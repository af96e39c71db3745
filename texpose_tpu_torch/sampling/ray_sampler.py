"""Continuous-coordinate ray sampling for patch training (port of
texpose_tpu/sampling/ray_sampler.py): world rays at normalized patch
coords via the closed-form align_corners=True pixel map (no +0.5 pixel
center, as the reference), and bilinearly sampled depth bounds."""

from __future__ import annotations

import torch

from ..geometry.rays import cam2world, img2cam, to_hom
from ..ops.grid_sample import grid_sample


def coords_to_pixels(coords, H, W):
    """[-1,1] coords [B,h,w,2] → pixel (u, v)."""
    u = (coords[..., 0] + 1) / 2 * (W - 1)
    v = (coords[..., 1] + 1) / 2 * (H - 1)
    return u, v


def get_rays(intr, coords, pose, H, W):
    """coords [B,h,w,2] → (center [B,h,w,3], ray [B,h,w,3]), world frame."""
    B, h, w, _ = coords.shape
    u, v = coords_to_pixels(coords, H, W)
    xy = torch.stack([u, v], dim=-1).reshape(B, h * w, 2)
    grid_3D = img2cam(to_hom(xy), intr)
    center_3D = cam2world(torch.zeros_like(grid_3D), pose)
    ray = cam2world(grid_3D, pose) - center_3D
    return center_3D.reshape(B, h, w, 3), ray.reshape(B, h, w, 3)


def get_bounds(coords, z_near, z_far, H, W):
    """Per-pixel depth bounds z_near/z_far [B,HW] sampled at the patch
    coords (bilinear, align_corners=True) → ([B,h,w], [B,h,w])."""
    B = z_near.shape[0]
    zn = z_near.reshape(B, 1, H, W).float()
    zf = z_far.reshape(B, 1, H, W).float()
    return (grid_sample(zn, coords, "bilinear", align_corners=True)[:, 0],
            grid_sample(zf, coords, "bilinear", align_corners=True)[:, 0])
