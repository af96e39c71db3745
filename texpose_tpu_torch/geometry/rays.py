"""Camera/ray geometry in PyTorch (port of texpose_tpu/geometry/rays.py).

World↔camera↔image transforms, the +0.5 pixel-center grid and the NDC
reparameterization.  Poses are [...,3,4] world→camera matrices, as in the
JAX package.
"""

from __future__ import annotations

import torch


def to_hom(X):
    """Append a homogeneous 1 to the last axis."""
    return torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)


def pose_invert(pose):
    """Invert a [...,3,4] rigid pose (R assumed orthonormal)."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    t_inv = -(R_inv @ t)
    return torch.cat([R_inv, t_inv], dim=-1)


def img2cam(X, intr):
    return X @ torch.linalg.inv(intr).transpose(-1, -2)


def cam2world(X, pose):
    """Camera-frame points → world (pose is world→cam, so invert first)."""
    return to_hom(X) @ pose_invert(pose).transpose(-1, -2)


def pixel_grid(H, W, dtype=torch.float32, device=None, center_offset=0.5):
    """[(H*W), 2] grid of (x, y) pixel centers, x fastest (row-major H×W)."""
    ys = torch.arange(H, dtype=dtype, device=device) + center_offset
    xs = torch.arange(W, dtype=dtype, device=device) + center_offset
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1).reshape(H * W, 2)


def convert_NDC(center, ray, intr, near=1.0):
    """Shift ray origins to the near plane and project to NDC (+z-facing
    convention, as texpose_tpu.geometry.rays.convert_NDC)."""
    center = center + (near - center[..., 2:]) / ray[..., 2:] * ray
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]
    scale_x = (intr[:, 0, 0] / intr[:, 0, 2])[:, None]
    scale_y = (intr[:, 1, 1] / intr[:, 1, 2])[:, None]
    cnx = scale_x * (cx / cz)
    cny = scale_y * (cy / cz)
    cnz = 1 - 2 * near / cz
    rnx = scale_x * (rx / rz - cx / cz)
    rny = scale_y * (ry / rz - cy / cz)
    rnz = 2 * near / cz
    return (torch.stack([cnx, cny, cnz], dim=-1),
            torch.stack([rnx, rny, rnz], dim=-1))
