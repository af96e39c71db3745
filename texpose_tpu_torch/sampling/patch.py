"""GRAF-style patch coordinates (port of texpose_tpu/sampling/patch.py).

The JAX sampler splits its PRNG key into the scale and the two shift
draws; here the three uniforms are an explicit input ([3, B, 1, 1, 1],
``patch_uniforms``), so a test can hand both packages the same numbers.
Coordinates are normalized to [-1, 1] with coords[..., 0] = x (indexes W),
as grid_sample reads them.
"""

from __future__ import annotations

import math

import torch


def base_grid(patch_size, device=None):
    """[p,p,2] grid, coords[i,j] = (lin[j], lin[i])."""
    lin = torch.linspace(-1.0, 1.0, patch_size, device=device)
    x = lin[None, :].expand(patch_size, patch_size)
    y = lin[:, None].expand(patch_size, patch_size)
    return torch.stack([x, y], dim=-1)


def patch_uniforms(generator, nbatch, device=None):
    """The sampler's draws: U[0,1) for (scale, h shift, w shift),
    [3, B, 1, 1, 1]."""
    return torch.rand((3, nbatch, 1, 1, 1), generator=generator,
                      device=device)


def scale_bounds(iteration, min_scale=0.25, max_scale=1.0,
                 scale_anneal=0.0002, device=None):
    """The annealed (lo, hi) scale range as float32 tensors, as the JAX
    sampler computes it (min scale decays as max·exp(−it·anneal), floored
    at min_scale and capped at 0.8)."""
    it = torch.as_tensor(float(iteration), dtype=torch.float32, device=device)
    hi = torch.as_tensor(max_scale, dtype=torch.float32, device=device)
    if scale_anneal > 0:
        lo = torch.clamp(max_scale * torch.exp(-it * scale_anneal),
                         min=min_scale)
        lo = torch.clamp(lo, max=0.8)
    else:
        lo = torch.as_tensor(min_scale, dtype=torch.float32, device=device)
    return lo, hi


def flex_patch_coords(uniforms, patch_size, iteration=0, min_scale=0.25,
                      max_scale=1.0, scale_anneal=0.0002):
    """Annealed random-scale, random-shift patch coords from the draws
    ``uniforms`` [3,B,1,1,1] → (coords [B,p,p,2] in [-1,1], scales
    [B,1,1,1])."""
    u_scale, u_h, u_w = uniforms
    lo, hi = scale_bounds(iteration, min_scale, max_scale, scale_anneal,
                          uniforms.device)
    scales = u_scale * (hi - lo) + lo
    coords = base_grid(patch_size, uniforms.device)[None] * scales
    max_offset = 1 - scales
    h_off = (u_h * 2 - 1) * max_offset
    w_off = (u_w * 2 - 1) * max_offset
    # the reference shifts x with the h offset and y with the w offset
    return coords + torch.cat([h_off, w_off], dim=-1), scales


def current_scale_bounds(iteration, min_scale=0.25, max_scale=1.0,
                         scale_anneal=0.0002):
    """Host-side mirror of the annealed (min, max) for logging."""
    if scale_anneal > 0:
        lo = max(min_scale, max_scale * math.exp(-iteration * scale_anneal))
        lo = min(0.8, lo)
    else:
        lo = min_scale
    return lo, max_scale
