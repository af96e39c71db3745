"""2D grid sampling (port of texpose_tpu/ops/grid_sample.py).

The JAX function reimplements torch's ``F.grid_sample`` semantics (NCHW
image, grid [B,h,w,2] of (x, y) in [-1,1], zero padding; bilinear, or
nearest with round-half-to-even), so the port calls it directly."""

from __future__ import annotations

import torch.nn.functional as F


def grid_sample(image, grid, mode="bilinear", align_corners=False):
    """image [B,C,H,W], grid [B,h,w,2] → [B,C,h,w]."""
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(mode)
    return F.grid_sample(image, grid.to(image.dtype), mode=mode,
                         padding_mode="zeros", align_corners=align_corners)
