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


def grid_sample_table(images, frame_idx, grid, mode="bilinear",
                      align_corners=False):
    """images [N,C,H,W], frame_idx [B] int, grid [B,h,w,2] → [B,C,h,w]:
    exactly ``grid_sample(images[frame_idx], grid, ...)``.  The JAX package
    folds the frame index into its gather so that the B frames are never
    materialized; here the gathered batch goes to ``F.grid_sample``."""
    return grid_sample(images[frame_idx], grid, mode, align_corners)
