"""Device-side resize matching cv2.resize(..., INTER_LINEAR) on float input
(port of texpose_tpu/ops/image.py): half-pixel sampling
src = (dst + 0.5)·(S/D) − 0.5, edge-replicated bilinear, rows then
columns."""

from __future__ import annotations

import functools

import numpy as np
import torch


def _axis_weights(src_size, dst_size):
    """Host-side gather indices + lerp weights for one axis."""
    d = np.arange(dst_size, dtype=np.float64)
    src = (d + 0.5) * (src_size / dst_size) - 0.5
    i0 = np.floor(src).astype(np.int64)
    w1 = (src - i0).astype(np.float32)
    i1 = np.clip(i0 + 1, 0, src_size - 1)
    i0 = np.clip(i0, 0, src_size - 1)
    return i0, i1, w1


@functools.lru_cache(maxsize=None)
def _axis_tables(src_size, dst_size, device):
    """``_axis_weights`` as device tensors, made once per (sizes, device)
    and kept: a resize makes no host→device copy (a captured frame reads
    them where they were at capture)."""
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(a, device=device)
                     for a in _axis_weights(src_size, dst_size))


def resize_bilinear(img, out_hw):
    """img [H,W,C] (or [H,W]) float → [out_H,out_W,(C)]."""
    H, W = img.shape[0], img.shape[1]
    oH, oW = int(out_hw[0]), int(out_hw[1])
    if (oH, oW) == (H, W):
        return img
    r0, r1, rw = _axis_tables(H, oH, img.device)
    c0, c1, cw = _axis_tables(W, oW, img.device)
    rw = rw.reshape(oH, *([1] * (img.ndim - 1)))
    cw = cw.reshape(1, oW, *([1] * (img.ndim - 2)))
    rows = img[r0] * (1 - rw) + img[r1] * rw
    return rows[:, c0] * (1 - cw) + rows[:, c1] * cw
