"""Positional encoding with BARF coarse-to-fine windowing (port of
texpose_tpu/ops/posenc.py).

freq_k = 2^k·π; per input dimension the encoding is
[sin(f_0 x)…sin(f_{L−1} x), cos(f_0 x)…cos(f_{L−1} x)], dims stacked then
flattened dim-major, and the window w_k = (1 − cos(π·clamp(α−k, 0, 1)))/2.
The angles are formed element-wise in float32: rounding them to bf16
turns the high bands into noise.
"""

from __future__ import annotations

import math

import torch


def c2f_band_weights(L, progress, c2f_range, c2f_start=0, device=None):
    """Per-frequency window w_k as an [L] float32 vector."""
    start, end = c2f_range
    progress = torch.as_tensor(progress, dtype=torch.float32, device=device)
    alpha = (progress - start) / (end - start) * L
    k = torch.arange(L, dtype=torch.float32, device=device) - c2f_start
    return (1 - torch.cos(math.pi * torch.clamp(alpha - k, 0.0, 1.0))) / 2


def positional_encoding(x, L, progress=None, c2f_range=None, c2f_start=0):
    """x [..., D] → [..., D*2L]."""
    freq = (2.0 ** torch.arange(L, dtype=x.dtype, device=x.device)) * math.pi
    spectrum = x[..., None] * freq                                # [...,D,L]
    enc = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2)
    if c2f_range is not None:
        enc = enc * c2f_band_weights(L, progress, c2f_range, c2f_start,
                                     device=x.device).to(x.dtype)
    return enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * L)


def posenc_with_identity(x, L, progress=None, c2f_range=None, c2f_start=0):
    """[x, posenc(x)] → [..., D + D*2L], the network input layout."""
    return torch.cat(
        [x, positional_encoding(x, L, progress, c2f_range, c2f_start)],
        dim=-1)
