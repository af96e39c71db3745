"""sRGB ↔ CIE Lab (D65/2°) in closed form (port of
texpose_tpu/ops/color.py).  Both branches of each piecewise function are
evaluated, so the unselected one is clamped into its domain to keep its
gradient finite."""

from __future__ import annotations

import torch

from .consts import device_const

_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_WHITE = (0.950456, 1.0, 1.088754)


def srgb_to_linear(rgb):
    """Inverse sRGB gamma, input in [0,1]."""
    hi = torch.clamp((rgb + 0.055) / 1.055, min=0.0) ** 2.4
    return torch.where(rgb > 0.04045, hi, rgb / 12.92)


def linear_to_srgb(lin):
    """sRGB gamma of linear RGB, clipped to [0,1] first."""
    lin = torch.clamp(lin, 0.0, 1.0)
    hi = 1.055 * torch.clamp(lin, min=0.0031308) ** (1 / 2.4) - 0.055
    return torch.where(lin > 0.0031308, hi, 12.92 * lin)


def rgb_to_lab(rgb):
    """rgb [B,3,H,W] in [0,1] → Lab [B,3,H,W], L∈[0,100], ab∈[−127,127]."""
    lin = srgb_to_linear(rgb)
    m = device_const(_RGB2XYZ, rgb.dtype, rgb.device)
    white = device_const(_WHITE, rgb.dtype, rgb.device)
    xyz = torch.einsum("ij,bjhw->bihw", m, lin) / white[None, :, None, None]
    eps = 0.008856
    kappa = 7.787
    f = torch.where(xyz > eps, torch.clamp(xyz, min=eps) ** (1.0 / 3.0),
                    kappa * xyz + 4.0 / 29.0)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=1)


def normalize_lab(lab):
    """L [0,100] → [0,1]; ab [−127,127] → [0,1]."""
    lo = device_const((0.0, -127.0, -127.0), lab.dtype,
                      lab.device)[None, :, None, None]
    hi = device_const((100.0, 127.0, 127.0), lab.dtype,
                      lab.device)[None, :, None, None]
    return (lab - lo) / (hi - lo)
