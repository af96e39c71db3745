"""Gaussian-window SSIM (port of texpose_tpu/ops/ssim.py): 11×11 Gaussian
(σ=1.5) as two separable depthwise convolutions with zero SAME padding,
C1=0.01², C2=0.03², mean over all pixels.  Callers on the card set
``torch.backends.cudnn.allow_tf32 = False`` so the convolutions run in
float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian(window_size, sigma, dtype, device):
    x = torch.arange(window_size, dtype=dtype, device=device) \
        - window_size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _blur(img, window):
    """Separable depthwise Gaussian blur, SAME padding. img [B,C,H,W]."""
    B, C, H, W = img.shape
    k = window.shape[0]
    out = img.reshape(B * C, 1, H, W)
    out = F.conv2d(out, window.reshape(1, 1, 1, k), padding=(0, k // 2))
    out = F.conv2d(out, window.reshape(1, 1, k, 1), padding=(k // 2, 0))
    return out.reshape(B, C, H, W)


def ssim(img1, img2, window_size=11, sigma=1.5, size_average=True):
    """img1/img2 [B,C,H,W] in [0,1] → scalar (or [B] if not size_average)."""
    window = _gaussian(window_size, sigma, img1.dtype, img1.device)
    mu1 = _blur(img1, window)
    mu2 = _blur(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window) - mu2_sq
    sigma12 = _blur(img1 * img2, window) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / \
               ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
