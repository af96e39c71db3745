"""LPIPS perceptual distance, AlexNet backbone + linear heads (port of
texpose_tpu/nn/lpips.py).

Conv weights are OIHW here (torch's layout) where the JAX package keeps
HWIO; ``from_jax`` converts a JAX parameter tree.  With no ported weights
the backbone is random from a seeded ``torch.Generator`` (the metric is
then reported as ``lpips_uncal``).  Callers on the card set
``torch.backends.cudnn.allow_tf32 = False`` so the convolutions run in
float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.consts import device_const

# (kernel, in, out, stride, pad); 3/2 max-pool before convs 1 and 2
ALEX_CONVS = [(11, 3, 64, 4, 2), (5, 64, 192, 1, 2), (3, 192, 384, 1, 1),
              (3, 384, 256, 1, 1), (3, 256, 256, 1, 1)]
_POOL_BEFORE = {1, 2}
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def init_lpips(generator, device=None):
    """Seeded random backbone + uniform non-negative linear heads."""
    convs = []
    for ks, cin, cout, _, _ in ALEX_CONVS:
        std = math.sqrt(2.0 / (ks * ks * cin))
        w = torch.randn((cout, cin, ks, ks), generator=generator) * std
        convs.append({"w": w.to(device),
                      "b": torch.zeros((cout,), device=device)})
    lins = [torch.full((c[2],), 1.0 / c[2], device=device)
            for c in ALEX_CONVS]
    return {"convs": convs, "lins": lins}


def from_jax(params, device=None):
    """A texpose_tpu.nn.lpips parameter tree (HWIO convs) → this module's
    (OIHW) tree."""
    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    return {"convs": [{"w": t(np.asarray(p["w"]).transpose(3, 2, 0, 1)),
                       "b": t(p["b"])} for p in params["convs"]],
            "lins": [t(lin) for lin in params["lins"]]}


def load_lpips_npz(path, device=None):
    """Ported weights (tools/port_weights.py npz, torch OIHW layouts)."""
    data = np.load(path)
    convs = [{"w": torch.as_tensor(data[f"conv{i}.weight"], device=device),
              "b": torch.as_tensor(data[f"conv{i}.bias"], device=device)}
             for i in range(len(ALEX_CONVS))]
    lins = [torch.as_tensor(np.maximum(data[f"lin{i}.weight"].reshape(-1),
                                       0.0), device=device)
            for i in range(len(ALEX_CONVS))]
    return {"convs": convs, "lins": lins}


def _alex_features(convs, x):
    """x [B,3,H,W] scaled input → the 5 post-ReLU feature maps."""
    feats = []
    for i, (p, (_, _, _, stride, pad)) in enumerate(zip(convs, ALEX_CONVS)):
        if i in _POOL_BEFORE:
            x = F.max_pool2d(x, 3, 2)
        x = torch.relu(F.conv2d(x, p["w"], p["b"], stride=stride,
                                padding=pad))
        feats.append(x)
    return feats


def _unit_normalize(x, eps=1e-10):
    return x / (torch.sqrt((x ** 2).sum(dim=1, keepdim=True)) + eps)


def lpips_distance(params, x, y):
    """x, y [B,3,H,W] in [-1,1] → [B] perceptual distances."""
    shift = device_const(SHIFT, x.dtype, x.device)[:, None, None]
    scale = device_const(SCALE, x.dtype, x.device)[:, None, None]
    fx = _alex_features(params["convs"], (x - shift) / scale)
    fy = _alex_features(params["convs"], (y - shift) / scale)
    total = 0.0
    for a, b, lin in zip(fx, fy, params["lins"]):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        total = total + (d * lin[None, :, None, None]).sum(dim=1) \
            .mean(dim=(1, 2))
    return total
