"""VGG19 features for the perceptual loss (port of texpose_tpu/nn/vgg.py):
torchvision's ``features`` stack up to layer 14 (conv3_3, pre-activation)
after ImageNet normalization.

Parameters are a list of {"w": [out,in,3,3], "b": [out]} tensors: He-normal
random features from a seeded generator (``init_vgg19``), torchvision
weights from an npz of ``features.N.weight/bias`` (``load_vgg19_npz``), or
the JAX package's HWIO parameters (``vgg_from_jax``).

Mixed precision: with dtype=bfloat16 the JAX package runs the whole stack
in bf16 — each convolution takes bf16 inputs and weights, accumulates in
f32 inside XLA and rounds its output to bf16; the bias add, ReLU and max
pool run on bf16 values.  The port does the same: ``F.conv2d`` on bf16
tensors accumulates in f32 and returns bf16, and every later op stays in
bf16 until the features are cast back to f32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

VGG19_CONVS = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
               (10, 128, 256), (12, 256, 256), (14, 256, 256)]
_POOL_AFTER = {1, 3}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def init_vgg19(generator, device=None):
    """Deterministic He-normal 3×3 filters, zero biases."""
    params = []
    for _, cin, cout in VGG19_CONVS:
        std = math.sqrt(2.0 / (9 * cin))
        w = torch.randn((cout, cin, 3, 3), generator=generator) * std
        params.append({"w": w.to(device),
                       "b": torch.zeros((cout,), device=device)})
    return params


def load_vgg19_npz(path, device=None):
    """torchvision vgg19 weights from an npz with state-dict keys."""
    data = np.load(path)
    return [{"w": torch.as_tensor(data[f"features.{idx}.weight"],
                                  dtype=torch.float32, device=device),
             "b": torch.as_tensor(data[f"features.{idx}.bias"],
                                  dtype=torch.float32, device=device)}
            for idx, _, _ in VGG19_CONVS]


def vgg_from_jax(params, device=None):
    """The JAX package's VGG parameters ({"w": HWIO, "b"} per conv)."""
    return [{"w": torch.tensor(np.asarray(p["w"]).transpose(3, 2, 0, 1),
                               dtype=torch.float32, device=device),
             "b": torch.tensor(np.asarray(p["b"]), dtype=torch.float32,
                               device=device)} for p in params]


def vgg19_features(params, x, dtype=None):
    """x [B,3,H,W] in [0,1] → conv3_3 features [B,256,H/4,W/4] f32."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    x = (x - mean) / std
    if dtype is not None:
        x = x.to(dtype)
    for i, p in enumerate(params):
        w, b = p["w"], p["b"]
        if dtype is not None:
            w, b = w.to(dtype), b.to(dtype)
        x = F.conv2d(x, w, padding=1) + b[None, :, None, None]
        if i != len(params) - 1:
            x = torch.clamp_min(x, 0)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 2, 2)
    return x.float()


def perceptual_loss_pairs(params, pairs, loss_type="l2", dtype=None):
    """pairs = [(fake_i, real_i, weight_i)], all [B,3,H,W]: ONE feature
    pass over the stacked batch; the real features carry no gradient."""
    stacked = torch.cat([x for f, r, _ in pairs for x in (f, r)], dim=0)
    feats = vgg19_features(params, stacked, dtype)
    B = pairs[0][0].shape[0]
    total = 0.0
    for i, (_, _, w) in enumerate(pairs):
        f_fake = feats[2 * i * B:(2 * i + 1) * B]
        f_real = feats[(2 * i + 1) * B:(2 * i + 2) * B].detach()
        if loss_type == "l1":
            d = (f_fake - f_real).abs().mean()
        elif loss_type == "l2":
            d = ((f_fake - f_real) ** 2).mean()
        else:
            d = (f_fake - f_real).abs().mean() + ((f_fake - f_real) ** 2).mean()
        total = total + w * d
    return total
