"""Port parity, the dual-density composite's backward: the gradients of
the port's fused_composite_st (its autograd Function; on the CPU the
backward is the kernel's twin ``composite_st_bwd_plain``) against
``jax.grad`` through the JAX package's fused_composite_st custom_vjp
(Pallas in interpret mode), on both of its input layouts — channel planes
(``flat=False``) and flat [M,C] (``flat=True``, ``kernels.composite_flat``):
the port's kernels always read and write the flat layout.  Same numpy
inputs and per-leaf loss weights on both sides; float32, the suffix sums
run in other orders: 1e-5 of each gradient's largest magnitude.

The twin is also held against torch.autograd through the forward twin
``composite_st_plain`` at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texpose_tpu.kernels.fused_composite import fused_composite_st as jfc
from texpose_tpu_torch.kernels.composite import (composite_st_bwd,
                                                 composite_st_plain,
                                                 fused_composite_st)
from texpose_tpu_torch.ops.render import _dists

REL = 1e-5
KEYS = ["rgb", "rgb_static", "rgb_transient", "depth", "opacity",
        "opacity_static", "opacity_transient", "uncert",
        "trans_density_mean"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inputs(seed, B=2, R=8, N=16):
    rng = np.random.default_rng(seed)
    M = B * R * N
    rgb_raw = rng.normal(size=(M, 3)).astype(np.float32)
    trans_raw = rng.normal(size=(M, 5)).astype(np.float32)
    dens_raw = (rng.normal(size=(M, 1)) * 2).astype(np.float32)
    depth = np.sort(rng.uniform(2, 6, size=(B, R, N, 1)), axis=2
                    ).astype(np.float32)
    ray = rng.normal(size=(B, R, 3)).astype(np.float32)
    weights = {k: rng.normal(size=(B, R, 3 if k.startswith("rgb") else 1)
                             ).astype(np.float32) for k in KEYS[:-1]}
    weights["trans_density_mean"] = np.float32(rng.normal())
    return (rgb_raw, trans_raw, dens_raw, depth, ray), weights


@pytest.mark.parametrize("flat", [False, True], ids=["planes", "flat"])
def test_composite_grads_match_jax_interpret(flat):
    args, wts = _inputs(3)

    def jloss(rgb_raw, trans_raw):
        out = jfc(rgb_raw, trans_raw, *map(jnp.asarray, args[2:]),
                  interpret=True, tile_rays=8, flat=flat)
        return sum((out[k] * wts[k]).sum() for k in KEYS)

    j_rgb, j_tr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(args[0]),
                                                  jnp.asarray(args[1]))
    t_rgb = torch.tensor(args[0], requires_grad=True)
    t_tr = torch.tensor(args[1], requires_grad=True)
    out = fused_composite_st(t_rgb, t_tr, *map(torch.from_numpy, args[2:]))
    sum((out[k] * torch.as_tensor(wts[k])).sum() for k in KEYS).backward()
    assert _rel(t_rgb.grad.numpy(), j_rgb) <= REL
    assert _rel(t_tr.grad.numpy(), j_tr) <= REL


@pytest.mark.parametrize("BR,N", [(16, 16), (5, 9), (3, 70)])
def test_bwd_twin_matches_autograd(BR, N):
    g = torch.Generator().manual_seed(BR * N)
    M = BR * N
    rgb_raw = torch.randn(M, 3, generator=g, requires_grad=True)
    trans_raw = torch.randn(M, 5, generator=g, requires_grad=True)
    dens_raw = torch.randn(M, 1, generator=g) * 2
    depth = torch.sort(torch.rand(BR, N, generator=g) * 4 + 2, 1).values
    ray = torch.randn(1, BR, 3, generator=g)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    cot = torch.randn(BR, 16, generator=g)
    packed = composite_st_plain(rgb_raw, trans_raw, dens_raw, depth, dist)
    ref = torch.autograd.grad((packed * cot).sum(), [rgb_raw, trans_raw])
    got = composite_st_bwd(rgb_raw.detach(), trans_raw.detach(), dens_raw,
                           dist, cot)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b.numpy()) <= REL
