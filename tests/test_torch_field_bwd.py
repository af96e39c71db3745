"""Port parity, the ST field's backward: the gradients of the port's
autograd Function (``st_field``; on the CPU its backward is the kernel's
plain twin ``st_field_bwd_plain``) against ``jax.grad`` through the JAX
package's fused_st_field custom_vjp (Pallas in interpret mode), from the
same parameters (JAX init → checkpoint bridge), inputs and output
cotangents (numpy, seeded).  Both compute in float32; the JAX kernel and
the twin sum in other orders (tile partials, split layer 0), so every
gradient tensor agrees to 1e-5 of its largest magnitude.

The twin is also held against torch.autograd through the forward twin
``st_field_plain`` (float32, 1e-5 of the largest magnitude), including
row counts whose 64-row tiles straddle image boundaries.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.nn import fields as jfields
from texpose_tpu_torch.kernels.st_field import (st_field, st_field_bwd,
                                                st_field_plain)
from texpose_tpu_torch.nn import fields as tfields
from test_fused_st import st_cfg
from test_torch_field import _bridge

REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("progress", [0.4, 1.0])
def test_field_grads_match_jax_interpret(progress):
    cfg = st_cfg()
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(0), cfg)
    nerf = _bridge(jparams, cfg)
    B, R, N = 2, 4, 16
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(B, R, N, 3)).astype(np.float32)
    ray = rng.normal(size=(B, R, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    lt = rng.normal(size=(B, 8)).astype(np.float32)
    ll = rng.normal(size=(B, 12)).astype(np.float32)
    g_rgb = rng.normal(size=(B * R * N, 3)).astype(np.float32)
    g_tr = rng.normal(size=(B * R * N, 5)).astype(np.float32)

    def jloss(heads, lt_, ll_):
        params = dict(heads, mlp_feat=jparams["mlp_feat"])
        rgb, _, tr = jfields.apply_nerf_st_raw(
            params, cfg, jnp.asarray(pts), jnp.asarray(ray), lt_, ll_,
            progress=jnp.asarray(progress), compute_dtype=jnp.float32,
            tile_fwd=32, tile_bwd=32, interpret=True)
        return (rgb * g_rgb).sum() + (tr * g_tr).sum()

    heads = {k: v for k, v in jparams.items() if k != "mlp_feat"}
    g_heads, g_lt, g_ll = jax.grad(jloss, argnums=(0, 1, 2))(
        heads, jnp.asarray(lt), jnp.asarray(ll))

    t_lt = torch.tensor(lt, requires_grad=True)
    t_ll = torch.tensor(ll, requires_grad=True)
    rgb, dens, tr = tfields.apply_nerf_st_raw(
        nerf, cfg, torch.from_numpy(pts), torch.from_numpy(ray), t_lt, t_ll,
        progress=progress, compute_dtype=torch.float32)
    assert not dens.requires_grad
    ((rgb * torch.from_numpy(g_rgb)).sum()
     + (tr * torch.from_numpy(g_tr)).sum()).backward()
    for name in ("mlp_rgb", "mlp_trans"):
        for i, layer in enumerate(getattr(nerf, name)):
            for part in ("w", "b"):
                got = getattr(layer, part).grad.numpy()
                want = np.asarray(g_heads[name][i][part])
                assert _rel(got, want) <= REL, (name, i, part)
    assert _rel(t_lt.grad.numpy(), g_lt) <= REL
    assert _rel(t_ll.grad.numpy(), g_ll) <= REL
    assert all(p.grad is None for p in nerf.mlp_feat.parameters())


@pytest.mark.parametrize("B,rows_per_img,cut", [(2, 64, 0), (3, 70, 5),
                                                (4, 7, 2)])
def test_bwd_twin_matches_autograd(B, rows_per_img, cut):
    """st_field_bwd on CPU tensors (the twin) = autograd of the forward
    twin, for the heads and the latent rows; the trunk gets nothing."""
    cfg = st_cfg()
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(1), cfg)
    nerf = _bridge(jparams, cfg)
    w = nerf.kernel_weights()
    g = torch.Generator().manual_seed(B)
    M = B * rows_per_img - cut
    xw = w.trunk[0].w.shape[0]
    xext = torch.randn(M, xw, generator=g)
    e3 = w.rgb[0].w.shape[0] - w.feat_dim - 12
    encpts = torch.randn(M, e3, generator=g)
    light = torch.randn(B, 12, generator=g, requires_grad=True)
    trans = torch.randn(B, 8, generator=g, requires_grad=True)
    g_rgb = torch.randn(M, 3, generator=g)
    g_tr = torch.randn(M, 5, generator=g)
    rgb, _, tr = st_field_plain(xext, encpts, light, trans, w, rows_per_img,
                                torch.float32)
    params = w.head_params()
    ref = torch.autograd.grad((rgb * g_rgb).sum() + (tr * g_tr).sum(),
                              params + [light, trans])
    *_, feat = st_field_plain(xext, encpts, light, trans, w, rows_per_img,
                              torch.float32, want_feat=True)
    d_heads, d_light, d_trans = st_field_bwd(
        feat.detach(), encpts, light.detach(), trans.detach(), w,
        rows_per_img, g_rgb, g_tr, torch.float32)
    for a, b in zip(list(d_heads) + [d_light, d_trans], ref):
        assert a.shape == b.shape
        assert _rel(a.detach().numpy(), b.numpy()) <= REL
    # the Function routes the same gradients
    out = st_field(xext, encpts, light, trans, w, rows_per_img,
                   torch.float32)
    got = torch.autograd.grad((out[0] * g_rgb).sum()
                              + (out[2] * g_tr).sum(),
                              params + [light, trans])
    for a, b in zip(got, ref):
        assert _rel(a.numpy(), b.numpy()) <= REL
