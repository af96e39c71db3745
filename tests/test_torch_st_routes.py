"""Port parity, the ST field's routes: which route each configuration takes
(the port's gates against the JAX package's), and the field kernels' route
under the plain composite (``apply_nerf_st`` through ``use_fused_st``:
rows 1/2, then the plain activations) against the JAX package's
``apply_nerf_st_fused`` (Pallas in interpret mode), from the same
parameters (JAX init → npz bridge) and the same numpy inputs, at the small
config of tests/test_fused_st_render.py (32-wide, L_3D 4, N 16).

Tolerances (float32 compute on both sides; only the summation order
differs), as tests/test_torch_st_render.py: outputs 3e-5 absolute;
gradients 5e-5 absolute or 1e-4 of the tensor's largest magnitude,
whichever is larger.
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
from test_fused_st_render import _cfg
from test_torch_field import _bridge
from texpose_tpu_torch.nn import fields as tfields

ATOL = 3e-5
GRAD_ATOL = 5e-5
GRAD_REL = 1e-4
B, R, N = 2, 64, 16          # R·N = 1024: JAX's fused-field tile holds


def _port_route(cfg, nerf):
    if tfields.use_fused_st_render(cfg, nerf, N):
        return "mega"
    if tfields.use_fused_render(cfg, nerf):
        return "two_kernel"
    return "field_kernel" if tfields.use_fused_st(cfg, nerf) else "plain"


def _jax_route(cfg, params):
    if jfields.use_fused_st_render(cfg, B, R, N, params):
        return "mega"
    if jfields.use_fused_render(cfg, B, R, N):
        return "two_kernel"
    if "mlp_trans" in params and jfields._use_fused_st(cfg, B, R, N):
        return "field_kernel"
    return "plain"


# case: (kernels, other config keys, the port's route, JAX's route)
ROUTE_CASES = {
    "default": ({"st_mega": False}, {}, "two_kernel", "two_kernel"),
    "st_mega": ({}, {}, "mega", "mega"),
    "fused_composite_off": ({"st_mega": False, "fused_composite": False},
                            {}, "field_kernel", "field_kernel"),
    "density_relu": ({"st_mega": False}, {"arch.density_activ": "relu"},
                     "field_kernel", "field_kernel"),
    "fused_st_off": ({"st_mega": False, "fused_st": False}, {}, "plain",
                     "plain"),
    "density_noise": ({"st_mega": False}, {"nerf.density_noise_reg": 0.5},
                      "plain", "plain"),
    # the port kernels' own contract: both heads need a hidden layer (JAX's
    # two-kernel gate has no such clause; its field kernel runs 1-layer
    # heads unsplit)
    "one_layer_heads": ({"st_mega": False},
                        {"arch.layers_rgb": [None, 3],
                         "arch.layers_trans": [None, 5]},
                        "plain", "two_kernel"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_st_route_table_matches_jax(monkeypatch, case):
    kernels, over, want_port, want_jax = ROUTE_CASES[case]
    for k in ("TEXPOSE_ST_MEGA", "TEXPOSE_ST_SPLIT_HEADS",
              "TEXPOSE_ST_BWD_FULLBLOCK", "TEXPOSE_ST_HEADS_FULLBLOCK",
              "TEXPOSE_ST_POSENC"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg = _cfg(**kernels)
    for key, value in over.items():
        node = cfg
        *path, last = key.split(".")
        for p in path:
            node = node[p]
        node[last] = value
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(0), cfg)
    nerf = tfields.init_nerf_st(cfg)
    assert _jax_route(cfg, jparams) == want_jax
    assert _port_route(cfg, nerf) == want_port


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = max(GRAD_ATOL, GRAD_REL * float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol, what


def test_field_kernel_route_matches_jax_interpret(monkeypatch):
    """apply_nerf_st with kernels.fused_composite off: the port's field
    kernel route (st_field: forward twin → backward twin, once each)
    against JAX's apply_nerf_st_fused in interpret mode — the activated
    outputs and the gradients of every head tensor and both latents."""
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg = _cfg(st_mega=False, fused_composite=False)
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(4), cfg)
    nerf = _bridge(jparams, cfg)
    assert tfields.use_fused_st(cfg, nerf)
    assert not tfields.use_fused_render(cfg, nerf)
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(B, R, N, 3)).astype(np.float32)
    ray = rng.normal(size=(B, R, 3)).astype(np.float32)
    unit = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
    unit = np.ascontiguousarray(np.broadcast_to(unit[:, :, None],
                                                pts.shape))
    lt = (rng.normal(size=(B, 8)) * 0.3).astype(np.float32)
    ll = (rng.normal(size=(B, 12)) * 0.3).astype(np.float32)
    cots = [rng.normal(size=s).astype(np.float32)
            for s in ((B, R, N, 3, 2), (B, R, N, 2), (B, R, N, 1))]

    def jloss(heads, lt_, ll_):
        outs = jfields.apply_nerf_st_fused(
            dict(heads, mlp_feat=jparams["mlp_feat"]), cfg,
            jnp.asarray(pts), jnp.asarray(unit), lt_, ll_,
            progress=jnp.asarray(0.5), compute_dtype=jnp.float32,
            interpret=True)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    heads = {k: v for k, v in jparams.items() if k != "mlp_feat"}
    (_, jouts), (g_heads, g_lt, g_ll) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
            heads, jnp.asarray(lt), jnp.asarray(ll))

    calls = {"st_field": 0}
    real = tfields.st_field

    def counted(*a, **k):
        calls["st_field"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tfields, "st_field", counted)
    t_lt = torch.tensor(lt, requires_grad=True)
    t_ll = torch.tensor(ll, requires_grad=True)
    outs = tfields.apply_nerf_st(
        nerf, cfg, torch.from_numpy(pts), torch.from_numpy(unit), t_lt,
        t_ll, progress=0.5, compute_dtype=torch.float32, training=True)
    assert calls["st_field"] == 1
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(j),
                                   atol=ATOL)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)) \
        .backward()
    for name in ("mlp_rgb", "mlp_trans"):
        for i, layer in enumerate(getattr(nerf, name)):
            for part in ("w", "b"):
                _close(getattr(layer, part).grad.numpy(),
                       g_heads[name][i][part], (name, i, part))
    _close(t_lt.grad.numpy(), g_lt, "latent_trans")
    _close(t_ll.grad.numpy(), g_ll, "latent_light")
    assert all(p.grad is None for p in nerf.mlp_feat.parameters())
