"""Port parity, static/transient/light field: texpose_tpu_torch against
texpose_tpu on the same parameters (JAX init → checkpoint bridge) and the
same numpy inputs.

The kernel route's JAX side is the Pallas kernel in interpret mode, as
tests/test_fused_st.py runs it; the port's CPU side is the kernel
wrapper's plain twin.  Both compute in float32 here, so the tolerance
(2e-5) only covers summation order."""

import copy
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.nn import fields as jfields
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from texpose_tpu_torch.nn import fields as tfields
from texpose_tpu_torch.utils.checkpoint import (jax_state_to_torch,
                                                torch_state_to_jax)
from test_fused_st import st_cfg

B, R, N = 2, 4, 16
ATOL = 2e-5


def _bridge(jparams, cfg):
    """JAX field params → a port NerfST holding the same values."""
    flat = tree_to_flat_dict({"params": {"nerf": jparams}})
    nerf = tfields.init_nerf_st(cfg)
    state = jax_state_to_torch(flat)
    nerf.load_state_dict({k[len("nerf."):]: v for k, v in state.items()},
                         strict=True)
    return nerf


@pytest.fixture(scope="module")
def setup():
    cfg = st_cfg()
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(B, R, N, 3)).astype(np.float32)
    ray = rng.normal(size=(B, R, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    lt = rng.normal(size=(B, 8)).astype(np.float32)
    ll = rng.normal(size=(B, 12)).astype(np.float32)
    return cfg, jparams, _bridge(jparams, cfg), (pts, ray, lt, ll)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_bridge_roundtrip_ignores_training_leaves():
    cfg = st_cfg()
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(1), cfg)
    flat = tree_to_flat_dict({
        "params": {"nerf": jparams, "disc": {"w": np.ones(3)}},
        "latents": {"light": np.ones((4, 12)), "trans": np.zeros((4, 8))},
        "opt_nerf": {"mu": np.ones(2)}, "sn_state": {"u": np.ones(2)},
        "step": np.int32(5)})
    state = jax_state_to_torch(flat)
    assert not any(k.startswith(("disc", "opt", "sn", "step"))
                   for k in state)
    assert state["latents.light"].shape == (4, 12)
    back = torch_state_to_jax(state)
    kept = [k for k in flat if k.startswith(("params/nerf/", "latents/"))]
    assert sorted(back) == sorted(kept)
    for k in kept:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k],
                                                          np.float32))


@pytest.mark.parametrize("progress", [0.4, None])
def test_apply_nerf_st_raw_matches_jax_kernel(setup, progress):
    """Kernel route: raw head outputs against the JAX fused_st_field op
    (interpret) — with the c2f window, and with c2f off."""
    cfg, jparams, nerf, (pts, ray, lt, ll) = setup
    if progress is None:
        cfg = copy.deepcopy(cfg)
        cfg.c2f = None
    jprog = None if progress is None else jnp.asarray(progress)
    ref = jfields.apply_nerf_st_raw(
        jparams, cfg, jnp.asarray(pts), jnp.asarray(ray), jnp.asarray(lt),
        jnp.asarray(ll), progress=jprog, compute_dtype=jnp.float32,
        tile_fwd=32, tile_bwd=32, interpret=True)
    with torch.no_grad():
        out = tfields.apply_nerf_st_raw(nerf, cfg, *_t(pts, ray, lt, ll),
                                        progress=progress,
                                        compute_dtype=torch.float32)
    for name, a, b in zip(("rgb_raw", "dens_raw", "trans_raw"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


def test_apply_nerf_st_matches_jax_plain(setup):
    """Plain route (activated outputs) against JAX apply_nerf_st, and the
    kernel route's activations against the same reference."""
    cfg, jparams, nerf, (pts, ray, lt, ll) = setup
    ray_s = np.broadcast_to(ray[:, :, None], pts.shape)
    ref = jfields.apply_nerf_st(jparams, cfg, jnp.asarray(pts),
                                jnp.asarray(ray_s), jnp.asarray(lt),
                                jnp.asarray(ll), progress=jnp.asarray(0.4))
    with torch.no_grad():
        rgb, dens, unc = tfields.apply_nerf_st(
            nerf, cfg, *_t(pts, ray_s, lt, ll), progress=0.4)
        rgb_raw, dens_raw, trans_raw = tfields.apply_nerf_st_raw(
            nerf, cfg, *_t(pts, ray, lt, ll), progress=0.4,
            compute_dtype=torch.float32)
    for name, a, b in zip(("rgb", "density", "uncert"), (rgb, dens, unc),
                          ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)
    sh = (B, R, N)
    np.testing.assert_allclose(
        torch.sigmoid(rgb_raw).reshape(*sh, 3).numpy(),
        np.asarray(ref[0][..., 0]), atol=ATOL)
    np.testing.assert_allclose(
        tfields.softplus(dens_raw[:, 0]).reshape(sh).numpy(),
        np.asarray(ref[1][..., 0]), atol=ATOL)
    np.testing.assert_allclose(
        tfields.softplus(trans_raw[:, 4:5]).reshape(*sh, 1).numpy(),
        np.asarray(ref[2]), atol=ATOL)


def test_apply_nerf_st_bf16_rounding_points(setup):
    """compute_dtype=bfloat16: operands rounded to bf16, f32 accumulation,
    at the same places as the JAX dense().  An f32 sum taken in another
    order can flip one activation's bf16 rounding (2^-8 relative), and the
    flip propagates through the layers: 3e-2 bounds that at outputs of
    magnitude ≲ 4, while a missing or extra rounding point errs by O(1)."""
    cfg, jparams, nerf, (pts, ray, lt, ll) = setup
    ray_s = np.broadcast_to(ray[:, :, None], pts.shape)
    ref = jfields.apply_nerf_st(jparams, cfg, jnp.asarray(pts),
                                jnp.asarray(ray_s), jnp.asarray(lt),
                                jnp.asarray(ll), progress=jnp.asarray(0.4),
                                compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        out = tfields.apply_nerf_st(nerf, cfg, *_t(pts, ray_s, lt, ll),
                                    progress=0.4,
                                    compute_dtype=torch.bfloat16)
        raw = tfields.apply_nerf_st_raw(nerf, cfg, *_t(pts, ray, lt, ll),
                                        progress=0.4,
                                        compute_dtype=torch.bfloat16)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   atol=3e-2)
    np.testing.assert_allclose(
        torch.sigmoid(raw[0]).reshape(B, R, N, 3).numpy(),
        np.asarray(ref[0][..., 0], np.float32), atol=3e-2)


def test_posenc_and_c2f_match_jax():
    from texpose_tpu.ops import posenc as jp
    from texpose_tpu_torch.ops import posenc as tp
    x = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32)
    for args in ((4, None, None, 0), (4, 0.3, (0.1, 0.6), 1)):
        ref = jp.posenc_with_identity(jnp.asarray(x), *args)
        got = tp.posenc_with_identity(torch.from_numpy(x), *args)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_nerf_st_init_shapes_and_seed():
    """Seeded port init: JAX parameter shapes, reproducible per seed."""
    cfg = st_cfg()
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(0), cfg)
    flat = tree_to_flat_dict({"params": {"nerf": jparams}})
    a = tfields.init_nerf_st(cfg, torch.Generator().manual_seed(7))
    b = tfields.init_nerf_st(cfg, torch.Generator().manual_seed(7))
    back = torch_state_to_jax({"nerf." + k: v
                               for k, v in a.state_dict().items()})
    assert {k: v.shape for k, v in back.items()} == \
        {k: v.shape for k, v in flat.items()}
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
