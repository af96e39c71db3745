"""Port parity, the coarse field's field-only and two-kernel routes: the
field forward with raw outputs (kernels/coarse_field.py ``coarse_field``,
row 7a with the row-7b backward), the single-density composite forward
(kernels/composite.py ``fused_composite_coarse``, row 9a/9c with the row-9b
backward), and the pretrain step with ``kernels.coarse_mega`` off or rays
that do not fit the mega kernel's row tile, against the JAX package (its
Pallas kernels in interpret mode).  The port's CPU side is the kernels'
plain twins.  Inputs from a numpy seed.

Tolerances (float32 compute on both sides; only the summation order
differs): forward outputs 1e-5 absolute, gradients 1e-4 of each tensor's
largest magnitude; the whole step as tests/test_torch_pretrain_step.py
(losses rtol 1e-4, gradients 2e-3 of max read off Adam's first moment).
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
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from test_torch_pretrain_kernels import (B, N, PROGRESS, R, _cfg, _bridge,
                                         _jax_pts, _port_inputs, _rel)
from test_torch_pretrain_step import (GRAD_REL, LOSS_RTOL, run_step,
                                      step_cfg)
from test_torch_pretrain_step import root  # noqa: F401  (the fixture)
from texpose_tpu_torch.kernels.coarse_field import coarse_field
from texpose_tpu_torch.kernels.composite import fused_composite_coarse
from texpose_tpu_torch.nn import fields as tfields


@pytest.mark.parametrize("view_dep", [False, True],
                         ids=["view_indep", "view_dep"])
def test_coarse_field_grads_match_jax_vjp(monkeypatch, view_dep):
    """coarse_field (field forward twin → field backward twin) against
    jax.vjp of apply_nerf_raw (fused_coarse_field in interpret mode): the
    raw outputs and every trunk and head gradient."""
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg = _cfg(view_dep)
    jparams = jfields.init_nerf(jax.random.PRNGKey(3), cfg)
    nerf = _bridge(jparams, cfg)
    rng = np.random.default_rng(17)
    center = np.tile(np.array([0.0, 0.0, -2.0], np.float32), (B, R, 1))
    ray = rng.normal(size=(B, R, 3)).astype(np.float32) * 0.2
    ray[..., 2] = 1.0
    depth = np.sort(rng.uniform(1.0, 3.0, size=(B, R, N, 1)), axis=2
                    ).astype(np.float32)
    M = B * R * N
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)
    g_dens = rng.normal(size=(M, 1)).astype(np.float32)
    pts, unit = _jax_pts(center, ray, depth)
    (j_rgb, j_dens), vjp = jax.vjp(lambda p: jfields.apply_nerf_raw(
        p, cfg, pts, unit if view_dep else None, jnp.asarray(PROGRESS),
        compute_dtype=jnp.float32, interpret=True), jparams)
    jg = tree_to_flat_dict({"nerf": vjp((jnp.asarray(g_rgb),
                                         jnp.asarray(g_dens)))[0]})
    xext, ep, _, _ = _port_inputs(cfg, center, ray, depth)
    rgb_raw, dens_raw = coarse_field(xext, ep, nerf.kernel_weights(),
                                     torch.float32)
    np.testing.assert_allclose(rgb_raw.detach().numpy(), np.asarray(j_rgb),
                               atol=1e-5)
    np.testing.assert_allclose(dens_raw.detach().numpy(), np.asarray(j_dens),
                               atol=1e-5)
    ((rgb_raw * torch.from_numpy(g_rgb)).sum()
     + (dens_raw * torch.from_numpy(g_dens)).sum()).backward()
    for name, p in nerf.named_parameters():
        key = "nerf/" + name.replace(".", "/")
        assert _rel(p.grad.numpy(), jg[key]) <= 1e-4, key


@pytest.mark.parametrize("flat", [False, True], ids=["planes", "flat"])
@pytest.mark.parametrize("n", [16, 40])
def test_composite_coarse_matches_jax_interpret(flat, n):
    """fused_composite_coarse (forward twin → backward twin) against the
    JAX function of that name in interpret mode, on its [BR,N] planes
    (row 9a) and on the flat [M,3]/[M,1] layout (row 9c): the packed
    outputs and both raw-output gradients."""
    from texpose_tpu.kernels.fused_composite_coarse import (
        fused_composite_coarse as jcomposite)
    rng = np.random.default_rng(n)
    M = B * R * n
    rgb_raw = rng.normal(size=(M, 3)).astype(np.float32)
    dens_raw = (rng.normal(size=(M, 1)) * 3).astype(np.float32)
    depth = np.sort(rng.uniform(2, 6, size=(B, R, n, 1)), 2).astype(
        np.float32)
    ray = rng.normal(size=(B, R, 3)).astype(np.float32)
    cot = rng.normal(size=(B, R, 5)).astype(np.float32)

    def cat(out, lib):
        return lib.concatenate([out["rgb"], out["depth"], out["opacity"]],
                               -1)

    def f(a, b):
        return cat(jcomposite(a, b, jnp.asarray(depth), jnp.asarray(ray),
                              interpret=True, flat=flat), jnp)

    j_out, vjp = jax.vjp(f, jnp.asarray(rgb_raw), jnp.asarray(dens_raw))
    j_drgb, j_ddens = vjp(jnp.asarray(cot))
    a = torch.from_numpy(rgb_raw).requires_grad_(True)
    b = torch.from_numpy(dens_raw).requires_grad_(True)
    out = cat(fused_composite_coarse(a, b, torch.from_numpy(depth),
                                     torch.from_numpy(ray)), torch)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    assert _rel(a.grad.numpy(), j_drgb) <= 1e-4
    assert _rel(b.grad.numpy(), j_ddens) <= 1e-4


@pytest.mark.parametrize("over", [{"kernels.coarse_mega": False},
                                  {"nerf.sample_intvs": 24}],
                         ids=["coarse_mega_off_N32", "N24"])
def test_two_kernel_step_matches_jax(root, tmp_path, monkeypatch, over):
    """One pretrain step of the port's two-kernel route against the JAX
    engine's (field kernel → composite kernel, interpret mode), on the JAX
    draws: with coarse_mega off at N = 32, and at N = 24, which does not
    divide the mega kernel's 64-row tile (4 images × 16 rays × N rows keep
    the JAX kernels' 512-row layout)."""
    cfg = step_cfg(root, tmp_path, **over)
    N_ = int(cfg.nerf.sample_intvs)
    assert tfields.use_fused_coarse_render(cfg, N_, True)
    assert not tfields.use_fused_coarse_mega(cfg, N_, True)
    _, peng, after, jloss, ploss = run_step(cfg, monkeypatch, True)
    assert sorted(jloss) == sorted(ploss)
    for k in jloss:
        np.testing.assert_allclose(float(ploss[k]), float(jloss[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for path, p in peng._named_params():
        g_jax = after["opt_state/0/mu/nerf/" + path] / 0.1
        assert _rel(p.grad.numpy(), g_jax) <= GRAD_REL, path


def test_two_kernel_route_matches_mega_route(root, tmp_path):
    """One port step through the two-kernel route's twins and one through
    the mega route's, from one state and one set of draws."""
    import copy
    from test_torch_pretrain_step import jax_draws, jax_engine, port_engine
    cfg = step_cfg(root, tmp_path)
    jeng = jax_engine(cfg)
    _, draws = jax_draws(cfg, jeng.state["key"], len(jeng.train_data))
    out = []
    for mega in (True, False):
        c = copy.deepcopy(cfg)
        c["kernels"]["coarse_mega"] = mega
        peng = port_engine(c, jeng)
        loss = peng.train_step(draws)
        out.append((loss, {k: p.grad.clone()
                           for k, p in peng._named_params()}))
    (lm, gm), (lt, gt) = out
    for k in lm:
        np.testing.assert_allclose(float(lt[k]), float(lm[k]), rtol=1e-5)
    for k in gm:
        assert _rel(gt[k].numpy(), gm[k].numpy()) <= 1e-4, k


def test_st_mega_gate_picks_the_render_kernels(tmp_path, monkeypatch):
    """kernels.st_mega on, where the JAX package takes its ST mega kernel
    (row 6, now ported), no longer raises: the render kernels' gate picks
    that route; unset or off, the two-kernel route's gate alone holds, and
    with fused_st off neither."""
    from test_texture_gan_e2e import tiny_gan_cfg
    monkeypatch.delenv("TEXPOSE_ST_MEGA", raising=False)
    cfg = tiny_gan_cfg("unused", tmp_path)
    nerf = tfields.init_nerf_st(cfg)
    N = int(cfg.nerf.sample_intvs)
    for kernels, two, mega in (({}, True, False),
                               ({"st_mega": False}, True, False),
                               ({"st_mega": True}, True, True),
                               ({"st_mega": True, "fused_st": False},
                                False, False)):
        cfg.kernels = kernels
        assert tfields.use_fused_render(cfg, nerf) == two, kernels
        assert tfields.use_fused_st_render(cfg, nerf, N) == mega, kernels
