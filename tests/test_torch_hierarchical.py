"""Port parity, the hierarchical geometry pretrain (``nerf.fine_sampling``):
the importance sampler and the sorted depth union (ops/render.py) against
the JAX package's with the same uniforms, and one training step of the
port's ``PretrainEngine`` with a coarse and a fine field against the JAX
engine's jitted step, from one state (the JAX init and Adam state over both
fields, carried over by the checkpoint bridge) and the draws of the JAX
step's own key splits (the render key split three ways: depth, fine,
density; both fields' noise from the density key at their own shapes).  The
JAX step runs plain and with its field kernels in interpret mode
(TEXPOSE_FUSED_INTERPRET=1); the port runs each field through its field
kernel's twins, forward and backward.  4 images × 16 rays × (32 + 32)
samples keep the JAX kernels' 512-row layout for both fields.

Tolerances: the sampler rtol 1e-5 (float32, the same arithmetic); the step
as tests/test_torch_pretrain_step.py — losses rtol 1e-4, gradients 2e-3 of
each tensor's largest magnitude (read off optax's first moment, mu =
0.1·g), updated parameters atol 2·lr.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from test_torch_pretrain_step import (GRAD_REL, LOSS_RTOL, _rel, jax_engine,
                                      port_engine, step_cfg)
from test_torch_pretrain_step import root  # noqa: F401  (the fixture)
from texpose_tpu_torch.ops.render import (sample_depth_from_pdf,
                                          union_sorted_depths)

N_FINE = 32


@pytest.mark.parametrize("stratified", [True, False],
                         ids=["stratified", "mid_bin"])
def test_sample_depth_from_pdf_matches_jax(stratified):
    from texpose_tpu.ops import render as jrender
    rng = np.random.default_rng(3)
    B, R, N, nf = 2, 7, 24, 40
    depth = np.sort(rng.uniform(2.0, 5.0, size=(B, R, N, 1)), 2).astype(
        np.float32)
    weights = rng.uniform(size=(B, R, N)).astype(np.float32)
    weights[0, 0] = 0.0                       # a ray with no weight at all
    weights[1, 2, 5:9] = 0.0
    key = jax.random.PRNGKey(8)
    j_fine = jrender.sample_depth_from_pdf(
        key, jnp.asarray(depth), jnp.asarray(weights), nf,
        stratified=stratified)
    rand = (torch.from_numpy(np.asarray(jax.random.uniform(key, (B, R, nf))))
            if stratified else None)
    t_fine = sample_depth_from_pdf(torch.from_numpy(depth),
                                   torch.from_numpy(weights), nf, rand)
    np.testing.assert_allclose(t_fine.numpy(), np.asarray(j_fine), rtol=1e-5)
    j_all = jrender.union_sorted_depths(jnp.asarray(depth), j_fine)
    t_all = union_sorted_depths(torch.from_numpy(depth), t_fine)
    assert t_all.shape == (B, R, N + nf, 1)
    np.testing.assert_allclose(t_all.numpy(), np.asarray(j_all), rtol=1e-5)


def fine_cfg(root, tmp_path, **over):
    return step_cfg(root, tmp_path, **{
        "nerf.fine_sampling": True, "nerf.sample_intvs_fine": N_FINE,
        "loss_weight.render_fine": 0, **over})


def jax_hier_draws(cfg, key, B):
    """The draws of the JAX hierarchical step from state['key']
    (pretrain.py step(), render.py render_rays_nerf_hierarchical,
    nn/fields.py apply_trunk)."""
    HW = cfg.H * cfg.W
    R = max(int(cfg.nerf.rand_rays) // B, 1)
    N = int(cfg.nerf.sample_intvs)
    key, sub = jax.random.split(key)
    k_perm, k_render = jax.random.split(sub)
    k_depth, k_fine, k_density = jax.random.split(k_render, 3)

    def t(x):
        return torch.as_tensor(np.array(x))

    return {"ray_idx": t(jax.random.permutation(k_perm, HW)[:R]).long(),
            "depth": t(jax.random.uniform(k_depth, (B, R, N, 1))),
            "fine": t(jax.random.uniform(k_fine, (B, R, N_FINE))),
            "density_noise": t(jax.random.normal(k_density, (B, R, N))),
            "density_noise_fine": t(jax.random.normal(
                k_density, (B, R, N + N_FINE)))}


@pytest.mark.parametrize("interpret,over", [
    (False, {}), (True, {}), (False, {"nerf.density_noise_reg": 0.5})],
    ids=["jax_plain", "jax_interpret", "jax_plain_noise"])
def test_hierarchical_step_matches_jax(root, tmp_path, monkeypatch,
                                       interpret, over):
    if interpret:
        monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    else:
        monkeypatch.delenv("TEXPOSE_FUSED_INTERPRET", raising=False)
    cfg = fine_cfg(root, tmp_path, **over)
    jeng = jax_engine(cfg)
    assert "nerf_fine" in jeng.state["params"]
    peng = port_engine(cfg, jeng)
    draws = jax_hier_draws(cfg, jeng.state["key"], len(jeng.train_data))
    state, jloss = jeng.step_fn(jeng.state, jeng.train_batch)
    after = tree_to_flat_dict(jax.device_get(state))
    ploss = peng.train_step(draws)
    assert "render_fine" in ploss and sorted(jloss) == sorted(ploss)
    for k in jloss:
        np.testing.assert_allclose(float(ploss[k]), float(jloss[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    paths = [path for path, _ in peng._all_params()]
    assert any(p.startswith("nerf_fine/") for p in paths)
    for path, p in peng._all_params():
        g_jax = after["opt_state/0/mu/" + path] / 0.1
        assert _rel(p.grad.numpy(), g_jax) <= GRAD_REL, path
    # the bridge: the JAX train state's keypaths, both fields, both ways
    flat = peng.train_state_flat(1)
    assert sorted(flat) == sorted(list(after) + ["step"])
    lr = cfg.optim.lr
    for k, v in after.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(flat[k], v, rtol=0, atol=2 * lr,
                                       err_msg=k)
    from texpose_tpu_torch.models import get_engine
    again = get_engine(cfg.model)(copy.deepcopy(cfg), "cpu")
    again.build_networks()
    again.setup_optimizer()
    again.load_train_state_flat(flat)
    back = again.train_state_flat(1)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
