"""Port parity, the geometry-pretrain training step: texpose_tpu_torch's
``PretrainEngine`` / ``PretrainEnvEngine.train_step`` against the JAX
engines' jitted step, from one state (the JAX init and Adam state carried
over by the checkpoint bridge) and one set of random draws (made with the
JAX step's own key splits and handed to the port).  The JAX step runs plain
and with its Pallas kernels in interpret mode (TEXPOSE_FUSED_INTERPRET=1);
the port runs its kernel route (the coarse field with the composite in its
epilogue, then the composite and field backwards), whose CPU side is the
kernels' plain twins.  Float32 compute, at the narrow widths of
tests/test_pretrain_e2e.py.

Tolerances:
  * losses: rtol 1e-4 — only the order of f32 sums differs;
  * gradients: JAX's are read off its first Adam moment (mu = 0.1·g) and
    agree to 2e-3 of each tensor's largest magnitude (the kernel route
    sums in other orders, and a sign flip at a ReLU boundary moves one
    term);
  * updated parameters: Adam's first step moves every element by ≈ ±lr
    whatever |g|, so atol 2·lr.
"""

import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from test_pretrain_e2e import tiny_pretrain_cfg

LOSS_RTOL = 1e-4
GRAD_REL = 2e-3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=4,
                            n_test=2, scene="scene_all", image_scale=0.25,
                            crop_res=32)


def step_cfg(root, tmp_path, env=False, **over):
    """The e2e test's tiny config on 4 images: 16 rays each x 32 samples
    (M = 2048 rows keeps the JAX kernels' layout contract), the shipped
    yamls' loss and data switches."""
    cfg = tiny_pretrain_cfg(root, tmp_path)
    cfg.data.scene = "scene_all"
    cfg.nerf.rand_rays = 64
    cfg.data.erode_mask_loss = True
    cfg.kernels = {}
    if env:
        cfg.model = "nerf_pretrain_env"
        cfg.arch.posenc.L_view = 2
        cfg.nerf.view_dep = True
        cfg.data.erode_mask_loss = None
        cfg.loss_weight.depth = None
        cfg.optim.lr = 1e-3
        cfg.optim.lr_end = 1e-4
    else:
        cfg.optim.sched = {"gamma": 0.99}
    for k, v in over.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    return cfg


def jax_engine(cfg, it=0):
    from texpose_tpu.models.pretrain import PretrainEngine, PretrainEnvEngine
    cls = PretrainEnvEngine if cfg.model == "nerf_pretrain_env" \
        else PretrainEngine
    eng = cls(cfg)
    eng.load_dataset()
    eng.build_networks()
    eng.setup_optimizer()
    eng.state["it"] = jax.numpy.asarray(it, jax.numpy.int32)
    return eng


def port_engine(cfg, jeng):
    """The port's engine holding the JAX engine's state."""
    from texpose_tpu_torch.models import get_engine
    eng = get_engine(cfg.model)(copy.deepcopy(cfg), "cpu")
    eng.load_dataset()
    eng.upload_train_split()
    eng.build_networks()
    eng.setup_optimizer()
    st = dict(jeng.state)
    st["step"] = np.int32(0)
    eng.load_train_state_flat(tree_to_flat_dict(st))
    return eng


def jax_draws(cfg, key, B, N_img=None):
    """The draws the JAX step makes from state['key'] (pretrain.py step(),
    render.py, nn/fields.py apply_trunk) → (next key, draws)."""
    HW = cfg.H * cfg.W
    R = max(int(cfg.nerf.rand_rays) // B, 1)
    N = int(cfg.nerf.sample_intvs)
    key, sub = jax.random.split(key)
    k_perm, k_render = jax.random.split(sub)
    k_depth, k_density = jax.random.split(k_render)
    draws = {
        "ray_idx": torch.as_tensor(np.array(
            jax.random.permutation(k_perm, HW)[:R]), dtype=torch.long),
        "depth": torch.as_tensor(np.array(jax.random.uniform(
            k_depth, (B, R, N, 1)))),
        "density_noise": torch.as_tensor(np.array(jax.random.normal(
            k_density, (B, R, N))))}
    return key, draws


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def run_step(cfg, monkeypatch, interpret, it=0):
    if interpret:
        monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    else:
        monkeypatch.delenv("TEXPOSE_FUSED_INTERPRET", raising=False)
    jeng = jax_engine(cfg, it)
    peng = port_engine(cfg, jeng)
    _, draws = jax_draws(cfg, jeng.state["key"], len(jeng.train_data))
    state, jloss = jeng.step_fn(jeng.state, jeng.train_batch)
    ploss = peng.train_step(draws)
    return jeng, peng, tree_to_flat_dict(jax.device_get(state)), jloss, ploss


VARIANTS = {
    "pretrain": (False, {}),
    # BARF c2f with the step at 30 % of max_iter: partial band windows
    "pretrain_c2f": (False, {"c2f": [0.1, 0.5]}),
    "env": (True, {}),
    # setbg_opaque: the opacity column carries the background's gradient
    "env_setbg": (True, {"nerf.setbg_opaque": True}),
}


@pytest.mark.parametrize("interpret,variant", [
    (False, "pretrain"), (True, "pretrain"), (False, "pretrain_c2f"),
    (True, "env"), (False, "env_setbg")],
    ids=["jax_plain", "jax_interpret", "jax_plain_c2f", "env_jax_interpret",
         "env_jax_plain_setbg"])
def test_one_step_matches_jax(root, tmp_path, monkeypatch, interpret,
                              variant):
    from texpose_tpu_torch.nn.fields import use_fused_coarse_render
    env, over = VARIANTS[variant]
    cfg = step_cfg(root, tmp_path, env=env, **over)
    it = int(0.3 * cfg.max_iter) if cfg.get("c2f") else 0
    assert use_fused_coarse_render(cfg, cfg.nerf.sample_intvs, True)
    jeng, peng, after, jloss, ploss = run_step(cfg, monkeypatch, interpret,
                                               it)
    assert sorted(jloss) == sorted(ploss)
    for k in jloss:
        np.testing.assert_allclose(float(ploss[k]), float(jloss[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for path, p in peng._named_params():
        g_jax = after["opt_state/0/mu/nerf/" + path] / 0.1
        assert _rel(p.grad.numpy(), g_jax) <= GRAD_REL, path
    flat = peng.train_state_flat(1)
    assert sorted(flat) == sorted(list(after) + ["step"])
    lr = cfg.optim.lr
    for k, v in after.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(flat[k], v, rtol=0, atol=2 * lr,
                                       err_msg=k)
    assert peng.it == int(after["it"]) == it + 1


def test_density_noise_step_takes_plain_route_and_matches_jax(
        root, tmp_path, monkeypatch):
    """With nerf.density_noise_reg the training render takes the plain
    route on both sides with the same standard-normal draw; evaluation
    keeps the kernel route."""
    from texpose_tpu_torch.nn.fields import use_fused_coarse_render
    cfg = step_cfg(root, tmp_path, **{"nerf.density_noise_reg": 0.5})
    assert not use_fused_coarse_render(cfg, cfg.nerf.sample_intvs, True)
    assert use_fused_coarse_render(cfg, cfg.nerf.sample_intvs, False)
    _, peng, after, jloss, ploss = run_step(cfg, monkeypatch, False)
    for k in jloss:
        np.testing.assert_allclose(float(ploss[k]), float(jloss[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for path, p in peng._named_params():
        g_jax = after["opt_state/0/mu/nerf/" + path] / 0.1
        assert _rel(p.grad.numpy(), g_jax) <= GRAD_REL, path


def test_kernel_route_matches_plain_route(root, tmp_path):
    """One port step through the kernel route's twins and one through the
    plain route (kernels.fused_coarse off), from one state and draws."""
    cfg = step_cfg(root, tmp_path)
    jeng = jax_engine(cfg)
    _, draws = jax_draws(cfg, jeng.state["key"], len(jeng.train_data))
    out = []
    for fused in (True, False):
        c = copy.deepcopy(cfg)
        c["kernels"]["fused_coarse"] = fused
        peng = port_engine(c, jeng)
        loss = peng.train_step(draws)
        out.append((loss, {k: p.grad.clone()
                           for k, p in peng._named_params()}))
    (lk, gk), (lp, gp) = out
    for k in lp:
        np.testing.assert_allclose(float(lk[k]), float(lp[k]), rtol=1e-5)
    for k in gp:
        assert _rel(gk[k].numpy(), gp[k].numpy()) <= 1e-4, k


def test_gate_refuses_unported_two_kernel_route(tmp_path, root):
    """Which coarse route each configuration takes, as the JAX package's
    gates: the mega forward (field + composite kernel) with N | 64 and
    kernels.coarse_mega on or unset; the two-kernel route (field kernel →
    composite kernel) with coarse_mega off or N ∤ 64; the field kernel under
    the plain composite without fused_composite; the plain route without
    fused_coarse, and with density noise in training.  None raises."""
    from texpose_tpu_torch.nn.fields import (use_fused_coarse,
                                             use_fused_coarse_mega,
                                             use_fused_coarse_render)

    def route(cfg, N, training):
        if use_fused_coarse_mega(cfg, N, training):
            return "mega"
        if use_fused_coarse_render(cfg, N, training):
            return "two_kernel"
        return "field_kernel" if use_fused_coarse(cfg, training) else "plain"

    cases = [({}, 32, True, "mega"), ({}, 64, False, "mega"),
             ({"kernels.coarse_mega": None}, 32, True, "mega"),
             ({"kernels.coarse_mega": False}, 32, True, "two_kernel"),
             ({}, 48, False, "two_kernel"), ({}, 192, True, "two_kernel"),
             ({"kernels.fused_composite": False}, 48, False, "field_kernel"),
             ({"kernels.fused_coarse": False}, 32, False, "plain"),
             ({"nerf.density_noise_reg": 0.5}, 32, True, "plain"),
             ({"nerf.density_noise_reg": 0.5}, 32, False, "mega")]
    for over, N, training, want in cases:
        cfg = step_cfg(root, tmp_path, **over)
        assert route(cfg, N, training) == want, (over, N, training)
