"""Port parity, the trunk forward (kernels/trunk.py, row 10) and what runs
it: the kernel's plain twin against the JAX package's
``fused_trunk_forward`` in interpret mode with a BARF c2f window;
``run_trunk``'s routes; the density-only field (``forward_samples_density``,
``composite_density``); and the texture model's evaluation with
``nerf.density_noise_reg`` (the ST kernels' gate is off, so the heads are
plain and the trunk takes the trunk kernel) against the JAX engine's
``evaluate_full``.  Inputs from a numpy seed.

Tolerances: float32 on both sides — 1e-5 absolute (only the summation
order differs); bf16 compute — both round every matmul operand at the same
points, a different f32 summation order can flip one rounding: 2e-2 of
max(|ref|, 1) per element, 1e-3 in the mean (the features compared after
rounding the JAX kernel's f32 output to bf16, as every consumer does).
Evaluation: PSNR 0.01 dB, SSIM 1e-4 per frame.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.nn import fields as jfields
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from test_torch_pretrain_kernels import B, N, PROGRESS, R, _cfg
from texpose_tpu_torch.kernels.st_field import make_xext
from texpose_tpu_torch.kernels.trunk import trunk_fwd
from texpose_tpu_torch.nn import fields as tfields
from texpose_tpu_torch.utils.checkpoint import jax_state_to_torch


def _density_field(cfg, seed=2):
    """The JAX density field's params and the port's NerfDensity holding
    the same values."""
    jparams = jfields.init_nerf_density(jax.random.PRNGKey(seed), cfg)
    state = jax_state_to_torch(tree_to_flat_dict({"params": {
        "nerf": jparams}}))
    nerf = tfields.init_nerf_density(cfg)
    nerf.load_state_dict({k[len("nerf."):]: v for k, v in state.items()},
                         strict=True)
    return jparams, nerf


def _rays(seed):
    rng = np.random.default_rng(seed)
    center = np.tile(np.array([0.0, 0.0, -2.0], np.float32), (B, R, 1))
    ray = rng.normal(size=(B, R, 3)).astype(np.float32) * 0.2
    ray[..., 2] = 1.0
    depth = np.sort(rng.uniform(1.0, 3.0, size=(B, R, N, 1)), axis=2
                    ).astype(np.float32)
    return center, ray, depth


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trunk_twin_matches_jax_fused_trunk_interpret(dtype):
    from texpose_tpu.kernels.fused_trunk import fused_trunk_forward
    cfg = _cfg(False)
    jparams, nerf = _density_field(cfg)
    rng = np.random.default_rng(5)
    M = 300                                  # not a multiple of any tile
    pts = (rng.normal(size=(M, 3)) * 0.5).astype(np.float32)
    L = cfg.arch.posenc.L_3D
    c2f = tfields._c2f_band_weights(cfg, L, PROGRESS)
    assert float(c2f.min()) < 1.0            # a partial window
    j_feat, j_dens = fused_trunk_forward(
        jnp.asarray(pts), jnp.asarray(c2f.numpy()),
        [lp["w"] for lp in jparams["mlp_feat"]],
        [lp["b"] for lp in jparams["mlp_feat"]], tuple(cfg.arch.skip), L,
        compute_dtype=getattr(jnp, dtype), tile=128, interpret=True)
    xext = make_xext(torch.from_numpy(pts), L, c2f)
    feat, dens = trunk_fwd(xext, nerf.kernel_weights(),
                           getattr(torch, dtype))
    assert feat.shape == (M, 32) and dens.shape == (M,)
    j_feat = np.asarray(j_feat, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(feat.numpy(), j_feat, atol=1e-5)
        np.testing.assert_allclose(dens.numpy(), np.asarray(j_dens),
                                   atol=1e-5)
        return
    j_feat = torch.from_numpy(j_feat).bfloat16().float().numpy()
    for a, b in ((feat.numpy(), j_feat), (dens.numpy(), np.asarray(j_dens))):
        err = np.abs(a - b)
        assert (err / np.maximum(np.abs(b), 1.0)).max() <= 2e-2
        assert err.mean() <= 1e-3


def test_run_trunk_takes_the_kernel_outside_training(monkeypatch):
    """Outside training (with kernels.fused_trunk and posenc) run_trunk
    calls the trunk kernel's wrapper, which runs no autograd; in training,
    with the switch off, or without posenc it runs apply_trunk, whose
    density noise then applies."""
    calls = []
    real = tfields.trunk_fwd

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tfields, "trunk_fwd", spy)
    cfg = _cfg(False, fused_trunk=True)
    _, nerf = _density_field(cfg)
    pts = torch.randn(2, 5, 7, 3)
    noise = torch.randn(2, 5, 7)
    ref = tfields.apply_trunk(nerf.mlp_feat, cfg, tfields._encode_points(
        cfg, pts, PROGRESS), torch.float32)
    feat, dens = tfields.run_trunk(nerf, cfg, pts, PROGRESS, torch.float32,
                                   noise, training=False)
    assert calls == [1] and feat.shape == (2, 5, 7, 32)
    np.testing.assert_allclose(dens.numpy(), ref[1].detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(feat.numpy(), ref[0].detach().numpy(),
                               atol=1e-5)
    cfg.nerf.density_noise_reg = 0.5
    for over, training in (({}, True), ({"fused_trunk": False}, False)):
        cfg.kernels = dict({"fused_trunk": True}, **over)
        _, d = tfields.run_trunk(nerf, cfg, pts, PROGRESS, torch.float32,
                                 noise if training else None, training)
        want = tfields.apply_trunk(
            nerf.mlp_feat, cfg, tfields._encode_points(cfg, pts, PROGRESS),
            torch.float32, noise if training else None)[1]
        np.testing.assert_allclose(d.detach().numpy(),
                                   want.detach().numpy(), atol=1e-6)
    assert calls == [1]


@pytest.mark.parametrize("mode", ["eval", "train_noise"])
def test_density_field_matches_jax(mode):
    """forward_samples_density and composite_density against the JAX
    functions: in evaluation (the port's trunk kernel twin) and in training
    with density noise (apply_trunk on both sides, one standard-normal
    draw)."""
    cfg = _cfg(False, fused_trunk=True)
    jparams, nerf = _density_field(cfg)
    center, ray, depth = _rays(9)
    key = jax.random.PRNGKey(4)
    training = mode == "train_noise"
    noise = None
    if training:
        cfg.nerf.density_noise_reg = 1.0
        noise = torch.from_numpy(np.asarray(jax.random.normal(key,
                                                              (B, R, N))))
    j_dens = jfields.forward_samples_density(
        jparams, cfg, jnp.asarray(center), jnp.asarray(ray),
        jnp.asarray(depth), jnp.asarray(PROGRESS),
        mode="train" if training else "eval", density_key=key,
        compute_dtype=jnp.float32)
    j_out = jfields.composite_density(j_dens, jnp.asarray(depth),
                                      jnp.asarray(ray))
    c, r, d = (torch.from_numpy(x) for x in (center, ray, depth))
    with torch.no_grad():
        t_dens = tfields.forward_samples_density(
            nerf, cfg, c, r, d, PROGRESS, torch.float32, noise, training)
        t_out = tfields.composite_density(t_dens, d, r)
    np.testing.assert_allclose(t_dens.numpy(), np.asarray(j_dens), atol=1e-5)
    assert sorted(t_out) == sorted(j_out)
    for k in t_out:
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   atol=1e-5, err_msg=k)


def test_noisy_texture_evaluation_matches_jax(tmp_path, monkeypatch):
    """evaluate_full of one texture-model state with
    nerf.density_noise_reg = 1: the JAX engine's plain route against the
    port's evaluate CLI, whose trunk goes through the trunk kernel's
    wrapper (its twin here) under plain heads."""
    from test_torch_slice import _quant, _syn2real_cfg
    from texpose_tpu.data.fixture import generate_fixture
    from texpose_tpu.models.texture_gan import TextureGANEngine as JaxEngine
    from texpose_tpu.utils.checkpoint import save_checkpoint
    from texpose_tpu_torch import evaluate as port_evaluate

    calls = []
    real = tfields.trunk_fwd
    monkeypatch.setattr(tfields, "trunk_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    root = generate_fixture(str(tmp_path / "bop"), n_train=2, n_test=2,
                            scene="scene_all", image_scale=0.25, crop_res=32)

    def cfg_for(out):
        cfg = _syn2real_cfg(root, out)
        cfg.nerf.density_noise_reg = 1.0
        return cfg

    jcfg = cfg_for(tmp_path / "jax")
    jeng = JaxEngine(jcfg)
    jeng.load_dataset(eval_split="test", prefetch_train=False)
    k_nerf, k_lt, k_ll = jax.random.split(jax.random.PRNGKey(1), 3)
    n = len(jeng.train_data)
    jeng.state = {
        "params": {"nerf": jfields.init_nerf_st(k_nerf, jcfg)},
        "latents": {"trans": jax.random.normal(k_lt, (n, 8)),
                    "light": jax.random.normal(k_ll, (n, 12))}}
    jeng.evaluate_full()

    tcfg = cfg_for(tmp_path / "torch")
    save_checkpoint(tcfg.output_path, jeng.state)
    yml = tmp_path / "eval.yaml"
    with open(yml, "w") as f:
        yaml.safe_dump({k: v for k, v in tcfg.to_dict().items()
                        if k not in ("H", "W", "output_path")}, f)
    teng = port_evaluate.main([f"--yaml={yml}", "--resume", "--device=cpu"])
    assert not tfields.use_fused_render(teng.cfg, teng.nerf)
    assert calls, "the trunk kernel's wrapper was not called"
    qj, qt = _quant(jcfg.output_path), _quant(tcfg.output_path)
    assert len(qj) == len(qt) == 2
    for rj, rt in zip(qj, qt):
        assert abs(rj["psnr"] - rt["psnr"]) < 0.01, (rj, rt)
        assert abs(rj["ssim"] - rt["ssim"]) < 1e-4, (rj, rt)
