"""Port parity, the texture model's render kernels (``kernels.st_mega``):
the port's ``render_st_core`` on its mega route (kernels/st_render.py;
on the CPU the kernels' plain twins) against the JAX package's on its mega
route (kernels/fused_st_render.py in interpret mode,
TEXPOSE_FUSED_INTERPRET=1), from the same parameters (JAX init → npz
bridge) and the same numpy inputs, at the small config of
tests/test_fused_st_render.py (32-wide, L_3D 4, N 16).

Tolerances (float32 compute on both sides; only the summation order
differs): the 8 render leaves and trans_density_mean 3e-5 absolute (the
JAX mega's own bound against its plain route); gradients 5e-5 absolute or
1e-4 of the tensor's largest magnitude, whichever is larger, in both
backward modes.  The gate is held against JAX's on the clauses of
test_mega_gate_fallbacks; JAX's TPU layout clause is replaced by the
port's own contract, rays whose N divides the kernels' 64-row tile.  One
evaluated frame matches the JAX mega's at the slice tests' PSNR 0.01 dB /
SSIM 1e-4.
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

from texpose_tpu.data.fixture import generate_fixture
from texpose_tpu.kernels.fused_st_render import _make_op
from texpose_tpu.models.render import render_st_core as jax_render
from texpose_tpu.nn import fields as jfields
from test_fused_st_render import KEYS, _cfg
from test_torch_field import _bridge
from texpose_tpu_torch.kernels import st_render as tst_render
from texpose_tpu_torch.models.render import render_st_core as port_render
from texpose_tpu_torch.nn import fields as tfields

ATOL = 3e-5
GRAD_ATOL = 5e-5
GRAD_REL = 1e-4
PROGRESS = 0.5


def _scene(B, R, seed):
    rng = np.random.default_rng(seed)
    center = rng.normal(size=(B, R, 3)).astype(np.float32)
    ray = rng.normal(size=(B, R, 3)).astype(np.float32)
    near = np.full((B, R), 2.0, np.float32)
    far = np.full((B, R), 6.0, np.float32)
    lt = (rng.normal(size=(B, 8)) * 0.3).astype(np.float32)
    ll = (rng.normal(size=(B, 12)) * 0.3).astype(np.float32)
    return center, ray, near, far, lt, ll


def _jax_run(params, cfg, scene, lt, ll):
    return jax_render(params, cfg, *(jnp.asarray(x) for x in scene),
                      lt, ll, jax.random.PRNGKey(7), jnp.asarray(PROGRESS),
                      "eval", compute_dtype=jnp.float32)


def _port_run(nerf, cfg, scene, lt, ll):
    return port_render(nerf, cfg, *(torch.from_numpy(x) for x in scene),
                       lt, ll, progress=PROGRESS,
                       compute_dtype=torch.float32)


def _setup(monkeypatch, B=2, R=64, seed=3, **kernels):
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg = _cfg(**kernels)
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(seed), cfg)
    nerf = _bridge(jparams, cfg)
    return cfg, jparams, nerf, _scene(B, R, seed)


def _loss(o):
    return ((o["rgb"] ** 2).mean() + 2 * (o["rgb_static"] ** 2).mean()
            + 3 * o["rgb_transient"].sum() + 0.5 * o["opacity"].sum()
            + 0.25 * o["opacity_transient"].sum()
            + 4 * (o["uncert"] ** 2).mean() + 1.5 * o["trans_density_mean"])


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = max(GRAD_ATOL, GRAD_REL * float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol, what


def test_mega_render_matches_jax_mega(monkeypatch):
    cfg, jparams, nerf, (*scene, lt, ll) = _setup(monkeypatch)
    N = int(cfg.nerf.sample_intvs)
    assert jfields.use_fused_st_render(cfg, 2, 64, N, jparams)
    assert tfields.use_fused_st_render(cfg, nerf, N)
    ref = _jax_run(jparams, cfg, scene, jnp.asarray(lt), jnp.asarray(ll))
    with torch.no_grad():
        out = _port_run(nerf, cfg, scene, torch.from_numpy(lt),
                        torch.from_numpy(ll))
        cfg.kernels.st_mega = False
        assert not tfields.use_fused_st_render(cfg, nerf, N)
        two = _port_run(nerf, cfg, scene, torch.from_numpy(lt),
                        torch.from_numpy(ll))
    for k in KEYS + ["trans_density_mean"]:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)
        # the port's two routes share every kernel twin's arithmetic
        np.testing.assert_allclose(out[k].numpy(), two[k].numpy(), atol=1e-6,
                                   err_msg=k)


def _spy(monkeypatch, names):
    """Count the calls of st_render's kernel wrappers by name."""
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(tst_render, n)

        def wrapped(*a, _fn=fn, _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tst_render, n, wrapped)
    return calls


@pytest.mark.parametrize("full_bwd", [False, True], ids=["hybrid", "fullbwd"])
def test_mega_gradients_match_jax_mega(monkeypatch, full_bwd):
    """Heads and latents through both packages' mega backward: the hybrid
    (composite backward → field backward) and, with TEXPOSE_MEGA_FULLBWD=1,
    the fully fused one; JAX's _make_op cache is cleared around the switch."""
    cfg, jparams, nerf, (*scene, lt, ll) = _setup(monkeypatch)
    if full_bwd:
        monkeypatch.setenv("TEXPOSE_MEGA_FULLBWD", "1")
    else:
        monkeypatch.delenv("TEXPOSE_MEGA_FULLBWD", raising=False)
    heads = {k: v for k, v in jparams.items() if k != "mlp_feat"}
    _make_op.cache_clear()
    try:
        g_heads, g_lt, g_ll = jax.grad(
            lambda h, a, b: _loss(_jax_run(dict(h, mlp_feat=jparams["mlp_feat"]),
                                           cfg, scene, a, b)),
            argnums=(0, 1, 2))(heads, jnp.asarray(lt), jnp.asarray(ll))
    finally:
        _make_op.cache_clear()
    calls = _spy(monkeypatch, ("st_render_bwd", "composite_st_bwd",
                               "st_field_bwd"))
    t_lt = torch.tensor(lt, requires_grad=True)
    t_ll = torch.tensor(ll, requires_grad=True)
    _loss(_port_run(nerf, cfg, scene, t_lt, t_ll)).backward()
    want = ({"st_render_bwd": 1, "composite_st_bwd": 0, "st_field_bwd": 0}
            if full_bwd else
            {"st_render_bwd": 0, "composite_st_bwd": 1, "st_field_bwd": 1})
    assert calls == want
    for name in ("mlp_rgb", "mlp_trans"):
        for i, layer in enumerate(getattr(nerf, name)):
            for part in ("w", "b"):
                _close(getattr(layer, part).grad.numpy(),
                       g_heads[name][i][part], (name, i, part))
    _close(t_lt.grad.numpy(), g_lt, "latent_trans")
    _close(t_ll.grad.numpy(), g_ll, "latent_light")
    assert all(p.grad is None for p in nerf.mlp_feat.parameters())


def test_mega_images_stay_apart(monkeypatch):
    """JAX's image-straddling case (B 4, R 64, N 16: one streamed TPU grid
    step spans two images): the loss and each image's latent gradients."""
    cfg, jparams, nerf, (*scene, lt, ll) = _setup(
        monkeypatch, B=4, seed=5, st_subtiles_fwd=4, st_subtiles_bwd=2)
    assert jfields.use_fused_st_render(cfg, 4, 64, 16, jparams)

    def loss(o):
        return (o["rgb"] ** 2).mean() + (o["uncert"] ** 2).mean()

    v_ref, (g_lt, g_ll) = jax.value_and_grad(
        lambda a, b: loss(_jax_run(jparams, cfg, scene, a, b)),
        argnums=(0, 1))(jnp.asarray(lt), jnp.asarray(ll))
    t_lt = torch.tensor(lt, requires_grad=True)
    t_ll = torch.tensor(ll, requires_grad=True)
    v = loss(_port_run(nerf, cfg, scene, t_lt, t_ll))
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_ref), atol=ATOL)
    _close(t_lt.grad.numpy(), g_lt, "latent_trans")
    _close(t_ll.grad.numpy(), g_ll, "latent_light")
    # every image's latents receive their own gradient
    assert (np.abs(t_ll.grad.numpy()).max(axis=1) > 0).all()


GATE_CASES = {
    "default": ({}, {}, 16),
    "N48": ({}, {}, 48),
    "N64": ({}, {}, 64),
    "st_mega_off": ({"st_mega": False}, {}, 16),
    "st_mega_null_env_on": ({"st_mega": None}, {"TEXPOSE_ST_MEGA": "1"}, 16),
    "st_mega_null_env_off": ({"st_mega": None}, {}, 16),
    "posenc_sinext": ({"st_posenc": "sinext"}, {}, 16),
    "split_heads_off": ({"st_split_heads": False}, {}, 16),
    "split_heads_env_off": ({}, {"TEXPOSE_ST_SPLIT_HEADS": "0"}, 16),
    "trunk_ilp": ({"st_trunk_ilp": True}, {}, 16),
    "trunk_fullblock": ({"st_trunk_fullblock": True}, {}, 16),
    "bwd_fullblock_env": ({}, {"TEXPOSE_ST_BWD_FULLBLOCK": "1"}, 16),
    "heads_fullblock_env": ({}, {"TEXPOSE_ST_HEADS_FULLBLOCK": "1"}, 16),
    "fused_st_off": ({"fused_st": False}, {}, 16),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_mega_gate_matches_jax(monkeypatch, case):
    """The port's use_fused_st_render against JAX's on each clause of
    test_mega_gate_fallbacks (and the env switches JAX reads), at B 2, R 16
    (R·N a multiple of the JAX fused field's 1024-row tile at N 64, where
    the JAX layout contract holds).  At N = 48 both refuse: JAX because
    48 rows do not fit its 512-row subtiles whole, the port because 48
    does not divide its 64-row tile."""
    kernels, env, N = GATE_CASES[case]
    for k in ("TEXPOSE_ST_MEGA", "TEXPOSE_ST_SPLIT_HEADS",
              "TEXPOSE_ST_BWD_FULLBLOCK", "TEXPOSE_ST_HEADS_FULLBLOCK",
              "TEXPOSE_ST_POSENC"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg = _cfg(**kernels)
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(0), cfg)
    nerf = tfields.init_nerf_st(cfg)
    want = jfields.use_fused_st_render(cfg, 2, 16 if N != 16 else 64, N,
                                       jparams)
    assert tfields.use_fused_st_render(cfg, nerf, N) == want
    assert want == (case in ("default", "N64", "st_mega_null_env_on"))


# ------------------------------------------------------- one evaluated frame

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")),
                            n_train=4, n_test=1, scene="scene_all",
                            image_scale=0.25, crop_res=32)


def test_evaluate_frame_matches_jax_mega(root, tmp_path, monkeypatch):
    """``evaluate`` with kernels.st_mega on: the JAX engine's evaluate_full
    (mega in interpret mode) and the port's CLI entry (mega twins) on the
    same checkpoint and frame."""
    from test_torch_slice import _quant, _syn2real_cfg
    from texpose_tpu.models.texture_gan import TextureGANEngine as JaxEngine
    from texpose_tpu.utils.checkpoint import save_checkpoint
    from texpose_tpu_torch import evaluate as port_evaluate

    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    jcfg = _syn2real_cfg(root, tmp_path / "jax")
    jcfg.kernels = {"st_mega": True, "fused_trunk": False}
    jeng = JaxEngine(jcfg)
    jeng.load_dataset(eval_split="test", prefetch_train=False)
    n = len(jeng.train_data)
    k_nerf, k_lt, k_ll = jax.random.split(jax.random.PRNGKey(0), 3)
    jeng.state = {
        "params": {"nerf": jfields.init_nerf_st(k_nerf, jcfg),
                   "disc": {"w": np.ones((3, 3), np.float32)}},
        "latents": {"trans": jax.random.normal(k_lt, (n, 8)),
                    "light": jax.random.normal(k_ll, (n, 12))},
        "sn_state": {"u": np.ones(4, np.float32)}}
    R, N = int(jcfg.nerf.rand_rays), int(jcfg.nerf.sample_intvs)
    assert jfields.use_fused_st_render(jcfg, 1, R, N,
                                       jeng.state["params"]["nerf"])
    jeng.evaluate_full()

    tcfg = _syn2real_cfg(root, tmp_path / "torch")
    tcfg.kernels = {"st_mega": True}
    save_checkpoint(tcfg.output_path, jeng.state)
    yml = tmp_path / "eval.yaml"
    with open(yml, "w") as f:
        yaml.safe_dump({k: v for k, v in tcfg.to_dict().items()
                        if k not in ("H", "W", "output_path")}, f)
    teng = port_evaluate.main([f"--yaml={yml}", "--resume", "--device=cpu"])
    assert tfields.use_fused_st_render(teng.cfg, teng.nerf, N)
    qj, qt = _quant(jcfg.output_path), _quant(tcfg.output_path)
    assert len(qj) == len(qt) == 1
    assert abs(qj[0]["psnr"] - qt[0]["psnr"]) < 0.01, (qj, qt)
    assert abs(qj[0]["ssim"] - qt[0]["ssim"]) < 1e-4, (qj, qt)
