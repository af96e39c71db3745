"""F7 (b) and (d): the texture-GAN step at a late optimizer state, and the
lockstep tool.

(b) One JAX state at a late training time: params, latents and the Adam
and RMSprop moments after 20 JAX steps at a small width, the optimizers'
counts and ``it`` then set to 15,000 (of a 20,000-step horizon: the
staircase at epoch 5000, the patch-scale anneal at its floor).  Carried
to the port over the npz train-state bridge, one step on each side with
the JAX step's draws (``jax_draws``), for the ``base`` loss set and with
``render.latent_ema``:
  * losses: rtol 1e-4 (only the order of f32 sums differs);
  * gradients: JAX's read off its moments' update (mu' = 0.9·mu + 0.1·g;
    D's RMSprop nu' = 0.99·nu + 0.01·g²): 2e-3 of each tensor's largest
    magnitude (tests/test_torch_train_step.py's bounds);
  * the moments after the step: what that gradient bound allows through
    their update (0.1·2e-3·max|g| for mu, 0.001·2·2e-3·max|g|² for nu);
  * updated parameters: to the optimizer's step size (2·lr at count
    15,000 for the heads, latents and the EMA shadow, 20·lr_D for D:
    ROADMAP's trap, an element whose g is near zero may move the other
    way);
  * the learning rate used and Adam's bias correction at that count: each
    side's optimizer applied to one gradient from the carried moments, the
    updates to rtol 1e-5 (an update is lr·m̂/(√v̂ + ε), so a rate or a bias
    correction off by more shows), past a floor of 1e-6 of the tensor's
    largest update (where 0.9·mu + 0.1·g cancels, the order of the f32
    operations moves the last bits).
(d) ``tools/lockstep_f7.py`` for 50 steps at the smallest width: its
result's keys."""

import importlib.util
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from texpose_tpu.utils.checkpoint import flat_dict_to_tree, tree_to_flat_dict
from test_torch_train_step import (GRAD_REL, LOSS_RTOL, jax_draws,
                                   jax_engine, port_engine, step_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNT = 15000
HORIZON = 20000
WARM = 20
UPDATE_RTOL = 1e-5
UPDATE_FLOOR = 1e-6
B1, B2, RHO = 0.9, 0.999, 0.99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=6,
                            n_test=1, scene="scene_all", image_scale=0.25,
                            crop_res=32)


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    """Fixed random VGG19 weights as an npz of torch state-dict keys, read
    by both engines (``vgg_weights``): the JAX engine then compiles no
    random init for them."""
    from texpose_tpu.nn.vgg import VGG19_CONVS
    rng = np.random.default_rng(0)
    weights = {}
    for idx, cin, cout in VGG19_CONVS:
        weights[f"features.{idx}.weight"] = (rng.normal(
            size=(cout, cin, 3, 3)) * np.sqrt(2.0 / (9 * cin))).astype(
                np.float32)
        weights[f"features.{idx}.bias"] = np.zeros(cout, np.float32)
    path = str(tmp_path_factory.mktemp("vgg") / "vgg19.npz")
    np.savez(path, **weights)
    return path


def _flat(state):
    return {k: np.array(v) for k, v in tree_to_flat_dict(state).items()}


def late_engines(cfg):
    """(JAX engine at the late state, port engine holding it, the late
    state's flat dict, the port's rate at COUNT)."""
    jeng = jax_engine(cfg)
    for _ in range(WARM):
        jeng.state, _ = jeng.step_fn(jeng.state, jeng.train_batch)
    flat = _flat(jeng.state)
    for k in flat:
        if k.startswith(("opt_nerf", "opt_disc")) and k.endswith("count"):
            flat[k] = np.int32(COUNT)
    flat["it"] = np.int32(COUNT)
    jeng.state = flat_dict_to_tree(jeng.state, flat)
    peng = port_engine(cfg, jeng)
    assert peng.it == COUNT
    return jeng, peng, flat


@pytest.fixture(scope="module", params=["base", "latent_ema"])
def late(request, root, vgg_npz, tmp_path_factory):
    """One step on each side from the late state → (cfg, flat before,
    JAX flat after, port flat after, JAX losses, port losses, port
    engine, JAX engine holding the state after)."""
    over = {"max_iter": HORIZON, "vgg_weights": vgg_npz}
    if request.param == "latent_ema":
        over["render.latent_ema"] = 0.999
    cfg = step_cfg(root, tmp_path_factory.mktemp(request.param), **over)
    jeng, peng, before = late_engines(cfg)
    _, draws = jax_draws(cfg, before["key"], len(jeng.train_data), COUNT)
    jeng.state, jloss = jeng.step_fn(jeng.state, jeng.train_batch)
    ploss = peng.train_step(draws)
    return (cfg, before, _flat(jeng.state), peng.train_state_flat(1), jloss,
            ploss, peng, jeng)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _gen_grads(cfg, before, after, peng):
    """{keypath: (port grad, JAX grad from its first moment's update)}."""
    from texpose_tpu_torch.utils.checkpoint import adam_keys
    out = {}
    keys = adam_keys(cfg.optim.get("lr_latent"))
    for (_, named), (_, mu, _, _) in zip(peng._adam_params().items(),
                                         keys.values()):
        for path, p in named:
            g = (after[mu + path].astype(np.float64)
                 - B1 * before[mu + path]) / (1 - B1)
            out[path] = (p.grad.numpy(), g, mu, path)
    return out


def test_losses_match(late):
    _, _, _, _, jloss, ploss, _, _ = late
    assert sorted(jloss) == sorted(ploss)
    for k in jloss:
        np.testing.assert_allclose(float(ploss[k]), float(jloss[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_gradients_match(late):
    cfg, before, after, _, _, _, peng, _ = late
    for path, (got, want, _, _) in _gen_grads(cfg, before, after,
                                              peng).items():
        assert _rel(got, want) <= GRAD_REL, path
    for grp, i, w in peng._disc_leaves():
        key = f"opt_disc/0/nu/{grp}/{i}/w"
        g2 = (after[key].astype(np.float64) - RHO * before[key]) / (1 - RHO)
        assert _rel(w.grad.numpy() ** 2, g2) <= 2 * GRAD_REL, (grp, i)


def test_moments_match(late):
    """Both Adam moments and D's RMSprop ν after the step, within what the
    gradient bound lets through their updates."""
    cfg, before, after, pflat, _, _, peng, _ = late
    for path, (_, g, mu, _) in _gen_grads(cfg, before, after, peng).items():
        nu = mu.replace("/mu/", "/nu/")
        gmax = float(np.abs(g).max())
        np.testing.assert_allclose(pflat[mu + path], after[mu + path],
                                   rtol=0, atol=(1 - B1) * GRAD_REL * gmax
                                   + 1e-12, err_msg=mu + path)
        np.testing.assert_allclose(pflat[nu + path], after[nu + path],
                                   rtol=0, atol=(1 - B2) * 2 * GRAD_REL
                                   * gmax ** 2 + 1e-20, err_msg=nu + path)
    for grp, i, _ in peng._disc_leaves():
        key = f"opt_disc/0/nu/{grp}/{i}/w"
        g2max = float(np.abs((after[key] - RHO * before[key])
                             / (1 - RHO)).max())
        np.testing.assert_allclose(pflat[key], after[key], rtol=0,
                                   atol=(1 - RHO) * 2 * GRAD_REL * g2max
                                   + 1e-20, err_msg=key)


def test_parameters_match_to_the_step_size(late):
    from texpose_tpu.models.optim import generator_schedule
    cfg, before, after, pflat, _, _, peng, _ = late
    spe = max(len(peng.train_data) // cfg.batch_size, 1)
    lr = float(generator_schedule(cfg, HORIZON, spe)(COUNT))
    assert lr < 0.5 * cfg.optim.lr            # the staircase has decayed
    lr_d = cfg.optim_disc.lr
    ema = cfg.render.get("latent_ema")
    assert ("latents_ema/light" in after) == bool(ema)
    assert sorted(pflat) == sorted(list(after) + ["step"])
    for k, v in after.items():
        if k.startswith(("params/nerf/mlp_rgb", "params/nerf/mlp_trans",
                         "latents/", "latents_ema/")):
            np.testing.assert_allclose(pflat[k], v, rtol=0, atol=2 * lr,
                                       err_msg=k)
        elif k.startswith("params/disc/"):
            np.testing.assert_allclose(pflat[k], v, rtol=0, atol=20 * lr_d,
                                       err_msg=k)
        elif k.startswith(("params/nerf/mlp_feat", "sn_state/")):
            np.testing.assert_allclose(pflat[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    if ema:
        # the shadow moved by (1 − d)·(latents' step) from its start
        moved = np.abs(after["latents_ema/light"]
                       - before["latents_ema/light"]).max()
        assert 0 < moved < 1
    assert int(after["it"]) == int(pflat["it"]) == COUNT + 1
    for k in after:
        if k.endswith("count"):
            assert int(after[k]) == COUNT + 1, k


def test_rate_and_bias_correction_at_the_late_count(late):
    """Each side's optimizer applied to one gradient from the carried
    moments at count 15,000: JAX's ``opt_nerf.update`` / ``opt_disc.update``
    and the port's Adam / RMSprop stepping zeroed parameters (whose new
    value is then the update itself) at the device count it = 15,000."""
    import jax
    cfg, before, _, _, _, _, _, jeng = late
    state = flat_dict_to_tree(jeng.state, before)
    fresh = port_engine(cfg, jeng)
    fresh.load_train_state_flat(dict(before, step=np.int32(0)))
    rng = np.random.default_rng(0)

    def draw(tree):
        return jax.tree_util.tree_map(lambda x: rng.normal(
            size=x.shape).astype(np.float32) * 1e-2, tree)

    gen_params = {"heads": {k: v for k, v in state["params"]["nerf"].items()
                            if k != "mlp_feat"},
                  "latents": state["latents"]}
    gen = draw(gen_params)
    upd, _ = jax.jit(jeng.opt_nerf.update)(gen, state["opt_nerf"],
                                           gen_params)
    upd = tree_to_flat_dict(upd)
    d_g = draw(state["params"]["disc"])
    d_upd = tree_to_flat_dict(jax.jit(jeng.opt_disc.update)(
        d_g, state["opt_disc"], state["params"]["disc"])[0])
    g_flat = tree_to_flat_dict(gen)
    dg_flat = tree_to_flat_dict(d_g)
    with torch.no_grad():
        for named in fresh._adam_params().values():
            for path, p in named:
                p.zero_()
                p.grad = torch.from_numpy(np.array(g_flat[path]))
        for grp, i, w in fresh._disc_leaves():
            w.zero_()
            w.grad = torch.from_numpy(np.array(dg_flat[f"{grp}/{i}/w"]))
    assert fresh.it == COUNT
    for opt in (fresh.opt_nerf, fresh.opt_disc):
        opt.step(fresh.it_dev)
    got = {path: p for named in fresh._adam_params().values()
           for path, p in named}
    got.update({f"{grp}/{i}/w": w for grp, i, w in fresh._disc_leaves()})
    want = dict(upd, **d_upd)
    assert sorted(got) == sorted(want)
    for path, p in got.items():
        w = np.asarray(want[path])
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=UPDATE_RTOL,
            atol=UPDATE_FLOOR * float(np.abs(w).max()), err_msg=path)


# ------------------------------------------------------------------- (d)

def test_lockstep_tool_smoke(tmp_path, monkeypatch, vgg_npz):
    """50 steps of tools/lockstep_f7.py at the smallest width: the result
    file's keys, one record per mark and side, finite PSNRs; at 50 steps
    with the JAX draws the port stays next to JAX.  The perceptual term and
    the discriminator are off (their convolutions are nearly all of a CPU
    step here, the GAN's ~250 ms of ~270), and torch runs on one thread
    (beside other test processes its thread pool only spins): the smoke
    holds the tool; the step tests above hold the whole loss set."""
    from texpose_tpu_torch.tools import quality_check as qc
    spec = importlib.util.spec_from_file_location(
        "lockstep_f7", os.path.join(REPO, "tools", "lockstep_f7.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setitem(qc.FIXTURE, "image_scale", 0.25)
    monkeypatch.setitem(qc.FIXTURE, "crop_res", 32)
    monkeypatch.setattr(tool, "N_VIEWS", 6)
    out = tmp_path / "lock.json"
    tiny = ["--arch.layers_feat=[null,32,32,32]",
            "--arch.layers_rgb=[null,32,3]",
            "--arch.layers_trans=[null,32,5]", "--arch.skip=[1]",
            "--arch.posenc.L_3D=4", "--nerf.sample_intvs=8",
            "--nerf.rand_rays=128", "--batch_size=2",
            "--data.image_size=[32,32]", "--loss_weight.feat=null",
            "--gan=null", f"--vgg_weights={vgg_npz}"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = tool.run({"steps": "50", "marks": "25,50", "pretrain": "3",
                        "seed": "0", "out": str(out)}, tiny,
                       log=lambda s: None)
    finally:
        torch.set_num_threads(threads)
    import json
    assert json.load(open(out)) == json.loads(json.dumps(rec))
    assert {"tool", "variant", "width", "pretrain_width", "fixture",
            "pretrain_steps", "steps", "marks", "seed", "sides",
            "distance", "losses", "wall_s", "d"} <= set(rec)
    assert rec["marks"] == [25, 50] and rec["fixture"]["n_train"] == 6
    assert set(rec["sides"]) == {"jax", "port", "port_own"}
    for side, rows in rec["sides"].items():
        assert [r["step"] for r in rows] == [25, 50], side
        for r in rows:
            for k in ("psnr", "psnr_mean", "psnr_topk8", "psnr_anchor",
                      "latent_light_norm_mean", "latent_light_spread",
                      "latent_trans_spread"):
                assert np.isfinite(r[k]), (side, k)
            assert "latent_light_norm_mean" in r["drift"]
    for pair in ("port-jax", "port_own-jax", "port_own-port"):
        for part in ("heads", "latents/light", "latents/trans"):
            d = rec["distance"]["50"][pair][part]
            assert set(d) == {"dist", "moved_a", "moved_b", "rel"}
    lock = rec["distance"]["50"]["port-jax"]
    assert lock["heads"]["rel"] < 0.1 and lock["heads"]["moved_b"] > 0
    assert set(rec["d"]) == {
        "mark", "lockstep_dpsnr_mean", "own_draws_spread_psnr_mean",
        "lockstep_dpsnr_topk8", "own_draws_spread_psnr_topk8",
        "psnr_mean_first_parts_at", "psnr_topk8_first_parts_at", "holds"}
    assert {"pretrain", "jax", "port", "port_own", "marks",
            "total"} <= set(rec["wall_s"])
