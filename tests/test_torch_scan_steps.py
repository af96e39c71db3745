"""The port's K-step dispatch (models/step_graph.py ``StepRunner``, the
counterpart of the JAX package's ``finalize_step`` / ``Engine.scan_k``)
and the device-resident step state it rests on, on the CPU (every step
eager; the captured CUDA graph runs on the card: chip_smoke.py's ``scan``
phase).

  * ``scan_k()`` equals the JAX engine's over a grid of freq.* / max_iter
    settings, and K = 10 dispatches equal 20 single steps exactly (loss,
    count, parameters), as tests/test_scan_steps.py holds JAX's;
  * one K = 10 dispatch of the port against JAX's ``finalize_step(step,
    10)`` from one state, on the draws of JAX's key splits
    (tests/test_torch_pretrain_step.py ``jax_draws``): the last losses,
    the parameters and the Adam moments within the bounds below;
  * the device step state equals the host values it replaced at counts 0,
    1, 10k, 15k and max_iter − 1: the rate tables (every count of the
    horizon), the c2f progress as float32 and the patch-scale bounds;
  * the new optimizers equal optax's updates at counts 0 and 15,000, and a
    count past the rate table reads its last rate;
  * after a warm-up step, no step reads the host or builds a tensor from
    host data (what a CUDA graph cannot replay);
  * a kernel weight pack stays until its parameters' versions move, and
    rebuilds once they are bumped (what the runner does after a replay).

Ten steps' tolerances.  One step from one state agrees to rtol 1e-4 in
the losses and 2e-3 in the gradients (tests/test_torch_pretrain_step.py);
ten chained steps do not: Adam's first updates move an element by ≈ ±lr
whatever |g|, so where g is near zero the two sides step apart by 2·lr
(lr = 5e-3 here), and the render loss parts by ~1e-3 at step 10, as
much for ten single steps of each side as for the dispatches (the
dispatch adds nothing: it equals the single steps bit for bit above).  So
the losses are held to the chained-steps bound of
tests/test_torch_train_step.py (CHAIN_RTOL, 2e-2), a parameter leaf's
displacement from the shared init to JAX's (‖Δp_port − Δp_jax‖ ≤
DISP_REL·‖Δp_jax‖; a step that skipped the update reads 1, one of the
wrong sign 2), and Adam's first and second moments to (1 − β1^K) and
(1 − β2^K)·2 times CHAIN_RTOL of max|g| and max|g|²: the one-step moment
bounds of tests/test_torch_late_state.py summed over the K updates, with
the gradients' distance CHAIN_RTOL instead of one step's 2e-3 and max|g|
bounded from JAX's second moment."""

import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from test_torch_pretrain_step import (jax_draws,
                                      jax_engine, port_engine, step_cfg)
from test_torch_train_step import CHAIN_RTOL
from torch_host_audit import host_reads

K = 10
B1, B2, RHO = 0.9, 0.999, 0.99
UPDATE_RTOL = 1e-5          # tests/test_torch_late_state.py
UPDATE_FLOOR = 1e-6
# ‖Δp_port − Δp_jax‖ / ‖Δp_jax‖ per parameter leaf after the K = 10
# dispatch: 0.0012 … 0.036 over the 14 leaves (measured on the CPU)
DISP_REL = 0.1
COUNTS = (0, 1, 10000, 15000)
HORIZON = 20000


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=4,
                            n_test=2, scene="scene_all", image_scale=0.25,
                            crop_res=32)


@pytest.fixture(autouse=True)
def one_thread():
    """Many small CPU steps: one torch thread beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_pretrain(cfg):
    from texpose_tpu_torch.models import get_engine
    eng = get_engine(cfg.model)(cfg, "cpu")
    eng.load_dataset()
    eng.upload_train_split()
    eng.build_networks()
    eng.setup_optimizer()
    return eng


class _Stub:
    def __init__(self, cfg, max_iter):
        self.cfg, self._max_iter = cfg, max_iter

    def max_iter(self):
        return self._max_iter


GRID = [(scan, scalar, val, ckpt, vis, max_iter)
        for scan in (1, 20, 100)
        for scalar, val, ckpt, vis in ((100, 10000, 10000, None),
                                       (5, 1000, 1000, 10),
                                       (30, 750, 2500, None))
        for max_iter in (30, 20000, 50003)]


@pytest.mark.parametrize("scan,scalar,val,ckpt,vis,max_iter", GRID)
def test_scan_k_matches_jax(root, tmp_path, scan, scalar, val, ckpt, vis,
                            max_iter):
    from texpose_tpu.models.base import Engine as JEngine
    from texpose_tpu_torch.models.base import Engine
    cfg = step_cfg(root, tmp_path)
    cfg.scan_steps = scan
    cfg.freq = {"scalar": scalar, "val": val, "ckpt": ckpt, "vis": vis}
    stub = _Stub(cfg, max_iter)
    want = JEngine.scan_k(stub)
    assert Engine.scan_k(stub) == want
    assert max_iter % want == 0 and all(
        f % want == 0 for f in (scan, scalar, val, ckpt, vis) if f)


def test_scan_gcd_clamp(root, tmp_path):
    cfg = step_cfg(root, tmp_path)
    cfg.scan_steps = 20
    cfg.freq.scalar = 5          # forces the gcd clamp to 5
    cfg.max_iter = 30
    assert port_pretrain(cfg).scan_k() == 5


def test_scan_equivalence(root, tmp_path):
    """K = 10 dispatches and 20 single steps from one seed: the same last
    loss, count and parameters."""
    res = {}
    for k in (1, K):
        cfg = step_cfg(root, tmp_path / f"k{k}")
        cfg.scan_steps = k
        cfg.max_iter = 20
        eng = port_pretrain(cfg)
        assert eng.scan_k() == k
        runner = eng.step_runner()
        for _ in range(20 // k):
            loss = runner.dispatch(k)
        res[k] = (float(loss["all"]), eng.it, int(eng.it_dev),
                  eng.nerf.mlp_feat[0].w.detach().clone())
    assert res[1][1] == res[K][1] == res[1][2] == res[K][2] == 20
    assert res[1][0] == res[K][0]
    np.testing.assert_allclose(res[K][3].numpy(), res[1][3].numpy(),
                               atol=1e-6)


def test_train_logs_where_jax_logs(root, tmp_path):
    """The training loop at K = 10: scalars after the first dispatch and
    at every freq.scalar, the steps JAX's loop logs."""
    import json
    cfg = step_cfg(root, tmp_path)
    cfg.scan_steps = 10
    cfg.max_iter = 40
    cfg.freq = {"scalar": 20, "val": 40, "ckpt": 40, "vis": None}
    eng = port_pretrain(cfg)
    eng.train()
    recs = [json.loads(ln) for ln in
            open(os.path.join(cfg.output_path, "metrics.jsonl"))]
    steps = [r["step"] for r in recs if r["split"] == "train"]
    # JAX: done = it + K over range(0, 40, 10); logged at it == start and
    # done % 20 == 0
    assert steps == [10, 20, 40]
    assert eng.it == 40 and int(eng.it_dev) == 40


def test_dispatch_matches_jax_finalize_step(root, tmp_path):
    """One dispatch of K = 10 steps on each side from the JAX init: JAX's
    ``finalize_step(step, 10)`` (a lax.scan) and the port's runner on the
    draws of JAX's key splits."""
    cfg = step_cfg(root, tmp_path)
    cfg.scan_steps = K
    jeng = jax_engine(cfg)
    peng = port_engine(cfg, jeng)
    assert jeng.scan_k() == peng.scan_k() == K
    B = len(jeng.train_data)
    key, draws = jeng.state["key"], []
    for _ in range(K):
        key, d = jax_draws(cfg, key, B)
        draws.append(d)
    init = tree_to_flat_dict(jax.device_get(jeng.state))
    state, jloss = jeng.step_fn(jeng.state, jeng.train_batch)
    after = tree_to_flat_dict(jax.device_get(state))
    feed = iter(draws)
    ploss = peng.step_runner().dispatch(K, lambda it: next(feed))
    assert sorted(jloss) == sorted(ploss)
    for k in jloss:
        np.testing.assert_allclose(float(ploss[k]), float(jloss[k]),
                                   rtol=CHAIN_RTOL, err_msg=k)
    flat = peng.train_state_flat(K)
    assert peng.it == int(after["it"]) == int(flat["it"]) == K
    n_mu = n_nu = 0
    for k, v in after.items():
        if k.startswith("params/"):
            d_j = np.asarray(v, np.float64) - init[k]
            d_p = np.asarray(flat[k], np.float64) - init[k]
            assert np.linalg.norm(d_p - d_j) <= DISP_REL * np.linalg.norm(
                d_j), k
        elif "/mu/" in k:
            nu = after[k.replace("/mu/", "/nu/")].astype(np.float64)
            gmax = math.sqrt(float(nu.max()) / (1 - B2) / B2 ** (K - 1))
            np.testing.assert_allclose(
                flat[k], v, rtol=0,
                atol=(1 - B1 ** K) * CHAIN_RTOL * gmax + 1e-12, err_msg=k)
            n_mu += 1
        elif "/nu/" in k:
            gmax2 = float(v.max()) / (1 - B2) / B2 ** (K - 1)
            np.testing.assert_allclose(
                flat[k], v, rtol=0,
                atol=(1 - B2 ** K) * 2 * CHAIN_RTOL * gmax2 + 1e-20,
                err_msg=k)
            n_nu += 1
        elif k.endswith("count"):
            assert int(flat[k]) == int(v) == K, k
    assert n_mu == n_nu == len(peng._all_params())


def _gan_engine(root, tmp_path, max_iter):
    from test_torch_train_step import step_cfg as gan_cfg
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    cfg = gan_cfg(root, tmp_path, **{"optim.lr_end": 1e-4,
                                     "optim_disc.lr_end": 1e-5,
                                     "max_iter": max_iter})
    eng = TextureGANEngine(cfg, "cpu")
    eng.load_dataset()
    eng.upload_train_split()
    eng.build_networks()
    eng.setup_optimizer()
    return eng


@pytest.mark.parametrize("engine", ["gan", "pretrain", "pretrain_c2f",
                                    "env"])
def test_device_state_equals_host_values(root, tmp_path, engine):
    """At counts 0, 1, 10k, 15k and max_iter − 1: every group's rate table
    entry equals the host schedule's rate (and the whole table does), the
    device progress equals float32(it / max_iter) and the patch-scale
    bounds from the device count equal those from the host count."""
    from texpose_tpu_torch.sampling.patch import scale_bounds
    if engine == "gan":
        eng = _gan_engine(root, tmp_path, HORIZON)
    else:
        over = {"c2f": [0.1, 0.5]} if engine == "pretrain_c2f" else {}
        cfg = step_cfg(root, tmp_path, env=engine == "env", **over)
        cfg.max_iter = HORIZON
        eng = port_pretrain(cfg)
    for opt in eng.optimizers():
        for g in opt.param_groups:
            want = np.asarray([g["schedule"](c) for c in range(HORIZON)],
                              np.float32)
            np.testing.assert_array_equal(g["lr_table"].numpy(), want)
    anneal = dict(min_scale=0.25, max_scale=1.0, scale_anneal=0.0002)
    decayed = False
    for c in COUNTS + (HORIZON - 1,):
        eng.set_step(c)
        assert eng.it == int(eng.it_dev) == c
        assert eng.progress().dtype == torch.float32
        assert float(eng.progress()) == float(np.float32(c / HORIZON))
        for opt in eng.optimizers():
            for g in opt.param_groups:
                assert float(opt._rate(g, eng.it_dev)) == -float(
                    np.float32(g["schedule"](c)))
                decayed |= g["schedule"](c) < g["schedule"](0)
        dev = [float(t) for t in scale_bounds(eng.it_dev, **anneal)]
        host = [float(t) for t in scale_bounds(c, **anneal)]
        assert dev == host, (c, dev, host)
    assert decayed


def _optax_case(kind, count, staircase, rng):
    import optax
    shape = (5, 7)
    mu = rng.normal(size=shape).astype(np.float32) * 1e-2
    nu = np.abs(rng.normal(size=shape)).astype(np.float32) * 1e-4
    g = rng.normal(size=shape).astype(np.float32) * 1e-2
    sched = optax.exponential_decay(1e-3, 8, 0.999, staircase=staircase)
    opt = (optax.adam(sched) if kind == "adam" else
           optax.rmsprop(sched, decay=RHO, eps=1e-8, eps_in_sqrt=False))
    moments = {"mu": mu, "nu": nu} if kind == "adam" else {"nu": nu}
    st = tuple(
        s._replace(**{k: v for k, v in dict(moments,
                                             count=np.int32(count)).items()
                      if k in getattr(s, "_fields", ())})
        for s in opt.init(np.zeros(shape, np.float32)))
    upd, _ = jax.jit(opt.update)(g, st)
    return mu, nu, g, np.asarray(upd)


def _optimizer(kind, p, staircase, horizon):
    from texpose_tpu_torch.models.optim import Adam, RMSprop, _exp_decay
    group = [{"params": [p],
              "schedule": _exp_decay(1e-3, 0.999, 8, staircase)}]
    return (Adam if kind == "adam" else RMSprop)(group, horizon)


@pytest.mark.parametrize("kind", ["adam", "rmsprop"])
@pytest.mark.parametrize("count", [0, 15000])
@pytest.mark.parametrize("staircase", [True, False])
def test_optimizer_matches_optax(kind, count, staircase):
    """One update from moments at ``count`` on a zero parameter (its new
    value is the update): optax's, and the port's with the rate from its
    table at the device count, on a staircase and a continuous decay."""
    rng = np.random.default_rng(count + len(kind))
    mu, nu, g, want = _optax_case(kind, count, staircase, rng)
    p = torch.zeros(mu.shape, requires_grad=True)
    opt = _optimizer(kind, p, staircase, count + 1)
    st = {"step": torch.tensor(float(count))}
    if kind == "adam":
        st.update(exp_avg=torch.from_numpy(mu.copy()),
                  exp_avg_sq=torch.from_numpy(nu.copy()))
    else:
        st.update(square_avg=torch.from_numpy(nu.copy()))
    opt.state[p] = st
    p.grad = torch.from_numpy(g)
    opt.step(torch.tensor(count))
    assert float(opt.state[p]["step"]) == count + 1
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=UPDATE_RTOL,
                               atol=UPDATE_FLOOR * float(np.abs(want).max()))


def test_rate_past_the_horizon_keeps_the_last():
    """A count past the table (a tool stepping on after max_iter) reads
    the horizon's last rate."""
    p = torch.zeros(3, requires_grad=True)
    opt = _optimizer("adam", p, True, 100)
    table = opt.param_groups[0]["lr_table"]
    assert table.shape == (100,)
    for c in (99, 100, 15000):
        assert float(opt._rate(opt.param_groups[0], torch.tensor(c))) \
            == -float(table[99])
    assert float(table[99]) < float(table[0])


def _host_reads(eng):
    """The host interactions of one step (``torch_host_audit``)."""
    return host_reads(lambda: eng.train_step(eng.make_draws(eng.it)))


@pytest.mark.parametrize("route", ["pretrain", "pretrain_c2f_noise",
                                   "two_kernel", "hierarchical", "env",
                                   "gan", "gan_st_mega"])
def test_step_reads_nothing_from_host(root, tmp_path, route):
    """After one warm-up step a training step of each route builds no
    tensor from host data and reads none back: what a captured graph could
    not replay (on the card such a call fails the capture)."""
    if route.startswith("gan"):
        eng = _gan_engine(root, tmp_path, 300)
        if route == "gan_st_mega":
            eng.cfg.kernels = {"st_mega": True}
    else:
        over = {"two_kernel": {"kernels.coarse_mega": False},
                "pretrain_c2f_noise": {"c2f": [0.1, 0.5],
                                       "nerf.density_noise_reg": 0.5},
                "hierarchical": {"nerf.fine_sampling": True,
                                 "nerf.sample_intvs_fine": 16,
                                 "loss_weight.render_fine": 0}}.get(route,
                                                                    {})
        eng = port_pretrain(step_cfg(root, tmp_path, env=route == "env",
                                     **over))
    eng.train_step(eng.make_draws(eng.it))
    assert _host_reads(eng) == []
    assert eng.it == int(eng.it_dev) == 2


def test_pack_cache_follows_versions(root, tmp_path):
    """The coarse field's kernel walk is kept while its parameters'
    versions stand (a replay writes the values without moving them) and
    rebuilt from the current values once the runner bumps them."""
    from texpose_tpu_torch.models.step_graph import bump_versions
    eng = port_pretrain(step_cfg(root, tmp_path, **{
        "arch.layers_feat": [None, 256, 256, 256], "arch.skip": []}))
    weights = eng.nerf.kernel_weights()
    walk = weights.trunk_walk(39)
    assert weights.trunk_walk(39) is walk
    w0 = weights.trunk[0].w
    with torch.no_grad():
        w0.data.add_(1.0)                 # as a replay: no version bump
    assert weights.trunk_walk(39) is walk
    bump_versions(eng.step_params())
    fresh = weights.trunk_walk(39)
    assert fresh is not walk
    assert not torch.equal(fresh.tiles.wide, walk.tiles.wide)
