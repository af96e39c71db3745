"""The machinery of ``tools/probe_f6.py`` (F6: the texture GAN's decline
after 10k steps, kernel fault or seed noise) on the CPU at a tiny width:

  * two branches of one route, each started through
    ``load_train_state_flat`` of one ``train_state_flat`` snapshot, end
    bit-equal and draw the same draws; the branches of the two routes
    (``kernels.fused_st`` on and off) draw the same draws too;
  * ``chip_smoke.trained_parity`` (the parity checks at a trained state)
    leaves the run unchanged: a branch with a check in the middle ends
    bit-equal to one without;
  * ``delta_table``, ``spread_table`` and ``verdict`` give the
    hand-computed Δ and verdicts on made-up six-seed tables: the noise
    cases and each of the rule's fault cases.
"""

import importlib.util
import os
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--arch.layers_feat=[null,32,32,32]", "--arch.layers_rgb=[null,32,3]",
        "--arch.layers_trans=[null,32,5]", "--arch.skip=[1]",
        "--arch.posenc.L_3D=4", "--nerf.sample_intvs=16",
        "--nerf.rand_rays=256", "--data.image_size=[32,32]",
        "--batch_size=2", "--compute_dtype=float32"]


def _probe():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "probe_f6", os.path.join(REPO, "tools", "probe_f6.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """A tiny texture-GAN engine on the CPU, 2 steps into its run."""
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    from texpose_tpu_torch.tools import quality_check as qc
    tmp = tmp_path_factory.mktemp("f6")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tempfile, "tempdir", str(tmp))
        mp.setitem(qc.FIXTURE, "image_scale", 0.25)
        mp.setitem(qc.FIXTURE, "crop_res", 32)
        cache = qc.fixture(10, True)
        eng = qc.start(TextureGANEngine, qc.gan_cfg(cache, 12, TINY), "cpu")
    finally:
        mp.undo()
    for _ in range(2):
        eng.train_step(eng.make_draws(eng.it))
    return eng


def _branch(eng, snap, steps, route=True, check_at=None):
    """``steps`` steps from ``snap`` loaded → (end state, the draws)."""
    cs = _probe().cs
    eng.load_train_state_flat(snap)
    was = eng.cfg.kernels.get("fused_st")
    eng.cfg.kernels.fused_st = route
    draws = []
    try:
        for i in range(steps):
            if i == check_at:
                res = cs.trained_parity(eng, "gan", "fused_st",
                                        lambda: cs.gan_grads(eng))
                assert res["ok"] and "route" in res
            d = eng.make_draws(eng.it)
            draws.append({k: v.clone() for k, v in d.items()})
            eng.train_step(d)
    finally:
        eng.cfg.kernels.fused_st = was
    return eng.train_state_flat(0), draws


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _same_draws(a, b):
    import torch
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("route", [True, False])
def test_branches_of_one_route_end_bit_equal(engine, route):
    snap = engine.train_state_flat(0)
    digest = _probe().gen_digest
    engine.load_train_state_flat(snap)
    d0 = digest(engine)
    s1, draws1 = _branch(engine, snap, 3, route)
    engine.load_train_state_flat(snap)
    assert digest(engine) == d0
    s2, draws2 = _branch(engine, snap, 3, route)
    _same_state(s1, s2)
    _same_draws(draws1, draws2)
    engine.load_train_state_flat(snap)


def test_branches_of_both_routes_draw_the_same_draws(engine):
    snap = engine.train_state_flat(0)
    _, k = _branch(engine, snap, 3, True)
    _, p = _branch(engine, snap, 3, False)
    _same_draws(k, p)
    engine.load_train_state_flat(snap)


def test_parity_check_leaves_the_run_unchanged(engine):
    snap = engine.train_state_flat(0)
    s1, draws1 = _branch(engine, snap, 3)
    s2, draws2 = _branch(engine, snap, 3, check_at=1)
    _same_state(s1, s2)
    _same_draws(draws1, draws2)
    engine.load_train_state_flat(snap)


def test_parity_checks_every_gan_kernel_on_its_twin(engine):
    """On the CPU every wrapper takes its twin, so each check reads 0 (and
    each f64-distance ratio of ``scale_bound`` 1: kernel and twin are one
    tensor); the dW pair runs only inside a CUDA backward."""
    cs = _probe().cs
    res = cs.trained_parity(engine, "gan", "fused_st",
                            lambda: cs.gan_grads(engine))
    assert sorted(r["kernel"] for r in res["rows"]) == sorted(
        set(cs.GAN_TWINS) - {"dw_pair"})
    assert all(r["ok"] and all(
        r[k] == (1.0 if k.endswith("_f64_ratio") else 0.0)
        for k in r["bounds"]) for r in res["rows"])
    field = next(r for r in res["rows"] if r["kernel"] == "st_field_fwd")
    assert {"e2e_raw_scale_rel", "e2e_raw_f64_ratio", "e2e_feat_scale_rel",
            "e2e_feat_f64_ratio"} <= set(field["bounds"])
    reg = res["regime"]
    assert reg["rays"] == 2 * 256 and 0 <= reg["reach_last"] <= reg["rays"]
    assert 0.0 <= reg["opaque_share"] <= 1.0 and reg["dens_raw_max"] > 0
    groups = res["route"]["groups"]
    assert {"heads/mlp_rgb", "heads/mlp_trans", "latents/light",
            "latents/trans"} <= set(groups)
    assert all(g["cosine"] > 0.999999 for g in groups.values())
    lines = cs.parity_text(res)
    assert len(lines) == len(res["rows"]) + 1
    assert all("[regime: " in ln for ln in lines[:-1])


@pytest.fixture(scope="module")
def full_width_rows():
    """Row 1's inputs at the shipped config's full width, 2 images x 64
    rows: (args of st_field_fwd, the seeded field's kernel weights)."""
    import torch
    from texpose_tpu_torch.nn.fields import init_nerf_st, st_field_inputs
    from texpose_tpu_torch.utils.config import load_yaml, process_options
    cfg = process_options(load_yaml(os.path.join(
        REPO, "configs", "nerf_lm_adapt_gan.yaml")))
    g = torch.Generator().manual_seed(5)
    weights = init_nerf_st(cfg, torch.Generator().manual_seed(0)) \
        .kernel_weights()
    pts = torch.randn(1, 8, 16, 3, generator=g) * 0.3
    ray = torch.randn(1, 8, 3, generator=g)
    xext, encpts = st_field_inputs(cfg, pts, ray / ray.norm(dim=-1,
                                                            keepdim=True),
                                   progress=1.0)
    light = torch.randn(2, int(cfg.nerf.N_latent_light), generator=g)
    trans = torch.randn(2, int(cfg.nerf.N_latent_trans), generator=g)
    return (xext, encpts, light, trans, weights, 64, torch.bfloat16)


def test_forced_walk_on_its_own_planes_reads_zero(full_width_rows):
    """The layer-by-layer comparison (``_forced``) of the walk against
    itself: every layer and raw output agrees exactly, and the plain
    walk's raw outputs are the twin's."""
    import torch
    from texpose_tpu_torch.kernels.st_field import st_field_plain
    cs = _probe().cs
    walk, xe, lrow, trow, pmap, planes, raw = cs._st_planes(
        full_width_rows, {})
    assert len(planes) == 8 + 3 + 3           # trunk and both heads' hidden
    assert cs._forced(walk, xe, planes, pmap, raw, lrow, trow, 64) == (
        0.0, 0.0, 0.0, 0.0)
    ref = st_field_plain(*full_width_rows)
    for a, b in zip(raw, ref):
        assert float((a - b).abs().max()) < 1e-3


@pytest.mark.parametrize("plane", [0, 4, 9])
def test_forced_walk_finds_a_wrong_activation(full_width_rows, plane):
    """One activation of one layer set wrong in the "kernel's" planes: the
    layer-by-layer comparison puts that layer past FEAT_REL."""
    cs = _probe().cs
    walk, xe, lrow, trow, pmap, planes, raw = cs._st_planes(
        full_width_rows, {})
    bad = dict(planes)
    bad[plane] = planes[plane].clone()
    bad[plane][17, 3] += 0.5 + 2 * float(bad[plane][17, 3].abs())
    lrel, lmean, rmax, rmean = cs._forced(walk, xe, bad, pmap, raw, lrow,
                                          trow, 64)
    assert lrel > cs.FEAT_REL


# ------------------------------------------------------ the decision rule

def _rows(values, steps):
    return [{"step": s, "psnr_topk8": v, "psnr_mean": v - 0.5}
            for s, v in zip(steps, values)]


def _recs(deltas20k, base=36.0):
    """Six made-up seeds: the plain branch at `base`, the kernel branch
    `delta` away at 20k and level at 15k."""
    return {s: {"seed": s, "trunk": _rows([35.0, base], [2000, 10000]),
                "kernels": _rows([base, base + d], [15000, 20000]),
                "plain": _rows([base, base], [15000, 20000]), "parity": {}}
            for s, d in enumerate(deltas20k)}


def _parity(g2k=0.004, g20k=0.005, ok=True):
    def at(g, ok_):
        return {"ok": ok_, "rows": [{"kernel": "st_field_bwd", "ok": ok_}],
                "route": {"grad_rel_norm": g}}
    return {s: {"2000": at(g2k, True), "10000": at(g2k, True),
                "15000": at(g2k, True), "20000": at(g20k, ok)}
            for s in range(3)}


NOISE = [0.3, -0.4, 0.1, -0.2, 0.5, -0.6]


def test_delta_table_is_kernel_minus_plain():
    probe = _probe()
    d = probe.delta_table(_recs(NOISE))
    assert sorted(d) == list(range(6))
    for s, want in enumerate(NOISE):
        assert d[s]["psnr_topk8"] == {15000: 0.0, 20000: pytest.approx(want)}
        assert d[s]["psnr_mean"][20000] == pytest.approx(want)


@pytest.mark.parametrize("deltas,parity,kind,why", [
    (NOISE, _parity(), "noise", None),
    # four of six negative and a mean of -0.6: neither clause of (b)
    ([-1.2, -0.9, 0.2, -0.5, 0.1, -1.3], _parity(), "noise", None),
    ([-0.1, -0.2, -0.05, -0.3, -0.1, -0.2], _parity(), "fault",
     "in all 6 seeds"),
    ([-1.5, -1.0, -0.9, 0.2, -0.8, -0.8], _parity(), "fault",
     "mean Δ -0.800 dB"),
    (NOISE, _parity(ok=False), "fault", "st_field_bwd past a bound"),
    # 0.004 -> 0.013: over 3x and past ROUTE_GRAD_NORM / 5 = 0.01
    (NOISE, _parity(0.004, 0.013), "fault", "step-gradient error"),
    # 0.004 -> 0.011 (2.75x) and 0.002 -> 0.009 (under 0.01): noise
    (NOISE, _parity(0.004, 0.011), "noise", None),
    (NOISE, _parity(0.002, 0.009), "noise", None),
])
def test_verdict_on_made_up_tables(deltas, parity, kind, why):
    probe = _probe()
    got, reasons = probe.verdict(probe.delta_table(_recs(deltas)), parity)
    assert got == kind, reasons
    if why is None:
        assert reasons == []
    else:
        assert any(why in r for r in reasons), reasons


def test_verdict_is_incomplete_when_a_check_did_not_run():
    probe = _probe()
    parity = _parity()
    parity[1]["15000"] = {"error": "RuntimeError('x')"}
    got, reasons = probe.verdict(probe.delta_table(_recs(NOISE)), parity)
    assert got == "incomplete"
    assert reasons == ["(c) seed 1 @15000: the check did not run"]


def test_spread_against_qual_h100_r1():
    probe = _probe()
    refs = probe.load_refs()
    assert sorted(refs) == list(range(6))
    recs = {s: {"seed": s, "trunk": [dict(r, psnr_topk8=r["psnr_topk8"]
                                          + 0.25)
                                     for r in refs[s] if r["step"] <= 10000],
                "kernels": [], "plain": [], "parity": {}}
            for s in (0, 4)}
    spread = probe.spread_table(recs, refs)
    for s in (0, 4):
        assert spread[s]["psnr_topk8"] == {2000: pytest.approx(0.25),
                                           10000: pytest.approx(0.25)}
        assert spread[s]["psnr_mean"] == {2000: 0.0, 10000: 0.0}


# ------------------- the field twin against JAX's kernel at trained scale

OUTPUTS = ("rgb_raw", "dens_raw", "trans_raw")


@pytest.fixture(scope="module")
def jax_vs_twin():
    """The shipped texture field (full width, bf16 compute) through JAX's
    field kernel in interpret mode (as tests/test_torch_field.py runs it),
    the port's twin and the twin with f64 sums (``chip_smoke.f64_sums``),
    at the seeded init and with the trunk's weights scaled by 2.5, which
    puts the raw outputs at ~2000 (the F6 runs' trained states read 2200
    for the density): {scale: [(|ref|max, |twin−jax|, |twin−f64|,
    |jax−f64|) per output]}."""
    import jax
    import jax.numpy as jnp
    import torch
    from texpose_tpu.nn import fields as jfields
    from texpose_tpu.utils.config import load_yaml as jload
    from texpose_tpu.utils.config import process_options as jprocess
    from texpose_tpu_torch.nn import fields as tfields
    from texpose_tpu_torch.utils import config as tconfig
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_field import _bridge
    cs = _probe().cs
    path = os.path.join(REPO, "configs", "nerf_lm_adapt_gan.yaml")
    jcfg = jload(path)
    jcfg.yaml = "x"
    jcfg = jprocess(jcfg)
    tcfg = tconfig.process_options(tconfig.load_yaml(path))
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(1, 32, 16, 3)) * 0.3).astype(np.float32)
    ray = rng.normal(size=(1, 32, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    lt = rng.normal(size=(1, 16)).astype(np.float32)
    ll = rng.normal(size=(1, 48)).astype(np.float32)
    t_in = [torch.from_numpy(x) for x in (pts, ray, lt, ll)]
    out = {}
    for scale in (1.0, 2.5):
        jp = dict(jparams)
        jp["mlp_feat"] = jax.tree_util.tree_map(lambda x: x * scale,
                                                jparams["mlp_feat"])
        nerf = _bridge(jp, jcfg)
        ref = jfields.apply_nerf_st_raw(
            jp, jcfg, *map(jnp.asarray, (pts, ray, lt, ll)),
            progress=jnp.asarray(1.0), compute_dtype=jnp.bfloat16,
            tile_fwd=256, tile_bwd=256, interpret=True)
        with torch.no_grad():
            twin = tfields.apply_nerf_st_raw(nerf, tcfg, *t_in, progress=1.0,
                                             compute_dtype=torch.bfloat16)
            with cs.f64_sums():
                exact = tfields.apply_nerf_st_raw(
                    nerf, tcfg, *t_in, progress=1.0,
                    compute_dtype=torch.bfloat16)
        rows = []
        for a, b, e in zip(twin, ref, exact):
            b = torch.from_numpy(np.asarray(b, np.float32)).reshape(a.shape)
            rows.append((float(b.abs().max()), float((a - b).abs().max()),
                         float((a.double() - e).abs().max()),
                         float((b.double() - e).abs().max())))
        out[scale] = rows
    return out


@pytest.mark.parametrize("i", range(3), ids=OUTPUTS)
def test_twin_matches_jax_kernel_at_init_scale(jax_vs_twin, i):
    """At the seeded init (outputs of magnitude ≲ 4) the twin and JAX's
    kernel agree within chip_smoke's FIELD_MAX_ERR."""
    size, err, _, _ = jax_vs_twin[1.0][i]
    assert size < 4 and err <= _probe().cs.FIELD_MAX_ERR


@pytest.mark.parametrize("i", range(3), ids=OUTPUTS)
def test_twin_parts_from_jax_kernel_at_trained_magnitudes(jax_vs_twin, i):
    """At outputs of magnitude ~2000 the twin parts from JAX's own kernel
    by far more than FIELD_MAX_ERR, yet by less than one bf16 step of the
    outputs' scale (2^-7), and neither is nearer the f64-sum arithmetic
    than 3x the other: f32 sums in two orders flip bf16 roundings that
    the layers amplify, as between the CUDA kernel and the twin on the
    card (PERF.md §6, PR 15).  An absolute bound set at init scale cannot
    hold there between any two of these implementations."""
    size, err, twin_f64, jax_f64 = jax_vs_twin[2.5][i]
    assert size > 1000
    assert err > 10 * _probe().cs.FIELD_MAX_ERR
    assert err / size < 2 ** -7
    assert twin_f64 <= 3 * jax_f64 and jax_f64 <= 3 * twin_f64
