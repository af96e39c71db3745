"""Port parity, the training-quality tools
(``texpose_tpu_torch/tools/quality_check.py`` and ``gan_ablate.py``)
against the JAX package's ``tools/tpu_quality_check.py`` and
``tools/gan_ablate.py``, on the CPU:

  * every stage's config, and every variant's, equals the JAX tool's as an
    option dict (only the output root differs: ``texpose_qual_torch*``
    where JAX writes ``texpose_qual*``); the engines are replaced by stubs
    that capture the config they are given;
  * the fixed-light ``scene_qual`` fixture is byte-equal to JAX's, file
    for file, at 3 views;
  * from one state carried across with the npz bridge, the mark
    evaluation's six latent protocols give PSNR within 0.01 dB and SSIM
    within 1e-4 of the JAX tool's (PERF.md §2's frame-parity bounds); the
    JAX side runs its own ``run_variant`` with the step made the
    identity;
  * the summary, the gates and ``drift_20k`` computed from QUAL_r5.json's
    own table equal the JAX ``main``'s arithmetic on that table, and
    QUAL_r5.json itself;
  * both tools run end to end at a tiny width (the pretrain → GAN handoff,
    the gates, the result file's schema, the pretrain's reuse).  At that
    width the pretrain cannot reach the shipped 14 dB gate in a few steps:
    one run shows the gate fires, the others set it to 0 to reach the GAN.
"""

import importlib.util
import json
import os
import sys
import tempfile

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_texture_gan_e2e import tiny_gan_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_TOL = 0.01
SSIM_TOL = 1e-4
TINY = ["--arch.layers_feat=[null,32,32,32]", "--arch.layers_rgb=[null,32,3]",
        "--arch.layers_trans=[null,32,5]", "--arch.skip=[1]",
        "--arch.posenc.L_3D=4", "--nerf.sample_intvs=16",
        "--nerf.rand_rays=256", "--data.image_size=[32,32]",
        "--batch_size=2", "--compute_dtype=float32"]


def _jax_tool(name):
    """tools/<name>.py of the JAX package, imported as a module."""
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tmpdir_(tmp_path, monkeypatch):
    """tempfile.gettempdir() → tmp_path (the tools' caches and runs)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


class _Captured(Exception):
    pass


def _capture(monkeypatch, module, cls_name):
    """Replace module.<cls_name> by a stub whose constructor raises with
    the config it was given."""
    class Stub:
        def __init__(self, cfg, *a, **k):
            raise _Captured(cfg)
    monkeypatch.setattr(module, cls_name, Stub)


def _cfg_of(fn, *args, **kw):
    with pytest.raises(_Captured) as got:
        fn(*args, **kw)
    return got.value.args[0].to_dict()


def _as_jax(port):
    """The port's option dict with its output names mapped to JAX's."""
    s = json.dumps(port, sort_keys=True)
    return json.loads(s.replace("texpose_qual_torch", "texpose_qual"))


def _jax_dict(d):
    return json.loads(json.dumps(d, sort_keys=True))


STAGES = ("pretrain_stage", "gan_stage", "ablate_pretrain")
VARIANT_NAMES = ("base", "latreg", "lab", "nofeat", "latreg_lab", "dlr",
                 "latreg_dlr", "gtpose", "ema", "ema_latreg", "latlr",
                 "latlr3", "nbrreg", "nbrreg1")


@pytest.mark.parametrize("what", STAGES + VARIANT_NAMES)
def test_configs_equal_the_jax_tools(what, tmpdir_, monkeypatch):
    import texpose_tpu.models.pretrain as jp
    import texpose_tpu.models.texture_gan as jt
    import texpose_tpu_torch.models.pretrain as tp
    import texpose_tpu_torch.models.texture_gan as tt
    from texpose_tpu_torch.tools import gan_ablate as ga
    from texpose_tpu_torch.tools import quality_check as qc
    jqc, jga = _jax_tool("tpu_quality_check"), _jax_tool("gan_ablate")
    assert set(jga.VARIANTS) == set(ga.VARIANTS) == set(VARIANT_NAMES)
    for mod, name in ((jp, "PretrainEngine"), (tp, "PretrainEngine"),
                      (jt, "TextureGANEngine"), (tt, "TextureGANEngine")):
        _capture(monkeypatch, mod, name)
    cache = str(tmpdir_ / "cache")
    assert _as_jax(qc.base("nerf_lm_pretrain.yaml", cache).to_dict()) \
        == _jax_dict(jqc._base("nerf_lm_pretrain.yaml", cache).to_dict())
    monkeypatch.setattr(jga, "FIXED_LIGHT", True)
    monkeypatch.setattr(jga, "N_TRAIN", 64)
    root = ga.out_root(True, 64)
    if what == "pretrain_stage":
        j = _cfg_of(jqc.pretrain_stage, cache)
        t = _cfg_of(qc.pretrain_stage, cache, "cpu")
    elif what == "gan_stage":
        j = _cfg_of(jqc.gan_stage, cache)
        t = _cfg_of(qc.gan_stage, cache, "cpu")
    elif what == "ablate_pretrain":
        j = _cfg_of(jga.pretrain, cache, 20000)
        t = _cfg_of(ga.pretrain, cache, 20000, "cpu", root)
    else:
        j = _cfg_of(jga.run_variant, cache, what, jga.VARIANTS[what], 20000,
                    [2000, 10000, 20000], seed=2)
        t = _cfg_of(ga.run_variant, cache, what, ga.VARIANTS[what], 20000,
                    [2000, 10000, 20000], "cpu", root, seed=2)
        assert t["seed"] == 2 and t["name"] == f"abl_{what}_seed2"
    assert "texpose_qual_torch" in t["output_path"]
    assert _as_jax(t) == _jax_dict(j)


def test_fixture_is_byte_equal_to_jax(tmpdir_, monkeypatch):
    from texpose_tpu_torch.tools import quality_check as qc
    jga = _jax_tool("gan_ablate")
    monkeypatch.setattr(jga, "N_TRAIN", 3)
    j = jga._fixture_fl()
    t = qc.fixture(3, fixed_light=True)
    assert j != t and os.path.basename(t) == "texpose_qual_torch_fixture_fl3"
    files = sorted(os.path.relpath(os.path.join(d, f), j)
                   for d, _, fs in os.walk(j) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), t)
                           for d, _, fs in os.walk(t) for f in fs)
    assert len(files) > 50
    for f in files:
        with open(os.path.join(j, f), "rb") as a, \
                open(os.path.join(t, f), "rb") as b:
            assert a.read() == b.read(), f


# ------------------------------------------------ the mark evaluation

def _tiny(root, out):
    cfg = tiny_gan_cfg(root, out)
    cfg.data.scene = "scene_qual"
    cfg.render.light = "topk_mean"
    cfg.render.N_candidate = 8
    return cfg


@pytest.fixture(scope="module")
def marks(tmp_path_factory):
    """The JAX tool's mark evaluation (its run_variant, one identity step)
    and the port's ``mark_eval`` on the same state → (jax ev, port ev)."""
    import jax
    from texpose_tpu.data.fixture import generate_fixture
    from texpose_tpu.models.texture_gan import TextureGANEngine
    from texpose_tpu.nn.fields import init_nerf_st
    from texpose_tpu.utils.checkpoint import save_checkpoint
    from texpose_tpu_torch.models.texture_gan import \
        TextureGANEngine as PortEngine
    from texpose_tpu_torch.tools import gan_ablate as ga

    tmp = tmp_path_factory.mktemp("qual_marks")
    root = generate_fixture(str(tmp / "bop"), n_train=10, n_test=1,
                            scene="scene_qual", image_scale=0.25,
                            crop_res=32, fixed_light=True)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tempfile, "tempdir", str(tmp))
        jga = _jax_tool("gan_ablate")
        mp.setattr(jga, "_base",
                   lambda yaml_name, cache: _tiny(cache, tmp / "unused"))
        mp.setattr(jga, "FIXED_LIGHT", True)
        mp.setattr(jga, "N_TRAIN", 10)
        cfg0 = _tiny(root, tmp)
        group_dir = os.path.join(jga._out_root(), str(cfg0.group))
        save_checkpoint(group_dir, {"params": {"nerf": init_nerf_st(
            jax.random.PRNGKey(7), cfg0)}})
        os.replace(os.path.join(group_dir, "model.ckpt"),
                   os.path.join(group_dir, "pretrain_model.ckpt"))
        engines = []
        setup = TextureGANEngine.setup_optimizer

        def identity_step(self):
            setup(self)
            engines.append(self)
            self.step_fn = lambda state, batch: (state, {"all": 0.0})
        mp.setattr(TextureGANEngine, "setup_optimizer", identity_step)
        (mark, ev_j), = jga.run_variant(root, "base", {}, 1, [1], seed=0)
        assert mark == 1 and ev_j["step_actual"] == 1
        state = engines[0].state
        # the latents spread so the protocols pick different rows
        n = len(engines[0].train_data)
        state["latents"] = {
            "trans": np.asarray(state["latents"]["trans"]),
            "light": np.asarray(state["latents"]["light"])}
        assert n >= 8 and state["latents"]["light"].std() > 0.5
    finally:
        mp.undo()

    tcfg = _tiny(root, tmp / "port")
    tcfg.resume = True
    save_checkpoint(tcfg.output_path, state)
    eng = PortEngine(tcfg, "cpu")
    eng.load_dataset()
    eng.build_networks()
    assert eng.restore_checkpoint()
    ev_t = ga.mark_eval(eng)
    assert eng.cfg.render.light == "topk_mean"
    assert eng.cfg.render.N_candidate == 8
    return ev_j, ev_t


@pytest.mark.parametrize("tag", ["", "_anchor", "_mean", "_topk8",
                                 "_topk8med", "_topk8rob"])
def test_mark_protocols_match_jax(marks, tag):
    ev_j, ev_t = marks
    assert set(ev_t) | {"step_actual"} == set(ev_j)
    assert abs(ev_t["psnr" + tag] - ev_j["psnr" + tag]) < PSNR_TOL, tag
    assert abs(ev_t["ssim" + tag] - ev_j["ssim" + tag]) < SSIM_TOL, tag


def test_mark_protocols_differ(marks):
    """The state makes the protocols disagree (the test above compares
    six different renders, not one)."""
    _, ev = marks
    assert len({round(ev[k], 3) for k in ev if k.startswith("psnr")}) >= 3


# -------------------------------------------------------- the summary

def test_summary_matches_jax_main_on_qual_r5(tmp_path, monkeypatch):
    from texpose_tpu_torch.tools import gan_ablate as ga
    r5_path = os.path.join(REPO, "QUAL_r5.json")
    r5 = json.load(open(r5_path))
    table = ga.table_from_json(r5)
    jga = _jax_tool("gan_ablate")
    monkeypatch.setattr(jga, "FIXED_LIGHT", r5["fixture"]["fixed_light"])
    monkeypatch.setattr(jga, "N_TRAIN", r5["fixture"]["n_train"])
    monkeypatch.setattr(jga, "_get_fixture", lambda: "unused")
    monkeypatch.setattr(jga, "pretrain", lambda cache, iters: None)
    monkeypatch.setattr(
        jga, "run_variant",
        lambda cache, name, ov, iters, eval_at, seed=0: table[name][seed])
    monkeypatch.setenv("ABL_VARIANTS", ",".join(r5["variants"]))
    monkeypatch.setenv("ABL_SEEDS", ",".join(
        str(s) for s in r5["fixture"]["seeds"]))
    monkeypatch.setenv("ABL_PRETRAIN_ITERS",
                       str(r5["fixture"]["pretrain_iters"]))
    monkeypatch.setenv("ABL_GAN_ITERS", str(r5["fixture"]["gan_iters"]))
    monkeypatch.setenv("ABL_JSON", str(tmp_path / "jax.json"))
    jga.main()
    want = json.load(open(tmp_path / "jax.json"))

    got = json.loads(json.dumps(ga.summarize(table, r5["fixture"])))
    assert got == want
    # QUAL_r5.json itself: the same seed means (within the rounding of its
    # stored 4-digit table), gates and per-seed 20k declines
    assert got["mean_psnr"] == r5["mean_psnr"]
    for field, g in r5["protocol_gates"].items():
        mine = got["protocol_gates"][field]
        assert {k: v for k, v in mine.items() if k != "mean_psnr"} == {
            k: v for k, v in g.items() if k != "mean_psnr"}, field
        for m, v in g["mean_psnr"].items():
            assert abs(mine["mean_psnr"][m] - v) <= 1e-4, (field, m)
    for k in ("per_seed", "spread_20k", "protocol"):
        assert got["drift_20k"]["base"][k] == r5["drift_20k"]["base"][k]
    for k in ("gate_10k_ge_2k", "gate_20k_ge_10k_minus_1db"):
        assert got[k] is r5[k] is True
    assert got["protocol_gates"]["psnr_topk8"]["gate_10k_ge_2k"] is True
    assert set(got["drift_20k"]["base"]["per_seed"]) == {"0", "1", "2"}

    # --merge of the per-seed files gives the same result
    paths = []
    for s in r5["fixture"]["seeds"]:
        one = ga.summarize({n: {s: rbs[s]} for n, rbs in table.items()},
                           dict(r5["fixture"], seeds=[s]))
        paths.append(str(tmp_path / f"s{s}.json"))
        ga.write_json(paths[-1], one)
    monkeypatch.setenv("ABL_JSON", str(tmp_path / "merged.json"))
    ga.main(["--merge", *paths])
    assert json.load(open(tmp_path / "merged.json")) == want


def test_merge_refuses_other_fixtures(tmp_path):
    from texpose_tpu_torch.tools import gan_ablate as ga
    r5 = json.load(open(os.path.join(REPO, "QUAL_r5.json")))
    other = dict(r5, fixture=dict(r5["fixture"], n_train=16))
    for name, doc in (("a", r5), ("b", other)):
        ga.write_json(str(tmp_path / f"{name}.json"), doc)
    with pytest.raises(ValueError, match="fixture"):
        ga.merge_files([str(tmp_path / "a.json"), str(tmp_path / "b.json")])


# ------------------------------------------------------- end to end

@pytest.fixture
def tiny_fixture(tmpdir_, monkeypatch):
    from texpose_tpu_torch.tools import quality_check as qc
    monkeypatch.setitem(qc.FIXTURE, "image_scale", 0.25)
    monkeypatch.setitem(qc.FIXTURE, "crop_res", 32)
    return tmpdir_


def test_quality_check_gates_fire_at_a_tiny_width(tiny_fixture,
                                                  monkeypatch):
    from texpose_tpu_torch.tools import quality_check as qc
    monkeypatch.setenv("QUAL_PRETRAIN_ITERS", "40")
    with pytest.raises(AssertionError, match="PSNR"):
        qc.main(["--device=cpu", *TINY])


def test_quality_check_runs_both_stages(tiny_fixture, monkeypatch, capsys):
    import torch
    from texpose_tpu_torch.tools import quality_check as qc
    from texpose_tpu_torch.utils.checkpoint import load_checkpoint_flat
    monkeypatch.setattr(qc, "PRETRAIN_MIN_PSNR", 0.0)
    monkeypatch.setenv("QUAL_PRETRAIN_ITERS", "40")
    monkeypatch.setenv("QUAL_GAN_ITERS", "22")
    out = qc.main(["--device=cpu", *TINY])
    pre, gan = out["pretrain"], out["gan"]
    assert pre["last"] < 0.9 * pre["first"]
    assert os.path.exists(pre["ckpt"]) and gan["first"] is not None
    assert pre["ckpt"].startswith(str(tiny_fixture / "texpose_qual_torch"))
    # the handoff: the GAN's trunk is the pretrain's, bit for bit
    flat = load_checkpoint_flat(pre["ckpt"])
    for k, v in gan["engine"].nerf.mlp_feat.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), flat["params/nerf/mlp_feat/" + k.replace(".", "/")])
    assert gan["engine"].it == 22 and pre["engine"].it == 40
    assert all(np.isfinite(v) for v in gan["last"].values())
    assert np.isfinite(gan["eval"]["psnr"])
    text = capsys.readouterr().out
    assert "PRETRAIN: loss" in text and "GAN eval_full" in text
    # QUAL_SKIP_PRETRAIN reuses the trunk; no card and no --device=cpu
    # raises before anything runs
    monkeypatch.setenv("QUAL_SKIP_PRETRAIN", "1")
    monkeypatch.setenv("QUAL_SKIP_GAN", "1")
    assert qc.main(["--device=cpu", *TINY]) == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device=cpu"):
            qc.main(TINY)


def test_gan_ablate_writes_the_qual_schema(tiny_fixture, monkeypatch,
                                           capsys):
    import torch
    from texpose_tpu_torch.tools import gan_ablate as ga
    from texpose_tpu_torch.tools import quality_check as qc
    monkeypatch.setattr(qc, "PRETRAIN_MIN_PSNR", 0.0)
    monkeypatch.setenv("ABL_FIXED_LIGHT", "1")
    monkeypatch.setenv("ABL_NTRAIN", "8")
    monkeypatch.setenv("ABL_PRETRAIN_ITERS", "10")
    monkeypatch.setenv("ABL_GAN_ITERS", "4")
    monkeypatch.setenv("ABL_EVAL_AT", "2,4")
    monkeypatch.setenv("ABL_VARIANTS", "base")
    monkeypatch.setenv("ABL_SEEDS", "0,1")
    monkeypatch.setenv("ABL_JSON", str(tiny_fixture / "q.json"))
    # two steps a dispatch, so each mark is a dispatch boundary (the
    # default K, gcd(100, 4) = 4, fires the mark at 2 at step 4)
    scan = "--scan_steps=2"
    out = ga.main(["--device=cpu", *TINY, scan])
    doc = json.load(open(tiny_fixture / "q.json"))
    assert doc == json.loads(json.dumps(out))
    r5 = json.load(open(os.path.join(REPO, "QUAL_r5.json")))
    # the gates need marks at 2k, 10k and 20k
    assert list(doc) == [k for k in r5 if not k.startswith("gate_")]
    assert doc["fixture"] == {"fixed_light": True, "n_train": 8,
                              "pretrain_iters": 10, "gan_iters": 4,
                              "seeds": [0, 1]}
    rows = doc["variants"]["base"]
    assert [r["step"] for r in rows["0"]] == [2, 4] == [
        r["step_actual"] for r in rows["1"]]
    assert set(rows["0"][0]) == set(r5["variants"]["base"]["0"][0])
    assert all(np.isfinite(v) for r in rows["0"] + rows["1"]
               for v in r.values())
    assert set(doc["protocol_gates"]) == set(ga.PROTOCOLS)
    assert doc["drift_20k"] == {}       # no 20k mark at 4 steps
    assert os.path.exists(os.path.join(
        ga.out_root(True, 8), "Duck", "pretrain_model.ckpt.abl10"))
    assert "=== SUMMARY" in capsys.readouterr().out
    # a second run reuses the pretrain; a run without a card and without
    # --device=cpu raises before anything runs
    monkeypatch.setenv("ABL_SEEDS", "1")
    monkeypatch.setenv("ABL_EVAL_AT", "2")
    monkeypatch.setenv("ABL_JSON", str(tiny_fixture / "q1.json"))
    again = ga.main(["--device=cpu", *TINY, scan])
    assert "PRETRAIN: reusing" in capsys.readouterr().out
    assert again["variants"]["base"]["1"][0] == rows["1"][0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device=cpu"):
            ga.main(TINY)
