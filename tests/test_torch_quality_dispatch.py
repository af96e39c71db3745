"""The training loops of the port's quality tools dispatch K =
``scan_k()`` steps at a time through the engine's ``StepRunner``, with
the JAX tools' accounting (``tools/tpu_quality_check.py``,
``tools/gan_ablate.py``: ``for it in range(0, max_iter, K)`` over
``step_fn``), on the CPU:

  * ``quality_check``'s two stages and ``gan_ablate``'s pretrain and
    ``run_variant`` against the JAX tools on the same configs with
    ``scan_steps`` 5: the same K, the same dispatch count, the same step
    of the "first" loss, and the same (mark, step_actual) pairs for marks
    {10, 23}.  At max_iter 23 ``scan_k`` clamps K to 1 (gcd with
    max_iter); at 25 and 30 K is 5 and the mark at 23 fires at the
    dispatch boundary 25.  The engines are stubs, in both packages, that
    keep each package's own ``scan_k`` and count the dispatches; a loss
    of the stub encodes the step it was read at;
  * ``tools/probe_f6.py``'s ``_steps`` dispatches K at a time, ends at its
    end and fires each mark once, at the first dispatch boundary at or
    past it.
"""

import importlib.util
import os
import re
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAN = 5
MARKS = [10, 23]


def _jax_tool(name):
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _losses(done):
    # "all" falls (the pretrain gates), "render" is the step itself
    return {"all": 1.0 / done, "render": float(done)}


class _Stub:
    """An engine that trains nothing: its package's ``scan_k``, stub
    evaluations, a checkpoint file, and a count of what ran."""
    created = []

    def __init__(self, cfg, *args):
        self.cfg = cfg
        self.it = 0
        self.dispatches = []
        self.evals = []
        os.makedirs(cfg.output_path, exist_ok=True)
        _Stub.created.append(self)

    def _nothing(self, *a, **k):
        pass

    load_dataset = upload_train_split = build_networks = _nothing
    setup_optimizer = restore_pretrained_checkpoint = _nothing

    def max_iter(self):
        return int(self.cfg.max_iter)

    def _dispatch(self, k):
        self.it += k
        self.dispatches.append(k)
        return _losses(self.it)

    def validate(self, it):
        return {"PSNR": 99.0}

    def evaluate_full(self):
        self.evals.append(self.it)
        return {"psnr": 30.0, "ssim": 0.9}

    def save_checkpoint(self, it):
        open(os.path.join(self.cfg.output_path, "model.ckpt"), "w").close()


def _jax_stub():
    from texpose_tpu.models.base import Engine

    class JaxStub(_Stub):
        scan_k = Engine.scan_k
        state = train_batch = None

        def step_fn(self, state, batch):
            return state, self._dispatch(self.scan_k())
    return JaxStub


def _port_stub():
    import torch
    from texpose_tpu_torch.models.base import Engine

    class Runner:
        route = "stub"

        def __init__(self, eng):
            self.eng = eng

        def dispatch(self, k):
            return {n: torch.tensor(v)
                    for n, v in self.eng._dispatch(k).items()}

    class PortStub(_Stub):
        scan_k = Engine.scan_k

        def __init__(self, cfg, device):
            super().__init__(cfg)
            self.device = torch.device(device)
            self.runner = Runner(self)

        def step_runner(self):
            return self.runner
    return PortStub


@pytest.fixture
def tools(tmp_path, monkeypatch):
    """(JAX quality check, JAX gan_ablate, port quality check, port
    gan_ablate), their engines stubbed, scan_steps 5 on every JAX config,
    the temp directory tmp_path."""
    import texpose_tpu.models.pretrain as jp
    import texpose_tpu.models.texture_gan as jt
    import texpose_tpu_torch.models.pretrain as tp
    import texpose_tpu_torch.models.texture_gan as tt
    from texpose_tpu_torch.tools import gan_ablate as ga
    from texpose_tpu_torch.tools import quality_check as qc
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    jqc, jga = _jax_tool("tpu_quality_check"), _jax_tool("gan_ablate")
    jax_cls, port_cls = _jax_stub(), _port_stub()
    for mod, name, cls in ((jp, "PretrainEngine", jax_cls),
                           (jt, "TextureGANEngine", jax_cls),
                           (tp, "PretrainEngine", port_cls),
                           (tt, "TextureGANEngine", port_cls)):
        monkeypatch.setattr(mod, name, cls)
    for mod in (jqc, jga):
        def scanned(yaml_name, cache, base=mod._base):
            cfg = base(yaml_name, cache)
            cfg.scan_steps = SCAN
            return cfg
        monkeypatch.setattr(mod, "_base", scanned)
    monkeypatch.setattr(jga, "FIXED_LIGHT", True)
    monkeypatch.setattr(jga, "N_TRAIN", 64)
    _Stub.created = []
    return jqc, jga, qc, ga


def _one_engine():
    (eng,) = _Stub.created
    _Stub.created = []
    return eng


def _first_step(text, what):
    """The step a JAX stage's printed "first" loss was read at."""
    m = re.search(rf"{what} ([0-9.]+) ->", text)
    v = float(m.group(1))
    return round(1.0 / v) if what == "PRETRAIN: loss" else round(v)


@pytest.mark.parametrize("iters", [23, 25, 30])
def test_quality_check_stages_dispatch_as_jax(tools, iters, monkeypatch,
                                              capsys, tmp_path):
    jqc, _, qc, _ = tools
    cache = str(tmp_path / "cache")
    scan = [f"--scan_steps={SCAN}"]
    monkeypatch.setenv("QUAL_PRETRAIN_ITERS", str(iters))
    monkeypatch.setenv("QUAL_GAN_ITERS", str(iters))
    want_k = 5 if iters % 5 == 0 else 1
    for what, jfn, port in (
            ("PRETRAIN: loss", jqc.pretrain_stage,
             lambda: qc.pretrain_stage(cache, "cpu", scan)),
            ("GAN: render", jqc.gan_stage,
             lambda: qc.gan_stage(cache, "cpu", scan))):
        capsys.readouterr()
        jfn(cache)
        j = _one_engine()
        j_first = _first_step(capsys.readouterr().out, what)
        out = port()
        t = _one_engine()
        t_first = _first_step(f"{what} {out['first']} ->", what)
        assert t.dispatches == j.dispatches == [want_k] * (iters // want_k)
        assert out["scan_k"] == want_k and t.it == j.it == iters
        assert t_first == j_first, what
        # pretrain: after the first dispatch; GAN: at the first dispatch
        # past step 20
        assert j_first == (want_k if what.startswith("PRETRAIN")
                           else 20 + want_k)


@pytest.mark.parametrize("iters", [23, 25, 30])
def test_gan_ablate_marks_dispatch_as_jax(tools, iters, tmp_path):
    _, jga, qc, ga = tools
    cache = str(tmp_path / "cache")
    scan = [f"--scan_steps={SCAN}"]
    root = ga.out_root(True, 64)
    want_k = 5 if iters % 5 == 0 else 1

    jga.pretrain(cache, iters)
    j = _one_engine()
    ga.pretrain(cache, iters, "cpu", root, scan)
    t = _one_engine()
    assert t.dispatches == j.dispatches == [want_k] * (iters // want_k)

    j_rows = jga.run_variant(cache, "base", {}, iters, MARKS, seed=1)
    j = _one_engine()
    t_rows = ga.run_variant(cache, "base", {}, iters, MARKS, "cpu", root,
                            seed=1, extra=scan)
    t = _one_engine()
    assert t.dispatches == j.dispatches
    pairs = [(m, ev["step_actual"]) for m, ev in t_rows]
    assert pairs == [(m, ev["step_actual"]) for m, ev in j_rows]
    # six evaluations a mark, at the mark's dispatch boundary
    assert t.evals == j.evals == [a for _, a in pairs for _ in range(6)]
    if want_k == 1:
        assert pairs == [(10, 10), (23, 23)]
    else:
        assert pairs == [(10, 10), (23, 25)]


def _probe_f6():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "probe_f6", os.path.join(REPO, "tools", "probe_f6.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("max_iter,start,end,marks,sizes,fired", [
    # K = gcd(5, 25) = 5; the mark at 23 fires at the boundary 25
    (25, 0, 25, {10, 23}, [5] * 5, [(10, 10), (23, 25)]),
    # K = 1 at max_iter 23
    (23, 0, 23, {10, 23}, [1] * 23, [(10, 10), (23, 23)]),
    # from a state at 10 to an end off the K grid: the last dispatch is
    # short; two marks inside one dispatch fire one a boundary
    (30, 10, 22, {12, 14, 22}, [5, 5, 2], [(12, 15), (14, 20), (22, 22)]),
])
def test_probe_f6_steps_dispatch_k_at_a_time(tools, monkeypatch, tmp_path,
                                             max_iter, start, end, marks,
                                             sizes, fired):
    _, _, qc, _ = tools
    f6 = _probe_f6()
    cfg = qc.gan_cfg(str(tmp_path / "cache"), max_iter,
                     [f"--scan_steps={SCAN}"])
    eng = _port_stub()(cfg, "cpu")
    eng.it = start
    seen, checked, saves = [], [], []
    monkeypatch.setattr(f6, "_mark", lambda eng, rec, tag, step, seed:
                        seen.append((step, eng.it)))
    monkeypatch.setattr(f6, "_parity", lambda eng, rec, step, seed, smi:
                        checked.append(step))
    f6._steps(eng, end, marks, {}, "trunk", 0, True, "", lambda:
              saves.append(eng.it))
    assert eng.dispatches == sizes and eng.it == end
    assert seen == fired
    assert checked == [m for m, _ in fired]
    assert saves == [a for _, a in fired]
