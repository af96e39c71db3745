"""The plain reference against the port's plain path at a small size on
the CPU, through a whole run of each cell (the harness's look for a card
skipped), and the comparison's control and faults: the control (the
reference one precision step below the configured bfloat16, in the
program's place) and each fault a cell can have (a step that leaves its
state unchanged, a step on half its batch with the mean over the rest,
an answer altered where it is produced) turn ``correct`` false.  This
test, and only this one, loads both the reference and the program."""

import numpy as np
import torch
import pytest

from bench_port import control
from bench_port.lib import engine, fixture, harness
from bench_port.reference import data
from bench_port.tests.tiny import run_cpu, tiny_spec

CELLS = ("gan.train", "pretrain.train", "pretrain.eval480")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_agrees(cell):
    """At this size the gaps run larger than at the cells' (fewer rows
    and leaves average them), so they are held to 1e-2, not to the
    limits set on the card."""
    run, checks, failed, out = run_cpu(cell)
    assert failed == 0 and out["attempted"] > 0
    assert len(checks) >= 4
    assert all(v <= 1e-2 for _, v, _ in checks), out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    r = control.readings(tiny_spec(cell), 4242, torch.device("cpu"), True,
                         log=lambda *a: None)
    limits = tiny_spec(cell)["workload"]["limits"]
    assert "control" in r
    for fault in set(r) - {"sound"}:
        failed = [n for n, v in r[fault].items() if v > limits[n]]
        assert failed, (fault, r)
        assert all(r[fault][n] > 3 * r["sound"][n] for n in failed), r


@pytest.mark.parametrize("cell", ("gan.train", "pretrain.train"))
def test_a_step_that_leaves_its_state_unchanged(cell, monkeypatch):
    from texpose_tpu_torch.models import optim
    monkeypatch.setattr(optim.Adam, "step", lambda self, count: None)
    monkeypatch.setattr(optim.RMSprop, "step", lambda self, count: None)
    _, checks, _, out = run_cpu(cell)
    assert not out["correct"]
    # no leaf moved: each leaf's gap reads 1, or its share of the median
    got = dict((n, v) for n, v, _ in checks)
    assert got["delta"] > 0.5 and got["start"] > 0.5


def test_gan_step_on_half_its_batch(monkeypatch):
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    step = TextureGANEngine.train_step

    def half(self, draws):
        h = draws["idx"].shape[0] // 2
        return step(self, {"idx": draws["idx"][:h],
                           "patch": draws["patch"][:, :h],
                           "depth": draws["depth"][:h]})

    monkeypatch.setattr(TextureGANEngine, "train_step", half)
    assert not run_cpu("gan.train")[3]["correct"]


def test_gan_step_without_r1(monkeypatch):
    """The critic's R1 term left out where the program makes it: the
    critic's own gradient number catches it."""
    from texpose_tpu_torch.models import texture_gan
    r1 = texture_gan.r1_penalty

    def off(d_out, x, sel, B, mesh=None):
        return tuple(0.0 * t for t in r1(d_out, x, sel, B, mesh))

    monkeypatch.setattr(texture_gan, "r1_penalty", off)
    _, checks, _, out = run_cpu("gan.train")
    assert not out["correct"]
    got = dict((n, (v, lim)) for n, v, lim in checks)
    assert got["grad.disc"][0] > got["grad.disc"][1], got


def test_pretrain_step_on_half_its_batch(monkeypatch):
    from texpose_tpu_torch.models.pretrain import PretrainEngine
    step = PretrainEngine.train_step

    def half(self, draws):
        full = self.train_batch
        h = full["image"].shape[0] // 2
        self.train_batch = {k: v[:h] for k, v in full.items()}
        try:
            return step(self, {**draws, "depth": draws["depth"][:h]})
        finally:
            self.train_batch = full

    monkeypatch.setattr(PretrainEngine, "train_step", half)
    assert not run_cpu("pretrain.train")[3]["correct"]


def test_a_frame_altered_where_it_is_made(monkeypatch):
    from texpose_tpu_torch.models import pretrain
    payloads = pretrain.frame_payloads

    def altered(lpips_params, rgb, opac, img):
        return payloads(lpips_params, torch.clamp(rgb + 0.05, 0, 1), opac,
                        img)

    monkeypatch.setattr(pretrain, "frame_payloads", altered)
    _, checks, _, out = run_cpu("pretrain.eval480")
    assert not out["correct"]
    assert dict((n, v) for n, v, _ in checks)["rgb_lsb"] > 5


@pytest.mark.parametrize("cell,split", [("gan.train", "train"),
                                        ("pretrain.train", "train"),
                                        ("pretrain.eval480", "test")])
def test_the_reference_reads_what_the_program_loads(cell, split, tmp_path):
    """The reference's own loader and the program's give the same arrays
    from the fixture's files, at the cells' own crops."""
    spec = harness.cell_spec(cell)
    traffic = spec["workload"]["traffic"]
    root = fixture.generate_fixture(str(tmp_path / "data"), 7,
                                    **traffic["fixture"])
    extra = {}
    if "frames" in traffic:
        extra["data.scene"] = fixture.cycle_test_split(
            root, traffic["fixture"]["scene"], 6)
    cfg = engine.build_cfg(spec, root, str(tmp_path), 7, extra)
    from texpose_tpu_torch.models import get_engine
    eng = get_engine(cfg.model)(cfg, torch.device("cpu"))
    prog = eng.make_dataset(split)
    ref = data.Split(engine.plain(cfg), split)
    assert len(ref) == len(prog)
    for i in range(len(prog)):
        p, r = prog[i], ref.sample(i)
        assert sorted(p) == sorted(r)
        for k in p:
            np.testing.assert_array_equal(np.asarray(r[k]), np.asarray(p[k]),
                                          err_msg=k)
