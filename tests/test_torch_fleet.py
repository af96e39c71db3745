"""The port's fleet launcher (``python -m texpose_tpu_torch.fleet``), the
counterpart of train_fleet.py: two tiny per-object pretrain runs on the
CPU end to end, each in its own output directory; and, with
``subprocess.Popen`` stubbed, the retry with ``--resume``, the exit code of
a fleet whose run keeps failing, and the one-card-per-slot pinning of
``--parallel``."""

import os
import shutil
import subprocess
import sys

import pytest

from texpose_tpu.data.fixture import generate_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fleet_trains_two_objects_on_the_cpu(tmp_path):
    root = generate_fixture(str(tmp_path / "bop"), n_train=3, n_test=1,
                            scene="scene_naive", fixed_light=True,
                            image_scale=0.2, crop_res=32, obj="ball")
    # the second object shares the frames under another split name
    src = os.path.join(root, "splits", "lm", "ball")
    dst = os.path.join(root, "splits", "lm", "cube")
    shutil.copytree(src, dst)
    for split in ("train", "val", "test"):
        p = os.path.join(dst, "scene_naive", f"{split}.txt")
        content = open(p).read().replace("ball", "cube")
        open(p, "w").write(content)
    out = str(tmp_path / "out")
    r = subprocess.run(
        [sys.executable, "-m", "texpose_tpu_torch.fleet",
         "--yaml=configs/nerf_lm_pretrain.yaml",
         "--objects=ball,cube", "--group=fleet", "--",
         f"--data.root={root}",
         f"--data.splits_root={os.path.join(root, 'splits')}",
         "--data.scene=scene_naive", "--data.image_size=[32,32]",
         "--arch.layers_feat=[null,16,16]", "--arch.layers_rgb=[null,16,3]",
         "--arch.skip=[1]", "--arch.posenc.L_3D=2",
         "--nerf.sample_intvs=4", "--nerf.rand_rays=64",
         "--nerf.depth.box_source=gt_box",
         "--max_iter=2", "--freq.scalar=1", "--freq.val=100",
         "--freq.ckpt=100", "--freq.vis=100",
         "--compute_dtype=float32", f"--output_root={out}",
         "--device=cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "[fleet] all 2 objects done" in r.stdout
    for obj in ("ball", "cube"):
        assert os.path.exists(os.path.join(out, "fleet", obj,
                                           "model.ckpt")), obj


class FakeRun:
    """A Popen stand-in whose wait() returns the next scripted code."""

    def __init__(self, log, codes, cmd, env):
        self.rc = codes.pop(0)
        log.append((cmd, env))

    def wait(self):
        return self.rc


def _fleet(monkeypatch, codes, argv, cards=1):
    import torch
    from texpose_tpu_torch import fleet
    log = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(fleet.subprocess, "Popen",
                        lambda cmd, env: FakeRun(log, codes, cmd, env))
    fleet.main(argv)
    return log


def test_fleet_retries_a_failed_run_with_resume(monkeypatch, capsys):
    log = _fleet(monkeypatch, [1, 0, 0],
                 ["--yaml=y.yaml", "--objects=duck,cat", "--retries=1",
                  "--", "--max_iter=5"])
    cmds = [cmd for cmd, _ in log]
    assert [c[c.index("-m") + 1] for c in cmds] == [
        "texpose_tpu_torch.train"] * 3
    assert [next(a for a in c if a.startswith("--data.object="))
            for c in cmds] == ["--data.object=duck", "--data.object=cat",
                               "--data.object=duck"]
    assert ["--resume" in c for c in cmds] == [False, False, True]
    assert all(c[-1 - ("--resume" in c)] == "--max_iter=5" for c in cmds)
    out = capsys.readouterr().out
    assert "[fleet] retrying duck with --resume (attempt 1/1)" in out
    assert "[fleet] all 2 objects done" in out


def test_fleet_fails_when_a_run_keeps_failing(monkeypatch, capsys):
    with pytest.raises(SystemExit) as err:
        _fleet(monkeypatch, [1, 0, 2],
               ["--yaml=y.yaml", "--objects=duck,cat", "--retries=1"])
    assert err.value.code == 1
    assert "[fleet] FAILED: {'duck': 2}" in capsys.readouterr().out


def test_fleet_pins_one_card_per_slot(monkeypatch):
    """--parallel=2 on two cards: the slots run on cards 0 and 1, and a
    finished run frees its card for the next object."""
    log = _fleet(monkeypatch, [0, 0, 0],
                 ["--yaml=y.yaml", "--objects=a,b,c", "--parallel=2"],
                 cards=2)
    assert [env["CUDA_VISIBLE_DEVICES"] for _, env in log] == ["0", "1", "0"]


def test_fleet_refuses_more_slots_than_cards(monkeypatch):
    with pytest.raises(ValueError, match="cards are visible"):
        _fleet(monkeypatch, [0, 0],
               ["--yaml=y.yaml", "--objects=a,b", "--parallel=2"], cards=1)
    log = _fleet(monkeypatch, [0, 0],
                 ["--yaml=y.yaml", "--objects=a,b", "--parallel=2", "--",
                  "--device=cpu"], cards=0)
    assert len(log) == 2
    assert all("CUDA_VISIBLE_DEVICES" not in env
               or env["CUDA_VISIBLE_DEVICES"] == os.environ.get(
                   "CUDA_VISIBLE_DEVICES") for _, env in log)
