"""The port stands alone: its host layer (data readers, fixture, config,
log, the PNG writer thread) is its own copy, no module of
texpose_tpu_torch — nor chip_smoke.py and the port's tools — imports jax
or the JAX package, the copied LineMOD readers give the JAX package's
arrays, and the entry points run on the card unless the caller asks for
the CPU."""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from texpose_tpu.data.fixture import generate_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(
        REPO, "texpose_tpu_torch")) for f in fs if f.endswith(".py")]
    + [os.path.join(REPO, "chip_smoke.py"),
       os.path.join(REPO, "tools", "profile_eval_torch.py"),
       os.path.join(REPO, "tools", "kernel_bounds.py"),
       os.path.join(REPO, "tools", "probe_composite.py"),
       os.path.join(REPO, "tools", "probe_f6.py"),
       os.path.join(REPO, "tools", "probe_dw_precision.py")])


def test_every_port_module_imports_with_jax_and_the_jax_package_poisoned():
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["texpose_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import texpose_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            texpose_tpu_torch.__path__, "texpose_tpu_torch.")]
        for name in ("kernels.coarse_field", "kernels.composite",
                     "kernels.st_field", "kernels.st_render",
                     "kernels.trunk", "nn.fields",
                     "models.pretrain", "models.render", "ops.render",
                     "geometry.pose", "raster.shaders", "raster.native",
                     "raster.torch_raster", "compute_box",
                     "compute_surfelinfo", "utils.vis", "ops.knn",
                     "parallel.mesh", "fleet", "tools.quality_check",
                     "tools.gan_ablate", "tools.eval_envelope"):
            assert "texpose_tpu_torch." + name in names, name
        for name in names:
            importlib.import_module(name)
        for path in ({REPO!r} + "/chip_smoke.py",
                     {REPO!r} + "/tools/profile_eval_torch.py",
                     {REPO!r} + "/tools/kernel_bounds.py",
                     {REPO!r} + "/tools/probe_composite.py",
                     {REPO!r} + "/tools/probe_f6.py",
                     {REPO!r} + "/tools/probe_dw_precision.py"):
            spec = importlib.util.spec_from_file_location("m", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "texpose_tpu."))
               or m == "texpose_tpu"]
        assert all(sys.modules[m] is None for m in bad), bad
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= 69


@pytest.mark.parametrize("package", ["nn", "ops", "sampling"])
def test_package_exports_match_the_jax_package(package):
    """Each public name of the JAX package's nn/, ops/ and sampling/
    ``__init__`` is exported by the port's under the same name (nothing is
    renamed; the port's fields are modules where JAX's are parameter
    trees, under the same function names), and every export resolves."""
    import importlib
    jpkg = importlib.import_module(f"texpose_tpu.{package}")
    tpkg = importlib.import_module(f"texpose_tpu_torch.{package}")
    jnames = {k for k in vars(jpkg)
              if not k.startswith("_") and not isinstance(
                  vars(jpkg)[k], type(jpkg))}
    assert jnames and not [k for k in jnames if not hasattr(tpkg, k)]
    for k in getattr(tpkg, "__all__", ()):
        assert getattr(tpkg, k) is not None, k


def test_no_port_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|texpose_tpu)([. ]|$)",
                         re.M)
    assert len(PORT_FILES) >= 40
    bad = [os.path.relpath(p, REPO) for p in PORT_FILES
           if pattern.search(open(p).read())]
    assert not bad


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=3,
                            n_test=2, scene="scene_all", image_scale=0.25,
                            crop_res=32)


@pytest.mark.parametrize("model,split", [
    ("nerf_pretrain", "train"), ("nerf_pretrain", "test"),
    ("nerf_adapt_st_gan", "train"), ("syn2real", "test")])
def test_copied_linemod_readers_match_the_jax_package(root, tmp_path, model,
                                                      split):
    """The port's copy of the dataset classes yields the JAX package's
    arrays, key for key, on the pretrain and the GAN configs (erode mask,
    synthetic images, NOCS and normals) and the syn2real test split."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_pretrain_e2e import tiny_pretrain_cfg
    from test_texture_gan_e2e import tiny_gan_cfg
    import texpose_tpu.data as jdata
    import texpose_tpu_torch.data as tdata
    if model == "nerf_pretrain":
        cfg = tiny_pretrain_cfg(root, tmp_path)
        cfg.data.scene = "scene_all"
        cfg.data.erode_mask_loss = True
    else:
        cfg = tiny_gan_cfg(root, tmp_path)
    kw = dict(split=split, splits_root=cfg.data.splits_root)
    if model == "syn2real":
        j = jdata.LineMODSyn2RealDataset(cfg, **kw)
        t = tdata.LineMODSyn2RealDataset(cfg, **kw)
    else:
        j = jdata.LineMODDataset(cfg, **kw)
        t = tdata.LineMODDataset(cfg, **kw)
    assert len(j) == len(t) > 0
    for i in range(len(j)):
        a, b = j[i], t[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                          err_msg=k)


@pytest.mark.parametrize("entry", ["train", "evaluate"])
def test_entry_points_raise_without_a_card(tmp_path, monkeypatch, entry):
    """No --device: the default is cuda, and with no card visible the
    entry point raises before any dataset is read; --device=cuda the
    same."""
    import importlib
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"texpose_tpu_torch.{entry}")
    yml = os.path.join(REPO, "configs", "nerf_lm_pretrain.yaml")
    for extra in ([], ["--device=cuda"]):
        with pytest.raises(RuntimeError, match="--device=cpu"):
            mod.main([f"--yaml={yml}", f"--output_root={tmp_path}",
                      "--data.root=/nonexistent", *extra])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("entry", ["compute_box", "compute_surfelinfo"])
def test_preprocessing_entry_points_raise_without_a_card(root, tmp_path,
                                                         monkeypatch, entry):
    """The preprocessing CLIs default to --device=cuda as the others: with
    no card visible they raise before any file is written, with and
    without --device=cuda."""
    import importlib
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"texpose_tpu_torch.{entry}")
    out = str(tmp_path / "out")
    if entry == "compute_box":
        argv = ["--data_root", os.path.join(root, "lm"), "--folder",
                "000001", "--split_file", os.path.join(
                    root, "splits", "lm", "ball", "scene_all", "train.txt"),
                "--cad_path", os.path.join(root, "lm", "models",
                                           "obj_000001.ply"),
                "--pred_loop", "init_calib", "--target_folder", out]
    else:
        argv = [f"--yaml={os.path.join(REPO, 'configs', 'nerf_lm_adapt_gan.yaml')}",
                f"--data.root={root}", "--data.object=ball",
                f"--data.splits_root={os.path.join(root, 'splits')}",
                "--data.pose_source=predicted",
                "--data.pose_loop=init_calib",
                f"--render.geo_save_dir={out}"]
    for extra in ([], ["--device=cuda"]):
        with pytest.raises(RuntimeError, match="--device=cpu"):
            mod.main([*argv, *extra])
    assert not os.path.exists(out)


@pytest.mark.parametrize("entry", ["train", "evaluate"])
def test_entry_points_refuse_data_parallel_on_several_cards(tmp_path,
                                                            monkeypatch,
                                                            entry):
    """mesh.dp with more than one visible card (and no process group): both
    CLIs start one worker per card on the same argv up front (stubbed here;
    no dataset read, the data root does not exist) where they once refused;
    with one card, or with mesh.dp unset, they stay single-process (and
    then fail on the missing data)."""
    import importlib
    import torch
    import torch.multiprocessing as mp
    from texpose_tpu_torch.parallel.mesh import worker_count
    from texpose_tpu_torch.utils.config import Config
    mod = importlib.import_module(f"texpose_tpu_torch.{entry}")
    yml = os.path.join(REPO, "configs", "nerf_lm_pretrain.yaml")
    argv = [f"--yaml={yml}", f"--output_root={tmp_path}",
            "--data.root=/nonexistent", "--device=cpu"]
    starts = []
    monkeypatch.setattr(mp, "start_processes",
                        lambda fn, args, nprocs, **kw: starts.append(
                            (args, nprocs, kw)))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mod.main([*argv, "--mesh.dp=true"])
    assert not os.listdir(tmp_path)
    (args, nprocs, kw), = starts
    assert nprocs == 2 and kw["start_method"] == "spawn"
    assert args[:3] == (f"texpose_tpu_torch.{entry}",
                        [*argv, "--mesh.dp=true"], 2)
    for count, dp in ((1, "true"), (2, "null")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        assert worker_count(Config({"mesh": {"dp": dp == "true"}})) == 0
        with pytest.raises(Exception) as err:
            mod.main([*argv, f"--mesh.dp={dp}"])
        assert "nonexistent" in str(err.value), err.value
    assert len(starts) == 1
