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
       os.path.join(REPO, "tools", "probe_composite.py")])


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
                     "models.pretrain", "models.render", "ops.render"):
            assert "texpose_tpu_torch." + name in names, name
        for name in names:
            importlib.import_module(name)
        for path in ({REPO!r} + "/chip_smoke.py",
                     {REPO!r} + "/tools/profile_eval_torch.py",
                     {REPO!r} + "/tools/kernel_bounds.py",
                     {REPO!r} + "/tools/probe_composite.py"):
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
    assert int(r.stdout.split()[-1]) >= 40


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
