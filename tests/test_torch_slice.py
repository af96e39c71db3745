"""Port parity, the whole evaluation slice: ``evaluate.py --syn2real`` of
the JAX package and ``python -m texpose_tpu_torch.evaluate`` of the port
evaluate the same checkpoint on the same fixture frames.

The JAX engine's state (field and latents from its own init, plus
stand-in discriminator and spectral-norm leaves that evaluation must
ignore) is saved as its npz ``model.ckpt``; the port resumes from that
file through its CLI entry.  Per frame, PSNR agrees within 0.01 dB, SSIM
within 1e-4, and the exported PNGs within 1 LSB (float32 compute; the
last-digit summation differences may round a pixel the other way).  The
LPIPS column is not compared: without ported weights each package draws
its own random backbone (``lpips_uncal``).
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from test_texture_gan_e2e import tiny_gan_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")),
                            n_train=4, n_test=2, scene="scene_all",
                            image_scale=0.25, crop_res=32)


def _syn2real_cfg(root, out):
    cfg = tiny_gan_cfg(root, out)
    cfg.syn2real = True
    cfg.data.image_size = [60, 80]
    cfg.data.raw_size = [120, 160]
    cfg.H, cfg.W = 60, 80
    return cfg


def _quant(path):
    rows = [ln.split() for ln in open(os.path.join(path, "quant.txt"))]
    head = rows[0][2:]
    return [dict(zip(head, map(float, r[1:]))) for r in rows[1:]]


def test_evaluate_full_matches_jax(root, tmp_path):
    import jax
    from texpose_tpu.models.texture_gan import TextureGANEngine as JaxEngine
    from texpose_tpu.nn.fields import init_nerf_st
    from texpose_tpu.utils.checkpoint import save_checkpoint
    from texpose_tpu_torch import evaluate as port_evaluate

    jcfg = _syn2real_cfg(root, tmp_path / "jax")
    jeng = JaxEngine(jcfg)
    jeng.load_dataset(eval_split="test", prefetch_train=False)
    k_nerf, k_lt, k_ll = jax.random.split(jax.random.PRNGKey(0), 3)
    n = len(jeng.train_data)
    jeng.state = {
        "params": {"nerf": init_nerf_st(k_nerf, jcfg),
                   "disc": {"w": np.ones((3, 3), np.float32)}},
        "latents": {"trans": jax.random.normal(k_lt, (n, 8)),
                    "light": jax.random.normal(k_ll, (n, 12))},
        "sn_state": {"u": np.ones(4, np.float32)}}
    res_j = jeng.evaluate_full()

    # the port resumes from the JAX checkpoint through its CLI entry
    tcfg = _syn2real_cfg(root, tmp_path / "torch")
    save_checkpoint(tcfg.output_path, jeng.state)
    yml = tmp_path / "eval.yaml"
    with open(yml, "w") as f:
        yaml.safe_dump({k: v for k, v in tcfg.to_dict().items()
                        if k not in ("H", "W", "output_path")}, f)
    teng = port_evaluate.main([f"--yaml={yml}", "--resume", "--device=cpu"])
    assert teng.start_step == 0

    qj, qt = _quant(jcfg.output_path), _quant(tcfg.output_path)
    assert len(qj) == len(qt) == 2
    assert "lpips_uncal" in qt[0]
    for rj, rt in zip(qj, qt):
        assert abs(rj["psnr"] - rt["psnr"]) < 0.01, (rj, rt)
        assert abs(rj["ssim"] - rt["ssim"]) < 1e-4, (rj, rt)
    assert abs(res_j["psnr"] - np.mean([r["psnr"] for r in qt])) < 0.01

    dj = os.path.join(jcfg.output_path, "test_view_last")
    dt = os.path.join(tcfg.output_path, "test_view_last")
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) and len(names) == 2
    pngs_t = {}
    for n in names:
        a = cv2.imread(os.path.join(dj, n)).astype(int)
        b = cv2.imread(os.path.join(dt, n)).astype(int)
        assert a.shape == b.shape == (120, 160, 3)
        assert np.abs(a - b).max() <= 1, n
        pngs_t[n] = b

    # the standard-payload route (taken by dense or empty frames: whole
    # frames uploaded, masked render on the device, metrics from the full
    # image) renders the same rays as the compact route; warm_eval runs
    # frame 0 through each route
    teng.warm_eval(0)
    teng.cfg.render.eval_compact = False
    teng.warm_eval(0)
    teng.evaluate_full()
    for rc, rs in zip(qt, _quant(tcfg.output_path)):
        for k in ("psnr", "ssim"):
            assert abs(rc[k] - rs[k]) < 1e-4, (k, rc, rs)
    for n, b in pngs_t.items():
        c = cv2.imread(os.path.join(dt, n)).astype(int)
        assert np.abs(b - c).max() <= 1, n


def test_evaluate_rejects_video_before_loading(tmp_path):
    """--video is refused up front: no dataset is read and nothing is
    rendered or written (the data root here does not exist)."""
    from texpose_tpu_torch import evaluate as port_evaluate
    cfg = _syn2real_cfg(str(tmp_path / "no_data"), tmp_path / "out")
    yml = tmp_path / "eval.yaml"
    with open(yml, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.to_dict().items()
                        if k not in ("H", "W", "output_path")}, f)
    with pytest.raises(NotImplementedError, match="video"):
        port_evaluate.main([f"--yaml={yml}", "--video", "--device=cpu"])
    assert not (tmp_path / "out").exists()


def test_port_imports_no_jax():
    """Every module of the port imports with jax made unimportable (the
    shared host layer's package init pulls jax only when JAX_PLATFORMS
    says cpu, so the child runs without it)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import texpose_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__,"
        " p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20
