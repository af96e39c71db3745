"""The pretrain engines' novel-view video (``evaluate --video``): the port's
``generate_videos_synthesis`` against the JAX engine's, from one state (the
JAX init through the checkpoint bridge), at the narrow widths of
tests/test_pretrain_e2e.py:

  * the orbit poses and novel_pose.npy against JAX's for the same anchor,
    atol 1e-5;
  * the orbit's frames: frame 0's render against the JAX engine's under
    the bounds tests/test_torch_pretrain_cli.py holds evaluate_full to
    (PSNR 0.01 dB, SSIM 1e-4), and every written PNG within one uint8
    step of JAX's;
  * ffmpeg: its command line, and the warning (PNGs kept) when it is
    missing or fails;
  * an engine with no video refuses it.
"""

import os
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from texpose_tpu.geometry.pose import get_novel_view_poses as jax_orbit
from test_torch_pretrain_step import jax_engine, port_engine, step_cfg

N = 4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=4,
                            n_test=2, scene="scene_all", image_scale=0.25,
                            crop_res=32)


@pytest.fixture(scope="module")
def engines(root, tmp_path_factory):
    cfg = step_cfg(root, tmp_path_factory.mktemp("video"))
    cfg.nerf.rand_rays = 1024          # one render chunk a 32x32 frame
    jeng = jax_engine(cfg)
    peng = port_engine(cfg, jeng)
    jeng.cfg.output_path = os.path.join(cfg.output_path, "jax")
    peng.cfg.output_path = os.path.join(cfg.output_path, "port")
    return jeng, peng


@pytest.fixture(scope="module")
def videos(engines):
    jeng, peng = engines
    return jeng.generate_videos_synthesis(N=N), \
        peng.generate_videos_synthesis(N=N)


@pytest.mark.parametrize("n", [N, 60])
def test_orbit_poses_match_jax(engines, videos, n):
    jeng, peng = engines
    anchor = peng.eval_frame(0)["pose"][0]
    np.testing.assert_array_equal(anchor.numpy(),
                                  np.asarray(jeng.eval_frame(0)["pose"][0]))
    zs = peng.cfg.nerf.depth.scale
    from texpose_tpu_torch.geometry import get_novel_view_poses
    t = get_novel_view_poses(anchor, N=n, scale=zs * 0.03, motion="gentle")
    j = jax_orbit(jnp.asarray(anchor.numpy()), N=n, scale=zs * 0.03,
                  motion="gentle")
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    if n == N:
        jp, pp = (np.load(os.path.join(v, "novel_pose.npy")) for v in videos)
        assert pp.shape == jp.shape == (N, 3, 4) and pp.dtype == np.float32
        np.testing.assert_allclose(pp, jp, atol=1e-5)
        np.testing.assert_allclose(pp, t.numpy(), atol=0)


def test_frame0_matches_jax(engines, videos):
    from texpose_tpu_torch.ops.ssim import ssim
    from texpose_tpu_torch.utils.metrics import mse_to_psnr
    jeng, peng = engines
    cfg = peng.cfg
    pose0 = np.load(os.path.join(videos[1], "novel_pose.npy"))[:1]
    pframe = dict(peng.eval_frame(0), pose=torch.as_tensor(pose0))
    jframe = dict(jeng.eval_frame(0), pose=jnp.asarray(pose0))
    with torch.inference_mode():
        pout = peng._render_frame(pframe)
    jout = jeng._render_frame(jeng.state["params"]["nerf"], jframe)
    img = pframe["image"].reshape(3, cfg.H, cfg.W).permute(1, 2, 0)
    renders = []
    for out in (pout, jout):
        rgb = torch.as_tensor(np.asarray(out["rgb"])).reshape(cfg.H, cfg.W, 3)
        renders.append(rgb)
    psnr = [float(mse_to_psnr(((r - img) ** 2).mean())) for r in renders]
    ssims = [float(ssim(r.permute(2, 0, 1)[None], img.permute(2, 0, 1)[None]))
             for r in renders]
    assert abs(psnr[0] - psnr[1]) <= 0.01, psnr
    assert abs(ssims[0] - ssims[1]) <= 1e-4, ssims
    depth = [np.asarray(o["depth"]).reshape(-1) for o in (pout, jout)]
    np.testing.assert_allclose(depth[0], depth[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["rgb", "depth"])
def test_pngs_match_jax(videos, kind):
    jdir, pdir = videos
    for i in range(N):
        j = cv2.imread(os.path.join(jdir, f"{kind}_{i}.png"), -1)
        p = cv2.imread(os.path.join(pdir, f"{kind}_{i}.png"), -1)
        assert p.shape == j.shape == ((32, 32, 3) if kind == "rgb"
                                      else (32, 32))
        assert np.abs(p.astype(int) - j).max() <= 1, (kind, i)
    assert not os.path.exists(os.path.join(pdir, f"{kind}_{N}.png"))


def test_ffmpeg_command_and_missing_ffmpeg_warning(engines, tmp_path,
                                                   monkeypatch):
    """With ffmpeg the PNGs go to novel_view_{rgb,depth}.mp4 at fps; when
    it is missing (or fails), a warning per video and the PNGs stay."""
    from texpose_tpu_torch.models import pretrain
    _, peng = engines
    calls, warns = [], []
    monkeypatch.setattr(peng.cfg, "output_path", str(tmp_path))
    monkeypatch.setattr(pretrain.log, "warn", warns.append)

    def fake_run(cmd, **kw):
        calls.append(cmd)
        assert kw.get("check") and kw.get("timeout")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(pretrain.subprocess, "run", fake_run)
    path = peng.generate_videos_synthesis(N=2, fps=12)
    assert [c[0] for c in calls] == ["ffmpeg", "ffmpeg"] and not warns
    assert calls[0][calls[0].index("-framerate") + 1] == "12"
    assert calls[0][-1] == os.path.join(str(tmp_path), "novel_view_rgb.mp4")
    assert calls[1][-1] == os.path.join(str(tmp_path),
                                        "novel_view_depth.mp4")

    for err in (FileNotFoundError("ffmpeg"),
                subprocess.CalledProcessError(1, "ffmpeg")):
        def missing(cmd, err=err, **kw):
            raise err
        monkeypatch.setattr(pretrain.subprocess, "run", missing)
        warns.clear()
        assert peng.generate_videos_synthesis(N=2) == path
        assert len(warns) == 2 and all("ffmpeg" in w for w in warns)
        assert sorted(os.listdir(path)) == [
            "depth_0.png", "depth_1.png", "novel_pose.npy", "rgb_0.png",
            "rgb_1.png"]


def test_engine_without_video_refuses():
    from texpose_tpu_torch.models.base import Engine
    from texpose_tpu_torch.models.pretrain import (PretrainEngine,
                                                   PretrainEnvEngine)
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    base = Engine.generate_videos_synthesis
    assert TextureGANEngine.generate_videos_synthesis is base
    for cls in (PretrainEngine, PretrainEnvEngine):
        assert cls.generate_videos_synthesis is not base
    with pytest.raises(NotImplementedError, match="video"):
        base(object.__new__(TextureGANEngine))
