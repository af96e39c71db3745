"""The engines' ``visualize`` (the freq.vis hook) and the texture model's
scene_vis export, the port against the JAX package from one state (the
JAX init carried over by the checkpoint bridge), at the narrow widths of
tests/test_pretrain_e2e.py and tests/test_texture_gan_e2e.py:

  * the panels of both pretrain engines (nine) and of the GAN (thirteen)
    against JAX's PNGs: the panels made of the frame's data alone are
    bit-equal; the rendered panels without a colormap within one uint8
    level everywhere (float32 compute with the sums in another order:
    an opacity one ulp below 1.0 truncates to 254 where JAX's gives 255,
    measured on 35 % of the pretrain's pred_mask pixels, 11 % of the
    GAN's); the colormapped ones within one level on ≥ 99.5 % of the pixels
    (a render's last ulp can move a value across a bin edge; measured:
    every pixel equal);
  * the GAN's cameras.png, and without matplotlib one warning, no
    cameras.png and the twelve other panels;
  * ``visualize`` leaves training as it was: a 4-step CLI run with
    freq.vis=2 ends with the train state (parameters, optimizer moments,
    counters) bit-equal to the run with freq.vis=null;
  * ``evaluate --syn2real --data.scene=scene_vis`` (60x80 rendered, 120x160
    raw, 2 frames, the JAX test's setup): quant rows within 1e-3 dB PSNR
    and 1e-4 SSIM of JAX's, three 256x256 PNGs a frame, the render's
    padded border white and the GT dump's black, syn_* bit-equal to JAX's
    and the render and depth_vis within one uint8 level.
"""

import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from texpose_tpu_torch.utils.checkpoint import load_checkpoint_flat

PRETRAIN_PANELS = ("image", "rgb", "image_masked", "pred_mask", "gt_mask",
                   "depth", "depth_gt", "depth_error", "z_near")
GAN_PANELS = ("image", "image_masked", "rgb", "rgb_static", "rgb_transient",
              "pred_mask", "gt_mask", "depth", "depth_gt", "z_near",
              "depth_error", "color_error", "uncert")
DATA_PANELS = {"image", "image_masked", "gt_mask", "depth_gt", "z_near"}
CMAP_PANELS = {"depth", "depth_gt", "depth_error", "z_near", "color_error",
               "uncert"}
CMAP_SHARE = 0.995


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=6,
                            n_test=2, scene="scene_all", image_scale=0.25,
                            crop_res=32)


def _vis_dirs(jeng, peng, out, it):
    jeng.cfg.output_path = os.path.join(out, "jax")
    peng.cfg.output_path = os.path.join(out, "port")
    jeng.visualize(it)
    peng.visualize(it)
    return (os.path.join(jeng.cfg.output_path, "vis"),
            os.path.join(peng.cfg.output_path, "vis"))


@pytest.fixture(scope="module", params=["pretrain", "env"])
def pretrain_vis(request, root, tmp_path_factory):
    from test_torch_pretrain_step import jax_engine, port_engine, step_cfg
    out = tmp_path_factory.mktemp(request.param)
    cfg = step_cfg(root, out, env=request.param == "env")
    cfg.nerf.rand_rays = 1024          # one render chunk a 32x32 frame
    jeng = jax_engine(cfg)
    return _vis_dirs(jeng, port_engine(cfg, jeng), str(out), 7)


@pytest.fixture(scope="module")
def gan_engines(root, tmp_path_factory):
    from test_torch_train_step import jax_engine, port_engine, step_cfg
    out = tmp_path_factory.mktemp("gan")
    cfg = step_cfg(root, out)
    jeng = jax_engine(cfg)
    peng = port_engine(cfg, jeng)
    return jeng, peng, _vis_dirs(jeng, peng, str(out), 5)


def _compare_panel(jdir, pdir, it, name):
    j = cv2.imread(os.path.join(jdir, f"{it:06d}_{name}.png")).astype(int)
    p = cv2.imread(os.path.join(pdir, f"{it:06d}_{name}.png")).astype(int)
    assert p.shape == j.shape == (36, 36, 3)
    d = np.abs(p - j).max(axis=-1)
    if name in DATA_PANELS:
        assert d.max() == 0, name
    elif name in CMAP_PANELS:
        assert (d <= 1).mean() >= CMAP_SHARE, (name, (d <= 1).mean())
    else:
        assert d.max() <= 1, (name, d.max())


@pytest.mark.parametrize("name", PRETRAIN_PANELS)
def test_pretrain_panels_match_jax(pretrain_vis, name):
    jdir, pdir = pretrain_vis
    assert sorted(os.listdir(pdir)) == sorted(
        f"000007_{n}.png" for n in PRETRAIN_PANELS)
    _compare_panel(jdir, pdir, 7, name)


@pytest.mark.parametrize("name", GAN_PANELS)
def test_gan_panels_match_jax(gan_engines, name):
    _, _, (jdir, pdir) = gan_engines
    assert sorted(os.listdir(pdir)) == sorted(
        [f"000005_{n}.png" for n in GAN_PANELS] + ["cameras.png"])
    _compare_panel(jdir, pdir, 5, name)


def test_gan_visualize_without_matplotlib(gan_engines, tmp_path,
                                          monkeypatch):
    """plot_cameras raising ImportError (no matplotlib, as on the card):
    one warning at the first visualize, no cameras.png, every other panel
    written at each firing."""
    from texpose_tpu_torch.models import texture_gan
    from texpose_tpu_torch.utils import vis
    _, peng, _ = gan_engines
    warns = []

    def no_mpl(*a, **k):
        raise ImportError("the camera plots need matplotlib")

    monkeypatch.setattr(vis, "plot_cameras", no_mpl)
    monkeypatch.setattr(texture_gan.log, "warn", warns.append)
    monkeypatch.setattr(peng.cfg, "output_path", str(tmp_path))
    monkeypatch.delattr(peng, "_no_cameras", raising=False)
    peng.visualize(1)
    peng.visualize(2)
    assert len(warns) == 1 and "cameras.png" in warns[0]
    assert sorted(os.listdir(tmp_path / "vis")) == sorted(
        f"{it:06d}_{n}.png" for it in (1, 2) for n in GAN_PANELS)
    monkeypatch.delattr(peng, "_no_cameras")


def _yaml(cfg, path):
    with open(path, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.to_dict().items()
                        if k not in ("H", "W", "output_path")}, f)
    return str(path)


@pytest.mark.parametrize("model", ["pretrain", "gan"])
def test_visualize_leaves_training_unchanged(root, tmp_path, model):
    from texpose_tpu_torch import train
    if model == "pretrain":
        from test_torch_pretrain_cli import pre_cfg
        cfg = pre_cfg(root, tmp_path)
        panels, extra = PRETRAIN_PANELS, []
    else:
        from test_texture_gan_e2e import tiny_gan_cfg
        cfg = tiny_gan_cfg(root, tmp_path)
        panels, extra = GAN_PANELS, ["--batch_size=2"]
    cfg.max_iter = 4
    yml = _yaml(cfg, tmp_path / "run.yaml")
    flats = {}
    for vis in ("2", "null"):
        eng = train.main([f"--yaml={yml}", "--device=cpu", f"--freq.vis={vis}",
                          f"--name=vis_{vis}", *extra])
        assert eng.it == 4
        flats[vis] = load_checkpoint_flat(os.path.join(eng.cfg.output_path,
                                                       "model.ckpt"))
        vis_dir = os.path.join(eng.cfg.output_path, "vis")
        if vis == "null":
            assert not os.path.exists(vis_dir)
        else:
            want = {f"{it:06d}_{n}.png" for it in (2, 4) for n in panels}
            got = set(os.listdir(vis_dir)) - {"cameras.png"}
            assert got == want
    assert sorted(flats["2"]) == sorted(flats["null"])
    for k, v in flats["null"].items():
        np.testing.assert_array_equal(flats["2"][k], v, err_msg=k)


def _quant(path):
    rows = [ln.split() for ln in open(os.path.join(path, "quant.txt"))]
    head = rows[0][2:]
    return [dict(zip(head, map(float, r[1:]))) for r in rows[1:]]


def test_scene_vis_export_matches_jax(root, tmp_path):
    import jax
    from texpose_tpu.models.texture_gan import TextureGANEngine as JaxEngine
    from texpose_tpu.nn.fields import init_nerf_st
    from texpose_tpu.utils.checkpoint import save_checkpoint
    from test_torch_slice import _syn2real_cfg
    from texpose_tpu_torch import evaluate

    # scene_vis shares the data tree; only the split files differ
    src = os.path.join(root, "splits", "lm", "ball", "scene_all")
    dst = os.path.join(root, "splits", "lm", "ball", "scene_vis")
    if not os.path.exists(dst):
        shutil.copytree(src, dst)

    def cfg_for(out):
        cfg = _syn2real_cfg(root, out)
        cfg.data.scene = "scene_vis"
        return cfg

    jcfg = cfg_for(tmp_path / "jax")
    jeng = JaxEngine(jcfg)
    jeng.load_dataset(eval_split="test", prefetch_train=False)
    k_nerf, k_lt, k_ll = jax.random.split(jax.random.PRNGKey(0), 3)
    n = len(jeng.train_data)
    jeng.state = {"params": {"nerf": init_nerf_st(k_nerf, jcfg)},
                  "latents": {"trans": jax.random.normal(k_lt, (n, 8)),
                              "light": jax.random.normal(k_ll, (n, 12))}}
    res_j = jeng.evaluate_full()

    tcfg = cfg_for(tmp_path / "torch")
    save_checkpoint(tcfg.output_path, jeng.state)
    teng = evaluate.main([f"--yaml={_yaml(tcfg, tmp_path / 'eval.yaml')}",
                          "--resume", "--device=cpu"])
    assert teng._eval_compact_transform() is None
    qj, qt = _quant(jcfg.output_path), _quant(tcfg.output_path)
    assert len(qj) == len(qt) == 2
    for rj, rt in zip(qj, qt):
        assert abs(rj["psnr"] - rt["psnr"]) <= 1e-3, (rj, rt)
        assert abs(rj["ssim"] - rt["ssim"]) <= 1e-4, (rj, rt)
    assert np.isfinite(res_j["psnr"])

    dj = os.path.join(jcfg.output_path, "test_view_last")
    dt = os.path.join(tcfg.output_path, "test_view_last")
    names = sorted(os.listdir(dt))
    assert names == sorted(os.listdir(dj))
    renders = [f for f in names if f[0].isdigit()]
    assert len(renders) == 2
    for kind in ("", "syn_", "depth_vis_"):
        for f in renders:
            a = cv2.imread(os.path.join(dj, kind + f)).astype(int)
            b = cv2.imread(os.path.join(dt, kind + f)).astype(int)
            assert a.shape == b.shape == (256, 256, 3), kind + f
            assert np.abs(a - b).max() <= (0 if kind == "syn_" else 1), \
                kind + f
    # the raw frame is 120x160 < 256: the padded border lies outside the
    # mask, so the white composite shows there; the GT dump is not
    # composited, and its padded border stays black
    img = cv2.imread(os.path.join(dt, renders[0]))
    assert (img[0, 0] == 255).all() and (img[-1, -1] == 255).all()
    gt = cv2.imread(os.path.join(dt, "syn_" + renders[0]))
    assert (gt[0, 0] == 0).all()

    # warm_eval renders a frame and skips the metrics under scene_vis
    teng.warm_eval(0)
    assert json.dumps(_quant(tcfg.output_path)) == json.dumps(qt)
