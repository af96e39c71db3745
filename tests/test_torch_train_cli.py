"""The port's training CLI (``python -m texpose_tpu_torch.train``) on the
CPU at a tiny size, and its checkpoints in both directions:

  * a few steps with --resume_pretrain from a pretrain_model.ckpt the JAX
    package wrote: the trunk stays bit-identical to that checkpoint, the
    heads and latents move, every logged loss is finite;
  * the JAX engine restores the port's model.ckpt strictly (every leaf of
    its train state, optimizer moments included, present with its shape),
    holds the same values and trains on; the port resumes from the
    checkpoint the JAX engine then writes, and goes on;
  * a run whose freq.vis fires (once refused) trains and writes the
    thirteen panels at each firing and the anchors' cameras.png once.
"""

import json
import os
import sys

import cv2
import jax
import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from test_texture_gan_e2e import tiny_gan_cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=6,
                            n_test=1, scene="scene_all", image_scale=0.25,
                            crop_res=32)


def _yaml(cfg, path):
    with open(path, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.to_dict().items()
                        if k not in ("H", "W", "output_path")}, f)
    return str(path)


def _pretrain_ckpt(cfg, path):
    """A JAX-written pretrain checkpoint holding a field for this config."""
    from texpose_tpu.nn.fields import init_nerf_st
    from texpose_tpu.utils.checkpoint import save_checkpoint
    params = init_nerf_st(jax.random.PRNGKey(42), cfg)
    save_checkpoint(str(path), {"params": {"nerf": params}})
    return os.path.join(str(path), "model.ckpt")


def _train(yml, *extra):
    from texpose_tpu_torch import train
    return train.main([f"--yaml={yml}", "--device=cpu", "--freq.vis=null",
                       "--batch_size=2", *extra])


def test_train_cli_resume_pretrain_and_jax_roundtrip(root, tmp_path):
    from texpose_tpu.utils.checkpoint import load_checkpoint_flat
    cfg = tiny_gan_cfg(root, tmp_path)
    cfg.max_iter = 3
    cfg.freq.scalar = 1
    pre = _pretrain_ckpt(cfg, tmp_path / "pre")
    yml = _yaml(cfg, tmp_path / "train.yaml")
    eng = _train(yml, "--resume_pretrain", f"--pretrain_ckpt={pre}")
    assert eng.it == 3
    pre_flat = load_checkpoint_flat(pre)
    out = load_checkpoint_flat(os.path.join(cfg.output_path, "model.ckpt"))
    assert int(out["step"]) == 3 and int(out["it"]) == 3
    for k, v in pre_flat.items():
        if "/mlp_feat/" in k:
            np.testing.assert_array_equal(out[k], v, err_msg=k)
        else:
            assert not np.array_equal(out[k], v), f"{k} did not move"
    recs = [json.loads(ln) for ln in
            open(os.path.join(cfg.output_path, "metrics.jsonl"))]
    train_recs = [r for r in recs if r["split"] == "train"]
    assert [r["step"] for r in train_recs if "all" in r] == [1, 2, 3]
    for r in train_recs:
        assert all(np.isfinite(v) for k, v in r.items() if k != "split"), r
    assert os.path.exists(os.path.join(cfg.output_path, "model", "3.ckpt"))

    # the JAX engine resumes strictly from the port's checkpoint
    from texpose_tpu.models.texture_gan import TextureGANEngine
    jcfg = tiny_gan_cfg(root, tmp_path)
    jcfg.batch_size = 2
    jcfg.max_iter = 5
    jcfg.resume = True
    jeng = TextureGANEngine(jcfg)
    jeng.load_dataset()
    jeng.build_networks()
    jeng.setup_optimizer()
    assert jeng.restore_checkpoint()
    assert jeng.start_step == 3 and int(jeng.state["it"]) == 3
    np.testing.assert_array_equal(
        np.asarray(jeng.state["latents"]["light"]), out["latents/light"])
    np.testing.assert_array_equal(
        np.asarray(jeng.state["opt_nerf"][0].nu["heads"]["mlp_rgb"][0]["w"]),
        out["opt_nerf/0/nu/heads/mlp_rgb/0/w"])
    jeng.state, loss = jeng.step_fn(jeng.state, jeng.train_batch)
    assert all(np.isfinite(float(v)) for v in loss.values())
    jeng.save_checkpoint(4)

    # and the port resumes from the checkpoint the JAX engine wrote
    eng2 = _train(yml, "--resume", "--max_iter=5")
    assert eng2.start_step == 4 and eng2.it == 5
    out2 = load_checkpoint_flat(os.path.join(cfg.output_path, "model.ckpt"))
    assert int(out2["step"]) == 5
    assert int(out2["opt_nerf/0/count"]) == 5


def test_train_cli_refuses_vis(root, tmp_path):
    from texpose_tpu_torch import train
    cfg = tiny_gan_cfg(root, tmp_path)
    cfg.max_iter = 3
    cfg.freq.vis = 2
    yml = _yaml(cfg, tmp_path / "train.yaml")
    eng = train.main([f"--yaml={yml}", "--device=cpu", "--batch_size=2"])
    assert eng.it == 3
    assert os.path.exists(os.path.join(cfg.output_path, "model.ckpt"))
    panels = ("image", "image_masked", "rgb", "rgb_static", "rgb_transient",
              "pred_mask", "gt_mask", "depth", "depth_gt", "z_near",
              "depth_error", "color_error", "uncert")
    vis_dir = os.path.join(cfg.output_path, "vis")
    assert sorted(os.listdir(vis_dir)) == sorted(
        [f"000002_{p}.png" for p in panels] + ["cameras.png"])
    for p in panels:
        img = cv2.imread(os.path.join(vis_dir, f"000002_{p}.png"))
        assert img.shape == (36, 36, 3), p
