"""The port's pretrain through its CLIs on the CPU at a tiny size, its
checkpoints in both directions, and its evaluation against the JAX
package's:

  * ``python -m texpose_tpu_torch.train --model=nerf_pretrain`` for a few
    steps: finite losses, trunk and head both move; the JAX PretrainEngine
    restores the port's model.ckpt strictly (every leaf of its train state,
    Adam moments and schedule count included) and trains on; the port
    resumes from the checkpoint the JAX engine then writes;
  * the port's checkpoint, placed as the group's pretrain_model.ckpt, gives
    its trunk to both texture-GAN engines' --resume_pretrain (the JAX one
    and the port's train CLI);
  * ``validate`` and ``evaluate_full`` of one state agree with the JAX
    engine's (losses rtol 1e-4, PSNR 0.01 dB, SSIM 1e-4); the port's
    evaluate CLI reloads a checkpoint;
  * the env variant's CLI; the hierarchical pretrain's CLI
    (``nerf.fine_sampling``) and its evaluation; the unported options are
    refused before the networks are built.
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import yaml

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from texpose_tpu.utils.checkpoint import load_checkpoint_flat, \
    tree_to_flat_dict
from texpose_tpu.utils.config import process_options
from test_pretrain_e2e import tiny_pretrain_cfg
from test_texture_gan_e2e import tiny_gan_cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=4,
                            n_test=2, scene="scene_all", image_scale=0.25,
                            crop_res=32)


def pre_cfg(root, tmp_path):
    """The tiny pretrain config with the GAN test's field (the trunk
    transfers), 16 rays per image x 16 samples."""
    cfg = tiny_pretrain_cfg(root, tmp_path)
    gan = tiny_gan_cfg(root, tmp_path)
    cfg.arch = gan.arch.copy()
    cfg.arch.posenc = {"L_3D": gan.arch.posenc.L_3D, "L_view": None}
    cfg.data.scene = "scene_all"
    cfg.data.erode_mask_loss = True
    cfg.nerf.sample_intvs = 16
    cfg.nerf.rand_rays = 64
    cfg.optim.sched = {"gamma": 0.999}
    cfg.max_iter = 3
    cfg.freq.scalar = 1
    cfg.group = "pipe"
    cfg.name = "pre"
    return process_options(cfg)


def _yaml(cfg, path):
    with open(path, "w") as f:
        yaml.safe_dump({k: v for k, v in cfg.to_dict().items()
                        if k not in ("H", "W", "output_path")}, f)
    return str(path)


def _train(yml, *extra):
    from texpose_tpu_torch import train
    return train.main([f"--yaml={yml}", "--device=cpu", "--freq.vis=null",
                       *extra])


def _jax_engine(cfg):
    from texpose_tpu.models.pretrain import PretrainEngine
    eng = PretrainEngine(cfg)
    eng.load_dataset()
    eng.build_networks()
    eng.setup_optimizer()
    return eng


def test_pretrain_cli_and_jax_roundtrip(root, tmp_path):
    cfg = pre_cfg(root, tmp_path)
    yml = _yaml(cfg, tmp_path / "pre.yaml")
    eng = _train(yml)
    assert eng.it == 3
    out = load_checkpoint_flat(os.path.join(cfg.output_path, "model.ckpt"))
    assert int(out["step"]) == 3 and int(out["it"]) == 3
    assert int(out["opt_state/0/count"]) == 3
    recs = [json.loads(ln) for ln in
            open(os.path.join(cfg.output_path, "metrics.jsonl"))]
    train_recs = [r for r in recs if r["split"] == "train"]
    assert [r["step"] for r in train_recs] == [1, 2, 3]
    for r in train_recs:
        assert {"mask", "depth", "render", "all"} <= set(r)
        assert all(np.isfinite(v) for k, v in r.items() if k != "split"), r
    assert any(r["split"] == "val" and "PSNR" in r for r in recs)
    # trunk and head both moved from the seeded init
    from texpose_tpu_torch.nn.fields import init_nerf
    import torch
    init = init_nerf(cfg, torch.Generator().manual_seed(0)).state_dict()
    for k, v in init.items():
        assert not np.array_equal(out["params/nerf/" + k.replace(".", "/")],
                                  v.numpy()), k

    # the JAX engine resumes strictly from the port's checkpoint
    jcfg = pre_cfg(root, tmp_path)
    jcfg.max_iter = 5
    jcfg.resume = True
    jeng = _jax_engine(jcfg)
    template = tree_to_flat_dict(dict(jeng.state, step=np.int32(0)))
    assert sorted(template) == sorted(out)
    assert jeng.restore_checkpoint()
    assert jeng.start_step == 3 and int(jeng.state["it"]) == 3
    restored = tree_to_flat_dict(jax.device_get(jeng.state))
    for k, v in restored.items():
        np.testing.assert_array_equal(v, out[k], err_msg=k)
    jeng.state, loss = jeng.step_fn(jeng.state, jeng.train_batch)
    assert all(np.isfinite(float(v)) for v in loss.values())
    jeng.save_checkpoint(4)

    # and the port resumes from the checkpoint the JAX engine wrote
    eng2 = _train(yml, "--resume", "--max_iter=5")
    assert eng2.start_step == 4 and eng2.it == 5
    out2 = load_checkpoint_flat(os.path.join(cfg.output_path, "model.ckpt"))
    assert int(out2["step"]) == 5 and int(out2["opt_state/0/count"]) == 5
    assert int(out2["opt_state/1/count"]) == 5

    # the port's evaluate CLI reloads it: PNGs and quant.txt
    from texpose_tpu_torch import evaluate
    ev = evaluate.main([f"--yaml={yml}", "--device=cpu", "--resume"])
    assert ev.start_step == 5
    rows = open(os.path.join(cfg.output_path, "quant.txt")).read().split(
        "\n")[1:]
    assert len([r for r in rows if r.strip()]) == len(ev.eval_data)
    for sub in ("rgb", "opacity"):
        assert len(os.listdir(os.path.join(cfg.output_path, sub))) == \
            len(ev.eval_data)


def test_port_pretrain_ckpt_feeds_both_gan_engines(root, tmp_path):
    """The port's pretrain checkpoint as <group>/pretrain_model.ckpt: the
    JAX GAN engine's and the port's GAN CLI's --resume_pretrain load its
    trunk bit for bit (and the port's GAN run keeps it frozen)."""
    cfg = pre_cfg(root, tmp_path)
    cfg.max_iter = 2
    _train(_yaml(cfg, tmp_path / "pre.yaml"))
    pre = load_checkpoint_flat(os.path.join(cfg.output_path, "model.ckpt"))
    group_ckpt = os.path.join(str(cfg.output_root), "pipe",
                              "pretrain_model.ckpt")
    shutil.copyfile(os.path.join(cfg.output_path, "model.ckpt"), group_ckpt)
    trunk = {k: v for k, v in pre.items()
             if k.startswith("params/nerf/mlp_feat/")}
    assert trunk

    gan = tiny_gan_cfg(root, tmp_path)
    gan.output_root = cfg.output_root
    gan.group = "pipe"
    gan.name = "gan"
    gan.batch_size = 2
    gan = process_options(gan)
    from texpose_tpu.models.texture_gan import TextureGANEngine
    jeng = TextureGANEngine(gan)
    jeng.load_dataset(prefetch_train=False)
    jeng.build_networks()
    jeng.restore_pretrained_checkpoint()
    jflat = tree_to_flat_dict({"params": jax.device_get(
        jeng.state["params"])})
    for k, v in trunk.items():
        np.testing.assert_array_equal(jflat[k], v, err_msg=k)

    gan.max_iter = 1
    peng = _train(_yaml(gan, tmp_path / "gan.yaml"), "--resume_pretrain")
    out = load_checkpoint_flat(os.path.join(gan.output_path, "model.ckpt"))
    for k, v in trunk.items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert peng.it == 1


@pytest.mark.parametrize("env", [False, True], ids=["pretrain", "env"])
def test_validate_and_evaluate_match_jax(root, tmp_path, env):
    """One state (the JAX init through the checkpoint bridge): the port's
    validate losses and PSNR, and evaluate_full's per-frame PSNR and SSIM
    (kernel route's twins; the compact uint8 payload for the pretrain, the
    standard f32 frame with render.eval_compact off for the env variant),
    against the JAX engine's."""
    from test_torch_pretrain_step import jax_engine, port_engine, step_cfg
    cfg = step_cfg(root, tmp_path, env=env)
    cfg.data.val_sub = 2
    if env:
        cfg.render = {"eval_compact": False}
    jeng = jax_engine(cfg)
    peng = port_engine(cfg, jeng)
    jval = jeng.validate(0)
    pval = peng.validate(0)
    assert sorted(jval) == sorted(pval)
    for k in jval:
        np.testing.assert_allclose(pval[k], jval[k], rtol=1e-4, err_msg=k)
    jres = jeng.evaluate_full()
    jrows = open(os.path.join(cfg.output_path, "quant.txt")).read()
    pres = peng.evaluate_full()
    prows = open(os.path.join(cfg.output_path, "quant.txt")).read()
    assert abs(pres["psnr"] - jres["psnr"]) <= 0.01
    assert abs(pres["ssim"] - jres["ssim"]) <= 1e-4

    def cols(text):
        return np.array([[float(x) for x in ln.split()[1:3]]
                         for ln in text.splitlines()[1:] if ln.strip()])

    j, p = cols(jrows), cols(prows)
    assert j.shape == p.shape == (len(jeng.eval_data), 2)
    np.testing.assert_allclose(p[:, 0], j[:, 0], atol=0.01)
    np.testing.assert_allclose(p[:, 1], j[:, 1], atol=1e-4)


def test_env_cli_trains(root, tmp_path):
    cfg = pre_cfg(root, tmp_path)
    cfg.model = "nerf_pretrain_env"
    cfg.arch.posenc.L_view = 2
    cfg.nerf.view_dep = True
    cfg.optim.sched = {}
    cfg.loss_weight.depth = None
    cfg.max_iter = 2
    cfg.name = "env"
    cfg = process_options(cfg)
    eng = _train(_yaml(cfg, tmp_path / "env.yaml"))
    assert type(eng).__name__ == "PretrainEnvEngine" and eng.it == 2
    out = load_checkpoint_flat(os.path.join(cfg.output_path, "model.ckpt"))
    assert out["params/nerf/mlp_rgb/0/w"].shape[0] == 32 + 15 + 3


def test_cli_refuses_unported_options(root, tmp_path):
    """The hierarchical pretrain runs through the CLI (3 steps, both
    fields' leaves and Adam moments in model.ckpt, the fine render loss
    logged) and the evaluate CLI reloads its coarse field; visualize and
    --video are refused before anything is built."""
    from texpose_tpu_torch import evaluate, train
    cfg = pre_cfg(root, tmp_path)
    cfg.nerf.fine_sampling = True
    cfg.nerf.sample_intvs_fine = 16
    cfg.loss_weight.render_fine = 0
    yml = _yaml(cfg, tmp_path / "fine.yaml")
    with pytest.raises(NotImplementedError, match="visualize"):
        train.main([f"--yaml={yml}", "--device=cpu", "--freq.vis=1"])
    with pytest.raises(NotImplementedError, match="video"):
        evaluate.main([f"--yaml={yml}", "--device=cpu", "--video"])
    assert not os.path.exists(os.path.join(cfg.output_path, "model.ckpt"))

    eng = _train(yml)
    assert eng.it == 3 and eng.nerf_fine is not None
    out = load_checkpoint_flat(os.path.join(cfg.output_path, "model.ckpt"))
    for field in ("nerf", "nerf_fine"):
        for k in ("params/{}/mlp_feat/0/w", "params/{}/mlp_rgb/1/b",
                  "opt_state/0/mu/{}/mlp_feat/2/w",
                  "opt_state/0/nu/{}/mlp_rgb/0/w"):
            assert k.format(field) in out, k.format(field)
    recs = [json.loads(ln) for ln in
            open(os.path.join(cfg.output_path, "metrics.jsonl"))]
    train_recs = [r for r in recs if r["split"] == "train"]
    assert [r["step"] for r in train_recs] == [1, 2, 3]
    assert all(np.isfinite(r["render_fine"]) for r in train_recs)
    ev = evaluate.main([f"--yaml={yml}", "--device=cpu", "--resume"])
    assert ev.start_step == 3
    np.testing.assert_array_equal(
        ev.nerf.mlp_feat[0].w.detach().numpy(),
        out["params/nerf/mlp_feat/0/w"])
    rows = open(os.path.join(cfg.output_path, "quant.txt")).read().split(
        "\n")[1:]
    assert len([r for r in rows if r.strip()]) == len(ev.eval_data)


def test_profile_flag_writes_a_trace(root, tmp_path):
    """--profile: a 2-step run leaves a torch.profiler chrome trace in
    <output_path>/profile, the directory of the JAX loop's jax.profiler
    trace, with the steps' host events in it."""
    cfg = pre_cfg(root, tmp_path)
    cfg.max_iter = 2
    eng = _train(_yaml(cfg, tmp_path / "pre.yaml"), "--profile=true")
    assert eng.it == 2
    prof_dir = os.path.join(cfg.output_path, "profile")
    files = os.listdir(prof_dir)
    assert files == ["trace.json"]
    with open(os.path.join(prof_dir, "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("step/") for n in names), sorted(
        str(n) for n in names)[:20]
