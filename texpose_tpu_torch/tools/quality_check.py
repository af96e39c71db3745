"""Training-quality gate of the port (the JAX package's
tools/tpu_quality_check.py): short real-config training runs at the full
width of the shipped configs, to show that the kernels TRAIN on the card —
the loss falls, the validation PSNR rises, no loss goes non-finite in
bf16.  Run after kernel changes:

    python -m texpose_tpu_torch.tools.quality_check              (the card)
    python -m texpose_tpu_torch.tools.quality_check --device=cpu

Any other ``--key=value`` argument overrides both stages' configs (a run
at a reduced width).  Env: QUAL_PRETRAIN_ITERS / QUAL_GAN_ITERS set the
lengths (4000 / 2000 steps); QUAL_SKIP_PRETRAIN=1 reuses an existing trunk
checkpoint; QUAL_SKIP_GAN=1 stops after the pretrain.  The fixture and the
runs live under ``tempfile.gettempdir()`` (``texpose_qual_torch*``).

Both stages train as the JAX tool does: K = ``scan_k()`` steps a dispatch
through the engine's ``StepRunner`` (one captured CUDA graph a step on a
card, eager steps on the CPU); the "first" loss is read after the first
dispatch (pretrain) and at the first dispatch past step 20 (GAN).
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# generate_fixture's settings besides n_train and fixed_light
FIXTURE = {"n_test": 2, "scene": "scene_qual", "image_scale": 1.0,
           "crop_res": 128}
# the pretrain's gates: last loss < PRETRAIN_LOSS_DROP x the first, and
# validation PSNR > PRETRAIN_MIN_PSNR dB (the masked render's)
PRETRAIN_LOSS_DROP = 0.9
PRETRAIN_MIN_PSNR = 14.0


def check(ok, what):
    """A quality gate: raises AssertionError (also under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def fixture(n_train=16, fixed_light=False):
    """The sphere fixture, generated once per temp directory: 16 views
    with per-image light (``texpose_qual_torch_fixture_v3``) or, with
    ``fixed_light``, ``n_train`` views under one light
    (``texpose_qual_torch_fixture_fl<n_train>``)."""
    from ..data.fixture import generate_fixture
    name = f"fl{n_train}" if fixed_light else "v3"
    cache = os.path.join(tempfile.gettempdir(),
                         f"texpose_qual_torch_fixture_{name}")
    if not os.path.exists(os.path.join(cache, ".done")):
        os.makedirs(cache, exist_ok=True)
        generate_fixture(cache, n_train=n_train, fixed_light=fixed_light,
                         **FIXTURE)
        open(os.path.join(cache, ".done"), "w").close()
    return cache


def out_root():
    return os.path.join(tempfile.gettempdir(), "texpose_qual_torch")


def base(yaml_name, cache):
    """A shipped config at its full width on the fixture, object ball."""
    from ..utils.config import load_yaml, process_options
    cfg = load_yaml(os.path.join(REPO, "configs", yaml_name))
    cfg.yaml = "x"
    cfg = process_options(cfg)
    cfg.data.root = cache
    cfg.data.splits_root = os.path.join(cache, "splits")
    cfg.data.object = "ball"
    cfg.output_root = out_root()
    return process_options(cfg)


def finish(cfg, overrides=()):
    """``overrides`` (``--key=value`` strings) merged over cfg, then the
    output path recomputed."""
    from ..utils.config import merge, parse_cli_overrides, process_options
    if overrides:
        cfg = merge(cfg, parse_cli_overrides(list(overrides)),
                    allow_new=True)
    return process_options(cfg)


def pretrain_cfg(cache, iters, overrides=()):
    cfg = base("nerf_lm_pretrain.yaml", cache)
    cfg.data.scene = "scene_qual"          # != scene_all → real depth maps
    cfg.data.pose_source = "gt"
    cfg.nerf.depth.box_source = "gt_box"
    cfg.max_iter = iters
    cfg.name = "qual_pretrain"
    return finish(cfg, overrides)


def gan_cfg(cache, iters, overrides=()):
    cfg = base("nerf_lm_adapt_gan.yaml", cache)
    cfg.data.scene = "scene_qual"
    cfg.nerf.depth.box_source = "pred_box_init_calib"
    cfg.max_iter = iters
    cfg.name = "qual_gan"
    cfg.resume_pretrain = True
    return finish(cfg, overrides)


def sync(device):
    """Wait for the card's queued work (before a clock read)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dispatches(eng, iters):
    """The JAX tools' training loop: K = ``scan_k()`` steps a dispatch
    through the engine's ``StepRunner`` → yields (it, K, the dispatch's
    last losses) after each dispatch, ``it`` the count before it."""
    K = eng.scan_k()
    runner = eng.step_runner()
    for it in range(0, iters, K):
        yield it, K, runner.dispatch(K)


def start(engine_cls, cfg, device):
    """The train CLI's bootstrap for a fresh run."""
    eng = engine_cls(cfg, device)
    eng.load_dataset()
    eng.upload_train_split()
    eng.build_networks()
    eng.setup_optimizer()
    return eng


def save_pretrain(eng, it, ck):
    """The run's model.ckpt at step ``it``, copied to ``ck`` (the group's
    pretrain_model.ckpt that --resume_pretrain reads)."""
    eng.save_checkpoint(it)
    shutil.copyfile(os.path.join(eng.cfg.output_path, "model.ckpt"), ck)


def pretrain_stage(cache, device, overrides=()):
    """The geometry pretrain (GT poses, gt_box) → its summary.  Gates: the
    last loss below 0.9× the first, validation PSNR above 14."""
    from ..models.pretrain import PretrainEngine
    cfg = pretrain_cfg(cache, int(os.environ.get("QUAL_PRETRAIN_ITERS",
                                                 "4000")), overrides)
    eng = start(PretrainEngine, cfg, device)
    first = None
    sync(eng.device)
    t0 = time.time()
    for it, K, loss in dispatches(eng, cfg.max_iter):
        if it == 0:
            # after ONE dispatch (K steps).  The background mask loss is
            # inert by construction (the 1e10 last quadrature interval
            # pins background opacity at 1 with zero gradient), so the
            # descent is the masked render/depth terms'
            first = float(loss["all"])
    last = float(loss["all"])
    sync(eng.device)
    dt = time.time() - t0
    route = eng.step_runner().route
    print(f"PRETRAIN: loss {first:.4f} -> {last:.4f} "
          f"({cfg.max_iter / dt:.1f} it/s, {dt:.1f} s, scan {K}; {route})",
          flush=True)
    val = eng.validate(cfg.max_iter)
    print(f"PRETRAIN val: {val}", flush=True)
    check(np.isfinite(last) and last < first * PRETRAIN_LOSS_DROP,
          f"pretrain loss did not fall below {PRETRAIN_LOSS_DROP}x the "
          f"first: {first} -> {last}")
    check(val["PSNR"] > PRETRAIN_MIN_PSNR,
          f"pretrain validation PSNR <= {PRETRAIN_MIN_PSNR}: {val}")
    ck = os.path.join(cfg.output_path, "..", "pretrain_model.ckpt")
    save_pretrain(eng, cfg.max_iter, ck)
    return {"first": first, "last": last, "it_per_s": cfg.max_iter / dt,
            "wall_s": dt, "scan_k": K, "route": route, "val": val,
            "ckpt": os.path.normpath(ck), "engine": eng}


def gan_stage(cache, device, overrides=()):
    """The texture GAN from the pretrain's trunk (pred_box_init_calib) →
    its summary.  Gates: every loss of the last step finite; then
    validation and the full evaluation."""
    from ..models.texture_gan import TextureGANEngine
    cfg = gan_cfg(cache, int(os.environ.get("QUAL_GAN_ITERS", "2000")),
                  overrides)
    eng = start(TextureGANEngine, cfg, device)
    eng.restore_pretrained_checkpoint()
    first = None
    sync(eng.device)
    t0 = time.time()
    for it, K, loss in dispatches(eng, cfg.max_iter):
        if first is None and it + K > 20:
            first = float(loss["render"])
    host = {k: float(v) for k, v in loss.items()}
    sync(eng.device)
    dt = time.time() - t0
    route = eng.step_runner().route
    shown = "n/a" if first is None else f"{first:.4f}"
    print(f"GAN: render {shown} -> {host['render']:.4f} "
          f"({cfg.max_iter / dt:.1f} it/s, {dt:.1f} s, scan {K}; {route}); "
          f"last={host}", flush=True)
    check(all(np.isfinite(v) for v in host.values()),
          f"non-finite GAN loss: {host}")
    val = eng.validate(cfg.max_iter)
    print(f"GAN val: {val}", flush=True)
    ev = eng.evaluate_full()
    print(f"GAN eval_full: {ev}", flush=True)
    return {"first": first, "last": host, "it_per_s": cfg.max_iter / dt,
            "wall_s": dt, "scan_k": K, "route": route, "val": val,
            "eval": ev, "engine": eng}


def parse_argv(argv):
    """(device name, config overrides) from ``--device=...`` and
    ``--key=value`` arguments."""
    device, rest = "cuda", []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--"):
            rest.append(a)
        else:
            raise ValueError(f"invalid argument {a!r} (expected --key=value)")
    return device, rest


def main(argv=None):
    """Both stages on the card (``--device=cpu`` for the CPU) → {stage:
    summary}."""
    from ..models.base import resolve_device
    name, overrides = parse_argv(list(sys.argv[1:] if argv is None
                                      else argv))
    device = resolve_device({"device": name})
    cache = fixture()
    out = {}
    ck = os.path.join(out_root(),
                      str(pretrain_cfg(cache, 0, overrides).group),
                      "pretrain_model.ckpt")
    if os.environ.get("QUAL_SKIP_PRETRAIN") and os.path.exists(ck):
        print("PRETRAIN: skipped (existing trunk checkpoint)", flush=True)
    else:
        out["pretrain"] = pretrain_stage(cache, device, overrides)
    if not os.environ.get("QUAL_SKIP_GAN"):
        out["gan"] = gan_stage(cache, device, overrides)
    return out


if __name__ == "__main__":
    main()
