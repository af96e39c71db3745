#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (texpose_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases; any failure exits non-zero and no result line is printed:
  1. build: both hand-written kernels compiled from csrc/ by nvcc (sm_90a);
  2. kernels: each kernel against its plain-PyTorch twin on the card at the
     main path's shapes — ST field on one 2048-ray × 64-sample chunk
     (131,072 rows, full width, bf16), composite on 2048 rays × 64 samples
     — checked against the bounds below and timed with CUDA events
     (median of repeats);
  3. slice: ``texpose_tpu_torch.evaluate`` (the CLI entry) on a generated
     480×640 fixture at the full width of configs/nerf_lm_adapt_gan.yaml,
     weights from the port's seeded init saved as a JAX-format npz and
     loaded with --init_weights.  The kernels' launch counters are zeroed
     just before that run and must be > 0 after it; PSNR/SSIM must be
     finite, quant.txt and one 480×640 PNG per frame written, and frame
     0's render through the kernels must agree with the plain route.
     views/s comes from a second, warm sweep.
Prints the card's name and power limit (nvidia-smi), one JSON line with
each kernel's numbers, and last {"ok": true, "device": {...}}.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# Bounds of kernel vs plain twin (max |a - b| over every output):
# ST field — both round each matmul operand to bf16 and sum in f32, in
# different orders; an order change can flip one activation's bf16
# rounding (2^-8 relative) and the flip propagates through 12 layers, so a
# few outputs of magnitude ≲ 4 move by up to ~2.5e-2 while the mean error
# stays ~1e-4.  A misplaced rounding point or a wrong weight errs by O(1).
FIELD_MAX_ERR = 3e-2
FIELD_MEAN_ERR = 1e-3
# composite — float32 on both sides; only the summation order differs.
COMPOSITE_MAX_ERR = 1e-4
# frame 0's object pixels, kernel route vs plain route (bf16 field): the
# field bound above after a sigmoid (slope ≤ 1/4) and compositing weights
# that sum to ≤ 1.
RENDER_MAX_ERR = 2e-2
N_TEST = 6


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps=10, warmup=2):
    """Median over reps of one call, CUDA events around it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def load_cfg(here):
    from texpose_tpu_torch.utils.config import load_yaml, process_options
    cfg = load_yaml(os.path.join(here, "configs", "nerf_lm_adapt_gan.yaml"))
    cfg.data.image_size = [480, 640]
    return process_options(cfg)


def kernel_phase(cfg, dev):
    """Each kernel against its twin on one eval chunk; returns the
    measured numbers per kernel."""
    import torch
    from texpose_tpu_torch.kernels.composite import (composite_st_fwd,
                                                     composite_st_plain)
    from texpose_tpu_torch.kernels.st_field import (st_field_fwd,
                                                    st_field_plain)
    from texpose_tpu_torch.models.render import gather_rays
    from texpose_tpu_torch.nn.fields import init_nerf_st, st_field_inputs
    from texpose_tpu_torch.ops.render import _dists, sample_depth

    g = torch.Generator().manual_seed(1)
    nerf = init_nerf_st(cfg, torch.Generator().manual_seed(0)).to(dev)
    weights = nerf.kernel_weights()
    R, N = int(cfg.nerf.rand_rays), int(cfg.nerf.sample_intvs)
    H, W = cfg.H, cfg.W
    # one chunk of object rays: a camera 4 units from the origin (the
    # fixture's 400 mm at depth scale 10), 2048 pixels of the frame's
    # central 160x160 window, bounds around a 0.6-unit sphere
    pose = torch.tensor([[[1., 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4]]])
    intr = torch.tensor([[[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]]])
    ys = torch.randint(160, 320, (R,), generator=g)
    xs = torch.randint(240, 400, (R,), generator=g)
    idx = (ys * W + xs)[None]
    near = torch.full((1, R), 3.4)
    far = torch.full((1, R), 4.6)
    center, ray, near, far = (t.to(dev) for t in gather_rays(
        pose, intr, idx, near, far, H, W, z_pregathered=True))
    depth = sample_depth(near, far, N)
    pts = center[..., None, :] + ray[..., None, :] * depth
    ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    xext, encpts = st_field_inputs(cfg, pts, ray_unit, progress=1.0)
    light = torch.randn(1, int(cfg.nerf.N_latent_light), generator=g).to(dev)
    trans = torch.randn(1, int(cfg.nerf.N_latent_trans), generator=g).to(dev)
    out = {}
    with torch.inference_mode():
        args = (xext, encpts, light, trans, weights, R * N, torch.bfloat16)
        got = st_field_fwd(*args)
        ref = st_field_plain(*args)
        torch.cuda.synchronize()
        errs = [(a - b).abs() for a, b in zip(got, ref)]
        max_err = max(float(e.max()) for e in errs)
        mean_err = max(float(e.mean()) for e in errs)
        ms = time_ms(lambda: st_field_fwd(*args))
        plain_ms = time_ms(lambda: st_field_plain(*args))
        tflops = 2 * weights_macs(weights, encpts.shape[1]) * R * N \
            / (ms * 1e-3) / 1e12
        print(f"kernel st_field_fwd: M={R * N} max|err|={max_err:.3g} "
              f"(bound {FIELD_MAX_ERR}) mean|err|={mean_err:.3g} "
              f"(bound {FIELD_MEAN_ERR}); {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms; {tflops:.1f} TFLOP/s", flush=True)
        if not (max_err <= FIELD_MAX_ERR and mean_err <= FIELD_MEAN_ERR):
            fail("st_field kernel disagrees with its plain twin")
        out["st_field_fwd"] = (max_err, ms, plain_ms)

        rgb_raw, dens_raw, trans_raw = got
        d = depth.reshape(R, N)
        dist = _dists(depth, ray).reshape(R, N)
        cargs = (rgb_raw, trans_raw, dens_raw, d, dist,
                 float(cfg.nerf.min_uncert))
        cgot = composite_st_fwd(*cargs)
        cref = composite_st_plain(*cargs)
        torch.cuda.synchronize()
        cmax = float((cgot - cref).abs().max())
        cms = time_ms(lambda: composite_st_fwd(*cargs), reps=20)
        cplain = time_ms(lambda: composite_st_plain(*cargs), reps=20)
        print(f"kernel composite_st_fwd: {R} rays x {N} samples "
              f"max|err|={cmax:.3g} (bound {COMPOSITE_MAX_ERR}); "
              f"{cms:.4f} ms vs plain {cplain:.4f} ms", flush=True)
        if not cmax <= COMPOSITE_MAX_ERR:
            fail("composite kernel disagrees with its plain twin")
        out["composite_st_fwd"] = (cmax, cms, cplain)
    return out


def weights_macs(weights, e3):
    """Multiply-adds per row of the field (the latent columns excluded:
    they are one row per image)."""
    F = weights.feat_dim
    macs = sum(layer.w.numel() for layer in weights.trunk)
    macs += (F + e3) * weights.rgb[0].w.shape[1] + F * weights.trans[0].w.shape[1]
    macs += sum(layer.w.numel() for layer in weights.rgb[1:])
    macs += sum(layer.w.numel() for layer in weights.trans[1:])
    return macs


def fixture_argv(here, tmp, dev, n_test):
    """A 480x640 fixture of n_test test frames and a seeded full-width
    checkpoint under tmp → the evaluation CLI's argv for them."""
    import torch
    from texpose_tpu_torch.data import generate_fixture
    from texpose_tpu_torch.nn.fields import init_nerf_st
    from texpose_tpu_torch.utils.checkpoint import (save_checkpoint_flat,
                                                    torch_state_to_jax)
    from texpose_tpu_torch.utils.config import set_options

    t0 = time.perf_counter()
    root = generate_fixture(os.path.join(tmp, "data"), n_train=8,
                            n_test=n_test, scene="scene_all",
                            image_scale=1.0, crop_res=128)
    print(f"fixture: {n_test} test frames at 480x640 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out_root = os.path.join(tmp, "out")
    ckpt = os.path.join(tmp, "init.npz")
    argv = ["--model=nerf_adapt_st_gan",
            f"--yaml={os.path.join(here, 'configs', 'nerf_lm_adapt_gan.yaml')}",
            f"--data.root={root}",
            f"--data.splits_root={os.path.join(root, 'splits')}",
            "--data.object=ball",
            "--nerf.depth.box_source=pred_box_init_calib",
            "--syn2real", "--data.image_size=[480,640]",
            f"--output_root={out_root}", f"--init_weights={ckpt}",
            f"--device={dev}"]
    # the weights: the port's seeded init, saved in the JAX npz format
    cfg = set_options(list(argv))
    gen = torch.Generator().manual_seed(0)
    state = {f"nerf.{k}": v for k, v in
             init_nerf_st(cfg, gen).state_dict().items()}
    state["latents.trans"] = torch.randn(8, cfg.nerf.N_latent_trans,
                                         generator=gen)
    state["latents.light"] = torch.randn(8, cfg.nerf.N_latent_light,
                                         generator=gen)
    save_checkpoint_flat(ckpt, torch_state_to_jax(state))
    return argv


def slice_phase(here, tmp, dev):
    """The evaluation CLI on a 480x640 fixture; returns the kernels'
    launch counts from that run."""
    import cv2
    import numpy as np
    import torch
    from texpose_tpu_torch import evaluate
    from texpose_tpu_torch.kernels.composite import composite_st_fwd
    from texpose_tpu_torch.kernels.st_field import st_field_fwd

    argv = fixture_argv(here, tmp, dev, N_TEST)
    st_field_fwd.launches = 0
    composite_st_fwd.launches = 0
    t0 = time.perf_counter()
    engine = evaluate.main(argv)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = {"st_field_fwd": st_field_fwd.launches,
                "composite_st_fwd": composite_st_fwd.launches}
    print(f"slice: evaluate (cold, {N_TEST} frames) {cold_s:.2f} s; "
          f"launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the main path did not launch every kernel: {launches}")

    out_path = engine.cfg.output_path
    rows = [ln.split() for ln in open(os.path.join(out_path, "quant.txt"))]
    psnr = [float(r[1]) for r in rows[1:]]
    ssim = [float(r[2]) for r in rows[1:]]
    if len(psnr) != N_TEST or not all(map(math.isfinite, psnr + ssim)):
        fail(f"quant.txt: {rows}")
    pngs = sorted(os.listdir(os.path.join(out_path, "test_view_last")))
    shapes = {cv2.imread(os.path.join(out_path, "test_view_last", p)).shape
              for p in pngs}
    if len(pngs) != N_TEST or shapes != {(480, 640, 3)}:
        fail(f"PNG export: {pngs} {shapes}")
    print(f"slice: PSNR {psnr} SSIM {ssim}", flush=True)

    # reference: frame 0 through the kernels and through the plain route
    frame = engine.eval_frame(0)
    sample = engine.eval_data[0]
    lt = np.zeros((1, int(engine.cfg.nerf.N_latent_trans)), np.float32)
    ll = engine.latents["light"][0:1]
    obj = torch.as_tensor(sample["obj_mask"].reshape(-1) > 0,
                          device=engine.device)
    with torch.inference_mode():
        k_out = engine._render_frame_st(frame, lt, ll,
                                        obj_host=sample["obj_mask"])
        engine.cfg.kernels.fused_st = False
        p_out = engine._render_frame_st(frame, lt, ll,
                                        obj_host=sample["obj_mask"])
        engine.cfg.kernels.fused_st = True
        err = float((k_out["rgb_static"][0][obj]
                     - p_out["rgb_static"][0][obj]).abs().max())
    print(f"slice: frame 0 rgb_static kernel vs plain route max|err|="
          f"{err:.3g} over {int(obj.sum())} object pixels "
          f"(bound {RENDER_MAX_ERR})", flush=True)
    if not err <= RENDER_MAX_ERR:
        fail("the kernel route disagrees with the plain route on frame 0")

    t0 = time.perf_counter()
    engine.evaluate_full()
    torch.cuda.synchronize()
    views = N_TEST / (time.perf_counter() - t0)
    print(f"slice: warm sweep {views:.3f} views/s end to end (480x640, "
          f"{N_TEST} frames)", flush=True)
    return launches


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "texpose_tpu_torch")):
        fail("texpose_tpu_torch/ not found: run from a checkout of the "
             "repository")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    # the shared host layer's package init imports jax when JAX_PLATFORMS
    # asks for cpu; the port must run with jax unimportable
    os.environ.pop("JAX_PLATFORMS", None)
    sys.modules["jax"] = None
    sys.path.insert(0, here)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from texpose_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    for name in ("st_field", "composite"):
        _build.build(name)
    print(f"build: both kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)

    measured = kernel_phase(load_cfg(here), dev)
    tmp = tempfile.mkdtemp(prefix="texpose_chip_smoke_")
    try:
        launches = slice_phase(here, tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    src = {"st_field_fwd": ("texpose_tpu_torch/csrc/st_field.cu",
                            "texpose_tpu/kernels/fused_st_field.py:922"),
           "composite_st_fwd": ("texpose_tpu_torch/csrc/composite.cu",
                                "texpose_tpu/kernels/fused_composite.py:240")}
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "launches": launches[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
               for name, (err, ms, plain_ms) in measured.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
