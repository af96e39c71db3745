#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (texpose_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases; any failure exits non-zero and no result line is printed:
  1. build: both kernel sources compiled from csrc/ by nvcc (sm_90a), in
     parallel;
  2. kernels: each of the four kernels against its plain-PyTorch twin on
     the card at the main paths' shapes — ST field forward on one
     2048-ray × 64-sample chunk (131,072 rows, full width, bf16), its
     backward on the train step's 8 images × 16,384 rows, composite
     forward and backward on 2048 rays × 64 samples — checked against the
     bounds below and timed with CUDA events (median of repeats);
  3. eval: ``texpose_tpu_torch.evaluate`` (the CLI entry) on a generated
     480×640 fixture at the full width of configs/nerf_lm_adapt_gan.yaml,
     weights from the port's seeded init saved as a JAX-format npz and
     loaded with --init_weights.  The launch counters are zeroed just
     before that run and both forward kernels' must be > 0 after it;
     PSNR/SSIM must be finite, quant.txt and one 480×640 PNG per frame
     written, and frame 0's render through the kernels must agree with the
     plain route.  views/s comes from a second, warm sweep;
  4. train: ``texpose_tpu_torch.train`` (the CLI entry) for TRAIN_STEPS
     steps on a 128×128 fixture of 16 train images at the same full width
     (batch 8 of 16×16 patches, 64 samples, VGG + GAN + R1 losses), the
     trunk from a seeded JAX-format pretrain_model.ckpt via
     --resume_pretrain.  All four launch counters are zeroed just before
     and must be > 0 after it; every logged loss must be finite, the trunk
     unchanged and the heads moved, model.ckpt must hold the JAX package's
     train-state keypaths, and the port's evaluate must reload it.  Then,
     from one state and one set of draws, the kernel route's losses and
     gradients must agree with the plain route's, and warm steps/s and
     rays/s (2048 rays per step) are timed.
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
# the field's [M,256] feature residual: the same flips through the 8 trunk
# layers, but the features reach ~10, where one bf16 ulp is 2^-7 of the
# value, so the bound is relative: |err| ≤ FEAT_REL·max(|ref|, 1) per
# element (measured 0.0162 on the H100), mean |err| ≤ 1e-3.
FEAT_REL = 3e-2
# composite — float32 on both sides; only the summation order differs.
COMPOSITE_MAX_ERR = 1e-4
# frame 0's object pixels, kernel route vs plain route (bf16 field): the
# field bound above after a sigmoid (slope ≤ 1/4) and compositing weights
# that sum to ≤ 1.
RENDER_MAX_ERR = 2e-2
# ST-field backward — the kernel's residual feeds kernel and twin, so they
# differ where an f32 summation order flips a bf16 rounding in the chain,
# and in the order of the atomic cross-tile sums: per gradient tensor,
# ‖kernel − twin‖ ≤ 1e-2·‖twin‖ and no element off by more than 5e-2 of
# the tensor's largest magnitude (tests/test_torch_cuda.py).
FIELD_BWD_NORM = 1e-2
FIELD_BWD_MAX = 5e-2
# composite backward — float32 on both sides; the suffix sums' order
# differs: 1e-4 of the largest magnitude.
COMPOSITE_BWD_REL = 1e-4
# train step, kernel route vs plain route from one state and one set of
# draws, both rounding every matmul operand to bf16: the plain route
# concatenates the heads' layer-0 input where the kernel splits it, and
# autograd rounds the weight gradients to bf16 where the kernel rounds the
# activation gradients, so each loss agrees to rtol ROUTE_LOSS_RTOL and
# each gradient tensor to ROUTE_GRAD_NORM of its norm.
ROUTE_LOSS_RTOL = 1e-2
ROUTE_GRAD_NORM = 5e-2
N_TEST = 6
TRAIN_STEPS = 30
WARM_STEPS = 20


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
    from texpose_tpu_torch.kernels.composite import (composite_st_bwd,
                                                     composite_st_bwd_plain,
                                                     composite_st_fwd,
                                                     composite_st_plain)
    from texpose_tpu_torch.kernels.st_field import (st_field_bwd,
                                                    st_field_bwd_plain,
                                                    st_field_fwd,
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

        # composite backward on the same rays, a cotangent like the train
        # step's (per-ray means over 2048 rays)
        cot = (torch.randn(R, 16, generator=g) / R).to(dev)
        bargs = (rgb_raw, trans_raw, dens_raw, dist, cot)
        bgot = composite_st_bwd(*bargs)
        bref = composite_st_bwd_plain(*bargs)
        torch.cuda.synchronize()
        brel = max(rel_max(a, b) for a, b in zip(bgot, bref))
        bmax = max(float((a - b).abs().max()) for a, b in zip(bgot, bref))
        bms = time_ms(lambda: composite_st_bwd(*bargs), reps=20)
        bplain = time_ms(lambda: composite_st_bwd_plain(*bargs), reps=20)
        print(f"kernel composite_st_bwd: {R} rays x {N} samples "
              f"max|err|={bmax:.3g} ({brel:.3g} of max, bound "
              f"{COMPOSITE_BWD_REL}); {bms:.4f} ms vs plain {bplain:.4f} ms",
              flush=True)
        if not brel <= COMPOSITE_BWD_REL:
            fail("composite backward kernel disagrees with its plain twin")
        out["composite_st_bwd"] = (bmax, bms, bplain)

        # field backward at the train step's shape: 8 images x 16,384 rows
        B = int(cfg.batch_size)
        rpi = int(cfg.patch_size) ** 2 * N
        M = B * rpi
        reps = -(-M // xext.shape[0])
        xt = xext.repeat(reps, 1)[:M]
        et = encpts.repeat(reps, 1)[:M]
        lt = torch.randn(B, int(cfg.nerf.N_latent_light), generator=g).to(dev)
        tt = torch.randn(B, int(cfg.nerf.N_latent_trans), generator=g).to(dev)
        fargs = (xt, et, lt, tt, weights, rpi, torch.bfloat16)
        *_, feat = st_field_fwd(*fargs, want_feat=True)
        *_, feat_ref = st_field_plain(*fargs, want_feat=True)
        torch.cuda.synchronize()
        ferr = (feat.float() - feat_ref).abs()
        frel = float((ferr / feat_ref.abs().clamp(min=1.0)).max())
        print(f"kernel st_field_fwd residual: M={M} feat max|err|="
              f"{float(ferr.max()):.3g}, max|err|/max(|ref|,1)={frel:.3g} "
              f"(bound {FEAT_REL}), mean|err|={float(ferr.mean()):.3g} "
              f"(bound {FIELD_MEAN_ERR})", flush=True)
        if not (frel <= FEAT_REL and float(ferr.mean()) <= FIELD_MEAN_ERR):
            fail("st_field residual disagrees with the twin's features")
        g_rgb = (torch.randn(M, 3, generator=g) / M).to(dev)
        g_tr = (torch.randn(M, 5, generator=g) / M).to(dev)
        gargs = (feat, et, lt, tt, weights, rpi, g_rgb, g_tr)
        got = st_field_bwd(*gargs)
        want = st_field_bwd_plain(*gargs)
        torch.cuda.synchronize()
        flat_got = list(got[0]) + list(got[1:])
        flat_want = list(want[0]) + list(want[1:])
        norm = max(rel_norm(a, b) for a, b in zip(flat_got, flat_want))
        peak = max(rel_max(a, b) for a, b in zip(flat_got, flat_want))
        fmax = max(float((a - b).abs().max())
                   for a, b in zip(flat_got, flat_want))
        fms = time_ms(lambda: st_field_bwd(*gargs))
        fplain = time_ms(lambda: st_field_bwd_plain(*gargs))
        print(f"kernel st_field_bwd: M={M} ({B} images) worst tensor "
              f"‖err‖/‖ref‖={norm:.3g} (bound {FIELD_BWD_NORM}), max|err|/"
              f"max|ref|={peak:.3g} (bound {FIELD_BWD_MAX}); {fms:.4f} ms "
              f"vs plain {fplain:.4f} ms", flush=True)
        if not (norm <= FIELD_BWD_NORM and peak <= FIELD_BWD_MAX):
            fail("st_field backward kernel disagrees with its plain twin")
        out["st_field_bwd"] = (fmax, fms, fplain)
    return out


def rel_max(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def rel_norm(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


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
    launch counts from that run (the forward kernels only: eval has no
    backward)."""
    import cv2
    import numpy as np
    import torch
    from texpose_tpu_torch import evaluate

    argv = fixture_argv(here, tmp, dev, N_TEST)
    zero_launches()
    t0 = time.perf_counter()
    engine = evaluate.main(argv)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"slice: evaluate (cold, {N_TEST} frames) {cold_s:.2f} s; "
          f"launches {launches}", flush=True)
    if min(launches[k] for k in ("st_field_fwd", "composite_st_fwd")) <= 0:
        fail(f"the eval path did not launch both forward kernels: "
             f"{launches}")

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


def _launch_wrappers():
    from texpose_tpu_torch.kernels.composite import (composite_st_bwd,
                                                     composite_st_fwd)
    from texpose_tpu_torch.kernels.st_field import st_field_bwd, st_field_fwd
    return {f.__name__: f for f in (st_field_fwd, st_field_bwd,
                                    composite_st_fwd, composite_st_bwd)}


def zero_launches():
    for f in _launch_wrappers().values():
        f.launches = 0


def read_launches():
    return {k: f.launches for k, f in _launch_wrappers().items()}


def train_argv(here, tmp, dev, steps):
    """A 128x128 fixture of 16 train images (bench.py's), a seeded trunk
    saved as the group's JAX-format pretrain_model.ckpt → the train CLI's
    argv."""
    import torch
    from texpose_tpu_torch.data import generate_fixture
    from texpose_tpu_torch.nn.fields import init_nerf_st
    from texpose_tpu_torch.utils.checkpoint import (save_checkpoint_flat,
                                                    torch_state_to_jax)
    from texpose_tpu_torch.utils.config import set_options

    t0 = time.perf_counter()
    root = generate_fixture(os.path.join(tmp, "train_data"), n_train=16,
                            n_test=1, scene="scene_all", image_scale=1.0,
                            crop_res=128)
    print(f"fixture: 16 train frames at 128x128 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out_root = os.path.join(tmp, "train_out")
    argv = ["--model=nerf_adapt_st_gan",
            f"--yaml={os.path.join(here, 'configs', 'nerf_lm_adapt_gan.yaml')}",
            f"--data.root={root}",
            f"--data.splits_root={os.path.join(root, 'splits')}",
            "--data.object=ball",
            "--nerf.depth.box_source=pred_box_init_calib",
            f"--output_root={out_root}", "--resume_pretrain",
            "--freq.vis=null", f"--max_iter={steps}", "--freq.scalar=10",
            "--freq.val=1000", "--freq.ckpt=1000", f"--device={dev}"]
    cfg = set_options(list(argv))
    trunk = init_nerf_st(cfg, torch.Generator().manual_seed(123)).mlp_feat
    pre_dir = os.path.join(out_root, str(cfg.group))
    os.makedirs(pre_dir, exist_ok=True)
    pre = save_checkpoint_flat(
        os.path.join(pre_dir, "pretrain_model.ckpt"),
        torch_state_to_jax({f"nerf.mlp_feat.{k}": v
                            for k, v in trunk.state_dict().items()}))
    return argv, pre


def train_phase(here, tmp, dev):
    """The train CLI at full width; returns (launch counts of that run,
    warm steps/s)."""
    import numpy as np
    import torch
    from texpose_tpu_torch import evaluate, train
    from texpose_tpu_torch.nn.fields import init_nerf_st
    from texpose_tpu_torch.utils.checkpoint import load_checkpoint_flat

    argv, pre = train_argv(here, tmp, dev, TRAIN_STEPS)
    zero_launches()
    t0 = time.perf_counter()
    eng = train.main(argv)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"train: {TRAIN_STEPS} steps (cold, incl. validation at step 0) "
          f"{cold_s:.2f} s; launches {launches}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"the train path did not launch every kernel: {launches}")

    cfg = eng.cfg
    recs = [json.loads(ln) for ln in
            open(os.path.join(cfg.output_path, "metrics.jsonl"))]
    losses = [r for r in recs if r["split"] == "train" and "all" in r]
    if [r["step"] for r in losses] != [1] + list(range(10, TRAIN_STEPS + 1,
                                                       10)):
        fail(f"train: unexpected scalar steps {[r['step'] for r in losses]}")
    for r in losses:
        bad = [k for k, v in r.items()
               if k != "split" and not math.isfinite(v)]
        if bad:
            fail(f"train: non-finite {bad} at step {r['step']}")
    last = {k: round(v, 5) for k, v in losses[-1].items()
            if k not in ("split", "time", "step")}
    print(f"train: step {losses[-1]['step']} losses {last}", flush=True)

    flat = load_checkpoint_flat(os.path.join(cfg.output_path, "model.ckpt"))
    pre_flat = load_checkpoint_flat(pre)
    init = init_nerf_st(cfg, torch.Generator().manual_seed(
        int(cfg.get("seed", 0))))
    for k, v in pre_flat.items():
        if not np.array_equal(flat[k], v):
            fail(f"train: frozen trunk leaf {k} changed")
    moved = 0
    for k, v in init.state_dict().items():
        if k.startswith(("mlp_rgb.", "mlp_trans.")):
            moved += not np.array_equal(
                flat["params/nerf/" + k.replace(".", "/")], v.numpy())
    if moved != len([k for k in init.state_dict()
                     if k.startswith(("mlp_rgb.", "mlp_trans."))]):
        fail("train: some head leaves did not move")
    need = ["params/nerf/mlp_feat/0/w", "params/nerf/mlp_rgb/0/w",
            "params/disc/main/0/w", "params/disc/final/2/w",
            "sn_state/main/0", "latents/light", "latents/trans",
            "opt_nerf/0/count", "opt_nerf/0/mu/heads/mlp_rgb/0/w",
            "opt_nerf/0/nu/latents/light", "opt_nerf/1/count",
            "opt_disc/0/nu/main/0/w", "key", "it", "step"]
    missing = [k for k in need if k not in flat]
    if missing or int(flat["step"]) != TRAIN_STEPS:
        fail(f"train: model.ckpt lacks JAX keypaths {missing} or step")
    print(f"train: trunk unchanged, heads moved; model.ckpt holds "
          f"{len(flat)} JAX keypaths, step {int(flat['step'])}", flush=True)

    # the port's evaluate reloads the trained checkpoint
    ev = evaluate.main([a for a in argv if not a.startswith(
        ("--resume_pretrain", "--max_iter", "--freq."))]
        + ["--resume"])
    q = [ln.split() for ln in open(os.path.join(ev.cfg.output_path,
                                                "quant.txt"))][1:]
    if ev.start_step != TRAIN_STEPS or not q or not all(
            math.isfinite(float(r[1])) for r in q):
        fail(f"train: evaluate did not reload model.ckpt ({ev.start_step}, "
             f"{q})")
    print(f"train: evaluate reloaded model.ckpt @ step {ev.start_step}, "
          f"PSNR {[float(r[1]) for r in q]}", flush=True)

    route_check(eng)

    # warm steps/s (host clock, the step's work ending in a sync)
    for _ in range(3):
        eng.train_step(eng.make_draws(eng.it))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        eng.train_step(eng.make_draws(eng.it))
    torch.cuda.synchronize()
    steps_s = WARM_STEPS / (time.perf_counter() - t0)
    print(f"train: warm {steps_s:.3f} steps/s = {steps_s * 2048:.1f} rays/s "
          f"(texture_train_rays_per_sec, batch 8 x 16x16 patches, "
          f"{WARM_STEPS} steps)", flush=True)
    return launches, steps_s


def route_check(eng):
    """One step from one state and one set of draws through the kernel
    route and through the plain route: losses and gradients agree."""
    cfg = eng.cfg
    state = eng.train_state_flat(0)
    draws = eng.make_draws(eng.it)

    def grads():
        out = {f"heads/{k}": p.grad.clone()
               for k, p in eng._trainable_heads()}
        out.update({f"latents/{k}": t.grad.clone()
                    for k, t in eng.latents.items()})
        out.update({f"disc/{g}/{i}": w.grad.clone()
                    for g, i, w in eng._disc_leaves()})
        return out

    k_loss = eng.train_step(draws)
    k_grad = grads()
    eng.load_train_state_flat(state)
    cfg.kernels.fused_st = False
    try:
        p_loss = eng.train_step(draws)
    finally:
        cfg.kernels.fused_st = True
    p_grad = grads()
    eng.load_train_state_flat(state)
    loss_err = max(abs(float(k_loss[k]) - float(p_loss[k]))
                   / max(abs(float(p_loss[k])), 1e-12) for k in p_loss)
    grad_err = {k: rel_norm(k_grad[k], p_grad[k]) for k in p_grad}
    worst = max(grad_err, key=grad_err.get)
    print(f"train: kernel vs plain route, one step: worst loss rel "
          f"{loss_err:.3g} (bound {ROUTE_LOSS_RTOL}); worst gradient "
          f"‖err‖/‖ref‖ {grad_err[worst]:.3g} at {worst} (bound "
          f"{ROUTE_GRAD_NORM})", flush=True)
    if not (loss_err <= ROUTE_LOSS_RTOL
            and grad_err[worst] <= ROUTE_GRAD_NORM):
        fail("train: the kernel route disagrees with the plain route")


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

    from concurrent.futures import ThreadPoolExecutor

    from texpose_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:       # one nvcc per source at once
        list(pool.map(_build.build, ("st_field", "composite")))
    print(f"build: both kernel sources in {time.perf_counter() - t0:.1f} s",
          flush=True)

    measured = kernel_phase(load_cfg(here), dev)
    tmp = tempfile.mkdtemp(prefix="texpose_chip_smoke_")
    try:
        slice_phase(here, tmp, dev)
        launches, _ = train_phase(here, tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    src = {"st_field_fwd": ("texpose_tpu_torch/csrc/st_field.cu",
                            "texpose_tpu/kernels/fused_st_field.py:922"),
           "st_field_bwd": ("texpose_tpu_torch/csrc/st_field.cu",
                            "texpose_tpu/kernels/fused_st_field.py:1000"),
           "composite_st_fwd": ("texpose_tpu_torch/csrc/composite.cu",
                                "texpose_tpu/kernels/fused_composite.py:240"),
           "composite_st_bwd": ("texpose_tpu_torch/csrc/composite.cu",
                                "texpose_tpu/kernels/fused_composite.py:258")}
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
