#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (texpose_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases; any failure exits non-zero and no result line is printed:
  1. build: the three kernel sources compiled from csrc/ by nvcc (sm_90a),
     in parallel;
  2. kernels: each of the seven kernels against its plain-PyTorch twin on
     the card at the main paths' shapes — ST field forward on one
     2048-ray × 64-sample chunk (131,072 rows, full width, bf16), its
     backward on the train step's 8 images × 16,384 rows, the dual
     composite forward and backward on 2048 rays × 64 samples; the coarse
     field + composite forward (with and without the training residuals),
     the composite-coarse backward and the trunk-training field backward
     on the pretrain step's 2048 rays × 64 samples — checked against the
     bounds below, timed with CUDA events (median of repeats) and set
     beside the least time the card could take (``bound``);
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
     --resume_pretrain.  All four texture kernels' launch counters are
     zeroed just before and must be > 0 after it; every logged loss must be
     finite, the trunk unchanged and the heads moved, model.ckpt must hold
     the JAX package's train-state keypaths, and the port's evaluate must
     reload it.  Then, from one state and one set of draws, the kernel
     route's losses and gradients must agree with the plain route's, and
     warm steps/s and rays/s (2048 rays per step) are timed;
  5. pretrain: ``texpose_tpu_torch.train --model=nerf_pretrain`` for
     PRETRAIN_STEPS steps at the full width of configs/nerf_lm_pretrain.yaml
     (8×256 trunk, skip at 4, RGB head 256-256-256-3, bf16, 64 samples,
     2048 rays) on a 128×128 fixture of 16 train images.  The three coarse
     kernels' counters are zeroed just before and must be > 0 after it;
     the losses must be finite, the trunk and the head both moved,
     model.ckpt must hold the JAX package's keypaths and the port's
     evaluate --resume must reload it; the kernel route must agree with the
     plain route from one state and one set of draws; warm steps/s × 2048
     is printed as pretrain_rays_per_sec.  Then ENV_STEPS steps of
     --model=nerf_pretrain_env (counters > 0 again), and the texture-GAN
     engine's --resume_pretrain loads the pretrain checkpoint's trunk.
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
# coarse field + composite forward, kernel vs twin: the raw outputs and the
# residual activations as the ST field's (FIELD_MAX_ERR / FIELD_MEAN_ERR,
# FEAT_REL); the composited rgb/depth/opacity after the sigmoid (slope ≤
# 1/4) and weights summing to ≤ 1, at depths ≲ 5, as RENDER_MAX_ERR
# relative to max(|ref|, 1).  Its two backwards: the composite's as the
# dual composite's (COMPOSITE_BWD_REL), the field's as the ST field
# backward's (FIELD_BWD_NORM / FIELD_BWD_MAX per tensor: atomics reorder
# its sums).
N_TEST = 6
TRAIN_STEPS = 30
WARM_STEPS = 20
PRETRAIN_STEPS = 30
ENV_STEPS = 10
# the least time the card could take (H100 SXM data sheet): bf16
# tensor-core and f32 peak rates, device-memory rate
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops, peak):
    """The least time the card could take, (ms, what bounds it): the larger
    of moving n_bytes at the memory rate and doing ops at ``peak``."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = ops / peak * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else \
        (by_bytes, "bytes")


def entry(err, ms, plain_ms, bnd, **extra):
    """One kernel's measured numbers (no single PyTorch call computes any
    of these functions, so there is no library time); ``extra`` adds
    further measured keys, such as relative errors."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            **extra}


# f32 operations per sample of the composites, counted from the kernels'
# arithmetic (a transcendental counted as one): far below their bytes
COMPOSITE_ST_FWD_OPS = 60
COMPOSITE_ST_BWD_OPS = 110
COMPOSITE_COARSE_BWD_OPS = 40


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
        out["st_field_fwd"] = entry(max_err, ms, plain_ms, bound(
            nbytes(xext, encpts, light, trans, *got,
                   *[t for layer in weights.trunk for t in (layer.w, layer.b)],
                   *weights.head_params()),
            2 * weights_macs(weights, encpts.shape[1]) * R * N, PEAK_BF16))

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
        out["composite_st_fwd"] = entry(cmax, cms, cplain, bound(
            nbytes(*cargs[:5], cgot), COMPOSITE_ST_FWD_OPS * R * N,
            PEAK_F32))

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
        out["composite_st_bwd"] = entry(bmax, bms, bplain, bound(
            nbytes(*bargs, *bgot), COMPOSITE_ST_BWD_OPS * R * N, PEAK_F32))

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
        out["st_field_bwd"] = entry(fmax, fms, fplain, bound(
            nbytes(feat, et, lt, tt, g_rgb, g_tr, *weights.head_params(),
                   *flat_got),
            2 * st_bwd_macs(weights, et.shape[1]) * M, PEAK_BF16))
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


def st_bwd_macs(weights, e3):
    """Multiply-adds per row of the ST heads' backward: the hidden layers'
    recompute, every layer's dW (layer 0 without its latent rows, done per
    image) and the dX of layers 1..n-1."""
    F = weights.feat_dim
    total = 0
    for head, rows0 in ((weights.rgb, F + e3), (weights.trans, F)):
        first = rows0 * head[0].w.shape[1]
        rest = [layer.w.numel() for layer in head[1:]]
        total += first + sum(rest[:-1])            # recompute
        total += first + sum(rest)                 # dW
        total += sum(rest)                         # dX
    return total


def coarse_macs(weights, e3):
    """Multiply-adds per row of the coarse field forward and of its
    backward (dW of every layer; dX of trunk layers 1.. through their
    activation rows and of the RGB head down to its layer 0's feature
    rows)."""
    H = weights.feat_dim
    fwd = sum(layer.w.numel() for layer in weights.trunk + weights.rgb)
    dx = sum(H * layer.w.shape[1] for layer in weights.trunk[1:])
    dx += sum(layer.w.numel() for layer in weights.rgb[1:])
    dx += H * weights.rgb[0].w.shape[1]
    return fwd, fwd + dx


def coarse_kernel_phase(here, dev):
    """The pretrain's three kernels against their twins at the pretrain
    step's shape, 2048 rays × 64 stratified samples (16 images × 128 rays)
    at the full width of configs/nerf_lm_pretrain.yaml."""
    import torch
    from texpose_tpu_torch.kernels.coarse_field import (
        coarse_field_bwd, coarse_field_bwd_plain, coarse_render_fwd,
        coarse_render_plain)
    from texpose_tpu_torch.kernels.composite import (
        composite_coarse_bwd, composite_coarse_bwd_plain)
    from texpose_tpu_torch.models.render import gather_rays
    from texpose_tpu_torch.nn.fields import coarse_field_inputs, init_nerf
    from texpose_tpu_torch.ops.render import _dists, sample_depth
    from texpose_tpu_torch.utils.config import load_yaml, process_options

    cfg = process_options(load_yaml(os.path.join(
        here, "configs", "nerf_lm_pretrain.yaml")))
    g = torch.Generator().manual_seed(2)
    w = init_nerf(cfg, torch.Generator().manual_seed(0)).to(dev) \
        .kernel_weights()
    BR, N = int(cfg.nerf.rand_rays), int(cfg.nerf.sample_intvs)
    M = BR * N
    # a camera 4 units from the object (the fixture's 400 mm at depth scale
    # 10), random pixels of the 128x128 crop, bounds around a 0.6-unit
    # sphere
    pose = torch.tensor([[[1., 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 4]]])
    intr = torch.tensor([[[160., 0, 64], [0, 160., 64], [0, 0, 1]]])
    idx = torch.randint(0, cfg.H * cfg.W, (1, BR), generator=g)
    center, ray, near, far = (t.to(dev) for t in gather_rays(
        pose, intr, idx, torch.full((1, BR), 3.4), torch.full((1, BR), 4.6),
        cfg.H, cfg.W, z_pregathered=True))
    depth = sample_depth(near, far, N, rand=torch.rand(
        1, BR, N, 1, generator=g).to(dev))
    pts = center[..., None, :] + ray[..., None, :] * depth
    xext, ep = coarse_field_inputs(cfg, pts, None, None)
    d = depth.reshape(BR, N)
    dist = _dists(depth, ray).reshape(BR, N)
    fwd_macs, bwd_macs = coarse_macs(w, ep.shape[1])
    out = {}
    args = (xext, ep, dist, d, w)
    with torch.no_grad():
        got = coarse_render_fwd(*args)
        ref = coarse_render_plain(*args)
        kgot, rgb, dens, (xe, acts) = coarse_render_fwd(*args, want_res=True)
        _, rgb_ref, dens_ref, acts_ref = coarse_render_plain(
            *args, want_res=True)
        torch.cuda.synchronize()
        if not torch.equal(got, kgot):
            fail("coarse_render_fwd: the training launch composites "
                 "differently from the evaluation launch")
        pabs = float((got - ref).abs().max())
        perr = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
        raw = [(a - b).abs() for a, b in ((rgb, rgb_ref), (dens, dens_ref))]
        raw_max = max(float(e.max()) for e in raw)
        raw_mean = max(float(e.mean()) for e in raw)
        act_abs = act_rel = act_mean = 0.0
        for a, b in zip(acts, acts_ref):
            e = (a.float() - b).abs()
            act_abs = max(act_abs, float(e.max()))
            act_rel = max(act_rel, float((e / b.abs().clamp(min=1.0)).max()))
            act_mean = max(act_mean, float(e.mean()))
        ms = time_ms(lambda: coarse_render_fwd(*args))
        plain_ms = time_ms(lambda: coarse_render_plain(*args))
        ms_res = time_ms(lambda: coarse_render_fwd(*args, want_res=True))
        plain_res = time_ms(lambda: coarse_render_plain(*args,
                                                        want_res=True))
        b_eval = bound(nbytes(xext, ep, dist, d, got, *w.params()),
                       2 * fwd_macs * M, PEAK_BF16)
        b_res = bound(nbytes(xext, ep, dist, d, got, rgb, dens, acts,
                             *w.params()), 2 * fwd_macs * M, PEAK_BF16)
        print(f"kernel coarse_render_fwd: {BR} rays x {N} samples packed "
              f"max|err|={pabs:.3g}, max|err|/max(|ref|,1)={perr:.3g} "
              f"(bound {RENDER_MAX_ERR}); "
              f"raw max|err|={raw_max:.3g} (bound {FIELD_MAX_ERR}) "
              f"mean={raw_mean:.3g} (bound {FIELD_MEAN_ERR}); residual "
              f"activations max|err|={act_abs:.3g}, max|err|/max(|ref|,1)="
              f"{act_rel:.3g} (bound {FEAT_REL}) mean={act_mean:.3g}; eval "
              f"{ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms (bound {b_eval[0]:.4f} ms, "
              f"{b_eval[1]}); with residuals {ms_res:.4f} ms vs plain "
              f"{plain_res:.4f} ms (bound {b_res[0]:.4f} ms, {b_res[1]}); "
              f"{2 * fwd_macs * M / (ms * 1e-3) / 1e12:.1f} TFLOP/s",
              flush=True)
        if not (perr <= RENDER_MAX_ERR and raw_max <= FIELD_MAX_ERR
                and raw_mean <= FIELD_MEAN_ERR and act_rel <= FEAT_REL
                and act_mean <= FIELD_MEAN_ERR):
            fail("coarse_render_fwd kernel disagrees with its plain twin")
        # absolute errors of every output of the training launch; the
        # relative errors that the check holds under their own keys
        out["coarse_render_fwd"] = entry(
            max(pabs, raw_max, act_abs), ms_res, plain_res, b_res,
            packed_rel_err=perr, act_rel_err=act_rel)

        cot = (torch.randn(BR, 8, generator=g) / BR).to(dev)
        cargs = (rgb, dens, dist, d, cot)
        cgot = composite_coarse_bwd(*cargs)
        cref = composite_coarse_bwd_plain(*cargs)
        torch.cuda.synchronize()
        crel = max(rel_max(a, b) for a, b in zip(cgot, cref))
        cmax = max(float((a - b).abs().max()) for a, b in zip(cgot, cref))
        cms = time_ms(lambda: composite_coarse_bwd(*cargs), reps=20)
        cplain = time_ms(lambda: composite_coarse_bwd_plain(*cargs), reps=20)
        cb = bound(nbytes(*cargs, *cgot), COMPOSITE_COARSE_BWD_OPS * M,
                   PEAK_F32)
        print(f"kernel composite_coarse_bwd: {BR} rays x {N} samples "
              f"max|err|={cmax:.3g} ({crel:.3g} of max, bound "
              f"{COMPOSITE_BWD_REL}); {cms:.4f} ms vs plain {cplain:.4f} ms "
              f"(bound {cb[0]:.4f} ms, {cb[1]})", flush=True)
        if not crel <= COMPOSITE_BWD_REL:
            fail("composite_coarse_bwd kernel disagrees with its plain twin")
        out["composite_coarse_bwd"] = entry(cmax, cms, cplain, cb)

        # the field backward from the kernel's residuals and the composite
        # backward's gradients, as the train step chains them
        fargs = (xext, ep, xe, acts, w, *cgot)
        fgot = coarse_field_bwd(*fargs)
        fref = coarse_field_bwd_plain(xext, ep, acts, w, *cgot)
        torch.cuda.synchronize()
        norm = max(rel_norm(a, b) for a, b in zip(fgot, fref))
        peak = max(rel_max(a, b) for a, b in zip(fgot, fref))
        fmax = max(float((a - b).abs().max()) for a, b in zip(fgot, fref))
        fms = time_ms(lambda: coarse_field_bwd(*fargs))
        fplain = time_ms(lambda: coarse_field_bwd_plain(
            xext, ep, acts, w, *cgot))
        fb = bound(nbytes(xe, acts, *cgot, *w.params(), *fgot),
                   2 * bwd_macs * M, PEAK_BF16)
        print(f"kernel coarse_field_bwd: M={M} worst tensor ‖err‖/‖ref‖="
              f"{norm:.3g} (bound {FIELD_BWD_NORM}), max|err|/max|ref|="
              f"{peak:.3g} (bound {FIELD_BWD_MAX}); {fms:.4f} ms vs plain "
              f"{fplain:.4f} ms (bound {fb[0]:.4f} ms, {fb[1]}); "
              f"{2 * bwd_macs * M / (fms * 1e-3) / 1e12:.1f} TFLOP/s",
              flush=True)
        if not (norm <= FIELD_BWD_NORM and peak <= FIELD_BWD_MAX):
            fail("coarse_field_bwd kernel disagrees with its plain twin")
        out["coarse_field_bwd"] = entry(fmax, fms, fplain, fb)
    return out


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


TEXTURE_KERNELS = ("st_field_fwd", "st_field_bwd", "composite_st_fwd",
                   "composite_st_bwd")
PRETRAIN_KERNELS = ("coarse_render_fwd", "composite_coarse_bwd",
                    "coarse_field_bwd")


def _launch_wrappers():
    from texpose_tpu_torch.kernels.coarse_field import (coarse_field_bwd,
                                                        coarse_render_fwd)
    from texpose_tpu_torch.kernels.composite import (composite_coarse_bwd,
                                                     composite_st_bwd,
                                                     composite_st_fwd)
    from texpose_tpu_torch.kernels.st_field import st_field_bwd, st_field_fwd
    return {f.__name__: f for f in (
        st_field_fwd, st_field_bwd, composite_st_fwd, composite_st_bwd,
        coarse_render_fwd, composite_coarse_bwd, coarse_field_bwd)}


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
    if min(launches[k] for k in TEXTURE_KERNELS) <= 0:
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

    route_check(eng, "fused_st", lambda: gan_grads(eng), "train")

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


def gan_grads(eng):
    out = {f"heads/{k}": p.grad.clone() for k, p in eng._trainable_heads()}
    out.update({f"latents/{k}": t.grad.clone()
                for k, t in eng.latents.items()})
    out.update({f"disc/{g}/{i}": w.grad.clone()
                for g, i, w in eng._disc_leaves()})
    return out


def route_check(eng, switch, grads, what):
    """One step from one state and one set of draws through the kernel
    route and, with cfg.kernels.<switch> off, through the plain route:
    losses and gradients (``grads()`` after a step) agree."""
    cfg = eng.cfg
    state = eng.train_state_flat(0)
    draws = eng.make_draws(eng.it)
    k_loss = eng.train_step(draws)
    k_grad = grads()
    eng.load_train_state_flat(state)
    setattr(cfg.kernels, switch, False)
    try:
        p_loss = eng.train_step(draws)
    finally:
        setattr(cfg.kernels, switch, True)
    p_grad = grads()
    eng.load_train_state_flat(state)
    loss_err = max(abs(float(k_loss[k]) - float(p_loss[k]))
                   / max(abs(float(p_loss[k])), 1e-12) for k in p_loss)
    grad_err = {k: rel_norm(k_grad[k], p_grad[k]) for k in p_grad}
    worst = max(grad_err, key=grad_err.get)
    print(f"{what}: kernel vs plain route, one step: worst loss rel "
          f"{loss_err:.3g} (bound {ROUTE_LOSS_RTOL}); worst gradient "
          f"‖err‖/‖ref‖ {grad_err[worst]:.3g} at {worst} (bound "
          f"{ROUTE_GRAD_NORM})", flush=True)
    if not (loss_err <= ROUTE_LOSS_RTOL
            and grad_err[worst] <= ROUTE_GRAD_NORM):
        fail(f"{what}: the kernel route disagrees with the plain route")


def pretrain_argv(here, tmp, dev, steps, env=False):
    """A 128x128 fixture of 16 train images (scene_naive for the pretrain,
    with depth maps; scene_all for the env variant, as the yamls) → the
    train CLI's argv for configs/nerf_lm_pretrain.yaml or nerf_lm_env.yaml
    at their full width.  Returns (argv, fixture root)."""
    from texpose_tpu_torch.data import generate_fixture
    scene = "scene_all" if env else "scene_naive"
    t0 = time.perf_counter()
    root = generate_fixture(os.path.join(tmp, f"{scene}_data"), n_train=16,
                            n_test=2, scene=scene, image_scale=1.0,
                            crop_res=128)
    print(f"fixture: 16 train frames ({scene}) at 128x128 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    yml = "nerf_lm_env.yaml" if env else "nerf_lm_pretrain.yaml"
    return ["--model=" + ("nerf_pretrain_env" if env else "nerf_pretrain"),
            f"--yaml={os.path.join(here, 'configs', yml)}",
            f"--data.root={root}",
            f"--data.splits_root={os.path.join(root, 'splits')}",
            "--data.object=ball",
            f"--output_root={os.path.join(tmp, 'pretrain_out')}",
            "--name=" + ("env" if env else "pre"), "--freq.vis=null",
            f"--max_iter={steps}", "--freq.scalar=10", "--freq.val=1000",
            "--freq.ckpt=1000", f"--device={dev}"], root


def _train_losses(cfg, steps):
    """The logged train losses; fails unless they come at the expected
    steps and are finite."""
    recs = [json.loads(ln) for ln in
            open(os.path.join(cfg.output_path, "metrics.jsonl"))]
    losses = [r for r in recs if r["split"] == "train" and "all" in r]
    if [r["step"] for r in losses] != [1] + list(range(10, steps + 1, 10)):
        fail(f"{cfg.model}: unexpected scalar steps "
             f"{[r['step'] for r in losses]}")
    for r in losses:
        bad = [k for k, v in r.items()
               if k != "split" and not math.isfinite(v)]
        if bad:
            fail(f"{cfg.model}: non-finite {bad} at step {r['step']}")
    return {k: round(v, 5) for k, v in losses[-1].items()
            if k not in ("split", "time", "step")}


def pretrain_phase(here, tmp, dev):
    """The pretrain CLI at full width, then the env variant's, then the
    texture GAN's --resume_pretrain from the pretrain checkpoint; returns
    (launch counts of the pretrain run, warm steps/s)."""
    import numpy as np
    import torch
    from texpose_tpu_torch import evaluate, train
    from texpose_tpu_torch.nn.fields import init_nerf
    from texpose_tpu_torch.utils.checkpoint import load_checkpoint_flat

    argv, _ = pretrain_argv(here, tmp, dev, PRETRAIN_STEPS)
    zero_launches()
    t0 = time.perf_counter()
    eng = train.main(argv)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"pretrain: {PRETRAIN_STEPS} steps (cold, incl. validation at "
          f"step 0) {cold_s:.2f} s; launches {launches}", flush=True)
    if min(launches[k] for k in PRETRAIN_KERNELS) <= 0:
        fail(f"the pretrain path did not launch every kernel: {launches}")
    cfg = eng.cfg
    print(f"pretrain: step {PRETRAIN_STEPS} losses "
          f"{_train_losses(cfg, PRETRAIN_STEPS)}", flush=True)

    ckpt = os.path.join(cfg.output_path, "model.ckpt")
    flat = load_checkpoint_flat(ckpt)
    init = init_nerf(cfg, torch.Generator().manual_seed(
        int(cfg.get("seed", 0)))).state_dict()
    still = [k for k, v in init.items() if np.array_equal(
        flat["params/nerf/" + k.replace(".", "/")], v.numpy())]
    if still:
        fail(f"pretrain: leaves that did not move: {still}")
    paths = [k for k, _ in eng._named_params()]
    need = ([f"params/nerf/{k}" for k in paths]
            + [f"opt_state/0/{m}/nerf/{k}" for m in ("mu", "nu")
               for k in paths]
            + ["opt_state/0/count", "opt_state/1/count", "key", "it",
               "step"])
    missing = [k for k in need if k not in flat]
    if missing or int(flat["step"]) != PRETRAIN_STEPS:
        fail(f"pretrain: model.ckpt lacks JAX keypaths {missing} or step")
    print(f"pretrain: trunk and head moved; model.ckpt holds {len(flat)} "
          f"JAX keypaths, step {int(flat['step'])}", flush=True)

    ev = evaluate.main([a for a in argv if not a.startswith(
        ("--max_iter", "--freq."))] + ["--resume"])
    q = [ln.split() for ln in open(os.path.join(ev.cfg.output_path,
                                                "quant.txt"))][1:]
    pngs = os.listdir(os.path.join(ev.cfg.output_path, "rgb"))
    if (ev.start_step != PRETRAIN_STEPS or len(q) != len(ev.eval_data)
            or len(pngs) != len(q)
            or not all(math.isfinite(float(r[1])) for r in q)):
        fail(f"pretrain: evaluate did not reload model.ckpt "
             f"({ev.start_step}, {q}, {pngs})")
    print(f"pretrain: evaluate reloaded model.ckpt @ step {ev.start_step}, "
          f"PSNR {[float(r[1]) for r in q]}", flush=True)

    route_check(eng, "fused_coarse",
                lambda: {k: p.grad.clone() for k, p in eng._named_params()},
                "pretrain")

    for _ in range(3):
        eng.train_step(eng.make_draws(eng.it))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        eng.train_step(eng.make_draws(eng.it))
    torch.cuda.synchronize()
    steps_s = WARM_STEPS / (time.perf_counter() - t0)
    print(f"pretrain: warm {steps_s:.3f} steps/s = pretrain_rays_per_sec "
          f"{steps_s * eng.rays_per_step():.1f} ({len(eng.train_data)} "
          f"images x {eng.rays_per_image()} rays x {cfg.nerf.sample_intvs} "
          f"samples, {WARM_STEPS} steps)", flush=True)

    # the env variant: view-dependent head, its own schedule and losses
    argv_e, root_e = pretrain_argv(here, tmp, dev, ENV_STEPS, env=True)
    zero_launches()
    eng_e = train.main(argv_e)
    torch.cuda.synchronize()
    launches_e = read_launches()
    if min(launches_e[k] for k in PRETRAIN_KERNELS) <= 0:
        fail(f"the env pretrain path did not launch every kernel: "
             f"{launches_e}")
    print(f"pretrain_env: {ENV_STEPS} steps, launches {launches_e}, losses "
          f"{_train_losses(eng_e.cfg, ENV_STEPS)}", flush=True)
    gan_loads_trunk(here, tmp, dev, ckpt, root_e)
    return launches, steps_s


def gan_loads_trunk(here, tmp, dev, pre_ckpt, root):
    """The texture-GAN engine's --resume_pretrain reads the trunk of the
    port's pretrain checkpoint, placed as the group's pretrain_model.ckpt."""
    import numpy as np
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    from texpose_tpu_torch.utils.checkpoint import load_checkpoint_flat
    from texpose_tpu_torch.utils.config import set_options

    cfg = set_options([
        "--model=nerf_adapt_st_gan",
        f"--yaml={os.path.join(here, 'configs', 'nerf_lm_adapt_gan.yaml')}",
        f"--data.root={root}",
        f"--data.splits_root={os.path.join(root, 'splits')}",
        "--data.object=ball", "--nerf.depth.box_source=pred_box_init_calib",
        f"--output_root={os.path.join(tmp, 'gan_from_pretrain')}",
        f"--device={dev}"])
    group_dir = os.path.join(str(cfg.output_root), str(cfg.group))
    os.makedirs(group_dir, exist_ok=True)
    shutil.copyfile(pre_ckpt, os.path.join(group_dir, "pretrain_model.ckpt"))
    eng = TextureGANEngine(cfg, dev)
    eng.load_dataset()
    eng.build_networks()
    eng.restore_pretrained_checkpoint()
    flat = load_checkpoint_flat(pre_ckpt)
    for k, v in eng.nerf.mlp_feat.state_dict().items():
        if not np.array_equal(v.cpu().numpy(), flat[
                "params/nerf/mlp_feat/" + k.replace(".", "/")]):
            fail(f"gan: --resume_pretrain did not load trunk leaf {k}")
    print(f"gan: --resume_pretrain loaded the pretrain checkpoint's trunk "
          f"({len(eng.nerf.mlp_feat.state_dict())} leaves)", flush=True)


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "texpose_tpu_torch")):
        fail("texpose_tpu_torch/ not found: run from a checkout of the "
             "repository")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    # the port runs with jax and the JAX package unimportable
    sys.modules["jax"] = None
    sys.modules["texpose_tpu"] = None
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
    sources = ("st_field", "composite", "coarse_field")
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        list(pool.map(_build.build, sources))
    print(f"build: {len(sources)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    measured = kernel_phase(load_cfg(here), dev)
    measured.update(coarse_kernel_phase(here, dev))
    tmp = tempfile.mkdtemp(prefix="texpose_chip_smoke_")
    try:
        slice_phase(here, tmp, dev)
        launches, _ = train_phase(here, tmp, dev)
        pre_launches, _ = pretrain_phase(here, tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches.update({k: pre_launches[k] for k in PRETRAIN_KERNELS})

    src = {"st_field_fwd": ("texpose_tpu_torch/csrc/st_field.cu",
                            "texpose_tpu/kernels/fused_st_field.py:922"),
           "st_field_bwd": ("texpose_tpu_torch/csrc/st_field.cu",
                            "texpose_tpu/kernels/fused_st_field.py:1000"),
           "composite_st_fwd": ("texpose_tpu_torch/csrc/composite.cu",
                                "texpose_tpu/kernels/fused_composite.py:240"),
           "composite_st_bwd": ("texpose_tpu_torch/csrc/composite.cu",
                                "texpose_tpu/kernels/fused_composite.py:258"),
           "coarse_render_fwd": (
               "texpose_tpu_torch/csrc/coarse_field.cu",
               "texpose_tpu/kernels/fused_coarse_render.py:161"),
           "composite_coarse_bwd": (
               "texpose_tpu_torch/csrc/composite.cu",
               "texpose_tpu/kernels/fused_composite_coarse.py:132"),
           "coarse_field_bwd": (
               "texpose_tpu_torch/csrc/coarse_field.cu",
               "texpose_tpu/kernels/fused_coarse_field.py:449")}
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "launches": launches[name],
                **numbers} for name, numbers in measured.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
