#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (texpose_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases; any failure exits non-zero and no result line is printed:
  1. build: the six kernel sources compiled from csrc/ by nvcc (sm_90a),
     in parallel with the measurement builds that nothing but the
     comparisons below runs: the one-kernel field backwards
     (coarse_field.cu, st_field.cu and st_render.cu with
     -DFIELD_BWD_ONE_KERNEL, tools/probe_field_bwd_atomics.py), the
     mma.sync field and trunk forwards (st_field.cu, coarse_field.cu,
     st_render.cu and trunk_fwd.cu with -DFIELD_FWD_MMA_SYNC,
     tools/probe_field_fwd.py) and those forwards' measurement switches
     (csrc/trunk.cuh TRUNK_FWD_*), which the "step 1" lines time against
     the mma.sync build in turns (where the replaced forwards' time went:
     weight loads, residual stores, epilogue);
  2. kernels: each of the fourteen kernels against its plain-PyTorch twin on
     the card at the main paths' shapes — ST field forward on one
     2048-ray × 64-sample chunk (131,072 rows, full width, bf16), its
     backward on the train step's 8 images × 16,384 rows, the dual
     composite forward and backward on 2048 rays × 64 samples, the trunk
     forward on the same chunk; the coarse field + composite forward (with
     and without the training residuals), the composite-coarse backward and
     the trunk-training field backward on the pretrain step's 2048 rays ×
     64 samples; the coarse field forward with raw outputs at 131,072 and
     at the fine field's 393,216 rows (2048 rays × (64 + 128) samples),
     with and without residuals; the composite-coarse forward at 64 and 192
     samples per ray, its backward at 192 and the field backward at
     393,216 rows — checked against the bounds
     below, timed with CUDA events (median of repeats) and set beside the
     least time the card could take (``bound``).  The three field
     backwards (rows 7b, 2 and the render backward 6b) run split: a
     dX-chain kernel, then the grouped dW GEMM and its reduction
     (csrc/dw_gemm.cu).  At each of their four shapes the GEMM and the
     reduction are held against the direct f32 products of the planes the
     dX chain wrote, each phase is timed alone beside the GEMM's yardstick
     (one torch.matmul per segment), and the one-kernel form they replaced
     (f32 dW atomics, from the measurement build) is held against the twin
     and timed against the split form in turns (old, new, new, old); 6b
     also beside the hybrid backward, timed before and after.  The five
     wgmma + TMA forwards (rows 1, 6f, 7a, 8 and the trunk forward, 10)
     are timed the same way against the mma.sync forms they replaced (held
     against the twins too), each beside the L2 weight bytes of both
     designs; the render backward's (6b) mma.sync recompute of the heads'
     raw outputs is held against the wgmma forward's;
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
     --resume_pretrain.  All four texture kernels' launch counters (and
     the dW GEMM's and its reduction's) are
     zeroed just before and must be > 0 after it; every logged loss must be
     finite, the trunk unchanged and the heads moved, model.ckpt must hold
     the JAX package's train-state keypaths, and the port's evaluate must
     reload it.  Then, from one state and one set of draws, the kernel
     route's losses and gradients must agree with the plain route's; one
     step with kernels.fused_composite=false must launch the field kernels
     (and the dW GEMM) once each and no composite kernel, and agree with
     the two-kernel route; warm steps/s and rays/s (2048 rays per step)
     are timed;
  5. trunk: the evaluate CLI on 2 generated 480×640 frames with the model
     trained in phase 4 and --nerf.density_noise_reg=1, where the ST
     kernels' gate is off and the trunk kernel runs under plain heads: its
     counter > 0 (the ST field kernel's 0), finite metrics, and frame 0
     within the render bound of the ST kernel route;
  6. pretrain: ``texpose_tpu_torch.train --model=nerf_pretrain`` for
     PRETRAIN_STEPS steps at the full width of configs/nerf_lm_pretrain.yaml
     (8×256 trunk, skip at 4, RGB head 256-256-256-3, bf16, 64 samples,
     2048 rays) on a 128×128 fixture of 16 train images.  The three coarse
     kernels' counters and the dW GEMM's and its reduction's are zeroed
     just before and must be > 0 after it;
     the losses must be finite, the trunk and the head both moved,
     model.ckpt must hold the JAX package's keypaths and the port's
     evaluate --resume must reload it; the kernel route must agree with the
     plain route from one state and one set of draws; warm steps/s × 2048
     is printed as pretrain_rays_per_sec.  Then ENV_STEPS steps of
     --model=nerf_pretrain_env (counters > 0 again), and the texture-GAN
     engine's --resume_pretrain loads the pretrain checkpoint's trunk;
  7. hierarchical: the same CLI with --nerf.fine_sampling=true
     --nerf.sample_intvs_fine=128 --loss_weight.render_fine=0 for
     HIER_STEPS steps (both fields through the field forward and backward
     kernels, the dW GEMM and its reduction: each counter exactly 2 per
     step), finite losses with
     render_fine, both fields' leaves moved, the route check against the
     plain route, warm steps/s, rays/s and the step's peak device memory;
  8. two-kernel: the pretrain CLI with --kernels.coarse_mega=false for
     TWO_KERNEL_STEPS steps (field forward → composite forward, composite
     backward → field backward, every counter > 0) and its route check
     against the mega route;
  9. st_mega: the texture model's render kernels (rows 6f/6b).  In phase 2
     each is held against its twin at full width — the forward's
     evaluation launch on one 2048-ray × 64-sample chunk, its training
     launch and the fused backward on the train step's 8 images × 16,384
     rows (the backward also against the hybrid backward).  Then the train
     CLI with --kernels.st_mega=true and TEXPOSE_MEGA_FULLBWD=1 for
     MEGA_STEPS steps (the fused backward's dX chain, the dW GEMM and its
     reduction exactly once per step, nothing else of the two-kernel
     route), HYBRID_STEPS steps of the default hybrid
     backward (each of its three kernels once per step), route checks of
     the fused vs the hybrid backward and of the mega vs the two-kernel
     route, warm steps/s of all three; and the eval CLI with the mega route
     on 2 frames of that model, frame 0 against the two-kernel route.
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
# grouped dW GEMM (phase b of the split field backwards) vs the direct f32
# products of the same bf16 planes: the products are exact in f32 on both
# sides, only the order of the f32 sums differs (k-steps, split partials):
# 1e-4 of each block's norm and largest magnitude; its reduction vs the
# twin's sum of the same partials, 1e-4 absolute (f32 adds, gradients ≲ 1).
DW_REL = 1e-4
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
# its sums).  The field forward with raw outputs as the mega forward's raw
# outputs and residuals; the trunk forward's features as the ST feature
# residual (FEAT_REL), its raw density as a raw output; the coarse
# composite forward as the dual one (COMPOSITE_MAX_ERR, f32 both sides).
N_TEST = 6
TRAIN_STEPS = 30
WARM_STEPS = 20
PRETRAIN_STEPS = 30
ENV_STEPS = 10
HIER_STEPS = 20
TWO_KERNEL_STEPS = 10
MEGA_STEPS = 10
HYBRID_STEPS = 3
N_FINE = 128               # NeRF's N_f (Mildenhall et al. 2020)
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
    """Bytes of the tensors.  A field function's bound counts its points,
    not the posenc rows xext that the port stages from them (the TPU kernels
    read the points and encode in the kernel): enc⊕pts rows end with the
    points, and the trunk alone takes xext[:, :3]."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, ops, peak, f32_ops=0):
    """The least time the card could take, (ms, what bounds it): the larger
    of moving n_bytes at the memory rate and doing ops at ``peak`` (plus
    f32_ops at the f32 rate: a fused kernel's composite)."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = (ops / peak + f32_ops / PEAK_F32) * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else \
        (by_bytes, "bytes")


def entry(err, ms, plain_ms, bnd, **extra):
    """One kernel's measured numbers (no single PyTorch call computes any
    of these functions, so there is no library time); ``extra`` adds
    further measured keys, such as relative errors."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            **extra}


def split_bwd(module, split, one_kernel, twin_grads, a_reads, writes_h,
              what):
    """The split field backward (rows 7b and 2: the dX-chain kernel, the
    grouped dW GEMM, the reduction) against the one-kernel form it replaced
    and phase by phase, on the inputs that ``split()`` (the wrapper, which
    sends its planes through ``module.dw_grads``) runs on.
    ``one_kernel()`` runs the one-kernel form (the measurement build's
    entry, not the package's); ``twin_grads`` are the plain twin's
    gradients; ``a_reads`` are the tensors phase (a) reads, and with
    ``writes_h`` it also writes the A planes phase (b) reads (row 2's
    recomputed hidden activations).  Returns (the split form's extra
    numbers, dw_gemm's entry, dw_reduce's entry)."""
    import torch
    from texpose_tpu_torch.kernels import dw_gemm as dw

    real = module.dw_grads
    seen = {}

    def capture(*args):
        seen["args"] = args
        return real(*args)

    module.dw_grads = capture
    try:
        split()
        torch.cuda.synchronize()
        srcs, g_wide, g_narrow, segs, grads = seen["args"]
        module.dw_grads = lambda *args: args[-1]
        dx_ms = time_ms(split)                   # phase (a) and the staging
    finally:
        module.dw_grads = real

    # the old one-kernel form against the twin, and in turns with the split
    # form (old, new, new, old)
    old = one_kernel()
    torch.cuda.synchronize()
    old_norm = max(rel_norm(a, b) for a, b in zip(old, twin_grads))
    ab = [time_ms(f) for f in (one_kernel, split, split, one_kernel)]

    # phase (b): the GEMM kernel and the reduction on phase (a)'s planes,
    # against the segments' direct f32 products of the same planes
    total = grads.numel()
    partial, prob = dw.dw_gemm(srcs, g_wide, g_narrow, segs)
    got = dw.dw_reduce(partial, prob, torch.zeros(total, device=grads.device))
    want = dw.dw_plain(srcs, g_wide, g_narrow, segs,
                       torch.zeros(total, device=grads.device))
    red_want = dw.dw_reduce_plain(partial, prob, torch.zeros_like(got))
    torch.cuda.synchronize()
    blocks = [(got[s.out:s.out + s.k_in * s.n], want[s.out:s.out + s.k_in * s.n])
              for s in segs]
    dw_norm = max(rel_norm(a, b) for a, b in blocks)
    dw_peak = max(rel_max(a, b) for a, b in blocks)
    dw_abs = max(float((a - b).abs().max()) for a, b in blocks)
    red_abs = float((got - red_want).abs().max())
    gemm_ms = time_ms(lambda: dw.dw_gemm(srcs, g_wide, g_narrow, segs))
    per, splits = dw.split_rows(g_wide.shape[1], prob.shape[0],
                                torch.cuda.get_device_properties(
                                    grads.device).multi_processor_count)
    gemm_plain = time_ms(lambda: dw.dw_gemm_plain(
        srcs, g_wide, g_narrow, prob.tolist(), per, splits), reps=3)
    red_ms = time_ms(lambda: dw.dw_reduce(partial, prob, got), reps=20)
    red_plain = time_ms(lambda: dw.dw_reduce_plain(partial, prob, got),
                        reps=3)
    # the yardsticks: one torch.matmul per segment on the same planes, and
    # one sum over the splits
    views = [(dw._planes(srcs[s.a])[s.a_plane][:, s.a_col:s.a_col + s.k_in],
              (g_wide[s.b_plane] if s.b == dw.WIDE else g_narrow)[
                  :, s.b_col:s.b_col + s.n]) for s in segs]
    lib_ms = time_ms(lambda: [torch.matmul(h.t(), g) for h, g in views])
    red_lib = time_ms(lambda: partial.sum(1), reps=20)

    M = g_wide.shape[1]
    used = {(s.a, s.a_plane) for s in segs}
    h_bytes = sum(dw._planes(srcs[a])[p].numel() * 2 for a, p in used)
    g_bytes = nbytes(g_wide, g_narrow)
    out_bytes = 4 * sum(s.k_in * s.n for s in segs)
    dw_ops = 2 * M * sum(s.k_in * s.n for s in segs)
    valid = 4 * sum(r[3] * r[7] for r in prob.tolist())   # bytes a split
    gemm_bound = bound(h_bytes + g_bytes + valid * splits, dw_ops, PEAK_BF16)
    red_bound = bound(valid * splits + out_bytes, valid * splits // 4,
                      PEAK_F32)
    # the split design's byte floor: phase (a) reads its inputs and writes
    # the planes, phase (b) reads the planes and the inputs it shares
    a_bytes = nbytes(*a_reads) + g_bytes + (nbytes(srcs[0]) if writes_h
                                            else 0)
    floor_ms = (a_bytes + h_bytes + g_bytes) / PEAK_BYTES * 1e3
    tflops = dw_ops / (gemm_ms * 1e-3) / 1e12
    print(f"kernel {what} split: M={M} dX chain (phase a, staging included) "
          f"{dx_ms:.4f} ms; dw_gemm {gemm_ms:.4f} ms vs plain {gemm_plain:.4f}"
          f" ms, torch.matmul of the same segments {lib_ms:.4f} ms (bound "
          f"{gemm_bound[0]:.4f} ms, {gemm_bound[1]}; {tflops:.1f} TFLOP/s), "
          f"dW vs the direct products worst block "
          f"‖err‖/‖ref‖={dw_norm:.3g} max|err|/max|ref|={dw_peak:.3g} (bound "
          f"{DW_REL}); dw_reduce {red_ms:.4f} ms vs plain {red_plain:.4f} ms, "
          f"sum over splits {red_lib:.4f} ms (bound {red_bound[0]:.4f} ms, "
          f"{red_bound[1]}) max|err|={red_abs:.3g}; byte floor of the split "
          f"design {floor_ms:.4f} ms; one-kernel form vs twin worst "
          f"‖err‖/‖ref‖={old_norm:.3g}; A/B old {ab[0]:.4f} / new {ab[1]:.4f}"
          f" / new {ab[2]:.4f} / old {ab[3]:.4f} ms", flush=True)
    if not (dw_norm <= DW_REL and dw_peak <= DW_REL and red_abs <= DW_REL
            and old_norm <= FIELD_BWD_NORM):
        fail(f"{what}: the dW GEMM or its reduction disagrees with the "
             "direct products, or the one-kernel form with the twin")
    extra = dict(dx_ms=dx_ms, dw_gemm_ms=gemm_ms, dw_reduce_ms=red_ms,
                 one_kernel_ms=[ab[0], ab[3]],
                 split_ms=[ab[1], ab[2]], one_kernel_rel_norm=old_norm)
    gemm = dict(entry(dw_abs, gemm_ms, gemm_plain, gemm_bound,
                      rel_norm=dw_norm), library_ms=lib_ms)
    red = dict(entry(red_abs, red_ms, red_plain, red_bound),
               library_ms=red_lib)
    return extra, gemm, red


# f32 operations per sample of the composites, counted from the kernels'
# arithmetic (a transcendental counted as one): far below their bytes
COMPOSITE_ST_FWD_OPS = 60
COMPOSITE_ST_BWD_OPS = 110
COMPOSITE_COARSE_FWD_OPS = 30
COMPOSITE_COARSE_BWD_OPS = 40


def load_probe(here, name="probe_field_bwd_atomics"):
    """tools/<name>.py as a module: the measurement builds and launchers of
    the one-kernel field backwards (probe_field_bwd_atomics) or of the
    mma.sync field forwards (probe_field_fwd)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fwd_ab(new, old, reps=10):
    """A field forward's mma.sync form (old, the measurement build
    -DFIELD_FWD_MMA_SYNC) and its shipped wgmma + TMA form (new) in turns:
    [old, new, new, old] ms."""
    return [time_ms(f, reps=reps) for f in (old, new, new, old)]


def ab_numbers(ab, old_err):
    """The forward's A/B keys of its ``kernels`` entry (measured numbers
    only: the L2 weight bytes, computed, are in ``ab_text``'s line)."""
    return dict(mma_sync_ms=[ab[0], ab[3]], wgmma_ms=[ab[1], ab[2]],
                mma_sync_max_abs_err=old_err)


def ab_text(ab, l2):
    return (f"A/B mma.sync / wgmma / wgmma / mma.sync {ab[0]:.4f} / "
            f"{ab[1]:.4f} / {ab[2]:.4f} / {ab[3]:.4f} ms; L2 weight bytes "
            f"{l2[0] / 1e9:.3f} GB (mma.sync form {l2[1] / 1e9:.3f} GB)")


def load_cfg(here):
    from texpose_tpu_torch.utils.config import load_yaml, process_options
    cfg = load_yaml(os.path.join(here, "configs", "nerf_lm_adapt_gan.yaml"))
    cfg.data.image_size = [480, 640]
    return process_options(cfg)


def eval_chunk(cfg, dev, seed):
    """One eval chunk of the texture field at full width: (generator, the
    seeded field's kernel weights, R, N, depth [1,R,N,1], ray [1,R,3],
    xext, enc⊕pts, light [1,48], trans [1,16]).  R = 2048 object rays: a
    camera 4 units from the origin (the fixture's 400 mm at depth scale
    10), pixels of the frame's central 160x160 window, bounds around a
    0.6-unit sphere; N = 64 mid-bin samples."""
    import torch
    from texpose_tpu_torch.models.render import gather_rays
    from texpose_tpu_torch.nn.fields import init_nerf_st, st_field_inputs
    from texpose_tpu_torch.ops.render import sample_depth

    g = torch.Generator().manual_seed(seed)
    nerf = init_nerf_st(cfg, torch.Generator().manual_seed(0)).to(dev)
    R, N = int(cfg.nerf.rand_rays), int(cfg.nerf.sample_intvs)
    H, W = cfg.H, cfg.W
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
    return (g, nerf.kernel_weights(), R, N, depth, ray, xext, encpts, light,
            trans)


def kernel_phase(cfg, dev, one_kernel, mma):
    """Each kernel against its twin on one eval chunk; returns the
    measured numbers per kernel.  ``one_kernel["st_field"]`` runs the ST
    heads' one-kernel backward, ``mma["st_field"]`` the ST field's mma.sync
    forward (the measurement builds)."""
    import torch
    from texpose_tpu_torch.kernels.composite import (composite_st_bwd,
                                                     composite_st_bwd_plain,
                                                     composite_st_fwd,
                                                     composite_st_plain)
    from texpose_tpu_torch.kernels import st_field as sf_module
    from texpose_tpu_torch.kernels.st_field import (st_field_bwd,
                                                    st_field_bwd_plain,
                                                    st_field_fwd,
                                                    st_field_plain)
    from texpose_tpu_torch.kernels.trunk import trunk_forward_plain, trunk_fwd
    from texpose_tpu_torch.ops.render import _dists

    g, weights, R, N, depth, ray, xext, encpts, light, trans = eval_chunk(
        cfg, dev, 1)
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
        old = mma["st_field"](*args[:6])
        torch.cuda.synchronize()
        old_err = max(float((a - b).abs().max()) for a, b in zip(old, ref))
        ab = fwd_ab(lambda: st_field_fwd(*args),
                    lambda: mma["st_field"](*args[:6]))
        l2 = mma["l2_bytes"](weights, xext.shape[1], encpts.shape[1], R * N)
        print(f"kernel st_field_fwd (row 1): mma.sync form max|err|="
              f"{old_err:.3g} (bound {FIELD_MAX_ERR}); {ab_text(ab, l2)}",
              flush=True)
        if not old_err <= FIELD_MAX_ERR:
            fail("st_field mma.sync form disagrees with its plain twin")
        out["st_field_fwd"] = entry(max_err, ms, plain_ms, bound(
            nbytes(encpts, light, trans, *got,
                   *[t for layer in weights.trunk for t in (layer.w, layer.b)],
                   *weights.head_params()),
            2 * weights_macs(weights, encpts.shape[1]) * R * N, PEAK_BF16),
            **ab_numbers(ab, old_err))

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
        extra, gemm, red = split_bwd(
            sf_module, lambda: st_field_bwd(*gargs),
            lambda: (lambda r: list(r[0]) + list(r[1:]))(
                one_kernel["st_field"](*gargs)),
            flat_want, (feat, g_rgb, g_tr, torch.empty(     # + staged ep
                (M, -(-et.shape[1] // 16) * 16), dtype=torch.bfloat16,
                device="meta")), True, "st_field_bwd")
        out["st_field_bwd"] = entry(fmax, fms, fplain, bound(
            nbytes(feat, et, lt, tt, g_rgb, g_tr, *weights.head_params(),
                   *flat_got),
            2 * st_bwd_macs(weights, et.shape[1]) * M, PEAK_BF16), **extra)
        out["_dw"] = {f"row 2, {M} rows": (gemm, red)}

        # the trunk forward on the eval chunk: the trunk of an evaluation
        # whose heads run plain (nerf.density_noise_reg)
        tgot = trunk_fwd(xext, weights)
        tref = trunk_forward_plain(xext, weights.trunk, weights.skip)
        torch.cuda.synchronize()
        terr = (tgot[0].float() - tref[0]).abs()
        trel = float((terr / tref[0].abs().clamp(min=1.0)).max())
        derr = (tgot[1] - tref[1][:, 0]).abs()
        tmax = max(float(terr.max()), float(derr.max()))
        tms = time_ms(lambda: trunk_fwd(xext, weights))
        tplain = time_ms(lambda: trunk_forward_plain(xext, weights.trunk,
                                                     weights.skip))
        trunk_params = [t for layer in weights.trunk
                        for t in (layer.w, layer.b)]
        t_ops = 2 * sum(layer.w.numel() for layer in weights.trunk) * R * N
        tb = bound(nbytes(xext[:, :3], *tgot, *trunk_params), t_ops,
                   PEAK_BF16)
        print(f"kernel trunk_fwd: M={R * N} feat max|err|/max(|ref|,1)="
              f"{trel:.3g} (bound {FEAT_REL}) mean={float(terr.mean()):.3g}"
              f"; dens max|err|={float(derr.max()):.3g} (bound "
              f"{FIELD_MAX_ERR}) mean={float(derr.mean()):.3g} (bound "
              f"{FIELD_MEAN_ERR}); {tms:.4f} ms vs plain {tplain:.4f} ms "
              f"(bound {tb[0]:.4f} ms, {tb[1]}); "
              f"{t_ops / (tms * 1e-3) / 1e12:.1f} TFLOP/s", flush=True)
        if not (trel <= FEAT_REL and float(terr.mean()) <= FIELD_MEAN_ERR
                and float(derr.max()) <= FIELD_MAX_ERR
                and float(derr.mean()) <= FIELD_MEAN_ERR):
            fail("trunk_fwd kernel disagrees with its plain twin")
        # the mma.sync form it replaced, against the twin and in turns
        old = mma["trunk"](xext, weights)
        torch.cuda.synchronize()
        old_rel = float(((old[0].float() - tref[0]).abs()
                         / tref[0].abs().clamp(min=1.0)).max())
        old_err = max(float((old[0].float() - tref[0]).abs().max()),
                      float((old[1] - tref[1][:, 0]).abs().max()))
        ab = fwd_ab(lambda: trunk_fwd(xext, weights),
                    lambda: mma["trunk"](xext, weights))
        l2 = mma["trunk_l2"](weights, xext.shape[1], R * N)
        print(f"kernel trunk_fwd (row 10): mma.sync form feat max|err|/"
              f"max(|ref|,1)={old_rel:.3g} (bound {FEAT_REL}); "
              f"{ab_text(ab, l2)}", flush=True)
        if not old_rel <= FEAT_REL:
            fail("trunk_fwd mma.sync form disagrees with its plain twin")
        out["trunk_fwd"] = entry(tmax, tms, tplain, tb, feat_rel_err=trel,
                                 **ab_numbers(ab, old_err))
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


def mega_bwd_macs(weights, e3):
    """Multiply-adds per row of the render backward (row 6b): the heads'
    backward (``st_bwd_macs``) plus both output layers' forward, which the
    composite's VJP needs (the kernel's second recompute of the transient
    head's hidden layers is its own cost, not the function's)."""
    return (st_bwd_macs(weights, e3) + weights.rgb[-1].w.numel()
            + weights.trans[-1].w.numel())


def st_mega_kernel_phase(cfg, dev, one_kernel, mma):
    """The render kernels against their twins at full width (rows 6f/6b):
    the forward's evaluation launch on one eval chunk (one image, 2048
    rays × 64 samples = 131,072 rows), its training launch and the fused
    backward on the train step's 8 images × 16,384 rows (the chunk's rays
    repeated); returns the measured numbers per kernel.
    ``mma["st_render"]`` runs the forward's mma.sync form and
    ``mma["recompute"]`` the fused backward's mma.sync recompute of the
    heads' raw outputs, ``one_kernel["st_render"]`` the fused backward's
    one-kernel form (the measurement builds)."""
    import torch
    from texpose_tpu_torch.kernels import st_field as sf_module
    from texpose_tpu_torch.kernels.composite import (composite_st_bwd,
                                                     composite_st_plain)
    from texpose_tpu_torch.kernels.st_field import st_field_bwd
    from texpose_tpu_torch.kernels.st_render import (st_render_bwd,
                                                     st_render_bwd_plain,
                                                     st_render_fwd,
                                                     st_render_plain)
    from texpose_tpu_torch.ops.render import _dists

    g, weights, R, N, depth, ray, xext, encpts, light, trans = eval_chunk(
        cfg, dev, 3)
    mu = float(cfg.nerf.min_uncert)
    M = R * N
    e3 = encpts.shape[1]
    params = [t for layer in weights.trunk for t in (layer.w, layer.b)] \
        + weights.head_params()
    fwd_ops = 2 * weights_macs(weights, e3)
    out = {}
    with torch.inference_mode():
        d = depth.reshape(R, N)
        dist = _dists(depth, ray).reshape(R, N)
        eargs = (xext, encpts, light, trans, dist, d, weights, M,
                 torch.bfloat16, mu)
        got = st_render_fwd(*eargs)
        ref = st_render_plain(*eargs)
        torch.cuda.synchronize()
        e_rel = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
        e_abs = float((got - ref).abs().max())
        ms_eval = time_ms(lambda: st_render_fwd(*eargs), reps=20)
        plain_eval = time_ms(lambda: st_render_plain(*eargs))
        b_eval = bound(nbytes(encpts, light, trans, dist, d, got, *params),
                       fwd_ops * M, PEAK_BF16, COMPOSITE_ST_FWD_OPS * M)

        # the training launch on the train step's layout
        B = int(cfg.batch_size)
        rpi = int(cfg.patch_size) ** 2 * N
        MT = B * rpi
        reps = -(-MT // M)
        xt, et = xext.repeat(reps, 1)[:MT], encpts.repeat(reps, 1)[:MT]
        dt = dist.repeat(reps, 1)[:MT // N]
        ddt = d.repeat(reps, 1)[:MT // N]
        lt = torch.randn(B, light.shape[1], generator=g).to(dev)
        tt = torch.randn(B, trans.shape[1], generator=g).to(dev)
        targs = (xt, et, lt, tt, dt, ddt, weights, rpi, torch.bfloat16, mu)
        kgot, rgb, dens, tr, feat = st_render_fwd(*targs, want_res=True)
        kref, rgb_ref, dens_ref, tr_ref, feat_ref = st_render_plain(
            *targs, want_res=True)
        epi = composite_st_plain(rgb, tr, dens, ddt, dt, mu)
        same = torch.equal(st_render_fwd(*targs), kgot)
        torch.cuda.synchronize()
        if not same:
            fail("st_render_fwd: the training launch composites differently "
                 "from the evaluation launch")
        p_rel = float(((kgot - kref).abs() / kref.abs().clamp(min=1.0)).max())
        p_abs = float((kgot - kref).abs().max())
        epi_err = float((kgot - epi).abs().max())
        raw = [(a - b).abs() for a, b in ((rgb, rgb_ref), (dens, dens_ref),
                                          (tr, tr_ref))]
        raw_max = max(float(e.max()) for e in raw)
        raw_mean = max(float(e.mean()) for e in raw)
        ferr = (feat.float() - feat_ref).abs()
        f_rel = float((ferr / feat_ref.abs().clamp(min=1.0)).max())
        f_mean = float(ferr.mean())
        del rgb_ref, dens_ref, tr_ref, feat_ref, ferr
        ms_res = time_ms(lambda: st_render_fwd(*targs, want_res=True),
                         reps=20)
        plain_res = time_ms(lambda: st_render_plain(*targs, want_res=True))
        b_res = bound(nbytes(et, lt, tt, dt, ddt, kgot, rgb, dens, tr, feat,
                             *params), fwd_ops * MT, PEAK_BF16,
                      COMPOSITE_ST_FWD_OPS * MT)
        print(f"kernel st_render_fwd: eval M={M} packed max|err|/max(|ref|,1)"
              f"={e_rel:.3g} (bound {RENDER_MAX_ERR}); training M={MT} "
              f"({B} images) packed {p_rel:.3g} (bound {RENDER_MAX_ERR}), "
              f"epilogue vs composite twin of its raw outputs max|err|="
              f"{epi_err:.3g} (bound {COMPOSITE_MAX_ERR}), raw max|err|="
              f"{raw_max:.3g} (bound {FIELD_MAX_ERR}) mean={raw_mean:.3g} "
              f"(bound {FIELD_MEAN_ERR}), feat max|err|/max(|ref|,1)="
              f"{f_rel:.3g} (bound {FEAT_REL}) mean={f_mean:.3g}; eval "
              f"{ms_eval:.4f} ms vs plain {plain_eval:.4f} ms (bound "
              f"{b_eval[0]:.4f} ms, {b_eval[1]}); training {ms_res:.4f} ms "
              f"vs plain {plain_res:.4f} ms (bound {b_res[0]:.4f} ms, "
              f"{b_res[1]}); {fwd_ops * M / (ms_eval * 1e-3) / 1e12:.1f} "
              "TFLOP/s eval", flush=True)
        if not (e_rel <= RENDER_MAX_ERR and p_rel <= RENDER_MAX_ERR
                and epi_err <= COMPOSITE_MAX_ERR and raw_max <= FIELD_MAX_ERR
                and raw_mean <= FIELD_MEAN_ERR and f_rel <= FEAT_REL
                and f_mean <= FIELD_MEAN_ERR):
            fail("st_render_fwd kernel disagrees with its plain twin")
        # the fused backward (6b) recomputes the heads' raw outputs from the
        # feature residual on mma.sync, summing in another order than this
        # wgmma forward: the largest raw-output difference it sees
        rec = mma["recompute"](feat, et, lt, tt, weights, rpi)
        old = mma["st_render"](*targs[:8], mu, want_res=True)
        old_eval = mma["st_render"](*eargs[:8], mu)
        torch.cuda.synchronize()
        rec_err = max(float((rec[0] - rgb).abs().max()),
                      float((rec[1] - tr).abs().max()))
        old_rel = max(float(((old[0] - kref).abs()
                             / kref.abs().clamp(min=1.0)).max()),
                      float(((old_eval - ref).abs()
                             / ref.abs().clamp(min=1.0)).max()))
        old_err = max(float((old[0] - kref).abs().max()),
                      float((old_eval - ref).abs().max()))
        del old, old_eval, rec, kref
        ab = fwd_ab(lambda: st_render_fwd(*targs, want_res=True),
                    lambda: mma["st_render"](*targs[:8], mu, want_res=True))
        ab_eval = fwd_ab(lambda: st_render_fwd(*eargs),
                         lambda: mma["st_render"](*eargs[:8], mu))
        l2 = mma["l2_bytes"](weights, xt.shape[1], e3, MT)
        print(f"kernel st_render_fwd (row 6f): 6b's mma.sync recompute vs "
              f"this forward's raw outputs max|diff|={rec_err:.3g} (bound "
              f"{FIELD_MAX_ERR}); mma.sync form packed max|err|/max(|ref|,1)="
              f"{old_rel:.3g} (bound {RENDER_MAX_ERR}); training "
              f"{ab_text(ab, l2)}; eval A/B {ab_eval[0]:.4f} / "
              f"{ab_eval[1]:.4f} / {ab_eval[2]:.4f} / {ab_eval[3]:.4f} ms",
              flush=True)
        if not (rec_err <= FIELD_MAX_ERR and old_rel <= RENDER_MAX_ERR):
            fail("st_render_fwd: the mma.sync recompute or form strays from "
                 "the forward or the twin")
        out["st_render_fwd"] = entry(
            max(p_abs, raw_max), ms_res, plain_res, b_res,
            packed_rel_err=p_rel, epilogue_err=epi_err, feat_rel_err=f_rel,
            eval_ms=ms_eval, eval_plain_ms=plain_eval,
            eval_bound_ms=b_eval[0], eval_bound_by=b_eval[1],
            eval_max_abs_err=e_abs, eval_packed_rel_err=e_rel,
            recompute_max_abs_diff=rec_err,
            eval_mma_sync_ms=[ab_eval[0], ab_eval[3]],
            eval_wgmma_ms=[ab_eval[1], ab_eval[2]],
            **ab_numbers(ab, old_err))

        # the fused backward from the training launch's residuals, against
        # its twin and against the hybrid backward (composite backward →
        # field backward) on the same residuals
        cot = (torch.randn(MT // N, 16, generator=g) / (MT // N)).to(dev)
        bargs = (feat, et, lt, tt, dens, dt, cot, weights, rpi)
        bgot = st_render_bwd(*bargs)
        bwant = st_render_bwd_plain(*bargs)

        def hybrid():
            d_rgb, d_tr = composite_st_bwd(rgb, tr, dens, dt, cot)
            return st_field_bwd(feat, et, lt, tt, weights, rpi, d_rgb, d_tr)

        bhyb = hybrid()
        torch.cuda.synchronize()
        flat = [list(x[0]) + [x[1], x[2]] for x in (bgot, bwant, bhyb)]
        norm = max(rel_norm(a, b) for a, b in zip(flat[0], flat[1]))
        peak = max(rel_max(a, b) for a, b in zip(flat[0], flat[1]))
        bmax = max(float((a - b).abs().max())
                   for a, b in zip(flat[0], flat[1]))
        h_norm = max(rel_norm(a, b) for a, b in zip(flat[0], flat[2]))
        bms = time_ms(lambda: st_render_bwd(*bargs), reps=20)
        bplain = time_ms(lambda: st_render_bwd_plain(*bargs))
        hms = time_ms(hybrid, reps=20)
        bb = bound(nbytes(feat, et, lt, tt, dens, dt, cot,
                          *weights.head_params(), *flat[0]),
                   2 * mega_bwd_macs(weights, e3) * MT, PEAK_BF16,
                   COMPOSITE_ST_BWD_OPS * MT)
        print(f"kernel st_render_bwd: M={MT} ({B} images) worst tensor "
              f"‖err‖/‖ref‖={norm:.3g} (bound {FIELD_BWD_NORM}), max|err|/"
              f"max|ref|={peak:.3g} (bound {FIELD_BWD_MAX}); vs the hybrid "
              f"backward ‖err‖/‖ref‖={h_norm:.3g} (bound {FIELD_BWD_NORM}); "
              f"{bms:.4f} ms vs plain {bplain:.4f} ms, hybrid (two kernels) "
              f"{hms:.4f} ms (bound {bb[0]:.4f} ms, {bb[1]}); "
              f"{2 * mega_bwd_macs(weights, e3) * MT / (bms * 1e-3) / 1e12:.1f}"
              " TFLOP/s", flush=True)
        if not (norm <= FIELD_BWD_NORM and peak <= FIELD_BWD_MAX
                and h_norm <= FIELD_BWD_NORM):
            fail("st_render_bwd kernel disagrees with its plain twin or the "
                 "hybrid backward")
        # the split form (dX chain, dW GEMM, reduction) phase by phase and
        # in turns with the one-kernel form it replaced; the hybrid again
        # after it, in the same call
        ep_meta = torch.empty((MT, -(-e3 // 16) * 16), dtype=torch.bfloat16,
                              device="meta")
        extra, gemm, red = split_bwd(
            sf_module, lambda: st_render_bwd(*bargs),
            lambda: (lambda r: list(r[0]) + [r[1], r[2]])(
                one_kernel["st_render"](*bargs)),
            flat[1], (feat, dens, dt, cot, ep_meta), True, "st_render_bwd")
        hms2 = time_ms(hybrid, reps=20)
        print(f"kernel st_render_bwd (row 6b): hybrid {hms:.4f} / "
              f"{hms2:.4f} ms around the A/B", flush=True)
        out["st_render_bwd"] = entry(bmax, bms, bplain, bb,
                                     hybrid_ms=[hms, hms2],
                                     hybrid_rel_norm=h_norm, **extra)
        out["_dw"] = {f"row 6b, {MT} rows": (gemm, red)}
    return out


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


def coarse_kernel_phase(here, dev, one_kernel, mma):
    """The pretrain's three kernels against their twins at the pretrain
    step's shape, 2048 rays × 64 stratified samples (16 images × 128 rays)
    at the full width of configs/nerf_lm_pretrain.yaml.
    ``one_kernel["coarse_field"]`` runs the trunk-training one-kernel
    backward, ``mma["coarse_render"]`` / ``mma["coarse_field"]`` the two
    forwards' mma.sync forms (the measurement builds)."""
    import torch
    from texpose_tpu_torch.kernels import coarse_field as cf_module
    from texpose_tpu_torch.kernels.coarse_field import (
        coarse_field_bwd, coarse_field_bwd_plain,
        coarse_render_fwd, coarse_render_plain)
    from texpose_tpu_torch.kernels.composite import (
        composite_coarse_bwd, composite_coarse_bwd_plain)
    from texpose_tpu_torch.ops.render import union_sorted_depths
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
        b_eval = bound(nbytes(ep, dist, d, got, *w.params()),
                       2 * fwd_macs * M, PEAK_BF16)
        b_res = bound(nbytes(ep, dist, d, got, rgb, dens, acts,
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
        old = mma["coarse_render"](*args)
        torch.cuda.synchronize()
        old_err = float((old - ref).abs().max())
        old_rel = float(((old - ref).abs() / ref.abs().clamp(min=1.0)).max())
        del old
        ab = fwd_ab(lambda: coarse_render_fwd(*args, want_res=True),
                    lambda: mma["coarse_render"](*args, want_res=True))
        ab_eval = fwd_ab(lambda: coarse_render_fwd(*args),
                         lambda: mma["coarse_render"](*args))
        l2 = mma["l2_bytes"](w, xext.shape[1], ep.shape[1], M)
        print(f"kernel coarse_render_fwd (row 8): mma.sync form packed "
              f"max|err|/max(|ref|,1)={old_rel:.3g} (bound {RENDER_MAX_ERR});"
              f" with residuals {ab_text(ab, l2)}; eval A/B {ab_eval[0]:.4f} "
              f"/ {ab_eval[1]:.4f} / {ab_eval[2]:.4f} / {ab_eval[3]:.4f} ms",
              flush=True)
        if not old_rel <= RENDER_MAX_ERR:
            fail("coarse_render_fwd mma.sync form disagrees with its twin")
        # absolute errors of every output of the training launch; the
        # relative errors that the check holds under their own keys
        out["coarse_render_fwd"] = entry(
            max(pabs, raw_max, act_abs), ms_res, plain_res, b_res,
            packed_rel_err=perr, act_rel_err=act_rel, eval_ms=ms,
            eval_plain_ms=plain_ms, eval_bound_ms=b_eval[0],
            eval_bound_by=b_eval[1],
            eval_mma_sync_ms=[ab_eval[0], ab_eval[3]],
            eval_wgmma_ms=[ab_eval[1], ab_eval[2]],
            **ab_numbers(ab, old_err))

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
        fb = bound(nbytes(ep, acts, *cgot, *w.params(), *fgot),
                   2 * bwd_macs * M, PEAK_BF16)
        print(f"kernel coarse_field_bwd: M={M} worst tensor ‖err‖/‖ref‖="
              f"{norm:.3g} (bound {FIELD_BWD_NORM}), max|err|/max|ref|="
              f"{peak:.3g} (bound {FIELD_BWD_MAX}); {fms:.4f} ms vs plain "
              f"{fplain:.4f} ms (bound {fb[0]:.4f} ms, {fb[1]}); "
              f"{2 * bwd_macs * M / (fms * 1e-3) / 1e12:.1f} TFLOP/s",
              flush=True)
        if not (norm <= FIELD_BWD_NORM and peak <= FIELD_BWD_MAX):
            fail("coarse_field_bwd kernel disagrees with its plain twin")
        extra, gemm, red = split_bwd(
            cf_module, lambda: coarse_field_bwd(*fargs),
            lambda: one_kernel["coarse_field"](*fargs), fref, (acts, *cgot),
            False, "coarse_field_bwd")
        out["coarse_field_bwd"] = entry(fmax, fms, fplain, fb, **extra)
        out["_dw"] = {f"row 7b, {M} rows": (gemm, red)}

        # the field forward with raw outputs (row 7a) on the coarse field's
        # rows and on the fine field's: the coarse samples plus 128 more
        # per ray (stratified, sorted in), 2048 × 192 = 393,216 rows
        fine_depth = union_sorted_depths(depth, sample_depth(
            near, far, N_FINE, rand=torch.rand(1, BR, N_FINE, 1,
                                               generator=g).to(dev)))
        fine_pts = center[..., None, :] + ray[..., None, :] * fine_depth
        fx, fe = coarse_field_inputs(cfg, fine_pts, None, None)
        variants = {}
        for rows, (x_, e_) in ((M, (xext, ep)), (fx.shape[0], (fx, fe))):
            variants[rows] = field_fwd_check(x_, e_, w, fwd_macs, rows, mma)
        f_out, f_raw, f_res = variants[fx.shape[0]]
        out["coarse_field_fwd"] = dict(f_out, variants={
            str(rows): v[0] for rows, v in variants.items()})

        # the composite forward (rows 9a/9c: one kernel, flat layout) on
        # both fields' raw outputs, and the backward at 192 samples
        depths = {N: (d, dist), fine_depth.shape[2]: (
            fine_depth.reshape(BR, -1),
            _dists(fine_depth, ray).reshape(BR, -1))}
        comp = {}
        for n, (rgb_, dens_) in ((N, variants[M][1]),
                                 (fine_depth.shape[2], f_raw)):
            dd, di = depths[n]
            comp[n] = composite_fwd_check(rgb_, dens_, dd, di, n)
        out["composite_coarse_fwd"] = dict(comp[N], variants={
            str(n): v for n, v in comp.items()})
        nf = fine_depth.shape[2]
        dd, di = depths[nf]
        cot = (torch.randn(BR, 8, generator=g) / BR).to(dev)
        cargs = (*f_raw, di, dd, cot)
        cgot = composite_coarse_bwd(*cargs)
        cref = composite_coarse_bwd_plain(*cargs)
        torch.cuda.synchronize()
        crel = max(rel_max(a, b) for a, b in zip(cgot, cref))
        cmax = max(float((a - b).abs().max()) for a, b in zip(cgot, cref))
        cms = time_ms(lambda: composite_coarse_bwd(*cargs), reps=20)
        cplain = time_ms(lambda: composite_coarse_bwd_plain(*cargs), reps=20)
        cb = bound(nbytes(*cargs, *cgot), COMPOSITE_COARSE_BWD_OPS * BR * nf,
                   PEAK_F32)
        print(f"kernel composite_coarse_bwd: {BR} rays x {nf} samples "
              f"max|err|={cmax:.3g} ({crel:.3g} of max, bound "
              f"{COMPOSITE_BWD_REL}); {cms:.4f} ms vs plain {cplain:.4f} ms "
              f"(bound {cb[0]:.4f} ms, {cb[1]})", flush=True)
        if not crel <= COMPOSITE_BWD_REL:
            fail("composite_coarse_bwd kernel disagrees with its plain twin "
                 f"at {nf} samples")
        out["composite_coarse_bwd"]["variants"] = {str(nf): entry(
            cmax, cms, cplain, cb)}

        # the field backward on the fine field's rows, from the kernel's
        # residuals and that composite backward's gradients
        MF = fx.shape[0]
        fargs = (fx, fe, *f_res, w, *cgot)
        fgot = coarse_field_bwd(*fargs)
        fref = coarse_field_bwd_plain(fx, fe, f_res[1], w, *cgot)
        torch.cuda.synchronize()
        norm = max(rel_norm(a, b) for a, b in zip(fgot, fref))
        peak = max(rel_max(a, b) for a, b in zip(fgot, fref))
        fmax = max(float((a - b).abs().max()) for a, b in zip(fgot, fref))
        fms = time_ms(lambda: coarse_field_bwd(*fargs), reps=5)
        fplain = time_ms(lambda: coarse_field_bwd_plain(
            fx, fe, f_res[1], w, *cgot), reps=5)
        fb = bound(nbytes(fe, f_res[1], *cgot, *w.params(), *fgot),
                   2 * bwd_macs * MF, PEAK_BF16)
        print(f"kernel coarse_field_bwd: M={MF} worst tensor ‖err‖/‖ref‖="
              f"{norm:.3g} (bound {FIELD_BWD_NORM}), max|err|/max|ref|="
              f"{peak:.3g} (bound {FIELD_BWD_MAX}); {fms:.4f} ms vs plain "
              f"{fplain:.4f} ms (bound {fb[0]:.4f} ms, {fb[1]}); "
              f"{2 * bwd_macs * MF / (fms * 1e-3) / 1e12:.1f} TFLOP/s",
              flush=True)
        if not (norm <= FIELD_BWD_NORM and peak <= FIELD_BWD_MAX):
            fail(f"coarse_field_bwd kernel disagrees with its plain twin at "
                 f"{MF} rows")
        extra, gemm, red = split_bwd(
            cf_module, lambda: coarse_field_bwd(*fargs),
            lambda: one_kernel["coarse_field"](*fargs), fref,
            (f_res[1], *cgot), False, "coarse_field_bwd")
        out["coarse_field_bwd"]["variants"] = {str(MF): entry(
            fmax, fms, fplain, fb, **extra)}
        out["_dw"][f"row 7b, {MF} rows"] = (gemm, red)
    return out


def field_fwd_check(xext, ep, w, fwd_macs, rows, mma):
    """coarse_field_fwd against coarse_field_plain, without and with the
    training residuals, and in turns with its mma.sync form
    ``mma["coarse_field"]`` (the measurement build) → (the training
    launch's numbers with the eval launch's under ``eval_*`` keys, its raw
    outputs, its residuals)."""
    old = mma["coarse_field"]
    import torch
    from texpose_tpu_torch.kernels.coarse_field import (coarse_field_fwd,
                                                        coarse_field_plain)
    got = coarse_field_fwd(xext, ep, w)
    rgb, dens, (xe, acts) = coarse_field_fwd(xext, ep, w, want_res=True)
    rgb_ref, dens_ref, acts_ref = coarse_field_plain(xext, ep, w,
                                                     want_res=True)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], rgb) and torch.equal(got[1], dens)):
        fail("coarse_field_fwd: the training launch differs from the "
             "evaluation launch")
    raw = [(a - b).abs() for a, b in ((rgb, rgb_ref), (dens, dens_ref))]
    raw_max = max(float(e.max()) for e in raw)
    raw_mean = max(float(e.mean()) for e in raw)
    act_abs = act_rel = act_mean = 0.0
    for a, b in zip(acts, acts_ref):
        e = (a.float() - b).abs()
        act_abs = max(act_abs, float(e.max()))
        act_rel = max(act_rel, float((e / b.abs().clamp(min=1.0)).max()))
        act_mean = max(act_mean, float(e.mean()))
    del acts_ref
    reps = 10 if rows <= 131072 else 5
    ms = time_ms(lambda: coarse_field_fwd(xext, ep, w), reps=reps)
    plain_ms = time_ms(lambda: coarse_field_plain(xext, ep, w), reps=reps)
    ms_res = time_ms(lambda: coarse_field_fwd(xext, ep, w, want_res=True),
                     reps=reps)
    plain_res = time_ms(lambda: coarse_field_plain(xext, ep, w,
                                                   want_res=True), reps=reps)
    ops = 2 * fwd_macs * rows
    b_eval = bound(nbytes(ep, rgb, dens, *w.params()), ops, PEAK_BF16)
    b_res = bound(nbytes(ep, rgb, dens, acts, *w.params()), ops, PEAK_BF16)
    print(f"kernel coarse_field_fwd: M={rows} raw max|err|={raw_max:.3g} "
          f"(bound {FIELD_MAX_ERR}) mean={raw_mean:.3g} (bound "
          f"{FIELD_MEAN_ERR}); residual activations max|err|/max(|ref|,1)="
          f"{act_rel:.3g} (bound {FEAT_REL}) mean={act_mean:.3g}; eval "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms (bound {b_eval[0]:.4f} "
          f"ms, {b_eval[1]}); with residuals {ms_res:.4f} ms vs plain "
          f"{plain_res:.4f} ms (bound {b_res[0]:.4f} ms, {b_res[1]}); "
          f"{ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s", flush=True)
    if not (raw_max <= FIELD_MAX_ERR and raw_mean <= FIELD_MEAN_ERR
            and act_rel <= FEAT_REL and act_mean <= FIELD_MEAN_ERR):
        fail(f"coarse_field_fwd kernel disagrees with its plain twin at "
             f"{rows} rows")
    o_rgb, o_dens = old(xext, ep, w)
    torch.cuda.synchronize()
    old_err = max(float((o_rgb - rgb_ref).abs().max()),
                  float((o_dens - dens_ref).abs().max()))
    ab = fwd_ab(lambda: coarse_field_fwd(xext, ep, w, want_res=True),
                lambda: old(xext, ep, w, want_res=True), reps=reps)
    ab_eval = fwd_ab(lambda: coarse_field_fwd(xext, ep, w),
                     lambda: old(xext, ep, w), reps=reps)
    l2 = mma["l2_bytes"](w, xext.shape[1], ep.shape[1], rows)
    print(f"kernel coarse_field_fwd (row 7a): M={rows} mma.sync form raw "
          f"max|err|={old_err:.3g} (bound {FIELD_MAX_ERR}); with residuals "
          f"{ab_text(ab, l2)}; eval A/B {ab_eval[0]:.4f} / {ab_eval[1]:.4f} "
          f"/ {ab_eval[2]:.4f} / {ab_eval[3]:.4f} ms", flush=True)
    if not old_err <= FIELD_MAX_ERR:
        fail(f"coarse_field_fwd mma.sync form disagrees with its twin at "
             f"{rows} rows")
    numbers = entry(max(raw_max, act_abs), ms_res, plain_res, b_res,
                    act_rel_err=act_rel, eval_ms=ms, eval_plain_ms=plain_ms,
                    eval_bound_ms=b_eval[0], eval_bound_by=b_eval[1],
                    eval_mma_sync_ms=[ab_eval[0], ab_eval[3]],
                    eval_wgmma_ms=[ab_eval[1], ab_eval[2]],
                    **ab_numbers(ab, old_err))
    return numbers, (rgb, dens), (xe, acts)


def composite_fwd_check(rgb, dens, depth, dist, n):
    """composite_coarse_fwd against composite_coarse_plain → numbers."""
    import torch
    from texpose_tpu_torch.kernels.composite import (composite_coarse_fwd,
                                                     composite_coarse_plain)
    BR = depth.shape[0]
    got = composite_coarse_fwd(rgb, dens, depth, dist)
    ref = composite_coarse_plain(rgb, dens, depth, dist)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    ms = time_ms(lambda: composite_coarse_fwd(rgb, dens, depth, dist),
                 reps=20)
    plain_ms = time_ms(lambda: composite_coarse_plain(rgb, dens, depth,
                                                      dist), reps=20)
    b = bound(nbytes(rgb, dens, depth, dist, got),
              COMPOSITE_COARSE_FWD_OPS * BR * n, PEAK_F32)
    print(f"kernel composite_coarse_fwd: {BR} rays x {n} samples "
          f"max|err|={err:.3g} (bound {COMPOSITE_MAX_ERR}); {ms:.4f} ms vs "
          f"plain {plain_ms:.4f} ms (bound {b[0]:.4f} ms, {b[1]})",
          flush=True)
    if not err <= COMPOSITE_MAX_ERR:
        fail(f"composite_coarse_fwd kernel disagrees with its plain twin at "
             f"{n} samples")
    return entry(err, ms, plain_ms, b)


def fixture_argv(here, tmp, dev, n_test, sub="", init=None):
    """A 480x640 fixture of n_test test frames under tmp/<sub> and a seeded
    full-width checkpoint (or the weights ``init``) → the evaluation CLI's
    argv for them."""
    import torch
    from texpose_tpu_torch.data import generate_fixture
    from texpose_tpu_torch.nn.fields import init_nerf_st
    from texpose_tpu_torch.utils.checkpoint import (save_checkpoint_flat,
                                                    torch_state_to_jax)
    from texpose_tpu_torch.utils.config import set_options

    t0 = time.perf_counter()
    root = generate_fixture(os.path.join(tmp, sub, "data"), n_train=8,
                            n_test=n_test, scene="scene_all",
                            image_scale=1.0, crop_res=128)
    print(f"fixture: {n_test} test frames at 480x640 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out_root = os.path.join(tmp, sub, "out")
    ckpt = init or os.path.join(tmp, "init.npz")
    argv = ["--model=nerf_adapt_st_gan",
            f"--yaml={os.path.join(here, 'configs', 'nerf_lm_adapt_gan.yaml')}",
            f"--data.root={root}",
            f"--data.splits_root={os.path.join(root, 'splits')}",
            "--data.object=ball",
            "--nerf.depth.box_source=pred_box_init_calib",
            "--syn2real", "--data.image_size=[480,640]",
            f"--output_root={out_root}", f"--init_weights={ckpt}",
            f"--device={dev}"]
    if init:
        return argv
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


_FIXTURES = {}          # generated fixtures by (scratch directory, kind)

# the split field backwards' phase (b), launched by rows 7b and 2
DW_KERNELS = ("dw_gemm", "dw_reduce")
TEXTURE_KERNELS = ("st_field_fwd", "st_field_bwd", "composite_st_fwd",
                   "composite_st_bwd") + DW_KERNELS
PRETRAIN_KERNELS = ("coarse_render_fwd", "composite_coarse_bwd",
                    "coarse_field_bwd") + DW_KERNELS


FIELD_KERNELS = ("coarse_field_fwd", "coarse_field_bwd") + DW_KERNELS
TWO_KERNELS = ("coarse_field_fwd", "composite_coarse_fwd",
               "composite_coarse_bwd", "coarse_field_bwd") + DW_KERNELS


def _launch_wrappers():
    from texpose_tpu_torch.kernels.coarse_field import (coarse_field_bwd,
                                                        coarse_field_fwd,
                                                        coarse_render_fwd)
    from texpose_tpu_torch.kernels.composite import (composite_coarse_bwd,
                                                     composite_coarse_fwd,
                                                     composite_st_bwd,
                                                     composite_st_fwd)
    from texpose_tpu_torch.kernels.st_field import st_field_bwd, st_field_fwd
    from texpose_tpu_torch.kernels.st_render import (st_render_bwd,
                                                     st_render_fwd)
    from texpose_tpu_torch.kernels.trunk import trunk_fwd
    from texpose_tpu_torch.kernels.dw_gemm import dw_gemm, dw_reduce
    return {f.__name__: f for f in (
        st_field_fwd, st_field_bwd, composite_st_fwd, composite_st_bwd,
        coarse_render_fwd, composite_coarse_bwd, coarse_field_bwd,
        coarse_field_fwd, composite_coarse_fwd, trunk_fwd, st_render_fwd,
        st_render_bwd, dw_gemm, dw_reduce)}


def zero_launches():
    for f in _launch_wrappers().values():
        f.launches = 0


def read_launches():
    return {k: f.launches for k, f in _launch_wrappers().items()}


def train_argv(here, tmp, dev, steps, out="train_out", extra=()):
    """A 128x128 fixture of 16 train images (bench.py's; made once per
    scratch directory), a seeded trunk saved as the group's JAX-format
    pretrain_model.ckpt under tmp/<out> → the train CLI's argv, plus
    ``extra`` flags."""
    import torch
    from texpose_tpu_torch.data import generate_fixture
    from texpose_tpu_torch.nn.fields import init_nerf_st
    from texpose_tpu_torch.utils.checkpoint import (save_checkpoint_flat,
                                                    torch_state_to_jax)
    from texpose_tpu_torch.utils.config import set_options

    if (tmp, "train") not in _FIXTURES:
        t0 = time.perf_counter()
        _FIXTURES[tmp, "train"] = generate_fixture(
            os.path.join(tmp, "train_data"), n_train=16, n_test=1,
            scene="scene_all", image_scale=1.0, crop_res=128)
        print(f"fixture: 16 train frames at 128x128 in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    root = _FIXTURES[tmp, "train"]
    out_root = os.path.join(tmp, out)
    argv = ["--model=nerf_adapt_st_gan",
            f"--yaml={os.path.join(here, 'configs', 'nerf_lm_adapt_gan.yaml')}",
            f"--data.root={root}",
            f"--data.splits_root={os.path.join(root, 'splits')}",
            "--data.object=ball",
            "--nerf.depth.box_source=pred_box_init_calib",
            f"--output_root={out_root}", "--resume_pretrain",
            "--freq.vis=null", f"--max_iter={steps}", "--freq.scalar=10",
            "--freq.val=1000", "--freq.ckpt=1000", f"--device={dev}",
            *extra]
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
    """The train CLI at full width; returns (launch counts of that run, its
    model.ckpt)."""
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

    # kernels.fused_composite off: the field kernels (rows 1 and 2) under
    # the plain composite, as JAX's apply_nerf_st takes them
    eng.cfg.kernels.fused_composite = False
    zero_launches()
    eng.train_step(eng.make_draws(eng.it))
    torch.cuda.synchronize()
    plain_comp = read_launches()
    want = dict(st_field_fwd=1, st_field_bwd=1, dw_gemm=1, dw_reduce=1,
                composite_st_fwd=0, composite_st_bwd=0)
    print(f"train: one step with kernels.fused_composite=false, launches "
          f"{ {k: plain_comp[k] for k in want} }", flush=True)
    if any(plain_comp[k] != v for k, v in want.items()):
        fail(f"train: with fused_composite off the step launched "
             f"{plain_comp}, expected {want}")
    route_check(eng, "fused_composite", lambda: gan_grads(eng),
                "train (fused_composite off)", ref=True,
                ref_name="two-kernel")
    eng.cfg.kernels.fused_composite = True
    gan_warm_rate(eng, "train")
    return launches, os.path.join(cfg.output_path, "model.ckpt")


def gan_warm_rate(eng, what):
    """Warm steps/s of a texture-GAN engine (host clock, WARM_STEPS steps
    ending in a sync); prints texture_train_rays_per_sec."""
    import torch
    for _ in range(3):
        eng.train_step(eng.make_draws(eng.it))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        eng.train_step(eng.make_draws(eng.it))
    torch.cuda.synchronize()
    steps_s = WARM_STEPS / (time.perf_counter() - t0)
    print(f"{what}: warm {steps_s:.3f} steps/s = {steps_s * 2048:.1f} rays/s "
          f"(texture_train_rays_per_sec, batch 8 x 16x16 patches, "
          f"{WARM_STEPS} steps)", flush=True)
    return steps_s


def gan_grads(eng):
    out = {f"heads/{k}": p.grad.clone() for k, p in eng._trainable_heads()}
    out.update({f"latents/{k}": t.grad.clone()
                for k, t in eng.latents.items()})
    out.update({f"disc/{g}/{i}": w.grad.clone()
                for g, i, w in eng._disc_leaves()})
    return out


def route_check(eng, switch, grads, what, ref=False, ref_name="plain",
                env=False):
    """One step from one state and one set of draws through the run's
    route and, with cfg.kernels.<switch> (with ``env``, the environment
    variable <switch>) set to ``ref``, through the reference route (the
    plain route by default): losses and gradients (``grads()`` after a
    step) agree."""
    cfg = eng.cfg
    state = eng.train_state_flat(0)
    draws = eng.make_draws(eng.it)
    k_loss = eng.train_step(draws)
    k_grad = grads()
    eng.load_train_state_flat(state)
    if env:
        was = os.environ.get(switch)
        os.environ[switch] = ref
    else:
        was = cfg.kernels.get(switch)
        setattr(cfg.kernels, switch, ref)
    try:
        p_loss = eng.train_step(draws)
    finally:
        if not env:
            setattr(cfg.kernels, switch, was)
        elif was is None:
            del os.environ[switch]
        else:
            os.environ[switch] = was
    p_grad = grads()
    eng.load_train_state_flat(state)
    loss_err = max(abs(float(k_loss[k]) - float(p_loss[k]))
                   / max(abs(float(p_loss[k])), 1e-12) for k in p_loss)
    grad_err = {k: rel_norm(k_grad[k], p_grad[k]) for k in p_grad}
    worst = max(grad_err, key=grad_err.get)
    print(f"{what}: kernel vs {ref_name} route, one step: worst loss rel "
          f"{loss_err:.3g} (bound {ROUTE_LOSS_RTOL}); worst gradient "
          f"‖err‖/‖ref‖ {grad_err[worst]:.3g} at {worst} (bound "
          f"{ROUTE_GRAD_NORM})", flush=True)
    if not (loss_err <= ROUTE_LOSS_RTOL
            and grad_err[worst] <= ROUTE_GRAD_NORM):
        fail(f"{what}: the kernel route disagrees with the {ref_name} "
             "route")


def pretrain_argv(here, tmp, dev, steps, env=False, name=None, extra=()):
    """A 128x128 fixture of 16 train images (scene_naive for the pretrain,
    with depth maps; scene_all for the env variant, as the yamls; made once
    per scratch directory and scene) → the train CLI's argv for configs/nerf_lm_pretrain.yaml or
    nerf_lm_env.yaml at their full width, run ``name``, plus ``extra``
    flags.  Returns (argv, fixture root)."""
    from texpose_tpu_torch.data import generate_fixture
    scene = "scene_all" if env else "scene_naive"
    if (tmp, scene) not in _FIXTURES:
        t0 = time.perf_counter()
        _FIXTURES[tmp, scene] = generate_fixture(
            os.path.join(tmp, f"{scene}_data"), n_train=16, n_test=2,
            scene=scene, image_scale=1.0, crop_res=128)
        print(f"fixture: 16 train frames ({scene}) at 128x128 in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    root = _FIXTURES[tmp, scene]
    yml = "nerf_lm_env.yaml" if env else "nerf_lm_pretrain.yaml"
    return ["--model=" + ("nerf_pretrain_env" if env else "nerf_pretrain"),
            f"--yaml={os.path.join(here, 'configs', yml)}",
            f"--data.root={root}",
            f"--data.splits_root={os.path.join(root, 'splits')}",
            "--data.object=ball",
            f"--output_root={os.path.join(tmp, 'pretrain_out')}",
            "--name=" + (name or ("env" if env else "pre")),
            "--freq.vis=null", f"--max_iter={steps}", "--freq.scalar=10",
            "--freq.val=1000", "--freq.ckpt=1000", f"--device={dev}",
            *extra], root


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
    still = _moved(flat, "nerf", init)
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
    steps_s = warm_rate(eng, "pretrain")

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


def warm_rate(eng, what):
    """Warm steps/s of a pretrain engine (host clock, WARM_STEPS steps
    ending in a sync) and the peak device memory of those steps; prints
    pretrain_rays_per_sec."""
    import torch
    cfg = eng.cfg
    for _ in range(3):
        eng.train_step(eng.make_draws(eng.it))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        eng.train_step(eng.make_draws(eng.it))
    torch.cuda.synchronize()
    steps_s = WARM_STEPS / (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fine = (f" + {cfg.nerf.sample_intvs_fine} fine"
            if cfg.nerf.get("fine_sampling") else "")
    print(f"{what}: warm {steps_s:.3f} steps/s = pretrain_rays_per_sec "
          f"{steps_s * eng.rays_per_step():.1f} ({len(eng.train_data)} "
          f"images x {eng.rays_per_image()} rays x {cfg.nerf.sample_intvs}"
          f"{fine} samples, {WARM_STEPS} steps); peak device memory "
          f"{peak:.3f} GiB (max_memory_allocated)", flush=True)
    return steps_s


def _moved(flat, field, init):
    """The leaves of params/<field> in ``flat`` still equal to ``init``."""
    import numpy as np
    return [k for k, v in init.items() if np.array_equal(
        flat[f"params/{field}/" + k.replace(".", "/")], v.numpy())]


def hierarchical_phase(here, tmp, dev):
    """The pretrain CLI with fine sampling at full width (64 coarse + 128
    fine samples per ray); returns the launch counts of that run."""
    import torch
    from texpose_tpu_torch import train
    from texpose_tpu_torch.nn.fields import init_nerf
    from texpose_tpu_torch.utils.checkpoint import load_checkpoint_flat

    argv, _ = pretrain_argv(here, tmp, dev, HIER_STEPS, name="hier", extra=(
        "--nerf.fine_sampling=true", f"--nerf.sample_intvs_fine={N_FINE}",
        "--loss_weight.render_fine=0"))
    zero_launches()
    t0 = time.perf_counter()
    eng = train.main(argv)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"hierarchical: {HIER_STEPS} steps (cold, incl. validation at step "
          f"0) {cold_s:.2f} s; launches {launches}", flush=True)
    if any(launches[k] != 2 * HIER_STEPS for k in FIELD_KERNELS):
        fail(f"hierarchical: both fields must run the field forward and "
             f"backward kernels once per step each: {launches}")
    cfg = eng.cfg
    losses = _train_losses(cfg, HIER_STEPS)
    if "render_fine" not in losses:
        fail(f"hierarchical: no render_fine loss logged: {losses}")
    print(f"hierarchical: step {HIER_STEPS} losses {losses}", flush=True)
    flat = load_checkpoint_flat(os.path.join(cfg.output_path, "model.ckpt"))
    seed = int(cfg.get("seed", 0))
    still = []
    for field, s in (("nerf", seed), ("nerf_fine", seed + 1)):
        init = init_nerf(cfg, torch.Generator().manual_seed(s)).state_dict()
        still += [f"{field}: {k}" for k in _moved(flat, field, init)]
    if still or not any(k.startswith("opt_state/0/mu/nerf_fine/")
                        for k in flat):
        fail(f"hierarchical: leaves that did not move or no fine Adam "
             f"state: {still}")
    print(f"hierarchical: both fields moved; model.ckpt holds {len(flat)} "
          "keypaths with params/nerf_fine", flush=True)
    route_check(eng, "fused_coarse",
                lambda: {k: p.grad.clone() for k, p in eng._all_params()},
                "hierarchical")
    warm_rate(eng, "hierarchical")
    return launches


def two_kernel_phase(here, tmp, dev):
    """The pretrain CLI with kernels.coarse_mega off: field kernel →
    composite kernel forward, their backwards; returns the launch counts
    of that run."""
    import torch
    from texpose_tpu_torch import train

    argv, _ = pretrain_argv(here, tmp, dev, TWO_KERNEL_STEPS, name="two",
                            extra=("--kernels.coarse_mega=false",))
    zero_launches()
    eng = train.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"two_kernel: {TWO_KERNEL_STEPS} steps, launches {launches}, "
          f"losses {_train_losses(eng.cfg, TWO_KERNEL_STEPS)}", flush=True)
    if (min(launches[k] for k in TWO_KERNELS) <= 0
            or launches["coarse_render_fwd"]):
        fail(f"the two-kernel route did not launch its four kernels (and "
             f"no mega forward): {launches}")
    route_check(eng, "coarse_mega",
                lambda: {k: p.grad.clone() for k, p in eng._named_params()},
                "two_kernel", ref=True, ref_name="mega")
    warm_rate(eng, "two_kernel")
    return launches


def trunk_phase(here, tmp, dev, ckpt):
    """The evaluate CLI with nerf.density_noise_reg on 2 frames at 480×640
    with the model ``ckpt`` trained by train_phase: the trunk kernel under
    plain heads; returns the launch counts of that run."""
    import numpy as np
    import torch
    from texpose_tpu_torch import evaluate

    argv = fixture_argv(here, tmp, dev, 2, sub="trunk", init=ckpt) + [
        "--nerf.density_noise_reg=1"]
    zero_launches()
    t0 = time.perf_counter()
    engine = evaluate.main(argv)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"trunk: evaluate (cold, 2 frames, density_noise_reg 1) "
          f"{time.perf_counter() - t0:.2f} s; launches {launches}",
          flush=True)
    if launches["trunk_fwd"] <= 0 or launches["st_field_fwd"]:
        fail(f"trunk: the noisy-config evaluation must run the trunk kernel "
             f"and not the ST field kernel: {launches}")
    rows = [ln.split() for ln in open(os.path.join(engine.cfg.output_path,
                                                   "quant.txt"))][1:]
    if len(rows) != 2 or not all(math.isfinite(float(r[1])) for r in rows):
        fail(f"trunk: quant.txt {rows}")
    frame = engine.eval_frame(0)
    sample = engine.eval_data[0]
    lt = np.zeros((1, int(engine.cfg.nerf.N_latent_trans)), np.float32)
    ll = engine.latents["light"][0:1]
    obj = torch.as_tensor(sample["obj_mask"].reshape(-1) > 0,
                          device=engine.device)
    with torch.inference_mode():
        t_out = engine._render_frame_st(frame, lt, ll,
                                        obj_host=sample["obj_mask"])
        engine.cfg.nerf.density_noise_reg = None
        k_out = engine._render_frame_st(frame, lt, ll,
                                        obj_host=sample["obj_mask"])
        engine.cfg.nerf.density_noise_reg = 1
        err = float((t_out["rgb_static"][0][obj]
                     - k_out["rgb_static"][0][obj]).abs().max())
    print(f"trunk: {launches['trunk_fwd'] / 2:.1f} trunk launches per frame; "
          f"PSNR {[float(r[1]) for r in rows]}; frame 0 rgb_static trunk "
          f"kernel + plain heads vs ST kernel route max|err|={err:.3g} over "
          f"{int(obj.sum())} object pixels (bound {RENDER_MAX_ERR})",
          flush=True)
    if not err <= RENDER_MAX_ERR:
        fail("trunk: the trunk kernel's route disagrees with the ST kernel "
             "route on frame 0")
    return launches


MEGA_KERNELS = ("st_render_fwd", "st_render_bwd")
TWO_KERNEL_ST = ("st_field_fwd", "composite_st_fwd", "composite_st_bwd",
                 "st_field_bwd") + DW_KERNELS


def _with_env(name, value, fn):
    """fn() with the environment variable ``name`` set to ``value``."""
    was = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if was is None:
            del os.environ[name]
        else:
            os.environ[name] = was


def st_mega_phase(here, tmp, dev):
    """The texture model's render kernels on their main paths: the train CLI
    with --kernels.st_mega=true and TEXPOSE_MEGA_FULLBWD=1 for MEGA_STEPS
    steps (render forward + fused backward, and nothing of the two-kernel
    route), then HYBRID_STEPS steps with the default hybrid backward, the
    route checks (fused vs hybrid backward; the mega route vs the
    two-kernel route) and the warm rates of the three; then the eval CLI
    with the mega route on 2 480×640 frames of the trained model, frame 0
    against the two-kernel route.  Returns the launch counts of the train
    CLI run."""
    import numpy as np
    import torch
    from texpose_tpu_torch import evaluate, train

    argv, _ = train_argv(here, tmp, dev, MEGA_STEPS, out="mega_out",
                         extra=("--kernels.st_mega=true",))
    zero_launches()
    t0 = time.perf_counter()
    eng = _with_env("TEXPOSE_MEGA_FULLBWD", "1", lambda: train.main(argv))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    print(f"st_mega: train CLI, {MEGA_STEPS} steps with TEXPOSE_MEGA_FULLBWD=1"
          f" (cold, incl. validation at step 0) {cold_s:.2f} s; launches "
          f"{launches}", flush=True)
    if (launches["st_render_bwd"] != MEGA_STEPS
            or launches["st_render_fwd"] < MEGA_STEPS
            or any(launches[k] != MEGA_STEPS for k in DW_KERNELS)
            or any(launches[k] for k in TWO_KERNEL_ST
                   if k not in DW_KERNELS)):
        fail(f"st_mega: the train CLI must launch the render forward, the "
             f"fused backward's dX chain, the dW GEMM and its reduction "
             f"(each once per step) and no other two-kernel kernel: "
             f"{launches}")
    print(f"st_mega: step {MEGA_STEPS} losses "
          f"{_train_losses(eng.cfg, MEGA_STEPS)}", flush=True)

    # the default, hybrid backward: render forward → composite backward →
    # field backward
    zero_launches()
    _with_env("TEXPOSE_MEGA_FULLBWD", "0", lambda: [
        eng.train_step(eng.make_draws(eng.it)) for _ in range(HYBRID_STEPS)])
    torch.cuda.synchronize()
    hyb = read_launches()
    want = dict(st_render_fwd=HYBRID_STEPS, composite_st_bwd=HYBRID_STEPS,
                st_field_bwd=HYBRID_STEPS, dw_gemm=HYBRID_STEPS,
                dw_reduce=HYBRID_STEPS, st_render_bwd=0, st_field_fwd=0,
                composite_st_fwd=0)
    print(f"st_mega: {HYBRID_STEPS} hybrid-backward steps, launches "
          f"{ {k: hyb[k] for k in want} }", flush=True)
    if any(hyb[k] != v for k, v in want.items()):
        fail(f"st_mega: the hybrid steps launched {hyb}, expected {want}")

    _with_env("TEXPOSE_MEGA_FULLBWD", "1", lambda: route_check(
        eng, "TEXPOSE_MEGA_FULLBWD", lambda: gan_grads(eng), "st_mega",
        ref="0", ref_name="hybrid-backward", env=True))
    _with_env("TEXPOSE_MEGA_FULLBWD", "0", lambda: route_check(
        eng, "st_mega", lambda: gan_grads(eng), "st_mega", ref=False,
        ref_name="two-kernel"))
    rates = {}
    for label, env, mega in (("fused backward", "1", True),
                             ("hybrid backward", "0", True),
                             ("two-kernel route", "0", False)):
        eng.cfg.kernels.st_mega = mega
        rates[label] = _with_env("TEXPOSE_MEGA_FULLBWD", env, lambda: (
            gan_warm_rate(eng, f"st_mega ({label})")))
    eng.cfg.kernels.st_mega = True

    # evaluation through the render forward on the trained model
    ckpt = os.path.join(eng.cfg.output_path, "model.ckpt")
    argv = fixture_argv(here, tmp, dev, 2, sub="mega", init=ckpt) + [
        "--kernels.st_mega=true"]
    zero_launches()
    t0 = time.perf_counter()
    engine = evaluate.main(argv)
    torch.cuda.synchronize()
    ev = read_launches()
    print(f"st_mega: evaluate (cold, 2 frames) {time.perf_counter() - t0:.2f}"
          f" s; launches {ev}", flush=True)
    if ev["st_render_fwd"] <= 0 or any(ev[k] for k in TWO_KERNEL_ST):
        fail(f"st_mega: the evaluation must run the render forward and no "
             f"two-kernel kernel: {ev}")
    rows = [ln.split() for ln in open(os.path.join(engine.cfg.output_path,
                                                   "quant.txt"))][1:]
    if len(rows) != 2 or not all(math.isfinite(float(r[1])) for r in rows):
        fail(f"st_mega: quant.txt {rows}")
    frame = engine.eval_frame(0)
    sample = engine.eval_data[0]
    lt = np.zeros((1, int(engine.cfg.nerf.N_latent_trans)), np.float32)
    ll = engine.latents["light"][0:1]
    obj = torch.as_tensor(sample["obj_mask"].reshape(-1) > 0,
                          device=engine.device)
    with torch.inference_mode():
        m_out = engine._render_frame_st(frame, lt, ll,
                                        obj_host=sample["obj_mask"])
        engine.cfg.kernels.st_mega = False
        t_out = engine._render_frame_st(frame, lt, ll,
                                        obj_host=sample["obj_mask"])
        engine.cfg.kernels.st_mega = True
        err = max(float((m_out[k][0][obj] - t_out[k][0][obj]).abs().max())
                  for k in ("rgb", "rgb_static", "depth", "uncert"))
    print(f"st_mega: {ev['st_render_fwd'] / 2:.1f} render launches per frame; "
          f"PSNR {[float(r[1]) for r in rows]}; frame 0 rgb/rgb_static/depth/"
          f"uncert mega vs two-kernel route max|err|={err:.3g} over "
          f"{int(obj.sum())} object pixels (bound {COMPOSITE_MAX_ERR}: the "
          "same raw outputs and composite arithmetic)", flush=True)
    if not err <= COMPOSITE_MAX_ERR:
        fail("st_mega: the mega route's frame disagrees with the two-kernel "
             "route's")
    return launches


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
    from functools import partial

    from texpose_tpu_torch.kernels import _build
    probe = load_probe(here)
    fwd = load_probe(here, "probe_field_fwd")
    t0 = time.perf_counter()
    sources = ("st_field", "composite", "coarse_field", "trunk_fwd",
               "st_render", "dw_gemm")
    copies = ("coarse_field", "st_field", "st_render")
    fwd_copies = [(s, None) for s in ("st_field", "coarse_field",
                                      "st_render", "trunk_fwd")] \
        + fwd.switch_copies()
    n_jobs = len(sources) + len(copies) + len(fwd_copies)
    with ThreadPoolExecutor(n_jobs) as pool:
        # one nvcc per source and per measurement build
        built = [pool.submit(_build.build, name) for name in sources]
        libs = {name: pool.submit(probe.build_copy, name, probe.ONE_KERNEL)
                for name in copies}
        fwd_libs = {c: pool.submit(fwd.build_mma, *[d for d in c if d])
                    for c in fwd_copies}
        for job in built:
            job.result()
        libs = {name: probe.load_one_kernel(job.result(), name)
                for name, job in libs.items()}
        fwd_libs = {c: fwd.load_mma(job.result(), c[0])
                    for c, job in fwd_libs.items()}
    print(f"build: {len(sources)} kernel sources and "
          f"{len(copies) + len(fwd_copies)} measurement "
          "builds in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    one_kernel = {
        "coarse_field": lambda *a: probe.coarse_one_kernel(
            libs["coarse_field"], *a),
        "st_field": lambda *a: probe.st_one_kernel(libs["st_field"], *a),
        "st_render": lambda *a: probe.render_one_kernel(libs["st_render"],
                                                        *a)}
    # the mma.sync forwards the wgmma forwards replaced, and the render
    # backward's mma.sync recompute (measurement builds)
    mma = {"st_field": partial(fwd.st_field_mma, fwd_libs["st_field", None]),
           "st_render": partial(fwd.st_render_mma,
                                fwd_libs["st_render", None]),
           "recompute": partial(fwd.st_recompute_mma,
                                fwd_libs["st_render", None]),
           "coarse_render": partial(fwd.coarse_render_mma,
                                    fwd_libs["coarse_field", None]),
           "coarse_field": partial(fwd.coarse_field_mma,
                                   fwd_libs["coarse_field", None]),
           "trunk": partial(fwd.trunk_mma, fwd_libs["trunk_fwd", None]),
           "l2_bytes": fwd.l2_bytes, "trunk_l2": fwd.trunk_l2_bytes}
    # step 1: where the mma.sync forwards' time went (measurement switches)
    step1 = fwd.attribution(dev, fwd_libs)

    measured, dw_runs = {}, {}
    for part in (kernel_phase(load_cfg(here), dev, one_kernel, mma),
                 coarse_kernel_phase(here, dev, one_kernel, mma),
                 st_mega_kernel_phase(load_cfg(here), dev, one_kernel,
                                      mma)):
        dw_runs.update(part.pop("_dw", {}))
        measured.update(part)
    measured["st_field_fwd"]["step1"] = step1["row 1, eval"]
    measured["coarse_render_fwd"]["step1"] = {
        k: v for k, v in step1.items() if k.startswith("row 8")}
    # the grouped dW GEMM and its reduction serve rows 7b and 2: the
    # pretrain step's launch first, the other shapes as variants
    first = next(k for k in dw_runs if k.startswith("row 7b"))
    for i, name in enumerate(("dw_gemm", "dw_reduce")):
        measured[name] = dict(dw_runs[first][i], variants={
            k: v[i] for k, v in dw_runs.items() if k != first})
    tmp = tempfile.mkdtemp(prefix="texpose_chip_smoke_")
    try:
        slice_phase(here, tmp, dev)
        launches, gan_ckpt = train_phase(here, tmp, dev)
        gan_launches = dict(launches)
        trunk_launches = trunk_phase(here, tmp, dev, gan_ckpt)
        pre_launches, _ = pretrain_phase(here, tmp, dev)
        hier_launches = hierarchical_phase(here, tmp, dev)
        two_launches = two_kernel_phase(here, tmp, dev)
        mega_launches = st_mega_phase(here, tmp, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # each kernel's count from the run of the path it was ported for
    launches.update({k: pre_launches[k] for k in PRETRAIN_KERNELS})
    launches["coarse_field_fwd"] = hier_launches["coarse_field_fwd"]
    launches["composite_coarse_fwd"] = two_launches["composite_coarse_fwd"]
    launches["trunk_fwd"] = trunk_launches["trunk_fwd"]
    launches.update({k: mega_launches[k] for k in MEGA_KERNELS})
    by_path = {"pretrain": pre_launches, "hierarchical": hier_launches,
               "two_kernel": two_launches, "gan": gan_launches,
               "st_mega": mega_launches}
    for k in DW_KERNELS:
        launches[k] = pre_launches[k]
        measured[k]["launches_by_path"] = {p: n[k] for p, n in by_path.items()}
        print(f"{k}: launches by path {measured[k]['launches_by_path']}",
              flush=True)

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
               "texpose_tpu/kernels/fused_coarse_field.py:449"),
           "coarse_field_fwd": (
               "texpose_tpu_torch/csrc/coarse_field.cu",
               "texpose_tpu/kernels/fused_coarse_field.py:413"),
           "composite_coarse_fwd": (
               "texpose_tpu_torch/csrc/composite.cu",
               "texpose_tpu/kernels/fused_composite_coarse.py:115"),
           "trunk_fwd": ("texpose_tpu_torch/csrc/trunk_fwd.cu",
                         "texpose_tpu/kernels/fused_trunk.py:229"),
           "st_render_fwd": ("texpose_tpu_torch/csrc/st_render.cu",
                             "texpose_tpu/kernels/fused_st_render.py:198"),
           "st_render_bwd": ("texpose_tpu_torch/csrc/st_render.cu",
                             "texpose_tpu/kernels/fused_st_render.py:314"),
           "dw_gemm": ("texpose_tpu_torch/csrc/dw_gemm.cu",
                       "texpose_tpu/kernels/fused_coarse_field.py:449, "
                       "texpose_tpu/kernels/fused_st_field.py:1000"),
           "dw_reduce": ("texpose_tpu_torch/csrc/dw_gemm.cu",
                         "texpose_tpu/kernels/fused_coarse_field.py:449, "
                         "texpose_tpu/kernels/fused_st_field.py:1000")}
    kernels = [{"name": name, "route": "cuda", "source": src[name][0],
                "replaces": src[name][1], "launches": launches[name],
                **numbers} for name, numbers in measured.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
