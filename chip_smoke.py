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
     tools/probe_field_fwd.py), those forwards' measurement switches
     (csrc/trunk.cuh TRUNK_FWD_*), which the "step 1" lines time against
     the mma.sync build in turns (where the replaced forwards' time went:
     weight loads, residual stores, epilogue), and the warp-per-ray
     composites of rows 4, 9a and 9b (composite.cu with
     -DCOMPOSITE_WARP_PER_RAY, tools/probe_composite.py);
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
     least time the card could take (``bound``).  The composites and the
     dW reduction, kernels of a few µs, are timed three ways: the kernel
     alone (200 launches captured in one CUDA graph, replayed between two
     events, cycling through copies of the inputs that together exceed
     twice the L2 cache, so the inputs come from device memory as the
     bound assumes; torch.profiler's kernel duration and the graph's own
     floor per launch beside it), the wrapper
     per call (host clock over 200 calls) and one call between events (the
     figure earlier records gave, mostly the wrapper's host work); the
     segmented rows 4, 9a and 9b also in turns against their warp-per-ray
     forms (old, new, new, old), through the old host path.  The three field
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
     before that run, which runs under a device trace
     (``eval_cli_launches``): each forward kernel's wrapper counts the warm
     call of the frame program before its capture, and the trace must
     hold its kernel inside the replays exactly once a frame per chunk of
     that frame; PSNR/SSIM must be finite, quant.txt and one 480×640
     PNG per frame written, and frame 0's render through the kernels must
     agree with the plain route.  views/s comes from a second, warm sweep;
  4. train: ``texpose_tpu_torch.train`` (the CLI entry) for TRAIN_STEPS
     steps on a 128×128 fixture of 16 train images at the same full width
     (batch 8 of 16×16 patches, 64 samples, VGG + GAN + R1 losses), the
     trunk from a seeded JAX-format pretrain_model.ckpt via
     --resume_pretrain.  All four texture kernels' launch counters (and
     the dW GEMM's and its reduction's) are
     zeroed just before and must be > 0 after it, and the run is traced
     on the device (``replay_trace``): its steps after the warm-up are
     replays of a captured step, whose kernels no wrapper counts, so each
     kernel must also be found inside the replays, and its launches in
     the last line are its wrapper's eager count plus its replays' count
     in the trace (``launches_eager`` / ``launches_replayed``; phases 5-9's
     CLI runs alike); every logged loss must be
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
     kernels' gate is off and the trunk kernel runs under plain heads,
     traced as phase 3's run: the trunk kernel eagerly in the warm call
     and inside the replays once a frame per chunk (the ST field
     kernel's counter 0), finite metrics, and frame 0 within the render
     bound of the ST kernel route;
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
     on 2 frames of that model, traced as phase 3's run (the render
     forward once a frame per chunk inside the replays, no two-kernel
     kernel either way), frame 0 against the two-kernel route.
  10. preprocess + video: a generated 480x640 fixture of 16 train frames
     whose CAD model is a finer icosphere (20,480 faces, written with the
     port's save_ply).  ``texpose_tpu_torch.compute_box`` runs on the card
     (its gt_box/ files feed the video below) and with --device=cpu: the
     files must agree (max |dt| ≤ 1e-2 mm where both are valid, validity
     differing only within 1e-3 mm of the edge); the torch rasterizer on
     the card against the native one on 4 frames (coverage agreement >
     0.999, depth rtol 1e-3, NOCS median |d| < 1e-3) and the box violation
     fraction of its depth < 0.05; ``compute_surfelinfo`` at the GAN crop
     (128x128) on the card and natively, 16 files in each of its three
     directories, within the same bounds; then ``texpose_tpu_torch.evaluate
     --model=nerf_pretrain --video`` at the full width of
     configs/nerf_lm_pretrain.yaml from a seeded JAX-format npz, on a
     480x480 crop (the pretrain data layer renders square crops only): the
     launch counters zeroed just before, coarse_render_fwd > 0 after,
     novel_pose.npy [60,3,4] and 60 RGB and 60 depth PNGs, and orbit frame
     0 through the kernels (row 8) and through the two-kernel route (rows
     7a + 9a, --kernels.coarse_mega=false: those two launched, row 8 not)
     within RENDER_MAX_ERR of max(|ref|, 1) of the plain route.  Seconds per frame of compute_box, both rasterizers and
     compute_surfelinfo, video frames/s and the rasterizer's peak device
     memory are printed beside the card's name and power limit.
  11. visualize + scene_vis + knn: the pretrain CLI at phase 6's full
     width with --freq.vis=5 for VIS_PRE_STEPS steps and the env variant
     for VIS_ENV_STEPS (one firing): the nine panels a firing, and row 8
     launched ⌈H·W/rand_rays⌉ times inside each visualize (its wrapper's
     eager launches plus those inside graph replays, a device trace of
     each call: visualize renders a captured frame program; its wall time
     is taken under that trace); the texture
     train CLI at phase 4's settings with --freq.vis=5 for VIS_GAN_STEPS
     steps: the thirteen panels, rows 1 and 3 launched inside each
     visualize, cameras.png written where matplotlib is found and else
     skipped with one warning, and the last firing's float render (the
     weights after the last update) within RENDER_MAX_ERR of the plain
     twins on the same state; ``evaluate --syn2real
     --data.scene=scene_vis`` on 2 fixture frames at 480×640 (the 256-px
     crops of the render, the GT and the depth: three PNGs a frame, rows 1
     and 3 launched, finite quant rows, frame 0 against the kernels-off
     route); ``knn_points`` (K = 4) and ``chamfer_distance`` on 10^4 points
     a side on the card against the CPU: the same indices, distances within
     rtol 1e-5.  visualize's wall time per call and the export's warm
     frames/s are printed beside the card's name and power limit.
  12. data parallelism (texpose_tpu_torch/parallel/mesh.py) at phase 6's
     and phase 4's full widths and on a 480x640 frame: (a) the pretrain
     and texture train CLIs for DP_STEPS steps and the evaluate CLI on
     frame 0 with --mesh.dp=true under torchrun's environment at world
     size 1 (NCCL on the card): the run joins the group, the counters of
     rows 8, 9b, 7b and the dW GEMM (pretrain), rows 1, 3, 4 and 2 (GAN)
     and rows 1 and 3 (eval) are > 0, rank 0 writes model.ckpt,
     options.yaml and metrics.jsonl with finite losses and quant.txt;
     (b) two ranks spawned on the one card over gloo on CUDA tensors
     drive the engines from the same argv: from one state and one set of
     global draws each step's losses and summed gradients agree with a
     one-rank engine's within ROUTE_LOSS_RTOL / ROUTE_GRAD_NORM, the
     ranks' train states are bit-identical after 3 steps, and the sharded
     masked eval of frame 0 agrees with one rank within RENDER_MAX_ERR;
     the gradient bytes all-reduced a step and the all-reduce's host ms
     are printed, and the two ranks' steps/s, which share one card over a
     host collective and are no data-parallel rate; (c) the same with NCCL,
     one rank per card, where at least two cards are visible, else one
     line says it did not run.
  scan (between phases 12 and 13): the captured training step
     (texpose_tpu_torch/models/step_graph.py, the port of JAX's
     ``finalize_step``) on four routes at full width — the GAN's
     two-kernel route, kernels.st_mega with the hybrid backward, the
     default pretrain and the hierarchical pretrain — under cuDNN's
     deterministic algorithms: (a) from one seed, SCAN_DISPATCHES ×
     SCAN_K steps eagerly on one engine, in captured dispatches of SCAN_K
     on a second and eagerly on a third: the counts equal, every kernel
     of the route found in a device trace of the last dispatches'
     replays exactly replays × one eager step's count times (the wrappers
     count none there: a replay launches without them), and the train
     states' distance printed, captured vs eager beside eager vs eager (the
     kernels' f32 atomics part two eager trajectories too); (b)
     SCAN_ROUNDS times, the first and third engines set to the second's
     train state and draw generator, one step each: the replay against
     the eager step, over every leaf of the train state (parameters,
     latents, both moments, the counts) and the losses, within SCAN_RTOL
     of each leaf's largest value, printed beside eager vs eager; (c)
     ``validate`` after a dispatch equal
     to ``validate`` of a fresh engine loaded from the checkpoint written
     there (the kernels' packs follow a replay); (d) warm steps/s in
     turns eager / captured / captured / eager, and a profiled window of
     each: wall and device-busy ms a step, the idle share, kernel and
     graph launches a step, beside the card's name and power limit.  The
     CLI runs of phases 4-11 run captured too (the shipped configs'
     scan_steps: 100, gcd-clamped), phase 12's eagerly under mesh.dp, and
     their metrics.jsonl must log at the steps JAX's loop logs
     (``logged_steps``).
  13. training quality (texpose_tpu_torch/tools/quality_check.py): (a)
     its pretrain (QUAL_PRETRAIN_STEPS steps, full width of
     configs/nerf_lm_pretrain.yaml, GT poses, gt_box) and its texture GAN
     (QUAL_GAN_STEPS steps, configs/nerf_lm_adapt_gan.yaml, the trunk
     handed over through pretrain_model.ckpt) on its 16-view 128x128
     scene_qual fixture, through the module's entry with the JAX tool's
     defaults but half its GAN steps, K = ``scan_k()`` steps a dispatch
     through the captured step as the JAX tool dispatches ``step_fn``
     (its route printed; one capture a stage): its gates hold (the
     pretrain's last loss below 0.9x the first and validation PSNR above
     14, every GAN loss finite) and its validation and evaluate_full run;
     (b) from each stage's end state and
     one set of draws per step, TRAJ_PRETRAIN_STEPS pretrain and
     TRAJ_GAN_STEPS GAN steps through the kernels and through the plain
     route (route_check's switch): the per-step relative loss differences
     (their median over steps and losses; each loss's worst step and its
     signed mean over the last half, in units of its mean size) and the
     end states' evaluate_full PSNR (both through the kernels) within the
     TRAJ_* bounds; (c) each stage's launches of rows 8, 9b, 7b and the dW
     GEMM and its reduction (pretrain) and rows 1, 3, 4 and 2 with them
     (GAN), once a step: the wrappers' counts hold the eager warm-up
     steps plus the warm calls of the stage's frame programs (its
     validation and evaluation, captured), a device trace from the
     stage's last dispatch to its end (``traced_last_dispatch``) that
     dispatch's K replayed steps plus the frame programs replayed after
     it (the frame runner's count), and the stage ran steps / K
     dispatches over one capture;
     (d) at each stage's end state, on the next step's own batch and
     draws, every kernel of the step as the step calls it against its
     plain twin on the same inputs (``twin_checks``): rows 8, 9b and 7b
     with the dW GEMM and its reduction (pretrain), rows 1, 3, 4 and 2
     with them (GAN), under the bounds above, each line beside the state's
     regime (largest raw outputs, opaque rays, rays that reach the 1e10
     last interval); the state and the draw generator restored after.
     The field forwards (rows 1 and 8) are held layer by layer: the
     twin's arithmetic (``walk_plain``) on the kernel's own activations
     of each layer (row 1's from a measurement launch that stores every
     hidden layer), each layer's output and the raw outputs against the
     kernel's under FEAT_REL / FIELD_MEAN_ERR / FIELD_MAX_ERR; and end
     to end, the raw outputs and the features / activations, under the
     scale-relative bound (``scale_bound``: max |kernel − twin| ≤
     SCALE_REL of max |twin|, each side within F64_RATIO of the other's
     distance from the twin with f64 sums, ``f64_sums``), since at
     trained magnitudes (raw outputs ~10^2-10^3) no bound set at the
     init's magnitudes holds between any two bf16 implementations.
     (e) tools/probe_f7.py through its entry, short (``f7_phase``):
     F7_SEEDS seeds on its 64-view fixture, each to F7_SPLIT_STEPS
     through the captured step, then its four branches from that state to
     F7_END_STEPS — as is, as is again, the TPU's default precision
     emulated (tools/tpu_precision.py) and cuDNN's deterministic
     algorithms, each captured anew: every branch finishes with the same
     draw generator state, b's emulated sites ran, c ran with
     ``cudnn.deterministic`` set and the others without, and both settings
     are restored after.
  frames (between phases 13 and 14): evaluation's per-frame programs
     (texpose_tpu_torch/models/frame_graph.py, the JAX engines' jit
     cache keys) on every route of FG_ROUTES — rows 1 + 3, 6f
     (kernels.st_mega), 10 (nerf.density_noise_reg), 8 and 7a + 9a
     (kernels.coarse_mega=false) — each captured once a key and replayed:
     on a 480x640 syn2real GAN engine frame 0 as its object pixels, a
     quarter of them and a whole frame (two P buckets and the whole-frame
     route, evaluate_full), on a 480x480 pretrain engine evaluate_full on
     both payloads, validate and a FG_VIDEO_N-frame orbit.  (c) Every key
     captured once in a first sweep (the wrappers' eager launches those of
     the warm calls), then in a second sweep under a device trace the
     route's kernels inside the replays exactly the runner's count (each
     replay its key's chunks) and no eager launch; (a) each key's
     replay against its eager body on the same payload (bit-equal
     predicted; else the FG_* / COMPOSITE_MAX_ERR bounds); (b) on the train
     CLI's 128x128 engines, FG_K captured training steps, then each key
     replayed (no new capture) against a fresh engine's eager body on the
     trained state; (d) views/s end to end (evaluate_full) and render only,
     eager / captured / captured / eager (the runner's capture off and on),
     and a profiled window each way end to end: wall and device-busy ms a
     frame, the idle share, kernel and graph launches a frame; (e) the
     allocator's growth over a captured sweep (< 512 MB) and the graph
     pool's bytes; all beside the card's name and power limit.
  sections (between the frames phase and phase 14): the port's
     decomposition tools at full width (``sections_phase``):
     texpose_tpu_torch/tools/step_sections.py's chained sections S1, S2,
     S8, S9, S0 and S3 (each body chained D_LO and D_HI times in one
     captured CUDA graph, replays timed with CUDA events, the marginal ms
     a body) and S5 (the captured GAN step through its runner, best of
     its dispatches over K); its split of the captured GAN, pretrain and
     hierarchical steps and of the rows 1 + 3 (480x640) and row 8
     (480x480) frames into device ms by kernel group (one eager run in
     named stages aligned with the replays' kernels under a device
     trace); the trace's own cost (the GAN step and the 480x640 frames
     untraced / traced / traced / untraced); eval_stages.py's stages of
     STAGE_FRAMES captured 480x640 frames beside sync_loop and
     pipe_loop.  It fails when a marginal is not a positive number, S1
     parts from row 1's CUDA-event time (the field op it chains, one call
     behind a device spin) by more than SEC_ROW1_REL or S5 (under the
     scan phase's deterministic cuDNN) from the scan phase's captured
     step by more than SEC_STEP_REL, a replayed
     kernel lands in no group or in two, "other" exceeds SEC_OTHER of a
     program's busy ms, or the frame's stages part from sync_loop by more
     than SEC_STAGES_REL; every reading beside the card's name and power
     limit.
  14. the evaluation envelope (texpose_tpu_torch/tools/eval_envelope.py):
     the tool's sweep of ENVELOPE_N frames of the cycled 1869-frame split
     at 480x640 on its 16/1-view fixture (disk → card → masked render →
     metrics → PNG, one warm frame first), its frame program captured,
     under a device trace: the allocator's growth over the sweep under
     the tool's 512 MB gate, and rows 1 and 3 launched once eagerly per
     chunk of one frame (the warm call before the capture) and inside
     graph replays exactly (ENVELOPE_N + 1) x the chunks of one frame;
     the allocator's peak, the graph pool's bytes and the host RSS.  Then
     views/s untraced on the same engine and split, the runner's capture
     off and on in turns (eager / captured / captured / eager), beside the
     card's name and power limit.
Prints the card's name and power limit (nvidia-smi), one JSON line with
each kernel's numbers (``launches``: from the main path's run of phases
3-9 it was ported for, its eager and its replayed launches summed;
apart, its replays in the captured frames of the frames phase and phase
14, ``launches_eval_replayed``, and its device ms inside the sections
phase's captured programs, ``captured_ms``), and last {"ok": true,
"device": {...}}.
"""

import contextlib
import datetime
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
# the field forwards end to end at trained states (phase 13 (d), raw
# outputs ~10^2-10^3): an f32 sum in another order flips bf16 roundings
# that the layers amplify past any absolute bound set at the init's
# magnitudes, between JAX's own field kernel and the twin as well, yet by
# less than one bf16 step of the outputs' scale; so per tensor
# max |kernel − twin| ≤ SCALE_REL·max |twin|, and neither side farther
# than F64_RATIO × the other from the twin with f64 sums (``scale_bound``;
# JAX's kernel against the twin in tests/test_torch_probe_f6.py).
SCALE_REL = 2.0 ** -7
F64_RATIO = 3.0
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


def cold_copies(args):
    """``args`` and copies of it (tensors cloned, other values as they are)
    whose tensors together hold more than twice the card's L2 cache, so a
    run that cycles through them reads its inputs from device memory, as
    a bound of bytes over the memory rate assumes."""
    import torch
    tensors = [a for a in args if torch.is_tensor(a)]
    if not tensors:
        return [tuple(args)]
    size = max(1, nbytes(*tensors))
    l2 = getattr(torch.cuda.get_device_properties(tensors[0].device),
                 "L2_cache_size", 50 << 20)
    n = max(2, -(-2 * l2 // size) + 1)

    def copy(a):                                # same sizes and strides
        if not torch.is_tensor(a):
            return a
        return torch.empty_strided(a.size(), a.stride(), dtype=a.dtype,
                                   device=a.device).copy_(a)
    return [tuple(args)] + [tuple(copy(a) for a in args)
                            for _ in range(n - 1)]


def graph_ms(fn, k=200, replays=5, args=None):
    """A small kernel alone: k calls of ``fn`` captured in one CUDA graph
    and replayed between two events, ms per call (median over replays).
    The wrappers launch on the current stream, the capture stream, so the
    graph holds the k kernels and none of the wrappers' host work.  With
    ``args`` the calls are ``fn(*copy)`` over ``cold_copies(args)`` in turn
    and every call's outputs stay alive until the graph is replayed, so
    inputs and outputs do not stay in L2 from one launch to the next;
    without, ``fn()`` k times (warm: the graph's own floor)."""
    import torch
    sets = cold_copies(args) if args is not None else None
    call = (lambda i: fn(*sets[i % len(sets)])) if sets else \
        (lambda i: fn())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            call(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call(i) for i in range(k)]
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    del graph, outs, sets
    return statistics.median(times)


_GRAPH_FLOOR = []


def graph_floor_ms():
    """The graph replay's own floor per launch: a 1-element fill (warm),
    measured once."""
    import torch
    if not _GRAPH_FLOOR:
        one = torch.zeros(1, device="cuda")
        _GRAPH_FLOOR.append(graph_ms(one.zero_))
    return _GRAPH_FLOOR[0]


def wrapper_ms(fn, k=200, runs=5):
    """The wrapper per call: host clock over k back-to-back calls ending in
    a synchronize, ms per call (median over runs).  For a kernel of a few
    µs the device keeps up, so this is the wrapper's host work."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / k)
    return statistics.median(times)


def profiler_ms(fn, name, calls=50):
    """torch.profiler's mean device duration (ms) of the kernels whose name
    holds ``name`` over ``calls`` eager calls; None if it saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if name in ev.key:
            total += getattr(ev, "device_time_total", None) or \
                getattr(ev, "cuda_time_total", 0)
            count += ev.count
    return total / count / 1e3 if count else None


def small_kernel_ms(fn, args, name, k=200, producer=None):
    """The three times of a kernel of a few µs called as ``fn(*args)``:
    the kernel alone by graph replay over cold copies of ``args``, the
    wrapper per call, one call between events; beside them the profiler's
    kernel duration (warm inputs) as a cross-check of the first, and the
    graph's own floor per launch.  With ``producer`` (a call that returns
    fresh arguments, running the kernels that write them on the main path)
    also ``in_path_ms``: the profiler's duration of the kernel launched
    right after its producer, as the main path launches it."""
    def once():
        return fn(*args)
    t = dict(kernel_ms=graph_ms(fn, k, args=args),
             wrapper_ms=wrapper_ms(once, k),
             event_ms=time_ms(once, reps=20),
             profiler_ms=profiler_ms(once, name),
             graph_floor_ms=graph_floor_ms())
    if producer is not None:
        t["in_path_ms"] = profiler_ms(lambda: fn(*producer()), name,
                                      calls=20)
    return t


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


def small_entry(err, t, plain_ms, bnd, **extra):
    """``entry`` of a kernel of a few µs from ``small_kernel_ms``'s times:
    ``ms`` is the kernel alone (graph replay), beside it the wrapper per
    call and the single call between events that earlier records gave."""
    return entry(err, t["kernel_ms"], plain_ms, bnd, **t, **extra)


def _ms(x):
    return "n/a" if x is None else f"{x:.5f}"


def small_text(t, plain_ms, bnd):
    path = (f"; after its producer {_ms(t['in_path_ms'])} ms (profiler)"
            if "in_path_ms" in t else "")
    return (f"kernel alone {t['kernel_ms']:.5f} ms (graph replay, inputs "
            f"cycled past L2; graph floor {t['graph_floor_ms']:.5f} ms; "
            f"profiler, warm {_ms(t['profiler_ms'])} ms{path}), wrapper per "
            f"call {t['wrapper_ms']:.5f} ms, one call between events "
            f"{t['event_ms']:.5f} ms vs plain {plain_ms:.4f} ms (bound "
            f"{bnd[0]:.5f} ms, {bnd[1]})")


def warp_ab(warp, row, new, args, want):
    """A segmented composite (row 4, 9a or 9b, ``new(*args)``) against the
    warp-per-ray form it replaced (``warp[row]``: the
    -DCOMPOSITE_WARP_PER_RAY build through the old host path,
    tools/probe_composite.py) in turns old / new / new / old → (its
    entry's A/B keys, the printed text, the old form's largest error
    relative to the twin's largest magnitude)."""
    import torch
    old = warp[row]
    got = old(*args)
    got = got if isinstance(got, tuple) else (got,)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    rel = max(rel_max(a, b) for a, b in zip(got, want))
    t = warp["turns"](old, new, args)
    keys = dict(warp_per_ray_kernel_ms=[t["kernel"][0], t["kernel"][3]],
                segmented_kernel_ms=[t["kernel"][1], t["kernel"][2]],
                warp_per_ray_wrapper_ms=[t["wrapper"][0], t["wrapper"][3]],
                segmented_wrapper_ms=[t["wrapper"][1], t["wrapper"][2]],
                warp_per_ray_max_abs_err=err)
    return keys, (f"A/B warp per ray / segmented / segmented / warp per "
                  f"ray: {warp['text'](t)}; warp-per-ray form max|err|="
                  f"{err:.3g}"), rel


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
    red_t = small_kernel_ms(dw.dw_reduce, (partial, prob, got), "dw_reduce")
    red_ms = red_t["kernel_ms"]
    red_plain = time_ms(lambda: dw.dw_reduce_plain(partial, prob, got),
                        reps=3)
    # the yardsticks: one torch.matmul per segment on the same planes, and
    # one sum over the splits
    views = [(dw._planes(srcs[s.a])[s.a_plane][:, s.a_col:s.a_col + s.k_in],
              (g_wide[s.b_plane] if s.b == dw.WIDE else g_narrow)[
                  :, s.b_col:s.b_col + s.n]) for s in segs]
    lib_ms = time_ms(lambda: [torch.matmul(h.t(), g) for h, g in views])
    red_lib = graph_ms(lambda p: p.sum(1), args=(partial,))

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
          f"{DW_REL}); dw_reduce {small_text(red_t, red_plain, red_bound)}"
          f", sum over splits {red_lib:.5f} ms (graph replay, cold) "
          f"max|err|={red_abs:.3g}; byte floor of the split "
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
    red = dict(small_entry(red_abs, red_t, red_plain, red_bound),
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


def kernel_phase(cfg, dev, one_kernel, mma, warp):
    """Each kernel against its twin on one eval chunk; returns the
    measured numbers per kernel.  ``one_kernel["st_field"]`` runs the ST
    heads' one-kernel backward, ``mma["st_field"]`` the ST field's mma.sync
    forward, ``warp["4"]`` the warp-per-ray dual composite backward (the
    measurement builds)."""
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
        ct = small_kernel_ms(
            composite_st_fwd, cargs, "composite_st_fwd",
            producer=lambda: (lambda r, dn, t: (r, t, dn, *cargs[3:]))(
                *st_field_fwd(*args)))
        cplain = time_ms(lambda: composite_st_plain(*cargs), reps=20)
        cb = bound(nbytes(*cargs[:5], cgot), COMPOSITE_ST_FWD_OPS * R * N,
                   PEAK_F32)
        print(f"kernel composite_st_fwd (row 3): {R} rays x {N} samples "
              f"max|err|={cmax:.3g} (bound {COMPOSITE_MAX_ERR}); "
              f"{small_text(ct, cplain, cb)}", flush=True)
        if not cmax <= COMPOSITE_MAX_ERR:
            fail("composite kernel disagrees with its plain twin")
        out["composite_st_fwd"] = small_entry(cmax, ct, cplain, cb)

        # composite backward on the same rays, a cotangent like the train
        # step's (per-ray means over 2048 rays)
        cot = (torch.randn(R, 16, generator=g) / R).to(dev)
        bargs = (rgb_raw, trans_raw, dens_raw, dist, cot)
        bgot = composite_st_bwd(*bargs)
        bref = composite_st_bwd_plain(*bargs)
        torch.cuda.synchronize()
        brel = max(rel_max(a, b) for a, b in zip(bgot, bref))
        bmax = max(float((a - b).abs().max()) for a, b in zip(bgot, bref))
        bt = small_kernel_ms(composite_st_bwd, bargs, "composite_st_bwd")
        bplain = time_ms(lambda: composite_st_bwd_plain(*bargs), reps=20)
        bb = bound(nbytes(*bargs, *bgot), COMPOSITE_ST_BWD_OPS * R * N,
                   PEAK_F32)
        ab_keys, ab_line, old_rel = warp_ab(warp, "4", composite_st_bwd,
                                            bargs, bref)
        print(f"kernel composite_st_bwd (row 4): {R} rays x {N} samples "
              f"max|err|={bmax:.3g} ({brel:.3g} of max, bound "
              f"{COMPOSITE_BWD_REL}); {small_text(bt, bplain, bb)}; "
              f"{ab_line}", flush=True)
        if not (brel <= COMPOSITE_BWD_REL and old_rel <= COMPOSITE_BWD_REL):
            fail("composite backward kernel disagrees with its plain twin")
        out["composite_st_bwd"] = small_entry(bmax, bt, bplain, bb,
                                              **ab_keys)

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


def coarse_kernel_phase(here, dev, one_kernel, mma, warp):
    """The pretrain's three kernels against their twins at the pretrain
    step's shape, 2048 rays × 64 stratified samples (16 images × 128 rays)
    at the full width of configs/nerf_lm_pretrain.yaml.
    ``one_kernel["coarse_field"]`` runs the trunk-training one-kernel
    backward, ``mma["coarse_render"]`` / ``mma["coarse_field"]`` the two
    forwards' mma.sync forms, ``warp["9a"]`` / ``warp["9b"]`` the
    warp-per-ray composite forward and backward (the measurement
    builds)."""
    import torch
    from texpose_tpu_torch.kernels import coarse_field as cf_module
    from texpose_tpu_torch.kernels.coarse_field import (
        coarse_field_bwd, coarse_field_bwd_plain, coarse_field_fwd,
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
        ct = small_kernel_ms(
            composite_coarse_bwd, cargs, "composite_coarse_bwd",
            producer=lambda: (lambda _, r, dn, res: (r, dn, *cargs[2:]))(
                *coarse_render_fwd(*args, want_res=True)))
        cplain = time_ms(lambda: composite_coarse_bwd_plain(*cargs), reps=20)
        cb = bound(nbytes(*cargs, *cgot), COMPOSITE_COARSE_BWD_OPS * M,
                   PEAK_F32)
        ab_keys, ab_line, old_rel = warp_ab(
            warp, "9b", composite_coarse_bwd, cargs, cref)
        print(f"kernel composite_coarse_bwd (row 9b): {BR} rays x {N} "
              f"samples max|err|={cmax:.3g} ({crel:.3g} of max, bound "
              f"{COMPOSITE_BWD_REL}); {small_text(ct, cplain, cb)}; "
              f"{ab_line}", flush=True)
        if not (crel <= COMPOSITE_BWD_REL and old_rel <= COMPOSITE_BWD_REL):
            fail("composite_coarse_bwd kernel disagrees with its plain twin")
        out["composite_coarse_bwd"] = small_entry(cmax, ct, cplain, cb,
                                                  **ab_keys)

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
        # both fields' raw outputs, also right after the field forward
        # with residuals that writes them on the two-kernel training route;
        # and the backward at 192 samples
        depths = {N: (d, dist), fine_depth.shape[2]: (
            fine_depth.reshape(BR, -1),
            _dists(fine_depth, ray).reshape(BR, -1))}
        comp = {}
        for n, (rgb_, dens_), (x_, e_) in (
                (N, variants[M][1], (xext, ep)),
                (fine_depth.shape[2], f_raw, (fx, fe))):
            dd, di = depths[n]
            comp[n] = composite_fwd_check(
                rgb_, dens_, dd, di, n, warp,
                lambda x_=x_, e_=e_, dd=dd, di=di: (*coarse_field_fwd(
                    x_, e_, w, want_res=True)[:2], dd, di))
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
        ct = small_kernel_ms(composite_coarse_bwd, cargs,
                             "composite_coarse_bwd")
        cplain = time_ms(lambda: composite_coarse_bwd_plain(*cargs), reps=20)
        cb = bound(nbytes(*cargs, *cgot), COMPOSITE_COARSE_BWD_OPS * BR * nf,
                   PEAK_F32)
        print(f"kernel composite_coarse_bwd (row 9b): {BR} rays x {nf} "
              f"samples max|err|={cmax:.3g} ({crel:.3g} of max, bound "
              f"{COMPOSITE_BWD_REL}); {small_text(ct, cplain, cb)}",
              flush=True)
        if not crel <= COMPOSITE_BWD_REL:
            fail("composite_coarse_bwd kernel disagrees with its plain twin "
                 f"at {nf} samples")
        out["composite_coarse_bwd"]["variants"] = {str(nf): small_entry(
            cmax, ct, cplain, cb)}

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


def composite_fwd_check(rgb, dens, depth, dist, n, warp, producer):
    """composite_coarse_fwd against composite_coarse_plain, and in turns
    against its warp-per-ray form ``warp["9a"]``; ``producer`` returns
    fresh arguments from the field forward that writes them on the main
    path (``small_kernel_ms``'s in_path_ms) → numbers."""
    import torch
    from texpose_tpu_torch.kernels.composite import (composite_coarse_fwd,
                                                     composite_coarse_plain)
    BR = depth.shape[0]
    args = (rgb, dens, depth, dist)
    got = composite_coarse_fwd(*args)
    ref = composite_coarse_plain(*args)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    t = small_kernel_ms(composite_coarse_fwd, args, "composite_coarse_fwd",
                        producer=producer)
    plain_ms = time_ms(lambda: composite_coarse_plain(*args), reps=20)
    b = bound(nbytes(*args, got), COMPOSITE_COARSE_FWD_OPS * BR * n,
              PEAK_F32)
    ab_keys, ab_line, _ = warp_ab(warp, "9a", composite_coarse_fwd, args,
                                  (ref,))
    # the warp-per-ray form right after the same producer
    ab_keys["warp_per_ray_in_path_ms"] = profiler_ms(
        lambda: warp["9a"](*producer()), "composite_coarse_fwd", calls=20)
    print(f"kernel composite_coarse_fwd (row 9a): {BR} rays x {n} samples "
          f"max|err|={err:.3g} (bound {COMPOSITE_MAX_ERR}); "
          f"{small_text(t, plain_ms, b)}; {ab_line}; warp-per-ray form "
          f"after its producer {_ms(ab_keys['warp_per_ray_in_path_ms'])} "
          f"ms (profiler)", flush=True)
    if not (err <= COMPOSITE_MAX_ERR
            and ab_keys["warp_per_ray_max_abs_err"] <= COMPOSITE_MAX_ERR):
        fail(f"composite_coarse_fwd kernel disagrees with its plain twin at "
             f"{n} samples")
    return small_entry(err, t, plain_ms, b, **ab_keys)


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
    """The evaluation CLI on a 480x640 fixture, under a device trace;
    returns the kernels' launch counts from that run, eager and inside
    its frames' graph replays (the forward kernels only: eval has no
    backward)."""
    import cv2
    import numpy as np
    import torch
    from texpose_tpu_torch import evaluate

    argv = fixture_argv(here, tmp, dev, N_TEST)
    names = ("st_field_fwd", "composite_st_fwd")
    zero_launches()
    t0 = time.perf_counter()
    with replay_trace(names) as replayed:
        engine = evaluate.main(argv)
    cold_s = time.perf_counter() - t0
    launches = eval_cli_launches("slice", engine, replayed, names, N_TEST)
    print(f"slice: evaluate (cold, {N_TEST} frames, under a device trace) "
          f"{cold_s:.2f} s; launches {launches}", flush=True)

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
    from texpose_tpu_torch.kernels import launch_counters
    return {f.__name__: f for f in launch_counters()}


def zero_launches():
    for f in _launch_wrappers().values():
        f.launches = 0


def read_launches():
    return {k: f.launches for k, f in _launch_wrappers().items()}


# the csrc kernel each wrapper launches, one a call: its symbol and, for
# the shared field forward, its template argument, the epilogue
# (csrc/field_fwd.cuh: EPI_NONE 0, EPI_COARSE 1, EPI_ST 2); the
# composites launch their segmented or their warp-per-ray form
KERNEL_SYMBOLS = {
    "st_field_fwd": {("field_fwd_kernel", 0)},
    "coarse_field_fwd": {("field_fwd_kernel", 0)},
    "trunk_fwd": {("field_fwd_kernel", 0)},
    "coarse_render_fwd": {("field_fwd_kernel", 1)},
    "st_render_fwd": {("field_fwd_kernel", 2)},
    "st_field_bwd": {("st_field_bwd_kernel", None)},
    "st_render_bwd": {("st_render_bwd_kernel", None)},
    "coarse_field_bwd": {("coarse_bwd_kernel", None)},
    "composite_st_fwd": {("composite_st_fwd_seg_kernel", None)},
    "composite_st_bwd": {("composite_st_bwd_seg_kernel", None),
                         ("composite_st_bwd_kernel", None)},
    "composite_coarse_fwd": {("composite_coarse_fwd_seg_kernel", None),
                             ("composite_coarse_fwd_kernel", None)},
    "composite_coarse_bwd": {("composite_coarse_bwd_seg_kernel", None),
                             ("composite_coarse_bwd_kernel", None)},
    "dw_gemm": {("dw_gemm_kernel", None)},
    "dw_reduce": {("dw_reduce_kernel", None)},
}


# each wrapper's kernel by its PERF.md row, as the sections phase's split
# groups the replayed kernels (texpose_tpu_torch/tools/step_sections.py)
WRAPPER_ROWS = {"st_field_fwd": "row 1", "coarse_field_fwd": "row 7a",
                "trunk_fwd": "row 10", "coarse_render_fwd": "row 8",
                "st_render_fwd": "row 6f", "st_field_bwd": "row 2 (dX)",
                "st_render_bwd": "row 6b (dX)",
                "coarse_field_bwd": "row 7b (dX)",
                "composite_st_fwd": "row 3", "composite_st_bwd": "row 4",
                "composite_coarse_fwd": "row 9a",
                "composite_coarse_bwd": "row 9b", "dw_gemm": "dw_gemm",
                "dw_reduce": "dw_reduce"}


_PROF_TOOL = []


def profile_tool():
    """tools/profile_eval_torch.py as a module (loaded once): the
    profiler's events (``trace_events``) and the device's busy intervals
    (``_device_intervals``)."""
    if not _PROF_TOOL:
        _PROF_TOOL.append(load_probe(os.path.dirname(os.path.abspath(
            __file__)), "profile_eval_torch"))
    return _PROF_TOOL[0]


@contextlib.contextmanager
def replay_trace(names):
    """A device trace (torch.profiler, CUPTI) of the block.  The dict it
    yields is filled after the block with the launches of the wrappers
    ``names``' kernels inside CUDA graph replays, by wrapper: the kernels
    whose correlation id is a ``cudaGraphLaunch``'s.  A replay launches a
    captured step's kernels without their wrappers, which count only what
    they launch themselves; ``["_symbols"]`` holds every kernel symbol
    the replays ran, with its count."""
    import torch
    from texpose_tpu_torch.tools.step_sections import kernel_symbol
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    owner = {}
    for k in names:
        for sym in KERNEL_SYMBOLS[k]:
            if sym in owner:
                fail(f"replay_trace: {owner[sym]} and {k} launch one symbol "
                     f"{sym}: a trace cannot tell them apart")
            owner[sym] = k
    counts = {}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        yield counts
        torch.cuda.synchronize()
    events = profile_tool().trace_events(prof)
    graphs = {e[1] for e in events if e[0] == DeviceType.CPU
              and "GraphLaunch" in e[2]}
    symbols = {}
    for dev_type, corr, name, *_ in events:
        if dev_type == DeviceType.CUDA and corr in graphs:
            sym = kernel_symbol(name)
            symbols[sym] = symbols.get(sym, 0) + 1
    counts.update({k: sum(n for sym, n in symbols.items()
                          if owner.get(sym) == k) for k in names})
    counts["_symbols"] = {f"{s[0]}<{s[1]}>" if s and s[1] is not None
                          else str(s and s[0]): n for s, n in symbols.items()}


@contextlib.contextmanager
def traced_last_dispatch(names):
    """The block with one ``replay_trace(names)`` window from the
    ``StepRunner.dispatch`` that ends a run (the engine's count reaching
    its max_iter) to the block's end, the run's evaluations after it
    included: the dict it yields holds, after the block, that window's
    counts by wrapper (only kernels inside graph replays count: the
    last dispatch's and those of the frame programs replayed after it)
    and ``["_symbols"]``, ``["_last_k"]`` the last dispatch's steps,
    ``["_frames_at_open"]`` the engine's frame runner's replayed launches
    when the window opened, and ``["_dispatches"]`` the number of
    dispatches the block ran.  Not every dispatch: a whole 4000-step stage holds ~10^6
    kernel records, a window a dispatch spends seconds parsing each
    window's events inside the run, and back-to-back windows lost records
    (about one step's a window); a window that ends right after the last
    replay lost that replay's last kernels once (H100, PR 19)."""
    from texpose_tpu_torch.models.step_graph import StepRunner
    plain = StepRunner.dispatch
    seen = {"_dispatches": 0}
    window = {}
    with contextlib.ExitStack() as stack:
        def dispatch(self, k, make_draws=None):
            seen["_dispatches"] += 1
            if not window and self.engine.it + k >= self.engine.max_iter():
                window.update(counts=stack.enter_context(replay_trace(names)),
                              k=k, frames=frame_counts(
                                  self.engine.frame_runner())[1])
            return plain(self, k, make_draws)

        StepRunner.dispatch = dispatch
        try:
            yield seen
        finally:
            StepRunner.dispatch = plain
    if window:
        seen.update(window["counts"], _last_k=window["k"],
                    _frames_at_open=window["frames"])


LAUNCH_SPLIT = {}    # the main paths' launches: eager and replayed apart


def path_launches(path, required, replayed):
    """A main path's launch counts, read just after its run: each
    wrapper's own count of its eager launches plus ``replayed``, the
    trace's count of its kernel inside graph replays (``replay_trace``).
    The two apart go to LAUNCH_SPLIT[path]; fails when a kernel of
    ``required`` ran in no replay."""
    eager = read_launches()
    LAUNCH_SPLIT[path] = {k: {"eager": n, "replayed": replayed.get(k, 0)}
                          for k, n in eager.items()}
    print(f"{path}: launches eager (wrapper counts) "
          f"{ {k: n for k, n in eager.items() if n} }, inside graph replays "
          f"(device trace) { {k: replayed[k] for k in required} }",
          flush=True)
    short = [k for k in required if replayed.get(k, 0) <= 0]
    if short:
        fail(f"{path}: kernels that ran in no graph replay: {short}; the "
             f"replays ran {replayed['_symbols']}")
    return {k: n + replayed.get(k, 0) for k, n in eager.items()}


def frame_counts(runner):
    """(eager, replayed) launches by wrapper of a frame runner's units since
    its last drop, from ``stats()``: each unit's warm call once, and its
    warm call's launches once a replay."""
    eager, replayed = {}, {}
    for u in runner.stats().values():
        for k, n in u["warm_launches"].items():
            eager[k] = eager.get(k, 0) + n
            replayed[k] = replayed.get(k, 0) + u["replays"] * n
    return eager, replayed


def eval_cli_launches(what, engine, traced, names, frames, absent=()):
    """An evaluate CLI run's launches, read just after it under a
    ``replay_trace(names + absent)`` of the whole run: each wrapper's own
    count of its eager launches (the warm call of each frame program before
    its capture) and the trace's count of ``names``' kernels inside graph
    replays.  Fails unless the replays ran ``frames`` frames, each with
    its program's chunks (the warm call's launches), the eager launches
    are the warm calls', and ``absent`` kernels ran neither way → the
    launch counts, eager plus replayed; both apart go to
    LAUNCH_SPLIT[what]."""
    eager = read_launches()
    runner = engine.frame_runner()
    units = {key: u for key, u in runner.stats().items()
             if any(u["warm_launches"].get(k) for k in names)}
    warm, want = frame_counts(runner)
    n = sum(u["replays"] for u in units.values())
    seen = {k: (eager[k], traced[k]) for k in names + absent}
    need = {k: (warm.get(k, 0), want.get(k, 0)) for k in names + absent}
    print(f"{what}: launches (eager, inside graph replays) {seen}, expected "
          f"{need}: the warm calls, then {frames} frames of "
          f"{ {str(k): u['warm_launches'] for k, u in units.items()} } "
          f"({n} replays, {runner.captures} captures)", flush=True)
    if n != frames or seen != need or any(seen[k] != (0, 0) for k in absent) \
            or min(need[k][1] for k in names) <= 0:
        fail(f"{what}: launches (eager, replayed) {seen} != {need}, or "
             f"{n} replayed frames != {frames}; the replays ran "
             f"{traced['_symbols']}")
    LAUNCH_SPLIT[what] = {k: {"eager": v, "replayed": traced.get(k, 0)}
                          for k, v in eager.items()}
    return {k: v + traced.get(k, 0) for k, v in eager.items()}


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
    with replay_trace(TEXTURE_KERNELS) as replayed:
        eng = train.main(argv)
    cold_s = time.perf_counter() - t0
    launches = path_launches("train", TEXTURE_KERNELS, replayed)
    print(f"train: {TRAIN_STEPS} steps (cold, incl. validation at step 0, "
          f"under a device trace) {cold_s:.2f} s; launches {launches}",
          flush=True)
    if min(launches[k] for k in TEXTURE_KERNELS) <= 0:
        fail(f"the train path did not launch every kernel: {launches}")

    cfg = eng.cfg
    recs = [json.loads(ln) for ln in
            open(os.path.join(cfg.output_path, "metrics.jsonl"))]
    losses = [r for r in recs if r["split"] == "train" and "all" in r]
    if [r["step"] for r in losses] != logged_steps(cfg, TRAIN_STEPS):
        fail(f"train: unexpected scalar steps {[r['step'] for r in losses]}"
             f", JAX's loop logs {logged_steps(cfg, TRAIN_STEPS)}")
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


def logged_steps(cfg, steps):
    """The steps at which the JAX loop logs scalars in a run of ``steps``
    steps: K = the gcd-clamped scan_steps per dispatch (``scan_k``), after
    the first dispatch and wherever it + K hits freq.scalar."""
    from types import SimpleNamespace
    from texpose_tpu_torch.models.base import Engine
    K = Engine.scan_k(SimpleNamespace(cfg=cfg, max_iter=lambda: steps))
    return [it + K for it in range(0, steps, K)
            if it == 0 or (it + K) % cfg.freq.scalar == 0]


def _train_losses(cfg, steps):
    """The logged train losses; fails unless they come at the steps JAX's
    loop logs them (``logged_steps``) and are finite."""
    recs = [json.loads(ln) for ln in
            open(os.path.join(cfg.output_path, "metrics.jsonl"))]
    losses = [r for r in recs if r["split"] == "train" and "all" in r]
    if [r["step"] for r in losses] != logged_steps(cfg, steps):
        fail(f"{cfg.model}: unexpected scalar steps "
             f"{[r['step'] for r in losses]}, JAX's loop logs "
             f"{logged_steps(cfg, steps)}")
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
    with replay_trace(PRETRAIN_KERNELS) as replayed:
        eng = train.main(argv)
    cold_s = time.perf_counter() - t0
    launches = path_launches("pretrain", PRETRAIN_KERNELS, replayed)
    print(f"pretrain: {PRETRAIN_STEPS} steps (cold, incl. validation at "
          f"step 0, under a device trace) {cold_s:.2f} s; launches "
          f"{launches}", flush=True)
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
    with replay_trace(PRETRAIN_KERNELS) as replayed:
        eng_e = train.main(argv_e)
    launches_e = path_launches("pretrain_env", PRETRAIN_KERNELS, replayed)
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
    with replay_trace(FIELD_KERNELS) as replayed:
        eng = train.main(argv)
    cold_s = time.perf_counter() - t0
    launches = path_launches("hierarchical", FIELD_KERNELS, replayed)
    print(f"hierarchical: {HIER_STEPS} steps (cold, incl. validation at step "
          f"0, under a device trace) {cold_s:.2f} s; launches {launches}",
          flush=True)
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
    with replay_trace(TWO_KERNELS + ("coarse_render_fwd",)) as replayed:
        eng = train.main(argv)
    launches = path_launches("two_kernel", TWO_KERNELS, replayed)
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
    with replay_trace(("trunk_fwd",)) as replayed:
        engine = evaluate.main(argv)
    cold_s = time.perf_counter() - t0
    launches = eval_cli_launches("trunk", engine, replayed, ("trunk_fwd",), 2)
    print(f"trunk: evaluate (cold, 2 frames, density_noise_reg 1, under a "
          f"device trace) {cold_s:.2f} s; launches {launches}", flush=True)
    if launches["st_field_fwd"]:
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
    print(f"trunk: PSNR {[float(r[1]) for r in rows]}; frame 0 rgb_static "
          f"trunk kernel + plain heads vs ST kernel route max|err|={err:.3g} over "
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


def _with_envs(env, fn):
    """fn() with each environment variable of ``env`` set to its value."""
    if not env:
        return fn()
    (name, value), *rest = env.items()
    return _with_env(name, str(value), lambda: _with_envs(dict(rest), fn))


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
    with replay_trace(MEGA_KERNELS + TWO_KERNEL_ST) as replayed:
        eng = _with_env("TEXPOSE_MEGA_FULLBWD", "1",
                        lambda: train.main(argv))
    cold_s = time.perf_counter() - t0
    launches = path_launches("st_mega", MEGA_KERNELS + DW_KERNELS, replayed)
    print(f"st_mega: train CLI, {MEGA_STEPS} steps with TEXPOSE_MEGA_FULLBWD=1"
          f" (cold, incl. validation at step 0, under a device trace) "
          f"{cold_s:.2f} s; launches {launches}", flush=True)
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
    absent = ("st_field_fwd", "composite_st_fwd")
    with replay_trace(("st_render_fwd",) + absent) as replayed:
        engine = evaluate.main(argv)
    cold_s = time.perf_counter() - t0
    ev = eval_cli_launches("st_mega eval", engine, replayed,
                           ("st_render_fwd",), 2, absent)
    print(f"st_mega: evaluate (cold, 2 frames, under a device trace) "
          f"{cold_s:.2f} s; launches {ev}", flush=True)
    if any(ev[k] for k in TWO_KERNEL_ST):
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
    print(f"st_mega: PSNR {[float(r[1]) for r in rows]}; frame 0 "
          f"rgb/rgb_static/depth/"
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


# preprocess + video: the generated fixture at 480x640 (16 train frames)
# with a finer icosphere standing in for a CAD model (20,480 faces at
# subdiv 5; LineMOD's CAD meshes reach about 100k), the crop of
# configs/nerf_lm_adapt_gan.yaml for the surfel files, and a 60-frame
# orbit (the engines' default N).
PRE_SCALE = 1.0          # of the fixture's 480x640 frames
PRE_H, PRE_W = 480, 640
PRE_TRAIN = 16
PRE_SUBDIV = 5
SURFEL_CROP = 128
RASTER_FRAMES = 4
VIDEO_N = 60
# the pretrain engines render square crops of the frame (the data layer
# asserts H == W, as the JAX package's), so the orbit runs at 480x480:
# 230,400 rays a frame, the 480 rows of the fixture's frames
VIDEO_HW = 480
VIDEO_EXTRA = ()          # extra flags of the video run (none on the card)
# the torch rasterizer vs the native one, as JAX's two backends
# (tests/test_raster.py): coverage agreement, depth rtol where both
# cover, NOCS median |Δ|; the box files, card vs CPU, as the CPU parity
# test holds the port to JAX (tests/test_torch_preprocess_cli.py).
RASTER_COVER = 0.999
RASTER_DEPTH_RTOL = 1e-3
RASTER_NOCS_MEDIAN = 1e-3
BOX_MAX_ERR = 1e-2        # mm, where both runs are valid
BOX_EDGE = 1e-3           # mm: valid masks may differ only this near 0
BOX_VIOLATIONS = 0.05     # tests/test_preprocess_cli.py


def _box_argv(root, out, dev, *extra):
    return ["--data_root", os.path.join(root, "lm"), "--folder", "000001",
            "--split_file", os.path.join(root, "splits", "lm", "ball",
                                         "scene_naive", "train.txt"),
            "--cad_path", os.path.join(root, "lm", "models",
                                       "obj_000001.ply"),
            "--height", str(PRE_H), "--width", str(PRE_W),
            f"--device={dev}", *extra] + (
                ["--target_folder", out] if out else [])


def _compare_boxes(card_dir, cpu_dir):
    """Box files of the card run (in the scene's gt_box/, beside the
    fixture's own for the test frames) against the CPU run's → (files, max
    |Δt| where both valid, pixels whose validity differs off the edge)."""
    import numpy as np
    names = sorted(os.listdir(cpu_dir))
    missing = sorted(set(names) - set(os.listdir(card_dir)))
    if missing or len(names) != PRE_TRAIN:
        fail(f"compute_box: CPU files {names}, not written on the card "
             f"{missing}")
    worst, off_edge = 0.0, 0
    for n in names:
        a = np.load(os.path.join(card_dir, n))["data"]
        b = np.load(os.path.join(cpu_dir, n))["data"]
        if a.shape != (2, PRE_H, PRE_W) or a.dtype != np.float32:
            fail(f"compute_box: {n} is {a.shape} {a.dtype}")
        va, vb = a[1] > 0, b[1] > 0
        both = va & vb
        worst = max(worst, float(np.abs(a[:, both] - b[:, both]).max()))
        edge = (np.abs(b[1]) < BOX_EDGE) | (np.abs(b[1] - b[0]) < BOX_EDGE)
        off_edge += int(((va != vb) & ~edge).sum())
    return names, worst, off_edge


def _raster_compare(rt, rn, pose, K):
    """One frame through the torch (card) and the native (host) renderer:
    (coverage agreement, worst depth rel err where both cover, NOCS median
    |Δ|, torch s, native s, torch depth)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    mt, dt = rt.render(pose, K, mode="mask")
    torch.cuda.synchronize()
    t_torch = time.perf_counter() - t0
    t0 = time.perf_counter()
    mn, dn = rn.render(pose, K, mode="mask")
    t_native = time.perf_counter() - t0
    cover = float(((mt > 0) == (mn > 0)).mean())
    both = (dt[0] > 0) & (dn[0] > 0)
    rel = float((np.abs(dt[0][both] - dn[0][both])
                 / np.abs(dn[0][both])).max())
    nt, _ = rt.render(pose, K, mode="nocs")
    nn_, _ = rn.render(pose, K, mode="nocs")
    med = float(np.median(np.abs(nt[0][both] - nn_[0][both])))
    return cover, rel, med, t_torch, t_native, dt[0]


def _surfel_compare(card, cpu, loop):
    """The surfel files of the card run against the native run's → worst
    (coverage agreement, NOCS median |Δ|/255, normal median |Δ|)."""
    import cv2
    import numpy as np
    cover, nocs_med, normal_med = 1.0, 0.0, 0.0
    for sub in (f"rgbsyn_{loop}", f"nocs_{loop}", f"normal_{loop}"):
        names = sorted(os.listdir(os.path.join(card, sub)))
        if len(names) != PRE_TRAIN or names != sorted(
                os.listdir(os.path.join(cpu, sub))):
            fail(f"compute_surfelinfo: {sub} holds {names}")
        for n in names:
            a, b = (os.path.join(d, sub, n) for d in (card, cpu))
            if n.endswith(".npz"):
                a, b = np.load(a)["data"], np.load(b)["data"]
            else:
                a, b = cv2.imread(a, -1), cv2.imread(b, -1)
            if a.shape[:2] != (SURFEL_CROP, SURFEL_CROP) or a.shape != b.shape:
                fail(f"compute_surfelinfo: {sub}/{n} is {a.shape} vs "
                     f"{b.shape}")
            if sub.startswith("rgbsyn"):
                cover = min(cover, float(((a[..., 3] > 0)
                                          == (b[..., 3] > 0)).mean()))
                continue
            both = (np.abs(a).sum(-1) > 0) & (np.abs(b).sum(-1) > 0)
            med = float(np.median(np.abs(a[both].astype(np.float64)
                                         - b[both])))
            if sub.startswith("nocs"):
                nocs_med = max(nocs_med, med / 255.0)
            else:
                normal_med = max(normal_med, med)
    return cover, nocs_med, normal_med


def preprocess_video_phase(here, tmp, dev, smi):
    """The preprocessing CLIs and the pretrain engine's --video on the
    card: compute_box against its CPU run, the torch rasterizer against the
    native one, compute_surfelinfo against its native run, and the
    60-frame orbit through the evaluate CLI; returns the launch counts of
    the video run."""
    import cv2
    import numpy as np
    import torch
    from texpose_tpu_torch import compute_box, compute_surfelinfo, evaluate
    from texpose_tpu_torch.data import generate_fixture, save_ply
    from texpose_tpu_torch.data.cad import CADModel
    from texpose_tpu_torch.data.fixture import _icosphere, sphere_albedo
    from texpose_tpu_torch.models.pretrain import PretrainEngine
    from texpose_tpu_torch.nn.fields import init_nerf
    from texpose_tpu_torch.raster import MeshRenderer
    from texpose_tpu_torch.utils.checkpoint import (save_checkpoint_flat,
                                                    torch_state_to_jax)
    from texpose_tpu_torch.utils.config import set_options

    t0 = time.perf_counter()
    root = generate_fixture(os.path.join(tmp, "pre_data"),
                            n_train=PRE_TRAIN, n_test=2, scene="scene_naive",
                            image_scale=PRE_SCALE, crop_res=SURFEL_CROP)
    cad = os.path.join(root, "lm", "models", "obj_000001.ply")
    verts, faces = _icosphere(60.0, subdiv=PRE_SUBDIV)
    save_ply(cad, verts, faces, sphere_albedo(verts / 60.0))
    model = CADModel(cad)
    print(f"preprocess: fixture of {PRE_TRAIN} train frames at "
          f"{PRE_H}x{PRE_W} in {time.perf_counter() - t0:.1f} s; CAD "
          f"icosphere (subdiv {PRE_SUBDIV}) {len(model.faces)} faces, "
          f"{len(model.vertices)} vertices", flush=True)

    # compute_box on the card (its gt_box/ feeds the video below) and on
    # the CPU
    scene = os.path.join(root, "lm", "000001")
    t0 = time.perf_counter()
    compute_box.main(_box_argv(root, None, dev, "--use_gt_pose"))
    torch.cuda.synchronize()
    box_s = (time.perf_counter() - t0) / PRE_TRAIN
    t0 = time.perf_counter()
    compute_box.main(_box_argv(root, os.path.join(tmp, "box_cpu"), "cpu",
                               "--use_gt_pose"))
    box_cpu_s = (time.perf_counter() - t0) / PRE_TRAIN
    names, worst, off_edge = _compare_boxes(
        os.path.join(scene, "gt_box"), os.path.join(tmp, "box_cpu", "gt_box"))
    cam = json.load(open(os.path.join(scene, "scene_camera.json")))
    gt = json.load(open(os.path.join(scene, "scene_gt.json")))

    def pose_K(i):
        rec = gt[str(i)][0]
        pose = np.concatenate(
            [np.float32(rec["cam_R_m2c"]).reshape(3, 3),
             np.float32(rec["cam_t_m2c"])[:, None]], axis=1)[None]
        return pose, np.float32(cam[str(i)]["cam_K"]).reshape(1, 3, 3)

    aabb = compute_box.squareify_aabb(model, dev)
    pose0, K0 = pose_K(0)
    ms = time_ms(lambda: compute_box.frame_box(*aabb, pose0[0], K0[0],
                                               PRE_H, PRE_W))
    print(f"preprocess: compute_box {len(names)} frames at {PRE_H}x{PRE_W}: "
          f"{box_s:.4f} s/frame on the card with the npz writes "
          f"(frame_box alone {ms:.3f} ms), {box_cpu_s:.4f} s/frame with "
          f"--device=cpu; card vs CPU max|dt| {worst:.3g} mm (bound "
          f"{BOX_MAX_ERR}), validity differs off the edge at {off_edge} "
          f"pixels [{smi}]", flush=True)
    if not (worst <= BOX_MAX_ERR and off_edge == 0):
        fail("compute_box: the card's box files disagree with the CPU's")

    # the torch rasterizer on the card against the native one
    rt = MeshRenderer(model.vertices, model.faces, H=PRE_H, W=PRE_W,
                      backend="torch", device=dev)
    rn = MeshRenderer(model.vertices, model.faces, H=PRE_H, W=PRE_W,
                      backend="native")
    _raster_compare(rt, rn, *pose_K(0))               # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()      # what earlier phases hold
    torch.cuda.reset_peak_memory_stats()
    rows = [_raster_compare(rt, rn, *pose_K(i)) for i in range(
        PRE_TRAIN - RASTER_FRAMES, PRE_TRAIN)]
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    cover = min(r[0] for r in rows)
    rel = max(r[1] for r in rows)
    med = max(r[2] for r in rows)
    t_torch = statistics.median(r[3] for r in rows)
    t_native = statistics.median(r[4] for r in rows)
    box = np.load(os.path.join(scene, "gt_box",
                               f"{PRE_TRAIN - 1:06d}.npz"))["data"]
    frac, obj, _ = compute_box.box_violations(rows[-1][5], box)
    print(f"preprocess: rasterizer, {len(model.faces)} faces at "
          f"{PRE_H}x{PRE_W}, {RASTER_FRAMES} frames: torch on the card "
          f"{t_torch:.4f} s/frame, native (host C++) {t_native:.4f} "
          f"s/frame (median, mask mode); peak device memory "
          f"{peak:.1f} MiB above the {base / 2 ** 20:.1f} MiB allocated "
          f"before (max_memory_allocated); coverage agreement "
          f"{cover:.6f} (bound > {RASTER_COVER}), depth rel err "
          f"{rel:.3g} (bound {RASTER_DEPTH_RTOL}), NOCS median |d| "
          f"{med:.3g} (bound {RASTER_NOCS_MEDIAN}); box violation "
          f"fraction {frac:.4f} of {int(obj.sum())} object pixels "
          f"(bound {BOX_VIOLATIONS}) [{smi}]", flush=True)
    if not (cover > RASTER_COVER and rel <= RASTER_DEPTH_RTOL
            and med < RASTER_NOCS_MEDIAN and frac < BOX_VIOLATIONS
            and obj.sum() > 0):
        fail("the torch rasterizer disagrees with the native one, or the "
             "box misses the CAD depth")

    # compute_surfelinfo at the GAN crop, on the card and natively
    surf = [f"--yaml={os.path.join(here, 'configs', 'nerf_lm_adapt_gan.yaml')}",
            f"--data.root={root}", "--data.object=ball",
            "--data.scene=scene_naive",
            f"--data.splits_root={os.path.join(root, 'splits')}",
            f"--data.image_size=[{SURFEL_CROP},{SURFEL_CROP}]",
            "--data.pose_source=predicted", "--data.pose_loop=init_calib",
            f"--cad_path={cad}"]
    card_dir, cpu_dir = (os.path.join(tmp, d) for d in ("geo", "geo_cpu"))
    t0 = time.perf_counter()
    compute_surfelinfo.main(surf + [f"--render.geo_save_dir={card_dir}",
                                    f"--device={dev}"])
    torch.cuda.synchronize()
    surf_s = (time.perf_counter() - t0) / PRE_TRAIN
    t0 = time.perf_counter()
    compute_surfelinfo.main(surf + [f"--render.geo_save_dir={cpu_dir}",
                                    "--device=cpu"])
    surf_cpu_s = (time.perf_counter() - t0) / PRE_TRAIN
    s_cover, s_nocs, s_normal = _surfel_compare(card_dir, cpu_dir,
                                                "init_calib")
    print(f"preprocess: compute_surfelinfo {PRE_TRAIN} frames at "
          f"{SURFEL_CROP}x{SURFEL_CROP}: {surf_s:.4f} s/frame on the card "
          f"(torch rasterizer), {surf_cpu_s:.4f} s/frame with --device=cpu "
          f"(native); card vs native: alpha coverage {s_cover:.6f}, NOCS "
          f"median |d| {s_nocs:.3g}, normal median |d| {s_normal:.3g} "
          f"[{smi}]", flush=True)
    if not (s_cover > RASTER_COVER and s_nocs < RASTER_NOCS_MEDIAN
            and s_normal < RASTER_NOCS_MEDIAN):
        fail("compute_surfelinfo: the card's files disagree with the "
             "native run's")

    # the pretrain engine's --video through the evaluate CLI
    argv = ["--model=nerf_pretrain",
            f"--yaml={os.path.join(here, 'configs', 'nerf_lm_pretrain.yaml')}",
            f"--data.root={root}",
            f"--data.splits_root={os.path.join(root, 'splits')}",
            "--data.object=ball", f"--data.image_size=[{VIDEO_HW},{VIDEO_HW}]",
            f"--output_root={os.path.join(tmp, 'video_out')}",
            "--name=video", f"--device={dev}", "--video", *VIDEO_EXTRA]
    cfg = set_options(list(argv))
    init = os.path.join(tmp, "pretrain_init.npz")
    save_checkpoint_flat(init, torch_state_to_jax({
        f"nerf.{k}": v for k, v in init_nerf(
            cfg, torch.Generator().manual_seed(0)).state_dict().items()}))
    video_s = []
    orig = PretrainEngine.generate_videos_synthesis

    def timed(self, N=60, fps=30):
        t = time.perf_counter()
        out = orig(self, N=VIDEO_N, fps=fps)
        torch.cuda.synchronize()
        video_s.append(time.perf_counter() - t)
        return out

    PretrainEngine.generate_videos_synthesis = timed
    zero_launches()
    try:
        t0 = time.perf_counter()
        eng = evaluate.main(argv + [f"--init_weights={init}"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        PretrainEngine.generate_videos_synthesis = orig
    launches = read_launches()
    novel = os.path.join(eng.cfg.output_path, "novel_view")
    poses = np.load(os.path.join(novel, "novel_pose.npy"))
    shapes = {k: {cv2.imread(os.path.join(novel, f"{k}_{i}.png"), -1).shape
                  for i in range(VIDEO_N)} for k in ("rgb", "depth")}
    mp4 = sorted(f for f in os.listdir(eng.cfg.output_path)
                 if f.endswith(".mp4"))
    print(f"video: evaluate --video ({len(eng.eval_data)} eval frames, then "
          f"{VIDEO_N} orbit frames at {VIDEO_HW}x{VIDEO_HW}) {cli_s:.2f} s; the "
          f"orbit {video_s[0]:.2f} s = {VIDEO_N / video_s[0]:.3f} frames/s "
          f"(PNG writes included); launches {launches}; mp4 {mp4 or 'none'} "
          f"[{smi}]", flush=True)
    if launches["coarse_render_fwd"] <= 0:
        fail(f"the video did not launch coarse_render_fwd: {launches}")
    if (poses.shape != (VIDEO_N, 3, 4)
            or shapes != {"rgb": {(VIDEO_HW, VIDEO_HW, 3)},
                          "depth": {(VIDEO_HW, VIDEO_HW)}}):
        fail(f"video: novel_pose.npy {poses.shape}, PNGs {shapes}")

    # orbit frame 0 through the kernels against the plain route
    # (and through the two-kernel route, rows 7a + 9a, which the video
    # takes with --kernels.coarse_mega=false)
    frame = dict(eng.eval_frame(0), pose=torch.as_tensor(poses[:1],
                                                         device=eng.device))
    kn = eng.cfg.kernels
    with torch.inference_mode():
        k_out = eng._render_frame(frame)
        kn.coarse_mega = False
        zero_launches()
        two_out = eng._render_frame(frame)
        two = read_launches()
        kn.coarse_mega = True
        kn.fused_coarse = False
        p_out = eng._render_frame(frame)
        kn.fused_coarse = True
    for name, out in (("kernel", k_out), ("two-kernel", two_out)):
        errs = {k: float(((out[k] - p_out[k]).abs()
                          / p_out[k].abs().clamp(min=1.0)).max())
                for k in ("rgb", "depth", "opacity")}
        print(f"video: orbit frame 0 {name} vs plain route, max |err| / "
              f"max(|ref|, 1): {errs} (bound {RENDER_MAX_ERR})", flush=True)
        if not all(math.isfinite(v) and v <= RENDER_MAX_ERR
                   for v in errs.values()):
            fail(f"video: the {name} route disagrees with the plain route "
                 "on orbit frame 0")
    print(f"video: orbit frame 0 with --kernels.coarse_mega=false, "
          f"launches {two}", flush=True)
    if min(two["coarse_field_fwd"], two["composite_coarse_fwd"]) <= 0 \
            or two["coarse_render_fwd"]:
        fail(f"video: the two-kernel route did not launch rows 7a + 9a "
             f"alone: {two}")
    return launches


VIS_EVERY = 5             # --freq.vis of the phase's training runs
VIS_PRE_STEPS = 10
VIS_ENV_STEPS = 5
VIS_GAN_STEPS = 10
VIS_FRAMES = 2
VIS_CROP = 256            # render.vis_crop's default
KNN_P = 10_000            # points a side (the workload's ~1e4)
KNN_K = 4
KNN_RTOL = 1e-5


class _WatchVisualize:
    """Within ``with``: wraps ``cls.visualize`` and the render method it
    calls (``render``), and records per visualize call its wall time
    (ending in a sync), the kernel launches inside it — the wrappers'
    eager launches plus those of ``names`` inside graph replays (a device
    trace of the call: the render is a replayed frame program after its
    first capture) — and the render's float rgb."""

    def __init__(self, cls, render, names):
        self.cls, self.render, self.calls = cls, render, []
        self.names = names
        self._orig = (cls.__dict__["visualize"], cls.__dict__[render])
        self._outs = None

    def __enter__(self):
        import torch
        visualize, render = self._orig
        watch = self

        def watched(eng, it, split="train"):
            torch.cuda.synchronize()
            before = read_launches()
            watch._outs = []
            with replay_trace(watch.names) as replayed:
                t0 = time.perf_counter()
                visualize(eng, it, split)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            after = read_launches()
            watch.calls.append({
                "it": it, "s": secs, "rgb": watch._outs[-1],
                "launches": {k: after[k] - before[k] + replayed.get(k, 0)
                             for k in after}})
            watch._outs = None

        def rendered(eng, *args, **kw):
            out = render(eng, *args, **kw)
            if watch._outs is not None:
                watch._outs.append(out["rgb"].detach().clone())
            return out

        self.cls.visualize = watched
        setattr(self.cls, self.render, rendered)
        return self

    def __exit__(self, *exc):
        self.cls.visualize = self._orig[0]
        setattr(self.cls, self.render, self._orig[1])
        return False


def _check_panels(what, out_path, calls, names, every, steps):
    """visualize fired at every ``every`` steps and wrote each panel."""
    its = [c["it"] for c in calls]
    if its != list(range(every, steps + 1, every)):
        fail(f"{what}: visualize fired at {its}")
    vis_dir = os.path.join(out_path, "vis")
    missing = [f"{it:06d}_{n}.png" for it in its for n in names
               if not os.path.exists(os.path.join(vis_dir,
                                                  f"{it:06d}_{n}.png"))]
    if missing:
        fail(f"{what}: panels missing: {missing}")
    return vis_dir


def vis_phase(here, tmp, dev, smi):
    """visualize on the card in the pretrain, env and GAN train CLIs
    (freq.vis), the scene_vis export through the evaluate CLI, and the KNN
    against its CPU result.  Prints visualize's wall time per engine and
    the export's frames/s beside ``smi``."""
    import importlib.util

    import cv2
    import numpy as np
    import torch
    from texpose_tpu_torch import evaluate, train
    from texpose_tpu_torch.models.pretrain import PretrainEngine
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    from texpose_tpu_torch.ops.knn import chamfer_distance, knn_points
    from texpose_tpu_torch.utils.log import log

    pre_panels = ("image", "rgb", "image_masked", "pred_mask", "gt_mask",
                  "depth", "depth_gt", "depth_error", "z_near")
    gan_panels = ("image", "image_masked", "rgb", "rgb_static",
                  "rgb_transient", "pred_mask", "gt_mask", "depth",
                  "depth_gt", "z_near", "depth_error", "color_error",
                  "uncert")

    # the pretrain and env CLIs: row 8 renders eval frame 0 at each firing
    for env, steps in ((False, VIS_PRE_STEPS), (True, VIS_ENV_STEPS)):
        what = "vis_env" if env else "vis_pretrain"
        argv, _ = pretrain_argv(here, tmp, dev, steps, env=env, name=what,
                                extra=(f"--freq.vis={VIS_EVERY}",))
        with _WatchVisualize(PretrainEngine, "_render_frame",
                             ("coarse_render_fwd",)) as w:
            eng = train.main(argv)
        cfg = eng.cfg
        _check_panels(what, cfg.output_path, w.calls, pre_panels, VIS_EVERY,
                      steps)
        chunks = math.ceil(cfg.H * cfg.W / int(cfg.nerf.rand_rays))
        got = [c["launches"]["coarse_render_fwd"] for c in w.calls]
        print(f"{what}: visualize at steps {[c['it'] for c in w.calls]}, "
              f"{cfg.H}x{cfg.W} frame, wall s "
              f"{[round(c['s'], 4) for c in w.calls]}; coarse_render_fwd "
              f"launches {got} (want {chunks} each) [{smi}]", flush=True)
        if got != [chunks] * len(w.calls):
            fail(f"{what}: visualize launched row 8 {got} times, expected "
                 f"{chunks} a firing")

    # the GAN CLI: rows 1 + 3 render eval frame 0 at each firing
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    warns = []
    argv, _ = train_argv(here, tmp, dev, VIS_GAN_STEPS, out="vis_gan_out",
                         extra=(f"--freq.vis={VIS_EVERY}",))
    warn = log.warn
    log.warn = lambda msg: (warns.append(msg), warn(msg))
    try:
        with _WatchVisualize(TextureGANEngine, "_render_frame_st",
                             ("st_field_fwd", "composite_st_fwd")) as w:
            eng = train.main(argv)
    finally:
        log.warn = warn
    vis_dir = _check_panels("vis_gan", eng.cfg.output_path, w.calls,
                            gan_panels, VIS_EVERY, VIS_GAN_STEPS)
    cam = os.path.exists(os.path.join(vis_dir, "cameras.png"))
    cam_warns = [m for m in warns if "cameras.png" in m]
    print(f"vis_gan: visualize at steps {[c['it'] for c in w.calls]}, wall s "
          f"{[round(c['s'], 4) for c in w.calls]}; launches "
          f"{[{k: v for k, v in c['launches'].items() if v} for c in w.calls]}"
          f"; matplotlib {'found' if has_mpl else 'missing'}, cameras.png "
          f"{'written' if cam else 'absent'}, warnings {cam_warns} [{smi}]",
          flush=True)
    if any(min(c["launches"]["st_field_fwd"],
               c["launches"]["composite_st_fwd"]) <= 0 for c in w.calls):
        fail("vis_gan: visualize did not launch rows 1 and 3")
    if cam != has_mpl or len(cam_warns) != (0 if has_mpl else 1):
        fail("vis_gan: cameras.png must be written with matplotlib, or "
             "skipped with one warning without it")
    # the last firing's render (the weights after the last step) against
    # the plain twins on the same state
    frame = eng.eval_frame(0)
    with torch.inference_mode():
        eng.cfg.kernels.fused_st = False
        p_rgb = eng._render_frame_st(
            frame, eng.latents["trans"][0:1].detach(),
            eng.latents["light"][0:1].detach())["rgb"]
        eng.cfg.kernels.fused_st = True
    err = float((w.calls[-1]["rgb"] - p_rgb).abs().max())
    print(f"vis_gan: the step-{w.calls[-1]['it']} panel's rgb vs the plain "
          f"route on the same state, max|err|={err:.3g} (bound "
          f"{RENDER_MAX_ERR})", flush=True)
    if not err <= RENDER_MAX_ERR:
        fail("vis_gan: visualize's render disagrees with the plain route")

    # the scene_vis export: 256-px crops of the render, the GT and the depth
    argv = fixture_argv(here, tmp, dev, VIS_FRAMES, sub="vis")
    root = next(a.split("=", 1)[1] for a in argv
                if a.startswith("--data.root="))
    split = os.path.join(root, "splits", "lm", "ball")
    shutil.copytree(os.path.join(split, "scene_all"),
                    os.path.join(split, "scene_vis"), dirs_exist_ok=True)
    zero_launches()
    t0 = time.perf_counter()
    eng = evaluate.main(argv + ["--data.scene=scene_vis"])
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_launches()
    if min(launches["st_field_fwd"], launches["composite_st_fwd"]) <= 0:
        fail(f"scene_vis: the export did not launch rows 1 and 3: "
             f"{launches}")
    out_dir = os.path.join(eng.cfg.output_path, "test_view_last")
    files = sorted(os.listdir(out_dir))
    shapes = {cv2.imread(os.path.join(out_dir, f)).shape for f in files}
    kinds = {k: len([f for f in files if f.startswith(k)])
             for k in ("syn_", "depth_vis_")}
    if (len(files) != 3 * VIS_FRAMES or shapes != {(VIS_CROP, VIS_CROP, 3)}
            or kinds != {"syn_": VIS_FRAMES, "depth_vis_": VIS_FRAMES}):
        fail(f"scene_vis: export {files} {shapes}")
    rows = [ln.split() for ln in open(os.path.join(eng.cfg.output_path,
                                                   "quant.txt"))][1:]
    if len(rows) != VIS_FRAMES or not all(
            math.isfinite(float(v)) for r in rows for v in r[1:]):
        fail(f"scene_vis: quant.txt {rows}")
    frame = eng.eval_frame(0)
    sample = eng.eval_data[0]
    lt = np.zeros((1, int(eng.cfg.nerf.N_latent_trans)), np.float32)
    ll = eng.latents["light"][0:1]
    obj = torch.as_tensor(sample["obj_mask"].reshape(-1) > 0,
                          device=eng.device)
    with torch.inference_mode():
        k_out = eng._render_frame_st(frame, lt, ll,
                                     obj_host=sample["obj_mask"])
        eng.cfg.kernels.fused_st = False
        p_out = eng._render_frame_st(frame, lt, ll,
                                     obj_host=sample["obj_mask"])
        eng.cfg.kernels.fused_st = True
    err = float((k_out["rgb_static"][0][obj]
                 - p_out["rgb_static"][0][obj]).abs().max())
    t0 = time.perf_counter()
    eng.evaluate_full()
    torch.cuda.synchronize()
    fps = VIS_FRAMES / (time.perf_counter() - t0)
    print(f"scene_vis: evaluate (cold, {VIS_FRAMES} frames at "
          f"{eng.cfg.H}x{eng.cfg.W}) {cold_s:.2f} s; launches {launches}; "
          f"{len(files)} PNGs {sorted(shapes)}; quant {rows}; frame 0 "
          f"rgb_static kernel vs plain route max|err|={err:.3g} over "
          f"{int(obj.sum())} object pixels (bound {RENDER_MAX_ERR}); warm "
          f"export {fps:.3f} frames/s (PNG writes in) [{smi}]", flush=True)
    if not err <= RENDER_MAX_ERR:
        fail("scene_vis: the kernel route disagrees with the plain route "
             "on frame 0")

    # KNN on the card against the CPU: the same indices (ties included)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, KNN_P, 3)).astype(np.float32)
    y = rng.normal(size=(1, KNN_P, 3)).astype(np.float32)
    y[:, KNN_P // 2:KNN_P // 2 + 100] = y[:, :100]     # tied neighbours
    x[:, :50] = y[:, 20:70]
    xc, yc = torch.as_tensor(x), torch.as_tensor(y)
    d_cpu, i_cpu = knn_points(xc, yc, K=KNN_K)
    ch_cpu = chamfer_distance(xc, yc)
    xg, yg = xc.to(dev), yc.to(dev)
    knn_points(xg, yg, K=KNN_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_gpu, i_gpu = knn_points(xg, yg, K=KNN_K)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    ch_gpu = chamfer_distance(xg, yg)
    same = int((i_gpu.cpu() == i_cpu).all(dim=-1).sum())
    d_rel = float(((d_gpu.cpu() - d_cpu).abs()
                   / d_cpu.abs().clamp(min=1e-30)).max())
    ch_rel = abs(float(ch_gpu) - float(ch_cpu)) / abs(float(ch_cpu))
    print(f"knn: P={KNN_P} x {KNN_P}, K={KNN_K}: {same}/{KNN_P} rows with "
          f"the CPU's indices; distances max rel {d_rel:.3g}, chamfer rel "
          f"{ch_rel:.3g} (rtol {KNN_RTOL}); card knn_points "
          f"{knn_s * 1e3:.2f} ms (host clock, one call) [{smi}]", flush=True)
    if same != KNN_P or not (d_rel <= KNN_RTOL and ch_rel <= KNN_RTOL):
        fail("knn: the card's neighbours disagree with the CPU's")


DP_STEPS = 10              # steps of each CLI run in phase 12 (a)
DP_RANKS = 2
DP_RATE_STEPS = 10         # timed steps of the two-rank engines in (b)
DP_DEADLINE_S = 600        # (b) and (c) each; a rank that hangs is killed


class _AllReduceClock:
    """Wraps the engines' gradient all-reduce (models/base.py's
    ``all_reduce_grads``) to record its bytes and its host ms per call,
    synchronized on both sides so the host clock spans the collective."""

    def __init__(self, dev):
        self.dev = dev
        self.calls = []

    def __enter__(self):
        from texpose_tpu_torch.models import base
        real = self._real = base.all_reduce_grads

        def timed(params, mesh):
            _sync(self.dev)
            t0 = time.perf_counter()
            n = real(params, mesh)
            _sync(self.dev)
            self.calls.append((n, (time.perf_counter() - t0) * 1e3))
            return n

        base.all_reduce_grads = timed
        return self

    def __exit__(self, *exc):
        from texpose_tpu_torch.models import base
        base.all_reduce_grads = self._real
        return False

    def text(self, steps):
        """Bytes and host ms per step, over ``steps`` steps."""
        per = len(self.calls) // steps
        if not per or per * steps != len(self.calls):
            fail(f"{len(self.calls)} gradient all-reduces in {steps} steps")
        steps_ms = sorted(sum(ms for _, ms in self.calls[i:i + per])
                          for i in range(0, len(self.calls), per))
        nbytes = sum(n for n, _ in self.calls[:per])
        return (f"{nbytes} gradient bytes all-reduced a step in {per} "
                f"call(s), host ms a step median "
                f"{statistics.median(steps_ms):.3f} (min {steps_ms[0]:.3f}, "
                f"max {steps_ms[-1]:.3f})")


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_engine(argv, dev, mesh, eval_split=None):
    """An engine built from the CLI's argv as the entry points build it,
    with or without the mesh (weights from the seeded init, or from
    --init_weights)."""
    from texpose_tpu_torch.models import get_engine
    from texpose_tpu_torch.utils.config import set_options
    cfg = set_options(list(argv))
    eng = get_engine(cfg.model)(cfg, dev, mesh=mesh)
    if eval_split:
        eng.load_dataset(eval_split=eval_split)
        eng.build_networks()
        eng.load_initial_weights()
        return eng
    eng.load_dataset()
    eng.upload_train_split()
    eng.build_networks()
    eng.setup_optimizer()
    return eng


def _dp_grads(eng):
    if hasattr(eng, "opt_nerf"):
        return gan_grads(eng)
    return {k: p.grad.clone() for k, p in eng._all_params()}


def _dp_same_on_every_rank(eng, mesh):
    """Leaves of the train state (parameters, optimizer moments and counts,
    latent EMA, spectral-norm state) that differ from rank 0's."""
    import numpy as np
    import torch
    import torch.distributed as dist
    bad = []
    for k, v in sorted(eng.train_state_flat(0).items()):
        raw = np.atleast_1d(np.ascontiguousarray(v)).view(np.uint8)
        t = torch.from_numpy(raw.copy()).to(mesh.device)
        ref = t.clone()
        dist.broadcast(ref, 0)
        if not torch.equal(ref, t):
            bad.append(k)
    return bad


def _dp_rank(rank, world, init, backend, dev_kind, spec, out_json):
    """Phase 12 (b)/(c) on one rank: each training engine's step from one
    state and one set of global draws against a one-rank engine on the same
    card, the ranks' states after 3 steps, the warm two-rank rate, the
    sharded eval frame against the one-rank frame."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from texpose_tpu_torch.parallel.mesh import make_mesh
    dev = f"cuda:{rank}" if dev_kind == "cuda" and backend == "nccl" \
        else ("cuda:0" if dev_kind == "cuda" else "cpu")
    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(world, dev)
        res = {}
        for kind in ("pretrain", "gan"):
            one = _dp_engine(spec[kind], dev, None)
            eng = _dp_engine(spec[kind], dev, mesh)
            draws = one.make_draws(0)
            l1 = one.train_step(draws)
            g1 = _dp_grads(one)
            del one
            l2 = eng.train_step(draws)
            g2 = _dp_grads(eng)
            loss_err = max(abs(float(l2[k]) - float(l1[k]))
                           / max(abs(float(l1[k])), 1e-12) for k in l1)
            grad_err = {k: rel_norm(g2[k], g1[k]) for k in g1}
            worst = max(grad_err, key=grad_err.get)
            for _ in range(2):
                eng.train_step(eng.make_draws(eng.it))
            differ = _dp_same_on_every_rank(eng, mesh)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(DP_RATE_STEPS):
                eng.train_step(eng.make_draws(eng.it))
            _sync(dev)
            rate = DP_RATE_STEPS / (time.perf_counter() - t0)
            with _AllReduceClock(dev) as clock:
                for _ in range(DP_RATE_STEPS):
                    eng.train_step(eng.make_draws(eng.it))
            res[kind] = {"loss_rel": loss_err, "grad_rel": grad_err[worst],
                         "worst": worst, "differ": differ,
                         "steps_s": rate, "all_reduce":
                         clock.text(DP_RATE_STEPS),
                         "losses": {k: float(v) for k, v in l2.items()}}
            del eng
            if torch.device(dev).type == "cuda":
                torch.cuda.empty_cache()
        # the eval frame: the sharded masked route against one rank
        engs = [_dp_engine(spec["eval"], dev, m, eval_split="test")
                for m in (mesh, None)]
        sample = engs[0].eval_data[0]
        frame = engs[0].eval_frame(0)
        lt = np.zeros((1, int(engs[0].cfg.nerf.N_latent_trans)), np.float32)
        ll = engs[0].latents["light"][0:1]
        with torch.inference_mode():
            outs = [e._render_frame_st(frame, lt, ll,
                                       obj_host=sample["obj_mask"])
                    for e in engs]
            _sync(dev)
            t0 = time.perf_counter()
            engs[0]._render_frame_st(frame, lt, ll,
                                     obj_host=sample["obj_mask"])
            _sync(dev)
            frame_ms = (time.perf_counter() - t0) * 1e3
        obj = sample["obj_mask"].reshape(-1) > 0
        res["eval"] = {
            "hw": [engs[0].cfg.H, engs[0].cfg.W],
            "err": max(float((outs[0][k] - outs[1][k]).abs().max())
                       for k in outs[1]),
            "object_pixels": int(obj.sum()), "frame_ms": frame_ms,
            "coverage": float(obj.mean())}
        if rank == 0:
            with open(out_json, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _dp_spawn(tmp, backend, dev_kind, spec, what):
    """Run _dp_rank in DP_RANKS spawned processes → rank 0's results."""
    import torch.multiprocessing as mp
    out_json = os.path.join(tmp, f"dp_{what}.json")
    init = f"file://{os.path.join(tmp, f'dp_{what}_rendezvous')}"
    t0 = time.perf_counter()
    ctx = mp.start_processes(_dp_rank, args=(DP_RANKS, init, backend,
                                             dev_kind, spec, out_json),
                             nprocs=DP_RANKS, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > DP_DEADLINE_S:
                for p in ctx.processes:
                    p.kill()
                fail(f"dp ({what}): the ranks did not finish in "
                     f"{DP_DEADLINE_S} s")
    except (mp.ProcessExitedException, mp.ProcessRaisedException) as e:
        fail(f"dp ({what}): a rank failed: {e}")
    with open(out_json) as f:
        res = json.load(f)
    res["wall_s"] = time.perf_counter() - t0
    return res


def _dp_check(res, what, smi, label):
    """Holds (b)/(c)'s results to route_check's bounds and RENDER_MAX_ERR
    and prints them."""
    for kind in ("pretrain", "gan"):
        r = res[kind]
        print(f"dp ({what}) {kind}: {DP_RANKS}-rank step vs one rank, one "
              f"state and one set of global draws: worst loss rel "
              f"{r['loss_rel']:.3g} (bound {ROUTE_LOSS_RTOL}); worst "
              f"gradient ‖err‖/‖ref‖ {r['grad_rel']:.3g} at {r['worst']} "
              f"(bound {ROUTE_GRAD_NORM}); state leaves differing across "
              f"ranks after 3 steps: {r['differ']}; {r['all_reduce']}; "
              f"{r['steps_s']:.3f} steps/s {label} [{smi}]", flush=True)
        if not (r["loss_rel"] <= ROUTE_LOSS_RTOL
                and r["grad_rel"] <= ROUTE_GRAD_NORM):
            fail(f"dp ({what}) {kind}: the {DP_RANKS}-rank step disagrees "
                 "with the one-rank step")
        if r["differ"]:
            fail(f"dp ({what}) {kind}: the ranks' states differ after 3 "
                 f"steps: {r['differ']}")
    e = res["eval"]
    print(f"dp ({what}) eval: frame 0 at {e['hw'][0]}x{e['hw'][1]}, "
          f"{e['object_pixels']} "
          f"object pixels (coverage {e['coverage']:.4f}, sharded masked "
          f"route), {DP_RANKS} ranks vs one rank max|err| {e['err']:.3g} "
          f"(bound {RENDER_MAX_ERR}); the {DP_RANKS}-rank frame "
          f"{e['frame_ms']:.2f} ms host clock {label}; phase wall "
          f"{res['wall_s']:.1f} s [{smi}]", flush=True)
    if not e["err"] <= RENDER_MAX_ERR:
        fail(f"dp ({what}) eval: the sharded frame disagrees with one rank")


def dp_phase(here, tmp, dev, smi):
    """Phase 12, data parallelism: (a) the pretrain, GAN train and eval
    CLIs with --mesh.dp=true under torchrun's environment at world size 1
    (NCCL on the card), (b) two spawned ranks on one card over gloo,
    driving the engines, (c) NCCL across two cards where two are
    visible."""
    import numpy as np
    import torch
    from texpose_tpu_torch import evaluate, train
    from texpose_tpu_torch.utils.checkpoint import load_checkpoint_flat

    pre_argv, _ = pretrain_argv(here, tmp, dev, DP_STEPS, name="dp_pre",
                                extra=("--mesh.dp=true",))
    gan_argv, _ = train_argv(here, tmp, dev, DP_STEPS, out="dp_gan_out",
                             extra=("--mesh.dp=true",))
    eval_argv = fixture_argv(here, tmp, dev, 1, sub="dp") \
        + ["--mesh.dp=true"]

    # (a) the CLIs under torchrun's environment, world size 1
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for what, argv, rows in (
                ("pretrain", pre_argv, ("coarse_render_fwd",
                                        "composite_coarse_bwd",
                                        "coarse_field_bwd") + DW_KERNELS),
                ("gan", gan_argv, TEXTURE_KERNELS)):
            zero_launches()
            with _AllReduceClock(dev) as clock:
                t0 = time.perf_counter()
                eng = train.main(argv)
                _sync(dev)
                wall = time.perf_counter() - t0
            launches = read_launches()
            cfg = eng.cfg
            files = sorted(os.listdir(cfg.output_path))
            print(f"dp (a) {what}: train CLI --mesh.dp=true under torchrun's "
                  f"environment, world size 1 ({eng.mesh}), {DP_STEPS} steps "
                  f"{wall:.2f} s cold; launches "
                  f"{ {k: launches[k] for k in rows} }; rank 0 wrote "
                  f"{files}; losses {_train_losses(cfg, DP_STEPS)}; "
                  f"{clock.text(DP_STEPS)} [{smi}]", flush=True)
            if eng.mesh is None or eng.mesh.size != 1:
                fail(f"dp (a) {what}: the run did not join the group")
            if min(launches[k] for k in rows) <= 0:
                fail(f"dp (a) {what}: the path did not launch {rows}: "
                     f"{launches}")
            if not {"model.ckpt", "options.yaml", "metrics.jsonl"} <= set(
                    files):
                fail(f"dp (a) {what}: rank 0 did not write its files: "
                     f"{files}")
            flat = load_checkpoint_flat(os.path.join(cfg.output_path,
                                                     "model.ckpt"))
            if int(flat["step"]) != DP_STEPS:
                fail(f"dp (a) {what}: model.ckpt at step {flat['step']}")
        zero_launches()
        t0 = time.perf_counter()
        ev = evaluate.main(eval_argv)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = read_launches()
        q = [ln.split() for ln in open(os.path.join(ev.cfg.output_path,
                                                    "quant.txt"))][1:]
        obj = int((np.asarray(ev.eval_data[0]["obj_mask"]) > 0).sum())
        print(f"dp (a) eval: evaluate CLI --mesh.dp=true, frame 0 at "
              f"{ev.cfg.H}x{ev.cfg.W} ({obj} object pixels) {wall:.2f} s "
              f"cold; launches { {k: launches[k] for k in ('st_field_fwd', 'composite_st_fwd')} }; "
              f"quant {q} [{smi}]", flush=True)
        if ev.mesh is None or min(launches["st_field_fwd"],
                                  launches["composite_st_fwd"]) <= 0:
            fail(f"dp (a) eval: rows 1 and 3 not launched under the mesh: "
                 f"{launches}")
        if len(q) != 1 or not all(math.isfinite(float(v)) for v in q[0][1:]):
            fail(f"dp (a) eval: quant.txt {q}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # (b) two ranks on one card, gloo on CUDA tensors, the engines driven
    # directly from the same argv; the kernels were built above
    dev_kind = torch.device(dev).type
    spec = {"pretrain": pre_argv, "gan": gan_argv,
            "eval": [a for a in eval_argv if a != "--mesh.dp=true"]}
    res = _dp_spawn(tmp, "gloo", dev_kind, spec, "b")
    _dp_check(res, "b", smi, f"(two ranks sharing one card over a host "
              f"collective: not a data-parallel rate)")

    # (c) NCCL, one rank per card, where two cards are visible
    cards = torch.cuda.device_count() if dev_kind == "cuda" else 0
    if cards >= DP_RANKS:
        res = _dp_spawn(tmp, "nccl", dev_kind, spec, "c")
        _dp_check(res, "c", smi, f"({DP_RANKS} ranks on {DP_RANKS} cards, "
                  "NCCL)")
    else:
        print(f"dp (c): NCCL across {DP_RANKS} ranks on {DP_RANKS} cards did "
              f"not run: torch.cuda.device_count() = {cards} on this "
              f"machine [{smi}]", flush=True)

# the scan phase: the captured training step (models/step_graph.py)
SCAN_K = 20                 # steps per captured dispatch
SCAN_DISPATCHES = 3
# a replayed step against an eager step from one state: the kernels' f32
# atomics (db and the latent-row sums of rows 2, 6b and 7b) make two eager
# steps from one state part by ~1e-6 of a leaf's largest value (0.85e-6
# to 1.7e-6 on an H100 at 700 W), and that noise grows past 0.1 in 60 steps,
# so the trajectories are printed beside an eager-vs-eager control and the
# bound holds the one-step difference; a stale pack, rate, count or draw
# errs by an update (≥ 1e-4)
SCAN_RTOL = 1e-5
SCAN_ROUNDS = 3             # one-step comparisons from one state
SCAN_TIMED = 20             # steps per timed turn
SCAN_PROFILED = 10          # steps per profiled window
HYBRID_KERNELS = ("st_render_fwd", "composite_st_bwd",
                  "st_field_bwd") + DW_KERNELS


def engine_from_argv(argv, extra=()):
    """The engine the train CLI builds from ``argv`` (+ ``extra``), set up
    and restored as ``train.main`` does, without training."""
    from texpose_tpu_torch.models import get_engine
    from texpose_tpu_torch.models.base import resolve_device
    from texpose_tpu_torch.utils.config import set_options
    cfg = set_options(list(argv) + list(extra))
    eng = get_engine(cfg.model)(cfg, resolve_device(cfg))
    eng.load_dataset()
    eng.upload_train_split()
    eng.build_networks()
    eng.setup_optimizer()
    if cfg.get("resume_pretrain"):
        eng.restore_pretrained_checkpoint()
    eng.restore_checkpoint()
    return eng


def state_delta(a, b):
    """max |Δ| and max |Δ|/max|a| over every leaf of two engines' train
    states (parameters, latents, both moments, the counts), and how many
    leaves differ at all."""
    import numpy as np
    fa, fb = a.train_state_flat(a.it), b.train_state_flat(b.it)
    if sorted(fa) != sorted(fb):
        fail(f"scan: the train states hold other leaves: "
             f"{sorted(set(fa) ^ set(fb))}")
    worst = rel = 0.0
    differ = []
    for k in fa:
        x = np.asarray(fa[k], np.float64)
        y = np.asarray(fb[k], np.float64)
        d = float(np.abs(x - y).max()) if x.size else 0.0
        worst = max(worst, d)
        rel = max(rel, d / max(float(np.abs(x).max()) if x.size else 0.0,
                               1e-30))
        if not np.array_equal(fa[k], fb[k]):
            differ.append(k)
    return worst, rel, differ, len(fa)


def _profiled_steps(run, n):
    """One profiled window of ``n`` steps → per step: host wall ms, device
    busy ms (the union of its kernels and copies), host kernel and graph
    launches, and the idle share 1 − busy/wall."""
    import torch
    from torch.profiler import ProfilerActivity
    run(2)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    tool = profile_tool()
    busy = tool._union_ms(tool._device_intervals(prof))
    events = tool.trace_events(prof)
    cpu = [e[2] for e in events if e[0] == DeviceType.CPU]
    kern = sum(c.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
               for c in cpu)
    graphs = sum(c.startswith(("cudaGraphLaunch", "cuGraphLaunch"))
                 for c in cpu)
    return {"wall_ms": wall / n, "busy_ms": busy / n,
            "idle": 1 - busy / wall, "kernel_launches": kern / n,
            "graph_launches": graphs / n}


def _same_state(dst, src):
    """Load ``src``'s whole train state and draw generator into ``dst``."""
    dst.load_train_state_flat(src.train_state_flat(src.it))
    dst.draw_gen.set_state(src.draw_gen.get_state())


def _loss_rel(a, b):
    return max(abs(float(a[k]) - float(b[k])) / max(abs(float(a[k])), 1e-30)
               for k in a)


def scan_route(what, argv, kernels, smi):
    """One route of the scan phase (see the module's docstring) → its
    readings; failures are returned in ``bad``, so one call reads every
    route."""
    import numpy as np
    import torch
    bad = []
    n = SCAN_K * SCAN_DISPATCHES
    eager, capt = engine_from_argv(argv), engine_from_argv(argv)
    twin = engine_from_argv(argv)
    runner = capt.step_runner()
    # (a) the trajectories: eager, captured, and eager again
    for i in range(n):
        if i == n - 1:
            zero_launches()
        eager.train_step(eager.make_draws(eager.it))
    torch.cuda.synchronize()
    per_step = read_launches()
    for _ in range(n):
        twin.train_step(twin.make_draws(twin.it))
    runner.dispatch(SCAN_K)
    zero_launches()
    with replay_trace(kernels) as replayed:
        for _ in range(SCAN_DISPATCHES - 1):
            runner.dispatch(SCAN_K)
    host = {k: n for k, n in read_launches().items() if n}
    counts = (eager.it, int(eager.it_dev), capt.it, int(capt.it_dev))
    traj = state_delta(eager, capt)[1], state_delta(eager, twin)[1]
    # (b) one step from one state, SCAN_ROUNDS times: a replay and
    # an eager step against two eager steps
    rounds = []
    for _ in range(SCAN_ROUNDS):
        _same_state(eager, capt)
        _same_state(twin, capt)
        l_e = eager.train_step(eager.make_draws(eager.it))
        l_t = twin.train_step(twin.make_draws(twin.it))
        l_c = runner.dispatch(1)
        torch.cuda.synchronize()
        rounds.append((state_delta(eager, capt), _loss_rel(l_e, l_c),
                       state_delta(eager, twin), _loss_rel(l_e, l_t)))
    if runner.graph is None or runner.captures != 1:
        bad.append(f"scan {what}: the runner did not capture the step once "
                   f"({runner.captures} captures)")
    n_rep = SCAN_K * (SCAN_DISPATCHES - 1)
    short = [k for k in kernels if per_step[k] <= 0
             or replayed[k] != n_rep * per_step[k]]
    if short or host:
        bad.append(f"scan {what}: the device trace of {n_rep} replays holds "
                   f"not {n_rep}x one eager step's launches of {short}, or "
                   f"a wrapper launched in them ({host}); replays "
                   f"{replayed}, one eager step {per_step}")
    if len(set(counts)) != 1 or counts[0] != n:
        bad.append(f"scan {what}: counts {counts} after {n} steps")
    one = max(r[0][1] for r in rounds), max(r[1] for r in rounds)
    noise = max(r[2][1] for r in rounds), max(r[3] for r in rounds)
    equal = sum(not r[0][2] for r in rounds)
    print(f"scan {what}: {n} eager steps vs {SCAN_DISPATCHES} captured "
          f"dispatches of {SCAN_K}: train state max |d|/max|x| "
          f"{traj[0]:.3g} (eager vs eager {traj[1]:.3g}); counts {counts}; "
          f"kernels in the device trace of the last {n_rep} replays "
          f"{ {k: replayed[k] for k in kernels} } (one eager step "
          f"{ {k: per_step[k] for k in kernels} })", flush=True)
    print(f"scan {what}: one step from one state x {SCAN_ROUNDS}: replay vs "
          f"eager state {one[0]:.3g}, losses {one[1]:.3g} "
          f"({equal}/{SCAN_ROUNDS} bit-equal; max |d| "
          f"{max(r[0][0] for r in rounds):.3g}); eager vs eager state "
          f"{noise[0]:.3g}, losses {noise[1]:.3g} (bound {SCAN_RTOL})",
          flush=True)
    if max(one) > SCAN_RTOL:
        bad.append(f"scan {what}: a replayed step parts from the eager step "
                   f"from one state by {one} (eager vs eager {noise})")

    # the packs after a dispatch: validate against a reloaded engine
    del twin
    v_capt = capt.validate(capt.it)
    capt.save_checkpoint(capt.it)
    fresh = engine_from_argv(argv, ("--resume",))
    v_fresh = fresh.validate(fresh.it)
    print(f"scan {what}: validate after the dispatch {v_capt}; fresh "
          f"engine from its checkpoint (step {fresh.start_step}) "
          f"{v_fresh}", flush=True)
    if fresh.start_step != capt.it or v_capt != v_fresh:
        bad.append(f"scan {what}: validate after a captured dispatch "
                   "differs from a reloaded engine's")
    del fresh

    # eager against captured in turns
    def run_eager(k):
        for _ in range(k):
            eager.train_step(eager.make_draws(eager.it))

    def run_capt(k):
        runner.dispatch(k)

    rates = []
    for name, run in (("eager", run_eager), ("captured", run_capt),
                      ("captured", run_capt), ("eager", run_eager)):
        run(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(SCAN_TIMED)
        torch.cuda.synchronize()
        rates.append((name, SCAN_TIMED / (time.perf_counter() - t0)))
    prof = {"eager": _profiled_steps(run_eager, SCAN_PROFILED),
            "captured": _profiled_steps(run_capt, SCAN_PROFILED)}
    if runner.captures != 1:
        bad.append(f"scan {what}: the timed dispatches captured again")
    e = float(np.mean([r for k, r in rates if k == "eager"]))
    c = float(np.mean([r for k, r in rates if k == "captured"]))
    print(f"scan {what}: warm steps/s in turns "
          + ", ".join(f"{k} {r:.3f}" for k, r in rates)
          + f" (eager {e:.3f}, captured {c:.3f}; {smi})", flush=True)
    for k, p in prof.items():
        print(f"scan {what}: {k} profiled {SCAN_PROFILED} steps: "
              f"{p['wall_ms']:.3f} ms/step wall, device busy "
              f"{p['busy_ms']:.3f} ms/step, idle {100 * p['idle']:.1f} %, "
              f"{p['kernel_launches']:.0f} kernel + "
              f"{p['graph_launches']:.0f} graph launches/step ({smi})",
              flush=True)
    return {"eager_steps_s": e, "captured_steps_s": c, "turns": rates,
            "profile": prof, "one_step_rel": one, "eager_noise_rel": noise,
            "trajectory_rel": traj, "bad": bad}


def scan_phase(here, tmp, dev, smi):
    """The captured training step (models/step_graph.py) on four routes at
    full width: the GAN's two-kernel route, kernels.st_mega with the
    hybrid backward, the default pretrain and the hierarchical pretrain
    (``scan_route``), under cudnn's deterministic algorithms."""
    import torch
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    big = f"--max_iter={10 * SCAN_K * SCAN_DISPATCHES}"
    out = {}
    try:
        gan, _ = train_argv(here, tmp, dev, 1, out="scan_gan",
                            extra=(big,))
        out["gan"] = scan_route("gan", gan, TEXTURE_KERNELS, smi)
        mega, _ = train_argv(here, tmp, dev, 1, out="scan_mega",
                             extra=(big, "--kernels.st_mega=true"))
        out["st_mega"] = _with_env(
            "TEXPOSE_MEGA_FULLBWD", "0", lambda: scan_route(
                "st_mega (hybrid backward)", mega, HYBRID_KERNELS, smi))
        pre, _ = pretrain_argv(here, tmp, dev, 1, name="scan_pre",
                               extra=(big,))
        out["pretrain"] = scan_route("pretrain", pre, PRETRAIN_KERNELS,
                                     smi)
        hier, _ = pretrain_argv(here, tmp, dev, 1, name="scan_hier", extra=(
            big, "--nerf.fine_sampling=true",
            f"--nerf.sample_intvs_fine={N_FINE}",
            "--loss_weight.render_fine=0"))
        out["hierarchical"] = scan_route("hierarchical", hier, FIELD_KERNELS,
                                         smi)
    finally:
        torch.backends.cudnn.deterministic = was
    print("scan: " + json.dumps({k: {kk: vv for kk, vv in v.items()
                                     if kk not in ("turns", "bad")}
                                 for k, v in out.items()}), flush=True)
    bad = [b for v in out.values() for b in v["bad"]]
    if bad:
        fail("; ".join(bad))
    return out


# tools/tpu_quality_check.py's pretrain default (its PSNR gate needs the
# steps); its GAN's 2000 cut to 1000, which keeps the whole command
# within ~120 s of phase 12's end (the GAN gate is finite losses)
QUAL_PRETRAIN_STEPS = 4000
QUAL_GAN_STEPS = 1000
TRAJ_PRETRAIN_STEPS = 200
TRAJ_GAN_STEPS = 50
# Bounds of the kernel vs plain trajectories (phase 13 (b)), from one
# state and one set of draws.  One step agrees within ROUTE_LOSS_RTOL; over
# many Adam steps the two routes' summation orders part the trajectories
# the way two seeds do, without a sign.  Measured on the H100 (two calls):
# median rel 3.6e-4 / 4.4e-4 (pretrain), 1.0e-3 / 1.6e-3 (GAN); a loss's
# worst step ≤ 0.032 (pretrain) and ≤ 0.086 (GAN) of its mean size, its
# last-half signed mean ≤ 1.3e-3 / 1.5e-2 of it; |dPSNR| 0.008-0.032 /
# 0.004-0.069 dB.  Each bound is ≥ 4x the largest reading, and a fault that
# shifts a loss by a tenth of its size, or costs a quarter dB in 50 steps,
# crosses it.  The R1 penalty (gan_reg_real, ≈ 0.005 and spiky: its worst
# step read 1.5x its mean, its signed mean -0.10) is held to the median
# only.
TRAJ_LOSS_MEDIAN = 1e-2        # median rel over the run's steps and losses
TRAJ_LOSS_DEV = 0.5            # a loss's worst step, in its mean size
TRAJ_LOSS_BIAS = 0.1           # a loss's signed mean over the last half
TRAJ_PSNR_DB = 0.3             # |dPSNR| of the end states' evaluate_full
TRAJ_SPIKY = ("gan_reg_real",)


def _launches_of(fn):
    """(fn()'s result, the launch counts of that call)."""
    import torch
    zero_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, read_launches()


def _trajectory(eng, switch, steps, what, smi):
    """``steps`` steps from one state and one set of draws per step through
    the kernels and through the plain route (cfg.kernels.<switch> off):
    the per-step relative loss differences, and the end states'
    evaluate_full PSNR, both states evaluated through the kernels."""
    import numpy as np
    start = eng.train_state_flat(0)
    draws = [eng.make_draws(eng.it + i) for i in range(steps)]
    runs = {}
    for route in ("kernels", "plain"):
        eng.load_train_state_flat(start)
        was = eng.cfg.kernels.get(switch)
        if route == "plain":
            setattr(eng.cfg.kernels, switch, False)
        try:
            losses = [eng.train_step(d) for d in draws]
        finally:
            setattr(eng.cfg.kernels, switch, was)
        runs[route] = ([{k: float(v) for k, v in ls.items()}
                        for ls in losses], eng.train_state_flat(0))
    names = list(runs["plain"][0][0])
    k = np.array([[r[n] for n in names] for r in runs["kernels"][0]])
    p = np.array([[r[n] for n in names] for r in runs["plain"][0]])
    rel = np.abs(k - p) / np.maximum(np.abs(p), 1e-12)     # [step, loss]
    # each loss's worst step and its signed mean over the last half, in
    # units of that loss's mean size over the run (the small GAN terms
    # pass near zero, where a step's own relative difference is noise); a
    # bias keeps one sign
    scale = np.maximum(np.abs(p).mean(axis=0), 1e-12)
    worst_dev = np.abs(k - p).max(axis=0) / scale
    bias = (k - p)[steps // 2:].mean(axis=0) / scale
    held = [i for i, n in enumerate(names) if n not in TRAJ_SPIKY]
    psnr = {}
    for route in ("kernels", "plain"):
        eng.load_train_state_flat(runs[route][1])
        psnr[route] = eng.evaluate_full()["psnr"]
    eng.load_train_state_flat(start)
    marks = sorted({s for s in (1, 2, 5, 10, 20, steps // 2, steps)
                    if 1 <= s <= steps})
    dpsnr = abs(psnr["kernels"] - psnr["plain"])
    per_loss = {n: (float(f"{d:.3g}"), float(f"{b:.3g}"))
                for n, d, b in zip(names, worst_dev, bias)}
    print(f"quality (b) {what}: {steps} steps kernels vs plain "
          f"(kernels.{switch}) from one state and one set of draws: median "
          f"loss rel over steps and losses {float(np.median(rel)):.3g} "
          f"(bound {TRAJ_LOSS_MEDIAN}); worst loss rel at steps {marks}: "
          f"{[float(f'{rel[s - 1].max():.3g}') for s in marks]}; per loss "
          f"(worst |d| / mean, last-half signed mean / mean; bounds "
          f"{TRAJ_LOSS_DEV}, {TRAJ_LOSS_BIAS} but for {TRAJ_SPIKY}): "
          f"{per_loss}; "
          f"plain 'all' {p[0, names.index('all')]:.4f} -> "
          f"{p[-1, names.index('all')]:.4f}; evaluate_full PSNR of the end "
          f"states {psnr['kernels']:.4f} (kernels) vs {psnr['plain']:.4f} "
          f"(plain), |d| {dpsnr:.4f} dB (bound {TRAJ_PSNR_DB}) [{smi}]",
          flush=True)
    if not (np.isfinite(rel).all() and np.median(rel) <= TRAJ_LOSS_MEDIAN
            and worst_dev[held].max() <= TRAJ_LOSS_DEV
            and np.abs(bias[held]).max() <= TRAJ_LOSS_BIAS
            and dpsnr <= TRAJ_PSNR_DB):
        fail(f"quality (b) {what}: the kernel trajectory leaves the plain "
             "route's")


# Phase 13 (d) and tools/probe_f6.py (c): a training step's kernels held
# against their twins at a trained state, each on the inputs the step
# gives it.  Beside each check, the regime the state puts the kernels in,
# from T, a ray's transmittance into its last (1e10) interval: the share
# of opaque rays (opacity over the other intervals 1 − T > OPACITY_FULL)
# and the rays that reach the last interval (T ≥ LAST_REACH).
OPACITY_FULL = 0.999
LAST_REACH = 1e-6
GAN_TWINS = ("st_field_fwd", "composite_st_fwd", "composite_st_bwd",
             "st_field_bwd", "dw_pair")
PRETRAIN_TWINS = ("coarse_render_fwd", "composite_coarse_bwd",
                  "coarse_field_bwd", "dw_pair")


def _last_interval(regime, dens_raw, dist, extra=None):
    """The regime's opaque share and the rays reaching the last interval:
    T from the softplus densities (plus ``extra``, the transient's) times
    the intervals, summed over all but the last sample."""
    import torch
    from texpose_tpu_torch.nn.mlp import softplus
    BR, N = dist.shape
    sd = softplus(dens_raw.float()[:, 0]).reshape(BR, N) * dist
    if extra is not None:
        sd = sd + softplus(extra.float()).reshape(BR, N) * dist
    T = torch.exp(-sd[:, :-1].sum(1))
    regime.update(opaque_share=float((1 - T > OPACITY_FULL).float().mean()),
                  reach_last=int((T >= LAST_REACH).sum()), rays=BR)


def _amax(t):
    return float(t.abs().max())


def _raw_stats(got, ref):
    """(max |err|, largest mean |err|, max |err| / max(|ref|, 1)) over the
    raw outputs."""
    errs = [(a.float() - b.float()).abs() for a, b in zip(got, ref)]
    return (max(float(e.max()) for e in errs),
            max(float(e.mean()) for e in errs),
            max(float((e / b.float().abs().clamp(min=1.0)).max())
                for e, b in zip(errs, ref)))


def _res_stats(acts, ref):
    """(max |err| / max(|ref|, 1), largest mean |err|) of residual
    activations."""
    rel = mean = 0.0
    for a, b in zip(acts, ref):
        e = (a.float() - b.float()).abs()
        rel = max(rel, float((e / b.float().abs().clamp(min=1.0)).max()))
        mean = max(mean, float(e.mean()))
    return rel, mean


def scale_bound(kernel, twin, exact):
    """C1's end-to-end bound of a field forward at a trained state, over
    matching tensors (each side's, and the twin's with f64 sums) → the
    worst of {"scale_rel": max|kernel − twin| / max|twin|, "f64_ratio":
    the larger of d_k / d_t and d_t / d_k}, d_k and d_t each side's max
    |· − exact|.  Distances under one f32 rounding of the scale
    (2^-24·max|twin|) count as that rounding, so two sides that both sit
    on the f64 sums read 1."""
    rel = ratio = 0.0
    for k, t, e in zip(kernel, twin, exact):
        k, t, e = k.double(), t.double(), e.double()
        scale = float(t.abs().max())
        rel = max(rel, float((k - t).abs().max()) / max(scale, 1e-30))
        d_k, d_t = float((k - e).abs().max()), float((t - e).abs().max())
        floor = max(scale * 2.0 ** -24, 1e-30)
        ratio = max(ratio, max(d_k, d_t, floor) / max(min(d_k, d_t), floor))
    return {"scale_rel": rel, "f64_ratio": ratio}


def _scale_row(kernel, twin, exact, what):
    """``scale_bound`` over ``what``'s tensors as row statistics and their
    bounds (SCALE_REL, F64_RATIO)."""
    got = scale_bound(kernel, twin, exact)
    return ({f"e2e_{what}_{k}": v for k, v in got.items()},
            {f"e2e_{what}_scale_rel": SCALE_REL,
             f"e2e_{what}_f64_ratio": F64_RATIO})


def _grad_stats(got, ref):
    """(worst tensor ‖err‖/‖ref‖, max|err|/max|ref|, max |err|)."""
    return (max(rel_norm(a, b) for a, b in zip(got, ref)),
            max(rel_max(a, b) for a, b in zip(got, ref)),
            max(float((a - b).abs().max()) for a, b in zip(got, ref)))


def _row(rows, kernel, stats, bounds):
    """One check: each statistic beside its bound; ok when none is past."""
    rows.append({"kernel": kernel, **{k: float(v) for k, v in stats.items()},
                 "bounds": bounds,
                 "ok": all(stats[k] <= b for k, b in bounds.items())})


@contextlib.contextmanager
def f64_sums():
    """While open, the plain twins keep their bf16 rounding points but hold
    every value in float64, so each matmul sums exactly (to f64): the
    reference that tells a kernel's summation error from its twin's."""
    import torch
    from texpose_tpu_torch.kernels import coarse_field as cf
    from texpose_tpu_torch.kernels import st_field as sf
    from texpose_tpu_torch.kernels import trunk as tk

    def round64(x, compute_dtype):
        if compute_dtype is None or compute_dtype == torch.float32:
            return x.double()
        return x.to(compute_dtype).double()

    saved = [(m, m.round_to) for m in (cf, sf, tk)]
    for m, _ in saved:
        m.round_to = round64
    try:
        yield
    finally:
        for m, real in saved:
            m.round_to = real


def _vs_f64(got, ref, exact, what):
    """Each side's largest and mean |err| against the f64-sum twin over
    ``what`` (the kernel's, then the twin's)."""
    out = {}
    for side, xs in (("", got), ("twin_", ref)):
        errs = [(a.double() - e).abs() for a, e in zip(xs, exact)]
        out[f"{side}{what}_max_vs_f64"] = max(float(e.max()) for e in errs)
        out[f"{side}{what}_mean_vs_f64"] = max(float(e.mean())
                                               for e in errs)
    return out


def _st_planes(args, kwargs):
    """Row 1's staged inputs and every hidden layer's activations as the
    kernel computes them → (walk, xe, lrow, trow, {plane: walk layer},
    {plane: [M, 256] bf16}, the raw outputs).  On the card a measurement
    launch of the kernel (counted nowhere) stores each hidden layer's
    output as a residual plane; on the CPU the planes are the plain walk's
    (``walk_plain``)."""
    import torch
    from texpose_tpu_torch.kernels import _build, field_fwd
    from texpose_tpu_torch.kernels import st_field as sf
    xext, encpts, light, trans, weights, rpi = args[:6]
    cdt = args[6] if len(args) > 6 else kwargs.get("compute_dtype",
                                                   torch.bfloat16)
    walk = weights.fwd_walk(xext.shape[1], encpts.shape[1])
    lrow, trow = (r.float().contiguous() for r in sf._latent_rows(
        weights, light, trans, encpts.shape[1], cdt))
    xe = sf.stage_rows(xext, encpts, walk.kx, walk.ke)
    hidden = [j for j, layer in enumerate(walk.layers) if layer.rows]
    pmap = {j: p for p, j in enumerate(hidden)}
    M, dev = xext.shape[0], xext.device
    if dev.type != "cuda":
        raw, res = field_fwd.walk_plain(walk, xe, lrow, trow, rpi, pmap)
        return (walk, xe, lrow, trow, pmap, res,
                (raw[field_fwd.NOUT_RGB], raw[field_fwd.NOUT_DENS],
                 raw[field_fwd.NOUT_TRANS]))
    out = [torch.empty((M, n), dtype=torch.float32, device=dev)
           for n in (3, 1, 5)]
    planes = torch.empty((len(hidden), M, field_fwd.HIDDEN),
                         dtype=torch.bfloat16, device=dev)
    _build.check(field_fwd.launch(
        _build.load("st_field", sf._ARGTYPES).st_field_fwd, walk, xe, pmap,
        n_res=len(hidden), rows_per_img=rpi, n_img=lrow.shape[0],
        stream=_build.stream_ptr(dev), lrow=lrow, trow=trow, rgb=out[0],
        dens=out[1], trans=out[2], res=planes), "st_field_fwd planes")
    return (walk, xe, lrow, trow, pmap, dict(enumerate(planes)),
            tuple(out))


def _forced(walk, xe, planes, pmap, raw_k, lrow=None, trow=None, rpi=1):
    """The twin's arithmetic layer by layer on the kernel's activations
    (``walk_plain`` forced to the kernel's planes): each hidden layer and
    each raw output computed from the kernel's inputs to that layer, held
    against the kernel's → (largest |err| / max(|ref|, 1) and mean |err|
    over the layers, largest and mean |err| over the raw outputs)."""
    from texpose_tpu_torch.kernels import field_fwd
    raw_f, res_f = field_fwd.walk_plain(walk, xe, lrow, trow, rpi, pmap,
                                        forced=planes)
    lrel, lmean = _res_stats([planes[p] for p in sorted(planes)],
                             [res_f[p] for p in sorted(planes)])
    codes = [c for c in (field_fwd.NOUT_RGB, field_fwd.NOUT_DENS,
                         field_fwd.NOUT_TRANS) if c in raw_f]
    rmax, rmean, _ = _raw_stats(raw_k, [raw_f[c] for c in codes])
    return lrel, lmean, rmax, rmean


def _check_dw(rows, srcs, g_wide, g_narrow, segs, grads):
    """The dW pair as a split backward runs it (dw_gemm, then dw_reduce
    into ``grads``), then held against the segments' direct f32 products
    and the reduction's twin on the same partials (DW_REL)."""
    import torch
    from texpose_tpu_torch.kernels import dw_gemm as dw
    partial, prob = dw.dw_gemm(srcs, g_wide, g_narrow, segs)
    out = dw.dw_reduce(partial, prob, grads)
    want = dw.dw_plain(srcs, g_wide, g_narrow, segs, torch.zeros_like(grads))
    red = dw.dw_reduce_plain(partial, prob, torch.zeros_like(grads))
    exact = torch.zeros_like(grads, dtype=torch.float64)
    for sg in segs:                       # the products summed in f64
        h = dw._planes(srcs[sg.a])[sg.a_plane][:, sg.a_col:sg.a_col
                                               + sg.k_in]
        g = (g_wide[sg.b_plane] if sg.b == dw.WIDE else g_narrow)[
            :, sg.b_col:sg.b_col + sg.n]
        exact[sg.out:sg.out + sg.k_in * sg.n] = (
            h.double().t() @ g.double()).reshape(-1)
    blocks = [slice(s.out, s.out + s.k_in * s.n) for s in segs]
    _row(rows, "dw_pair", {
        "dw_rel_norm": max(rel_norm(out[b], want[b]) for b in blocks),
        "dw_rel_max": max(rel_max(out[b], want[b]) for b in blocks),
        "reduce_abs": max(float((out[b] - red[b]).abs().max())
                          for b in blocks),
        "rel_norm_vs_f64": max(rel_norm(out[b].double(), exact[b])
                               for b in blocks),
        "direct_rel_norm_vs_f64": max(rel_norm(want[b].double(), exact[b])
                                      for b in blocks)},
        {"dw_rel_norm": DW_REL, "dw_rel_max": DW_REL,
         "reduce_abs": DW_REL})
    return out


@contextlib.contextmanager
def twin_checks(kind):
    """While open, every kernel of the GAN step (``kind`` "gan": rows 1,
    3, 4 and 2 with the dW pair) or of the pretrain step ("pretrain": rows
    8, 9b and 7b with the dW pair), as its autograd Function calls it,
    launches and is then held against its plain twin on the same inputs
    under chip_smoke's bounds → (rows, regime): a dict per check, and the
    state's regime (the largest raw outputs, opaque rays, rays reaching
    the last interval).  The field forwards are held layer by layer on
    the kernel's activations (``_forced``), and end to end under
    ``scale_bound`` (the ``e2e_*_scale_rel`` and ``e2e_*_f64_ratio``
    statistics); their absolute end-to-end errors and each side's
    distance from the f64-sum twin are recorded beside."""
    import torch
    from texpose_tpu_torch.kernels import coarse_field as cf
    from texpose_tpu_torch.kernels import composite as cp
    from texpose_tpu_torch.kernels import st_field as sf

    rows, regime, saved = [], {}, []

    def patch(module, name, make):
        real = getattr(module, name)
        saved.append((module, name, real))

        def checked(*args, **kwargs):
            # the wrapper counts its launch on the module's name for
            # itself, which names this function while the patch holds
            checked.launches = real.launches
            out = real(*args, **kwargs)
            real.launches = checked.launches
            with torch.no_grad():
                make(args, kwargs, out)
            return out
        setattr(module, name, checked)

    def st_fwd(args, kwargs, got):
        ref = sf.st_field_plain(*args, **kwargs)
        with f64_sums():
            exact = sf.st_field_plain(*args, **kwargs)
        e_max, e_mean, e_rel = _raw_stats(got[:3], ref[:3])
        frel, fmean = _res_stats(got[3:], ref[3:])
        # off the card the wrapper ran the twin: no layer to force
        lrel, lmean, rmax, rmean, same = frel, fmean, e_max, e_mean, 1.0
        if got[0].is_cuda:
            walk, xe, lrow, trow, pmap, planes, raw_k = _st_planes(args,
                                                                   kwargs)
            lrel, lmean, rmax, rmean = _forced(walk, xe, planes, pmap, raw_k,
                                               lrow, trow, args[5])
            same = float(all(torch.equal(a, b)
                             for a, b in zip(raw_k, got[:3])))
        s_raw, b_raw = _scale_row(got[:3], ref[:3], exact[:3], "raw")
        s_feat, b_feat = _scale_row(got[3:], ref[3:], exact[3:], "feat")
        _row(rows, "st_field_fwd", {
            "layer_rel": lrel, "layer_mean_abs": lmean, "raw_max_abs": rmax,
            "raw_mean_abs": rmean, **s_raw, **s_feat,
            "planes_launch_equal": same,
            "e2e_raw_max_abs": e_max, "e2e_raw_mean_abs": e_mean,
            "e2e_raw_rel": e_rel, "e2e_feat_rel": frel,
            "e2e_feat_mean_abs": fmean,
            **_vs_f64(got[:3], ref[:3], exact[:3], "raw"),
            **_vs_f64(got[3:], ref[3:], exact[3:], "feat")},
            {"layer_rel": FEAT_REL, "layer_mean_abs": FIELD_MEAN_ERR,
             "raw_max_abs": FIELD_MAX_ERR, "raw_mean_abs": FIELD_MEAN_ERR,
             **b_raw, **b_feat})
        rgb, dens, tr = got[:3]
        regime.update(dens_raw_max=_amax(dens), rgb_head_max=_amax(rgb),
                      trans_rgb_max=_amax(tr[:, :3]),
                      trans_dens_max=_amax(tr[:, 3]),
                      uncert_raw_max=_amax(tr[:, 4]))

    def st_comp_fwd(args, kwargs, got):
        ref = cp.composite_st_plain(*args, **kwargs)
        exact = cp.composite_st_plain(
            *[a.double() if torch.is_tensor(a) else a for a in args],
            **kwargs)
        err = (got - ref).abs()
        col = int(err.max(0).values.argmax())
        _row(rows, "composite_st_fwd", {
            "max_abs": float(err.max()), "worst_column": col,
            "ref_max_there": float(ref[:, col].abs().max()),
            "max_vs_f64": float((got.double() - exact).abs().max()),
            "twin_max_vs_f64": float((ref.double() - exact).abs().max())},
            {"max_abs": COMPOSITE_MAX_ERR})
        rgb, tr, dens, _, dist = args[:5]
        _last_interval(regime, dens, dist, tr[:, 3])

    def st_comp_bwd(args, kwargs, got):
        ref = cp.composite_st_bwd_plain(*args, **kwargs)
        _row(rows, "composite_st_bwd",
             {"rel_max": max(rel_max(a, b) for a, b in zip(got, ref))},
             {"rel_max": COMPOSITE_BWD_REL})

    def st_bwd(args, kwargs, got):
        ref = sf.st_field_bwd_plain(*args, **kwargs)
        norm, peak, _ = _grad_stats(list(got[0]) + list(got[1:]),
                                    list(ref[0]) + list(ref[1:]))
        _row(rows, "st_field_bwd", {"rel_norm": norm, "rel_max": peak},
             {"rel_norm": FIELD_BWD_NORM, "rel_max": FIELD_BWD_MAX})

    def coarse_fwd(args, kwargs, got):
        ref = cf.coarse_render_plain(*args, **kwargs)
        with f64_sums():
            exact = cf.coarse_render_plain(*args, **kwargs)
        packed, rgb, dens, (_, acts) = got
        xext, ep, dist, depth, w = args[:5]
        comp = cp.composite_coarse_plain(rgb, dens, depth, dist)
        perr = float(((packed - comp).abs()
                      / comp.abs().clamp(min=1.0)).max())
        e_perr = float(((packed - ref[0]).abs()
                        / ref[0].abs().clamp(min=1.0)).max())
        e_max, e_mean, e_rel = _raw_stats((rgb, dens), ref[1:3])
        arel, amean = _res_stats(acts, ref[3])
        lrel, lmean, rmax, rmean = arel, amean, e_max, e_mean
        if packed.is_cuda:
            walk = w.fwd_walk(xext.shape[1], ep.shape[1])
            lrel, lmean, rmax, rmean = _forced(
                walk, sf.stage_rows(xext, ep, walk.kx, walk.ke),
                dict(enumerate(acts)), w.res_planes(), (rgb, dens))
        s_raw, b_raw = _scale_row((rgb, dens), ref[1:3], exact[1:3], "raw")
        s_act, b_act = _scale_row(acts, ref[3], exact[3], "act")
        _row(rows, "coarse_render_fwd", {
            "layer_rel": lrel, "layer_mean_abs": lmean, "raw_max_abs": rmax,
            "raw_mean_abs": rmean, "packed_rel": perr, **s_raw, **s_act,
            "e2e_packed_rel": e_perr, "e2e_raw_max_abs": e_max,
            "e2e_raw_mean_abs": e_mean, "e2e_raw_rel": e_rel,
            "e2e_act_rel": arel, "e2e_act_mean_abs": amean,
            **_vs_f64((rgb, dens), ref[1:3], exact[1:3], "raw"),
            **_vs_f64(acts, ref[3], exact[3], "act")},
            {"layer_rel": FEAT_REL, "layer_mean_abs": FIELD_MEAN_ERR,
             "raw_max_abs": FIELD_MAX_ERR, "raw_mean_abs": FIELD_MEAN_ERR,
             "packed_rel": RENDER_MAX_ERR, **b_raw, **b_act})
        regime.update(dens_raw_max=_amax(dens), rgb_head_max=_amax(rgb))
        _last_interval(regime, dens, args[2])

    def coarse_comp_bwd(args, kwargs, got):
        ref = cp.composite_coarse_bwd_plain(*args, **kwargs)
        _row(rows, "composite_coarse_bwd",
             {"rel_max": max(rel_max(a, b) for a, b in zip(got, ref))},
             {"rel_max": COMPOSITE_BWD_REL})

    def coarse_bwd(args, kwargs, got):
        xext, ep, _, acts, w, g_rgb, g_dens = args[:7]
        ref = cf.coarse_field_bwd_plain(xext, ep, acts, w, g_rgb, g_dens,
                                        *args[7:], **kwargs)
        norm, peak, _ = _grad_stats(got, ref)
        _row(rows, "coarse_field_bwd", {"rel_norm": norm, "rel_max": peak},
             {"rel_norm": FIELD_BWD_NORM, "rel_max": FIELD_BWD_MAX})

    if kind == "gan":
        module, field = sf, (("st_field_fwd", st_fwd),
                             ("st_field_bwd", st_bwd))
        for name, make in (("composite_st_fwd", st_comp_fwd),
                           ("composite_st_bwd", st_comp_bwd)):
            patch(cp, name, make)
    else:
        module, field = cf, (("coarse_render_fwd", coarse_fwd),
                             ("coarse_field_bwd", coarse_bwd),
                             ("composite_coarse_bwd", coarse_comp_bwd))
    for name, make in field:
        patch(module, name, make)
    saved.append((module, "dw_grads", module.dw_grads))
    module.dw_grads = lambda *a: _check_dw(rows, *a)
    try:
        yield rows, regime
    finally:
        for mod, name, real in reversed(saved):
            setattr(mod, name, real)


def grad_groups(k_grad, p_grad):
    """Per parameter group (a key's first two path parts): the relative
    norm ‖k − p‖/‖p‖ and the cosine of the concatenated gradients (in
    float64)."""
    import torch
    groups = {}
    for key in p_grad:
        groups.setdefault("/".join(key.split("/")[:2]), []).append(key)
    out = {}
    for grp, keys in groups.items():
        k = torch.cat([k_grad[n].double().reshape(-1) for n in keys])
        p = torch.cat([p_grad[n].double().reshape(-1) for n in keys])
        out[grp] = {"rel_norm": float((k - p).norm() / p.norm().clamp(
            min=1e-30)), "cosine": float(torch.nn.functional.cosine_similarity(
                k, p, dim=0))}
    return out


def trained_parity(eng, kind, switch=None, grads=None):
    """At the engine's state and on the next step's own batch and draws:
    that step through the kernels with each kernel held against its twin
    (``twin_checks``); with ``switch``, the same step through the plain
    route (cfg.kernels.<switch> off) and both steps' losses and gradients
    (``grads()`` after a step) compared as ``route_check`` does, per
    parameter group.  The state and the draw generator are restored, so a
    run goes on as if nothing ran → {"rows", "regime", "ok"[, "route"]}."""
    import torch
    state = eng.train_state_flat(0)
    gen = eng.draw_gen.get_state()
    draws = eng.make_draws(eng.it)
    try:
        with twin_checks(kind) as (rows, regime):
            k_loss = eng.train_step(draws)
        out = {"rows": rows, "regime": regime,
               "ok": all(r["ok"] for r in rows)}
        if switch:
            k_grad = grads()
            eng.load_train_state_flat(state)
            was = eng.cfg.kernels.get(switch)
            setattr(eng.cfg.kernels, switch, False)
            try:
                p_loss = eng.train_step(draws)
            finally:
                setattr(eng.cfg.kernels, switch, was)
            p_grad = grads()
            loss_rel = max(abs(float(k_loss[k]) - float(p_loss[k]))
                           / max(abs(float(p_loss[k])), 1e-12)
                           for k in p_loss)
            per_tensor = max(rel_norm(k_grad[k], p_grad[k]) for k in p_grad)
            out["route"] = {"loss_rel": loss_rel, "grad_rel_norm": per_tensor,
                            "groups": grad_groups(k_grad, p_grad)}
            out["ok"] = out["ok"] and loss_rel <= ROUTE_LOSS_RTOL \
                and per_tensor <= ROUTE_GRAD_NORM
    finally:
        eng.load_train_state_flat(state)
        eng.draw_gen.set_state(gen)
    _sync(eng.device)
    return out


def parity_text(res):
    """The checks of ``trained_parity`` as lines, each with the regime."""
    reg = res["regime"]
    regime = ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else
                       f"{k} {v}" for k, v in reg.items())
    lines = [f"{r['kernel']}: " + ", ".join(
        f"{k} {r[k]:.3g} (bound {b})" for k, b in r["bounds"].items())
        + ("" if r["ok"] else " PAST A BOUND") + "".join(
            f", {k} {v:.3g}" for k, v in r.items()
            if k not in r["bounds"] and k not in ("kernel", "bounds", "ok"))
        + f" [regime: {regime}]" for r in res["rows"]]
    if "route" in res:
        rt = res["route"]
        lines.append(
            f"step kernels vs plain: worst loss rel {rt['loss_rel']:.3g} "
            f"(bound {ROUTE_LOSS_RTOL}), worst tensor ‖err‖/‖ref‖ "
            f"{rt['grad_rel_norm']:.3g} (bound {ROUTE_GRAD_NORM}); groups "
            + "; ".join(f"{g} rel {v['rel_norm']:.3g} cos {v['cosine']:.6f}"
                        for g, v in rt["groups"].items()))
    return lines


def quality_phase(here, tmp, dev, smi):
    """Phase 13, the training-quality gate: (a) quality_check's two stages
    with the JAX tool's defaults, its gates asserted; (b) kernel vs plain
    trajectories; (c) the stages' launch counts against steps × the
    per-step counts, eager and inside replays apart; (d) the kernels
    against their twins at the end states."""
    import tempfile as tf
    from texpose_tpu_torch.tools import quality_check as qc

    was_tmp = tf.tempdir
    tf.tempdir = tmp                        # fixture and runs under tmp
    try:
        argv = [f"--device={dev}"]
        t0 = time.perf_counter()
        with traced_last_dispatch(PRETRAIN_KERNELS) as rep_pre:
            pre, la_pre = _launches_of(lambda: _with_envs(
                {"QUAL_PRETRAIN_ITERS": QUAL_PRETRAIN_STEPS,
                 "QUAL_SKIP_GAN": 1}, lambda: qc.main(argv))["pretrain"])
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        with traced_last_dispatch(TEXTURE_KERNELS) as rep_gan:
            gan, la_gan = _launches_of(lambda: _with_envs(
                {"QUAL_GAN_ITERS": QUAL_GAN_STEPS, "QUAL_SKIP_PRETRAIN": 1},
                lambda: qc.main(argv))["gan"])
        t_gan = time.perf_counter() - t0
        print(f"quality (a) pretrain: {QUAL_PRETRAIN_STEPS} steps, loss "
              f"{pre['first']:.4f} -> {pre['last']:.4f} (gate < "
              f"{qc.PRETRAIN_LOSS_DROP} x), val PSNR {pre['val']['PSNR']:.3f}"
              f" (gate > {qc.PRETRAIN_MIN_PSNR}); {pre['it_per_s']:.1f} "
              f"steps/s with the last dispatch traced, stage {t_pre:.1f} s "
              f"with the fixture; scan {pre['scan_k']}, route: "
              f"{pre['route']} [{smi}]", flush=True)
        print(f"quality (a) gan: {QUAL_GAN_STEPS} steps, render "
              f"{gan['first']:.4f} -> {gan['last']['render']:.4f}, every "
              f"loss finite; val {gan['val']}; evaluate_full "
              f"{gan['eval']}; {gan['it_per_s']:.1f} steps/s with the last "
              f"dispatch traced, stage {t_gan:.1f} s; scan {gan['scan_k']}, "
              f"route: {gan['route']} [{smi}]", flush=True)
        peng, geng = pre["engine"], gan["engine"]
        for what, eng in (("pretrain", peng), ("gan", geng)):
            runner = eng.step_runner()
            if runner.graph is None or runner.captures != 1:
                fail(f"quality (a) {what}: the stage's steps did not run "
                     f"as one captured graph ({runner.captures} captures; "
                     f"{runner.route})")

        # (c) launches: each kernel of the step once a step, the eager
        # warm-up steps and the warm calls of the stage's frame programs
        # (its validation and evaluation) counted by the wrappers, the
        # stage's last dispatch (all replays of the one captured step) and
        # the frame programs replayed after it by its device trace
        from texpose_tpu_torch.models.step_graph import WARMUP_STEPS as W
        P, G = QUAL_PRETRAIN_STEPS, QUAL_GAN_STEPS
        for what, got, rep, eng, steps, kernels in (
                ("pretrain", la_pre, rep_pre, peng, P, PRETRAIN_KERNELS),
                ("gan", la_gan, rep_gan, geng, G, TEXTURE_KERNELS)):
            frames = eng.frame_runner()
            f_eager, f_rep = frame_counts(frames)
            want = {k: W + f_eager.get(k, 0) for k in kernels}
            at_open = rep.get("_frames_at_open", {})
            frame_rep = {k: f_rep.get(k, 0) - at_open.get(k, 0)
                         for k in kernels}
            seen = {k: got[k] for k in kernels}
            K = eng.scan_k()
            seen_rep = {k: rep.get(k) for k in kernels}
            want_rep = {k: K + frame_rep[k] for k in kernels}
            print(f"quality (c) {what}: launches eager (wrapper counts) "
                  f"{seen}, expected {want} ({W} warm-up steps + the warm "
                  f"calls of {frames.captures} frame programs); inside the "
                  f"graph replays of the last of {rep['_dispatches']} "
                  f"dispatches and the frames after it (device trace) "
                  f"{seen_rep}, expected {want_rep} (1 a replayed step + "
                  f"the frames' {frame_rep}); {eng.it} steps, "
                  f"{eng.step_runner().captures} capture; frames: "
                  f"{frames.route}", flush=True)
            if seen != want or seen_rep != want_rep or eng.it != steps \
                    or rep["_dispatches"] != steps // K \
                    or rep.get("_last_k") != K:
                fail(f"quality (c) {what}: launches eager {seen} != {want} "
                     f"or replayed {seen_rep} != {want_rep}, or {eng.it} "
                     f"steps in {rep['_dispatches']} dispatches; the "
                     f"replays ran {rep.get('_symbols')}")
            fwd = ("coarse_render_fwd",) if what == "pretrain" else (
                "st_field_fwd", "composite_st_fwd")
            if min(min(want[k] - W, frame_rep[k]) for k in fwd) <= 0:
                fail(f"quality (c) {what}: validation / evaluation launched "
                     f"no kernel eagerly or in a replay ({want}, "
                     f"{frame_rep})")

        # (b) the trajectories from the stages' end states
        _trajectory(peng, "fused_coarse", TRAJ_PRETRAIN_STEPS, "pretrain",
                    smi)
        _trajectory(geng, "fused_st", TRAJ_GAN_STEPS, "gan", smi)

        # (d) the kernels against their twins at the stages' end states,
        # on one real batch each: the next step's own inputs
        for eng, kind, want in ((peng, "pretrain", PRETRAIN_TWINS),
                                (geng, "gan", GAN_TWINS)):
            res = trained_parity(eng, kind)
            for line in parity_text(res):
                print(f"quality (d) {kind} at step {eng.it}: {line} [{smi}]",
                      flush=True)
            seen = sorted(r["kernel"] for r in res["rows"])
            if seen != sorted(want):
                fail(f"quality (d) {kind}: checked {seen}, expected "
                     f"{sorted(want)}")
            if not res["ok"]:
                fail(f"quality (d) {kind}: a kernel parts from its twin at "
                     "the trained state")
    finally:
        tf.tempdir = was_tmp



# Phase 13 (e): tools/probe_f7.py's four branches, short: F7_SEEDS seeds,
# F7_SPLIT_STEPS GAN steps to the branch point, then each branch to
# F7_END_STEPS (a pretrain of F7_PRETRAIN_STEPS on the probe's 64-view
# fixture)
F7_SEEDS = (0, 1)
F7_PRETRAIN_STEPS = 300
F7_SPLIT_STEPS = 300
F7_END_STEPS = 600
F7_MARKS = (400, 600)


def f7_phase(here, tmp, dev, smi):
    """Phase 13 (e), tools/probe_f7.py through its entry: every seed's
    four branches reach F7_END_STEPS from one state with one draw
    generator state, each captured anew; branch b ran the emulated call
    sites (convolutions and spectral-norm matvecs counted > 0) and c under
    ``cudnn.deterministic``; a, a2 and b without it; the sites and the
    flag restored after every branch and after the phase."""
    import tempfile as tf
    import torch
    from texpose_tpu_torch.models import losses
    from texpose_tpu_torch.nn import discriminator as disc
    f7 = load_probe(here, "probe_f7")
    sites = (disc._conv, disc.sn_apply, losses.rgb_to_lab)
    was = torch.backends.cudnn.deterministic
    env = {"F7_PRETRAIN_ITERS": F7_PRETRAIN_STEPS,
           "F7_SPLIT": F7_SPLIT_STEPS, "F7_END": F7_END_STEPS,
           "F7_BRANCH_MARKS": ",".join(map(str, F7_MARKS))}
    was_tmp = tf.tempdir
    tf.tempdir = tmp
    t0 = time.perf_counter()
    try:
        out = _with_envs(env, lambda: f7.main([
            f"--device={dev}", "--seeds=" + ",".join(map(str, F7_SEEDS)),
            "--out=" + os.path.join(tmp, "f7")]))
    finally:
        tf.tempdir = was_tmp
    wall = time.perf_counter() - t0
    bad = []
    for seed, rec in out["seeds"].items():
        st = rec["settings"]
        print(f"f7 seed {seed}: steps/s by branch {rec['steps_per_s']}; "
              f"settings {st}; route: {rec['route']} [{smi}]", flush=True)
        if set(out["delta"][seed]) != set(f7.BRANCHES):
            bad.append(f"seed {seed}: branches that did not finish: "
                       f"{set(f7.BRANCHES) - set(out['delta'][seed])}")
        if len(set(rec["gen_digest"].values())) != 1:
            bad.append(f"seed {seed}: the branches' draw generators differ")
        calls = st["b"].get("site_calls", {})
        if min(calls.get("conv", 0), calls.get("sn_matvec", 0)) <= 0:
            bad.append(f"seed {seed}: branch b ran no emulated site "
                       f"({calls})")
        flags = {br: st[br]["cudnn_deterministic"] for br in f7.BRANCHES}
        if flags != {"a": False, "a2": False, "b": False, "c": True}:
            bad.append(f"seed {seed}: cudnn.deterministic by branch {flags}")
        if not all(st[br]["restored"] and st[br]["captures"] >= 1
                   for br in f7.BRANCHES):
            bad.append(f"seed {seed}: a branch left its setting behind or "
                       "captured no step")
    if (disc._conv, disc.sn_apply, losses.rgb_to_lab) != sites \
            or torch.backends.cudnn.deterministic != was:
        bad.append("the sites or cudnn.deterministic not restored")
    print(f"f7: {len(F7_SEEDS)} seeds x {len(f7.BRANCHES)} branches, "
          f"{F7_SPLIT_STEPS} + {len(f7.BRANCHES)} x "
          f"{F7_END_STEPS - F7_SPLIT_STEPS} GAN steps a seed, phase "
          f"{wall:.1f} s with the fixture and the pretrain; outcome "
          f"{out['outcome']} (no reading at this length) [{smi}]",
          flush=True)
    if bad:
        fail("f7: " + "; ".join(bad))
    return out


# The frames phase (between phases 13 and 14): every route of the
# evaluation frames captured (texpose_tpu_torch/models/frame_graph.py).
# FG_K captured training steps between the evaluations of (b); FG_TIMED
# frames a timed turn of (d), FG_PROFILED a profiled window; FG_VIDEO_N
# orbit frames; the extra flags of each engine (none on the card)
FG_K = 5
FG_TIMED = 8
FG_PROFILED = 4
FG_VIDEO_N = 2
FG_EXTRA = {"gan": (), "gan_train": (), "pretrain": (), "pretrain_train": ()}
# (a) and (b): a replay against the eager body on one payload is predicted
# bit-equal (the eval forwards have no atomics, and capture and eager run
# one cuDNN algorithm); a unit that is not is held to the frame-parity
# bounds of PERF.md §2 (its metrics: PSNR 0.01 dB, SSIM 1e-4, LPIPS rtol
# 1e-4 as the CPU tests, PNG payloads 1 LSB) or, a render unit, to
# COMPOSITE_MAX_ERR over its leaves
FG_PSNR_DB = 0.01
FG_SSIM = 1e-4
FG_LPIPS_RTOL = 1e-4
# route → (engine kind, switches, the frame's kernels: traced wrappers)
FG_ROUTES = {
    "rows 1+3": ("gan", {}, ("st_field_fwd", "composite_st_fwd")),
    "row 6f": ("gan", {"kernels.st_mega": True}, ("st_render_fwd",)),
    "row 10": ("gan", {"nerf.density_noise_reg": 1}, ("trunk_fwd",)),
    "row 8": ("pretrain", {}, ("coarse_render_fwd",)),
    "rows 7a+9a": ("pretrain", {"kernels.coarse_mega": False},
                   ("coarse_field_fwd", "composite_coarse_fwd")),
}


class _FrameSplit:
    """``n`` eval frames cycling through ``forms`` of frame 0 of ``data``:
    "object" (its object pixels, at most 45 % of the frame: the masked
    route in the bucket P of its count), "quarter" (the first quarter of
    those: a smaller bucket) and "whole" (a whole-frame mask: the
    whole-frame route)."""

    def __init__(self, data, forms, n):
        self.data, self.forms, self.n = data, forms, n
        self.raw_hw = getattr(data, "raw_hw", None)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np
        s = dict(self.data[0])
        mask = np.asarray(s["obj_mask"])
        form = self.forms[i % len(self.forms)]
        if form == "whole":
            s["obj_mask"] = np.ones_like(mask)
        else:
            on = np.nonzero(mask.reshape(-1) > 0)[0][:int(0.45 * mask.size)]
            m = np.zeros(mask.size, mask.dtype)
            m[on[:len(on) // 4] if form == "quarter" else on] = 1
            s["obj_mask"] = m.reshape(mask.shape)
        s["frame_index"] = np.asarray(i)
        return s


def _set_switches(eng, switches):
    """cfg <- switches {dotted key: value} → the previous values."""
    was = {}
    for key, value in switches.items():
        *path, leaf = key.split(".")
        node = eng.cfg
        for p in path:
            node = node[p]
        was[key] = node.get(leaf)
        node[leaf] = value
    return was


def _rebind(body, eng, other):
    """A unit's body (a partial over the engine's field, config and LPIPS
    parameters) bound to ``other``'s."""
    from functools import partial
    swap = {id(eng.nerf): other.nerf, id(eng.cfg): other.cfg,
            id(eng._ensure_lpips()[0]): other._ensure_lpips()[0]}
    return partial(body.func, *[swap.get(id(a), a) for a in body.args],
                   **body.keywords)


def _fg_compare(got, ref):
    """(bit-equal, within the bounds, the largest differences) of a
    unit's outputs against another run's."""
    import torch
    if isinstance(got, dict):
        d = max(float((got[k].double() - ref[k].double()).abs().max())
                for k in ref)
        same = all(torch.equal(got[k], ref[k]) for k in ref)
        return same, d <= COMPOSITE_MAX_ERR, {"leaves": d}
    p, s, lp = (abs(float(a) - float(b)) for a, b in zip(got[:3], ref[:3]))
    png = max(int((a.int() - b.int()).abs().max()) for a, b in
              zip(got[3:], ref[3:]))
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    ok = (p <= FG_PSNR_DB and s <= FG_SSIM and png <= 1
          and lp <= FG_LPIPS_RTOL * abs(float(ref[2])) + 1e-7)
    return same, ok, {"psnr": p, "ssim": s, "lpips": lp, "png": png}


def _fg_units(eng, other=None):
    """Every unit's outputs on its current inputs: replayed through the
    runner, and by its body eagerly (on ``other``'s field when given) →
    {key: (replayed, eager)}."""
    import torch
    runner = eng.frame_runner()
    out = {}
    with torch.inference_mode():
        for key, unit in list(runner.units.items()):
            inputs = {k: v.clone() for k, v in unit.slots.items()}
            body = unit.body if other is None else _rebind(unit.body, eng,
                                                           other)
            got = runner.run(key, unit.body, **inputs)
            out[key] = (got, body(**inputs))
    torch.cuda.synchronize()
    return out


def _fg_keys(what, eng, kernels, sweeps, smi):
    """(c) every key of the route captured once (a sweep whose wrappers'
    launches are the warm calls'), then replayed under a device trace (a
    second sweep: the route's kernels inside its replays exactly the
    runner's count); (a) each key's replay against its eager body → (keys,
    (a)'s rows, failures, the traced replays by wrapper)."""
    runner = eng.frame_runner()
    eng.drop_step_graph()
    bad = []
    caps0 = runner.captures
    zero_launches()
    sweeps["keys"]()
    host = {k: n for k, n in read_launches().items() if n}
    warm, rep0 = frame_counts(runner)
    caps = runner.captures - caps0
    zero_launches()
    with replay_trace(kernels) as traced:
        sweeps["keys"]()
    again = {k: n for k, n in read_launches().items() if n}
    want = {k: n - rep0.get(k, 0) for k, n in frame_counts(runner)[1].items()
            if n - rep0.get(k, 0)}
    keys = sorted(runner.units, key=str)
    stats = {str(k): v for k, v in runner.stats().items()}
    print(f"frames {what} (c): keys {keys}, {caps} captures; launches a "
          f"replay { {k: v['warm_launches'] for k, v in stats.items()} }; "
          f"the first sweep's eager launches (wrapper counts) {host}, the "
          f"warm calls' {warm}; the second sweep's kernels inside graph "
          f"replays (device trace) { {k: traced[k] for k in kernels} }, the "
          f"runner's count {want}, eager {again or 0} [{smi}]", flush=True)
    if caps != len(keys) or runner.captures != caps0 + caps \
            or not runner.capturable:
        bad.append(f"{what}: {runner.captures} captures for {len(keys)} "
                   f"keys ({runner.route})")
    if set(want) != set(kernels) or any(traced[k] != want[k]
                                        for k in kernels) \
            or host != warm or again or min(want.values(), default=0) <= 0:
        bad.append(f"{what}: traced replays "
                   f"{ {k: traced[k] for k in kernels} } != the frames' "
                   f"{want}, or eager {host} != the warm calls' {warm}, or "
                   f"replayed frames launched eagerly ({again}); the "
                   f"replays ran {traced['_symbols']}")
    rows = {}
    for key, (got, ref) in _fg_units(eng).items():
        same, ok, diff = _fg_compare(got, ref)
        rows[str(key)] = {"bit_equal": same, **diff}
        if not ok:
            bad.append(f"{what}: {key} replayed vs eager {diff}")
    print(f"frames {what} (a) replay vs eager on one payload a key: {rows}",
          flush=True)
    return keys, rows, bad, {k: traced[k] for k in kernels}


def _fg_trained(what, eng, fresh, sweeps):
    """(b) the route's keys captured, FG_K captured training steps, then
    every key replayed against a fresh engine's eager body on the trained
    state → (rows, failures)."""
    from texpose_tpu_torch.models.step_graph import route_name
    runner = eng.frame_runner()
    if not runner.units:
        sweeps["keys"]()
    caps = runner.captures
    before = _fg_units(eng)
    steps = eng.step_runner()
    steps.dispatch(FG_K)
    fresh.load_train_state_flat(eng.train_state_flat(eng.it))
    rows, bad, moved = {}, [], 0
    for key, (got, ref) in _fg_units(eng, fresh).items():
        same, ok, diff = _fg_compare(got, ref)
        rows[str(key)] = {"bit_equal": same, **diff}
        moved += not _fg_compare(got, before[key][0])[0]
        if not ok:
            bad.append(f"{what}: {key} after {FG_K} steps, replayed vs the "
                       f"fresh engine's eager {diff}")
    print(f"frames {what} (b) after {FG_K} training steps "
          f"({route_name(eng)}, {steps.captures} step capture) on "
          f"{eng.cfg.H}x{eng.cfg.W} frames: replay vs a fresh engine's eager "
          f"body {rows}; {moved} of {len(rows)} keys' outputs moved",
          flush=True)
    if runner.captures != caps or steps.graph is None or moved == 0:
        bad.append(f"{what}: the frames captured again after training "
                   f"({runner.captures - caps}), the step was not captured, "
                   f"or no output moved ({moved})")
    return rows, bad


def _fg_rates(what, eng, sweeps, smi):
    """(d) views/s, end to end (evaluate_full) and render only, eager /
    captured / captured / eager, and a profiled window of each mode end
    to end; (e) the
    allocator's growth over a captured sweep and the graph pool's bytes →
    (readings, failures)."""
    import torch
    from texpose_tpu_torch.models.frame_graph import pool_bytes
    out = {}
    for name in ("e2e", "render"):
        run = sweeps[name]
        turns = []
        for mode in ("eager", "captured", "captured", "eager"):
            run(1, mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(FG_TIMED, mode)
            torch.cuda.synchronize()
            turns.append((mode, FG_TIMED / (time.perf_counter() - t0)))
        prof = {} if name == "render" else {
            m: _profiled_steps(lambda k, m=m: run(k, m), FG_PROFILED)
            for m in ("eager", "captured")}
        out[name] = {"turns": turns, "profile": prof}
        e = statistics.mean(r for m, r in turns if m == "eager")
        c = statistics.mean(r for m, r in turns if m == "captured")
        print(f"frames {what} (d) {name} at {eng.cfg.H}x{eng.cfg.W}: views/s "
              "in turns " + ", ".join(f"{m} {r:.3f}" for m, r in turns)
              + f" (eager {e:.3f}, captured {c:.3f}) [{smi}]", flush=True)
        for m, p in prof.items():
            print(f"frames {what} (d) {name} {m}, profiled {FG_PROFILED} "
                  f"frames: {p['wall_ms']:.3f} ms/frame wall, device busy "
                  f"{p['busy_ms']:.3f} ms/frame, idle {100 * p['idle']:.1f} "
                  f"%, {p['kernel_launches']:.0f} kernel + "
                  f"{p['graph_launches']:.1f} graph launches/frame [{smi}]",
                  flush=True)
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    sweeps["e2e"](FG_TIMED, "captured")
    torch.cuda.synchronize()
    pool = pool_bytes(eng.frame_runner())
    mem = {"growth_mb": (torch.cuda.memory_allocated() - a0) / 1e6,
           "pool_mb": None if pool is None else pool / 1e6}
    out["mem"] = mem
    print(f"frames {what} (e): allocator growth over a captured sweep of "
          f"{FG_TIMED} frames {mem['growth_mb']:.3f} MB (gate < 512), the "
          f"frames' graph pool "
          + ("not read (the allocator's snapshot names no pool)"
             if pool is None else f"{mem['pool_mb']:.1f} MB") + f" [{smi}]",
          flush=True)
    bad = [] if mem["growth_mb"] < 512.0 else [
        f"{what}: a captured sweep grew the allocator by "
        f"{mem['growth_mb']} MB"]
    return out, bad


def _sweeps(eng):
    """An engine's sweeps over _FrameSplit forms of its frame 0: "keys"
    (every frame program: the GAN's evaluate_full over the object, its
    quarter and the whole frame; the pretrain's evaluate_full on both
    payloads, validate and a FG_VIDEO_N-frame orbit), "e2e" (evaluate_full
    over n object frames) and "render" (frame 0's whole-frame render n
    times), the runner capturing or not by ``mode``."""
    import numpy as np
    import torch
    data = eng.eval_data
    runner = eng.frame_runner()
    gan = hasattr(eng, "_render_frame_st")

    def split(forms, n):
        eng.eval_data = _FrameSplit(data, forms, n)
        eng._eval_cache = (None, None)

    def keys():
        if gan:
            split(("object", "quarter", "whole"), 3)
            eng.evaluate_full()
        else:
            split(("object",), 2)
            eng.evaluate_full()
            eng.cfg.render = {"eval_compact": False}
            try:
                eng.evaluate_full()
            finally:
                eng.cfg.render = {}
            eng.validate(getattr(eng, "it", 0))
            eng.generate_videos_synthesis(N=FG_VIDEO_N)
        torch.cuda.synchronize()

    def captured(mode, fn):
        was = runner.capturable
        runner.capturable = was and mode == "captured"
        try:
            fn()
        finally:
            runner.capturable = was

    def e2e(n, mode):
        split(("object",), n)
        captured(mode, eng.evaluate_full)

    def render(n, mode):
        split(("object",), 1)
        frame = eng.eval_frame(0)

        def go():
            with torch.inference_mode():
                for _ in range(n):
                    if gan:
                        eng._render_frame_st(frame, np.zeros(
                            (1, int(eng.cfg.nerf.N_latent_trans)),
                            np.float32), eng.latents["light"][0:1])
                    else:
                        eng._render_frame(frame)
        captured(mode, go)

    return {"keys": keys, "e2e": e2e, "render": render}


def _eval_engine(argv):
    """The engine the evaluate CLI builds from ``argv``, without its
    sweep."""
    from texpose_tpu_torch.models import get_engine
    from texpose_tpu_torch.models.base import resolve_device
    from texpose_tpu_torch.utils.config import set_options
    cfg = set_options(list(argv))
    eng = get_engine(cfg.model)(cfg, resolve_device(cfg))
    eng.load_dataset(eval_split="test")
    eng.build_networks()
    eng.load_initial_weights()
    eng.restore_checkpoint()
    return eng


def frames_phase(here, tmp, dev, smi):
    """The frames phase: every route of the eval frames (FG_ROUTES), its
    frame programs captured.  (a), (c), (d) and (e) on the evaluate CLI's
    engines: a 480x640 syn2real GAN engine (frame 0 as its object pixels,
    a quarter of them and a whole frame: two P buckets and the whole-frame
    route) and a 480x480 pretrain engine (evaluate_full on both payloads,
    validate, the orbit); (b) on the train CLI's engines at their 128x128
    crops, the same forms (the fixtures' 480-pixel frames carry no NOCS
    maps for the GAN's losses, nor masks the pretrain's 480x480 train crops
    read) → {route: the traced replays by wrapper}."""
    t0 = time.perf_counter()
    gan = fixture_argv(here, tmp, dev, 1, sub="frames") \
        + list(FG_EXTRA["gan"])
    train, _ = train_argv(here, tmp, dev, 1, out="frames_gan", extra=(
        "--max_iter=1000", *FG_EXTRA["gan_train"]))
    pre, _ = pretrain_argv(here, tmp, dev, 1, name="frames", extra=(
        "--max_iter=1000", *FG_EXTRA["pretrain_train"]))
    pre_ev, _ = pretrain_argv(here, tmp, dev, 1, name="frames_ev", extra=(
        "--data.image_size=[480,480]", *FG_EXTRA["pretrain"]))
    engines = {"gan": (_eval_engine(gan), engine_from_argv(train),
                       engine_from_argv(train)),
               "pretrain": (_eval_engine(pre_ev), engine_from_argv(pre),
                            engine_from_argv(pre))}
    sweeps = {id(e): _sweeps(e) for group in engines.values()
              for e in group[:2]}
    print(f"frames: engines built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out, bad, traced = {}, [], {}
    for what, (kind, switches, kernels) in FG_ROUTES.items():
        ev, tr, fresh = group = engines[kind]
        uniq = list({id(e): e for e in group}.values())
        was = [_set_switches(e, switches) for e in uniq]
        try:
            t = [time.perf_counter()]
            keys, a, b, traced[what] = _fg_keys(what, ev, kernels,
                                                sweeps[id(ev)], smi)
            bad += b
            t.append(time.perf_counter())
            tr.drop_step_graph()
            rows_b, b = _fg_trained(what, tr, fresh, sweeps[id(tr)])
            bad += b
            t.append(time.perf_counter())
            rates, b = _fg_rates(what, ev, sweeps[id(ev)], smi)
            bad += b
            t.append(time.perf_counter())
            secs = [round(y - x, 1) for x, y in zip(t, t[1:])]
            print(f"frames {what}: (a) + (c) {secs[0]} s, (b) {secs[1]} s, "
                  f"(d) + (e) {secs[2]} s", flush=True)
            out[what] = {"keys": [str(k) for k in keys], "a": a,
                         "b": rows_b, "seconds": secs, **rates}
        finally:
            for e, w in zip(uniq, was):
                _set_switches(e, w)
    print(f"frames: {len(FG_ROUTES)} routes, phase "
          f"{time.perf_counter() - t0:.1f} s; " + json.dumps(
              {k: {"keys": v["keys"], "mem": v["mem"],
                   "views_per_s": {n: v[n]["turns"] for n in ("e2e",
                                                             "render")}}
               for k, v in out.items()}), flush=True)
    if bad:
        fail("frames: " + "; ".join(bad))
    return traced


# The sections phase (between the frames phase and phase 14): the port's
# decomposition tools (texpose_tpu_torch/tools/step_sections.py,
# eval_stages.py) at full width.  SEC_TAGS: the chained sections run
# (S5 apart, through the step runner); STAGE_FRAMES: the 480x640 frames of
# the frame stages; the extra flags of the tools' engines (none on the
# card).  The checks: a chained capture measures what the kernel alone
# measures (S1 against row 1's CUDA-event time in this phase, within
# SEC_ROW1_REL: the field op S1 chains, one call between events behind a
# device spin, ``step_sections.op_ms`` — phase 2's one-call time also holds
# the host's launch gaps, 0.82-1.22 ms between calls), the step runner what
# the scan phase measures (S5 under the scan phase's deterministic cuDNN
# against its captured ms a step, within SEC_STEP_REL), every replayed
# kernel lands in one group and
# "other" holds at most SEC_OTHER of a program's busy ms, and the frame's
# stages add up to the stages in sequence (within SEC_STAGES_REL)
SEC_TAGS = "12890" + "3"
STAGE_FRAMES = 32
SEC_EXTRA = ()
SEC_ROW1_REL = 0.25
SEC_STEP_REL = 0.15
SEC_OTHER = 0.10
SEC_STAGES_REL = 0.15


def sections_phase(here, tmp, dev, smi, row1_ms, scan_step_ms):
    """The sections phase: S1, S2, S8, S9, S0, S3 (chained captures,
    marginal ms a body), row 1 alone (``op_ms``) and S5 (the captured step
    through its runner, under the scan phase's deterministic cuDNN);
    the device split by kernel group of the captured GAN, pretrain and
    hierarchical steps and of the rows 1 + 3 (480x640) and row 8 (480x480)
    frames; the trace's own cost in turns for the GAN step and the 480x640
    frames; the frame stages over STAGE_FRAMES frames at 480x640.
    ``row1_ms``: phase 2's CUDA-event time of row 1 (printed beside);
    ``scan_step_ms``: the scan phase's captured GAN step → the readings."""
    import tempfile as tf
    from texpose_tpu_torch.tools import eval_stages as es
    from texpose_tpu_torch.tools import step_sections as ss

    was_tmp = tf.tempdir
    tf.tempdir = tmp                        # fixtures and outputs under tmp
    t0 = time.perf_counter()
    bad = []
    try:
        gan = ss.gan_engine(dev, SEC_EXTRA)
        sec = ss.Sections(gan)
        out = {"sections": {}}
        for tag in SEC_TAGS:
            r = ss.run_section(sec, tag)
            out["sections"][tag] = r
            print(f"sections: {ss.SECTIONS[tag][0]}: {r['marginal_ms']:.4f} "
                  f"ms a body (medians {r['marginal_median_ms']:.4f}); best "
                  f"{r['best_ms']}, median {r['median_ms']} ms at depths "
                  f"{r['depths']} [{smi}]", flush=True)
            if not (math.isfinite(r["marginal_ms"]) and r["marginal_ms"] > 0):
                bad.append(f"section {tag}: marginal {r['marginal_ms']}")
        import torch
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True       # as the scan phase
        try:
            s5 = ss.engine_step_ms(gan)
        finally:
            torch.backends.cudnn.deterministic = was
        out["sections"]["5"] = s5
        print(f"sections: S5 official step {s5['ms_per_step']:.4f} ms a step "
              f"(median {s5['median_ms']:.4f}, K {s5['scan_k']}, "
              f"cudnn.deterministic); the scan phase's captured step "
              f"{scan_step_ms:.4f} ms [{smi}]", flush=True)
        s1 = out["sections"]["1"]["marginal_ms"]
        alone = out["sections"]["1"]["op_alone_ms"] = ss.field_op_ms(sec)
        print(f"sections: S1 {s1:.4f} ms against row 1 alone {alone:.4f} ms "
              f"(the field op S1 chains, CUDA events behind a device spin; "
              f"phase 2's one call {row1_ms:.4f} ms) [{smi}]", flush=True)
        if abs(s1 - alone) > SEC_ROW1_REL * alone:
            bad.append(f"S1 {s1} ms differs from row 1's {alone} ms by "
                       f"more than {SEC_ROW1_REL:.0%}")
        if not (math.isfinite(s5["ms_per_step"]) and s5["ms_per_step"] > 0) \
                or abs(s5["ms_per_step"] - scan_step_ms) \
                > SEC_STEP_REL * scan_step_ms:
            bad.append(f"S5 {s5['ms_per_step']} ms differs from the scan "
                       f"phase's {scan_step_ms} ms a step by more than "
                       f"{SEC_STEP_REL:.0%}")
        ev = ss.gan_eval_engine(dev, STAGE_FRAMES, SEC_EXTRA)
        out["split"] = ss.split_all(
            dev, SEC_EXTRA, log=lambda t: print(f"sections: {t}", flush=True),
            gan=gan, ev=ev)
        for name, r in out["split"].items():
            if "turns" in r:
                continue
            if r["n_misgrouped"] or r["other_share"] > SEC_OTHER \
                    or r["replays"] <= 0:
                bad.append(f"split {name}: {r['n_misgrouped']} kernels in "
                           f"no or two groups ({r['misgrouped']}), other "
                           f"{r['other_share']:.3f} of busy (top "
                           f"{r['other_top']}), {r['replays']} replays")
        st = es.run_stages(ev, STAGE_FRAMES)
        out["stages"] = st
        print("sections: frame stages\n" + es.stages_text(st) + f" [{smi}]",
              flush=True)
        if abs(st["stage_sum_ms"] - st["sync_loop_ms"]) \
                > SEC_STAGES_REL * st["sync_loop_ms"]:
            bad.append(f"frame stages sum {st['stage_sum_ms']} ms against "
                       f"sync_loop {st['sync_loop_ms']} ms")
    finally:
        tf.tempdir = was_tmp
    print(f"sections: phase {time.perf_counter() - t0:.1f} s; "
          + json.dumps(out, default=str), flush=True)
    if bad:
        fail("sections: " + "; ".join(bad))
    return out


# Phase 14's cut of the 1869-frame split: over ENVELOPE_N frames a leak of
# 512 MB / ENVELOPE_N = 2 MB a frame (a quarter of one 480x640 frame's
# ~7.4 MB of f32 RGB) crosses the tool's gate; ~15-20 s of sweep
ENVELOPE_N = 256


def envelope_phase(here, tmp, dev, smi):
    """Phase 14, the evaluation envelope: the tool's sweep of ENVELOPE_N
    480x640 frames (``eval_envelope.run``, its frames captured): its
    memory gate on the allocator holds, and rows 1 and 3 launch once per
    chunk of each frame: eagerly once (the warm call before the frame
    program's capture) and inside graph replays (a device trace of the
    run) for the warm frame and every frame of the sweep.  Then the
    sweep's views/s untraced, eager and captured in turns
    (``_envelope_turns``)."""
    import tempfile as tf
    from texpose_tpu_torch.models.frame_graph import pool_bytes
    from texpose_tpu_torch.tools import eval_envelope as ee

    names = ("st_field_fwd", "composite_st_fwd")
    was_tmp = tf.tempdir
    tf.tempdir = tmp                        # fixture and output under tmp
    try:
        t0 = time.perf_counter()
        with replay_trace(names) as replayed:
            (out, res, eng), la = _launches_of(lambda: _with_env(
                "EVAL_N", str(ENVELOPE_N), lambda: _with_env(
                    "EVAL_HW", "480,640", lambda: ee.run(dev))))
        wall = time.perf_counter() - t0
        runner = eng.frame_runner()
        units = runner.stats()
        per = {k: sum(u["warm_launches"].get(k, 0) for u in units.values())
               for k in names}
        want = {k: (per[k], per[k] * (ENVELOPE_N + 1)) for k in names}
        seen = {k: (la[k], replayed[k]) for k in names}
        pool = pool_bytes(runner)
        print(f"envelope: {out['frames']} frames at 480x640 in "
              f"{out['wall_s']} s = {out['views_per_s']} views/s "
              f"(views_per_sec_e2e, under a device trace), PSNR "
              f"{out['psnr']}; allocator {out['mem_before_mb']} -> "
              f"{out['mem_after_mb']} MB (delta {out['hbm_delta_mb']} MB, "
              f"gate < {ee.GATE_MB}), peak {out['peak_hbm_mb']} MB, "
              f"reserved {out['live_device_before_mb']} -> "
              f"{out['live_device_after_mb']} MB, the frames' graph pool "
              f"{'not read' if pool is None else f'{pool / 1e6:.1f} MB'}, "
              f"host RSS {out['rss_before_mb']} -> {out['rss_after_mb']} "
              f"MB; frame programs {sorted(units, key=str)} "
              f"({runner.captures} captures, {runner.route}); launches "
              f"(eager, inside graph replays) {seen}, expected {want} (the "
              f"warm call; {ENVELOPE_N} + 1 replayed frames, the warm "
              f"frame included); phase {wall:.1f} s [{smi}]", flush=True)
        if out["frames"] != ENVELOPE_N or out["o1_frame_memory"] is not True \
                or out["o1_basis"] != "allocator":
            fail(f"envelope: the memory gate failed: {out}")
        if min(per.values()) <= 0 or seen != want or len(units) != 1 \
                or runner.captures != 1:
            fail(f"envelope: launches {seen} != {want}, or frame programs "
                 f"{units} not one captured key")
        if not math.isfinite(res["psnr"]):
            fail(f"envelope: non-finite PSNR {res}")
        turns = _envelope_turns(eng, runner, smi)
        if runner.captures != 1:
            fail(f"envelope: the timed sweeps captured again "
                 f"({runner.captures} captures)")
        print(f"envelope: phase {time.perf_counter() - t0:.1f} s with the "
              f"timed sweeps; " + json.dumps({"traced": out["views_per_s"],
                                              "turns": turns}), flush=True)
    finally:
        tf.tempdir = was_tmp
    return {k: replayed[k] for k in names}


def _envelope_turns(eng, runner, smi):
    """views/s of the envelope's ENVELOPE_N-frame sweep (``evaluate_full``
    end to end), untraced, the runner's capture off and on in turns →
    [(mode, views/s)]."""
    import torch
    turns = []
    was = runner.capturable
    try:
        for mode in ("eager", "captured", "captured", "eager"):
            runner.capturable = was and mode == "captured"
            eng._eval_cache = (None, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.evaluate_full()
            torch.cuda.synchronize()
            turns.append((mode, ENVELOPE_N / (time.perf_counter() - t0)))
    finally:
        runner.capturable = was
    e = statistics.mean(r for m, r in turns if m == "eager")
    c = statistics.mean(r for m, r in turns if m == "captured")
    print(f"envelope: {ENVELOPE_N} frames at 480x640 end to end, untraced, "
          f"views/s in turns " + ", ".join(f"{m} {r:.3f}" for m, r in turns)
          + f" (eager {e:.3f}, captured {c:.3f}) [{smi}]", flush=True)
    return turns


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
    cprobe = load_probe(here, "probe_composite")
    t0 = time.perf_counter()
    sources = ("st_field", "composite", "coarse_field", "trunk_fwd",
               "st_render", "dw_gemm")
    copies = ("coarse_field", "st_field", "st_render")
    fwd_copies = [(s, None) for s in ("st_field", "coarse_field",
                                      "st_render", "trunk_fwd")] \
        + fwd.switch_copies()
    n_jobs = len(sources) + len(copies) + len(fwd_copies) + 1
    with ThreadPoolExecutor(n_jobs) as pool:
        # one nvcc per source and per measurement build
        built = [pool.submit(_build.build, name) for name in sources]
        libs = {name: pool.submit(probe.build_copy, name, probe.ONE_KERNEL)
                for name in copies}
        fwd_libs = {c: pool.submit(fwd.build_mma, *[d for d in c if d])
                    for c in fwd_copies}
        warp_lib = pool.submit(cprobe.build_old)
        for job in built:
            job.result()
        libs = {name: probe.load_one_kernel(job.result(), name)
                for name, job in libs.items()}
        fwd_libs = {c: fwd.load_mma(job.result(), c[0])
                    for c, job in fwd_libs.items()}
        warp_lib = cprobe.load_old(warp_lib.result())
    print(f"build: {len(sources)} kernel sources and "
          f"{len(copies) + len(fwd_copies) + 1} measurement "
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
    # the warp-per-ray composites the segmented rows 4, 9a and 9b
    # replaced, through their old host path (measurement build)
    warp = {**cprobe.legacy(warp_lib), "turns": cprobe.turns,
            "text": cprobe.turns_text}
    # step 1: where the mma.sync forwards' time went (measurement switches)
    step1 = fwd.attribution(dev, fwd_libs)

    measured, dw_runs = {}, {}
    for part in (kernel_phase(load_cfg(here), dev, one_kernel, mma, warp),
                 coarse_kernel_phase(here, dev, one_kernel, mma, warp),
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
        preprocess_video_phase(here, tmp, dev, smi)
        vis_phase(here, tmp, dev, smi)
        dp_phase(here, tmp, dev, smi)
        scan = scan_phase(here, tmp, dev, smi)
        quality_phase(here, tmp, dev, smi)
        f7_phase(here, tmp, dev, smi)
        eval_replays = list(frames_phase(here, tmp, dev, smi).values())
        sections = sections_phase(
            here, tmp, dev, smi, measured["st_field_fwd"]["ms"],
            1e3 / scan["gan"]["captured_steps_s"])
        eval_replays.append(envelope_phase(here, tmp, dev, smi))
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
    # the run each count comes from: eager launches (the wrappers' counts)
    # and launches inside graph replays (the device trace) apart
    path_of = dict({k: "train" for k in TEXTURE_KERNELS},
                   **{k: "pretrain" for k in PRETRAIN_KERNELS},
                   coarse_field_fwd="hierarchical",
                   composite_coarse_fwd="two_kernel", trunk_fwd="trunk",
                   **{k: "st_mega" for k in MEGA_KERNELS})
    # and, apart and not in ``launches``, each kernel's replays in the
    # captured frames of the frames and envelope phases (their device
    # traces)
    for k in measured:
        split = LAUNCH_SPLIT[path_of[k]][k]
        measured[k]["launches_eager"] = split["eager"]
        measured[k]["launches_replayed"] = split["replayed"]
        measured[k]["launches_eval_replayed"] = sum(
            r.get(k, 0) for r in eval_replays)
        # its device ms a step or a frame inside each captured program of
        # the sections phase's split (traced)
        measured[k]["captured_ms"] = {
            name: r["groups_ms"][WRAPPER_ROWS[k]]
            for name, r in sections["split"].items()
            if WRAPPER_ROWS[k] in r.get("groups_ms", {})}

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
