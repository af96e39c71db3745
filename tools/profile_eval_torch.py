#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's evaluation (or, with --train,
its texture-GAN train step; with --pretrain, its geometry-pretrain step)
goes, on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_eval_torch.py [--frames 12] [--trace out.json]
    python3 tools/profile_eval_torch.py --noisy [--frames 12]
    python3 tools/profile_eval_torch.py --train [--steps 30] [--trace ...]
    python3 tools/profile_eval_torch.py [--train] --st-mega [--steps 30]
    python3 tools/profile_eval_torch.py --pretrain [--steps 30] [--trace ...]
    python3 tools/profile_eval_torch.py --pretrain --fine [--steps 30]

Builds the same 480x640 fixture and seeded full-width checkpoint as
chip_smoke.py (``fixture_argv``), runs the evaluation CLI once cold, then
prints one line per measurement, each starting with its key:

  sweep:        warm ``evaluate_full`` views/s, twice, no profiler;
  profile:      one warm sweep under ``torch.profiler`` (CPU + CUDA): its
                wall ms, the union of the device events' intervals (busy
                ms) and the idle share 1 - busy/wall;
  host:         the sum of the CPU ops' self time over that sweep, and per
                frame;
  device_ops:   the table of ops by self device time;
  cpu_ops:      the table of ops by self CPU time;
  frame:        one compact frame on the host clock (median of 5,
                synchronized): render + metrics, render only, metrics only;
  load:         the dataset's per-frame load on the host, without and with
                the compact transform (mean over the frames).

--noisy evaluates with nerf.density_noise_reg = 1, as chip_smoke.py's
trunk phase does: the ST kernels' gate is off, so each frame's trunk runs
in the trunk kernel (row 10) and its heads plain.

--train builds chip_smoke.py's train fixture (``train_argv``: 16 train
images at 128x128, the seeded JAX-format pretrain checkpoint, the full
width of configs/nerf_lm_adapt_gan.yaml), runs the train CLI for 5 steps
cold, then runs the steps as the train CLI runs them: K = ``scan_k()``
steps a dispatch through ``engine.step_runner().dispatch(K)``, one
captured CUDA graph a step after its warm-up (models/step_graph.py).  It
prints:

  train_sweep:   warm steps/s and rays/s (2048 rays per step), twice, no
                 profiler;
  train_profile: --steps warm captured steps under ``torch.profiler``:
                 wall, device busy (union of device events), idle share,
                 and kernel and graph launches per step;
  train_host:    CPU op self time per step;
  train_device_ops / train_cpu_ops: the op tables, as above.
A replay runs no profiler range and no wrapper, so the step's device time
by stage and kernel group (the weight repacks included, which run inside
the graph) comes from ``python -m texpose_tpu_torch.tools.step_sections
--split``.
With --st-mega the frames and steps render through the render kernels
(--kernels.st_mega=true: the render forward; in a step the hybrid backward
or, with TEXPOSE_MEGA_FULLBWD=1 in the environment, the fused one); the
train lines then take the prefix ``train_st_mega``.

--pretrain builds chip_smoke.py's pretrain fixture (``pretrain_argv``: 16
train images at 128x128, the full width of configs/nerf_lm_pretrain.yaml,
2048 rays x 64 samples per step) and prints the same lines with the prefix
``pretrain_``.  With --fine, the hierarchical pretrain (chip_smoke.py's
hierarchical phase: a coarse and a fine field, 64 + 128 samples per ray),
prefix ``hierarchical_``.

The profiler's own cost lengthens the profiled wall, so the idle share
there is an upper bound on the unprofiled one.  --trace writes the
profiled sweep (or the profiled steps) as a Chrome trace.
"""

import argparse
import os
import shutil
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from texpose_tpu_torch.tools.step_sections import (  # noqa: E402
    trace_events, union_ms as _union_ms)


def _device_intervals(prof):
    """[start, end) µs of every device event that is a kernel or a copy:
    the GPU-side spans of user ranges (``record_function``) cover idle gaps
    and are left out."""
    from torch.autograd import DeviceType
    return [(start / 1e3, end / 1e3)
            for dev, _, name, start, end, user in trace_events(prof)
            if dev == DeviceType.CUDA and not user]


def _median_ms(fn, reps=5):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(engine, n, trace):
    import torch
    from torch.profiler import ProfilerActivity

    for k in range(2):
        t0 = time.perf_counter()
        engine.evaluate_full()
        torch.cuda.synchronize()
        print(f"sweep: warm unprofiled run {k}: "
              f"{n / (time.perf_counter() - t0):.3f} views/s ({n} frames)",
              flush=True)

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.evaluate_full()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = _device_intervals(prof)
    busy = _union_ms(dev)
    print(f"profile: wall {wall:.1f} ms; device busy {busy:.1f} ms over "
          f"{len(dev)} device events; device idle "
          f"{100 * (1 - busy / wall):.1f} %", flush=True)
    avgs = prof.key_averages()
    cpu_ms = sum(a.self_cpu_time_total for a in avgs) / 1e3
    print(f"host: {cpu_ms:.1f} ms of CPU op self time "
          f"({cpu_ms / n:.1f} ms/frame)", flush=True)
    dkey = _device_key(avgs)
    print("device_ops:\n" + avgs.table(sort_by=dkey, row_limit=15),
          flush=True)
    print("cpu_ops:\n" + avgs.table(sort_by="self_cpu_time_total",
                                    row_limit=15), flush=True)
    if trace:
        prof.export_chrome_trace(trace)
        print(f"profile: trace written to {trace}", flush=True)


def frame_times(engine):
    import torch
    from texpose_tpu_torch.models.base import compute_dtype
    from texpose_tpu_torch.models.render import render_rays_masked_st_pre
    from texpose_tpu_torch.utils.metrics import frame_metrics
    from texpose_tpu_torch.utils.pipeline import to_device

    cfg = engine.cfg
    dev = engine.device
    sample = engine.eval_data[0]
    raw_hw = getattr(engine.eval_data, "raw_hw", None)
    payload = engine._eval_compact_transform()(sample)
    if "image_sparse_u8" not in payload:
        print("frame: frame 0 does not take the compact route", flush=True)
        return
    frame = to_device(payload, dev, batch=False)
    lt = torch.zeros((1, int(cfg.nerf.N_latent_trans)), device=dev)
    ll = engine.latents["light"][0:1]
    HW = cfg.H * cfg.W
    idx = frame["idx"]

    def render():
        return render_rays_masked_st_pre(
            engine.nerf, cfg, frame["pose"], frame["intr"], idx,
            frame["z_near_pre"], frame["z_far_pre"], lt, ll, progress=1.0,
            compute_dtype=compute_dtype(cfg), chunk=int(cfg.nerf.rand_rays))

    with torch.inference_mode():
        vals = render()["rgb_static"][0]
        rgb = torch.zeros((HW, 3), device=dev)
        rgb[idx] = vals
        img = torch.zeros((HW, 3), device=dev)
        img[idx] = frame["image_sparse_u8"].float() / 255.0
        rgb, img = (t.reshape(cfg.H, cfg.W, 3) for t in (rgb, img))
        both = _median_ms(lambda: float(engine._eval_compact(
            frame, lt, ll, raw_hw)[0]))
        r_ms = _median_ms(render)
        lpips = engine._ensure_lpips()[0]
        m_ms = _median_ms(lambda: float(frame_metrics(lpips, rgb, img,
                                                      raw_hw)[0]))
    print(f"frame: compact frame 0 ({len(payload['idx'])} rays) render + "
          f"metrics {both:.1f} ms; render only {r_ms:.1f} ms; metrics only "
          f"{m_ms:.1f} ms", flush=True)

    transform = engine._eval_compact_transform()
    n = len(engine.eval_data)
    t0 = time.perf_counter()
    for i in range(n):
        engine.eval_data[i]
    plain = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    for i in range(n):
        transform(engine.eval_data[i])
    compact = (time.perf_counter() - t0) * 1e3 / n
    print(f"load: {plain:.1f} ms/frame; {compact:.1f} ms/frame with the "
          f"compact transform ({n} frames)", flush=True)


def _device_key(avgs):
    return ("self_device_time_total"
            if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")


def profile_train(eng, steps, trace, key="train"):
    import torch
    from torch.profiler import ProfilerActivity
    runner = eng.step_runner()
    K = eng.scan_k()

    def run(n):
        # n steps as the train CLI runs them: dispatches of at most K
        for done in range(0, n, K):
            runner.dispatch(min(K, n - done))
        torch.cuda.synchronize()

    run(K)                      # the warm-up steps and the capture
    for k in range(2):
        t0 = time.perf_counter()
        run(steps)
        rate = steps / (time.perf_counter() - t0)
        print(f"{key}_sweep: warm unprofiled run {k}: {rate:.3f} steps/s = "
              f"{rate * eng.rays_per_step():.1f} rays/s ({steps} steps, K "
              f"{K}; {runner.route})", flush=True)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        wall = (time.perf_counter() - t0) * 1e3
    dev = _device_intervals(prof)
    busy = _union_ms(dev)
    avgs = prof.key_averages()

    def calls(*names):
        return sum(a.count for a in avgs if a.key.startswith(names))

    launches = calls("cudaLaunchKernel", "cuLaunchKernel")
    graphs = calls("cudaGraphLaunch", "cuGraphLaunch")
    print(f"{key}_profile: wall {wall:.1f} ms ({wall / steps:.2f} ms/step); "
          f"device busy {busy:.1f} ms ({busy / steps:.2f} ms/step) over "
          f"{len(dev)} device events; device idle "
          f"{100 * (1 - busy / wall):.1f} %; {launches / steps:.1f} kernel + "
          f"{graphs / steps:.1f} graph launches/step", flush=True)
    cpu_ms = sum(a.self_cpu_time_total for a in avgs) / 1e3
    print(f"{key}_host: {cpu_ms / steps:.2f} ms/step of CPU op self time",
          flush=True)
    dkey = _device_key(avgs)
    print(f"{key}_device_ops:\n" + avgs.table(sort_by=dkey, row_limit=20),
          flush=True)
    print(f"{key}_cpu_ops:\n" + avgs.table(sort_by="self_cpu_time_total",
                                          row_limit=15), flush=True)
    if trace:
        prof.export_chrome_trace(trace)
        print(f"{key}_profile: trace written to {trace}", flush=True)


def main_train(args):
    import torch
    from chip_smoke import pretrain_argv, train_argv
    from texpose_tpu_torch import train
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="texpose_profile_")
    try:
        key = "train"
        if args.pretrain and args.fine:
            argv, _ = pretrain_argv(HERE, tmp, dev, 5, name="hier", extra=(
                "--nerf.fine_sampling=true", "--nerf.sample_intvs_fine=128",
                "--loss_weight.render_fine=0"))
            key = "hierarchical"
        elif args.pretrain:
            argv, _ = pretrain_argv(HERE, tmp, dev, 5)
            key = "pretrain"
        elif args.st_mega:
            argv, _ = train_argv(HERE, tmp, dev, 5,
                                 extra=("--kernels.st_mega=true",))
            key = "train_st_mega"
        else:
            argv, _ = train_argv(HERE, tmp, dev, 5)
        eng = train.main(argv)
        torch.cuda.synchronize()
        eng.cfg.max_iter = 100000
        profile_train(eng, args.steps, args.trace, key)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--train", action="store_true",
                    help="profile warm texture-GAN train steps instead")
    ap.add_argument("--pretrain", action="store_true",
                    help="profile warm geometry-pretrain steps instead")
    ap.add_argument("--fine", action="store_true",
                    help="with --pretrain: the hierarchical pretrain")
    ap.add_argument("--st-mega", action="store_true",
                    help="render through the render kernels (st_mega)")
    ap.add_argument("--noisy", action="store_true",
                    help="evaluate with nerf.density_noise_reg=1 (the "
                         "trunk kernel under plain heads)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--trace", default=None,
                    help="write the profiled run as a Chrome trace here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_eval_torch: needs a CUDA device")
    sys.modules["jax"] = None
    sys.modules["texpose_tpu"] = None
    if args.train or args.pretrain:
        return main_train(args)
    from chip_smoke import fixture_argv
    from texpose_tpu_torch import evaluate
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="texpose_profile_")
    try:
        argv = fixture_argv(HERE, tmp, dev, args.frames)
        if args.st_mega:
            argv.append("--kernels.st_mega=true")
        if args.noisy:
            argv.append("--nerf.density_noise_reg=1")
        engine = evaluate.main(argv)
        torch.cuda.synchronize()
        profile(engine, args.frames, args.trace)
        frame_times(engine)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
