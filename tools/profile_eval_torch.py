#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's evaluation goes, on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/profile_eval_torch.py [--frames 12] [--trace out.json]

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

The profiler's own cost lengthens the profiled wall, so the idle share
there is an upper bound on the unprofiled one.  --trace writes the
profiled sweep as a Chrome trace.
"""

import argparse
import os
import shutil
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _union_ms(intervals):
    """Total length of the union of [start, end) intervals in µs → ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


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
    from torch.autograd import DeviceType
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
    dev = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    busy = _union_ms(dev)
    print(f"profile: wall {wall:.1f} ms; device busy {busy:.1f} ms over "
          f"{len(dev)} device events; device idle "
          f"{100 * (1 - busy / wall):.1f} %", flush=True)
    avgs = prof.key_averages()
    cpu_ms = sum(a.self_cpu_time_total for a in avgs) / 1e3
    print(f"host: {cpu_ms:.1f} ms of CPU op self time "
          f"({cpu_ms / n:.1f} ms/frame)", flush=True)
    dkey = ("self_device_time_total"
            if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")
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
        m_ms = _median_ms(lambda: float(engine._metrics(rgb, img,
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--trace", default=None,
                    help="write the profiled sweep as a Chrome trace here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_eval_torch: needs a CUDA device")
    os.environ.pop("JAX_PLATFORMS", None)
    sys.modules["jax"] = None
    sys.path.insert(0, HERE)
    from chip_smoke import fixture_argv
    from texpose_tpu_torch import evaluate
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="texpose_profile_")
    try:
        engine = evaluate.main(fixture_argv(HERE, tmp, dev, args.frames))
        torch.cuda.synchronize()
        profile(engine, args.frames, args.trace)
        frame_times(engine)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
