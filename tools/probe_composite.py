#!/usr/bin/env python3
"""The composite kernels' times on one GPU, honestly split: rows 3 and 4
(the dual composite forward and backward, csrc/composite.cu), 9a and 9b
(the single-density composite forward and backward) at the main paths'
shapes, 2048 rays × 64 samples, rows 9a and 9b also at 192 samples (the
hierarchical pretrain's fine field).

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/probe_composite.py [--k 200] [--ab | --host]

Per row, beside its bound (chip_smoke.py's ``bound``):
  kernel   the kernel alone: K calls of the wrapper captured in one CUDA
           graph and replayed between two events, / K (the graph holds the
           kernels, not the wrappers' host work; the calls cycle through
           copies of the inputs that together exceed twice the L2 cache,
           chip_smoke.py's ``cold_copies``); torch.profiler's mean kernel
           duration over 50 eager calls beside it as a cross-check;
  wrapper  the wrapper per call: host clock over K back-to-back calls
           ending in a synchronize, / K;
  event    one call between two CUDA events (median of 20), the figure
           the earlier records give.
First the graph's floor per launch (a 1-element fill, the least a kernel
alone can read). With --ab, rows 4, 9a and 9b (9a at both sample counts)
also run in turns old / new / new / old: old is
csrc/composite.cu built with -DCOMPOSITE_WARP_PER_RAY (the warp-per-ray
forms the segmented kernels replaced) into build/probe_composite/,
launched through ``legacy_*`` below, a copy of the wrappers' host path as
it stood before the segmented kernels (checks, ``.contiguous()``,
``_build``-style lookup under a lock, a new ``ctypes.c_void_p`` stream
per call); new is the package's build through the package's wrappers.
chip_smoke.py loads this file for the same comparison. With --host it
times the pieces of composite_st_fwd's launch path on the host, then
rows 4, 9a and 9b's old host paths and wrappers in turns. Prints the
card's name and power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "build", "probe_composite")
OLD = "COMPOSITE_WARP_PER_RAY"


def inputs(dev, BR, N, seed, dual):
    """Random raw field outputs, sorted depths and their intervals at
    BR rays × N samples; a cotangent like a train step's (per-ray means).
    dual: (rgb [M,3], trans [M,5], dens [M,1], depth, dist, g [BR,16]);
    else (rgb, dens, depth, dist, g [BR,8])."""
    import torch
    from texpose_tpu_torch.ops.render import _dists
    g = torch.Generator().manual_seed(seed)
    M = BR * N
    rgb = torch.randn(M, 3, generator=g)
    tr = torch.randn(M, 5, generator=g)
    dens = torch.randn(M, 1, generator=g) * 3
    depth = torch.sort(torch.rand(BR, N, generator=g) * 1.2 + 3.4,
                       dim=1).values
    ray = torch.randn(1, BR, 3, generator=g)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    cot = torch.randn(BR, 16 if dual else 8, generator=g) / BR
    out = (rgb, tr, dens, depth, dist, cot) if dual else \
        (rgb, dens, depth, dist, cot)
    return tuple(t.to(dev) for t in out)


def calls(dev):
    """{row: (the wrapper, its arguments, its outputs, f32 operations,
    kernel-name substring)} at the main paths' shapes."""
    import chip_smoke as cs
    from texpose_tpu_torch.kernels import composite as C
    rows = {}
    BR = 2048
    rgb, tr, dens, depth, dist, cot = inputs(dev, BR, 64, 1, True)
    fa = (rgb, tr, dens, depth, dist, 0.05)
    ba = (rgb, tr, dens, dist, cot)
    rows["3"] = (C.composite_st_fwd, fa, (C.composite_st_fwd(*fa),),
                 cs.COMPOSITE_ST_FWD_OPS * BR * 64, "composite_st_fwd")
    rows["4"] = (C.composite_st_bwd, ba, C.composite_st_bwd(*ba),
                 cs.COMPOSITE_ST_BWD_OPS * BR * 64, "composite_st_bwd")
    for n in (64, 192):
        rgb, dens, depth, dist, cot = inputs(dev, BR, n, n, False)
        fa = (rgb, dens, depth, dist)
        ba = (rgb, dens, dist, depth, cot)
        rows[f"9a N={n}"] = (
            C.composite_coarse_fwd, fa, (C.composite_coarse_fwd(*fa),),
            cs.COMPOSITE_COARSE_FWD_OPS * BR * n, "composite_coarse_fwd")
        rows[f"9b N={n}"] = (
            C.composite_coarse_bwd, ba, C.composite_coarse_bwd(*ba),
            cs.COMPOSITE_COARSE_BWD_OPS * BR * n, "composite_coarse_bwd")
    return rows


# ---------------------------------------------------------------- old form

def build_old():
    """csrc/composite.cu with -DCOMPOSITE_WARP_PER_RAY → the library's path
    (rows 4, 9a and 9b as one warp per ray; row 3 as shipped)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from probe_field_bwd_atomics import build_copy
    return build_copy("composite", OLD, out_dir=OUT_DIR)


def load_old(so):
    from texpose_tpu_torch.kernels import composite as C
    lib = ctypes.CDLL(so)
    for sym, argtypes in C._ARGTYPES.items():
        getattr(lib, sym).argtypes = argtypes
        getattr(lib, sym).restype = ctypes.c_int
    return lib


_lock = threading.Lock()
_libs = {}


def _legacy_lib(lib):
    with _lock:                                   # as _build.load did
        return _libs.setdefault("composite", lib)


def _legacy_planes(what, device, args, numels):
    import torch
    for x, numel in zip(args, numels):
        if (x.dtype != torch.float32 or x.device != device
                or x.numel() != numel):
            raise ValueError(f"{what}: bad input {x.dtype} {tuple(x.shape)}")
    return [x.contiguous() for x in args]


def legacy_st_bwd(lib, rgb_raw, trans_raw, dens_raw, dist, g):
    """composite_st_bwd's host path before the segmented kernels."""
    import torch
    BR, N = dist.shape
    M = BR * N
    args = _legacy_planes("composite_st_bwd", rgb_raw.device,
                          (rgb_raw, trans_raw, dens_raw, dist, g),
                          (3 * M, 5 * M, M, M, BR * 16))
    d_rgb = torch.empty((M, 3), dtype=torch.float32, device=rgb_raw.device)
    d_tr = torch.empty((M, 5), dtype=torch.float32, device=rgb_raw.device)
    err = _legacy_lib(lib).composite_st_bwd(
        *(x.data_ptr() for x in args), BR, N, 0, 0, 0, 0, d_rgb.data_ptr(),
        d_tr.data_ptr(), ctypes.c_void_p(
            torch.cuda.current_stream(rgb_raw.device).cuda_stream))
    if err:
        raise RuntimeError(f"composite_st_bwd: cudaError_t {err}")
    return d_rgb, d_tr


def legacy_coarse_fwd(lib, rgb_raw, dens_raw, depth, dist):
    """composite_coarse_fwd's host path before the segmented kernels."""
    import torch
    BR, N = depth.shape
    M = BR * N
    args = _legacy_planes("composite_coarse_fwd", rgb_raw.device,
                          (rgb_raw, dens_raw, dist, depth), (3 * M, M, M, M))
    out = torch.empty((BR, 8), dtype=torch.float32, device=rgb_raw.device)
    err = _legacy_lib(lib).composite_coarse_fwd(
        *(x.data_ptr() for x in args), BR, N, 0, 0, 0, 0, out.data_ptr(),
        ctypes.c_void_p(
            torch.cuda.current_stream(rgb_raw.device).cuda_stream))
    if err:
        raise RuntimeError(f"composite_coarse_fwd: cudaError_t {err}")
    return out


def legacy_coarse_bwd(lib, rgb_raw, dens_raw, dist, depth, g):
    """composite_coarse_bwd's host path before the segmented kernels."""
    import torch
    BR, N = dist.shape
    M = BR * N
    args = _legacy_planes("composite_coarse_bwd", rgb_raw.device,
                          (rgb_raw, dens_raw, dist, depth, g),
                          (3 * M, M, M, M, BR * 8))
    d_rgb = torch.empty((M, 3), dtype=torch.float32, device=rgb_raw.device)
    d_dens = torch.empty((M, 1), dtype=torch.float32, device=rgb_raw.device)
    err = _legacy_lib(lib).composite_coarse_bwd(
        *(x.data_ptr() for x in args), BR, N, 0, 0, 0, 0, d_rgb.data_ptr(),
        d_dens.data_ptr(), ctypes.c_void_p(
            torch.cuda.current_stream(rgb_raw.device).cuda_stream))
    if err:
        raise RuntimeError(f"composite_coarse_bwd: cudaError_t {err}")
    return d_rgb, d_dens


def turns(old, new, args, k=200):
    """Two launchers of one row on ``args`` in turns old / new / new / old:
    {"kernel": the kernel alone (graph replay / k over cold copies of
    args), "wrapper": the wrapper per call}, four ms each."""
    import chip_smoke as cs
    order = (old, new, new, old)
    return dict(kernel=[cs.graph_ms(f, k, args=args) for f in order],
                wrapper=[cs.wrapper_ms(lambda f=f: f(*args), k)
                         for f in order])


def turns_text(t):
    return ("kernel alone " + " / ".join(f"{x:.5f}" for x in t["kernel"])
            + " ms, wrapper per call "
            + " / ".join(f"{x:.5f}" for x in t["wrapper"]) + " ms")


def legacy(old_lib):
    """{row: the warp-per-ray form of the row through its old host path,
    returning a tuple as the package's wrapper does}."""
    return {
        "4": lambda *a: legacy_st_bwd(old_lib, *a),
        "9a": lambda *a: (legacy_coarse_fwd(old_lib, *a),),
        "9b": lambda *a: legacy_coarse_bwd(old_lib, *a)}


def ab(dev, old_lib, k=200):
    """Rows 4, 9a and 9b (2048 × 64; 9a also × 192) in turns, the
    warp-per-ray form through its old host path against the package's:
    {row: (turns, the old form's and the new one's max |err| / max
    |twin|)}."""
    import chip_smoke as cs
    import torch
    from texpose_tpu_torch.kernels import composite as C
    rgb, tr, dens, depth, dist, cot = inputs(dev, 2048, 64, 1, True)
    sb = (rgb, tr, dens, dist, cot)
    crgb, cdens, cdepth, cdist, cot = inputs(dev, 2048, 64, 64, False)
    ba = (crgb, cdens, cdist, cdepth, cot)
    old = legacy(old_lib)
    pairs = {
        "4": (old["4"], C.composite_st_bwd, sb,
              C.composite_st_bwd_plain(*sb)),
        "9b": (old["9b"], C.composite_coarse_bwd, ba,
               C.composite_coarse_bwd_plain(*ba))}
    for n in (64, 192):
        frgb, fdens, fdepth, fdist, _ = inputs(dev, 2048, n, n, False)
        ca = (frgb, fdens, fdepth, fdist)
        pairs[f"9a N={n}"] = (old["9a"],
                              lambda *a: (C.composite_coarse_fwd(*a),), ca,
                              (C.composite_coarse_plain(*ca),))
    out = {}
    for row, (old_fn, new, args, want) in pairs.items():
        errs = []
        for fn in (old_fn, new):
            got = fn(*args)
            torch.cuda.synchronize()
            errs.append(max(cs.rel_max(a, b) for a, b in zip(got, want)))
        out[row] = (turns(old_fn, new, args, k), *errs)
    return out


def host(dev, old_lib, k, rounds=4):
    """Where the wrappers' host time goes (µs a call, host clock over k
    calls then a synchronize, median of 5): each piece of
    composite_st_fwd's launch path on row 3's 2048 × 64 inputs; then rows
    4, 9a and 9b's old host paths and wrappers in turns, ``rounds``
    times."""
    import time
    import torch
    from texpose_tpu_torch.kernels import composite as C
    rgb, tr, dens, depth, dist, _ = inputs(dev, 2048, 64, 1, True)
    args = (rgb, tr, dens, depth, dist)
    M = 2048 * 64
    numels = (3 * M, 5 * M, M, M, M)
    ptrs = [x.data_ptr() for x in args]
    lib = C._kernels()
    out = rgb.new_empty((2048, 16))
    plan = C.segment_plan(2048, 64, ptrs)
    stream = torch._C._cuda_getCurrentRawStream(0)
    pieces = {
        "is_cuda, shape": lambda: (rgb.is_cuda, depth.shape),
        "the checks (_ready)": lambda: C._ready("x", args, numels),
        "5 data_ptr()": lambda: [x.data_ptr() for x in args],
        "new_empty [2048,16]": lambda: rgb.new_empty((2048, 16)),
        "segment_plan": lambda: C.segment_plan(2048, 64, ptrs),
        "the raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "ctypes entry, no launch (BR = 0)": lambda: lib.composite_st_fwd(
            *ptrs, 0, 64, 0.05, *plan, out.data_ptr(), stream),
        "ctypes entry with its launch": lambda: lib.composite_st_fwd(
            *ptrs, 2048, 64, 0.05, *plan, out.data_ptr(), stream),
        "the wrapper": lambda: C.composite_st_fwd(*args),
    }
    crgb, cdens, cdepth, cdist, cot = inputs(dev, 2048, 64, 64, False)
    bargs = (crgb, cdens, cdist, cdepth, cot)
    sargs = (rgb, tr, dens, dist, torch.cat([cot, cot], 1))
    fargs = (crgb, cdens, cdepth, cdist)
    legacy_paths = legacy(old_lib)
    pieces.update({
        "row 9b: new_empty [M,3] and [M,1]": lambda: (
            crgb.new_empty((M, 3)), crgb.new_empty((M, 1))),
        "row 9b: one new_empty [4M]": lambda: crgb.new_empty((4 * M,)),
        "row 4: the wrapper": lambda: C.composite_st_bwd(*sargs),
        "row 4: the old host path": lambda: legacy_paths["4"](*sargs),
        "row 9a: the wrapper": lambda: C.composite_coarse_fwd(*fargs),
        "row 9a: the old host path": lambda: legacy_paths["9a"](*fargs),
        "row 9b: the wrapper": lambda: C.composite_coarse_bwd(*bargs),
        "row 9b: the old host path": lambda: legacy_paths["9b"](*bargs),
    })
    for name, fn in pieces.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e6 / k)
        runs.sort()
        print(f"host: {name}: {runs[2]:.2f} µs a call", flush=True)
    # the two host paths of each row in turns, several rounds: the host
    # clock moves between runs more than the paths differ
    import chip_smoke as cs
    for row in ("4", "9a", "9b"):
        old = pieces[f"row {row}: the old host path"]
        new = pieces[f"row {row}: the wrapper"]
        for r in range(rounds):
            t = [cs.wrapper_ms(f, k) * 1e3 for f in (old, new, new, old)]
            print(f"host: row {row} round {r}: old host path / wrapper / "
                  f"wrapper / old host path "
                  + " / ".join(f"{x:.2f}" for x in t) + " µs a call",
                  flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--k", type=int, default=200)
    parser.add_argument("--ab", action="store_true")
    parser.add_argument("--host", action="store_true")
    opts = parser.parse_args()
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("probe_composite: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    if opts.host:
        host(dev, load_old(build_old()), opts.k)
        return
    old_job = None
    if opts.ab:
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(1)
        old_job = pool.submit(build_old)
    one = torch.zeros(1, device=dev)
    floor = cs.graph_ms(one.zero_, opts.k)
    print(f"graph replay floor: a 1-element fill {floor:.5f} ms per launch",
          flush=True)
    for row, (fn, args, outs, ops, name) in calls(dev).items():
        ins = [a for a in args if torch.is_tensor(a)]
        bnd = cs.bound(cs.nbytes(*ins, *outs), ops, cs.PEAK_F32)
        t = cs.small_kernel_ms(fn, args, name, opts.k)
        prof = t["profiler_ms"]
        print(f"row {row}: kernel alone {t['kernel_ms']:.5f} ms (graph "
              f"replay / {opts.k}, inputs cycled past L2; profiler "
              f"{'n/a' if prof is None else f'{prof:.5f}'} ms), wrapper per "
              f"call {t['wrapper_ms']:.5f} ms, one call between events "
              f"{t['event_ms']:.5f} ms; bound {bnd[0]:.5f} ms ({bnd[1]}), "
              f"kernel / bound {t['kernel_ms'] / bnd[0]:.2f}", flush=True)
    if old_job is not None:
        old_lib = load_old(old_job.result())
        for row, (t, old_err, new_err) in ab(dev, old_lib, opts.k).items():
            print(f"row {row} A/B warp per ray / segmented / segmented / "
                  f"warp per ray: {turns_text(t)}; vs twin max|err|/max|ref| "
                  f"old {old_err:.3g}, new {new_err:.3g}", flush=True)


if __name__ == "__main__":
    main()
