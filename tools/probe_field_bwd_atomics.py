#!/usr/bin/env python3
"""Where the field backward kernels' time went before their split, on one
GPU: the trunk-training backward (row 7b, csrc/coarse_field.cu) and the ST
heads' backward (row 2, csrc/st_field.cu), each in its one-kernel form
with the cross-tile dW sums as f32 atomics; with --render, the render
backward (row 6b, csrc/st_render.cu) in both forms.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/probe_field_bwd_atomics.py [--reps 20]
    python3 tools/probe_field_bwd_atomics.py --render [--reps 20]

The package ships only the split form (the dX-chain kernel, then
csrc/dw_gemm.cu).  The one-kernel form is compiled only in the measurement
build -DFIELD_BWD_ONE_KERNEL (entries coarse_bwd_atomic,
st_field_bwd_atomic, st_render_bwd_atomic), into build/probe_bwd/;
``build_copy``, ``load_one_kernel``, ``coarse_one_kernel``,
``st_one_kernel`` and ``render_one_kernel`` below build and launch it, and
chip_smoke.py uses them for its in-call comparison of the two forms.
With --render this script times the render backward's measurement
switches (csrc/st_render.cu) on the GAN step's 8 images × 16,384 rows at
the full width of configs/nerf_lm_adapt_gan.yaml, each against its build
in turns (build, switch, switch, build), in the shipped split form
(through the package's wrapper, the library swapped by ``using``) and,
but for the recompute, in the one-kernel form:
  no VJP          ST_RENDER_BWD_NO_VJP: the composite's VJP (one warp per
                  ray) skipped, the raw outputs scaled standing in for its
                  gradients (results wrong);
  no second pass  ST_RENDER_BWD_NO_SECOND_PASS: the transient head's second
                  pass over its hidden layers skipped — the split form's
                  read-back of its planes, the one-kernel form's recompute
                  (results wrong);
  recompute       ST_RENDER_BWD_RECOMPUTE: the split form recomputes them
                  as the one-kernel form does instead of reading them back
                  (the design the read-back replaced; results right).
Without --render it builds the one-kernel form once more per measurement
switch of csrc/trunk.cuh (all nvcc runs in parallel):
  plain stores  TRUNK_DW_PLAIN_STORES: every dW partial written with a plain
                store instead of atomicAdd (same products and bytes);
  no dW         TRUNK_BWD_NO_DW: the dW products and their adds skipped;
  no dX         TRUNK_BWD_NO_DX: the dX products (g · Wᵀ) skipped;
  zero loads    TRUNK_BWD_NO_LOADS: every staged row load (residuals,
                inputs) replaced by a zero fill.
Each switch's results are wrong; only the time means something.  Each is
timed against the one-kernel build in turns (one-kernel, switch, switch,
one-kernel), CUDA-event medians, on the main paths' shapes: 7b on the
pretrain step's 131,072 rows at the full width of
configs/nerf_lm_pretrain.yaml, row 2 on the GAN step's 8 images x 16,384
rows at the full width of configs/nerf_lm_adapt_gan.yaml.  Prints one line
per run and the card's name and power limit.  The copies are measurement
devices only: nothing in the package uses them.
"""

import argparse
import contextlib
import ctypes
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "build", "probe_bwd")
ONE_KERNEL = "FIELD_BWD_ONE_KERNEL"
SWITCHES = {"plain stores": "TRUNK_DW_PLAIN_STORES",
            "no dW": "TRUNK_BWD_NO_DW",
            "no dX": "TRUNK_BWD_NO_DX",
            "zero loads": "TRUNK_BWD_NO_LOADS"}
RENDER_SWITCHES = {"no VJP": "ST_RENDER_BWD_NO_VJP",
                   "no second pass": "ST_RENDER_BWD_NO_SECOND_PASS",
                   "recompute": "ST_RENDER_BWD_RECOMPUTE"}
# the one-kernel entries of the measurement build: (symbol, argtypes)
ENTRIES = {"coarse_field": ("coarse_bwd_atomic", [ctypes.c_void_p] * 7
                            + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
           "st_field": ("st_field_bwd_atomic", [ctypes.c_void_p] * 12
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
           "st_render": ("st_render_bwd_atomic", [ctypes.c_void_p] * 13
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])}


def build_copy(source, *defines, out_dir=OUT_DIR):
    """csrc/<source>.cu built with -D<define> for each of ``defines`` → the
    shared library's path."""
    from texpose_tpu_torch.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "-".join((source,) + defines) + ".so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                    *[f"-D{d}" for d in defines], "-o", so,
                    os.path.join(_build.CSRC, f"{source}.cu")], check=True)
    return so


def load_one_kernel(so, source):
    """The built copy of csrc/<source>.cu with its one-kernel entry typed."""
    lib = ctypes.CDLL(so)
    sym, argtypes = ENTRIES[source]
    getattr(lib, sym).argtypes = argtypes
    getattr(lib, sym).restype = ctypes.c_int
    return lib


def coarse_one_kernel(lib, xext, ep, xe, acts, weights, g_rgb, g_dens):
    """``coarse_field_bwd``'s result from the one-kernel form in ``lib``
    (a -DFIELD_BWD_ONE_KERNEL build of csrc/coarse_field.cu)."""
    import torch
    from texpose_tpu_torch.kernels import _build, coarse_field as cf
    M, kx, ke, layout, grads, offs, wT, g_rgb, g_dens = cf._bwd_inputs(
        "coarse_bwd_atomic", xext, ep, xe, acts, weights, g_rgb, g_dens,
        torch.bfloat16)
    _build.check(lib.coarse_bwd_atomic(
        xe.data_ptr(), acts.data_ptr(), g_rgb.data_ptr(), g_dens.data_ptr(),
        wT.data_ptr(), grads.data_ptr(), offs.data_ptr(), M, kx, ke,
        len(weights.trunk), len(weights.rgb),
        sum(1 << s for s in weights.skip), _build.stream_ptr(xext.device)),
        "coarse_bwd_atomic")
    return cf._finish(weights, layout, grads, xext.shape[1], ep.shape[1])


def st_one_kernel(lib, feat, encpts, light, trans, weights, rows_per_img,
                  g_rgb, g_trans):
    """``st_field_bwd``'s result from the one-kernel form in ``lib`` (a
    -DFIELD_BWD_ONE_KERNEL build of csrc/st_field.cu)."""
    import torch
    from texpose_tpu_torch.kernels import _build, st_field as sf
    (wh, bh, wT, ke, ep, lrow, trow, layout, grads, d_lrow,
     d_trow) = sf.bwd_inputs("st_field_bwd_atomic", feat, encpts, light,
                             trans, weights, rows_per_img, torch.bfloat16,
                             (g_rgb, g_trans))
    g_rgb = g_rgb.float().contiguous()
    g_trans = g_trans.float().contiguous()
    feat = feat.contiguous()
    _build.check(lib.st_field_bwd_atomic(
        feat.data_ptr(), ep.data_ptr(), g_rgb.data_ptr(), g_trans.data_ptr(),
        wh.data_ptr(), bh.data_ptr(), wT.data_ptr(), lrow.data_ptr(),
        trow.data_ptr(), grads.data_ptr(), d_lrow.data_ptr(),
        d_trow.data_ptr(), feat.shape[0], ke, int(rows_per_img),
        lrow.shape[0], len(weights.rgb), len(weights.trans),
        _build.stream_ptr(feat.device)), "st_field_bwd_atomic")
    return sf.finish_flat(weights, layout, grads, d_lrow, d_trow, light,
                          trans, encpts.shape[1])


def render_one_kernel(lib, feat, encpts, light, trans, dens, dist, g,
                      weights, rows_per_img):
    """``st_render_bwd``'s result from the one-kernel form in ``lib`` (a
    -DFIELD_BWD_ONE_KERNEL build of csrc/st_render.cu)."""
    import torch
    from texpose_tpu_torch.kernels import _build, st_field as sf
    (wh, bh, wT, ke, ep, lrow, trow, layout, grads, d_lrow,
     d_trow) = sf.bwd_inputs("st_render_bwd_atomic", feat, encpts, light,
                             trans, weights, rows_per_img, torch.bfloat16,
                             (dens, dist, g))
    dens, dist, g = (t.float().contiguous() for t in (dens, dist, g))
    feat = feat.contiguous()
    _build.check(lib.st_render_bwd_atomic(
        feat.data_ptr(), ep.data_ptr(), dens.data_ptr(), dist.data_ptr(),
        g.data_ptr(), wh.data_ptr(), bh.data_ptr(), wT.data_ptr(),
        lrow.data_ptr(), trow.data_ptr(), grads.data_ptr(),
        d_lrow.data_ptr(), d_trow.data_ptr(), feat.shape[0], ke,
        dist.shape[1], int(rows_per_img), lrow.shape[0], len(weights.rgb),
        len(weights.trans), _build.stream_ptr(feat.device)),
        "st_render_bwd_atomic")
    return sf.finish_flat(weights, layout, grads, d_lrow, d_trow, light,
                          trans, encpts.shape[1])


@contextlib.contextmanager
def using(source, lib):
    """Inside the block the package's wrappers launch csrc/<source>.cu's
    kernels from ``lib`` (a measurement build) instead of the package's
    build."""
    import importlib
    from texpose_tpu_torch.kernels import _build
    module = importlib.import_module(f"texpose_tpu_torch.kernels.{source}")
    kept = _build.load(source, module._ARGTYPES)     # the package's own
    _build._libs[source] = lib
    try:
        yield
    finally:
        _build._libs[source] = kept


def time_ms(launch, reps):
    import torch
    for _ in range(3):
        launch()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def coarse_launcher(dev):
    """The pretrain step's field backward inputs → launch(lib)."""
    import torch
    from texpose_tpu_torch.kernels import coarse_field as cf
    from texpose_tpu_torch.kernels.st_field import make_xext
    from texpose_tpu_torch.nn.fields import init_nerf
    from texpose_tpu_torch.ops.render import _dists
    from texpose_tpu_torch.utils.config import load_yaml, process_options

    cfg = process_options(load_yaml(os.path.join(
        HERE, "configs", "nerf_lm_pretrain.yaml")))
    w = init_nerf(cfg, torch.Generator().manual_seed(0)).to(dev) \
        .kernel_weights()
    g = torch.Generator().manual_seed(1)
    BR, N = 2048, 64
    M = BR * N
    pts = (torch.randn(M, 3, generator=g) * 0.5).to(dev)
    xext = make_xext(pts, 10, torch.ones(10, device=dev))
    depth = torch.sort(torch.rand(BR, N, generator=g) * 2 + 3,
                       dim=1).values.to(dev)
    ray = torch.randn(1, BR, 3, generator=g).to(dev)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    with torch.no_grad():
        _, _, _, (xe, acts) = cf.coarse_render_fwd(xext, pts, dist, depth, w,
                                                   want_res=True)
    g_rgb = (torch.randn(M, 3, generator=g) / M).to(dev)
    g_dens = (torch.randn(M, 1, generator=g) / M).to(dev)

    def launch(lib):
        coarse_one_kernel(lib, xext, pts, xe, acts, w, g_rgb, g_dens)

    return launch, M


def st_launcher(dev):
    """The GAN step's heads' backward inputs → launch(lib)."""
    import torch
    from texpose_tpu_torch.kernels import st_field as sf
    from texpose_tpu_torch.nn.fields import init_nerf_st
    from texpose_tpu_torch.utils.config import load_yaml, process_options

    cfg = process_options(load_yaml(os.path.join(
        HERE, "configs", "nerf_lm_adapt_gan.yaml")))
    w = init_nerf_st(cfg, torch.Generator().manual_seed(0)).to(dev) \
        .kernel_weights()
    g = torch.Generator().manual_seed(2)
    B, rpi = 8, 16 * 16 * 64
    M = B * rpi
    pts = (torch.randn(M, 3, generator=g) * 0.5).to(dev)
    xext = sf.make_xext(pts, 10, torch.ones(10, device=dev))
    e3 = 3 + 6 * 4 + 3
    encpts = torch.cat([torch.rand(M, e3 - 3, generator=g).to(dev) * 2 - 1,
                        pts], 1)
    light = torch.randn(B, 48, generator=g).to(dev)
    trans = torch.randn(B, 16, generator=g).to(dev)
    with torch.no_grad():
        *_, feat = sf.st_field_fwd(xext, encpts, light, trans, w, rpi,
                                   want_feat=True)
    g_rgb = (torch.randn(M, 3, generator=g) / M).to(dev)
    g_tr = (torch.randn(M, 5, generator=g) / M).to(dev)

    def launch(lib):
        st_one_kernel(lib, feat, encpts, light, trans, w, rpi, g_rgb, g_tr)

    return launch, M


def render_inputs(dev):
    """The GAN step's render backward inputs (8 images × 256 rays × 64
    samples, the render forward's residuals) → (args of st_render_bwd, M)."""
    import torch
    from texpose_tpu_torch.kernels import st_field as sf
    from texpose_tpu_torch.kernels.st_render import st_render_fwd
    from texpose_tpu_torch.nn.fields import init_nerf_st
    from texpose_tpu_torch.ops.render import _dists
    from texpose_tpu_torch.utils.config import load_yaml, process_options

    cfg = process_options(load_yaml(os.path.join(
        HERE, "configs", "nerf_lm_adapt_gan.yaml")))
    w = init_nerf_st(cfg, torch.Generator().manual_seed(0)).to(dev) \
        .kernel_weights()
    g = torch.Generator().manual_seed(3)
    B, R, N = 8, 256, 64
    M = B * R * N
    pts = (torch.randn(M, 3, generator=g) * 0.5).to(dev)
    xext = sf.make_xext(pts, 10, torch.ones(10, device=dev))
    encpts = torch.cat([torch.rand(M, 27, generator=g).to(dev) * 2 - 1, pts],
                       1)
    light = torch.randn(B, 48, generator=g).to(dev)
    trans = torch.randn(B, 16, generator=g).to(dev)
    depth = torch.sort(torch.rand(B * R, N, generator=g) * 2 + 3,
                       dim=1).values.to(dev)
    ray = torch.randn(1, B * R, 3, generator=g).to(dev)
    dist = _dists(depth.reshape(1, B * R, N, 1), ray).reshape(B * R, N)
    with torch.no_grad():
        _, _, dens, _, feat = st_render_fwd(xext, encpts, light, trans, dist,
                                            depth, w, R * N, want_res=True)
    cot = (torch.randn(B * R, 16, generator=g) / (B * R)).to(dev)
    return (feat, encpts, light, trans, dens, dist, cot, w, R * N), M


def render_attribution(dev, reps):
    """The render backward's switches against their builds in turns, in
    the split form (the package's build; the switch builds swapped in with
    ``using``) and the one-kernel form (its -DFIELD_BWD_ONE_KERNEL build)
    → {form: {switch: [build ms, switch ms, switch ms, build ms]}}."""
    import torch
    from texpose_tpu_torch.kernels import st_render as sr
    jobs = [(d,) for d in RENDER_SWITCHES.values()] + [(ONE_KERNEL,)] + [
        (ONE_KERNEL, d) for d in RENDER_SWITCHES.values()
        if d != "ST_RENDER_BWD_RECOMPUTE"]
    with ThreadPoolExecutor(len(jobs)) as pool:        # one nvcc per copy
        copies = dict(zip(jobs, pool.map(
            lambda job: build_copy("st_render", *job), jobs)))
    args, M = render_inputs(dev)
    out = {"split": {}, "one-kernel": {}}
    with torch.no_grad():
        sr.st_render_bwd(*args)                      # builds the package's
        for label, define in RENDER_SWITCHES.items():
            lib = ctypes.CDLL(copies[define,])

            def switched(lib=lib):
                with using("st_render", lib):
                    return sr.st_render_bwd(*args)

            lib.st_render_bwd_dx.argtypes = sr._ARGTYPES["st_render_bwd_dx"]
            lib.st_render_bwd_dx.restype = ctypes.c_int
            ms = [time_ms(f, reps) for f in (lambda: sr.st_render_bwd(*args),
                                              switched, switched,
                                              lambda: sr.st_render_bwd(*args))]
            out["split"][label] = ms
            print(f"render attribution: split form at M={M}: build / {label}"
                  f" / {label} / build {ms[0]:.4f} / {ms[1]:.4f} / "
                  f"{ms[2]:.4f} / {ms[3]:.4f} ms (medians of {reps}, incl. "
                  "the dW GEMM and the wrapper's staging)", flush=True)
        base = load_one_kernel(copies[ONE_KERNEL,], "st_render")
        for label, define in RENDER_SWITCHES.items():
            if (ONE_KERNEL, define) not in copies:
                continue
            lib = load_one_kernel(copies[ONE_KERNEL, define], "st_render")
            ms = [time_ms(lambda lb=lb: render_one_kernel(lb, *args), reps)
                  for lb in (base, lib, lib, base)]
            out["one-kernel"][label] = ms
            print(f"render attribution: one-kernel form at M={M}: build / "
                  f"{label} / {label} / build {ms[0]:.4f} / {ms[1]:.4f} / "
                  f"{ms[2]:.4f} / {ms[3]:.4f} ms (medians of {reps})",
                  flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--render", action="store_true",
                    help="time the render backward's switches instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_field_bwd_atomics: needs a CUDA device")
    sys.modules["jax"] = None
    sys.modules["texpose_tpu"] = None
    sys.path.insert(0, HERE)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    if args.render:
        render_attribution(dev, args.reps)
        return
    kernels = {"coarse_field": ("coarse_bwd_kernel", coarse_launcher),
               "st_field": ("st_field_bwd_kernel", st_launcher)}
    jobs = [(src, ONE_KERNEL) + d for src in kernels
            for d in [()] + [(d,) for d in SWITCHES.values()]]
    with ThreadPoolExecutor(len(jobs)) as pool:        # one nvcc per copy
        copies = dict(zip(jobs, pool.map(lambda job: build_copy(*job),
                                         jobs)))
    for src, (kname, make) in kernels.items():
        libs = {"one-kernel": load_one_kernel(copies[src, ONE_KERNEL], src)}
        for label, define in SWITCHES.items():
            libs[label] = load_one_kernel(copies[src, ONE_KERNEL, define], src)
        launch, M = make(dev)
        for label in SWITCHES:
            for name in ("one-kernel", label, label, "one-kernel"):
                ms = time_ms(lambda: launch(libs[name]), args.reps)
                print(f"probe: {kname} ({name}) {ms:.4f} ms (M={M}, median "
                      f"of {args.reps}, incl. the wrapper's staging)",
                      flush=True)
        del launch
        torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
