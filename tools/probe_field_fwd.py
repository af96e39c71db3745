#!/usr/bin/env python3
"""Where the field forwards' time goes in their mma.sync form, on one GPU:
the ST field forward (row 1, csrc/st_field.cu) and the coarse field +
composite forward (row 8, csrc/coarse_field.cu); and the mma.sync form of
the trunk forward (row 10, csrc/trunk_fwd.cu) beside the others.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/probe_field_fwd.py [--reps 20]

The package ships the wgmma + TMA forwards (csrc/field_fwd.cuh).  The
mma.sync forms they replaced are compiled only in the measurement build
-DFIELD_FWD_MMA_SYNC (entries st_field_fwd_mma, st_render_fwd_mma,
coarse_fwd_mma, coarse_field_fwd_mma, trunk_fwd_mma), into
build/probe_fwd/, beside st_render_recompute_mma, the render backward's
(row 6b) mma.sync recompute of the heads' raw outputs; ``build_mma``,
``load_mma`` and the ``*_mma`` launchers below build and launch them on
the fragment packs of ``mma_buffers`` (the package keeps only the heads'
packs its backwards read; the trunk's is built here, ``trunk_pack``), and
chip_smoke.py uses them for its in-call comparison of the two forms (rows
1, 6f, 7a, 8 and 10), for the 6f / 6b raw-output difference, for both
designs' L2 weight bytes (``l2_bytes``, ``trunk_l2_bytes``) and, through
``attribution``, for the table below.  This script builds them once more per measurement switch of
csrc/trunk.cuh (all nvcc runs in parallel):
  no weight loads     TRUNK_FWD_NO_WEIGHT_LOADS: each warp_gemm fetches its
                      first k-step's B fragments and reuses them (the L2
                      weight traffic gone, the products kept);
  no residual stores  TRUNK_FWD_NO_RES_STORES: the residual tiles are not
                      stored (row 8's training launch);
  no epilogue         TRUNK_FWD_NO_EPILOGUE: the hidden layers' bias, ReLU
                      and bf16 stores to shared memory skipped.
With --new it times the wgmma forward's own switches (csrc/field_fwd.cuh:
FIELD_FWD_NO_WEIGHT_LOADS, FIELD_FWD_NO_WGMMA, FIELD_FWD_NO_EPILOGUE)
against the package's build instead, through the package's wrappers.
Each switch's results are wrong; only the time means something.  Each is
timed against the mma.sync build (the package's, with --new) in turns
(mma.sync, switch, switch, mma.sync), CUDA-event medians, at 131,072
rows: row 1's evaluation launch (one 2048-ray × 64-sample chunk) at the
full width of configs/nerf_lm_adapt_gan.yaml, row 8's training launch (with the 11
residual planes) and evaluation launch on the pretrain step's 2048 rays ×
64 samples at the full width of configs/nerf_lm_pretrain.yaml.  Also
prints ``ptxas -v`` (registers, spills) of both forms' kernels, one line
per run (the shipped builds' and the measurement builds') and the card's
name and power limit.  The copies are measurement devices only: nothing in
the package uses them.
"""

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from probe_field_bwd_atomics import build_copy, time_ms, using  # noqa: E402

OUT_DIR = os.path.join(HERE, "build", "probe_fwd")
MMA = "FIELD_FWD_MMA_SYNC"
SWITCHES = {"no weight loads": "TRUNK_FWD_NO_WEIGHT_LOADS",
            "no residual stores": "TRUNK_FWD_NO_RES_STORES",
            "no epilogue": "TRUNK_FWD_NO_EPILOGUE"}
# the mma.sync entries of the measurement build: {source: {symbol: argtypes}}
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    "st_field": {"st_field_fwd_mma": [_P] * 11 + [_I] * 9 + [_P]},
    "st_render": {"st_render_fwd_mma": [_P] * 14 + [_I] * 10
                  + [ctypes.c_float, _P],
                  "st_render_recompute_mma": [_P] * 8 + [_I] * 6 + [_P]},
    "coarse_field": {"coarse_fwd_mma": [_P] * 11 + [_I] * 7 + [_P],
                     "coarse_field_fwd_mma": [_P] * 8 + [_I] * 6 + [_P]},
    "trunk_fwd": {"trunk_fwd_mma": [_P] * 5 + [_I] * 4 + [_P]},
}


def build_mma(source, *defines):
    """csrc/<source>.cu built with -DFIELD_FWD_MMA_SYNC (and ``defines``)
    → the shared library's path."""
    return build_copy(source, MMA, *defines, out_dir=OUT_DIR)


def load_mma(so, source):
    """The built copy of csrc/<source>.cu with its mma.sync entries typed."""
    lib = ctypes.CDLL(so)
    for sym, argtypes in ENTRIES[source].items():
        getattr(lib, sym).argtypes = argtypes
        getattr(lib, sym).restype = ctypes.c_int
    return lib


# the wgmma forward's measurement switches (csrc/field_fwd.cuh)
NEW_SWITCHES = {"no weight loads": "FIELD_FWD_NO_WEIGHT_LOADS",
                "no wgmma": "FIELD_FWD_NO_WGMMA",
                "no epilogue": "FIELD_FWD_NO_EPILOGUE"}


def load_new(so, source):
    """A build of csrc/<source>.cu with its wgmma forward entries typed."""
    from texpose_tpu_torch.kernels import field_fwd
    entries = {"st_field": ("st_field_fwd",), "st_render": ("st_render_fwd",),
               "coarse_field": ("coarse_fwd", "coarse_field_fwd"),
               "trunk_fwd": ("trunk_fwd",)}[source]
    lib = ctypes.CDLL(so)
    for sym in entries:
        getattr(lib, sym).argtypes = field_fwd.ARGTYPES
        getattr(lib, sym).restype = ctypes.c_int
    return lib


def ptxas_report(source, *defines):
    """``ptxas -v`` of csrc/<source>.cu's kernels: one line per kernel with
    its registers, stack frame and spills."""
    from texpose_tpu_torch.kernels import _build
    os.makedirs(OUT_DIR, exist_ok=True)
    obj = os.path.join(OUT_DIR, "-".join((source,) + defines) + ".o")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",)]
    proc = subprocess.run(
        [_build.find_nvcc(), *flags, "-Xptxas", "-v", "-c",
         *[f"-D{d}" for d in defines], "-o", obj,
         os.path.join(_build.CSRC, f"{source}.cu")],
        capture_output=True, text=True, check=True)
    out, kernel = [], None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif kernel and ("registers" in line or "spill" in line
                         or "stack frame" in line):
            out.append(f"{source}{'+' + '+'.join(defines) if defines else ''}"
                       f" {kernel}: {line.split(':', 1)[-1].strip()}")
    return out


def _check(err, what):
    from texpose_tpu_torch.kernels import _build
    _build.check(err, what)


def trunk_pack(weights, xw):
    """(wpack bf16, bias f32, kx) of the trunk in the mma.sync kernels' walk
    order (kernels/st_field.py ``_pack_layer``): each layer, the last split
    into its 256 feature columns and one density n8 tile; kept with the
    field's packs while its trunk is unchanged."""
    import torch
    from texpose_tpu_torch.kernels.st_field import (
        HIDDEN, _OUT_TILE, _cat_packs, _ceil16, _pack_layer, _pad_bias,
        check_trunk)
    kx = _ceil16(xw)

    def build():
        check_trunk(weights.trunk, weights.skip, xw, weights._bad)
        H, n = HIDDEN, len(weights.trunk)
        ws, bs = [], []
        for li, layer in enumerate(weights.trunk):
            segs = ([(0, xw, kx)] if li == 0 else
                    [(0, H, H), (H, H + xw, kx)] if li in weights.skip else
                    [(0, H, H)])
            if li < n - 1:
                ws.append(_pack_layer(layer.w, segs, H, H))
                bs.append(layer.b)
            else:
                ws.append(_pack_layer(layer.w[:, 1:], segs, H, H))
                bs.append(layer.b[1:])
                ws.append(_pack_layer(layer.w[:, :1], segs, 1, _OUT_TILE))
                bs.append(_pad_bias(layer.b[:1], _OUT_TILE))
        return _cat_packs(ws), _cat_packs(bs, torch.float32)

    return weights._cached("trunk_mma", (xw,), weights.trunk, build) + (kx,)


def mma_buffers(weights, xw, e3):
    """The mma.sync forwards' fragment packs (kernels/st_field.py
    ``_pack_layer``): (trunk wpack bf16, trunk bias f32, heads wpack, heads
    bias, kx, ke).  The trunk's is ``trunk_pack``; an ST field's heads pack
    is its backward's; a coarse field's RGB head pack is built here, kept
    with the field's packs while its tensors are unchanged."""
    import torch
    from texpose_tpu_torch.kernels.st_field import (HIDDEN, _cat_packs,
                                                    _ceil16, pack_head)
    wpack, bias, kx = trunk_pack(weights, xw)
    if hasattr(weights, "trans"):
        wh, bh, _, ke = weights.kernel_buffers_bwd(e3)
        return wpack, bias, wh, bh, kx, ke
    ke = _ceil16(e3)

    def build_rgb():
        w, b = pack_head(weights.rgb, [(0, HIDDEN, HIDDEN),
                                       (HIDDEN, HIDDEN + e3, ke)])
        return _cat_packs(w), _cat_packs(b, torch.float32)

    return (wpack, bias) + weights._cached("rgb_mma", (xw, e3), weights.rgb,
                                           build_rgb) + (kx, ke)


def l2_bytes(weights, xw, e3, M):
    """The L2 weight bytes of a field forward at M rows: (the wgmma design:
    every 128-row tile streams the walk's slices once, kernels/field_fwd.py
    ``l2_weight_bytes``; the mma.sync design: every 64-row tile read its
    whole fragment packs)."""
    from texpose_tpu_torch.kernels.field_fwd import l2_weight_bytes
    wpack, _, wh, _, _, _ = mma_buffers(weights, xw, e3)
    return (l2_weight_bytes(weights.fwd_walk(xw, e3), M),
            -(-M // 64) * 2 * (wpack.numel() + wh.numel()))


def trunk_l2_bytes(weights, xw, M):
    """The trunk forward's L2 weight bytes at M rows: (the wgmma design's,
    ``l2_weight_bytes`` of the trunk walk; the mma.sync design's, every
    64-row tile reading the whole trunk pack)."""
    from texpose_tpu_torch.kernels.field_fwd import l2_weight_bytes
    wpack, _, _ = trunk_pack(weights, xw)
    return (l2_weight_bytes(weights.trunk_walk(xw), M),
            -(-M // 64) * 2 * wpack.numel())


def trunk_mma(lib, xext, weights):
    """``trunk_fwd``'s result (feat [M,256] bf16, dens_raw [M]) from the
    mma.sync form in ``lib``."""
    import torch
    from texpose_tpu_torch.kernels import _build
    M, xw = xext.shape
    dev = xext.device
    wpack, bias, kx = trunk_pack(weights, xw)
    x = torch.zeros((M, kx), dtype=torch.bfloat16, device=dev)
    x[:, :xw] = xext
    feat = torch.empty((M, 256), dtype=torch.bfloat16, device=dev)
    dens = torch.empty((M,), dtype=torch.float32, device=dev)
    _check(lib.trunk_fwd_mma(
        x.data_ptr(), wpack.data_ptr(), bias.data_ptr(), feat.data_ptr(),
        dens.data_ptr(), M, kx, len(weights.trunk),
        sum(1 << s for s in weights.skip), _build.stream_ptr(dev)),
        "trunk_fwd_mma")
    return feat, dens


def st_field_mma(lib, xext, encpts, light, trans, weights, rows_per_img,
                 want_feat=False):
    """``st_field_fwd``'s result from the mma.sync form in ``lib``."""
    import torch
    from texpose_tpu_torch.kernels import _build
    from texpose_tpu_torch.kernels.st_field import _latent_rows, stage_rows
    M, xw = xext.shape
    e3 = encpts.shape[1]
    dev = xext.device
    wpack, bias, wh, bh, kx, ke = mma_buffers(weights, xw, e3)
    lrow, trow = (t.float().contiguous() for t in _latent_rows(
        weights, light, trans, e3, torch.bfloat16))
    xe = stage_rows(xext, encpts, kx, ke)
    rgb = torch.empty((M, 3), device=dev)
    dens = torch.empty((M, 1), device=dev)
    tr = torch.empty((M, 5), device=dev)
    feat = (torch.empty((M, 256), dtype=torch.bfloat16, device=dev)
            if want_feat else None)
    _check(lib.st_field_fwd_mma(
        xe.data_ptr(), wpack.data_ptr(), bias.data_ptr(), wh.data_ptr(),
        bh.data_ptr(), lrow.data_ptr(), trow.data_ptr(), rgb.data_ptr(),
        dens.data_ptr(), tr.data_ptr(),
        feat.data_ptr() if feat is not None else None, M, kx, ke,
        int(rows_per_img), lrow.shape[0], len(weights.trunk),
        len(weights.rgb), len(weights.trans),
        sum(1 << s for s in weights.skip), _build.stream_ptr(dev)),
        "st_field_fwd_mma")
    return (rgb, dens, tr, feat) if want_feat else (rgb, dens, tr)


def st_render_mma(lib, xext, encpts, light, trans, dist, depth, weights,
                  rows_per_img, min_uncert=0.05, want_res=False):
    """``st_render_fwd``'s result from the mma.sync form in ``lib``."""
    import torch
    from texpose_tpu_torch.kernels import _build
    from texpose_tpu_torch.kernels.st_field import _latent_rows, stage_rows
    M, xw = xext.shape
    e3 = encpts.shape[1]
    BR, N = dist.shape
    dev = xext.device
    wpack, bias, wh, bh, kx, ke = mma_buffers(weights, xw, e3)
    lrow, trow = (t.float().contiguous() for t in _latent_rows(
        weights, light, trans, e3, torch.bfloat16))
    xe = stage_rows(xext, encpts, kx, ke)
    dist, depth = dist.float().contiguous(), depth.float().contiguous()
    out = torch.empty((BR, 16), device=dev)
    rgb = torch.empty((M, 3), device=dev)
    dens = torch.empty((M, 1), device=dev)
    tr = torch.empty((M, 5), device=dev)
    feat = (torch.empty((M, 256), dtype=torch.bfloat16, device=dev)
            if want_res else None)
    _check(lib.st_render_fwd_mma(
        xe.data_ptr(), wpack.data_ptr(), bias.data_ptr(), wh.data_ptr(),
        bh.data_ptr(), lrow.data_ptr(), trow.data_ptr(), dist.data_ptr(),
        depth.data_ptr(), out.data_ptr(), rgb.data_ptr(), dens.data_ptr(),
        tr.data_ptr(), feat.data_ptr() if feat is not None else None, M, kx,
        ke, N, int(rows_per_img), lrow.shape[0], len(weights.trunk),
        len(weights.rgb), len(weights.trans),
        sum(1 << s for s in weights.skip), float(min_uncert),
        _build.stream_ptr(dev)), "st_render_fwd_mma")
    return (out, rgb, dens, tr, feat) if want_res else out


def st_recompute_mma(lib, feat, encpts, light, trans, weights,
                     rows_per_img):
    """(rgb_raw [M,3], trans_raw [M,5]) as the render backward (row 6b)
    recomputes them from the feature residual on mma.sync, from the
    measurement entry in ``lib`` (st_render.cu)."""
    import torch
    from texpose_tpu_torch.kernels import _build
    from texpose_tpu_torch.kernels.st_field import _latent_rows
    M, e3 = feat.shape[0], encpts.shape[1]
    dev = feat.device
    wh, bh, _, ke = weights.kernel_buffers_bwd(e3)
    lrow, trow = (t.float().contiguous() for t in _latent_rows(
        weights, light, trans, e3, torch.bfloat16))
    ep = torch.zeros((M, ke), dtype=torch.bfloat16, device=dev)
    ep[:, :e3] = encpts
    rgb = torch.empty((M, 3), device=dev)
    tr = torch.empty((M, 5), device=dev)
    feat = feat.contiguous()
    _check(lib.st_render_recompute_mma(
        feat.data_ptr(), ep.data_ptr(), wh.data_ptr(), bh.data_ptr(),
        lrow.data_ptr(), trow.data_ptr(), rgb.data_ptr(), tr.data_ptr(), M,
        ke, int(rows_per_img), lrow.shape[0], len(weights.rgb),
        len(weights.trans), _build.stream_ptr(dev)),
        "st_render_recompute_mma")
    return rgb, tr


def coarse_render_mma(lib, xext, ep, dist, depth, weights, want_res=False):
    """``coarse_render_fwd``'s result from the mma.sync form in ``lib``."""
    import torch
    from texpose_tpu_torch.kernels import _build
    from texpose_tpu_torch.kernels.st_field import stage_rows
    M, xw = xext.shape
    BR, N = dist.shape
    dev = xext.device
    wpack, bias, wr, br, kx, ke = mma_buffers(weights, xw, ep.shape[1])
    xe = stage_rows(xext, ep, kx, ke)
    dist, depth = dist.float().contiguous(), depth.float().contiguous()
    out = torch.empty((BR, 8), device=dev)
    rgb = torch.empty((M, 3), device=dev)
    dens = torch.empty((M, 1), device=dev)
    n_res = len(weights.trunk) + len(weights.rgb) - 1
    acts = (torch.empty((n_res, M, 256), dtype=torch.bfloat16, device=dev)
            if want_res else None)
    _check(lib.coarse_fwd_mma(
        xe.data_ptr(), wpack.data_ptr(), bias.data_ptr(), wr.data_ptr(),
        br.data_ptr(), dist.data_ptr(), depth.data_ptr(), out.data_ptr(),
        rgb.data_ptr(), dens.data_ptr(),
        acts.data_ptr() if acts is not None else None, M, kx, ke, N,
        len(weights.trunk), len(weights.rgb),
        sum(1 << s for s in weights.skip), _build.stream_ptr(dev)),
        "coarse_fwd_mma")
    return (out, rgb, dens, (xe, acts)) if want_res else out


def coarse_field_mma(lib, xext, ep, weights, want_res=False):
    """``coarse_field_fwd``'s result from the mma.sync form in ``lib``."""
    import torch
    from texpose_tpu_torch.kernels import _build
    from texpose_tpu_torch.kernels.st_field import stage_rows
    M, xw = xext.shape
    dev = xext.device
    wpack, bias, wr, br, kx, ke = mma_buffers(weights, xw, ep.shape[1])
    xe = stage_rows(xext, ep, kx, ke)
    rgb = torch.empty((M, 3), device=dev)
    dens = torch.empty((M, 1), device=dev)
    n_res = len(weights.trunk) + len(weights.rgb) - 1
    acts = (torch.empty((n_res, M, 256), dtype=torch.bfloat16, device=dev)
            if want_res else None)
    _check(lib.coarse_field_fwd_mma(
        xe.data_ptr(), wpack.data_ptr(), bias.data_ptr(), wr.data_ptr(),
        br.data_ptr(), rgb.data_ptr(), dens.data_ptr(),
        acts.data_ptr() if acts is not None else None, M, kx, ke,
        len(weights.trunk), len(weights.rgb),
        sum(1 << s for s in weights.skip), _build.stream_ptr(dev)),
        "coarse_field_fwd_mma")
    return (rgb, dens, (xe, acts)) if want_res else (rgb, dens)


def st_inputs(dev, seed=0):
    """Row 1's evaluation launch: one image's 2048 rays × 64 samples at the
    full width of configs/nerf_lm_adapt_gan.yaml → (args of st_field_fwd
    without compute_dtype, M)."""
    import torch
    from texpose_tpu_torch.kernels.st_field import make_xext
    from texpose_tpu_torch.nn.fields import init_nerf_st
    from texpose_tpu_torch.utils.config import load_yaml, process_options
    cfg = process_options(load_yaml(os.path.join(
        HERE, "configs", "nerf_lm_adapt_gan.yaml")))
    w = init_nerf_st(cfg, torch.Generator().manual_seed(0)).to(dev) \
        .kernel_weights()
    g = torch.Generator().manual_seed(seed + 1)
    M = 2048 * 64
    pts = (torch.randn(M, 3, generator=g) * 0.5).to(dev)
    xext = make_xext(pts, 10, torch.ones(10, device=dev))
    encpts = torch.cat([torch.rand(M, 27, generator=g).to(dev) * 2 - 1, pts],
                       1)
    light = torch.randn(1, 48, generator=g).to(dev)
    trans = torch.randn(1, 16, generator=g).to(dev)
    return (xext, encpts, light, trans, w, M), M


def coarse_inputs(dev, seed=0):
    """Row 8's launches: the pretrain step's 2048 rays × 64 samples at the
    full width of configs/nerf_lm_pretrain.yaml → (xext, ep, dist, depth,
    weights)."""
    import torch
    from texpose_tpu_torch.kernels.st_field import make_xext
    from texpose_tpu_torch.nn.fields import init_nerf
    from texpose_tpu_torch.ops.render import _dists
    from texpose_tpu_torch.utils.config import load_yaml, process_options
    cfg = process_options(load_yaml(os.path.join(
        HERE, "configs", "nerf_lm_pretrain.yaml")))
    w = init_nerf(cfg, torch.Generator().manual_seed(0)).to(dev) \
        .kernel_weights()
    g = torch.Generator().manual_seed(seed + 1)
    BR, N = 2048, 64
    pts = (torch.randn(BR * N, 3, generator=g) * 0.5).to(dev)
    xext = make_xext(pts, 10, torch.ones(10, device=dev))
    depth = torch.sort(torch.rand(BR, N, generator=g) * 2 + 3,
                       dim=1).values.to(dev)
    ray = torch.randn(1, BR, 3, generator=g).to(dev)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    return xext, pts, dist, depth, w


def switch_copies():
    """(source, defines) of the switch builds: st_field.cu and
    coarse_field.cu with each of SWITCHES (built with build_mma)."""
    return [(src, d) for src in ("st_field", "coarse_field")
            for d in SWITCHES.values()]


def attribution(dev, libs, reps=20):
    """Step 1: each switch's build against the mma.sync build in turns →
    {run: {switch: [mma.sync ms, switch ms, switch ms, mma.sync ms]}}.
    libs: {(source, define or None): loaded library} for st_field and
    coarse_field, the mma.sync builds under None."""
    import torch
    st_args, M = st_inputs(dev)
    xext, ep, dist, depth, w = coarse_inputs(dev)
    runs = {
        "row 1, eval": ("st_field", lambda lib: st_field_mma(lib, *st_args)),
        "row 8, training": ("coarse_field", lambda lib: coarse_render_mma(
            lib, xext, ep, dist, depth, w, want_res=True)),
        "row 8, eval": ("coarse_field", lambda lib: coarse_render_mma(
            lib, xext, ep, dist, depth, w)),
    }
    out = {}
    with torch.no_grad():
        for what, (src, launch) in runs.items():
            out[what] = {}
            for label, define in SWITCHES.items():
                if label == "no residual stores" and "training" not in what:
                    continue
                order = (None, define, define, None)
                ms = [time_ms(lambda: launch(libs[src, d]), reps)
                      for d in order]
                out[what][label] = ms
                print(f"step 1: {what} at M={M}: mma.sync / {label} / "
                      f"{label} / mma.sync {ms[0]:.4f} / {ms[1]:.4f} / "
                      f"{ms[2]:.4f} / {ms[3]:.4f} ms (medians of {reps}, "
                      "incl. the wrapper's staging)", flush=True)
    return out


def new_copies():
    """(source, define) of the wgmma forward's switch builds: st_field.cu
    and coarse_field.cu with each of NEW_SWITCHES (built with build_copy
    into build/probe_fwd/, no FIELD_FWD_MMA_SYNC)."""
    return [(src, d) for src in ("st_field", "coarse_field")
            for d in NEW_SWITCHES.values()]


def attribution_new(dev, libs, reps=20):
    """Where the wgmma forwards' time goes: each of NEW_SWITCHES against
    the package's build in turns → {run: {switch: [shipped ms, switch ms,
    switch ms, shipped ms]}}.  libs: {(source, define): library loaded with
    load_new}."""
    import torch
    from texpose_tpu_torch.kernels.coarse_field import coarse_render_fwd
    from texpose_tpu_torch.kernels.st_field import st_field_fwd
    st_args, M = st_inputs(dev)
    xext, ep, dist, depth, w = coarse_inputs(dev)
    runs = {
        "row 1, eval": ("st_field", lambda: st_field_fwd(*st_args)),
        "row 8, training": ("coarse_field", lambda: coarse_render_fwd(
            xext, ep, dist, depth, w, want_res=True)),
        "row 8, eval": ("coarse_field", lambda: coarse_render_fwd(
            xext, ep, dist, depth, w)),
    }
    out = {}
    with torch.no_grad():
        for what, (src, launch) in runs.items():
            out[what] = {}
            for label, define in NEW_SWITCHES.items():
                def switched():
                    with using(src, libs[src, define]):
                        return launch()
                ms = [time_ms(f, reps)
                      for f in (launch, switched, switched, launch)]
                out[what][label] = ms
                print(f"wgmma attribution: {what} at M={M}: wgmma / {label} "
                      f"/ {label} / wgmma {ms[0]:.4f} / {ms[1]:.4f} / "
                      f"{ms[2]:.4f} / {ms[3]:.4f} ms (medians of {reps})",
                      flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--new", action="store_true",
                    help="time the wgmma forward's switches instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_field_fwd: needs a CUDA device")
    sys.modules["jax"] = None
    sys.modules["texpose_tpu"] = None
    sys.path.insert(0, HERE)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    if args.new:
        with ThreadPoolExecutor(len(new_copies())) as pool:
            paths = pool.map(lambda c: build_copy(*c, out_dir=OUT_DIR),
                             new_copies())
            libs = {c: load_new(path, c[0])
                    for c, path in zip(new_copies(), paths)}
        attribution_new(dev, libs, args.reps)
        return
    jobs = [(src,) for src in ("st_field", "coarse_field")] + switch_copies()
    srcs = ("st_field", "coarse_field", "st_render", "trunk_fwd")
    reports = [(src,) for src in srcs] + [(src, MMA) for src in srcs]
    with ThreadPoolExecutor(len(jobs) + len(reports)) as pool:
        copies = dict(zip(jobs, pool.map(lambda job: build_mma(*job), jobs)))
        for lines in pool.map(lambda job: ptxas_report(*job), reports):
            for line in lines:
                print(f"ptxas: {line}", flush=True)
    libs = {(job[0], job[1] if len(job) > 1 else None):
            load_mma(path, job[0]) for job, path in copies.items()}
    attribution(dev, libs, args.reps)


if __name__ == "__main__":
    main()
