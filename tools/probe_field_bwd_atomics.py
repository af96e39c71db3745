#!/usr/bin/env python3
"""How much of the trunk-training backward kernel's time (csrc/coarse_field.cu
``coarse_bwd_kernel``) its cross-tile f32 atomics take, on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/probe_field_bwd_atomics.py [--reps 20]

Builds csrc/coarse_field.cu a second time into build/probe_atomics/, with
TRUNK_DW_PLAIN_STORES defined: every dW partial of ``warp_dw``
(csrc/trunk.cuh) is then written with a plain store instead of ``atomicAdd``
— the sums come out wrong, the products, residual reads and bytes written
stay — then times the shipped kernel and that build on the pretrain step's
shape (131,072 rows, the full width of configs/nerf_lm_pretrain.yaml), in
turns (shipped, copy, copy, shipped), CUDA-event medians.  Prints one line
per run and the card's name and power limit.  The copy is a measurement
device only: nothing in the package uses it.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_copy(out_dir):
    """csrc/coarse_field.cu with warp_dw's atomics as plain stores → the
    shared library's path."""
    from texpose_tpu_torch.kernels import _build
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "coarse_field_no_atomics.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                    "-DTRUNK_DW_PLAIN_STORES", "-o", so,
                    os.path.join(_build.CSRC, "coarse_field.cu")], check=True)
    return so


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_field_bwd_atomics: needs a CUDA device")
    sys.modules["jax"] = None
    sys.modules["texpose_tpu"] = None
    sys.path.insert(0, HERE)
    from texpose_tpu_torch.kernels import _build, coarse_field as cf
    from texpose_tpu_torch.kernels.st_field import make_xext
    from texpose_tpu_torch.nn.fields import init_nerf
    from texpose_tpu_torch.ops.render import _dists
    from texpose_tpu_torch.utils.config import load_yaml, process_options

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
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
    kx, ke = cf._ceil16(xext.shape[1]), cf._ceil16(pts.shape[1])
    wT = w.kernel_buffer_bwd(xext.shape[1], 3)
    _, offs, total = w.grad_layout(kx, ke)
    offs = torch.tensor(offs, dtype=torch.int32, device=dev)
    grads = torch.zeros(total, dtype=torch.float32, device=dev)
    libs = {"shipped": _build.load("coarse_field", cf._ARGTYPES)}
    copy = ctypes.CDLL(build_copy(os.path.join(HERE, "build",
                                               "probe_atomics")))
    copy.coarse_bwd.argtypes = cf._ARGTYPES["coarse_bwd"]
    copy.coarse_bwd.restype = ctypes.c_int
    libs["plain stores"] = copy
    skip_mask = sum(1 << s for s in w.skip)

    def launch(lib):
        grads.zero_()
        _build.check(lib.coarse_bwd(
            xe.data_ptr(), acts.data_ptr(), g_rgb.data_ptr(),
            g_dens.data_ptr(), wT.data_ptr(), grads.data_ptr(),
            offs.data_ptr(), M, kx, ke, len(w.trunk), len(w.rgb), skip_mask,
            _build.stream_ptr(dev)), "coarse_bwd")

    def time_ms(lib):
        for _ in range(3):
            launch(lib)
        out = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(lib)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)

    for name in ("shipped", "plain stores", "plain stores", "shipped"):
        print(f"probe: coarse_bwd_kernel ({name}) {time_ms(libs[name]):.4f} "
              f"ms (M={M}, median of {args.reps}, incl. zeroing the 2.8 MB "
              f"gradient)", flush=True)


if __name__ == "__main__":
    main()
