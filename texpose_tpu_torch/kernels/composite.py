"""Dual-density (NeRF-W) composite forward: the CUDA kernel's wrapper and its
plain-PyTorch twin.

Replaces texpose_tpu/kernels/fused_composite.py (``fused_composite_st``
forward, ``_run_fwd``).  The kernel is ``csrc/composite.cu``; its header
says what bounds it on the card and how its design answers that.

Activations match texpose_tpu.nn.fields.apply_nerf_st_fused: sigmoid
colors, softplus static density, transient density and uncertainty.
Packed output columns [BR,16]:
  0-2 rgb | 3-5 rgb_static | 6-8 rgb_transient | 9 depth | 10 opacity
  11 opacity_static | 12 opacity_transient | 13 uncert
  14 sum_n softplus(transient density raw) | 15 zero
"""

from __future__ import annotations

import ctypes

import torch

from ..nn.mlp import softplus
from ..ops.render import _dists, _transmittance
from . import _build

N_OUT = 16


def composite_st_plain(rgb_raw, trans_raw, dens_raw, depth, dist,
                       min_uncert=0.05):
    """rgb_raw [BR·N,3], trans_raw [BR·N,5], dens_raw [BR·N,1], depth and
    dist [BR,N] → packed [BR,16]."""
    BR, N = depth.shape
    cs = torch.sigmoid(rgb_raw).reshape(BR, N, 3)
    ct = torch.sigmoid(trans_raw[:, :3]).reshape(BR, N, 3)
    dens_t = softplus(trans_raw[:, 3]).reshape(BR, N)
    u = softplus(trans_raw[:, 4]).reshape(BR, N)
    sds = softplus(dens_raw[:, 0]).reshape(BR, N) * dist
    sdt = dens_t * dist
    sd = sds + sdt
    T, T_s, T_t = (_transmittance(x) for x in (sd, sds, sdt))
    a_s = 1.0 - torch.exp(-sds)
    a_t = 1.0 - torch.exp(-sdt)
    a = 1.0 - torch.exp(-sd)
    ps, pt, p = T * a_s, T * a_t, T * a
    ws, wt = T_s * a_s, T_t * a_t
    cols = [(ps[..., None] * cs + pt[..., None] * ct).sum(1),
            (ws[..., None] * cs).sum(1),
            (wt[..., None] * ct).sum(1),
            (ws * depth).sum(1, keepdim=True),
            p.sum(1, keepdim=True),
            ws.sum(1, keepdim=True),
            wt.sum(1, keepdim=True),
            (u * pt).sum(1, keepdim=True) + min_uncert,
            dens_t.sum(1, keepdim=True),
            torch.zeros_like(dist[:, :1])]
    return torch.cat(cols, dim=1)


_ARGTYPES = {"composite_st_fwd": [ctypes.c_void_p] * 5
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p]}


def composite_st_fwd(rgb_raw, trans_raw, dens_raw, depth, dist,
                     min_uncert=0.05):
    """Packed [BR,16] composite.  CPU tensors take ``composite_st_plain``;
    CUDA tensors launch the kernel or raise."""
    if rgb_raw.device.type == "cpu":
        return composite_st_plain(rgb_raw, trans_raw, dens_raw, depth, dist,
                                  min_uncert)
    if rgb_raw.device.type != "cuda":
        raise ValueError(f"composite_st_fwd: no kernel for {rgb_raw.device}")
    BR, N = depth.shape
    M = BR * N
    args = (rgb_raw, trans_raw, dens_raw, depth, dist)
    for x, numel in zip(args, (3 * M, 5 * M, M, M, M)):
        if (x.dtype != torch.float32 or x.device != rgb_raw.device
                or x.numel() != numel):
            raise ValueError("composite_st_fwd: expects float32 CUDA "
                             f"tensors of {M} samples, got {x.dtype} "
                             f"{tuple(x.shape)}")
    args = [x.contiguous() for x in args]
    out = torch.empty((BR, N_OUT), dtype=torch.float32,
                      device=rgb_raw.device)
    lib = _build.load("composite", _ARGTYPES)
    err = lib.composite_st_fwd(*(x.data_ptr() for x in args), BR, N,
                               float(min_uncert), out.data_ptr(),
                               _build.stream_ptr(rgb_raw.device))
    _build.check(err, "composite_st_fwd")
    composite_st_fwd.launches += 1
    return out


composite_st_fwd.launches = 0


def fused_composite_st(rgb_raw, trans_raw, dens_raw, depth_samples, ray,
                       min_uncert=0.05):
    """Composite from RAW field outputs (the JAX function of this name):
    depth_samples [B,R,N,1], ray [B,R,3] → dict of [B,R,C] leaves plus the
    scalar 'trans_density_mean'."""
    B, R, N, _ = depth_samples.shape
    d = depth_samples.reshape(B * R, N)
    dist = _dists(depth_samples, ray).reshape(B * R, N)
    packed = composite_st_fwd(rgb_raw, trans_raw, dens_raw, d, dist,
                              min_uncert)
    return packed_to_dict(packed, B, R, N)


def packed_to_dict(packed, B, R, N):
    """Unpack the [BR,16] composite buffer into the render dict."""
    def out(lo, hi):
        return packed[:, lo:hi].reshape(B, R, hi - lo)

    return dict(
        rgb=out(0, 3), rgb_static=out(3, 6), rgb_transient=out(6, 9),
        depth=out(9, 10), opacity=out(10, 11), opacity_static=out(11, 12),
        opacity_transient=out(12, 13), uncert=out(13, 14),
        trans_density_mean=packed[:, 14].sum() / (B * R * N))
