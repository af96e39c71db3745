"""The composites: the dual-density (NeRF-W) composite of the texture model,
forward and backward, and the single-density (vanilla NeRF) composite of
the pretrain — the CUDA kernels' wrappers, their plain-PyTorch twins, and
the autograd Function that pairs the dual composite's two kernels.

Replaces texpose_tpu/kernels/fused_composite.py (``fused_composite_st``:
``_run_fwd``/``_run_bwd`` and the flat-input ``_run_fwd_flat``/
``_run_bwd_flat``; the port always reads the field's flat [M,C] outputs and
writes flat [M,3]/[M,5] gradients, so ``kernels.composite_flat`` selects
the same kernels).  The kernels are in ``csrc/composite.cu``; its header
says what bounds them on the card and how their design answers that.

Activations match texpose_tpu.nn.fields.apply_nerf_st_fused: sigmoid
colors, softplus static density, transient density and uncertainty.
Packed output columns [BR,16]:
  0-2 rgb | 3-5 rgb_static | 6-8 rgb_transient | 9 depth | 10 opacity
  11 opacity_static | 12 opacity_transient | 13 uncert
  14 sum_n softplus(transient density raw) | 15 zero

The single-density composite replaces texpose_tpu/kernels/
fused_composite_coarse.py (``fused_composite_coarse``): its forward
(``_run_fwd``, and ``_run_fwd_flat`` with ``kernels.composite_flat``) is
``composite_coarse_fwd`` (twin ``composite_coarse_plain``; the warp-per-ray
device function of the same composite runs as the epilogue of the coarse
mega forward, ``csrc/field_fwd.cuh``), its backward (``_run_bwd`` / ``_run_bwd_flat``,
the closed-form VJP to rgb AND density) is ``composite_coarse_bwd``.  Both
read the field's flat [M,3]/[M,1] outputs, N ≤ 256 samples per ray.
Packed columns [BR,8]: 0-2 rgb | 3 depth | 4 opacity | 5-7 zero.
"""

from __future__ import annotations

import ctypes

import torch

from ..nn.mlp import softplus
from ..ops.render import _dists, _transmittance
from . import _build

N_OUT = 16
N_OUT_COARSE = 8


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


def composite_st_bwd_plain(rgb_raw, trans_raw, dens_raw, dist, g):
    """The backward kernel's twin: _bwd_cols in closed form.  g [BR,16] is
    the packed output's cotangent → (d rgb_raw [BR·N,3], d trans_raw
    [BR·N,5]); the static density gets none."""
    BR, N = dist.shape
    cs = torch.sigmoid(rgb_raw).reshape(BR, N, 3)
    ct = torch.sigmoid(trans_raw[:, :3]).reshape(BR, N, 3)
    t3 = trans_raw[:, 3].reshape(BR, N)
    t4 = trans_raw[:, 4].reshape(BR, N)
    u = softplus(t4)
    sds = softplus(dens_raw[:, 0]).reshape(BR, N) * dist
    sdt = softplus(t3) * dist
    sd = sds + sdt
    T, T_s, T_t = (_transmittance(x) for x in (sd, sds, sdt))
    e_s, e_t, e = torch.exp(-sds), torch.exp(-sdt), torch.exp(-sd)
    ps, pt, p = T * (1.0 - e_s), T * (1.0 - e_t), T * (1.0 - e)
    ws, wt = T_s * (1.0 - e_s), T_t * (1.0 - e_t)
    g_rgb, g_rgbs, g_rgbt = g[:, None, 0:3], g[:, None, 3:6], g[:, None, 6:9]
    g_op, g_opt, g_unc, g_treg = g[:, 10:11], g[:, 12:13], g[:, 13:14], \
        g[:, 14:15]
    d_rgb = (ps[..., None] * g_rgb + ws[..., None] * g_rgbs) * cs * (1 - cs)
    d_tc = (pt[..., None] * g_rgb + wt[..., None] * g_rgbt) * ct * (1 - ct)
    F_ps = (cs * g_rgb).sum(-1)
    F_pt = (ct * g_rgb).sum(-1) + u * g_unc
    F_wt = (ct * g_rgbt).sum(-1) + g_opt
    d_sdt = F_pt * T * e_t + F_wt * T_t * e_t + g_op * T * e
    # through T (ps, pt, p) and T_t (wt): each carries −1 per upstream sdt
    v = F_ps * ps + F_pt * pt + g_op * p + F_wt * wt
    suffix = torch.flip(torch.cumsum(torch.flip(v, [1]), 1), [1])
    d_sdt = d_sdt - torch.cat([suffix[:, 1:], torch.zeros_like(v[:, :1])], 1)
    d_t3 = (d_sdt * dist + g_treg) * torch.sigmoid(t3)
    d_t4 = pt * g_unc * torch.sigmoid(t4)
    d_tr = torch.cat([d_tc, d_t3[..., None], d_t4[..., None]], dim=-1)
    return d_rgb.reshape(BR * N, 3), d_tr.reshape(BR * N, 5)


def composite_coarse_plain(rgb_raw, dens_raw, depth, dist):
    """rgb_raw [BR·N,3], dens_raw [BR·N,1] (no activations), depth and dist
    [BR,N] → packed [BR,8]: sigmoid colors, softplus density, w = T·α."""
    BR, N = depth.shape
    cs = torch.sigmoid(rgb_raw).reshape(BR, N, 3)
    sd = softplus(dens_raw[:, 0]).reshape(BR, N) * dist
    w = _transmittance(sd) * (1.0 - torch.exp(-sd))
    return torch.cat([(w[..., None] * cs).sum(1),
                      (w * depth).sum(1, keepdim=True),
                      w.sum(1, keepdim=True),
                      torch.zeros_like(dist[:, :3])], dim=1)


def composite_coarse_bwd_plain(rgb_raw, dens_raw, dist, depth, g):
    """The coarse backward kernel's twin: fused_composite_coarse's
    _bwd_kernel in closed form.  g [BR,8] is the packed output's cotangent
    → (d rgb_raw [BR·N,3], d dens_raw [BR·N,1])."""
    BR, N = dist.shape
    cs = torch.sigmoid(rgb_raw).reshape(BR, N, 3)
    x = dens_raw[:, 0].reshape(BR, N)
    sd = softplus(x) * dist
    T, e = _transmittance(sd), torch.exp(-sd)
    w = T * (1.0 - e)
    g_rgb = g[:, None, 0:3]
    d_rgb = w[..., None] * g_rgb * cs * (1.0 - cs)
    G = (cs * g_rgb).sum(-1) + depth * g[:, 3:4] + g[:, 4:5]
    v = G * w
    suffix = torch.flip(torch.cumsum(torch.flip(v, [1]), 1), [1])
    d_sd = G * T * e - torch.cat([suffix[:, 1:], torch.zeros_like(v[:, :1])],
                                 1)
    d_dens = d_sd * dist * torch.sigmoid(x)
    return d_rgb.reshape(BR * N, 3), d_dens.reshape(BR * N, 1)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "composite_st_fwd": [_P] * 5 + [_I, _I, ctypes.c_float] + [_I] * 4
    + [_P, _P],
    "composite_st_bwd": [_P] * 5 + [_I] * 6 + [_P] * 3,
    "composite_coarse_bwd": [_P] * 5 + [_I] * 6 + [_P] * 3,
    "composite_coarse_fwd": [_P] * 4 + [_I] * 6 + [_P] * 2,
}
MAX_SAMPLES = 256      # the composite kernels' samples per ray
SEG_THREADS = 256      # csrc/composite.cu kSegThreads


def segment_plan(BR, N, ptrs):
    """The launch of a segmented composite kernel (rows 3, 4, 9a and 9b):
    (S samples a lane, L lanes a ray, vector loads?, blocks of
    SEG_THREADS).  L is 32, one ray a warp; S is 2 up to 64 samples a ray,
    4 up to 128, 8 up to 256: the kernels are bound by issuing their
    instructions, so S is the least that keeps a ray inside one warp
    (csrc/composite_seg.cuh).  The vector-load variant needs every base
    pointer in ``ptrs`` 16-byte aligned and N % S == 0: then a lane's S
    rows are whole and aligned, so no vector load reads past the ray's
    last row; otherwise the scalar-load variant of the same kernel runs."""
    samples = 2 if N <= 64 else 4 if N <= 128 else 8
    lanes = 32
    bits = 0
    for p in ptrs:
        bits |= p
    return (samples, lanes, N % samples == 0 and not bits & 15,
            -(-BR * lanes // SEG_THREADS))


_lib = None


def _kernels():
    """csrc/composite.cu's entries, built, loaded and bound at first use,
    then kept."""
    global _lib
    if _lib is None:
        _lib = _build.load("composite", _ARGTYPES)
    return _lib


def _ready(what, args, numels):
    """(the kernel's inputs, their data pointers): float32 tensors on one
    card of ``numels`` elements each, else ValueError; non-contiguous
    inputs are copied first (the caller keeps the returned inputs until it
    has launched)."""
    dev = args[0].get_device()
    ptrs = []
    for x, numel in zip(args, numels):
        if (x.dtype is not torch.float32 or x.get_device() != dev
                or x.numel() != numel):
            raise ValueError(f"{what}: expects float32 tensors on one CUDA "
                             f"device with {numels} elements, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            return _ready(what, [y.contiguous() for y in args], numels)
        ptrs.append(x.data_ptr())
    return args, ptrs


def _on_card(x, what):
    """True for a CUDA tensor; False for a CPU tensor (the twin runs);
    ValueError otherwise."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for {x.device}")


def composite_st_fwd(rgb_raw, trans_raw, dens_raw, depth, dist,
                     min_uncert=0.05):
    """Packed [BR,16] composite.  CPU tensors take ``composite_st_plain``;
    CUDA tensors launch the segmented kernel (vector or scalar loads, as
    ``segment_plan`` finds) or raise."""
    if not _on_card(rgb_raw, "composite_st_fwd"):
        return composite_st_plain(rgb_raw, trans_raw, dens_raw, depth, dist,
                                  min_uncert)
    BR, N = depth.shape
    _check_samples("composite_st_fwd", N)
    M = BR * N
    args, ptrs = _ready("composite_st_fwd",
                        (rgb_raw, trans_raw, dens_raw, depth, dist),
                        (3 * M, 5 * M, M, M, M))
    out = rgb_raw.new_empty((BR, N_OUT))
    _build.check(_kernels().composite_st_fwd(
        *ptrs, BR, N, float(min_uncert), *segment_plan(BR, N, ptrs),
        out.data_ptr(), torch._C._cuda_getCurrentRawStream(
            rgb_raw.get_device())), "composite_st_fwd")
    composite_st_fwd.launches += 1
    return out


composite_st_fwd.launches = 0


def composite_st_bwd(rgb_raw, trans_raw, dens_raw, dist, g):
    """(d rgb_raw [M,3], d trans_raw [M,5]) from the packed cotangent g
    [BR,16].  CPU tensors take ``composite_st_bwd_plain``; CUDA tensors
    launch the segmented kernel (vector or scalar loads, as
    ``segment_plan`` finds) or raise."""
    if not _on_card(rgb_raw, "composite_st_bwd"):
        return composite_st_bwd_plain(rgb_raw, trans_raw, dens_raw, dist, g)
    BR, N = dist.shape
    _check_samples("composite_st_bwd", N)
    M = BR * N
    args, ptrs = _ready("composite_st_bwd",
                        (rgb_raw, trans_raw, dens_raw, dist, g),
                        (3 * M, 5 * M, M, M, BR * N_OUT))
    d_rgb = rgb_raw.new_empty((M, 3))
    d_tr = rgb_raw.new_empty((M, 5))
    _build.check(_kernels().composite_st_bwd(
        *ptrs, BR, N, *segment_plan(BR, N, ptrs), d_rgb.data_ptr(),
        d_tr.data_ptr(), torch._C._cuda_getCurrentRawStream(
            rgb_raw.get_device())), "composite_st_bwd")
    composite_st_bwd.launches += 1
    return d_rgb, d_tr


composite_st_bwd.launches = 0


def _check_samples(what, N):
    if N > MAX_SAMPLES:
        raise ValueError(f"{what}: {N} samples per ray; the kernel takes up "
                         f"to {MAX_SAMPLES}")


def composite_coarse_fwd(rgb_raw, dens_raw, depth, dist):
    """Packed [BR,8] single-density composite of the raw field outputs.
    CPU tensors take ``composite_coarse_plain``; CUDA tensors launch the
    segmented kernel (vector or scalar loads, as ``segment_plan`` finds;
    N ≤ 256) or raise."""
    if not _on_card(rgb_raw, "composite_coarse_fwd"):
        return composite_coarse_plain(rgb_raw, dens_raw, depth, dist)
    BR, N = depth.shape
    _check_samples("composite_coarse_fwd", N)
    M = BR * N
    args, ptrs = _ready("composite_coarse_fwd",
                        (rgb_raw, dens_raw, dist, depth), (3 * M, M, M, M))
    out = rgb_raw.new_empty((BR, N_OUT_COARSE))
    _build.check(_kernels().composite_coarse_fwd(
        *ptrs, BR, N, *segment_plan(BR, N, ptrs), out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(rgb_raw.get_device())),
        "composite_coarse_fwd")
    composite_coarse_fwd.launches += 1
    return out


composite_coarse_fwd.launches = 0


def composite_coarse_bwd(rgb_raw, dens_raw, dist, depth, g):
    """(d rgb_raw [M,3], d dens_raw [M,1]) from the packed cotangent g
    [BR,8].  CPU tensors take ``composite_coarse_bwd_plain``; CUDA tensors
    launch the segmented kernel (vector or scalar loads, as
    ``segment_plan`` finds; N ≤ 256) or raise."""
    if not _on_card(rgb_raw, "composite_coarse_bwd"):
        return composite_coarse_bwd_plain(rgb_raw, dens_raw, dist, depth, g)
    BR, N = dist.shape
    _check_samples("composite_coarse_bwd", N)
    M = BR * N
    args, ptrs = _ready("composite_coarse_bwd",
                        (rgb_raw, dens_raw, dist, depth, g),
                        (3 * M, M, M, M, BR * N_OUT_COARSE))
    d_rgb = rgb_raw.new_empty((M, 3))
    d_dens = rgb_raw.new_empty((M, 1))
    _build.check(_kernels().composite_coarse_bwd(
        *ptrs, BR, N, *segment_plan(BR, N, ptrs), d_rgb.data_ptr(),
        d_dens.data_ptr(), torch._C._cuda_getCurrentRawStream(
            rgb_raw.get_device())), "composite_coarse_bwd")
    composite_coarse_bwd.launches += 1
    return d_rgb, d_dens


composite_coarse_bwd.launches = 0


class _CompositeST(torch.autograd.Function):
    """fused_composite_st's custom_vjp: gradients to rgb_raw and trans_raw
    only; the static density, depths and intervals get none."""

    @staticmethod
    def forward(ctx, rgb_raw, trans_raw, dens_raw, depth, dist, min_uncert):
        ctx.save_for_backward(rgb_raw, trans_raw, dens_raw, dist)
        return composite_st_fwd(rgb_raw, trans_raw, dens_raw, depth, dist,
                                min_uncert)

    @staticmethod
    def backward(ctx, g):
        d_rgb, d_tr = composite_st_bwd(*ctx.saved_tensors, g.contiguous())
        return d_rgb, d_tr, None, None, None, None


def fused_composite_st(rgb_raw, trans_raw, dens_raw, depth_samples, ray,
                       min_uncert=0.05):
    """Composite from RAW field outputs (the JAX function of this name):
    depth_samples [B,R,N,1], ray [B,R,3] → dict of [B,R,C] leaves plus the
    scalar 'trans_density_mean'; differentiable in rgb_raw and trans_raw."""
    B, R, N, _ = depth_samples.shape
    d = depth_samples.reshape(B * R, N)
    dist = _dists(depth_samples, ray).reshape(B * R, N)
    packed = _CompositeST.apply(rgb_raw, trans_raw, dens_raw, d, dist,
                                float(min_uncert))
    return packed_to_dict(packed, B, R, N)


class _CompositeCoarse(torch.autograd.Function):
    """fused_composite_coarse's custom_vjp: gradients to rgb_raw and
    dens_raw; depths and intervals get none."""

    @staticmethod
    def forward(ctx, rgb_raw, dens_raw, depth, dist):
        ctx.save_for_backward(rgb_raw, dens_raw, dist, depth)
        return composite_coarse_fwd(rgb_raw, dens_raw, depth, dist)

    @staticmethod
    def backward(ctx, g):
        d_rgb, d_dens = composite_coarse_bwd(*ctx.saved_tensors,
                                             g.contiguous())
        return d_rgb, d_dens, None, None


def fused_composite_coarse(rgb_raw, dens_raw, depth_samples, ray):
    """Single-density composite from RAW field outputs (the JAX function of
    this name): rgb_raw [BR·N,3], dens_raw [BR·N,1], depth_samples
    [B,R,N,1], ray [B,R,3] → dict(rgb [B,R,3], depth [B,R,1], opacity
    [B,R,1]); differentiable in rgb_raw and dens_raw."""
    B, R, N, _ = depth_samples.shape
    d = depth_samples.reshape(B * R, N).detach()
    dist = _dists(depth_samples, ray).reshape(B * R, N).detach()
    packed = _CompositeCoarse.apply(rgb_raw, dens_raw, d, dist)

    def out(lo, hi):
        return packed[:, lo:hi].reshape(B, R, hi - lo)

    return dict(rgb=out(0, 3), depth=out(3, 4), opacity=out(4, 5))


def packed_to_dict(packed, B, R, N):
    """Unpack the [BR,16] composite buffer into the render dict."""
    def out(lo, hi):
        return packed[:, lo:hi].reshape(B, R, hi - lo)

    return dict(
        rgb=out(0, 3), rgb_static=out(3, 6), rgb_transient=out(6, 9),
        depth=out(9, 10), opacity=out(10, 11), opacity_static=out(11, 12),
        opacity_transient=out(12, 13), uncert=out(13, 14),
        trans_density_mean=packed[:, 14].sum() / (B * R * N))
