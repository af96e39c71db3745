"""The texture model's render in one kernel per direction: the ST field with
the dual-density composite fused in, and the fully fused backward — the
CUDA kernels' wrappers, their plain-PyTorch twins, and the autograd
Function that pairs them (``fused_st_render``).

Replaces texpose_tpu/kernels/fused_st_render.py (``fused_st_render``: the
mega forward ``_run_fwd``, the fully fused backward ``_run_bwd`` taken with
TEXPOSE_MEGA_FULLBWD=1, and the hybrid backward of ``_make_op``, which
chains the composite backward and the field backward).  The kernels are in
``csrc/st_render.cu``; its header says what bounds them on the card and how
their design answers that.

The weights need nothing new: the kernels read the ST field's
(``STFieldWeights`` of kernels/st_field.py: the forward walk's tiles, the
heads' packs and the backward's transposed packs), and the JAX parameters
reach them through the npz bridge of utils/checkpoint.py as for the
field.

Forward contract: the ST field's (xext [M,3+6L], enc⊕pts [M,E+3], the
per-image latents, rows_per_img) plus the composite's intervals and sample
depths dist, depth [BR,N], with M = BR·N and N dividing the kernel's
64-row tile, so a tile holds whole rays → packed [BR,16] (the columns of
kernels/composite.py).  The training variant also returns the residuals:
rgb_raw [M,3], dens_raw [M,1], trans_raw [M,5] (f32) and the [M,256]
feature residual (bf16 from the kernel).  The raw outputs and the packed
composite are those of the two-kernel route (``st_field_fwd`` →
``composite_st_fwd``).

Backward contract (the trunk is frozen): from the feature residual,
enc⊕pts, the latents, dens_raw, dist and the packed cotangent g [BR,16] →
the gradients of every head Dense weight and bias and of the latent rows,
as ``st_field_bwd`` returns them.  Nothing reaches the trunk, the points,
the depths or the intervals.  On the card the fused backward runs split as
row 2 does: its dX-chain kernel writes the planes of ``split_planes``, then
the grouped dW GEMM (kernels/dw_gemm.py) forms dW over the same segment
table (``dw_segments``).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..ops.render import _dists
from . import _build, field_fwd
from .composite import (N_OUT, composite_st_bwd, composite_st_bwd_plain,
                        composite_st_plain, packed_to_dict)
from .st_field import (HIDDEN, ROW_TILE, bwd_inputs, feat_plane,
                       finish_split, fwd_inputs, heads_plain, split_planes,
                       st_field_bwd, st_field_bwd_dx_plain,
                       st_field_bwd_plain, st_field_plain)


def st_render_plain(xext, encpts, light, trans, dist, depth, weights,
                    rows_per_img, compute_dtype=torch.bfloat16,
                    min_uncert=0.05, want_res=False):
    """The forward kernel's twin: the field twin, then the composite twin.
    With want_res: (packed, rgb_raw, dens_raw, trans_raw, feat)."""
    rgb, dens, tr, feat = st_field_plain(xext, encpts, light, trans, weights,
                                         rows_per_img, compute_dtype,
                                         want_feat=True)
    packed = composite_st_plain(rgb, tr, dens, depth, dist, min_uncert)
    return (packed, rgb, dens, tr, feat) if want_res else packed


def _raw_grads(feat, encpts, light, trans, dens, dist, g, weights,
               rows_per_img, compute_dtype):
    """Both heads recomputed from the feature residual, then the
    composite's closed-form VJP → (d rgb_raw [M,3], d trans_raw [M,5])."""
    rgb, tr = heads_plain(feat.float(), encpts, light, trans, weights,
                          rows_per_img, compute_dtype)
    return composite_st_bwd_plain(rgb, tr, dens, dist, g)


def st_render_bwd_plain(feat, encpts, light, trans, dens, dist, g, weights,
                        rows_per_img, compute_dtype=torch.bfloat16):
    """The backward's twin: the composite's VJP of the recomputed raw
    outputs, then the heads' backward twin.  Returns what
    ``st_render_bwd`` returns."""
    d_rgb, d_tr = _raw_grads(feat, encpts, light, trans, dens, dist, g,
                             weights, rows_per_img, compute_dtype)
    return st_field_bwd_plain(feat, encpts, light, trans, weights,
                              rows_per_img, d_rgb, d_tr, compute_dtype)


def st_render_bwd_dx_plain(feat, encpts, light, trans, dens, dist, g,
                           weights, rows_per_img,
                           compute_dtype=torch.bfloat16):
    """The dX-chain kernel's twin (phase (a) of the split render
    backward): the composite's VJP of the recomputed raw outputs, then
    row 2's dX-chain twin → what ``st_field_bwd_dx_plain`` returns (the
    planes, db and the latent row sums); ``dw_grads`` over ``dw_segments``
    fills the dW blocks."""
    d_rgb, d_tr = _raw_grads(feat, encpts, light, trans, dens, dist, g,
                             weights, rows_per_img, compute_dtype)
    return st_field_bwd_dx_plain(feat, encpts, light, trans, weights,
                                 rows_per_img, d_rgb, d_tr, compute_dtype)


_ARGTYPES = {
    "st_render_fwd": field_fwd.ARGTYPES,
    "st_render_bwd_dx": [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
}


def _check_rays(what, M, dist, others):
    """M rows must be whole rays of N | 64 samples; dist and the ``others``
    ((tensor, shape) pairs) must have the shapes that implies."""
    BR, N = dist.shape
    if M != BR * N or ROW_TILE % N or any(tuple(t.shape) != s
                                          for t, s in others):
        raise ValueError(f"{what}: {M} rows for {BR} rays x {N} samples "
                         f"(N must divide {ROW_TILE}), or a misshaped "
                         "per-ray input")


def st_render_fwd(xext, encpts, light, trans, dist, depth, weights,
                  rows_per_img, compute_dtype=torch.bfloat16,
                  min_uncert=0.05, want_res=False):
    """Packed [BR,16] f32; with want_res also (rgb_raw [M,3], dens_raw
    [M,1], trans_raw [M,5], feat [M,256]).

    CPU tensors take ``st_render_plain``; CUDA tensors launch the kernel
    (bf16 compute only, rays of N | 64 samples) or raise."""
    if xext.device.type == "cpu":
        return st_render_plain(xext, encpts, light, trans, dist, depth,
                               weights, rows_per_img, compute_dtype,
                               min_uncert, want_res)
    M = xext.shape[0]
    _check_rays("st_render_fwd", M, dist, ((depth, tuple(dist.shape)),))
    walk, lrow, trow, xe = fwd_inputs(
        "st_render_fwd", xext, encpts, light, trans, weights, rows_per_img,
        compute_dtype, (dist, depth))
    BR, N = dist.shape
    dev = xext.device
    dist = dist.float().contiguous()
    depth = depth.float().contiguous()
    out = torch.empty((BR, N_OUT), dtype=torch.float32, device=dev)
    # the raw outputs: residuals in training, scratch the epilogue reads
    # back in evaluation
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev)
    dens = torch.empty((M, 1), dtype=torch.float32, device=dev)
    tr = torch.empty((M, 5), dtype=torch.float32, device=dev)
    feat = (torch.empty((M, HIDDEN), dtype=torch.bfloat16, device=dev)
            if want_res else None)
    lib = _build.load("st_render", _ARGTYPES)
    err = field_fwd.launch(
        lib.st_render_fwd, walk, xe, feat_plane(weights, want_res),
        n_res=int(want_res), rows_per_img=rows_per_img, n_img=lrow.shape[0],
        N=N, min_uncert=float(min_uncert), stream=_build.stream_ptr(dev),
        lrow=lrow, trow=trow, rgb=rgb, dens=dens, trans=tr, res=feat,
        dist=dist, depth=depth, out=out)
    _build.check(err, "st_render_fwd")
    st_render_fwd.launches += 1
    return (out, rgb, dens, tr, feat) if want_res else out


st_render_fwd.launches = 0


def st_render_bwd(feat, encpts, light, trans, dens, dist, g, weights,
                  rows_per_img, compute_dtype=torch.bfloat16):
    """Gradients of the heads and latents from the packed cotangent g
    [BR,16] → (head grads in ``weights.head_params()`` order, d_light
    [B,Dl], d_trans [B,Dt]), f32.

    CPU tensors take ``st_render_bwd_plain``; CUDA tensors launch the
    dX-chain kernel (bf16 compute only, rays of N | 64 samples; its
    launches counted here), then the grouped dW GEMM and its reduction
    (``finish_split``), or raise."""
    if feat.device.type == "cpu":
        return st_render_bwd_plain(feat, encpts, light, trans, dens, dist, g,
                                   weights, rows_per_img, compute_dtype)
    M = feat.shape[0]
    BR, N = dist.shape
    _check_rays("st_render_bwd", M, dist, ((dens, (M, 1)), (g, (BR, N_OUT))))
    (wh, bh, wT, ke, ep, lrow, trow, layout, grads, d_lrow,
     d_trow) = bwd_inputs("st_render_bwd", feat, encpts, light, trans,
                          weights, rows_per_img, compute_dtype,
                          (dens, dist, g))
    dens = dens.float().contiguous()
    dist = dist.float().contiguous()
    g = g.float().contiguous()
    feat = feat.contiguous()
    hplanes, gplanes, gnarrow = planes = split_planes(weights, M,
                                                      feat.device)
    lib = _build.load("st_render", _ARGTYPES)
    err = lib.st_render_bwd_dx(
        feat.data_ptr(), ep.data_ptr(), dens.data_ptr(), dist.data_ptr(),
        g.data_ptr(), wh.data_ptr(), bh.data_ptr(), wT.data_ptr(),
        lrow.data_ptr(), trow.data_ptr(), grads.data_ptr(),
        d_lrow.data_ptr(), d_trow.data_ptr(), hplanes.data_ptr(),
        gplanes.data_ptr(), gnarrow.data_ptr(), M, ke, N, int(rows_per_img),
        lrow.shape[0], len(weights.rgb), len(weights.trans),
        _build.stream_ptr(feat.device))
    _build.check(err, "st_render_bwd")
    st_render_bwd.launches += 1
    return finish_split(weights, planes, feat, ep, layout, grads, d_lrow,
                        d_trow, light, trans, encpts.shape[1])


st_render_bwd.launches = 0


class _STRender(torch.autograd.Function):
    """fused_st_render's custom_vjp (``_make_op``): the forward keeps the
    residuals; the backward is the hybrid (composite backward → field
    backward, kernels or twins by device) or, with full_bwd, the fully
    fused backward.  Gradients reach the heads and the latents only."""

    @staticmethod
    def forward(ctx, xext, encpts, light, trans, dist, depth, weights,
                rows_per_img, compute_dtype, min_uncert, full_bwd,
                *head_params):
        packed, rgb, dens, tr, feat = st_render_fwd(
            xext, encpts, light, trans, dist, depth, weights, rows_per_img,
            compute_dtype, min_uncert, want_res=True)
        raw = () if full_bwd else (rgb, tr)
        ctx.save_for_backward(feat, encpts, light, trans, dens, dist, *raw)
        ctx.weights = weights
        ctx.rows_per_img = rows_per_img
        ctx.compute_dtype = compute_dtype
        ctx.full_bwd = full_bwd
        return packed

    @staticmethod
    def backward(ctx, g):
        feat, encpts, light, trans, dens, dist, *raw = ctx.saved_tensors
        g = g.contiguous()
        if ctx.full_bwd:
            d_heads, d_light, d_trans = st_render_bwd(
                feat, encpts, light, trans, dens, dist, g, ctx.weights,
                ctx.rows_per_img, ctx.compute_dtype)
        else:
            d_rgb, d_tr = composite_st_bwd(raw[0], raw[1], dens, dist, g)
            d_heads, d_light, d_trans = st_field_bwd(
                feat, encpts, light, trans, ctx.weights, ctx.rows_per_img,
                d_rgb, d_tr, ctx.compute_dtype)
        return (None, None, d_light, d_trans) + (None,) * 7 + tuple(d_heads)


def fused_st_render(xext, encpts, light, trans, depth_samples, ray, weights,
                    rows_per_img, compute_dtype=torch.bfloat16,
                    min_uncert=0.05):
    """Field + composite in one kernel per direction (the JAX function of
    this name): the field's row inputs as ``st_field`` takes them (xext and
    enc⊕pts stand for JAX's points, ray encodings and posenc constants),
    the latents, depth_samples [B,R,N,1] and ray [B,R,3] → the composite
    dict of ``fused_composite_st`` ([B,R,C] leaves and the scalar
    'trans_density_mean').  With grad enabled the heads and latents
    differentiate through the autograd Function (training variant); else
    the evaluation variant runs.  TEXPOSE_MEGA_FULLBWD=1 selects the fully
    fused backward, read at each call as the JAX package reads it (the
    hybrid otherwise).  Depths and intervals take no gradient."""
    B, R, N, _ = depth_samples.shape
    depth = depth_samples.reshape(B * R, N).detach()
    dist = _dists(depth_samples, ray).reshape(B * R, N).detach()
    if torch.is_grad_enabled():
        packed = _STRender.apply(xext, encpts, light, trans, dist, depth,
                                 weights, rows_per_img, compute_dtype,
                                 float(min_uncert),
                                 os.environ.get("TEXPOSE_MEGA_FULLBWD",
                                                "0") == "1",
                                 *weights.head_params())
    else:
        packed = st_render_fwd(xext, encpts, light, trans, dist, depth,
                               weights, rows_per_img, compute_dtype,
                               min_uncert)
    return packed_to_dict(packed, B, R, N)
