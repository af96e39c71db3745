"""The pretrain stage's coarse field: its forward with the single-density
composite fused in, its forward with raw outputs, and its trunk-training
backward — the CUDA kernels' wrappers, their plain-PyTorch twins, and the
autograd Functions that pair them (``coarse_render``: mega forward →
composite backward → field backward; ``coarse_field``: field forward →
field backward).

Replaces texpose_tpu/kernels/fused_coarse_render.py (``_run_fwd``, the
field + composite mega forward, and the hybrid backward ``op_bwd``) and
texpose_tpu/kernels/fused_coarse_field.py (``_run_fwd``, the field forward
with raw outputs, and ``_run_bwd``, the trunk-training backward).  The
kernels are in ``csrc/coarse_field.cu``; its header says what bounds them
on the card and how their design answers that.

Forward contract:
  xext  [M, 3+6L] f32  pts ⊕ c2f-weighted sin/cos bands (``make_xext``)
  ep    [M, E+3]  f32  view encoding ⊕ pts (pts alone without view_dep):
        the RGB head's row input beside the features
  dist, depth [BR, N]  quadrature intervals and sample depths, N | 64
  → packed [BR, 8] f32: rgb | depth | opacity | zeros.
With ``want_res`` it also returns the backward's residuals: rgb_raw [M,3]
and dens_raw [M,1] (f32, pre-activation) for the composite backward, and
every hidden layer's ReLU output rounded to compute_dtype (the trunk's
layers, then the RGB head's hidden layers) for the field backward.  The
field forward (``coarse_field_fwd``) takes xext and ep alone, any M, and
returns rgb_raw and dens_raw (with ``want_res`` the residuals too).  Every
path rounds every matmul operand to compute_dtype and accumulates in f32,
the trunk at the rounding points of kernels/trunk.py.

Backward contract (the trunk trains): from the residuals and the raw-output
gradients d rgb_raw [M,3], d dens_raw [M,1] → the gradient of every trunk
and RGB-head weight and bias.  Nothing flows to the points or the
encodings (poses are fixed in the pretrain).
"""

from __future__ import annotations

import ctypes

import torch

from ..nn.mlp import relu, round_to
from . import _build, field_fwd
from .composite import composite_coarse_bwd, composite_coarse_plain
from .dw_gemm import NARROW, NARROW_COLS, WIDE, Segment, dw_grads
from .field_fwd import (blocks, build_tiles, coarse_head_layers, make_walk,
                        trunk_layers)
from .st_field import (HIDDEN, ROW_TILE, TrunkWeights, _cat_packs, _ceil16,
                       _pack_layer, _OUT_TILE, check_trunk, stage_rows)
from .trunk import trunk_forward_plain


class CoarseFieldWeights(TrunkWeights):
    """The coarse field's dense layers (``.w`` [in,out], ``.b``) plus the
    kernels' copies.  The trunk trains, so the forward walk's tiles and the
    backward's transposed pack rebuild after every optimizer step."""

    _kind = "coarse_field"

    def __init__(self, trunk, rgb, skip):
        super().__init__(trunk, skip)
        self.rgb = list(rgb)

    def params(self):
        """Every tensor, in the order the backward returns gradients: trunk
        (w, b) per layer, then the RGB head."""
        return [t for layers in (self.trunk, self.rgb) for layer in layers
                for t in (layer.w, layer.b)]

    def _check(self, xw, e3):
        check_trunk(self.trunk, self.skip, xw, self._bad)
        if len(self.trunk) - 1 in self.skip or len(self.trunk) < 2:
            self._bad(f"the last trunk layer may not be a skip layer "
                      f"(skip {self.skip})")
        shapes = [tuple(layer.w.shape) for layer in self.rgb]
        if (len(self.rgb) < 2 or shapes[0] != (HIDDEN + e3, HIDDEN)
                or shapes[-1] != (HIDDEN, 3)
                or any(s != (HIDDEN, HIDDEN) for s in shapes[1:-1])):
            self._bad(f"rgb head layers {shapes} (row input {e3} wide)")

    def fwd_walk(self, xw, e3):
        """The forward kernels' ``Walk`` (kernels/field_fwd.py): the trunk
        and the RGB head in one set of tiles, rebuilt whenever a tensor
        changed (every optimizer step)."""
        kx, ke = _ceil16(xw), _ceil16(e3)

        def build():
            self._check(xw, e3)
            layers = (trunk_layers(self.trunk, self.skip, xw, kx, self._bad)
                      + coarse_head_layers(self.rgb, kx, ke, e3))
            return make_walk(layers, build_tiles(layers, self.rgb[0].w.device),
                             kx, ke, blocks(kx) + blocks(ke), self._bad)

        return self._cached("walk", (xw, e3), self.trunk + self.rgb, build)

    def res_planes(self):
        """The forward walk's residual planes in training: every hidden
        layer's output, plane j = walk layer j (the trunk's, then the RGB
        head's hidden layers)."""
        return {j: j for j in range(len(self.trunk) + len(self.rgb) - 1)}

    def kernel_buffer_bwd(self, xw, e3):
        """Backward: the Wᵀ packs in the kernel's walk order — RGB output
        layer (K padded to 16), RGB hidden layers down to 1, RGB layer 0's
        feature rows, the trunk's last layer (its 256 feature columns then
        the density column, K = 272), trunk layers nf-2 .. 1 (their
        activation rows only)."""
        H = HIDDEN

        def pack_t(w, segs):
            return _pack_layer(w, segs, H, H)

        def build():
            self._check(xw, e3)
            parts = [pack_t(self.rgb[-1].w.t(), [(0, 3, 16)])]
            parts += [pack_t(layer.w.t(), [(0, H, H)])
                      for layer in self.rgb[-2:0:-1]]
            parts.append(pack_t(self.rgb[0].w[:H].t(), [(0, H, H)]))
            last = self.trunk[-1].w[:H]
            parts.append(pack_t(torch.cat([last[:, 1:].t(), last[:, :1].t()]),
                                [(0, H, H), (H, H + 1, 16)]))
            parts += [pack_t(layer.w[:H].t(), [(0, H, H)])
                      for layer in self.trunk[-2:0:-1]]
            return _cat_packs(parts)

        return self._cached("wT", (xw, e3), self.trunk + self.rgb, build)

    def grad_layout(self, kx, ke):
        """The backward kernel's flat f32 output: [(key, rows, cols)] and
        the per-layer offsets {dW, dW2, db, db2} (-1 = none) it writes to:
        trunk layers (layer 0's dW has kx rows; a skip layer adds its xext
        block, the last layer its density tile and bias), then the RGB head
        (layer 0 adds its enc⊕pts block; the output layer is one n8 tile).
        The blocks are the field's width (256 on the kernels' path)."""
        H = self.feat_dim
        layout, offs, at = [], [], 0

        def add(key, rows, cols):
            nonlocal at
            layout.append((key, rows, cols))
            at += rows * cols
            return at - rows * cols

        nf, nr = len(self.trunk), len(self.rgb)
        for li in range(nf):
            o = [add(("t", li, "w"), kx if li == 0 else H, H), -1, -1, -1]
            if li == nf - 1:
                o[1] = add(("t", li, "w_dens"), H, _OUT_TILE)
            elif li in self.skip:
                o[1] = add(("t", li, "w_x"), kx, H)
            o[2] = add(("t", li, "b"), 1, H)
            if li == nf - 1:
                o[3] = add(("t", li, "b_dens"), 1, _OUT_TILE)
            offs += o
        for li in range(nr):
            cols = _OUT_TILE if li == nr - 1 else H
            o = [add(("r", li, "w"), H, cols), -1, -1, -1]
            if li == 0:
                o[1] = add(("r", 0, "w_ep"), ke, H)
            o[2] = add(("r", li, "b"), 1, cols)
            offs += o
        return layout, offs, at

    def dw_segments(self, kx, ke):
        """The dW blocks of ``grad_layout`` as the grouped GEMM's segments
        (kernels/dw_gemm.py): A source 0 is the residual stack (plane j =
        the output of trunk layer j, then of RGB hidden layer j - nf), A
        source 1 the staged input [M, kx+ke] (xext | enc⊕pts); wide G plane
        j is the gradient of the layer that outputs residual plane j, the
        narrow plane holds d rgb_raw (columns 0-2) and d dens_raw (8)."""
        layout, _, _ = self.grad_layout(kx, ke)
        at, off = 0, {}
        for key, rows, cols in layout:
            off[key] = at
            at += rows * cols
        H, O = self.feat_dim, _OUT_TILE
        nf, nr = len(self.trunk), len(self.rgb)
        segs = []
        for li in range(nf):
            if li == 0:
                segs.append(Segment(1, 0, 0, kx, WIDE, 0, 0, H,
                                    off["t", 0, "w"]))
                continue
            segs.append(Segment(0, li - 1, 0, H, WIDE, li, 0, H,
                                off["t", li, "w"]))
            if li == nf - 1:
                segs.append(Segment(0, li - 1, 0, H, NARROW, 0, 8, O,
                                    off["t", li, "w_dens"]))
            elif li in self.skip:
                segs.append(Segment(1, 0, 0, kx, WIDE, li, 0, H,
                                    off["t", li, "w_x"]))
        for li in range(nr):
            a_plane = nf - 1 if li == 0 else nf + li - 1
            if li == nr - 1:
                segs.append(Segment(0, a_plane, 0, H, NARROW, 0, 0, O,
                                    off["r", li, "w"]))
                continue
            segs.append(Segment(0, a_plane, 0, H, WIDE, nf + li, 0, H,
                                off["r", li, "w"]))
            if li == 0:
                segs.append(Segment(1, 0, kx, ke, WIDE, nf, 0, H,
                                    off["r", 0, "w_ep"]))
        return segs

    def finish_grads(self, parts, xw, e3):
        """The kernel's blocks → gradients in ``params()`` order."""
        out = []
        nf, nr = len(self.trunk), len(self.rgb)
        for li in range(nf):
            w, b = parts[("t", li, "w")], parts[("t", li, "b")].reshape(-1)
            if li == 0:
                w = w[:xw]
            elif li == nf - 1:
                w = torch.cat([parts[("t", li, "w_dens")][:, :1], w], 1)
                b = torch.cat([parts[("t", li, "b_dens")].reshape(-1)[:1], b])
            elif li in self.skip:
                w = torch.cat([w, parts[("t", li, "w_x")][:xw]])
            out += [w, b]
        for li in range(nr):
            w, b = parts[("r", li, "w")], parts[("r", li, "b")].reshape(-1)
            if li == 0:
                w = torch.cat([w, parts[("r", 0, "w_ep")][:e3]])
            if li == nr - 1:
                w, b = w[:, :3], b[:3]
            out += [w, b]
        return out


def coarse_field_plain(xext, ep, weights, compute_dtype=torch.bfloat16,
                       want_res=False):
    """The field forward kernel's twin: (rgb_raw [M,3], dens_raw [M,1]); with
    want_res also acts, the list of hidden ReLU outputs (trunk, then RGB
    head) rounded to compute_dtype and held in f32."""
    def c(x):
        return round_to(x, compute_dtype)

    h, dens, acts = trunk_forward_plain(xext, weights.trunk, weights.skip,
                                        compute_dtype, want_acts=True)
    x = torch.cat([h, c(ep.float())], -1)
    nr = len(weights.rgb)
    for li, layer in enumerate(weights.rgb):
        z = x @ c(layer.w) + layer.b
        if li < nr - 1:
            x = c(relu(z))
            acts.append(x)
    return (z, dens, acts) if want_res else (z, dens)


def coarse_render_plain(xext, ep, dist, depth, weights,
                        compute_dtype=torch.bfloat16, want_res=False):
    """The mega forward kernel's twin: the field twin, then the composite
    twin.  With want_res: (packed, rgb_raw, dens_raw, acts)."""
    rgb_raw, dens, acts = coarse_field_plain(xext, ep, weights, compute_dtype,
                                             want_res=True)
    packed = composite_coarse_plain(rgb_raw, dens, depth, dist)
    return (packed, rgb_raw, dens, acts) if want_res else packed


def coarse_field_bwd_plain(xext, ep, acts, weights, g_rgb, g_dens,
                           compute_dtype=torch.bfloat16):
    """The field backward kernel's twin (any layer width): from the
    residual activations (a list, or the kernel's stacked bf16 buffer), each
    layer's dW = round(h)ᵀ·round(g), db = Σ g, g ← (round(g)·round(W)ᵀ)⊙
    [h > 0], from the RGB output layer down to trunk layer 0.  The RGB
    head's layer 0 passes back only its feature rows, joined by the
    density's gradient as the trunk's last layer's column 0; a skip layer
    passes back only its activation block.  → gradients in
    ``weights.params()`` order."""
    def c(x):
        return round_to(x, compute_dtype)

    nf, nr = len(weights.trunk), len(weights.rgb)
    h = [acts[i].float() for i in range(nf)]
    r = [acts[nf + i].float() for i in range(nr - 1)]
    xc, F = c(xext.float()), weights.feat_dim
    grads = {}
    g = g_rgb.float()
    for li in range(nr - 1, -1, -1):
        x = r[li - 1] if li > 0 else torch.cat([h[-1], c(ep.float())], -1)
        w = weights.rgb[li].w
        grads[("r", li)] = (c(x).t() @ c(g), g.sum(0))
        if li > 0:
            g = (c(g) @ c(w).t()) * (r[li - 1] > 0)
        else:
            g = (c(g) @ c(w[:F]).t()) * (h[-1] > 0)
    g = torch.cat([g_dens.float(), g], -1)
    for li in range(nf - 1, -1, -1):
        x = xc if li == 0 else (torch.cat([h[li - 1], xc], -1)
                                if li in weights.skip else h[li - 1])
        grads[("t", li)] = (c(x).t() @ c(g), g.sum(0))
        if li > 0:
            w = weights.trunk[li].w[:h[li - 1].shape[1]]
            g = (c(g) @ c(w).t()) * (h[li - 1] > 0)
    return [t for key in [("t", i) for i in range(nf)]
            + [("r", i) for i in range(nr)] for t in grads[key]]


def coarse_field_bwd_dx_plain(xext, ep, acts, weights, g_rgb, g_dens,
                              compute_dtype=torch.bfloat16):
    """The dX-chain kernel's twin (phase (a) of the field backward): the
    layers walked down as ``coarse_field_bwd_plain`` walks them, without
    the dW products → (gplanes [n_res, M, 256]: plane j the gradient of the
    layer that outputs residual plane j, rounded to compute_dtype;
    gnarrow [M, 16]: d rgb_raw in columns 0-2 and d dens_raw in 8, rounded;
    grads: the flat f32 buffer of ``grad_layout`` with every db block set
    and every dW block zero).  ``dw_grads`` over ``dw_segments`` fills the
    dW blocks from these planes."""
    def c(x):
        return round_to(x, compute_dtype)

    H = weights.feat_dim
    nf, nr = len(weights.trunk), len(weights.rgb)
    M = xext.shape[0]
    kx, ke = _ceil16(xext.shape[1]), _ceil16(ep.shape[1])
    layout, _, total = weights.grad_layout(kx, ke)
    at, off = 0, {}
    for key, rows, cols in layout:
        off[key] = at
        at += rows * cols
    grads = torch.zeros(total, dtype=torch.float32, device=xext.device)

    def put(key, v):
        grads[off[key]:off[key] + v.numel()] = v

    h = [acts[i].float() for i in range(nf + nr - 1)]
    gplanes = torch.zeros((nf + nr - 1, M, H), device=xext.device)
    gnarrow = torch.zeros((M, NARROW_COLS), device=xext.device)
    gnarrow[:, :3] = c(g_rgb.float())
    gnarrow[:, 8] = c(g_dens.float()[:, 0])
    g = g_rgb.float()
    put(("r", nr - 1, "b"), g.sum(0))
    for li in range(nr - 1, 0, -1):              # RGB layers nr-1 .. 1
        g = (c(g) @ c(weights.rgb[li].w).t()) * (h[nf + li - 1] > 0)
        gplanes[nf + li - 1] = c(g)
        put(("r", li - 1, "b"), g.sum(0))
    # RGB layer 0 passes back its feature rows; the density joins them
    g = (c(g) @ c(weights.rgb[0].w[:H]).t()) * (h[nf - 1] > 0)
    gplanes[nf - 1] = c(g)
    put(("t", nf - 1, "b"), g.sum(0))
    put(("t", nf - 1, "b_dens"), g_dens.float().sum(0))
    g = torch.cat([g_dens.float(), g], -1)
    for li in range(nf - 1, 0, -1):              # trunk layers nf-1 .. 1
        g = (c(g) @ c(weights.trunk[li].w[:H]).t()) * (h[li - 1] > 0)
        gplanes[li - 1] = c(g)
        put(("t", li - 1, "b"), g.sum(0))
    return gplanes, gnarrow, grads


_ARGTYPES = {
    "coarse_fwd": field_fwd.ARGTYPES,
    "coarse_field_fwd": field_fwd.ARGTYPES,
    "coarse_bwd_dx": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def _check_cuda(what, x, compute_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("coarse_field CUDA kernel computes in bfloat16 "
                         f"only, got compute_dtype={compute_dtype}")


def _staged(xext, ep, walk):
    """(the backward's staged row input [M, kx+ke], xext and enc⊕pts each
    16-padded; the forward kernel's, xext padded to whole 64-column blocks:
    the same tensor when kx is a multiple of 64, as in the shipped
    configs)."""
    kx = _ceil16(xext.shape[1])
    xe = stage_rows(xext, ep, kx, walk.ke)
    return xe, (xe if walk.kx == kx else
                stage_rows(xext, ep, walk.kx, walk.ke))


def coarse_render_fwd(xext, ep, dist, depth, weights,
                      compute_dtype=torch.bfloat16, want_res=False):
    """Packed [BR,8] f32; with want_res also (rgb_raw [M,3], dens_raw [M,1],
    res) where res is the kernel's (staged input, [n_res, M, 256] bf16
    activations) or the twin's (None, list of activations).

    CPU tensors take ``coarse_render_plain``; CUDA tensors launch the
    kernel (bf16 compute only, rays of N | 64 samples) or raise."""
    if xext.device.type == "cpu":
        out = coarse_render_plain(xext, ep, dist, depth, weights,
                                  compute_dtype, want_res)
        return out[:3] + ((None, out[3]),) if want_res else out
    _check_cuda("coarse_render_fwd", xext, compute_dtype)
    M, xw = xext.shape
    BR, N = dist.shape
    e3 = ep.shape[1]
    dev = xext.device
    if (M != BR * N or ROW_TILE % N or tuple(depth.shape) != (BR, N)
            or ep.shape[0] != M):
        raise ValueError(f"coarse_render_fwd: {M} rows for {BR} rays x {N} "
                         f"samples (N must divide {ROW_TILE})")
    walk = weights.fwd_walk(xw, e3)
    if any(t.device != dev for t in (ep, dist, depth, walk.tiles.wide)):
        raise ValueError("coarse_render_fwd: inputs and weights must all "
                         f"lie on {dev}")
    xe, xe_k = _staged(xext, ep, walk)
    dist = dist.float().contiguous()
    depth = depth.float().contiguous()
    out = torch.empty((BR, 8), dtype=torch.float32, device=dev)
    rgb_raw = torch.empty((M, 3), dtype=torch.float32, device=dev)
    dens_raw = torch.empty((M, 1), dtype=torch.float32, device=dev)
    n_res = len(weights.trunk) + len(weights.rgb) - 1
    acts = (torch.empty((n_res, M, HIDDEN), dtype=torch.bfloat16, device=dev)
            if want_res else None)
    lib = _build.load("coarse_field", _ARGTYPES)
    err = field_fwd.launch(
        lib.coarse_fwd, walk, xe_k, weights.res_planes() if want_res else {},
        n_res=n_res if want_res else 0, N=N, stream=_build.stream_ptr(dev),
        rgb=rgb_raw, dens=dens_raw, res=acts, dist=dist, depth=depth,
        out=out)
    _build.check(err, "coarse_render_fwd")
    coarse_render_fwd.launches += 1
    return (out, rgb_raw, dens_raw, (xe, acts)) if want_res else out


coarse_render_fwd.launches = 0


def coarse_field_fwd(xext, ep, weights, compute_dtype=torch.bfloat16,
                     want_res=False):
    """(rgb_raw [M,3], dens_raw [M,1]) f32; with want_res also res, the
    kernel's (staged input, [n_res, M, 256] bf16 activations) or the twin's
    (None, list of activations), as ``coarse_render_fwd``'s.

    CPU tensors take ``coarse_field_plain``; CUDA tensors launch the kernel
    (bf16 compute only, any M) or raise."""
    if xext.device.type == "cpu":
        out = coarse_field_plain(xext, ep, weights, compute_dtype, want_res)
        return out[:2] + ((None, out[2]),) if want_res else out
    _check_cuda("coarse_field_fwd", xext, compute_dtype)
    M, xw = xext.shape
    e3 = ep.shape[1]
    dev = xext.device
    if ep.shape[0] != M:
        raise ValueError(f"coarse_field_fwd: {M} xext rows, {ep.shape[0]} "
                         "enc⊕pts rows")
    walk = weights.fwd_walk(xw, e3)
    if any(t.device != dev for t in (ep, walk.tiles.wide)):
        raise ValueError("coarse_field_fwd: inputs and weights must all lie "
                         f"on {dev}")
    xe, xe_k = _staged(xext, ep, walk)
    rgb_raw = torch.empty((M, 3), dtype=torch.float32, device=dev)
    dens_raw = torch.empty((M, 1), dtype=torch.float32, device=dev)
    n_res = len(weights.trunk) + len(weights.rgb) - 1
    acts = (torch.empty((n_res, M, HIDDEN), dtype=torch.bfloat16, device=dev)
            if want_res else None)
    lib = _build.load("coarse_field", _ARGTYPES)
    err = field_fwd.launch(
        lib.coarse_field_fwd, walk, xe_k,
        weights.res_planes() if want_res else {},
        n_res=n_res if want_res else 0, stream=_build.stream_ptr(dev),
        rgb=rgb_raw, dens=dens_raw, res=acts)
    _build.check(err, "coarse_field_fwd")
    coarse_field_fwd.launches += 1
    return (rgb_raw, dens_raw, (xe, acts)) if want_res else (rgb_raw,
                                                            dens_raw)


coarse_field_fwd.launches = 0


def _bwd_inputs(what, xext, ep, xe, acts, weights, g_rgb, g_dens,
                compute_dtype):
    """The field backward kernels' checked inputs and zeroed flat gradient:
    (M, kx, ke, layout, grads, offs, wT, g_rgb, g_dens) on the card."""
    _check_cuda(what, xext, compute_dtype)
    M, xw = xext.shape
    e3 = ep.shape[1]
    dev = xext.device
    kx, ke = _ceil16(xw), _ceil16(e3)
    n_res = len(weights.trunk) + len(weights.rgb) - 1
    if (xe is None or tuple(xe.shape) != (M, kx + ke)
            or tuple(acts.shape) != (n_res, M, HIDDEN)
            or acts.dtype != torch.bfloat16
            or tuple(g_rgb.shape) != (M, 3)
            or tuple(g_dens.shape) != (M, 1)):
        raise ValueError(f"{what}: expects the kernel's staged "
                         f"[M,{kx + ke}] input and [{n_res},M,256] bf16 "
                         f"residuals and [M,3]/[M,1] gradients, got "
                         f"{tuple(acts.shape)}, {tuple(g_rgb.shape)}, "
                         f"{tuple(g_dens.shape)}")
    wT = weights.kernel_buffer_bwd(xw, e3)
    if any(t.device != dev for t in (xe, acts, g_rgb, g_dens, wT)):
        raise ValueError(f"{what}: inputs, gradients and weights must all "
                         f"lie on {dev}")
    layout, offs, total = weights.grad_layout(kx, ke)
    grads = torch.zeros(total, dtype=torch.float32, device=dev)
    offs = _build.device_ints(tuple(offs), dev)
    return (M, kx, ke, layout, grads, offs, wT, g_rgb.float().contiguous(),
            g_dens.float().contiguous())


def _finish(weights, layout, grads, xw, e3):
    """The flat f32 gradient → gradients in ``weights.params()`` order."""
    parts, at = {}, 0
    for key, rows, cols in layout:
        parts[key] = grads[at:at + rows * cols].view(rows, cols)
        at += rows * cols
    return weights.finish_grads(parts, xw, e3)


def coarse_field_bwd(xext, ep, xe, acts, weights, g_rgb, g_dens,
                     compute_dtype=torch.bfloat16):
    """Gradients of every trunk and RGB-head tensor, in ``weights.params()``
    order, f32, from the forward's residuals (``xe`` and ``acts`` as
    ``coarse_render_fwd`` returns them).

    CPU tensors take ``coarse_field_bwd_plain``; CUDA tensors launch the
    dX-chain kernel (bf16 compute only; its launches counted here), then
    the grouped dW GEMM and its reduction (``dw_grads``), or raise."""
    if xext.device.type == "cpu":
        return coarse_field_bwd_plain(xext, ep, acts, weights, g_rgb, g_dens,
                                      compute_dtype)
    M, kx, ke, layout, grads, offs, wT, g_rgb, g_dens = _bwd_inputs(
        "coarse_field_bwd", xext, ep, xe, acts, weights, g_rgb, g_dens,
        compute_dtype)
    dev = xext.device
    gplanes = torch.empty((acts.shape[0], M, HIDDEN), dtype=torch.bfloat16,
                          device=dev)
    gnarrow = torch.empty((M, NARROW_COLS), dtype=torch.bfloat16, device=dev)
    lib = _build.load("coarse_field", _ARGTYPES)
    err = lib.coarse_bwd_dx(
        acts.data_ptr(), g_rgb.data_ptr(), g_dens.data_ptr(), wT.data_ptr(),
        grads.data_ptr(), offs.data_ptr(), gplanes.data_ptr(),
        gnarrow.data_ptr(), M, kx, ke, len(weights.trunk), len(weights.rgb),
        sum(1 << s for s in weights.skip), _build.stream_ptr(dev))
    _build.check(err, "coarse_field_bwd")
    coarse_field_bwd.launches += 1
    dw_grads([acts, xe], gplanes, gnarrow, weights.dw_segments(kx, ke), grads)
    return _finish(weights, layout, grads, xext.shape[1], ep.shape[1])


coarse_field_bwd.launches = 0


class _CoarseRender(torch.autograd.Function):
    """fused_coarse_render's custom_vjp: the forward keeps the residuals;
    the backward runs the composite backward, then the field backward
    (kernels or twins by device).  No gradient reaches the inputs."""

    @staticmethod
    def forward(ctx, xext, ep, dist, depth, weights, compute_dtype, *params):
        packed, rgb_raw, dens_raw, res = coarse_render_fwd(
            xext, ep, dist, depth, weights, compute_dtype, want_res=True)
        ctx.save_for_backward(xext, ep, dist, depth, rgb_raw, dens_raw)
        ctx.res = res
        ctx.weights = weights
        ctx.compute_dtype = compute_dtype
        return packed

    @staticmethod
    def backward(ctx, g):
        xext, ep, dist, depth, rgb_raw, dens_raw = ctx.saved_tensors
        d_rgb, d_dens = composite_coarse_bwd(rgb_raw, dens_raw, dist, depth,
                                             g.contiguous())
        xe, acts = ctx.res
        ctx.res = None
        grads = coarse_field_bwd(xext, ep, xe, acts, ctx.weights, d_rgb,
                                 d_dens, ctx.compute_dtype)
        return (None,) * 6 + tuple(grads)


class _CoarseField(torch.autograd.Function):
    """fused_coarse_field's custom_vjp: the forward keeps the residuals, the
    backward runs the field backward (kernel or twin by device) from the
    raw-output gradients.  No gradient reaches the inputs."""

    @staticmethod
    def forward(ctx, xext, ep, weights, compute_dtype, *params):
        rgb_raw, dens_raw, res = coarse_field_fwd(xext, ep, weights,
                                                  compute_dtype, want_res=True)
        ctx.save_for_backward(xext, ep)
        ctx.res = res
        ctx.weights = weights
        ctx.compute_dtype = compute_dtype
        return rgb_raw, dens_raw

    @staticmethod
    def backward(ctx, g_rgb, g_dens):
        xext, ep = ctx.saved_tensors
        xe, acts = ctx.res
        ctx.res = None
        grads = coarse_field_bwd(xext, ep, xe, acts, ctx.weights,
                                 g_rgb.contiguous(), g_dens.contiguous(),
                                 ctx.compute_dtype)
        return (None,) * 4 + tuple(grads)


def coarse_field(xext, ep, weights, compute_dtype=torch.bfloat16):
    """Differentiable coarse field: (rgb_raw [M,3], dens_raw [M,1]) with
    gradients to every trunk and RGB-head tensor."""
    return _CoarseField.apply(xext, ep, weights, compute_dtype,
                              *weights.params())


def coarse_render(xext, ep, dist, depth, weights,
                  compute_dtype=torch.bfloat16):
    """Differentiable coarse render: packed [BR,8] with gradients to every
    trunk and RGB-head tensor."""
    return _CoarseRender.apply(xext, ep, dist, depth, weights, compute_dtype,
                               *weights.params())
