"""Static/transient/light field, forward and backward: the CUDA kernels'
wrappers, their plain-PyTorch twins, and the autograd Function that pairs
them (``st_field``).

Replaces texpose_tpu/kernels/fused_st_field.py (``fused_st_field``:
``_run_fwd`` and ``_run_bwd`` with ``_finish_split``).  The kernels are in
``csrc/st_field.cu``; its header says what bounds them on the card and how
their design answers that.

Forward contract (as the JAX op in its default "xext" + split-heads mode):
  xext   [M, 3+6L] f32  pts ⊕ c2f-weighted sin/cos bands (``make_xext``)
  encpts [M, E+3]  f32  view encoding ⊕ pts (the RGB head's row input)
  light  [B, Dl], trans [B, Dt]  per-image latents; row m belongs to image
         m // rows_per_img
  → rgb_raw [M,3], dens_raw [M,1], trans_raw [M,5] float32, no activations.
The latent columns of both heads' layer 0 are pre-multiplied once per call
into [B,256] rows (``latent_rows``), so layer 0 adds a row instead of
concatenating [M,48]/[M,16] broadcasts.  Both paths round every matmul
operand to compute_dtype and accumulate in float32.

Backward contract (the trunk is frozen): from the forward's [M,256]
feature residual, enc⊕pts, the latents and the raw-output gradients
g_rgb [M,3], g_trans [M,5] → the gradients of every head Dense weight and
bias, and of the gathered latent rows light [B,Dl] and trans [B,Dt].
Nothing flows to the trunk, the points or the encodings.  The products
round both operands to compute_dtype (the JAX kernel's ``.astype(cdtype)``
before every ``_dot_t1``/``_dot_t2``); bias and latent sums stay f32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..nn.mlp import relu, round_to
from ..ops.consts import device_const
from . import _build, field_fwd
from .dw_gemm import NARROW, NARROW_COLS, WIDE, Segment, dw_grads
from .field_fwd import (Tiles, blocks, build_tiles, make_walk,
                        st_head_layers, trunk_layers, trunk_walk_layers,
                        write_tiles)

HIDDEN = 256          # the CUDA kernel's layer width
_OUT_TILE = 8         # output layers are padded to one mma n-tile
ROW_TILE = 64         # a kernel with a composite epilogue needs whole rays
                      # in each 64-row half of its row tile (field_fwd.cuh)


def make_xext(pts, L, c2f_w):
    """[M, 3+6L] float32: pts then, per dim, L sin and L cos bands of
    2^k·π·x times the c2f window — posenc_with_identity's layout, with the
    angles formed element-wise in float32."""
    freqs = device_const(tuple((2.0 ** k) * math.pi for k in range(int(L))),
                         torch.float32, pts.device)
    ang = pts.float()[:, :, None] * freqs                       # [M,3,L]
    w = torch.cat([c2f_w, c2f_w]).to(torch.float32)
    blk = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1) * w
    return torch.cat([pts.float(), blk.reshape(pts.shape[0], 6 * int(L))],
                     dim=1)


def latent_rows(light, trans, w_l, w_t, compute_dtype):
    """Each image's latent contribution to the heads' layer 0: [B,O] f32."""
    return (round_to(light, compute_dtype) @ round_to(w_l, compute_dtype),
            round_to(trans, compute_dtype) @ round_to(w_t, compute_dtype))


def _ceil16(n):
    return (n + 15) // 16 * 16


def _pack_layer(w, segs, n_out, n_pad):
    """w [K,N] (JAX [in,out] layout) → mma fragment order, bf16, flat: the
    mma.sync kernels' packs (the backwards, and the forwards' measurement
    build).

    segs: [(row_lo, row_hi, k_pad)] — where each input slice of w lands in
    the kernel's zero-padded K.  Tile (nt, kt) of the packed buffer holds,
    for lane l = 4g + q, the bf16 values B[k][n] at n = nt*8 + g and
    k = kt*16 + (2q, 2q+1, 2q+8, 2q+9): one 8-byte load per lane."""
    k_pad = sum(kp for _, _, kp in segs)
    full = torch.zeros((k_pad, n_pad), dtype=torch.float32, device=w.device)
    r = 0
    for lo, hi, kp in segs:
        full[r:r + hi - lo, :n_out] = w[lo:hi]
        r += kp
    KT, NT = k_pad // 16, n_pad // 8
    return (full.to(torch.bfloat16).view(KT, 2, 4, 2, NT, 8)
            .permute(4, 0, 5, 2, 1, 3).reshape(-1))


def stage_rows(xext, encpts, kx, ke):
    """The field kernels' row input: [M, kx+ke] bf16, xext | enc⊕pts, each
    zero padded to its 16-multiple width."""
    M, xw = xext.shape
    xe = torch.zeros((M, kx + ke), dtype=torch.bfloat16, device=xext.device)
    xe[:, :xw] = xext
    xe[:, kx:kx + encpts.shape[1]] = encpts
    return xe


def _pad_bias(b, n_pad):
    out = torch.zeros((n_pad,), dtype=torch.float32, device=b.device)
    out[:b.shape[0]] = b
    return out


class PackCache:
    """Packed copies of dense layers (objects with ``.w`` [in,out] and
    ``.b``) for a kernel.  Each pack is rebuilt whenever one of its
    parameters is modified in place (an optimizer step or load_state_dict
    bumps ``_version``)."""

    _kind = "field"

    @staticmethod
    def _key(extra, layers):
        return tuple(extra) + tuple((id(t), t._version, t.device)
                                    for layer in layers
                                    for t in (layer.w, layer.b))

    def _cached(self, name, extra, layers, build):
        key = self._key(extra, layers)
        hit = self._packs.get(name)
        if hit is not None and hit[0] == key:
            return hit[1]
        with torch.no_grad():
            value = build()
        self._packs[name] = (key, value)
        return value

    def _bad(self, msg):
        raise ValueError(f"{self._kind} CUDA kernel: {msg}")


def check_trunk(trunk, skip, xw, bad):
    """The trunk layers the kernels take: 256 wide, layer 0 not a skip."""
    if 0 in skip or len(trunk) > 31:
        bad(f"unsupported trunk (skip {skip}, {len(trunk)} layers)")
    n = len(trunk)
    for li, layer in enumerate(trunk):
        n_in = xw if li == 0 else HIDDEN + (xw if li in skip else 0)
        want = (n_in, HIDDEN + (li == n - 1))
        if tuple(layer.w.shape) != want:
            bad(f"trunk layer {li} is {tuple(layer.w.shape)}, "
                f"expected {want}")


class TrunkWeights(PackCache):
    """The trunk's dense layers (``.w`` [in,out], ``.b``) plus the trunk
    kernel's walk (``trunk_walk``), rebuilt whenever a trunk tensor changed.
    Every field's weights extend it, so the trunk kernel of kernels/trunk.py
    takes any field's."""

    _kind = "trunk"

    def __init__(self, trunk, skip):
        self.trunk = list(trunk)
        self.skip = tuple(sorted(int(s) for s in skip))
        self.feat_dim = self.trunk[-1].w.shape[1] - 1
        self._packs = {}

    def trunk_walk(self, xw):
        """The trunk kernel's ``Walk`` (row 10, kernels/field_fwd.py
        ``trunk_walk_layers``; ke 0, the X region xext's blocks alone).  Its
        tiles are those of this field's forward walk (``fwd_walk``, where
        the trunk's layers come first) when one over the same xext width is
        cached with the current trunk, read through the trunk's offsets;
        else the trunk's own."""
        kx = _ceil16(xw)

        def build():
            check_trunk(self.trunk, self.skip, xw, self._bad)
            layers = trunk_walk_layers(self.trunk, self.skip, xw, kx,
                                       self._bad)
            tiles = self._field_tiles(xw)
            tiles = (build_tiles(layers, self.trunk[0].w.device)
                     if tiles is None else
                     Tiles(tiles.wide, tiles.narrow, tiles.bias,
                           tiles.offs[:len(layers)]))
            return make_walk(layers, tiles, kx, 0, blocks(kx), self._bad)

        return self._cached("trunk_walk", (xw,), self.trunk, build)

    def _field_tiles(self, xw):
        """The tiles of the cached forward walk over xext ``xw`` wide whose
        trunk is the current one, or None.  Its cache key is (xw, e3) and
        then the trunk's tensors (``fwd_walk``)."""
        hit = self._packs.get("walk")
        trunk = self._key((), self.trunk)
        if hit is None or hit[0][0] != xw or hit[0][2:2 + len(trunk)] != trunk:
            return None
        return hit[1].tiles


def pack_head(layers, first_segs):
    """(wpack bf16, bias f32) of a head: layer 0 with ``first_segs``, the
    hidden layers 256 → 256, the output layer padded to one n8 tile."""
    ws, bs = [], []
    for li, layer in enumerate(layers):
        segs = first_segs if li == 0 else [(0, HIDDEN, HIDDEN)]
        if li < len(layers) - 1:
            ws.append(_pack_layer(layer.w, segs, HIDDEN, HIDDEN))
            bs.append(layer.b)
        else:
            ws.append(_pack_layer(layer.w, segs, layer.w.shape[1],
                                  _OUT_TILE))
            bs.append(_pad_bias(layer.b, _OUT_TILE))
    return ws, bs


class STFieldWeights(TrunkWeights):
    """The field's dense layers (objects with ``.w`` [in,out] and ``.b``)
    plus the kernels' copies of them: the forward walk's tiles are built
    when a trunk tensor changed (a head update rewrites the heads' rows in
    place), the heads' packs whenever a head tensor changed."""

    _kind = "st_field"

    def __init__(self, trunk, rgb, trans, skip):
        super().__init__(trunk, skip)
        self.rgb, self.trans = list(rgb), list(trans or ())
        self._heads_of = (None, None)     # (walk, the heads' key it holds)

    def _check_heads(self, e3):
        for name, head, n_out in (("rgb", self.rgb, 3),
                                  ("trans", self.trans, 5)):
            shapes = [tuple(layer.w.shape) for layer in head]
            if (len(head) < 2 or len(head) > 16 or shapes[0][1] != HIDDEN
                    or shapes[-1] != (HIDDEN, n_out)
                    or any(s != (HIDDEN, HIDDEN) for s in shapes[1:-1])):
                self._bad(f"{name} head layers {shapes}")
        if self.rgb[0].w.shape[0] <= self.feat_dim + e3:
            self._bad("rgb layer 0 has no latent rows")

    def fwd_walk(self, xw, e3):
        """The forward kernel's ``Walk`` (kernels/field_fwd.py): the
        trunk's layers, then the RGB and the transient head's, in one set
        of tiles built whenever a trunk tensor changed; when only a head
        tensor did, the heads' rows are rewritten in place."""
        kx, ke = _ceil16(xw), _ceil16(e3)

        def heads():
            self._check_heads(e3)
            return st_head_layers(self.rgb, self.trans, kx, ke,
                                  self.feat_dim, e3)

        def build():
            check_trunk(self.trunk, self.skip, xw, self._bad)
            layers = trunk_layers(self.trunk, self.skip, xw, kx,
                                  self._bad) + heads()
            walk = make_walk(layers, build_tiles(layers, self.rgb[0].w.device),
                             kx, ke, 4, self._bad)
            self._heads_of = (walk, self._key((), self.rgb + self.trans))
            return walk

        walk = self._cached("walk", (xw, e3), self.trunk, build)
        key = self._key((), self.rgb + self.trans)
        if self._heads_of[0] is not walk or self._heads_of[1] != key:
            nt = len(self.trunk)
            with torch.no_grad():
                walk.layers[nt:] = heads()
                write_tiles(walk.tiles, walk.layers[nt:], nt)
            self._heads_of = (walk, key)
        return walk

    def kernel_buffers_bwd(self, e3):
        """Backward: (heads wpack, heads bias, Wᵀ pack, ke); the Wᵀ pack
        holds each head's layers 1..n-1 transposed ([out, in], out padded
        to 16 for the output layers), RGB head first."""
        ke = _ceil16(e3)

        def build_t():
            self._check_heads(e3)
            return _cat_packs(
                [_pack_layer(layer.w.t(), [(0, layer.w.shape[1],
                                            _ceil16(layer.w.shape[1]))],
                             HIDDEN, HIDDEN)
                 for head in (self.rgb, self.trans) for layer in head[1:]])

        heads = self._cached("heads", (e3,), self.rgb + self.trans,
                             lambda: self._pack_heads(e3, ke))
        wT = self._cached("heads_t", (e3,), self.rgb + self.trans, build_t)
        return heads + (wT, ke)

    def _pack_heads(self, e3, ke):
        self._check_heads(e3)
        F, H = self.feat_dim, HIDDEN
        ws, bs = [], []
        for head, first_segs in ((self.rgb, [(0, F, H), (F, F + e3, ke)]),
                                 (self.trans, [(0, F, H)])):
            w, b = pack_head(head, first_segs)
            ws += w
            bs += b
        return _cat_packs(ws), _cat_packs(bs, torch.float32)

    def head_params(self):
        """The heads' tensors in the order the backward returns their
        gradients: RGB (w, b) per layer, then transient."""
        return [t for head in (self.rgb, self.trans) for layer in head
                for t in (layer.w, layer.b)]


def _cat_packs(parts, dtype=None):
    out = torch.cat([p.reshape(-1) for p in parts]).contiguous()
    return out if dtype is None else out.to(dtype)


def _latent_rows(weights, light, trans, e3, compute_dtype):
    F = weights.feat_dim
    return latent_rows(light, trans, weights.rgb[0].w[F + e3:],
                       weights.trans[0].w[F:], compute_dtype)


def heads_plain(feat, encpts, light, trans, weights, rows_per_img,
                compute_dtype=torch.bfloat16):
    """Both heads' raw outputs (rgb_raw [M,3], trans_raw [M,5]) from the
    trunk features, at the forward twin's rounding points: the heads of
    ``st_field_plain``, and the recompute of the render backward's twin."""
    def c(x):
        return round_to(x, compute_dtype)

    lrow, trow = _latent_rows(weights, light, trans, encpts.shape[1],
                              compute_dtype)
    img = torch.arange(feat.shape[0], device=feat.device) // rows_per_img

    def head(layers, extra, lat):
        x0 = feat if extra is None else torch.cat([feat, c(extra)], dim=-1)
        w0 = layers[0].w[:x0.shape[1]]
        h = relu(c(x0) @ c(w0) + lat[img] + layers[0].b)
        for layer in layers[1:-1]:
            h = relu(c(h) @ c(layer.w) + layer.b)
        return c(h) @ c(layers[-1].w) + layers[-1].b

    return head(weights.rgb, encpts, lrow), head(weights.trans, None, trow)


def st_field_plain(xext, encpts, light, trans, weights, rows_per_img,
                   compute_dtype=torch.bfloat16, want_feat=False):
    """The forward kernel's plain-PyTorch twin: same signature, same
    rounding points.  want_feat adds the residual (the trunk features as
    the heads read them: rounded to compute_dtype, held in float32)."""
    def c(x):
        return round_to(x, compute_dtype)

    xc = c(xext)
    h = xc
    n = len(weights.trunk)
    dens = None
    for li, layer in enumerate(weights.trunk):
        if li in weights.skip:
            h = torch.cat([h, xc], dim=-1)
        z = c(h) @ c(layer.w) + layer.b
        if li == n - 1:
            dens = z[:, :1]
            z = z[:, 1:]
        h = relu(z)
    rgb, tr = heads_plain(h, encpts, light, trans, weights, rows_per_img,
                          compute_dtype)
    out = (rgb, dens, tr)
    return out + (c(h),) if want_feat else out


def _image_index(M, rows_per_img, n_img, device):
    return torch.clamp(torch.arange(M, device=device) // rows_per_img,
                       max=n_img - 1)


def st_field_bwd_plain(feat, encpts, light, trans, weights, rows_per_img,
                       g_rgb, g_trans, compute_dtype=torch.bfloat16):
    """The backward kernel's plain-PyTorch twin (any layer width): the
    heads recomputed from the feature residual, then each layer's
    dW = round(h)ᵀ·round(g), db = Σ g, g ← (round(g)·round(W)ᵀ)⊙[h > 0]
    down to layer 0, whose row sums per image are the latent rows'
    gradient.  Returns what ``st_field_bwd`` returns."""
    def c(x):
        return round_to(x, compute_dtype)

    e3 = encpts.shape[1]
    lrow, trow = _latent_rows(weights, light, trans, e3, compute_dtype)
    M = feat.shape[0]
    img = _image_index(M, rows_per_img, lrow.shape[0], feat.device)
    featc = c(feat.float())
    ep = c(encpts.float())
    parts, dlat = {}, {}
    for name, layers, extra, lat, g_out in (
            ("rgb", weights.rgb, ep, lrow, g_rgb),
            ("trans", weights.trans, None, trow, g_trans)):
        x0 = featc if extra is None else torch.cat([featc, extra], dim=-1)
        hs = [relu(c(x0) @ c(layers[0].w[:x0.shape[1]]) + lat[img]
                   + layers[0].b)]
        for layer in layers[1:-1]:
            hs.append(relu(c(hs[-1]) @ c(layer.w) + layer.b))
        g = g_out.float()
        for li in range(len(layers) - 1, 0, -1):
            parts[(name, li, "w")] = c(hs[li - 1]).t() @ c(g)
            parts[(name, li, "b")] = g.sum(0)
            g = (c(g) @ c(layers[li].w).t()) * (hs[li - 1] > 0)
        parts[(name, 0, "w")] = featc.t() @ c(g)
        if extra is not None:
            parts[(name, 0, "w_ep")] = extra.t() @ c(g)
        parts[(name, 0, "b")] = g.sum(0)
        dlat[name] = torch.zeros((lat.shape[0], g.shape[1]),
                                 dtype=torch.float32,
                                 device=g.device).index_add_(0, img, g)
    return _finish_bwd(weights, parts, dlat["rgb"], dlat["trans"], light,
                       trans, e3)


def _grad_layout(weights, ke):
    """[(head, layer, part, rows, cols)] of the backward kernel's flat f32
    output, in its walk order: per head and layer, dW (output layers padded
    to one 8-column tile), for RGB layer 0 also the enc⊕pts block [ke,256],
    then db.  The blocks are the heads' width (256 on the kernels' path)."""
    out = []
    for name, head in (("rgb", weights.rgb), ("trans", weights.trans)):
        for li, layer in enumerate(head):
            cols = layer.w.shape[1] if li < len(head) - 1 else _OUT_TILE
            rows = weights.feat_dim if li == 0 else layer.w.shape[0]
            out.append((name, li, "w", rows, cols))
            if li == 0 and name == "rgb":
                out.append((name, li, "w_ep", ke, cols))
            out.append((name, li, "b", 1, cols))
    return out


def dw_segments(weights, ke):
    """The dW blocks of ``_grad_layout`` as the grouped GEMM's segments
    (kernels/dw_gemm.py): A source 0 is the stack of both heads' recomputed
    hidden activations (RGB head first: plane j of a head = its hidden
    layer j's output), A source 1 the feat residual, A source 2 enc⊕pts
    [M, ke]; wide G plane j is the gradient of hidden activation plane j,
    the narrow plane holds d rgb_raw (columns 0-2) and d trans_raw (8-12)."""
    off, at = {}, 0
    for name, li, part, r, c in _grad_layout(weights, ke):
        off[name, li, part] = at
        at += r * c
    segs, base, F = [], 0, weights.feat_dim
    for name, head, col in (("rgb", weights.rgb, 0),
                            ("trans", weights.trans, 8)):
        n, H = len(head), head[0].w.shape[1]
        segs.append(Segment(1, 0, 0, F, WIDE, base, 0, H, off[name, 0, "w"]))
        if name == "rgb":
            segs.append(Segment(2, 0, 0, ke, WIDE, base, 0, H,
                                off[name, 0, "w_ep"]))
        for li in range(1, n - 1):
            segs.append(Segment(0, base + li - 1, 0, H, WIDE, base + li, 0,
                                H, off[name, li, "w"]))
        segs.append(Segment(0, base + n - 2, 0, H, NARROW, 0, col, _OUT_TILE,
                            off[name, n - 1, "w"]))
        base += n - 1
    return segs


def st_field_bwd_dx_plain(feat, encpts, light, trans, weights, rows_per_img,
                          g_rgb, g_trans, compute_dtype=torch.bfloat16):
    """The dX-chain kernel's twin (phase (a) of the heads' backward): the
    heads recomputed and walked down as ``st_field_bwd_plain`` does,
    without the dW products → (hplanes, gplanes [n_rgb-1 + n_trans-1, M,
    256]: each head's hidden activations and their gradients, RGB head
    first, rounded to compute_dtype; gnarrow [M, 16]: d rgb_raw in columns
    0-2 and d trans_raw in 8-12, rounded; grads: the flat f32 buffer of
    ``_grad_layout`` with every db block set and every dW block zero;
    d_lrow, d_trow: the per-image row sums of each head's layer-0
    gradient).  ``dw_grads`` over ``dw_segments`` fills the dW blocks."""
    def c(x):
        return round_to(x, compute_dtype)

    e3 = encpts.shape[1]
    ke = _ceil16(e3)
    lrow, trow = _latent_rows(weights, light, trans, e3, compute_dtype)
    M = feat.shape[0]
    img = _image_index(M, rows_per_img, lrow.shape[0], feat.device)
    featc = c(feat.float())
    ep = c(encpts.float())
    layout = _grad_layout(weights, ke)
    off, at = {}, 0
    for name, li, part, r, cc in layout:
        off[name, li, part] = at
        at += r * cc
    grads = torch.zeros(at, dtype=torch.float32, device=feat.device)
    nh = len(weights.rgb) + len(weights.trans) - 2
    hplanes = torch.zeros((nh, M, weights.rgb[0].w.shape[1]),
                          device=feat.device)
    gplanes = torch.zeros_like(hplanes)
    gnarrow = torch.zeros((M, 16), device=feat.device)
    gnarrow[:, :3] = c(g_rgb.float())
    gnarrow[:, 8:13] = c(g_trans.float())
    dlat, base = {}, 0
    for name, layers, extra, lat, g_out in (
            ("rgb", weights.rgb, ep, lrow, g_rgb),
            ("trans", weights.trans, None, trow, g_trans)):
        x0 = featc if extra is None else torch.cat([featc, extra], dim=-1)
        hs = [relu(c(x0) @ c(layers[0].w[:x0.shape[1]]) + lat[img]
                   + layers[0].b)]
        for layer in layers[1:-1]:
            hs.append(relu(c(hs[-1]) @ c(layer.w) + layer.b))
        g = g_out.float()
        b = off[name, len(layers) - 1, "b"]
        grads[b:b + g.shape[1]] = g.sum(0)
        for li in range(len(layers) - 1, 0, -1):
            g = (c(g) @ c(layers[li].w).t()) * (hs[li - 1] > 0)
            hplanes[base + li - 1] = c(hs[li - 1])
            gplanes[base + li - 1] = c(g)
            b = off[name, li - 1, "b"]
            grads[b:b + g.shape[1]] = g.sum(0)
        dlat[name] = torch.zeros((lat.shape[0], g.shape[1]),
                                 dtype=torch.float32,
                                 device=g.device).index_add_(0, img, g)
        base += len(layers) - 1
    return hplanes, gplanes, gnarrow, grads, dlat["rgb"], dlat["trans"]


def _finish_bwd(weights, parts, d_lrow, d_trow, light, trans, e3):
    """The JAX op's _finish_split, in f32: the latent blocks' dW rows
    (latentᵀ·d_row) and the latents' own gradients (d_row·W_latᵀ) from the
    per-image layer-0 row sums; the head gradients back in the parameter
    layout.  → (head grads in ``head_params`` order, d_light, d_trans)."""
    F = weights.feat_dim
    out = []
    for name, head, lat, d_row in (("rgb", weights.rgb, light, d_lrow),
                                   ("trans", weights.trans, trans, d_trow)):
        for li, layer in enumerate(head):
            n_out = layer.w.shape[1]
            dw = parts[(name, li, "w")][:, :n_out]
            if li == 0:
                blocks = [dw]
                if name == "rgb":
                    blocks.append(parts[(name, 0, "w_ep")][:e3, :n_out])
                blocks.append(lat.float().t() @ d_row)
                dw = torch.cat(blocks, dim=0)
            out += [dw, parts[(name, li, "b")].reshape(-1)[:n_out]]
    d_light = d_lrow @ weights.rgb[0].w[F + e3:].float().t()
    d_trans = d_trow @ weights.trans[0].w[F:].float().t()
    return out, d_light, d_trans


_ARGTYPES = {
    "st_field_fwd": field_fwd.ARGTYPES,
    "st_field_bwd_dx": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}


def _check_rows(what, M, encpts, light, trans, rows_per_img):
    if (encpts.shape[0] != M or rows_per_img <= 0
            or -(-M // rows_per_img) > min(light.shape[0], trans.shape[0])):
        raise ValueError(f"{what}: row counts disagree")


def _check_cuda(what, x, compute_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"{what}: the CUDA kernel computes in bfloat16 "
                         f"only, got compute_dtype={compute_dtype}")


def fwd_inputs(what, xext, encpts, light, trans, weights, rows_per_img,
               compute_dtype, others=()):
    """The field forward kernels' checked, staged inputs: (walk, lrow, trow,
    xe) on the inputs' card; ``others`` are further tensors that must lie
    there."""
    _check_cuda(what, xext, compute_dtype)
    M, xw = xext.shape
    e3 = encpts.shape[1]
    dev = xext.device
    _check_rows(what, M, encpts, light, trans, rows_per_img)
    walk = weights.fwd_walk(xw, e3)
    if any(t.device != dev for t in (encpts, light, trans, walk.tiles.wide,
                                     *others)):
        raise ValueError(f"{what}: inputs, latents and weights must all lie "
                         f"on {dev}")
    lrow, trow = _latent_rows(weights, light, trans, e3, compute_dtype)
    return (walk, lrow.float().contiguous(), trow.float().contiguous(),
            stage_rows(xext, encpts, walk.kx, walk.ke))


def st_field_fwd(xext, encpts, light, trans, weights, rows_per_img,
                 compute_dtype=torch.bfloat16, want_feat=False):
    """(rgb_raw [M,3], dens_raw [M,1], trans_raw [M,5]) f32, plus the
    [M,256] feature residual with want_feat (bf16 from the kernel).

    CPU tensors take ``st_field_plain``; CUDA tensors launch the kernel
    (bf16 compute only) or raise."""
    if xext.device.type == "cpu":
        return st_field_plain(xext, encpts, light, trans, weights,
                              rows_per_img, compute_dtype, want_feat)
    walk, lrow, trow, xe = fwd_inputs(
        "st_field_fwd", xext, encpts, light, trans, weights, rows_per_img,
        compute_dtype)
    M, dev = xext.shape[0], xext.device
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev)
    dens = torch.empty((M, 1), dtype=torch.float32, device=dev)
    tr = torch.empty((M, 5), dtype=torch.float32, device=dev)
    feat = (torch.empty((M, HIDDEN), dtype=torch.bfloat16, device=dev)
            if want_feat else None)
    lib = _build.load("st_field", _ARGTYPES)
    err = field_fwd.launch(
        lib.st_field_fwd, walk, xe, feat_plane(weights, want_feat),
        n_res=int(want_feat), rows_per_img=rows_per_img, n_img=lrow.shape[0],
        stream=_build.stream_ptr(dev), lrow=lrow, trow=trow, rgb=rgb,
        dens=dens, trans=tr, res=feat)
    _build.check(err, "st_field_fwd")
    st_field_fwd.launches += 1
    return (rgb, dens, tr, feat) if want_feat else (rgb, dens, tr)


def feat_plane(weights, want_feat):
    """The forward walk's residual plane: the last trunk layer's output, the
    feature residual, as plane 0 when it is wanted."""
    return {len(weights.trunk) - 1: 0} if want_feat else {}


st_field_fwd.launches = 0


def bwd_inputs(what, feat, encpts, light, trans, weights, rows_per_img,
               compute_dtype, others=()):
    """The heads' backward kernels' checked inputs and zeroed outputs:
    (heads wpack, heads bias, Wᵀ pack, ke, ep, lrow, trow, layout, grads,
    d_lrow, d_trow) on the residual's card; ``others`` are further tensors
    that must lie there."""
    _check_cuda(what, feat, compute_dtype)
    M, e3 = feat.shape[0], encpts.shape[1]
    dev = feat.device
    _check_rows(what, M, encpts, light, trans, rows_per_img)
    if feat.dtype != torch.bfloat16 or tuple(feat.shape) != (M, HIDDEN):
        raise ValueError(f"{what}: expects a bf16 [M,256] residual, got "
                         f"{feat.dtype} {tuple(feat.shape)}")
    wh, bh, wT, ke = weights.kernel_buffers_bwd(e3)
    if any(t.device != dev for t in (encpts, light, trans, wh, *others)):
        raise ValueError(f"{what}: inputs, gradients, latents and weights "
                         f"must all lie on {dev}")
    lrow, trow = _latent_rows(weights, light, trans, e3, compute_dtype)
    ep = torch.zeros((M, ke), dtype=torch.bfloat16, device=dev)
    ep[:, :e3] = encpts
    lrow = lrow.float().contiguous()
    trow = trow.float().contiguous()
    layout = _grad_layout(weights, ke)
    grads = torch.zeros(sum(r * c for *_, r, c in layout),
                        dtype=torch.float32, device=dev)
    return (wh, bh, wT, ke, ep, lrow, trow, layout, grads,
            torch.zeros_like(lrow), torch.zeros_like(trow))


def finish_flat(weights, layout, grads, d_lrow, d_trow, light, trans, e3):
    """The backward kernels' flat f32 output → ``_finish_bwd``'s result."""
    parts, off = {}, 0
    for name, li, part, r, c in layout:
        parts[(name, li, part)] = grads[off:off + r * c].view(r, c)
        off += r * c
    return _finish_bwd(weights, parts, d_lrow, d_trow, light, trans, e3)


def st_field_bwd(feat, encpts, light, trans, weights, rows_per_img, g_rgb,
                 g_trans, compute_dtype=torch.bfloat16):
    """Gradients of the heads and latents → (head grads in
    ``weights.head_params()`` order, d_light [B,Dl], d_trans [B,Dt]), f32.

    CPU tensors take ``st_field_bwd_plain``; CUDA tensors launch the
    dX-chain kernel (bf16 compute only; its launches counted here), then
    the grouped dW GEMM and its reduction (``dw_grads``), or raise."""
    if feat.device.type == "cpu":
        return st_field_bwd_plain(feat, encpts, light, trans, weights,
                                  rows_per_img, g_rgb, g_trans,
                                  compute_dtype)
    M = feat.shape[0]
    if tuple(g_rgb.shape) != (M, 3) or tuple(g_trans.shape) != (M, 5):
        raise ValueError("st_field_bwd: expects [M,3]/[M,5] gradients, got "
                         f"{tuple(g_rgb.shape)}, {tuple(g_trans.shape)}")
    (wh, bh, wT, ke, ep, lrow, trow, layout, grads, d_lrow,
     d_trow) = bwd_inputs("st_field_bwd", feat, encpts, light, trans,
                          weights, rows_per_img, compute_dtype,
                          (g_rgb, g_trans))
    g_rgb = g_rgb.float().contiguous()
    g_trans = g_trans.float().contiguous()
    feat = feat.contiguous()
    dev = feat.device
    hplanes, gplanes, gnarrow = planes = split_planes(weights, M, dev)
    lib = _build.load("st_field", _ARGTYPES)
    err = lib.st_field_bwd_dx(
        feat.data_ptr(), ep.data_ptr(), g_rgb.data_ptr(), g_trans.data_ptr(),
        wh.data_ptr(), bh.data_ptr(), wT.data_ptr(), lrow.data_ptr(),
        trow.data_ptr(), grads.data_ptr(), d_lrow.data_ptr(),
        d_trow.data_ptr(), hplanes.data_ptr(), gplanes.data_ptr(),
        gnarrow.data_ptr(), M, ke, int(rows_per_img), lrow.shape[0],
        len(weights.rgb), len(weights.trans), _build.stream_ptr(dev))
    _build.check(err, "st_field_bwd")
    st_field_bwd.launches += 1
    return finish_split(weights, planes, feat, ep, layout, grads, d_lrow,
                        d_trow, light, trans, encpts.shape[1])


st_field_bwd.launches = 0


def split_planes(weights, M, device):
    """The planes a heads' dX chain (rows 2 and 6b) writes and the grouped
    dW GEMM reads: (hplanes, gplanes [n_rgb-1 + n_trans-1, M, 256] bf16,
    RGB head first; gnarrow [M, 16] bf16)."""
    nh = len(weights.rgb) + len(weights.trans) - 2
    hplanes = torch.empty((nh, M, HIDDEN), dtype=torch.bfloat16,
                          device=device)
    return (hplanes, torch.empty_like(hplanes),
            torch.empty((M, NARROW_COLS), dtype=torch.bfloat16,
                        device=device))


def finish_split(weights, planes, feat, ep, layout, grads, d_lrow, d_trow,
                 light, trans, e3):
    """Phase (b) of the split heads' backward (rows 2 and 6b): every dW
    from the dX chain's ``planes``, the feat residual and the staged
    enc⊕pts ``ep`` (``dw_grads`` over ``dw_segments``), then
    ``finish_flat``."""
    hplanes, gplanes, gnarrow = planes
    dw_grads([hplanes, feat, ep], gplanes, gnarrow,
             dw_segments(weights, ep.shape[1]), grads)
    return finish_flat(weights, layout, grads, d_lrow, d_trow, light, trans,
                       e3)


class _STField(torch.autograd.Function):
    """fused_st_field's custom_vjp: forward keeps the feature residual,
    backward runs the heads-only backward (kernel or twin by device)."""

    @staticmethod
    def forward(ctx, xext, encpts, light, trans, weights, rows_per_img,
                compute_dtype, *head_params):
        rgb, dens, tr, feat = st_field_fwd(xext, encpts, light, trans,
                                           weights, rows_per_img,
                                           compute_dtype, want_feat=True)
        ctx.save_for_backward(feat, encpts, light, trans, *head_params)
        ctx.weights = weights
        ctx.rows_per_img = rows_per_img
        ctx.compute_dtype = compute_dtype
        ctx.mark_non_differentiable(dens)
        return rgb, dens, tr

    @staticmethod
    def backward(ctx, g_rgb, _g_dens, g_trans):
        feat, encpts, light, trans = ctx.saved_tensors[:4]
        if g_rgb is None:
            g_rgb = torch.zeros((feat.shape[0], 3), device=feat.device)
        if g_trans is None:
            g_trans = torch.zeros((feat.shape[0], 5), device=feat.device)
        d_heads, d_light, d_trans = st_field_bwd(
            feat, encpts, light, trans, ctx.weights, ctx.rows_per_img,
            g_rgb, g_trans, ctx.compute_dtype)
        return (None, None, d_light, d_trans, None, None, None, *d_heads)


def st_field(xext, encpts, light, trans, weights, rows_per_img,
             compute_dtype=torch.bfloat16):
    """Differentiable field: (rgb_raw, dens_raw, trans_raw) with gradients
    to the head parameters and to ``light`` / ``trans`` only (dens_raw is
    frozen-trunk output)."""
    return _STField.apply(xext, encpts, light, trans, weights, rows_per_img,
                          compute_dtype, *weights.head_params())
