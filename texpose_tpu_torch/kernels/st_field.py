"""Static/transient/light field forward: the CUDA kernel's wrapper and its
plain-PyTorch twin.

Replaces texpose_tpu/kernels/fused_st_field.py (``fused_st_field``
forward, ``_run_fwd``) on the evaluation path.  The kernel is
``csrc/st_field.cu``; its header says what bounds it on the card and how
its design answers that.

Contract (as the JAX op in its default "xext" + split-heads mode):
  xext   [M, 3+6L] f32  pts ⊕ c2f-weighted sin/cos bands (``make_xext``)
  encpts [M, E+3]  f32  view encoding ⊕ pts (the RGB head's row input)
  light  [B, Dl], trans [B, Dt]  per-image latents; row m belongs to image
         m // rows_per_img
  → rgb_raw [M,3], dens_raw [M,1], trans_raw [M,5] float32, no activations.
The latent columns of both heads' layer 0 are pre-multiplied once per call
into [B,256] rows (``latent_rows``), so layer 0 adds a row instead of
concatenating [M,48]/[M,16] broadcasts.  Both paths round every matmul
operand to compute_dtype and accumulate in float32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..nn.mlp import relu, round_to
from . import _build

HIDDEN = 256          # the CUDA kernel's layer width
_OUT_TILE = 8         # output layers are padded to one mma n-tile


def make_xext(pts, L, c2f_w):
    """[M, 3+6L] float32: pts then, per dim, L sin and L cos bands of
    2^k·π·x times the c2f window — posenc_with_identity's layout, with the
    angles formed element-wise in float32."""
    freqs = torch.tensor([(2.0 ** k) * math.pi for k in range(int(L))],
                         dtype=torch.float32, device=pts.device)
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
    """w [K,N] (JAX [in,out] layout) → mma fragment order, bf16, flat.

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


def _pad_bias(b, n_pad):
    out = torch.zeros((n_pad,), dtype=torch.float32, device=b.device)
    out[:b.shape[0]] = b
    return out


class STFieldWeights:
    """The field's dense layers (objects with ``.w`` [in,out] and ``.b``)
    plus the kernel's packed copy of them, rebuilt whenever a parameter is
    modified in place (load_state_dict bumps ``_version``)."""

    def __init__(self, trunk, rgb, trans, skip):
        self.trunk, self.rgb, self.trans = list(trunk), list(rgb), list(trans)
        self.skip = tuple(sorted(int(s) for s in skip))
        self.feat_dim = self.trunk[-1].w.shape[1] - 1
        self._packed_key = None
        self._packed = None

    def _tensors(self):
        for layer in self.trunk + self.rgb + self.trans:
            yield layer.w
            yield layer.b

    def _check_kernel_shapes(self, xw, e3):
        def bad(msg):
            raise ValueError(f"st_field CUDA kernel: {msg}")
        if 0 in self.skip or len(self.trunk) > 31:
            bad(f"unsupported trunk (skip {self.skip}, "
                f"{len(self.trunk)} layers)")
        n = len(self.trunk)
        for li, layer in enumerate(self.trunk):
            n_in = xw if li == 0 else HIDDEN + (xw if li in self.skip else 0)
            want = (n_in, HIDDEN + (li == n - 1))
            if tuple(layer.w.shape) != want:
                bad(f"trunk layer {li} is {tuple(layer.w.shape)}, "
                    f"expected {want}")
        for name, head, n_out in (("rgb", self.rgb, 3),
                                  ("trans", self.trans, 5)):
            shapes = [tuple(layer.w.shape) for layer in head]
            if (len(head) < 2 or shapes[0][1] != HIDDEN
                    or shapes[-1] != (HIDDEN, n_out)
                    or any(s != (HIDDEN, HIDDEN) for s in shapes[1:-1])):
                bad(f"{name} head layers {shapes}")
        if self.rgb[0].w.shape[0] <= self.feat_dim + e3:
            bad("rgb layer 0 has no latent rows")

    def kernel_buffers(self, xw, e3):
        """(wpack bf16 flat, bias f32 flat, kx, ke) in the kernel's walk
        order: trunk layers (the last split into 256 feature columns and
        one density tile), then the RGB head, then the transient head."""
        kx, ke = _ceil16(xw), _ceil16(e3)
        key = (xw, e3) + tuple((id(t), t._version, t.device)
                               for t in self._tensors())
        if key == self._packed_key:
            return self._packed
        self._check_kernel_shapes(xw, e3)
        with torch.no_grad():
            packed = self._pack(xw, e3, kx, ke)
        self._packed_key, self._packed = key, packed
        return packed

    def _pack(self, xw, e3, kx, ke):
        F = self.feat_dim
        H = HIDDEN
        ws, bs = [], []
        n = len(self.trunk)
        for li, layer in enumerate(self.trunk):
            if li == 0:
                segs = [(0, xw, kx)]
            elif li in self.skip:
                segs = [(0, H, H), (H, H + xw, kx)]
            else:
                segs = [(0, H, H)]
            if li < n - 1:
                ws.append(_pack_layer(layer.w, segs, H, H))
                bs.append(layer.b)
            else:
                ws.append(_pack_layer(layer.w[:, 1:], segs, H, H))
                bs.append(layer.b[1:])
                ws.append(_pack_layer(layer.w[:, :1], segs, 1, _OUT_TILE))
                bs.append(_pad_bias(layer.b[:1], _OUT_TILE))
        for head, first_segs in ((self.rgb, [(0, F, H), (F, F + e3, ke)]),
                                 (self.trans, [(0, F, H)])):
            for li, layer in enumerate(head):
                segs = first_segs if li == 0 else [(0, H, H)]
                if li < len(head) - 1:
                    ws.append(_pack_layer(layer.w, segs, H, H))
                    bs.append(layer.b)
                else:
                    n_out = layer.w.shape[1]
                    ws.append(_pack_layer(layer.w, segs, n_out, _OUT_TILE))
                    bs.append(_pad_bias(layer.b, _OUT_TILE))
        return (torch.cat(ws).contiguous(),
                torch.cat([b.float() for b in bs]).contiguous(), kx, ke)


def _latent_rows(weights, light, trans, e3, compute_dtype):
    F = weights.feat_dim
    return latent_rows(light, trans, weights.rgb[0].w[F + e3:],
                       weights.trans[0].w[F:], compute_dtype)


def st_field_plain(xext, encpts, light, trans, weights, rows_per_img,
                   compute_dtype=torch.bfloat16):
    """The kernel's plain-PyTorch twin: same signature, same rounding
    points."""
    def c(x):
        return round_to(x, compute_dtype)

    lrow, trow = _latent_rows(weights, light, trans, encpts.shape[1],
                              compute_dtype)
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
    feat = h
    img = torch.arange(xext.shape[0], device=xext.device) // rows_per_img

    def head(layers, extra, lat):
        x0 = feat if extra is None else torch.cat([feat, c(extra)], dim=-1)
        w0 = layers[0].w[:x0.shape[1]]
        h = relu(c(x0) @ c(w0) + lat[img] + layers[0].b)
        for layer in layers[1:-1]:
            h = relu(c(h) @ c(layer.w) + layer.b)
        return c(h) @ c(layers[-1].w) + layers[-1].b

    return (head(weights.rgb, encpts, lrow), dens,
            head(weights.trans, None, trow))


_ARGTYPES = {"st_field_fwd": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
             + [ctypes.c_void_p]}


def st_field_fwd(xext, encpts, light, trans, weights, rows_per_img,
                 compute_dtype=torch.bfloat16):
    """(rgb_raw [M,3], dens_raw [M,1], trans_raw [M,5]) f32.

    CPU tensors take ``st_field_plain``; CUDA tensors launch the kernel
    (bf16 compute only) or raise."""
    if xext.device.type == "cpu":
        return st_field_plain(xext, encpts, light, trans, weights,
                              rows_per_img, compute_dtype)
    if xext.device.type != "cuda":
        raise ValueError(f"st_field_fwd: no kernel for {xext.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("st_field CUDA kernel computes in bfloat16 only, "
                         f"got compute_dtype={compute_dtype}")
    M, xw = xext.shape
    e3 = encpts.shape[1]
    dev = xext.device
    if (encpts.shape[0] != M or rows_per_img <= 0
            or -(-M // rows_per_img) > min(light.shape[0], trans.shape[0])):
        raise ValueError("st_field_fwd: row counts disagree")
    wpack, bias, kx, ke = weights.kernel_buffers(xw, e3)
    if any(t.device != dev for t in (encpts, light, trans, wpack)):
        raise ValueError("st_field_fwd: inputs, latents and weights must "
                         f"all lie on {dev}")
    lrow, trow = _latent_rows(weights, light, trans, e3, compute_dtype)
    xe = torch.zeros((M, kx + ke), dtype=torch.bfloat16, device=dev)
    xe[:, :xw] = xext
    xe[:, kx:kx + e3] = encpts
    lrow = lrow.float().contiguous()
    trow = trow.float().contiguous()
    rgb = torch.empty((M, 3), dtype=torch.float32, device=dev)
    dens = torch.empty((M, 1), dtype=torch.float32, device=dev)
    tr = torch.empty((M, 5), dtype=torch.float32, device=dev)
    lib = _build.load("st_field", _ARGTYPES)
    skip_mask = sum(1 << s for s in weights.skip)
    err = lib.st_field_fwd(
        xe.data_ptr(), wpack.data_ptr(), bias.data_ptr(), lrow.data_ptr(),
        trow.data_ptr(), rgb.data_ptr(), dens.data_ptr(), tr.data_ptr(),
        M, kx, ke, int(rows_per_img), lrow.shape[0], len(weights.trunk),
        len(weights.rgb), len(weights.trans), skip_mask,
        _build.stream_ptr(dev))
    _build.check(err, "st_field_fwd")
    st_field_fwd.launches += 1
    return rgb, dens, tr


st_field_fwd.launches = 0
