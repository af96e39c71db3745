"""The field backwards' weight gradients, phase (b) of rows 7b and 2: the
grouped dW GEMM (``dw_gemm``: per-split f32 partial tiles), the fixed-order
sum of its partials (``dw_reduce``), each with its plain-PyTorch twin, and
the descriptor table both read.  ``dw_grads`` chains the two, as the
backwards call them.

Each backward (kernels/coarse_field.py ``coarse_field_bwd``,
kernels/st_field.py ``st_field_bwd``) first runs its dX-chain kernel, which
walks the layers down per 64-row tile and stores every layer's bf16 output
gradient G (row 2 also its recomputed hidden activations H) to device
planes.  Then every layer's dW = Hᵀ·G is a product over all M rows, listed
as ``Segment``s: which A source (H: a stack of [M, width] bf16 planes), its
plane and first column, the dW rows (k_in, a multiple of 16), which G (the
wide [planes, M, 256] stack or the narrow [M, 16] plane of the output and
density gradients), its plane and first column, and the offset of the
[k_in, n] f32 block in the backward's flat gradient buffer (n = 256, or 8
for a narrow block).  The kernels are in ``csrc/dw_gemm.cu``; its header
says what bounds them on the card and how the design answers that.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

WIDE, NARROW = "wide", "narrow"
TILE_I = 128           # dW rows per block (csrc/dw_gemm.cu kTileI)
TILE_N = 256           # dW columns per block
STAGE_ROWS = 64        # rows per pipeline stage (kRows)
NARROW_COLS = 16       # the narrow G plane's width
H100_SMS = 132         # the CPU twin splits the rows as on this card


class Segment(NamedTuple):
    """One dW block: grads[out : out + k_in·n] = (H[:, a_col:a_col+k_in])ᵀ ·
    G[:, b_col:b_col+n] over all rows, H = A source ``a`` plane
    ``a_plane``, G = the wide stack's plane ``b_plane`` or the narrow
    plane.  The kernel takes n = 256 (wide) or 8 (narrow); the twins any
    width."""
    a: int
    a_plane: int
    a_col: int
    k_in: int
    b: str
    b_plane: int
    b_col: int
    n: int
    out: int


def _planes(t):
    """An A source as a [planes, M, width] stack."""
    return t if t.dim() == 3 else t[None]


def dw_plain(a_sources, g_wide, g_narrow, segments, grads):
    """Every segment's f32 product of the planes' values over all rows,
    written into ``grads`` (the function ``dw_grads`` computes, in one
    matmul per segment)."""
    for s in segments:
        h = _planes(a_sources[s.a])[s.a_plane][:, s.a_col:s.a_col + s.k_in]
        h = h.float()
        g = (g_wide[s.b_plane] if s.b == WIDE else g_narrow)
        g = g[:, s.b_col:s.b_col + s.n].float()
        grads[s.out:s.out + s.k_in * s.n] = (h.t() @ g).reshape(-1)
    return grads


def problems(segments):
    """The kernels' descriptor table: each segment cut into tiles of 128 dW
    rows, [tiles][12] int32 {a map, a plane, a column, dW rows, b map
    (3 wide, 4 narrow), b plane, b column, n, out offset, 0, 0, 0}."""
    rows = []
    for s in segments:
        for i0 in range(0, s.k_in, TILE_I):
            rows.append([s.a, s.a_plane, s.a_col + i0,
                         min(TILE_I, s.k_in - i0), 3 if s.b == WIDE else 4,
                         s.b_plane, s.b_col, s.n, s.out + i0 * s.n, 0, 0, 0])
    return rows


def split_rows(M, tiles, sms):
    """(rows per split, splits): at most two blocks per SM (a block takes a
    whole SM, so at most two waves and no third, near-empty one), each
    split a whole number of 64-row stages and at least eight of them (so
    the four-stage ring fills)."""
    chunks = -(-M // STAGE_ROWS)
    splits = max(1, min(2 * sms // max(tiles, 1), chunks // 8))
    per = -(-chunks // splits)
    return per * STAGE_ROWS, -(-chunks // per)


@functools.lru_cache(maxsize=64)
def _plan(segments, M, device):
    """(table, rows per split, splits, the table as an int32 tensor on
    ``device``) for a tuple of segments over M rows: made once per shape,
    so a step copies no table to the card."""
    table = problems(segments)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else H100_SMS)
    per, splits = split_rows(M, len(table), sms)
    return table, per, splits, _build.device_ints(
        tuple(v for row in table for v in row), device).view(-1, 12)


def dw_gemm_plain(a_sources, g_wide, g_narrow, table, per, splits):
    """The GEMM kernel's twin: for each tile of ``table`` and each split of
    ``per`` rows, the f32 product of the tile's H columns and G columns
    over the split's rows → partial [tiles, splits, 128, 256], zero past
    the tile's dW rows and columns."""
    partial = torch.zeros((len(table), splits, TILE_I, TILE_N),
                          dtype=torch.float32, device=g_wide.device)
    for t, (a, a_plane, a_col, k_in, b, b_plane, b_col, n, *_) in \
            enumerate(table):
        h = _planes(a_sources[a])[a_plane][:, a_col:a_col + k_in].float()
        g = (g_wide[b_plane] if b == 3 else g_narrow)[:, b_col:b_col + n]
        g = g.float()
        for sp in range(splits):
            r0, r1 = sp * per, (sp + 1) * per
            partial[t, sp, :k_in, :n] = h[r0:r1].t() @ g[r0:r1]
    return partial


_ARGTYPES = {
    "dw_gemm": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p],
    "dw_reduce": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
}


def _map(t, box):
    """A [planes, rows, columns] bf16 source → its map row for the kernel."""
    t = _planes(t)
    if t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise ValueError("dw_gemm: sources must be contiguous bf16, got "
                         f"{t.dtype}")
    if (t.shape[2] * 2) % 16 or t.data_ptr() % 16:
        raise ValueError(f"dw_gemm: rows of {t.shape[2]} bf16 are not "
                         "16-byte aligned")
    return [t.data_ptr(), t.shape[2], t.shape[1], t.shape[0], box]


def dw_gemm(a_sources, g_wide, g_narrow, segments):
    """Every segment's dW as per-split partials → (partial [tiles, splits,
    128, 256] f32, the descriptor table as an int32 tensor, cached per
    shape: read-only), the input of ``dw_reduce``.  a_sources: A sources ([planes, M, width] or [M,
    width]); g_wide [planes, M, width]; g_narrow [M, 16].  CPU tensors take
    ``dw_gemm_plain`` (any width and float type); CUDA tensors launch
    csrc/dw_gemm.cu ``dw_gemm_kernel`` or raise: one to three contiguous
    bf16 A sources, G 256 wide, blocks 256 (wide) or 8 (narrow) columns."""
    dev = g_wide.device
    M = g_wide.shape[1]
    srcs = list(a_sources)
    if any(t.device != dev or t.shape[-2] != M for t in srcs + [g_narrow]):
        raise ValueError(f"dw_gemm: every plane must hold {M} rows on {dev}")
    table, per, splits, prob = _plan(tuple(segments), M, dev)
    if dev.type == "cpu":
        return dw_gemm_plain(srcs, g_wide, g_narrow, table, per,
                             splits), prob
    if dev.type != "cuda":
        raise ValueError(f"dw_gemm: no kernel for {dev}")
    if not 1 <= len(srcs) <= 3 or tuple(g_narrow.shape) != (M, NARROW_COLS) \
            or g_wide.shape[2] != TILE_N:
        raise ValueError("dw_gemm: expects 1-3 A sources, G [planes, M, 256] "
                         f"and [M, {NARROW_COLS}], got {tuple(g_wide.shape)}, "
                         f"{tuple(g_narrow.shape)}")
    if any(s.k_in % 16 or s.n != (TILE_N if s.b == WIDE else 8)
           or s.b_col + s.n > (TILE_N if s.b == WIDE else NARROW_COLS)
           for s in segments):
        raise ValueError("dw_gemm: dW rows must be multiples of 16, blocks "
                         "256 (wide) or 8 (narrow) wide inside their plane")
    maps = [_map(t, 64) for t in srcs]
    maps += [maps[0]] * (3 - len(maps))
    maps += [_map(g_wide, 64), _map(g_narrow, 8)]
    flat = (ctypes.c_longlong * 25)(*[int(v) for m in maps for v in m])
    partial = torch.empty((len(table), splits, TILE_I, TILE_N),
                          dtype=torch.float32, device=dev)
    lib = _build.load("dw_gemm", _ARGTYPES)
    _build.check(lib.dw_gemm(flat, prob.data_ptr(), len(table),
                             partial.data_ptr(), M, per, splits,
                             _build.stream_ptr(dev)), "dw_gemm")
    dw_gemm.launches += 1
    return partial, prob


dw_gemm.launches = 0


def dw_reduce_plain(partial, prob, grads):
    """The reduction's twin: each tile's k_in × n block, summed over the
    splits in order, into ``grads``."""
    for t, row in enumerate(prob.tolist()):
        k_in, n, out = row[3], row[7], row[8]
        acc = partial[t, 0, :k_in, :n].clone()
        for sp in range(1, partial.shape[1]):
            acc += partial[t, sp, :k_in, :n]
        grads[out:out + k_in * n] = acc.reshape(-1)
    return grads


def dw_reduce(partial, prob, grads):
    """partial [tiles, splits, 128, 256] f32 (the GEMM's per-split tiles),
    prob the descriptor table on the same device → the sums, in split
    order, written into the flat f32 ``grads``.  CPU tensors take
    ``dw_reduce_plain``; CUDA tensors launch csrc/dw_gemm.cu
    ``dw_reduce_kernel`` or raise."""
    if partial.device.type == "cpu":
        return dw_reduce_plain(partial, prob, grads)
    if partial.device.type != "cuda" or prob.dtype != torch.int32 \
            or partial.shape[2:] != (TILE_I, TILE_N) \
            or grads.dtype != torch.float32 or not grads.is_contiguous():
        raise ValueError("dw_reduce: expects f32 [tiles, splits, 128, 256] "
                         "partials, an int32 table and a contiguous f32 "
                         "buffer on the card")
    lib = _build.load("dw_gemm", _ARGTYPES)
    _build.check(lib.dw_reduce(partial.data_ptr(), prob.data_ptr(),
                               partial.shape[0], partial.shape[1],
                               grads.data_ptr(),
                               _build.stream_ptr(partial.device)),
                 "dw_reduce")
    dw_reduce.launches += 1
    return grads


dw_reduce.launches = 0


def dw_grads(a_sources, g_wide, g_narrow, segments, grads):
    """Phase (b) of the split backwards: every segment's dW into the flat
    f32 ``grads`` (``dw_gemm``, then ``dw_reduce``)."""
    return dw_reduce(*dw_gemm(a_sources, g_wide, g_narrow, segments), grads)
