"""The field forwards' weight tiles and walk: what the wgmma + TMA forward
kernel (``csrc/field_fwd.cuh``; rows 1, 6f, 7a, 8 and 10) reads, its
launcher, and their plain-PyTorch readers.

The kernel knows no field.  It takes
  * the weights as plain bf16 tiles TMA can read: ``wide`` [Rw, 256] (every
    256-column layer's input rows, one K segment after another, each padded
    to a multiple of 16 rows) and ``narrow`` [Rn, 8] (each 8-column layer —
    the trunk's density column, the heads' 3- and 5-column outputs — as 256
    rows, its columns padded to 8), with the f32 biases in one flat
    ``bias`` (256 per wide layer, 8 per narrow one);
  * the walk: one row of ``LAYER_INTS`` ints per layer (the ``LayerField``
    enum of field_fwd.cuh, mirrored below) saying where its weights start,
    which shared buffer and 64-column blocks feed its k-steps, where its
    output goes, which latent row, residual plane and raw output it has.
``Tiles`` / ``Walk`` below build both on the weights' device in a few
torch ops (zeros, one copy per K segment and bias; ``write_tiles``
rewrites a field's heads in place); ``read_walk`` and
``walk_plain`` read them back in plain PyTorch, the second running the walk
exactly as the kernel does, so the CPU tests check the tiles and the table
against the JAX-layout weights and the fields' twins.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from ..nn.mlp import relu, round_to

HIDDEN = 256          # the kernel's layer width
NARROW = 8            # columns of a narrow layer's tile
NARROW_K = 256        # K rows of a narrow layer's tile
BLOCK = 64            # columns of a shared 64-column block
LAYER_INTS = 16
MAX_LAYERS = 32
ROWS = 128            # the kernel's row tile

# field_fwd.cuh LayerField
(WROW, NROW, S0BUF, S0BLK, S0STEPS, S1BUF, S1BLK, S1STEPS, OUT, BIAS, NBIAS,
 LAT, NOUT, RES, XFREE) = range(15)
BUF_A, BUF_X = 0, 1
LAT_NONE, LAT_L, LAT_T = 0, 1, 2
NOUT_NONE, NOUT_DENS, NOUT_RGB, NOUT_TRANS = 0, 1, 2, 3
NOUT_COLS = {NOUT_DENS: 1, NOUT_RGB: 3, NOUT_TRANS: 5}

# shared memory (field_fwd.cuh fwd_smem / kSmemCap): 1024 B of alignment,
# the ring, two warpgroups' 4-block A buffers and X regions, the barriers
_SMEM_CAP, _STAGE, _BLOCK_BYTES = 232448, 4 * 64 * 64 * 2, 64 * 64 * 2


def ring_stages(xregion):
    """Weight-ring stages that fit beside an X region of ``xregion``
    64-column blocks per warpgroup (the kernel takes at most 4)."""
    fixed = 1024 + 2 * (4 + xregion) * _BLOCK_BYTES + (2 * 4 + 2) * 8
    return min(4, (_SMEM_CAP - fixed) // _STAGE)


@dataclass
class Layer:
    """One layer of a walk.  ``rows``: its 256-column weight's K segments in
    A order, [(w rows [k, 256] in the JAX [in, out] layout, k_pad)], empty
    for a narrow-only layer; ``b`` their bias.  ``narrow``: (w [256, n],
    b [n]) of its 8-column part or None.  ``segs``: its A operand's segments
    [(buffer, first block, k-steps)].  The rest as the table's fields."""
    rows: list
    b: torch.Tensor | None
    narrow: tuple | None
    segs: list
    out: int = -1
    lat: int = LAT_NONE
    nout: int = NOUT_NONE
    xfree: bool = False


@dataclass
class Tiles:
    """The weight tiles of consecutive layers: wide [Rw, 256] and narrow
    [Rn, 8] bf16, bias f32, and per layer its (wrow, nrow, bias, nbias)
    offsets (-1: none)."""
    wide: torch.Tensor
    narrow: torch.Tensor
    bias: torch.Tensor
    offs: list = field(default_factory=list)


def build_tiles(layers, device):
    """``Tiles`` of ``layers`` on ``device``: zeros, then ``write_tiles``.
    The tiles are normal tensors even when built under inference mode (a
    validation pass), so ``write_tiles`` may rewrite them in training."""
    rw = sum(k_pad for layer in layers for _, k_pad in layer.rows)
    offs = []
    r = n = bo = 0
    for layer in layers:
        wrow = bias = nrow = nbias = -1
        if layer.rows:
            wrow, bias = r, bo
            r, bo = r + sum(k_pad for _, k_pad in layer.rows), bo + HIDDEN
        if layer.narrow is not None:
            nrow, nbias = n, bo
            n, bo = n + NARROW_K, bo + NARROW
        offs.append((wrow, nrow, bias, nbias))
    with torch.inference_mode(False):
        tiles = Tiles(
            torch.zeros((rw, HIDDEN), dtype=torch.bfloat16, device=device),
            torch.zeros((n, NARROW), dtype=torch.bfloat16, device=device),
            torch.zeros((bo,), dtype=torch.float32, device=device), offs)
    write_tiles(tiles, layers)
    return tiles


def write_tiles(tiles, layers, first=0):
    """Copy ``layers`` (the walk's layers from ``first`` to its end) into
    their places in ``tiles``, in place: one copy per K segment and narrow
    part (bf16 rounding in the copy; the padding stays zero), one cat of
    their biases into the bias tile's tail they own."""
    biases, b0 = [], None
    for layer, (wrow, nrow, bias, nbias) in zip(layers, tiles.offs[first:]):
        if wrow >= 0:
            r = wrow
            for w, k_pad in layer.rows:
                tiles.wide[r:r + w.shape[0]].copy_(w)
                r += k_pad
            biases.append(layer.b.float())
        if nrow >= 0:
            w, b = layer.narrow
            tiles.narrow[nrow:nrow + w.shape[0], :w.shape[1]].copy_(w)
            biases.append(torch.nn.functional.pad(
                b.float(), (0, NARROW - b.shape[0])))
        if b0 is None:
            b0 = bias if wrow >= 0 else nbias
    torch.cat(biases, out=tiles.bias[b0:])


def blocks(k):
    return -(-k // BLOCK)


def steps(k):
    """The k-steps of a K segment k columns wide: whole 64-column blocks,
    one slice each (the columns past k are zero in the A operand)."""
    return 4 * blocks(k)


def trunk_layers(trunk, skip, xw, kx, bad):
    """The trunk's walk: layer 0 reads xext from X, a skip layer A then
    xext, the others A; each overwrites A; the last one's column 0 (the
    raw density) is its narrow part, so it may not be a skip layer."""
    H, n = HIDDEN, len(trunk)
    if n < 2 or n - 1 in skip:
        bad(f"the wgmma forward needs >= 2 trunk layers, the last not a "
            f"skip layer (skip {tuple(skip)}, {n} layers)")
    out = []
    for li, layer in enumerate(trunk):
        w, b = layer.w, layer.b
        if li == 0:
            rows, segs = [(w[:xw], kx)], [(BUF_X, 0, steps(kx))]
        elif li in skip:
            rows = [(w[:H], H), (w[H:H + xw], kx)]
            segs = [(BUF_A, 0, H // 16), (BUF_X, 0, steps(kx))]
        else:
            rows, segs = [(w, H)], [(BUF_A, 0, H // 16)]
        narrow = None
        if li == n - 1:
            rows = [(r[:, 1:], k) for r, k in rows]
            narrow, b = (w[:, :1], b[:1]), b[1:]
        out.append(Layer(rows, b, narrow, segs, out=BUF_A,
                         nout=NOUT_DENS if narrow else NOUT_NONE))
    return out


def trunk_walk_layers(trunk, skip, xw, kx, bad):
    """The trunk kernel's walk (row 10): ``trunk_layers`` alone, the X
    region (xext only) freed after the last layer that reads it, so the next
    tile's xext loads under the layers after it."""
    layers = trunk_layers(trunk, skip, xw, kx, bad)
    last = max(i for i, layer in enumerate(layers)
               if any(buf == BUF_X for buf, _, _ in layer.segs))
    layers[last].xfree = True
    return layers


def head_layers(head, first_rows, first_segs, buf, lat, nout, xfree_at):
    """A head's walk: layer 0 with ``first_rows`` / ``first_segs`` (the
    features in A and, for an RGB head, enc⊕pts in X), its hidden layers
    256 → 256 in buffer ``buf``, the output layer as a narrow layer reading
    ``buf``.  ``xfree_at``: the index of the layer after whose products X is
    free (None: not in this head)."""
    out, n = [], len(head)
    for li, layer in enumerate(head):
        if li == n - 1:
            entry = Layer([], None, (layer.w, layer.b),
                          [(buf, 0, HIDDEN // 16)], nout=nout)
        else:
            rows, segs = ((first_rows, first_segs) if li == 0 else
                          ([(layer.w, HIDDEN)], [(buf, 0, HIDDEN // 16)]))
            entry = Layer(rows, layer.b, None, segs, out=buf,
                          lat=lat if li == 0 else LAT_NONE)
        entry.xfree = li == xfree_at
        out.append(entry)
    return out


@dataclass
class Walk:
    """A field's forward for the kernel: its tiles, its layers (the rows of
    the table, less the residual planes), the row input's shape (kx: the
    staged xext width, zero padded to whole 64-column blocks, so enc⊕pts
    starts a block; ke: the 16-padded enc⊕pts width, 0 for the trunk
    kernel's walk; bx, xblocks: their 64-column blocks) and the X region's
    size in blocks."""
    tiles: Tiles
    layers: list
    kx: int
    ke: int
    xregion: int

    @property
    def bx(self):
        return blocks(self.kx)

    @property
    def xblocks(self):
        return blocks(self.kx) + blocks(self.ke)

    def table(self, res):
        """The kernel's table, flat: ``res`` maps a layer's index to its
        residual plane (the rest store none)."""
        flat = []
        for i, (layer, (wrow, nrow, bias, nbias)) in enumerate(
                zip(self.layers, self.tiles.offs)):
            s0 = layer.segs[0]
            s1 = layer.segs[1] if len(layer.segs) > 1 else (0, 0, 0)
            flat += [wrow, nrow, *s0, *s1, layer.out, bias, nbias, layer.lat,
                     layer.nout, res.get(i, -1), int(layer.xfree), 0]
        return flat


def st_head_layers(rgb, trans, kx, ke, F, e3):
    """The ST field's heads: the RGB head (layer 0: feat from A, enc⊕pts
    from X; its hidden layers in X, over the row input, which is free after
    its output layer), then the transient head (over feat in A)."""
    H = HIDDEN
    return (head_layers(rgb, [(rgb[0].w[:F], H), (rgb[0].w[F:F + e3], ke)],
                        [(BUF_A, 0, H // 16), (BUF_X, blocks(kx), steps(ke))],
                        BUF_X, LAT_L, NOUT_RGB, len(rgb) - 1)
            + head_layers(trans, [(trans[0].w[:F], H)], [(BUF_A, 0, H // 16)],
                          BUF_A, LAT_T, NOUT_TRANS, None))


def coarse_head_layers(rgb, kx, ke, e3):
    """The coarse field's RGB head: layer 0 reads feat from A and enc⊕pts
    from X (free after its products) and overwrites A; the rest in A."""
    H = HIDDEN
    return head_layers(rgb, [(rgb[0].w[:H], H), (rgb[0].w[H:H + e3], ke)],
                       [(BUF_A, 0, H // 16), (BUF_X, blocks(kx), steps(ke))],
                       BUF_A, LAT_NONE, NOUT_RGB, 0)


def make_walk(layers, tiles, kx, ke, xregion, bad):
    """The ``Walk`` of ``layers`` (the trunk's, then the heads') over
    ``tiles``.  ``xregion``: the X region's blocks (the ST walk keeps its
    RGB head's activations there: 4)."""
    need = blocks(kx) + blocks(ke)
    if need > xregion or ring_stages(xregion) < 2:
        bad(f"xext and enc⊕pts need {need} 64-column blocks: more than the "
            f"X region's {xregion} or no room left for the weight ring")
    if len(layers) > MAX_LAYERS:
        bad(f"more than {MAX_LAYERS} layers")
    return Walk(tiles, list(layers), BLOCK * blocks(kx), ke, xregion)


# the launchers' flat arguments (field_fwd.cuh FwdPtr, FwdInt)
_PTRS = ("wide", "narrow", "bias", "xe", "lrow", "trow", "rgb", "dens",
         "trans", "res", "dist", "depth", "out")
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]


def launch(fn, walk, xe, res_planes, *, n_res=0, rows_per_img=1, n_img=1,
           N=0, min_uncert=0.0, stream=None, **tensors):
    """Launch entry ``fn`` (a ctypes function of a field's library) of the
    forward kernel over the staged rows ``xe`` [M, kx+ke] bf16.
    ``res_planes``: {layer index: residual plane} of ``tensors["res"]``
    ([n_res, M, 256] bf16); ``tensors``: the other FwdPtr tensors (lrow,
    trow, rgb, dens, trans, res, dist, depth, out), absent ones null.
    Returns the cudaError_t."""
    ptrs = dict(wide=walk.tiles.wide, narrow=walk.tiles.narrow,
                bias=walk.tiles.bias, xe=xe, **tensors)
    table = walk.table(res_planes)
    ints = [xe.shape[0], walk.kx, walk.ke, walk.tiles.wide.shape[0],
            walk.tiles.narrow.shape[0], len(walk.layers), int(rows_per_img),
            int(n_img), int(n_res), int(N), walk.bx, walk.xblocks,
            walk.xregion]
    return fn((ctypes.c_longlong * len(_PTRS))(*[
                  ptrs[k].data_ptr() if ptrs.get(k) is not None else 0
                  for k in _PTRS]),
              (ctypes.c_int * len(ints))(*ints),
              (ctypes.c_int * len(table))(*table),
              ctypes.c_float(min_uncert), stream)


def l2_weight_bytes(walk, M):
    """The L2 bytes the forward reads for its weights at M rows: every
    128-row tile streams each layer's wide slices (64 rows × 256 × 2 B, one
    per 4 k-steps) and narrow slices (256 × 8 × 2 B) once."""
    per_tile = 0
    for layer in walk.layers:
        k_steps = sum(s for *_, s in layer.segs)
        if layer.rows:
            per_tile += k_steps // 4 * 64 * HIDDEN * 2
        if layer.narrow is not None:
            per_tile += NARROW_K * NARROW * 2
    return -(-M // ROWS) * per_tile


# ------------------------------------------------------------ plain readers

def read_walk(walk):
    """The weights back from the tiles, per layer in walk order:
    (wide segments [k_pad, 256] f32 in A order, wide bias [256], narrow
    weight [256, 8], narrow bias [8]); None where the layer has none.  The
    values are the bf16 tiles' (the JAX weights rounded to bf16)."""
    t, out = walk.tiles, []
    for layer, (wrow, nrow, bias, nbias) in zip(walk.layers, t.offs):
        segs = wb = nw = nb = None
        if wrow >= 0:
            segs, r = [], wrow
            for _, k_pad in layer.rows:
                segs.append(t.wide[r:r + k_pad].float())
                r += k_pad
            wb = t.bias[bias:bias + HIDDEN]
        if nrow >= 0:
            nw = t.narrow[nrow:nrow + NARROW_K].float()
            nb = t.bias[nbias:nbias + NARROW]
        out.append((segs, wb, nw, nb))
    return out


def walk_plain(walk, xe, lrow=None, trow=None, rows_per_img=1,
               res_planes=None, forced=None):
    """The kernel's arithmetic over the walk's table and tiles, in plain
    PyTorch on xe's device: per layer, the A operand is the table's blocks
    of the warpgroup's buffers (A: 256 columns; X: the row input's
    64-column blocks, later the ST RGB head's activations), times the wide
    tile's rows (bf16 values, f32 products) + bias (+ latent row) → ReLU →
    bf16 into the output buffer; narrow layers give the raw outputs.  Once
    X is freed it is poisoned (NaN), so a walk that reads it after that
    shows.  ``forced`` ({plane: the kernel's residual plane}) runs the walk
    layer by layer on the kernel's own activations: after a layer of a
    forced plane is computed (and kept as that residual plane), its output
    buffer takes the kernel's plane.
    → (dict of raw outputs by NOUT code, residual planes by plane)."""
    M = xe.shape[0]
    dev = xe.device
    t = walk.tiles
    table = walk.table(res_planes or {})
    xe = xe.float()
    width = xe.shape[1]
    xcols = []
    for b in range(walk.xblocks):
        c0 = BLOCK * b if b < walk.bx else walk.kx + BLOCK * (b - walk.bx)
        blk = torch.zeros((M, BLOCK), dtype=torch.float32, device=dev)
        hi = min(c0 + BLOCK, width)
        blk[:, :hi - c0] = xe[:, c0:hi]
        xcols.append(blk)
    X = torch.zeros((M, BLOCK * walk.xregion), dtype=torch.float32,
                    device=dev)
    X[:, :BLOCK * walk.xblocks] = torch.cat(xcols, 1)
    bufs = [torch.zeros((M, HIDDEN), dtype=torch.float32, device=dev), X]
    lats = [None, lrow, trow]
    img = None
    raw, res = {}, {}
    for i in range(len(walk.layers)):
        L = table[i * LAYER_INTS:(i + 1) * LAYER_INTS]
        segs = [(L[S0BUF], L[S0BLK], L[S0STEPS])]
        if L[S1STEPS]:
            segs.append((L[S1BUF], L[S1BLK], L[S1STEPS]))
        a = torch.cat([bufs[b][:, BLOCK * blk:BLOCK * blk + 16 * s]
                       for b, blk, s in segs], 1)
        if L[WROW] >= 0:
            k = a.shape[1]
            # rows past the pack: zero
            w = torch.zeros((k, HIDDEN), device=dev)
            rows = t.wide[L[WROW]:L[WROW] + k].float()
            w[:rows.shape[0]] = rows
            z = a @ w + t.bias[L[BIAS]:L[BIAS] + HIDDEN]
            if L[LAT]:
                lat = lats[L[LAT]]
                if img is None:
                    img = torch.clamp(torch.arange(M, device=dev)
                                      // rows_per_img, max=lat.shape[0] - 1)
                z = z + lat[img]
            bufs[L[OUT]][:, :HIDDEN] = round_to(relu(z), torch.bfloat16)
            if L[RES] >= 0:
                res[L[RES]] = bufs[L[OUT]][:, :HIDDEN].clone()
                if forced is not None and L[RES] in forced:
                    bufs[L[OUT]][:, :HIDDEN] = forced[L[RES]].float()
        if L[NROW] >= 0:
            a0 = a[:, :16 * L[S0STEPS]]
            z = a0 @ t.narrow[L[NROW]:L[NROW] + NARROW_K].float() \
                + t.bias[L[NBIAS]:L[NBIAS] + NARROW]
            raw[L[NOUT]] = z[:, :NOUT_COLS[L[NOUT]]]
        if L[XFREE]:
            bufs[BUF_X] = torch.full_like(X, float("nan"))
    return raw, res
