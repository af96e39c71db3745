"""The wgmma + TMA field forward's weight tiles and walk
(texpose_tpu_torch/kernels/field_fwd.py) on the CPU: what rows 1, 6f, 7a
and 8 read on the card.

* The plain reader of the tiles (``read_walk``) gives back every layer's
  JAX-layout weight, rounded to bf16, exactly, and its bias exactly: the
  trunk with its skip layer and its density column, both ST heads (their
  latent rows are the host's per-image rows, not in the tiles) and the
  coarse RGB head.  The plain twins fed the read-back weights give the
  twins' outputs bit for bit.
* ``walk_plain`` runs the kernel's table and tiles as the kernel does
  (buffers, blocks, k-steps, bias, latent row, residual planes; the X
  region poisoned once freed): it matches the twins and the JAX package's
  fields (Pallas in interpret mode) at bf16 compute.  Both round every
  product operand to bf16 and sum in f32 in other orders, which can flip one
  rounding (2^-8 relative): 2e-2 absolute, 1e-3 in the mean, as
  tests/test_torch_pretrain_kernels.py holds its bf16 twin.

Every field here is 256 wide (the kernel's only width).  "small" is a
3-layer trunk with a skip at 1, L_3D 2 (xext 15 → 16 columns), 2-layer
heads and narrow enc⊕pts rows; "full" the shipped configs' 8-layer trunk,
skip at 4, L_3D 10, 4-layer heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texpose_tpu.nn import fields as jfields
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from texpose_tpu.utils.config import Config, process_options
from texpose_tpu_torch.kernels import field_fwd as ff
from texpose_tpu_torch.kernels.coarse_field import (CoarseFieldWeights,
                                                    coarse_field_plain)
from texpose_tpu_torch.kernels.st_field import (STFieldWeights, _latent_rows,
                                                make_xext, st_field_plain,
                                                stage_rows)
from texpose_tpu_torch.nn import fields as tfields
from texpose_tpu_torch.nn.init import dense_init
from texpose_tpu_torch.nn.mlp import Dense, round_to
from texpose_tpu_torch.utils.checkpoint import jax_state_to_torch

H = 256
BF16 = torch.bfloat16
# (trunk layers, skip, L_3D, head layers, ST enc⊕pts width, latents)
SIZES = {"small": (3, (1,), 2, 2, 12, (4, 2)),
         "full": (8, (4,), 10, 4, 30, (48, 16))}
B, RPI = 3, 70                       # 210 rows: two ragged 128-row tiles


def _layer(g, i, o, mode=None):
    return Dense(*dense_init(g, i, o, mode))


def _trunk(g, n, skip, xw):
    return ([_layer(g, xw, H)]
            + [_layer(g, H + (xw if li in skip else 0), H)
               for li in range(1, n - 1)] + [_layer(g, H, H + 1, "first")])


def _weights(field, size, seed=0):
    """(weights, xw, e3, latent widths) of a seeded field."""
    n, skip, L, nh, e3, (dl, dt) = SIZES[size]
    g = torch.Generator().manual_seed(seed)
    xw = 3 + 6 * L
    trunk = _trunk(g, n, skip, xw)
    if field == "st":
        rgb = ([_layer(g, H + e3 + dl, H)]
               + [_layer(g, H, H) for _ in range(nh - 2)]
               + [_layer(g, H, 3, "all")])
        trans = ([_layer(g, H + dt, H)]
                 + [_layer(g, H, H) for _ in range(nh - 2)]
                 + [_layer(g, H, 5, "all")])
        return STFieldWeights(trunk, rgb, trans, skip), xw, e3, (dl, dt)
    e3 = 3
    rgb = ([_layer(g, H + e3, H)] + [_layer(g, H, H) for _ in range(nh - 2)]
           + [_layer(g, H, 3, "all")])
    return CoarseFieldWeights(trunk, rgb, skip), xw, e3, None


def _inputs(xw, L, e3, lat, seed=1):
    g = torch.Generator().manual_seed(seed)
    M = B * RPI
    pts = torch.randn(M, 3, generator=g) * 0.5
    xext = make_xext(pts, L, torch.linspace(1.0, 0.3, L))
    ep = torch.cat([torch.randn(M, e3 - 3, generator=g), pts], 1)
    lats = (None if lat is None else
            (torch.randn(B, lat[0], generator=g),
             torch.randn(B, lat[1], generator=g)))
    return xext, ep, lats


def _heads(w):
    return [("rgb", w.rgb)] + ([("trans", w.trans)]
                               if isinstance(w, STFieldWeights) else [])


def _read_back(w, walk, xw, e3):
    """Every layer's (w, b) in the JAX layout from ``read_walk``: the trunk,
    then each head; a head's layer 0 without its latent rows."""
    read = ff.read_walk(walk)
    nf, F = len(w.trunk), w.feat_dim
    out = []
    for li in range(nf):
        segs, wb, nw, nb = read[li]
        true = ([xw] if li == 0 else [F, xw] if li in w.skip else [F])
        rows = torch.cat([s[:k] for s, k in zip(segs, true)])
        for s, k in zip(segs, true):            # the padding rows are zero
            assert not s[k:].any()
        if li == nf - 1:
            assert not nw[:, 1:].any() and not nb[1:].any()
            rows, wb = torch.cat([nw[:, :1], rows], 1), torch.cat([nb[:1], wb])
        out.append((rows, wb))
    at = nf
    for name, head in _heads(w):
        for li in range(len(head)):
            segs, wb, nw, nb = read[at]
            at += 1
            if li == len(head) - 1:
                n = head[li].w.shape[1]
                assert not nw[:, n:].any() and not nb[n:].any()
                out.append((nw[:, :n], nb[:n]))
            elif li == 0:
                true = [F, e3] if name == "rgb" else [F]
                out.append((torch.cat([s[:k] for s, k in zip(segs, true)]),
                            wb))
            else:
                out.append((segs[0], wb))
    return out


def _layers(w):
    return w.trunk + [layer for _, head in _heads(w) for layer in head]


def _rebuilt(w, back):
    """A weights object of the same kind holding the read-back layers (a
    head's layer 0 gets its latent rows back from ``w``)."""
    layers, at = [], 0
    for layer, (wt, b) in zip(_layers(w), back):
        if wt.shape[0] < layer.w.shape[0]:      # layer 0 of a head
            wt = torch.cat([wt, layer.w[wt.shape[0]:]])
        layers.append(Dense(wt, b))
    nf = len(w.trunk)
    trunk, rest = layers[:nf], layers[nf:]
    if isinstance(w, STFieldWeights):
        nr = len(w.rgb)
        return STFieldWeights(trunk, rest[:nr], rest[nr:], w.skip)
    return CoarseFieldWeights(trunk, rest, w.skip)


CASES = [(f, s) for f in ("st", "coarse") for s in ("small", "full")]


@pytest.mark.parametrize("field,size", CASES)
def test_read_walk_gives_back_jax_weights(field, size):
    w, xw, e3, _ = _weights(field, size)
    walk = w.fwd_walk(xw, e3)
    back = _read_back(w, walk, xw, e3)
    layers = _layers(w)
    assert len(back) == len(layers) == len(walk.layers)
    for layer, (wt, b) in zip(layers, back):
        ref = round_to(layer.w.detach(), BF16)[:wt.shape[0]]
        assert torch.equal(wt, ref)
        assert torch.equal(b, layer.b.detach())
    lat = [layer.lat for layer in walk.layers]
    nf = len(w.trunk)
    assert lat[nf] == (ff.LAT_L if field == "st" else ff.LAT_NONE)
    if field == "st":
        assert lat[nf + len(w.rgb)] == ff.LAT_T
    assert sum(1 for x in lat if x) == (2 if field == "st" else 0)


@pytest.mark.parametrize("field,size", CASES)
def test_twins_through_the_reader_bit_for_bit(field, size):
    w, xw, e3, lat = _weights(field, size)
    xext, ep, lats = _inputs(xw, SIZES[size][2], e3 if field == "st" else 3,
                             lat)
    w2 = _rebuilt(w, _read_back(w, w.fwd_walk(xw, e3), xw, e3))
    with torch.no_grad():
        if field == "st":
            a = st_field_plain(xext, ep, *lats, w, RPI, want_feat=True)
            b = st_field_plain(xext, ep, *lats, w2, RPI, want_feat=True)
        else:
            a = coarse_field_plain(xext, ep, w, want_res=True)
            b = coarse_field_plain(xext, ep, w2, want_res=True)
            a, b = a[:2] + tuple(a[2]), b[:2] + tuple(b[2])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _walk_run(w, walk, xext, ep, lats, e3):
    xe = stage_rows(xext, ep, walk.kx, walk.ke)
    if isinstance(w, STFieldWeights):
        lrow, trow = _latent_rows(w, lats[0], lats[1], e3, BF16)
        raw, res = ff.walk_plain(walk, xe, lrow.float(), trow.float(), RPI,
                                 {len(w.trunk) - 1: 0})
        return (raw[ff.NOUT_RGB], raw[ff.NOUT_DENS], raw[ff.NOUT_TRANS],
                res[0])
    raw, res = ff.walk_plain(walk, xe, res_planes=w.res_planes())
    return (raw[ff.NOUT_RGB], raw[ff.NOUT_DENS]) + tuple(
        res[j] for j in range(len(res)))


def _close(a, b, atol=2e-2, mean=1e-3):
    err = (a - b).abs()
    assert float(err.max()) <= atol and float(err.mean()) <= mean, \
        float(err.max())


@pytest.mark.parametrize("field,size", CASES)
def test_walk_plain_matches_the_twins(field, size):
    """The table and tiles run as the kernel runs them: raw outputs and
    residual planes (the ST feature residual, the coarse field's 11 or 3
    planes) against the twins'."""
    w, xw, e3, lat = _weights(field, size)
    xext, ep, lats = _inputs(xw, SIZES[size][2], e3 if field == "st" else 3,
                             lat)
    with torch.no_grad():
        got = _walk_run(w, w.fwd_walk(xw, e3), xext, ep, lats, e3)
        if field == "st":
            ref = st_field_plain(xext, ep, *lats, w, RPI, want_feat=True)
        else:
            r = coarse_field_plain(xext, ep, w, want_res=True)
            ref = r[:2] + tuple(r[2])
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        _close(a, b)


def _st_cfg():
    return process_options(Config({
        "arch": {"layers_feat": [None, H, H, H], "layers_rgb": [None, H, 3],
                 "layers_trans": [None, H, 5], "skip": [1],
                 "posenc": {"L_3D": 4, "L_view": 2},
                 "density_activ": "softplus", "tf_init": True},
        "nerf": {"view_dep": True, "density_noise_reg": None,
                 "N_latent_trans": 8, "N_latent_light": 12,
                 "min_uncert": 0.05, "depth": {"scale": 10, "range": [0, 3]}},
        "c2f": {"range": [0.1, 0.6], "start": 1},
        "data": {"image_size": [8, 8]},
        "kernels": {"fused_trunk": False},
    }))


def _coarse_cfg(view_dep):
    return process_options(Config({
        "arch": {"layers_feat": [None] + [H] * 4, "layers_rgb": [None, H, 3],
                 "skip": [2], "posenc": {"L_3D": 4,
                                         "L_view": 2 if view_dep else None},
                 "density_activ": "softplus", "tf_init": True},
        "nerf": {"view_dep": view_dep, "density_noise_reg": None,
                 "sample_intvs": 16, "sample_stratified": False,
                 "setbg_opaque": False,
                 "depth": {"param": "metric", "scale": 1, "range": [0, 3]}},
        "c2f": [0.0, 1.0], "camera": {"ndc": False},
        "data": {"image_size": [16, 16]},
        "kernels": {"fused_trunk": False},
    }))


def _bridge(jparams, init):
    state = jax_state_to_torch(tree_to_flat_dict({"params": {
        "nerf": jparams}}))
    nerf = init()
    nerf.load_state_dict({k[len("nerf."):]: v for k, v in state.items()},
                         strict=True)
    return nerf


def test_walk_plain_matches_jax_st_field(monkeypatch):
    """The ST walk against the JAX package's fused_st_field (interpret) at
    bf16 compute, on the same parameters and numpy inputs: 2 images × 4
    rays × 16 samples, a c2f window at 0.4."""
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg = _st_cfg()
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(0), cfg)
    nerf = _bridge(jparams, lambda: tfields.init_nerf_st(cfg))
    rng = np.random.default_rng(5)
    b, r, n = 2, 4, 16
    pts = rng.normal(size=(b, r, n, 3)).astype(np.float32)
    ray = rng.normal(size=(b, r, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    lt = rng.normal(size=(b, 8)).astype(np.float32)
    ll = rng.normal(size=(b, 12)).astype(np.float32)
    ref = jfields.apply_nerf_st_raw(
        jparams, cfg, jnp.asarray(pts), jnp.asarray(ray), jnp.asarray(lt),
        jnp.asarray(ll), progress=jnp.asarray(0.4),
        compute_dtype=jnp.bfloat16, tile_fwd=32, tile_bwd=32, interpret=True)
    w = nerf.kernel_weights()
    with torch.no_grad():
        xext, ep = tfields.st_field_inputs(cfg, torch.from_numpy(pts),
                                           torch.from_numpy(ray), 0.4)
        walk = w.fwd_walk(xext.shape[1], ep.shape[1])
        lrow, trow = _latent_rows(w, torch.from_numpy(ll),
                                  torch.from_numpy(lt), ep.shape[1], BF16)
        raw, _ = ff.walk_plain(walk, stage_rows(xext, ep, walk.kx, walk.ke),
                               lrow.float(), trow.float(), r * n)
    for code, j in zip((ff.NOUT_RGB, ff.NOUT_DENS, ff.NOUT_TRANS), ref):
        _close(raw[code], torch.from_numpy(np.asarray(j, np.float32)))


@pytest.mark.parametrize("view_dep", [False, True],
                         ids=["view_indep", "view_dep"])
def test_walk_plain_matches_jax_coarse_field(monkeypatch, view_dep):
    """The coarse walk against the JAX package's fused_coarse_field
    (interpret) at bf16 compute: 2 images' 8 rays × 16 samples."""
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg = _coarse_cfg(view_dep)
    jparams = jfields.init_nerf(jax.random.PRNGKey(1), cfg)
    nerf = _bridge(jparams, lambda: tfields.init_nerf(cfg))
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(2, 8, 16, 3)).astype(np.float32) * 0.5
    ray = rng.normal(size=(2, 8, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    j_rgb, j_dens = jfields.apply_nerf_raw(
        jparams, cfg, jnp.asarray(pts),
        jnp.asarray(ray) if view_dep else None, jnp.asarray(0.5),
        compute_dtype=jnp.bfloat16, interpret=True)
    w = nerf.kernel_weights()
    with torch.no_grad():
        xext, ep = tfields.coarse_field_inputs(
            cfg, torch.from_numpy(pts),
            torch.from_numpy(ray) if view_dep else None, 0.5)
        walk = w.fwd_walk(xext.shape[1], ep.shape[1])
        raw, _ = ff.walk_plain(walk, stage_rows(xext, ep, walk.kx, walk.ke))
    _close(raw[ff.NOUT_RGB], torch.from_numpy(np.asarray(j_rgb, np.float32)))
    _close(raw[ff.NOUT_DENS],
           torch.from_numpy(np.asarray(j_dens, np.float32)))


@pytest.mark.parametrize("field", ["st", "coarse"])
def test_walk_table_frees_x_once_and_fits(field):
    """The table the kernel checks (field_fwd.cuh bad_walk): one layer frees
    X and none after it reads or writes X; every narrow layer reads 16
    k-steps of one 256-column buffer; the ring keeps >= 2 stages."""
    w, xw, e3, _ = _weights(field, "full")
    walk = w.fwd_walk(xw, e3)
    t = walk.table({})
    rows = [t[i:i + ff.LAYER_INTS] for i in range(0, len(t), ff.LAYER_INTS)]
    freed = [i for i, L in enumerate(rows) if L[ff.XFREE]]
    assert len(freed) == 1
    for L in rows[freed[0] + 1:]:
        assert ff.BUF_X not in (L[ff.S0BUF], L[ff.OUT]) and (
            L[ff.S1STEPS] == 0 or L[ff.S1BUF] != ff.BUF_X)
    for L in rows:
        if L[ff.NROW] >= 0:
            assert L[ff.S0STEPS] == 16 and L[ff.S1STEPS] == 0
    assert ff.ring_stages(walk.xregion) == (3 if field == "st" else 4)
    assert walk.xblocks == 2


def test_l2_weight_bytes_per_128_rows():
    """The design's L2 weight bytes: each 128-row tile streams every wide
    layer's ceil(k-steps / 4) 32 KB slices and one 4 KB slice per narrow
    layer — at 131,072 rows 1.858 GB (ST) and 1.451 GB (coarse)."""
    st, xw, e3, _ = _weights("st", "full")
    co, _, ce3, _ = _weights("coarse", "full")
    assert ff.l2_weight_bytes(st.fwd_walk(xw, e3), 131072) == 1024 * (
        (1 + 6 * 4 + 5) * 32768 + 4096            # trunk + density
        + (5 + 4 + 4) * 32768 + 4096              # RGB head
        + (4 + 4 + 4) * 32768 + 4096)             # transient head
    assert ff.l2_weight_bytes(co.fwd_walk(xw, ce3), 131072) == 1024 * (
        (1 + 6 * 4 + 5) * 32768 + 4096 + (5 + 4 + 4) * 32768 + 4096)
    assert ff.l2_weight_bytes(co.fwd_walk(xw, ce3), 129) == 2 * (
        ff.l2_weight_bytes(co.fwd_walk(xw, ce3), 128))


def test_walks_refuse_what_the_kernel_cannot_take():
    """A last trunk layer that is a skip layer (its density column would
    need the xext block) and enc⊕pts rows too wide for the ST walk's X
    region raise on the host."""
    g = torch.Generator().manual_seed(3)
    xw = 15

    def st(trunk, skip, e3):
        return STFieldWeights(
            trunk, [_layer(g, H + e3 + 4, H), _layer(g, H, 3, "all")],
            [_layer(g, H + 2, H), _layer(g, H, 5, "all")], skip)

    last_skip = [_layer(g, xw, H), _layer(g, H, H),
                 _layer(g, H + xw, H + 1, "first")]
    with pytest.raises(ValueError, match="skip"):
        st(last_skip, (2,), 12).fwd_walk(xw, 12)
    with pytest.raises(ValueError, match="blocks"):
        st(_trunk(g, 3, (1,), xw), (1,), 200).fwd_walk(xw, 200)


def _same_tiles(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("wide", "narrow", "bias")) and a.offs == b.offs


@pytest.mark.parametrize("size", ["small", "full"])
def test_st_walk_rewrites_the_heads_in_place(size):
    """A head update (an optimizer step on the heads, the trunk frozen)
    rewrites the heads' rows of the same tiles in place; the trunk's rows
    stay as they were; the tiles then equal a fresh build's, and the reader
    gives back the updated weights.  An unchanged field writes nothing; a
    trunk update builds new tiles.  The walk is built, and later rewritten,
    under inference mode (validation passes) and used outside it."""
    w, xw, e3, _ = _weights("st", size)
    with torch.inference_mode():
        walk = w.fwd_walk(xw, e3)
    tiles = walk.tiles
    ptrs = [t.data_ptr() for t in (tiles.wide, tiles.narrow, tiles.bias)]
    trunk_rows = walk.tiles.offs[len(w.trunk)][0]     # RGB layer 0's wrow
    trunk_wide = tiles.wide[:trunk_rows].clone()
    versions = [t._version for t in (tiles.wide, tiles.narrow, tiles.bias)]
    assert w.fwd_walk(xw, e3) is walk
    assert versions == [t._version
                        for t in (tiles.wide, tiles.narrow, tiles.bias)]

    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for _, head in _heads(w):
            for layer in head:
                layer.w.add_(torch.randn(layer.w.shape, generator=g) * 0.1)
                layer.b.add_(torch.randn(layer.b.shape, generator=g) * 0.1)
    with torch.inference_mode():                # the next validation pass
        assert w.fwd_walk(xw, e3) is walk
    assert ptrs == [t.data_ptr()
                    for t in (tiles.wide, tiles.narrow, tiles.bias)]
    assert torch.equal(tiles.wide[:trunk_rows], trunk_wide)
    fresh = STFieldWeights(w.trunk, w.rgb, w.trans, w.skip)
    assert _same_tiles(tiles, fresh.fwd_walk(xw, e3).tiles)
    for layer, (wt, b) in zip(_layers(w), _read_back(w, walk, xw, e3)):
        assert torch.equal(wt, round_to(layer.w, BF16)[:wt.shape[0]])
        assert torch.equal(b, layer.b)

    with torch.no_grad():
        w.trunk[1].w.mul_(0.5)
    rebuilt = w.fwd_walk(xw, e3)
    assert rebuilt is not walk
    assert _same_tiles(rebuilt.tiles, STFieldWeights(
        w.trunk, w.rgb, w.trans, w.skip).fwd_walk(xw, e3).tiles)
