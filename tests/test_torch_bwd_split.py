"""The split form of the field backwards (rows 7b and 2, and the render
backward 6b): phase (a), the dX chain that stores each layer's output
gradient (and rows 2 and 6b's recomputed hidden activations) to planes,
then phase (b), the grouped dW GEMM over the descriptor table
(kernels/dw_gemm.py ``dw_segments`` of each field; 6b uses row 2's), then
the fixed-order sum of the GEMM's split partials.  The CUDA kernels cannot
run here, so the layouts they read are held on the CPU through their plain
twins, at a small width:

  * the descriptor table covers every dW block of the gradient layout
    exactly once, with dW rows that are multiples of 16 (for 6b, inside
    the planes its dX chain's twin writes);
  * phase (a)'s twin, then phase (b)'s twin from that table, equals the
    one-piece twin (``coarse_field_bwd_plain`` / ``st_field_bwd_plain`` /
    ``st_render_bwd_plain``) to rtol 1e-5 in float32 (the same products,
    summed in another order) and, for 6b at bf16 compute, to 2e-3 of each
    tensor's largest magnitude (the planes hold the same bf16 values; the
    sums' order differs);
  * the same output equals JAX's backward of ``fused_coarse_field`` /
    ``fused_st_field`` / the fully fused render backward
    (TEXPOSE_MEGA_FULLBWD=1) in interpret mode, to the tolerances of
    tests/test_torch_pretrain_kernels.py (1e-4 of each tensor's largest
    magnitude), tests/test_torch_field_bwd.py (1e-5) and
    tests/test_torch_st_render.py (5e-5 absolute or 1e-4 of the largest
    magnitude);
  * the reduction's twin sums the split partials of the kernel's tiles
    into their blocks.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.nn import fields as jfields
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from test_fused_st import st_cfg
from test_torch_field import _bridge as _st_bridge
from test_torch_pretrain_kernels import (B, N, PROGRESS, R, _bridge, _cfg,
                                         _jax_pts, _port_inputs, _rel)
from test_torch_st_render import _close, _jax_run, _loss, _port_run, _setup
from texpose_tpu.kernels.fused_st_render import _make_op
from texpose_tpu_torch.kernels import dw_gemm as dw
from texpose_tpu_torch.kernels import st_field as sf
from texpose_tpu_torch.kernels import st_render as sr
from texpose_tpu_torch.kernels.coarse_field import (
    coarse_field_bwd_dx_plain, coarse_field_bwd_plain, coarse_render_plain)
from texpose_tpu_torch.kernels.st_field import _ceil16
from texpose_tpu_torch.nn.mlp import round_to

SPLIT_RTOL = 1e-5


def _coarse(view_dep):
    cfg = _cfg(view_dep)
    jparams = jfields.init_nerf(jax.random.PRNGKey(1), cfg)
    nerf = _bridge(jparams, cfg)
    rng = np.random.default_rng(7)
    center = np.tile(np.array([0.0, 0.0, -2.0], np.float32), (B, R, 1))
    ray = rng.normal(size=(B, R, 3)).astype(np.float32) * 0.2
    ray[..., 2] = 1.0
    depth = np.sort(rng.uniform(1.0, 3.0, size=(B, R, N, 1)), axis=2
                    ).astype(np.float32)
    return cfg, jparams, nerf, (center, ray, depth)


def _st():
    cfg = st_cfg()
    jparams = jfields.init_nerf_st(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, _st_bridge(jparams, cfg)


def _blocks(parts):
    """{offset: (rows, cols)} of the dW blocks of a gradient layout given as
    [(part, rows, cols)]: every part that is not a bias."""
    out, at = {}, 0
    for part, rows, cols in parts:
        if not part.startswith("b"):
            out[at] = (rows, cols)
        at += rows * cols
    return out


def _render_inputs(w, Bi, Ri, Ni, seed):
    """The render backward's inputs at the field ``w``'s widths, from a
    numpy seed: (feat [M,F], encpts [M,18], light [Bi,12], trans [Bi,8],
    dens [M,1], dist [BR,N], g [BR,16], rows per image)."""
    rng = np.random.default_rng(seed)
    M, BR = Bi * Ri * Ni, Bi * Ri

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32))

    feat = torch.relu(t(M, w.feat_dim))
    dist = torch.from_numpy(rng.uniform(0.01, 0.2, size=(BR, Ni))
                            .astype(np.float32))
    return (feat, t(M, 18), t(Bi, 12, scale=0.3), t(Bi, 8, scale=0.3),
            t(M, 1), dist, t(BR, 16, scale=0.1), Ri * Ni)


def _render_split(feat, encpts, light, trans, dens, dist, g, w, rpi,
                  compute_dtype=torch.float32):
    """Row 6b's split twins: the dX chain's (``st_render_bwd_dx_plain``),
    then phase (b)'s through the wrapper's own ``finish_split`` on the
    staged enc⊕pts (rounded to compute_dtype, as the card's bf16 staging)
    → what ``st_render_bwd`` returns."""
    hp, gp, gn, grads, d_lrow, d_trow = sr.st_render_bwd_dx_plain(
        feat, encpts, light, trans, dens, dist, g, w, rpi, compute_dtype)
    e3 = encpts.shape[1]
    ke = _ceil16(e3)
    ep = torch.zeros((feat.shape[0], ke))
    ep[:, :e3] = round_to(encpts.float(), compute_dtype)
    return sf.finish_split(w, (hp, gp, gn), round_to(feat.float(),
                                                     compute_dtype), ep,
                           sf._grad_layout(w, ke), grads, d_lrow, d_trow,
                           light, trans, e3)


@pytest.mark.parametrize("row", ["7b_view_indep", "7b_view_dep", "2", "6b"])
def test_descriptor_table_covers_the_layout(row, monkeypatch):
    """Every dW block of the layout is one segment, at its offset, of its
    rows and columns; nothing else is; dW rows are multiples of 16 and
    each block lies inside its G plane (wide blocks the layer's width,
    narrow ones 8 columns of the 16-column plane).  For 6b (the render
    kernels' test field) each segment's A and G columns also lie inside
    the planes its dX chain's twin writes."""
    if row.startswith("7b"):
        cfg, _, nerf, scene = _coarse(row.endswith("view_dep"))
        xext, ep, _, _ = _port_inputs(cfg, *scene)
        w = nerf.kernel_weights()
        kx, ke = _ceil16(xext.shape[1]), _ceil16(ep.shape[1])
        layout, _, _ = w.grad_layout(kx, ke)
        blocks = _blocks([(k[2], r, c) for k, r, c in layout])
        segs = w.dw_segments(kx, ke)
        width = w.feat_dim
    else:
        if row == "2":
            _, _, nerf = _st()
        else:
            _, _, nerf, _ = _setup(monkeypatch)
        w = nerf.kernel_weights()
        ke = _ceil16(3 + 6 * 2 + 3)
        blocks = _blocks([(part, r, c) for *_, part, r, c
                          in sf._grad_layout(w, ke)])
        segs = sf.dw_segments(w, ke)
        width = w.rgb[0].w.shape[1]
    if row == "6b":
        args = _render_inputs(w, 2, 4, 16, 1)
        with torch.no_grad():
            hp, gp, gn, *_ = sr.st_render_bwd_dx_plain(*args[:7], w,
                                                       args[7])
        srcs = [hp, args[0][None], torch.zeros((1, hp.shape[1], ke))]
        for s in segs:
            a = srcs[s.a]
            assert s.a_plane < a.shape[0] and s.a_col + s.k_in <= a.shape[2]
            if s.b == dw.WIDE:
                assert s.b_plane < gp.shape[0] and s.n <= gp.shape[2], s
            assert gn.shape[1] == dw.NARROW_COLS
    got = {s.out: (s.k_in, s.n) for s in segs}
    assert len(got) == len(segs)
    assert got == blocks
    for s in segs:
        assert s.k_in % 16 == 0, s
        if s.b == dw.WIDE:
            assert s.n == width and s.b_col == 0, s
        else:
            assert s.n == 8 and s.b_col + s.n <= dw.NARROW_COLS, s


def _coarse_split(nerf, xext, ep, acts, g_rgb, g_dens):
    """Phase (a)'s twin, phase (b)'s twin over the table → gradients in
    params() order (float32)."""
    w = nerf.kernel_weights()
    kx, ke = _ceil16(xext.shape[1]), _ceil16(ep.shape[1])
    gplanes, gnarrow, grads = coarse_field_bwd_dx_plain(
        xext, ep, acts, w, g_rgb, g_dens, torch.float32)
    M = xext.shape[0]
    xe = torch.zeros((M, kx + ke))
    xe[:, :xext.shape[1]] = xext
    xe[:, kx:kx + ep.shape[1]] = ep
    acts_t = torch.stack([a.float() for a in acts])
    dw.dw_grads([acts_t, xe[None]], gplanes, gnarrow, w.dw_segments(kx, ke),
                grads)
    layout, _, _ = w.grad_layout(kx, ke)
    parts, at = {}, 0
    for key, rows, cols in layout:
        parts[key] = grads[at:at + rows * cols].view(rows, cols)
        at += rows * cols
    return w.finish_grads(parts, xext.shape[1], ep.shape[1])


@pytest.mark.parametrize("view_dep", [False, True],
                         ids=["view_indep", "view_dep"])
def test_coarse_split_matches_twin_and_jax(monkeypatch, view_dep):
    """Row 7b: the split twins against coarse_field_bwd_plain (rtol 1e-5)
    and against the VJP of fused_coarse_field in interpret mode (1e-4 of
    each tensor's largest magnitude), every trunk and head tensor."""
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg, jparams, nerf, (center, ray, depth) = _coarse(view_dep)
    M = B * R * N
    rng = np.random.default_rng(5)
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)
    g_dens = rng.normal(size=(M, 1)).astype(np.float32)
    xext, ep, dist, d = _port_inputs(cfg, center, ray, depth)
    w = nerf.kernel_weights()
    with torch.no_grad():
        *_, acts = coarse_render_plain(xext, ep, dist, d, w, torch.float32,
                                       want_res=True)
        args = (torch.from_numpy(g_rgb), torch.from_numpy(g_dens))
        split = _coarse_split(nerf, xext, ep, acts, *args)
        twin = coarse_field_bwd_plain(xext, ep, acts, w, *args,
                                      torch.float32)
    for a, b in zip(split, twin):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SPLIT_RTOL,
                                   atol=SPLIT_RTOL * float(b.abs().max()))
    pts, unit = _jax_pts(center, ray, depth)
    _, vjp = jax.vjp(lambda p: jfields.apply_nerf_raw(
        p, cfg, pts, unit if view_dep else None, jnp.asarray(PROGRESS),
        compute_dtype=jnp.float32, interpret=True), jparams)
    jg = tree_to_flat_dict({"nerf": vjp((jnp.asarray(g_rgb),
                                         jnp.asarray(g_dens)))[0]})
    names = [n for n, _ in nerf.named_parameters()]
    for name, g in zip(names, split):
        key = "nerf/" + name.replace(".", "/")
        assert _rel(g.numpy(), jg[key]) <= 1e-4, key


def test_st_split_matches_twin_and_jax():
    """Row 2: the split twins against st_field_bwd_plain (rtol 1e-5) and
    against jax.grad through fused_st_field (interpret mode, 1e-5 of each
    tensor's largest magnitude): every head tensor and both latents, with
    rows of two images."""
    cfg, jparams, nerf = _st()
    Bi, Ri, Ni = 2, 4, 16
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(Bi, Ri, Ni, 3)).astype(np.float32)
    ray = rng.normal(size=(Bi, Ri, 3)).astype(np.float32)
    ray /= np.linalg.norm(ray, axis=-1, keepdims=True)
    lt = rng.normal(size=(Bi, 8)).astype(np.float32)
    ll = rng.normal(size=(Bi, 12)).astype(np.float32)
    M = Bi * Ri * Ni
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)
    g_tr = rng.normal(size=(M, 5)).astype(np.float32)
    w = nerf.kernel_weights()
    rpi = Ri * Ni
    with torch.no_grad():
        from texpose_tpu_torch.nn.fields import st_field_inputs
        xext, encpts = st_field_inputs(cfg, torch.from_numpy(pts),
                                       torch.from_numpy(ray), 1.0)
        *_, feat = sf.st_field_plain(xext, encpts, torch.from_numpy(ll),
                                     torch.from_numpy(lt), w, rpi,
                                     torch.float32, want_feat=True)
        args = (feat, encpts, torch.from_numpy(ll), torch.from_numpy(lt), w,
                rpi, torch.from_numpy(g_rgb), torch.from_numpy(g_tr),
                torch.float32)
        hplanes, gplanes, gnarrow, grads, d_lrow, d_trow = \
            sf.st_field_bwd_dx_plain(*args)
        e3 = encpts.shape[1]
        ke = _ceil16(e3)
        ep = torch.zeros((M, ke))
        ep[:, :e3] = encpts
        dw.dw_grads([hplanes, feat[None], ep[None]], gplanes, gnarrow,
                    sf.dw_segments(w, ke), grads)
        split = sf.finish_flat(w, sf._grad_layout(w, ke), grads, d_lrow,
                               d_trow, torch.from_numpy(ll),
                               torch.from_numpy(lt), e3)
        twin = sf.st_field_bwd_plain(*args)
    flat_split = list(split[0]) + list(split[1:])
    flat_twin = list(twin[0]) + list(twin[1:])
    for a, b in zip(flat_split, flat_twin):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SPLIT_RTOL,
                                   atol=SPLIT_RTOL * float(b.abs().max()))

    def jloss(heads, lt_, ll_):
        params = dict(heads, mlp_feat=jparams["mlp_feat"])
        rgb, _, tr = jfields.apply_nerf_st_raw(
            params, cfg, jnp.asarray(pts), jnp.asarray(ray), lt_, ll_,
            progress=jnp.asarray(1.0), compute_dtype=jnp.float32,
            tile_fwd=32, tile_bwd=32, interpret=True)
        return (rgb * g_rgb).sum() + (tr * g_tr).sum()

    heads = {k: v for k, v in jparams.items() if k != "mlp_feat"}
    g_heads, g_lt, g_ll = jax.grad(jloss, argnums=(0, 1, 2))(
        heads, jnp.asarray(lt), jnp.asarray(ll))
    want = [g_heads[name][i][part] for name in ("mlp_rgb", "mlp_trans")
            for i in range(len(heads[name])) for part in ("w", "b")]
    for got, ref in zip(split[0], want):
        assert _rel(got.numpy(), ref) <= 1e-5
    assert _rel(split[1].numpy(), g_ll) <= 1e-5
    assert _rel(split[2].numpy(), g_lt) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_st_render_split_matches_twin(dtype, monkeypatch):
    """Row 6b: the split twins (dX chain, then phase (b) over row 2's
    segment table) against st_render_bwd_plain, every head tensor and both
    latents, with rows of two images: to rtol 1e-5 in float32, to 2e-3 of
    each tensor's largest magnitude at bf16 compute."""
    _, _, nerf, _ = _setup(monkeypatch)
    w = nerf.kernel_weights()
    cdt = getattr(torch, dtype)
    args = _render_inputs(w, 2, 4, 16, 3)
    with torch.no_grad():
        feat = round_to(args[0], cdt)
        split = _render_split(feat, *args[1:7], w, args[7], cdt)
        twin = sr.st_render_bwd_plain(feat, *args[1:7], w, args[7], cdt)
    flat_split = list(split[0]) + list(split[1:])
    flat_twin = list(twin[0]) + list(twin[1:])
    assert len(flat_split) == len(flat_twin) == 2 * (len(w.rgb)
                                                     + len(w.trans)) + 2
    for a, b in zip(flat_split, flat_twin):
        assert a.shape == b.shape
        peak = float(b.abs().max())
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SPLIT_RTOL,
                                       atol=SPLIT_RTOL * peak)
        else:
            assert float((a - b).abs().max()) <= 2e-3 * peak


def test_st_render_split_matches_jax_fullbwd(monkeypatch):
    """Row 6b: the port's mega route with its backward taken by the split
    twins, against jax.grad through the JAX package's fully fused render
    backward (TEXPOSE_MEGA_FULLBWD=1, interpret mode), as
    tests/test_torch_st_render.py holds the one-piece twin: every head
    tensor and both latents."""
    cfg, jparams, nerf, (*scene, lt, ll) = _setup(monkeypatch)
    monkeypatch.setenv("TEXPOSE_MEGA_FULLBWD", "1")
    heads = {k: v for k, v in jparams.items() if k != "mlp_feat"}
    _make_op.cache_clear()
    try:
        g_heads, g_lt, g_ll = jax.grad(
            lambda h, a, b: _loss(_jax_run(dict(h, mlp_feat=jparams[
                "mlp_feat"]), cfg, scene, a, b)),
            argnums=(0, 1, 2))(heads, jnp.asarray(lt), jnp.asarray(ll))
    finally:
        _make_op.cache_clear()
    calls = []

    def split(*args):
        calls.append(1)
        return _render_split(*args)

    monkeypatch.setattr(sr, "st_render_bwd", split)
    t_lt = torch.tensor(lt, requires_grad=True)
    t_ll = torch.tensor(ll, requires_grad=True)
    _loss(_port_run(nerf, cfg, scene, t_lt, t_ll)).backward()
    assert calls == [1]
    for name in ("mlp_rgb", "mlp_trans"):
        for i, layer in enumerate(getattr(nerf, name)):
            for part in ("w", "b"):
                _close(getattr(layer, part).grad.numpy(),
                       g_heads[name][i][part], (name, i, part))
    _close(t_lt.grad.numpy(), g_lt, "latent_trans")
    _close(t_ll.grad.numpy(), g_ll, "latent_light")


def test_reduce_twin_sums_split_partials_in_order():
    """dw_reduce's twin: each tile's k_in × n block of the partials,
    summed over the splits, lands at its offset; nothing else is
    written."""
    rng = np.random.default_rng(3)
    segs = [dw.Segment(0, 0, 0, 32, dw.WIDE, 0, 0, 256, 0),
            dw.Segment(0, 0, 0, 256, dw.NARROW, 0, 8, 8, 32 * 256)]
    table = dw.problems(segs)
    assert [r[3] for r in table] == [32, 128, 128]
    assert [r[8] for r in table] == [0, 32 * 256, 32 * 256 + 128 * 8]
    partial = torch.from_numpy(rng.normal(size=(len(table), 3, 128, 256))
                               .astype(np.float32))
    grads = torch.full((32 * 256 + 256 * 8 + 5,), 7.0)
    dw.dw_reduce(partial, torch.tensor(table, dtype=torch.int32), grads)
    np.testing.assert_allclose(
        grads[:32 * 256].numpy(),
        partial[0, :, :32, :].sum(0).reshape(-1).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        grads[32 * 256:32 * 256 + 128 * 8].numpy(),
        partial[1, :, :, :8].sum(0).reshape(-1).numpy(), rtol=1e-6)
    assert (grads[-5:] == 7.0).all()


def test_gemm_twin_splits_rows_and_sums_to_the_products():
    """dw_gemm's twin over a ragged row count that the table splits in
    three (M = 1,500: 24 stages, three splits of eight): its partials, summed
    by dw_reduce's twin, equal the segments' direct products (dw_plain) to
    rtol 1e-5, for every kind of block (two-tile 256-row blocks, a 16-row
    block inside a ragged 80-column source, narrow blocks at both column
    offsets); each partial holds its split's rows only."""
    rng = np.random.default_rng(9)
    M = 1500

    def plane(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    srcs = [plane(2, M, 256), plane(M, 80)]
    g_wide, g_narrow = plane(2, M, 256), plane(M, dw.NARROW_COLS)
    S, W, NW = dw.Segment, dw.WIDE, dw.NARROW
    segs = [S(0, 1, 0, 256, W, 0, 0, 256, 0),
            S(1, 0, 64, 16, W, 1, 0, 256, 256 * 256),
            S(0, 0, 0, 256, NW, 0, 0, 8, 272 * 256),
            S(0, 1, 0, 256, NW, 0, 8, 8, 272 * 256 + 256 * 8)]
    total = 272 * 256 + 2 * 256 * 8
    partial, prob = dw.dw_gemm(srcs, g_wide, g_narrow, segs)
    per, splits = dw.split_rows(M, prob.shape[0], dw.H100_SMS)
    assert splits == 3 and partial.shape == (prob.shape[0], 3, 128, 256)
    h = srcs[0][1][per:2 * per, :128]
    np.testing.assert_allclose(partial[0, 1].numpy(),
                               (h.t() @ g_wide[0][per:2 * per]).numpy(),
                               rtol=1e-5, atol=1e-4)
    got = dw.dw_reduce(partial, prob, torch.zeros(total))
    want = dw.dw_plain(srcs, g_wide, g_narrow, segs, torch.zeros(total))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SPLIT_RTOL,
                               atol=SPLIT_RTOL * float(want.abs().max()))


def test_split_rows_fill_the_card():
    """Split-K: at the main paths' rows every split is a whole number of
    64-row stages, at least eight of them and at most MAX_SPLIT_STAGES
    (the accumulator's sums stay short: PR 15), and the blocks cover the
    rows once and fill at least one wave of the 132 SMs where the rows
    allow (27 tiles for row 7b, 17 for row 2); at few rows they keep to two
    waves."""
    for M, tiles in ((131072, 27), (393216, 27), (131072, 17), (640, 27),
                     (8192, 17)):
        per, splits = dw.split_rows(M, tiles, 132)
        assert per % dw.STAGE_ROWS == 0 and per * splits >= M
        assert per * (splits - 1) < M
        assert per >= 8 * dw.STAGE_ROWS or splits == 1
        assert per <= dw.MAX_SPLIT_STAGES * dw.STAGE_ROWS
        if M >= 131072:
            assert splits * tiles >= 132, (M, tiles, splits)
        if M <= 2 * 132 // tiles * 8 * dw.STAGE_ROWS:
            assert splits * tiles <= 264, (M, tiles, splits)
    assert dw.split_rows(131072, 17, 132) == (2048, 64)
