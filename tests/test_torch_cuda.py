"""The hand-written CUDA kernels against their plain-PyTorch twins, on the
card (marked ``cuda``, skipped without one; run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``).

ST field: both sides round every matmul operand to bf16 and accumulate in
f32, but sum in different orders, which can flip an activation's bf16
rounding (2^-8 relative) and the flip propagates: max |err| ≤ 3e-2 at
outputs of magnitude ≲ 4, mean |err| ≤ 1e-3.  The feature residual the
training forward writes reaches ~10, where one bf16 ulp is 2^-7 of the
value: |err| ≤ 3e-2·max(|ref|, 1) per element, mean |err| ≤ 1e-3.  Composite: float32 on both
sides, 1e-4 covers the summation order.

Backward kernels.  Field: the kernel's residual feeds both the kernel and
its twin, so they differ only where a different f32 summation order flips
a bf16 rounding of an activation or a gradient inside the chain, plus the
order of the cross-tile atomic sums.  Each flip moves one term by 2^-8
relative, and with random-sign gradients the sums cancel to ~√M terms, so
the bound is on the norm: ‖kernel − twin‖ ≤ FIELD_BWD_REL·‖twin‖ for every
gradient tensor, and no element off by more than FIELD_BWD_MAX of the
tensor's largest magnitude (a wrong index or image would miss by O(1)).
Composite: float32 on both sides, only the order of the suffix sums
differs: 1e-4 of the largest magnitude.
"""

import pytest
import torch

from texpose_tpu_torch.kernels.composite import (composite_st_bwd,
                                                 composite_st_bwd_plain,
                                                 composite_st_fwd,
                                                 composite_st_plain)
from texpose_tpu_torch.kernels.st_field import (STFieldWeights, make_xext,
                                                st_field_bwd,
                                                st_field_bwd_plain,
                                                st_field_fwd, st_field_plain)
from texpose_tpu_torch.nn.init import dense_init
from texpose_tpu_torch.nn.mlp import Dense
from texpose_tpu_torch.ops.render import _dists

pytestmark = pytest.mark.cuda

FIELD_BWD_REL = 1e-2
FIELD_BWD_MAX = 5e-2
COMPOSITE_BWD_REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(device, seed=0, n_head=4):
    """The shipped config's field: 8x256 trunk, skip at 4, L_3D=10,
    L_view=4, 48/16-d latents; heads of n_head layers (4 shipped)."""
    g = torch.Generator().manual_seed(seed)

    def layer(i, o, mode=None):
        return Dense(*dense_init(g, i, o, mode)).to(device)

    trunk = ([layer(63, 256)] + [layer(256, 256) for _ in range(3)]
             + [layer(256 + 63, 256)] + [layer(256, 256) for _ in range(2)]
             + [layer(256, 257, "first")])
    hidden = n_head - 2
    rgb = ([layer(256 + 27 + 3 + 48, 256)]
           + [layer(256, 256) for _ in range(hidden)] + [layer(256, 3, "all")])
    trans = ([layer(256 + 16, 256)] + [layer(256, 256) for _ in range(hidden)]
             + [layer(256, 5, "all")])
    return STFieldWeights(trunk, rgb, trans, [4])


@pytest.mark.parametrize("B,rows_per_img", [(1, 4096), (3, 333)])
def test_st_field_kernel_matches_plain(cuda, B, rows_per_img):
    w = _weights(cuda)
    g = torch.Generator().manual_seed(B)
    M = B * rows_per_img
    pts = (torch.randn(M, 3, generator=g) * 0.5).to(cuda)
    xext = make_xext(pts, 10, torch.ones(10, device=cuda))
    encpts = torch.cat([torch.randn(M, 27, generator=g).to(cuda), pts], 1)
    light = torch.randn(B, 48, generator=g).to(cuda)
    trans = torch.randn(B, 16, generator=g).to(cuda)
    with torch.inference_mode():
        n0 = st_field_fwd.launches
        out = st_field_fwd(xext, encpts, light, trans, w, rows_per_img)
        torch.cuda.synchronize()
        assert st_field_fwd.launches == n0 + 1
        ref = st_field_plain(xext, encpts, light, trans, w, rows_per_img)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        err = (a - b).abs()
        assert float(err.max()) <= 3e-2 and float(err.mean()) <= 1e-3


def _field_inputs(device, B, rows_per_img, seed):
    g = torch.Generator().manual_seed(seed)
    M = B * rows_per_img
    pts = (torch.randn(M, 3, generator=g) * 0.5).to(device)
    xext = make_xext(pts, 10, torch.ones(10, device=device))
    encpts = torch.cat([torch.randn(M, 27, generator=g).to(device), pts], 1)
    light = torch.randn(B, 48, generator=g).to(device)
    trans = torch.randn(B, 16, generator=g).to(device)
    return xext, encpts, light, trans


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _norm_err(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@pytest.mark.parametrize("B,rows_per_img", [(8, 16384), (3, 333)])
def test_st_field_bwd_kernel_matches_plain(cuda, B, rows_per_img):
    """The train step's shape (8 images x 16,384 rows = 131,072) and one
    whose tiles straddle image boundaries."""
    w = _weights(cuda)
    xext, encpts, light, trans = _field_inputs(cuda, B, rows_per_img, B)
    M = xext.shape[0]
    g = torch.Generator().manual_seed(7)
    g_rgb = (torch.randn(M, 3, generator=g) * 1e-3).to(cuda)
    g_trans = (torch.randn(M, 5, generator=g) * 1e-3).to(cuda)
    with torch.no_grad():
        n0 = st_field_fwd.launches
        *out, feat = st_field_fwd(xext, encpts, light, trans, w,
                                  rows_per_img, want_feat=True)
        *ref, feat_ref = st_field_plain(xext, encpts, light, trans, w,
                                        rows_per_img, want_feat=True)
        assert st_field_fwd.launches == n0 + 1
        assert feat.dtype == torch.bfloat16 and feat.shape == (M, 256)
        err = (feat.float() - feat_ref).abs()
        assert float((err / feat_ref.abs().clamp(min=1.0)).max()) <= 3e-2
        assert float(err.mean()) <= 1e-3
        for a, b in zip(out, ref):
            err = (a - b).abs()
            assert float(err.max()) <= 3e-2 and float(err.mean()) <= 1e-3
        n0 = st_field_bwd.launches
        got = st_field_bwd(feat, encpts, light, trans, w, rows_per_img,
                           g_rgb, g_trans)
        torch.cuda.synchronize()
        assert st_field_bwd.launches == n0 + 1
        want = st_field_bwd_plain(feat, encpts, light, trans, w,
                                  rows_per_img, g_rgb, g_trans)
    flat_got = list(got[0]) + [got[1], got[2]]
    flat_want = list(want[0]) + [want[1], want[2]]
    for a, b in zip(flat_got, flat_want):
        assert a.shape == b.shape
    norm = [_norm_err(a, b) for a, b in zip(flat_got, flat_want)]
    peak = [_rel_err(a, b) for a, b in zip(flat_got, flat_want)]
    print("st_field_bwd norm errors:", [f"{e:.1e}" for e in norm])
    print("st_field_bwd max errors:", [f"{e:.1e}" for e in peak])
    assert max(norm) <= FIELD_BWD_REL and max(peak) <= FIELD_BWD_MAX


@pytest.mark.parametrize("BR,N", [(2048, 64), (37, 16), (5, 100)])
def test_composite_bwd_kernel_matches_plain(cuda, BR, N):
    g = torch.Generator().manual_seed(N + 1)
    M = BR * N
    rgb_raw = torch.randn(M, 3, generator=g).to(cuda)
    trans_raw = torch.randn(M, 5, generator=g).to(cuda)
    dens_raw = (torch.randn(M, 1, generator=g) * 3).to(cuda)
    depth = torch.sort(torch.rand(BR, N, generator=g) * 4 + 2,
                       dim=1).values.to(cuda)
    ray = torch.randn(1, BR, 3, generator=g).to(cuda)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    cot = torch.randn(BR, 16, generator=g).to(cuda)
    n0 = composite_st_bwd.launches
    got = composite_st_bwd(rgb_raw, trans_raw, dens_raw, dist, cot)
    torch.cuda.synchronize()
    assert composite_st_bwd.launches == n0 + 1
    want = composite_st_bwd_plain(rgb_raw, trans_raw, dens_raw, dist, cot)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    print("composite_st_bwd relative errors:", errs)
    assert max(errs) <= COMPOSITE_BWD_REL


@pytest.mark.parametrize("BR,N", [(2048, 64), (37, 16), (5, 100)])
def test_composite_kernel_matches_plain(cuda, BR, N):
    g = torch.Generator().manual_seed(N)
    M = BR * N
    rgb_raw = torch.randn(M, 3, generator=g).to(cuda)
    trans_raw = torch.randn(M, 5, generator=g).to(cuda)
    dens_raw = (torch.randn(M, 1, generator=g) * 3).to(cuda)
    depth = torch.sort(torch.rand(BR, N, generator=g) * 4 + 2,
                       dim=1).values.to(cuda)
    ray = torch.randn(1, BR, 3, generator=g).to(cuda)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    out = composite_st_fwd(rgb_raw, trans_raw, dens_raw, depth, dist, 0.05)
    ref = composite_st_plain(rgb_raw, trans_raw, dens_raw, depth, dist, 0.05)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-4


def test_wrappers_raise_on_unsupported_input(cuda):
    w = _weights(cuda)
    x = torch.zeros(64, 63, device=cuda)
    e = torch.zeros(64, 30, device=cuda)
    lat = (torch.zeros(1, 48, device=cuda), torch.zeros(1, 16, device=cuda))
    with pytest.raises(ValueError):
        st_field_fwd(x, e, *lat, w, 64, compute_dtype=torch.float32)
    with pytest.raises(ValueError):                  # two images' rows, one latent
        st_field_fwd(x, e, *lat, w, 32)
    with pytest.raises(ValueError):                  # weights left on the host
        st_field_fwd(x, e, *lat, _weights("cpu"), 64)
    d = torch.zeros(2, 4, device=cuda)
    with pytest.raises(ValueError):
        composite_st_fwd(torch.zeros(8, 3, device=cuda, dtype=torch.float64),
                         torch.zeros(8, 5, device=cuda),
                         torch.zeros(8, 1, device=cuda), d, d)


def test_render_with_f32_compute_raises_on_card(cuda, tmp_path):
    """The render path on CUDA tensors takes the kernels whatever the
    compute dtype: float32 compute raises in the field kernel's wrapper
    instead of running the plain twins unseen."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_texture_gan_e2e import tiny_gan_cfg
    from texpose_tpu_torch.models.render import render_st_core
    from texpose_tpu_torch.nn.fields import init_nerf_st
    cfg = tiny_gan_cfg("unused", tmp_path)
    nerf = init_nerf_st(cfg).to(cuda)
    center = torch.zeros(1, 4, 3, device=cuda)
    ray = torch.ones(1, 4, 3, device=cuda)
    near = torch.full((1, 4), 2.0, device=cuda)
    lt, ll = torch.zeros(1, 8, device=cuda), torch.zeros(1, 12, device=cuda)
    n0 = st_field_fwd.launches
    with pytest.raises(ValueError, match="bfloat16"):
        render_st_core(nerf, cfg, center, ray, near, near + 1.0, lt, ll,
                       progress=1.0, compute_dtype=torch.float32)
    assert st_field_fwd.launches == n0


# ------------------------------------------------ the pretrain's kernels
#
# Coarse field + composite forward: the ST field's bounds for the raw
# outputs (bf16 re-rounding after a different f32 summation order), 2e-2
# for the composited rgb/depth/opacity (sigmoid slope ≤ 1/4, weights summing
# to ≤ 1, depths ≲ 6), and the residual activations relative like the ST
# feature residual.  Composite-coarse backward: f32 on both sides, 1e-4 of
# the largest magnitude.  Field backward: from the kernel's own residuals,
# per tensor on the norm (atomics reorder its sums), as the ST backward.


def _coarse_weights(device, view_dep, seed=0, n_head=4):
    """The shipped pretrain field: 8x256 trunk with skip at 4, L_3D 10, RGB
    head 256-256-256-3 (n_head layers) on feat ⊕ (27-wide view encoding) ⊕
    pts."""
    from texpose_tpu_torch.kernels.coarse_field import CoarseFieldWeights
    g = torch.Generator().manual_seed(seed)

    def layer(i, o, mode=None):
        return Dense(*dense_init(g, i, o, mode)).to(device)

    trunk = ([layer(63, 256)] + [layer(256, 256) for _ in range(3)]
             + [layer(256 + 63, 256)] + [layer(256, 256) for _ in range(2)]
             + [layer(256, 257, "first")])
    e3 = 30 if view_dep else 3
    rgb = ([layer(256 + e3, 256)]
           + [layer(256, 256) for _ in range(n_head - 2)]
           + [layer(256, 3, "all")])
    return CoarseFieldWeights(trunk, rgb, [4])


def _coarse_inputs(device, BR, N, view_dep, seed):
    g = torch.Generator().manual_seed(seed)
    M = BR * N
    pts = (torch.randn(M, 3, generator=g) * 0.5).to(device)
    c2f = torch.linspace(1.0, 0.2, 10).to(device)
    xext = make_xext(pts, 10, c2f)
    ep = (torch.cat([torch.randn(M, 27, generator=g).to(device), pts], 1)
          if view_dep else pts)
    depth = torch.sort(torch.rand(BR, N, generator=g) * 2 + 3,
                       dim=1).values.to(device)
    ray = torch.randn(1, BR, 3, generator=g).to(device)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    return xext, ep, dist, depth


@pytest.mark.parametrize("BR,N,view_dep", [(2048, 64, False), (37, 64, True),
                                           (301, 32, True), (13, 8, False)])
def test_coarse_render_kernel_matches_plain(cuda, BR, N, view_dep):
    from texpose_tpu_torch.kernels.coarse_field import (coarse_render_fwd,
                                                        coarse_render_plain)
    w = _coarse_weights(cuda, view_dep)
    xext, ep, dist, depth = _coarse_inputs(cuda, BR, N, view_dep, BR)
    with torch.no_grad():
        n0 = coarse_render_fwd.launches
        out = coarse_render_fwd(xext, ep, dist, depth, w)
        got, rgb, dens, (xe, acts) = coarse_render_fwd(
            xext, ep, dist, depth, w, want_res=True)
        torch.cuda.synchronize()
        assert coarse_render_fwd.launches == n0 + 2
        ref, rgb_ref, dens_ref, acts_ref = coarse_render_plain(
            xext, ep, dist, depth, w, want_res=True)
    assert torch.equal(out, got)
    assert out.shape == (BR, 8) and acts.shape == (11, BR * N, 256)
    for a, b in ((rgb, rgb_ref), (dens, dens_ref)):
        err = (a - b).abs()
        assert float(err.max()) <= 3e-2 and float(err.mean()) <= 1e-3
    assert float((got - ref).abs().max()) <= 2e-2
    for a, b in zip(acts, acts_ref):
        err = (a.float() - b).abs()
        assert float((err / b.abs().clamp(min=1.0)).max()) <= 3e-2
        assert float(err.mean()) <= 1e-3


@pytest.mark.parametrize("BR,N", [(2048, 64), (37, 16), (5, 48)])
def test_composite_coarse_bwd_kernel_matches_plain(cuda, BR, N):
    from texpose_tpu_torch.kernels.composite import (
        composite_coarse_bwd, composite_coarse_bwd_plain)
    g = torch.Generator().manual_seed(N + 2)
    M = BR * N
    rgb_raw = torch.randn(M, 3, generator=g).to(cuda)
    dens_raw = (torch.randn(M, 1, generator=g) * 3).to(cuda)
    depth = torch.sort(torch.rand(BR, N, generator=g) * 4 + 2,
                       dim=1).values.to(cuda)
    ray = torch.randn(1, BR, 3, generator=g).to(cuda)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    cot = torch.randn(BR, 8, generator=g).to(cuda)
    n0 = composite_coarse_bwd.launches
    got = composite_coarse_bwd(rgb_raw, dens_raw, dist, depth, cot)
    torch.cuda.synchronize()
    assert composite_coarse_bwd.launches == n0 + 1
    want = composite_coarse_bwd_plain(rgb_raw, dens_raw, dist, depth, cot)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    print("composite_coarse_bwd relative errors:", errs)
    assert max(errs) <= COMPOSITE_BWD_REL


@pytest.mark.parametrize("BR,N,view_dep", [(2048, 64, False),
                                           (2048, 192, False),
                                           (301, 32, True)])
def test_coarse_field_bwd_kernel_matches_plain(cuda, BR, N, view_dep):
    """The pretrain step's 131,072 rows (residuals from the render
    forward), the hierarchical step's fine field (393,216 rows, residuals
    from the field forward, row 7a) and a ragged view-dependent case."""
    from texpose_tpu_torch.kernels.coarse_field import (
        coarse_field_bwd, coarse_field_bwd_plain, coarse_field_fwd,
        coarse_render_fwd)
    w = _coarse_weights(cuda, view_dep)
    xext, ep, dist, depth = _coarse_inputs(cuda, BR, N, view_dep, 3)
    M = BR * N
    g = torch.Generator().manual_seed(9)
    g_rgb = (torch.randn(M, 3, generator=g) / M).to(cuda)
    g_dens = (torch.randn(M, 1, generator=g) / M).to(cuda)
    with torch.no_grad():
        if N > 64:                                # the fine field (7a)
            _, _, (xe, acts) = coarse_field_fwd(xext, ep, w, want_res=True)
        else:
            _, _, _, (xe, acts) = coarse_render_fwd(xext, ep, dist, depth, w,
                                                    want_res=True)
        n0 = coarse_field_bwd.launches
        got = coarse_field_bwd(xext, ep, xe, acts, w, g_rgb, g_dens)
        torch.cuda.synchronize()
        assert coarse_field_bwd.launches == n0 + 1
        want = coarse_field_bwd_plain(xext, ep, acts, w, g_rgb, g_dens)
    assert [a.shape for a in got] == [p.shape for p in w.params()]
    norm = [_norm_err(a, b) for a, b in zip(got, want)]
    peak = [_rel_err(a, b) for a, b in zip(got, want)]
    print("coarse_field_bwd norm errors:", [f"{e:.1e}" for e in norm])
    print("coarse_field_bwd max errors:", [f"{e:.1e}" for e in peak])
    assert max(norm) <= FIELD_BWD_REL and max(peak) <= FIELD_BWD_MAX


def test_coarse_render_autograd_launches_all_three(cuda):
    from texpose_tpu_torch.kernels.coarse_field import (coarse_field_bwd,
                                                        coarse_render,
                                                        coarse_render_fwd)
    from texpose_tpu_torch.kernels.composite import composite_coarse_bwd
    w = _coarse_weights(cuda, False)
    xext, ep, dist, depth = _coarse_inputs(cuda, 64, 64, False, 4)
    counts = [f.launches for f in (coarse_render_fwd, composite_coarse_bwd,
                                   coarse_field_bwd)]
    params = w.params()
    for p in params:
        p.requires_grad_(True)
    coarse_render(xext, ep, dist, depth, w)[:, :5].sum().backward()
    torch.cuda.synchronize()
    assert [f.launches for f in (coarse_render_fwd, composite_coarse_bwd,
                                 coarse_field_bwd)] == [c + 1 for c in counts]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in params)


# ------------------------------- the coarse field's two-kernel route, trunk
#
# Field forward with raw outputs (row 7a): the mega forward's bounds for the
# raw outputs and the residual activations, at rows that are not a multiple
# of the 64-row tile too.  Composite-coarse forward (rows 9a/9c): float32 on
# both sides, 1e-4 absolute.  Trunk forward (row 10): the features as the
# residual activations (3e-2 of max(|ref|, 1), mean 1e-3), the raw density
# as a raw output.


@pytest.mark.parametrize("BR,N,view_dep", [(2048, 64, False),
                                           (2048, 192, False),
                                           (301, 24, True), (13, 7, False)])
def test_coarse_field_fwd_kernel_matches_plain(cuda, BR, N, view_dep):
    from texpose_tpu_torch.kernels.coarse_field import (coarse_field_fwd,
                                                        coarse_field_plain)
    w = _coarse_weights(cuda, view_dep)
    xext, ep, _, _ = _coarse_inputs(cuda, BR, N, view_dep, BR + N)
    with torch.no_grad():
        n0 = coarse_field_fwd.launches
        rgb0, dens0 = coarse_field_fwd(xext, ep, w)
        rgb, dens, (xe, acts) = coarse_field_fwd(xext, ep, w, want_res=True)
        torch.cuda.synchronize()
        assert coarse_field_fwd.launches == n0 + 2
        rgb_ref, dens_ref, acts_ref = coarse_field_plain(xext, ep, w,
                                                         want_res=True)
    assert torch.equal(rgb0, rgb) and torch.equal(dens0, dens)
    assert rgb.shape == (BR * N, 3) and acts.shape == (11, BR * N, 256)
    for a, b in ((rgb, rgb_ref), (dens, dens_ref)):
        err = (a - b).abs()
        assert float(err.max()) <= 3e-2 and float(err.mean()) <= 1e-3
    for a, b in zip(acts, acts_ref):
        err = (a.float() - b).abs()
        assert float((err / b.abs().clamp(min=1.0)).max()) <= 3e-2
        assert float(err.mean()) <= 1e-3


@pytest.mark.parametrize("BR,N", [(2048, 64), (2048, 192), (37, 100),
                                  (5, 256), (3, 7)])
def test_composite_coarse_fwd_kernel_matches_plain(cuda, BR, N):
    from texpose_tpu_torch.kernels.composite import (composite_coarse_fwd,
                                                     composite_coarse_plain)
    g = torch.Generator().manual_seed(N + 3)
    M = BR * N
    rgb_raw = torch.randn(M, 3, generator=g).to(cuda)
    dens_raw = (torch.randn(M, 1, generator=g) * 3).to(cuda)
    depth = torch.sort(torch.rand(BR, N, generator=g) * 4 + 2,
                       dim=1).values.to(cuda)
    ray = torch.randn(1, BR, 3, generator=g).to(cuda)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    n0 = composite_coarse_fwd.launches
    out = composite_coarse_fwd(rgb_raw, dens_raw, depth, dist)
    torch.cuda.synchronize()
    assert composite_coarse_fwd.launches == n0 + 1
    ref = composite_coarse_plain(rgb_raw, dens_raw, depth, dist)
    assert out.shape == (BR, 8)
    assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.parametrize("BR,N", [(2048, 192), (9, 256), (7, 130)])
def test_composite_coarse_bwd_kernel_widened(cuda, BR, N):
    """Row 9b past 64 samples per ray (4 and 8 samples per lane)."""
    from texpose_tpu_torch.kernels.composite import (
        composite_coarse_bwd, composite_coarse_bwd_plain)
    g = torch.Generator().manual_seed(N + 5)
    M = BR * N
    rgb_raw = torch.randn(M, 3, generator=g).to(cuda)
    dens_raw = (torch.randn(M, 1, generator=g) * 3).to(cuda)
    depth = torch.sort(torch.rand(BR, N, generator=g) * 4 + 2,
                       dim=1).values.to(cuda)
    ray = torch.randn(1, BR, 3, generator=g).to(cuda)
    dist = _dists(depth.reshape(1, BR, N, 1), ray).reshape(BR, N)
    cot = torch.randn(BR, 8, generator=g).to(cuda)
    got = composite_coarse_bwd(rgb_raw, dens_raw, dist, depth, cot)
    torch.cuda.synchronize()
    want = composite_coarse_bwd_plain(rgb_raw, dens_raw, dist, depth, cot)
    errs = [_rel_err(a, b) for a, b in zip(got, want)]
    print("composite_coarse_bwd relative errors:", errs)
    assert max(errs) <= COMPOSITE_BWD_REL


@pytest.mark.parametrize("M", [131072, 1000])
def test_trunk_fwd_kernel_matches_plain(cuda, M):
    from texpose_tpu_torch.kernels.trunk import (trunk_forward_plain,
                                                 trunk_fwd)
    tw = _weights(cuda)          # the ST field's weights: their trunk pack
    g = torch.Generator().manual_seed(M)
    pts = (torch.randn(M, 3, generator=g) * 0.5).to(cuda)
    xext = make_xext(pts, 10, torch.linspace(1.0, 0.3, 10).to(cuda))
    n0 = trunk_fwd.launches
    feat, dens = trunk_fwd(xext, tw)
    torch.cuda.synchronize()
    assert trunk_fwd.launches == n0 + 1
    assert feat.dtype == torch.bfloat16 and feat.shape == (M, 256)
    feat_ref, dens_ref = trunk_forward_plain(xext, tw.trunk, tw.skip)
    err = (feat.float() - feat_ref).abs()
    assert float((err / feat_ref.abs().clamp(min=1.0)).max()) <= 3e-2
    assert float(err.mean()) <= 1e-3
    err = (dens - dens_ref[:, 0]).abs()
    assert float(err.max()) <= 3e-2 and float(err.mean()) <= 1e-3


@pytest.mark.parametrize("field,M", [("st", 300), ("coarse", 64),
                                     ("density", 129)],
                         ids=["st-shared-tiles", "coarse-one-tile",
                              "density-own-tiles"])
def test_trunk_fwd_walk_tiles_and_edges(cuda, field, M):
    """Row 10 on the wgmma tile: through the tiles it shares with a field's
    forward walk (built first) and through its own (the density-only
    field), at a ragged last tile, M = 64 (the second warpgroup has no
    row) and M = 129; the features' ReLU mask as the twin's."""
    from texpose_tpu_torch.kernels.st_field import TrunkWeights
    from texpose_tpu_torch.kernels.trunk import (trunk_forward_plain,
                                                 trunk_fwd)
    if field == "st":
        w = _weights(cuda)
        w.fwd_walk(63, 30)
    elif field == "coarse":
        w = _coarse_weights(cuda, True)
        w.fwd_walk(63, 30)
    else:
        c = _coarse_weights(cuda, False, seed=3)
        w = TrunkWeights(c.trunk, c.skip)
    shared = field != "density"
    assert (w.trunk_walk(63).tiles.wide is w.fwd_walk(63, 30).tiles.wide
            if shared else w._packs.get("walk") is None)
    g = torch.Generator().manual_seed(M)
    pts = (torch.randn(M, 3, generator=g) * 0.5).to(cuda)
    xext = make_xext(pts, 10, torch.linspace(1.0, 0.3, 10).to(cuda))
    n0 = trunk_fwd.launches
    with torch.inference_mode():
        feat, dens = trunk_fwd(xext, w)
    torch.cuda.synchronize()
    assert trunk_fwd.launches == n0 + 1
    feat_ref, dens_ref = trunk_forward_plain(xext, w.trunk, w.skip)
    _feat_close(feat, feat_ref)
    _mask_agrees(feat, feat_ref)
    err = (dens - dens_ref[:, 0]).abs()
    assert float(err.max()) <= 3e-2 and float(err.mean()) <= 1e-3


def test_coarse_field_autograd_and_raising_wrappers(cuda):
    """coarse_field's autograd launches the field forward and backward
    kernels once each; the new wrappers raise on what their kernels do not
    take (f32 compute, more than 256 samples per ray)."""
    from texpose_tpu_torch.kernels.coarse_field import (coarse_field,
                                                        coarse_field_bwd,
                                                        coarse_field_fwd)
    from texpose_tpu_torch.kernels.composite import (composite_coarse_bwd,
                                                     composite_coarse_fwd)
    from texpose_tpu_torch.kernels.trunk import trunk_fwd
    w = _coarse_weights(cuda, False)
    xext, ep, _, _ = _coarse_inputs(cuda, 100, 24, False, 6)
    counts = [f.launches for f in (coarse_field_fwd, coarse_field_bwd)]
    params = w.params()
    for p in params:
        p.requires_grad_(True)
    rgb, dens = coarse_field(xext, ep, w)
    (rgb.sum() + dens.sum()).backward()
    torch.cuda.synchronize()
    assert [f.launches for f in (coarse_field_fwd, coarse_field_bwd)] == \
        [c + 1 for c in counts]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in params)
    with pytest.raises(ValueError, match="bfloat16"):
        coarse_field_fwd(xext, ep, w, torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        trunk_fwd(xext, w, torch.float32)
    big = torch.zeros(2, 257, device=cuda)
    with pytest.raises(ValueError, match="256"):
        composite_coarse_fwd(torch.zeros(514, 3, device=cuda),
                             torch.zeros(514, 1, device=cuda), big, big)
    with pytest.raises(ValueError, match="256"):
        composite_coarse_bwd(torch.zeros(514, 3, device=cuda),
                             torch.zeros(514, 1, device=cuda), big, big,
                             torch.zeros(2, 8, device=cuda))


# ------------------------------------- the render kernels (kernels.st_mega)
#
# Forward (row 6f): the packed composite against the whole twin (field twin
# → composite twin) at RENDER_REL of max(|ref|, 1): the ST field's raw-output
# bound after the sigmoid (slope ≤ 1/4) and weights summing to ≤ 1, and for
# column 14 a sum over N samples whose errors are mostly of random sign; the
# composite epilogue alone, against composite_st_plain of the kernel's own
# raw outputs, at the composites' 1e-4 (f32 both sides).  The training
# variant's raw outputs and residual as the field forward's.  Backward (row
# 6b): from the kernel's residuals, per tensor on the norm (atomics reorder
# its sums), as the field backward — against its twin and against the
# hybrid backward (composite_st_bwd → st_field_bwd).

RENDER_REL = 2e-2


def _render_inputs(device, B, R, N, seed):
    rows = R * N
    xext, encpts, light, trans = _field_inputs(device, B, rows, seed)
    g = torch.Generator().manual_seed(seed + 1)
    depth = torch.sort(torch.rand(B * R, N, generator=g) * 2 + 3,
                       dim=1).values.to(device)
    ray = torch.randn(1, B * R, 3, generator=g).to(device)
    dist = _dists(depth.reshape(1, B * R, N, 1), ray).reshape(B * R, N)
    return xext, encpts, light, trans, dist, depth


@pytest.mark.parametrize("B,R,N", [(1, 2048, 64), (4, 18, 16), (4, 5, 32)])
def test_st_render_fwd_kernel_matches_plain(cuda, B, R, N):
    """The eval chunk's shape (one image, 2048 rays × 64 samples) and two
    whose 64-row tiles straddle image boundaries (288 and 160 rows per
    image)."""
    from texpose_tpu_torch.kernels.st_render import (st_render_fwd,
                                                     st_render_plain)
    w = _weights(cuda)
    args = (*_render_inputs(cuda, B, R, N, B + N), w, R * N)
    with torch.no_grad():
        n0 = st_render_fwd.launches
        out = st_render_fwd(*args)
        got, rgb, dens, tr, feat = st_render_fwd(*args, want_res=True)
        torch.cuda.synchronize()
        assert st_render_fwd.launches == n0 + 2
        ref, rgb_ref, dens_ref, tr_ref, feat_ref = st_render_plain(
            *args, want_res=True)
        epi = composite_st_plain(rgb, tr, dens, args[5], args[4], 0.05)
    assert torch.equal(out, got) and out.shape == (B * R, 16)
    assert float((got - epi).abs().max()) <= 1e-4
    err = (got - ref).abs() / ref.abs().clamp(min=1.0)
    assert float(err.max()) <= RENDER_REL
    for a, b in ((rgb, rgb_ref), (dens, dens_ref), (tr, tr_ref)):
        e = (a - b).abs()
        assert float(e.max()) <= 3e-2 and float(e.mean()) <= 1e-3
    e = (feat.float() - feat_ref).abs()
    assert float((e / feat_ref.abs().clamp(min=1.0)).max()) <= 3e-2
    assert float(e.mean()) <= 1e-3


@pytest.mark.parametrize("B,R,N", [(8, 256, 64), (4, 18, 16), (4, 5, 32)])
def test_st_render_bwd_kernel_matches_plain(cuda, B, R, N):
    """The train step's shape (8 images × 256 rays × 64 samples) and two
    whose tiles straddle image boundaries: the fused backward against its
    twin and against the hybrid backward on the same residuals."""
    from texpose_tpu_torch.kernels.st_render import (st_render_bwd,
                                                     st_render_bwd_plain,
                                                     st_render_fwd)
    w = _weights(cuda)
    xext, encpts, light, trans, dist, depth = _render_inputs(cuda, B, R, N,
                                                             B + 2 * N)
    g = torch.Generator().manual_seed(11)
    cot = (torch.randn(B * R, 16, generator=g) / (B * R)).to(cuda)
    with torch.no_grad():
        _, rgb, dens, tr, feat = st_render_fwd(
            xext, encpts, light, trans, dist, depth, w, R * N, want_res=True)
        n0 = st_render_bwd.launches
        got = st_render_bwd(feat, encpts, light, trans, dens, dist, cot, w,
                            R * N)
        torch.cuda.synchronize()
        assert st_render_bwd.launches == n0 + 1
        want = st_render_bwd_plain(feat, encpts, light, trans, dens, dist,
                                   cot, w, R * N)
        d_rgb, d_tr = composite_st_bwd(rgb, tr, dens, dist, cot)
        hyb = st_field_bwd(feat, encpts, light, trans, w, R * N, d_rgb, d_tr)
    flat = [list(x[0]) + [x[1], x[2]] for x in (got, want, hyb)]
    for a, b in zip(flat[0], flat[1]):
        assert a.shape == b.shape
    for ref in (flat[1], flat[2]):
        norm = [_norm_err(a, b) for a, b in zip(flat[0], ref)]
        peak = [_rel_err(a, b) for a, b in zip(flat[0], ref)]
        print("st_render_bwd norm errors:", [f"{e:.1e}" for e in norm])
        assert max(norm) <= FIELD_BWD_REL and max(peak) <= FIELD_BWD_MAX


@pytest.mark.parametrize("full", [False, True], ids=["hybrid", "fullbwd"])
def test_st_render_autograd_launches_its_kernels(cuda, monkeypatch, full):
    """fused_st_render under grad: the training forward, then the hybrid
    backward's two kernels, or with TEXPOSE_MEGA_FULLBWD=1 the fused one's
    dX chain — each followed by the dW GEMM and its reduction — and
    nothing of the two-kernel forward route."""
    from texpose_tpu_torch.kernels import composite as comp
    from texpose_tpu_torch.kernels import st_field as sf
    from texpose_tpu_torch.kernels import st_render as sr
    monkeypatch.setenv("TEXPOSE_MEGA_FULLBWD", "1" if full else "0")
    w = _weights(cuda)
    B, R, N = 2, 64, 64
    xext, encpts, light, trans, dist, depth = _render_inputs(cuda, B, R, N, 5)
    light.requires_grad_(True)
    trans.requires_grad_(True)
    params = w.head_params()
    for p in params:
        p.requires_grad_(True)
    from texpose_tpu_torch.kernels import dw_gemm as dw
    fns = (sr.st_render_fwd, sr.st_render_bwd, comp.composite_st_bwd,
           sf.st_field_bwd, sf.st_field_fwd, comp.composite_st_fwd,
           dw.dw_gemm, dw.dw_reduce)
    counts = [f.launches for f in fns]
    depth_samples = depth.reshape(B, R, N, 1)
    ray = torch.ones(B, R, 3, device=cuda)
    out = sr.fused_st_render(xext, encpts, light, trans, depth_samples, ray,
                             w, R * N)
    (out["rgb"].square().mean() + out["uncert"].mean()
     + out["trans_density_mean"]).backward()
    torch.cuda.synchronize()
    added = [f.launches - c for f, c in zip(fns, counts)]
    # both backwards end in the grouped dW GEMM and its reduction, once
    assert added == ([1, 1, 0, 0, 0, 0, 1, 1] if full
                     else [1, 0, 1, 1, 0, 0, 1, 1])
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in params + [light, trans])


def test_st_render_bwd_dw_is_the_same_run_to_run(cuda):
    """Row 6b split: dW comes from the grouped GEMM's fixed-order sums, so
    two launches on the same inputs give the same dW bits (but for layer
    0's latent rows, which come from the per-image sums; those, db and the
    latents' gradients are f32 atomics, whose order varies: held to 1e-4
    of their largest magnitude)."""
    from texpose_tpu_torch.kernels.st_render import (st_render_bwd,
                                                     st_render_fwd)
    w = _weights(cuda)
    B, R, N = 4, 64, 64
    xext, encpts, light, trans, dist, depth = _render_inputs(cuda, B, R, N, 9)
    g = torch.Generator().manual_seed(12)
    cot = (torch.randn(B * R, 16, generator=g) / (B * R)).to(cuda)
    with torch.no_grad():
        _, _, dens, _, feat = st_render_fwd(
            xext, encpts, light, trans, dist, depth, w, R * N, want_res=True)
        args = (feat, encpts, light, trans, dens, dist, cot, w, R * N)
        a, b = st_render_bwd(*args), st_render_bwd(*args)
    torch.cuda.synchronize()
    n_rgb = len(w.rgb)
    for i, (x, y) in enumerate(zip(a[0][0::2], b[0][0::2])):   # head dW
        li = i if i < n_rgb else i - n_rgb
        rows = x.shape[0] if li else 256 + (30 if i == 0 else 0)
        assert torch.equal(x[:rows], y[:rows]), i
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
    for x, y in zip(list(a[0][1::2]) + list(a[1:]),
                    list(b[0][1::2]) + list(b[1:])):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


def test_st_render_wrappers_raise_on_unsupported_input(cuda):
    from texpose_tpu_torch.kernels.st_render import (st_render_bwd,
                                                     st_render_fwd)
    w = _weights(cuda)
    xext, encpts, light, trans, dist, depth = _render_inputs(cuda, 1, 4, 16,
                                                             3)
    with pytest.raises(ValueError, match="bfloat16"):
        st_render_fwd(xext, encpts, light, trans, dist, depth, w, 64,
                      compute_dtype=torch.float32)
    # 48 samples per ray do not fit the 64-row tile whole
    d48 = torch.ones(4, 48, device=cuda)
    x48, e48, l48, t48 = _field_inputs(cuda, 1, 192, 4)
    with pytest.raises(ValueError, match="64"):
        st_render_fwd(x48, e48, l48, t48, d48, d48, w, 192)
    feat = torch.zeros(192, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="64"):
        st_render_bwd(feat, e48, l48, t48, torch.zeros(192, 1, device=cuda),
                      d48, torch.zeros(4, 16, device=cuda), w, 192)


# ------------------------- the split backwards' grouped dW GEMM (7b and 2)
#
# dw_gemm against dw_plain on the same bf16 planes: the products are exact
# in f32 on both sides and only the order of the f32 sums differs (wgmma's
# k-steps and the split partials vs one matmul), so the result agrees to
# DW_REL of the block's norm and largest magnitude.  The split partials are
# summed in a fixed order, so two launches give the same bits.

DW_REL = 1e-4


def _dw_case(device, M, seed):
    """Planes and segments covering every kind of block the two backwards
    list: 256-row hidden blocks (two 128-row tiles), a 64-column xext block,
    a 16-column block inside a ragged 80-column source, the narrow 8-column
    output / density blocks at both column offsets."""
    from texpose_tpu_torch.kernels import dw_gemm as dw
    g = torch.Generator().manual_seed(seed)

    def plane(*shape):
        return torch.randn(*shape, generator=g).to(device, torch.bfloat16)

    acts = plane(3, M, 256)
    xe = plane(M, 80)
    g_wide = plane(3, M, 256)
    g_narrow = plane(M, dw.NARROW_COLS)
    S, W, N = dw.Segment, dw.WIDE, dw.NARROW
    segs, at = [], 0
    for a, a_plane, a_col, k_in, b, b_plane, b_col, n in (
            (0, 0, 0, 256, W, 1, 0, 256), (0, 2, 0, 256, W, 2, 0, 256),
            (1, 0, 0, 64, W, 0, 0, 256), (1, 0, 64, 16, W, 1, 0, 256),
            (0, 1, 0, 256, N, 0, 0, 8), (0, 2, 0, 256, N, 0, 8, 8)):
        segs.append(S(a, a_plane, a_col, k_in, b, b_plane, b_col, n, at))
        at += k_in * n
    return [acts, xe], g_wide, g_narrow, segs, at


@pytest.mark.parametrize("M", [131072, 4096, 999])
def test_dw_gemm_matches_plain(cuda, M):
    from texpose_tpu_torch.kernels import dw_gemm as dw
    srcs, g_wide, g_narrow, segs, total = _dw_case(cuda, M, M)
    n0 = (dw.dw_gemm.launches, dw.dw_reduce.launches)
    got = dw.dw_grads(srcs, g_wide, g_narrow, segs,
                      torch.full((total,), float("nan"), device=cuda))
    again = dw.dw_grads(srcs, g_wide, g_narrow, segs,
                        torch.zeros(total, device=cuda))
    torch.cuda.synchronize()
    assert (dw.dw_gemm.launches, dw.dw_reduce.launches) == (n0[0] + 2,
                                                            n0[1] + 2)
    want = dw.dw_plain(srcs, g_wide, g_narrow, segs,
                       torch.zeros(total, device=cuda))
    assert torch.equal(got, again)
    for s in segs:
        a, b = got[s.out:s.out + s.k_in * s.n], want[s.out:s.out + s.k_in * s.n]
        print(s, f"{_norm_err(a, b):.1e} {_rel_err(a, b):.1e}")
        assert _norm_err(a, b) <= DW_REL and _rel_err(a, b) <= DW_REL, s


def test_dw_reduce_matches_plain(cuda):
    from texpose_tpu_torch.kernels import dw_gemm as dw
    segs = [dw.Segment(0, 0, 0, 48, dw.WIDE, 0, 0, 256, 0),
            dw.Segment(0, 0, 0, 256, dw.NARROW, 0, 8, 8, 48 * 256)]
    prob = torch.tensor(dw.problems(segs), dtype=torch.int32, device=cuda)
    g = torch.Generator().manual_seed(5)
    partial = torch.randn(prob.shape[0], 7, dw.TILE_I, dw.TILE_N,
                          generator=g).to(cuda)
    total = 48 * 256 + 256 * 8
    n0 = dw.dw_reduce.launches
    got = dw.dw_reduce(partial, prob, torch.full((total + 3,), 7.0,
                                                 device=cuda))
    torch.cuda.synchronize()
    assert dw.dw_reduce.launches == n0 + 1
    want = dw.dw_reduce_plain(partial, prob, torch.full((total + 3,), 7.0,
                                                        device=cuda))
    assert float((got - want).abs().max()) <= 1e-5
    assert (got[-3:] == 7.0).all()


def test_field_bwds_launch_the_split_kernels(cuda):
    """Both field backwards on the card: the dX-chain kernel, then the
    grouped dW GEMM and its reduction, once each per call."""
    from texpose_tpu_torch.kernels import dw_gemm as dw
    from texpose_tpu_torch.kernels.coarse_field import (coarse_field_bwd,
                                                        coarse_render_fwd)
    fns = (coarse_field_bwd, st_field_bwd, dw.dw_gemm, dw.dw_reduce)
    w = _coarse_weights(cuda, True)
    xext, ep, dist, depth = _coarse_inputs(cuda, 64, 64, True, 8)
    M = xext.shape[0]
    counts = [f.launches for f in fns]
    with torch.no_grad():
        _, _, _, (xe, acts) = coarse_render_fwd(xext, ep, dist, depth, w,
                                                want_res=True)
        coarse_field_bwd(xext, ep, xe, acts, w, torch.ones(M, 3, device=cuda),
                         torch.ones(M, 1, device=cuda))
        sw = _weights(cuda)
        x2, e2, l2, t2 = _field_inputs(cuda, 2, 2048, 3)
        *_, feat = st_field_fwd(x2, e2, l2, t2, sw, 2048, want_feat=True)
        st_field_bwd(feat, e2, l2, t2, sw, 2048,
                     torch.ones(4096, 3, device=cuda),
                     torch.ones(4096, 5, device=cuda))
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(fns, counts)] == [1, 1, 2, 2]


@pytest.mark.parametrize("over", [{"kernels.fused_composite": False},
                                  {"arch.density_activ": "relu"}],
                         ids=["fused_composite_off", "density_relu"])
def test_field_kernel_route_launches_under_plain_composite(cuda, over):
    """The texture model's render under grad at the full width of
    configs/nerf_lm_adapt_gan.yaml where the composite kernel's gate is off
    but the field kernels' holds (JAX's apply_nerf_st → apply_nerf_st_fused):
    rows 1 and 2 (with the grouped dW GEMM) launch once each, no composite
    kernel, and the heads and latents get finite gradients."""
    import os
    from texpose_tpu_torch.kernels import composite as comp
    from texpose_tpu_torch.kernels import dw_gemm as dw
    from texpose_tpu_torch.kernels import st_field as sf
    from texpose_tpu_torch.models.render import render_st_core
    from texpose_tpu_torch.nn.fields import init_nerf_st, use_fused_st
    from texpose_tpu_torch.utils.config import load_yaml, process_options
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = process_options(load_yaml(os.path.join(
        root, "configs", "nerf_lm_adapt_gan.yaml")))
    cfg.kernels = {"st_mega": False}
    for key, value in over.items():
        part, name = key.split(".")
        cfg[part][name] = value
    nerf = init_nerf_st(cfg, torch.Generator().manual_seed(0)).to(cuda)
    assert use_fused_st(cfg, nerf)
    B, R = 2, 64
    g = torch.Generator().manual_seed(1)
    center = torch.zeros(B, R, 3)
    center[..., 2] = -4.0
    ray = torch.randn(B, R, 3, generator=g) * 0.05
    ray[..., 2] = 1.0
    near = torch.full((B, R), 3.4)
    lt = torch.randn(B, int(cfg.nerf.N_latent_trans), generator=g)
    ll = torch.randn(B, int(cfg.nerf.N_latent_light), generator=g)
    center, ray, near, lt, ll = (t.to(cuda) for t in (center, ray, near, lt,
                                                      ll))
    lt.requires_grad_(True)
    ll.requires_grad_(True)
    fns = (sf.st_field_fwd, sf.st_field_bwd, dw.dw_gemm,
           comp.composite_st_fwd, comp.composite_st_bwd)
    counts = [f.launches for f in fns]
    out = render_st_core(nerf, cfg, center, ray, near, near + 1.2, lt, ll,
                         progress=1.0, training=True)
    (out["rgb"].square().mean() + out["trans_density_mean"]).backward()
    torch.cuda.synchronize()
    assert [f.launches - c for f, c in zip(fns, counts)] == [1, 1, 1, 0, 0]
    heads = list(nerf.mlp_rgb.parameters()) + list(nerf.mlp_trans.parameters())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in heads + [lt, ll])
    assert all(p.grad is None for p in nerf.mlp_feat.parameters())


# ------------------ the wgmma + TMA field forwards' tile (rows 1, 6f, 7a, 8)
#
# A 128-row tile of two 64-row warpgroups: M below 128, M ≡ 64 (mod 128)
# (the last tile's second warpgroup has no row in range), ragged tiles,
# image boundaries inside one tile, 2-layer heads, the N = 32 and N = 64
# composite epilogues.  Bounds as above.  The residual planes are ReLU
# outputs in the backwards' [M, 256] layout: no negative value, and their
# ReLU mask is the twin's except where a bf16 rounding at zero flips a unit
# (|value| ≤ 2e-2 on both sides, at most 1e-4 of the units).


def _mask_agrees(got, ref):
    got = got.float()
    assert float(got.min()) >= 0.0
    flip = (got > 0) != (ref > 0)
    assert float(flip.float().mean()) <= 1e-4
    assert float((got.abs() * flip).max()) <= 2e-2
    assert float((ref.abs() * flip).max()) <= 2e-2


def _feat_close(got, ref):
    e = (got.float() - ref).abs()
    assert float((e / ref.abs().clamp(min=1.0)).max()) <= 3e-2
    assert float(e.mean()) <= 1e-3


@pytest.mark.parametrize("B,rows_per_img,n_head", [
    (1, 100, 4), (2, 96, 4), (5, 40, 4), (3, 333, 2)],
    ids=["M<128", "M=64mod128", "images-in-one-tile", "ragged-2-layer"])
def test_st_field_fwd_tile_edges(cuda, B, rows_per_img, n_head):
    w = _weights(cuda, n_head=n_head)
    args = (*_field_inputs(cuda, B, rows_per_img, B * rows_per_img), w,
            rows_per_img)
    with torch.inference_mode():
        n0 = st_field_fwd.launches
        out = st_field_fwd(*args, want_feat=True)
        torch.cuda.synchronize()
        assert st_field_fwd.launches == n0 + 1
        ref = st_field_plain(*args, want_feat=True)
    for a, b in zip(out[:3], ref[:3]):
        assert a.shape == b.shape
        err = (a - b).abs()
        assert float(err.max()) <= 3e-2 and float(err.mean()) <= 1e-3
    assert out[3].shape == (B * rows_per_img, 256)
    _feat_close(out[3], ref[3])
    _mask_agrees(out[3], ref[3])


@pytest.mark.parametrize("BR,N,n_head", [(37, 64, 2), (301, 32, 2),
                                         (3, 32, 4)],
                         ids=["N64-M=64mod128", "N32-ragged", "N32-M<128"])
def test_coarse_fwd_tile_edges(cuda, BR, N, n_head):
    """Rows 8 and 7a on one set of inputs: the composite epilogue at N = 64
    and 32, the residual planes (n_trunk + n_rgb - 1 of them) against the
    twin's activations and ReLU masks, one launch per call."""
    from texpose_tpu_torch.kernels.coarse_field import (coarse_field_fwd,
                                                        coarse_render_fwd,
                                                        coarse_render_plain)
    w = _coarse_weights(cuda, True, n_head=n_head)
    xext, ep, dist, depth = _coarse_inputs(cuda, BR, N, True, BR * N)
    with torch.no_grad():
        n0, f0 = coarse_render_fwd.launches, coarse_field_fwd.launches
        got, rgb, dens, (_, acts) = coarse_render_fwd(
            xext, ep, dist, depth, w, want_res=True)
        f_rgb, f_dens, (_, f_acts) = coarse_field_fwd(xext, ep, w,
                                                      want_res=True)
        torch.cuda.synchronize()
        assert coarse_render_fwd.launches == n0 + 1
        assert coarse_field_fwd.launches == f0 + 1
        ref, rgb_ref, dens_ref, acts_ref = coarse_render_plain(
            xext, ep, dist, depth, w, want_res=True)
    assert acts.shape == (8 + n_head - 1, BR * N, 256)
    assert torch.equal(rgb, f_rgb) and torch.equal(dens, f_dens)
    assert torch.equal(acts, f_acts)
    assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= 2e-2
    for a, b in ((rgb, rgb_ref), (dens, dens_ref)):
        err = (a - b).abs()
        assert float(err.max()) <= 3e-2 and float(err.mean()) <= 1e-3
    for a, b in zip(acts, acts_ref):
        _feat_close(a, b)
        _mask_agrees(a, b)


@pytest.mark.parametrize("B,R,N,n_head", [(3, 3, 32, 2), (2, 3, 64, 4)],
                         ids=["N32-2-layer", "N64"])
def test_st_render_fwd_tile_edges(cuda, B, R, N, n_head):
    """Row 6f with image boundaries inside a 128-row tile (96 and 192 rows
    per image), a ragged last tile, 2-layer heads, N = 32 and 64."""
    from texpose_tpu_torch.kernels.st_render import (st_render_fwd,
                                                     st_render_plain)
    w = _weights(cuda, n_head=n_head)
    args = (*_render_inputs(cuda, B, R, N, B * R * N), w, R * N)
    with torch.no_grad():
        n0 = st_render_fwd.launches
        got, rgb, dens, tr, feat = st_render_fwd(*args, want_res=True)
        torch.cuda.synchronize()
        assert st_render_fwd.launches == n0 + 1
        ref, rgb_ref, dens_ref, tr_ref, feat_ref = st_render_plain(
            *args, want_res=True)
        epi = composite_st_plain(rgb, tr, dens, args[5], args[4], 0.05)
    assert float((got - epi).abs().max()) <= 1e-4
    assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= \
        RENDER_REL
    for a, b in ((rgb, rgb_ref), (dens, dens_ref), (tr, tr_ref)):
        e = (a - b).abs()
        assert float(e.max()) <= 3e-2 and float(e.mean()) <= 1e-3
    _feat_close(feat, feat_ref)
    _mask_agrees(feat, feat_ref)

