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


def _weights(device, seed=0):
    """The shipped config's field: 8x256 trunk, skip at 4, L_3D=10,
    L_view=4, 48/16-d latents."""
    g = torch.Generator().manual_seed(seed)

    def layer(i, o, mode=None):
        return Dense(*dense_init(g, i, o, mode)).to(device)

    trunk = ([layer(63, 256)] + [layer(256, 256) for _ in range(3)]
             + [layer(256 + 63, 256)] + [layer(256, 256) for _ in range(2)]
             + [layer(256, 257, "first")])
    rgb = [layer(256 + 27 + 3 + 48, 256), layer(256, 256), layer(256, 256),
           layer(256, 3, "all")]
    trans = [layer(256 + 16, 256), layer(256, 256), layer(256, 256),
             layer(256, 5, "all")]
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


def _coarse_weights(device, view_dep, seed=0):
    """The shipped pretrain field: 8x256 trunk with skip at 4, L_3D 10, RGB
    head 256-256-256-3 on feat ⊕ (27-wide view encoding) ⊕ pts."""
    from texpose_tpu_torch.kernels.coarse_field import CoarseFieldWeights
    g = torch.Generator().manual_seed(seed)

    def layer(i, o, mode=None):
        return Dense(*dense_init(g, i, o, mode)).to(device)

    trunk = ([layer(63, 256)] + [layer(256, 256) for _ in range(3)]
             + [layer(256 + 63, 256)] + [layer(256, 256) for _ in range(2)]
             + [layer(256, 257, "first")])
    e3 = 30 if view_dep else 3
    rgb = [layer(256 + e3, 256), layer(256, 256), layer(256, 256),
           layer(256, 3, "all")]
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
                                           (301, 32, True)])
def test_coarse_field_bwd_kernel_matches_plain(cuda, BR, N, view_dep):
    from texpose_tpu_torch.kernels.coarse_field import (
        coarse_field_bwd, coarse_field_bwd_plain, coarse_render_fwd)
    w = _coarse_weights(cuda, view_dep)
    xext, ep, dist, depth = _coarse_inputs(cuda, BR, N, view_dep, 3)
    M = BR * N
    g = torch.Generator().manual_seed(9)
    g_rgb = (torch.randn(M, 3, generator=g) / M).to(cuda)
    g_dens = (torch.randn(M, 1, generator=g) / M).to(cuda)
    with torch.no_grad():
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
