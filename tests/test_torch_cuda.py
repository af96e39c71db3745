"""The hand-written CUDA kernels against their plain-PyTorch twins, on the
card (marked ``cuda``, skipped without one; run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``).

ST field: both sides round every matmul operand to bf16 and accumulate in
f32, but sum in different orders, which can flip an activation's bf16
rounding (2^-8 relative) and the flip propagates: max |err| ≤ 3e-2 at
outputs of magnitude ≲ 4, mean |err| ≤ 1e-3.  Composite: float32 on both
sides, 1e-4 covers the summation order.
"""

import pytest
import torch

from texpose_tpu_torch.kernels.composite import (composite_st_fwd,
                                                 composite_st_plain)
from texpose_tpu_torch.kernels.st_field import (STFieldWeights, make_xext,
                                                st_field_fwd, st_field_plain)
from texpose_tpu_torch.nn.init import dense_init
from texpose_tpu_torch.nn.mlp import Dense
from texpose_tpu_torch.ops.render import _dists

pytestmark = pytest.mark.cuda


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
