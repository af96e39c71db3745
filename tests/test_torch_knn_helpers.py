"""The port's KNN (texpose_tpu_torch/ops/knn.py) and the helpers that no
engine calls, each against its JAX counterpart on seeded numpy inputs:

  * knn_points: equal indices, including JAX's lower index among tied
    distances (duplicated y points and x points equal to y points) and the
    padding masks; distances, knn_gather, p2p_distance (every reduction)
    and chamfer_distance at rtol 1e-5 (f32, the same ‖x‖²−2x·y+‖y‖² form;
    only the order of the dot products' sums may differ);
  * the losses l1_loss, point_loss, uncertainty_render_loss and
    transient_reg_loss, psnr with a broadcast mask, linear_to_srgb, the
    patch grids, get_image, grid_sample_table, perceptual_loss and
    leaky_relu at rtol 1e-5 (bit-equal where no sum is reordered);
  * conv_init held to JAX's shape and bound (its draws are torch's own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texpose_tpu.ops import knn as jknn
from texpose_tpu_torch.ops import knn as tknn

RTOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _points(seed, B=2, P1=40, P2=30, D=3):
    """x, y with ties: y[:, 10:20] duplicates y[:, :10], and x[:, :5]
    equals y[:, 12:17] (nearest at distance 0 twice: 2..6 and 12..16)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, P1, D)).astype(np.float32)
    y = rng.normal(size=(B, P2, D)).astype(np.float32)
    y[:, 10:20] = y[:, :10]
    x[:, :5] = y[:, 12:17]
    return x, y


def _masks(kind, B=2, P1=40, P2=30):
    rng = np.random.default_rng(7)
    xm = rng.random((B, P1)) > 0.3 if kind in ("x", "both") else None
    ym = rng.random((B, P2)) > 0.3 if kind in ("y", "both") else None
    if ym is not None:
        ym[:, :20] = True          # keep the duplicated points
    return xm, ym


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("mask", ["none", "x", "y", "both"])
def test_knn_points_matches_jax_with_ties(K, mask):
    x, y = _points(K)
    xm, ym = _masks(mask)
    jd, ji = jknn.knn_points(jnp.asarray(x), jnp.asarray(y), K=K,
                             x_mask=None if xm is None else jnp.asarray(xm),
                             y_mask=None if ym is None else jnp.asarray(ym))
    td, ti = tknn.knn_points(_t(x), _t(y), K=K,
                             x_mask=None if xm is None else _t(xm),
                             y_mask=None if ym is None else _t(ym))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=1e-6)
    if mask in ("none", "y"):
        # tied neighbours come lower index first, as jax.lax.top_k's
        first = ti.numpy()[:, :5]
        np.testing.assert_array_equal(first[..., 0],
                                      np.arange(2, 7)[None].repeat(2, 0))
        if K > 1:
            np.testing.assert_array_equal(
                first[..., 1], np.arange(12, 17)[None].repeat(2, 0))
    feats = np.random.default_rng(1).normal(size=(2, 30, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tknn.knn_gather(_t(feats), ti).numpy(),
        np.asarray(jknn.knn_gather(jnp.asarray(feats), ji)))


def test_pairwise_sqdist_matches_jax():
    x, y = _points(3)
    got = tknn.pairwise_sqdist(_t(x), _t(y)).numpy()
    want = np.asarray(jknn.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert (got >= 0).all()


@pytest.mark.parametrize("batch_reduction", ["mean", "sum", None])
@pytest.mark.parametrize("point_reduction", ["mean", "sum"])
@pytest.mark.parametrize("mask", ["none", "both"])
def test_p2p_and_chamfer_match_jax(batch_reduction, point_reduction, mask):
    x, y = _points(5)
    xm, ym = _masks(mask)
    jm = [None if m is None else jnp.asarray(m) for m in (xm, ym)]
    tm = [None if m is None else _t(m) for m in (xm, ym)]
    got, none = tknn.p2p_distance(_t(x), _t(y), *tm,
                                  batch_reduction=batch_reduction,
                                  point_reduction=point_reduction)
    want, _ = jknn.p2p_distance(jnp.asarray(x), jnp.asarray(y), *jm,
                                batch_reduction=batch_reduction,
                                point_reduction=point_reduction)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    np.testing.assert_allclose(
        tknn.chamfer_distance(_t(x), _t(y), *tm).numpy(),
        np.asarray(jknn.chamfer_distance(jnp.asarray(x), jnp.asarray(y),
                                         *jm)), rtol=RTOL)


def test_losses_match_jax():
    from texpose_tpu.models import losses as jl
    from texpose_tpu_torch.models import losses as tl
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(2, 64, 3)).astype(np.float32) for _ in "ab")
    mask = (rng.random((2, 64, 1)) > 0.4).astype(np.float32)
    unc = (rng.random((2, 64, 1)) + 0.05).astype(np.float32)
    dens = rng.random((2, 64, 16, 2)).astype(np.float32)
    cases = [
        (tl.l1_loss(_t(a), _t(b)), jl.l1_loss(a, b)),
        (tl.l1_loss(_t(a)), jl.l1_loss(a)),
        (tl.point_loss(_t(a), _t(b), _t(mask)), jl.point_loss(a, b, mask)),
        (tl.uncertainty_render_loss(_t(a), _t(b), _t(unc), _t(mask)),
         jl.uncertainty_render_loss(a, b, unc, mask)),
        (tl.transient_reg_loss(_t(dens)), jl.transient_reg_loss(dens))]
    for i, (got, want) in enumerate(cases):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, err_msg=str(i))
    # point_loss passes no gradient through its median scale
    pa = _t(a).requires_grad_(True)
    tl.point_loss(pa, _t(b), _t(mask)).backward()
    jg = jax.grad(lambda p: jl.point_loss(p, b, mask))(jnp.asarray(a))
    np.testing.assert_allclose(pa.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("mask_shape", [None, (6, 5, 1), (6, 5, 3)])
def test_psnr_matches_jax(mask_shape):
    from texpose_tpu.utils.metrics import psnr as jpsnr
    from texpose_tpu_torch.utils.metrics import psnr as tpsnr
    rng = np.random.default_rng(1)
    a, b = (rng.random((6, 5, 3), dtype=np.float32) for _ in "ab")
    m = None if mask_shape is None else \
        (rng.random(mask_shape) > 0.5).astype(np.float32)
    got = tpsnr(_t(a), _t(b), None if m is None else _t(m))
    want = jpsnr(a, b, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_linear_to_srgb_matches_jax():
    from texpose_tpu.ops.color import linear_to_srgb as j
    from texpose_tpu_torch.ops.color import linear_to_srgb as t
    x = np.concatenate([np.linspace(-0.5, 1.5, 401, dtype=np.float32),
                        np.float32([0.0031308, 0.0, 1.0])])
    np.testing.assert_allclose(t(_t(x)).numpy(), np.asarray(j(x)),
                               rtol=RTOL, atol=1e-7)


def test_patch_grids_and_get_image_match_jax():
    from texpose_tpu.sampling import patch as jp
    from texpose_tpu.sampling.ray_sampler import get_image as jget
    from texpose_tpu_torch.sampling import patch as tp
    from texpose_tpu_torch.sampling import get_image as tget
    np.testing.assert_allclose(tp.base_grid(7).numpy(),
                               np.asarray(jp._base_grid(7)), atol=1e-7)
    tc, ts = tp.full_image_coords(2, 5, 9)
    jc, js = jp.full_image_coords(2, 5, 9)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tc, ts = tp.rescale_patch_coords(3, 4, scale=0.5)
    jc, js = jp.rescale_patch_coords(3, 4, scale=0.5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-7)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tc.shape == (3, 4, 4, 2) and ts.shape == (3, 1, 1, 1)
    img = np.random.default_rng(2).random((3, 3, 11, 13), dtype=np.float32)
    np.testing.assert_allclose(tget(tc, _t(img)).numpy(),
                               np.asarray(jget(jc, img)), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_table_matches_jax(mode, align_corners):
    from texpose_tpu.ops.grid_sample import grid_sample_table as j
    from texpose_tpu_torch.ops import grid_sample_table as t
    rng = np.random.default_rng(3)
    images = rng.random((5, 3, 9, 12), dtype=np.float32)
    idx = np.array([4, 0, 4], np.int32)
    grid = rng.uniform(-1.1, 1.1, (3, 4, 6, 2)).astype(np.float32)
    got = t(_t(images), torch.as_tensor(idx, dtype=torch.long), _t(grid),
            mode, align_corners)
    want = j(jnp.asarray(images), jnp.asarray(idx), jnp.asarray(grid), mode,
             align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("loss_type", ["l1", "l2", "both"])
def test_perceptual_loss_matches_jax(loss_type):
    from texpose_tpu.nn.vgg import init_vgg19, perceptual_loss as j
    from texpose_tpu_torch.nn import perceptual_loss as t
    from texpose_tpu_torch.nn.vgg import vgg_from_jax
    params = init_vgg19(jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    fake, real = (rng.random((2, 3, 16, 16), dtype=np.float32) for _ in "fr")
    tf = _t(fake).requires_grad_(True)
    tr = _t(real).requires_grad_(True)
    got = t(vgg_from_jax(params), tf, tr, loss_type)
    got.backward()
    want = j(params, jnp.asarray(fake), jnp.asarray(real), loss_type)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4)
    assert tr.grad is None or not tr.grad.any()
    with pytest.raises(NotImplementedError):
        t(vgg_from_jax(params), tf, tr, "l3")


def test_leaky_relu_and_conv_init():
    from texpose_tpu.nn import conv_init as jconv, leaky_relu as jlr
    from texpose_tpu_torch.nn import conv_init, leaky_relu
    x = np.float32([-3.0, -0.5, 0.0, -0.0, 0.25, 4.0])
    np.testing.assert_array_equal(leaky_relu(_t(x)).numpy(),
                                  np.asarray(jlr(x)))
    np.testing.assert_array_equal(leaky_relu(_t(x), 0.1).numpy(),
                                  np.asarray(jlr(x, 0.1)))
    g = torch.Generator().manual_seed(0)
    for gain in (None, 1.0, 2.0):
        w = conv_init(g, 4, 4, 32, 64, gain)["w"]
        jw = np.asarray(jconv(jax.random.PRNGKey(0), 4, 4, 32, 64,
                              gain)["w"])
        assert tuple(w.shape) == jw.shape == (4, 4, 32, 64)
        assert w.dtype == torch.float32
        if gain is None:
            assert abs(float(w.std()) - 0.02) < 1e-3
        else:
            bound = gain * np.sqrt(6.0 / (16 * 32 + 16 * 64))
            assert float(w.abs().max()) <= bound
            assert float(w.abs().max()) > 0.99 * bound
            assert np.abs(jw).max() <= bound * (1 + 1e-6)
