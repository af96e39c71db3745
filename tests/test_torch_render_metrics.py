"""Port parity, chunked rendering and the eval metrics: texpose_tpu_torch
against texpose_tpu on the same numpy inputs and bridged parameters.

Tolerances: float32 throughout; 1e-5 where only summation order differs
on values of order 1, 1e-4 on rendered leaves that include depth (values
up to ~6 here) and the 16-sample quadrature."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.models import render as jrender
from texpose_tpu.nn.fields import init_nerf_st as jinit
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from texpose_tpu_torch.models import render as trender
from texpose_tpu_torch.nn.fields import init_nerf_st
from texpose_tpu_torch.utils.checkpoint import jax_state_to_torch
from test_texture_gan_e2e import tiny_gan_cfg

H, W = 12, 16


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    cfg = tiny_gan_cfg("unused", tmp_path_factory.mktemp("cfg"))
    cfg.H, cfg.W = H, W
    cfg.nerf.rand_rays = 16
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.concatenate([q, [[0.1], [-0.2], [4.0]]], 1)[None]
    intr = np.array([[[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]]])
    z_near = rng.uniform(2.5, 3.5, size=(1, H * W))
    z_far = z_near + rng.uniform(1.0, 2.0, size=(1, H * W))
    obj = (rng.random(H * W) < 0.2).astype(np.float32)
    f32 = {k: np.asarray(v, np.float32) for k, v in dict(
        pose=pose, intr=intr, z_near=z_near, z_far=z_far, obj=obj).items()}
    jparams = jinit(jax.random.PRNGKey(2), cfg)
    nerf = init_nerf_st(cfg)
    state = jax_state_to_torch(tree_to_flat_dict({"params": {"nerf":
                                                             jparams}}))
    nerf.load_state_dict({k[5:]: v for k, v in state.items()})
    lt = rng.normal(size=(1, 8)).astype(np.float32)
    ll = rng.normal(size=(1, 12)).astype(np.float32)
    return cfg, f32, jparams, nerf, lt, ll


def _t(x):
    return torch.from_numpy(np.array(x))


def test_gather_rays_matches_jax(scene):
    cfg, f, *_ = scene
    idx = np.random.default_rng(0).integers(0, H * W, size=(1, 40))
    ref = jrender.gather_rays(jnp.asarray(f["pose"]), jnp.asarray(f["intr"]),
                              jnp.asarray(idx), jnp.asarray(f["z_near"]),
                              jnp.asarray(f["z_far"]), H, W)
    got = trender.gather_rays(_t(f["pose"]), _t(f["intr"]), _t(idx),
                              _t(f["z_near"]), _t(f["z_far"]), H, W)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_masked_render_and_scatter_match_jax(scene):
    """render_rays_masked_st_pre (host-pre-gathered bounds, two chunks)
    then scatter_masked_st: the port's kernel route (plain twins on the
    CPU) against the JAX plain route."""
    cfg, f, jparams, nerf, lt, ll = scene
    idx_p, n = trender.masked_ray_indices(f["obj"], cfg.nerf.rand_rays)
    ji, _ = jrender.masked_ray_indices(f["obj"], cfg.nerf.rand_rays)
    np.testing.assert_array_equal(idx_p, ji)
    assert len(idx_p) % cfg.nerf.rand_rays == 0 and n == int(f["obj"].sum())
    zn, zf = f["z_near"][:, idx_p], f["z_far"][:, idx_p]
    ref = jrender.render_rays_masked_st_pre(
        jparams, cfg, jnp.asarray(f["pose"]), jnp.asarray(f["intr"]),
        jnp.asarray(idx_p), jnp.asarray(zn), jnp.asarray(zf),
        jnp.asarray(lt), jnp.asarray(ll), jax.random.PRNGKey(0),
        progress=jnp.asarray(1.0), chunk=cfg.nerf.rand_rays)
    with torch.no_grad():
        got = trender.render_rays_masked_st_pre(
            nerf, cfg, _t(f["pose"]), _t(f["intr"]), _t(idx_p), _t(zn),
            _t(zf), _t(lt), _t(ll), progress=1.0,
            compute_dtype=torch.float32, chunk=cfg.nerf.rand_rays)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)
    out = {k: np.asarray(v) for k, v in ref.items()}
    jfull = jrender.scatter_masked_st(cfg, {k: jnp.asarray(v)
                                            for k, v in out.items()},
                                      jnp.asarray(idx_p), n,
                                      jnp.asarray(f["obj"]))
    tfull = trender.scatter_masked_st(cfg, {k: _t(v) for k, v in out.items()},
                                      _t(idx_p), _t(f["obj"]))
    for k in out:
        np.testing.assert_array_equal(tfull[k].numpy(), np.asarray(jfull[k]))


def test_full_frame_render_matches_masked_on_object(scene):
    """The whole-frame route (dense frames) agrees with the masked route on
    object pixels and holds the defaults elsewhere."""
    cfg, f, _, nerf, lt, ll = scene
    args = (_t(f["pose"]), _t(f["intr"]))
    idx_p, _ = trender.masked_ray_indices(f["obj"], cfg.nerf.rand_rays)
    obj = _t(f["obj"])[None]
    with torch.no_grad():
        full = trender.render_full_nerf_st(
            nerf, cfg, *args, _t(f["z_near"]), _t(f["z_far"]), _t(lt),
            _t(ll), progress=1.0, compute_dtype=torch.float32,
            obj_mask=obj)
        part = trender.render_rays_masked_st_pre(
            nerf, cfg, *args, _t(idx_p), _t(f["z_near"][:, idx_p]),
            _t(f["z_far"][:, idx_p]), _t(lt), _t(ll), progress=1.0,
            compute_dtype=torch.float32)
        masked = trender.scatter_masked_st(cfg, part, _t(idx_p), obj)
    for k in ("rgb_static", "rgb", "uncert", "depth", "opacity_static"):
        np.testing.assert_allclose(masked[k].numpy(), full[k].numpy(),
                                   atol=1e-5, err_msg=k)


def test_ssim_psnr_resize_match_jax():
    import cv2
    from texpose_tpu.ops.image import resize_bilinear as jresize
    from texpose_tpu.ops.ssim import ssim as jssim
    from texpose_tpu.utils.metrics import mse_to_psnr as jpsnr
    from texpose_tpu_torch.ops.image import resize_bilinear
    from texpose_tpu_torch.ops.ssim import ssim
    from texpose_tpu_torch.utils.metrics import mse_to_psnr
    rng = np.random.default_rng(1)
    a = rng.random((2, 3, 30, 41)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1
                ).astype(np.float32)
    np.testing.assert_allclose(float(ssim(_t(a), _t(b))),
                               float(jssim(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)
    np.testing.assert_allclose(
        ssim(_t(a), _t(b), size_average=False).numpy(),
        np.asarray(jssim(jnp.asarray(a), jnp.asarray(b),
                         size_average=False)), atol=1e-6)
    mse = float(((a - b) ** 2).mean())
    np.testing.assert_allclose(float(mse_to_psnr(mse)), float(jpsnr(mse)),
                               rtol=1e-6)
    img = a[0].transpose(1, 2, 0)
    got = resize_bilinear(_t(img), (61, 77)).numpy()
    np.testing.assert_allclose(got, np.asarray(jresize(jnp.asarray(img),
                                                       (61, 77))), atol=1e-6)
    np.testing.assert_allclose(
        got, cv2.resize(img, (77, 61), interpolation=cv2.INTER_LINEAR),
        atol=1e-5)


def test_lpips_matches_jax_on_converted_weights():
    """JAX's (HWIO) LPIPS parameters converted to OIHW give the same
    distances; the port's own seeded init is deterministic."""
    from texpose_tpu.nn.lpips import ALEX_CONVS
    from texpose_tpu.nn.lpips import lpips_distance as jlpips
    from texpose_tpu_torch.nn.lpips import (from_jax, init_lpips,
                                            lpips_distance)
    wr = np.random.default_rng(4)
    jp = {"convs": [{"w": jnp.asarray(wr.normal(
                         scale=(2.0 / (k * k * ci)) ** 0.5,
                         size=(k, k, ci, co)).astype(np.float32)),
                     "b": jnp.asarray(wr.normal(scale=0.01, size=co)
                                      .astype(np.float32))}
                    for k, ci, co, _, _ in ALEX_CONVS],
          "lins": [jnp.asarray(wr.random(c[2]).astype(np.float32))
                   for c in ALEX_CONVS]}
    rng = np.random.default_rng(2)
    x = (rng.random((2, 3, 48, 56)) * 2 - 1).astype(np.float32)
    y = (rng.random((2, 3, 48, 56)) * 2 - 1).astype(np.float32)
    ref = np.asarray(jlpips(jp, jnp.asarray(x), jnp.asarray(y)))
    got = lpips_distance(from_jax(jp), _t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)
    p1 = init_lpips(torch.Generator().manual_seed(0))
    p2 = init_lpips(torch.Generator().manual_seed(0))
    d1 = lpips_distance(p1, _t(x), _t(y))
    assert torch.equal(d1, lpips_distance(p2, _t(x), _t(y)))
    assert (d1 > 0).all() and float(lpips_distance(p1, _t(x), _t(x)).max()) \
        < 1e-6
