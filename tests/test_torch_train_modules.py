"""Port parity of the train step's smaller modules, each against its JAX
function on the same numpy inputs (and the same random numbers, drawn
with the JAX package's own key splits where it draws them): patch
coordinates, patch rays and bounds, grid sampling, stratified depth, Lab,
the losses, VGG features (f32 and bf16), the discriminator with its
spectral norm and R1 input gradient, and the optimizer schedules.
Float32: 1e-5 relative unless a test says otherwise."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.utils.config import Config, process_options
from test_texture_gan_e2e import tiny_gan_cfg

RTOL = 1e-5


def _close(a, b, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.mark.parametrize("it", [0, 3000, 20000])
def test_flex_patch_coords(it):
    from texpose_tpu.sampling.patch import flex_patch_coords as jfpc
    from texpose_tpu_torch.sampling.patch import flex_patch_coords
    key = jax.random.PRNGKey(it + 1)
    cj, sj = jfpc(key, 4, 16, iteration=it)
    ks = jax.random.split(key, 3)
    u = np.stack([np.asarray(jax.random.uniform(k, (4, 1, 1, 1)))
                  for k in ks])
    ct, st = flex_patch_coords(_t(u), 16, iteration=it)
    _close(st, sj)
    _close(ct, cj)


def test_patch_rays_and_bounds():
    from texpose_tpu.sampling import ray_sampler as jrs
    from texpose_tpu_torch.sampling import ray_sampler as trs
    rng = np.random.default_rng(0)
    B, H, W = 2, 12, 10
    coords = rng.uniform(-1, 1, size=(B, 4, 4, 2)).astype(np.float32)
    intr = np.array([[[20., 0, 5], [0, 21., 6], [0, 0, 1]]] * B, np.float32)
    pose = np.concatenate([np.eye(3)[None].repeat(B, 0),
                           rng.normal(size=(B, 3, 1))], -1).astype(np.float32)
    zn = rng.uniform(1, 2, size=(B, H * W)).astype(np.float32)
    zf = zn + 1
    cj, rj = jrs.get_rays(intr, coords, pose, H, W)
    ct, rt = trs.get_rays(_t(intr), _t(coords), _t(pose), H, W)
    _close(ct, cj)
    _close(rt, rj)
    for a, b in zip(trs.get_bounds(_t(coords), _t(zn), _t(zf), H, W),
                    jrs.get_bounds(coords, zn, zf, H, W)):
        _close(a, b)


@pytest.mark.parametrize("mode,align", [("bilinear", True),
                                        ("bilinear", False),
                                        ("nearest", False)])
def test_grid_sample(mode, align):
    from texpose_tpu.ops.grid_sample import grid_sample as jgs
    from texpose_tpu_torch.ops.grid_sample import grid_sample
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 3, 9, 11)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(2, 5, 6, 2)).astype(np.float32)
    # exact half-pixel positions: both round half to even
    grid[0, 0, 0] = [-1 + 1.0 / 11, -1 + 1.0 / 9]
    _close(grid_sample(_t(img), _t(grid), mode, align),
           jgs(img, grid, mode, align))


def test_stratified_depth():
    from texpose_tpu.ops.render import sample_depth as jsd
    from texpose_tpu_torch.ops.render import sample_depth
    rng = np.random.default_rng(2)
    near = rng.uniform(1, 2, size=(2, 5)).astype(np.float32)
    far = near + 1.5
    key = jax.random.PRNGKey(4)
    dj = jsd(key, near, far, 8, stratified=True)
    u = np.asarray(jax.random.uniform(key, (2, 5, 8, 1)))
    _close(sample_depth(_t(near), _t(far), 8, rand=_t(u)), dj)


def test_lab_loss():
    from texpose_tpu.models.losses import lab_loss as jlab
    from texpose_tpu_torch.models.losses import lab_loss
    rng = np.random.default_rng(3)
    fake = rng.uniform(0, 1, size=(2, 3, 6, 6)).astype(np.float32)
    real = rng.uniform(0, 1, size=(2, 3, 6, 6)).astype(np.float32)
    fake[0, :, 0, 0] = 0.0                        # the linear branch
    mask = (rng.uniform(size=(2, 1, 6, 6)) > 0.3).astype(np.float32)
    tf = _t(fake).requires_grad_(True)
    lt, fv, rv = lab_loss(tf, _t(real), _t(mask))
    lj, fvj, rvj = jlab(fake, real, mask)
    _close(lt.detach(), lj)
    _close(fv, fvj, rtol=1e-4, atol=1e-5)
    _close(rv, rvj, rtol=1e-4, atol=1e-5)
    lt.backward()
    # at an exactly-zero channel JAX's gradient is NaN (the unselected
    # power branch of its where); the port clamps that branch: finite
    assert torch.isfinite(tf.grad).all()
    fake[0, :, 0, 0] = 0.5
    tf = _t(fake).requires_grad_(True)
    lab_loss(tf, _t(real), _t(mask))[0].backward()
    gj = jax.grad(lambda f: jlab(f, real, mask)[0])(fake)
    _close(tf.grad, gj, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("gan_type", ["standard", "wgan"])
def test_gan_and_reg_losses(gan_type):
    from texpose_tpu.models import losses as jl
    from texpose_tpu_torch.models import losses as tl
    rng = np.random.default_rng(4)
    d = rng.normal(size=(6,)).astype(np.float32) * 3
    for target in (0, 1):
        _close(tl.gan_loss(_t(d), target, gan_type),
               jl.gan_loss(d, target, gan_type))
    u = rng.uniform(0.05, 2, size=(2, 8, 1)).astype(np.float32)
    _close(tl.uncertainty_reg_loss(_t(u)), jl.uncertainty_reg_loss(u))
    x, y = (rng.normal(size=(10,)).astype(np.float32) for _ in range(2))
    _close(tl.smooth_l1(_t(x), _t(y)), jl.smooth_l1(x, y))
    _close(tl.mse_loss(_t(x), _t(y)), jl.mse_loss(x, y))
    lw = {"a": -1, "b": None, "c": 0.5}
    parts = {"a": 2.0, "b": 5.0, "c": 1.5}
    tt, td = tl.summarize_loss(parts, lw)
    jt, jd = jl.summarize_loss(parts, lw)
    _close(tt, jt)
    assert sorted(td) == sorted(jd)


def _vgg_pair():
    from texpose_tpu.nn.vgg import init_vgg19
    from texpose_tpu_torch.nn.vgg import vgg_from_jax
    jp = init_vgg19(jax.random.PRNGKey(5))
    return jp, vgg_from_jax(jp)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_vgg_features(bf16):
    """f32 to 1e-4; bf16 (the whole stack in bf16 on both sides, f32
    accumulation inside each conv): both round every layer's output to
    bf16, so a summation-order flip moves an element by one bf16 ulp of
    its magnitude and propagates — 3e-2 of the features' largest
    magnitude."""
    from texpose_tpu.nn.vgg import vgg19_features as jf
    from texpose_tpu_torch.nn.vgg import vgg19_features
    jp, tp = _vgg_pair()
    x = np.random.default_rng(6).uniform(size=(2, 3, 16, 16)
                                         ).astype(np.float32)
    want = np.asarray(jf(jp, x, jnp.bfloat16 if bf16 else None))
    got = vgg19_features(tp, _t(x), torch.bfloat16 if bf16 else None)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= (3e-2 if bf16 else 1e-4)


def test_perceptual_loss_pairs():
    from texpose_tpu.nn.vgg import perceptual_loss_pairs as jpl
    from texpose_tpu_torch.nn.vgg import perceptual_loss_pairs
    jp, tp = _vgg_pair()
    rng = np.random.default_rng(7)
    a, b, c = (rng.uniform(size=(2, 3, 16, 16)).astype(np.float32)
               for _ in range(3))
    got = perceptual_loss_pairs(tp, [(_t(a), _t(b), 1.0),
                                     (_t(a), _t(c), 5.0)])
    want = jpl(jp, [(a, b, 1.0), (a, c, 5.0)])
    _close(got, want, rtol=1e-4)


def _disc(cfg):
    from texpose_tpu.nn.discriminator import init_discriminator as jinit
    jparams, jstate = jinit(jax.random.PRNGKey(8), cfg)
    tparams = {g: [_t(p["w"]).clone().requires_grad_(True)
                   for p in jparams[g]] for g in ("main", "final")}
    tstate = {g: [_t(u).clone() for u in jstate[g]]
              for g in ("main", "final")}
    return jparams, jstate, tparams, tstate


@pytest.mark.parametrize("training", [True, False])
def test_discriminator_and_spectral_norm(tmp_path, training):
    from texpose_tpu.nn import discriminator as jd
    from texpose_tpu_torch.nn import discriminator as td
    cfg = tiny_gan_cfg("unused", tmp_path)
    jparams, jstate, tparams, tstate = _disc(cfg)
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(3, 9, 16, 16)).astype(np.float32)
    scales = rng.uniform(0.3, 1, size=(3, 1, 1, 1)).astype(np.float32)
    dj, sj = jd.apply_discriminator(jparams, jstate, cfg, x, scales, 0.5,
                                    training=training)
    dt, st = td.apply_discriminator(tparams, tstate, cfg, _t(x), _t(scales),
                                    0.5, training=training)
    _close(dt.detach(), dj, rtol=1e-4, atol=1e-5)
    for g in ("main", "final"):
        for a, b in zip(st[g], sj[g]):
            _close(a, b)
    # σ's gradient flows through the raw kernels only
    gj = jax.grad(lambda p: jd.apply_discriminator(
        p, jstate, cfg, x, scales, 0.5, training=training)[0].sum())(jparams)
    dt.sum().backward()
    for g in ("main", "final"):
        for w, gw in zip(tparams[g], gj[g]):
            _close(w.grad, gw["w"], rtol=1e-3, atol=1e-6)


def test_r1_penalty_matches_jax(tmp_path):
    """The R1 penalty from ONE forward over [real; fake] with sel (as the
    D step builds it) and its gradient to the kernels (double backward)."""
    from texpose_tpu.models.losses import r1_penalty as jr1
    from texpose_tpu.nn import discriminator as jd
    from texpose_tpu_torch.models.losses import r1_penalty
    from texpose_tpu_torch.nn import discriminator as td
    cfg = tiny_gan_cfg("unused", tmp_path)
    jparams, jstate, tparams, tstate = _disc(cfg)
    rng = np.random.default_rng(10)
    real = rng.uniform(size=(2, 9, 16, 16)).astype(np.float32)
    fake = rng.uniform(size=(2, 9, 16, 16)).astype(np.float32)
    scales = rng.uniform(0.3, 1, size=(2, 1, 1, 1)).astype(np.float32)

    def jreg(p):
        return jr1(lambda z: jd.apply_discriminator(
            p, jstate, cfg, z, scales, 0.5)[0], real)

    both = torch.cat([_t(real), _t(fake)]).requires_grad_(True)
    psn, _ = td.sn_normalize_disc(tparams, tstate)
    d, _ = td.apply_discriminator(psn, tstate, cfg, both,
                                  torch.cat([_t(scales)] * 2), 0.5,
                                  normalized=True)
    sel = torch.tensor([1.0, 1.0, 0.0, 0.0])
    reg_r, _ = r1_penalty(d, both, sel, 2)
    _close(reg_r.detach(), jreg(jparams), rtol=1e-4)
    reg_r.backward()
    gj = jax.grad(jreg)(jparams)
    for g in ("main", "final"):
        for w, gw in zip(tparams[g], gj[g]):
            _close(w.grad, gw["w"], rtol=2e-3, atol=1e-6)


@pytest.mark.parametrize("opt", [
    {"lr": 1e-3, "lr_end": 1e-4, "sched": {}},
    {"lr": 1e-3, "sched": {"gamma": 0.9}},
    {"lr": 1e-3, "lr_end": 1e-4, "sched": {}, "lr_latent": 3e-4}])
def test_generator_optimizer_matches_optax(opt):
    """Five steps with epoch boundaries (3 steps per epoch): torch Adam
    with the staircase (and the lr_latent group) vs the JAX package's
    optax construction, on the same gradients: 1e-6 absolute."""
    from texpose_tpu.models.optim import make_generator_optimizer as jmake
    from texpose_tpu_torch.models.optim import (make_generator_optimizer,
                                                set_lrs)
    cfg = process_options(Config({"optim": opt, "optim_disc": {"lr": 1e-4}}))
    rng = np.random.default_rng(11)
    h0 = rng.normal(size=(4, 3)).astype(np.float32)
    l0 = rng.normal(size=(5, 2)).astype(np.float32)
    jo = jmake(cfg, 15, 3)
    params = {"heads": {"w": jnp.asarray(h0)}, "latents": {"l": jnp.asarray(l0)}}
    state = jo.init(params)
    th = torch.tensor(h0, requires_grad=True)
    tl = torch.tensor(l0, requires_grad=True)
    to = make_generator_optimizer(cfg, [th], [tl], 15, 3)
    for it in range(5):
        gh = rng.normal(size=h0.shape).astype(np.float32)
        gl = rng.normal(size=l0.shape).astype(np.float32)
        upd, state = jo.update({"heads": {"w": gh}, "latents": {"l": gl}},
                               state, params)
        params = optax.apply_updates(params, upd)
        th.grad, tl.grad = _t(gh), _t(gl)
        set_lrs(to, it)
        to.step()
        _close(th.detach(), params["heads"]["w"], rtol=0, atol=1e-6)
        _close(tl.detach(), params["latents"]["l"], rtol=0, atol=1e-6)


def test_disc_optimizer_matches_optax():
    from texpose_tpu.models.optim import make_disc_optimizer as jmake
    from texpose_tpu_torch.models.optim import make_disc_optimizer, set_lrs
    cfg = process_options(Config({"optim": {"lr": 1e-3},
                                  "optim_disc": {"lr": 1e-4}}))
    rng = np.random.default_rng(12)
    w0 = rng.normal(size=(3, 3)).astype(np.float32)
    jo = jmake(cfg, 10, 2)
    p = jnp.asarray(w0)
    state = jo.init(p)
    tw = torch.tensor(w0, requires_grad=True)
    to = make_disc_optimizer(cfg, [tw], 10, 2)
    for it in range(4):
        g = rng.normal(size=w0.shape).astype(np.float32)
        upd, state = jo.update(g, state, p)
        p = optax.apply_updates(p, upd)
        tw.grad = _t(g)
        set_lrs(to, it)
        to.step()
        _close(tw.detach(), p, rtol=0, atol=1e-6)
