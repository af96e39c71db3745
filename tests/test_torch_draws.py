"""F7 (c): the port's own random draws against the JAX step's.

Every step test hands the port the JAX step's draws (``jax_draws``), so
the port's ``TextureGANEngine.make_draws`` (its device generator) is held
here to the same distributions as JAX's key splits (texpose_tpu/models/
texture_gan.py's step: ``jax.random.choice`` for the batch, the patch
sampler's three uniforms, the render's depth uniforms and density noise,
the WGAN-GP ε), over 256 steps of a batch of 8 from 16 images (2048 draws
of each patch quantity, 2048 image picks, 2^20 depth uniforms), with fixed
seeds on both sides:

  * ``idx``: 8 distinct images a step; each image's frequency within a
    chi-square bound, and the two sides' frequencies one distribution;
  * the patch scales at it = 0, 5000, 10000 and 20000 (the anneal of the
    lower bound): the port's lower bound equal to JAX's, every scale in
    [lo, hi], the normalized scale U[0,1) by a KS test on each side and
    the two sides one distribution (two-sample KS);
  * the two shifts (recovered from the coordinates) and the depth
    uniforms: U[0,1) by KS on each side, and two-sample KS;
  * ``density_noise`` (N(0,1)) and ``gp_eps`` (U[0,1)) with the configs
    that draw them.

Every test passes at p ≥ 1e-3."""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_step import jax_draws

P_MIN = 1e-3
STEPS = 256
B, N_IMG, PATCH, N_SAMPLES = 8, 16, 8, 8
ITS = (0, 5000, 10000, 20000)
ANNEAL = {"min_scale": 0.25, "max_scale": 1.0, "scale_anneal": 0.0002}


def _cfg(noise=False, gp=False):
    from texpose_tpu_torch.utils.config import Config
    return Config({
        "batch_size": B, "patch_size": PATCH,
        "nerf": {"sample_intvs": N_SAMPLES,
                 "density_noise_reg": 0.5 if noise else None},
        "gan": {"type": "wgan" if gp else "standard"},
        "loss_weight": {"gan_gp": 1 if gp else None}})


def port_draws(cfg, seed=0, steps=STEPS):
    """``steps`` steps of the port engine's ``make_draws`` (its own
    generator, seeded as a run's) → {name: [steps, ...] numpy}."""
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    eng = types.SimpleNamespace(cfg=cfg, device=torch.device("cpu"),
                                train_data=range(N_IMG),
                                draw_gen=torch.Generator().manual_seed(seed))
    out = [TextureGANEngine.make_draws(eng, it) for it in range(steps)]
    return {k: np.stack([d[k].numpy() for d in out]) for k in out[0]}


def jax_side(cfg, seed=0):
    """STEPS steps of JAX's draws from PRNGKey(seed)'s key chain → (draws
    as ``port_draws``, the steps' patch keys)."""
    key = jax.random.PRNGKey(seed)
    steps, k_patch = [], []
    for it in range(STEPS):
        k_patch.append(jax.random.split(key, 5)[2])
        key, d = jax_draws(cfg, key, N_IMG, it)
        steps.append(d)
    draws = {k: np.stack([d[k].numpy() for d in steps]) for k in steps[0]}
    return draws, jnp.stack(k_patch)


@pytest.fixture(scope="module")
def sides():
    """A config that draws every optional draw; both sides' draws."""
    cfg = _cfg(noise=True, gp=True)
    jd, k_patch = jax_side(cfg)
    return cfg, port_draws(cfg), jd, k_patch


def _uniform(x):
    return stats.kstest(np.ravel(x), "uniform").pvalue


def _same(a, b):
    return stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue


def test_shapes_and_dtypes_match(sides):
    _, pd, jd, _ = sides
    for k in ("idx", "patch", "depth"):
        assert pd[k].shape == jd[k].shape, k
        assert pd[k].dtype == jd[k].dtype, k


def test_idx_without_replacement_and_uniform(sides):
    _, pd, jd, _ = sides
    counts = {}
    for side, d in (("port", pd), ("jax", jd)):
        idx = d["idx"]
        assert all(len(set(row)) == B for row in idx.tolist()), side
        assert idx.min() >= 0 and idx.max() < N_IMG, side
        counts[side] = np.bincount(idx.ravel(), minlength=N_IMG)
        assert stats.chisquare(counts[side]).pvalue >= P_MIN, side
    table = np.stack([counts["port"], counts["jax"]])
    assert stats.chi2_contingency(table).pvalue >= P_MIN


def _jax_patches(k_patch, it):
    from texpose_tpu.sampling.patch import flex_patch_coords
    fn = jax.jit(jax.vmap(lambda k: flex_patch_coords(
        k, B, PATCH, iteration=it, **ANNEAL)))
    coords, scales = fn(k_patch)
    lo = flex_patch_coords(k_patch[0], 1, PATCH, iteration=it,
                           random_scale=False, **ANNEAL)[1]
    return (np.asarray(coords).reshape(-1, PATCH, PATCH, 2),
            np.asarray(scales).ravel(), float(np.asarray(lo).ravel()[0]))


def _port_patches(patch, it):
    from texpose_tpu_torch.sampling.patch import (flex_patch_coords,
                                                  scale_bounds)
    coords, scales = [], []
    for u in torch.from_numpy(patch):
        c, s = flex_patch_coords(u, PATCH, iteration=it, **ANNEAL)
        coords.append(c.numpy())
        scales.append(s.numpy().ravel())
    lo, hi = scale_bounds(it, **ANNEAL)
    return (np.concatenate(coords), np.concatenate(scales), float(lo),
            float(hi))


def _shifts(coords, scales):
    """The two shifts' uniforms from the coordinates: the grid is symmetric
    about 0, so a patch's mean coordinate is its offset, (2u − 1)(1 − s)."""
    keep = scales < 0.99
    off = coords.mean(axis=(1, 2))[keep]
    return (off / (1 - scales[keep])[:, None] + 1) / 2


@pytest.mark.parametrize("it", ITS)
def test_patch_scales_follow_the_anneal(sides, it):
    _, pd, _, k_patch = sides
    jc, js, jlo = _jax_patches(k_patch, it)
    pc, ps, plo, hi = _port_patches(pd["patch"], it)
    np.testing.assert_allclose(plo, jlo, rtol=1e-6)
    assert hi == ANNEAL["max_scale"]
    u = {}
    for side, s in (("port", ps), ("jax", js)):
        assert s.size == STEPS * B
        assert s.min() >= jlo and s.max() <= hi, side
        u[side] = (s - jlo) / (hi - jlo)
        assert _uniform(u[side]) >= P_MIN, (side, it)
    assert _same(u["port"], u["jax"]) >= P_MIN
    if it == 0:
        # the two shifts, once: they do not depend on the anneal
        sp, sj = _shifts(pc, ps), _shifts(jc, js)
        for side, sh in (("port", sp), ("jax", sj)):
            assert sh.min() >= -1e-4 and sh.max() <= 1 + 1e-4, side
            for axis in range(2):
                assert _uniform(sh[:, axis]) >= P_MIN, (side, axis)
        for axis in range(2):
            assert _same(sp[:, axis], sj[:, axis]) >= P_MIN, axis


def test_patch_uniforms_are_independent_of_each_other(sides):
    """The scale and the two shifts are three independent draws on both
    sides (no two of them one number)."""
    _, pd, jd, _ = sides
    for side, d in (("port", pd), ("jax", jd)):
        u = d["patch"].reshape(STEPS, 3, B).transpose(1, 0, 2).reshape(3, -1)
        corr = np.corrcoef(u)
        assert np.abs(corr[np.triu_indices(3, 1)]).max() < 0.1, side


def test_depth_uniforms(sides):
    _, pd, jd, _ = sides
    for side, d in (("port", pd), ("jax", jd)):
        x = d["depth"]
        assert x.min() >= 0 and x.max() < 1, side
        assert _uniform(x) >= P_MIN, side
    assert _same(pd["depth"], jd["depth"]) >= P_MIN


@pytest.mark.parametrize("what", ["density_noise", "gp_eps"])
def test_optional_draws(sides, what):
    """The draws only some configs make: the port draws them exactly when
    the config asks, in JAX's shapes, from JAX's distributions."""
    _, pd, jd, _ = sides
    asks = _cfg(noise=what == "density_noise", gp=what == "gp_eps")
    assert what in port_draws(asks, steps=1)
    assert what not in port_draws(_cfg(), steps=1)
    assert pd[what].shape == jd[what].shape
    if what == "density_noise":
        for side, x in (("port", pd[what]), ("jax", jd[what])):
            assert stats.kstest(x.ravel(), "norm").pvalue >= P_MIN, side
    else:
        for side, x in (("port", pd[what]), ("jax", jd[what])):
            assert _uniform(x) >= P_MIN, side
    assert _same(pd[what], jd[what]) >= P_MIN
