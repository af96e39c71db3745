"""Port parity, dual-density composite: texpose_tpu_torch's composite
(the kernel wrapper's plain twin on the CPU) against the JAX Pallas
kernel in interpret mode and against the plain composite_static_transient
on the activated field outputs.  float32 throughout; atol 1e-5 covers the
summation order."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from texpose_tpu.kernels.fused_composite import fused_composite_st as jfused
from texpose_tpu.ops.render import composite_static_transient as jplain
from texpose_tpu_torch.kernels import composite as tcomp
from texpose_tpu_torch.nn.mlp import softplus
from texpose_tpu_torch.ops.render import composite_static_transient as tplain

KEYS = ["rgb", "rgb_static", "rgb_transient", "depth", "opacity",
        "opacity_static", "opacity_transient", "uncert",
        "trans_density_mean"]
ATOL = 1e-5


def _inputs(B, R, N, seed):
    rng = np.random.default_rng(seed)
    M = B * R * N
    rgb_raw = rng.normal(size=(M, 3)).astype(np.float32)
    trans_raw = rng.normal(size=(M, 5)).astype(np.float32)
    dens_raw = (rng.normal(size=(M, 1)) * 2).astype(np.float32)
    depth = np.sort(rng.uniform(2.0, 6.0, size=(B, R, N, 1)),
                    axis=2).astype(np.float32)
    ray = rng.normal(size=(B, R, 3)).astype(np.float32)
    return rgb_raw, trans_raw, dens_raw, depth, ray


@pytest.mark.parametrize("B,R,N", [(2, 8, 16), (1, 16, 64)])
def test_composite_matches_jax_kernel(B, R, N):
    args = _inputs(B, R, N, seed=N)
    ref = jfused(*map(jnp.asarray, args), min_uncert=0.05, interpret=True,
                 tile_rays=8, flat=False)
    out = tcomp.fused_composite_st(*map(torch.from_numpy, args),
                                   min_uncert=0.05)
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, err_msg=k)


def test_composite_matches_plain_composite():
    """The kernel route's packed columns against composite_static_transient
    on sigmoid/softplus-activated samples, in both packages."""
    B, R, N = 2, 8, 16
    rgb_raw, trans_raw, dens_raw, depth, ray = _inputs(B, R, N, seed=1)
    sh = (B, R, N)
    t = {k: torch.from_numpy(v) for k, v in
         dict(rgb=rgb_raw, tr=trans_raw, d=dens_raw).items()}
    rgb_pair = torch.stack([torch.sigmoid(t["rgb"]).reshape(*sh, 3),
                            torch.sigmoid(t["tr"][:, :3]).reshape(*sh, 3)],
                           dim=-1)
    dens_pair = torch.stack([softplus(t["d"][:, 0]).reshape(sh),
                             softplus(t["tr"][:, 3]).reshape(sh)], dim=-1)
    unc = softplus(t["tr"][:, 4:5]).reshape(*sh, 1)
    plain = tplain(rgb_pair, dens_pair, torch.from_numpy(depth),
                   torch.from_numpy(ray), unc, min_uncert=0.05)
    jref = jplain(jnp.asarray(rgb_pair.numpy()),
                  jnp.asarray(dens_pair.numpy()), jnp.asarray(depth),
                  jnp.asarray(ray), jnp.asarray(unc.numpy()),
                  min_uncert=0.05)
    out = tcomp.fused_composite_st(t["rgb"], t["tr"], t["d"],
                                   torch.from_numpy(depth),
                                   torch.from_numpy(ray), min_uncert=0.05)
    for k in KEYS[:-1]:
        np.testing.assert_allclose(out[k].numpy(), plain[k].numpy(),
                                   atol=ATOL, err_msg=k)
        np.testing.assert_allclose(plain[k].numpy(), np.asarray(jref[k]),
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(out["trans_density_mean"]),
                               float(dens_pair[..., 1].mean()), atol=ATOL)


def test_softplus_matches_jax_beyond_threshold():
    """softplus is jax.nn.softplus's formula, not F.softplus's linear
    cut-over above 20."""
    x = np.array([-60.0, -5.0, 0.0, 3.0, 19.9, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
