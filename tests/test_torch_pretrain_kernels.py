"""Port parity, the pretrain's kernel modules: the plain twins of the coarse
field + composite forward (kernels/coarse_field.py), the composite-coarse
backward (kernels/composite.py) and the trunk-training field backward,
and the autograd Function that chains them, against the JAX package's
plain route (``apply_nerf`` + ``composite``) and its Pallas kernels in
interpret mode (``fused_coarse_field``, ``fused_composite_coarse``,
``fused_coarse_render``).  Inputs from a numpy seed; a narrow field (4×32
trunk, skip at 2, L_3D 4, L_view 2) with a BARF c2f window at half
progress, so the band weights are not ones.

Tolerances: float32 on both sides, only the summation order differs —
forward outputs 1e-5 absolute, gradients 1e-4 of each tensor's largest
magnitude.  At bf16 compute both round each matmul operand to bf16 at the
same points; a different f32 summation order can flip one rounding, so
raw outputs agree to 2e-2 absolute and 1e-3 in the mean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from texpose_tpu.nn import fields as jfields
from texpose_tpu.ops.render import composite as jcomposite
from texpose_tpu.utils.checkpoint import tree_to_flat_dict
from texpose_tpu.utils.config import Config, process_options
from texpose_tpu_torch.kernels.coarse_field import (coarse_field_bwd_plain,
                                                    coarse_render,
                                                    coarse_render_plain)
from texpose_tpu_torch.kernels.composite import (composite_coarse_bwd_plain,
                                                 composite_coarse_plain)
from texpose_tpu_torch.nn import fields as tfields
from texpose_tpu_torch.ops.render import _dists
from texpose_tpu_torch.utils.checkpoint import jax_state_to_torch

B, R, N = 2, 8, 16
PROGRESS = 0.5


def _cfg(view_dep, **kernels):
    return process_options(Config({
        "arch": {"layers_feat": [None] + [32] * 4, "layers_rgb": [None, 32, 3],
                 "skip": [2], "posenc": {"L_3D": 4,
                                         "L_view": 2 if view_dep else None},
                 "density_activ": "softplus", "tf_init": True},
        "nerf": {"view_dep": view_dep, "density_noise_reg": None,
                 "sample_intvs": N, "sample_stratified": False,
                 "setbg_opaque": False,
                 "depth": {"param": "metric", "scale": 1, "range": [0, 3]}},
        "c2f": [0.0, 1.0], "camera": {"ndc": False},
        "data": {"image_size": [16, 16]},
        "kernels": dict({"fused_trunk": False}, **kernels),
    }))


def _bridge(jparams, cfg):
    """JAX coarse-field params → a port NerfCoarse holding the same
    values."""
    state = jax_state_to_torch(tree_to_flat_dict({"params": {
        "nerf": jparams}}))
    nerf = tfields.init_nerf(cfg)
    nerf.load_state_dict({k[len("nerf."):]: v for k, v in state.items()},
                         strict=True)
    return nerf


@pytest.fixture(scope="module", params=[False, True],
                ids=["view_indep", "view_dep"])
def setup(request):
    view_dep = request.param
    cfg = _cfg(view_dep)
    jparams = jfields.init_nerf(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(7)
    center = np.tile(np.array([0.0, 0.0, -2.0], np.float32), (B, R, 1))
    ray = rng.normal(size=(B, R, 3)).astype(np.float32) * 0.2
    ray[..., 2] = 1.0
    depth = np.sort(rng.uniform(1.0, 3.0, size=(B, R, N, 1)), axis=2
                    ).astype(np.float32)
    return cfg, jparams, _bridge(jparams, cfg), (center, ray, depth)


def _port_inputs(cfg, center, ray, depth):
    c, r, d = (torch.from_numpy(x) for x in (center, ray, depth))
    pts = c[..., None, :] + r[..., None, :] * d
    ray_unit = r / torch.linalg.norm(r, dim=-1, keepdim=True) \
        if cfg.nerf.view_dep else None
    xext, ep = tfields.coarse_field_inputs(cfg, pts, ray_unit, PROGRESS)
    return xext, ep, _dists(d, r).reshape(B * R, N), d.reshape(B * R, N)


def _jax_pts(center, ray, depth):
    pts = center[..., None, :] + ray[..., None, :] * depth
    unit = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
    return jnp.asarray(pts), jnp.asarray(unit)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_forward_twin_matches_jax_plain_and_interpret(setup, monkeypatch):
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg, jparams, nerf, (center, ray, depth) = setup
    xext, ep, dist, d = _port_inputs(cfg, center, ray, depth)
    with torch.no_grad():
        packed, rgb_raw, dens_raw, acts = coarse_render_plain(
            xext, ep, dist, d, nerf.kernel_weights(), torch.float32,
            want_res=True)
    assert len(acts) == 4 + 1
    pts, unit = _jax_pts(center, ray, depth)
    p = jnp.asarray(PROGRESS)
    # the JAX field kernel (interpret): raw outputs
    j_rgb, j_dens = jfields.apply_nerf_raw(
        jparams, cfg, pts, unit if cfg.nerf.view_dep else None, p,
        compute_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(rgb_raw.numpy(), np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(dens_raw.numpy(), np.asarray(j_dens),
                               atol=1e-5)
    # the JAX mega kernel (interpret) and the plain route, composited
    j_mega = jfields.forward_coarse_render(
        jparams, cfg, jnp.asarray(center), jnp.asarray(ray),
        jnp.asarray(depth), p, compute_dtype=jnp.float32, interpret=True)
    cfg_p = _cfg(cfg.nerf.view_dep, fused_coarse=False)
    j_rgb_s, j_dens_s = jfields.apply_nerf(
        jparams, cfg_p, pts,
        jnp.broadcast_to(unit[..., None, :], pts.shape)
        if cfg.nerf.view_dep else None, p, compute_dtype=jnp.float32)
    j_plain = jcomposite(j_rgb_s, j_dens_s, jnp.asarray(depth),
                         jnp.asarray(ray))
    cols = {"rgb": (0, 3), "depth": (3, 4), "opacity": (4, 5)}
    for k, (lo, hi) in cols.items():
        got = packed[:, lo:hi].reshape(B, R, hi - lo).numpy()
        np.testing.assert_allclose(got, np.asarray(j_mega[k]), atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got, np.asarray(j_plain[k]), atol=1e-5,
                                   err_msg=k)
    assert np.all(packed[:, 5:].numpy() == 0)
    # the port's plain route against the JAX plain route
    with torch.no_grad():
        t_rgb, t_dens = tfields.forward_samples_nerf(
            nerf, cfg, torch.from_numpy(center), torch.from_numpy(ray),
            torch.from_numpy(depth), PROGRESS, torch.float32)
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(j_rgb_s), atol=1e-5)
    np.testing.assert_allclose(t_dens.numpy(), np.asarray(j_dens_s),
                               atol=1e-5)


def test_forward_twin_bf16_matches_jax_interpret(setup, monkeypatch):
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg, jparams, nerf, (center, ray, depth) = setup
    xext, ep, dist, d = _port_inputs(cfg, center, ray, depth)
    with torch.no_grad():
        _, rgb_raw, dens_raw, _ = coarse_render_plain(
            xext, ep, dist, d, nerf.kernel_weights(), torch.bfloat16,
            want_res=True)
    pts, unit = _jax_pts(center, ray, depth)
    j_rgb, j_dens = jfields.apply_nerf_raw(
        jparams, cfg, pts, unit if cfg.nerf.view_dep else None,
        jnp.asarray(PROGRESS), compute_dtype=jnp.bfloat16, interpret=True)
    for a, b in ((rgb_raw, j_rgb), (dens_raw, j_dens)):
        err = np.abs(a.numpy() - np.asarray(b, np.float32))
        assert err.max() <= 2e-2 and err.mean() <= 1e-3, err.max()


def test_autograd_wiring_matches_fused_coarse_render(setup, monkeypatch):
    """coarse_render (forward twin → composite backward twin → field
    backward twin) against jax.grad through fused_coarse_render's
    custom_vjp (mega forward + composite and field backward kernels,
    interpret): rgb, depth and opacity all carry cotangent."""
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg, jparams, nerf, (center, ray, depth) = setup
    rng = np.random.default_rng(11)
    cot = rng.normal(size=(B, R, 5)).astype(np.float32)

    def jloss(params):
        out = jfields.forward_coarse_render(
            params, cfg, jnp.asarray(center), jnp.asarray(ray),
            jnp.asarray(depth), jnp.asarray(PROGRESS),
            compute_dtype=jnp.float32, interpret=True)
        o = jnp.concatenate([out["rgb"], out["depth"], out["opacity"]], -1)
        return (o * cot).sum()

    jg = tree_to_flat_dict({"nerf": jax.grad(jloss)(jparams)})
    xext, ep, dist, d = _port_inputs(cfg, center, ray, depth)
    weights = nerf.kernel_weights()
    packed = coarse_render(xext, ep, dist, d, weights, torch.float32)
    (packed[:, :5] * torch.from_numpy(cot.reshape(B * R, 5))).sum().backward()
    for name, p in nerf.named_parameters():
        key = "nerf/" + name.replace(".", "/")
        assert _rel(p.grad.numpy(), jg[key]) <= 1e-4, key


def test_composite_bwd_twin_matches_jax_interpret():
    from texpose_tpu.kernels.fused_composite_coarse import (
        fused_composite_coarse)
    rng = np.random.default_rng(3)
    M = B * R * N
    rgb_raw = rng.normal(size=(M, 3)).astype(np.float32)
    dens_raw = (rng.normal(size=(M, 1)) * 3).astype(np.float32)
    depth = np.sort(rng.uniform(2, 6, size=(B, R, N, 1)), 2).astype(np.float32)
    ray = rng.normal(size=(B, R, 3)).astype(np.float32)
    g = rng.normal(size=(B, R, 5)).astype(np.float32)

    def f(a, b):
        out = fused_composite_coarse(a, b, jnp.asarray(depth),
                                     jnp.asarray(ray), interpret=True)
        return jnp.concatenate([out["rgb"], out["depth"], out["opacity"]], -1)

    j_out, vjp = jax.vjp(f, jnp.asarray(rgb_raw), jnp.asarray(dens_raw))
    j_drgb, j_ddens = vjp(jnp.asarray(g))
    dist = _dists(torch.from_numpy(depth), torch.from_numpy(ray)
                  ).reshape(B * R, N)
    d = torch.from_numpy(depth).reshape(B * R, N)
    packed = composite_coarse_plain(torch.from_numpy(rgb_raw),
                                    torch.from_numpy(dens_raw), d, dist)
    np.testing.assert_allclose(packed[:, :5].numpy(),
                               np.asarray(j_out).reshape(B * R, 5), atol=1e-5)
    g8 = torch.zeros(B * R, 8)
    g8[:, :5] = torch.from_numpy(g.reshape(B * R, 5))
    d_rgb, d_dens = composite_coarse_bwd_plain(
        torch.from_numpy(rgb_raw), torch.from_numpy(dens_raw), dist, d, g8)
    assert _rel(d_rgb.numpy(), j_drgb) <= 1e-4
    assert _rel(d_dens.numpy(), j_ddens) <= 1e-4


def test_field_bwd_twin_matches_jax_interpret(setup, monkeypatch):
    """The field backward's twin from the forward twin's residuals against
    the VJP of fused_coarse_field (interpret) for given raw-output
    gradients: every trunk (skip and density split included) and head
    tensor."""
    monkeypatch.setenv("TEXPOSE_FUSED_INTERPRET", "1")
    cfg, jparams, nerf, (center, ray, depth) = setup
    M = B * R * N
    rng = np.random.default_rng(5)
    g_rgb = rng.normal(size=(M, 3)).astype(np.float32)
    g_dens = rng.normal(size=(M, 1)).astype(np.float32)
    pts, unit = _jax_pts(center, ray, depth)
    _, vjp = jax.vjp(lambda p: jfields.apply_nerf_raw(
        p, cfg, pts, unit if cfg.nerf.view_dep else None,
        jnp.asarray(PROGRESS), compute_dtype=jnp.float32, interpret=True),
        jparams)
    jg = tree_to_flat_dict({"nerf": vjp((jnp.asarray(g_rgb),
                                         jnp.asarray(g_dens)))[0]})
    xext, ep, dist, d = _port_inputs(cfg, center, ray, depth)
    weights = nerf.kernel_weights()
    with torch.no_grad():
        *_, acts = coarse_render_plain(xext, ep, dist, d, weights,
                                       torch.float32, want_res=True)
        grads = coarse_field_bwd_plain(xext, ep, acts, weights,
                                       torch.from_numpy(g_rgb),
                                       torch.from_numpy(g_dens),
                                       torch.float32)
    names = [n for n, _ in nerf.named_parameters()]
    assert len(grads) == len(names) == len(weights.params())
    for name, g in zip(names, grads):
        key = "nerf/" + name.replace(".", "/")
        assert g.shape == jg[key].shape, key
        assert _rel(g.numpy(), jg[key]) <= 1e-4, key


@pytest.mark.parametrize("what", ["losses", "composite", "schedules"])
def test_pretrain_losses_composite_and_schedules_match_jax(what):
    """The slice's plain modules against the JAX package's: the masked MSE
    and scale-invariant depth losses with their gradients (min/max ties
    included, where both frameworks split the gradient), the vanilla
    composite with setbg_opaque, and the per-iteration schedules (the
    staircase γ^count and the continuous decay to lr_end)."""
    rng = np.random.default_rng(4)
    if what == "losses":
        from texpose_tpu.models import losses as jl
        from texpose_tpu_torch.models import losses as tl
        pred = rng.uniform(0.5, 2.0, size=(3, 40, 1)).astype(np.float32)
        tgt = rng.uniform(0.5, 2.0, size=(3, 40, 1)).astype(np.float32)
        tgt[:, ::4] = pred[:, ::4]                       # ties
        mask = (rng.uniform(size=(3, 40, 1)) > 0.3).astype(np.float32)
        for jf, tf in ((jl.masked_mse_loss, tl.masked_mse_loss),
                       (jl.scale_invariant_depth_loss,
                        tl.scale_invariant_depth_loss)):
            jv, jg = jax.value_and_grad(lambda p, q: jf(p, q, mask),
                                        (0, 1))(pred, tgt)
            p = torch.from_numpy(pred).requires_grad_(True)
            q = torch.from_numpy(tgt).requires_grad_(True)
            v = tf(p, q, torch.from_numpy(mask))
            v.backward()
            np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[0]),
                                       rtol=1e-5, atol=1e-8)
            np.testing.assert_allclose(q.grad.numpy(), np.asarray(jg[1]),
                                       rtol=1e-5, atol=1e-8)
    elif what == "composite":
        from texpose_tpu_torch.ops.render import composite
        rgb = rng.uniform(size=(2, 5, N, 3)).astype(np.float32)
        dens = rng.uniform(0, 3, size=(2, 5, N)).astype(np.float32)
        depth = np.sort(rng.uniform(1, 3, size=(2, 5, N, 1)), 2).astype(
            np.float32)
        ray = rng.normal(size=(2, 5, 3)).astype(np.float32)
        j = jcomposite(*(jnp.asarray(x) for x in (rgb, dens, depth, ray)),
                       setbg_opaque=True)
        t = composite(*(torch.from_numpy(x) for x in (rgb, dens, depth, ray)),
                      setbg_opaque=True)
        for k in ("rgb", "depth", "opacity", "prob"):
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                       atol=1e-6, err_msg=k)
    else:
        from texpose_tpu.models.optim import pretrain_schedule as jsched
        from texpose_tpu_torch.models.optim import pretrain_schedule
        for optim in ({"lr": 5e-4, "lr_end": 1e-4,
                       "sched": {"gamma": 0.999992}},
                      {"lr": 1e-3, "lr_end": 1e-4, "sched": {"gamma": None}},
                      {"lr": 1e-3, "lr_end": None, "sched": {}}):
            cfg = Config({"optim": optim})
            js, ts = jsched(cfg, 50000), pretrain_schedule(cfg, 50000)
            for count in (0, 1, 7, 12345, 49999):
                want = float(js(count)) if callable(js) else float(js)
                # both raise the f32-rounded γ to the count in float32
                np.testing.assert_allclose(ts(count), want, rtol=1e-6)
