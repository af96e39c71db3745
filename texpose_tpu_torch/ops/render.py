"""Depth sampling, the vanilla NeRF composite and the dual-density
composite (port of texpose_tpu/ops/render.py).

Transmittances are exp(−exclusive cumsum), in float32 whatever the field's
compute dtype.
"""

from __future__ import annotations

import torch


def sample_depth(depth_min, depth_max, num_samples, param="metric",
                 rand=None):
    """Depth samples in [depth_min, depth_max]: [B,R] → [B,R,N,1].
    Stratified with rand (uniforms [B,R,N,1], drawn by the caller; the
    training path), mid-bin without (evaluation)."""
    lo = depth_min[:, :, None, None]
    hi = depth_max[:, :, None, None]
    grid = torch.arange(num_samples, dtype=lo.dtype,
                        device=lo.device)[None, None, :, None]
    depth = ((0.5 if rand is None else rand) + grid) / num_samples \
        * (hi - lo) + lo
    if param == "inverse":
        depth = 1.0 / (depth + 1e-8)
    return depth


def _dists(depth_samples, ray):
    """Quadrature interval lengths [B,R,N] = Δdepth · ‖ray‖, the last
    interval 1e10."""
    ray_length = torch.linalg.norm(ray, dim=-1, keepdim=True)       # [B,R,1]
    d = depth_samples[..., 0]
    intv = torch.cat([d[..., 1:] - d[..., :-1],
                      torch.full_like(d[..., :1], 1e10)], dim=-1)
    return intv * ray_length


def _transmittance(sigma_delta):
    """T_i = exp(-Σ_{j<i} σ_j δ_j), exclusive cumsum."""
    shifted = torch.cat([torch.zeros_like(sigma_delta[..., :1]),
                         sigma_delta[..., :-1]], dim=-1)
    return torch.exp(-torch.cumsum(shifted, dim=-1))


def composite(rgb_samples, density_samples, depth_samples, ray,
              setbg_opaque=False, bgcolor=1.0):
    """Vanilla NeRF compositing: rgb_samples [B,R,N,3], density_samples
    [B,R,N], depth_samples [B,R,N,1] → dict(rgb [B,R,3], depth [B,R,1],
    opacity [B,R,1], prob [B,R,N,1])."""
    sigma_delta = density_samples * _dists(depth_samples, ray)
    alpha = 1 - torch.exp(-sigma_delta)
    prob = (_transmittance(sigma_delta) * alpha)[..., None]
    rgb = (rgb_samples * prob).sum(dim=-2)
    opacity = prob.sum(dim=-2)
    if setbg_opaque:
        rgb = rgb + bgcolor * (1 - opacity)
    return dict(rgb=rgb, depth=(depth_samples * prob).sum(dim=-2),
                opacity=opacity, prob=prob)


def composite_static_transient(rgb_samples, density_samples, depth_samples,
                               ray, uncert_samples, min_uncert=0.05):
    """NeRF-W dual-density compositing.

    rgb_samples [B,R,N,3,2] (static, transient), density_samples [B,R,N,2],
    uncert_samples [B,R,N,1] → dict of rgb, rgb_static, rgb_transient
    [B,R,3]; depth, opacity, opacity_static, opacity_transient, uncert
    [B,R,1]; prob [B,R,N,1]; alpha_static, alpha_transient [B,R,N].  The
    combined rgb uses the joint transmittance with per-branch alphas; depth
    integrates against the static weights.
    """
    dist = _dists(depth_samples, ray)
    sd_static = density_samples[..., 0] * dist
    sd_trans = density_samples[..., 1] * dist
    sd = sd_static + sd_trans

    alpha_static = 1 - torch.exp(-sd_static)
    alpha_trans = 1 - torch.exp(-sd_trans)
    alpha = 1 - torch.exp(-sd)

    T = _transmittance(sd)
    T_static = _transmittance(sd_static)
    T_trans = _transmittance(sd_trans)

    prob_static = (T * alpha_static)[..., None]
    prob_trans = (T * alpha_trans)[..., None]
    prob = (T * alpha)[..., None]
    w_static_own = (T_static * alpha_static)[..., None]
    w_trans_own = (T_trans * alpha_trans)[..., None]

    rgb = (rgb_samples[..., 0] * prob_static
           + rgb_samples[..., 1] * prob_trans).sum(dim=-2)
    return dict(
        rgb=rgb,
        rgb_static=(w_static_own * rgb_samples[..., 0]).sum(dim=-2),
        rgb_transient=(w_trans_own * rgb_samples[..., 1]).sum(dim=-2),
        depth=(depth_samples * w_static_own).sum(dim=-2),
        opacity=prob.sum(dim=-2),
        opacity_static=w_static_own.sum(dim=-2),
        opacity_transient=w_trans_own.sum(dim=-2),
        prob=prob,
        uncert=(uncert_samples * prob_trans).sum(dim=-2) + min_uncert,
        alpha_static=alpha_static, alpha_transient=alpha_trans)
