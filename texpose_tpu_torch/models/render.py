"""Ray rendering for the engines (port of texpose_tpu/models/render.py).

JAX's ``lax.map`` over ray chunks becomes a Python loop; every chunk runs
the field and the composite on ``chunk`` rays × N samples, with mid-bin
depth samples.  ``render_rays_nerf`` (the pretrain's coarse field: the mega
forward, the two-kernel route or the plain route, by the gates of
nn/fields.py), ``render_rays_nerf_hierarchical`` (coarse + importance-
sampled fine field) and ``render_st_core`` (the texture model's field, also
the training step's render through models/texture_gan.py::render_patch)
take stratified depth uniforms and the optional density noise from the
caller, and ``training`` (the trunk kernel runs only outside training).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry.rays import cam2world, convert_NDC, img2cam, pixel_grid, to_hom
from ..kernels.composite import fused_composite_coarse, fused_composite_st
from ..nn.fields import (forward_coarse_render, forward_samples_nerf,
                         forward_samples_nerf_raw, forward_samples_nerf_st,
                         forward_samples_nerf_st_raw, forward_st_render,
                         use_fused_coarse_mega, use_fused_coarse_render,
                         use_fused_render, use_fused_st_render)
from ..ops.render import (composite, composite_static_transient,
                          sample_depth, sample_depth_from_pdf,
                          union_sorted_depths)


def ray_batch_sample(values, ray_idx):
    """values [B,HW,C], ray_idx [B,R] → [B,R,C]."""
    return torch.gather(values, 1, ray_idx[..., None].expand(
        -1, -1, values.shape[-1]))


def gather_rays(pose, intr, ray_idx, z_near, z_far, H, W, ndc=False,
                z_pregathered=False):
    """Centers/rays/bounds of the selected pixels: pose [B,3,4], intr
    [B,3,3], ray_idx [B,R], z_near/z_far [B,HW] (or [B,R] when
    z_pregathered) → (center, ray [B,R,3], near, far [B,R])."""
    B, R = ray_idx.shape
    xy = pixel_grid(H, W, pose.dtype, pose.device)[ray_idx.reshape(-1)]
    grid_3D = img2cam(to_hom(xy.reshape(B, R, 2)), intr)
    center = cam2world(torch.zeros_like(grid_3D), pose)
    ray = cam2world(grid_3D, pose) - center
    if z_pregathered:
        near, far = z_near, z_far
    else:
        near = ray_batch_sample(z_near[..., None], ray_idx)[..., 0]
        far = ray_batch_sample(z_far[..., None], ray_idx)[..., 0]
    if ndc:
        center, ray = convert_NDC(center, ray, intr)
    return center, ray, near, far


def render_rays_nerf(nerf, cfg, pose, intr, ray_idx, z_near, z_far,
                     progress=None, compute_dtype=None, depth_rand=None,
                     density_noise=None, training=False):
    """Coarse-NeRF render of the selected rays → dict(rgb [B,R,3], depth
    [B,R,1], opacity [B,R,1]).  depth_rand [B,R,N,1] uniforms make the
    samples stratified, else mid-bin; density_noise [B,R,N] (standard
    normal) is added in training on the plain route, which the gates pick
    for a noisy training config.  Routes, as the JAX package's: the mega
    forward (field + composite kernel), the two-kernel route (field kernel
    → composite kernel, ``kernels.coarse_mega`` off or N ∤ 64), the plain
    route."""
    center, ray, near, far = gather_rays(
        pose, intr, ray_idx, z_near, z_far, cfg.H, cfg.W,
        ndc=cfg.camera.get("ndc", False))
    N = int(cfg.nerf.sample_intvs)
    depth_samples = sample_depth(near, far, N, param=cfg.nerf.depth.param,
                                 rand=depth_rand)
    if use_fused_coarse_render(cfg, N, training):
        if use_fused_coarse_mega(cfg, N, training):
            out = forward_coarse_render(nerf, cfg, center, ray,
                                        depth_samples, progress,
                                        compute_dtype)
        else:
            rgb_raw, dens_raw = forward_samples_nerf_raw(
                nerf, cfg, center, ray, depth_samples, progress,
                compute_dtype)
            out = fused_composite_coarse(rgb_raw, dens_raw, depth_samples,
                                         ray)
        if cfg.nerf.get("setbg_opaque", False):
            out["rgb"] = out["rgb"] + 1.0 * (1.0 - out["opacity"])
        return out
    rgb_s, dens_s = forward_samples_nerf(
        nerf, cfg, center, ray, depth_samples, progress, compute_dtype,
        density_noise if training else None, training)
    out = composite(rgb_s, dens_s, depth_samples, ray,
                    setbg_opaque=cfg.nerf.get("setbg_opaque", False))
    return dict(rgb=out["rgb"], depth=out["depth"], opacity=out["opacity"])


def render_rays_nerf_hierarchical(nerf, nerf_fine, cfg, pose, intr, ray_idx,
                                  z_near, z_far, progress=None,
                                  compute_dtype=None, depth_rand=None,
                                  fine_rand=None, density_noise=None,
                                  density_noise_fine=None, training=False):
    """Coarse + importance-sampled fine render (the JAX package's working
    ``nerf.fine_sampling``) → the coarse dict plus rgb_fine, depth_fine,
    opacity_fine.  Each field goes through ``forward_samples_nerf`` (its
    kernel where ``use_fused_coarse`` holds) and the plain composite; the
    fine depths are drawn from the coarse weights, detached: fine_rand
    [B,R,N_fine] uniforms make them stratified, and density_noise [B,R,N] /
    density_noise_fine [B,R,N+N_fine] are the two fields' training noise."""
    center, ray, near, far = gather_rays(
        pose, intr, ray_idx, z_near, z_far, cfg.H, cfg.W,
        ndc=cfg.camera.get("ndc", False))
    setbg = cfg.nerf.get("setbg_opaque", False)
    depth_samples = sample_depth(near, far, int(cfg.nerf.sample_intvs),
                                 param=cfg.nerf.depth.param, rand=depth_rand)
    rgb_s, dens_s = forward_samples_nerf(
        nerf, cfg, center, ray, depth_samples, progress, compute_dtype,
        density_noise if training else None, training)
    out_c = composite(rgb_s, dens_s, depth_samples, ray, setbg_opaque=setbg)
    fine = sample_depth_from_pdf(depth_samples, out_c["prob"][..., 0].detach(),
                                 int(cfg.nerf.sample_intvs_fine), fine_rand)
    depth_all = union_sorted_depths(depth_samples, fine)
    rgb_f, dens_f = forward_samples_nerf(
        nerf_fine, cfg, center, ray, depth_all, progress, compute_dtype,
        density_noise_fine if training else None, training)
    out_f = composite(rgb_f, dens_f, depth_all, ray, setbg_opaque=setbg)
    return dict(rgb=out_c["rgb"], depth=out_c["depth"],
                opacity=out_c["opacity"], rgb_fine=out_f["rgb"],
                depth_fine=out_f["depth"], opacity_fine=out_f["opacity"])


def render_full_nerf(nerf, cfg, pose, intr, z_near, z_far, progress=None,
                     compute_dtype=None, chunk=None):
    """Whole-frame coarse render in chunks of ``rand_rays`` rays with mid-bin
    samples → dict of [B,HW,C]."""
    B = pose.shape[0]
    HW = cfg.H * cfg.W
    chunks = _chunk_indices(HW, chunk or cfg.nerf.rand_rays, pose.device)
    outs = [render_rays_nerf(nerf, cfg, pose, intr, idx[None].expand(B, -1),
                             z_near, z_far, progress, compute_dtype)
            for idx in chunks]
    return {k: torch.cat([o[k] for o in outs], dim=1)[:, :HW]
            for k in outs[0]}


def render_st_core(nerf, cfg, center, ray, near, far, latent_trans,
                   latent_light, progress=None, compute_dtype=None,
                   depth_rand=None, density_noise=None, training=False):
    """Samples → field → dual composite.  depth_rand [B,R,N,1] uniforms
    make the samples stratified (training), else mid-bin; density_noise
    [B,R,N] is the training density noise's standard normal draw (plain
    route only: the gates send noisy configs there).  Routes, as the JAX
    package's: the render kernels (``use_fused_st_render``: field and
    composite in one kernel per direction), the two-kernel route
    (``use_fused_render``: field kernel → composite kernel), the plain
    route.  The kernel routes return the composite dict with the scalar
    'trans_density_mean'; the plain route adds the per-sample leaves."""
    N = int(cfg.nerf.sample_intvs)
    depth_samples = sample_depth(near, far, N, param=cfg.nerf.depth.param,
                                 rand=depth_rand)
    min_uncert = cfg.nerf.get("min_uncert", 0.05)
    if use_fused_st_render(cfg, nerf, N):
        return forward_st_render(nerf, cfg, center, ray, depth_samples,
                                 latent_trans, latent_light, min_uncert,
                                 progress, compute_dtype)
    if use_fused_render(cfg, nerf):
        rgb_raw, dens_raw, trans_raw = forward_samples_nerf_st_raw(
            nerf, cfg, center, ray, depth_samples, latent_trans,
            latent_light, progress, compute_dtype)
        return fused_composite_st(rgb_raw, trans_raw, dens_raw,
                                  depth_samples, ray, min_uncert)
    rgb_s, dens_s, unc_s = forward_samples_nerf_st(
        nerf, cfg, center, ray, depth_samples, latent_trans, latent_light,
        progress, compute_dtype, density_noise, training)
    out = composite_static_transient(rgb_s, dens_s, depth_samples, ray,
                                     unc_s, min_uncert)
    out["trans_density_mean"] = dens_s[..., -1].mean()
    return out


def render_rays_nerf_st(nerf, cfg, pose, intr, ray_idx, z_near, z_far,
                        latent_trans, latent_light, progress=None,
                        compute_dtype=None, z_pregathered=False):
    """Render the selected rays → dict of per-ray [B,R,C] leaves only."""
    center, ray, near, far = gather_rays(
        pose, intr, ray_idx, z_near, z_far, cfg.H, cfg.W,
        ndc=cfg.camera.get("ndc", False), z_pregathered=z_pregathered)
    out = render_st_core(nerf, cfg, center, ray, near, far, latent_trans,
                         latent_light, progress, compute_dtype)
    return {k: v for k, v in out.items() if v.dim() == 3}


def _chunk_indices(HW, chunk, device):
    """[num_chunks, chunk] ray indices covering 0..HW-1, the last chunk
    padded by repeating the final index."""
    num_chunks = -(-HW // chunk)
    idx = torch.arange(num_chunks * chunk, device=device)
    return torch.clamp(idx, max=HW - 1).reshape(num_chunks, chunk)


def masked_ray_indices(obj_mask, chunk):
    """Host-side object-pixel ray indices padded to a power-of-two multiple
    of `chunk`: obj_mask [HW] → (idx [P] int64, n_valid)."""
    mask = np.asarray(obj_mask).reshape(-1) > 0
    idx = np.nonzero(mask)[0].astype(np.int64)
    n = max(len(idx), 1)
    buckets = chunk * (2 ** max(0, math.ceil(math.log2(n / chunk)))) \
        if n > chunk else chunk
    idx_p = np.pad(idx, (0, buckets - len(idx)),
                   mode="edge" if len(idx) else "constant")
    return idx_p, len(idx)


def _render_chunks(nerf, cfg, pose, intr, chunks, z_near, z_far,
                   latent_trans, latent_light, progress, compute_dtype,
                   z_pregathered):
    """Loop over [NC, chunk] index rows → dict of [B, NC·chunk, C]."""
    B = pose.shape[0]
    outs = []
    for ci, idx in enumerate(chunks):
        idx = idx[None].expand(B, -1)
        zn, zf = z_near, z_far
        if z_pregathered:
            zn, zf = z_near[:, ci], z_far[:, ci]
        outs.append(render_rays_nerf_st(
            nerf, cfg, pose, intr, idx, zn, zf, latent_trans, latent_light,
            progress, compute_dtype, z_pregathered=z_pregathered))
    return {k: torch.cat([o[k] for o in outs], dim=1) for k in outs[0]}


def render_rays_masked_st_pre(nerf, cfg, pose, intr, ray_idx, z_near_pre,
                              z_far_pre, latent_trans, latent_light,
                              progress=None, compute_dtype=None, chunk=None):
    """Render a padded index set ray_idx [P] (P a multiple of chunk) →
    [B,P,C], from bounds z_near_pre / z_far_pre [B,P] already gathered at
    ray_idx."""
    B = pose.shape[0]
    chunk = chunk or cfg.nerf.rand_rays
    NC = ray_idx.shape[0] // chunk
    return _render_chunks(nerf, cfg, pose, intr, ray_idx.reshape(NC, chunk),
                          z_near_pre.reshape(B, NC, chunk),
                          z_far_pre.reshape(B, NC, chunk), latent_trans,
                          latent_light, progress, compute_dtype,
                          z_pregathered=True)


def scatter_masked_st(cfg, out, ray_idx, obj_mask):
    """Scatter [B,P,C] results into full [B,HW,C] buffers with the
    reference's defaults: 0 outside the object, uncert ← min_uncert."""
    B = next(iter(out.values())).shape[0]
    HW = cfg.H * cfg.W
    min_u = cfg.nerf.get("min_uncert", 0.05)
    m = obj_mask.reshape(1, HW, 1) > 0
    full = {}
    for k, v in out.items():
        default = torch.full((B, HW, v.shape[-1]),
                             min_u if k == "uncert" else 0.0,
                             dtype=v.dtype, device=v.device)
        buf = default.clone()
        buf[:, ray_idx] = v
        full[k] = torch.where(m, buf, default)
    return full


def render_full_nerf_st(nerf, cfg, pose, intr, z_near, z_far, latent_trans,
                        latent_light, progress=None, compute_dtype=None,
                        chunk=None, obj_mask=None):
    """Whole-frame render in ray chunks → dict of [B,HW,C]; with obj_mask
    [B,HW], non-object pixels take the reference's defaults."""
    HW = cfg.H * cfg.W
    chunk = chunk or cfg.nerf.rand_rays
    chunks = _chunk_indices(HW, chunk, pose.device)
    out = _render_chunks(nerf, cfg, pose, intr, chunks, z_near, z_far,
                         latent_trans, latent_light, progress, compute_dtype,
                         z_pregathered=False)
    return fill_mask_defaults(cfg, {k: v[:, :HW] for k, v in out.items()},
                              obj_mask)


def fill_mask_defaults(cfg, out, obj_mask=None):
    """The reference's defaults outside obj_mask [B,HW] (None: none):
    uncert ← min_uncert, the colors, opacities and depth ← 0."""
    if obj_mask is None:
        return out
    m = obj_mask[..., None]
    min_u = cfg.nerf.get("min_uncert", 0.05)
    out["uncert"] = out["uncert"] * m + (1 - m) * min_u
    for k in ("rgb", "rgb_static", "rgb_transient", "opacity",
              "opacity_static", "opacity_transient", "depth"):
        out[k] = out[k] * m
    return out
