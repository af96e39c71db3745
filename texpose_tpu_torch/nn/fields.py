"""The NeRF fields (port of texpose_tpu/nn/fields.py): the pretrain's coarse
field, the density-only field and the texture stage's
static/transient/light field.

``NerfCoarse`` holds the 8×256 trunk (``mlp_feat``) and the RGB head
(``mlp_rgb``); the pretrain trains both.  Routes, as in the JAX package:
  * ``apply_nerf`` / ``forward_samples_nerf`` — activated outputs: through
    the coarse field kernel (``apply_nerf_raw``: raw outputs, with grad
    enabled through the autograd Function ``coarse_field`` whose backward
    is the field's backward kernel; kernels/coarse_field.py) when
    ``use_fused_coarse`` holds, else plain PyTorch with the training
    density noise, the trunk through ``run_trunk``;
  * ``forward_coarse_render`` — the coarse field kernel with the composite
    in its epilogue (with grad enabled, the composite and field backward
    kernels); ``use_fused_coarse_mega`` picks it, ``use_fused_coarse_render``
    the two-kernel route (``forward_samples_nerf_raw`` → the composite
    kernel, models/render.py).

``run_trunk`` is JAX's: where the trunk is not trained in the call
(evaluation) it runs the trunk kernel (kernels/trunk.py), else
``apply_trunk`` with the noise.  ``NerfDensity`` is the trunk alone
(``forward_samples_density``, ``composite_density``).

``NerfST`` holds the frozen 8×256 trunk (``mlp_feat``), the light-latent
RGB head (``mlp_rgb``) and the transient head (``mlp_trans``) as
``Dense`` layers with weights stored [in, out], so the checkpoint bridge
maps the JAX npz leaves onto it one to one.  Three forward routes, as in
the JAX package:
  * ``apply_nerf_st`` — activated outputs: through the field kernels
    (``apply_nerf_st_fused``) where ``use_fused_st`` holds, as JAX's, else
    plain PyTorch heads with the trunk through ``run_trunk``;
  * ``apply_nerf_st_raw`` — raw head outputs through the ST-field kernel
    wrapper (kernels/st_field.py), the input of the composite kernel; with
    grad enabled it goes through the autograd Function ``st_field``, whose
    backward is the field's backward kernel;
  * ``forward_st_render`` — field and composite in one kernel per
    direction (kernels/st_render.py), where ``use_fused_st_render`` picks
    it (``kernels.st_mega``), as JAX's mega route.
In the texture stage the trunk is frozen: no route lets a gradient reach
it.  The training-only density noise (``nerf.density_noise_reg``)
takes the plain route, as in the JAX package; the noise is an explicit
standard-normal input drawn by the caller.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..kernels.coarse_field import (ROW_TILE, CoarseFieldWeights,
                                    coarse_field, coarse_field_fwd,
                                    coarse_render, coarse_render_fwd)
from ..kernels.st_field import (STFieldWeights, TrunkWeights, make_xext,
                                st_field, st_field_fwd)
from ..kernels.st_render import fused_st_render
from ..kernels.trunk import trunk_fwd
from ..ops.posenc import c2f_band_weights, posenc_with_identity
from ..ops.render import _dists, composite
from .init import dense_init
from .mlp import DENSITY_ACTIVATIONS, Dense, dense, relu, softplus


def get_layer_dims(layers):
    """[None, h1, ..., out] → [(in,out) per layer]."""
    return list(zip(layers[:-1], layers[1:]))


def _c2f(cfg):
    """The two c2f config shapes → (range, start_freq)."""
    c2f = cfg.get("c2f", None)
    if c2f is None:
        return None, 0
    if isinstance(c2f, dict):
        rng = c2f.get("range", None)
        start = c2f.get("start", None) or 0
        return (tuple(rng) if rng is not None else None), start
    return tuple(c2f), 0


def input_3d_dim(cfg):
    return 3 + 6 * cfg.arch.posenc.L_3D if cfg.arch.get("posenc") else 3


def input_view_dim(cfg):
    if not cfg.arch.get("posenc") or not cfg.arch.posenc.get("L_view"):
        return 3
    return 3 + 6 * cfg.arch.posenc.L_view


def _c2f_band_weights(cfg, L, progress, device=None):
    """Per-frequency window as an [L] vector; ones when c2f is disabled or
    progress is absent."""
    c2f_range, c2f_start = _c2f(cfg)
    if c2f_range is None or progress is None:
        return torch.ones((L,), dtype=torch.float32, device=device)
    return c2f_band_weights(L, progress, c2f_range, c2f_start, device=device)


def _encode_points(cfg, points, progress):
    if cfg.arch.get("posenc"):
        c2f_range, c2f_start = _c2f(cfg)
        return posenc_with_identity(points, cfg.arch.posenc.L_3D, progress,
                                    c2f_range, c2f_start)
    return points


def _encode_view(cfg, ray_unit, progress, c2f=False):
    if cfg.arch.get("posenc") and cfg.arch.posenc.get("L_view"):
        c2f_range, c2f_start = _c2f(cfg) if c2f else (None, 0)
        return posenc_with_identity(ray_unit, cfg.arch.posenc.L_view,
                                    progress, c2f_range, c2f_start)
    return ray_unit


def _layers(generator, dims, first_in, last_mode):
    out = []
    for li, (k_in, k_out) in enumerate(dims):
        if li == 0:
            k_in = first_in
        mode = last_mode if li == len(dims) - 1 else None
        out.append(Dense(*dense_init(generator, k_in, k_out, out_mode=mode)))
    return nn.ModuleList(out)


def init_trunk(cfg, generator=None):
    """The trunk's Dense layers (an ``nn.ModuleList``): layers_feat with
    skip connections, the last layer emitting [density, feat...]."""
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    in3d = input_3d_dim(cfg)
    tf_init = bool(cfg.arch.tf_init)
    trunk = []
    dims = get_layer_dims(cfg.arch.layers_feat)
    for li, (k_in, k_out) in enumerate(dims):
        if li == 0:
            k_in = in3d
        if li in cfg.arch.skip:
            k_in += in3d
        last = li == len(dims) - 1
        if last:
            k_out += 1
        mode = "first" if (tf_init and last) else None
        trunk.append(Dense(*dense_init(generator, k_in, k_out,
                                       out_mode=mode)))
    return nn.ModuleList(trunk)


class NerfCoarse(nn.Module):
    """The pretrain's coarse field: trunk + RGB head on feat ⊕ (view
    encoding) ⊕ pts.  Weights are drawn from ``generator`` (a seeded
    ``torch.Generator``)."""

    def __init__(self, cfg, generator):
        super().__init__()
        self.mlp_feat = init_trunk(cfg, generator)
        self.mlp_rgb = _layers(
            generator, get_layer_dims(cfg.arch.layers_rgb),
            cfg.arch.layers_feat[-1]
            + (input_view_dim(cfg) if cfg.nerf.view_dep else 0) + 3,
            "all" if cfg.arch.tf_init else None)
        self.skip = tuple(cfg.arch.skip)
        self._kernel_weights = None

    def kernel_weights(self):
        """The layers as the coarse field kernel wrapper takes them."""
        if self._kernel_weights is None:
            self._kernel_weights = CoarseFieldWeights(
                self.mlp_feat, self.mlp_rgb, self.skip)
        return self._kernel_weights


def init_nerf(cfg, generator=None):
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return NerfCoarse(cfg, generator)


class NerfDensity(nn.Module):
    """The density-only field: the trunk alone (the JAX package's
    ``init_nerf_density``, a geometry-only utility variant)."""

    def __init__(self, cfg, generator):
        super().__init__()
        self.mlp_feat = init_trunk(cfg, generator)
        self.skip = tuple(cfg.arch.skip)
        self._kernel_weights = None

    def kernel_weights(self):
        """The trunk as the trunk kernel wrapper takes it."""
        if self._kernel_weights is None:
            self._kernel_weights = TrunkWeights(self.mlp_feat, self.skip)
        return self._kernel_weights


def init_nerf_density(cfg, generator=None):
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return NerfDensity(cfg, generator)


class NerfST(nn.Module):
    """Frozen trunk + light-conditioned RGB head + transient head.  Weights
    are drawn from ``generator`` (a seeded ``torch.Generator``)."""

    def __init__(self, cfg, generator):
        super().__init__()
        self.mlp_feat = init_trunk(cfg, generator)
        feat_dim = cfg.arch.layers_feat[-1]
        last_mode = "all" if cfg.arch.tf_init else None
        self.mlp_rgb = _layers(
            generator, get_layer_dims(cfg.arch.layers_rgb),
            feat_dim + (input_view_dim(cfg) if cfg.nerf.view_dep else 0)
            + 3 + cfg.nerf.N_latent_light, last_mode)
        self.mlp_trans = _layers(
            generator, get_layer_dims(cfg.arch.layers_trans),
            feat_dim + cfg.nerf.N_latent_trans, last_mode) \
            if cfg.arch.get("layers_trans") else None
        self.skip = tuple(cfg.arch.skip)
        self._kernel_weights = None

    def kernel_weights(self):
        """The layers as the ST-field kernel wrapper takes them."""
        if self._kernel_weights is None:
            self._kernel_weights = STFieldWeights(
                self.mlp_feat, self.mlp_rgb, self.mlp_trans, self.skip)
        return self._kernel_weights


def init_nerf_st(cfg, generator=None):
    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    return NerfST(cfg, generator)


def apply_trunk(layers, cfg, points_enc, compute_dtype=None,
                density_noise=None):
    """Trunk → (feat [..,F], density [..]); ReLU after every layer, the last
    layer's column 0 is the density.  density_noise (standard normal, the
    density's shape) adds ``nerf.density_noise_reg`` × noise to the raw
    density before its activation (training only)."""
    feat = points_enc
    density = None
    n = len(layers)
    for li, layer in enumerate(layers):
        if li in cfg.arch.skip:
            feat = torch.cat([feat, points_enc], dim=-1)
        feat = dense(layer, feat, compute_dtype)
        if li == n - 1:
            density = feat[..., 0]
            scale = cfg.nerf.get("density_noise_reg")
            if scale and density_noise is not None:
                density = density + density_noise * scale
            density = DENSITY_ACTIVATIONS[cfg.arch.density_activ](density)
            feat = feat[..., 1:]
        feat = relu(feat)
    return feat, density


def run_trunk(nerf, cfg, points, progress=None, compute_dtype=None,
              density_noise=None, training=False):
    """posenc + trunk of ``nerf`` on raw points [...,3] → (feat [...,F],
    density [...]) with the activation (and, in training, the noise)
    applied.  Where the trunk is not trained in this call (not
    ``training``), with posenc and ``kernels.fused_trunk`` (JAX's
    ``_use_fused_trunk`` without its backend clause: the wrapper picks the
    kernel or its twin by device), the trunk kernel runs (kernels/trunk.py;
    its features come rounded to compute_dtype, as every consumer rounds
    them); no gradient reaches the trunk there.  Otherwise ``apply_trunk``
    with the noise."""
    kcfg = cfg.get("kernels") or {}
    if (not training and cfg.arch.get("posenc")
            and kcfg.get("fused_trunk", True)):
        L3 = cfg.arch.posenc.L_3D
        shape = points.shape[:-1]
        pts = points.reshape(-1, 3)
        xext = make_xext(pts, L3, _c2f_band_weights(cfg, L3, progress,
                                                    device=pts.device))
        feat, dens = trunk_fwd(xext, nerf.kernel_weights(), compute_dtype)
        density = DENSITY_ACTIVATIONS[cfg.arch.density_activ](dens)
        return (feat.float().reshape(*shape, feat.shape[-1]),
                density.reshape(shape))
    return apply_trunk(nerf.mlp_feat, cfg,
                       _encode_points(cfg, points, progress), compute_dtype,
                       density_noise)


def _run_head(layers, x, compute_dtype):
    n = len(layers)
    for li, layer in enumerate(layers):
        x = dense(layer, x, compute_dtype)
        if li != n - 1:
            x = relu(x)
    return x


def use_fused_coarse(cfg, training=False):
    """Whether the coarse field takes its kernels (``apply_nerf_raw``): JAX's
    ``_use_fused_coarse`` — ``kernels.fused_coarse``, posenc, no density
    noise in training.  Its row-tile clause is TPU tiling and is dropped:
    the CUDA kernel masks a ragged last tile.  The compute dtype is not part
    of the gate: on the card the kernel computes in bf16 only and its
    wrapper raises for anything else."""
    kcfg = cfg.get("kernels") or {}
    if not kcfg.get("fused_coarse", True) or not cfg.arch.get("posenc"):
        return False
    return not (training and cfg.nerf.get("density_noise_reg"))


def apply_nerf(nerf, cfg, points, ray_unit=None, progress=None,
               compute_dtype=None, density_noise=None, training=False):
    """points [...,3] (+ ray_unit with view_dep: per point [...,3], or per
    ray with one axis fewer) → (rgb [...,3], density [...]).  With
    ``use_fused_coarse`` the field kernel (its twin on the CPU) computes the
    raw outputs and the activations follow here; otherwise the plain route.
    The view encoding takes no c2f window (as the JAX package's coarse
    field)."""
    shape = points.shape[:-1]
    if use_fused_coarse(cfg, training):
        rgb_raw, dens_raw = apply_nerf_raw(nerf, cfg, points, ray_unit,
                                           progress, compute_dtype)
        density = DENSITY_ACTIVATIONS[cfg.arch.density_activ](dens_raw[:, 0])
        return (torch.sigmoid(rgb_raw).reshape(*shape, 3),
                density.reshape(shape))
    feat, density = run_trunk(nerf, cfg, points, progress, compute_dtype,
                              density_noise, training)
    if cfg.nerf.view_dep:
        if ray_unit.dim() == points.dim() - 1:
            ray_unit = ray_unit[..., None, :].expand(points.shape)
        feat = torch.cat([feat, _encode_view(cfg, ray_unit, progress),
                          points], dim=-1)
    else:
        feat = torch.cat([feat, points], dim=-1)
    return torch.sigmoid(_run_head(nerf.mlp_rgb, feat, compute_dtype)), \
        density


def _ray_unit(cfg, ray):
    if not cfg.nerf.view_dep:
        return None
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def forward_samples_nerf(nerf, cfg, center, ray, depth_samples, progress=None,
                         compute_dtype=None, density_noise=None,
                         training=False):
    """center/ray [B,R,3], depth_samples [B,R,N,1] → rgb [B,R,N,3],
    density [B,R,N]."""
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    return apply_nerf(nerf, cfg, pts, _ray_unit(cfg, ray), progress,
                      compute_dtype, density_noise, training)


def coarse_field_inputs(cfg, points, ray_unit=None, progress=None):
    """The coarse field kernel's row inputs for points [...,3]: (xext
    [M,3+6L], enc⊕pts [M,E+3] — pts alone without view_dep) in float32.
    ray_unit may be per ray (one axis fewer than points); its encoding (no
    c2f) is then broadcast over the samples."""
    L3 = cfg.arch.posenc.L_3D
    pts = points.reshape(-1, 3)
    xext = make_xext(pts, L3, _c2f_band_weights(cfg, L3, progress,
                                                device=pts.device))
    if not cfg.nerf.view_dep:
        return xext, pts.float()
    enc = _encode_view(cfg, ray_unit, progress)
    if ray_unit.dim() == points.dim() - 1:
        enc = enc[..., None, :].expand(*points.shape[:-1], enc.shape[-1])
    return xext, torch.cat([enc.reshape(pts.shape[0], -1), pts], dim=1)


def apply_nerf_raw(nerf, cfg, points, ray_unit=None, progress=None,
                   compute_dtype=None):
    """Kernel route of the coarse field: raw outputs (rgb_raw [M,3],
    dens_raw [M,1]), M = the points' rows, no activations — the composite
    kernel's input.  With grad enabled the trunk and the RGB head
    differentiate through ``coarse_field``."""
    xext, ep = coarse_field_inputs(cfg, points, ray_unit, progress)
    op = coarse_field if torch.is_grad_enabled() else coarse_field_fwd
    return op(xext, ep, nerf.kernel_weights(),
              compute_dtype or torch.bfloat16)


def forward_samples_nerf_raw(nerf, cfg, center, ray, depth_samples,
                             progress=None, compute_dtype=None):
    """The raw-output counterpart of ``forward_samples_nerf`` for the
    two-kernel route: (rgb_raw [M,3], dens_raw [M,1])."""
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    return apply_nerf_raw(nerf, cfg, pts, _ray_unit(cfg, ray), progress,
                          compute_dtype)


def forward_coarse_render(nerf, cfg, center, ray, depth_samples,
                          progress=None, compute_dtype=None):
    """Kernel route: field + composite → dict(rgb [B,R,3], depth [B,R,1],
    opacity [B,R,1]).  With grad enabled the trunk and the RGB head
    differentiate through ``coarse_render``; depths and rays take none."""
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    B, R, N, _ = pts.shape
    xext, ep = coarse_field_inputs(cfg, pts, _ray_unit(cfg, ray), progress)
    depth = depth_samples.reshape(B * R, N).detach()
    dist = _dists(depth_samples, ray).reshape(B * R, N).detach()
    op = coarse_render if torch.is_grad_enabled() else coarse_render_fwd
    packed = op(xext, ep, dist, depth, nerf.kernel_weights(),
                compute_dtype or torch.bfloat16)

    def out(lo, hi):
        return packed[:, lo:hi].reshape(B, R, hi - lo)

    return dict(rgb=out(0, 3), depth=out(3, 4), opacity=out(4, 5))


def use_fused_coarse_render(cfg, N, training=False):
    """Whether the coarse render takes a kernel route (JAX's gate of the
    same name): ``use_fused_coarse`` plus ``kernels.fused_composite`` and a
    softplus density (the composite kernels' activation).  Then
    ``use_fused_coarse_mega`` picks between the mega forward and the
    two-kernel route (field kernel → composite kernel).  The JAX gate's
    ray-tile clause is TPU tiling and is dropped."""
    kcfg = cfg.get("kernels") or {}
    if not kcfg.get("fused_composite", True):
        return False
    if cfg.arch.density_activ != "softplus":
        return False
    return use_fused_coarse(cfg, training)


def use_fused_coarse_mega(cfg, N, training=False):
    """Whether the coarse render takes the mega forward (field + composite
    in one kernel): the two-kernel contract, ``kernels.coarse_mega`` not
    off (null means on, as the JAX package's default), and rays that fit
    whole into the kernel's row tile (N | 64)."""
    knob = (cfg.get("kernels") or {}).get("coarse_mega")
    if knob is not None and not knob:
        return False
    return ROW_TILE % int(N) == 0 and use_fused_coarse_render(cfg, N,
                                                              training)


# ------------------------------------------------------- density-only field

def forward_samples_density(nerf, cfg, center, ray, depth_samples,
                            progress=None, compute_dtype=None,
                            density_noise=None, training=False):
    """center/ray [B,R,3], depth_samples [B,R,N,1] → density [B,R,N]
    through ``run_trunk``."""
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    _, density = run_trunk(nerf, cfg, pts, progress, compute_dtype,
                           density_noise, training)
    return density


def composite_density(density_samples, depth_samples, ray):
    """Depth/opacity-only compositing (no RGB head) → dict(depth, opacity,
    prob)."""
    out = composite(torch.zeros(density_samples.shape + (3,),
                                device=density_samples.device),
                    density_samples, depth_samples, ray)
    return dict(depth=out["depth"], opacity=out["opacity"],
                prob=out["prob"])


def apply_nerf_st(nerf, cfg, points, ray_unit, latent_trans, latent_light,
                  progress=None, compute_dtype=None, density_noise=None,
                  training=False):
    """points [B,R,N,3] → (rgb [B,R,N,3,2], density [B,R,N,2],
    uncert [B,R,N,1]).  Where ``use_fused_st`` holds, the field kernels
    compute the raw outputs (``apply_nerf_st_fused``), as JAX's route of
    the same name; else the plain route: the trunk through ``run_trunk``
    (its kernel outside training), its outputs detached (frozen geometry),
    as the JAX package's stop_gradient, and plain PyTorch heads."""
    B, R, N, _ = points.shape
    if use_fused_st(cfg, nerf):
        return apply_nerf_st_fused(nerf, cfg, points, ray_unit, latent_trans,
                                   latent_light, progress, compute_dtype)
    feat, density = run_trunk(nerf, cfg, points, progress, compute_dtype,
                              density_noise, training)
    feat, density = feat.detach(), density.detach()
    if cfg.nerf.view_dep:
        ray_enc = _encode_view(cfg, ray_unit, progress, c2f=True)
        feat_rgb = torch.cat([feat, ray_enc, points], dim=-1)
    else:
        feat_rgb = torch.cat([feat, points], dim=-1)
    light = latent_light[:, None, None, :].expand(B, R, N, -1)
    rgb = torch.sigmoid(_run_head(nerf.mlp_rgb,
                                  torch.cat([feat_rgb, light], dim=-1),
                                  compute_dtype))
    if nerf.mlp_trans is None:
        return rgb, density, None
    trans = latent_trans[:, None, None, :].expand(B, R, N, -1)
    t = _run_head(nerf.mlp_trans, torch.cat([feat, trans], dim=-1),
                  compute_dtype)
    rgb_pair = torch.stack([rgb, torch.sigmoid(t[..., :3])], dim=-1)
    density_pair = torch.stack([density, softplus(t[..., 3])], dim=-1)
    return rgb_pair, density_pair, softplus(t[..., 4:5])


def st_field_inputs(cfg, points, ray_unit, progress=None):
    """The ST-field kernel's row inputs for points [B,R,N,3]: (xext
    [M,3+6L], enc⊕pts [M,E+3]) in float32.  ray_unit may be per ray
    [B,R,3]; its encoding is then broadcast over the samples."""
    B, R, N, _ = points.shape
    L3 = cfg.arch.posenc.L_3D
    pts = points.reshape(-1, 3)
    ray_enc = _encode_view(cfg, ray_unit, progress, c2f=True)
    if ray_unit.dim() == points.dim() - 1:
        ray_enc = ray_enc[..., None, :].expand(B, R, N, ray_enc.shape[-1])
    ray_enc = ray_enc.reshape(pts.shape[0], -1)
    xext = make_xext(pts, L3, _c2f_band_weights(cfg, L3, progress,
                                                device=pts.device))
    return xext, torch.cat([ray_enc, pts], dim=1)


def apply_nerf_st_raw(nerf, cfg, points, ray_unit, latent_trans,
                      latent_light, progress=None, compute_dtype=None):
    """Kernel route: raw head outputs (rgb_raw [M,3], dens_raw [M,1],
    trans_raw [M,5]), M = B·R·N — the composite kernel's input.  With grad
    enabled the heads and latents differentiate through ``st_field``."""
    B, R, N, _ = points.shape
    xext, encpts = st_field_inputs(cfg, points, ray_unit, progress)
    op = st_field if torch.is_grad_enabled() else st_field_fwd
    return op(xext, encpts, latent_light, latent_trans, nerf.kernel_weights(),
              R * N, compute_dtype or torch.bfloat16)


def apply_nerf_st_fused(nerf, cfg, points, ray_unit, latent_trans,
                        latent_light, progress=None, compute_dtype=None):
    """The field kernels' route with the plain activations after them
    (JAX's function of this name): raw outputs from ``apply_nerf_st_raw``,
    then sigmoid / ``density_activ`` / softplus → the outputs of
    ``apply_nerf_st``.  The static density is frozen-trunk output and takes
    no gradient."""
    B, R, N, _ = points.shape
    rgb_raw, dens_raw, trans_raw = apply_nerf_st_raw(
        nerf, cfg, points, ray_unit, latent_trans, latent_light, progress,
        compute_dtype)
    density = DENSITY_ACTIVATIONS[cfg.arch.density_activ](
        dens_raw[:, 0].detach())
    sh = (B, R, N)
    rgb_pair = torch.stack([torch.sigmoid(rgb_raw).reshape(*sh, 3),
                            torch.sigmoid(trans_raw[:, :3]).reshape(*sh, 3)],
                           dim=-1)
    density_pair = torch.stack([density.reshape(sh),
                                softplus(trans_raw[:, 3]).reshape(sh)],
                               dim=-1)
    return rgb_pair, density_pair, softplus(trans_raw[:, 4:5]).reshape(*sh, 1)


def forward_samples_nerf_st(nerf, cfg, center, ray, depth_samples,
                            latent_trans, latent_light, progress=None,
                            compute_dtype=None, density_noise=None,
                            training=False):
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    ray_unit = _ray_unit(cfg, ray)
    if ray_unit is not None:
        ray_unit = ray_unit[..., None, :].expand(pts.shape)
    return apply_nerf_st(nerf, cfg, pts, ray_unit, latent_trans,
                         latent_light, progress, compute_dtype,
                         density_noise, training)


def forward_samples_nerf_st_raw(nerf, cfg, center, ray, depth_samples,
                                latent_trans, latent_light, progress=None,
                                compute_dtype=None):
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    return apply_nerf_st_raw(nerf, cfg, pts, ray_unit, latent_trans,
                             latent_light, progress, compute_dtype)


def use_fused_st(cfg, nerf):
    """Whether the ST field takes its kernels (rows 1/2 through
    ``apply_nerf_st_raw``): JAX's ``_use_fused_st`` — ``kernels.fused_st``,
    view-dependent posenc, a transient head, no density noise.  JAX's
    row-tile clause ((R·N) a multiple of 1024) is TPU tiling and is
    dropped: the CUDA kernels mask a ragged last tile.  In its place stands
    the CUDA kernels' own contract: both heads have at least two layers
    (``STFieldWeights._check_heads``; the backward walks a hidden layer —
    JAX's field kernel also runs 1-layer heads, so such heads take the plain
    route here).  The compute dtype is not part of the gate: on the card
    the field kernels compute in bf16 only and their wrappers raise for
    anything else."""
    kcfg = cfg.get("kernels") or {}
    if not kcfg.get("fused_st", True) or nerf.mlp_trans is None:
        return False
    if not (cfg.arch.get("posenc") and cfg.arch.posenc.get("L_view")
            and cfg.nerf.view_dep):
        return False
    if cfg.nerf.get("density_noise_reg"):
        return False
    return len(nerf.mlp_rgb) >= 2 and len(nerf.mlp_trans) >= 2


def use_fused_render(cfg, nerf):
    """Whether rendering takes a kernel route (ST-field kernel → composite
    kernel on raw outputs, or the render kernels when
    ``use_fused_st_render`` also holds): JAX's gate — the
    ``kernels.fused_composite`` switch, a softplus density (the composite
    kernels' activation) and ``use_fused_st`` (with the port kernels'
    ≥2-layer-heads contract in place of JAX's TPU tile clause)."""
    kcfg = cfg.get("kernels") or {}
    if not kcfg.get("fused_composite", True):
        return False
    if cfg.arch.density_activ != "softplus":
        return False
    return use_fused_st(cfg, nerf)


def use_fused_st_render(cfg, nerf, N):
    """Whether rendering takes the render kernels (field + composite in one
    kernel per direction, kernels/st_render.py): JAX's gate of the same
    name.  The knob is ``kernels.st_mega``, or TEXPOSE_ST_MEGA=1 where that
    key is null (off by default); then ``use_fused_render`` must hold, and
    the route falls back to the two-kernel route on each of JAX's clauses:
    a posenc mode other than xext, split heads off, the trunk fullblock /
    ILP experiments, the TEXPOSE_ST_BWD_FULLBLOCK / _HEADS_FULLBLOCK
    switches (each read as JAX reads it; they pick the route only, the
    math is the same).  JAX's layout clause (``mega_layout_ok``: whole
    rays in every 512-row TPU subtile) is TPU tiling; in its place stands
    the CUDA kernels' own contract, whole rays in every 64-row tile (N
    divides 64), as ``use_fused_coarse_mega``'s."""
    kcfg = cfg.get("kernels") or {}
    knob = kcfg.get("st_mega")
    if knob is None:
        knob = os.environ.get("TEXPOSE_ST_MEGA", "0") == "1"
    if not knob or not use_fused_render(cfg, nerf):
        return False
    enc_mode = kcfg.get("st_posenc") or os.environ.get("TEXPOSE_ST_POSENC",
                                                       "xext")
    split = kcfg.get("st_split_heads")
    if split is None:
        split = os.environ.get("TEXPOSE_ST_SPLIT_HEADS", "1") == "1"
    if enc_mode != "xext" or not split:
        return False
    if kcfg.get("st_trunk_fullblock") or kcfg.get("st_trunk_ilp"):
        return False
    if (os.environ.get("TEXPOSE_ST_BWD_FULLBLOCK", "0") == "1"
            or os.environ.get("TEXPOSE_ST_HEADS_FULLBLOCK", "0") == "1"):
        return False
    return ROW_TILE % int(N) == 0


def forward_st_render(nerf, cfg, center, ray, depth_samples, latent_trans,
                      latent_light, min_uncert, progress=None,
                      compute_dtype=None):
    """Render-kernel route (JAX's function of this name): the field's row
    inputs as ``forward_samples_nerf_st_raw`` builds them (per-ray view
    encodings broadcast over the samples), then ``fused_st_render`` → the
    composite dict with the scalar 'trans_density_mean'.  With grad enabled
    the heads and latents differentiate through its autograd Function."""
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    B, R, N, _ = pts.shape
    ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    xext, encpts = st_field_inputs(cfg, pts, ray_unit, progress)
    return fused_st_render(xext, encpts, latent_light, latent_trans,
                           depth_samples, ray, nerf.kernel_weights(), R * N,
                           compute_dtype or torch.bfloat16, min_uncert)
