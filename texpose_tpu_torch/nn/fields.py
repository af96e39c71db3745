"""The NeRF fields (port of texpose_tpu/nn/fields.py): the pretrain's coarse
field and the texture stage's static/transient/light field.

``NerfCoarse`` holds the 8×256 trunk (``mlp_feat``) and the RGB head
(``mlp_rgb``); the pretrain trains both.  Two routes, as in the JAX
package: ``apply_nerf`` / ``forward_samples_nerf`` (plain PyTorch, with the
training density noise of ``apply_trunk``) and ``forward_coarse_render``
(the coarse field kernel with the composite in its epilogue,
kernels/coarse_field.py; with grad enabled its autograd Function runs the
composite and field backward kernels).  ``use_fused_coarse_render`` picks.

``NerfST`` holds the frozen 8×256 trunk (``mlp_feat``), the light-latent
RGB head (``mlp_rgb``) and the transient head (``mlp_trans``) as
``Dense`` layers with weights stored [in, out], so the checkpoint bridge
maps the JAX npz leaves onto it one to one.  Two forward routes, as in
the JAX package:
  * ``apply_nerf_st`` — plain PyTorch, activated outputs;
  * ``apply_nerf_st_raw`` — raw head outputs through the ST-field kernel
    wrapper (kernels/st_field.py), the input of the composite kernel; with
    grad enabled it goes through the autograd Function ``st_field``, whose
    backward is the field's backward kernel.
In the texture stage the trunk is frozen: neither route lets a gradient
reach it.  The training-only density noise (``nerf.density_noise_reg``)
takes the plain route, as in the JAX package; the noise is an explicit
standard-normal input drawn by the caller.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.coarse_field import (ROW_TILE, CoarseFieldWeights,
                                    coarse_render, coarse_render_fwd)
from ..kernels.st_field import (STFieldWeights, make_xext, st_field,
                                st_field_fwd)
from ..ops.posenc import c2f_band_weights, posenc_with_identity
from ..ops.render import _dists
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


def _trunk(cfg, generator):
    """The trunk's Dense layers: layers_feat with skip connections, the last
    layer emitting [density, feat...]."""
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
        self.mlp_feat = _trunk(cfg, generator)
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


class NerfST(nn.Module):
    """Frozen trunk + light-conditioned RGB head + transient head.  Weights
    are drawn from ``generator`` (a seeded ``torch.Generator``)."""

    def __init__(self, cfg, generator):
        super().__init__()
        self.mlp_feat = _trunk(cfg, generator)
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


def _run_head(layers, x, compute_dtype):
    n = len(layers)
    for li, layer in enumerate(layers):
        x = dense(layer, x, compute_dtype)
        if li != n - 1:
            x = relu(x)
    return x


def apply_nerf(nerf, cfg, points, ray_unit=None, progress=None,
               compute_dtype=None, density_noise=None):
    """Plain route: points [...,3] (+ ray_unit [...,3] with view_dep) →
    (rgb [...,3], density [...]); the trunk trains.  The view encoding takes
    no c2f window (as the JAX package's coarse field)."""
    feat, density = apply_trunk(nerf.mlp_feat, cfg,
                                _encode_points(cfg, points, progress),
                                compute_dtype, density_noise)
    if cfg.nerf.view_dep:
        feat = torch.cat([feat, _encode_view(cfg, ray_unit, progress),
                          points], dim=-1)
    else:
        feat = torch.cat([feat, points], dim=-1)
    return torch.sigmoid(_run_head(nerf.mlp_rgb, feat, compute_dtype)), \
        density


def forward_samples_nerf(nerf, cfg, center, ray, depth_samples, progress=None,
                         compute_dtype=None, density_noise=None):
    """center/ray [B,R,3], depth_samples [B,R,N,1] → rgb [B,R,N,3],
    density [B,R,N]."""
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    ray_unit = None
    if cfg.nerf.view_dep:
        ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        ray_unit = ray_unit[..., None, :].expand(pts.shape)
    return apply_nerf(nerf, cfg, pts, ray_unit, progress, compute_dtype,
                      density_noise)


def coarse_field_inputs(cfg, points, ray_unit=None, progress=None):
    """The coarse field kernel's row inputs for points [B,R,N,3]: (xext
    [M,3+6L], enc⊕pts [M,E+3] — pts alone without view_dep) in float32.
    ray_unit is per ray [B,R,3]; its encoding (no c2f) is broadcast over
    the samples."""
    B, R, N, _ = points.shape
    L3 = cfg.arch.posenc.L_3D
    pts = points.reshape(-1, 3)
    xext = make_xext(pts, L3, _c2f_band_weights(cfg, L3, progress,
                                                device=pts.device))
    if not cfg.nerf.view_dep:
        return xext, pts.float()
    enc = _encode_view(cfg, ray_unit, progress)
    enc = enc[..., None, :].expand(B, R, N, enc.shape[-1])
    return xext, torch.cat([enc.reshape(pts.shape[0], -1), pts], dim=1)


def forward_coarse_render(nerf, cfg, center, ray, depth_samples,
                          progress=None, compute_dtype=None):
    """Kernel route: field + composite → dict(rgb [B,R,3], depth [B,R,1],
    opacity [B,R,1]).  With grad enabled the trunk and the RGB head
    differentiate through ``coarse_render``; depths and rays take none."""
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    B, R, N, _ = pts.shape
    ray_unit = (ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
                if cfg.nerf.view_dep else None)
    xext, ep = coarse_field_inputs(cfg, pts, ray_unit, progress)
    depth = depth_samples.reshape(B * R, N).detach()
    dist = _dists(depth_samples, ray).reshape(B * R, N).detach()
    op = coarse_render if torch.is_grad_enabled() else coarse_render_fwd
    packed = op(xext, ep, dist, depth, nerf.kernel_weights(),
                compute_dtype or torch.bfloat16)

    def out(lo, hi):
        return packed[:, lo:hi].reshape(B, R, hi - lo)

    return dict(rgb=out(0, 3), depth=out(3, 4), opacity=out(4, 5))


def use_fused_coarse_render(cfg, N, training=False):
    """Whether the coarse render takes the kernel route: the JAX gates'
    contract (``kernels.fused_coarse`` and ``kernels.fused_composite``,
    posenc, softplus density, no density noise in training).  The JAX
    package's other fused route — the two-kernel field → composite path,
    taken with ``kernels.coarse_mega`` off or rays that do not fit whole
    into the kernel's row tile — needs kernels not ported yet, so those
    configurations raise instead of running plain.  The compute dtype is
    not part of the gate: on the card the kernel computes in bf16 only and
    its wrapper raises for anything else."""
    kcfg = cfg.get("kernels") or {}
    if not (kcfg.get("fused_coarse", True)
            and kcfg.get("fused_composite", True)):
        return False
    if not cfg.arch.get("posenc") or cfg.arch.density_activ != "softplus":
        return False
    if training and cfg.nerf.get("density_noise_reg"):
        return False
    if kcfg.get("coarse_mega") is False or ROW_TILE % int(N):
        raise NotImplementedError(
            f"the two-kernel coarse route (kernels.coarse_mega="
            f"{kcfg.get('coarse_mega')}, {N} samples per ray, row tile "
            f"{ROW_TILE}) needs the coarse field and composite forward "
            "kernels, not ported yet (ROADMAP.md, Queue 2 rows 7a/9a)")
    return True


def apply_nerf_st(nerf, cfg, points, ray_unit, latent_trans, latent_light,
                  progress=None, compute_dtype=None, density_noise=None):
    """Plain route: points [B,R,N,3] → (rgb [B,R,N,3,2], density [B,R,N,2],
    uncert [B,R,N,1]).  The trunk's outputs are detached (frozen
    geometry), as the JAX package's stop_gradient."""
    B, R, N, _ = points.shape
    feat, density = apply_trunk(nerf.mlp_feat, cfg,
                                _encode_points(cfg, points, progress),
                                compute_dtype, density_noise)
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


def forward_samples_nerf_st(nerf, cfg, center, ray, depth_samples,
                            latent_trans, latent_light, progress=None,
                            compute_dtype=None, density_noise=None):
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    ray_unit = None
    if cfg.nerf.view_dep:
        ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        ray_unit = ray_unit[..., None, :].expand(pts.shape)
    return apply_nerf_st(nerf, cfg, pts, ray_unit, latent_trans,
                         latent_light, progress, compute_dtype,
                         density_noise)


def forward_samples_nerf_st_raw(nerf, cfg, center, ray, depth_samples,
                                latent_trans, latent_light, progress=None,
                                compute_dtype=None):
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    return apply_nerf_st_raw(nerf, cfg, pts, ray_unit, latent_trans,
                             latent_light, progress, compute_dtype)


def use_fused_render(cfg, nerf):
    """Whether rendering takes the kernel route (ST-field kernel → composite
    kernel on raw outputs): the JAX gate's contract (softplus density,
    view-dependent posenc, a transient head, ≥2-layer heads, no training
    density noise, the ``kernels.fused_st`` / ``kernels.fused_composite``
    switches).  The compute dtype is not part of the gate: on the card the
    field kernel computes in bf16 only and its wrapper raises for anything
    else."""
    kcfg = cfg.get("kernels") or {}
    if not (kcfg.get("fused_st", True) and kcfg.get("fused_composite", True)):
        return False
    if cfg.nerf.get("density_noise_reg"):
        return False
    if cfg.arch.density_activ != "softplus" or nerf.mlp_trans is None:
        return False
    if not (cfg.arch.get("posenc") and cfg.arch.posenc.get("L_view")
            and cfg.nerf.view_dep):
        return False
    return len(nerf.mlp_rgb) >= 2 and len(nerf.mlp_trans) >= 2
