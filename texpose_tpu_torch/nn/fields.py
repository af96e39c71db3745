"""The texture stage's static/transient/light field (port of the ST path of
texpose_tpu/nn/fields.py).

``NerfST`` holds the frozen 8×256 trunk (``mlp_feat``), the light-latent
RGB head (``mlp_rgb``) and the transient head (``mlp_trans``) as
``Dense`` layers with weights stored [in, out], so the checkpoint bridge
maps the JAX npz leaves onto it one to one.  Two forward routes, as in
the JAX package:
  * ``apply_nerf_st`` — plain PyTorch, activated outputs;
  * ``apply_nerf_st_raw`` — raw head outputs through the ST-field kernel
    wrapper (kernels/st_field.py), the input of the composite kernel.
This slice evaluates only: the training-only density noise is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.st_field import STFieldWeights, make_xext, st_field_fwd
from ..ops.posenc import c2f_band_weights, posenc_with_identity
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


class NerfST(nn.Module):
    """Frozen trunk + light-conditioned RGB head + transient head.  Weights
    are drawn from ``generator`` (a seeded ``torch.Generator``)."""

    def __init__(self, cfg, generator):
        super().__init__()
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
        self.mlp_feat = nn.ModuleList(trunk)
        feat_dim = cfg.arch.layers_feat[-1]
        last_mode = "all" if tf_init else None
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


def apply_trunk(layers, cfg, points_enc, compute_dtype=None):
    """Trunk → (feat [..,F], density [..]); ReLU after every layer, the last
    layer's column 0 is the density."""
    feat = points_enc
    density = None
    n = len(layers)
    for li, layer in enumerate(layers):
        if li in cfg.arch.skip:
            feat = torch.cat([feat, points_enc], dim=-1)
        feat = dense(layer, feat, compute_dtype)
        if li == n - 1:
            density = DENSITY_ACTIVATIONS[cfg.arch.density_activ](feat[..., 0])
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


def apply_nerf_st(nerf, cfg, points, ray_unit, latent_trans, latent_light,
                  progress=None, compute_dtype=None):
    """Plain route: points [B,R,N,3] → (rgb [B,R,N,3,2], density [B,R,N,2],
    uncert [B,R,N,1])."""
    B, R, N, _ = points.shape
    feat, density = apply_trunk(nerf.mlp_feat, cfg,
                                _encode_points(cfg, points, progress),
                                compute_dtype)
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
    trans_raw [M,5]), M = B·R·N — the composite kernel's input."""
    B, R, N, _ = points.shape
    xext, encpts = st_field_inputs(cfg, points, ray_unit, progress)
    return st_field_fwd(xext, encpts, latent_light, latent_trans,
                        nerf.kernel_weights(), R * N,
                        compute_dtype or torch.bfloat16)


def forward_samples_nerf_st(nerf, cfg, center, ray, depth_samples,
                            latent_trans, latent_light, progress=None,
                            compute_dtype=None):
    pts = center[..., None, :] + ray[..., None, :] * depth_samples
    ray_unit = None
    if cfg.nerf.view_dep:
        ray_unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
        ray_unit = ray_unit[..., None, :].expand(pts.shape)
    return apply_nerf_st(nerf, cfg, pts, ray_unit, latent_trans,
                         latent_light, progress, compute_dtype)


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
    view-dependent posenc, a transient head, ≥2-layer heads, the
    ``kernels.fused_st`` / ``kernels.fused_composite`` switches).  The
    compute dtype is not part of the gate: on the card the field kernel
    computes in bf16 only and its wrapper raises for anything else."""
    kcfg = cfg.get("kernels") or {}
    if not (kcfg.get("fused_st", True) and kcfg.get("fused_composite", True)):
        return False
    if cfg.arch.density_activ != "softplus" or nerf.mlp_trans is None:
        return False
    if not (cfg.arch.get("posenc") and cfg.arch.posenc.get("L_view")
            and cfg.nerf.view_dep):
        return False
    return len(nerf.mlp_rgb) >= 2 and len(nerf.mlp_trans) >= 2
