"""Patch discriminator (port of texpose_tpu/nn/discriminator.py): a
spectral-norm DCGAN conv stack with instance norm, scale- and
geometry-conditioned.

Parameters keep the JAX layout — {"main": [w], "final": [w]} with each w
an HWIO [kh,kw,in,out] tensor — so the checkpoint bridge is a rename; the
spectral-norm power-iteration vectors u are explicit state
({"main": [u], "final": [u]}).  σ always comes from one power iteration
(v = ‖Wu‖-normalized, u_new = ‖Wᵀv‖-normalized, σ = vᵀ W u_new); with
``training`` the new u is kept, else the old one is returned.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.posenc import positional_encoding
from .mlp import leaky_relu


def _normalize(v):
    return v / (torch.linalg.norm(v) + 1e-12)


def sn_apply(w, u, training):
    """(w/σ, new u); gradients flow through w only (u, v detached)."""
    kh, kw, cin, cout = w.shape
    w_mat = w.reshape(kh * kw * cin, cout)
    w_sg = w_mat.detach()
    v = _normalize(w_sg @ u)
    u_new = _normalize(w_sg.t() @ v)
    sigma = v @ (w_mat @ u_new)
    return w / sigma, (u_new if training else u).detach()


def instance_norm(x, eps=1e-5):
    """Affine-free per-sample, per-channel spatial normalization."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


def _conv(x, w, stride, padding):
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride,
                    padding=padding)


def _main_spec(imsize, nc, ndf, final_dim):
    """(kh, in, out, stride, pad, instance-norm) per conv."""
    if imsize == 128:
        spec = [(4, nc, ndf // 2, 2, 1, False),
                (4, ndf // 2, ndf, 2, 1, True),
                (4, ndf, ndf * 2, 2, 1, True),
                (4, ndf * 2, ndf * 4, 2, 1, True)]
    elif imsize == 64:
        spec = [(4, nc, ndf, 2, 1, False),
                (4, ndf, ndf * 2, 2, 1, True),
                (4, ndf * 2, ndf * 4, 2, 1, True)]
    elif imsize == 32:
        spec = [(4, nc, ndf * 2, 2, 1, True),
                (4, ndf * 2, ndf * 4, 2, 1, True)]
    elif imsize == 16:
        spec = [(4, nc, ndf * 4, 2, 1, True)]
    else:
        raise NotImplementedError(f"imsize {imsize}")
    return spec + [(4, ndf * 4, ndf * 8, 2, 1, True),
                   (4, ndf * 8, final_dim, 1, 0, False)]


def disc_channels(cfg):
    nc = 3
    if cfg.gan.geo_conditional:
        nc += 6
    if cfg.gan.get("L_nocs"):
        nc += cfg.gan.L_nocs * 2 * 3
    if cfg.gan.get("L_normal"):
        nc += cfg.gan.L_normal * 2 * 3
    return nc


def init_discriminator(generator, cfg, ndf=64, device=None):
    """(params, sn_state): N(0, 0.02) HWIO kernels, u = 1/√out."""
    nc = disc_channels(cfg)
    final_dim = ndf if cfg.gan.scale_conditional else 1
    shapes = [(k, k, cin, cout) for k, cin, cout, *_ in
              _main_spec(cfg.patch_size, nc, ndf, final_dim)]
    head = []
    if cfg.gan.scale_conditional:
        head_in = ndf + cfg.gan.L_scale * 2 + 1
        head = [(1, 1, cin, cout)
                for cin, cout in [(head_in, ndf), (ndf, ndf), (ndf, 1)]]
    params, state = {}, {}
    for grp, grp_shapes in (("main", shapes), ("final", head)):
        params[grp] = [(torch.randn(s, generator=generator) * 0.02).to(device)
                       for s in grp_shapes]
        state[grp] = [torch.ones((s[-1],), device=device) / s[-1] ** 0.5
                      for s in grp_shapes]
    return params, state


def _posenc_image(x, L, progress=None, c2f_range=None):
    """[B,C,h,w] → [B,2CL,h,w] (frequency-major per channel)."""
    B, C, h, w = x.shape
    flat = x.reshape(B, C, h * w).transpose(1, 2)
    enc = positional_encoding(flat, L, progress, c2f_range)
    return enc.transpose(1, 2).reshape(B, 2 * C * L, h, w)


def sn_normalize_disc(params, state, training=True):
    """Spectrally normalize every kernel once → (normalized params, new
    u-state); every pass of a step reuses the normalized weights."""
    out, new_state = {}, {}
    for grp in ("main", "final"):
        pairs = [sn_apply(w, u, training)
                 for w, u in zip(params.get(grp, []), state.get(grp, []))]
        out[grp] = [p[0] for p in pairs]
        new_state[grp] = [p[1] for p in pairs]
    return out, new_state


def apply_discriminator(params, state, cfg, x, scales=None, progress=None,
                        training=True, normalized=False):
    """x [B,nc_raw,h,w] (rgb | rgb+nocs+normal), scales [B,1,1,1] →
    (logits [B], new sn_state).  normalized=True: params already hold the
    normalized kernels and state passes through."""
    if not normalized:
        params, state = sn_normalize_disc(params, state, training)
    ndf = params["main"][-2].shape[-1] // 8
    nc = disc_channels(cfg)
    final_dim = ndf if cfg.gan.scale_conditional else 1
    spec = _main_spec(cfg.patch_size, nc, ndf, final_dim)
    inputs = x
    if cfg.gan.geo_conditional:
        image, nocs, normal = torch.split(x, x.shape[1] // 3, dim=1)
        parts = [image, nocs, normal]
        c2f = cfg.gan.get("geo_c2f")
        c2f = tuple(c2f) if c2f is not None else None
        if cfg.gan.get("L_nocs"):
            parts.append(_posenc_image(nocs, cfg.gan.L_nocs, progress, c2f))
        if cfg.gan.get("L_normal"):
            # the reference encodes the normals with L_nocs too
            parts.append(_posenc_image(normal, cfg.gan.L_nocs, progress,
                                       c2f))
        inputs = torch.cat(parts, dim=1)
    out = inputs
    for i, (_, _, _, stride, pad, use_in) in enumerate(spec):
        out = _conv(out, params["main"][i], stride, pad)
        if use_in:
            out = instance_norm(out)
        if i != len(spec) - 1:
            out = leaky_relu(out)
    if cfg.gan.scale_conditional:
        scale_enc = _posenc_image(scales, cfg.gan.L_scale)
        out = leaky_relu(torch.cat([out, scale_enc, scales], dim=1))
        for j, w in enumerate(params["final"]):
            out = _conv(out, w, 1, 0)
            if j != len(params["final"]) - 1:
                out = leaky_relu(out)
    return out.reshape(out.shape[0], -1).squeeze(-1), state
