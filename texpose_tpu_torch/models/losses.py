"""The training losses (port of texpose_tpu/models/losses.py): L1 and
MSE, the pretrain's masked MSE and scale-invariant depth loss, the robust
point loss, the uncertainty-weighted render loss and regularizer, the
transient density regularizer, the Lab chromaticity loss, the GAN losses
with the R1 and WGAN-GP penalties, and the 10**w log-scale weighting.

Under data parallelism (``mesh``, parallel/mesh.py) each batch loss is this
rank's share of the loss over the GLOBAL batch: a masked mean is
Σ_local mask·e / (Σ_ranks mask + ε), a plain mean the local mean over the
world size (equal shards), so the ranks' shares sum to the global loss and
their gradients to the global gradient.  With ``mesh=None`` every function
computes what it always did, bit for bit."""

from __future__ import annotations

import torch

from ..ops.color import normalize_lab, rgb_to_lab
from ..parallel.mesh import global_ratio


def mean_term(x, mesh=None):
    """A plain mean over the batch, or this rank's share of it under data
    parallelism: over equal shards, the local mean over the world size
    (Σ_local / count_global)."""
    return x if mesh is None else x / mesh.size


def l1_loss(pred, label=0.0):
    return (pred - label).abs().mean()


def mse_loss(pred, label=0.0, mesh=None):
    return mean_term(((pred - label) ** 2).mean(), mesh)


def masked_mse_loss(pred, label, mask, eps=1e-5, mesh=None):
    """Σ mask·(pred−label)² / (Σ mask + ε)."""
    num = (mask * (pred - label) ** 2).sum()
    if mesh is not None:
        return global_ratio(num, mask.sum(), mesh, eps)
    return num / (mask.sum() + eps)


def scale_invariant_depth_loss(depth_pred, depth_target, mask=None,
                               mesh=None):
    """1 − min/max ratio.  Where prediction and target tie, min and max each
    pass half of the gradient to both, as jnp.minimum/maximum do."""
    mn = torch.minimum(depth_pred, depth_target)
    mx = torch.maximum(depth_pred, depth_target)
    loss = 1 - mn / (mx + 1e-5)
    if mask is not None:
        mask = mask.to(loss.dtype)
        if mesh is not None:
            return global_ratio((loss * mask).sum(), mask.sum(), mesh, 1e-5)
        return (loss * mask).sum() / (mask.sum() + 1e-5)
    return mean_term(loss.mean(), mesh)


def point_loss(point_pred, point_target, mask):
    """Robust Geman-McClure-style point loss on [B,P,D] points: the
    per-point error's scale c is twice its median over P (no gradient
    through c); mask [B,P,1]."""
    e = torch.linalg.vector_norm(point_pred - point_target, dim=-1,
                                 keepdim=True)
    c = 2 * torch.quantile(e.detach(), 0.5, dim=1, keepdim=True)
    loss = -torch.expm1(-0.5 * (e / c) ** 2)
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / (mask.sum() + 1e-5)


def uncertainty_render_loss(rgb, image, uncert, mask, eps=1e-5, mesh=None):
    """σ²-weighted masked MSE."""
    num = (mask * ((image - rgb) ** 2 / uncert ** 2)).sum()
    if mesh is not None:
        return global_ratio(num, mask.sum(), mesh, eps)
    return num / (mask.sum() + eps)


def uncertainty_reg_loss(uncert, mesh=None):
    """5 + E[log σ²]/2."""
    return mean_term(5.0 + torch.log(uncert ** 2).mean() / 2, mesh)


def transient_reg_loss(density_samples):
    """Mean transient density (the last channel of density_samples)."""
    return density_samples[..., -1].mean()


def smooth_l1(x, y, beta=1.0):
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d ** 2 / beta, d - 0.5 * beta)


def lab_loss(fake, real, mask=None, mesh=None):
    """SmoothL1 on the normalized ab channels → (loss, fake_lab_vis,
    real_lab_vis); the visualizations carry no gradient."""
    fake_lab = normalize_lab(rgb_to_lab(fake))
    real_lab = normalize_lab(rgb_to_lab(real))
    loss = smooth_l1(fake_lab[:, 1:], real_lab[:, 1:])
    if mask is not None and mesh is not None:
        loss = global_ratio((loss * mask).sum(), mask.sum(), mesh)
    elif mask is not None:
        loss = (loss * mask).sum() / mask.sum()
    else:
        loss = mean_term(loss.mean(), mesh)
    fake_vis = fake_lab.detach().clone()
    fake_vis[:, 0] = real_lab[:, 0].detach()
    return loss, fake_vis, real_lab.detach()


def gan_loss(d_out, target, gan_type="standard", mesh=None):
    """d_out [B] logits; target ∈ {0, 1}."""
    if gan_type == "standard":
        return mean_term((torch.clamp_min(d_out, 0) - d_out * float(target)
                       + torch.log1p(torch.exp(-d_out.abs()))).mean(), mesh)
    if gan_type == "wgan":
        return mean_term((2 * target - 1) * d_out.mean(), mesh)
    raise NotImplementedError(gan_type)


def r1_penalty(d_out, x, sel, B, mesh=None):
    """R1-style penalties from ONE discriminator forward: the input
    gradient of Σ sel·D(x) (sel [2B] picks the real and/or fake halves),
    with a graph so the penalty trains D → (real, fake) E‖∇x‖²."""
    g, = torch.autograd.grad(d_out, x, sel, create_graph=True)
    sq = (g ** 2).reshape(g.shape[0], -1).sum(dim=1)
    return mean_term(sq[:B].mean(), mesh), mean_term(sq[B:].mean(), mesh)


def wgan_gp_reg(disc_fn, eps, patch_real, patch_fake, center=1.0,
                mesh=None):
    """WGAN-GP at the interpolates (1−ε)·real + ε·fake; eps [B,1,1,1] is
    the caller's U[0,1) draw."""
    B = patch_real.shape[0]
    x = ((1 - eps) * patch_real + eps * patch_fake).detach()
    x.requires_grad_(True)
    grad, = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    norm2 = (grad ** 2).reshape(B, -1).sum(dim=1)
    return mean_term(((torch.sqrt(norm2 + 1e-12) - center) ** 2).mean(), mesh)


def summarize_loss(loss_dict, loss_weight):
    """Σ 10**w · loss over the keys whose weight is set → (total, dict with
    'all')."""
    total = 0.0
    for key, value in loss_dict.items():
        if key == "all":
            continue
        w = loss_weight.get(key)
        if w is not None:
            total = total + (10.0 ** float(w)) * value
    out = dict(loss_dict)
    out["all"] = total
    return total, out
