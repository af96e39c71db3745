"""The geometry pretrain in plain PyTorch: the reference the
``pretrain.train`` cell's steps and the ``pretrain.eval480`` cell's frames
are compared with.

A step, as TexPose's ``nerf_pretrain`` trains (the configuration
``configs/nerf_lm_pretrain.yaml``): R = rand_rays / n_images rays of every
train image at one shared set of pixels, stratified depths, the 8×256
trunk and the RGB head (both trained), the NeRF composite; the masked
render loss, the scale-invariant depth loss on the eroded mask and the
mask loss (10**w weights); one Adam step on the per-iteration
ExponentialLR schedule.  A frame: every pixel's ray at mid-bin depths
through the same field and composite, then PSNR against the masked image,
SSIM and LPIPS.

``state``: {key: tensor} of ``trunk.*`` and ``rgb.*`` and Adam's
``m.<key>``, ``v.<key>``; ``count``: the updates applied before the step.
"""

from __future__ import annotations

import torch

from . import ops
from .gan import ADAM, moment


def field_keys(state):
    return [k for k in state if k.startswith(("trunk.", "rgb."))]


def field(prec, W, cfg, center, ray, depth):
    """Rays [B,R,3] at depths [B,R,N,1] → rgb [B,R,N,3], density [B,R,N]."""
    pts = center[..., None, :] + ray[..., None, :] * depth
    feat, dens = ops.trunk(prec, W, ops.posenc(
        pts, cfg["arch"]["posenc"]["L_3D"]), cfg["arch"]["skip"])
    rgb = torch.sigmoid(ops.head(prec, W, "rgb", torch.cat([feat, pts], -1)))
    return rgb, ops.softplus(dens)


def pixel_rays(batch, ray_idx, H, W):
    """The rays of pixels ray_idx [R] (centers at +0.5) of every image →
    (center, ray [B,R,3])."""
    ys, xs = torch.div(ray_idx, W, rounding_mode="floor"), ray_idx % W
    xy = torch.stack([xs, ys], -1).float() + 0.5
    B = batch["pose"].shape[0]
    return ops.rays_from_pixels(xy[None].expand(B, -1, -1), batch["intr"],
                                batch["pose"])


def losses(cfg, out, image, mask, mask_obj, depth_gt):
    lw = cfg["loss_weight"]
    loss = {"mask": ((out["opacity"] - mask) ** 2).mean()}
    mn = torch.minimum(out["depth"], depth_gt)
    mx = torch.maximum(out["depth"], depth_gt)
    loss["depth"] = ((1 - mn / (mx + 1e-5)) * mask_obj).sum() \
        / (mask_obj.sum() + 1e-5)
    loss["render"] = (mask_obj * (out["rgb"] - image) ** 2).sum() \
        / (mask_obj.sum() + 1e-5)
    total = sum(10.0 ** float(lw[k]) * v for k, v in loss.items()
                if lw.get(k) is not None)
    loss["all"] = total
    return total, loss


def step(state, count, batch, draws, cfg, prec=None):
    """One pretrain step → (new state, losses, gradients)."""
    prec = prec or ops.Precision()
    H, W_ = batch["image"].shape[-2:]
    B = batch["image"].shape[0]
    ray_idx = draws["ray_idx"]
    center, ray = pixel_rays(batch, ray_idx, H, W_)
    near = batch["z_near"][:, ray_idx]
    far = batch["z_far"][:, ray_idx]
    depth = ops.sample_depth(near, far, int(cfg["nerf"]["sample_intvs"]),
                             draws["depth"])
    keys = field_keys(state)
    Wt = {k: (v.detach().requires_grad_(True) if k in keys else v)
          for k, v in state.items()}
    rgb, dens = field(prec, Wt, cfg, center, ray, depth)
    out = ops.composite(rgb, dens, depth, ray)

    def at(x, c):
        return x.reshape(B, c, H * W_)[:, :, ray_idx].permute(0, 2, 1)

    mask_src = batch["erode_mask"] if cfg["data"].get("erode_mask_loss") \
        else batch["obj_mask"]
    total, loss = losses(cfg, out, at(batch["image"], 3),
                         at(batch["obj_mask"].float(), 1),
                         at(mask_src.float(), 1), at(batch["depth_gt"], 1))
    grads = dict(zip(keys, torch.autograd.grad(total, [Wt[k] for k in keys])))
    b1, b2, eps = ADAM
    o = cfg["optim"]
    lr = o["lr"] * float(o["sched"]["gamma"]) ** count if count > 0 \
        else o["lr"]
    n = count + 1
    new = dict(state)
    for k in keys:
        g = grads[k]
        m = b1 * moment(state, "m." + k, g) + (1 - b1) * g
        v = b2 * moment(state, "v." + k, g) + (1 - b2) * g * g
        new["m." + k], new["v." + k] = m, v
        new[k] = state[k] - lr * (m / (1 - b1 ** n)) / (
            torch.sqrt(v / (1 - b2 ** n)) + eps)
    return ({k: v.detach() for k, v in new.items()},
            {k: v.detach() for k, v in loss.items()},
            {k: v.detach() for k, v in grads.items()})


@torch.no_grad()
def render_frame(W, cfg, pose, intr, z_near, z_far, H, Wd, prec=None,
                 rows=4096):
    """A whole frame at mid-bin depths → (rgb [H,W,3], opacity [H,W]),
    ``rows`` rays at a time."""
    prec = prec or ops.Precision()
    idx = torch.arange(H * Wd, device=pose.device)
    batch = {"pose": pose[None], "intr": intr[None]}
    rgb, opac = [], []
    for s in range(0, H * Wd, rows):
        r = idx[s:s + rows]
        center, ray = pixel_rays(batch, r, H, Wd)
        depth = ops.sample_depth(z_near[r][None], z_far[r][None],
                                 int(cfg["nerf"]["sample_intvs"]))
        c, d = field(prec, W, cfg, center, ray, depth)
        out = ops.composite(c, d, depth, ray)
        rgb.append(out["rgb"][0])
        opac.append(out["opacity"][0, :, 0])
    return torch.cat(rgb).reshape(H, Wd, 3), torch.cat(opac).reshape(H, Wd)


@torch.no_grad()
def frame_metrics(W, rgb, image):
    """(PSNR, SSIM, LPIPS) of rgb against image (masked), [H,W,3] each."""
    a = rgb.permute(2, 0, 1)[None]
    b = image.permute(2, 0, 1)[None]
    return (ops.psnr(rgb, image), ops.ssim(a, b),
            ops.lpips(W, a * 2 - 1, b * 2 - 1).mean())


def halve(batch, draws):
    """The step cut to the first half of the train images."""
    h = batch["image"].shape[0] // 2
    return ({k: v[:h] for k, v in batch.items()},
            {"ray_idx": draws["ray_idx"], "depth": draws["depth"][:h]})
