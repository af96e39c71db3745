"""The texture GAN's training step in plain PyTorch: the reference the
``gan.train`` cell's steps are compared with.

One step, as TexPose's ``nerf_adapt_st_gan`` trains (the configuration
``configs/nerf_lm_adapt_gan.yaml``): B patches at annealed random scales
and shifts, their rays and stratified depths, the frozen trunk, the
light-latent RGB head and the transient head, the NeRF-W composite; the
uncertainty-weighted render loss, the uncertainty and transient
regularizers, the VGG19 perceptual loss and the generator's GAN loss
(10**w weights); one Adam step (ExponentialLR stepped once an epoch) on
the heads and the whole latent tables.  Then the discriminator on [real;
fake] from the pre-update render: one spectral normalization, the
standard GAN losses, the R1 penalty on the real half, one RMSprop step.

``state``: {key: tensor} of the trained leaves (``rgb.*``, ``trans.*``,
``latent.*``, ``disc.*``), the frozen ones (``trunk.*``, ``vgg.*``), the
spectral-norm vectors ``sn.<grp>.<i>``, Adam's ``m.<key>``, ``v.<key>``
and RMSprop's ``nu.<key>``; ``count``: the updates applied before the
step.  ``batch``: the uploaded train split; ``draws``: the step's idx
[B], patch [3,B,1,1,1] and depth [B,p²,N,1] uniforms.
"""

from __future__ import annotations

import math

import torch

from . import ops

ADAM = (0.9, 0.999, 1e-8)
RMSPROP = (0.99, 1e-8)
# faults the comparison must catch, planted by configuration keys: the
# critic's R1 term switched off (its weight 10**-inf)
FAULTS = {"r1_off": {"loss_weight.gan_reg_real": float("-inf")}}


def adam_keys(state):
    return [k for k in state if k.startswith(("rgb.", "trans.", "latent."))]


def moment(state, key, like):
    """An optimizer moment of the state; zeros where the optimizer has
    made none yet."""
    return state[key] if key in state else torch.zeros_like(like)


def disc_keys(state):
    return sorted((k for k in state if k.startswith("disc.")),
                  key=lambda k: (k.split(".")[1] != "main",
                                 int(k.split(".")[2])))


def patch_coords(uniforms, p, count, pc):
    """Annealed random-scale, random-shift patch coordinates → (coords
    [B,p,p,2] in [-1, 1], scales [B,1,1,1])."""
    u_scale, u_h, u_w = uniforms
    hi = float(pc["max_scale"])
    lo = min(max(hi * math.exp(-count * pc["scale_anneal"]),
                 pc["min_scale"]), 0.8)
    scales = u_scale * (hi - lo) + lo
    lin = torch.linspace(-1.0, 1.0, p, device=uniforms.device)
    grid = torch.stack([lin[None, :].expand(p, p), lin[:, None].expand(p, p)],
                       dim=-1)
    off = torch.cat([(u_h * 2 - 1) * (1 - scales),
                     (u_w * 2 - 1) * (1 - scales)], dim=-1)
    return grid[None] * scales + off, scales


def render(prec, W, cfg, batch, idx, coords, depth_rand):
    """The patches' render → (rgb [B,3,p,p], uncert [B,R,1], transient
    density mean)."""
    B, p = coords.shape[0], coords.shape[1]
    H, Wd = batch["image"].shape[-2:]
    pose, intr = batch["pose_init"][idx], batch["intr"][idx]
    u = (coords[..., 0] + 1) / 2 * (Wd - 1)
    v = (coords[..., 1] + 1) / 2 * (H - 1)
    center, ray = ops.rays_from_pixels(
        torch.stack([u, v], dim=-1).reshape(B, p * p, 2), intr, pose)
    zn = batch["z_near"][idx].reshape(B, 1, H, Wd).float()
    zf = batch["z_far"][idx].reshape(B, 1, H, Wd).float()
    near = ops.grid_sample(zn, coords, align_corners=True)[:, 0]
    far = ops.grid_sample(zf, coords, align_corners=True)[:, 0]
    N = int(cfg["nerf"]["sample_intvs"])
    depth = ops.sample_depth(near.reshape(B, -1), far.reshape(B, -1), N,
                             depth_rand)
    pts = center[..., None, :] + ray[..., None, :] * depth
    with torch.no_grad():
        feat, dens = ops.trunk(prec, W, ops.posenc(
            pts, cfg["arch"]["posenc"]["L_3D"]), cfg["arch"]["skip"])
    unit = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    view = ops.posenc(unit, cfg["arch"]["posenc"]["L_view"])
    view = view[..., None, :].expand(*pts.shape[:-1], view.shape[-1])
    lat_t = W["latent.trans"][idx][:, None, None, :].expand(
        *pts.shape[:-1], -1)
    lat_l = W["latent.light"][idx][:, None, None, :].expand(
        *pts.shape[:-1], -1)
    rgb_s = torch.sigmoid(ops.head(prec, W, "rgb",
                                   torch.cat([feat, view, pts, lat_l], -1)))
    t = ops.head(prec, W, "trans", torch.cat([feat, lat_t], -1))
    rgb = torch.stack([rgb_s, torch.sigmoid(t[..., :3])], dim=-1)
    density = torch.stack([ops.softplus(dens), ops.softplus(t[..., 3])],
                          dim=-1)
    out = ops.composite_dual(rgb, density, depth, ray,
                             ops.softplus(t[..., 4:5]),
                             cfg["nerf"]["min_uncert"])
    img = out["rgb"].reshape(B, p, p, 3).permute(0, 3, 1, 2)
    return img, out["uncert"], density[..., 1].mean()


def supervision(batch, idx, coords):
    """The patches of the split's images and maps at coords."""
    B = idx.shape[0]
    H, Wd = batch["image"].shape[-2:]

    def mask_of(key):
        return (batch[key][idx] > 0).float().reshape(B, 1, H, Wd)

    out = {"image": ops.grid_sample(batch["image"][idx], coords,
                                    align_corners=True),
           "mask": ops.grid_sample(mask_of("obj_mask"), coords, "nearest"),
           "image_syn": ops.grid_sample(batch["image_syn"][idx], coords,
                                        align_corners=True),
           "mask_syn": ops.grid_sample(mask_of("mask_syn"), coords,
                                       "nearest")}
    for key, src in (("nocs", "nocs_pred"), ("normal", "normal_pred")):
        out[key] = ops.grid_sample(batch[src][idx], coords,
                                   align_corners=True) * out["mask_syn"]
    return out


def normalized_disc(state, training):
    """The spectrally normalized kernels → ({grp: [w]}, {grp: [u]})."""
    ws, us = {"main": [], "final": []}, {"main": [], "final": []}
    for k in disc_keys(state):
        grp = k.split(".")[1]
        w, u = ops.spectral_norm(state[k], state["sn." + k[5:]])
        ws[grp].append(w)
        us[grp].append(u)
    return ws, us


def step(state, count, batch, draws, cfg, prec=None):
    """One generator + discriminator step → (new state, losses {name:
    float tensor}, gradients {key: tensor} as the optimizers got them)."""
    prec = prec or ops.Precision()
    lw = {k: v for k, v in cfg["loss_weight"].items() if v is not None}
    p = int(cfg["patch_size"])
    idx = draws["idx"]
    coords, scales = patch_coords(draws["patch"], p, count, cfg["patch"])
    W = {k: (v.detach().requires_grad_(True) if k in adam_keys(state)
             else v) for k, v in state.items()}
    rgb, uncert, trans_mean = render(prec, W, cfg, batch, idx, coords,
                                     draws["depth"])
    sup = supervision(batch, idx, coords)
    mask, image = sup["mask"], sup["image"]
    unc_img = uncert.reshape(rgb.shape[0], p, p, 1).permute(0, 3, 1, 2)
    loss = {"render": (mask * ((image - rgb) ** 2 / unc_img ** 2)).sum()
            / (mask.sum() + 1e-5),
            "uncert": 5.0 + torch.log(uncert ** 2).mean() / 2,
            "trans_reg": trans_mean}
    mask_pad = ((sup["mask_syn"] == 1) & (mask == 0)).to(rgb.dtype)
    pairs = [(rgb, image * mask + sup["image_syn"] * mask_pad, 1.0),
             (rgb * mask + image * (1 - mask), image, 5.0)]
    feats = ops.vgg_features(prec, W, torch.cat(
        [x for f, r, _ in pairs for x in (f, r)], dim=0))
    B = rgb.shape[0]
    loss["feat"] = sum(w * ((feats[2 * i * B:(2 * i + 1) * B]
                             - feats[(2 * i + 1) * B:(2 * i + 2) * B]
                             .detach()) ** 2).mean()
                       for i, (_, _, w) in enumerate(pairs))
    geo = [sup["nocs"], sup["normal"]]
    frozen, _ = normalized_disc({k: v.detach() for k, v in state.items()},
                                training=False)
    L_scale = cfg["gan"]["L_scale"]
    loss["gan_nerf"] = ops.gan_loss(ops.discriminator(
        frozen["main"], frozen["final"], torch.cat([rgb] + geo, 1), scales,
        L_scale), 1)
    total = sum(10.0 ** float(lw[k]) * v for k, v in loss.items())
    loss["all"] = total
    keys = adam_keys(state)
    grads = dict(zip(keys, torch.autograd.grad(total, [W[k] for k in keys])))

    new = dict(state)
    b1, b2, eps = ADAM
    o = cfg["optim"]
    spe = max(int(cfg["n_images"]) // int(cfg["batch_size"]), 1)
    lr = o["lr"] * float(o["sched"]["gamma"]) ** (count // spe) \
        if count > 0 else o["lr"]
    n = count + 1
    for k in keys:
        g = grads[k]
        m = b1 * moment(state, "m." + k, g) + (1 - b1) * g
        v = b2 * moment(state, "v." + k, g) + (1 - b2) * g * g
        new["m." + k], new["v." + k] = m, v
        upd = (m / (1 - b1 ** n)) / (torch.sqrt(v / (1 - b2 ** n)) + eps)
        new[k] = state[k] - lr * upd

    # the discriminator, from the pre-update render
    rgb_d = rgb.detach()
    real = torch.cat([image * mask + rgb_d * mask_pad] + geo, 1)
    fake = torch.cat([rgb_d] + geo, 1)
    dk = disc_keys(state)
    D = {k: state[k].detach().requires_grad_(True) for k in dk}
    ws, us = normalized_disc({**state, **D}, training=True)
    both = torch.cat([real, fake], 0).requires_grad_(True)
    logits = ops.discriminator(ws["main"], ws["final"], both,
                               torch.cat([scales, scales], 0), L_scale)
    dloss = {"gan_disc_real": ops.gan_loss(logits[:B], 1),
             "gan_disc_fake": ops.gan_loss(logits[B:], 0)}
    sel = torch.cat([torch.ones(B, device=logits.device),
                     torch.zeros(B, device=logits.device)])
    g_in, = torch.autograd.grad(logits, both, sel, create_graph=True)
    dloss["gan_reg_real"] = (g_in ** 2).reshape(2 * B, -1).sum(1)[:B].mean()
    dtotal = sum(10.0 ** float(lw[k]) * v for k, v in dloss.items())
    dgrads = dict(zip(dk, torch.autograd.grad(dtotal, [D[k] for k in dk])))
    d, eps = RMSPROP
    dlr = cfg["optim_disc"]["lr"]
    for k in dk:
        g = dgrads[k]
        nu = d * moment(state, "nu." + k, g) + (1 - d) * g * g
        new["nu." + k] = nu
        new[k] = state[k] - dlr * g / (torch.sqrt(nu) + eps)
    for grp in ("main", "final"):
        for i, u in enumerate(us[grp]):
            new[f"sn.{grp}.{i}"] = u
    grads.update(dgrads)
    losses = {k: v.detach() for k, v in {**loss, **dloss}.items()}
    return ({k: v.detach() for k, v in new.items()}, losses,
            {k: v.detach() for k, v in grads.items()})


def halve(batch, draws):
    """The step's draws cut to the first half of its patches."""
    h = draws["idx"].shape[0] // 2
    return batch, {"idx": draws["idx"][:h], "patch": draws["patch"][:, :h],
                   "depth": draws["depth"][:h]}
