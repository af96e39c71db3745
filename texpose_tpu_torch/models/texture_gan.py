"""Texture-GAN engine (port of texpose_tpu/models/texture_gan.py).

Training (``texpose_tpu_torch.train``): one step is ``train_step(draws)``
with every random number of the step in ``draws`` (``make_draws``: batch
indices, patch uniforms, stratified depth uniforms, density noise, the
WGAN ε), so a test can feed the JAX package's draws.  The generator pass
renders B 16×16 patches through the ST-field and composite kernels (their
autograd Functions run the backward kernels), adds the VGG perceptual, GAN
and regularizer losses, and one Adam step moves the heads and the whole
latent tables (dense gradients: rows outside the batch move through their
Adam moments, as with optax).  The discriminator step reuses the detached
pre-update render: one spectral normalization, one forward over
[real; fake], the R1 input gradient with a graph, one RMSprop step.

Evaluation: novel-view synthesis over the test split with PSNR/SSIM/LPIPS
and PNG export (``evaluate.py --syn2real``).

Per frame, with the shipped config: top-k pose-neighbour light latent on
the host, the object rays only (bucketed to a multiple of the 2048-ray
chunk), each chunk through the ST-field kernel and the composite kernel,
then scatter, metrics and the PNG payload on the device: one frame
program (``eval_compact_body``; the masked, whole-frame and metrics
bodies for the other routes), on a card one captured CUDA graph a JAX
cache key (models/frame_graph.py).  Frame i+1 loads
and uploads on a worker thread while frame i renders; results are pulled
one frame behind the dispatch; PNG encodes run on a writer thread.  The
paper-visual export (``--data.scene=scene_vis``) renders whole frames and
writes 256-px crops of the render, the GT and the depth; ``visualize``
(the freq.vis hook) writes eval frame 0's panels during training.

Under data parallelism (``mesh``) each rank renders and discriminates its
slice of the patch batch (B must divide over the ranks, as in JAX) from
the global draws; its losses are its shares of the global ones
(models/losses.py), and the gradients of the heads, of the latent tables
(whose rows the ranks touch apart) and of D are summed before Adam and
RMSprop, so the optimizers, the latent EMA and the spectral-norm state
stay identical on every rank.  Whole frames render through the sharded
routes of parallel/mesh.py (the object-ray set with coverage in (0, 0.5),
else H·W), and evaluation uploads the standard payload.
"""

from __future__ import annotations

import os
from collections import deque
from functools import partial

import cv2
import numpy as np
import torch

from ..nn.discriminator import (apply_discriminator, init_discriminator,
                                 sn_normalize_disc)
from ..nn.fields import init_nerf_st
from ..nn.lpips import lpips_distance
from ..nn.vgg import init_vgg19, load_vgg19_npz, perceptual_loss_pairs
from ..ops.consts import device_const
from ..ops.grid_sample import grid_sample
from ..ops.ssim import ssim
from ..parallel.mesh import (masked_ray_indices_sharded,
                             render_full_nerf_st_sharded,
                             render_masked_nerf_st_sharded)
from ..sampling.patch import (current_scale_bounds, flex_patch_coords,
                              patch_uniforms)
from ..sampling.ray_sampler import get_bounds, get_rays
from ..utils import checkpoint as ckpt
from ..utils import vis
from ..utils.log import log
from ..utils.metrics import (frame_metrics, mse_to_psnr, png_bgr,
                             write_quant)
from ..utils.pipeline import AsyncWriter, to_device
from ..utils.spans import span
from .base import Engine, compute_dtype
from .losses import (gan_loss, lab_loss, mean_term, mse_loss, r1_penalty,
                     summarize_loss, uncertainty_reg_loss,
                     uncertainty_render_loss, wgan_gp_reg)
from .optim import make_disc_optimizer, make_generator_optimizer
from .render import (masked_ray_indices, render_full_nerf_st,
                     render_rays_masked_st_pre, render_st_core,
                     scatter_masked_st)


def render_patch(nerf, cfg, pose, intr, coords, z_near, z_far, latent_trans,
                 latent_light, progress, compute_dtype=None,
                 depth_rand=None, density_noise=None, training=False):
    """Patch-coordinate render: coords [B,h,w,2] in [-1,1] → the composite
    dict with [B,hw,C] leaves."""
    B, h, w, _ = coords.shape
    center, ray = get_rays(intr, coords, pose, cfg.H, cfg.W)
    near, far = get_bounds(coords, z_near, z_far, cfg.H, cfg.W)
    return render_st_core(nerf, cfg, center.reshape(B, h * w, 3),
                          ray.reshape(B, h * w, 3), near.reshape(B, h * w),
                          far.reshape(B, h * w), latent_trans, latent_light,
                          progress, compute_dtype, depth_rand,
                          density_noise, training)


def sample_patch_images(cfg, batch, coords):
    """Supervision at the patch coords → dict of [B,C,h,w]: image and
    image_syn (bilinear, align_corners), mask and mask_syn (nearest),
    nocs and normal (bilinear, times mask_syn)."""
    B = coords.shape[0]
    H, W = cfg.H, cfg.W

    def mask_of(key):
        return (batch[key] > 0).float().reshape(B, 1, H, W)

    out = {"image": grid_sample(batch["image"], coords, "bilinear",
                                align_corners=True),
           "mask": grid_sample(mask_of("obj_mask"), coords, "nearest")}
    if "image_syn" in batch:
        out["image_syn"] = grid_sample(batch["image_syn"], coords,
                                       "bilinear", align_corners=True)
        out["mask_syn"] = grid_sample(mask_of("mask_syn"), coords, "nearest")
    else:
        out["image_syn"], out["mask_syn"] = out["image"], out["mask"]
    if "nocs_pred" in batch:
        for key, src in (("nocs", "nocs_pred"), ("normal", "normal_pred")):
            out[key] = grid_sample(batch[src], coords, "bilinear",
                                   align_corners=True) * out["mask_syn"]
    return out


# ------------------------------------------------------------ frame bodies
# The per-frame programs of evaluation, functions of tensors only (the JAX
# engine's jitted bodies; models/frame_graph.py runs them, captured on a
# card).  The statics come first, bound by the engine: the field, the
# config, LPIPS's parameters, raw_hw.

def _one(device):
    """The c2f progress of evaluation (JAX's ``jnp.asarray(1.0)``)."""
    return device_const(1.0, torch.float32, device)


def render_masked_body(nerf, cfg, pose, intr, z_near, z_far, lt, ll, idx,
                       obj_mask):
    """The object rays ``idx`` [P] (a bucketed, padded index set) of a
    whole frame, then the reference's defaults elsewhere → dict of
    [1,HW,C] (JAX's ``("masked", P)`` program and ``scatter_masked_st``)."""
    zn, zf = (z.reshape(1, -1)[:, idx] for z in (z_near, z_far))
    out = render_rays_masked_st_pre(
        nerf, cfg, pose, intr, idx, zn, zf, lt, ll,
        progress=_one(pose.device), compute_dtype=compute_dtype(cfg),
        chunk=int(cfg.nerf.rand_rays))
    return scatter_masked_st(cfg, out, idx,
                             (obj_mask.reshape(1, -1) > 0).float())


def render_full_body(nerf, cfg, pose, intr, z_near, z_far, lt, ll, obj_mask):
    """Every ray of a whole frame, the reference's defaults outside
    obj_mask → dict of [1,HW,C] (JAX's ``_render_jit``)."""
    return render_full_nerf_st(
        nerf, cfg, pose, intr, z_near, z_far, lt, ll,
        progress=_one(pose.device), compute_dtype=compute_dtype(cfg),
        obj_mask=(obj_mask.reshape(1, -1) > 0).float())


def eval_metrics_body(cfg, lpips_params, raw_hw, rgb_flat, image, obj_mask):
    """A standard-payload frame's metrics → (psnr, ssim, lpips, the full
    BGR uint8 frame) (JAX's ``("evalmetrics", raw_hw)`` program)."""
    rgb = rgb_flat.reshape(cfg.H, cfg.W, 3)
    mask = obj_mask.reshape(cfg.H, cfg.W, 1).float()
    img = image.reshape(3, cfg.H, cfg.W).permute(1, 2, 0) * mask
    p, s, lp, rgb = frame_metrics(lpips_params, rgb, img, raw_hw)
    return p, s, lp, png_bgr(rgb)


def eval_compact_body(nerf, cfg, lpips_params, raw_hw, pose, intr, zn, zf,
                      lt, ll, idx, img_sparse_u8):
    """A compact-payload frame in one program (JAX's ``("evalcompact",
    raw_hw, P)``): the masked render from the pre-gathered bounds, the
    scatter, the metrics → (psnr, ssim, lpips, png): the sparse [P,3] RGB
    uint8 object colors, or the full resized BGR frame when raw_hw
    differs.  ``idx`` is the object-pixel set padded with in-set
    duplicates, whose renders are equal, so the scatters are
    deterministic."""
    HW = cfg.H * cfg.W
    out = render_rays_masked_st_pre(
        nerf, cfg, pose, intr, idx, zn, zf, lt, ll,
        progress=_one(pose.device), compute_dtype=compute_dtype(cfg),
        chunk=int(cfg.nerf.rand_rays))
    vals = out["rgb_static"][0]                                    # [P,3]
    rgb = torch.zeros((HW, 3), device=vals.device)
    rgb[idx] = vals
    img = torch.zeros((HW, 3), device=vals.device)
    img[idx] = img_sparse_u8.float() / 255.0
    p, s, lp, rgb = frame_metrics(lpips_params, rgb.reshape(cfg.H, cfg.W, 3),
                                  img.reshape(cfg.H, cfg.W, 3), raw_hw)
    if raw_hw is not None and tuple(raw_hw) != (cfg.H, cfg.W):
        return p, s, lp, png_bgr(rgb)
    return p, s, lp, (torch.clamp(vals, 0.0, 1.0) * 255.0).to(torch.uint8)


class TextureGANEngine(Engine):
    """model=nerf_adapt_st_gan, evaluation."""

    # ------------------------------------------------------------------ data

    def make_dataset(self, split):
        if self.cfg.get("syn2real"):
            from ..data import LineMODSyn2RealDataset
            return LineMODSyn2RealDataset(
                self.cfg, split=split, subset=self._split_subset(split),
                multi_obj=self.cfg.data.get("multi_obj", False),
                splits_root=self.cfg.data.get("splits_root", "splits"))
        return super().make_dataset(split)

    def load_dataset(self, eval_split="val"):
        super().load_dataset(eval_split=eval_split)
        self.pose_anchor = np.asarray(
            self.train_data.get_all_camera_poses(source="gt"))

    # ------------------------------------------------------------- networks

    def build_networks(self, seed=None):
        """Field + latent tables, drawn from one seeded generator (weights
        come from a checkpoint for any meaningful evaluation)."""
        cfg = self.cfg
        seed = int(cfg.get("seed", 0) if seed is None else seed)
        gen = torch.Generator().manual_seed(seed)
        log.info("building networks (st-nerf + latents)...")
        self.nerf = init_nerf_st(cfg, gen).to(self.device)
        n = len(self.train_data)
        self.latents = {
            "trans": torch.randn((n, cfg.nerf.N_latent_trans),
                                 generator=gen).to(self.device),
            "light": torch.randn((n, cfg.nerf.N_latent_light),
                                 generator=gen).to(self.device)}
        if cfg.render.get("latent_ema"):
            self.latents_ema = {k: v.clone() for k, v in self.latents.items()}
        self.disc = self.sn_state = None
        if cfg.get("gan") is not None:
            self.disc, self.sn_state = init_discriminator(gen, cfg,
                                                          device=self.device)
        vgg_path = cfg.get("vgg_weights")
        if vgg_path and os.path.exists(str(vgg_path)):
            self.vgg = load_vgg19_npz(str(vgg_path), self.device)
            log.info(f"loaded VGG19 weights from {vgg_path}")
        else:
            self.vgg = init_vgg19(gen, self.device)
            if cfg.loss_weight.get("feat") is not None:
                log.warn("no vgg_weights provided — perceptual loss uses "
                         "random (fixed) features")

    # ------------------------------------------------------------ training

    def max_iter(self):
        cfg = self.cfg
        if cfg.get("max_iter"):
            return int(cfg.max_iter)
        return int(cfg.max_epoch * len(self.train_data) // cfg.batch_size)

    def rays_per_step(self):
        return int(self.cfg.batch_size) * int(self.cfg.patch_size) ** 2

    def _trainable_heads(self):
        """(keypath under params/nerf, parameter) of the RGB and transient
        heads; the trunk is frozen and never reaches the optimizer."""
        return [(f"{name}/{k.replace('.', '/')}", p)
                for name in ("mlp_rgb", "mlp_trans")
                for k, p in getattr(self.nerf, name).named_parameters()]

    def setup_optimizer(self):
        cfg = self.cfg
        max_iter = self.max_iter()
        spe = max(len(self.train_data) // cfg.batch_size, 1)
        self.nerf.mlp_feat.requires_grad_(False)
        for t in self.latents.values():
            t.requires_grad_(True)
        heads = [p for _, p in self._trainable_heads()]
        self.opt_nerf = make_generator_optimizer(
            cfg, heads, [self.latents["light"], self.latents["trans"]],
            max_iter, spe)
        B = int(cfg.batch_size)
        if self.mesh is not None and B % self.mesh.size:
            raise ValueError(f"batch_size {B} must divide the mesh "
                             f"({self.mesh.size} ranks)")
        self.opt_disc = None
        if self.disc is not None:
            for grp in self.disc.values():
                for w in grp:
                    w.requires_grad_(True)
            self.opt_disc = make_disc_optimizer(
                cfg, [w for grp in ("main", "final")
                      for w in self.disc[grp]], max_iter, spe)
        self.init_step_state()
        self.draw_gen = torch.Generator(self.device)
        self.draw_gen.manual_seed(int(cfg.get("seed", 0)))
        self.nbr_table = None
        if cfg.loss_weight.get("latent_nbr_reg") is not None:
            self.nbr_table = torch.as_tensor(
                self._pose_neighbor_table(int(cfg.render.N_candidate)),
                dtype=torch.long, device=self.device)

    def optimizers(self):
        return [o for o in (self.opt_nerf, self.opt_disc) if o is not None]

    def _pose_neighbor_table(self, k):
        """[N, k]: each train image's k nearest train images by geodesic
        rotation distance (itself first)."""
        R = self.pose_anchor[:, :, :3]
        Rd = R[:, None] @ np.swapaxes(R[None], -2, -1)
        tr = Rd[..., 0, 0] + Rd[..., 1, 1] + Rd[..., 2, 2]
        d = np.arccos(np.clip((tr - 1) / 2, -1 + 1e-7, 1 - 1e-7))
        np.fill_diagonal(d, 0.0)
        k = min(int(k), d.shape[0])
        return np.argsort(d, axis=1)[:, :k].astype(np.int32)

    def make_draws(self, it):
        """Every random number of step ``it``, drawn on the device from the
        engine's generator: idx [B] (without replacement unless B > N),
        patch [3,B,1,1,1], depth [B,h·w,N,1] uniforms, and — when the
        config uses them — density_noise [B,h·w,N] standard normals and
        the WGAN-GP ε [B,1,1,1]."""
        cfg = self.cfg
        g, dev = self.draw_gen, self.device
        B, N_img = int(cfg.batch_size), len(self.train_data)
        R = int(cfg.patch_size) ** 2
        N = int(cfg.nerf.sample_intvs)
        if B > N_img:
            idx = torch.randint(N_img, (B,), generator=g, device=dev)
        else:
            idx = torch.argsort(torch.rand(N_img, generator=g,
                                           device=dev))[:B]
        draws = {"idx": idx, "patch": patch_uniforms(g, B, dev),
                 "depth": torch.rand((B, R, N, 1), generator=g, device=dev)}
        if cfg.nerf.get("density_noise_reg"):
            draws["density_noise"] = torch.randn((B, R, N), generator=g,
                                                 device=dev)
        if (cfg.get("gan") is not None and cfg.gan.type == "wgan"
                and cfg.loss_weight.get("gan_gp") is not None):
            draws["gp_eps"] = torch.rand((B, 1, 1, 1), generator=g,
                                         device=dev)
        return draws

    def _gen_losses(self, batch, idx, coords, scales, draws, progress):
        """The generator's forward: render, supervision and losses →
        (total, loss dict, rgb [B,3,h,w], sup); under data parallelism B is
        this rank's shard and each loss its share of the global one."""
        cfg = self.cfg
        lw = cfg.loss_weight
        mesh = self.mesh
        B, p = idx.shape[0], int(cfg.patch_size)
        lat_t = self.latents["trans"][idx]
        lat_l = self.latents["light"][idx]
        pose = batch["pose_init"] if cfg.data.pose_source == "predicted" \
            else batch["pose"]
        out = render_patch(self.nerf, cfg, pose, batch["intr"], coords,
                           batch["z_near"], batch["z_far"], lat_t, lat_l,
                           progress, compute_dtype(cfg), draws["depth"],
                           draws.get("density_noise"), training=True)
        rgb = out["rgb"].reshape(B, p, p, 3).permute(0, 3, 1, 2)
        uncert = out["uncert"].reshape(B, p, p, 1).permute(0, 3, 1, 2)
        sup = sample_patch_images(cfg, batch, coords)
        mask, image = sup["mask"], sup["image"]
        loss = {}
        if lw.get("render") is not None:
            if cfg.nerf.get("mask_obj"):
                loss["render"] = uncertainty_render_loss(
                    rgb, image, uncert, mask, mesh=mesh)
            else:
                loss["render"] = mse_loss(rgb, image, mesh=mesh)
        if lw.get("mask") is not None:
            opac = out["opacity"].reshape(B, p, p, 1).permute(0, 3, 1, 2)
            loss["mask"] = mse_loss(opac, mask, mesh=mesh)
        if lw.get("uncert") is not None:
            loss["uncert"] = uncertainty_reg_loss(out["uncert"], mesh=mesh)
        if lw.get("trans_reg") is not None:
            loss["trans_reg"] = mean_term(out["trans_density_mean"], mesh)
        if lw.get("latent_reg") is not None:
            loss["latent_reg"] = mean_term((lat_t ** 2).mean()
                                           + (lat_l ** 2).mean(), mesh)
        if lw.get("latent_nbr_reg") is not None:
            nt = self.nbr_table[idx]
            nm_l = self.latents["light"][nt].mean(dim=1).detach()
            nm_t = self.latents["trans"][nt].mean(dim=1).detach()
            loss["latent_nbr_reg"] = mean_term(
                ((lat_l - nm_l) ** 2).mean() + ((lat_t - nm_t) ** 2).mean(),
                mesh)
        if lw.get("feat") is not None:
            mask_pad = ((sup["mask_syn"] == 1) & (mask == 0)).to(rgb.dtype)
            loss["feat"] = mean_term(perceptual_loss_pairs(self.vgg, [
                (rgb, image * mask + sup["image_syn"] * mask_pad, 1.0),
                (rgb * mask + image * (1 - mask), image, 5.0)],
                dtype=compute_dtype(cfg)), mesh)
        if lw.get("lab") is not None:
            loss["lab"], _, _ = lab_loss(rgb, sup["image_syn"],
                                         mask=sup["mask_syn"], mesh=mesh)
        if self.disc is not None and lw.get("gan_nerf") is not None:
            fake = rgb
            if cfg.gan.geo_conditional:
                fake = torch.cat([rgb, sup["nocs"], sup["normal"]], dim=1)
            frozen = {k: [w.detach() for w in v]
                      for k, v in self.disc.items()}
            d_fake, _ = apply_discriminator(frozen, self.sn_state, cfg, fake,
                                            scales, progress, training=False)
            loss["gan_nerf"] = gan_loss(d_fake, 1, cfg.gan.type, mesh=mesh)
        total, loss = summarize_loss(loss, lw)
        return total, loss, rgb, sup

    def _disc_losses(self, rgb_d, sup, scales, draws, progress):
        """The discriminator's loss on [real; fake] from one spectral
        normalization and one forward → (total, loss dict, new sn_state);
        under data parallelism each loss is this rank's share."""
        cfg = self.cfg
        lw = cfg.loss_weight
        mesh = self.mesh
        B = rgb_d.shape[0]
        mask, mask_syn = sup["mask"], sup["mask_syn"]
        mask_pad = ((mask_syn == 1) & (mask == 0)).to(rgb_d.dtype)
        real = sup["image"] * mask + rgb_d * mask_pad
        fake = rgb_d
        if cfg.gan.geo_conditional:
            real = torch.cat([real, sup["nocs"], sup["normal"]], dim=1)
            fake = torch.cat([fake, sup["nocs"], sup["normal"]], dim=1)
        psn, sn2 = sn_normalize_disc(self.disc, self.sn_state)
        both = torch.cat([real, fake], dim=0)
        need_r = lw.get("gan_reg_real") is not None
        need_f = lw.get("gan_reg_fake") is not None
        if need_r or need_f:
            both.requires_grad_(True)
        d_both, _ = apply_discriminator(psn, sn2, cfg, both,
                                        torch.cat([scales, scales], dim=0),
                                        progress, normalized=True)
        loss = {"gan_disc_real": gan_loss(d_both[:B], 1, cfg.gan.type, mesh),
                "gan_disc_fake": gan_loss(d_both[B:], 0, cfg.gan.type, mesh)}
        total = (10.0 ** float(lw.gan_disc_real) * loss["gan_disc_real"]
                 + 10.0 ** float(lw.gan_disc_fake) * loss["gan_disc_fake"])
        if need_r or need_f:
            sel = torch.cat([
                torch.full((B,), float(need_r), dtype=d_both.dtype,
                           device=d_both.device),
                torch.full((B,), float(need_f), dtype=d_both.dtype,
                           device=d_both.device)])
            reg_r, reg_f = r1_penalty(d_both, both, sel, B, mesh)
            if need_r:
                loss["gan_reg_real"] = reg_r
                total = total + 10.0 ** float(lw.gan_reg_real) * reg_r
            if need_f:
                loss["gan_reg_fake"] = reg_f
                total = total + 10.0 ** float(lw.gan_reg_fake) * reg_f
        if cfg.gan.type == "wgan" and lw.get("gan_gp") is not None:
            gp = wgan_gp_reg(
                lambda x: apply_discriminator(self.disc, self.sn_state, cfg,
                                              x, scales, progress)[0],
                draws["gp_eps"], real, fake, mesh=mesh)
            loss["gan_gp"] = gp
            total = total + 10.0 ** float(lw.gan_gp) * gp
        return total, loss, sn2

    def train_step(self, draws):
        """One generator + discriminator step → the step's losses (device
        scalars: G losses with 'all', then the D losses).  Its stages are
        spans (``step/...``, utils/spans.py): nothing without a profiler,
        and ranges that split a trace's host and device time by stage.  Under
        data parallelism ``draws`` are the global draws; this rank steps its
        slice of the batch.  It reads the step count, its progress, the
        patch-scale anneal and the rates on the device and moves the count
        on there (``it_dev``), so a CUDA graph of it replays
        (models/step_graph.py); the spectral-norm state is updated in
        place."""
        cfg = self.cfg
        it = self.it_dev
        draws = self.shard_draws(draws, {"patch": 1})
        progress = self.progress()
        patch_cfg = cfg.get("patch") or {}
        with span("step/batch"):
            idx = draws["idx"]
            batch = {k: v[idx] for k, v in self.train_batch.items()}
            coords, scales = flex_patch_coords(
                draws["patch"], int(cfg.patch_size), iteration=it,
                min_scale=patch_cfg.get("min_scale", 0.25),
                max_scale=patch_cfg.get("max_scale", 1.0),
                scale_anneal=patch_cfg.get("scale_anneal", 0.0002))

        # ---- generator (heads + latents); trunk frozen ----
        with span("step/gen_forward"):
            total, loss, rgb, sup = self._gen_losses(batch, idx, coords,
                                                     scales, draws, progress)
        with span("step/gen_backward"):
            self.opt_nerf.zero_grad(set_to_none=True)
            total.backward()
            self.reduce_grads(self.opt_nerf)
        with span("step/gen_update"):
            self.opt_nerf.step(it)
            ema_d = cfg.render.get("latent_ema")
            if ema_d:
                with torch.no_grad():
                    for k, v in self.latents.items():
                        self.latents_ema[k].mul_(ema_d).add_(v,
                                                             alpha=1 - ema_d)
        loss = {k: v.detach() for k, v in loss.items()}

        # ---- discriminator (reuses the pre-update render) ----
        if self.disc is not None:
            with span("step/disc_forward"):
                dtotal, dloss, sn2 = self._disc_losses(
                    rgb.detach(), sup, scales, draws, progress)
            with span("step/disc_backward"):
                self.opt_disc.zero_grad(set_to_none=True)
                dtotal.backward()
                self.reduce_grads(self.opt_disc)
            with span("step/disc_update"):
                self.opt_disc.step(it)
                with torch.no_grad():
                    for grp, vs in self.sn_state.items():
                        for v, v2 in zip(vs, sn2[grp]):
                            v.copy_(v2)
            loss.update({k: v.detach() for k, v in dloss.items()})
        self.advance()
        return self.reduce_losses(loss)

    def log_scalars(self, it, loss, split="train"):
        host = super().log_scalars(it, loss, split=split)
        patch_cfg = self.cfg.get("patch") or {}
        lo, hi = current_scale_bounds(
            it, patch_cfg.get("min_scale", 0.25),
            patch_cfg.get("max_scale", 1.0),
            patch_cfg.get("scale_anneal", 0.0002))
        self.writer.scalars(it, {"patch_scale_min": lo,
                                 "patch_scale_max": hi}, split=split)
        return host

    # ------------------------------------------------- train-state bridge

    def _adam_params(self):
        """{group: [(keypath under mu/ and nu/, parameter)]} in the order of
        the Adam groups (ckpt.adam_keys)."""
        heads = [(f"heads/{k}", p) for k, p in self._trainable_heads()]
        lats = [(f"latents/{k}", self.latents[k]) for k in ("light", "trans")]
        if self.cfg.optim.get("lr_latent"):
            return {"heads": heads, "latents": lats}
        return {"all": heads + lats}

    def _disc_leaves(self):
        return [(grp, i, w) for grp in ("main", "final")
                for i, w in enumerate(self.disc[grp])]

    def train_state_flat(self, step):
        """The whole train state under the JAX package's keypaths (numpy),
        restorable by its ``--resume``."""
        def np_(t):                    # a copy, never a view of the state
            return t.detach().to("cpu", copy=True).numpy()

        flat = {}
        for k, v in self.state_tensors().items():
            path = k.replace(".", "/")
            flat[("params/" + path) if path.startswith("nerf/") else path] \
                = np_(v)
        keys = ckpt.adam_keys(self.cfg.optim.get("lr_latent"))
        for (grp, named), (count_key, mu, nu, sched_key) in zip(
                self._adam_params().items(), keys.values()):
            count = 0
            for path, p in named:
                st = self.opt_nerf.state.get(p, {})
                count = int(st["step"]) if "step" in st else count
                zero = np.zeros(tuple(p.shape), np.float32)
                flat[mu + path] = np_(st["exp_avg"]) if st else zero
                flat[nu + path] = np_(st["exp_avg_sq"]) if st else zero
            flat[count_key] = np.int32(count)
            flat[sched_key] = np.int32(count)
        if self.disc is not None:
            d_count = 0
            for grp, i, w in self._disc_leaves():
                st = self.opt_disc.state.get(w, {})
                d_count = int(st["step"]) if "step" in st else d_count
                flat[f"params/disc/{grp}/{i}/w"] = np_(w)
                flat[f"sn_state/{grp}/{i}"] = np_(self.sn_state[grp][i])
                flat[f"opt_disc/0/nu/{grp}/{i}/w"] = (
                    np_(st["square_avg"]) if st
                    else np.zeros(tuple(w.shape), np.float32))
            if self.cfg.optim_disc.get("lr_end"):
                flat["opt_disc/1/count"] = np.int32(d_count)
        flat["key"] = ckpt.jax_key(self.cfg.get("seed", 0))
        flat["it"] = np.int32(self.it)
        flat["step"] = np.int32(step)
        return flat

    def load_train_state_flat(self, flat, fname="checkpoint"):
        """Strict inverse of train_state_flat: every leaf the engine holds
        must be in ``flat`` with its shape."""
        def get(key, shape):
            if key not in flat:
                raise KeyError(f"{fname}: checkpoint missing leaf {key}")
            arr = np.asarray(flat[key])
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{fname}: shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs {tuple(shape)}")
            return torch.as_tensor(arr.astype(np.float32),
                                   device=self.device)

        with torch.no_grad():
            for k, v in self.state_tensors().items():
                path = k.replace(".", "/")
                v.copy_(get(("params/" + path) if path.startswith("nerf/")
                            else path, v.shape))
            keys = ckpt.adam_keys(self.cfg.optim.get("lr_latent"))
            for (grp, named), (count_key, mu, nu, _) in zip(
                    self._adam_params().items(), keys.values()):
                count = int(get(count_key, ()).item())
                for path, p in named:
                    self.opt_nerf.state[p] = {
                        "step": torch.tensor(float(count)),
                        "exp_avg": get(mu + path, p.shape),
                        "exp_avg_sq": get(nu + path, p.shape)}
            if self.disc is not None:
                d_count = int(get("it", ()).item())
                if self.cfg.optim_disc.get("lr_end"):
                    d_count = int(get("opt_disc/1/count", ()).item())
                for grp, i, w in self._disc_leaves():
                    w.copy_(get(f"params/disc/{grp}/{i}/w", w.shape))
                    self.sn_state[grp][i].copy_(get(
                        f"sn_state/{grp}/{i}", self.sn_state[grp][i].shape))
                    self.opt_disc.state[w] = {
                        "step": torch.tensor(float(d_count)),
                        "square_avg": get(f"opt_disc/0/nu/{grp}/{i}/w",
                                          w.shape)}
        self.set_step(int(get("it", ()).item()))
        self.draw_gen.manual_seed(int(self.cfg.get("seed", 0)) * 1000003
                                  + self.it)
        return int(get("step", ()).item())

    def restore_checkpoint(self):
        """With cfg.resume and <output_path>/model.ckpt: the whole train
        state once setup_optimizer has run (training), else the field and
        latents only (evaluation)."""
        if getattr(self, "opt_nerf", None) is None:
            return super().restore_checkpoint()
        fname = os.path.join(self.cfg.output_path, "model.ckpt")
        if not (self.cfg.get("resume") and os.path.exists(fname)):
            return False
        self.start_step = self.load_train_state_flat(
            ckpt.load_checkpoint_flat(fname), fname)
        log.info(f"resumed from {fname} @ step {self.start_step}")
        return True

    # ------------------------------------------------ eval latent protocols

    def _anchor_distances(self, pose):
        """Geodesic rotation distance from pose [3,4] to every anchor."""
        Rd = pose[None, :, :3] @ np.swapaxes(
            self.pose_anchor[:, :, :3], -2, -1)
        tr = Rd[..., 0, 0] + Rd[..., 1, 1] + Rd[..., 2, 2]
        return np.arccos(np.clip((tr - 1) / 2, -1 + 1e-7, 1 - 1e-7))

    def _select_light_latent(self, pose, k=None, rng=None):
        """Random pick among the top-k rotation-distance anchors."""
        k = k or int(self.cfg.render.N_candidate)
        cand = np.argsort(self._anchor_distances(np.asarray(pose)))[:k]
        rng = rng or np.random.default_rng(0)
        return int(cand[rng.integers(len(cand))])

    def _host_latents_table(self):
        """The eval latent tables on the host (EMA shadow when kept)."""
        tab = self.latents_ema or self.latents
        return {k: v.detach().cpu().numpy() for k, v in tab.items()}

    def _latent_norm_z(self, tab):
        """Robust (median/MAD) z-score of each row's latent norm."""
        out = {}
        for name, t in tab.items():
            norms = np.linalg.norm(np.asarray(t), axis=1)
            med = float(np.median(norms))
            mad = float(np.median(np.abs(norms - med)))
            out[name] = np.abs(norms - med) / (1.4826 * mad + 1e-6)
        return out

    def _topk_latents(self, pose, k=None, tab=None, mode="mean"):
        """Aggregate of the top-k nearest-pose latents: "mean", "median"
        (per dimension) or "robust" (mean after dropping rows whose
        latent-norm robust z exceeds render.topk_z; needs ≥8 rows)."""
        k = k or int(self.cfg.render.N_candidate)
        cand = np.argsort(self._anchor_distances(np.asarray(pose)))[:k]
        if tab is None:
            tab = self._host_latents_table()
        if mode == "median":
            ll = np.median(tab["light"][cand], axis=0, keepdims=True)
            lt = np.median(tab["trans"][cand], axis=0, keepdims=True)
            return lt.astype(tab["trans"].dtype), ll.astype(tab["light"].dtype)
        if mode == "robust" and len(tab["light"]) >= 8:
            z = self._latent_norm_z(tab)
            zmax = np.maximum(z["light"][cand], z["trans"][cand])
            keep = zmax <= float(self.cfg.render.get("topk_z") or 6.0)
            if not keep.any():
                keep = zmax == zmax.min()
            cand = cand[keep]
        elif mode not in ("mean", "robust"):
            raise ValueError(f"unknown topk latent mode '{mode}'")
        ll = tab["light"][cand].mean(axis=0, keepdims=True)
        lt = tab["trans"][cand].mean(axis=0, keepdims=True)
        return lt, ll

    def _frame_latents(self, pose, tab, rng):
        """(lt, ll) [1,D] numpy for one frame under cfg.render.light."""
        cfg = self.cfg
        light_mode = cfg.render.get("light", "anchor")
        if light_mode == "mean":
            ll = tab["light"].mean(axis=0, keepdims=True)
            lt = tab["trans"].mean(axis=0, keepdims=True)
        elif light_mode.startswith("topk_"):
            lt, ll = self._topk_latents(pose, tab=tab, mode=light_mode[5:])
        else:
            li = self._select_light_latent(pose, rng=rng)
            ll = tab["light"][li:li + 1]
            lt = tab["trans"][li:li + 1]
        if cfg.render.transient == "zero":
            lt = np.zeros((1, int(cfg.nerf.N_latent_trans)), np.float32)
        return lt, ll

    # ----------------------------------------------------------- validation

    def validate(self, it):
        """Whole-frame validation of the first val_sub eval frames with the
        main losses, latents of train image 0 (or the render.val_light
        protocol) → mean row, logged under split 'val'; then the latent
        drift monitor."""
        cfg = self.cfg
        lw = cfg.loss_weight
        n = min(len(self.eval_data), cfg.data.get("val_sub") or 1)
        val_light = cfg.render.get("val_light")
        if val_light not in (None, "mean") \
                and not str(val_light).startswith("topk_"):
            raise ValueError(f"unknown render.val_light '{val_light}'")
        lt = self.latents["trans"][0:1].detach()
        ll = self.latents["light"][0:1].detach()
        tab = self._host_latents_table() if val_light else None
        if val_light == "mean":
            lt = tab["trans"].mean(axis=0, keepdims=True)
            ll = tab["light"].mean(axis=0, keepdims=True)
        rows = []
        with torch.inference_mode():
            for i in range(n):
                frame = self.eval_frame(i)
                if val_light and val_light.startswith("topk_"):
                    lt, ll = self._topk_latents(
                        frame["pose"].cpu().numpy()[0], tab=tab,
                        mode=val_light[5:])
                out = self._render_frame_st(frame, lt, ll)
                mask = (frame["obj_mask"] > 0).float().reshape(1, -1, 1)
                image = frame["image"].reshape(1, 3, -1).permute(0, 2, 1)
                row = {"PSNR": float(mse_to_psnr(mse_loss(out["rgb"],
                                                          image * mask)))}
                if lw.get("render") is not None:
                    row["render"] = float(uncertainty_render_loss(
                        out["rgb"], image, out["uncert"], mask))
                if lw.get("uncert") is not None:
                    row["uncert"] = float(uncertainty_reg_loss(out["uncert"]))
                rows.append(row)
        mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        self.writer.scalars(it, mean, split="val")
        log.info("[val %d] %s" % (it, " ".join(f"{k}={v:.4g}"
                                               for k, v in mean.items())))
        if cfg.render.get("drift_monitor", True):
            self.monitor_latent_drift(it)
        return mean

    def monitor_latent_drift(self, it, z_thresh=6.0, psnr_drop_db=1.0):
        """Latent-drift telemetry (split 'drift'): per-table latent norms
        and robust z, and eval frame 0's PSNR under every latent protocol;
        an alarm when a norm's z passes z_thresh (tables of ≥ 8 rows) or
        the top-8 protocol falls psnr_drop_db below its best."""
        cfg = self.cfg
        tab = self._host_latents_table()
        rec, alarms = {}, []
        zs = self._latent_norm_z(tab)
        for name, t in tab.items():
            norms = np.linalg.norm(np.asarray(t), axis=1)
            z_max = float(zs[name].max())
            rec[f"latent_{name}_norm_mean"] = float(norms.mean())
            rec[f"latent_{name}_norm_max"] = float(norms.max())
            rec[f"latent_{name}_z_max"] = z_max
            if z_max > z_thresh and len(norms) >= 8:
                alarms.append(f"latent_{name} robust-z={z_max:.1f} "
                              f"(row {int(zs[name].argmax())})")
        frame = self.eval_frame(0)
        pose = frame["pose"].cpu().numpy()[0]
        mask = (frame["obj_mask"] > 0).float().reshape(1, -1, 1)
        image = frame["image"].reshape(1, 3, -1).permute(0, 2, 1) * mask
        li = self._select_light_latent(pose,
                                       rng=np.random.default_rng(int(it)))
        protocols = {
            "anchor": (tab["trans"][li:li + 1], tab["light"][li:li + 1]),
            "topk3": self._topk_latents(pose, k=3, tab=tab),
            "topk8": self._topk_latents(pose, k=8, tab=tab),
            "topk8med": self._topk_latents(pose, k=8, tab=tab,
                                           mode="median"),
            "topk8rob": self._topk_latents(pose, k=8, tab=tab,
                                           mode="robust"),
            "mean": (tab["trans"].mean(axis=0, keepdims=True),
                     tab["light"].mean(axis=0, keepdims=True))}
        zero_lt = np.zeros((1, int(cfg.nerf.N_latent_trans)), np.float32)
        with torch.inference_mode():
            for pname, (lt, ll) in protocols.items():
                if cfg.render.transient == "zero":
                    lt = zero_lt
                out = self._render_frame_st(frame, lt, ll)
                mse = float(((image - out["rgb_static"]) ** 2).mean())
                rec[f"psnr_{pname}"] = float(-10.0 * np.log10(mse + 1e-10))
        hist = getattr(self, "_drift_psnr_hist", [])
        cur = rec["psnr_topk8"]
        if len(hist) >= 2 and max(hist) - cur > psnr_drop_db:
            alarms.append(f"psnr_topk8 {cur:.2f} dB is {max(hist) - cur:.2f}"
                          f" below its best ({max(hist):.2f})")
        hist.append(cur)
        self._drift_psnr_hist = hist
        rec["drift_alarm"] = float(bool(alarms))
        if alarms:
            log.warn(f"latent drift alarm @ {it}: " + "; ".join(alarms))
        self.writer.scalars(it, rec, split="drift")
        return rec

    def visualize(self, it, split="train"):
        """Render eval frame 0 with latent row 0 of the current tables and
        write thirteen panels as <output_path>/vis/<it>_<name>.png (and
        TensorBoard images): the GT image and masks, rgb / rgb_static /
        rgb_transient / pred_mask, and the depth, error and uncertainty
        heatmaps; then, once, cameras.png (the train anchors' frusta).
        Where matplotlib is missing, the camera plot is skipped with one
        warning and every other panel is still written.  Draws nothing
        from the step's generator and builds no graph.  Every rank renders
        (a collective under data parallelism); rank 0 writes."""
        cfg = self.cfg
        with torch.inference_mode():
            frame = self.eval_frame(0)
            out = self._render_frame_st(frame,
                                        self.latents["trans"][0:1].detach(),
                                        self.latents["light"][0:1].detach())
            if not self.is_writer:
                return
            host = {k: out[k].cpu().numpy()
                    for k in ("rgb", "rgb_static", "rgb_transient",
                              "opacity_static", "depth", "uncert")}
            fr = {k: frame[k].cpu().numpy()
                  for k in ("image", "obj_mask", "depth_gt", "z_near")}
        H, W = cfg.H, cfg.W
        vis_dir = os.path.join(cfg.output_path, "vis")

        def img(key, c):
            return host[key].reshape(1, H, W, c).transpose(0, 3, 1, 2)

        zs = cfg.nerf.depth.scale
        image = fr["image"].reshape(1, 3, H, W)
        gt_mask = (fr["obj_mask"].reshape(1, 1, H, W) > 0).astype(np.float32)
        depth_gt = fr["depth_gt"].reshape(1, 1, H, W)
        z_near = fr["z_near"].reshape(1, 1, H, W)
        depth_err = np.abs(img("depth", 1) - depth_gt) * gt_mask
        color_err = ((img("rgb", 3) - image * gt_mask) ** 2
                     ).mean(axis=1, keepdims=True)
        panels = {
            "image": (image, (0, 1), None),
            "image_masked": (image * gt_mask, (0, 1), None),
            "rgb": (img("rgb", 3), (0, 1), None),
            "rgb_static": (img("rgb_static", 3), (0, 1), None),
            "rgb_transient": (img("rgb_transient", 3), (0, 1), None),
            "pred_mask": (img("opacity_static", 1), (0, 1), None),
            "gt_mask": (gt_mask, (0, 1), None),
            "depth": (img("depth", 1) * gt_mask, (0.8 * zs, 1.1 * zs),
                      "plasma"),
            "depth_gt": (depth_gt, (0.8 * zs, 1.1 * zs), "plasma"),
            "z_near": (z_near, (0.6 * zs, float(z_near.max())), "plasma"),
            "depth_error": (depth_err,
                            (0, float(np.quantile(depth_err, 0.99))),
                            "turbo"),
            "color_error": (color_err,
                            (0, float(np.quantile(color_err, 0.95))),
                            "turbo"),
            "uncert": (img("uncert", 1),
                       (float(host["uncert"].min()),
                        float(np.quantile(host["uncert"], 0.99))),
                       "viridis"),
        }
        for name, (im, rng, cmap) in panels.items():
            vis.tb_image(self.writer, it, split, name,
                         vis.preprocess_vis_image(im, rng, cmap))
            vis.dump_image_grid(
                os.path.join(vis_dir, f"{it:06d}_{name}.png"), im, rng, cmap)
        cam_png = os.path.join(vis_dir, "cameras.png")
        if not os.path.exists(cam_png) and not getattr(self, "_no_cameras",
                                                       False):
            try:
                vis.plot_cameras(self.pose_anchor, cam_png)
            except ImportError as e:
                self._no_cameras = True
                log.warn(f"visualize: no cameras.png ({e}); the other "
                         "panels are written")

    # --------------------------------------------------------------- render

    def _render_frame_st(self, frame, latent_trans, latent_light,
                         obj_host=None):
        """Whole-frame render → dict of [1,HW,C].  With object coverage in
        (0, 0.5) only object rays render (bucketed); either way the
        reference's defaults fill the non-object pixels.  Under data
        parallelism the ranks share the rays: the padded object-ray set
        (coverage in (0, 0.5)) or H·W."""
        cfg = self.cfg
        obj = np.asarray(obj_host if obj_host is not None
                         else frame["obj_mask"].cpu()).reshape(-1)
        coverage = float((obj > 0).mean())
        chunk = int(cfg.nerf.rand_rays)
        args = dict(pose=frame["pose"], intr=frame["intr"],
                    z_near=frame["z_near"], z_far=frame["z_far"],
                    lt=latent_trans, ll=latent_light,
                    obj_mask=frame["obj_mask"])
        if self.mesh is not None:
            return self._render_frame_st_sharded(obj, coverage, chunk, **args)
        runner = self.frame_runner()
        if 0 < coverage < 0.5:
            idx_p, _ = masked_ray_indices(obj, chunk)
            return runner.run(("masked", len(idx_p)),
                              partial(render_masked_body, self.nerf, cfg),
                              idx=idx_p, **args)
        return runner.run(("full", cfg.H, cfg.W),
                          partial(render_full_body, self.nerf, cfg), **args)

    def _render_frame_st_sharded(self, obj, coverage, chunk, pose, intr,
                                 z_near, z_far, lt, ll, obj_mask):
        """The whole-frame render under data parallelism, eager: the ranks
        share the padded object-ray set (coverage in (0, 0.5)) or H·W."""
        cfg = self.cfg
        lt, ll = (torch.as_tensor(x, dtype=torch.float32, device=self.device)
                  for x in (lt, ll))
        cdt = compute_dtype(cfg)
        obj_f = (obj_mask.reshape(1, -1) > 0).float()
        args = (self.nerf, cfg, pose, intr, z_near, z_far, lt, ll)
        if 0 < coverage < 0.5:
            idx_p, _ = masked_ray_indices_sharded(obj, chunk, self.mesh.size)
            idx = torch.as_tensor(idx_p, device=self.device)
            out = render_masked_nerf_st_sharded(
                self.mesh, *args, idx, progress=1.0, compute_dtype=cdt,
                chunk=chunk)
            return scatter_masked_st(cfg, out, idx, obj_f)
        return render_full_nerf_st_sharded(
            self.mesh, *args, progress=1.0, compute_dtype=cdt, chunk=chunk,
            obj_mask=obj_f)

    # -------------------------------------------------------------- metrics

    def _eval_metrics(self, rgb_flat, image, obj_mask, raw_hw):
        """Standard-payload frame: (psnr, ssim, lpips, full BGR uint8),
        the ``("evalmetrics", raw_hw)`` program (eager under data
        parallelism)."""
        body = partial(eval_metrics_body, self.cfg, self._ensure_lpips()[0],
                       raw_hw)
        args = dict(rgb_flat=rgb_flat, image=image, obj_mask=obj_mask)
        if self.mesh is not None:
            return body(**args)
        return self.frame_runner().run(("evalmetrics", raw_hw), body, **args)

    # The compact payload: the object-ray subset only — [P,3] uint8 GT
    # pixels (the dataset images are uint8/255 PNGs and every metric
    # compares against image*mask, a scatter of exactly those pixels into
    # zeros), the [P] indices and the [P] z bounds gathered on the host.

    def _eval_compact_transform(self):
        """EvalPrefetcher transform for the compact payload, or None under
        data parallelism (as in JAX), for the scene_vis export (it renders
        and crops whole frames) and when render.eval_compact is off.  Frames with coverage outside (0, 0.5)
        keep the standard payload (the whole-frame route needs the full z
        maps)."""
        cfg = self.cfg
        if self.mesh is not None or cfg.data.scene == "scene_vis" \
                or not cfg.render.get("eval_compact", True):
            return None
        chunk = int(cfg.nerf.rand_rays)

        def transform(sample):
            obj = np.asarray(sample["obj_mask"]).reshape(-1)
            if not 0.0 < float((obj > 0).mean()) < 0.5:
                return {k: np.asarray(v)[None] for k, v in sample.items()}
            idx_p, _ = masked_ray_indices(obj, chunk)
            sample["_idx_host"] = idx_p
            z_near = np.asarray(sample["z_near"], np.float32).reshape(-1)
            z_far = np.asarray(sample["z_far"], np.float32).reshape(-1)
            img_u8 = np.rint(np.asarray(sample["image"]) * 255.0
                             ).astype(np.uint8)
            return {
                "image_sparse_u8": img_u8.reshape(3, -1).T[idx_p],
                "pose": np.asarray(sample["pose"], np.float32)[None],
                "intr": np.asarray(sample["intr"], np.float32)[None],
                "idx": idx_p,
                "z_near_pre": z_near[idx_p][None],
                "z_far_pre": z_far[idx_p][None],
            }
        return transform

    def _eval_compact(self, frame, lt, ll, raw_hw):
        """Compact-payload frame → (psnr, ssim, lpips, png), the
        ``("evalcompact", raw_hw, P)`` program (``eval_compact_body``)."""
        body = partial(eval_compact_body, self.nerf, self.cfg,
                       self._ensure_lpips()[0], raw_hw)
        return self.frame_runner().run(
            ("evalcompact", raw_hw, frame["idx"].shape[0]), body,
            pose=frame["pose"], intr=frame["intr"], zn=frame["z_near_pre"],
            zf=frame["z_far_pre"], lt=lt, ll=ll, idx=frame["idx"],
            img_sparse_u8=frame["image_sparse_u8"])

    def warm_eval(self, i=0):
        """Run eval frame i's whole pipeline once (kernel builds, weight
        packing, first-call allocations, and on a card the capture of its
        frame programs) so a timed sweep measures the steady state."""
        cfg = self.cfg
        sample = self.eval_data[i]
        raw_hw = getattr(self.eval_data, "raw_hw", None)
        lt = np.zeros((1, int(cfg.nerf.N_latent_trans)), np.float32)
        ll = self.latents["light"][0:1]
        transform = self._eval_compact_transform()
        payload = transform(sample) if transform is not None else None
        with torch.inference_mode():
            if payload is not None and "image_sparse_u8" in payload:
                res = self._eval_compact(to_device(payload, self.device,
                                                   batch=False),
                                         lt, ll, raw_hw)
            else:
                frame = self.eval_frame(i)
                out = self._render_frame_st(frame, lt, ll,
                                            obj_host=sample["obj_mask"])
                if cfg.data.scene == "scene_vis":
                    float(out["rgb_static"].sum())
                    return
                res = self._eval_metrics(out["rgb_static"], frame["image"],
                                         frame["obj_mask"], raw_hw)
            float(res[0])

    def _eval_frame_vis(self, frame, out, raw_hw, fi, test_path, writer):
        """The scene_vis export of one frame: the render composited on
        white inside the object mask, upscaled to raw_hw (cv2 INTER_LINEAR;
        INTER_NEAREST for the mask) and center-cropped to render.vis_crop
        (default 256) px, with PSNR/SSIM/LPIPS on the crop; writes
        <fi>.png, syn_<fi>.png (the unmasked GT) and depth_vis_<fi>.png
        (depth/depth.scale over [0.3, 0.5], plasma) → the quant row."""
        cfg = self.cfg
        lpips_params, lpips_key = self._ensure_lpips()
        rgb = out["rgb_static"].reshape(cfg.H, cfg.W, 3).cpu().numpy()
        mask = frame["obj_mask"].reshape(cfg.H, cfg.W, 1).cpu().numpy()
        gt = frame["image"][0].permute(1, 2, 0).cpu().numpy()
        image = gt * mask
        d = (out["depth"].reshape(cfg.H, cfg.W, 1).cpu().numpy()
             / cfg.nerf.depth.scale)
        if raw_hw is not None and tuple(raw_hw) != (cfg.H, cfg.W):
            size = (raw_hw[1], raw_hw[0])
            rgb, image, gt = (cv2.resize(a, size,
                                         interpolation=cv2.INTER_LINEAR)
                              for a in (rgb, image, gt))
            mask = cv2.resize(mask, size,
                              interpolation=cv2.INTER_NEAREST)[..., None]
            d = cv2.resize(d, size, interpolation=cv2.INTER_LINEAR)[..., None]
        crop = int(cfg.render.get("vis_crop") or 256)
        rgb, image, gt, m, d = [vis.center_crop(a, crop)
                                for a in (rgb, image, gt, mask, d)]
        rgb = rgb * m + (1.0 - m)
        rgb_t = torch.as_tensor(rgb.transpose(2, 0, 1),
                                device=self.device)[None]
        img_t = torch.as_tensor(image.transpose(2, 0, 1),
                                device=self.device)[None]
        row = {"psnr": float(mse_to_psnr(((rgb_t - img_t) ** 2).mean())),
               "ssim": float(ssim(rgb_t, img_t)),
               lpips_key: float(lpips_distance(lpips_params, rgb_t * 2 - 1,
                                               img_t * 2 - 1).mean())}
        if not self.is_writer:
            return row
        writer.submit(cv2.imwrite, os.path.join(test_path, f"{fi:06d}.png"),
                      (np.clip(rgb, 0, 1) * 255)[..., ::-1].astype(np.uint8))
        writer.submit(cv2.imwrite,
                      os.path.join(test_path, f"syn_{fi:06d}.png"),
                      (np.clip(gt, 0, 1) * 255)[..., ::-1].astype(np.uint8))
        dv = vis.preprocess_vis_image(
            d.transpose(2, 0, 1)[None], from_range=(0.3, 0.5),
            cmap="plasma")[0].transpose(1, 2, 0)
        writer.submit(cv2.imwrite,
                      os.path.join(test_path, f"depth_vis_{fi:06d}.png"),
                      (dv * 255)[..., ::-1].astype(np.uint8))
        return row

    # ------------------------------------------------------------- evaluate

    def evaluate_full(self):
        """Novel-view synthesis over the eval split → quant.txt and one PNG
        per frame under <output_path>/test_view_last (or
        render.save_path); returns the mean PSNR and SSIM.  Under
        data.scene=scene_vis each frame is the paper-visual export
        (``_eval_frame_vis``): three 256-px crops, quant rows on the
        crop.  Under data parallelism every rank renders and rank 0
        writes.  The sweep is the span ``eval/sweep`` (``eval/pull`` a
        frame's result, ``eval/quant``; the pipeline's spans in
        utils/pipeline.py)."""
        with span("eval/sweep"):
            return self._evaluate_full()

    def _evaluate_full(self):
        cfg = self.cfg
        vis_mode = cfg.data.scene == "scene_vis"
        test_path = cfg.render.get("save_path") or os.path.join(
            cfg.output_path, "test_view_last")
        if self.is_writer:
            os.makedirs(test_path, exist_ok=True)
        # render.eval_seed varies the anchor protocol's random pick
        rng = np.random.default_rng(int(cfg.render.get("eval_seed", 0) or 0))
        raw_hw = getattr(self.eval_data, "raw_hw", None)
        need = raw_hw is not None and tuple(raw_hw) != (cfg.H, cfg.W)
        tab = self._host_latents_table()
        _, lpips_key = self._ensure_lpips()
        rows = [None] * len(self.eval_data)
        pending = deque()

        def write_sparse_png(path, idx_p, vals):
            # the full BGR frame from the sparse object-ray payload
            # (background 0 = the reference's mask default)
            full = np.zeros((cfg.H * cfg.W, 3), np.uint8)
            full[idx_p] = vals
            cv2.imwrite(path, np.ascontiguousarray(
                full.reshape(cfg.H, cfg.W, 3)[..., ::-1]))

        def flush_one(writer):
            i, fi, idx_p, (p, s, lp, png) = pending.popleft()
            with span("eval/pull"):
                rows[i] = {"psnr": float(p), "ssim": float(s),
                           lpips_key: float(lp)}
                if not self.is_writer:
                    return
                png = png.cpu().numpy()
            path = os.path.join(test_path, f"{fi:06d}.png")
            if idx_p is not None:
                writer.submit(write_sparse_png, path, idx_p, png)
            else:
                writer.submit(cv2.imwrite, path, np.ascontiguousarray(png))

        transform = self._eval_compact_transform()
        with torch.inference_mode(), AsyncWriter() as writer:
            for i, frame, sample in self.eval_frames(transform=transform):
                lt, ll = self._frame_latents(np.asarray(sample["pose"]), tab,
                                             rng)
                if "image_sparse_u8" in frame:
                    res = self._eval_compact(frame, lt, ll, raw_hw)
                    idx_p = None if need else sample["_idx_host"]
                else:
                    out = self._render_frame_st(frame, lt, ll,
                                                obj_host=sample["obj_mask"])
                    if vis_mode:
                        rows[i] = self._eval_frame_vis(
                            frame, out, raw_hw, int(sample["frame_index"]),
                            test_path, writer)
                        continue
                    res = self._eval_metrics(out["rgb_static"],
                                             frame["image"],
                                             frame["obj_mask"], raw_hw)
                    idx_p = None
                pending.append((i, int(sample["frame_index"]), idx_p, res))
                # pull results one frame behind the dispatch
                if len(pending) >= 2:
                    flush_one(writer)
            while pending:
                flush_one(writer)
        mean_psnr = float(np.mean([r["psnr"] for r in rows]))
        mean_ssim = float(np.mean([r["ssim"] for r in rows]))
        log.info(f"PSNR:  {mean_psnr:8.2f}")
        log.info(f"SSIM:  {mean_ssim:8.2f}")
        if self.is_writer:
            with span("eval/quant"):
                write_quant(cfg.output_path, rows)
        return dict(psnr=mean_psnr, ssim=mean_ssim)
