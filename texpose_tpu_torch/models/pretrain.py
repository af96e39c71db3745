"""Geometry-pretrain engines (port of texpose_tpu/models/pretrain.py):
``model=nerf_pretrain`` and ``model=nerf_pretrain_env`` fit the coarse
field — the 8×256 trunk the texture GAN later loads frozen with
``--resume_pretrain`` — and its RGB head to masked crops.

Training: one step is ``train_step(draws)`` with every random number of the
step in ``draws`` (``make_draws``: one ray permutation shared by every
image, the stratified depth uniforms, the density noise), so a test can
feed the JAX package's draws.  The whole train split renders R =
rand_rays // B rays per image through the coarse field kernel with the
composite in its epilogue; the mask, scale-invariant depth and masked
render losses (weights 10**w) backpropagate through the composite and
field backward kernels into the trunk and the head; one Adam step on the
per-iteration schedule.

Evaluation: ``validate`` renders val_sub whole frames and logs the losses
and PSNR; ``evaluate_full`` renders every eval frame from a compact uint8
payload, with PSNR/SSIM/LPIPS, an RGB and an opacity PNG per frame and
quant.txt.  ``nerf.fine_sampling``, ``visualize`` and
``generate_videos_synthesis`` are later slices of the port.
"""

from __future__ import annotations

import os
from collections import deque

import cv2
import numpy as np
import torch
from torch.profiler import record_function

from ..nn.fields import init_nerf
from ..nn.lpips import lpips_distance
from ..ops.ssim import ssim
from ..utils import checkpoint as ckpt
from ..utils.log import log
from ..utils.metrics import mse_to_psnr, write_quant
from ..utils.pipeline import AsyncWriter
from .base import Engine, compute_dtype
from .losses import (masked_mse_loss, mse_loss, scale_invariant_depth_loss,
                     summarize_loss)
from .optim import make_pretrain_optimizer, set_lrs
from .render import ray_batch_sample, render_full_nerf, render_rays_nerf


class PretrainEngine(Engine):
    """model=nerf_pretrain."""

    pose_source_fixed = None       # the env variant forces "gt"

    # ------------------------------------------------------------- networks

    def build_networks(self, seed=None):
        """The coarse field from one seeded generator."""
        cfg = self.cfg
        if cfg.nerf.get("fine_sampling"):
            raise NotImplementedError(
                "nerf.fine_sampling (the hierarchical coarse + fine render) "
                "is not ported to texpose_tpu_torch yet (ROADMAP.md)")
        seed = int(cfg.get("seed", 0) if seed is None else seed)
        log.info("building networks (coarse nerf)...")
        self.nerf = init_nerf(cfg, torch.Generator().manual_seed(seed)
                              ).to(self.device)

    def max_iter(self):
        return int(self.cfg.max_iter)

    def rays_per_step(self):
        return int(self.cfg.nerf.rand_rays)

    def _named_params(self):
        """(keypath under params/nerf, parameter), trunk then RGB head."""
        return [(f"{name}/{k.replace('.', '/')}", p)
                for name in ("mlp_feat", "mlp_rgb")
                for k, p in getattr(self.nerf, name).named_parameters()]

    def setup_optimizer(self):
        cfg = self.cfg
        self.opt = make_pretrain_optimizer(
            cfg, [p for _, p in self._named_params()], self.max_iter())
        self.it = 0
        self.draw_gen = torch.Generator(self.device)
        self.draw_gen.manual_seed(int(cfg.get("seed", 0)))

    # ------------------------------------------------------------ train step

    def get_pose(self, batch, mode):
        source = self.pose_source_fixed or self.cfg.data.pose_source
        if mode == "train" and source == "predicted":
            return batch["pose_init"]
        return batch["pose"]

    def compute_loss(self, cfg, out, batch, ray_idx=None):
        """The train/val losses: out holds rgb/depth/opacity [B,R,C];
        ray_idx None means whole-frame (validation) tensors."""
        B = batch["image"].shape[0]
        HW = cfg.H * cfg.W
        image = batch["image"].reshape(B, 3, HW).permute(0, 2, 1)
        mask = batch["obj_mask"].reshape(B, HW, 1).float()
        mask_src = batch.get("erode_mask", batch["obj_mask"]) \
            if cfg.data.get("erode_mask_loss") else batch["obj_mask"]
        mask_obj = mask_src.reshape(B, HW, 1).float()
        depth_gt = batch["depth_gt"].reshape(B, HW, 1)
        if ray_idx is not None:
            image, mask, mask_obj, depth_gt = (
                ray_batch_sample(x, ray_idx)
                for x in (image, mask, mask_obj, depth_gt))
        loss = {}
        lw = cfg.loss_weight
        if lw.get("mask") is not None:
            loss["mask"] = mse_loss(out["opacity"], mask)
        if lw.get("depth") is not None:
            loss["depth"] = scale_invariant_depth_loss(out["depth"], depth_gt,
                                                       mask_obj)
        if lw.get("render") is not None:
            loss["render"] = (masked_mse_loss(out["rgb"], image, mask_obj)
                              if cfg.nerf.get("mask_obj")
                              else mse_loss(out["rgb"], image))
        return loss

    def rays_per_image(self):
        return max(int(self.cfg.nerf.rand_rays) // len(self.train_data), 1)

    def make_draws(self, it):
        """Every random number of step ``it``, drawn on the device from the
        engine's generator: ray_idx [R] (one permutation of the pixels,
        shared by every image), depth [B,R,N,1] uniforms when sampling is
        stratified, density_noise [B,R,N] standard normals when the config
        sets nerf.density_noise_reg."""
        cfg = self.cfg
        g, dev = self.draw_gen, self.device
        B, R = len(self.train_data), self.rays_per_image()
        N = int(cfg.nerf.sample_intvs)
        draws = {"ray_idx": torch.randperm(cfg.H * cfg.W, generator=g,
                                           device=dev)[:R]}
        if cfg.nerf.sample_stratified:
            draws["depth"] = torch.rand((B, R, N, 1), generator=g, device=dev)
        if cfg.nerf.get("density_noise_reg"):
            draws["density_noise"] = torch.randn((B, R, N), generator=g,
                                                 device=dev)
        return draws

    def train_step(self, draws):
        """One step on the whole train split → the step's losses (device
        scalars, with 'all').  Its stages are named profiler ranges
        (``step/...``)."""
        cfg = self.cfg
        it = self.it
        progress = it / self.max_iter() if cfg.get("c2f") is not None \
            else None
        batch = self.train_batch
        B = batch["image"].shape[0]
        with record_function("step/forward"):
            ray_idx = draws["ray_idx"][None].expand(B, -1)
            out = render_rays_nerf(
                self.nerf, cfg, self.get_pose(batch, "train"), batch["intr"],
                ray_idx, batch["z_near"], batch["z_far"], progress,
                compute_dtype(cfg), draws.get("depth"),
                draws.get("density_noise"), training=True)
            total, loss = summarize_loss(
                self.compute_loss(cfg, out, batch, ray_idx), cfg.loss_weight)
        with record_function("step/backward"):
            self.opt.zero_grad(set_to_none=True)
            total.backward()
        with record_function("step/update"):
            set_lrs(self.opt, it)
            self.opt.step()
        self.it = it + 1
        return {k: v.detach() for k, v in loss.items()}

    # ------------------------------------------------- train-state bridge

    def _has_schedule_state(self):
        """optax.adam keeps a schedule count only for a schedule, not for a
        constant learning rate."""
        o = self.cfg.optim
        return bool((o.get("sched") or {}).get("gamma") or o.get("lr_end"))

    def train_state_flat(self, step):
        """The whole train state under the JAX package's keypaths (numpy),
        restorable by its ``--resume``."""
        def np_(t):                    # a copy, never a view of the state
            return t.detach().to("cpu", copy=True).numpy()

        count_key, mu, nu, sched_key = ckpt.pretrain_opt_keys(
            self._has_schedule_state())
        flat, count = {}, 0
        for path, p in self._named_params():
            flat["params/nerf/" + path] = np_(p)
            st = self.opt.state.get(p, {})
            count = int(st["step"]) if "step" in st else count
            zero = np.zeros(tuple(p.shape), np.float32)
            flat[mu + path] = np_(st["exp_avg"]) if st else zero
            flat[nu + path] = np_(st["exp_avg_sq"]) if st else zero
        flat[count_key] = np.int32(count)
        if sched_key:
            flat[sched_key] = np.int32(count)
        flat["key"] = ckpt.jax_key(self.cfg.get("seed", 0))
        flat["it"] = np.int32(self.it)
        flat["step"] = np.int32(step)
        return flat

    def load_train_state_flat(self, flat, fname="checkpoint"):
        """Strict inverse of train_state_flat."""
        def get(key, shape):
            if key not in flat:
                raise KeyError(f"{fname}: checkpoint missing leaf {key}")
            arr = np.asarray(flat[key])
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{fname}: shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs {tuple(shape)}")
            return torch.as_tensor(arr.astype(np.float32),
                                   device=self.device)

        count_key, mu, nu, _ = ckpt.pretrain_opt_keys(
            self._has_schedule_state())
        count = int(get(count_key, ()).item())
        with torch.no_grad():
            for path, p in self._named_params():
                p.copy_(get("params/nerf/" + path, p.shape))
                self.opt.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": get(mu + path, p.shape),
                    "exp_avg_sq": get(nu + path, p.shape)}
        self.it = int(get("it", ()).item())
        self.draw_gen.manual_seed(int(self.cfg.get("seed", 0)) * 1000003
                                  + self.it)
        return int(get("step", ()).item())

    def save_checkpoint(self, it):
        return self.save_flat_checkpoint(self.train_state_flat(it), it)

    def restore_checkpoint(self):
        """With cfg.resume and <output_path>/model.ckpt: the whole train
        state once setup_optimizer has run (training), else the field only
        (evaluation)."""
        if getattr(self, "opt", None) is None:
            return super().restore_checkpoint()
        fname = os.path.join(self.cfg.output_path, "model.ckpt")
        if not (self.cfg.get("resume") and os.path.exists(fname)):
            return False
        self.start_step = self.load_train_state_flat(
            ckpt.load_checkpoint_flat(fname), fname)
        log.info(f"resumed from {fname} @ step {self.start_step}")
        return True

    # ------------------------------------------------------------ validation

    def _render_frame(self, frame, progress=None):
        """Whole-frame render of a [1,...] frame → dict of [1,HW,C]."""
        return render_full_nerf(
            self.nerf, self.cfg, frame["pose"], frame["intr"],
            frame["z_near"], frame["z_far"],
            1.0 if progress is None else progress, compute_dtype(self.cfg))

    def validate(self, it):
        cfg = self.cfg
        n = min(len(self.eval_data), cfg.data.get("val_sub") or 1)
        progress = it / self.max_iter() if cfg.get("c2f") is not None else 1.0
        rows = []
        with torch.inference_mode():
            for i in range(n):
                frame = self.eval_frame(i)
                out = self._render_frame(frame, progress)
                _, loss = summarize_loss(self.compute_loss(cfg, out, frame),
                                         cfg.loss_weight)
                rows.append({k: float(v) for k, v in loss.items()})
        mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        if "render" in mean:
            mean["PSNR"] = float(mse_to_psnr(mean["render"]))
        self.writer.scalars(it, mean, split="val")
        log.info(f"[val {it}] " + " ".join(f"{k}={v:.4g}"
                                           for k, v in mean.items()))
        return mean

    # ------------------------------------------------------------ evaluation

    def _eval_compact_transform(self):
        """The compact eval payload: uint8 image and mask (lossless: the
        dataset images are uint8/255 PNGs, masks {0,1}) and the f32 z maps
        the whole-frame render reads at every pixel; None when
        render.eval_compact is off."""
        if not (self.cfg.get("render") or {}).get("eval_compact", True):
            return None

        def transform(sample):
            return {
                "image_u8": np.rint(np.asarray(sample["image"]) * 255.0
                                    ).astype(np.uint8)[None],
                "obj_mask_u8": (np.asarray(sample["obj_mask"]) > 0
                                ).astype(np.uint8)[None],
                "pose": np.asarray(sample["pose"], np.float32)[None],
                "intr": np.asarray(sample["intr"], np.float32)[None],
                "z_near": np.asarray(sample["z_near"], np.float32)[None],
                "z_far": np.asarray(sample["z_far"], np.float32)[None],
            }
        return transform

    def _eval_frame_metrics(self, frame):
        """One frame's render, metrics and PNG payloads on the device →
        (psnr, ssim, lpips, BGR uint8 [H,W,3], opacity uint8 [H,W])."""
        cfg = self.cfg
        lpips_params, _ = self._ensure_lpips()
        out = self._render_frame(frame)
        rgb = out["rgb"].reshape(cfg.H, cfg.W, 3)
        opac = out["opacity"].reshape(cfg.H, cfg.W)
        if "image_u8" in frame:
            mask = frame["obj_mask_u8"].reshape(cfg.H, cfg.W, 1).float()
            img = frame["image_u8"].reshape(3, cfg.H, cfg.W).permute(
                1, 2, 0).float() / 255.0 * mask
        else:
            mask = frame["obj_mask"].reshape(cfg.H, cfg.W, 1).float()
            img = frame["image"].reshape(3, cfg.H, cfg.W).permute(1, 2, 0) \
                * mask
        p = mse_to_psnr(((rgb - img) ** 2).mean())
        rgb_t = rgb.permute(2, 0, 1)[None]
        img_t = img.permute(2, 0, 1)[None]
        s = ssim(rgb_t, img_t)
        lp = lpips_distance(lpips_params, rgb_t * 2 - 1, img_t * 2 - 1).mean()
        png = (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8).flip(-1)
        png_op = (torch.clamp(opac, 0.0, 1.0) * 255.0).to(torch.uint8)
        return p, s, lp, png, png_op

    def evaluate_full(self):
        """Render every eval frame, metric it, export an RGB and an opacity
        PNG per frame and quant.txt; returns the mean PSNR and SSIM.  Frame
        i+1 loads and uploads while frame i renders; results are pulled one
        frame behind the dispatch; PNG encodes run on a writer thread."""
        cfg = self.cfg
        rgb_dir = os.path.join(cfg.output_path, "rgb")
        op_dir = os.path.join(cfg.output_path, "opacity")
        os.makedirs(rgb_dir, exist_ok=True)
        os.makedirs(op_dir, exist_ok=True)
        _, lpips_key = self._ensure_lpips()
        rows = [None] * len(self.eval_data)
        pending = deque()

        def flush_one(writer):
            i, fi, (p, s, lp, png, png_op) = pending.popleft()
            rows[i] = {"psnr": float(p), "ssim": float(s),
                       lpips_key: float(lp)}
            writer.submit(cv2.imwrite, os.path.join(rgb_dir, f"{fi:06d}.png"),
                          np.ascontiguousarray(png.cpu().numpy()))
            writer.submit(cv2.imwrite, os.path.join(op_dir, f"{fi:06d}.png"),
                          np.ascontiguousarray(png_op.cpu().numpy()))

        with torch.inference_mode(), AsyncWriter() as writer:
            for i, frame, sample in self.eval_frames(
                    transform=self._eval_compact_transform()):
                pending.append((i, int(sample["frame_index"]),
                                self._eval_frame_metrics(frame)))
                if len(pending) >= 2:
                    flush_one(writer)
            while pending:
                flush_one(writer)
        mean_psnr = float(np.mean([r["psnr"] for r in rows]))
        mean_ssim = float(np.mean([r["ssim"] for r in rows]))
        log.info(f"PSNR: {mean_psnr:8.2f}")
        log.info(f"SSIM: {mean_ssim:8.2f}")
        write_quant(cfg.output_path, rows)
        return dict(psnr=mean_psnr, ssim=mean_ssim)


class PretrainEnvEngine(PretrainEngine):
    """model=nerf_pretrain_env: the same skeleton with poses always GT and
    the view-dependent field of nerf_lm_env.yaml (its optimizer decays to
    lr_end continuously: models/optim.py)."""

    pose_source_fixed = "gt"
