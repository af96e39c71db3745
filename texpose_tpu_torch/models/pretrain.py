"""Geometry-pretrain engines (port of texpose_tpu/models/pretrain.py):
``model=nerf_pretrain`` and ``model=nerf_pretrain_env`` fit the coarse
field — the 8×256 trunk the texture GAN later loads frozen with
``--resume_pretrain`` — and its RGB head to masked crops.

Training: one step is ``train_step(draws)`` with every random number of the
step in ``draws`` (``make_draws``: one ray permutation shared by every
image, the stratified depth uniforms, the density noise), so a test can
feed the JAX package's draws.  The whole train split renders R =
rand_rays // B rays per image through the coarse field kernel with the
composite in its epilogue (or, with ``kernels.coarse_mega`` off, the field
kernel then the composite kernel); the mask, scale-invariant depth and
masked render losses (weights 10**w) backpropagate through the composite
and field backward kernels into the trunk and the head; one Adam step on
the per-iteration schedule.

With ``nerf.fine_sampling`` a second field, ``nerf_fine``, renders the
coarse samples plus ``nerf.sample_intvs_fine`` importance samples drawn
from the coarse weights (models/render.py
``render_rays_nerf_hierarchical``); both fields run their field kernels
forward and backward, the composites are plain, ``loss_weight.render_fine``
adds the fine render loss, and Adam steps both fields.  Its state lives
under ``params/nerf_fine`` beside ``params/nerf``.

Evaluation: ``validate`` renders val_sub whole frames and logs the losses
and PSNR; ``evaluate_full`` renders every eval frame from a compact uint8
payload, with PSNR/SSIM/LPIPS, an RGB and an opacity PNG per frame and
quant.txt.  Both render the coarse field only, as the JAX package's.
Each frame program (``render_frame_body``, ``eval_compact_body``,
``eval_metrics_body``) is, on a card, one captured CUDA graph a JAX cache
key (models/frame_graph.py).
``generate_videos_synthesis`` (``evaluate --video``) renders an N-frame
novel-view orbit around eval frame 0 through the same whole-frame render,
and ``visualize`` (the freq.vis hook) eval frame 0's panels.

Under data parallelism (``mesh``) each rank renders its slice of the
per-image ray axis (R must divide over the ranks, as in JAX) from the
global draws, its losses are its shares of the global ones
(models/losses.py), and the gradients are summed before Adam; every
whole-frame render shards the frame's rays (parallel/mesh.py
``render_full_nerf_sharded``), and evaluation uploads the standard
payload.
"""

from __future__ import annotations

import os
import subprocess
from collections import deque
from functools import partial

import cv2
import numpy as np
import torch

from ..geometry.pose import get_novel_view_poses
from ..nn.fields import init_nerf
from ..ops.consts import device_const
from ..parallel.mesh import render_full_nerf_sharded
from ..utils import checkpoint as ckpt
from ..utils import vis
from ..utils.log import log
from ..utils.metrics import (frame_metrics, mse_to_psnr, png_bgr,
                             write_quant)
from ..utils.pipeline import AsyncWriter
from ..utils.spans import span
from .base import Engine, compute_dtype
from .losses import (masked_mse_loss, mse_loss, scale_invariant_depth_loss,
                     summarize_loss)
from .optim import make_pretrain_optimizer
from .render import (ray_batch_sample, render_full_nerf, render_rays_nerf,
                     render_rays_nerf_hierarchical)


# ------------------------------------------------------------ frame bodies
# The per-frame programs of evaluation, functions of tensors only (the JAX
# engine's jitted bodies; models/frame_graph.py runs them, captured on a
# card).  The statics come first, bound by the engine.

def render_frame_body(nerf, cfg, pose, intr, z_near, z_far, progress):
    """Whole-frame coarse render → dict of [1,HW,C] (JAX's
    ``_render_jit``); ``progress`` a device scalar (validation's c2f
    progress, 1 elsewhere)."""
    return render_full_nerf(nerf, cfg, pose, intr, z_near, z_far, progress,
                            compute_dtype(cfg))


def frame_payloads(lpips_params, rgb, opac, img):
    """rgb/img [H,W,3] (img masked), opac [H,W] → (psnr, ssim, lpips, BGR
    uint8 [H,W,3], opacity uint8 [H,W])."""
    p, s, lp, _ = frame_metrics(lpips_params, rgb, img, None)
    png_op = (torch.clamp(opac, 0.0, 1.0) * 255.0).to(torch.uint8)
    return p, s, lp, png_bgr(rgb), png_op


def eval_metrics_body(cfg, lpips_params, rgb_flat, opac_flat, image,
                      obj_mask):
    """A standard-payload frame's metrics and PNG payloads (JAX's
    ``_eval_metrics_fn`` program)."""
    mask = obj_mask.reshape(cfg.H, cfg.W, 1).float()
    img = image.reshape(3, cfg.H, cfg.W).permute(1, 2, 0) * mask
    return frame_payloads(lpips_params, rgb_flat.reshape(cfg.H, cfg.W, 3),
                          opac_flat.reshape(cfg.H, cfg.W), img)


def eval_compact_body(nerf, cfg, lpips_params, pose, intr, z_near, z_far,
                      image_u8, mask_u8):
    """A compact-payload frame in one program (JAX's ``_eval_compact_fn``):
    the whole-frame render, the metrics and the PNG payloads from the
    uint8 image and mask."""
    out = render_full_nerf(nerf, cfg, pose, intr, z_near, z_far,
                           device_const(1.0, torch.float32, pose.device),
                           compute_dtype(cfg))
    mask = mask_u8.reshape(cfg.H, cfg.W, 1).float()
    img = image_u8.reshape(3, cfg.H, cfg.W).permute(1, 2, 0).float() \
        / 255.0 * mask
    return frame_payloads(lpips_params, out["rgb"].reshape(cfg.H, cfg.W, 3),
                          out["opacity"].reshape(cfg.H, cfg.W), img)


class PretrainEngine(Engine):
    """model=nerf_pretrain."""

    pose_source_fixed = None       # the env variant forces "gt"

    # ------------------------------------------------------------- networks

    def build_networks(self, seed=None):
        """The coarse field from one seeded generator; with
        nerf.fine_sampling the fine field from its own (seed + 1)."""
        cfg = self.cfg
        seed = int(cfg.get("seed", 0) if seed is None else seed)
        fine = bool(cfg.nerf.get("fine_sampling"))
        log.info("building networks (coarse nerf"
                 + (" + fine nerf" if fine else "") + ")...")
        self.nerf = init_nerf(cfg, torch.Generator().manual_seed(seed)
                              ).to(self.device)
        self.nerf_fine = init_nerf(
            cfg, torch.Generator().manual_seed(seed + 1)).to(self.device) \
            if fine else None

    def max_iter(self):
        return int(self.cfg.max_iter)

    def rays_per_step(self):
        return int(self.cfg.nerf.rand_rays)

    def _fields(self):
        """(name under params/, field) of every trained field."""
        fields = [("nerf", self.nerf)]
        if self.nerf_fine is not None:
            fields.append(("nerf_fine", self.nerf_fine))
        return fields

    def _named_params(self, field="nerf"):
        """(keypath under params/<field>, parameter), trunk then RGB head."""
        nerf = dict(self._fields())[field]
        return [(f"{name}/{k.replace('.', '/')}", p)
                for name in ("mlp_feat", "mlp_rgb")
                for k, p in getattr(nerf, name).named_parameters()]

    def _all_params(self):
        """(keypath under params/, parameter) of every trained field."""
        return [(f"{field}/{path}", p) for field, _ in self._fields()
                for path, p in self._named_params(field)]

    def setup_optimizer(self):
        cfg = self.cfg
        self.opt = make_pretrain_optimizer(
            cfg, [p for _, p in self._all_params()], self.max_iter())
        if self.mesh is not None and self.rays_per_image() % self.mesh.size:
            raise ValueError(f"rays-per-image {self.rays_per_image()} must "
                             f"divide the mesh ({self.mesh.size} ranks)")
        self.init_step_state()
        self.draw_gen = torch.Generator(self.device)
        self.draw_gen.manual_seed(int(cfg.get("seed", 0)))

    def optimizers(self):
        return [self.opt]

    # ------------------------------------------------------------ train step

    def get_pose(self, batch, mode):
        source = self.pose_source_fixed or self.cfg.data.pose_source
        if mode == "train" and source == "predicted":
            return batch["pose_init"]
        return batch["pose"]

    def compute_loss(self, cfg, out, batch, ray_idx=None, mesh=None):
        """The train/val losses: out holds rgb/depth/opacity [B,R,C];
        ray_idx None means whole-frame (validation) tensors; with ``mesh``
        each loss is this rank's share of the global one."""
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
            loss["mask"] = mse_loss(out["opacity"], mask, mesh=mesh)
        if lw.get("depth") is not None:
            loss["depth"] = scale_invariant_depth_loss(
                out["depth"], depth_gt, mask_obj, mesh=mesh)
        for key, rgb in (("render", "rgb"), ("render_fine", "rgb_fine")):
            if rgb in out and lw.get(key) is not None:
                loss[key] = (masked_mse_loss(out[rgb], image, mask_obj,
                                             mesh=mesh)
                             if cfg.nerf.get("mask_obj")
                             else mse_loss(out[rgb], image, mesh=mesh))
        return loss

    def rays_per_image(self):
        return max(int(self.cfg.nerf.rand_rays) // len(self.train_data), 1)

    def make_draws(self, it):
        """Every random number of step ``it``, drawn on the device from the
        engine's generator: ray_idx [R] (one permutation of the pixels,
        shared by every image), depth [B,R,N,1] uniforms when sampling is
        stratified, density_noise [B,R,N] standard normals when the config
        sets nerf.density_noise_reg.  With fine sampling also the fine
        draws' uniforms fine [B,R,N_fine] (stratified) and the fine field's
        noise density_noise_fine [B,R,N+N_fine]."""
        cfg = self.cfg
        g, dev = self.draw_gen, self.device
        B, R = len(self.train_data), self.rays_per_image()
        N = int(cfg.nerf.sample_intvs)
        Nf = int(cfg.nerf.sample_intvs_fine) if self.nerf_fine is not None \
            else 0
        draws = {"ray_idx": torch.randperm(cfg.H * cfg.W, generator=g,
                                           device=dev)[:R]}
        if cfg.nerf.sample_stratified:
            draws["depth"] = torch.rand((B, R, N, 1), generator=g, device=dev)
            if Nf:
                draws["fine"] = torch.rand((B, R, Nf), generator=g,
                                           device=dev)
        if cfg.nerf.get("density_noise_reg"):
            draws["density_noise"] = torch.randn((B, R, N), generator=g,
                                                 device=dev)
            if Nf:
                draws["density_noise_fine"] = torch.randn(
                    (B, R, N + Nf), generator=g, device=dev)
        return draws

    def train_step(self, draws):
        """One step on the whole train split → the step's losses (device
        scalars, with 'all').  Its stages are spans (``step/...``,
        utils/spans.py), profiler ranges while a profiler runs.  Under
        data parallelism ``draws`` are the global draws; this rank
        renders its slice of the ray axis.  It reads the step count, its
        progress and the rate on the device and moves the count on there
        (``it_dev``), so a CUDA graph of it replays
        (models/step_graph.py)."""
        cfg = self.cfg
        draws = self.shard_draws(draws, {k: 1 for k in draws
                                         if k != "ray_idx"})
        progress = self.progress() if cfg.get("c2f") is not None else None
        batch = self.train_batch
        B = batch["image"].shape[0]
        with span("step/forward"):
            ray_idx = draws["ray_idx"][None].expand(B, -1)
            rays = (self.get_pose(batch, "train"), batch["intr"], ray_idx,
                    batch["z_near"], batch["z_far"], progress,
                    compute_dtype(cfg), draws.get("depth"))
            if self.nerf_fine is not None:
                out = render_rays_nerf_hierarchical(
                    self.nerf, self.nerf_fine, cfg, *rays, draws.get("fine"),
                    draws.get("density_noise"),
                    draws.get("density_noise_fine"), training=True)
            else:
                out = render_rays_nerf(self.nerf, cfg, *rays,
                                       draws.get("density_noise"),
                                       training=True)
            total, loss = summarize_loss(
                self.compute_loss(cfg, out, batch, ray_idx, self.mesh),
                cfg.loss_weight)
        with span("step/backward"):
            self.opt.zero_grad(set_to_none=True)
            total.backward()
            self.reduce_grads(self.opt)
        with span("step/update"):
            self.opt.step(self.it_dev)
        self.advance()
        return self.reduce_losses({k: v.detach() for k, v in loss.items()})

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
        for path, p in self._all_params():
            flat["params/" + path] = np_(p)
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
            for path, p in self._all_params():
                p.copy_(get("params/" + path, p.shape))
                self.opt.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": get(mu + path, p.shape),
                    "exp_avg_sq": get(nu + path, p.shape)}
        self.set_step(int(get("it", ()).item()))
        self.draw_gen.manual_seed(int(self.cfg.get("seed", 0)) * 1000003
                                  + self.it)
        return int(get("step", ()).item())

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
        """Whole-frame render of a [1,...] frame → dict of [1,HW,C]: the
        ``("frame", H, W)`` program (``render_frame_body``), or, under
        data parallelism, the rays sharded over the ranks."""
        cfg = self.cfg
        progress = 1.0 if progress is None else float(progress)
        args = dict(pose=frame["pose"], intr=frame["intr"],
                    z_near=frame["z_near"], z_far=frame["z_far"])
        if self.mesh is not None:
            return render_full_nerf_sharded(self.mesh, self.nerf, cfg,
                                            *args.values(), progress,
                                            compute_dtype(cfg))
        return self.frame_runner().run(
            ("frame", cfg.H, cfg.W), partial(render_frame_body, self.nerf,
                                             cfg), progress=progress, **args)

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

    def _depth_gt_range(self, zs, dmax):
        """Heatmap range of the depth_gt panel (the env variant overrides
        it with fixed fractions of depth.scale)."""
        return (0.7 * zs, dmax)

    def _z_near_range(self, zs, z_near):
        """Heatmap range of the z_near panel."""
        return (0.9 * zs, float(z_near.max()))

    def visualize(self, it, split="train"):
        """Render eval frame 0 with the current field and write nine panels
        as <output_path>/vis/<it>_<name>.png (and TensorBoard images):
        image, rgb, image_masked, pred_mask, gt_mask and the plasma/turbo
        depth heatmaps.  Draws nothing from the step's generator and
        builds no graph.  Every rank renders (a collective under data
        parallelism); rank 0 writes."""
        cfg = self.cfg
        progress = it / self.max_iter() if cfg.get("c2f") is not None else 1.0
        with torch.inference_mode():
            frame = self.eval_frame(0)
            out = self._render_frame(frame, progress)
            if not self.is_writer:
                return
            host = {k: v.cpu().numpy() for k, v in out.items()}
            fr = {k: frame[k].cpu().numpy()
                  for k in ("image", "obj_mask", "erode_mask", "depth_gt",
                            "z_near") if k in frame}
        H, W = cfg.H, cfg.W
        rgb = host["rgb"].reshape(1, H, W, 3).transpose(0, 3, 1, 2)
        depth = host["depth"].reshape(1, 1, H, W)
        opac = host["opacity"].reshape(1, 1, H, W)
        image = fr["image"]
        mask = fr["obj_mask"].reshape(1, 1, H, W)
        # the masked display takes the eroded mask when the loss does
        lmask = (fr["erode_mask"].reshape(1, 1, H, W)
                 if cfg.data.get("erode_mask_loss") and "erode_mask" in fr
                 else mask)
        depth_gt = fr["depth_gt"].reshape(1, 1, H, W)
        z_near = fr["z_near"].reshape(1, 1, H, W)
        depth_err = np.abs(depth - depth_gt) * mask
        vis_dir = os.path.join(cfg.output_path, "vis")
        zs = cfg.nerf.depth.scale
        dmax = max(float(depth.max()), 1e-6)
        panels = {
            "image": (image, (0, 1), None),
            "rgb": (rgb, (0, 1), None),
            "image_masked": (image * lmask + (1 - lmask), (0, 1), None),
            "pred_mask": (opac, (0, 1), None),
            "gt_mask": (mask, (0, 1), None),
            "depth": (depth * mask, (0.7 * zs, dmax), "plasma"),
            "depth_gt": (depth_gt, self._depth_gt_range(zs, dmax), "plasma"),
            "depth_error": (depth_err,
                            (0, float(np.quantile(depth_err, 0.99))),
                            "turbo"),
            "z_near": (z_near, self._z_near_range(zs, z_near), "plasma"),
        }
        for name, (img, rng, cmap) in panels.items():
            vis.tb_image(self.writer, it, split, name,
                         vis.preprocess_vis_image(img, rng, cmap))
            vis.dump_image_grid(
                os.path.join(vis_dir, f"{it:06d}_{name}.png"), img, rng, cmap)

    # ------------------------------------------------------------ evaluation

    def _eval_compact_transform(self):
        """The compact eval payload: uint8 image and mask (lossless: the
        dataset images are uint8/255 PNGs, masks {0,1}) and the f32 z maps
        the whole-frame render reads at every pixel; None under data
        parallelism (as in JAX) and when render.eval_compact is off."""
        if self.mesh is not None or not (
                self.cfg.get("render") or {}).get("eval_compact", True):
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
        (psnr, ssim, lpips, BGR uint8 [H,W,3], opacity uint8 [H,W]): the
        compact payload's ``("evalcompact",)`` program, else the
        ``("frame", H, W)`` render and the ``("evalmetrics",)`` program
        (eager under data parallelism)."""
        cfg = self.cfg
        lpips_params, _ = self._ensure_lpips()
        if "image_u8" in frame:
            return self.frame_runner().run(
                ("evalcompact",),
                partial(eval_compact_body, self.nerf, cfg, lpips_params),
                pose=frame["pose"], intr=frame["intr"],
                z_near=frame["z_near"], z_far=frame["z_far"],
                image_u8=frame["image_u8"], mask_u8=frame["obj_mask_u8"])
        out = self._render_frame(frame)
        body = partial(eval_metrics_body, cfg, lpips_params)
        args = dict(rgb_flat=out["rgb"], opac_flat=out["opacity"],
                    image=frame["image"], obj_mask=frame["obj_mask"])
        if self.mesh is not None:
            return body(**args)
        return self.frame_runner().run(("evalmetrics",), body, **args)

    def evaluate_full(self):
        """Render every eval frame, metric it, export an RGB and an opacity
        PNG per frame and quant.txt; returns the mean PSNR and SSIM.  Frame
        i+1 loads and uploads while frame i renders; results are pulled one
        frame behind the dispatch; PNG encodes run on a writer thread.
        Under data parallelism every rank renders and rank 0 writes.  The
        sweep is the span ``eval/sweep`` (``eval/pull`` a frame's result,
        ``eval/quant``; the pipeline's spans in utils/pipeline.py)."""
        with span("eval/sweep"):
            return self._evaluate_full()

    def _evaluate_full(self):
        cfg = self.cfg
        rgb_dir = os.path.join(cfg.output_path, "rgb")
        op_dir = os.path.join(cfg.output_path, "opacity")
        if self.is_writer:
            os.makedirs(rgb_dir, exist_ok=True)
            os.makedirs(op_dir, exist_ok=True)
        _, lpips_key = self._ensure_lpips()
        rows = [None] * len(self.eval_data)
        pending = deque()

        def flush_one(writer):
            i, fi, (p, s, lp, png, png_op) = pending.popleft()
            with span("eval/pull"):
                rows[i] = {"psnr": float(p), "ssim": float(s),
                           lpips_key: float(lp)}
                if not self.is_writer:
                    return
                png = np.ascontiguousarray(png.cpu().numpy())
                png_op = np.ascontiguousarray(png_op.cpu().numpy())
            writer.submit(cv2.imwrite, os.path.join(rgb_dir, f"{fi:06d}.png"),
                          png)
            writer.submit(cv2.imwrite, os.path.join(op_dir, f"{fi:06d}.png"),
                          png_op)

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
        if self.is_writer:
            with span("eval/quant"):
                write_quant(cfg.output_path, rows)
        return dict(psnr=mean_psnr, ssim=mean_ssim)

    def generate_videos_synthesis(self, N=60, fps=30):
        """Render an N-frame novel-view orbit ("gentle" motion, radius
        depth.scale·0.03) around eval frame 0's pose, with frame 0's
        intrinsics and depth range, and write <output_path>/novel_view/:
        novel_pose.npy [N,3,4] (the poses, for the pose estimator),
        rgb_<i>.png and depth_<i>.png (depth mapped from [0.7, 1.3]·scale
        to [0, 255]); then novel_view_{rgb,depth}.mp4 through ffmpeg, or a
        warning and the PNGs alone where ffmpeg is missing or fails.  Under
        data parallelism every rank renders and rank 0 writes."""
        cfg = self.cfg
        novel_path = os.path.join(cfg.output_path, "novel_view")
        frame = self.eval_frame(0)
        zs = cfg.nerf.depth.scale
        pose_novel = get_novel_view_poses(frame["pose"][0], N=N,
                                          scale=zs * 0.03, motion="gentle")
        if self.is_writer:
            os.makedirs(novel_path, exist_ok=True)
            np.save(os.path.join(novel_path, "novel_pose.npy"),
                    pose_novel.cpu().numpy())
        with torch.inference_mode(), AsyncWriter() as writer:
            for i in range(N):
                out = self._render_frame(dict(frame,
                                              pose=pose_novel[i:i + 1]))
                rgb = out["rgb"].reshape(cfg.H, cfg.W, 3)
                depth = out["depth"].reshape(cfg.H, cfg.W)
                rgb = (torch.clamp(rgb, 0, 1) * 255).flip(-1).to(torch.uint8)
                dvis = torch.clamp((depth - 0.7 * zs) / (0.6 * zs), 0, 1)
                dvis = (dvis * 255).to(torch.uint8)
                for kind, img in ((("rgb", rgb), ("depth", dvis))
                                  if self.is_writer else ()):
                    writer.submit(cv2.imwrite,
                                  os.path.join(novel_path, f"{kind}_{i}.png"),
                                  np.ascontiguousarray(img.cpu().numpy()))
        for kind in ("rgb", "depth") if self.is_writer else ():
            try:
                subprocess.run(
                    ["ffmpeg", "-y", "-framerate", str(fps), "-i",
                     os.path.join(novel_path, f"{kind}_%d.png"),
                     "-pix_fmt", "yuv420p",
                     os.path.join(cfg.output_path,
                                  f"novel_view_{kind}.mp4")],
                    check=True, capture_output=True, timeout=300)
            except (FileNotFoundError, subprocess.SubprocessError):
                log.warn(f"ffmpeg unavailable — kept {kind} PNG frames only")
        return novel_path


class PretrainEnvEngine(PretrainEngine):
    """model=nerf_pretrain_env: the same skeleton with poses always GT and
    the view-dependent field of nerf_lm_env.yaml (its optimizer decays to
    lr_end continuously: models/optim.py); its depth_gt and z_near panels
    span the fixed range [0.6, 0.8]·depth.scale."""

    pose_source_fixed = "gt"

    def _depth_gt_range(self, zs, dmax):
        return (0.6 * zs, 0.8 * zs)

    def _z_near_range(self, zs, z_near):
        return (0.6 * zs, 0.8 * zs)
