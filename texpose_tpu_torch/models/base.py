"""Engine base (port of texpose_tpu/models/base.py).

State lives in torch objects on an explicit ``device``: the field as an
``nn.Module`` (``self.nerf``) and the per-image latent tables as tensors
(``self.latents``, optionally ``self.latents_ema``).  Checkpoints are the
JAX package's npz files in both directions (utils/checkpoint.py).

Training: the whole train split is uploaded once (``train_batch``); each
step's random draws come from one seeded device generator; the loop fires
the freq.scalar / freq.val / freq.ckpt hooks at the iterations the JAX
loop does (``scan_steps`` fuses steps there and is read and ignored here:
one step per iteration).  Losses reach the host only at freq.scalar, where
a non-finite one stops the run.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from ..utils import checkpoint as ckpt
from ..utils.log import log
from ..utils.metrics import MetricsWriter, StepTimer
from ..utils.pipeline import EvalPrefetcher, to_device


def resolve_device(cfg):
    """The entry points' device: ``--device=`` (default ``cuda``).  A CUDA
    device with no card visible raises: the port runs on the CPU only when
    the caller asks for it."""
    device = torch.device(cfg.get("device") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device={device} but no CUDA device is visible; pass "
            "--device=cpu to run on the CPU")
    return device


def compute_dtype(cfg):
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[str(cfg.get("compute_dtype",
                                                  "float32"))]


class Engine:
    """Evaluation engine base; subclasses build the networks."""

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # metrics compare against float32 references: no TF32 in the
            # SSIM/LPIPS convolutions or the plain matmuls (process-wide)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        os.makedirs(cfg.output_path, exist_ok=True)
        self.writer = MetricsWriter(cfg.output_path,
                                    use_tb=cfg.get("tb", False))
        self.timer = StepTimer()
        self.nerf = None
        self.latents = None
        self.latents_ema = None
        self.train_batch = None
        self.start_step = 0

    # ------------------------------------------------------------------ data

    def _split_subset(self, split):
        """train truncates by data.train_sub, every eval split by
        data.val_sub (also when the eval split is "test")."""
        d = self.cfg.data
        return d.get("train_sub") if split == "train" else d.get("val_sub")

    def make_dataset(self, split):
        from ..data import LineMODDataset
        return LineMODDataset(self.cfg, split=split,
                              subset=self._split_subset(split),
                              multi_obj=self.cfg.data.get("multi_obj", False),
                              splits_root=self.cfg.data.get("splits_root",
                                                            "splits"))

    def load_dataset(self, eval_split="val"):
        """The train split serves its length (latent tables) and camera
        poses (light-latent anchors); eval frames stream one at a time.
        Training uploads the train split with ``upload_train_split``."""
        cfg = self.cfg
        if cfg.data.get("val_on_test"):
            eval_split = "test"
        log.info(f"loading dataset {cfg.data.dataset}/{cfg.data.object} "
                 f"scene={cfg.data.scene}...")
        self.train_data = self.make_dataset("train")
        self.eval_data = self.make_dataset(eval_split)
        self._eval_cache = (None, None)
        log.info(f"train={len(self.train_data)} frames; {eval_split}="
                 f"{len(self.eval_data)} frames streamed per-frame at eval")

    def upload_train_split(self):
        """Stack the whole train split on the host and upload it once: the
        step gathers its batch on the device."""
        self.train_batch = to_device(self.train_data.prefetch_all(),
                                     self.device, batch=False)
        log.info(f"train split uploaded to {self.device}")

    def eval_frame(self, i):
        """Eval frame i as a dict of [1, ...] device tensors (size-1
        cache)."""
        if self._eval_cache[0] != i:
            self._eval_cache = (i, to_device(self.eval_data[i], self.device))
        return self._eval_cache[1]

    def eval_frames(self, transform=None):
        """(i, device frame, host sample) with frame i+1 loading and
        uploading on a worker thread while frame i renders."""
        with EvalPrefetcher(self.eval_data, self.device,
                            transform=transform) as pf:
            for i, frame, sample in pf:
                if transform is None:
                    self._eval_cache = (i, frame)
                yield i, frame, sample

    # ------------------------------------------------------- persist/restore

    def state_tensors(self):
        """{state_dict key: tensor} of everything a checkpoint restores."""
        out = {f"nerf.{k}": v for k, v in self.nerf.state_dict().items()}
        for name, tab in (("latents", self.latents),
                          ("latents_ema", self.latents_ema)):
            for k, v in (tab or {}).items():
                out[f"{name}.{k}"] = v
        return out

    def _load_state(self, incoming):
        """Copy matching tensors in place → (n_loaded, skipped)."""
        own = self.state_tensors()
        n, skipped = 0, []
        with torch.no_grad():
            for key, t in incoming.items():
                if key not in own:
                    continue
                if tuple(t.shape) != tuple(own[key].shape):
                    skipped.append(f"{key}: ckpt {tuple(t.shape)} vs "
                                   f"{tuple(own[key].shape)}")
                    continue
                own[key].copy_(t)
                n += 1
        return n, skipped

    def restore_checkpoint(self):
        """With cfg.resume, load the field and latents from
        <output_path>/model.ckpt (a JAX-format npz); every field and latent
        leaf must be present.  Other leaves are ignored."""
        fname = os.path.join(self.cfg.output_path, "model.ckpt")
        if not (self.cfg.get("resume") and os.path.exists(fname)):
            return False
        flat = ckpt.load_checkpoint_flat(fname)
        incoming = ckpt.jax_state_to_torch(flat)
        missing = sorted(set(self.state_tensors()) - set(incoming))
        if missing:
            raise KeyError(f"{fname}: checkpoint missing {missing}")
        _, skipped = self._load_state(incoming)
        if skipped:
            raise ValueError(f"{fname}: shape mismatch {skipped}")
        self.start_step = int(flat["step"]) if "step" in flat else 0
        log.info(f"resumed from {fname} @ step {self.start_step}")
        return True

    def _load_subtree(self, fname, prefix, what):
        """Copy the checkpoint's ``prefix`` leaves (e.g. nerf.mlp_feat.)
        into the field; raises when none matches."""
        incoming = {k: v for k, v in ckpt.jax_state_to_torch(
            ckpt.load_checkpoint_flat(fname)).items() if k.startswith(prefix)}
        n, skipped = self._load_state(incoming)
        if skipped:
            raise ValueError(f"{fname}: shape mismatch {skipped}")
        if n == 0:
            raise KeyError(f"no leaves under {prefix!r} found in {fname}")
        log.info(f"restored {what} ({n} leaves) from {fname}")
        return n

    def restore_pretrained_checkpoint(self):
        """--resume_pretrain: ONLY the geometry trunk (mlp_feat) from the
        group-level pretrain checkpoint."""
        cfg = self.cfg
        fname = cfg.get("pretrain_ckpt") or os.path.join(
            str(cfg.output_root), str(cfg.group), "pretrain_model.ckpt")
        return self._load_subtree(fname, "nerf.mlp_feat.", "geometry trunk")

    def restore_field_checkpoint(self):
        """--resume_real: the whole field from the pretrain checkpoint."""
        cfg = self.cfg
        fname = cfg.get("field_ckpt") or os.path.join(
            str(cfg.output_root), str(cfg.group), "pretrain_model.ckpt")
        return self._load_subtree(fname, "nerf.", "nerf field")

    def save_flat_checkpoint(self, flat, it):
        """<output_path>/model.ckpt (atomically) plus model/<it>.ckpt."""
        fname = os.path.join(self.cfg.output_path, "model.ckpt")
        tmp = fname + ".tmp"
        ckpt.save_checkpoint_flat(tmp, flat)
        os.replace(tmp, fname)
        d = os.path.join(self.cfg.output_path, "model")
        os.makedirs(d, exist_ok=True)
        shutil.copyfile(fname, os.path.join(d, f"{it}.ckpt"))
        log.info(f"saved checkpoint {fname} @ step {it}")
        return fname

    # ------------------------------------------------------------- training

    def train(self):
        """The JAX loop's schedule, one step per iteration: scalars at
        done % freq.scalar (and the first step), val at freq.val, ckpt at
        freq.ckpt, and a final checkpoint."""
        cfg = self.cfg
        max_iter = self.max_iter()
        log.title(f"TRAINING START ({type(self).__name__}, "
                  f"{max_iter} steps)")
        if self.start_step == 0:
            self.validate(0)
        prof = self._start_profiler() if cfg.get("profile") else None
        t_start = time.time()
        for it in range(self.start_step, max_iter):
            loss = self.train_step(self.make_draws(it))
            self.timer.tick()
            done = it + 1
            if done % cfg.freq.scalar == 0 or it == self.start_step:
                self.log_scalars(done, loss)
            if cfg.freq.get("vis") and done % cfg.freq.vis == 0:
                self.visualize(done)
            if cfg.freq.get("val") and done % cfg.freq.val == 0:
                self.validate(done)
            if cfg.freq.get("ckpt") and done % cfg.freq.ckpt == 0:
                self.save_checkpoint(done)
        if prof is not None:
            self._stop_profiler(prof)
        self.save_checkpoint(max_iter)
        wall = time.time() - t_start
        rate = (max_iter - self.start_step) / max(wall, 1e-9)
        log.title(f"TRAINING DONE in {wall:.1f}s ({rate:.2f} it/s)")

    def _start_profiler(self):
        """--profile: a torch.profiler trace of the training loop (host,
        and the card's kernels where the run is on one), as the JAX loop's
        jax.profiler trace; written by ``_stop_profiler``."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profiler(self, prof):
        """Ends the trace and writes it as a chrome-trace JSON to
        <output_path>/profile/trace.json (the JAX loop's trace directory)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        prof_dir = os.path.join(self.cfg.output_path, "profile")
        os.makedirs(prof_dir, exist_ok=True)
        fname = os.path.join(prof_dir, "trace.json")
        prof.export_chrome_trace(fname)
        log.info(f"torch.profiler trace → {fname}")
        return fname

    def log_scalars(self, it, loss, split="train"):
        """Pull the step's losses to the host; a non-finite one raises."""
        host = {k: float(v) for k, v in loss.items()}
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad:
            raise FloatingPointError(
                f"non-finite loss at step {it}: {bad} ({host})")
        host["it_per_sec"] = 1.0 / self.timer.it_time \
            if self.timer.it_time else 0.0
        host["rays_per_sec"] = self.timer.rays_per_sec(self.rays_per_step())
        self.writer.scalars(it, host, split=split)
        log.info(f"[{split} {it}] " + " ".join(f"{k}={v:.4g}"
                                                for k, v in host.items()))
        return host

    def visualize(self, it, split="train"):
        raise NotImplementedError(
            "visualize is not ported to texpose_tpu_torch yet: pass "
            "--freq.vis=null")

    def load_initial_weights(self):
        """cfg.init_weights=<npz>: overlay every matching field/latent leaf
        onto the freshly built state; shape mismatches are skipped and
        reported."""
        fname = self.cfg.get("init_weights")
        if not fname:
            return False
        incoming = ckpt.jax_state_to_torch(ckpt.load_checkpoint_flat(fname))
        n, skipped = self._load_state(incoming)
        if n == 0:
            raise KeyError(f"init_weights {fname}: no leaf matched the "
                           f"engine state (wrong model/config?)")
        log.info(f"initialized {n} leaves from {fname}")
        for s in skipped:
            log.warn(f"init_weights skipped (shape mismatch) {s}")
        return True

    # --------------------------------------------------------------- metrics

    def _ensure_lpips(self):
        """Lazy LPIPS parameters → (params, metric key)."""
        if not hasattr(self, "_lpips_params"):
            from ..nn.lpips import init_lpips, load_lpips_npz
            path = self.cfg.get("lpips_weights")
            if path and os.path.exists(str(path)):
                self._lpips_params = load_lpips_npz(str(path), self.device)
                self.lpips_key = "lpips"
                log.info(f"loaded LPIPS weights from {path}")
            else:
                self._lpips_params = init_lpips(
                    torch.Generator().manual_seed(0), self.device)
                self.lpips_key = "lpips_uncal"
                log.warn("no lpips_weights provided — LPIPS uses random "
                         "(fixed) AlexNet features; quant.txt will name "
                         "the column lpips_uncal")
        return self._lpips_params, self.lpips_key

    def build_networks(self, seed=None):
        raise NotImplementedError

    def evaluate_full(self):
        raise NotImplementedError

    def max_iter(self):
        raise NotImplementedError

    def rays_per_step(self):
        raise NotImplementedError

    def make_draws(self, it):
        raise NotImplementedError

    def train_step(self, draws):
        raise NotImplementedError

    def save_checkpoint(self, it):
        raise NotImplementedError

    def validate(self, it):
        raise NotImplementedError

