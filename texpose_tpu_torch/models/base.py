"""Engine base (port of texpose_tpu/models/base.py).

State lives in torch objects on an explicit ``device``: the field as an
``nn.Module`` (``self.nerf``) and the per-image latent tables as tensors
(``self.latents``, optionally ``self.latents_ema``).  Checkpoints are the
JAX package's npz files in both directions (utils/checkpoint.py).

Training: the whole train split is uploaded once (``train_batch``); each
step's random draws come from one seeded device generator.  The step's
state lives on the device: the step count (``it_dev``, mirrored on the
host as ``it``), the c2f ``progress`` formed from it, the patch-scale
anneal and each optimizer group's rate, read from a float32 table of the
run's max_iter counts at that count, so nothing of a step reads the host.  ``train``
runs K = ``scan_k()`` steps per dispatch (``scan_steps``, gcd-clamped so
every freq.* hook and max_iter stay reachable, as the JAX loop's
``finalize_step``) and fires the freq.scalar / freq.vis / freq.val /
freq.ckpt hooks after each dispatch at ``done = it + K``, where the JAX
loop fires them; a dispatch returns its last step's losses.  On a card
each step after a few eager warm-up steps is one replay of a captured
CUDA graph (models/step_graph.py); on the CPU and under data parallelism
the steps run eagerly.  Evaluation runs each frame program (render,
metrics, PNG payload) through ``frame_runner()``, one captured CUDA graph
a program on a card (models/frame_graph.py).  Losses reach the host only
at freq.scalar, where a non-finite one stops the run.

Data parallelism (``mesh``, a parallel.mesh.Mesh; the entry points build
it under mesh.dp): every rank holds the same state on its own card, draws
the same global draws and steps its shard; rank 0 alone writes files
(checkpoints, metrics, panels, PNGs, quant.txt), and every other rank runs
the same renders and collectives and writes nothing.
"""

from __future__ import annotations

import math
import os
import shutil
import time

import numpy as np
import torch

from ..parallel.mesh import (all_reduce_grads, all_reduce_scalars,
                             replicate, shard_axis)
from ..utils import checkpoint as ckpt
from ..utils import spans
from ..utils.log import log
from ..utils.metrics import MetricsWriter, NullWriter, StepTimer
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

    def __init__(self, cfg, device, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(
            device)
        self.is_writer = mesh is None or mesh.rank == 0
        if self.device.type == "cuda":
            # metrics compare against float32 references: no TF32 in the
            # SSIM/LPIPS convolutions or the plain matmuls (process-wide)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if self.is_writer:
            os.makedirs(cfg.output_path, exist_ok=True)
            self.writer = MetricsWriter(cfg.output_path,
                                        use_tb=cfg.get("tb", False))
        else:
            self.writer = NullWriter()
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
        self.drop_step_graph()
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

    def save_checkpoint(self, it):
        """The train state as <output_path>/model.ckpt (rank 0 only)."""
        if not self.is_writer:
            return None
        return self.save_flat_checkpoint(self.train_state_flat(it), it)

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

    # ------------------------------------------------------- step state

    def init_step_state(self):
        """The step count at 0, on the host (``it``) and on the device
        (``it_dev``, the count the step reads), and no captured step."""
        self.it = 0
        self.it_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self._max_iter_dev = torch.tensor(float(self.max_iter()),
                                          dtype=torch.float32,
                                          device=self.device)
        self.drop_step_graph()

    def set_step(self, it):
        """Set the step count (a restored train state): both copies, and
        the captured step, if any, is dropped."""
        self.it = int(it)
        self.it_dev.fill_(self.it)
        self.drop_step_graph()

    def advance(self):
        """The end of a step: the device count moves on inside the step,
        its host mirror beside it."""
        self.it_dev.add_(1)
        self.it += 1

    def progress(self):
        """The c2f progress as the JAX step forms it, the count as float32
        over max_iter, on the device."""
        return self.it_dev.to(torch.float32) / self._max_iter_dev

    def optimizers(self):
        """The optimizers a training step updates."""
        raise NotImplementedError

    def step_params(self):
        """Every tensor the optimizers update."""
        return [p for opt in self.optimizers() for g in opt.param_groups
                for p in g["params"]]

    def step_runner(self):
        """The runner of this engine's training steps
        (models/step_graph.py)."""
        if getattr(self, "_runner", None) is None:
            from .step_graph import StepRunner
            self._runner = StepRunner(self)
        return self._runner

    def drop_step_graph(self):
        """Forget the captured step and the captured frames (the state
        they were captured over was replaced); the next dispatch and the
        next call of each frame program warm up and capture anew."""
        if getattr(self, "_runner", None) is not None:
            self._runner.drop()
        if getattr(self, "_frames", None) is not None:
            self._frames.drop()

    def frame_runner(self):
        """The runner of this engine's per-frame evaluation programs
        (models/frame_graph.py), keyed as the JAX engine's jit cache."""
        if getattr(self, "_frames", None) is None:
            from .frame_graph import FrameRunner
            self._frames = FrameRunner(self)
        return self._frames

    # ------------------------------------------------------------- training

    def scan_k(self):
        """Steps per dispatch: cfg.scan_steps clamped by gcd so every set
        freq.* hook and max_iter stay reachable (the JAX engine's
        ``scan_k``)."""
        K = max(int(self.cfg.get("scan_steps") or 1), 1)
        for f in ("scalar", "val", "ckpt", "vis"):
            v = self.cfg.freq.get(f)
            if v:
                K = math.gcd(K, int(v))
        return max(math.gcd(K, self.max_iter()), 1)

    def train(self):
        """The JAX loop's schedule, K = ``scan_k()`` steps per dispatch:
        scalars at done % freq.scalar (and after the first dispatch),
        panels at freq.vis, val at freq.val, ckpt at freq.ckpt, with done
        = it + K, and a final checkpoint."""
        cfg = self.cfg
        max_iter = self.max_iter()
        log.title(f"TRAINING START ({type(self).__name__}, "
                  f"{max_iter} steps)")
        K = self.scan_k()
        runner = self.step_runner()
        log.info(f"{K} steps per dispatch, {runner.route}")
        if self.mesh is not None:
            replicate(self.state_tensors(), self.mesh)
        if self.start_step == 0:
            self.validate(0)
        prof = self._start_profiler() \
            if cfg.get("profile") and self.is_writer else None
        t_start = time.time()
        for it in range(self.start_step, max_iter, K):
            loss = runner.dispatch(K)
            self.timer.tick()
            done = it + K
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

    # ------------------------------------------------ data parallelism

    def shard_draws(self, draws, dims=None):
        """This rank's slice of the step's global draws along their batch
        axis (dims {name: axis}, default 0); unchanged without a mesh."""
        if self.mesh is None:
            return draws
        dims = dims or {}
        return {k: shard_axis(v, self.mesh, dims.get(k, 0))
                for k, v in draws.items()}

    def reduce_grads(self, opt):
        """Sum the ranks' gradient shares of the optimizer's parameters into
        the global gradient (no-op without a mesh)."""
        if self.mesh is not None:
            all_reduce_grads([p for g in opt.param_groups
                              for p in g["params"]], self.mesh)

    def reduce_losses(self, loss):
        """The step's loss terms summed over the ranks' shares: the global
        losses (unchanged without a mesh)."""
        if self.mesh is None:
            return loss
        return all_reduce_scalars(loss, self.mesh)

    def _start_profiler(self):
        """--profile: a torch.profiler trace of the training loop (host,
        and the card's kernels where the run is on one), as the JAX loop's
        jax.profiler trace; written by ``_stop_profiler``.  The program's
        spans (utils/spans.py) record while it runs."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        spans.take()
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profiler(self, prof):
        """Ends the trace and writes it as a chrome-trace JSON to
        <output_path>/profile/trace.json (the JAX loop's trace directory),
        with the spans of the threads the profiler does not record (the
        evaluation's prefetch worker and PNG writer), a track each."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        prof_dir = os.path.join(self.cfg.output_path, "profile")
        os.makedirs(prof_dir, exist_ok=True)
        fname = os.path.join(prof_dir, "trace.json")
        prof.export_chrome_trace(fname)
        kept, dropped = spans.take()
        spans.add_to_chrome_trace(fname, kept)
        if dropped:
            log.warn(f"{dropped} worker spans past the buffer's "
                        f"{spans.CAPACITY} are not in the trace")
        log.info(f"torch.profiler trace → {fname}")
        return fname

    def log_scalars(self, it, loss, split="train"):
        """Pull the step's losses to the host; a non-finite one raises.
        The rates count the K steps of a dispatch (the timer ticks once a
        dispatch)."""
        host = {k: float(v) for k, v in loss.items()}
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad:
            raise FloatingPointError(
                f"non-finite loss at step {it}: {bad} ({host})")
        K = self.scan_k()
        host["it_per_sec"] = K / self.timer.it_time \
            if self.timer.it_time else 0.0
        host["rays_per_sec"] = self.timer.rays_per_sec(
            self.rays_per_step() * K)
        self.writer.scalars(it, host, split=split)
        log.info(f"[{split} {it}] " + " ".join(f"{k}={v:.4g}"
                                                for k, v in host.items()))
        return host

    def visualize(self, it, split="train"):
        """The freq.vis hook: panels of the current state under
        <output_path>/vis (and TensorBoard); engines override it.  Default:
        no-op."""

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

    def generate_videos_synthesis(self, N=60, fps=30):
        """Novel-view orbit videos; the pretrain engines implement it (the
        GAN engine has none, as in the JAX package)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement novel-view video "
            f"synthesis")

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

    def validate(self, it):
        raise NotImplementedError

