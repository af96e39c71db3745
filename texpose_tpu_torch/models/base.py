"""Engine base, evaluation half (port of texpose_tpu/models/base.py).

State lives in torch objects on an explicit ``device``: the field as an
``nn.Module`` (``self.nerf``) and the per-image latent tables as tensors
(``self.latents``, optionally ``self.latents_ema``).  Checkpoints are the
JAX package's npz files, read through utils/checkpoint.py.  Training,
optimizers and checkpoint writing belong to a later slice of the port.
"""

from __future__ import annotations

import os

import torch

from ..utils import checkpoint as ckpt
from ..utils.log import log
from ..utils.pipeline import EvalPrefetcher, to_device


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
        self.nerf = None
        self.latents = None
        self.latents_ema = None
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
        poses (light-latent anchors); eval frames stream one at a time."""
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

