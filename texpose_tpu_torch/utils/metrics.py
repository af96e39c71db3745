"""Image metrics, the quant.txt dump, the metrics.jsonl writer and the
step timer (port of texpose_tpu/utils/metrics.py, which imports jax)."""

from __future__ import annotations

import json
import os
import time

import torch


def mse_to_psnr(mse):
    return -10.0 * torch.log10(torch.as_tensor(mse) + 1e-10)


def write_quant(output_path, rows):
    """rows: list of dicts (psnr/ssim/lpips…) → quant.txt, one line per
    frame; the header names the columns from the row keys."""
    fname = os.path.join(output_path, "quant.txt")
    keys = list(rows[0].keys()) if rows else ["psnr", "ssim", "lpips"]
    with open(fname, "w") as f:
        f.write("# frame " + " ".join(keys) + "\n")
        for i, r in enumerate(rows):
            f.write(f"{i} " + " ".join(str(r[k]) for k in keys) + "\n")
    return fname


class MetricsWriter:
    """JSONL metrics stream (<output_path>/metrics.jsonl) plus optional
    TensorBoard scalars, as the JAX package's writer."""

    def __init__(self, output_path, use_tb=False):
        os.makedirs(output_path, exist_ok=True)
        self.fname = os.path.join(output_path, "metrics.jsonl")
        self._f = open(self.fname, "a")
        self.tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(log_dir=output_path, flush_secs=10)
            except Exception:
                self.tb = None

    def scalars(self, step, scalars, split="train"):
        rec = {"step": int(step), "split": split, "time": time.time()}
        for k, v in scalars.items():
            v = float(v)
            rec[k] = v
            if self.tb is not None:
                self.tb.add_scalar(f"{split}/{k}", v, step)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()


class StepTimer:
    """EMA of the host time between ticks, and rays/s from it."""

    def __init__(self, ema=0.9):
        self.ema = ema
        self.it_time = None
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.it_time = dt if self.it_time is None else \
                self.ema * self.it_time + (1 - self.ema) * dt
        self._last = now
        return self.it_time

    def rays_per_sec(self, rays_per_step):
        return rays_per_step / self.it_time if self.it_time else 0.0
