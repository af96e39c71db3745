"""Image metrics (a frame's PSNR/SSIM/LPIPS and its PNG payload, as the
captured frame programs compute them), the quant.txt dump, the
metrics.jsonl writer (with TensorBoard scalars and images) and the step
timer (port of texpose_tpu/utils/metrics.py, which imports jax)."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..nn.lpips import lpips_distance
from ..ops.image import resize_bilinear
from ..ops.ssim import ssim


def psnr(pred, target, mask=None):
    """−10·log10(MSE).  With a mask, the MSE over the masked elements: the
    mask broadcasts against pred (e.g. [H,W,1] against [H,W,3]) and the
    denominator counts the broadcast elements, so a channel-less mask does
    not inflate the MSE by the channel count."""
    if mask is not None:
        m = torch.broadcast_to(mask, torch.broadcast_shapes(mask.shape,
                                                            pred.shape))
        mse = ((pred - target) ** 2 * m).sum() / (m.sum() + 1e-10)
    else:
        mse = ((pred - target) ** 2).mean()
    return -10.0 * torch.log10(mse + 1e-10)


def mse_to_psnr(mse):
    return -10.0 * torch.log10(torch.as_tensor(mse) + 1e-10)


def frame_metrics(lpips_params, rgb, img, raw_hw):
    """rgb/img [H,W,3] (img already masked) → (psnr, ssim, lpips, rgb) as
    device tensors, upscaled to raw_hw first when it differs
    (cv2.INTER_LINEAR float semantics)."""
    if raw_hw is not None and tuple(raw_hw) != tuple(rgb.shape[:2]):
        rgb = resize_bilinear(rgb, tuple(raw_hw))
        img = resize_bilinear(img, tuple(raw_hw))
    p = mse_to_psnr(((rgb - img) ** 2).mean())
    rgb_t = rgb.permute(2, 0, 1)[None]
    img_t = img.permute(2, 0, 1)[None]
    s = ssim(rgb_t, img_t)
    lp = lpips_distance(lpips_params, rgb_t * 2 - 1, img_t * 2 - 1).mean()
    return p, s, lp, rgb


def png_bgr(rgb):
    """[...,3] RGB in [0,1] → BGR uint8."""
    return (torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8).flip(-1)


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

    def image(self, step, name, img, split="train"):
        """img [C,H,W] float in [0,1]; TensorBoard only (the JSONL stream
        stays scalar)."""
        if self.tb is not None:
            self.tb.add_image(f"{split}/{name}", np.asarray(img), step)

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()


class NullWriter:
    """MetricsWriter's interface writing nothing: the writer of every
    data-parallel rank but rank 0."""

    def scalars(self, step, scalars, split="train"):
        pass

    def image(self, step, name, img, split="train"):
        pass

    def close(self):
        pass


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
