"""Image metrics and the quant.txt dump (port of the eval half of
texpose_tpu/utils/metrics.py)."""

from __future__ import annotations

import os

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
