"""Evaluation entry point of the PyTorch/CUDA port, with the flags of the
JAX package's ``evaluate.py``:

    python -m texpose_tpu_torch.evaluate --model=nerf_adapt_st_gan \\
        --yaml=configs/nerf_lm_adapt_gan.yaml --data.image_size=[480,640] \\
        --syn2real --resume   (or --init_weights=<npz>)

Checkpoints are the JAX package's npz files.  ``--device=`` picks the
device (default: cuda when a card is visible, else cpu).
"""

import sys

import torch

from .models import get_engine
from .utils.config import set_options
from .utils.log import log


def main(argv=None):
    cfg = set_options(argv)
    log.title(f"[{' '.join(sys.argv)}]")
    if cfg.get("video"):
        raise NotImplementedError(
            "--video: the GAN model has no novel-view video synthesis")
    device = cfg.get("device") or ("cuda" if torch.cuda.is_available()
                                   else "cpu")
    engine = get_engine(cfg.model)(cfg, device)
    engine.load_dataset(eval_split=cfg.get("eval_split", "test"))
    engine.build_networks()
    engine.load_initial_weights()
    engine.restore_checkpoint()
    engine.evaluate_full()
    return engine


if __name__ == "__main__":
    main()
