"""Evaluation entry point of the PyTorch/CUDA port, with the flags of the
JAX package's ``evaluate.py``:

    python -m texpose_tpu_torch.evaluate --model=nerf_adapt_st_gan \\
        --yaml=configs/nerf_lm_adapt_gan.yaml --data.image_size=[480,640] \\
        --syn2real --resume   (or --init_weights=<npz>)
    python -m texpose_tpu_torch.evaluate --model=nerf_pretrain \\
        --yaml=configs/nerf_lm_pretrain.yaml --name=pre --resume

Checkpoints are the JAX package's npz files.  ``--device=`` picks the
device (default: cuda; with no card visible the run raises unless
``--device=cpu`` asks for the CPU).  ``--video`` (the pretrain engines'
novel-view orbit) is not ported yet and is refused before anything is
built.
"""

import sys

from .models import get_engine
from .models.base import resolve_device
from .utils.config import set_options
from .utils.log import log


def main(argv=None):
    cfg = set_options(argv)
    log.title(f"[{' '.join(sys.argv)}]")
    if cfg.get("video"):
        raise NotImplementedError(
            "--video: novel-view video synthesis is not ported to "
            "texpose_tpu_torch yet (ROADMAP.md), and the GAN model has none")
    device = resolve_device(cfg)
    engine = get_engine(cfg.model)(cfg, device)
    engine.load_dataset(eval_split=cfg.get("eval_split", "test"))
    engine.build_networks()
    engine.load_initial_weights()
    engine.restore_checkpoint()
    engine.evaluate_full()
    return engine


if __name__ == "__main__":
    main()
