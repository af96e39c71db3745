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
from .models.base import Engine, refuse_data_parallel, resolve_device
from .utils.config import set_options
from .utils.log import log


def main(argv=None):
    cfg = set_options(argv)
    log.title(f"[{' '.join(sys.argv)}]")
    refuse_data_parallel(cfg)
    engine_cls = get_engine(cfg.model)
    if cfg.get("video") and (engine_cls.generate_videos_synthesis
                             is Engine.generate_videos_synthesis):
        raise NotImplementedError(
            f"--video: {engine_cls.__name__} has no novel-view video "
            "synthesis (the pretrain engines do)")
    device = resolve_device(cfg)
    engine = engine_cls(cfg, device)
    engine.load_dataset(eval_split=cfg.get("eval_split", "test"))
    engine.build_networks()
    engine.load_initial_weights()
    engine.restore_checkpoint()
    engine.evaluate_full()
    if cfg.get("video"):
        engine.generate_videos_synthesis()
    return engine


if __name__ == "__main__":
    main()
