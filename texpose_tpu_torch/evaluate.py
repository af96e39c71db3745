"""Evaluation entry point of the PyTorch/CUDA port, with the flags of the
JAX package's ``evaluate.py``:

    python -m texpose_tpu_torch.evaluate --model=nerf_adapt_st_gan \\
        --yaml=configs/nerf_lm_adapt_gan.yaml --data.image_size=[480,640] \\
        --syn2real --resume   (or --init_weights=<npz>)
    python -m texpose_tpu_torch.evaluate --model=nerf_pretrain \\
        --yaml=configs/nerf_lm_pretrain.yaml --name=pre --resume

Checkpoints are the JAX package's npz files.  ``--device=`` picks the
device (default: cuda; with no card visible the run raises unless
``--device=cpu`` asks for the CPU).  ``--video`` renders the pretrain
engines' novel-view orbit (the GAN model has none: refused before anything
is built).  ``--mesh.dp=true`` shards each frame's rays over one process
per card, as in ``train`` (its docstring says how the workers start);
rank 0 writes the files.
"""

import sys

from .models import get_engine
from .models.base import Engine, resolve_device
from .parallel.mesh import data_parallel, launch_workers, worker_count
from .utils.config import set_options
from .utils.log import log


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = set_options(argv)
    log.title(f"[{' '.join(sys.argv)}]")
    engine_cls = get_engine(cfg.model)
    if cfg.get("video") and (engine_cls.generate_videos_synthesis
                             is Engine.generate_videos_synthesis):
        raise NotImplementedError(
            f"--video: {engine_cls.__name__} has no novel-view video "
            "synthesis (the pretrain engines do)")
    n = worker_count(cfg)
    if n:
        return launch_workers("texpose_tpu_torch.evaluate", argv, n)
    device = resolve_device(cfg)
    with data_parallel(cfg, device) as mesh:
        engine = engine_cls(cfg, device, mesh=mesh)
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
