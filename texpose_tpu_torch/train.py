"""Training entry point of the PyTorch/CUDA port, with the flags of the JAX
package's ``train.py``:

    python -m texpose_tpu_torch.train --model=nerf_pretrain \\
        --yaml=configs/nerf_lm_pretrain.yaml --group=Duck --name=pre
    python -m texpose_tpu_torch.train --model=nerf_adapt_st_gan \\
        --yaml=configs/nerf_lm_adapt_gan.yaml --group=Duck --name=run0 \\
        --resume_pretrain
    python -m texpose_tpu_torch.train --yaml=configs/nerf_lm_pretrain.yaml \\
        --nerf.fine_sampling=true --nerf.sample_intvs_fine=128 \\
        --loss_weight.render_fine=0   (hierarchical)

Bootstraps: options → engine → load_dataset (train split uploaded once) →
build_networks → setup_optimizer → init_weights / resume_pretrain /
resume_real → resume → train.  Checkpoints are the JAX package's npz
files, both ways.  ``--device=`` picks the device (default: cuda; with no
card visible the run raises unless ``--device=cpu`` asks for the CPU).
``freq.vis`` writes the engines' panels under <output_path>/vis.

Data parallelism, ``--mesh.dp=true`` (parallel/mesh.py): one process per
card.  Under torchrun (``torchrun --nproc_per_node=N -m
texpose_tpu_torch.train ... --mesh.dp=true``) each worker joins the group
its environment names; without it, on a host with more than one visible
card, this entry point starts ``mesh.n_devices`` workers (null: every
visible card) on the same argv itself, and a worker that dies fails the
run with its exit code.  Rank 0 writes the files.
"""

import sys

from .models import get_engine
from .models.base import resolve_device
from .parallel.mesh import data_parallel, launch_workers, worker_count
from .utils.config import save_options_file, set_options
from .utils.log import log


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = set_options(argv)
    log.title(f"[{' '.join(sys.argv)}]")
    n = worker_count(cfg)
    if n:
        return launch_workers("texpose_tpu_torch.train", argv, n)
    device = resolve_device(cfg)
    with data_parallel(cfg, device) as mesh:
        engine = get_engine(cfg.model)(cfg, device, mesh=mesh)
        engine.load_dataset()
        engine.upload_train_split()
        engine.build_networks()
        engine.setup_optimizer()
        engine.load_initial_weights()
        if cfg.get("resume_pretrain"):
            engine.restore_pretrained_checkpoint()
        elif cfg.get("resume_real"):
            engine.restore_field_checkpoint()
        engine.restore_checkpoint()
        if cfg.get("save_config_mode", True) and engine.is_writer:
            save_options_file(cfg)
        engine.train()
    return engine


if __name__ == "__main__":
    main()
