"""Training entry point of the PyTorch/CUDA port, with the flags of the JAX
package's ``train.py``:

    python -m texpose_tpu_torch.train --model=nerf_pretrain \\
        --yaml=configs/nerf_lm_pretrain.yaml --group=Duck --name=pre \\
        --freq.vis=null
    python -m texpose_tpu_torch.train --model=nerf_adapt_st_gan \\
        --yaml=configs/nerf_lm_adapt_gan.yaml --group=Duck --name=run0 \\
        --resume_pretrain --freq.vis=null

Bootstraps: options → engine → load_dataset (train split uploaded once) →
build_networks → setup_optimizer → init_weights / resume_pretrain /
resume_real → resume → train.  Checkpoints are the JAX package's npz
files, both ways.  ``--device=`` picks the device (default: cuda; with no
card visible the run raises unless ``--device=cpu`` asks for the CPU).
Not ported yet, and refused before anything is built: ``visualize`` (a run
whose freq.vis would fire within max_iter) here, and the pretrain's
``nerf.fine_sampling`` by its engine's ``build_networks``.
"""

import sys

from .models import get_engine
from .models.base import resolve_device
from .utils.config import save_options_file, set_options
from .utils.log import log


def _check_unported(cfg, engine):
    vis = (cfg.get("freq") or {}).get("vis")
    if vis and int(vis) <= engine.max_iter():
        raise NotImplementedError(
            f"freq.vis={vis} fires within max_iter={engine.max_iter()}, but "
            "visualize is not ported to texpose_tpu_torch yet: pass "
            "--freq.vis=null")


def main(argv=None):
    cfg = set_options(argv)
    log.title(f"[{' '.join(sys.argv)}]")
    device = resolve_device(cfg)
    engine = get_engine(cfg.model)(cfg, device)
    engine.load_dataset()
    _check_unported(cfg, engine)
    engine.upload_train_split()
    engine.build_networks()
    engine.setup_optimizer()
    engine.load_initial_weights()
    if cfg.get("resume_pretrain"):
        engine.restore_pretrained_checkpoint()
    elif cfg.get("resume_real"):
        engine.restore_field_checkpoint()
    engine.restore_checkpoint()
    if cfg.get("save_config_mode", True):
        save_options_file(cfg)
    engine.train()
    return engine


if __name__ == "__main__":
    main()
