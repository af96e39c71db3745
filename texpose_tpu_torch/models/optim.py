"""Optimizers and learning-rate schedules (port of
texpose_tpu/models/optim.py; tests/test_optim_parity.py pins the
semantics the JAX package reproduces).

  * generator (heads + latent tables): torch ``Adam`` (β 0.9/0.999, ε 1e-8
    outside the bias-corrected root — optax.adam's update), learning rate
    a per-epoch staircase lr·γ^⌊count/steps_per_epoch⌋; with
    ``optim.lr_latent`` the latent tables are a second parameter group on
    their own staircase.
  * discriminator: torch ``RMSprop(alpha=0.99, eps=1e-8)`` (ε outside the
    root, optax's eps_in_sqrt=False), constant lr unless
    ``optim_disc.lr_end`` sets a staircase.
  * pretrain (trunk + RGB head): torch ``Adam`` with a per-iteration
    schedule — lr·γ^count with the yaml's literal ``optim.sched.gamma``
    (nerf_lm_pretrain.yaml), else the continuous decay
    lr·(lr_end/lr)^(count/max_iter) (nerf_lm_env.yaml), else constant.
``set_lrs(opt, count)`` writes each group's rate for the update about to
run; count is the number of updates already applied (optax's schedule
count).
"""

from __future__ import annotations

import torch


def _staircase(lr0, rate, steps_per_epoch):
    return lambda count: lr0 * rate ** (count // steps_per_epoch)


def generator_schedule(cfg, max_iter, steps_per_epoch):
    lr, lr_end = cfg.optim.lr, cfg.optim.get("lr_end")
    gamma = (cfg.optim.get("sched") or {}).get("gamma")
    if gamma:
        return _staircase(lr, float(gamma), steps_per_epoch)
    if lr_end:
        n_epochs = max(max_iter // steps_per_epoch, 1)
        return _staircase(lr, (lr_end / lr) ** (1.0 / n_epochs),
                          steps_per_epoch)
    return lambda count: lr


def latent_schedule(cfg, max_iter, steps_per_epoch):
    lr0 = cfg.optim.lr_latent
    lr, lr_end = cfg.optim.lr, cfg.optim.get("lr_end")
    lr_latent_end = cfg.optim.get("lr_latent_end") or (
        lr0 * (lr_end / lr) if lr_end else None)
    gamma = (cfg.optim.get("sched") or {}).get("gamma")
    if gamma:
        return _staircase(lr0, float(gamma), steps_per_epoch)
    if lr_latent_end:
        n_epochs = max(max_iter // steps_per_epoch, 1)
        return _staircase(lr0, (lr_latent_end / lr0) ** (1.0 / n_epochs),
                          steps_per_epoch)
    return lambda count: lr0


def disc_schedule(cfg, max_iter, steps_per_epoch):
    dlr, dlr_end = cfg.optim_disc.lr, cfg.optim_disc.get("lr_end")
    if dlr_end:
        n_epochs = max(max_iter // steps_per_epoch, 1)
        return _staircase(dlr, (dlr_end / dlr) ** (1.0 / n_epochs),
                          steps_per_epoch)
    return lambda count: dlr


def make_generator_optimizer(cfg, heads, latents, max_iter, steps_per_epoch):
    """Adam over [heads] (+ [latents] as its own group with lr_latent)."""
    sched_h = generator_schedule(cfg, max_iter, steps_per_epoch)
    if cfg.optim.get("lr_latent"):
        groups = [{"params": list(heads), "schedule": sched_h},
                  {"params": list(latents),
                   "schedule": latent_schedule(cfg, max_iter,
                                               steps_per_epoch)}]
    else:
        groups = [{"params": list(heads) + list(latents),
                   "schedule": sched_h}]
    for g in groups:
        g["lr"] = g["schedule"](0)
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def make_disc_optimizer(cfg, params, max_iter, steps_per_epoch):
    sched = disc_schedule(cfg, max_iter, steps_per_epoch)
    return torch.optim.RMSprop([{"params": list(params), "schedule": sched,
                                 "lr": sched(0)}],
                               alpha=0.99, eps=1e-8)


def pretrain_schedule(cfg, max_iter):
    lr, lr_end = cfg.optim.lr, cfg.optim.get("lr_end")
    gamma = (cfg.optim.get("sched") or {}).get("gamma")
    if gamma:
        return lambda count: lr * float(gamma) ** count
    if lr_end:
        return lambda count: lr * (lr_end / lr) ** (count / max_iter)
    return lambda count: lr


def make_pretrain_optimizer(cfg, params, max_iter):
    """Adam over the field's parameters on ``pretrain_schedule``."""
    sched = pretrain_schedule(cfg, max_iter)
    return torch.optim.Adam([{"params": list(params), "schedule": sched,
                              "lr": sched(0)}], betas=(0.9, 0.999), eps=1e-8)


def set_lrs(opt, count):
    for g in opt.param_groups:
        g["lr"] = g["schedule"](int(count))
