"""Optimizers and learning-rate schedules (port of
texpose_tpu/models/optim.py; tests/test_optim_parity.py pins the
semantics the JAX package reproduces).

  * generator (heads + latent tables): ``Adam`` (β 0.9/0.999, ε 1e-8
    outside the bias-corrected root — optax.adam's update), learning rate
    a per-epoch staircase lr·γ^⌊count/steps_per_epoch⌋; with
    ``optim.lr_latent`` the latent tables are a second parameter group on
    their own staircase.
  * discriminator: ``RMSprop`` (decay 0.99, ε 1e-8 outside the root,
    optax's eps_in_sqrt=False), constant lr unless ``optim_disc.lr_end``
    sets a staircase.
  * pretrain (trunk + RGB head): ``Adam`` with a per-iteration schedule —
    lr·γ^count with the yaml's literal ``optim.sched.gamma``
    (nerf_lm_pretrain.yaml), else the continuous decay
    lr·(lr_end/lr)^(count/max_iter) (nerf_lm_env.yaml), else constant.

``Adam`` and ``RMSprop`` are optax's updates as plain tensor ops, with
torch's per-parameter state keys (``step``, ``exp_avg``, ``exp_avg_sq``;
``step``, ``square_avg``).  Each group's rates over the run's horizon
(max_iter counts) are a float32 table on the parameters' device, made once
from its schedule, and ``step(count)`` reads the rate at a device count
(the number of updates already applied, optax's schedule count; a count
past the horizon keeps the last rate): nothing of a step reads the host,
so a captured CUDA graph replays it (models/step_graph.py).  Every
decaying schedule is optax.exponential_decay's float32 arithmetic
(``_exp_decay``); the table holds the same values.
"""

from __future__ import annotations

import numpy as np
import torch


def _exp_decay(lr0, rate, steps, staircase=True):
    """optax.exponential_decay(lr0, steps, rate, staircase) as optax
    computes it, in float32: lr0 at count ≤ 0, else lr0·rate^p with p =
    count / steps (floored with ``staircase``).  The float32 rate's
    rounding is raised to p, so over a 20k-step run of 8-step epochs the
    value parts from the float64 product by ~4e-5 of itself.
    ``schedule.table(n)``: counts 0 … n−1 as float32, each the value
    ``schedule`` gives (p formed over the whole range, the power taken
    once per distinct p)."""
    lr32, rate32, steps32 = np.float32(lr0), np.float32(rate), \
        np.float32(steps)

    def value(p):
        return float(lr32 * np.power(rate32, p))

    def schedule(count):
        if count <= 0:
            return float(lr32)
        p = np.float32(count) / steps32
        if staircase:
            p = np.floor(p)
        return value(p)

    def table(n):
        p = np.arange(n, dtype=np.float32) / steps32
        if staircase:
            p = np.floor(p)
        uniq, inv = np.unique(p, return_inverse=True)
        out = np.asarray([value(q) for q in uniq], np.float32)[inv]
        out[:1] = lr32
        return out

    schedule.table = table
    return schedule


def _constant(lr):
    def schedule(count):
        return lr
    schedule.table = lambda n: np.full(n, lr, np.float32)
    return schedule


def generator_schedule(cfg, max_iter, steps_per_epoch):
    lr, lr_end = cfg.optim.lr, cfg.optim.get("lr_end")
    gamma = (cfg.optim.get("sched") or {}).get("gamma")
    if gamma:
        return _exp_decay(lr, float(gamma), steps_per_epoch)
    if lr_end:
        n_epochs = max(max_iter // steps_per_epoch, 1)
        return _exp_decay(lr, (lr_end / lr) ** (1.0 / n_epochs),
                          steps_per_epoch)
    return _constant(lr)


def latent_schedule(cfg, max_iter, steps_per_epoch):
    lr0 = cfg.optim.lr_latent
    lr, lr_end = cfg.optim.lr, cfg.optim.get("lr_end")
    lr_latent_end = cfg.optim.get("lr_latent_end") or (
        lr0 * (lr_end / lr) if lr_end else None)
    gamma = (cfg.optim.get("sched") or {}).get("gamma")
    if gamma:
        return _exp_decay(lr0, float(gamma), steps_per_epoch)
    if lr_latent_end:
        n_epochs = max(max_iter // steps_per_epoch, 1)
        return _exp_decay(lr0, (lr_latent_end / lr0) ** (1.0 / n_epochs),
                          steps_per_epoch)
    return _constant(lr0)


def disc_schedule(cfg, max_iter, steps_per_epoch):
    dlr, dlr_end = cfg.optim_disc.lr, cfg.optim_disc.get("lr_end")
    if dlr_end:
        n_epochs = max(max_iter // steps_per_epoch, 1)
        return _exp_decay(dlr, (dlr_end / dlr) ** (1.0 / n_epochs),
                          steps_per_epoch)
    return _constant(dlr)


class _Optax(torch.optim.Optimizer):
    """An optax update over torch parameter groups, each with its
    ``schedule`` and that schedule's ``lr_table`` of ``horizon`` counts."""

    def __init__(self, groups, horizon, **defaults):
        super().__init__(groups, defaults)
        for g in self.param_groups:
            g["lr_table"] = torch.from_numpy(
                g["schedule"].table(int(horizon))).to(g["params"][0].device)

    def _rate(self, group, count):
        """-rate of the update: the table's at the device count."""
        tab = group["lr_table"]
        at = count.clamp(max=tab.shape[0] - 1).reshape(1)
        return -tab.index_select(0, at).reshape(())

    def _state(self, p, **moments):
        """The parameter's state, made on its first update (zero moments,
        count 0) and its count moved to the parameter's device."""
        st = self.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32,
                                     device=p.device)
            for k in moments:
                st[k] = torch.zeros_like(p, memory_format=torch.
                                         preserve_format)
        elif st["step"].device != p.device:
            st["step"] = st["step"].to(p.device, torch.float32)
        return st


class Adam(_Optax):
    """optax.adam: μ ← (1−β1)·g + β1·μ, ν ← (1−β2)·g² + β2·ν, count + 1,
    the update −lr · (μ/(1−β1^count)) / (√(ν/(1−β2^count)) + ε) added to
    the parameter; each operation over a group's tensors at once (the
    ``_foreach`` ops: the same float32 operations per element, a few
    launches a group).  The bias corrections read the group's first
    tensor's count: a group's tensors step together, as optax keeps one
    count for them all."""

    def __init__(self, groups, horizon, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(groups, horizon, b1=b1, b2=b2, eps=eps)

    @torch.no_grad()
    def step(self, count):
        """One update at ``count`` (a device integer: the updates already
        applied), its rates from the groups' tables."""
        for g in self.param_groups:
            b1, b2, eps = g["b1"], g["b2"], g["eps"]
            ps = [p for p in g["params"] if p.grad is not None]
            if not ps:
                continue
            grads = [p.grad for p in ps]
            sts = [self._state(p, exp_avg=None, exp_avg_sq=None) for p in ps]
            mu = [st["exp_avg"] for st in sts]
            nu = [st["exp_avg_sq"] for st in sts]
            n = [st["step"] for st in sts]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            torch._foreach_add_(n, 1)
            m_hat = torch._foreach_div(mu, 1 - torch.pow(b1, n[0]))
            v_hat = torch._foreach_div(nu, 1 - torch.pow(b2, n[0]))
            torch._foreach_sqrt_(v_hat)
            torch._foreach_add_(v_hat, eps)
            upd = torch._foreach_div(m_hat, v_hat)
            torch._foreach_mul_(upd, self._rate(g, count))
            torch._foreach_add_(ps, upd)


class RMSprop(_Optax):
    """optax.rmsprop(eps_in_sqrt=False): ν ← (1−d)·g² + d·ν, the update
    −lr · g/(√ν + ε) (as optax forms it: (1/(√ν + ε))·g) added to the
    parameter, over a group's tensors at once.  ``step`` counts the
    updates (optax keeps no count)."""

    def __init__(self, groups, horizon, decay=0.99, eps=1e-8):
        super().__init__(groups, horizon, decay=decay, eps=eps)

    @torch.no_grad()
    def step(self, count):
        for g in self.param_groups:
            d, eps = g["decay"], g["eps"]
            ps = [p for p in g["params"] if p.grad is not None]
            if not ps:
                continue
            grads = [p.grad for p in ps]
            sts = [self._state(p, square_avg=None) for p in ps]
            nu = [st["square_avg"] for st in sts]
            torch._foreach_mul_(nu, d)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - d))
            torch._foreach_add_([st["step"] for st in sts], 1)
            scale = torch._foreach_sqrt(nu)
            torch._foreach_add_(scale, eps)
            torch._foreach_reciprocal_(scale)
            upd = torch._foreach_mul(scale, grads)
            torch._foreach_mul_(upd, self._rate(g, count))
            torch._foreach_add_(ps, upd)


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
    return Adam(groups, max_iter)


def make_disc_optimizer(cfg, params, max_iter, steps_per_epoch):
    return RMSprop([{"params": list(params),
                     "schedule": disc_schedule(cfg, max_iter,
                                               steps_per_epoch)}], max_iter)


def pretrain_schedule(cfg, max_iter):
    lr, lr_end = cfg.optim.lr, cfg.optim.get("lr_end")
    gamma = (cfg.optim.get("sched") or {}).get("gamma")
    if gamma:
        return _exp_decay(lr, float(gamma), 1)
    if lr_end:
        return _exp_decay(lr, lr_end / lr, max_iter, staircase=False)
    return _constant(lr)


def make_pretrain_optimizer(cfg, params, max_iter):
    """Adam over the field's parameters on ``pretrain_schedule``."""
    return Adam([{"params": list(params),
                  "schedule": pretrain_schedule(cfg, max_iter)}], max_iter)

