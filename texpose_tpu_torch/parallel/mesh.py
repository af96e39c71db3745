"""Data parallelism on torch.distributed (port of texpose_tpu/parallel/mesh.py).

One process per card.  Where the JAX package shards a batch axis over a
1-D device mesh inside one program and XLA inserts the psum, the port runs
one rank per card under a process group (NCCL on CUDA tensors, gloo on the
CPU) and does by hand what the partitioner does there:

  * data parallel: every rank draws the step's GLOBAL draws from an
    identically seeded generator and takes its equal slice of the batch
    axis (the pretrain's per-image ray axis, the GAN's patch batch:
    ``shard_axis``); each loss term is this rank's share of the global
    loss (``global_ratio`` for the masked means, the local mean over the
    world size for the plain ones: models/losses.py), so the backward
    gives this rank's share of the global gradient and
    ``all_reduce_grads`` sums the shares.  The optimizers then step
    identical gradients on identical states on every rank.
  * ray-sharded rendering: ``render_full_*_sharded`` and
    ``render_masked_nerf_st_sharded`` render this rank's slice of a
    frame's (padded) rays in ``rand_rays`` chunks through
    models/render.py, and every rank assembles the whole frame
    (``gather_slots``).

Only ``all_reduce`` and ``broadcast`` are used: both backends take them on
CUDA tensors, so two ranks can share one card over gloo.  A gather is an
all_reduce(SUM) over a zeroed buffer in which each rank fills its own slot
(x + 0 is exact, so the assembly is bit for bit).

Entry points (``train``, ``evaluate``): ``data_parallel`` joins the group
that torchrun's environment names (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR/MASTER_PORT), and ``worker_count`` / ``launch_workers`` start
one worker per card on the same argv where mesh.dp is set on a host with
several cards and no group.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..models.render import (fill_mask_defaults, masked_ray_indices,
                             render_rays_nerf, render_rays_nerf_st)


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: rank, world size
    and its device."""

    rank: int
    size: int
    device: torch.device


def _local_device(device):
    """cuda → cuda:LOCAL_RANK (an explicit index is kept); raises where it
    names no visible card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    index = device.index
    if index is None:
        index = int(os.environ.get("LOCAL_RANK", 0))
    count = torch.cuda.device_count()
    if index >= count:
        raise RuntimeError(f"cuda:{index} (LOCAL_RANK) names no visible "
                           f"card: {count} visible")
    return torch.device("cuda", index)


def make_mesh(n_devices=None, device="cuda"):
    """The Mesh of this process: from the default group where one is
    initialized, else from torchrun's environment, whose group it
    initializes (NCCL on cuda:LOCAL_RANK, gloo on the CPU).  n_devices, when
    set, must equal the world size."""
    dev = _local_device(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "data parallelism needs a process group or torchrun's "
                "environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    size = dist.get_world_size()
    if n_devices and int(n_devices) != size:
        raise ValueError(f"mesh.n_devices={n_devices} but the group has "
                         f"{size} ranks")
    return Mesh(rank=dist.get_rank(), size=size, device=dev)


@contextlib.contextmanager
def data_parallel(cfg, device):
    """The run's Mesh where mesh.dp is set and a process group exists or
    torchrun's environment names one (joined here and left on exit), else
    None: with one card and no group the run stays single-process, as the
    JAX engine's ``len(jax.devices()) > 1`` gate."""
    if not ((cfg.get("mesh") or {}).get("dp") and (
            dist.is_initialized() or "WORLD_SIZE" in os.environ)):
        yield None
        return
    owns = not dist.is_initialized()
    mesh = make_mesh(cfg.mesh.get("n_devices"), device)
    try:
        yield mesh
    finally:
        if owns:
            dist.destroy_process_group()


def worker_count(cfg):
    """Workers an entry point starts itself: with mesh.dp set, no process
    group, no torchrun environment and more than one visible card,
    mesh.n_devices (null: every visible card); else 0."""
    if not (cfg.get("mesh") or {}).get("dp") or dist.is_initialized() \
            or "WORLD_SIZE" in os.environ:
        return 0
    count = torch.cuda.device_count()
    if count <= 1:
        return 0
    n = int(cfg.mesh.get("n_devices") or count)
    if n > count:
        raise ValueError(f"mesh.n_devices={n} but {count} cards are "
                         "visible")
    return n


def _worker(local_rank, module, argv, n, port):
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    importlib.import_module(module).main(argv)


def launch_workers(module, argv, n):
    """Run ``module.main(argv)`` in n spawned workers under torchrun's
    environment (rank i on cuda:i) and wait for all of them.  A worker that
    dies ends the others, and the run exits with its code."""
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        mp.start_processes(_worker, args=(module, list(argv), n, port),
                           nprocs=n, join=True, start_method="spawn")
    except mp.ProcessExitedException as e:
        code = e.exit_code if e.exit_code > 0 else 128 - e.exit_code
        raise SystemExit(code) from e


# ----------------------------------------------------------- collectives

def replicate(tree, mesh):
    """Broadcast every tensor of ``tree`` (a tensor, or a list / tuple /
    dict of them) from rank 0, in place; returns the tree.  Through
    ``detach()``, which shares the version counter, so the weight packs
    keyed by it are rebuilt."""
    for t in _leaves(tree):
        dist.broadcast(t.detach(), 0)
    return tree


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for x in tree for t in _leaves(x)]


def shard_axis(x, mesh, dim=0):
    """This rank's equal slice of ``x`` along ``dim``."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"axis {dim} of length {n} does not split over "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    return x.narrow(dim, mesh.rank * per, per)


def shard_leading_axis(tree, mesh):
    """This rank's equal slice of every leaf's leading axis (a tensor, or a
    dict of them)."""
    if isinstance(tree, dict):
        return {k: shard_axis(v, mesh) for k, v in tree.items()}
    return shard_axis(tree, mesh)


def dp_constrain_batch(batch, mesh):
    """This rank's slice of every [B, ...] leaf of a step's batch."""
    return shard_leading_axis(batch, mesh)


def all_sum(x, mesh):
    """Σ over the ranks of a tensor (a copy; no gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def global_ratio(num, den, mesh, eps=0.0):
    """This rank's share of a masked mean over the global batch:
    num_local / (Σ_ranks den + eps).  The denominator is all-reduced without
    gradient and the numerator stays local, so the ranks' shares sum to the
    global Σnum / (Σden + eps)."""
    return num / (all_sum(den, mesh) + eps)


def all_reduce_scalars(values, mesh):
    """{name: scalar tensor} → the same keys summed over the ranks, in one
    all_reduce."""
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(())
                        for k in keys])
    dist.all_reduce(flat)
    return dict(zip(keys, flat.unbind()))


def all_reduce_grads(params, mesh):
    """Sum every parameter's gradient over the ranks, flattened into one
    buffer per dtype (a missing gradient counts as zeros) → the bytes
    reduced."""
    groups = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        groups.setdefault(p.grad.dtype, []).append(p)
    total = 0
    for ps in groups.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        dist.all_reduce(flat)
        total += flat.numel() * flat.element_size()
        offset = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
    return total


def gather_slots(local, mesh):
    """{name: [B, per, C]} of this rank → {name: [B, per·size, C]} on every
    rank, rank r's rows at [r·per, (r+1)·per): one all_reduce(SUM) over a
    zeroed buffer in which each rank fills its own slot."""
    keys = list(local)
    widths = [local[k].shape[-1] for k in keys]
    part = torch.cat([local[k] for k in keys], dim=-1)
    B, per, C = part.shape
    buf = torch.zeros((B, per * mesh.size, C), dtype=part.dtype,
                      device=part.device)
    buf[:, mesh.rank * per:(mesh.rank + 1) * per] = part
    dist.all_reduce(buf)
    return dict(zip(keys, buf.split(widths, dim=-1)))


# ------------------------------------------------------ sharded renders

def _pad_rays(HW, n_shards, chunk):
    """Smallest padded ray count divisible by n_shards with per-shard size
    divisible by chunk."""
    per = -(-HW // n_shards)
    per = -(-per // chunk) * chunk
    return per * n_shards, per


def _render_shards(render_fn, idx, mesh, chunk):
    """idx [P] ray indices with P % (chunk·size) == 0: this rank renders
    its slice chunk by chunk (render_fn(idx [chunk]) → dict of [B,chunk,C])
    → dict of [B,P,C] on every rank."""
    per = idx.shape[0] // mesh.size
    mine = idx[mesh.rank * per:(mesh.rank + 1) * per]
    outs = [render_fn(ci) for ci in mine.reshape(per // chunk, chunk)]
    return gather_slots({k: torch.cat([o[k] for o in outs], dim=1)
                         for k in outs[0]}, mesh)


def render_full_nerf_sharded(mesh, nerf, cfg, pose, intr, z_near, z_far,
                             progress=None, compute_dtype=None, chunk=None):
    """Whole-frame coarse render, the H·W ray axis sharded over the ranks →
    dict of [B,HW,C] (models/render.py render_full_nerf's result)."""
    B = pose.shape[0]
    HW = cfg.H * cfg.W
    chunk = int(chunk or cfg.nerf.rand_rays)
    total, _ = _pad_rays(HW, mesh.size, chunk)
    idx = torch.clamp(torch.arange(total, device=pose.device), max=HW - 1)

    def body(ci):
        return render_rays_nerf(nerf, cfg, pose, intr, ci[None].expand(B, -1),
                                z_near, z_far, progress, compute_dtype)

    out = _render_shards(body, idx, mesh, chunk)
    return {k: v[:, :HW] for k, v in out.items()}


def masked_ray_indices_sharded(obj_mask, chunk, n_shards):
    """Host-side: object-ray indices padded so each of the n_shards gets an
    equal, chunk-divisible slice (the power-of-two bucketing of
    models.render.masked_ray_indices is kept for power-of-two meshes).

    obj_mask [HW] → (idx [P] int64 with P % (chunk·n_shards) == 0,
    n_valid)."""
    idx_p, n = masked_ray_indices(obj_mask, chunk)
    unit = chunk * n_shards
    total = -(-len(idx_p) // unit) * unit
    # edge padding DUPLICATES ray indices; scatter_masked_st's indexed
    # write is well defined only because the eval render is per-ray
    # deterministic (mid-bin samples), so every duplicate writes the same
    # value
    idx_p = np.pad(idx_p, (0, total - len(idx_p)), mode="edge")
    return idx_p, n


def render_masked_nerf_st_sharded(mesh, nerf, cfg, pose, intr, z_near,
                                  z_far, latent_trans, latent_light, ray_idx,
                                  progress=None, compute_dtype=None,
                                  chunk=None):
    """Masked ST render: the PADDED OBJECT-RAY index set ray_idx [P] (from
    masked_ray_indices_sharded), not H·W, shards over the ranks → dict of
    [B,P,C] aligned with ray_idx on every rank; scatter with
    models.render.scatter_masked_st."""
    B = pose.shape[0]
    chunk = int(chunk or cfg.nerf.rand_rays)

    def body(ci):
        return render_rays_nerf_st(nerf, cfg, pose, intr,
                                   ci[None].expand(B, -1), z_near, z_far,
                                   latent_trans, latent_light, progress,
                                   compute_dtype)

    return _render_shards(body, ray_idx, mesh, chunk)


def render_full_nerf_st_sharded(mesh, nerf, cfg, pose, intr, z_near, z_far,
                                latent_trans, latent_light, progress=None,
                                compute_dtype=None, chunk=None,
                                obj_mask=None):
    """Whole-frame static/transient render, the ray axis sharded, with the
    reference's mask-fill defaults where obj_mask [B,HW] is given → dict of
    [B,HW,C] (render_full_nerf_st's result)."""
    B = pose.shape[0]
    HW = cfg.H * cfg.W
    chunk = int(chunk or cfg.nerf.rand_rays)
    total, _ = _pad_rays(HW, mesh.size, chunk)
    idx = torch.clamp(torch.arange(total, device=pose.device), max=HW - 1)

    def body(ci):
        return render_rays_nerf_st(nerf, cfg, pose, intr,
                                   ci[None].expand(B, -1), z_near, z_far,
                                   latent_trans, latent_light, progress,
                                   compute_dtype)

    out = {k: v[:, :HW] for k, v in
           _render_shards(body, idx, mesh, chunk).items()}
    return fill_mask_defaults(cfg, out, obj_mask)
