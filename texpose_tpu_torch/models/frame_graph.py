"""Captured evaluation frames: the port of the JAX engines' per-frame
compiled programs (texpose_tpu/models/texture_gan.py ``_render_jits``,
``_render_jit``; models/pretrain.py ``_render_jit``,
``_eval_metrics_jit``, ``_eval_compact_jit``).

The JAX engines evaluate a frame as one jitted program per static-shape
key: the texture GAN's ``("evalcompact", raw_hw, P)``, ``("masked", P)``,
``("evalmetrics", raw_hw)`` and its whole-frame render, the pretrain's
whole-frame render, ``("evalcompact",)`` and ``("evalmetrics",)``.  A
``FrameRunner`` keeps one unit per such key (the whole-frame renders as
``("full", H, W)`` and ``("frame", H, W)``) and runs the key's body, a
function of tensors only (the engines' ``*_body`` functions), on the
unit's static input slots.

On a card each key's first call copies its inputs into the slots, runs
the body once eagerly (kernel builds, weight packs, cached constants,
first-call allocations), captures it as a CUDA graph and replays it; every
later call copies its inputs into the slots and replays.  The graphs of
one runner share one memory pool.  On the CPU the same slots run the body
eagerly.  Under data parallelism the engines render eagerly and sharded
(NCCL inside a frame is not captured) and do not call the runner.

What makes a frame replayable:
  * the body reads nothing from the host: its constants are cached device
    tensors (ops/consts.py ``device_const``, ops/image.py's resize
    tables), the latents and the c2f progress are slot inputs, and the
    host-side bucketing (models/render.py ``masked_ray_indices``) stays
    outside, its index set a slot input;
  * a replay overwrites the static outputs, so ``run`` hands back device
    copies of them: a result pulled one frame behind the dispatch (the
    engines' ``evaluate_full``) is never the next replay's;
  * the slots are filled on the consuming stream, after the prefetch
    worker's upload on the same stream (utils/pipeline.py); capture runs
    in thread-local mode, so that worker's pinning and copies go on
    beside it;
  * the weights follow training: the field's parameters' versions are
    bumped before capture, so the kernels' weight packs (``PackCache``)
    are rebuilt inside the graph from the parameters' storage at every
    replay, and after it, so an eager reader rebuilds its own; the runner
    holds every pack its graphs read.  An optimizer step, a captured
    training step's replay and a load all write that storage in place.

The captured frames are dropped with the captured step
(``Engine.drop_step_graph``: every load or restore of parameters), and
as the captured step is when a switch a body reads changes
(models/step_graph.py ``follow_route``), so a frame never replays another
route.  A frame that cannot be captured raises, naming the engine, the key
and the route; it is never evaluated eagerly instead.  The wrappers' launch
counts are those of the eager calls (``stats()``: each unit's warm call
and its replays); the kernels of a replay are counted from a device trace
(chip_smoke.py ``replay_trace``).  A call is the span ``frame/run``, its
graph's launch ``frame/replay`` (utils/spans.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import launch_counters
from ..utils.spans import span
from .step_graph import (bump_versions, follow_route, pack_holdings,
                         route_key, route_name)


def field_params(engine):
    """The parameters of the engine's fields (the kernels' packs key on
    them)."""
    return [p for name in ("nerf", "nerf_fine")
            if getattr(engine, name, None) is not None
            for p in getattr(engine, name).parameters()]


def _map(fn, out):
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    return tuple(fn(v) for v in out)


class _Unit:
    """One key's static input slots, its graph and its static outputs."""

    def __init__(self, key, body, inputs, device):
        self.key, self.body = key, body
        self.graph = self.out = self.held = None
        self.warm_launches = {}
        self.replays = 0
        with torch.inference_mode(False):
            self.slots = {k: _empty_like(v, device)
                          for k, v in inputs.items()}

    def load(self, inputs):
        """Copy this frame's inputs into the slots."""
        for k, slot in self.slots.items():
            v = inputs[k]
            if isinstance(v, (float, int)):
                slot.fill_(v)
                continue
            if isinstance(v, np.ndarray):
                # a host array goes up from pinned memory without blocking
                # the host on the stream (the allocator keeps the pinned
                # block until the copy has run)
                v = torch.from_numpy(np.require(v, requirements=("C", "W")))
                if slot.is_cuda:
                    v = v.pin_memory()
            if tuple(v.shape) != tuple(slot.shape):
                raise ValueError(
                    f"frame {self.key!r}: input {k} is {tuple(v.shape)}, "
                    f"its slot {tuple(slot.shape)}: the key must fix every "
                    "input's shape")
            slot.copy_(v, non_blocking=v.device.type == "cpu"
                       and v.is_pinned())


def _empty_like(v, device):
    if isinstance(v, (float, int)):
        return torch.empty((), dtype=torch.float32, device=device)
    if isinstance(v, np.ndarray):
        return torch.empty(v.shape, dtype=torch.from_numpy(
            np.zeros((), v.dtype)).dtype, device=device)
    return torch.empty(tuple(v.shape), dtype=v.dtype, device=device)


class FrameRunner:
    """Runs an engine's per-frame programs, one unit a key."""

    def __init__(self, engine):
        self.engine = engine
        self.device = engine.device
        self.capturable = (engine.device.type == "cuda"
                           and engine.mesh is None)
        self.units = {}
        self.captures = 0
        self.pool = self.key = None

    @property
    def route(self):
        """How the frames run, for the logs."""
        if not self.capturable:
            return f"eager frames on {self.device}"
        return ("one captured CUDA graph a frame program after one eager "
                f"warm call ({route_name(self.engine)})")

    def drop(self):
        """Forget every captured frame; the next call of a key warms up
        and captures again."""
        if any(u.graph is not None for u in self.units.values()):
            torch.cuda.synchronize(self.device)
        self.units = {}
        self.pool = None

    def run(self, key, body, **inputs):
        """The outputs (a dict or a tuple of tensors, as ``body`` returns
        them) of ``body(**inputs)`` for the frame program ``key``, as
        device copies no later call touches.  ``inputs``: tensors, numpy
        arrays or numbers (0-d float32 slots); the key fixes their shapes.
        The unit's body is the one of the key's first call."""
        with span("frame/run"):
            follow_route(self)
            unit = self.units.get(key)
            with torch.inference_mode():
                if unit is None:
                    unit = self.units[key] = _Unit(key, body, inputs,
                                                   self.device)
                unit.load(inputs)
                if not self.capturable:
                    return unit.body(**unit.slots)
                if unit.graph is None:
                    self._warm(unit)
                    self._capture(unit)
                with span("frame/replay"):
                    unit.graph.replay()
                unit.replays += 1
                return _map(torch.clone, unit.out)

    def _warm(self, unit):
        """One eager call on the slots; the wrappers' launches of it are
        the kernels each replay launches."""
        counters = launch_counters()
        before = [f.launches for f in counters]
        unit.body(**unit.slots)
        unit.warm_launches = {f.__name__: f.launches - n
                              for f, n in zip(counters, before)
                              if f.launches != n}

    def _capture(self, unit):
        """Capture the body on the slots into the shared pool, the field's
        packs rebuilt inside; the host effects of the capture are
        undone."""
        eng = self.engine
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        params = field_params(eng)
        counters = launch_counters()
        before = [f.launches for f in counters]
        graph = torch.cuda.CUDAGraph()
        bump_versions(params)
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = unit.body(**unit.slots)
        except Exception as err:
            raise RuntimeError(
                f"{type(eng).__name__}: the frame program {unit.key!r} "
                f"cannot be captured as a CUDA graph (route "
                f"{route_key(eng)}): {err}") from err
        finally:
            for f, n in zip(counters, before):
                f.launches = n
        unit.graph, unit.out = graph, out
        unit.held = pack_holdings(eng)
        self.captures += 1
        bump_versions(params)

    def stats(self):
        """{key: {"replays", "captured", "warm_launches"}} of the units
        since the last drop: the wrappers' launches of a unit's warm call
        are those of each of its replays."""
        return {k: {"replays": u.replays, "captured": u.graph is not None,
                    "warm_launches": dict(u.warm_launches)}
                for k, u in self.units.items()}


def pool_bytes(runner):
    """The bytes of the device segments of the runner's graph pool (the
    allocator's snapshot), or None off the card, before any capture, or
    where the snapshot names no segment's pool."""
    if runner.pool is None or runner.device.type != "cuda":
        return None
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    want = tuple(runner.pool)
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == want)
