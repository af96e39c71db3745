"""Captured training steps: the port of texpose_tpu/models/base.py
``finalize_step``.

The JAX engines run each training step as one compiled device program with
donated state, K of them per dispatch (``scan_steps``).  Here a
``StepRunner`` dispatches K steps of an engine's ``train_step`` and
returns the last step's losses.  On a card, after ``WARMUP_STEPS`` eager
steps (real, counted steps: they build the kernels and upload their
tables), it captures one step as a CUDA graph and replays that graph for
every later step; on the CPU, and under data parallelism (NCCL inside a
graph is not captured), every step runs eagerly.

What makes one step replayable:
  * the step reads nothing from the host: the count, the c2f progress, the
    patch-scale anneal and the rates come from the engine's device count
    (models/base.py ``it_dev``, models/optim.py rate tables), and its
    constants are cached device tensors (ops/consts.py);
  * the state it updates keeps its storage: the optimizers and the latent
    EMA work in place, the spectral-norm vectors are copied back in place;
  * the draws come from the engine's device generator, registered with
    the graph, so a replay consumes the generator exactly as an eager step
    does: ``scan_steps = K`` and ``= 1`` from one seed give one trajectory.

Capture records the step without running it, so what the step does on the
host during capture is undone: the host count ``it`` goes back, and so do
the kernel wrappers' launch counts.  A wrapper counts the launches it
makes itself; the kernels a replay launches are not counted on the host
(a trace of the device counts them: chip_smoke.py).
The kernels' weight packs (``PackCache``) key on the parameters'
``_version``, which a replay does not move: the parameters' versions are
bumped before capture (the packs are rebuilt inside the graph, as every
eager step rebuilds them) and after each dispatch that replayed (an eager
reader between dispatches — validate, visualize, save_checkpoint —
rebuilds them from the current values).  The runner holds every pack the
graph was captured over, so an eager rebuild never frees storage the graph
reads.  Loading a train state drops the graph (``Engine.drop_step_graph``):
the next dispatch warms up and captures again.  So does a change of a
switch the step reads (``route_key``: the kernel gates, the TEXPOSE_*
environment, cuDNN's and the matmuls' flags, cfg.nerf, the compute dtype):
``follow_route``, which the frame runner (models/frame_graph.py) calls
too, drops a runner's graphs when the key moved since they were captured.

A step that cannot be captured raises at capture, naming the engine and
its route; it never falls back to eager steps.

A dispatch is the span ``dispatch`` (utils/spans.py); a replay has no
span of its own (under a profiler a range costs a tenth of a millisecond
of host time).
"""

from __future__ import annotations

import json
import os

import torch

from ..kernels import launch_counters
from ..utils.spans import span

WARMUP_STEPS = 3


def route_name(engine):
    """The engine and the switches that pick its step's kernels."""
    cfg = engine.cfg
    kern = {k: v for k, v in (cfg.get("kernels") or {}).items()
            if v is not None}
    parts = [type(engine).__name__] + [f"kernels.{k}={v}"
                                        for k, v in sorted(kern.items())]
    if (cfg.get("nerf") or {}).get("fine_sampling"):
        parts.append("nerf.fine_sampling=true")
    if os.environ.get("TEXPOSE_MEGA_FULLBWD") == "1":
        parts.append("TEXPOSE_MEGA_FULLBWD=1")
    return " ".join(parts)


def route_key(engine):
    """Every switch a captured program of the engine reads besides its
    inputs: the kernel gates (``route_name``), the TEXPOSE_* environment,
    cuDNN's and the matmuls' algorithm flags, cfg.nerf and the compute
    dtype."""
    cfg = engine.cfg
    env = " ".join(f"{k}={v}" for k, v in sorted(os.environ.items())
                   if k.startswith("TEXPOSE_"))
    cudnn, tf32 = torch.backends.cudnn, torch.backends.cuda.matmul.allow_tf32
    env += (f" cudnn={cudnn.deterministic},{cudnn.benchmark},"
            f"{cudnn.allow_tf32} tf32={tf32}")
    return (f"{route_name(engine)} {env} compute_dtype="
            f"{cfg.get('compute_dtype', 'float32')} nerf="
            + json.dumps(cfg.get("nerf"), sort_keys=True, default=str))


def follow_route(runner):
    """Drop ``runner``'s captured graphs (``runner.drop()``) when its
    engine's ``route_key`` moved since they were captured, so a graph never
    replays another route."""
    key = route_key(runner.engine)
    if key != runner.key:
        runner.drop()
        runner.key = key


def bump_versions(tensors):
    """Mark ``tensors`` modified in place (a replay moved them without
    moving their ``_version``)."""
    for t in tensors:
        torch.autograd.graph.increment_version(t)


def pack_holdings(engine):
    """Every weight pack the engine's fields' kernel caches hold now."""
    held = []
    for name in ("nerf", "nerf_fine"):
        field = getattr(engine, name, None)
        for m in field.modules() if field is not None else ():
            kw = getattr(m, "_kernel_weights", None)
            if kw is not None:
                held.append((dict(kw._packs), getattr(kw, "_heads_of", None)))
    return held


class StepRunner:
    """Dispatches an engine's training steps, K at a time."""

    def __init__(self, engine):
        self.engine = engine
        self.captures = 0
        self.key = None
        self.capturable = engine.device.type == "cuda" and engine.mesh is None
        self.drop()

    @property
    def route(self):
        """How the steps run, for the logs."""
        eng = self.engine
        if eng.device.type != "cuda":
            return f"eager steps on {eng.device}"
        if eng.mesh is not None:
            return ("eager steps under mesh.dp (a step's NCCL collectives "
                    "are not captured)")
        return (f"one captured CUDA graph a step after {WARMUP_STEPS} eager "
                f"warm-up steps ({route_name(eng)})")

    def drop(self):
        """Forget the captured step; the next dispatch warms up again."""
        if getattr(self, "graph", None) is not None:
            torch.cuda.synchronize(self.engine.device)
        self.graph = self.out = self.held = None
        self.warm = 0

    def dispatch(self, k, make_draws=None):
        """Run ``k`` steps → the last step's losses (device scalars; after
        a replay they are the graph's outputs, rewritten by the next one).
        ``make_draws(it)``: each step's draws (default: the engine's
        ``make_draws``)."""
        eng = self.engine
        make_draws = make_draws or eng.make_draws
        with span("dispatch"):
            follow_route(self)
            loss, replayed = None, False
            for _ in range(k):
                if (self.graph is None and self.capturable
                        and self.warm >= WARMUP_STEPS):
                    self.capture(make_draws)
                if self.graph is not None:
                    loss = self.replay()
                    replayed = True
                else:
                    loss = eng.train_step(make_draws(eng.it))
                    self.warm += 1
            if replayed:
                bump_versions(eng.step_params())
            return loss

    def capture(self, make_draws):
        """Capture one step of the engine as a CUDA graph, its draws from
        the engine's generator registered with the graph; the host effects
        of the capture are undone."""
        eng = self.engine
        what = route_name(eng)
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                f"{what}: capturing the step needs "
                "torch.cuda.CUDAGraph.register_generator_state (torch "
                f"{torch.__version__} lacks it)")
        counters = launch_counters()
        before = [f.launches for f in counters]
        it0 = eng.it
        bump_versions(eng.step_params())
        graph.register_generator_state(eng.draw_gen)
        try:
            with torch.cuda.graph(graph):
                out = eng.train_step(make_draws(it0))
        except Exception as err:
            raise RuntimeError(
                f"{what}: the training step cannot be captured as a CUDA "
                f"graph: {err}") from err
        finally:
            eng.it = it0
            for f, n in zip(counters, before):
                f.launches = n
        self.graph, self.out = graph, out
        self.held = pack_holdings(eng)
        self.captures += 1
        bump_versions(eng.step_params())

    def replay(self):
        """One step: the graph's replay, and the host count moved on as
        the eager step moves it."""
        self.graph.replay()
        self.engine.it += 1
        return self.out
