"""The traced run's reading of a ``torch.profiler`` device trace.

``traced(fn)`` runs ``fn`` inside a ``bench/window`` range under the
profiler and returns a ``TraceView``: the window's span (host clock of the
range), the device events inside it (kernels, copies, fills), the busy
time as the union of their intervals, and the largest idle gaps labelled
with the host operation that was running across each.

The stage alignment is a copy of ``texpose_tpu_torch/tools/step_sections.py
--split``'s: one eager step runs with chosen module functions of the
program in named ranges (their backward bracketed by identity Functions
that leave zero-length ranges on autograd's thread) and its kernels take
the innermost range around their launch; each replayed step's kernels then
take the stage of the eager kernel they align with (difflib over the
kernel names), since a CUDA graph replay runs no profiler range.
"""

from __future__ import annotations

import contextlib
import re
from difflib import SequenceMatcher
from functools import wraps

import torch

WINDOW = "bench/window"


def kineto_events(prof):
    """A finished profile's events as (is_device, correlation id, name,
    start ns, end ns, is_user_annotation) tuples, read from the profiler's
    raw results (building its event tree takes tens of seconds over 10^5
    kernels)."""
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        raise RuntimeError("the profiler keeps no kineto_results")
    return [(str(e.device_type()).endswith("CUDA"), e.correlation_id(),
             e.name(), e.start_ns(), e.end_ns(),
             getattr(e, "is_user_annotation", lambda: False)())
            for e in res.events()]


def union_ns(intervals):
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals):
    """The union of intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn):
    """fn() inside the ``bench/window`` range under the profiler (CPU and
    CUDA activities), the device synchronized inside → its events."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    return kineto_events(prof)


class TraceView:
    """The traced window: ``units`` steps or frames of the cell's timed
    path.  ``kernels``: [(name, start ns, end ns, stage)] of the device
    events inside the window, by start (stage None unless aligned)."""

    def __init__(self, events, units, stages=None):
        wins = [(s, e) for dev, _, n, s, e, user in events
                if not dev and n == WINDOW]
        if not wins:
            raise RuntimeError("the trace holds no bench/window range")
        self.t0, self.t1 = wins[0]
        self.events = events
        self.units = units
        dev = sorted(((n, s, e, c) for d, c, n, s, e, user in events
                      if d and not user and s >= self.t0 and e <= self.t1),
                     key=lambda k: k[1])
        self.kernels = [(n, s, e, None) for n, s, e, _ in dev]
        if stages is not None:
            self.kernels = [(n, s, e, st) for (n, s, e, _), st in
                            zip(self.kernels, stages(events, dev))]
        self.busy_ns = union_ns([(s, e) for _, s, e, _ in self.kernels])

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self):
        return self.busy_ns / 1e9

    def device_ms(self, match):
        """Device ms a unit of the kernels whose name ``match`` accepts."""
        return sum(e - s for n, s, e, _ in self.kernels
                   if match(n)) / 1e6 / max(self.units, 1)

    def breakdown(self, top=10):
        """{"device_ops": [[name, s]], "idle_gaps": [[host op, s]]}: the
        device operations that took most time, and the longest idle gaps
        by the innermost host operation running across each."""
        by = {}
        for n, s, e, _ in self.kernels:
            short = re.sub(r"\(.*", "", n.replace("(anonymous namespace)::",
                                                  ""))[:160] or n[:160]
            by[short] = by.get(short, 0) + (e - s)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        busy = merged([(s, e) for _, s, e, _ in self.kernels])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        host = [(n, s, e) for d, _, n, s, e, user in self.events
                if not d and n != WINDOW]
        out = []
        for length, s, e in gaps:
            mid = (s + e) / 2
            around = [h for h in host if h[1] <= mid <= h[2]]
            name = min(around, key=lambda h: h[2] - h[1])[0] if around \
                else "no traced host operation"
            out.append([name[:160], length / 1e9])
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": out}


# ---------------------------------------------------------------- stages

class _Mark(torch.autograd.Function):
    """Identity whose backward leaves a zero-length range
    ``stage/bwd<label`` (on a function's outputs: its backward begins) or
    ``stage/bwd>label`` (on its inputs: it ends)."""

    @staticmethod
    def forward(ctx, x, label, end):
        ctx.label, ctx.end = label, end
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(
                f"stage/bwd{'>' if ctx.end else '<'}{ctx.label}"):
            pass
        return g, None, None


def _marked(obj, label, end):
    if isinstance(obj, torch.Tensor):
        return (_Mark.apply(obj, label, end)
                if obj.requires_grad and torch.is_grad_enabled() else obj)
    if type(obj) is dict:
        return {k: _marked(v, label, end) for k, v in obj.items()}
    if type(obj) in (list, tuple):
        return type(obj)(_marked(v, label, end) for v in obj)
    return obj


def _staged(fn, stage, counter):
    @wraps(fn)
    def run(*args, **kwargs):
        counter[0] += 1
        label = f"{stage}#{counter[0]}"
        args, kwargs = _marked(args, label, True), _marked(kwargs, label,
                                                           True)
        with torch.profiler.record_function(f"stage/{stage}"):
            return _marked(fn(*args, **kwargs), label, False)
    return run


@contextlib.contextmanager
def staged(targets):
    """The block with each (module, function name, stage) of ``targets``
    in its stage (restored after)."""
    counter = [0]
    saved = [(m, n, vars(m)[n]) for m, n, _ in targets if n in vars(m)]
    try:
        for m, n, stage in targets:
            if n in vars(m):
                setattr(m, n, _staged(vars(m)[n], stage, counter))
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _ranges(events):
    """[(start, end, stage)]: the program's ``step/`` ranges, the staged
    calls' ranges and each staged call's backward."""
    out, begin, end = [], {}, {}
    for d, _, name, s, e, user in events:
        if d or not user:
            continue
        if name.startswith("stage/bwd"):
            label = name[len("stage/bwd") + 1:]
            side = begin if name[len("stage/bwd")] == "<" else end
            side[label] = max(side.get(label, s), s)
        elif name.startswith("step/"):
            out.append((s, e, name))
        elif name.startswith("stage/"):
            out.append((s, e, name[len("stage/"):]))
    for label, s in begin.items():
        if label in end and end[label] > s:
            out.append((s, end[label], label.split("#")[0]))
    return out


def kernel_stages(events):
    """An eager run's device kernels with the innermost range around each
    one's launch → [(name, stage or None)] by start."""
    ranges = _ranges(events)
    launched = {c: s for d, c, n, s, e, user in events
                if not d and not user and n.startswith("cu")}
    out = []
    for d, c, n, s, e, user in sorted(
            (ev for ev in events if ev[0] and not ev[5]),
            key=lambda ev: ev[3]):
        t = launched.get(c)
        inner = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        out.append((n, min(inner, key=lambda r: r[1] - r[0])[2]
                    if inner else None))
    return out


def aligner(eager_events):
    """stages(events, device events) for ``TraceView``: each CUDA graph
    replay's kernels take the stage of the eager kernel they align with;
    kernels outside a replay take None."""
    eager = kernel_stages(eager_events)

    def stages(events, dev):
        graphs = {c for d, c, n, s, e, user in events
                  if not d and "GraphLaunch" in n}
        reps = {}
        for i, (n, s, e, c) in enumerate(dev):
            if c in graphs:
                reps.setdefault(c, []).append(i)
        out = [None] * len(dev)
        cache = {}
        for members in reps.values():
            names = tuple(dev[i][0] for i in members)
            if names not in cache:
                got = [None] * len(names)
                sm = SequenceMatcher(None, [n for n, _ in eager], list(names),
                                     autojunk=False)
                for a, b, size in sm.get_matching_blocks():
                    for k in range(size):
                        got[b + k] = eager[a + k][1]
                cache[names] = got
            for i, st in zip(members, cache[names]):
                out[i] = st
        return out

    return stages
