"""The program's own spans (``texpose_tpu_torch/utils/spans.py``) in a
traced run, joined with the run's device trace (lib/trace.py).

A span of the profiled thread is a ``record_function`` range, so it is in
the trace itself, on the clock of the device's kernels: ``ranges(view)``
reads those inside the window.  The worker threads' spans (the prefetch
worker's ``eval/load`` and ``eval/upload``, the writer's ``eval/png``)
are kept by the program while the profiler runs; ``worker_spans(run)``
takes them once a run.  They give durations only, and are never placed on
the trace's clock.  A program without spans has none of either, and every
reading of this module is then None.

The device's idle time in the window splits in two.  Inside the device
extent of a graph launch (first kernel start to last kernel end of the
kernels sharing one ``cudaGraphLaunch`` correlation id) it is the graph's
own (``in_graph``).  The rest are the host gaps: stretches with no device
op and no graph in flight, each instant of which goes to the innermost
range open at that instant with the names of the ranges around it, or to
no range.
"""

from __future__ import annotations

import importlib

from .trace import WINDOW, merged, union_ns


def worker_spans(run):
    """The program's worker-thread spans of the run's traced stretch, or
    None (no trace, or none kept).  The program is read once a run: its
    spans stay on the view (``program_spans``)."""
    view = getattr(run, "trace", None)
    if view is None:
        return None
    if getattr(view, "program_spans", None) is None:
        try:
            mod = importlib.import_module("texpose_tpu_torch.utils.spans")
        except ModuleNotFoundError:
            view.program_spans = []
        else:
            view.program_spans = mod.take()[0]
    return view.program_spans or None


def worker_ms(spans, *names):
    """Summed ms of the worker spans called one of ``names``."""
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name in names) / 1e6


def ranges(view):
    """The profiled thread's host ranges inside the window (its own range
    left out) → [(start, end, name)]."""
    return [(s, e, n) for dev, _, n, s, e, user in view.events
            if user and not dev and n != WINDOW and view.t0 <= s < e
            and e <= view.t1]


def graph_extents(view):
    """[start, end] of each graph launch's kernels in the window."""
    graphs = {c for dev, c, n, s, e, user in view.events
              if not dev and "GraphLaunch" in n}
    ext = {}
    for dev, c, n, s, e, user in view.events:
        if dev and not user and c in graphs and s >= view.t0 \
                and e <= view.t1:
            lo, hi = ext.get(c, (s, e))
            ext[c] = (min(lo, s), max(hi, e))
    return list(ext.values())


def host_gaps(view):
    """The window's stretches with no device op and no graph launch in
    flight → [(start, end)], and the graphs' own idle ns."""
    busy = [(s, e) for _, s, e, _ in view.kernels]
    covered = merged(busy + graph_extents(view))
    in_graph = union_ns(covered) - union_ns(busy)
    gaps, t = [], view.t0
    for s, e in covered + [[view.t1, view.t1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    return gaps, in_graph


def innermost(rngs):
    """Nested ranges as a timeline [(start, end, names)], names the
    innermost open range's and its enclosing ranges' (innermost first),
    () where none is open."""
    edges = sorted([(s, 1, i) for i, (s, e, n) in enumerate(rngs)]
                   + [(e, 0, i) for i, (s, e, n) in enumerate(rngs)])
    out, stack, prev = [], [], None
    for t, opens, i in edges:
        if prev is not None and t > prev:
            out.append((prev, t, tuple(rngs[j][2] for j in reversed(stack))))
        prev = t
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    return out


def idle_split(view, root):
    """The window's device idle ns by the ranges open on the profiled
    thread → ({names: ns} of the host gaps, names () outside every range;
    the graphs' own idle ns), or None without a ``root`` range."""
    rngs = ranges(view)
    if not any(n == root for _, _, n in rngs):
        return None
    gaps, in_graph = host_gaps(view)
    timeline = innermost(rngs)
    by, j, outside = {}, 0, 0
    for a, b in gaps:
        outside += b - a
        while j < len(timeline) and timeline[j][1] <= a:
            j += 1
        k = j
        while k < len(timeline) and timeline[k][0] < b:
            s, e, names = timeline[k]
            part = min(b, e) - max(a, s)
            by[names] = by.get(names, 0) + part
            outside -= part
            k += 1
    by[()] = by.get((), 0) + outside
    return by, in_graph


def idle_ms(run, root, inside, outside=()):
    """Host-gap ms a unit of the traced stretch while the profiled thread
    was inside a range called one of ``inside`` and in none of
    ``outside``, or None."""
    view = getattr(run, "trace", None)
    split = idle_split(view, root) if view is not None else None
    if split is None or view.units <= 0:
        return None
    ns = sum(v for names, v in split[0].items()
             if set(names) & set(inside) and not set(names) & set(outside))
    return ns / 1e6 / view.units
