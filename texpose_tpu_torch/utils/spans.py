"""The port's spans: host time of the program's own stages, on every
thread, while a ``torch.profiler`` session runs.

``span(name)`` is a context manager.  With no profiler running in the
process (the profiler's own process-wide flag, which worker threads see
too) it returns one shared no-op context and reads no clock.  On a thread
the profiler records (the one that started it, and autograd's) a span is
a ``torch.profiler.record_function(name)`` range: the profiler stamps it
on its own clock, beside the device's kernels.  The profiler records no
range of a thread it did not start on, so there (the evaluation's
prefetch worker and PNG writer) a span is kept here instead: its name,
its thread, and its start and end on ``time.time_ns()``.

Kept spans stay in memory, at most ``CAPACITY`` of them, until ``take()``
hands them over with the number the full buffer refused; nothing is
written during a run.  ``add_to_chrome_trace`` puts them into a profiler's
chrome trace (``train --profile``), a track a thread.

Names: ``eval/...`` (the evaluation loop, its prefetch worker and its
writer), ``frame/...`` (models/frame_graph.py), ``dispatch``
(models/step_graph.py) and the engines' ``step/...`` stages of an eager
training step.  No other name starts with ``step/``, and none with
``stage/`` or ``bench/``: the benchmark's trace reader
(bench_port/lib/trace.py) gives those prefixes to its own stages.
"""

from __future__ import annotations

import json
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

CAPACITY = 1 << 16

_lock = threading.Lock()
_kept = []
_dropped = 0


class Span(NamedTuple):
    name: str
    thread: str
    start_ns: int
    end_ns: int


class _Off:
    """The shared context of a span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def recording():
    """Whether a ``torch.profiler`` session runs in this process."""
    return getattr(_profiler, "_is_profiler_enabled", False)


def span(name):
    if not recording():
        return _OFF
    if torch.autograd._profiler_enabled():     # this thread is profiled
        return record_function(name)
    return _Kept(name)


class _Kept:
    __slots__ = ("name", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        s = Span(self.name, threading.current_thread().name, self.t0,
                 time.time_ns())
        global _dropped
        with _lock:
            if len(_kept) < CAPACITY:
                _kept.append(s)
            else:
                _dropped += 1
        return False


def take():
    """The kept spans, by end, and the number the full buffer refused,
    since the last call."""
    global _dropped
    with _lock:
        out, dropped = _kept[:], _dropped
        _kept.clear()
        _dropped = 0
    return out, dropped


def add_to_chrome_trace(path, spans):
    """Append ``spans`` to the chrome trace JSON at ``path`` (as the
    profiler's ``export_chrome_trace`` wrote it), in its time base, as
    complete events on one track (tid) a thread, named for the thread."""
    with open(path) as f:
        trace = json.load(f)
    base_ns = int(trace.get("baseTimeNanoseconds", 0))
    pid = "program spans"
    tids = {}
    for s in spans:
        tid = tids.setdefault(s.thread, len(tids) + 1)
        trace["traceEvents"].append(
            {"ph": "X", "cat": "span", "name": s.name, "pid": pid,
             "tid": tid, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3})
    trace["traceEvents"] += [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
         "args": {"name": name}} for name, tid in tids.items()]
    with open(path, "w") as f:
        json.dump(trace, f)
