"""The port's spans (texpose_tpu_torch/utils/spans.py) on the CPU, under a
CPU-only ``torch.profiler``:

  * with no profiler running, ``span`` hands back one shared no-op
    context, keeps nothing and reads no clock;
  * with one running, a span of the profiled thread is the profiler's own
    range and nothing else, and a worker thread's span is kept with its
    thread and stamps; the buffer keeps at most its capacity and counts
    what it refuses; threads lose no span;
  * each engine's ``evaluate_full`` gives one ``eval/load``,
    ``eval/upload``, ``eval/pull`` and ``frame/run`` a frame;
    ``StepRunner.dispatch(k)`` is one ``dispatch`` range around its k
    steps;
  * the engines' ``step/...`` stage names are unchanged, and no other span
    name takes the ``step/``, ``stage/`` or ``bench/`` prefix;
  * ``train --profile``'s chrome trace holds the worker threads' spans
    inside the trace's time range, and the profiled thread's once."""

import json
import os
import re
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(__file__))

from texpose_tpu.data.fixture import generate_fixture
from texpose_tpu_torch.utils import spans
from texpose_tpu_torch.utils.pipeline import AsyncWriter, EvalPrefetcher

PORT = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "texpose_tpu_torch")
GAN_STAGES = ["step/batch", "step/gen_forward", "step/gen_backward",
              "step/gen_update", "step/disc_forward", "step/disc_backward",
              "step/disc_update"]
PRETRAIN_STAGES = ["step/forward", "step/backward", "step/update"]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def host_ranges(prof):
    """The profile's record_function ranges → [(name, start, end)] by
    start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()), key=lambda r: r[1])


def names(prof, name):
    return [r for r in host_ranges(prof) if r[0] == name]


def inside(inner, outer):
    return outer[1] <= inner[1] <= inner[2] <= outer[2]


class _Frames:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2, 3), i, np.float32)}


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.take()
    yield
    spans.take()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return generate_fixture(str(tmp_path_factory.mktemp("bop")), n_train=4,
                            n_test=2, scene="scene_all", image_scale=0.25,
                            crop_res=32)


def test_off_is_one_shared_noop_reading_no_clock(monkeypatch):
    calls = []
    real = time.time_ns
    monkeypatch.setattr(time, "time_ns", lambda: calls.append(1) or real())
    assert not spans.recording()
    a, b = spans.span("eval/load"), spans.span("dispatch")
    assert a is b
    with a as got:
        assert got is None
    assert spans.take() == ([], 0) and calls == []


def test_main_thread_spans_are_ranges_worker_spans_are_kept():
    def work():
        with spans.span("eval/load"):
            with spans.span("eval/upload"):
                pass

    with cpu_profile() as prof:
        with spans.span("eval/sweep"):
            t = threading.Thread(target=work, name="worker")
            t.start()
            t.join(timeout=10)
            with spans.span("eval/pull"):
                pass
    assert not t.is_alive()
    kept, dropped = spans.take()
    assert dropped == 0
    assert [(s.name, s.thread) for s in kept] == [("eval/upload", "worker"),
                                                  ("eval/load", "worker")]
    upload, load = kept
    assert load.start_ns <= upload.start_ns <= upload.end_ns <= load.end_ns
    (sweep,), (pull,) = names(prof, "eval/sweep"), names(prof, "eval/pull")
    assert inside(pull, sweep)
    assert not names(prof, "eval/load")


def test_the_buffer_keeps_its_capacity_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(spans, "CAPACITY", 3)

    def work():
        for i in range(5):
            with spans.span(f"eval/png{i}"):
                pass

    with cpu_profile():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
    kept, dropped = spans.take()
    assert [s.name for s in kept] == ["eval/png0", "eval/png1", "eval/png2"]
    assert dropped == 2
    assert spans.take() == ([], 0)


def test_threads_lose_no_span():
    n_threads, n = 12, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with spans.span("eval/png"):
                    pass

        with cpu_profile():
            threads = [threading.Thread(target=work, name=f"w{k}")
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    kept, dropped = spans.take()
    assert dropped == 0
    by = {}
    for s in kept:
        by[s.thread] = by.get(s.thread, 0) + 1
    assert by == {f"w{k}": n for k in range(n_threads)}


def test_a_profiled_threads_span_is_its_own_range():
    with cpu_profile() as prof:
        for k in range(8):
            with spans.span(f"probe/{k}"):
                torch.ones(64).mul_(2)
    assert spans.take() == ([], 0)
    ops = [r for r in ((e.name(), e.start_ns(), e.end_ns()) for e in
                       prof.profiler.kineto_results.events())
           if r[0] == "aten::mul_"]
    for k in range(8):
        (got,) = names(prof, f"probe/{k}")
        assert inside(ops[k], got)


def _engine(kind, root, tmp_path):
    if kind == "gan":
        from test_torch_scan_steps import _gan_engine
        return _gan_engine(root, tmp_path, 300)
    from test_torch_pretrain_step import step_cfg
    from test_torch_scan_steps import port_pretrain
    return port_pretrain(step_cfg(root, tmp_path))


@pytest.mark.parametrize("kind", ["gan", "pretrain"])
def test_evaluate_full_spans_a_frame(kind, root, tmp_path):
    eng = _engine(kind, root, tmp_path)
    eng.evaluate_full()                     # builds the frame programs
    frames = len(eng.eval_data)
    with cpu_profile() as prof:
        eng.evaluate_full()
    kept, _ = spans.take()
    for name in ("eval/load", "eval/upload"):
        got = [s for s in kept if s.name == name]
        assert len(got) == frames, name
        assert {s.thread for s in got} == {"eval-prefetch"}
    assert {s.thread for s in kept if s.name == "eval/png"} == \
        {"eval-writer"}
    (sweep,) = names(prof, "eval/sweep")
    for name in ("eval/pull", "frame/run"):
        got = names(prof, name)
        assert len(got) == frames, name
        assert all(inside(r, sweep) for r in got)
    for name in ("eval/wait", "eval/drain", "eval/quant"):
        assert names(prof, name), name


def test_a_dispatch_is_one_range_around_its_steps(root, tmp_path):
    eng = _engine("pretrain", root, tmp_path)
    runner = eng.step_runner()
    with cpu_profile() as prof:
        runner.dispatch(3)
    (disp,) = names(prof, "dispatch")
    steps = names(prof, "step/forward")
    assert len(steps) == 3 and all(inside(r, disp) for r in steps)


@pytest.mark.parametrize("kind,stages", [("gan", GAN_STAGES),
                                         ("pretrain", PRETRAIN_STAGES)])
def test_step_stage_names_are_unchanged(kind, stages, root, tmp_path):
    eng = _engine(kind, root, tmp_path)
    with cpu_profile() as prof:
        eng.train_step(eng.make_draws(eng.it))
    got = [n for n, _, _ in host_ranges(prof) if n.startswith("step/")]
    assert got == stages
    assert spans.take() == ([], 0)


def test_no_other_span_takes_a_reserved_prefix():
    found = set()
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    found |= set(re.findall(r'\bspan\(\s*"([^"]+)"',
                                            fh.read()))
    assert {"eval/sweep", "eval/load", "frame/run", "dispatch"} <= found
    step = {n for n in found if n.startswith("step/")}
    assert step == set(GAN_STAGES) | set(PRETRAIN_STAGES)
    assert not [n for n in found if n.startswith(("stage/", "bench/"))]


def test_profile_export_holds_the_worker_spans(tmp_path):
    from texpose_tpu_torch.models.base import Engine
    stub = types.SimpleNamespace(
        device=torch.device("cpu"),
        cfg=types.SimpleNamespace(output_path=str(tmp_path)))
    prof = Engine._start_profiler(stub)
    with spans.span("eval/sweep"), AsyncWriter() as writer:
        with EvalPrefetcher(_Frames(3), "cpu") as pf:
            for i, frame, _ in pf:
                torch.ones(8).add_(frame["image"].sum())
                writer.submit(time.sleep, 0.002)
    fname = Engine._stop_profiler(stub, prof)
    with open(fname) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "span"]
    theirs = [e for e in events if e.get("ph") == "X"
              and e.get("cat") != "span"]
    tracks = {e["tid"]: e["args"]["name"] for e in events
              if e.get("pid") == "program spans" and e.get("ph") == "M"}
    by_thread = {}
    for e in ours:
        by_thread.setdefault(tracks[e["tid"]], []).append(e["name"])
    assert sorted(by_thread["eval-prefetch"]) == ["eval/load"] * 3 + \
        ["eval/upload"] * 3
    assert by_thread["eval-writer"] == ["eval/png"] * 3
    assert set(by_thread) == {"eval-prefetch", "eval-writer"}
    assert [e["name"] for e in theirs].count("eval/sweep") == 1
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e["dur"] for e in theirs)
    for e in ours:
        assert lo - 1e3 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e3, e
