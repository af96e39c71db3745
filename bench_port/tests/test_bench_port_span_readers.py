"""The readers of the program's spans (lib/spans.py and the metrics
``load_ms.eval``, ``png_ms.eval``, ``idle_data_ms.eval``,
``idle_host_ms.eval``, ``idle_host_ms.train``) on a synthetic 10 ms window:
two graph launches (kernels 1-2 and 2.5-3 ms, 6-8 ms), a copy at 9-9.5 ms,
the profiled thread's ranges of one sweep of two frames (or of one
dispatch of two steps), and the prefetch worker's and the writer's
spans."""

import sys

import pytest

from bench_port.lib import harness, spans as S, trace
from texpose_tpu_torch.utils.spans import Span

MS = 1_000_000
FIELD = "void (anonymous namespace)::field_fwd_kernel<1>(Params)"


def device_events():
    return [(False, 0, trace.WINDOW, 0, 10 * MS, True),
            (False, 101, "cudaGraphLaunch", MS // 2, MS // 2 + 100, False),
            (True, 101, FIELD, 1 * MS, 2 * MS, False),
            (True, 101, FIELD, 2 * MS + MS // 2, 3 * MS, False),
            (False, 102, "cudaGraphLaunch", 5 * MS, 5 * MS + 100, False),
            (True, 102, FIELD, 6 * MS, 7 * MS, False),
            (True, 102, FIELD, 7 * MS, 8 * MS, False),
            (False, 300, "cudaMemcpyAsync", 9 * MS, 9 * MS + 10, False),
            (True, 300, "Memcpy DtoH", 9 * MS, 9 * MS + MS // 2, False)]


def rng(name, a, b):
    return (False, 0, name, int(a * MS), int(b * MS), True)


def sweep_ranges():
    return [rng("frame/run", -2, -1),              # before the window
            rng("eval/sweep", 0.5, 9.8),
            rng("eval/wait", 0.5, 1.0),
            rng("eval/wait", 1.8, 2.7),            # inside graph 101
            rng("eval/pull", 3.0, 4.0),
            rng("eval/wait", 4.0, 5.0),
            rng("eval/drain", 8.5, 9.2),
            (True, 0, "eval/sweep", 0, 10 * MS, True)]   # the device's copy


def dispatch_ranges():
    return [rng("dispatch", 0.5, 9.0)]


def worker(name, a, b, thread):
    return Span(name, thread, int(a * MS), int(b * MS))


def worker_spans():
    return [worker("eval/load", 0.2, 0.8, "eval-prefetch"),
            worker("eval/upload", 0.8, 0.9, "eval-prefetch"),
            worker("eval/load", 1.0, 2.0, "eval-prefetch"),
            worker("eval/upload", 2.0, 2.2, "eval-prefetch"),
            worker("eval/png", 4.2, 4.6, "eval-writer"),
            worker("eval/png", 4.6, 5.0, "eval-writer"),
            worker("eval/png", 8.6, 9.0, "eval-writer"),
            worker("eval/png", 9.0, 9.2, "eval-writer")]


def run_of(ranges, program_spans=(), units=2):
    view = trace.TraceView(device_events() + ranges, units)
    view.program_spans = list(program_spans)
    return harness.Run(trace=view)


def read(name, run):
    return harness.reader(name).read(run)


def test_gaps_leave_out_each_graph_launchs_extent():
    view = run_of([]).trace
    gaps, in_graph = S.host_gaps(view)
    assert gaps == [(0, 1 * MS), (3 * MS, 6 * MS), (8 * MS, 9 * MS),
                    (9 * MS + MS // 2, 10 * MS)]
    assert in_graph == MS // 2
    assert S.graph_extents(view) == [(1 * MS, 3 * MS), (6 * MS, 8 * MS)]


def test_only_the_windows_host_ranges_are_read():
    got = S.ranges(run_of(sweep_ranges()).trace)
    assert [n for _, _, n in got] == ["eval/sweep", "eval/wait",
                                      "eval/wait", "eval/pull",
                                      "eval/wait", "eval/drain"]


def test_innermost_nests_ranges_and_ends_before_it_opens():
    line = S.innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"),
                        (5, 6, "d")])
    assert line == [(0, 2, ("a",)), (2, 4, ("b", "a")), (4, 5, ("c", "a")),
                    (5, 6, ("d", "c", "a")), (6, 10, ("a",))]


def test_idle_goes_to_wait_host_and_no_range():
    run = run_of(sweep_ranges())
    by, in_graph = S.idle_split(run.trace, "eval/sweep")
    ms = {k: v / MS for k, v in by.items()}
    assert ms == pytest.approx({
        (): 0.7,                                   # 0-0.5, 9.8-10
        ("eval/wait", "eval/sweep"): 1.5,          # 0.5-1, 4-5
        ("eval/drain", "eval/sweep"): 0.5,         # 8.5-9
        ("eval/pull", "eval/sweep"): 1.0,          # 3-4
        ("eval/sweep",): 1.8})                     # 5-6, 8-8.5, 9.5-9.8
    # the wait inside graph 101's extent (2-2.5 ms idle) counts nowhere
    assert in_graph == MS // 2
    view = run.trace
    idle = (view.t1 - view.t0 - view.busy_ns) / MS
    assert sum(ms.values()) + in_graph / MS == pytest.approx(idle)
    assert read("idle_data_ms.eval", run) == pytest.approx(2.0 / 2)
    assert read("idle_host_ms.eval", run) == pytest.approx(2.8 / 2)


def test_idle_is_a_unit_of_the_traced_stretch():
    assert read("idle_data_ms.eval", run_of(sweep_ranges(), units=4)) == \
        pytest.approx(2.0 / 4)


def test_worker_readers():
    run = run_of(sweep_ranges(), worker_spans())
    assert read("load_ms.eval", run) == pytest.approx((0.7 + 1.2) / 2)
    assert read("png_ms.eval", run) == pytest.approx(1.4 / 2)


def test_dispatch_idle_a_step():
    run = run_of(dispatch_ranges())
    # gaps 0.5-1, 3-6, 8-9 inside the dispatch; 0-0.5 and 9.5-10 outside
    assert read("idle_host_ms.train", run) == pytest.approx(4.5 / 2)
    assert read("idle_data_ms.eval", run) is None


NEW = ("load_ms.eval", "png_ms.eval", "idle_data_ms.eval",
       "idle_host_ms.eval", "idle_host_ms.train")


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_is_none(name, monkeypatch):
    assert read(name, harness.Run(trace=None)) is None
    assert read(name, run_of([])) is None
    # a program without spans (the module cannot be imported)
    monkeypatch.setitem(sys.modules, "texpose_tpu_torch.utils.spans", None)
    run = run_of([])
    run.trace.program_spans = None
    assert read(name, run) is None


def test_the_workers_spans_are_taken_once_a_run():
    import threading

    import torch
    from texpose_tpu_torch.utils import spans as program
    program.take()

    def work():
        with program.span("eval/png"):
            pass

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        t = threading.Thread(target=work, name="eval-writer")
        t.start()
        t.join(timeout=10)
    run = run_of([])
    run.trace.program_spans = None
    first = S.worker_spans(run)
    assert [s.name for s in first] == ["eval/png"]
    assert S.worker_spans(run) == first and program.take() == ([], 0)
