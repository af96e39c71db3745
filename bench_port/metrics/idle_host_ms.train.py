"""Device-idle ms a step while the step runner dispatches: host gaps of
the traced dispatch (no device op, no graph in flight) while the profiled
thread is inside ``dispatch``, ÷ the dispatch's steps (lib/spans.py)."""

from bench_port.lib import spans as S


def read(run):
    return S.idle_ms(run, "dispatch", ("dispatch",))
