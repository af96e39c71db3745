"""Device-idle ms a frame while the evaluation loop's own host work runs:
host gaps of the traced sweep (no device op, no graph in flight) while the
profiled thread is inside ``eval/sweep`` but not waiting on a worker (the
pull of results, the frame runner, the loop), ÷ the sweep's frames
(lib/spans.py)."""

from bench_port.lib import spans as S


def read(run):
    return S.idle_ms(run, "eval/sweep", ("eval/sweep",),
                     ("eval/wait", "eval/drain"))
