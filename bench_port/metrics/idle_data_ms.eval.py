"""Device-idle ms a frame while the evaluation loop waits on its workers:
host gaps of the traced sweep (no device op, no graph in flight) while the
profiled thread is in ``eval/wait`` (the prefetch queue) or ``eval/drain``
(the PNG writer's), ÷ the sweep's frames (lib/spans.py)."""

from bench_port.lib import spans as S


def read(run):
    return S.idle_ms(run, "eval/sweep", ("eval/wait", "eval/drain"))
