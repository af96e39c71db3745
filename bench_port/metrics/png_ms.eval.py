"""Writer-thread ms a frame: the program's ``eval/png`` spans (one a PNG
encode and write) summed over the traced sweep, ÷ the sweep's frames
(lib/spans.py)."""

from bench_port.lib import spans as S


def read(run):
    sp = S.worker_spans(run) or []
    if not any(s.name == "eval/png" for s in sp) or run.trace.units <= 0:
        return None
    return S.worker_ms(sp, "eval/png") / run.trace.units
