"""Prefetch-worker ms a frame: the program's ``eval/load`` (``dataset[i]``
and the payload transform) and ``eval/upload`` spans summed over the
traced sweep, ÷ the frames it loaded (lib/spans.py)."""

from bench_port.lib import spans as S


def read(run):
    sp = S.worker_spans(run) or []
    loads = [s for s in sp if s.name == "eval/load"]
    if not loads:
        return None
    return S.worker_ms(sp, "eval/load", "eval/upload") / len(loads)
