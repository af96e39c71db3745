"""Model FLOPs a unit (lib/flops.py ``model_flops``) × the traced window's
units ÷ (its seconds × the bf16 dense peak), in %."""

from bench_port.lib import flops


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * flops.model_flops(run.cfg, run.shapes) * t.units / (
        t.window_s * flops.PEAK_FLOPS)
