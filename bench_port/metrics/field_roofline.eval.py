"""The field rows' least time (lib/flops.py ``field_work`` at the bf16
and HBM peaks) ÷ the device time of the kernels that do that work, in %.
The kernels, by symbol: the wgmma field forward (rows 1, 8), the field
backwards' dX chains (rows 2, 7b) and the grouped dW GEMM with its
reduction."""

import re

from bench_port.lib import flops

SYMBOLS = ("field_fwd_kernel", "st_field_bwd_kernel", "coarse_bwd_kernel",
           "dw_gemm_kernel", "dw_reduce_kernel")
PATTERN = re.compile(r"\b(" + "|".join(SYMBOLS) + r")\b")


def read(run):
    t = run.trace
    if t is None:
        return None
    ms = t.device_ms(lambda n: PATTERN.search(n) is not None)
    if ms <= 0:
        return None
    least = flops.least_seconds(*flops.field_work(run.cfg, run.shapes))
    return 100.0 * least * 1e3 / ms
