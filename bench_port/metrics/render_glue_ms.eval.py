"""A frame's device-busy ms less the device ms of its field and composite
kernels (the wgmma field forward with the composite in its epilogue, and
any composite kernel): the chunk loop's rays, samples and encodings, the
metrics and the PNG payload."""

import re

PATTERN = re.compile(r"\b(field_fwd_kernel|composite_\w*kernel)\b")


def read(run):
    t = run.trace
    if t is None or t.units <= 0:
        return None
    field = t.device_ms(lambda n: PATTERN.search(n) is not None)
    return t.busy_ns / 1e6 / t.units - field
