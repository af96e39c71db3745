"""The port tests' audit of what a CUDA graph cannot replay: a
``TorchFunctionMode`` that records every torch call building a tensor
from host data or without a device, indexing with a host list or a
boolean mask, reading a tensor to the host, or whose result's size or
validity the host must read (on the card a synchronisation; on the CPU
the same calls, so the CPU shows them).  Used on the captured training
step (tests/test_torch_scan_steps.py) and the captured evaluation frames
(tests/test_torch_frame_graph.py)."""

import traceback

import torch
from torch.overrides import TorchFunctionMode

SYNCING = {"nonzero", "argwhere", "masked_select", "unique",
           "unique_consecutive", "repeat_interleave", "inv", "solve",
           "cholesky", "eigh", "svd", "lstsq", "lu_factor", "det",
           "inverse", "bincount", "histc", "multinomial"}
FACTORIES = {torch.zeros, torch.ones, torch.full, torch.empty,
             torch.arange, torch.linspace, torch.rand, torch.randn,
             torch.randint, torch.randperm, torch.eye}
READS = {"item", "tolist", "numpy", "__bool__", "__float__", "__int__",
         "cpu"}


def _host_index(idx):
    """Whether an index builds a host tensor (a list) or reads one back
    (a boolean mask: its count decides the result's shape)."""
    parts = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(x, list)
               or (isinstance(x, torch.Tensor) and x.dtype == torch.bool)
               for x in parts)


class Audit(TorchFunctionMode):
    """Within ``with``: ``hits`` lists each host interaction as "name at
    file:line"."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        name = name[len("linalg_"):] if name.startswith("linalg_") else name
        host = ((func in (torch.tensor, torch.from_numpy,
                          torch.scalar_tensor))
                or (func is torch.as_tensor
                    and not isinstance(args[0], torch.Tensor))
                or (func in FACTORIES and "device" not in kwargs)
                or name in READS or name in SYNCING
                or (func is torch.where and len(args) == 1)
                or (name in ("__getitem__", "__setitem__")
                    and _host_index(args[1])))
        if host:
            where = traceback.extract_stack()[-2]
            self.hits.append(f"{name} at {where.filename}:{where.lineno}")
        return func(*args, **kwargs)


def host_reads(fn):
    """The host interactions of ``fn()``."""
    audit = Audit()
    with audit:
        fn()
    return audit.hits
