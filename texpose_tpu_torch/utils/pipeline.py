"""Host-pipeline overlap for streaming evaluation (port of
texpose_tpu/utils/pipeline.py).

``EvalPrefetcher`` loads dataset[i] on a background thread and uploads
frame i+1..i+depth while frame i renders: the host sample becomes pinned
tensors copied with ``.to(device, non_blocking=True)`` (the JAX version's
``jax.device_put``).  The PNG writer thread is the JAX package's
``AsyncWriter``, which is jax-free and re-exported here.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch
from texpose_tpu.utils.pipeline import AsyncWriter  # noqa: F401


class _Stop:
    pass


def to_device(sample, device, batch=True):
    """{key: array} → {key: tensor on device}; batch adds a leading [1]."""
    cuda = torch.device(device).type == "cuda"
    out = {}
    for k, v in sample.items():
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        if batch:
            t = t[None]
        if cuda:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=cuda)
    return out


class EvalPrefetcher:
    """Iterate (i, device_frame, host_sample) over the dataset with a
    background load+upload thread.

    device_frame is ``to_device(sample)`` — each array with a leading batch
    axis — or, with ``transform``, ``to_device(transform(sample),
    batch=False)``: the transform runs on the worker and owns the payload's
    layout.  Use as a context manager (or drain fully); an early exit sets
    the stop event so the worker never blocks on a full queue.  A worker
    exception is re-raised at the consuming ``next``.
    """

    def __init__(self, dataset, device, depth=2, transform=None):
        self.dataset = dataset
        self.device = device
        self.transform = transform
        self._q = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for i in range(len(self.dataset)):
                if self._stop.is_set():
                    return
                sample = self.dataset[i]
                if self.transform is not None:
                    frame = to_device(self.transform(sample), self.device,
                                      batch=False)
                else:
                    frame = to_device(sample, self.device)
                self._put((i, frame, sample))
            self._put(_Stop())
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            self._put(e)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        # the worker enqueues exactly one terminal item (_Stop or the
        # first exception); the latch keeps a later next() from blocking
        if self._done:
            raise StopIteration
        item = self._q.get()
        if isinstance(item, _Stop):
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
