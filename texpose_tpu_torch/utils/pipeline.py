"""Host-pipeline overlap for streaming evaluation (port of
texpose_tpu/utils/pipeline.py).

``EvalPrefetcher`` loads dataset[i] on a background thread and uploads
frame i+1..i+depth while frame i renders: the host sample becomes pinned
tensors copied with ``.to(device, non_blocking=True)`` (the JAX version's
``jax.device_put``).  ``AsyncWriter`` runs the per-frame PNG encodes on a
writer thread, off the critical path; both re-raise a worker's exception
at the consuming call.  The worker's ``eval/load`` (``dataset[i]`` and
the transform) and ``eval/upload``, the consumer's ``eval/wait`` and the
writer's ``eval/png`` and ``eval/drain`` are spans (utils/spans.py).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .spans import span


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
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="eval-prefetch")
        self._thread.start()

    def _work(self):
        try:
            for i in range(len(self.dataset)):
                if self._stop.is_set():
                    return
                with span("eval/load"):
                    sample = self.dataset[i]
                    host = sample if self.transform is None \
                        else self.transform(sample)
                with span("eval/upload"):
                    frame = to_device(host, self.device,
                                      batch=self.transform is None)
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
        with span("eval/wait"):
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


class AsyncWriter:
    """Run (fn, *args) jobs on a writer thread; close() drains and
    re-raises the first failure."""

    def __init__(self, depth=8):
        self._q = queue.Queue(maxsize=max(int(depth), 1))
        self._err = None
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="eval-writer")
        self._thread.start()

    def _work(self):
        while True:
            item = self._q.get()
            if isinstance(item, _Stop):
                return
            fn, args = item
            try:
                with span("eval/png"):
                    fn(*args)
            except BaseException as e:  # noqa: BLE001
                if self._err is None:
                    self._err = e

    def submit(self, fn, *args):
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        self._q.put((fn, args))

    def close(self):
        with span("eval/drain"):
            self._q.put(_Stop())
            self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            # a silent return here would report success while queued
            # writes are killed with the daemon thread at process exit
            raise RuntimeError(
                "AsyncWriter: writer thread still running after 60 s "
                "drain timeout — queued writes may be incomplete")
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:  # don't mask the primary exception; best-effort drain
            self._q.put(_Stop())
            self._thread.join(timeout=10.0)
        return False
