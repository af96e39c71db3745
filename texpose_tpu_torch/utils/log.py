"""Colored console logging + EMA iteration timer.

Capability parity with the reference's util.Log / update_timer
(the reference TexPose code, util.py:93-140), re-built without global state.
"""

from __future__ import annotations

import sys
import time


class _Color:
    @staticmethod
    def _c(msg, code, bold=False):
        b = "1;" if bold else ""
        return f"\033[{b}{code}m{msg}\033[0m"

    red = staticmethod(lambda m, bold=False: _Color._c(m, 31, bold))
    green = staticmethod(lambda m, bold=False: _Color._c(m, 32, bold))
    yellow = staticmethod(lambda m, bold=False: _Color._c(m, 33, bold))
    blue = staticmethod(lambda m, bold=False: _Color._c(m, 34, bold))
    magenta = staticmethod(lambda m, bold=False: _Color._c(m, 35, bold))
    cyan = staticmethod(lambda m, bold=False: _Color._c(m, 36, bold))


color = _Color


class Log:
    def __init__(self, stream=None):
        self.stream = stream or sys.stdout

    def _emit(self, msg):
        print(msg, file=self.stream, flush=True)

    def title(self, msg):
        self._emit(color.yellow(msg, bold=True))

    def info(self, msg):
        self._emit(color.green(msg))

    def warn(self, msg):
        self._emit(color.red(f"WARNING: {msg}"))

    def error(self, msg):
        self._emit(color.red(f"ERROR: {msg}", bold=True))

    def loss_train(self, it, loss, lr=None, timer=None):
        parts = [f"it {it}", f"loss {float(loss):.4f}"]
        if lr is not None:
            parts.append(f"lr {float(lr):.2e}")
        if timer is not None and timer.it_mean is not None:
            parts.append(f"{timer.it_mean * 1e3:.1f} ms/it")
        self._emit(color.cyan(" | ".join(parts)))

    def loss_val(self, loss):
        self._emit(color.magenta(f"val loss {float(loss):.4f}"))


log = Log()


class Timer:
    """Wall-clock timer with EMA per-iteration time and ETA estimation."""

    def __init__(self, ema=0.99):
        self.start = time.time()
        self.it_start = None
        self.it_mean = None
        self._ema = ema

    def tic(self):
        self.it_start = time.time()

    def toc(self):
        it_time = time.time() - self.it_start
        self.it_mean = (it_time if self.it_mean is None
                        else self._ema * self.it_mean + (1 - self._ema) * it_time)
        return it_time

    def eta(self, it, max_it):
        if self.it_mean is None:
            return float("inf")
        return self.it_mean * max(max_it - it, 0)

    def elapsed(self):
        return time.time() - self.start
