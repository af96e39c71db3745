"""Colored console logging.

Capability parity with the reference's util.Log (the reference TexPose
code, util.py:93-140), re-built without global state; the iteration rate
is utils/metrics.py ``StepTimer``.
"""

from __future__ import annotations

import sys


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
