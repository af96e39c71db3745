"""Writes ``colormaps.npz`` beside this file: the 256-entry RGB tables of
matplotlib's ``plasma``, ``turbo`` and ``viridis`` (float64, [256, 3]
each), which ``utils/vis.py`` indexes on machines without matplotlib.

    python -m texpose_tpu_torch.utils.make_colormaps

Needs matplotlib (the tables were written with 3.10.8).  Each table is the
colormap called on its integer indices 0..255, which returns its lookup
table's rows unscaled.  The generator also checks what ``vis.py`` assumes
of these maps: "bad" (NaN) is black, under and over are the end colors.
"""

from __future__ import annotations

import os

import numpy as np

NAMES = ("plasma", "turbo", "viridis")
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "colormaps.npz")


def tables():
    """{name: [256, 3] float64} from matplotlib."""
    import matplotlib
    out = {}
    for name in NAMES:
        cmap = matplotlib.colormaps[name]
        if cmap.N != 256:
            raise ValueError(f"{name}: {cmap.N} entries, expected 256")
        lut = cmap(np.arange(cmap.N))
        if (tuple(cmap.get_bad()[:3]) != (0.0, 0.0, 0.0)
                or not np.array_equal(cmap.get_under(), lut[0])
                or not np.array_equal(cmap.get_over(), lut[-1])):
            raise ValueError(f"{name}: bad/under/over colors are not "
                             "black and the end colors")
        out[name] = np.ascontiguousarray(lut[:, :3], np.float64)
    return out


def main():
    np.savez(PATH, **tables())
    print(PATH)


if __name__ == "__main__":
    main()
