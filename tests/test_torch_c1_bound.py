"""C1: the scale-relative bound that phase 13 (d) of chip_smoke.py and
tools/probe_f6.py hold the field forwards (rows 1 and 8) to end to end at
trained states (``chip_smoke.scale_bound``): max |kernel − twin| under
2^-7 of max |twin|, and each side within 3x of the other's distance from
the twin with f64 sums.  The bound passes the readings recorded at the
F6 runs' trained states (an error of 6.6 at outputs of 2600, kernel and
twin equally far from f64 sums) and fires on an error of 2^-6 of the
scale, and on a kernel 4x farther from f64 sums than the twin."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cs():
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _outputs(scale=2600.0, d_twin=3.3, d_kernel=3.3, seed=0):
    """(kernel, twin, exact) for three raw outputs of max |exact| =
    ``scale``: the twin ``d_twin`` from exact at the largest element and
    the kernel ``d_kernel`` the other way there, every other element
    within a tenth of that."""
    rng = np.random.default_rng(seed)
    kernel, twin, exact = [], [], []
    for n in (3, 1, 5):
        e = rng.uniform(-scale, scale, size=(512, n))
        e[7, 0] = scale
        small = rng.uniform(-0.1, 0.1, size=e.shape)
        t = e + small * d_twin
        k = e - small * d_kernel
        t[7, 0] = scale + d_twin
        k[7, 0] = scale - d_kernel
        exact.append(torch.from_numpy(e))
        twin.append(torch.from_numpy(t).float())
        kernel.append(torch.from_numpy(k).float())
    return kernel, twin, exact


def _held(cs, kernel, twin, exact):
    """The row phase 13 (d) writes for these tensors → (stats, ok)."""
    stats, bounds = cs._scale_row(kernel, twin, exact, "raw")
    rows = []
    cs._row(rows, "st_field_fwd", stats, bounds)
    return rows[0], rows[0]["ok"]


def test_bounds_are_the_tests_of_jax_kernel():
    """The constants are those tests/test_torch_probe_f6.py holds JAX's own
    field kernel to against the twin at outputs of ~2000."""
    cs = _cs()
    assert cs.SCALE_REL == 2.0 ** -7 and cs.F64_RATIO == 3.0


def test_bound_passes_recorded_trained_readings():
    """Raw error 6.6 at outputs of 2600, both sides 3.3 from f64 sums."""
    cs = _cs()
    row, ok = _held(cs, *_outputs())
    assert ok
    assert row["e2e_raw_scale_rel"] == pytest.approx(6.6 / 2603.3, rel=1e-4)
    assert row["e2e_raw_f64_ratio"] == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("i", range(3))
def test_bound_fires_on_injected_scale_error(i):
    """2^-6 of the scale added to one element of the twin's output ``i``:
    past SCALE_REL."""
    cs = _cs()
    kernel, twin, exact = _outputs()
    twin[i] = twin[i].clone()
    twin[i][100, 0] += 2.0 ** -6 * float(twin[i].abs().max())
    row, ok = _held(cs, kernel, twin, exact)
    assert not ok
    assert row["e2e_raw_scale_rel"] > cs.SCALE_REL


@pytest.mark.parametrize("kernel_side", [True, False],
                         ids=["kernel_far", "twin_far"])
def test_bound_fires_on_fourfold_f64_distance(kernel_side):
    """One side 4x farther from the f64 sums than the other, the scale
    bound itself met: only the distance ratio fires."""
    cs = _cs()
    d_far, d_near = 4.0, 1.0
    kernel, twin, exact = _outputs(
        d_twin=d_near if kernel_side else d_far,
        d_kernel=d_far if kernel_side else d_near)
    row, ok = _held(cs, kernel, twin, exact)
    assert not ok
    assert row["e2e_raw_scale_rel"] <= cs.SCALE_REL
    assert row["e2e_raw_f64_ratio"] == pytest.approx(4.0, rel=1e-3)


def test_equal_sides_on_the_f64_sums_read_one():
    """Kernel, twin and f64 sums one tensor: both bound statistics at their
    floor (0 and 1)."""
    cs = _cs()
    x = [torch.linspace(-3, 3, 64).reshape(16, 4)]
    got = cs.scale_bound(x, x, [t.double() for t in x])
    assert got == {"scale_rel": 0.0, "f64_ratio": 1.0}
