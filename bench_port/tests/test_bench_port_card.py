"""On the card only (marker ``cuda``; skipped without one): a run of a
cell through the command prints a correct result line, and the control
at the cell's own size fails its limits.

    python -m pytest bench_port/tests/test_bench_port_card.py -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

from bench_port.lib import harness


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_run_prints_a_correct_result():
    need_card()
    out = subprocess.run(
        [sys.executable, os.path.join("bench_port", "run.py"), "--workload",
         "pretrain.train", "--seed", "2147483659", "--seconds", "2",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"train_rays_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size():
    from bench_port import control
    device = need_card()
    spec = harness.cell_spec("gan.train")
    r = control.readings(spec, 3000000019, device, True, log=lambda *a: None)
    limits = spec["workload"]["limits"]
    assert all(v <= limits[n] for n, v in r["sound"].items()), r
    assert any(v > limits[n] for n, v in r["control"].items()), r
