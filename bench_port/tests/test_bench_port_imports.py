"""What the benchmark loads: neither the harness nor the program it drives
loads jax, jaxlib, flax or the JAX package (top-level names compared
whole: the port's own name begins with the JAX package's), and the
reference that decides ``correct`` loads nothing of the program."""

import json
import os
import subprocess
import sys

from bench_port.lib import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "texpose_tpu"}


def top_level_after(code):
    """The top-level module names loaded by a fresh interpreter that ran
    ``code`` at the repo root."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, env=env,
        check=True, timeout=300)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    readers = [m["name"] for m in
               harness.load_json(os.path.join(harness.ROOT,
                                              "BENCHMARK.json"))
               ["end_to_end"]]
    code = ("import bench_port.lib.harness as h, bench_port.entries.train, "
            "bench_port.entries.eval, bench_port.control\n"
            "import texpose_tpu_torch.models.texture_gan, "
            "texpose_tpu_torch.models.pretrain, "
            "texpose_tpu_torch.models.step_graph, "
            "texpose_tpu_torch.models.frame_graph\n"
            f"for n in {readers!r}: h.reader(n)\n")
    top = top_level_after(code)
    assert "texpose_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    top = top_level_after("import bench_port.reference.gan, "
                          "bench_port.reference.pretrain, "
                          "bench_port.reference.ops")
    assert not top & (FORBIDDEN | {"texpose_tpu_torch"})
    ref = os.path.join(harness.ROOT, "bench_port", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            assert "texpose_tpu" not in open(os.path.join(ref, name)).read()


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "texpose_tpu_torch_probe", object())
    assert "texpose_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "texpose_tpu.probe", object())
    assert "texpose_tpu" in harness.forbidden_modules()
