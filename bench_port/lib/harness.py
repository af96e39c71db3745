"""One run of one cell of the port's benchmark.

The cell's entry in ``BENCHMARK.json`` names its configuration
(``bench_port/configs/<file>``) and its workload file
(``bench_port/workloads/<cell>.json``: the entry module under
``bench_port/entries``, the traffic's parameters, the comparison's
limits); every metric, end-to-end and per-layer, is a reader
``bench_port/metrics/<metric>.py`` with ``read(run)`` → a number or None
(None: nothing to read in this run, and the metric is left out of the
line).  Nothing here names a cell, a configuration or a metric.

A run: the entry's ``setup`` (data from the seed, the engine, its weights
from the seed, the compared first steps or frames, the warm-up of every
shape the window uses), then its ``window`` for ``--seconds``; with
``--trace 1`` a traced stretch of the timed path after it.  The device
peak is read, the program's state freed, and the entry's ``check``
compares what the timed path produced with the plain reference
(``bench_port/reference``).  The last line of standard output is the
result; the compared numbers, each with its limit, end standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "texpose_tpu")


def setup_env():
    """The run's caches inside the checkout (fixed paths under build/),
    set before torch is imported; no library of the run loads JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_port", sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(name, root=ROOT):
    """The cell's entry in BENCHMARK.json with its workload and
    configuration files, and its data cache directory inside the checkout
    → a dict (raises on a name not there)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    cell = cells[name]
    confs = {c["name"]: c for c in bench["configs"]}
    conf = confs[cell["config"]]
    return {"name": name, "chips": int(cell["chips"]), "bench": bench,
            "cache": os.path.join(root, "build", "bench_port", "data", name),
            "config": load_json(os.path.join(root, conf["file"])),
            "workload": load_json(os.path.join(
                root, "bench_port", "workloads", f"{name}.json"))}


def metrics_for(bench, cell, kind):
    """The metrics of ``kind`` ("end_to_end" or "per_layer") the cell
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name, root=ROOT):
    """The module ``bench_port/metrics/<name>.py``."""
    path = os.path.join(root, "bench_port", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Top-level names in sys.modules that the run must not have loaded,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a run measured, for the metric readers: ``setup_s``,
    ``window`` (the entry's: ``seconds`` and its counts), ``peak_bytes``,
    ``trace`` (a lib.trace.TraceView, or None), ``cfg`` (the engine's
    configuration as plain data), ``shapes`` (lib.flops) and ``spec``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def execute(spec, seed, seconds, trace, device, t_start, overrides=None,
            log=None):
    """Set up, time, trace and check one run of the cell on ``device`` →
    (Run, checks [(name, value, limit)], failed units).  ``overrides``
    (tests at a small size on the CPU): {"config": {...}, "workload":
    {...}} merged over the files' dicts."""
    import torch
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    if overrides:
        spec = dict(spec)
        for key in ("config", "workload"):
            spec[key] = _merge(spec[key], overrides.get(key) or {})
    entry = importlib.import_module(
        f"bench_port.entries.{spec['workload']['entry']}")
    cuda = device.type == "cuda"
    needs = set()
    if trace:
        for m in metrics_for(spec["bench"], spec["name"], "per_layer"):
            needs |= set(getattr(reader(m["name"]), "NEEDS", ()))
    workdir = tempfile.mkdtemp(prefix="bench_port_")
    try:
        cell = entry.Cell(spec, seed, device, workdir, log)
        cell.setup()
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.time() - t_start
        log(f"set-up {setup_s:.3f} s")
        window = cell.window(seconds)
        log(f"window: {window}")
        view = cell.trace(needs) if trace else None
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        cell.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = cell.check()
        run = Run(setup_s=setup_s, window=window, peak_bytes=peak,
                  trace=view, cfg=cell.plain_cfg, shapes=cell.shapes,
                  spec=spec)
        return run, checks, window.get("failed", 0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def result_line(run, checks, failed, trace, chips, device_kind):
    """The result's dict (its ``checks`` key last)."""
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(run.spec["bench"], run.spec["name"], kind):
        v = reader(m["name"]).read(run)
        if v is not None:
            if not math.isfinite(v):
                raise ValueError(f"metric {m['name']} read {v}")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    out = {"correct": bool(correct),
           "attempted": int(run.window["units"]), "failed": int(failed),
           "metrics": metrics,
           "device": {"platform": "gpu", "kind": device_kind,
                      "count": chips,
                      "memory_peak_bytes": int(run.peak_bytes)}}
    if trace:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(prog="bench_port/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start):
    args = parse_args(argv)
    spec = cell_spec(args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < spec["chips"]:
        print(f"bench_port: {args.workload} needs {spec['chips']} CUDA "
              f"card(s); torch sees {cards}", file=sys.stderr, flush=True)
        return 2
    device = torch.device("cuda", 0)
    run, checks, failed = execute(spec, args.seed, args.seconds,
                                  bool(args.trace), device, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: the run loaded {bad}", file=sys.stderr,
              flush=True)
        return 3
    out = result_line(run, checks, failed, bool(args.trace), spec["chips"],
                      torch.cuda.get_device_name(0))
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr,
              flush=True)
    print(json.dumps(out), flush=True)
    return 0
