"""The two readings a cell's limits are set from, on the card at the cell's
own size: the program's gaps on many seeds (the lower reading), and those
of the control — the plain reference computed one precision step below
the configured bfloat16 (float8 e4m3 operands) and put in the program's
place — on the first few (the upper reading).  Training cells also read
the faults planted in the reference put in the program's place: a step
that leaves half its batch out, and each of the reference module's
``FAULTS`` (configuration keys, as a loss term switched off).  No window
is timed: each seed runs the cell's set-up (for an evaluation cell, its
warm sweep is the frames compared).  It runs on a CUDA card only: limits
are set from the card's readings.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--out control_<cell>.json]
"""

import argparse
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port.lib import harness  # noqa: E402

harness.setup_env()

import torch  # noqa: E402

from bench_port.reference import ops  # noqa: E402


def readings(spec, seed, device, control, log=print):
    """{"sound": {name: gap}, "control": ..., and for a training cell
    "half_batch" and each of the reference's FAULTS: ...} of one seed
    (all but "sound" only with ``control``)."""
    entry = importlib.import_module(
        f"bench_port.entries.{spec['workload']['entry']}")
    workdir = tempfile.mkdtemp(prefix="bench_port_control_")
    try:
        cell = entry.Cell(spec, seed, device, workdir, log)
        cell.setup()
        cell.release()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out = {"sound": {n: v for n, v, _ in cell.check()}}
        if control:
            low = ops.Precision("float8")
            if spec["workload"]["entry"] == "train":
                ref, _ = cell.reference()
                ctl, _ = cell.reference(low)
                half, _ = cell.reference(halve=True)
                out["control"] = {n: v for n, v, _ in cell.checks(ctl, ref)}
                out["half_batch"] = {n: v for n, v, _ in
                                     cell.checks(half, ref)}
                for name, keys in getattr(cell.ref_mod, "FAULTS",
                                          {}).items():
                    bad, _ = cell.reference(cfg=keys)
                    out[name] = {n: v for n, v, _ in cell.checks(bad, ref)}
            else:
                ref = cell.reference()
                out["control"] = {n: v for n, v, _ in
                                  cell.checks(cell.reference(low), ref)}
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < spec["chips"]:
        print(f"control: {args.workload} needs {spec['chips']} CUDA card(s); "
              f"torch sees {cards}", file=sys.stderr, flush=True)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    res = {"workload": args.workload, "seeds": {},
           "device": torch.cuda.get_device_name(0)}
    for i, seed in enumerate(seeds):
        t0 = time.time()
        r = readings(spec, seed, device, i < args.control)
        r["seconds"] = time.time() - t0
        res["seeds"][str(seed)] = r
        print(json.dumps({"seed": seed, **r}), flush=True)
    kinds = {k for r in res["seeds"].values() for k in r} - {"seconds"}
    for kind in sorted(kinds):
        got = [r[kind] for r in res["seeds"].values() if kind in r]
        if got:
            res[kind] = {n: {"max": max(g[n] for g in got),
                             "min": min(g[n] for g in got)}
                         for n in got[0]}
            print(kind, json.dumps(res[kind]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
