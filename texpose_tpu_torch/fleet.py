"""Multi-object fleet launcher of the PyTorch/CUDA port, with the flags of
the top-level ``train_fleet.py``: each object of the 13-object LineMOD
fleet is one independent ``python -m texpose_tpu_torch.train`` run (each
owns its radiance field; nothing is shared across objects), with its own
output directory <output_root>/<group>/<object>.

    python -m texpose_tpu_torch.fleet --yaml=configs/nerf_lm_adapt_gan.yaml \\
        --objects=duck,cat,ape --group=LM [--parallel=2] [--retries=1] \\
        [-- extra train args]

``--parallel=k`` runs k objects at once, one card each: slot i runs with
``CUDA_VISIBLE_DEVICES=i``; more slots than visible cards raises unless the
extras hold ``--device=cpu``.  ``--retries=n`` relaunches a failed run with
``--resume`` up to n times.  Any run that still fails makes the fleet exit
1.
"""

import argparse
import os
import subprocess
import sys

import torch


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(prog="python -m texpose_tpu_torch.fleet")
    p.add_argument("--yaml", required=True)
    p.add_argument("--objects", required=True,
                   help="comma-separated object names")
    p.add_argument("--group", default="fleet")
    p.add_argument("--parallel", type=int, default=1,
                   help="concurrent runs, one card each")
    p.add_argument("--retries", type=int, default=0,
                   help="relaunch a failed run with --resume up to N times")
    a = p.parse_args(argv)

    on_cpu = "--device=cpu" in extra
    cards = torch.cuda.device_count()
    if not on_cpu and a.parallel > cards:
        raise ValueError(f"--parallel={a.parallel} but {cards} cards are "
                         "visible (one run per card; pass -- --device=cpu "
                         "to run on the CPU)")
    objects = [o for o in a.objects.split(",") if o]
    procs, results, attempts = [], {}, {}
    free = list(range(a.parallel))

    def launch(obj, slot, resume=False):
        cmd = [sys.executable, "-m", "texpose_tpu_torch.train",
               f"--yaml={a.yaml}", f"--data.object={obj}",
               f"--group={a.group}", f"--name={obj}"] + extra
        if resume:
            cmd.append("--resume")
        env = dict(os.environ)
        if not on_cpu:
            env["CUDA_VISIBLE_DEVICES"] = str(slot)
        print(f"[fleet] launching {obj}: {' '.join(cmd)}", flush=True)
        return obj, slot, subprocess.Popen(cmd, env=env)

    queue = objects[:]
    while queue or procs:
        while queue and free:
            obj = queue.pop(0)
            procs.append(launch(obj, free.pop(0),
                                resume=attempts.get(obj, 0) > 0))
        obj, slot, pr = procs.pop(0)
        rc = pr.wait()
        free.append(slot)
        print(f"[fleet] {obj} exited with {rc}", flush=True)
        if rc != 0 and attempts.get(obj, 0) < a.retries:
            attempts[obj] = attempts.get(obj, 0) + 1
            print(f"[fleet] retrying {obj} with --resume "
                  f"(attempt {attempts[obj]}/{a.retries})", flush=True)
            queue.append(obj)
        else:
            results[obj] = rc

    failed = {k: v for k, v in results.items() if v != 0}
    if failed:
        print(f"[fleet] FAILED: {failed}", flush=True)
        sys.exit(1)
    print(f"[fleet] all {len(results)} objects done", flush=True)


if __name__ == "__main__":
    main()
