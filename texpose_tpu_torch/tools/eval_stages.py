"""Where the time of one captured 480x640 evaluation frame goes, stage by
stage (the JAX package's tools/probe_eval_stages.py): the texture GAN's
``evaluate_full`` loop taken apart, each stage ending in a sync, on the
host clock, over a cycled split of the evaluation envelope's fixture
(tools/eval_envelope.py), a fresh frame object each iteration.

    python -m texpose_tpu_torch.tools.eval_stages [--frames 32] [--noisy]
        [--key=value]

Needs a CUDA card; it raises without one.  The readings, with the card's
``nvidia-smi`` name and power limit, go to SECTIONS_H100.json
(``frame_stages``; ``SECTIONS_JSON`` overrides the path).  --noisy
evaluates with nerf.density_noise_reg = 1 (the trunk kernel, row 10, under
plain heads); ``--key=value`` overrides the config.

Stages (``STAGES``), as ``evaluate_full`` and ``FrameRunner.run`` run them
(models/texture_gan.py, models/frame_graph.py):
  load     ``dataset[i]`` and the compact transform (the prefetch worker's)
  upload   the payload's pin and upload (``to_device``, the worker's)
  latents  the frame's latents (``_frame_latents``)
  route    ``follow_route`` (``step_graph.route_key``) and the unit lookup
  put      ``_Unit.load``: the slots' copies, the latent's pin and upload
  render   the ``("evalcompact", raw_hw, P)`` replay (its body, eagerly,
           where nothing is captured)
  clone    ``_map(torch.clone, unit.out)``
  pull     ``flush_one``'s ``float(p)``, ``float(s)``, ``float(lp)`` and
           ``png.cpu()``
  png      the writer's encode of the frame's PNG
sync_loop is the wall of the stages in sequence a frame, pipe_loop the
wall a frame of ``evaluate_full`` over the same split (the shipped loop:
the next frame loads on the worker, results are pulled one frame behind,
PNGs encode on the writer thread).  CUDA events at the stage boundaries
give each device stage's device ms (the render's is the replay's).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from . import eval_envelope as ee
from . import quality_check as qc
from .step_sections import nvidia_smi, record

STAGES = ("load", "upload", "latents", "route", "put", "render", "clone",
          "pull", "png")
DEVICE_STAGES = ("upload", "put", "render", "clone", "pull")


class Clock:
    """Stage marks on the host clock, each after a sync, with a CUDA event
    beside each mark on a card; with ``sync`` False bare host times (the
    stages in sequence, as the loop runs them)."""

    def __init__(self, device, sync=True):
        self.cuda = device.type == "cuda" and sync
        self.marks = []

    def mark(self, name):
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            torch.cuda.synchronize()
        self.marks.append((name, time.perf_counter(), ev))

    def read(self):
        """{stage: host ms} and {stage: device ms} between the marks."""
        host, dev = {}, {}
        for (_, t0, e0), (name, t1, e1) in zip(self.marks, self.marks[1:]):
            host[name] = (t1 - t0) * 1e3
            if e0 is not None:
                dev[name] = e0.elapsed_time(e1)
        return host, dev


def compact_inputs(frame, lt, ll):
    """The ``("evalcompact", raw_hw, P)`` program's inputs from a compact
    payload on the device (``TextureGANEngine._eval_compact``)."""
    return dict(pose=frame["pose"], intr=frame["intr"],
                zn=frame["z_near_pre"], zf=frame["z_far_pre"], lt=lt, ll=ll,
                idx=frame["idx"], img_sparse_u8=frame["image_sparse_u8"])


def write_png(cfg, path, idx_p, png):
    """The writer's encode of a frame (``evaluate_full``'s
    ``write_sparse_png`` for a sparse payload)."""
    import cv2
    if idx_p is None:
        cv2.imwrite(path, np.ascontiguousarray(png))
        return
    full = np.zeros((cfg.H * cfg.W, 3), np.uint8)
    full[idx_p] = png
    cv2.imwrite(path, np.ascontiguousarray(
        full.reshape(cfg.H, cfg.W, 3)[..., ::-1]))


def stage_frame(eng, i, tab, rng, out_dir, sync=True):
    """Frame i of ``evaluate_full``'s loop stage by stage (each ending in a
    sync, or with ``sync`` False in sequence) → ({stage: host ms}, {stage:
    device ms}, the frame's (psnr, ssim, lpips))."""
    from ..models.frame_graph import _map
    from ..models.step_graph import follow_route
    from ..utils.pipeline import to_device
    cfg = eng.cfg
    raw_hw = getattr(eng.eval_data, "raw_hw", None)
    need = raw_hw is not None and tuple(raw_hw) != (cfg.H, cfg.W)
    runner = eng.frame_runner()
    transform = eng._eval_compact_transform()
    clock = Clock(eng.device, sync)
    clock.mark("start")
    sample = eng.eval_data[i]
    payload = transform(sample)
    if "image_sparse_u8" not in payload:
        raise ValueError(f"frame {i} does not take the compact payload")
    clock.mark("load")
    frame = to_device(payload, eng.device, batch=False)
    clock.mark("upload")
    lt, ll = eng._frame_latents(np.asarray(sample["pose"]), tab, rng)
    clock.mark("latents")
    key = ("evalcompact", raw_hw, frame["idx"].shape[0])
    follow_route(runner)
    unit = runner.units.get(key)
    clock.mark("route")
    if unit is None:
        raise KeyError(f"frame program {key} not captured: warm it first")
    with torch.inference_mode():
        unit.load(compact_inputs(frame, lt, ll))
        clock.mark("put")
        if unit.graph is not None:
            unit.graph.replay()
            unit.replays += 1
            out = unit.out
        else:
            out = unit.body(**unit.slots)
        clock.mark("render")
        p, s, lp, png = _map(torch.clone, out)
        clock.mark("clone")
    metrics = (float(p), float(s), float(lp))
    png = png.cpu().numpy()
    clock.mark("pull")
    write_png(cfg, os.path.join(out_dir, f"{i:06d}.png"),
              None if need else sample["_idx_host"], png)
    clock.mark("png")
    host, dev = clock.read()
    return host, dev, metrics


def _stats(rows):
    a = np.asarray(rows)
    return {"median": float(np.median(a)), "min": float(a.min()),
            "max": float(a.max())}


def run_stages(eng, n=None, out_dir=None):
    """The stages over the engine's first n eval frames (its frame program
    warmed on frame 0 first), each ending in a sync; then the same frames'
    stages in sequence, a frame's wall each (sync_loop); then
    ``evaluate_full``'s per-frame wall over the split (pipe_loop) → the
    reading."""
    n = len(eng.eval_data) if n is None else n
    out_dir = out_dir or tempfile.mkdtemp(prefix="texpose_eval_stages_")
    eng.warm_eval(0)
    eng._eval_cache = (None, None)
    tab = eng._host_latents_table()
    seed = int(eng.cfg.render.get("eval_seed", 0) or 0)
    rng = np.random.default_rng(seed)
    host, dev, loops = {k: [] for k in STAGES}, {}, []
    for i in range(n):
        h, d, _ = stage_frame(eng, i, tab, rng, out_dir)
        for k in STAGES:
            host[k].append(h[k])
        for k, v in d.items():
            dev.setdefault(k, []).append(v)
    rng = np.random.default_rng(seed)
    for i in range(n):
        loops.append(sum(stage_frame(eng, i, tab, rng, out_dir,
                                     sync=False)[0].values()))
    eng._eval_cache = (None, None)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.evaluate_full()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    pipe = (time.perf_counter() - t0) * 1e3 / len(eng.eval_data)
    shutil.rmtree(out_dir, ignore_errors=True)
    stages = {k: _stats(v) for k, v in host.items()}
    med = {k: v["median"] for k, v in stages.items()}
    sync_loop = float(np.median(loops))
    return {"frames": n, "hw": [eng.cfg.H, eng.cfg.W], "host_ms": stages,
            "device_ms": {k: _stats(v) for k, v in dev.items()
                          if k in DEVICE_STAGES},
            "stage_sum_ms": sum(med.values()), "sync_loop_ms": sync_loop,
            "pipe_loop_ms": pipe, "views_per_s_sync": 1e3 / sync_loop,
            "views_per_s_pipe": 1e3 / pipe,
            "route": eng.frame_runner().route}


def stages_text(r):
    lines = [f"{k:8s} med {v['median']:8.3f} ms  min {v['min']:8.3f}  max "
             f"{v['max']:8.3f}" + (f"   device med "
                                   f"{r['device_ms'][k]['median']:8.3f} ms"
                                   if k in r["device_ms"] else "")
             for k, v in r["host_ms"].items()]
    lines.append(f"stage sum (medians) {r['stage_sum_ms']:.3f} ms; sync_loop "
                 f"{r['sync_loop_ms']:.3f} ms = {r['views_per_s_sync']:.2f} "
                 f"views/s; pipe_loop {r['pipe_loop_ms']:.3f} ms = "
                 f"{r['views_per_s_pipe']:.2f} views/s ({r['frames']} frames "
                 f"at {r['hw'][0]}x{r['hw'][1]}; {r['route']})")
    return "\n".join(lines)


def stages_engine(device, n, overrides=()):
    """The evaluation envelope's 480x640 GAN engine over an n-frame split
    (its frame 0 cycled)."""
    from ..models.texture_gan import TextureGANEngine
    cache = ee.fixture()
    scene = ee.long_split(cache, n)
    out = os.path.join(tempfile.gettempdir(), "texpose_eval_stages_torch")
    shutil.rmtree(out, ignore_errors=True)
    cfg = ee.envelope_cfg(cache, scene, (480, 640), out, overrides)
    eng = TextureGANEngine(cfg, device)
    eng.load_dataset(eval_split="test")
    eng.build_networks()
    eng.setup_optimizer()
    return eng


def main(argv=None):
    """The stages on the card → the reading, written to SECTIONS_JSON
    (``frame_stages``); raises without a card."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n, noisy, rest = 32, False, []
    it = iter(argv)
    for a in it:
        if a == "--frames":
            n = int(next(it))
        elif a.startswith("--frames="):
            n = int(a.split("=", 1)[1])
        elif a == "--noisy":
            noisy = True
        elif a.startswith("--device"):
            raise ValueError("eval_stages measures on the card only")
        elif a.startswith("--"):
            rest.append(a)
        else:
            raise ValueError(f"invalid argument {a!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("eval_stages: the measurement needs a CUDA card; "
                           "none is visible")
    print(nvidia_smi(), flush=True)
    if noisy:
        rest.append("--nerf.density_noise_reg=1")
    eng = stages_engine(torch.device("cuda", 0), n, rest)
    res = run_stages(eng)
    print(stages_text(res), flush=True)
    print(json.dumps(res), flush=True)
    record("frame_stages" + ("_noisy" if noisy else ""), res)
    qc.check(res["frames"] == n, f"{res['frames']} frames, expected {n}")
    return res


if __name__ == "__main__":
    main()
