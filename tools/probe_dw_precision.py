#!/usr/bin/env python3
"""How exact the split backwards' grouped dW GEMM (csrc/dw_gemm.cu, with
its fixed-order reduction) is at trained states, by the length of its
in-accumulator sums: the rows of one split.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/probe_dw_precision.py [--splits=1,2,4,8,16]

It trains quality_check's two stages to the end states chip_smoke's phase
13 trains (QUAL_PRETRAIN_STEPS / QUAL_GAN_STEPS), captures the dW GEMM's
inputs of each stage's next step (rows 7b and 2: the planes the dX chain
wrote) and prints, beside the f32 products of the same planes
(torch.matmul, TF32 off): the worst block's ‖dW − f64 sums‖ / ‖f64 sums‖
and the GEMM + reduction time (CUDA events, median of 10) for the split
plan before PR 15 (``two_wave_rows``: at most two waves of blocks) with
its splits multiplied by each factor of --splits (the same kernel,
shorter sums, more partials for ``dw_reduce`` to add in f32), then the
old plan and the package's (``dw_gemm.split_rows``) in turns old / new /
new / old.  Prints the card's name and power limit.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def capture(eng, module):
    """The dW GEMM's inputs of the engine's next step, cloned; the state
    and the draw generator restored after."""
    import torch
    seen = {}
    real = module.dw_grads

    def grab(srcs, g_wide, g_narrow, segs, grads):
        seen["args"] = ([s.clone() for s in srcs], g_wide.clone(),
                        g_narrow.clone(), segs, grads.numel())
        return real(srcs, g_wide, g_narrow, segs, grads)

    state, gen = eng.train_state_flat(0), eng.draw_gen.get_state()
    module.dw_grads = grab
    try:
        eng.train_step(eng.make_draws(eng.it))
        torch.cuda.synchronize()
    finally:
        module.dw_grads = real
        eng.load_train_state_flat(state)
        eng.draw_gen.set_state(gen)
    return seen["args"]


def exact_and_f32(srcs, g_wide, g_narrow, segs, total):
    """Each segment's dW summed in f64 and in f32 (torch.matmul)."""
    import torch
    from texpose_tpu_torch.kernels import dw_gemm as dw
    out = {}
    for dtype in (torch.float64, torch.float32):
        g = torch.zeros(total, dtype=dtype, device=g_wide.device)
        for s in segs:
            h = dw._planes(srcs[s.a])[s.a_plane][:, s.a_col:s.a_col + s.k_in]
            b = (g_wide[s.b_plane] if s.b == dw.WIDE else g_narrow)[
                :, s.b_col:s.b_col + s.n]
            g[s.out:s.out + s.k_in * s.n] = (h.to(dtype).t() @ b.to(dtype)
                                             ).reshape(-1)
        out[dtype] = g
    return out[torch.float64], out[torch.float32]


def worst_rel(got, exact, segs):
    """The worst segment's ‖got − exact‖ / ‖exact‖."""
    blocks = [slice(s.out, s.out + s.k_in * s.n) for s in segs]
    return max(float((got[b].double() - exact[b]).norm())
               / max(float(exact[b].norm()), 1e-30) for b in blocks)


def two_wave_rows(M, tiles, sms):
    """The split plan before PR 15: at most two blocks per SM, each split
    at least eight 64-row stages."""
    from texpose_tpu_torch.kernels import dw_gemm as dw
    chunks = -(-M // dw.STAGE_ROWS)
    splits = max(1, min(2 * sms // max(tiles, 1), chunks // 8))
    per = -(-chunks // splits)
    return per * dw.STAGE_ROWS, -(-chunks // per)


def run_plan(args, plan, exact):
    """(worst block's distance from f64 sums, GEMM + reduction ms) with
    the split plan ``plan`` (rows per split, splits)."""
    import torch
    import chip_smoke as cs
    from texpose_tpu_torch.kernels import dw_gemm as dw
    srcs, g_wide, g_narrow, segs, total = args
    real = dw.split_rows
    dw.split_rows = lambda *_a: plan
    dw._plan.cache_clear()
    try:
        def run():
            return dw.dw_grads(srcs, g_wide, g_narrow, segs,
                               torch.zeros(total, device=g_wide.device))
        got = run()
        torch.cuda.synchronize()
        return worst_rel(got, exact, segs), cs.time_ms(run, reps=10)
    finally:
        dw.split_rows = real
        dw._plan.cache_clear()


def sweep(what, args, factors, smi):
    import torch
    from texpose_tpu_torch.kernels import dw_gemm as dw
    srcs, g_wide, g_narrow, segs, total = args
    M = g_wide.shape[1]
    exact, f32 = exact_and_f32(srcs, g_wide, g_narrow, segs, total)
    sms = torch.cuda.get_device_properties(g_wide.device) \
        .multi_processor_count
    tiles = len(dw.problems(segs))
    old = two_wave_rows(M, tiles, sms)
    new = dw.split_rows(M, tiles, sms)
    print(f"{what}: M={M}, {tiles} tiles; f32 products (torch.matmul) "
          f"worst block {worst_rel(f32, exact, segs):.3g} of the f64 "
          f"norm [{smi}]", flush=True)
    chunks = -(-M // dw.STAGE_ROWS)
    for f in factors:
        per = max(1, -(-chunks // (old[1] * f))) * dw.STAGE_ROWS
        plan = (per, -(-M // per))
        rel, ms = run_plan(args, plan, exact)
        part_mb = tiles * plan[1] * dw.TILE_I * dw.TILE_N * 4 / 1e6
        print(f"{what}: splits {plan[1]} of {plan[0]} rows (x{f}): worst "
              f"block {rel:.3g} of the f64 norm; GEMM + reduction "
              f"{ms:.4f} ms; partials {part_mb:.1f} MB [{smi}]", flush=True)
    turns = [run_plan(args, p, exact) for p in (old, new, new, old)]
    print(f"{what}: in turns old {old} / new {new} / new / old: worst block "
          + " / ".join(f"{r:.3g}" for r, _ in turns) + "; ms "
          + " / ".join(f"{t:.4f}" for _, t in turns) + f" [{smi}]",
          flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--splits", default="1,2,4,8,16")
    factors = [int(x) for x in p.parse_args().splits.split(",")]
    sys.modules["jax"] = None
    sys.modules["texpose_tpu"] = None
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("probe_dw_precision: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from texpose_tpu_torch.kernels import coarse_field as cf
    from texpose_tpu_torch.kernels import st_field as sf
    from texpose_tpu_torch.tools import quality_check as qc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    tmp = tempfile.mkdtemp(prefix="probe_dw_")
    tempfile.tempdir = tmp                  # fixture and runs under tmp
    os.environ.update(QUAL_PRETRAIN_ITERS=str(cs.QUAL_PRETRAIN_STEPS),
                      QUAL_GAN_ITERS=str(cs.QUAL_GAN_STEPS))
    try:
        out = qc.main(["--device=cuda"])
        for what, eng, module in (
                (f"row 7b at pretrain step {out['pretrain']['engine'].it}",
                 out["pretrain"]["engine"], cf),
                (f"row 2 at GAN step {out['gan']['engine'].it}",
                 out["gan"]["engine"], sf)):
            sweep(what, capture(eng, module), factors, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
