#!/usr/bin/env python3
"""F6 on the card: does the texture GAN's decline after 10k steps through
the kernels (ROADMAP Queue 3, QUAL_H100_r1.json) come from a kernel, or is
it seed noise?  QUAL_r5's protocol (the 64-view fixed-light fixture, the
``base`` variant, a 20k pretrain, full width), per seed:

  (a) the GAN to F6_SPLIT (10k) steps on the kernel route, marks at 2k and
      10k under the six latent protocols (``gan_ablate.mark_eval``), to set
      beside QUAL_H100_r1.json / QUAL_H100_r1_s345.json: equal if the
      route is deterministic, else their difference is the card's
      run-to-run spread;
  (b) the route swap: the 10k state (``train_state_flat``) loaded twice
      through ``load_train_state_flat``, which reseeds the draw generator
      to seed·1000003 + 10000, so both branches draw the same draws (and
      neither continues the original run's); 10k → 20k once through the
      kernels and once with ``kernels.fused_st`` off (the field and the
      composite kernels together), marks at 15k and 20k;
      Δ = kernel branch − plain branch;
  (c) on the seeds of ``--parity``, at the 2k, 10k, 15k and 20k states of
      the kernel side: the next step's own batch and draws through the
      kernels, each kernel (rows 1, 3, 4 and 2 with the dW pair) held
      against its twin on its own inputs, and the whole step's gradients
      against the plain route's, per parameter group
      (``chip_smoke.trained_parity``; chip_smoke.py's bounds).  The state
      and the draw generator are restored, so the run goes on unchanged.

Run from the root of a checkout:

    python3 tools/probe_f6.py [--seeds=0,1,2] [--parity=0,1,2] [--procs=3]
                              [--out=DIR] [--device=cpu] [--key=value ...]
    python3 tools/probe_f6.py --report DIR [DIR ...]

Every stretch of training dispatches K = ``scan_k()`` steps at a time
through the engine's ``StepRunner`` (``_steps``; the captured step on a
card), as the JAX tools dispatch ``step_fn``; a mark fires at the first
dispatch boundary at or past it.  A route swap drops the captured step.

The pretrain runs first (``gan_ablate.pretrain``, reused by its stamp);
with --procs > 1 each seed then runs in its own process on the same card.
Each seed writes DIR/f6_s<seed>.json (rewritten after every phase), then
the tables and the verdict of ``verdict`` go to DIR/F6.json and standard
output.  --report rebuilds them from the seed files of several
directories.  Env: F6_PRETRAIN_ITERS (20000), F6_SPLIT (10000), F6_END
(20000), F6_TRUNK_MARKS ("2000,10000"), F6_BRANCH_MARKS
("15000,20000").  Other ``--key=value`` arguments override the configs
(a run at a reduced width).
"""

import glob
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from texpose_tpu_torch.tools import gan_ablate as ga  # noqa: E402
from texpose_tpu_torch.tools import quality_check as qc  # noqa: E402

PROTOCOLS = ("psnr_topk8", "psnr_mean")        # the Δ table's protocols
REFS = ("QUAL_H100_r1.json", "QUAL_H100_r1_s345.json")
# the decision rule (PERF.md §6, PR 15, written before the runs): a mean
# Δ20k below DELTA_MEAN_DB with at most one seed at or above 0, or every
# seed below 0; the step-gradient error at the last state GRAD_GROWTH x its
# value at the first and past ROUTE_GRAD_NORM / GRAD_SHARE
DELTA_MEAN_DB = -0.5
GRAD_GROWTH = 3.0
GRAD_SHARE = 5.0


def horizons():
    """(pretrain steps, split, end, trunk marks, branch marks)."""
    env = os.environ.get
    return (int(env("F6_PRETRAIN_ITERS", "20000")),
            int(env("F6_SPLIT", "10000")), int(env("F6_END", "20000")),
            [int(x) for x in env("F6_TRUNK_MARKS", "2000,10000").split(",")],
            [int(x) for x in env("F6_BRANCH_MARKS",
                                 "15000,20000").split(",")])


def gen_digest(eng):
    """A digest of the draw generator's state (equal states draw equal
    draws)."""
    return hashlib.sha1(eng.draw_gen.get_state().numpy().tobytes()
                        ).hexdigest()[:16]


def _mark(eng, rec, tag, step, seed):
    t0 = time.time()
    ev = ga.mark_eval(eng)
    ev["step_actual"] = eng.it
    rec[tag].append({"step": step, **{k: float(v) for k, v in ev.items()}})
    print(f"  [s{seed} {tag}] @{step}: psnr_topk8 {ev['psnr_topk8']:.4f} "
          f"psnr_mean {ev['psnr_mean']:.4f} ({time.time() - t0:.1f} s)",
          flush=True)


def _parity(eng, rec, step, seed, smi):
    """The parity checks at this state; a check that cannot run is
    recorded as such, and the seed's run goes on."""
    try:
        res = cs.trained_parity(eng, "gan", "fused_st",
                                lambda: cs.gan_grads(eng))
    except Exception as e:                      # noqa: BLE001
        rec["parity"][str(step)] = {"error": repr(e)}
        print(f"  [s{seed} parity @{step}] could not run: {e!r}", flush=True)
        return
    rec["parity"][str(step)] = res
    for line in cs.parity_text(res):
        print(f"  [s{seed} parity @{step}] {line} [{smi}]", flush=True)


def _steps(eng, end, marks, rec, tag, seed, parity, smi, save):
    """Dispatches of K = ``scan_k()`` steps to ``end`` through the
    engine's ``StepRunner``, as the JAX tools dispatch ``step_fn``; a mark
    fires at the first dispatch boundary at or past it (one a dispatch):
    its evaluation, then (with ``parity``) the parity checks; ``save()``
    after each mark."""
    K = eng.scan_k()
    runner = eng.step_runner()
    pending = sorted(m for m in marks if m > eng.it)
    qc.sync(eng.device)
    t0, done0 = time.time(), eng.it
    while eng.it < end:
        runner.dispatch(min(K, end - eng.it))
        if pending and eng.it >= pending[0]:
            step = pending.pop(0)
            qc.sync(eng.device)
            rate = (eng.it - done0) / (time.time() - t0)
            print(f"  [s{seed} {tag}] step {eng.it}: {rate:.2f} steps/s "
                  f"(scan {K}; {runner.route})", flush=True)
            _mark(eng, rec, tag, step, seed)
            if parity:
                _parity(eng, rec, step, seed, smi)
            save()
            t0, done0 = time.time(), eng.it


def run_seed(cache, seed, device, root, extra, parity, out_dir, smi=""):
    """Phases (a)-(c) of one seed → its record, also written to
    out_dir/f6_s<seed>.json after every phase."""
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    _, split, end, trunk_marks, branch_marks = horizons()
    cfg = ga.variant_cfg(cache, "base", {}, end, seed, root, extra)
    eng = qc.start(TextureGANEngine, cfg, device)
    eng.restore_pretrained_checkpoint()
    rec = {"seed": seed, "split": split, "end": end, "trunk": [],
           "kernels": [], "plain": [], "parity": {}, "wall_s": {},
           "gen_digest": {}, "device": smi}
    path = os.path.join(out_dir, f"f6_s{seed}.json")

    def save():
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)

    t0 = time.time()
    _steps(eng, split, set(trunk_marks), rec, "trunk", seed, parity, smi,
           save)
    rec["wall_s"]["trunk"] = time.time() - t0
    snap = eng.train_state_flat(split)
    for route in ("kernels", "plain"):
        t0 = time.time()
        eng.load_train_state_flat(snap)
        rec["gen_digest"][route] = gen_digest(eng)
        eng.cfg.kernels.fused_st = route == "kernels"
        eng.drop_step_graph()               # capture the branch's route
        _steps(eng, end, set(branch_marks), rec, route, seed,
               parity and route == "kernels", smi, save)
        rec["wall_s"][route] = time.time() - t0
        save()
    eng.cfg.kernels.fused_st = True
    eng.drop_step_graph()
    return rec


def _by_step(rows):
    return {int(r["step"]): r for r in rows}


def delta_table(recs, protocols=PROTOCOLS):
    """{seed: {protocol: {step: kernel branch − plain branch}}} at the
    branch marks both branches reached."""
    out = {}
    for seed, rec in sorted(recs.items()):
        k, p = _by_step(rec["kernels"]), _by_step(rec["plain"])
        out[seed] = {proto: {s: k[s][proto] - p[s][proto]
                             for s in sorted(set(k) & set(p))}
                     for proto in protocols}
    return out


def spread_table(recs, refs, protocols=PROTOCOLS):
    """(a): {seed: {protocol: {step: this run − the reference run}}} at
    the trunk marks, the reference being QUAL_H100_r1*.json's rows."""
    out = {}
    for seed, rec in sorted(recs.items()):
        ref = refs.get(seed)
        if ref is None:
            continue
        mine, theirs = _by_step(rec["trunk"]), _by_step(ref)
        out[seed] = {proto: {s: mine[s][proto] - theirs[s][proto]
                             for s in sorted(set(mine) & set(theirs))}
                     for proto in protocols}
    return out


def verdict(deltas, parity):
    """The decision rule → ("fault" or "noise", the reasons; "incomplete"
    when a parity check did not run).  A kernel fault when any of these
    holds:
      (c) a kernel past its chip_smoke bound at a trained state, or the
          step past route_check's bounds; or the step-gradient error at the
          last checked state ≥ GRAD_GROWTH x its value at the first and
          past ROUTE_GRAD_NORM / GRAD_SHARE;
      (b) on a protocol, Δ at the last mark below 0 in every seed, or
          their mean below DELTA_MEAN_DB with at most one seed at or above
          0.
    ``deltas`` as ``delta_table`` gives; ``parity`` {seed: {step:
    trained_parity's result}}."""
    reasons = []
    broken = [f"(c) seed {seed} @{s}: the check did not run"
              for seed, by_step in sorted(parity.items())
              for s, res in sorted(by_step.items()) if "error" in res]
    if broken:
        return "incomplete", broken
    for seed, by_step in sorted(parity.items()):
        steps = sorted(by_step, key=int)
        for s in steps:
            if not by_step[s]["ok"]:
                past = [r["kernel"] for r in by_step[s]["rows"]
                        if not r["ok"]] or ["the step"]
                reasons.append(f"(c) seed {seed} @{s}: {', '.join(past)} "
                               "past a bound")
        if len(steps) >= 2:
            g0 = by_step[steps[0]]["route"]["grad_rel_norm"]
            g1 = by_step[steps[-1]]["route"]["grad_rel_norm"]
            if g1 >= GRAD_GROWTH * g0 and \
                    g1 > cs.ROUTE_GRAD_NORM / GRAD_SHARE:
                reasons.append(f"(c) seed {seed}: step-gradient error "
                               f"{g0:.3g} @{steps[0]} -> {g1:.3g} "
                               f"@{steps[-1]}")
    for proto in PROTOCOLS:
        last = [d[proto][max(d[proto])] for d in deltas.values()
                if d[proto]]
        if not last:
            continue
        neg = sum(x < 0 for x in last)
        mean = sum(last) / len(last)
        if neg == len(last):
            reasons.append(f"(b) {proto}: Δ < 0 in all {len(last)} seeds "
                           f"(mean {mean:.3f} dB)")
        elif mean < DELTA_MEAN_DB and neg >= len(last) - 1:
            reasons.append(f"(b) {proto}: mean Δ {mean:.3f} dB < "
                           f"{DELTA_MEAN_DB} with {neg} of {len(last)} "
                           "negative")
    return ("fault" if reasons else "noise"), reasons


def load_refs():
    """{seed: QUAL_H100_r1*.json's base rows}."""
    refs = {}
    for name in REFS:
        path = os.path.join(REPO, name)
        if os.path.exists(path):
            doc = json.load(open(path))
            for seed, rows in doc["variants"]["base"].items():
                refs[int(seed)] = rows
    return refs


def report(recs, out_dir, smi=""):
    """The (a)-(c) tables and the verdict → F6.json in out_dir; printed."""
    deltas = delta_table(recs)
    spread = spread_table(recs, load_refs())
    parity = {seed: rec["parity"] for seed, rec in recs.items()
              if rec["parity"]}
    kind, reasons = verdict(deltas, parity)
    print(f"\n=== F6 [{smi}] ===", flush=True)
    for seed, rec in sorted(recs.items()):
        k, p = _by_step(rec["kernels"]), _by_step(rec["plain"])
        tr = _by_step(rec["trunk"])
        cells = " ".join(
            f"{proto} trunk " + "/".join(f"{tr[s][proto]:.3f}"
                                         for s in sorted(tr))
            + " kernels " + "/".join(f"{k[s][proto]:.3f}" for s in sorted(k))
            + " plain " + "/".join(f"{p[s][proto]:.3f}" for s in sorted(p))
            + " Δ " + "/".join(f"{v:+.3f}" for v in
                               deltas[seed][proto].values())
            for proto in PROTOCOLS)
        same = rec["gen_digest"].get("kernels") == \
            rec["gen_digest"].get("plain")
        print(f"(b) seed {seed}: {cells}; branches' draw generators "
              f"{'equal' if same else 'DIFFER'}", flush=True)
    for seed, by_proto in spread.items():
        print(f"(a) seed {seed} vs QUAL_H100_r1: " + "; ".join(
            f"{proto} " + " ".join(f"@{s} {v:+.4f}" for s, v in d.items())
            for proto, d in by_proto.items()), flush=True)
    print(f"verdict: {kind}" + (": " + "; ".join(reasons) if reasons
                                else ""), flush=True)
    out = {"device": smi, "horizons": horizons(), "seeds": recs,
           "delta": deltas, "spread_vs_qual_h100_r1": spread,
           "verdict": kind, "reasons": reasons}
    path = os.path.join(out_dir, "F6.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)
    return out


def read_seed_files(dirs, prefix="f6"):
    recs = {}
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, f"{prefix}_s*.json"))):
            rec = json.load(open(path))
            recs[int(rec["seed"])] = rec
    return recs


def _smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def parse(argv, out="f6"):
    opts = {"seeds": "0,1,2", "parity": "", "procs": "1",
            "out": os.path.join(REPO, "chiprun_out", out), "child": None}
    rest = []
    for a in argv:
        key = a[2:].split("=", 1)[0]
        if key in opts and "=" in a:
            opts[key] = a.split("=", 1)[1]
        elif key == "child":
            opts["child"] = True
        else:
            rest.append(a)
    return opts, rest


def main(argv=None):
    from texpose_tpu_torch.models.base import resolve_device
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--report":
        recs = read_seed_files(argv[1:])
        return report(recs, argv[1], next(iter(recs.values()))["device"])
    opts, rest = parse(argv)
    name, extra = qc.parse_argv(rest)
    device = resolve_device({"device": name})
    smi = _smi()
    seeds = [int(s) for s in opts["seeds"].split(",")]
    parity = {int(s) for s in opts["parity"].split(",") if s}
    out_dir = opts["out"]
    os.makedirs(out_dir, exist_ok=True)
    cache = qc.fixture(64, True)
    root = ga.out_root(True, 64)
    ga.pretrain(cache, horizons()[0], device, root, extra)
    procs = int(opts["procs"])
    if opts["child"] or procs <= 1:
        recs = {s: run_seed(cache, s, device, root, extra, s in parity,
                            out_dir, smi) for s in seeds}
        return recs if opts["child"] else report(recs, out_dir, smi)
    failed = spawn_seeds(__file__, argv, seeds, procs, out_dir, "f6")
    out = report(read_seed_files([out_dir]), out_dir, smi)
    if failed:
        raise SystemExit(f"probe_f6: seed runs failed: {failed}")
    return out


def spawn_seeds(script, argv, seeds, procs, out_dir, prefix):
    """``script`` once per seed (``--seeds=<s> --child`` and the rest of
    ``argv``), at most ``procs`` processes at a time on the same card,
    each logging to out_dir/<prefix>_s<seed>.log → the seeds that
    failed."""
    base = [a for a in argv if not a.startswith(("--seeds=", "--procs="))]
    running, failed = [], []
    for s in seeds:
        while len(running) >= procs:
            failed += _reap(running)
        log = open(os.path.join(out_dir, f"{prefix}_s{s}.log"), "w")
        running.append((s, log, subprocess.Popen(
            [sys.executable, os.path.abspath(script), *base,
             f"--seeds={s}", "--child"], stdout=log,
            stderr=subprocess.STDOUT)))
    while running:
        failed += _reap(running)
    return failed


def _reap(running):
    """Wait for one of the running seed processes → the seeds that
    failed."""
    while True:
        for i, (s, log, p) in enumerate(running):
            if p.poll() is not None:
                log.close()
                del running[i]
                return [s] if p.returncode else []
        time.sleep(5)


if __name__ == "__main__":
    main()
