#!/usr/bin/env python3
"""F7 on the card: the port's texture loses quality under the mean-latent
protocol (``psnr_mean``) from 10k to 20k GAN steps, where the JAX package
on the TPU did not (ROADMAP Queue 3).  Two platform causes, each swapped
in alone from one shared 10k state.  QUAL_r5's protocol: the 64-view
fixed-light fixture, the ``base`` variant at the full width of
configs/nerf_lm_adapt_gan.yaml, one shared 20k pretrain; per seed:

  * the GAN to F7_SPLIT (10k) steps through the captured dispatch
    (``probe_f6._steps``: K = ``scan_k()`` steps a dispatch), a mark there
    under the six latent protocols (``gan_ablate.mark_eval``);
  * from that state, loaded anew for each branch through
    ``load_train_state_flat`` (which reseeds the draw generator, so every
    branch draws the same draws), four branches to F7_END (20k), marks at
    F7_BRANCH_MARKS (15k, 20k), the captured step dropped and captured
    again for each:
      a   as is;
      a2  as is again: two runs from one state part through the kernels'
          f32 atomics and cuDNN's nondeterministic backwards, so
          |Δa − Δa2| is the noise floor a branch has to clear;
      b   the TPU's default precision (tools/tpu_precision.py): the
          discriminator's convolutions and their VJPs, the spectral-norm
          matvecs and the Lab contraction on bf16-rounded operands with f32
          products and sums, TF32 off;
      c   cuDNN's deterministic algorithms (``cudnn.deterministic``).

Δ_x = the branch's protocol PSNR at the last mark − the 10k mark's; d_x =
Δ_x − Δ_a.  The decision rule (PERF.md §6, PR 19, written before the
runs): on ``psnr_mean``, branch b or c accounts for F7 when its six-seed
mean d_x > 0, that mean ≥ 2 standard errors of d_x, that mean > the mean
|Δa − Δa2|, and the seed mean of Δ_x ≥ −1 dB (the 20k gate).

Run from the root of a checkout:

    python3 tools/probe_f7.py [--seeds=0,1,2,3,4,5] [--procs=3] [--out=DIR]
                              [--pretrain=CKPT] [--device=cpu] [--key=value]
    python3 tools/probe_f7.py --report DIR [DIR ...]

The pretrain runs first (``gan_ablate.pretrain``, reused by its stamp) and
is copied to DIR/pretrain_model.ckpt; ``--pretrain=CKPT`` adopts such a
copy instead, so seeds run in separate calls share one pretrain.  With
--procs > 1 each seed runs in its own process on the same card.  Each
seed writes DIR/f7_s<seed>.json (rewritten after every mark), then the
tables and the outcome go to DIR/F7_H100.json and standard output;
--report rebuilds them from the seed files of several directories.
Env: F7_PRETRAIN_ITERS (20000), F7_SPLIT (10000), F7_END (20000),
F7_BRANCH_MARKS ("15000,20000").  Other ``--key=value`` arguments override
the configs (a run at a reduced width).
"""

import contextlib
import hashlib
import json
import math
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import probe_f6 as f6  # noqa: E402
import tpu_precision  # noqa: E402
from texpose_tpu_torch.tools import gan_ablate as ga  # noqa: E402
from texpose_tpu_torch.tools import quality_check as qc  # noqa: E402

BRANCHES = ("a", "a2", "b", "c")
PROTOCOLS = ("psnr_mean", "psnr_topk8")
RULE_PROTOCOL = "psnr_mean"
GATE_DB = -1.0              # the 20k gate: 20k ≥ 10k − 1 dB
SE_MULT = 2.0


def horizons():
    """(pretrain steps, split, end, branch marks)."""
    env = os.environ.get
    return (int(env("F7_PRETRAIN_ITERS", "20000")),
            int(env("F7_SPLIT", "10000")), int(env("F7_END", "20000")),
            [int(x) for x in env("F7_BRANCH_MARKS",
                                 "15000,20000").split(",")])


@contextlib.contextmanager
def cudnn_deterministic():
    import torch
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


@contextlib.contextmanager
def branch_setting(name):
    """The block under branch ``name``'s setting → a dict that holds, at
    the block's end, the calls of the emulated sites (branch b)."""
    seen = {}
    if name == "b":
        with tpu_precision.tpu_default_precision() as calls:
            yield seen
            seen["site_calls"] = dict(calls)
    elif name == "c":
        with cudnn_deterministic():
            yield seen
    else:
        yield seen


def file_digest(path):
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()[:16]


def run_seed(cache, seed, device, root, extra, out_dir, smi="",
             pretrain_digest=None, branches=BRANCHES):
    """The trunk to the split and the branches from its state → the
    seed's record, also written to out_dir/f7_s<seed>.json after every
    mark."""
    import torch
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    _, split, end, marks = horizons()
    cfg = ga.variant_cfg(cache, "base", {}, end, seed, root, extra)
    eng = qc.start(TextureGANEngine, cfg, device)
    eng.restore_pretrained_checkpoint()
    rec = {"seed": seed, "split": split, "end": end, "trunk": [],
           "wall_s": {}, "steps_per_s": {}, "gen_digest": {},
           "settings": {}, "pretrain_digest": pretrain_digest,
           "route": eng.step_runner().route, "device": smi}
    path = os.path.join(out_dir, f"f7_s{seed}.json")

    def save():
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)

    t0 = time.time()
    f6._steps(eng, split, {split}, rec, "trunk", seed, False, smi, save)
    rec["wall_s"]["trunk"] = time.time() - t0
    snap = eng.train_state_flat(split)
    sites, was = _site_functions(), torch.backends.cudnn.deterministic
    for br in branches:
        eng.load_train_state_flat(snap)
        eng.drop_step_graph()               # capture under the setting
        rec["gen_digest"][br] = f6.gen_digest(eng)
        rec[br] = []
        t0, captures = time.time(), eng.step_runner().captures
        with branch_setting(br) as seen:
            f6._steps(eng, end, set(marks), rec, br, seed, False, smi, save)
            seen["cudnn_deterministic"] = torch.backends.cudnn.deterministic
            seen["captures"] = eng.step_runner().captures - captures
        eng.drop_step_graph()
        seen["restored"] = (_site_functions() == sites
                            and torch.backends.cudnn.deterministic == was)
        rec["settings"][br] = seen
        rec["wall_s"][br] = time.time() - t0
        rec["steps_per_s"][br] = (end - split) / rec["wall_s"][br]
        save()
    return rec


def _site_functions():
    """The functions branch b swaps out, as the package holds them now."""
    from texpose_tpu_torch.models import losses
    from texpose_tpu_torch.nn import discriminator as disc
    return disc._conv, disc.sn_apply, losses.rgb_to_lab


# ------------------------------------------------------------ the tables

def _last(rows, proto):
    by = {int(r["step"]): r for r in rows}
    return by[max(by)][proto] if by else None


def delta_table(recs, protocols=PROTOCOLS):
    """{seed: {branch: {protocol: Δ = the branch's last mark − the trunk's
    last mark}}} for the branches a seed finished."""
    out = {}
    for seed, rec in sorted(recs.items()):
        base = {p: _last(rec["trunk"], p) for p in protocols}
        out[seed] = {br: {p: _last(rec[br], p) - base[p] for p in protocols}
                     for br in BRANCHES if rec.get(br) and max(
                         int(r["step"]) for r in rec[br]) >= rec["end"]}
    return out


def _mean_se(xs):
    n = len(xs)
    mean = sum(xs) / n
    if n < 2:
        return mean, math.inf
    var = sum((x - mean) ** 2 for x in xs) / (n - 1)
    return mean, math.sqrt(var / n)


def decide(deltas, protocol=RULE_PROTOCOL):
    """The decision rule on ``protocol`` → {branch: {d, mean_d, se_d,
    noise, mean_delta, clauses, accounts}} for b and c, over the seeds
    where a, a2 and the branch finished."""
    out = {}
    for br in ("b", "c"):
        seeds = [s for s, d in deltas.items()
                 if {"a", "a2", br} <= set(d)]
        if not seeds:
            continue
        d = [deltas[s][br][protocol] - deltas[s]["a"][protocol]
             for s in seeds]
        noise = [abs(deltas[s]["a"][protocol] - deltas[s]["a2"][protocol])
                 for s in seeds]
        mean_d, se_d = _mean_se(d)
        mean_noise = sum(noise) / len(noise)
        mean_delta = sum(deltas[s][br][protocol] for s in seeds) / len(seeds)
        clauses = {"mean_d_positive": mean_d > 0,
                   "mean_d_ge_2se": mean_d >= SE_MULT * se_d,
                   "mean_d_above_noise": mean_d > mean_noise,
                   "gate_holds": mean_delta >= GATE_DB}
        out[br] = {"seeds": seeds, "d": dict(zip(seeds, d)),
                   "noise": dict(zip(seeds, noise)), "mean_d": mean_d,
                   "se_d": se_d, "mean_noise": mean_noise,
                   "mean_delta": mean_delta, "clauses": clauses,
                   "accounts": all(clauses.values())}
    return out


def outcome(rule):
    """"b", "c", "both" or "neither" of the branches that account."""
    acc = [br for br in ("b", "c") if rule.get(br, {}).get("accounts")]
    return "both" if len(acc) == 2 else acc[0] if acc else "neither"


def report(recs, out_dir, smi=""):
    """The Δ tables, the rule on both protocols and the outcome →
    F7_H100.json in out_dir; printed."""
    deltas = delta_table(recs)
    rules = {p: decide(deltas, p) for p in PROTOCOLS}
    print(f"\n=== F7 [{smi}] ===", flush=True)
    for seed, rec in sorted(recs.items()):
        for p in PROTOCOLS:
            tr = {int(r["step"]): r[p] for r in rec["trunk"]}
            cells = "; ".join(
                f"{br} " + "/".join(f"{r[p]:.3f}" for r in rec[br])
                + f" Δ {deltas[seed][br][p]:+.3f}"
                for br in BRANCHES if br in deltas[seed])
            print(f"seed {seed} {p}: trunk {tr}; {cells}", flush=True)
        same = len(set(rec["gen_digest"].values())) == 1
        print(f"seed {seed}: steps/s {rec['steps_per_s']}; settings "
              f"{rec['settings']}; draw generators "
              f"{'equal' if same else 'DIFFER'}", flush=True)
    for p, rule in rules.items():
        for br, r in rule.items():
            print(f"{p} branch {br}: d " + " ".join(
                f"s{s} {v:+.3f}" for s, v in r["d"].items())
                + f"; mean d {r['mean_d']:+.4f} (SE {r['se_d']:.4f}), mean "
                f"|Δa − Δa2| {r['mean_noise']:.4f}, seed-mean Δ "
                f"{r['mean_delta']:+.4f}; {r['clauses']} → "
                f"{'accounts' if r['accounts'] else 'does not account'}",
                flush=True)
    kind = outcome(rules[RULE_PROTOCOL])
    print(f"outcome ({RULE_PROTOCOL}): {kind} [{smi}]", flush=True)
    out = {"device": smi, "horizons": horizons(), "protocol": RULE_PROTOCOL,
           "pretrain_digests": sorted({str(r.get("pretrain_digest"))
                                       for r in recs.values()}),
           "seeds": recs, "delta": deltas, "rule": rules, "outcome": kind}
    path = os.path.join(out_dir, "F7_H100.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)
    return out


def adopt_pretrain(src, cache, iters, root, extra):
    """``src`` placed where ``gan_ablate.pretrain`` keeps the pretrain of
    ``iters`` steps, with its stamp, so the runs reuse it."""
    cfg = qc.pretrain_cfg(cache, iters, ["--output_root=" + root, *extra])
    ck = os.path.join(root, str(cfg.group), "pretrain_model.ckpt")
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    shutil.copyfile(src, ck)
    open(ck + f".abl{iters}", "w").close()


def main(argv=None):
    from texpose_tpu_torch.models.base import resolve_device
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--report":
        recs = f6.read_seed_files(argv[1:], "f7")
        return report(recs, argv[1], next(iter(recs.values()))["device"])
    pre = [a for a in argv if a.startswith("--pretrain=")]
    opts, rest = f6.parse([a for a in argv if a not in pre], out="f7")
    name, extra = qc.parse_argv(rest)
    device = resolve_device({"device": name})
    smi = f6._smi()
    seeds = [int(s) for s in opts["seeds"].split(",")]
    out_dir = opts["out"]
    os.makedirs(out_dir, exist_ok=True)
    cache = qc.fixture(64, True)
    root = ga.out_root(True, 64)
    iters = horizons()[0]
    if pre and not opts["child"]:
        adopt_pretrain(pre[0].split("=", 1)[1], cache, iters, root, extra)
    ck = ga.pretrain(cache, iters, device, root, extra)
    kept = os.path.join(out_dir, "pretrain_model.ckpt")
    if not opts["child"] and not os.path.exists(kept):
        shutil.copyfile(ck, kept)
    digest = file_digest(ck)
    procs = int(opts["procs"])
    if opts["child"] or procs <= 1:
        recs = {s: run_seed(cache, s, device, root, extra, out_dir, smi,
                            digest) for s in seeds}
        return recs if opts["child"] else report(recs, out_dir, smi)
    failed = f6.spawn_seeds(__file__, [a for a in argv if a not in pre],
                            seeds, procs, out_dir, "f7")
    out = report(f6.read_seed_files([out_dir], "f7"), out_dir, smi)
    if failed:
        raise SystemExit(f"probe_f7: seed runs failed: {failed}")
    return out


if __name__ == "__main__":
    main()
