"""Long-horizon quality protocol of the texture GAN (the JAX package's
tools/gan_ablate.py): one pretrain, then each variant's GAN run evaluated
at several horizons under six render-time latent protocols, over seeds.

    python -m texpose_tpu_torch.tools.gan_ablate              (the card)
    python -m texpose_tpu_torch.tools.gan_ablate --device=cpu
    python -m texpose_tpu_torch.tools.gan_ablate --merge a.json b.json

Variants (config overrides the engine reads; a bare key is a loss weight):
  base    - shipping defaults (feat=-2, no lab, no latent_reg)
  latreg  - + loss_weight.latent_reg=-2 (L2 on per-image latents)
  lab     - + loss_weight.lab=0 (chromaticity anchor against adversarial
            color drift)
  nofeat  - loss_weight.feat=None (no random-VGG perceptual term)
  and the combinations and controls of ``VARIANTS``.

Env: ABL_PRETRAIN_ITERS (steps, default 20000), ABL_GAN_ITERS (default
20000), ABL_EVAL_AT (comma steps, default "2000,10000,20000"),
ABL_VARIANTS (default base,latreg,lab,nofeat), ABL_SEEDS (default 0),
ABL_FIXED_LIGHT=1 (one light for every view), ABL_NTRAIN (views, default
16), ABL_JSON (the result file, in QUAL_r5.json's schema, rewritten after
each seed's run).  ``--merge`` writes ABL_JSON from several result files
(one per seed, say) over the same fixture.  Other ``--key=value``
arguments override every stage's config (a run at a reduced width).

The pretrain runs once per temp directory and step count (a stamp file
beside its checkpoint) and is reused by later runs and seeds.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

from . import quality_check as qc

VARIANTS = {
    "base": {},
    "latreg": {"latent_reg": -2},
    "lab": {"lab": 0},
    "nofeat": {"feat": None},
    "latreg_lab": {"latent_reg": -2, "lab": 0},
    # D gets the same 10x staircase lr decay as G
    "dlr": {"optim_disc.lr_end": 1.e-5},
    "latreg_dlr": {"latent_reg": -2, "optim_disc.lr_end": 1.e-5},
    # control: train under GT poses (noisy-pose misalignment x texture
    # sharpening vs training pathology)
    "gtpose": {"data.pose_source": "gt"},
    # eval side: EMA shadow of the latent tables
    "ema": {"render.latent_ema": 0.999},
    "ema_latreg": {"render.latent_ema": 0.999, "latent_reg": -2},
    # a latent-specific learning rate
    "latlr": {"optim.lr_latent": 1.e-4},
    "latlr3": {"optim.lr_latent": 3.e-4},
    # pull each image's latents toward the stop-gradient mean of its
    # pose-neighbourhood
    "nbrreg": {"latent_nbr_reg": -2},
    "nbrreg1": {"latent_nbr_reg": -1},
}

# the render-time latent protocols evaluated at each mark besides the
# config default: (tag, render.light, N_candidate or None for the config's)
MARK_PROTOCOLS = (("anchor", "anchor", None), ("mean", "mean", None),
                  ("topk8", "topk_mean", 8),
                  ("topk8med", "topk_median", 8),
                  ("topk8rob", "topk_robust", 8))
PROTOCOLS = ("psnr", "psnr_anchor", "psnr_mean", "psnr_topk8",
             "psnr_topk8med", "psnr_topk8rob")
DRIFT_PROTOCOLS = ("psnr_topk8", "psnr_topk8med", "psnr_topk8rob", "psnr")


def out_root(fixed_light, n_train):
    return os.path.join(
        tempfile.gettempdir(),
        f"texpose_qual_torch_fl{n_train}" if fixed_light
        else "texpose_qual_torch")


def _set_dotted(cfg, key, value):
    node = cfg
    parts = key.split(".")
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def pretrain(cache, iters, device, root, overrides=()):
    """The pretrain of ``iters`` steps → the group's pretrain_model.ckpt
    under ``root``; reused when its stamp exists."""
    from ..models.pretrain import PretrainEngine
    cfg = qc.pretrain_cfg(cache, iters, ["--output_root=" + root,
                                         *overrides])
    ck = os.path.join(root, str(cfg.group), "pretrain_model.ckpt")
    stamp = ck + f".abl{iters}"
    if os.path.exists(stamp):
        print(f"PRETRAIN: reusing {ck}", flush=True)
        return ck
    eng = qc.start(PretrainEngine, cfg, device)
    qc.sync(eng.device)
    t0 = time.time()
    for _, K, loss in qc.dispatches(eng, iters):
        pass
    last = float(loss["all"])
    qc.sync(eng.device)
    print(f"PRETRAIN: {iters} steps in {time.time() - t0:.1f} s (scan {K}; "
          f"{eng.step_runner().route}), loss={last:.4f} "
          f"val={eng.validate(iters)}", flush=True)
    qc.save_pretrain(eng, iters, ck)
    open(stamp, "w").close()
    return ck


def variant_cfg(cache, name, overrides, iters, seed, root, extra=()):
    """The GAN config of variant ``name`` (its ``overrides``) and seed."""
    cfg = qc.base("nerf_lm_adapt_gan.yaml", cache)
    cfg.output_root = root
    cfg.data.scene = "scene_qual"
    cfg.nerf.depth.box_source = "pred_box_init_calib"
    cfg.max_iter = iters
    cfg.name = f"abl_{name}"
    cfg.seed = seed
    cfg.resume_pretrain = True
    for k, v in overrides.items():
        if "." in k:
            _set_dotted(cfg, k, v)
        else:
            cfg.loss_weight[k] = v
    return qc.finish(cfg, extra)


def mark_eval(eng):
    """evaluate_full under the config's latent protocol, then under each
    of MARK_PROTOCOLS on the same state → {psnr, ssim, psnr_<tag>,
    ssim_<tag>}.  The protocol is a render-time choice, so every one is
    measured on the same training run."""
    ev = dict(eng.evaluate_full())
    render = eng.cfg.render
    prev_light = render.get("light", "topk_mean")
    prev_k = int(render.N_candidate)
    for tag, light, k in MARK_PROTOCOLS:
        render.light = light
        render.N_candidate = k or prev_k
        e2 = eng.evaluate_full()
        ev[f"psnr_{tag}"], ev[f"ssim_{tag}"] = e2["psnr"], e2["ssim"]
    render.light = prev_light
    render.N_candidate = prev_k
    return ev


def run_variant(cache, name, overrides, iters, eval_at, device, root,
                seed=0, extra=()):
    """One GAN run from the pretrain's trunk → [(mark, eval dict)], each
    mark evaluated after its step."""
    from ..models.texture_gan import TextureGANEngine
    cfg = variant_cfg(cache, name, overrides, iters, seed, root, extra)
    eng = qc.start(TextureGANEngine, cfg, device)
    eng.restore_pretrained_checkpoint()
    marks = sorted(m for m in eval_at if m <= iters)
    results = []
    qc.sync(eng.device)
    t0 = time.time()
    t_eval = 0.0
    mi = 0
    for it, K, loss in qc.dispatches(eng, iters):
        done = it + K
        # a mark fires at the first dispatch boundary at or past it, and
        # records the real step count
        if mi < len(marks) and done >= marks[mi]:
            # the losses' host copy waits for the dispatch's kernels
            cur = {k: round(float(v), 4) for k, v in sorted(loss.items())}
            t1 = time.time()
            ev = mark_eval(eng)
            t_eval += time.time() - t1
            ev["step_actual"] = done
            results.append((marks[mi], ev))
            print(f"  [{name}] @{marks[mi]:6d} (real {done}): "
                  f"psnr={ev['psnr']:.2f} ssim={ev['ssim']:.3f} ref-anchor "
                  f"{ev['psnr_anchor']:.2f}/{ev['ssim_anchor']:.3f} "
                  f"({done / (time.time() - t0 - t_eval):.1f} it/s "
                  f"training) loss={cur}", flush=True)
            mi += 1
    host = {k: float(v) for k, v in loss.items()}
    qc.sync(eng.device)
    wall = time.time() - t0
    print(f"  [{name}] seed {seed}: {iters} steps in {wall:.1f} s "
          f"({wall - t_eval:.1f} s training, {t_eval:.1f} s at the "
          f"{len(marks)} marks; scan {K}, {eng.step_runner().route})",
          flush=True)
    qc.check(all(np.isfinite(v) for v in host.values()),
             f"non-finite loss in variant {name}: {host}")
    return results


def _means(rows_by_seed, field="psnr"):
    """mark -> mean <field> across seeds."""
    marks = [m for m, _ in next(iter(rows_by_seed.values()))]
    return {m: float(np.mean([dict(rows)[m][field]
                              for rows in rows_by_seed.values()]))
            for m in marks}


def print_summary(table):
    seeds = {s for rbs in table.values() for s in rbs}
    print("\n=== SUMMARY (psnr by real step; mean over "
          f"{len(seeds)} seed(s)) ===", flush=True)
    for name, rows_by_seed in table.items():
        for field in PROTOCOLS:
            try:
                mean = _means(rows_by_seed, field)
            except KeyError:
                continue
            cells = "  ".join(f"@{m}: {v:.2f}" for m, v in mean.items())
            per_seed = "; ".join(
                f"s{s}: " + "/".join(f"{dict(rows)[m][field]:.2f}"
                                     for m in sorted(dict(rows)))
                for s, rows in rows_by_seed.items())
            print(f"{name:10s} {field:12s} {cells}   [{per_seed}]",
                  flush=True)


def _gates(by_mark):
    g = {}
    if {2000, 10000} <= set(by_mark):
        g["gate_10k_ge_2k"] = bool(by_mark[10000] >= by_mark[2000])
    if {10000, 20000} <= set(by_mark):
        g["gate_20k_ge_10k_minus_1db"] = bool(
            by_mark[20000] >= by_mark[10000] - 1.0)
    return g


def _drift(rows_by_seed):
    """Per-seed peak-to-20k decline and the cross-seed 20k spread by
    protocol, psnr_topk8 on top."""
    by_proto = {}
    for f in DRIFT_PROTOCOLS:
        per_seed, vals_20k = {}, []
        for seed, rows in rows_by_seed.items():
            d = dict(rows)
            if 20000 not in d or f not in d[20000]:
                continue
            peak = max(ev[f] for ev in d.values())
            per_seed[str(seed)] = {
                "psnr_20k": round(float(d[20000][f]), 4),
                "decline_from_peak": round(float(peak - d[20000][f]), 4)}
            vals_20k.append(float(d[20000][f]))
        if vals_20k:
            by_proto[f] = {"per_seed": per_seed,
                           "spread_20k": round(max(vals_20k)
                                               - min(vals_20k), 4)}
    if "psnr_topk8" not in by_proto:
        return None
    top = by_proto["psnr_topk8"]
    return {"per_seed": top["per_seed"], "spread_20k": top["spread_20k"],
            "protocol": "psnr_topk8", "by_protocol": by_proto}


def summarize(table, fixture):
    """The result file (QUAL_r5.json's schema) of ``table`` {variant:
    {seed: [(mark, eval dict)]}}: per-seed rows, seed means, per-protocol
    seed-mean gates of the first variant (the shipped defaults), per-seed
    20k declines and the top-level gates on the config-default protocol."""
    out = {
        "fixture": fixture,
        "variants": {
            name: {str(seed): [{"step": m,
                                **{k: round(float(v), 4)
                                   for k, v in ev.items()}}
                               for m, ev in rows]
                   for seed, rows in rows_by_seed.items()}
            for name, rows_by_seed in table.items()},
        "mean_psnr": {name: {str(m): round(v, 4)
                             for m, v in _means(rbs).items()}
                      for name, rbs in table.items()},
    }
    first = table[next(iter(table))]
    proto_gates = {}
    for field in PROTOCOLS:
        try:
            bm = _means(first, field)
        except KeyError:
            continue
        proto_gates[field] = {
            "mean_psnr": {str(m): round(v, 4) for m, v in bm.items()},
            **_gates(bm)}
    out["protocol_gates"] = proto_gates
    out["drift_20k"] = {name: d for name, d in
                        ((n, _drift(rbs)) for n, rbs in table.items())
                        if d is not None}
    out.update(_gates(_means(first)))
    return out


def table_from_json(doc):
    """The {variant: {seed: [(mark, eval dict)]}} table of a result
    file."""
    return {name: {int(seed): [(r["step"], {k: v for k, v in r.items()
                                            if k != "step"})
                               for r in rows]
                   for seed, rows in by_seed.items()}
            for name, by_seed in doc["variants"].items()}


def merge_files(paths):
    """One result over the seeds of several result files of the same
    fixture and horizons (a later file's seed replaces an earlier's)."""
    docs = [json.load(open(p)) for p in paths]
    keep = ("fixed_light", "n_train", "pretrain_iters", "gan_iters")
    fix = {k: docs[0]["fixture"][k] for k in keep}
    for d, p in zip(docs, paths):
        if {k: d["fixture"][k] for k in keep} != fix:
            raise ValueError(f"{p}: fixture {d['fixture']} differs from "
                             f"{docs[0]['fixture']}")
    table = {}
    for d in docs:
        for name, rbs in table_from_json(d).items():
            table.setdefault(name, {}).update(rbs)
    table = {n: dict(sorted(rbs.items())) for n, rbs in table.items()}
    fix["seeds"] = sorted({s for rbs in table.values() for s in rbs})
    return table, fix


def write_json(path, out):
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)


def main(argv=None):
    """The protocol on the card (``--device=cpu`` for the CPU) → its
    result dict; or, with ``--merge``, the merge of result files."""
    from ..models.base import resolve_device
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--merge":
        table, fix = merge_files(argv[1:])
        out = summarize(table, fix)
        print_summary(table)
        write_json(os.environ["ABL_JSON"], out)
        return out
    name, extra = qc.parse_argv(argv)
    device = resolve_device({"device": name})
    fixed_light = os.environ.get("ABL_FIXED_LIGHT") == "1"
    n_train = int(os.environ.get("ABL_NTRAIN", "16"))
    cache = qc.fixture(n_train, True) if fixed_light else qc.fixture()
    root = out_root(fixed_light, n_train)
    p_iters = int(os.environ.get("ABL_PRETRAIN_ITERS", "20000"))
    g_iters = int(os.environ.get("ABL_GAN_ITERS", "20000"))
    eval_at = [int(x) for x in os.environ.get(
        "ABL_EVAL_AT", "2000,10000,20000").split(",")]
    names = os.environ.get("ABL_VARIANTS",
                           "base,latreg,lab,nofeat").split(",")
    seeds = [int(s) for s in os.environ.get("ABL_SEEDS", "0").split(",")]
    fix = {"fixed_light": fixed_light, "n_train": n_train,
           "pretrain_iters": p_iters, "gan_iters": g_iters, "seeds": seeds}
    pretrain(cache, p_iters, device, root, extra)
    table, out = {}, None
    for name in names:
        for seed in seeds:
            print(f"=== variant {name} seed {seed} ({VARIANTS[name]}) ===",
                  flush=True)
            table.setdefault(name, {})[seed] = run_variant(
                cache, name, VARIANTS[name], g_iters, eval_at, device, root,
                seed=seed, extra=extra)
            done = [s for s in seeds
                    if any(s in rbs for rbs in table.values())]
            out = summarize(table, dict(fix, seeds=done))
            if os.environ.get("ABL_JSON"):
                write_json(os.environ["ABL_JSON"], out)
    print_summary(table)
    return out


if __name__ == "__main__":
    main()
