#!/usr/bin/env python3
"""F7 on the CPU: the texture GAN stepped in lockstep through the JAX
package's engine and the port's, from one state, at a reduced width.

F7 (ROADMAP Queue 3): under the mean-latent protocol (``psnr_mean``) the
port's texture loses quality between 10k and 20k GAN steps on the card
where the JAX package's on the TPU did not.  This tool asks where the two
engines part when both run the same arithmetic on the same numbers:

  1. a pretrain through the port (``gan_ablate.pretrain``) on the
     fixed-light ``scene_qual`` fixture of quality_check (16 views,
     128x128), at the width below;
  2. JAX's ``TextureGANEngine`` (trunk from that pretrain) set up for the
     ``base`` variant of tools/gan_ablate.py, its whole train state carried
     to the port's engines over the npz bridge (``train_state_flat``
     keypaths) with its VGG weights;
  3. ``--steps`` steps: JAX's jitted step; the port's ``train_step`` fed
     the JAX step's own draws (``jax_draws``, made from the JAX state's key
     chain); and a second port engine on its own draws (``make_draws``),
     whose distance from the first is the spread that the draws alone
     cause;
  4. at each mark (``--marks``), per side: the six latent protocols' PSNR
     over the eval split (the port's ``gan_ablate.mark_eval``, JAX's
     ``run_variant`` protocol), the latent tables' mean row norm and row
     spread (mean distance from the table's mean row),
     ``monitor_latent_drift``, and each pair's distance in the heads and
     in each table, beside how far each side moved from the start.

Both sides compute in float32 on the CPU.  What the CPU cannot reach: the
TPU's default bf16 matmul and convolution precision in JAX's VGG and
discriminator, and cuDNN's nondeterministic backwards on the card.

Run from the root of a checkout (CPU only; imports both packages, as the
tests do):

    python3 tools/lockstep_f7.py [--steps=2000] [--marks=250,500,1000,2000]
        [--pretrain=2000] [--seed=0] [--out=F7_LOCKSTEP_CPU.json]
        [--key=value ...]

``--key=value`` overrides both GAN configs and the pretrain's (a still
smaller width).  The result goes to ``--out``, rewritten after each mark.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (REPO, os.path.join(REPO, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the width: heads 64 wide on a 4-layer 64-wide trunk, batch 4 of the
# config's 16x16 patches (the discriminator's smallest input), 16 samples,
# 16 views; both sides in float32
WIDTH = ["--arch.layers_feat=[null,64,64,64,64]",
         "--arch.layers_rgb=[null,64,3]", "--arch.layers_trans=[null,64,5]",
         "--arch.skip=[2]", "--nerf.sample_intvs=16", "--batch_size=4",
         "--compute_dtype=float32", "--scan_steps=1"]
PRETRAIN = ["--arch.layers_feat=[null,64,64,64,64]",
            "--arch.layers_rgb=[null,64,3]", "--arch.skip=[2]",
            "--nerf.sample_intvs=16", "--nerf.rand_rays=512",
            "--compute_dtype=float32"]
N_VIEWS = 16
VARIANT = "base"
DIST_KEYS = ("heads", "latents/light", "latents/trans")


def parse(argv):
    opts = {"steps": "2000", "marks": "250,500,1000,2000",
            "pretrain": "2000", "seed": "0",
            "out": os.path.join(REPO, "F7_LOCKSTEP_CPU.json")}
    extra = []
    for a in argv:
        key = a[2:].split("=", 1)[0]
        if key in opts and "=" in a:
            opts[key] = a.split("=", 1)[1]
        elif a.startswith("--") and "=" in a:
            extra.append(a)
        else:
            raise SystemExit(f"invalid argument {a!r} (--key=value)")
    return opts, extra


def configs(cache, steps, seed, root, extra):
    """(port config, JAX config) of the ``base`` variant at the width; the
    JAX engine writes under its own name and reads the port's pretrain."""
    from texpose_tpu.utils.config import Config, process_options
    from texpose_tpu_torch.tools import gan_ablate as ga
    cfg = ga.variant_cfg(cache, VARIANT, ga.VARIANTS[VARIANT], steps, seed,
                         root, WIDTH + list(extra))
    jcfg = Config(json.loads(json.dumps(cfg.to_dict())))
    jcfg.pretrain_ckpt = os.path.join(root, str(cfg.group),
                                      "pretrain_model.ckpt")
    jcfg.name = str(cfg.name) + "_jax"
    return cfg, process_options(jcfg)


def jax_engine(jcfg):
    from texpose_tpu.models.texture_gan import TextureGANEngine
    eng = TextureGANEngine(jcfg)
    eng.load_dataset()
    eng.build_networks()
    eng.setup_optimizer()
    eng.restore_pretrained_checkpoint()
    return eng


def port_engine(cfg, jeng, name):
    """A port engine holding the JAX engine's whole train state and VGG."""
    from texpose_tpu.utils.checkpoint import tree_to_flat_dict
    from texpose_tpu_torch.models.texture_gan import TextureGANEngine
    from texpose_tpu_torch.nn.vgg import vgg_from_jax
    from texpose_tpu_torch.tools import quality_check as qc
    from texpose_tpu_torch.utils.config import Config, process_options
    pcfg = Config(json.loads(json.dumps(cfg.to_dict())))
    pcfg.name = str(cfg.name) + name
    eng = qc.start(TextureGANEngine, process_options(pcfg), "cpu")
    eng.load_train_state_flat(tree_to_flat_dict(
        dict(jeng.state, step=np.int32(0))))
    eng.vgg = vgg_from_jax(jeng.vgg_params)
    return eng


def jax_flat(jeng):
    from texpose_tpu.utils.checkpoint import tree_to_flat_dict
    return {k: np.array(v) for k, v in tree_to_flat_dict(jeng.state).items()}


def parts(flat):
    """{heads, latents/light, latents/trans} → the concatenated float64
    vector of each (the bridge's keypaths)."""
    heads = sorted(k for k in flat if k.startswith(
        ("params/nerf/mlp_rgb/", "params/nerf/mlp_trans/")))
    out = {"heads": np.concatenate([np.asarray(flat[k], np.float64).ravel()
                                    for k in heads])}
    for t in ("light", "trans"):
        out[f"latents/{t}"] = np.asarray(flat[f"latents/{t}"],
                                         np.float64).ravel()
    return out


def table_stats(tab):
    """Per table: the mean row norm and the row spread (mean distance of a
    row from the table's mean row)."""
    out = {}
    for name, t in tab.items():
        t = np.asarray(t, np.float64)
        out[f"latent_{name}_norm_mean"] = float(
            np.linalg.norm(t, axis=1).mean())
        out[f"latent_{name}_spread"] = float(
            np.linalg.norm(t - t.mean(0, keepdims=True), axis=1).mean())
    return out


def jax_mark_eval(eng):
    """The mark evaluation of tools/gan_ablate.py's ``run_variant``: the
    config's latent protocol, then anchor, mean, topk8 and the two robust
    top-8 aggregators on the same state."""
    ev = dict(eng.evaluate_full())
    prev_light = eng.cfg.render.get("light", "topk_mean")
    prev_k = int(eng.cfg.render.N_candidate)
    for tag, light, k in (("anchor", "anchor", prev_k),
                          ("mean", "mean", prev_k),
                          ("topk8", "topk_mean", 8),
                          ("topk8med", "topk_median", 8),
                          ("topk8rob", "topk_robust", 8)):
        eng.cfg.render.light = light
        eng.cfg.render.N_candidate = k
        e2 = eng.evaluate_full()
        ev[f"psnr_{tag}"], ev[f"ssim_{tag}"] = e2["psnr"], e2["ssim"]
    eng.cfg.render.light = prev_light
    eng.cfg.render.N_candidate = prev_k
    return ev


def mark_record(side, eng, it):
    from texpose_tpu_torch.tools import gan_ablate as ga
    if side == "jax":
        ev = jax_mark_eval(eng)
        tab = {k: np.asarray(v) for k, v in eng._host_latents_table().items()}
    else:
        ev = ga.mark_eval(eng)
        tab = eng._host_latents_table()
    drift = eng.monitor_latent_drift(it)
    return {"step": it, **{k: float(v) for k, v in ev.items()},
            **table_stats(tab),
            "drift": {k: float(v) for k, v in drift.items()}}


def distances(flats, start):
    """Each pair's distance per part, beside how far each side moved from
    the start: {pair: {part: {dist, moved_a, moved_b, rel}}}."""
    p = {s: parts(f) for s, f in flats.items()}
    p0 = parts(start)
    out = {}
    for a, b in (("port", "jax"), ("port_own", "jax"), ("port_own", "port")):
        out[f"{a}-{b}"] = {}
        for k in DIST_KEYS:
            d = float(np.linalg.norm(p[a][k] - p[b][k]))
            ma = float(np.linalg.norm(p[a][k] - p0[k]))
            mb = float(np.linalg.norm(p[b][k] - p0[k]))
            out[f"{a}-{b}"][k] = {"dist": d, "moved_a": ma, "moved_b": mb,
                                  "rel": d / max(ma, mb, 1e-30)}
    return out


def read_d(rec):
    """(d) of the F7 rule (PERF.md §6, PR 17) on the result: at the last
    mark, the lockstep sides' |Δ psnr_mean| (port − JAX) under the spread
    the own-draws run shows (|port_own − port|), and psnr_mean parting (its
    |Δ| past that mark's spread) no sooner than psnr_topk8 does."""
    marks = [r["step"] for r in rec["sides"]["jax"]]

    def at(side, field):
        return [r[field] for r in rec["sides"][side]]

    def first_part(field):
        lock = np.abs(np.subtract(at("port", field), at("jax", field)))
        spread = np.abs(np.subtract(at("port_own", field),
                                    at("port", field)))
        hit = [m for m, d, s in zip(marks, lock, spread) if d > s]
        return (hit[0] if hit else None), lock, spread

    mean_first, lock_mean, spread_mean = first_part("psnr_mean")
    top_first, lock_top, spread_top = first_part("psnr_topk8")
    under = bool(lock_mean[-1] < spread_mean[-1])
    not_sooner = mean_first is None or (top_first is not None
                                        and mean_first >= top_first)
    return {"mark": marks[-1],
            "lockstep_dpsnr_mean": float(lock_mean[-1]),
            "own_draws_spread_psnr_mean": float(spread_mean[-1]),
            "lockstep_dpsnr_topk8": float(lock_top[-1]),
            "own_draws_spread_psnr_topk8": float(spread_top[-1]),
            "psnr_mean_first_parts_at": mean_first,
            "psnr_topk8_first_parts_at": top_first,
            "holds": under and not_sooner}


def run(opts, extra, log=print):
    """The lockstep run → its result dict (also written to opts["out"])."""
    import jax
    import torch
    from texpose_tpu_torch.tools import gan_ablate as ga
    from texpose_tpu_torch.tools import quality_check as qc
    from test_torch_train_step import jax_draws
    jax.config.update("jax_platforms", "cpu")
    steps, seed = int(opts["steps"]), int(opts["seed"])
    marks = sorted(int(m) for m in opts["marks"].split(",")
                   if int(m) <= steps)
    t_all = time.time()
    cache = qc.fixture(N_VIEWS, True)
    root = os.path.join(tempfile.gettempdir(), "texpose_lockstep_f7")
    t0 = time.time()
    ga.pretrain(cache, int(opts["pretrain"]), "cpu", root,
                PRETRAIN + list(extra))
    t_pre = time.time() - t0
    cfg, jcfg = configs(cache, steps, seed, root, extra)
    jeng = jax_engine(jcfg)
    engines = {"jax": jeng, "port": port_engine(cfg, jeng, "_port"),
               "port_own": port_engine(cfg, jeng, "_own")}
    start = jax_flat(jeng)
    key = start["key"]                  # the step donates the state's own
    n_train = len(jeng.train_data)
    rec = {"tool": "tools/lockstep_f7.py", "variant": VARIANT,
           "width": WIDTH + list(extra), "pretrain_width": PRETRAIN
           + list(extra), "fixture": {"n_train": N_VIEWS,
                                      "fixed_light": True,
                                      **qc.FIXTURE},
           "pretrain_steps": int(opts["pretrain"]), "steps": steps,
           "marks": marks, "seed": seed, "torch_threads":
           torch.get_num_threads(),
           "sides": {s: [] for s in engines}, "distance": {},
           "losses": {s: [] for s in engines},
           "wall_s": {"pretrain": t_pre, "jax": 0.0, "port": 0.0,
                      "port_own": 0.0, "marks": 0.0}}
    for it in range(steps):
        key, draws = jax_draws(cfg, key, n_train, it)
        t0 = time.time()
        jeng.state, jloss = jeng.step_fn(jeng.state, jeng.train_batch)
        jloss = {k: float(v) for k, v in jloss.items()}
        rec["wall_s"]["jax"] += time.time() - t0
        t0 = time.time()
        ploss = engines["port"].train_step(draws)
        rec["wall_s"]["port"] += time.time() - t0
        t0 = time.time()
        oloss = engines["port_own"].train_step(
            engines["port_own"].make_draws(it))
        rec["wall_s"]["port_own"] += time.time() - t0
        done = it + 1
        if done not in marks:
            continue
        t0 = time.time()
        for side, loss in (("jax", jloss), ("port", ploss),
                           ("port_own", oloss)):
            rec["losses"][side].append(
                {"step": done, **{k: float(v) for k, v in loss.items()}})
            rec["sides"][side].append(mark_record(side, engines[side], done))
        flats = {"jax": jax_flat(jeng),
                 "port": engines["port"].train_state_flat(done),
                 "port_own": engines["port_own"].train_state_flat(done)}
        rec["distance"][str(done)] = distances(flats, start)
        rec["wall_s"]["marks"] += time.time() - t0
        rec["wall_s"]["total"] = time.time() - t_all
        rec["d"] = read_d(rec)
        row = "  ".join(
            f"{s} mean {rec['sides'][s][-1]['psnr_mean']:.3f} topk8 "
            f"{rec['sides'][s][-1]['psnr_topk8']:.3f}" for s in engines)
        lat = rec["distance"][str(done)]["port-jax"]
        log(f"@{done}: {row}; port-jax heads rel "
            f"{lat['heads']['rel']:.3g}, light rel "
            f"{lat['latents/light']['rel']:.3g} "
            f"({rec['wall_s']['total']:.0f} s)")
        with open(opts["out"], "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    opts, extra = parse(list(sys.argv[1:] if argv is None else argv))
    rec = run(opts, extra, log=lambda s: print(s, flush=True))
    print(json.dumps({"d": rec["d"], "wall_s": rec["wall_s"]}), flush=True)
    return rec


if __name__ == "__main__":
    main()
