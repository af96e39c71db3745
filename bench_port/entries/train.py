"""A training cell: ``engine.step_runner().dispatch(K)`` back to back, K =
the engine's ``scan_k()``, each step one replay of the captured step on a
card.

Set-up: the data from the seed, the engine, the benchmark's weights; the
runner's eager warm-up steps, then ``compared_steps`` more, all as
single-step dispatches of the window's call (the first past the warm-up
captures the step), their draws, losses and states kept for the check;
one warm dispatch of K.  The window counts the
steps of every dispatch it ran and their rays.  The check runs the plain
reference (``bench_port/reference/<reference>.py``) from the same weights
over the same steps, the warm-up's and the compared, with the same draws, on the
train split as the reference's own loader reads it from the files.
"""

from __future__ import annotations

import importlib
import json
import time

import torch

from ..lib import compare, engine, fixture, trace, weights


class Cell:
    def __init__(self, spec, seed, device, workdir, log):
        self.spec, self.seed, self.device = spec, seed, device
        self.workdir, self.log = workdir, log
        self.work = spec["workload"]

    def setup(self):
        traffic = self.work["traffic"]
        st = engine.Stages(self.device)
        root = fixture.cell_data(self.spec, self.seed, self.workdir)
        st.mark("data generation")
        cfg = engine.build_cfg(self.spec, root, self.workdir, self.seed)
        self.plain_cfg = engine.plain(cfg)
        eng = self.eng = engine.make_engine(cfg, self.device, st)
        n_img = len(eng.train_data)
        self.plain_cfg["n_images"] = n_img
        W = weights.make_weights(self.plain_cfg, self.seed, self.device,
                                 n_images=n_img if eng.latents else None)
        engine.load_weights(eng, W)
        st.mark("weights")
        self.frozen = {k: v for k, v in W.items()
                       if k.startswith(tuple(self.work["frozen"]))}
        self.rays = eng.rays_per_step()
        self.shapes = {"kind": self.work["kind"], "B": int(cfg.batch_size),
                       "p": int(cfg.get("patch_size") or 0),
                       "N": int(cfg.nerf.sample_intvs), "rays": self.rays}
        keep = {}

        def draws(it):
            keep["d"] = eng.make_draws(it)
            return keep["d"]

        from texpose_tpu_torch.models import step_graph
        runner = self.runner = eng.step_runner()
        self.warm = int(getattr(step_graph, "WARMUP_STEPS", 0))
        self.it0 = eng.it
        prog = {"init": engine.snapshot(eng), "losses": [], "draws": []}
        for j in range(self.warm + int(self.work["compared_steps"])):
            if j == self.warm:
                st.mark("eager warm-up steps (kernel builds on a cold "
                        "checkout)")
                prog["start"] = engine.snapshot(eng)
            loss = runner.dispatch(1, draws)
            prog["losses"].append({k: float(v) for k, v in loss.items()})
            prog["draws"].append({k: v.clone() for k, v in
                                  keep["d"].items()})
            if j == 0:
                prog["first"] = engine.snapshot(eng)
        prog["end"] = engine.snapshot(eng)
        self.prog = prog
        from ..reference import data
        self.batch = {k: torch.as_tensor(v, device=self.device) for k, v in
                      data.Split(self.plain_cfg, "train").stacked().items()}
        st.mark("compared steps (the first captures the step)")
        self.K = eng.scan_k()
        runner.dispatch(self.K)
        st.mark("warm dispatch")
        self.log(f"{runner.route}; K = {self.K}; {self.rays} rays a step")
        self.log(f"set-up stages: {st.s}")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds):
        self._sync()
        t0 = time.perf_counter()
        n = 0
        while True:
            loss = self.runner.dispatch(self.K)
            n += self.K
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        dt = time.perf_counter() - t0
        bad = [k for k, v in loss.items() if not torch.isfinite(v).item()]
        return {"seconds": dt, "units": n, "steps": n,
                "rays": n * self.rays, "K": self.K,
                "failed": self.K if bad else 0}

    def trace(self, needs):
        eng, stages = self.eng, None
        if "stages" in needs:
            targets = [(importlib.import_module(m), f, st)
                       for m, f, st in self.work["stages"]]
            self._sync()
            with trace.staged(targets):
                events = trace.profile(
                    lambda: eng.train_step(eng.make_draws(eng.it)))
            stages = trace.aligner(events)
            self.runner.dispatch(2)
        self._sync()
        events = trace.profile(lambda: self.runner.dispatch(self.K))
        return trace.TraceView(events, self.K, stages)

    def release(self):
        self.eng = self.runner = None

    def check(self):
        """The compared steps against the reference → [(name, gap,
        limit)]."""
        ref, prog = self.reference()
        return self.checks(prog, ref)

    def checks(self, prog, ref):
        """[(name, gap, limit)] of ``prog``'s records against ``ref``'s,
        one for each limit of the workload file."""
        gaps, details = compare.training_checks(
            prog, ref, self.ref_mod.ADAM[0],
            getattr(self.ref_mod, "RMSPROP", (0.0,))[0],
            self.work.get("loss_steps"), self.work.get("groups"))
        self.log(f"comparison: {gaps} {details}")
        return [(k, gaps[k], float(v))
                for k, v in self.work["limits"].items()]

    def reference(self, prec=None, halve=False, cfg=None):
        """The reference → (its records, the program's records): from the
        benchmark's weights through the eager warm-up steps (to
        ``warm_end``, also ``start``) and on through the compared steps,
        with the program's draws; its records carry the program's keys
        too, so that one put in the program's place is compared as the
        program.  ``halve``: each step on the first half of its
        batch (the fault of a step that leaves half the batch out, read in
        the reference's place); ``cfg``: {dotted key: value} over the
        configuration (a fault planted in the reference, as a loss term's
        weight)."""
        from ..reference import ops
        self.ref_mod = importlib.import_module(
            f"bench_port.reference.{self.work['reference']}")
        prec = prec or ops.Precision(self.plain_cfg["compute_dtype"])
        plain_cfg = self.plain_cfg
        if cfg:
            plain_cfg = json.loads(json.dumps(plain_cfg))
            for key, v in cfg.items():
                node = plain_cfg
                *head, last = key.split(".")
                for p in head:
                    node = node[p]
                node[last] = v

        def step(state, count, d):
            batch = self.batch
            if halve:
                batch, d = self.ref_mod.halve(batch, d)
            return self.ref_mod.step(state, count, batch, d, plain_cfg, prec)

        state = dict(self.prog["init"])
        state.update(self.frozen)
        ref = {"init": self.prog["init"], "losses": []}
        for j, d in enumerate(self.prog["draws"]):
            if j == self.warm:
                ref["start"] = ref["warm_end"] = state
            state, losses, grads = step(state, self.it0 + j, d)
            ref["losses"].append({k: float(v) for k, v in losses.items()})
            if j == 0:
                ref["grads1"], ref["first"] = grads, state
        ref["end"] = state
        return ref, self.prog
