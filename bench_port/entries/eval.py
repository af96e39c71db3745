"""An evaluation cell: ``engine.evaluate_full()`` over a cycled test split,
called back to back; on a card each frame is one replay of its captured
frame program, loads on the prefetch worker and PNG encodes on the
writer.

Set-up: the data from the seed (the test frames cycled to ``frames``);
the evaluation engine at the traffic's crop with the benchmark's weights
from the seed and its LPIPS network; one warm sweep, which captures the
frame program.  The window counts the frames of every whole sweep.  The
check reads a seeded sample of the last sweep's frames back — the RGB and
opacity PNGs and the quant.txt row — and the plain reference renders and
scores each frame from the same weights and the frame's inputs as its own
loader reads them from the files.
"""

from __future__ import annotations

import os
import time

import cv2
import numpy as np
import torch

from ..lib import engine, fixture, trace, weights


class Cell:
    def __init__(self, spec, seed, device, workdir, log):
        self.spec, self.seed, self.device = spec, seed, device
        self.workdir, self.log = workdir, log
        self.work = spec["workload"]

    def setup(self):
        traffic = self.work["traffic"]
        st = engine.Stages(self.device)
        root = fixture.cell_data(self.spec, self.seed, self.workdir)
        scene = fixture.cycle_test_split(root, traffic["fixture"]["scene"],
                                         int(traffic["frames"]))
        st.mark("data generation")
        cfg = engine.build_cfg(self.spec, root, self.workdir, self.seed,
                               {"data.scene": scene})
        self.plain_cfg = engine.plain(cfg)
        eng = self.eng = engine.make_engine(cfg, self.device, st,
                                            train=False, eval_split="test")
        self.weights = weights.make_weights(self.plain_cfg, self.seed,
                                            self.device, lpips=True)
        engine.load_weights(eng, self.weights)
        st.mark("weights")
        self.frames = len(eng.eval_data)
        self.shapes = {"kind": self.work["kind"], "H": cfg.H, "W": cfg.W,
                       "N": int(cfg.nerf.sample_intvs)}
        rows = np.random.default_rng(self.seed).choice(
            self.frames, int(self.work["checked_frames"]), replace=False)
        from ..reference import data
        split = data.Split(self.plain_cfg, "test")
        self.samples = {int(i): split.sample(int(i)) for i in rows}
        eng.evaluate_full()
        st.mark("warm sweep (captures the frame program)")
        self.log(f"{self.frames} frames a sweep at {cfg.H}x{cfg.W}; "
                 f"checked rows {sorted(self.samples)}")
        self.log(f"set-up stages: {st.s}")

    def window(self, seconds):
        t0 = time.perf_counter()
        n, sweeps = 0, []
        while True:
            t = time.perf_counter()
            self.eng.evaluate_full()
            sweeps.append(time.perf_counter() - t)
            n += self.frames
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.log(f"sweep seconds: {sweeps}")
        rows = self.quant()
        bad = sum(1 for r in rows.values()
                  if not all(np.isfinite(v) for v in r.values()))
        return {"seconds": dt, "units": n, "frames": n,
                "failed": bad * (n // self.frames)}

    def quant(self):
        """quant.txt's rows {i: {column: value}}."""
        path = os.path.join(self.plain_cfg["output_path"], "quant.txt")
        with open(path) as f:
            head = f.readline().split()[2:]
            return {int(p[0]): dict(zip(head, map(float, p[1:])))
                    for p in (ln.split() for ln in f) if p}

    def trace(self, needs):
        events = trace.profile(self.eng.evaluate_full)
        return trace.TraceView(events, self.frames)

    def release(self):
        self.eng = None

    def check(self):
        """The sampled frames against the reference → [(name, worst gap,
        limit)]."""
        return self.checks(self.program_outputs(), self.reference())

    def checks(self, prog, ref):
        """[(name, worst gap, limit)] of ``prog``'s frames against
        ``ref``'s: the mean |Δ| of the RGB and opacity PNGs in 8-bit
        levels (the opacity's only logged: sound runs and the control read
        alike there), and |Δ| of PSNR (dB), SSIM and LPIPS."""
        lim = self.work["limits"]
        gaps = [{"rgb_lsb": float(np.abs(p["rgb"] - r["rgb"]).mean()),
                 "opacity_lsb": float(np.abs(p["opacity"]
                                             - r["opacity"]).mean()),
                 "psnr_db": abs(p["psnr"] - r["psnr"]),
                 "ssim": abs(p["ssim"] - r["ssim"]),
                 "lpips": abs(p["lpips"] - r["lpips"])}
                for p, r in zip(prog, ref)]
        self.log("frame gaps: " + str(gaps))
        return [(k, max(g[k] for g in gaps), float(lim[k]))
                for k in ("rgb_lsb", "psnr_db", "ssim", "lpips")]

    def program_outputs(self):
        """The sampled frames as the last sweep left them: the PNGs (8-bit
        levels, float64) and the quant.txt row."""
        rows = self.quant()
        out_dir = self.plain_cfg["output_path"]
        got = []
        for i, s in sorted(self.samples.items()):
            fi = int(s["frame_index"])
            png = cv2.imread(os.path.join(out_dir, "rgb", f"{fi:06d}.png"),
                             cv2.IMREAD_UNCHANGED)[..., ::-1]
            op = cv2.imread(os.path.join(out_dir, "opacity", f"{fi:06d}.png"),
                            cv2.IMREAD_UNCHANGED)
            row = rows[i]
            lp = next(k for k in row if k.startswith("lpips"))
            got.append({"rgb": png.astype(np.float64),
                        "opacity": op.astype(np.float64),
                        "psnr": row["psnr"], "ssim": row["ssim"],
                        "lpips": row[lp]})
        return got

    def reference(self, prec=None):
        """The reference's render and scores of the sampled frames from
        the same weights and each frame's inputs as the reference's loader
        reads them, its PNG levels as the program forms them."""
        from ..reference import ops, pretrain
        prec = prec or ops.Precision(self.plain_cfg["compute_dtype"])
        H, Wd = self.shapes["H"], self.shapes["W"]
        got = []
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=self.device)

        for i, s in sorted(self.samples.items()):
            rgb, opac = pretrain.render_frame(
                self.weights, self.plain_cfg, t(s["pose"]), t(s["intr"]),
                t(s["z_near"]).reshape(-1), t(s["z_far"]).reshape(-1), H, Wd,
                prec)
            mask = t(s["obj_mask"]).reshape(H, Wd, 1)
            img = t(s["image"]).reshape(3, H, Wd).permute(1, 2, 0) * mask
            p, ss, lp = pretrain.frame_metrics(self.weights, rgb, img)

            def levels(x):
                return (torch.clamp(x, 0, 1) * 255).to(torch.uint8).cpu() \
                    .numpy().astype(np.float64)

            got.append({"rgb": levels(rgb), "opacity": levels(opac),
                        "psnr": float(p), "ssim": float(ss),
                        "lpips": float(lp)})
        return got
