"""Where the captured texture-GAN training step's time goes, section by
section (the JAX package's tools/bench_scan_sections.py and
tools/bench_decompose.py), and where the captured steps' and frames'
device time goes by kernel group (``--split``: what the JAX package's
tools/hlo_dump.py read from the compiled step's HLO, read here from the
device trace of the replays).

    python -m texpose_tpu_torch.tools.step_sections \\
        [--sections 0123456789abcdefhi] [--st-mega] [--split] [--key=value]

Needs a CUDA card; it raises without one (the bodies run on the CPU only
inside the tests).  Every reading, with the card's ``nvidia-smi`` name and
power limit, goes to SECTIONS_H100.json at the repository root
(``SECTIONS_JSON`` overrides the path); ``--key=value`` overrides the
config (a reduced width).

The configuration is bench.py's ``_bench_cfg``: configs/nerf_lm_adapt_gan.yaml
at full width on the generated 16-view fixture (bench_cfg), batch 8 of
16x16 patches and 64 samples, 131,072 field rows.

Sections.  A section of depth d is its body chained d times through one
carried tensor, as the JAX tool's ``lax.scan``, here captured as ONE CUDA
graph of the d chained bodies (``capture_chain``; the port's counterpart of
a scan, as ``StepRunner`` is the port's ``scan_steps``).  Each replay is
timed with CUDA events, REPS times at D_LO and D_HI chained bodies, no
profiler active; the marginal ms of one body is (t_hi - t_lo) / (D_HI -
D_LO) over the best times, as the JAX tool's ``marginal`` (the medians'
marginal is printed beside it):

  S0 render fwd        render_patch forward (rays + field + composite),
                       chained on the light latents
  S1 kernel fwd        the field kernel (row 1) forward, chained on pts
  S2 kernel fwd+bwd    + the heads-only backward (row 2: dX chain, dW GEMM,
                       reduction), chained on the heads
  S3 render grad       render_patch's uncertainty-weighted loss, its
                       gradient to the heads (rows 1-4 and the glue)
  S4 G-only step       the engine's captured step with gan = None
  S5 official step     the engine's captured G + D step
  S6 prologue          ``st_field_inputs`` + the latent rows alone
  S7 kernel only       the field kernel with its inputs built outside
  S8 / S9 composite    the dual composite (rows 3 / 3 + 4) alone
  Sa / Sb / Sc         rays + bounds / sample_depth / the render glue with
                       the field stubbed by a linear map
  Sd                   field + composite with pts and enc given (the
                       composite reads the flat [M,C] rows: row 5's layout
                       is the port's only one)
  Se / Sf              S0 with constant bounds / mid-bin depths (the
                       module functions patched, restored in ``finally``)
  Sh / Si              S0 with the rays and depths / the points given
  S1m / S2m            (--st-mega) the render kernels: row 6f forward,
                       6f + the fused backward 6b

S4 and S5 are the JAX tool's ``engine_step_ms``: K = ``scan_k()`` steps
through ``engine.step_runner().dispatch(K)``, best of ENGINE_DISPATCHES
dispatches ending in a sync, host clock, over K.  The JAX tool's Sg
(channel planes prebuilt outside a TPU relayout) has no counterpart: the
port's composites read the field's rows directly.

Deltas attribute as in the JAX tool: S3 - S2 the composite and the glue,
S4 - S3 the losses and the optimizers, S5 - S4 the discriminator step.

The split (``--split``).  For each captured program (``split_all``: the GAN
step, the default and the hierarchical pretrain step, the rows 1 + 3 eval
frame at 480x640 and the row 8 frame at 480x480) one eager run of it under
a device trace, its stages named by profiler ranges (the engines' own
``step/...`` ranges and this tool's ``section/...`` ranges around the
module functions of ``_stage_targets``, with markers that bracket their
backward), then SPLIT_STEPS (SPLIT_FRAMES) replays of its CUDA graph
under a device trace.  Each replayed kernel takes the stage of the eager kernel it aligns
with (the replay's kernel names against the eager run's), then its group
(``groups_of``): a csrc kernel its row by symbol (``ROW_SYMBOLS``; the
shared ``field_fwd_kernel<0>`` by the engine's route, ``shared_owner``),
any other kernel its stage's group.  Printed: device ms a step (a frame)
by group, their sum beside the union of the replays' busy intervals, and
"other" with its five largest symbols.  Beside it the trace's own cost:
the GAN step and the rows 1 + 3 frames' evaluate_full timed untraced /
traced / traced / untraced (``trace_turns``).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from difflib import SequenceMatcher
from functools import partial, wraps

import numpy as np
import torch

from . import quality_check as qc

REPO = qc.REPO
D_LO, D_HI, REPS = 4, 20, 5          # the JAX tool's depths and repetitions
ENGINE_DISPATCHES = 6                # engine_step_ms's n_disp
SPLIT_STEPS = 10                     # replayed steps in a split's window
SPLIT_FRAMES = 8                     # replayed frames in a split's window
TURN_STEPS = 30                      # steps a trace-cost turn
SPIN_CYCLES = 5_000_000              # a device spin (≈ 3 ms) ahead of a
                                     # timed call: ``op_ms``
ALL_SECTIONS = "0123456789abcdefhi"
SECTIONS_JSON = os.environ.get("SECTIONS_JSON",
                               os.path.join(REPO, "SECTIONS_H100.json"))

# --------------------------------------------------------------- config


def bench_fixture():
    """bench.py's fixture (16 train views, 1 test view, 128-pixel crops),
    generated once per temp directory (the evaluation envelope's)."""
    from . import eval_envelope
    return eval_envelope.fixture()


def bench_cfg(cache, overrides=(), gan=True):
    """bench.py's ``_bench_cfg`` on the fixture: the shipped texture config
    at full width, object ball, predicted boxes; with ``gan`` False the
    G-only step of the JAX tool's S4 (no discriminator, the five gan_* loss
    weights None).  max_iter 100000, as the JAX tool sets it."""
    from ..utils.config import load_yaml
    cfg = load_yaml(os.path.join(REPO, "configs", "nerf_lm_adapt_gan.yaml"))
    cfg.yaml = "configs/nerf_lm_adapt_gan.yaml"
    cfg.data.root = cache
    cfg.data.splits_root = os.path.join(cache, "splits")
    cfg.data.object = "ball"
    cfg.nerf.depth.box_source = "pred_box_init_calib"
    cfg.output_root = os.path.join(tempfile.gettempdir(),
                                   "texpose_sections_torch")
    if not gan:
        cfg.gan = None
        for k in ("gan_nerf", "gan_disc_real", "gan_disc_fake",
                  "gan_reg_real", "gan_reg_fake"):
            cfg.loss_weight[k] = None
    cfg = qc.finish(cfg, overrides)
    cfg.max_iter = 100000
    return cfg


def gan_engine(device, overrides=(), gan=True):
    """The texture-GAN engine of ``bench_cfg``, set up as the train CLI
    sets up a fresh run."""
    from ..models.texture_gan import TextureGANEngine
    cfg = bench_cfg(bench_fixture(), overrides=overrides, gan=gan)
    return qc.start(TextureGANEngine, cfg, device)


def need_card():
    """The measurement paths' device: the card, or raise."""
    if not torch.cuda.is_available():
        raise RuntimeError("step_sections: the measurements need a CUDA "
                           "card; none is visible")
    return torch.device("cuda", 0)


def nvidia_smi():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def record(key, value):
    """SECTIONS_H100.json[key] <- value (the other keys kept), with the
    card's nvidia-smi line."""
    path = SECTIONS_JSON
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out[key] = value
    out.setdefault("device", {})[key] = nvidia_smi()
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


# ------------------------------------------------------------- sections


def chain(body, carry, depth):
    """``depth`` applications of ``body`` through ``carry``."""
    for _ in range(depth):
        carry = body(carry)
    return carry


@contextlib.contextmanager
def kept_launch_counts():
    """The kernel wrappers' launch counts as they were before the block (a
    capture or a measurement is no run of a path)."""
    from ..kernels import launch_counters
    counters = launch_counters()
    before = [f.launches for f in counters]
    try:
        yield
    finally:
        for f, n in zip(counters, before):
            f.launches = n


def capture_chain(body, carry, depth):
    """One CUDA graph of ``depth`` chained bodies from ``carry`` (static
    inputs: a replay recomputes the chain from them; a body that updates
    its carry in place moves it at every replay, as the step's optimizer
    does) → ``run``, which replays it; ``run.graph`` and ``run.out`` keep
    the graph and its outputs alive.  One eager body first builds the
    kernels, packs and cached constants."""
    with kept_launch_counts():
        chain(body, carry, 1)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = chain(body, carry, depth)

    def run():
        graph.replay()

    run.graph, run.out = graph, out
    return run


def event_ms(run):
    """ms of ``run()`` between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def op_ms(fn, reps=10, warm=2):
    """Median ms of one call of ``fn`` between two CUDA events, its host
    work hidden behind a device spin enqueued first: the events bracket
    the device's work alone (one eager call's CUDA-event time otherwise
    holds the host's launch gaps, which grow on a slow host)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        times.append(event_ms(fn))
    return statistics.median(times)


def field_op_ms(sec):
    """The device ms of the field op that S1 chains (``Sections.field``:
    xext, the enc⊕pts rows and row 1's wrapper), alone (``op_ms``)."""
    with torch.no_grad():
        return op_ms(lambda: sec.field(sec.x["pts"]))


def marginal(make_run, d_lo=D_LO, d_hi=D_HI, reps=REPS, clock=event_ms):
    """The marginal ms of one body from two chain depths (the JAX tool's
    ``marginal``): ``make_run(d)`` → a run of a depth-d chain, run once to
    warm, then timed ``reps`` times by ``clock(run)``."""
    best, med = {}, {}
    for d in (d_lo, d_hi):
        run = make_run(d)
        run()
        ts = [clock(run) for _ in range(reps)]
        best[d], med[d] = min(ts), statistics.median(ts)
        del run
    return {"marginal_ms": (best[d_hi] - best[d_lo]) / (d_hi - d_lo),
            "marginal_median_ms": (med[d_hi] - med[d_lo]) / (d_hi - d_lo),
            "depths": [d_lo, d_hi], "reps": reps,
            "best_ms": {str(d): best[d] for d in best},
            "median_ms": {str(d): med[d] for d in med}}


def _t(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


class Sections:
    """The JAX tool's section bodies on the port, over one engine and one
    set of seeded inputs.  ``inputs`` replaces any of the seeded numpy
    inputs (pts [M,3], enc [M,E], light [B,Dl], trans [B,Dt], rgb_raw
    [M,3], trans_raw [M,5], dens_raw [M,1], depth [B,R,N,1] sorted, ray
    [B,R,3], w9 [3+E,9], depth_rand [B,R,N,1] uniforms, coords [B,p,p,2]).
    Each section method returns (body, carry, in_place): ``body(carry)``
    is one application; an ``in_place`` body updates the heads in place
    and returns its carry."""

    def __init__(self, eng, seed=0, inputs=None):
        from ..models.base import compute_dtype
        from ..nn.fields import input_view_dim
        from ..sampling.patch import flex_patch_coords
        cfg = eng.cfg
        self.eng, self.cfg, self.dev = eng, cfg, eng.device
        self.B, self.hw = int(cfg.batch_size), int(cfg.patch_size)
        self.R, self.N = self.hw ** 2, int(cfg.nerf.sample_intvs)
        self.M = self.B * self.R * self.N
        self.dtype = compute_dtype(cfg) or torch.bfloat16
        self.nerf = eng.nerf
        self.w = eng.nerf.kernel_weights()
        self.L3 = int(cfg.arch.posenc.L_3D)
        B, R, N, M = self.B, self.R, self.N, self.M
        E = input_view_dim(cfg)
        rng = np.random.default_rng(seed)
        base = {
            "pts": rng.standard_normal((M, 3)),
            "enc": rng.standard_normal((M, E)),
            "light": rng.standard_normal((B, int(cfg.nerf.N_latent_light))),
            "trans": rng.standard_normal((B, int(cfg.nerf.N_latent_trans))),
            "rgb_raw": rng.standard_normal((M, 3)),
            "trans_raw": rng.standard_normal((M, 5)),
            "dens_raw": rng.standard_normal((M, 1)),
            "depth": np.sort(rng.uniform(0.5, 3.0, (B, R, N, 1)), axis=2),
            "ray": rng.standard_normal((B, R, 3)),
            "w9": rng.standard_normal((3 + E, 9)) * 0.1,
            "depth_rand": rng.uniform(size=(B, R, N, 1)),
            "patch": rng.uniform(size=(3, B, 1, 1, 1))}
        base.update(inputs or {})
        self.x = {k: _t(v, self.dev) for k, v in base.items()}
        if "coords" not in self.x:
            self.x["coords"] = flex_patch_coords(self.x["patch"],
                                                 self.hw)[0]
        self.batch = {k: v[:B] for k, v in eng.train_batch.items()}
        self.c2f = torch.ones((self.L3,), device=self.dev)
        self.p05 = torch.full((), 0.5, device=self.dev)
        self.heads = self.w.head_params()

    # the field as the JAX tool's ``field(h, p, e)``: fused_st_field on
    # pts (its xext built from them), enc, the latents and the heads
    def field(self, p, grad=False):
        from ..kernels.st_field import make_xext, st_field, st_field_fwd
        xext = make_xext(p, self.L3, self.c2f)
        encpts = torch.cat([self.x["enc"], p], dim=1)
        op = st_field if grad else st_field_fwd
        return op(xext, encpts, self.x["light"], self.x["trans"], self.w,
                  self.R * self.N, self.dtype)

    def _step_heads(self, loss):
        g = torch.autograd.grad(loss, self.heads)
        with torch.no_grad():
            torch._foreach_add_(self.heads, g, alpha=-1e-12)

    def render(self, light, **kw):
        from ..models.texture_gan import render_patch
        b = self.batch
        return render_patch(self.nerf, self.cfg, b["pose_init"], b["intr"],
                            self.x["coords"], b["z_near"], b["z_far"],
                            self.x["trans"], light, self.p05, self.dtype,
                            self.x["depth_rand"], training=True, **kw)

    def s1(self):
        def body(p):
            with torch.no_grad():
                return p + 1e-6 * self.field(p)[0]
        return body, self.x["pts"], False

    def loss2(self):
        """The JAX tool's S2 loss (bench_scan_sections.py:214-216)."""
        rgb, _, tr = self.field(self.x["pts"], grad=True)
        return (rgb ** 2).mean() + (tr ** 2).mean()

    def s2(self):
        def body(h):
            self._step_heads(self.loss2())
            return h
        return body, self.heads, True

    def s0(self):
        def body(light):
            with torch.no_grad():
                return light + 1e-6 * self.render(light)["rgb"].mean()
        return body, self.x["light"], False

    def rloss(self, out):
        """The JAX tool's S3 loss (bench_scan_sections.py:554-564)."""
        from ..models.texture_gan import sample_patch_images
        B, hw = self.B, self.hw
        if not hasattr(self, "_sup"):
            self._sup = sample_patch_images(self.cfg, self.batch,
                                            self.x["coords"])
        sup = self._sup
        rgb = out["rgb"].reshape(B, hw, hw, 3).permute(0, 3, 1, 2)
        unc = out["uncert"].reshape(B, hw, hw, 1).permute(0, 3, 1, 2)
        m = sup["mask"]
        return ((m * ((sup["image"] - rgb) ** 2 / unc ** 2)).sum()
                / (m.sum() + 1e-5) + out["trans_density_mean"])

    def s3(self):
        self.rloss(self.render(self.x["light"]))   # the supervision once

        def body(h):
            self._step_heads(self.rloss(self.render(self.x["light"])))
            return h
        return body, self.heads, True

    def composite(self, rr, tr):
        from ..kernels.composite import fused_composite_st
        return fused_composite_st(rr, tr, self.x["dens_raw"],
                                  self.x["depth"], self.x["ray"])

    def s8(self):
        B, R, N, M = self.B, self.R, self.N, self.M

        def body(rr):
            with torch.no_grad():
                out = self.composite(rr, self.x["trans_raw"])
                d = out["rgb"][:, :, None, :].expand(B, R, N, 3)
                return rr + 1e-6 * d.reshape(M, 3)
        return body, self.x["rgb_raw"], False

    @staticmethod
    def closs(out):
        """The JAX tool's S9 loss."""
        return ((out["rgb"] ** 2).mean() + (out["uncert"] ** 2).mean()
                + out["trans_density_mean"])

    def s9(self):
        def body(c):
            x, t = (v.detach().requires_grad_(True) for v in c)
            gx, gt = torch.autograd.grad(self.closs(self.composite(x, t)),
                                         (x, t))
            return x.detach() - 1e-9 * gx, t.detach() - 1e-9 * gt
        return body, (self.x["rgb_raw"], self.x["trans_raw"]), False

    def rays(self, coords):
        from ..sampling.ray_sampler import get_bounds, get_rays
        b, cfg = self.batch, self.cfg
        ctr, ray = get_rays(b["intr"], coords, b["pose_init"], cfg.H, cfg.W)
        near, far = get_bounds(coords, b["z_near"], b["z_far"], cfg.H,
                               cfg.W)
        return ctr, ray, near, far

    def sa(self):
        def body(c):
            with torch.no_grad():
                d = sum(t.mean() for t in self.rays(c))
                return c + 1e-9 * d
        return body, self.x["coords"], False

    def sb(self):
        from ..ops.render import sample_depth
        far = torch.full((self.B, self.R), 3.0, device=self.dev)
        param = self.cfg.nerf.depth.param

        def body(near):
            with torch.no_grad():
                d = sample_depth(near, far, self.N, param=param,
                                 rand=self.x["depth_rand"])
                return near + 1e-9 * d.mean()
        return body, torch.full((self.B, self.R), 0.5, device=self.dev), False

    def glue(self, coords):
        """rays, bounds and stratified depths of the patch → (center
        [B,R,3], ray [B,R,3], depth [B,R,N,1])."""
        from ..ops.render import sample_depth
        B, R = self.B, self.R
        ctr, ray, near, far = self.rays(coords)
        dep = sample_depth(near.reshape(B, R), far.reshape(B, R), self.N,
                           param=self.cfg.nerf.depth.param,
                           rand=self.x["depth_rand"])
        return ctr.reshape(B, R, 3), ray.reshape(B, R, 3), dep

    def sc(self):
        from ..nn.fields import _encode_view
        B, R, N = self.B, self.R, self.N

        def body(light):
            with torch.no_grad():
                ctr, ray, dep = self.glue(self.x["coords"])
                pts = ctr[..., None, :] + ray[..., None, :] * dep
                ru = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
                e = _encode_view(self.cfg, ru, self.p05, c2f=True)
                e = e[..., None, :].expand(B, R, N, e.shape[-1])
                x = torch.cat([pts.reshape(-1, 3),
                               e.reshape(-1, e.shape[-1])], dim=1)
                raw = x @ self.x["w9"] + light[0, :9]
                from ..kernels.composite import fused_composite_st
                out = fused_composite_st(raw[:, :3], raw[:, 3:8],
                                         raw[:, 8:9], dep, ray)
                return light + 1e-6 * out["rgb"].mean()
        return body, self.x["light"], False

    def sd(self):
        def body(p):
            with torch.no_grad():
                rgb, dens, tr = self.field(p)
                from ..kernels.composite import fused_composite_st
                out = fused_composite_st(rgb, tr, dens, self.x["depth"],
                                         self.x["ray"])
                return p + 1e-6 * out["rgb"].mean()
        return body, self.x["pts"], False

    def s6(self):
        from ..kernels.st_field import _latent_rows
        from ..nn.fields import st_field_inputs
        B, R, N = self.B, self.R, self.N
        ray = self.x["ray"]
        ru = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)

        def body(p):
            with torch.no_grad():
                xext, encpts = st_field_inputs(self.cfg, p.reshape(B, R, N,
                                                                   3),
                                               ru, self.p05)
                lrow, trow = _latent_rows(self.w, self.x["light"],
                                          self.x["trans"], encpts.shape[1],
                                          self.dtype)
                return p + 1e-6 * (xext[0, 0] + encpts[0, 0] + lrow[0, 0]
                                   + trow[0, 0])
        return body, self.x["pts"], False

    def s7(self):
        from ..kernels.st_field import make_xext, st_field_fwd
        p0 = self.x["pts"]
        xext = make_xext(p0, self.L3, self.c2f)
        encpts = torch.cat([self.x["enc"], p0], dim=1)

        def body(p):
            with torch.no_grad():
                rgb = st_field_fwd(xext, encpts, self.x["light"],
                                   self.x["trans"], self.w, self.R * self.N,
                                   self.dtype)[0]
                return p + 1e-6 * rgb
        return body, p0, False

    def sh(self, pts_given):
        """The JAX tool's Sh (rays and depths given) or, ``pts_given``, Si
        (the points too)."""
        from ..kernels.composite import fused_composite_st
        from ..nn.fields import apply_nerf_st_raw
        ctr0, ray0, dep0 = self.glue(self.x["coords"])
        pts0 = ctr0[..., None, :] + ray0[..., None, :] * dep0

        def body(light):
            with torch.no_grad():
                pts = pts0 if pts_given else (ctr0[..., None, :]
                                              + ray0[..., None, :] * dep0)
                ru = ray0 / torch.linalg.norm(ray0, dim=-1, keepdim=True)
                rgb, dens, tr = apply_nerf_st_raw(
                    self.nerf, self.cfg, pts, ru, self.x["trans"], light,
                    self.p05, self.dtype)
                out = fused_composite_st(rgb, tr, dens, dep0, ray0)
                return light + 1e-6 * out["rgb"].mean()
        return body, self.x["light"], False

    def mega(self, p, grad=False):
        from ..kernels.st_field import make_xext
        from ..kernels.st_render import fused_st_render
        xext = make_xext(p, self.L3, self.c2f)
        encpts = torch.cat([self.x["enc"], p], dim=1)
        return fused_st_render(xext, encpts, self.x["light"],
                               self.x["trans"], self.x["depth"],
                               self.x["ray"], self.w, self.R * self.N,
                               self.dtype)

    def s1m(self):
        def body(p):
            with torch.no_grad():
                return p + 1e-6 * self.mega(p)["rgb"].mean()
        return body, self.x["pts"], False

    def s2m(self):
        def body(h):
            self._step_heads(self.closs(self.mega(self.x["pts"])))
            return h
        return body, self.heads, True


# tag → label, the Sections method that makes the body, its arguments
SECTIONS = {
    "0": ("S0 render fwd", "s0", ()),
    "1": ("S1 kernel fwd", "s1", ()),
    "2": ("S2 kernel fwd+bwd", "s2", ()),
    "3": ("S3 render grad", "s3", ()),
    "6": ("S6 prologue", "s6", ()),
    "7": ("S7 kernel only", "s7", ()),
    "8": ("S8 composite fwd", "s8", ()),
    "9": ("S9 composite f+b", "s9", ()),
    "a": ("Sa rays+bounds", "sa", ()),
    "b": ("Sb sample_depth", "sb", ()),
    "c": ("Sc glue (no field)", "sc", ()),
    "d": ("Sd field+composite", "sd", ()),
    "e": ("Se S0 w/o bounds", "s0", ()),
    "f": ("Sf S0 w/o strat", "s0", ()),
    "h": ("Sh rays/dep given", "sh", (False,)),
    "i": ("Si pts also given", "sh", (True,)),
    "m": ("S1m render kernel fwd (6f)", "s1m", ()),
    "n": ("S2m render kernel fwd+bwd (6f+6b)", "s2m", ()),
}
ENGINE_SECTIONS = {"4": "S4 G-only step", "5": "S5 official step"}


@contextlib.contextmanager
def ablation(tag):
    """Se: the patch's depth bounds constant (texture_gan.get_bounds);
    Sf: mid-bin depths (models/render.py's sample_depth without its
    uniforms); S2m: the fully fused render backward."""
    from ..models import render as rd
    from ..models import texture_gan as tg
    saved = (tg.get_bounds, rd.sample_depth,
             os.environ.get("TEXPOSE_MEGA_FULLBWD"))
    if tag == "e":
        tg.get_bounds = lambda c, zn, zf, H, W: (
            torch.full(c.shape[:3], 0.5, device=c.device),
            torch.full(c.shape[:3], 3.0, device=c.device))
    elif tag == "f":
        plain = saved[1]
        rd.sample_depth = (lambda lo, hi, n, param="metric", rand=None:
                           plain(lo, hi, n, param=param))
    elif tag == "n":
        os.environ["TEXPOSE_MEGA_FULLBWD"] = "1"
    try:
        yield
    finally:
        tg.get_bounds, rd.sample_depth = saved[:2]
        if saved[2] is None:
            os.environ.pop("TEXPOSE_MEGA_FULLBWD", None)
        else:
            os.environ["TEXPOSE_MEGA_FULLBWD"] = saved[2]


def section_body(sec, tag):
    """(body, carry, in_place) of section ``tag`` on ``Sections`` sec."""
    _, name, args = SECTIONS[tag]
    return getattr(sec, name)(*args)


def chained_run(sec, tag, depth):
    """A depth-``depth`` chain of section ``tag``, captured (its carry a
    static input: a copy of the seeded one, or the live heads)."""
    body, carry, in_place = section_body(sec, tag)
    if not in_place:
        carry = (tuple(c.clone() for c in carry) if isinstance(carry, tuple)
                 else carry.clone())
    return capture_chain(body, carry, depth)


def run_section(sec, tag):
    """Section ``tag``'s marginal (``marginal``) under its ablation."""
    with ablation(tag):
        return marginal(partial(chained_run, sec, tag))


def engine_step_ms(eng, n_disp=ENGINE_DISPATCHES):
    """ms a step of the engine's captured step (the JAX tool's
    ``engine_step_ms``): K = ``scan_k()`` steps a dispatch through its
    ``StepRunner``, two warm dispatches (warm-up steps and the capture),
    then the best of ``n_disp`` dispatches ending in a sync, host clock,
    over K."""
    k = eng.scan_k()
    runner = eng.step_runner()
    for _ in range(2):
        loss = runner.dispatch(k)
    float(loss["all"])
    times = []
    for _ in range(n_disp):
        t0 = time.perf_counter()
        loss = runner.dispatch(k)
        float(loss["all"])
        times.append((time.perf_counter() - t0) * 1e3 / k)
    return {"ms_per_step": min(times), "median_ms": statistics.median(times),
            "scan_k": k, "dispatches": n_disp, "route": runner.route}


def sections(device, tags, overrides=(), st_mega=False, log=print):
    """Every section of ``tags`` at full width (``--key=value`` overrides
    cut it) → {tag: reading}."""
    eng = gan_engine(device, overrides)
    sec = Sections(eng)
    out = {}
    for tag in tags + ("mn" if st_mega else ""):
        if tag in ENGINE_SECTIONS:
            if tag == "4":
                e4 = gan_engine(device, overrides, gan=False)
                res = engine_step_ms(e4)
                del e4
            else:
                res = engine_step_ms(eng)
            label = ENGINE_SECTIONS[tag]
            log(f"{label:32s}: {res['ms_per_step']:8.4f} ms/step (median "
                f"{res['median_ms']:.4f}, K {res['scan_k']}, "
                f"{res['route']})")
        else:
            label = SECTIONS[tag][0]
            res = run_section(sec, tag)
            log(f"{label:32s}: {res['marginal_ms']:8.4f} ms/step (medians "
                f"{res['marginal_median_ms']:.4f}); best {res['best_ms']} "
                f"median {res['median_ms']} ms at depths {res['depths']}")
            if tag == "1":
                res["op_alone_ms"] = field_op_ms(sec)
                log(f"{'S1 field op alone':32s}: {res['op_alone_ms']:8.4f} ms "
                    "(CUDA events around one call behind a device spin)")
        out[tag] = dict(res, label=label)
    return out


# ------------------------------------------------------------ the split

# the csrc kernels by symbol (and, for the shared field forward, its
# epilogue template argument: csrc/field_fwd.cuh EPI_NONE 0, EPI_COARSE 1,
# EPI_ST 2) → their PERF.md row; chip_smoke.py's KERNEL_SYMBOLS maps the
# same symbols to the wrappers
ROW_SYMBOLS = {
    ("field_fwd_kernel", 1): "row 8",
    ("field_fwd_kernel", 2): "row 6f",
    ("st_field_bwd_kernel", None): "row 2 (dX)",
    ("st_render_bwd_kernel", None): "row 6b (dX)",
    ("coarse_bwd_kernel", None): "row 7b (dX)",
    ("composite_st_fwd_seg_kernel", None): "row 3",
    ("composite_st_bwd_seg_kernel", None): "row 4",
    ("composite_st_bwd_kernel", None): "row 4",
    ("composite_coarse_fwd_seg_kernel", None): "row 9a",
    ("composite_coarse_fwd_kernel", None): "row 9a",
    ("composite_coarse_bwd_seg_kernel", None): "row 9b",
    ("composite_coarse_bwd_kernel", None): "row 9b",
    ("dw_gemm_kernel", None): "dw_gemm",
    ("dw_reduce_kernel", None): "dw_reduce",
}
SHARED = ("field_fwd_kernel", 0)     # rows 1, 7a and 10: by the route
# the other kernels by the stage they ran in (disjoint sets of stages)
STAGE_GROUPS = {
    "weight packs": {"pack"},
    "draws": {"draws"},
    "VGG": {"vgg"},
    "discriminator + R1": {"disc", "step/disc_forward",
                           "step/disc_backward"},
    "updates (optimizers, EMA)": {"step/gen_update", "step/disc_update",
                                  "step/update"},
    "render glue": {"render"},
    "losses + batch": {"step/batch", "step/gen_forward", "step/forward"},
    "loss backward": {"step/gen_backward", "step/backward"},
    "metrics (SSIM, LPIPS)": {"metrics"},
    "scatter + PNG payload": {"frame"},
    "slot copies + clones": {"io"},
}
OTHER = "other"


def kernel_symbol(name):
    """(symbol, the field forward's epilogue or None) of a traced kernel's
    demangled name, or None for a kernel of no csrc wrapper's (chip_smoke.py
    maps the symbols to the wrappers, ``KERNEL_SYMBOLS``)."""
    m = re.search(r"(\w+_kernel)\s*(?:<([^>]*)>)?\s*\(", name)
    if m is None:
        return None
    if m.group(1) != "field_fwd_kernel":
        return m.group(1), None
    nums = re.findall(r"\d+", m.group(2) or "")
    return m.group(1), int(nums[-1]) if nums else None


def shared_owner(engine):
    """The row of ``field_fwd_kernel<0>`` on the engine's route
    (``step_graph.route_name``): the ST field forward (row 1) on the
    texture GAN's, the trunk kernel (row 10) there under density noise
    (its gate sends the field to the trunk kernel), the coarse field
    forward (row 7a) on the pretrain's."""
    from ..models.step_graph import route_name
    if route_name(engine).startswith("TextureGANEngine"):
        return ("row 10" if engine.cfg.nerf.get("density_noise_reg")
                else "row 1")
    return "row 7a"


def groups_of(name, stage, owner):
    """Every group whose rule takes a kernel named ``name`` that ran in
    ``stage`` (a csrc kernel by its symbol, any other by its stage, else
    "other"); the rules are meant to be disjoint, so a kernel lands in
    exactly one."""
    sym = kernel_symbol(name)
    row = owner if sym == SHARED else ROW_SYMBOLS.get(sym)
    out = [row] if row else []
    if row is None and sym is not None and sym[0] == SHARED[0]:
        out.append("row ? (field_fwd_kernel)")
    if row is None:
        out += [g for g, stages in STAGE_GROUPS.items() if stage in stages]
    if not out:
        out.append(OTHER)
    return out


def trace_events(prof):
    """A finished profile's events as (device type, correlation id, name,
    start ns, end ns, user annotation) tuples, read from the profiler's
    raw results: building its event tree (``prof.events()``) takes tens
    of seconds over the 10^5 kernels of a traced sweep."""
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        raise RuntimeError("the profiler keeps no kineto_results to read "
                           "the trace from")
    return [(e.device_type(), e.correlation_id(), e.name(), e.start_ns(),
             e.end_ns(), getattr(e, "is_user_annotation", lambda: False)())
            for e in res.events()]


def union_ms(intervals):
    """Total length of the union of [start, end) intervals in µs → ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


@contextlib.contextmanager
def device_trace():
    """torch.profiler over the block (CPU + CUDA); yields a dict that
    holds the block's events (``trace_events``) after it."""
    from torch.profiler import ProfilerActivity
    got = {}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        yield got
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    got["events"] = trace_events(prof)


def _is_cuda(dev_type):
    return str(dev_type).endswith("CUDA")


def device_kernels(events):
    """The device events that are kernels, copies or fills (not the GPU
    spans of user ranges), by start: (corr, name, start, end)."""
    return sorted(((c, n, s, e) for d, c, n, s, e, user in events
                   if _is_cuda(d) and not user), key=lambda k: k[2])


# ---------------------------------------------------------------- stages

class _Mark(torch.autograd.Function):
    """Identity whose backward leaves a zero-length profiler range
    ``section/bwd<label>`` (``end`` False: on a function's outputs, where
    its backward begins) or ``section/bwd>label`` (on its inputs, where it
    ends)."""

    @staticmethod
    def forward(ctx, x, label, end):
        ctx.label, ctx.end = label, end
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(
                f"section/bwd{'>' if ctx.end else '<'}{ctx.label}"):
            pass
        return g, None, None


def _marked(obj, label, end):
    """obj with every tensor that requires grad passed through ``_Mark``."""
    if isinstance(obj, torch.Tensor):
        return (_Mark.apply(obj, label, end)
                if obj.requires_grad and torch.is_grad_enabled() else obj)
    if type(obj) is dict:
        return {k: _marked(v, label, end) for k, v in obj.items()}
    if type(obj) in (list, tuple):
        return type(obj)(_marked(v, label, end) for v in obj)
    return obj


def _staged(fn, stage, counter):
    """``fn`` inside the range ``section/<stage>``, its backward bracketed
    by ``_Mark``s labelled ``<stage>#<call>``."""
    @wraps(fn)
    def run(*args, **kwargs):
        counter[0] += 1
        label = f"{stage}#{counter[0]}"
        args, kwargs = _marked(args, label, True), _marked(kwargs, label,
                                                           True)
        with torch.profiler.record_function(f"section/{stage}"):
            return _marked(fn(*args, **kwargs), label, False)
    return run


def _stage_targets():
    """(owner, attribute, stage) of every function the split's eager run
    puts in a stage: the module functions the engines' steps and frame
    bodies call, and the kernels' weight packs."""
    from ..kernels import coarse_field, st_field
    from ..models import pretrain, texture_gan
    out = [(texture_gan, "render_patch", "render"),
           (texture_gan, "perceptual_loss_pairs", "vgg"),
           (texture_gan, "apply_discriminator", "disc"),
           (texture_gan, "render_rays_masked_st_pre", "render"),
           (texture_gan, "render_full_nerf_st", "render"),
           (texture_gan, "frame_metrics", "metrics"),
           (pretrain, "render_rays_nerf", "render"),
           (pretrain, "render_rays_nerf_hierarchical", "render"),
           (pretrain, "render_full_nerf", "render"),
           (pretrain, "frame_metrics", "metrics"),
           (st_field.PackCache, "_cached", "pack")]
    for cls in (st_field.TrunkWeights, st_field.STFieldWeights,
                coarse_field.CoarseFieldWeights):
        for name in ("trunk_walk", "fwd_walk", "kernel_buffers_bwd",
                     "kernel_buffer_bwd"):
            if name in vars(cls):
                out.append((cls, name, "pack"))
    return out


@contextlib.contextmanager
def staged():
    """The block with ``_stage_targets`` in their stages (restored after)."""
    counter = [0]
    saved = [(owner, name, vars(owner)[name])
             for owner, name, _ in _stage_targets()]
    try:
        for owner, name, stage in _stage_targets():
            setattr(owner, name, _staged(vars(owner)[name], stage, counter))
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def stage_ranges(events):
    """[(start, end, stage)] of the trace's ranges: the engines' ``step/``
    and this tool's ``section/`` ranges, and each staged call's backward
    (from its last ``bwd<`` marker to its last ``bwd>`` marker)."""
    ranges, begin, end = [], {}, {}
    for d, _, name, s, e, user in events:
        if _is_cuda(d) or not user:
            continue
        if name.startswith("section/bwd"):
            label = name[len("section/bwd") + 1:]
            side = begin if name[len("section/bwd")] == "<" else end
            side[label] = max(side.get(label, s), s)
        elif name.startswith("step/"):
            ranges.append((s, e, name))
        elif name.startswith("section/"):
            ranges.append((s, e, name[len("section/"):]))
    for label, s in begin.items():
        if label in end and end[label] > s:
            ranges.append((s, end[label], label.split("#")[0]))
    return ranges


def launch_times(events):
    """{correlation id: host start ns} of the trace's runtime and driver
    API calls (each kernel, copy or fill shares its launch's id)."""
    return {c: s for d, c, n, s, e, user in events
            if not _is_cuda(d) and not user and n.startswith("cu")}


def kernel_stages(events):
    """The device kernels of an eager run with their stages: the innermost
    range (``stage_ranges``) around each kernel's launch → [(name,
    stage or None)] by start."""
    ranges = stage_ranges(events)
    launched = launch_times(events)
    out = []
    for c, name, _, _ in device_kernels(events):
        t = launched.get(c)
        inner = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        stage = min(inner, key=lambda r: r[1] - r[0])[2] if inner else None
        out.append((name, stage))
    return out


def align(eager, names):
    """The stage of each of ``names`` (a replay's kernels) from the eager
    run's [(name, stage)] where the two sequences match (difflib), None
    elsewhere → (stages, the matched share)."""
    stages = [None] * len(names)
    sm = SequenceMatcher(None, [n for n, _ in eager], names, autojunk=False)
    hit = 0
    for a, b, size in sm.get_matching_blocks():
        for k in range(size):
            stages[b + k] = eager[a + k][1]
        hit += size
    return stages, hit / max(len(names), 1)


def replays_of(events):
    """The window's device events inside CUDA graph replays, one list per
    replay (its ``cudaGraphLaunch``'s correlation id) by start, and the
    window's other device events."""
    graphs = {c for d, c, n, s, e, user in events
              if not _is_cuda(d) and "GraphLaunch" in n}
    reps, rest = {}, []
    for k in device_kernels(events):
        (reps.setdefault(k[0], []) if k[0] in graphs else rest).append(k)
    return [reps[c] for c in sorted(reps, key=lambda c: reps[c][0][2])], rest


def split(eager_events, window_events, owner, units, outside="io"):
    """The device ms a unit (a step or a frame) by group of a replayed
    window: its replays' kernels grouped by their aligned stages
    (``align`` against the eager run's ``kernel_stages``), the window's
    other device events (slot copies, clones) as stage ``outside``;
    ``units`` the steps or frames in the window → the reading."""
    eager = kernel_stages(eager_events)
    reps, rest = replays_of(window_events)
    by, sym, bad, shares = {}, {}, [], []
    cache = {}
    for rep in reps:
        names = tuple(k[1] for k in rep)
        if names not in cache:
            cache[names] = align(eager, list(names))
        stages, share = cache[names]
        shares.append(share)
        for (c, name, s, e), stage in zip(rep, stages):
            _add(by, sym, bad, name, stage, owner, (e - s) / 1e6)
    for c, name, s, e in rest:
        _add(by, sym, bad, name, outside, owner, (e - s) / 1e6)
    busy = union_ms([(s / 1e3, e / 1e3) for k in reps for _, _, s, e in k]
                    + [(s / 1e3, e / 1e3) for _, _, s, e in rest])
    n = max(units, 1)
    groups = {g: v / n for g, v in sorted(by.items(), key=lambda kv: -kv[1])}
    top = sorted(sym.get(OTHER, {}).items(), key=lambda kv: -kv[1])[:5]
    return {"groups_ms": groups, "sum_ms": sum(groups.values()),
            "busy_ms": busy / n, "replays": len(reps), "units": units,
            "kernels_per_replay": (sum(len(r) for r in reps)
                                   / max(len(reps), 1)),
            "aligned": min(shares) if shares else 0.0,
            "other_share": groups.get(OTHER, 0.0) / max(busy / n, 1e-12),
            "other_top": [(name, ms / n) for name, ms in top],
            "misgrouped": bad[:10], "n_misgrouped": len(bad)}


def _add(by, sym, bad, name, stage, owner, ms):
    got = groups_of(name, stage, owner)
    if len(got) != 1:
        bad.append((name, stage, got))
    g = got[0]
    by[g] = by.get(g, 0.0) + ms
    short = re.sub(r"\(.*", "", name)[:120]
    sym.setdefault(g, {})[short] = sym.get(g, {}).get(short, 0.0) + ms


def step_split(eng, steps=SPLIT_STEPS):
    """The captured step's split: one eager step in its stages under a
    trace (its draws in ``draws``), then ``steps`` replays of the captured
    step under another (the runner captured first) → the reading."""
    runner = eng.step_runner()
    runner.dispatch(eng.scan_k())
    torch.cuda.synchronize()
    with staged(), device_trace() as eager:
        with torch.profiler.record_function("section/draws"):
            draws = eng.make_draws(eng.it)
        eng.train_step(draws)
    runner.dispatch(2)
    torch.cuda.synchronize()
    with device_trace() as window:
        runner.dispatch(steps)
    return split(eager["events"], window["events"], shared_owner(eng),
                 steps)


def frame_split(eng, key, frames=SPLIT_FRAMES):
    """A captured frame program's split: its body once eagerly in its
    stages (the field's packs rebuilt, as inside the graph) under a trace,
    then ``frames`` calls of the program through the runner (slot copies,
    the replay, the clones) under another → the reading."""
    from ..models.frame_graph import field_params
    from ..models.step_graph import bump_versions
    runner = eng.frame_runner()
    unit = runner.units[key]
    inputs = {k: v.clone() for k, v in unit.slots.items()}
    bump_versions(field_params(eng))
    with torch.inference_mode(), staged(), device_trace() as eager:
        with torch.profiler.record_function("section/frame"):
            unit.body(**inputs)
    bump_versions(field_params(eng))
    with torch.inference_mode():
        runner.run(key, unit.body, **inputs)
        torch.cuda.synchronize()
        with device_trace() as window:
            for _ in range(frames):
                runner.run(key, unit.body, **inputs)
    return split(eager["events"], window["events"], shared_owner(eng),
                 frames)


def trace_turns(run, units):
    """The trace's own cost: ``run()`` (``units`` steps or frames) timed
    untraced / traced / traced / untraced, host clock ending in a sync,
    the profiler's start and its parse outside the timed span → readings
    in units/s."""
    from torch.profiler import ProfilerActivity
    turns = []
    for mode in ("untraced", "traced", "traced", "untraced"):
        run()
        torch.cuda.synchronize()
        ctx = (torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
               if mode == "traced" else contextlib.nullcontext())
        with ctx:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        turns.append((mode, units / wall))
    un = statistics.mean(r for m, r in turns if m == "untraced")
    tr = statistics.mean(r for m, r in turns if m == "traced")
    return {"turns": turns, "untraced": un, "traced": tr,
            "traced_over_untraced": tr / un}


# the captured programs of the split
def _pretrain_engine(device, overrides=(), eval_hw=None):
    from ..models.pretrain import PretrainEngine
    cfg = qc.pretrain_cfg(qc.fixture(), 100000, overrides)
    if eval_hw is None:
        return qc.start(PretrainEngine, cfg, device)
    cfg = qc.finish(cfg, [f"--data.image_size=[{eval_hw[0]},{eval_hw[1]}]"])
    cfg.max_iter = 100000
    eng = PretrainEngine(cfg, device)
    eng.load_dataset(eval_split="test")
    eng.build_networks()
    eng.setup_optimizer()
    return eng


HIER = ("--nerf.fine_sampling=true", "--nerf.sample_intvs_fine=128",
        "--loss_weight.render_fine=0")


def gan_eval_engine(device, n_frames, overrides=()):
    """The evaluation envelope's 480x640 GAN engine over an ``n_frames``
    split (``tools/eval_envelope.py``), its frame program captured on
    frame 0 (``warm_eval``)."""
    from ..models.texture_gan import TextureGANEngine
    from . import eval_envelope as ee
    cache = ee.fixture()
    scene = ee.long_split(cache, n_frames)
    out = os.path.join(tempfile.gettempdir(), "texpose_sections_eval")
    cfg = ee.envelope_cfg(cache, scene, (480, 640), out, overrides)
    eng = TextureGANEngine(cfg, device)
    eng.load_dataset(eval_split="test")
    eng.build_networks()
    eng.setup_optimizer()
    eng.warm_eval(0)
    eng._eval_cache = (None, None)
    return eng


def _unit_key(eng, wrapper):
    """The key of the frame runner's unit whose warm call launched
    ``wrapper``."""
    for key, u in eng.frame_runner().stats().items():
        if u["warm_launches"].get(wrapper):
            return key
    raise RuntimeError(f"no captured frame program launched {wrapper}: "
                       f"{eng.frame_runner().stats()}")


def split_all(device, overrides=(), log=print, gan=None, ev=None):
    """The split of every captured program and the trace's cost → {program:
    reading}.  ``gan``: the bench engine (``gan_engine``), ``ev``: the
    480x640 evaluation engine (``gan_eval_engine``), built here unless
    given."""
    out = {}
    gan = gan or gan_engine(device, overrides)
    out["GAN step (rows 1-4)"] = step_split(gan)
    out["trace cost, GAN step"] = trace_turns(
        lambda: gan.step_runner().dispatch(TURN_STEPS), TURN_STEPS)
    for name, extra in (("pretrain step (rows 8, 9b, 7b)", ()),
                        ("hierarchical step (rows 7a, 7b)", HIER)):
        e = _pretrain_engine(device, tuple(overrides) + extra)
        out[name] = step_split(e)
        del e
    ev = ev or gan_eval_engine(device, SPLIT_FRAMES, overrides)
    out["GAN frame 480x640 (rows 1 + 3)"] = frame_split(
        ev, _unit_key(ev, "st_field_fwd"))
    out["trace cost, GAN frames"] = trace_turns(
        lambda: ev.evaluate_full(), len(ev.eval_data))
    pe = _pretrain_engine(device, overrides, eval_hw=(480, 480))
    pe.evaluate_full()
    out["pretrain frame 480x480 (row 8)"] = frame_split(
        pe, _unit_key(pe, "coarse_render_fwd"))
    del pe
    for name, r in out.items():
        log(split_text(name, r))
    return out


def split_text(name, r):
    """One program's split (or trace-cost reading) as lines of text."""
    if "turns" in r:
        return (f"{name}: units/s in turns "
                + ", ".join(f"{m} {v:.3f}" for m, v in r["turns"])
                + f"; traced / untraced {r['traced_over_untraced']:.3f}")
    lines = [f"{name}: {r['replays']} replays, {r['kernels_per_replay']:.0f}"
             f" device events a replay, aligned {100 * r['aligned']:.1f} %;"
             f" group sum {r['sum_ms']:.4f} ms, busy {r['busy_ms']:.4f} ms "
             f"a unit; other {100 * r['other_share']:.2f} % of busy; "
             f"{r['n_misgrouped']} kernels in no or two groups"]
    lines += [f"  {g:30s} {ms:9.4f} ms" for g, ms in r["groups_ms"].items()]
    lines += [f"  other: {ms:.4f} ms {n}" for n, ms in r["other_top"]]
    return "\n".join(lines)


def parse_args(argv):
    """(sections, st_mega, split, config overrides) of the command line;
    the sections default to every one, or to none with --split alone."""
    tags, st_mega, do_split, rest = None, False, False, []
    for a in argv:
        if a.startswith("--sections="):
            tags = a.split("=", 1)[1]
        elif a == "--st-mega":
            st_mega = True
        elif a == "--split":
            do_split = True
        elif a.startswith("--device"):
            raise ValueError("step_sections measures on the card only")
        elif a.startswith("--"):
            rest.append(a)
        else:
            raise ValueError(f"invalid argument {a!r}")
    if tags is None:
        tags = "" if do_split else ALL_SECTIONS
    unknown = set(tags) - set(SECTIONS) - set(ENGINE_SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}")
    return tags, st_mega, do_split, rest


def main(argv=None):
    """The sections (and with --split the split) on the card → the
    readings, written to SECTIONS_JSON; raises without a card."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--sections" in argv:                    # "--sections 01" form
        i = argv.index("--sections")
        argv[i:i + 2] = [f"--sections={argv[i + 1]}"]
    tags, st_mega, do_split, overrides = parse_args(argv)
    device = need_card()
    smi = nvidia_smi()
    print(smi, flush=True)
    log = partial(print, flush=True)
    out = {}
    if tags:
        out["sections"] = sections(device, tags, overrides, st_mega, log)
        record("sections", out["sections"])
    if do_split:
        out["split"] = split_all(device, overrides, log)
        record("split", out["split"])
    return out


if __name__ == "__main__":
    main()
