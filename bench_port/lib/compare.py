"""The numbers that decide ``correct``: the program against the plain
reference, each a gap as a share of the reference's size.

Training (the benchmark's weights through the runner's eager warm-up
steps, then three more of the timed path; the reference follows every
one from the same weights, each side from its own state):
  * ``start``: the change over the warm-up, by leaf as ``delta``;
  * ``loss``: the largest relative gap of a step's objective
    (``loss["all"]``) over the first n steps (all by default);
  * ``grad``: the first step's gradient as each optimizer got it — the
    program's worked out from its optimizer state after the step (Adam's
    first moment; RMSprop's second, which gives its norm) — by leaf:
    |‖g‖ − ‖g_ref‖| over max(‖g_ref‖, the median leaf's ‖g_ref‖).  Both
    sides take it at the same state, the benchmark's weights: a later
    step's gradient would also carry the drift of the optimizers' first
    updates, which move every element by the learning rate times its
    gradient's sign, however near nought that gradient lies;
  * ``delta``: the parameters' change over the steps after the warm-up,
    by leaf, the same measure;
  * ``grad.<group>``: ``grad`` over the leaves whose keys start with the
    group's prefix alone (as a critic's, whose leaves are a few among
    many).
``grad`` takes the worst leaf; ``start`` and ``delta`` the median leaf,
since the drift above reaches every leaf and the few leaves of a critic
most.  Leaves whose reference gradient is under a thousandth of the
median leaf's (nought to rounding, as a bias under a normalization) move
by round-off alone under Adam and are left out.
Frames: the worst of the frames compared.
"""

from __future__ import annotations

import statistics

import torch

LEAF_FLOOR = 1e-3


def first_grad_norms(before, after, b1, decay):
    """{leaf: ‖g‖} of the step between two optimizer states (a moment
    absent before the step counts as zeros; a leaf with no moment after it
    got no gradient); ``b1``: Adam's first-moment decay, ``decay``:
    RMSprop's."""
    out = {}
    for k, a in after.items():
        if not k.startswith(("m.", "nu.")):
            continue
        b = before[k].double() if k in before else torch.zeros_like(
            a, dtype=torch.float64)
        if k.startswith("m."):
            g = (a.double() - b1 * b) / (1 - b1)
            out[k[2:]] = float(torch.linalg.vector_norm(g))
        elif k.startswith("nu."):
            g2 = (a.double() - decay * b) / (1 - decay)
            out[k[3:]] = float(g2.clamp_min(0).sum().sqrt())
    return out


def _gaps(prog, ref, keep):
    """{leaf: |prog − ref| / max(ref, the median leaf's ref)}."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30)
            for k in keep}


def _change(a, b, keep):
    return {k: float(torch.linalg.vector_norm(a[k].double() - b[k].double()))
            for k in keep}


def training_checks(prog, ref, b1, decay, loss_steps=None, groups=None):
    """prog: {"init", "first" (after step 1), "start" (after the warm-up),
    "end": states, "losses": [per step {name: value}]}; ref: the same
    with "grads1" {leaf: tensor} (step 1's) → ({"start", "loss", "grad",
    "delta", "grad.<group>"...} gaps, details: the
    leaves left out, each step's objective gap, step 1's loss terms on
    both sides, the worst leaves, each leaf's first gradient gap).  ``loss_steps``: compare the first n
    steps' objectives (None: all); ``groups``: {group: key prefix}."""
    steps = [abs(float(lp["all"]) - float(lr["all"]))
             / max(abs(float(lr["all"])), 1e-12)
             for lp, lr in zip(prog["losses"], ref["losses"])]
    g_ref = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in ref["grads1"].items()}
    g_prog = first_grad_norms(prog["init"], prog["first"], b1, decay)
    med = statistics.median(g_ref.values())
    keep = [k for k in g_ref if g_ref[k] >= LEAF_FLOOR * med]
    init = prog["init"]
    by = {"grad": _gaps(g_prog, g_ref, keep),
          "delta": _gaps(_change(prog["end"], prog["start"], keep),
                         _change(ref["end"], ref["start"], keep), keep),
          "start": _gaps(_change(prog["start"], init, keep),
                         _change(ref["start"], init, keep), keep)}
    pick = {"grad": max, "delta": statistics.median,
            "start": statistics.median}
    out = {n: pick[n](g.values()) for n, g in by.items()}
    out["loss"] = max(steps[:loss_steps])
    for group, prefix in (groups or {}).items():
        out[f"grad.{group}"] = max(
            v for k, v in by["grad"].items() if k.startswith(prefix))
    worst = {n: [(k, g[k]) for k in sorted(g, key=g.get)[-3:]]
             for n, g in by.items()}
    terms = {k: (float(v), float(ref["losses"][0][k]))
             for k, v in prog["losses"][0].items() if k in ref["losses"][0]}
    return out, {"left_out": sorted(set(g_ref) - set(keep)), "steps": steps,
                 "step1_terms": terms,
                 "worst": worst, "grad_by_leaf": by["grad"]}
