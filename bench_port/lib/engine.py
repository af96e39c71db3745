"""The program under test, as the benchmark drives it: its configuration
from the configuration file and the workload's traffic, its engine set up
as the train or evaluate CLI sets up a fresh run, the benchmark's weights
loaded into it, and snapshots of its state under the reference's keys."""

from __future__ import annotations

import json
import os
import time

import torch

from . import harness


def _nested(flat):
    """{"a.b": v} → {"a": {"b": v}}."""
    out = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split(".")
        for p in head:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def build_cfg(spec, data_root, workdir, seed, extra=None):
    """The engine's configuration: the repo yaml the configuration file
    names, its ``set`` sizes, the traffic's ``cfg`` keys, then ``extra``
    (dotted keys); data under data_root, output under workdir."""
    from texpose_tpu_torch.utils.config import (Config, load_yaml, merge,
                                                process_options)
    conf, traffic = spec["config"], spec["workload"]["traffic"]
    cfg = load_yaml(os.path.join(harness.ROOT, conf["yaml"]))
    cfg.yaml = conf["yaml"]
    flat = dict(conf["set"])
    flat.update(traffic.get("cfg") or {})
    flat.update(extra or {})
    flat.update({"data.root": data_root,
                 "data.splits_root": os.path.join(data_root, "splits"),
                 "output_root": os.path.join(workdir, "out"),
                 "seed": int(seed) % (2 ** 63)})
    cfg = merge(cfg, Config(_nested(flat)), allow_new=True)
    return process_options(cfg)


def plain(cfg):
    """The configuration as plain JSON data."""
    return json.loads(json.dumps(cfg.to_dict(), default=str))


class Stages:
    """Seconds of each set-up stage (host clock after a device sync)."""

    def __init__(self, device):
        self.device, self.t, self.s = device, time.perf_counter(), {}

    def mark(self, name):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self.t
        self.t = now


def make_engine(cfg, device, stages, train=True, eval_split="val"):
    """The engine of cfg.model, its data loaded, networks built; with
    ``train`` the train split uploaded and the optimizers set up, as the
    train CLI sets up a run (the evaluate CLI sets up neither)."""
    from texpose_tpu_torch.models import get_engine
    eng = get_engine(cfg.model)(cfg, device)
    eng.load_dataset(eval_split=eval_split)
    if train:
        eng.upload_train_split()
    stages.mark("engine: data")
    eng.build_networks()
    stages.mark("engine: networks (VGG19 / field init on the host)")
    if train:
        eng.setup_optimizer()
        stages.mark("engine: optimizers")
    return eng


def leaves(eng):
    """{reference key: the engine's tensor} of every weight the benchmark
    makes (lib/weights.py keys)."""
    out = {}
    nerf = eng.nerf
    for name, mod in (("trunk", nerf.mlp_feat), ("rgb", nerf.mlp_rgb),
                      ("trans", getattr(nerf, "mlp_trans", None))):
        for i, layer in enumerate(mod or ()):
            out[f"{name}.{i}.w"], out[f"{name}.{i}.b"] = layer.w, layer.b
    for k, t in (eng.latents or {}).items():
        out[f"latent.{k}"] = t
    for grp, ws in (getattr(eng, "disc", None) or {}).items():
        for i, w in enumerate(ws):
            out[f"disc.{grp}.{i}"] = w
    for i, p in enumerate(getattr(eng, "vgg", None) or ()):
        out[f"vgg.{i}.w"], out[f"vgg.{i}.b"] = p["w"], p["b"]
    return out


@torch.no_grad()
def load_weights(eng, W):
    """Copy the benchmark's weights into the engine (every engine leaf
    must have one, of its shape); with LPIPS keys, the engine's LPIPS
    network too."""
    for key, t in leaves(eng).items():
        got = tuple(W[key].shape) if key in W else None
        if got != tuple(t.shape):
            raise ValueError(f"weight {key}: engine {tuple(t.shape)}, "
                             f"benchmark {got}")
        t.copy_(W[key])
    if "lpips.0.w" in W:
        n = sum(1 for k in W if k.startswith("lpips.lin."))
        eng._lpips_params = {
            "convs": [{"w": W[f"lpips.{i}.w"], "b": W[f"lpips.{i}.b"]}
                      for i in range(n)],
            "lins": [W[f"lpips.lin.{i}"] for i in range(n)]}
        eng.lpips_key = "lpips_uncal"


@torch.no_grad()
def snapshot(eng):
    """A copy of the engine's train state under the reference's keys: the
    weights, the spectral-norm vectors ``sn.<grp>.<i>``, each optimizer's
    moments (``m.``, ``v.`` Adam; ``nu.`` RMSprop) of every leaf."""
    own = leaves(eng)
    out = {k: t.detach().clone() for k, t in own.items()}
    for grp, us in (getattr(eng, "sn_state", None) or {}).items():
        for i, u in enumerate(us):
            out[f"sn.{grp}.{i}"] = u.detach().clone()
    key_of = {id(t): k for k, t in own.items()}
    for opt in eng.optimizers():
        for g in opt.param_groups:
            for p in g["params"]:
                st = opt.state.get(p) or {}
                for name, short in (("exp_avg", "m"), ("exp_avg_sq", "v"),
                                    ("square_avg", "nu")):
                    if name in st:
                        out[f"{short}.{key_of[id(p)]}"] = \
                            st[name].detach().clone()
    return out
