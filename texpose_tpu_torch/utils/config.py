"""Config system: YAML with recursive ``_parent_`` inheritance plus dotted CLI
overrides.

Capability parity with the reference options system
(the reference TexPose code, options.py:17-141):
  * ``--a.b.c=v``  sets a nested key (value parsed as YAML)
  * ``--flag``     sets a boolean True
  * ``--flag!``    sets a boolean False
  * ``--a.b.c=``   sets None
  * YAML files may declare ``_parent_: path.yaml`` which is loaded first and
    recursively merged (child wins).
Differences (deliberate): no interactive prompts — unknown keys raise unless
``allow_new=True``; snapshotting writes ``options.yaml`` into the run dir and
never blocks on stdin (training jobs are non-interactive).
"""

from __future__ import annotations

import os
import sys
import copy
import yaml


class Config(dict):
    """Dot-accessible nested dict (functional stand-in for easydict)."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = {} if d is None else dict(d)
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, Config._wrap(v))

    # C-level dict methods bypass __setitem__ — wrap here too, or a
    # cfg.setdefault("data", {...}) would store a plain dict whose keys
    # then fail dot access
    def setdefault(self, k, default=None):
        if k not in self:
            self[k] = default
        return self[k]

    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError:
            raise AttributeError(k)

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self):
        def conv(v):
            if isinstance(v, Config):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v
        return conv(self)


def load_yaml(fname: str) -> Config:
    """Load a YAML file, recursively merging ``_parent_`` chains (child wins)."""
    with open(fname) as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config(raw)
    parent = cfg.pop("_parent_", None)
    if parent is not None:
        base_dir = os.path.dirname(os.path.abspath(fname))
        cand = parent if os.path.isabs(parent) else None
        if cand is None:
            for root in (base_dir, os.getcwd(), os.path.dirname(base_dir)):
                p = os.path.join(root, parent)
                if os.path.exists(p):
                    cand = p
                    break
        if cand is None:
            raise FileNotFoundError(f"_parent_ {parent!r} not found relative to {fname!r}")
        parent_cfg = load_yaml(cand)
        cfg = merge(parent_cfg, cfg, allow_new=True)
    return cfg


def merge(base: Config, override: Config, allow_new: bool = False,
          _path: str = "") -> Config:
    """Recursively merge ``override`` into a copy of ``base``.

    With ``allow_new=False``, a key present in ``override`` but absent from
    ``base`` raises KeyError (mirrors the reference's unknown-key guard,
    options.py:83-90, but non-interactive).
    """
    out = copy.deepcopy(base)
    for k, v in override.items():
        here = f"{_path}.{k}" if _path else str(k)
        if k not in out:
            if not allow_new:
                raise KeyError(f"unknown config key: {here}")
            out[k] = copy.deepcopy(v)
        elif isinstance(out[k], Config) and isinstance(v, (dict, Config)):
            out[k] = merge(out[k], Config(v), allow_new=allow_new, _path=here)
        else:
            out[k] = copy.deepcopy(v)
    return out


def parse_cli_overrides(argv) -> Config:
    """Parse ``--a.b.c=value`` style args into a nested Config.

    ``--flag`` → True, ``--flag!`` → False, ``--k=`` → None; values are parsed
    with yaml.safe_load so numbers/lists/bools round-trip.
    """
    cfg = Config()
    for arg in argv:
        if not arg.startswith("--"):
            raise ValueError(f"invalid argument: {arg!r} (expected --key=value)")
        body = arg[2:]
        if "=" not in body:
            if body.endswith("!"):
                keys, value = body[:-1], False
            else:
                keys, value = body, True
        else:
            keys, raw = body.split("=", 1)
            value = None if raw == "" else yaml.safe_load(raw)
        node = cfg
        parts = keys.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = value
    return cfg


def resolve_yaml(name: str) -> str:
    """Resolve a ``--yaml=`` value to a file path.

    Accepts a literal path, or — like the reference's bare-name form
    ``--yaml=nerf_lm_adapt_gan`` → ``options/<name>.yaml``
    (options.py:50-51) — a name resolved against ``configs/`` in the
    current directory or next to the installed package.
    """
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    base = str(name) if str(name).endswith((".yaml", ".yml")) \
        else str(name) + ".yaml"
    tried = []
    # path-style names (e.g. "configs/x.yaml") also resolve package-relative
    # when run from outside the repo: join pkg_root directly AND with a
    # stripped leading "configs/" so both spellings work from anywhere.
    cands = [str(name), base,
             os.path.join("configs", base),
             os.path.join(pkg_root, base),
             os.path.join(pkg_root, "configs",
                          base[len("configs/"):] if base.startswith("configs/")
                          else base)]
    for cand in cands:
        if os.path.isfile(cand):
            return cand
        tried.append(cand)
    raise FileNotFoundError(
        f"--yaml={name!r}: no config found (tried {tried})")


def set_options(argv=None, default_yaml=None, allow_new=True) -> Config:
    """Full option bootstrap: CLI → yaml load → merge → postprocess.

    Mirrors the reference ``options.set`` flow: the ``--yaml=...`` arg selects
    the config file; remaining dotted args override it.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    cli = parse_cli_overrides(argv)
    yaml_file = cli.pop("yaml", default_yaml)
    if yaml_file:
        yaml_file = resolve_yaml(yaml_file)
        cfg = load_yaml(yaml_file)
        cfg.yaml = yaml_file
    else:
        cfg = Config()
    cfg = merge(cfg, cli, allow_new=allow_new)
    return process_options(cfg)


def process_options(cfg: Config) -> Config:
    """Seed/output-path post-processing (reference options.py:95-115)."""
    cfg.setdefault("seed", 0)
    cfg.setdefault("group", "default")
    cfg.setdefault("name", "debug")
    cfg.setdefault("output_root", "output")
    if cfg.get("seed", 0) != 0 and cfg.get("name"):
        if not str(cfg.name).endswith(f"_seed{cfg.seed}"):
            cfg.name = f"{cfg.name}_seed{cfg.seed}"
    cfg.output_path = os.path.join(str(cfg.output_root), str(cfg.group), str(cfg.name))
    if cfg.get("data") and cfg.data.get("image_size"):
        cfg.H, cfg.W = cfg.data.image_size
    return cfg


def save_options_file(cfg: Config, output_path: str | None = None):
    """Snapshot the active config to ``<output_path>/options.yaml``."""
    output_path = output_path or cfg.output_path
    os.makedirs(output_path, exist_ok=True)
    fname = os.path.join(output_path, "options.yaml")
    with open(fname, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, default_flow_style=False, sort_keys=False)
    return fname
