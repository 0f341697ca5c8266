"""YAML configs: ``base_config`` inheritance and ``${...}`` interpolation.

Counterpart of ``vidtome_tpu/config.py`` (the same YAML files drive both
packages): a recursive ``base_config`` chain (child values override the
base's), the generation prompt normalised from ``str`` to ``{"edit": str}``,
``${key.path}`` interpolation against the root, and config snapshots beside
stage outputs without the other stage's section.  PyYAML and a dict with
attribute access; no JAX.
"""

from __future__ import annotations

import argparse
import copy
import os
import re
from typing import Any, Mapping

import yaml

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Config(dict):
    """A dict whose nested mappings are Configs, with attribute access:
    ``cfg.generation.prompt`` is ``cfg["generation"]["prompt"]``.  A
    missing attribute raises AttributeError (``cfg.get`` and ``in`` are the
    optional paths)."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = v

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def merge_configs(base: Mapping, override: Mapping) -> Config:
    """``override`` deep-merged on top of ``base`` (override wins)."""
    out = Config(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = v
    return out


def _lookup(root: Mapping, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        node = node[part]
    return node


def resolve_interpolations(cfg: Config, max_passes: int = 10) -> Config:
    """Resolve ``${a.b.c}`` against the root, pass after pass until nothing
    changes (a reference may resolve to a string holding another).  A value
    that is one whole reference takes the referenced value's type."""

    def resolve_value(v: Any) -> Any:
        if not isinstance(v, str):
            return v
        full = _INTERP_RE.fullmatch(v)
        if full:
            return _lookup(cfg, full.group(1))
        return _INTERP_RE.sub(lambda m: str(_lookup(cfg, m.group(1))), v)

    def walk(node: Any) -> tuple[Any, bool]:
        if isinstance(node, Mapping):
            changed = False
            for k in list(node.keys()):
                new, ch = walk(node[k])
                if ch:
                    node[k] = new
                    changed = True
            return node, changed
        if isinstance(node, list):
            pairs = [walk(item) for item in node]
            return [p[0] for p in pairs], any(p[1] for p in pairs)
        new = resolve_value(node)
        return new, new is not node and new != node

    for _ in range(max_passes):
        if not walk(cfg)[1]:
            break
    return cfg


def load_yaml(path: str) -> Config:
    with open(path) as f:
        return Config(yaml.safe_load(f) or {})


def load_config_file(path: str, resolve: bool = True) -> Config:
    """A YAML config with its ``base_config`` chain merged beneath it, the
    generation prompt normalised and the interpolations resolved."""
    config = load_yaml(path)
    cur_path, cur = path, config
    seen = {os.path.abspath(path)}
    while "base_config" in cur and cur.base_config != cur_path:
        base_path = cur.base_config
        if os.path.abspath(base_path) in seen:
            break
        seen.add(os.path.abspath(base_path))
        base = load_yaml(base_path)
        config = merge_configs(base, config)
        cur_path, cur = base_path, base

    if "generation" in config and "prompt" in config.generation:
        if isinstance(config.generation.prompt, str):
            config.generation.prompt = Config(
                {"edit": config.generation.prompt})
    if resolve:
        resolve_interpolations(config)
    return config


def load_config(argv: list[str] | None = None,
                print_config: bool = True) -> Config:
    """The CLI's config: ``--config <path>`` (other arguments ignored)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="configs/tea-pour.yaml",
                        help="Config file path")
    args, _ = parser.parse_known_args(argv)
    config = load_config_file(args.config)
    if print_config:
        print("[INFO] loaded config:")
        print(yaml.safe_dump(config.to_dict(), sort_keys=False))
    return config


def save_config(config: Mapping, path: str, gene: bool = False,
                inv: bool = False) -> None:
    """Write ``config.yaml`` under ``path``, without the generation section
    beside inversion outputs (``inv``) and without the inversion section
    beside generation outputs (``gene``)."""
    os.makedirs(path, exist_ok=True)
    snap = copy.deepcopy(Config(config))
    if gene:
        snap.pop("inversion", None)
    if inv:
        snap.pop("generation", None)
    with open(os.path.join(path, "config.yaml"), "w") as f:
        yaml.safe_dump(snap.to_dict(), f, sort_keys=False)
