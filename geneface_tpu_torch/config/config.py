"""Hierarchical YAML configuration (port of ``geneface_tpu/config/config.py``).

``Config`` is a dict with attribute access; :func:`load_config` resolves
``base_config`` parents depth-first (later parents and the child win), lets
a saved ``<work_dir>/config.yaml`` override the chain, and applies
``key=value`` overrides last. ``yaml`` is imported only inside the loaders,
so nothing on the render path needs it.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Mapping

__all__ = ["Config", "load_config", "parse_overrides", "save_config"]


class Config(dict):
    """A dict with attribute access (``cfg.lr`` == ``cfg["lr"]``)."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e


def _deep_merge(dst: dict, src: Mapping) -> dict:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _load_yaml_chain(path: str, seen: tuple = ()) -> dict:
    import yaml

    if path in seen:
        raise ValueError(f"base_config cycle detected at {path} (chain: {seen})")
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    parents = raw.pop("base_config", [])
    if isinstance(parents, str):
        parents = [parents]
    merged: dict = {}
    for parent in parents:
        ppath = parent
        if not os.path.isabs(parent):
            rel = os.path.join(os.path.dirname(path), parent)
            ppath = rel if os.path.exists(rel) else parent
        _deep_merge(merged, _load_yaml_chain(ppath, seen + (path,)))
    _deep_merge(merged, raw)
    return merged


def _parse_value(text: str) -> Any:
    """A CLI override value: a Python literal if it is one, else a string."""
    t = text.strip()
    if t.lower() in ("true", "false"):
        return t.lower() == "true"
    if t.lower() in ("none", "null"):
        return None
    try:
        return ast.literal_eval(t)
    except (ValueError, SyntaxError):
        # the reference's space-separated list syntax: "[1 1 1]"
        if t.startswith("[") and t.endswith("]") and "," not in t:
            try:
                return ast.literal_eval("[" + ",".join(t[1:-1].split()) + "]")
            except (ValueError, SyntaxError):
                pass
        return t


def parse_overrides(spec: str | list | None) -> dict:
    """``"a=1,b=[1 2 3]"`` (or a list of ``k=v``) → ``{key: value}``."""
    if not spec:
        return {}
    if isinstance(spec, str):
        items, depth, cur = [], 0, []
        for ch in spec:  # split on commas outside brackets
            depth += (ch in "[({") - (ch in "])}")
            if ch == "," and depth == 0:
                items.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        items.append("".join(cur))
    else:
        items = list(spec)
    out = {}
    for item in items:
        if not item.strip():
            continue
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        k, v = item.split("=", 1)
        out[k.strip()] = _parse_value(v)
    return out


def load_config(path: str, overrides: str | list | Mapping | None = None,
                work_dir: str | None = None, use_saved: bool = True) -> Config:
    """YAML chain with ``base_config`` inheritance, then the saved
    ``<work_dir>/config.yaml`` (unless ``use_saved`` is false), then
    ``overrides``; ``work_dir`` is set last."""
    cfg = _load_yaml_chain(path)
    saved = os.path.join(work_dir, "config.yaml") if work_dir else None
    if saved and use_saved and os.path.exists(saved):
        import yaml

        with open(saved) as f:
            _deep_merge(cfg, yaml.safe_load(f) or {})
    cfg = Config(cfg)
    ov = dict(overrides) if isinstance(overrides, Mapping) else parse_overrides(overrides)
    cfg.update(ov)
    if work_dir:
        cfg["work_dir"] = work_dir
    return cfg


def save_config(cfg: Mapping, work_dir: str) -> str:
    """Write the resolved config to ``<work_dir>/config.yaml`` atomically."""
    import yaml

    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, "config.yaml")
    with open(path + ".part", "w") as f:
        yaml.safe_dump(copy.deepcopy(dict(cfg)), f, sort_keys=True)
    os.replace(path + ".part", path)
    return path
