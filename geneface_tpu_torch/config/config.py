"""Hierarchical YAML configuration (port of ``geneface_tpu/config/config.py``).

``Config`` is a dict with attribute access; :func:`load_config` resolves
``base_config`` parents depth-first (later parents and the child win) and
applies ``key=value`` overrides. ``yaml`` is imported only inside the loader,
so nothing on the render path needs it.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping

__all__ = ["Config", "load_config"]


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


def load_config(path: str, overrides: Mapping | None = None) -> Config:
    """YAML chain with ``base_config`` inheritance, then ``overrides``."""
    cfg = Config(_load_yaml_chain(path))
    cfg.update(dict(overrides or {}))
    return cfg
