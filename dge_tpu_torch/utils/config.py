"""YAML config file + dotted CLI overrides.

JAX counterpart: ``dge_tpu/utils/config.py``. ``yaml`` is imported only
when a config file is read; dotted overrides are parsed without it (JSON
scalars: numbers, true/false/null, quoted strings, lists; anything else
stays a string), so the CLI runs where PyYAML is not installed.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, Dict, List, Optional


def _parse_scalar(s: str) -> Any:
    for text in (s, s.lower()):
        try:
            return json.loads(text)
        except ValueError:
            pass
    return s


def apply_dotlist(cfg: Dict[str, Any], dotlist: List[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` overrides (the reference's OmegaConf
    from_dotlist, utils/config.py:99-109)."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override '{item}' is not key=value")
        key, value = item.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"cannot override non-dict node at {p} in {key}")
        node[parts[-1]] = _parse_scalar(value)
    return cfg


def load_config(path: Optional[str],
                overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """The YAML file at ``path`` (none: an empty config) with ``overrides``
    applied."""
    cfg: Dict[str, Any] = {}
    if path:
        import yaml

        with open(path) as f:
            cfg = yaml.safe_load(f) or {}
    if overrides:
        apply_dotlist(cfg, overrides)
    return cfg


def parse_structured(cls, cfg: Optional[Dict[str, Any]] = None):
    """Instantiate a dataclass from a dict, recursing into dataclass fields
    (reference parse_structured, utils/config.py:121-123); an unknown key
    raises."""
    cfg = cfg or {}
    if not dataclasses.is_dataclass(cls):
        return cfg
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in cfg.items():
        if k not in fields:
            raise ValueError(f"unknown config key '{k}' for {cls.__name__}")
        ftype = fields[k].type
        if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[k] = parse_structured(ftype, v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def make_trial_dir(exp_root: str, name: str, tag: str,
                   timestamp: Optional[str] = None) -> str:
    """outputs/<name>/<tag>@<timestamp> trial layout (ExperimentConfig,
    utils/config.py:46-96)."""
    ts = timestamp or datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    trial = os.path.join(exp_root, name, f"{tag}@{ts}")
    os.makedirs(trial, exist_ok=True)
    return trial
