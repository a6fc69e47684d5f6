"""Hydra-compatible config shell (no hydra dependency).

The port's own copy of ``bacs_tpu/config/core.py`` (``Config``,
``parse_overrides``, ``load_config``): the same ``conf/`` trees and the
same command-line grammar as ``main.py``, for ``bacs_tpu_torch.main``:

    python -m bacs_tpu_torch.main --config-path conf/bacs \
        --config-name bacs_plus_config training.batch_size=4 \
        +training.steps_per_class=100 loss=mib

- a root yaml with a `defaults:` list of {group: name} entries, each loaded
  from `<config_path>/<group>/<name>.yaml` into `config[group]`
- `# @package _group_` headers (implicit: group files nest under their group)
- override grammar: `key=value` (dotted paths), `+key=value` (add new key),
  `group=name` (swap a defaults-group file), `~key` (delete)
- `_target_` strings are left in place; the registry layers
  (models/methods/train) resolve them instead of arbitrary import.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import yaml


class Config(dict):
    """Nested dict with attribute access (a light DictConfig stand-in)."""

    def __getattr__(self, item):
        try:
            v = self[item]
        except KeyError as e:
            raise AttributeError(item) from e
        return v

    def __setattr__(self, key, value):
        self[key] = value

    @staticmethod
    def _wrap(obj):
        if isinstance(obj, dict) and not isinstance(obj, Config):
            return Config({k: Config._wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config._wrap(v) for v in obj]
        return obj

    def to_dict(self) -> Dict[str, Any]:
        def _un(o):
            if isinstance(o, dict):
                return {k: _un(v) for k, v in o.items()}
            if isinstance(o, list):
                return [_un(v) for v in o]
            return o

        return _un(self)


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _parse_value(text: str) -> Any:
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _set_path(cfg: Dict[str, Any], dotted: str, value: Any, allow_new: bool):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if not allow_new and p not in node:
                raise KeyError(
                    f"Override path {dotted!r} not in config (use +{dotted})"
                )
            node[p] = Config()
        node = node[p]
    if not allow_new and parts[-1] not in node:
        raise KeyError(f"Override key {dotted!r} not in config (use +{dotted})")
    node[parts[-1]] = value


def parse_overrides(args: Sequence[str]):
    """Split CLI args into (group_swaps, sets, adds, deletes)."""
    group_swaps: Dict[str, str] = {}
    sets: List[tuple] = []
    adds: List[tuple] = []
    deletes: List[str] = []
    for arg in args:
        if arg.startswith("~"):
            deletes.append(arg[1:])
            continue
        if "=" not in arg:
            raise ValueError(f"Bad override {arg!r} (expected key=value)")
        key, value = arg.split("=", 1)
        if key.startswith("+"):
            adds.append((key[1:], _parse_value(value)))
        elif "." not in key:
            # may be a defaults-group swap OR a top-level set; decided later
            group_swaps[key] = value
        else:
            sets.append((key, _parse_value(value)))
    return group_swaps, sets, adds, deletes


def load_config(
    config_path: str,
    config_name: str,
    overrides: Optional[Sequence[str]] = None,
) -> Config:
    root_file = os.path.join(config_path, f"{config_name}.yaml")
    root = _load_yaml(root_file)
    defaults = root.pop("defaults", [])
    root.pop("hydra", None)

    group_swaps, sets, adds, deletes = parse_overrides(overrides or [])

    cfg: Dict[str, Any] = {}
    for entry in defaults:
        if isinstance(entry, str):
            continue  # e.g. `- _self_`
        (group, name), = entry.items()
        if group in group_swaps:
            name = group_swaps.pop(group)
        group_file = os.path.join(config_path, group, f"{name}.yaml")
        cfg[group] = _load_yaml(group_file)
    # root-level keys override/extend group content
    for k, v in root.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k].update(v)
        else:
            cfg[k] = v
    # remaining non-dotted overrides are top-level sets
    for key, value in group_swaps.items():
        cfg[key] = _parse_value(value)
    for key, value in sets:
        _set_path(cfg, key, value, allow_new=False)
    for key, value in adds:
        _set_path(cfg, key, value, allow_new=True)
    for key in deletes:
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.get(p, {})
        node.pop(parts[-1], None)
    return Config._wrap(cfg)
