"""Hydra-style config composition (the port's copy of
`gpv_tpu/utils/config.py`).

Same semantics as the JAX package's engine: a `defaults:` list composing
config groups, `# @package <target>` directives (`_group_`, `_global_` or
a dotted path), `${a.b.c}` interpolation (a cycle raises), `group=option`
overrides (an unknown option raises) and dotted value overrides. YAML is
read by `yaml_subset` (the card machine has no pyyaml), with YAML 1.2
floats in files (`1e-4` is a float, as hydra reads it).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any

from . import yaml_subset

_INTERP = re.compile(r"\$\{([^}]+)\}")


class ConfigNode(dict):
    """Nested dict with attribute access; values resolved at finalize time."""

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def get_path(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            elif isinstance(cur, (list, tuple)) and part.lstrip("-").isdigit():
                cur = cur[int(part)]
            else:
                return default
        return cur

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        cur = self
        for p in parts[:-1]:
            nxt = cur.get(p)
            if not isinstance(nxt, dict):
                nxt = ConfigNode()
                cur[p] = nxt
            cur = nxt
        cur[parts[-1]] = value


def _to_node(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigNode({k: _to_node(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_node(v) for v in obj]
    return obj


def _parse_scalar(s: str) -> Any:
    """Parse a CLI override value ('null', '1e-4', lists, dicts): numbers
    first, then YAML (1.1 resolution, as `yaml.safe_load` reads it), and
    the text itself when it is not valid YAML."""
    txt = s.strip()
    try:
        return int(txt)
    except ValueError:
        pass
    try:
        return float(txt)
    except ValueError:
        pass
    try:
        return yaml_subset.load(s)
    except yaml_subset.YamlError:
        return s


def _merge(base: Any, over: Any) -> Any:
    """Deep merge: `over` wins; dicts merge recursively."""
    if isinstance(base, dict) and isinstance(over, dict):
        out = ConfigNode(base)
        for k, v in over.items():
            out[k] = _merge(base.get(k), v) if k in base else _to_node(v)
        return out
    return _to_node(over)


class _Missing:
    pass


_MISSING = _Missing()


def _resolve(root: ConfigNode, value: Any, stack: tuple = ()) -> Any:
    """Resolve ${...} interpolations recursively against the root config."""
    if isinstance(value, str):
        m = _INTERP.fullmatch(value.strip())
        if m:  # whole-string interpolation keeps the target's type
            key = m.group(1)
            if key in stack:
                raise ValueError(f"interpolation cycle at ${{{key}}}")
            tgt = root.get_path(key, _MISSING)
            if tgt is _MISSING:
                raise KeyError(f"interpolation target not found: ${{{key}}}")
            return _resolve(root, tgt, stack + (key,))

        def sub(mm):
            key = mm.group(1)
            if key in stack:
                raise ValueError(f"interpolation cycle at ${{{key}}}")
            tgt = root.get_path(key, _MISSING)
            if tgt is _MISSING:
                raise KeyError(f"interpolation target not found: ${{{key}}}")
            return str(_resolve(root, tgt, stack + (key,)))

        return _INTERP.sub(sub, value)
    if isinstance(value, dict):
        return ConfigNode({k: _resolve(root, v, stack)
                           for k, v in value.items()})
    if isinstance(value, list):
        return [_resolve(root, v, stack) for v in value]
    return value


def load_yaml(path: str | Path):
    """(ConfigNode or value, package directive or None) of one file."""
    text = Path(path).read_text()
    m = re.match(r"\s*#\s*@package\s+(\S+)", text)
    data = yaml_subset.load(text, floats12=True) or {}
    return _to_node(data), (m.group(1) if m else None)


def load_config(config_dir: str | Path, config_name: str,
                overrides: list[str] | None = None,
                resolve: bool = True,
                _group_overrides: dict | None = None) -> ConfigNode:
    """Compose a config the hydra way.

    Args:
      config_dir: root config directory (e.g. the repo's `configs/`).
      config_name: primary config, e.g. "exp/gpv" (no extension).
      overrides: "a.b=value" dotted overrides; "group=name" swaps a
        defaults-list group choice (e.g. "learning_datasets=all").

    Returns a fully composed (and, if `resolve`, interpolation-resolved)
    ConfigNode.
    """
    config_dir = Path(config_dir)
    primary, _ = load_yaml(config_dir / f"{config_name}.yaml")
    defaults = primary.pop("defaults", [])
    primary.pop("hydra", None)

    group_overrides: dict[str, str] = dict(_group_overrides or {})
    value_overrides: list[tuple[str, Any]] = []
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        k, v = ov.split("=", 1)
        if (config_dir / k / f"{v}.yaml").exists():
            group_overrides[k] = v
        elif (config_dir / k).is_dir():
            # the key names a config group but the option does not exist:
            # fail as hydra does rather than set a string value
            options = sorted(p.stem for p in (config_dir / k).glob("*.yaml"))
            raise ValueError(
                f"unknown option {v!r} for config group {k!r}; "
                f"available: {options}")
        else:
            value_overrides.append((k, _parse_scalar(v)))

    cfg = ConfigNode()
    for entry in defaults:
        if isinstance(entry, dict):
            (group, name), = entry.items()
        else:
            group, name = None, entry
        if group is None:
            # a plain entry composes another config (its own defaults
            # first); this call's group choices apply inside it too
            sub = load_config(config_dir, name, overrides=None,
                              resolve=False,
                              _group_overrides=group_overrides)
            cfg = _merge(cfg, sub)
            continue
        name = group_overrides.get(group, name)
        sub, package = load_yaml(config_dir / group / f"{name}.yaml")
        if package in (None, "_group_"):
            cfg.set_path(group, sub)  # a group choice replaces the earlier
        elif package == "_global_":
            cfg = _merge(cfg, sub)
        else:
            node = cfg.get_path(package)
            merged = _merge(node, sub) if isinstance(node, dict) else sub
            cfg.set_path(package, merged)

    cfg = _merge(cfg, primary)
    for k, v in value_overrides:
        cfg.set_path(k, _to_node(v))

    if resolve:
        cfg = _resolve(cfg, cfg)
    return cfg


def to_dict(cfg: Any) -> Any:
    """ConfigNode tree -> plain python (for a YAML dump or metadata)."""
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [to_dict(v) for v in cfg]
    return cfg


def save_config(cfg: Any, path: str | Path) -> None:
    Path(path).write_text(yaml_subset.dump(to_dict(cfg)))
