"""YAML configurations (a copy of ``irdu_tpu/utils/config.py``): the
``configs/*.yaml`` files drive the trainer, with a check of the required
top-level keys and ``a.b.c=value`` overrides from the command line.

PyYAML is imported inside the functions that parse YAML, so the module
imports where PyYAML is missing (the card's machine): there a caller hands
the ``Trainer`` a dict instead of a path.
"""

from __future__ import annotations

import io
from typing import Any

REQUIRED_TOP_KEYS = ("name", "model", "train")


def load_config(path: str | None = None, text: str | None = None,
                validate: bool = True) -> dict[str, Any]:
    """The configuration at ``path`` (or in ``text``) as a dict; ValueError
    when a required top-level key is missing."""
    import yaml

    if text is None:
        with open(path) as fh:
            text = fh.read()
    conf = yaml.safe_load(io.StringIO(text)) or {}
    if validate:
        missing = [k for k in REQUIRED_TOP_KEYS if k not in conf]
        if missing:
            raise ValueError(f"config missing required keys: {missing}")
    return conf


def apply_overrides(conf: dict[str, Any], overrides: list[str]) -> dict[str, Any]:
    """Apply ``a.b.c=value`` overrides in place, each value YAML-parsed
    (``train.max_steps=800`` is an int, ``eval.datasets={}`` a dict, a bare
    ``1e-4``, a string to YAML 1.1, a float); missing or non-dict parents
    become dicts."""
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"override {item!r} is not of the form key=value")
        node = conf
        parts = key.strip().split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = node[p] = {}
            node = nxt
        node[parts[-1]] = _parse_value(raw)
    return conf


def _parse_value(raw: str):
    import yaml

    val = yaml.safe_load(raw) if raw != "" else None
    if isinstance(val, str):
        try:
            val = float(val)
        except ValueError:
            pass
    return val


def pretty_config(conf: dict, indent: int = 0) -> str:
    """The configuration as indented ``key: value`` lines."""
    lines = []
    for key, value in conf.items():
        pad = "  " * indent
        if isinstance(value, dict):
            lines.append(f"{pad}{key}:")
            lines.append(pretty_config(value, indent + 1))
        else:
            lines.append(f"{pad}{key}: {value}")
    return "\n".join(lines)
