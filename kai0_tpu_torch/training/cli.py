"""The training entry point's command line: ``<config-name> [--field.path=value ...]``.

Counterpart of ``kai0_tpu/training/cli.py:18-123``, on the port's registry:
any dataclass field of the named config is overridable by its dotted path
(``--optimizer.state_dtype=int8``, ``--data.base_config.prompt_from_task=true``,
an ``Optional`` dataclass left at None is instantiated from its annotation),
values convert to the current value's type (bool, int, float, comma lists)
or the annotation's, ``none``/``null`` give None, a bare ``--flag`` is true,
and an unknown config or field name gets did-you-mean suggestions.
"""

from __future__ import annotations

import dataclasses
import difflib
import sys
import types
import typing


def parse_overrides(obj, overrides: dict[str, str]):
    """Apply ``{"a.b.c": "value"}`` overrides to a (frozen) dataclass tree."""
    for path, raw in overrides.items():
        obj = _set_path(obj, path.split("."), raw)
    return obj


def _set_path(obj, parts: list[str], raw: str):
    name = parts[0]
    if not dataclasses.is_dataclass(obj):
        raise ValueError(f"Cannot override field {name!r} on non-dataclass {type(obj).__name__}")
    fields = {f.name: f for f in dataclasses.fields(obj)}
    if name not in fields:
        close = difflib.get_close_matches(name, fields, n=3)
        raise ValueError(f"Unknown field {name!r} on {type(obj).__name__}. Did you mean: {close}?")
    current = getattr(obj, name)
    if len(parts) > 1:
        if current is None:
            # Optional[dataclass] left at None (e.g. DataConfigFactory.base_config,
            # whose consumers treat None as "default DataConfig"): instantiate the
            # default so dotted overrides can reach inside —
            # ``--data.base_config.augment_mirror=True`` works on any config.
            try:
                ann = typing.get_type_hints(type(obj)).get(name)
            except Exception:  # noqa: BLE001 — unresolvable annotation: report None below
                ann = None
            for arg in typing.get_args(ann) or (ann,):
                if dataclasses.is_dataclass(arg):
                    current = arg()
                    break
            if current is None:
                raise ValueError(
                    f"Cannot override {'.'.join(parts)}: field {name!r} is None"
                )
        value = _set_path(current, parts[1:], raw)
    else:
        value = _convert(raw, current, fields[name].type)
    return dataclasses.replace(obj, **{name: value})


def _convert(raw: str, current, annotation):
    if raw.lower() in ("none", "null"):
        return None
    # Prefer converting to the current value's type; fall back to the annotation.
    target = type(current) if current is not None else _annotation_type(annotation)
    if target is bool or isinstance(current, bool):
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"Cannot parse boolean from {raw!r}")
    if target is int:
        return int(raw)
    if target is float:
        return float(raw)
    if target in (list, tuple):
        items = [s for s in raw.split(",") if s]
        elem = type(current[0]) if current else str
        return target(elem(s) for s in items)
    return raw


def _annotation_type(annotation):
    if isinstance(annotation, str):
        # Postponed evaluation (from __future__ import annotations) stores field
        # types as strings; resolve the common scalar forms ("int | None", ...).
        base = annotation.split("|")[0].strip()
        return {"int": int, "float": float, "bool": bool, "str": str}.get(base, str)
    origin = typing.get_origin(annotation)
    if origin is typing.Union or isinstance(annotation, types.UnionType):
        for arg in typing.get_args(annotation):
            if arg is not type(None):
                return _annotation_type(arg)
    return annotation if isinstance(annotation, type) else str


def cli(configs: dict[str, object], argv: list[str] | None = None):
    """Select a named config and apply --key=value overrides."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("-"):
        names = "\n  ".join(sorted(configs))
        raise SystemExit(f"Usage: <config-name> [--field.path=value ...]\nAvailable configs:\n  {names}")
    name = argv[0]
    if name not in configs:
        close = difflib.get_close_matches(name, configs.keys(), n=5)
        raise SystemExit(f"Unknown config {name!r}. Did you mean one of: {close}?")

    overrides = {}
    i = 1
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"Unexpected argument: {arg!r}")
        key = arg[2:]
        if "=" in key:
            key, value = key.split("=", 1)
        else:
            if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
                value = "true"  # bare flag
            else:
                i += 1
                value = argv[i]
        overrides[key.replace("-", "_") if "." not in key else key] = value
        i += 1

    return parse_overrides(configs[name], overrides)
