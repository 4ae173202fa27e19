"""Override paths: address any field of a (nested, frozen) `ScenarioSpec`
by a dotted string with optional sequence indices —

    "sim.routing"          -> spec.sim.routing
    "faults[0].frac"       -> spec.faults[0].frac
    "topo.n_planes"        -> spec.topo.n_planes
    "workloads[1].demand"  -> spec.workloads[1].demand
    "faults"               -> the whole fault tuple

`apply_override` returns a *new* spec (dataclass `replace` all the way
down — specs stay frozen and hashable), validating each step: unknown
field names, out-of-range indices, indexing a non-sequence, and leaf
type mismatches all raise `OverridePathError` with the full path in the
message.  This is the substrate `Experiment` axes lower through.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Union

PathStep = Union[str, int]

_STEP_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)((?:\[\d+\])*)$")
_INDEX_RE = re.compile(r"\[(\d+)\]")


class OverridePathError(ValueError):
    """An override path failed to parse, resolve, or type-check."""


def parse_path(path: str) -> List[PathStep]:
    """'faults[0].frac' -> ['faults', 0, 'frac']."""
    if not isinstance(path, str) or not path.strip():
        raise OverridePathError(f"empty override path {path!r}")
    steps: List[PathStep] = []
    for part in path.split("."):
        m = _STEP_RE.match(part)
        if not m:
            raise OverridePathError(
                f"malformed override path {path!r}: cannot parse "
                f"segment {part!r} (expected name or name[index])")
        steps.append(m.group(1))
        steps.extend(int(i) for i in _INDEX_RE.findall(m.group(2)))
    return steps


def _type_name(v: Any) -> str:
    return type(v).__name__


def _check_leaf_type(path: str, old: Any, new: Any) -> Any:
    """Value compatibility against the current leaf value.  Returns the
    (possibly coerced) value: int -> float promotion and list -> tuple
    are allowed; everything else must match the existing kind."""
    if old is None:                      # Optional field — can't infer
        return new
    if isinstance(old, bool):
        if not isinstance(new, bool):
            raise OverridePathError(
                f"override {path!r}: expected bool, got "
                f"{_type_name(new)} ({new!r})")
        return new
    if isinstance(old, int) and not isinstance(old, bool):
        if not isinstance(new, int) or isinstance(new, bool):
            raise OverridePathError(
                f"override {path!r}: expected int, got "
                f"{_type_name(new)} ({new!r})")
        return new
    if isinstance(old, float):
        if not isinstance(new, (int, float)) or isinstance(new, bool):
            raise OverridePathError(
                f"override {path!r}: expected float, got "
                f"{_type_name(new)} ({new!r})")
        return float(new)
    if isinstance(old, str):
        if not isinstance(new, str):
            raise OverridePathError(
                f"override {path!r}: expected str, got "
                f"{_type_name(new)} ({new!r})")
        return new
    if isinstance(old, tuple):
        if not isinstance(new, (tuple, list)):
            raise OverridePathError(
                f"override {path!r}: expected tuple, got "
                f"{_type_name(new)} ({new!r})")
        return tuple(new)
    if dataclasses.is_dataclass(old):
        if type(new) is not type(old):
            raise OverridePathError(
                f"override {path!r}: expected {_type_name(old)}, got "
                f"{_type_name(new)} ({new!r})")
        return new
    return new                            # pragma: no cover — no such leaf


def _set(obj: Any, steps: List[PathStep], value: Any, path: str) -> Any:
    if not steps:
        return _check_leaf_type(path, obj, value)
    step, rest = steps[0], steps[1:]
    if isinstance(step, int):
        if not isinstance(obj, (tuple, list)):
            raise OverridePathError(
                f"override {path!r}: index [{step}] into a "
                f"{_type_name(obj)} (not a sequence)")
        if not 0 <= step < len(obj):
            raise OverridePathError(
                f"override {path!r}: index [{step}] out of range for "
                f"length {len(obj)}")
        items = list(obj)
        items[step] = _set(items[step], rest, value, path)
        return tuple(items)
    if not dataclasses.is_dataclass(obj):
        raise OverridePathError(
            f"override {path!r}: field {step!r} on a "
            f"{_type_name(obj)} (not a spec dataclass)")
    names = [f.name for f in dataclasses.fields(obj)]
    if step not in names:
        raise OverridePathError(
            f"override {path!r}: {_type_name(obj)} has no field "
            f"{step!r}; known fields: {names}")
    return dataclasses.replace(
        obj, **{step: _set(getattr(obj, step), rest, value, path)})


def apply_override(spec: Any, path: str, value: Any) -> Any:
    """Return a copy of `spec` with the field at `path` set to `value`."""
    return _set(spec, parse_path(path), value, path)


def get_path(spec: Any, path: str) -> Any:
    """Read the current value at `path` (same grammar as overrides)."""
    obj = spec
    for step in parse_path(path):
        if isinstance(step, int):
            if not isinstance(obj, (tuple, list)):
                raise OverridePathError(
                    f"path {path!r}: index [{step}] into a "
                    f"{_type_name(obj)}")
            if not 0 <= step < len(obj):
                raise OverridePathError(
                    f"path {path!r}: index [{step}] out of range for "
                    f"length {len(obj)}")
            obj = obj[step]
        else:
            if not dataclasses.is_dataclass(obj) or not hasattr(obj, step):
                raise OverridePathError(
                    f"path {path!r}: no field {step!r} on "
                    f"{_type_name(obj)}")
            obj = getattr(obj, step)
    return obj
