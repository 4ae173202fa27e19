"""On-disk run cache keyed by a content hash of the fully-resolved
per-point `ScenarioSpec`.

The key is a SHA-256 over a *canonical* form of the spec — dataclasses
lowered field-by-field (type name included, so a `FaultSpec` never
collides with a `WorkloadSpec` of equal fields), tuples as lists, dicts
key-sorted — serialized with `json.dumps(sort_keys=True)`.  No `repr`
anywhere: formatting changes can't invalidate or alias entries.  A salt
(derive-hook tag, schema version) folds in anything that changes the
*metrics* without changing the spec.

Entries are one JSON file per key under `root/<k[:2]>/<k>.json`, written
atomically (tmp + rename) so an interrupted sweep never leaves a
half-written entry.  `get` treats unreadable, corrupt, version-skewed,
or key-mismatched files as misses — a poisoned entry costs one re-run,
never a crash or a wrong row.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Any, Optional

import numpy as np

from repro_torch.scenarios.runner import ScenarioMetrics
from repro_torch.scenarios.spec import ScenarioSpec

from .resultset import SCHEMA_VERSION

CACHE_VERSION = 1


def canonicalize(obj: Any) -> Any:
    """Lower specs to a deterministic JSON-ready structure.

    Fields named in a dataclass's `HASH_ELIDE_DEFAULTS` class attribute
    are omitted while they hold their declared default — the additive-
    schema-evolution contract: extending a spec with new defaulted
    fields (e.g. `TopologySpec.kind`) must not re-key every pre-existing
    cache entry."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        elide = getattr(type(obj), "HASH_ELIDE_DEFAULTS", ())
        return {"__dataclass__": type(obj).__name__,
                "fields": {f.name: canonicalize(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)
                           if not (f.name in elide
                                   and f.default is not dataclasses.MISSING
                                   and getattr(obj, f.name) == f.default)}}
    if isinstance(obj, (tuple, list)):
        return [canonicalize(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): canonicalize(obj[k]) for k in sorted(obj)}
    if isinstance(obj, np.generic):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(
        f"cannot canonicalize {type(obj).__name__} for cache hashing: "
        f"{obj!r}")


def spec_key(spec: ScenarioSpec, salt: str = "") -> str:
    """Content hash of a fully-resolved grid point."""
    payload = json.dumps(
        {"cache_version": CACHE_VERSION,
         "metrics_schema": SCHEMA_VERSION,
         "salt": salt,
         "spec": canonicalize(spec)},
        sort_keys=True, allow_nan=True)
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


class RunCache:
    """Directory-backed metrics cache; safe to share across sweeps."""

    def __init__(self, root: str):
        self.root = str(root)

    def path_for(self, key: str) -> str:
        return os.path.join(self.root, key[:2], f"{key}.json")

    def get(self, key: str) -> Optional[ScenarioMetrics]:
        try:
            with open(self.path_for(key), "r", encoding="utf-8") as f:
                entry = json.load(f)
            if entry.get("cache_version") != CACHE_VERSION:
                return None
            if entry.get("key") != key:
                return None
            return ScenarioMetrics.from_dict(entry["metrics"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def put(self, key: str, spec: ScenarioSpec,
            metrics: ScenarioMetrics) -> None:
        path = self.path_for(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        entry = {"cache_version": CACHE_VERSION, "key": key,
                 "spec": canonicalize(spec),
                 "metrics": metrics.to_dict()}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(entry, f, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        n = 0
        for _, _, files in os.walk(self.root):
            n += sum(f.endswith(".json") for f in files)
        return n
