"""Trace configuration: which per-slot signals to record, and how often.

Only the spec lives here: the schema field rides inside `SimSpec`, so
scenario specs carry it.  The slot engine of this package does not
record traces yet and refuses specs with tracing enabled.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# Canonical field order of a captured trace.
TRACE_FIELDS: Tuple[str, ...] = ("host_bw", "util", "queue", "ecn",
                                 "eligible")


@dataclass(frozen=True)
class TraceSpec:
    """What to record per slot (`fields`), at what decimation (`every`,
    in slots)."""
    enabled: bool = False
    every: int = 1
    fields: Tuple[str, ...] = TRACE_FIELDS

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    def active_fields(self) -> Tuple[str, ...]:
        """Requested fields in canonical order (capture order)."""
        return tuple(f for f in TRACE_FIELDS if f in self.fields)

    def validate(self) -> None:
        if self.every < 1:
            raise ValueError(f"trace.every must be >= 1, got {self.every}")
        unknown = sorted(set(self.fields) - set(TRACE_FIELDS))
        if unknown:
            raise ValueError(
                f"unknown trace fields {unknown}; valid: {TRACE_FIELDS}")
        if self.enabled and not self.active_fields():
            raise ValueError("trace enabled with no fields selected")
