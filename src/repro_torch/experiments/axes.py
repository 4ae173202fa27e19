"""Declarative grid axes.

An `Axis` names one override path and the values it takes; combinators
compose axes into a grid expression:

    product(a, b)   — cartesian product, last axis fastest (C order);
    zip_axes(a, b)  — lockstep iteration (equal lengths required);
    chain(g1, g2)   — run grid g1's points, then g2's.

Every grid lowers to an ordered list of coordinate assignments
`((path, value, label), ...)`; `Experiment` applies the values to the
base spec in order and records the labels as the point's grid
coordinates.  Labels default to the value when it is a plain scalar —
pass `labels=` for unwieldy values (whole fault tuples, inline specs).

Two virtual paths exist on top of real spec fields:

    "scenario" — value is a registry name or a `ScenarioSpec`; replaces
                 the base spec (put this axis first);
    "seed"     — perturbs `sim.seed` *and* `workload_seed` by the value
                 (the same semantics as `SweepGrid.seeds`).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, Union

Coord = Tuple[str, Any, Any]               # (path, value, label)
Point = Tuple[Coord, ...]

SPECIAL_PATHS = ("scenario", "seed")


def _default_label(value: Any) -> Any:
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    name = getattr(value, "name", None)    # ScenarioSpec and friends
    if isinstance(name, str):
        return name
    return repr(value)


@dataclass(frozen=True)
class Axis:
    """One swept dimension: `path` (override path or virtual path) and
    the `values` it takes.  `labels` (same length) are what lands in the
    ResultSet coordinate column; they must be JSON scalars."""
    path: str
    values: Tuple[Any, ...]
    labels: Optional[Tuple[Any, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))
        if self.labels is not None:
            object.__setattr__(self, "labels", tuple(self.labels))
        if not self.values:
            raise ValueError(f"axis {self.path!r} has no values")
        if self.labels is not None and len(self.labels) != len(self.values):
            raise ValueError(
                f"axis {self.path!r}: {len(self.labels)} labels for "
                f"{len(self.values)} values")
        for lab in self.labels or ():
            if not (isinstance(lab, (str, int, float, bool)) or lab is None):
                raise ValueError(
                    f"axis {self.path!r}: label {lab!r} is not a JSON "
                    "scalar")

    def points(self) -> List[Point]:
        labels = (self.labels if self.labels is not None
                  else tuple(_default_label(v) for v in self.values))
        return [((self.path, v, l),) for v, l in zip(self.values, labels)]

    def paths(self) -> Tuple[str, ...]:
        return (self.path,)


GridLike = Union[Axis, "Product", "Zip", "Chain"]


def _as_grid(g) -> GridLike:
    if isinstance(g, (Axis, Product, Zip, Chain)):
        return g
    raise TypeError(
        f"expected an Axis or grid combinator, got {type(g).__name__}: "
        f"{g!r}")


@dataclass(frozen=True)
class Product:
    grids: Tuple[GridLike, ...]

    def points(self) -> List[Point]:
        out = []
        for combo in itertools.product(*(g.points() for g in self.grids)):
            pt: Point = tuple(c for part in combo for c in part)
            seen = [p for p, _, _ in pt]
            dupes = sorted({p for p in seen if seen.count(p) > 1})
            if dupes:
                raise ValueError(
                    f"grid point assigns paths {dupes} more than once")
            out.append(pt)
        return out

    def paths(self) -> Tuple[str, ...]:
        return tuple(p for g in self.grids for p in g.paths())


@dataclass(frozen=True)
class Zip:
    grids: Tuple[GridLike, ...]

    def points(self) -> List[Point]:
        lengths = {len(g.points()) for g in self.grids}
        if len(lengths) > 1:
            raise ValueError(
                f"zip_axes requires equal-length axes; got lengths "
                f"{sorted(len(g.points()) for g in self.grids)}")
        return [tuple(c for part in combo for c in part)
                for combo in zip(*(g.points() for g in self.grids))]

    def paths(self) -> Tuple[str, ...]:
        return tuple(p for g in self.grids for p in g.paths())


@dataclass(frozen=True)
class Chain:
    grids: Tuple[GridLike, ...]

    def points(self) -> List[Point]:
        return [pt for g in self.grids for pt in g.points()]

    def paths(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for g in self.grids:
            for p in g.paths():
                if p not in seen:
                    seen.append(p)
        return tuple(seen)


def product(*grids) -> Product:
    return Product(tuple(_as_grid(g) for g in grids))


def zip_axes(*grids) -> Zip:
    return Zip(tuple(_as_grid(g) for g in grids))


def chain(*grids) -> Chain:
    return Chain(tuple(_as_grid(g) for g in grids))
