"""Columnar experiment results.

A `ResultSet` replaces `List[ScenarioMetrics]` + hand-rolled CSV: one
typed column per metric field (names and kinds come from the single
`runner.METRIC_FIELDS` table), one `axis.<path>` column per grid axis
(holding that point's coordinate label), and per-run `extra` metrics as
a JSON column.  Rows stream in while an experiment runs; queries
(`filter` / `group_by` / `pivot` / `summary`) and lossless JSON / CSV
serialization (schema-versioned) operate on the finished set.

Column kinds: "str" | "int" | "float" | "bool" for scalars, "json" for
structured values (tenant dicts, tuple-valued recovery columns, extra).
Coordinate columns are "json"-kinded so CSV cells round-trip exact types
(NaN floats survive both formats).
"""
from __future__ import annotations

import csv
import io
import json
import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.scenarios.runner import (METRIC_FIELDS, METRIC_KINDS,
                                    TRACE_METRIC_DEFAULTS, ScenarioMetrics,
                                    metric_value)

SCHEMA_VERSION = 1

METRIC_COLUMNS: Tuple[str, ...] = tuple(n for n, _, _ in METRIC_FIELDS)

# Columns that may be absent from serializations written before they
# existed — deserialization backfills the default instead of raising.
_BACKFILL_COLUMNS: Dict[str, Any] = dict(TRACE_METRIC_DEFAULTS)

def _std(xs: List[float]) -> float:
    mu = sum(xs) / len(xs)
    return math.sqrt(sum((x - mu) ** 2 for x in xs) / len(xs))


_AGGS: Dict[str, Callable[[List[float]], float]] = {
    "mean": lambda xs: sum(xs) / len(xs),
    "min": min,
    "max": max,
    "sum": sum,
    "std": _std,
    "count": len,
}


def axis_column(path: str) -> str:
    """ResultSet column name of a grid axis (`faults[0].frac` ->
    `axis.faults[0].frac`) — prefixed so axis paths can never collide
    with metric columns like `seed` or `nic`."""
    return f"axis.{path}"


def _jsonify(v: Any) -> Any:
    """Tuples -> lists (JSON has no tuples); dicts copied."""
    if isinstance(v, dict):
        return {str(k): _jsonify(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return [_jsonify(x) for x in v]
    return v


class ResultSet:
    """Columnar store: `self._cols[name]` is the column list; all
    columns share length.  `coord_names` are axis paths (unprefixed)."""

    def __init__(self, coord_names: Sequence[str] = ()):
        self.coord_names: List[str] = list(coord_names)
        self._cols: Dict[str, List] = {n: [] for n in self.column_names}
        self._order: List[int] = []          # grid ordinal per row
        self.cache_hits = 0
        self.cache_misses = 0
        # executor flight-recorder summary (per-point wall clock,
        # dispatch/compile counts); attached by `run_experiment`
        self.flight: Optional[Dict[str, Any]] = None

    # ---- shape ----------------------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return ([axis_column(p) for p in self.coord_names]
                + list(METRIC_COLUMNS))

    def column_kind(self, name: str) -> str:
        if name in METRIC_KINDS:
            return METRIC_KINDS[name]
        if name.startswith("axis.") and name[5:] in self.coord_names:
            return "json"
        raise KeyError(f"unknown column {name!r}; "
                       f"known: {self.column_names}")

    def __len__(self) -> int:
        return len(self._cols[METRIC_COLUMNS[0]])

    def column(self, name: str) -> List:
        if name not in self._cols:
            raise KeyError(f"unknown column {name!r}; "
                           f"known: {self.column_names}")
        return list(self._cols[name])

    def rows(self) -> List[Dict[str, Any]]:
        names = self.column_names
        return [{n: self._cols[n][i] for n in names}
                for i in range(len(self))]

    # ---- building -------------------------------------------------------
    def append(self, m: ScenarioMetrics,
               coords: Optional[Dict[str, Any]] = None,
               order: Optional[int] = None) -> None:
        coords = coords or {}
        unknown = sorted(set(coords) - set(self.coord_names))
        if unknown:
            raise KeyError(
                f"coords {unknown} are not declared axes "
                f"{self.coord_names}")
        for p in self.coord_names:
            self._cols[axis_column(p)].append(coords.get(p))
        for name in METRIC_COLUMNS:
            v = metric_value(m, name)
            if METRIC_KINDS[name] == "json":
                v = _jsonify(v)
            self._cols[name].append(v)
        self._order.append(len(self._order) if order is None else order)

    def extend(self, other: "ResultSet") -> None:
        """Append another set's rows (coordinate columns are unioned;
        rows missing an axis get None there)."""
        for p in other.coord_names:
            if p not in self.coord_names:
                self.coord_names.append(p)
                self._cols[axis_column(p)] = [None] * len(self)
        base = (max(self._order) + 1) if self._order else 0
        for i in range(len(other)):
            for p in self.coord_names:
                col = axis_column(p)
                v = other._cols[col][i] if col in other._cols else None
                self._cols[col].append(v)
            for n in METRIC_COLUMNS:
                self._cols[n].append(other._cols[n][i])
            self._order.append(base + other._order[i])

    def sort_to_grid_order(self) -> None:
        """Re-order rows by grid ordinal — streaming appends rows in
        completion order; this restores the declared grid order."""
        perm = sorted(range(len(self)), key=self._order.__getitem__)
        for n in self._cols:
            col = self._cols[n]
            self._cols[n] = [col[i] for i in perm]
        self._order = [self._order[i] for i in perm]

    def to_metrics(self) -> List[ScenarioMetrics]:
        """Reconstruct the `ScenarioMetrics` records (row order)."""
        derived = ("worst_recovery_slots",)      # recomputed, not stored
        keys = [n for n in METRIC_COLUMNS if n not in derived]
        return [ScenarioMetrics.from_dict({k: r[k] for k in keys})
                for r in self.rows()]

    # ---- queries --------------------------------------------------------
    def _subset(self, idxs: Iterable[int]) -> "ResultSet":
        rs = ResultSet(self.coord_names)
        for i in idxs:
            for n in self._cols:
                rs._cols[n].append(self._cols[n][i])
            rs._order.append(self._order[i])
        return rs

    def filter(self, pred: Optional[Callable[[Dict], bool]] = None,
               **eq) -> "ResultSet":
        """Rows where `pred(row_dict)` holds and/or column == value for
        every `column=value` kwarg (axis columns via their full
        `axis.<path>` name, passed through a dict if not an identifier)."""
        for k in eq:
            if k not in self._cols:
                raise KeyError(f"unknown column {k!r}; "
                               f"known: {self.column_names}")
        names = self.column_names
        keep = []
        for i in range(len(self)):
            row = {n: self._cols[n][i] for n in names}
            if any(row[k] != v for k, v in eq.items()):
                continue
            if pred is not None and not pred(row):
                continue
            keep.append(i)
        return self._subset(keep)

    def group_by(self, *names: str) -> Dict[Tuple, "ResultSet"]:
        for n in names:
            if n not in self._cols:
                raise KeyError(f"unknown column {n!r}; "
                               f"known: {self.column_names}")
        groups: Dict[Tuple, List[int]] = {}
        for i in range(len(self)):
            key = tuple(self._cols[n][i] for n in names)
            groups.setdefault(key, []).append(i)
        return {k: self._subset(v) for k, v in groups.items()}

    def pivot(self, index: str, columns: str, values: str,
              agg: str = "mean") -> Dict[Any, Dict[Any, float]]:
        """{index_label: {column_label: agg(values)}} — e.g.
        `pivot("axis.faults[0].frac", "nic", "mean_goodput")`."""
        if agg not in _AGGS:
            raise ValueError(f"unknown agg {agg!r}; known: "
                             f"{sorted(_AGGS)}")
        cells: Dict[Any, Dict[Any, List[float]]] = {}
        for i in range(len(self)):
            r = cells.setdefault(self._cols[index][i], {})
            r.setdefault(self._cols[columns][i], []).append(
                self._cols[values][i])
        return {ri: {ci: _AGGS[agg](vs) for ci, vs in row.items()}
                for ri, row in cells.items()}

    def summary(self, values: Sequence[str] = ("mean_goodput",),
                by: Sequence[str] = ()) -> Dict:
        """Per-group mean/std/min/max/count of the value columns.
        Without `by`, one group keyed by ()."""
        groups = self.group_by(*by) if by else {(): self}
        out: Dict = {}
        for key, rs in groups.items():
            stats = {}
            for v in values:
                xs = [x for x in rs.column(v)
                      if isinstance(x, (int, float))
                      and not (isinstance(x, float) and math.isnan(x))]
                stats[v] = ({"mean": _AGGS["mean"](xs),
                             "std": _AGGS["std"](xs),
                             "min": min(xs), "max": max(xs),
                             "count": len(xs)} if xs
                            else {"mean": float("nan"),
                                  "std": float("nan"),
                                  "min": float("nan"),
                                  "max": float("nan"), "count": 0})
            out[key] = stats
        return out

    # ---- serialization --------------------------------------------------
    def to_json(self) -> str:
        doc = {"schema_version": SCHEMA_VERSION,
               "coord_names": self.coord_names,
               "n_rows": len(self),
               "columns": {n: self._cols[n] for n in self.column_names}}
        if self.flight is not None:
            doc["flight"] = self.flight
        return json.dumps(doc, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ResultSet":
        d = json.loads(text)
        ver = d.get("schema_version")
        if ver != SCHEMA_VERSION:
            raise ValueError(
                f"ResultSet schema version {ver!r} != supported "
                f"{SCHEMA_VERSION}")
        rs = cls(d["coord_names"])
        n_rows = int(d.get("n_rows", 0))
        for n in rs.column_names:
            if n not in d["columns"]:
                if n in _BACKFILL_COLUMNS:
                    rs._cols[n] = [_jsonify(_BACKFILL_COLUMNS[n])
                                   for _ in range(n_rows)]
                    continue
                raise ValueError(f"ResultSet JSON missing column {n!r}")
            rs._cols[n] = list(d["columns"][n])
        lens = {len(c) for c in rs._cols.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged ResultSet columns: lengths {lens}")
        rs._order = list(range(len(rs)))
        rs.flight = d.get("flight")
        return rs

    def to_csv(self) -> str:
        """Lossless CSV: scalar columns as plain text, json-kinded
        columns (and axis coordinates) as JSON-encoded cells."""
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        names = self.column_names
        w.writerow(names)
        for i in range(len(self)):
            row = []
            for n in names:
                v = self._cols[n][i]
                if self.column_kind(n) == "json":
                    row.append(json.dumps(v, sort_keys=True))
                elif isinstance(v, float) and math.isnan(v):
                    row.append("nan")
                else:
                    row.append(str(v))
            w.writerow(row)
        return buf.getvalue()

    @classmethod
    def from_csv(cls, text: str) -> "ResultSet":
        rows = list(csv.reader(io.StringIO(text)))
        if not rows:
            raise ValueError("empty ResultSet CSV")
        header = rows[0]
        coord_names = [n[5:] for n in header if n.startswith("axis.")]
        missing = [n for n in METRIC_COLUMNS if n not in header
                   and n not in _BACKFILL_COLUMNS]
        if missing:
            raise ValueError(f"ResultSet CSV missing columns {missing}")
        rs = cls(coord_names)
        parsers = {"str": str, "int": int, "float": float,
                   "bool": lambda s: s == "True", "json": json.loads}
        backfill = [n for n in METRIC_COLUMNS if n not in header]
        for cells in rows[1:]:
            for n, cell in zip(header, cells):
                if n in rs._cols:
                    rs._cols[n].append(parsers[rs.column_kind(n)](cell))
            for n in backfill:
                rs._cols[n].append(_jsonify(_BACKFILL_COLUMNS[n]))
            rs._order.append(len(rs._order))
        lens = {len(c) for c in rs._cols.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged ResultSet CSV: column lengths "
                             f"{lens}")
        return rs
