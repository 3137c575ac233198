"""Column/table statistics for pruning and cost estimation.

Reference: src/daft-stats/src/lib.rs — ``ColumnRangeStatistics`` /
``TableStatistics`` / ``TableMetadata`` drive row-group pruning, broadcast-join
decisions and optimizer cost estimates.

Port of ``daft_tpu/stats.py``; ``estimate_selectivity`` is the filter
estimate behind the plan nodes' ``approx_stats``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class ColumnRangeStatistics:
    """[lower, upper] bounds plus null count; None bounds mean unknown."""

    lower: Any = None
    upper: Any = None
    null_count: Optional[int] = None

    def is_missing(self) -> bool:
        return self.lower is None and self.upper is None

    def union(self, other: "ColumnRangeStatistics") -> "ColumnRangeStatistics":
        def _min(a, b):
            if a is None or b is None:
                return None
            return min(a, b)

        def _max(a, b):
            if a is None or b is None:
                return None
            return max(a, b)

        nc = None
        if self.null_count is not None and other.null_count is not None:
            nc = self.null_count + other.null_count
        return ColumnRangeStatistics(_min(self.lower, other.lower), _max(self.upper, other.upper), nc)

    def might_contain(self, value: Any) -> bool:
        if self.is_missing():
            return True
        try:
            if self.lower is not None and value < self.lower:
                return False
            if self.upper is not None and value > self.upper:
                return False
        except TypeError:
            return True
        return True


@dataclass(frozen=True)
class TableStatistics:
    columns: Dict[str, ColumnRangeStatistics] = field(default_factory=dict)

    def union(self, other: "TableStatistics") -> "TableStatistics":
        out = {}
        for name in set(self.columns) | set(other.columns):
            a = self.columns.get(name, ColumnRangeStatistics())
            b = other.columns.get(name, ColumnRangeStatistics())
            out[name] = a.union(b)
        return TableStatistics(out)


@dataclass(frozen=True)
class TableMetadata:
    length: int
    size_bytes: Optional[int] = None


@dataclass(frozen=True)
class ApproxStats:
    """Cardinality/size estimates attached to plan nodes by the optimizer
    (reference: src/daft-logical-plan/src/stats.rs ApproxStats)."""

    num_rows: float = 0.0
    size_bytes: float = 0.0

    def scaled(self, selectivity: float) -> "ApproxStats":
        # Floor at one row (when the input had any): a chain of filters
        # multiplying selectivities can otherwise estimate 0 rows, and a
        # zero cardinality starves join ordering — every order containing
        # the "empty" relation costs the same, so the DP's tie-break (not
        # the data) picks the plan.
        rows = self.num_rows * selectivity
        if self.num_rows > 0:
            rows = max(rows, 1.0)
        return ApproxStats(rows, self.size_bytes * selectivity)


#: Pinned selectivity constants (tests/test_feedback.py asserts these —
#: repurposing a value means re-deriving every seeded q-error baseline).
#: Every estimate_selectivity return is clamped into
#: [SELECTIVITY_FLOOR, 1.0]: a predicate may be arbitrarily weird, but
#: the estimate must never claim "no rows survive" (0 would starve join
#: ordering the same way an unclamped ``scaled`` did) nor "more rows than
#: arrived".
UNKNOWN_SELECTIVITY = 0.25
SELECTIVITY_FLOOR = 0.01


def estimate_selectivity(expr) -> float:
    """Shape-based predicate selectivity estimate (reference:
    src/daft-logical-plan/src/stats.rs selectivity heuristics).

    eq -> 0.1, ranges -> 0.3, AND multiplies, OR saturating-adds,
    NOT complements, is_null -> 0.05, anything else ->
    UNKNOWN_SELECTIVITY. The result is clamped to
    [SELECTIVITY_FLOOR, 1.0].
    """
    return min(max(_estimate_selectivity(expr), SELECTIVITY_FLOOR), 1.0)


def _estimate_selectivity(expr) -> float:
    from daft_tpu_torch.expressions.expr import BinaryOp, UnaryOp

    if isinstance(expr, BinaryOp):
        if expr.op == "and":
            return _estimate_selectivity(expr.left) * _estimate_selectivity(expr.right)
        if expr.op == "or":
            return min(_estimate_selectivity(expr.left) + _estimate_selectivity(expr.right), 1.0)
        if expr.op == "eq":
            return 0.1
        if expr.op in ("lt", "le", "gt", "ge"):
            return 0.3
        if expr.op == "ne":
            return 0.9
    if isinstance(expr, UnaryOp):
        if expr.op == "not":
            return max(1.0 - _estimate_selectivity(expr.child), 0.05)
        if expr.op == "is_null":
            return 0.05
        if expr.op == "not_null":
            return 0.95
    return UNKNOWN_SELECTIVITY

