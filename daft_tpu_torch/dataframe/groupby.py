"""GroupedDataFrame (port of ``daft_tpu/dataframe/groupby.py``; reference:
daft/dataframe — GroupedDataFrame API).

``agg`` and the shorthands ``sum``, ``mean``, ``min``, ``max``, ``count``,
``stddev`` and ``any_value`` build a grouped ``Aggregate``. ``agg_list``,
``agg_concat`` and ``map_groups`` need list partials and the ``.list``
namespace: they raise ``DaftNotImplementedError`` naming ROADMAP A.3.
"""

from __future__ import annotations

from typing import List

from daft_tpu_torch.errors import DaftNotImplementedError
from daft_tpu_torch.expressions.expression import Expression, col, lit


class GroupedDataFrame:
    def __init__(self, df, group_by: List):
        from daft_tpu_torch.dataframe.dataframe import _to_expr

        self._df = df
        self._group_by = [_to_expr(g) for g in group_by]

    def agg(self, *exprs: Expression):
        from daft_tpu_torch.dataframe.dataframe import DataFrame, _flatten

        return DataFrame(self._df._builder.aggregate(
            [e._expr for e in _flatten(exprs)], [g._expr for g in self._group_by]))

    def _agg_all(self, op: str):
        group_names = {g.name() for g in self._group_by}
        return self.agg(*[getattr(col(f.name), op)() for f in self._df.schema
                          if f.name not in group_names
                          and (op in ("min", "max", "count", "any_value") or f.dtype.is_numeric())])

    def sum(self, *cols):
        return self.agg(*[_e(c).sum() for c in cols]) if cols else self._agg_all("sum")

    def mean(self, *cols):
        return self.agg(*[_e(c).mean() for c in cols]) if cols else self._agg_all("mean")

    def min(self, *cols):
        return self.agg(*[_e(c).min() for c in cols]) if cols else self._agg_all("min")

    def max(self, *cols):
        return self.agg(*[_e(c).max() for c in cols]) if cols else self._agg_all("max")

    def count(self, *cols):
        if cols:
            return self.agg(*[_e(c).count() for c in cols])
        return self.agg(lit(1).count().alias("count"))

    def stddev(self, *cols):
        return self.agg(*[_e(c).stddev() for c in cols]) if cols else self._agg_all("stddev")

    def any_value(self, *cols):
        return self.agg(*[_e(c).any_value() for c in cols]) if cols else self._agg_all("any_value")

    def agg_list(self, *cols):
        raise DaftNotImplementedError(
            "agg_list is not ported to daft_tpu_torch: ROADMAP A.3 (list partials, with the "
            ".list namespace)")

    def agg_concat(self, *cols):
        raise DaftNotImplementedError(
            "agg_concat is not ported to daft_tpu_torch: ROADMAP A.3 (list partials, with the "
            ".list namespace)")

    def map_groups(self, udf_expr):
        raise DaftNotImplementedError(
            "map_groups is not ported to daft_tpu_torch: ROADMAP A.3 (it aggregates each "
            "group's values as a list and explodes the UDF's lists)")


def _e(c) -> Expression:
    return c if isinstance(c, Expression) else col(c)
