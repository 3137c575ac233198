"""GroupedDataFrame (port of ``daft_tpu/dataframe/groupby.py``; reference:
daft/dataframe — GroupedDataFrame API).

``agg`` and the shorthands ``sum``, ``mean``, ``min``, ``max``, ``count``,
``stddev``, ``any_value``, ``agg_list`` and ``agg_concat`` build a grouped
``Aggregate``; ``map_groups`` runs a UDF over each group's values.
"""

from __future__ import annotations

from typing import List

from daft_tpu_torch.errors import DaftValueError
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
                          and (op in ("min", "max", "count", "any_value", "agg_list", "agg_concat")
                              or f.dtype.is_numeric())])

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
        return self.agg(*[_e(c).agg_list() for c in cols]) if cols else self._agg_all("agg_list")

    def agg_concat(self, *cols):
        return self.agg(*[_e(c).agg_concat() for c in cols]) if cols else self._agg_all("agg_concat")

    def map_groups(self, udf_expr):
        """Apply a UDF to each group's full column values; the UDF may return
        any number of rows per group (reference: dataframe.py map_groups →
        per-group PyScalarFn evaluation). Lowered as: evaluate arg
        expressions, agg_list them per group, run the UDF over each group's
        flattened series, explode the per-group results."""
        from daft_tpu_torch.dataframe.dataframe import _to_expr
        from daft_tpu_torch.datatype import DataType
        from daft_tpu_torch.expressions.expr import Alias, UdfCall
        from daft_tpu_torch.series import Series
        from daft_tpu_torch.udf import Udf

        e = _to_expr(udf_expr)._expr
        out_name = e.name()
        while isinstance(e, Alias):
            e = e.child
        if not isinstance(e, UdfCall):
            raise DaftValueError("map_groups expects a UDF call expression")
        u = e.udf

        df = self._df
        tmp = []
        for i, a in enumerate(e.args):
            nm = f"__mg_a{i}"
            tmp.append(nm)
            df = df.with_column(nm, Expression(a))
        gdf = GroupedDataFrame(df, list(self._group_by))
        agged = gdf.agg(*[col(nm).agg_list().alias(nm) for nm in tmp])

        kwargs = dict(e.kwargs)

        def per_group(*list_series):
            outs = []
            pylists = [s.to_pylist() for s in list_series]
            for row in zip(*pylists) if pylists else ():
                flat = [Series.from_pylist(list(v) if v is not None else [],
                                           f"a{j}")
                        for j, v in enumerate(row)]
                outs.append(u.evaluate(flat, kwargs).to_pylist())
            return outs

        wrapper = Udf(per_group, DataType.list(u.return_dtype), batch=True,
                      name=out_name)
        keys = [g.name() for g in self._group_by]
        out = agged.with_column(out_name, wrapper(*[col(nm) for nm in tmp]))
        out = out.select(*(keys + [out_name])) if keys else out.select(out_name)
        # A UDF may return zero rows for a group — exploding its empty list
        # would fabricate a null row, so drop empty groups first.
        out = out.where(col(out_name).list.length() > 0)
        return out.explode(out_name)


def _e(c) -> Expression:
    return c if isinstance(c, Expression) else col(c)
