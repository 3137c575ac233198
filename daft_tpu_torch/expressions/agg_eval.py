"""Aggregation evaluation, global and grouped (port of
``daft_tpu/expressions/agg_eval.py``).

Reference: agg kernels in src/daft-core/src/array/ops and the grouped-aggregate
sinks in src/daft-local-execution. Grouped aggregations dispatch to Arrow
Acero's hash aggregation (native C++), as in the JAX package. Composite
aggregation expressions (``(col('a') * 2).sum() + 1``) are decomposed: the
inner AggOp nodes are computed (per group), then the outer expression is
evaluated over their results, as the reference's planner extracts AggExprs
from projections.

Both paths evaluate the aggregations' children on the host, as the JAX
package does. The aggregations Acero lacks (the list merge, the sketches,
``median``, ``string_agg``, ``skew``) run per group over one stable sort by
group, in linear work (ROADMAP C.39).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.evaluator import evaluate
from daft_tpu_torch.expressions.expr import AggOp, Alias, ColumnRef, Expr
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series, _sum_dtype

_ARROW_AGGS = {
    "sum": "sum", "mean": "mean", "min": "min", "max": "max", "product": "product",
    "count": "count", "count_distinct": "count_distinct", "list": "list",
    "stddev": "stddev", "variance": "variance",
    "any_value": "first", "bool_and": "all", "bool_or": "any",
}


def _decompose(exprs: Sequence[Expr]) -> Tuple[List[Tuple[str, AggOp]], List[Expr]]:
    """Extract the unique AggOp nodes; rewrite the outer exprs to reference them."""
    aggs: List[Tuple[str, AggOp]] = []
    keys: Dict[tuple, str] = {}

    def rewrite(e: Expr):
        if isinstance(e, AggOp):
            k = e.key()
            if k not in keys:
                keys[k] = f"__agg_{len(aggs)}"
                aggs.append((keys[k], e))
            return ColumnRef(keys[k])
        return None

    # Keep each original output name: the rewritten tree's natural name would
    # be the synthetic __agg_N column.
    return aggs, [Alias(e.transform(rewrite), e.name()) for e in exprs]


def eval_aggregation(rb, agg_exprs: Sequence[Expr], group_by: Sequence[Expr] = ()):
    from daft_tpu_torch.recordbatch import RecordBatch, _group_codes

    group_by = list(group_by)
    named_aggs, outer = _decompose(list(agg_exprs))

    if not group_by:
        agg_cols = [_global_agg(evaluate(agg.child, rb), agg).rename(name)
                    for name, agg in named_aggs]
        inter = RecordBatch(Schema([Field(c.name, c.dtype) for c in agg_cols]), agg_cols, 1)
        out_cols = [evaluate(e, inter).rename(e.name()) for e in outer]
        return RecordBatch(Schema([Field(c.name, c.dtype) for c in out_cols]), out_cols, 1)

    key_series = [evaluate(g, rb).rename(g.name()) for g in group_by]
    # The children once over the whole batch: (name, agg, child series).
    slots = [(name, agg, evaluate(agg.child, rb)) for name, agg in named_aggs]

    def _acero_spec(name, agg, child):
        if agg.op not in _ARROW_AGGS or child.dtype.is_python() or child.dtype.is_logical():
            return None
        opts = None
        if agg.op == "count":
            mode = agg.kwargs.get("mode", "valid")
            arrow_mode = {"valid": "only_valid", "null": "only_null", "all": "all"}.get(
                mode, "only_valid")
            opts = pc.CountOptions(mode=arrow_mode)
        elif agg.op in ("stddev", "variance"):
            opts = pc.VarianceOptions(ddof=0)
        elif agg.op == "any_value":
            opts = pc.ScalarAggregateOptions(skip_nulls=bool(agg.kwargs.get("ignore_nulls", False)))
        return (f"__v_{name}", _ARROW_AGGS[agg.op], opts, name, agg)

    specs = [_acero_spec(name, agg, child) for name, agg, child in slots]
    keys_direct = all(not k.dtype.is_python() and not k.dtype.is_nested()
                      and not k.dtype.is_logical() for k in key_series)
    results: Dict[str, Series] = {}

    if keys_direct and all(s is not None for s in specs):
        # Fast path: ONE Arrow hash aggregation, grouped directly by the key
        # columns. Arrow's single-threaded group_by emits groups in
        # first-occurrence order (null keys form their own group), which is
        # _group_codes' order: no code pass, no argsort realignment.
        key_names_internal = [f"__k_{i}" for i in range(len(key_series))]
        table_cols = {n: k.to_arrow() for n, k in zip(key_names_internal, key_series)}
        for (colname, _a, _o, _name, _g), (_n, _agg, child) in zip(specs, slots):
            table_cols[colname] = child.to_arrow()
        agged = pa.table(table_cols).group_by(key_names_internal, use_threads=False).aggregate(
            [(c, a, o) if o is not None else (c, a) for c, a, o, _, _ in specs])
        num_groups = len(agged)
        key_cols = [Series.from_arrow(agged.column(n).combine_chunks(), k.name).cast(k.dtype)
                    for n, k in zip(key_names_internal, key_series)]
        keys_rb = RecordBatch(Schema([Field(c.name, c.dtype) for c in key_cols]), key_cols,
                              num_groups)
        for colname, arrow_agg, _opts, name, agg in specs:
            out_col = agged.column(f"{colname}_{arrow_agg}").combine_chunks()
            results[name] = _fix_agg_dtype(Series.from_arrow(out_col, name), agg)
    else:
        group_ids, first_idx = _group_codes(key_series)
        num_groups = len(first_idx)
        keys_rb = RecordBatch(Schema([Field(k.name, k.dtype) for k in key_series]), key_series,
                              len(rb)).take(first_idx.astype(np.uint64))
        acero_targets = [s for s in specs if s is not None]
        if acero_targets:
            table_cols = {"__code": pa.array(group_ids)}
            for spec, (_n, _agg, child) in zip(specs, slots):
                if spec is not None:
                    table_cols[spec[0]] = child.to_arrow()
            agged = pa.table(table_cols).group_by("__code", use_threads=False).aggregate(
                [(c, a, o) if o is not None else (c, a) for c, a, o, _, _ in acero_targets])
            # Align to first-occurrence group order.
            perm = pa.array(np.argsort(np.asarray(agged.column("__code")), kind="stable"))
            for colname, arrow_agg, _opts, name, agg in acero_targets:
                out_col = agged.column(f"{colname}_{arrow_agg}").combine_chunks().take(perm)
                results[name] = _fix_agg_dtype(Series.from_arrow(out_col, name), agg)
        # The rest (Python / logical children, list and sketch partials): one
        # global aggregation per group over the group's rows in input order,
        # read from ONE stable sort by group. The JAX package selects each
        # group's rows with a full-length mask, O(rows x groups) (ROADMAP
        # C.39); the rows, their order and the results are the same. A list
        # ``concat`` (the merge of every list partial) runs vectorised.
        rest = [(name, agg, child) for name, agg, child in slots if name not in results]
        if rest:
            order = np.argsort(group_ids, kind="stable").astype(np.uint64)
            bounds = np.zeros(num_groups + 1, dtype=np.int64)
            np.cumsum(np.bincount(group_ids, minlength=num_groups), out=bounds[1:])
        for name, agg, child in rest:
            if agg.op == "concat" and child.dtype.is_list():
                results[name] = _grouped_list_concat(child, group_ids, num_groups, name)
                continue
            parts = [_global_agg(child.take(order[bounds[g]:bounds[g + 1]]), agg)
                     for g in range(num_groups)]
            results[name] = (Series.concat(parts).rename(name) if parts
                             else Series.null(name, child.dtype, 0))

    inter_cols = list(keys_rb.columns()) + [results[name] for name, _, _ in slots]
    inter = RecordBatch(Schema([Field(c.name, c.dtype) for c in inter_cols]), inter_cols,
                        num_groups)
    out_cols = list(keys_rb.columns()) + [evaluate(e, inter).rename(e.name()) for e in outer]
    names = [c.name for c in out_cols]
    if len(set(names)) != len(names):
        raise DaftValueError(f"Duplicate output names in aggregation: {names}")
    return RecordBatch(Schema([Field(c.name, c.dtype) for c in out_cols]), out_cols, num_groups)


def _fix_agg_dtype(res: Series, agg: AggOp) -> Series:
    """Acero's output types where they differ from the JAX package's partial
    types: counts are uint64, the moments f64. A float32 ``hash_sum`` stays a
    double and ``hash_list`` a list, as there; the final cast brings each to
    the resolved type."""
    if agg.op in ("count", "count_distinct"):
        return res.cast(DataType.uint64())
    if agg.op in ("stddev", "variance", "mean"):
        return res.cast(DataType.float64())
    return res


def _global_agg(child: Series, agg: AggOp) -> Series:
    op = agg.op
    if op == "sum":
        return child.sum()
    if op == "product":
        v = child.drop_null().to_numpy()
        out_dt = _sum_dtype(child.dtype)
        if len(v) == 0:
            return Series.from_pylist([None], child.name, out_dt)
        out = np.prod(v.astype(out_dt.to_numpy(), copy=False))
        return Series.from_pylist([out.item()], child.name, out_dt)
    if op == "median":
        v = child.drop_null().cast(DataType.float64()).to_numpy()
        return Series.from_pylist([float(np.median(v)) if len(v) else None],
                                  child.name, DataType.float64())
    if op == "string_agg":
        sep = agg.kwargs.get("sep", ",")
        vals = [v for v in child.to_pylist() if v is not None]
        return Series.from_pylist([sep.join(str(v) for v in vals) if vals else None],
                                  child.name, DataType.string())
    if op == "mean":
        return child.mean()
    if op == "min":
        return child.min()
    if op == "max":
        return child.max()
    if op == "count":
        return child.count(agg.kwargs.get("mode", "valid"))
    if op == "count_distinct":
        return child.count_distinct()
    if op == "any_value":
        return child.any_value(agg.kwargs.get("ignore_nulls", False))
    if op == "list":
        return child.agg_list()
    if op == "concat":
        return child.agg_concat()
    if op == "stddev":
        return child.stddev()
    if op == "variance":
        return child.variance()
    if op == "skew":
        return child.skew()
    if op == "approx_count_distinct":
        return child.approx_count_distinct()
    if op == "approx_percentile":
        # DDSketch-backed so the one-pass and two-phase answers agree
        # (reference: src/daft-sketch DDSketch for approx percentiles).
        from daft_tpu_torch.kernels.sketches import DDSketch

        sk = DDSketch.from_series(child.cast(DataType.float64()))
        q = agg.kwargs["percentiles"]
        if isinstance(q, (list, tuple)):
            out = [[sk.quantile(float(x)) for x in q]] if sk.count else [None]
            return Series.from_pylist(out, child.name, DataType.list(DataType.float64()))
        return Series.from_pylist([sk.quantile(float(q))], child.name, DataType.float64())
    if op == "dd_sketch":
        from daft_tpu_torch.kernels.sketches import DDSketch

        sk = DDSketch.from_series(child.cast(DataType.float64()))
        return Series.from_pylist([sk.to_bytes()], child.name, DataType.binary())
    if op == "dd_merge":
        from daft_tpu_torch.kernels.sketches import DDSketch

        blobs = [b for b in child.to_pylist() if b is not None]
        sk = DDSketch.from_bytes(blobs[0]) if blobs else DDSketch()
        for b in blobs[1:]:
            sk = sk.merge(DDSketch.from_bytes(b))
        return Series.from_pylist([sk.to_bytes()], child.name, DataType.binary())
    if op in ("bool_and", "bool_or"):
        v = child.drop_null().to_numpy()
        out = (bool(v.all()) if op == "bool_and" else bool(v.any())) if len(v) else None
        return Series.from_pylist([out], child.name, DataType.bool())
    raise DaftValueError(f"Unknown agg op {op}")


def _grouped_list_concat(child: Series, group_ids: np.ndarray, num_groups: int,
                         name: str) -> Series:
    """Each group's lists concatenated in row order (``Series.agg_concat``
    per group, as the JAX package computes it), for all groups at once: the
    elements of the valid lists, stably sorted by their row's group."""
    arr = child.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    lengths = np.asarray(pc.fill_null(pc.list_value_length(arr), 0)).astype(np.int64)
    elem_group = np.repeat(group_ids, lengths)
    order = np.argsort(elem_group, kind="stable")
    offsets = np.zeros(num_groups + 1, dtype=np.int64)
    np.cumsum(np.bincount(elem_group, minlength=num_groups), out=offsets[1:])
    out_dtype = DataType.list(child.dtype.inner)
    out = pa.LargeListArray.from_arrays(pa.array(offsets), arr.flatten().take(pa.array(order)))
    return Series.from_arrow(out.cast(out_dtype.to_arrow()), name, out_dtype)
