"""List kernels (port of ``daft_tpu/kernels/list_ops.py``; reference:
src/daft-functions-list). Host Arrow and Python, as in the JAX package."""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftTypeError
from daft_tpu_torch.kernels.registry import register_kernel
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series


def _inner_field(fields, kwargs):
    f = fields[0]
    if not f.dtype.is_list():
        raise DaftTypeError(f"Expected list column, got {f.dtype!r}")
    return Field(f.name, f.dtype.inner)


def _same(fields, kwargs):
    return fields[0]


@register_kernel("list_length", lambda f, k: Field(f[0].name, DataType.uint64()))
def _list_length(args, **kwargs):
    out = pc.list_value_length(args[0].to_arrow())
    return Series.from_arrow(out.cast(pa.uint64()), args[0].name, DataType.uint64())


@register_kernel("list_count", lambda f, k: Field(f[0].name, DataType.uint64()))
def _list_count(args, mode: str = "valid", **kwargs):
    arr = args[0].to_arrow()
    if mode == "all":
        out = pc.list_value_length(arr)
        return Series.from_arrow(pc.fill_null(out, 0).cast(pa.uint64()), args[0].name, DataType.uint64())
    out = []
    for v in arr.to_pylist():
        if v is None:
            out.append(0)
        else:
            out.append(sum(1 for x in v if x is not None))
    return Series.from_pylist(out, args[0].name, DataType.uint64())


@register_kernel("list_get", _inner_field)
def _list_get(args, default=None, **kwargs):
    s = args[0]
    idx = args[1].to_pylist()
    idx = idx * len(s) if len(idx) == 1 else idx
    inner = s.dtype.inner
    out = []
    for v, i in zip(s.to_pylist(), idx):
        if v is None or i is None or not (-len(v) <= i < len(v)):
            out.append(default)
        else:
            out.append(v[i])
    return Series.from_pylist(out, s.name, inner)


@register_kernel("list_slice", _same)
def _list_slice(args, end=None, **kwargs):
    s = args[0]
    start = int(args[1].scalar())
    out = [None if v is None else v[start:end] for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, s.dtype)


@register_kernel("list_chunk", lambda f, k: Field(f[0].name, DataType.list(DataType.fixed_size_list(f[0].dtype.inner, k["size"]))))
def _list_chunk(args, size: int = 1, **kwargs):
    s = args[0]
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
        else:
            chunks = [v[i:i + size] for i in range(0, len(v) - size + 1, size)]
            out.append(chunks)
    return Series.from_pylist(out, s.name, DataType.list(DataType.fixed_size_list(s.dtype.inner, size)))


@register_kernel("list_join", lambda f, k: Field(f[0].name, DataType.string()))
def _list_join(args, **kwargs):
    sep = args[1].scalar()
    arr = args[0].to_arrow()
    out = pc.binary_join(arr.cast(pa.large_list(pa.large_string())),
                         pa.scalar(sep, pa.large_string()))
    return Series.from_arrow(out, args[0].name, DataType.string())


def _agg_resolver(out_dtype_fn):
    def resolver(fields, kwargs):
        f = fields[0]
        if not f.dtype.is_list():
            raise DaftTypeError(f"Expected list column, got {f.dtype!r}")
        return Field(f.name, out_dtype_fn(f.dtype.inner))

    return resolver


def _list_agg(pyarrow_agg, np_fallback):
    def fn(args, **kwargs):
        s = args[0]
        out = []
        for v in s.to_pylist():
            if v is None:
                out.append(None)
            else:
                vals = [x for x in v if x is not None]
                out.append(np_fallback(vals) if vals else None)
        return out

    return fn


@register_kernel("list_sum", _agg_resolver(lambda dt: dt))
def _list_sum(args, **kwargs):
    out = _list_agg(None, lambda v: sum(v))(args)
    return Series.from_pylist(out, args[0].name, args[0].dtype.inner)


@register_kernel("list_mean", _agg_resolver(lambda dt: DataType.float64()))
def _list_mean(args, **kwargs):
    out = _list_agg(None, lambda v: float(np.mean(v)))(args)
    return Series.from_pylist(out, args[0].name, DataType.float64())


@register_kernel("list_min", _agg_resolver(lambda dt: dt))
def _list_min(args, **kwargs):
    out = _list_agg(None, lambda v: min(v))(args)
    return Series.from_pylist(out, args[0].name, args[0].dtype.inner)


@register_kernel("list_max", _agg_resolver(lambda dt: dt))
def _list_max(args, **kwargs):
    out = _list_agg(None, lambda v: max(v))(args)
    return Series.from_pylist(out, args[0].name, args[0].dtype.inner)


@register_kernel("list_sort", _same)
def _list_sort(args, desc: bool = False, **kwargs):
    s = args[0]
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
        else:
            vals = sorted((x for x in v if x is not None), reverse=desc)
            nulls = [None] * (len(v) - len(vals))
            out.append(vals + nulls)
    return Series.from_pylist(out, s.name, s.dtype)


@register_kernel("list_distinct", _same)
def _list_distinct(args, **kwargs):
    s = args[0]
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
        else:
            seen, res = set(), []
            for x in v:
                if x is not None and x not in seen:
                    seen.add(x)
                    res.append(x)
            out.append(res)
    return Series.from_pylist(out, s.name, s.dtype)


@register_kernel("list_contains", lambda f, k: Field(f[0].name, DataType.bool()))
def _list_contains(args, **kwargs):
    s = args[0]
    needle = args[1].to_pylist()
    needle = needle * len(s) if len(needle) == 1 else needle
    out = [None if v is None else (n in v) for v, n in zip(s.to_pylist(), needle)]
    return Series.from_pylist(out, s.name, DataType.bool())


@register_kernel("list_value_counts", lambda f, k: Field(f[0].name, DataType.map(f[0].dtype.inner, DataType.uint64())))
def _list_value_counts(args, **kwargs):
    s = args[0]
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
        else:
            counts: dict = {}
            for x in v:
                if x is not None:
                    counts[x] = counts.get(x, 0) + 1
            out.append(list(counts.items()))
    dtype = DataType.map(s.dtype.inner, DataType.uint64())
    return Series.from_arrow(pa.array(out, dtype.to_arrow()), s.name, dtype)


# ------------------------------------------------------------------ #
# List long tail (reference: daft/functions/list.py)                  #
# ------------------------------------------------------------------ #
def _flatten_resolver(fields, kwargs):
    f = fields[0]
    if not f.dtype.is_list() or not f.dtype.inner.is_list():
        raise DaftTypeError(f"list_flatten expects list<list<T>>, got {f.dtype!r}")
    return Field(f.name, DataType.list(f.dtype.inner.inner))


@register_kernel("list_flatten", _flatten_resolver)
def _list_flatten(args, **kwargs):
    """list<list<T>> -> list<T> per row."""
    f = args[0]
    if not f.dtype.is_list() or not f.dtype.inner.is_list():
        raise DaftTypeError(f"list_flatten expects list<list<T>>, got {f.dtype!r}")
    out = [None if v is None else [x for sub in v if sub is not None for x in sub]
           for v in f.to_pylist()]
    return Series.from_pylist(out, f.name, DataType.list(f.dtype.inner.inner))


@register_kernel("list_bool_and", lambda f, k: Field(f[0].name, DataType.bool()))
def _list_bool_and(args, **kwargs):
    out = [None if v is None else all(bool(x) for x in v if x is not None)
           for v in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, DataType.bool())


@register_kernel("list_bool_or", lambda f, k: Field(f[0].name, DataType.bool()))
def _list_bool_or(args, **kwargs):
    out = [None if v is None else any(bool(x) for x in v if x is not None)
           for v in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, DataType.bool())


@register_kernel("list_append", _same)
def _list_append(args, **kwargs):
    lists = args[0].to_pylist()
    vals = args[1].to_pylist()
    if len(vals) == 1 and len(lists) != 1:
        vals = vals * len(lists)
    out = [None if v is None else list(v) + [x] for v, x in zip(lists, vals)]
    return Series.from_pylist(out, args[0].name, args[0].dtype)


def _eval_over_elements(list_series, expr):
    """Evaluate `expr` (referencing element()) over the flattened elements,
    then re-wrap with the original offsets. This is how list_map/list_filter
    lower: one vectorized evaluation, no per-row Python loop on the expr."""
    from daft_tpu_torch.expressions.evaluator import evaluate
    from daft_tpu_torch.recordbatch import RecordBatch
    from daft_tpu_torch.schema import Schema

    arr = list_series.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    flat = arr.flatten()
    inner = Series.from_arrow(flat, "__list_element__", list_series.dtype.inner)
    rb = RecordBatch(Schema([Field("__list_element__", inner.dtype)]), [inner], len(inner))
    return arr, evaluate(expr, rb)


def _list_map_resolver(fields, kwargs):
    from daft_tpu_torch.schema import Schema

    inner = Schema([Field("__list_element__", fields[0].dtype.inner)])
    return Field(fields[0].name, DataType.list(kwargs["expr"].to_field(inner).dtype))


@register_kernel("list_map", _list_map_resolver)
def _list_map(args, expr=None, **kwargs):
    arr, mapped = _eval_over_elements(args[0], expr)
    offsets = arr.offsets
    mapped_arr = mapped.to_arrow()
    if isinstance(mapped_arr, pa.ChunkedArray):
        mapped_arr = mapped_arr.combine_chunks()
    out = pa.LargeListArray.from_arrays(offsets.cast(pa.int64()), mapped_arr)
    if not arr.is_valid().to_numpy(zero_copy_only=False).all():
        out = pc.if_else(arr.is_valid(), out, pa.nulls(len(out), out.type))
    return Series.from_arrow(out, args[0].name, DataType.list(mapped.dtype))


@register_kernel("list_filter", _same)
def _list_filter(args, expr=None, **kwargs):
    arr, keep = _eval_over_elements(args[0], expr)
    keep_np = np.asarray(pc.fill_null(keep.to_arrow(), False))
    offsets = np.asarray(arr.offsets.cast(pa.int64()))
    lists = arr.flatten().to_pylist()
    valid = arr.is_valid().to_numpy(zero_copy_only=False)
    out = []
    for i in range(len(arr)):
        if not valid[i]:
            out.append(None)
            continue
        lo, hi = offsets[i], offsets[i + 1]
        out.append([lists[j] for j in range(lo, hi) if keep_np[j]])
    return Series.from_pylist(out, args[0].name, args[0].dtype)


@register_kernel("list_compact", _same)
def _list_compact(args, **kwargs):
    """Drop null elements from each list."""
    out = [None if v is None else [x for x in v if x is not None]
           for v in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, args[0].dtype)


@register_kernel("list_seq", lambda f, k: Field(f[0].name, DataType.list(DataType.uint64())))
def _list_seq(args, **kwargs):
    """n -> [0, 1, ..., n-1] per row (reference: daft/functions/list.py seq)."""
    s = args[0]
    vals, mask = s.cast(DataType.int64()).to_numpy_masked()
    n = np.where(mask, 0, np.maximum(vals, 0)) if mask is not None else np.maximum(vals, 0)
    offsets = np.zeros(len(n) + 1, dtype=np.int64)
    np.cumsum(n, out=offsets[1:])
    values = pa.array(
        (np.arange(int(offsets[-1]), dtype=np.uint64) -
         np.repeat(offsets[:-1], n).astype(np.uint64)),
        pa.uint64())
    null_mask = pa.array(mask) if mask is not None and mask.any() else None
    arr = pa.LargeListArray.from_arrays(pa.array(offsets, pa.int64()), values,
                                        mask=null_mask)
    dt = DataType.list(DataType.uint64())
    return Series.from_arrow(arr.cast(dt.to_arrow()), s.name, dt)


def _list_pack_resolver(fields, kwargs):
    from daft_tpu_torch.datatype import unify_dtypes

    inner = fields[0].dtype
    for f in fields[1:]:
        inner = unify_dtypes(inner, f.dtype)
    return Field(fields[0].name, DataType.list(inner))


@register_kernel("list_pack", _list_pack_resolver)
def _list_pack(args, **kwargs):
    """N columns -> one list column of [col0, col1, ...] per row (reference:
    daft/functions/list.py to_list)."""
    from daft_tpu_torch.datatype import unify_dtypes

    inner = args[0].dtype
    for s in args[1:]:
        inner = unify_dtypes(inner, s.dtype)
    cols = [s.cast(inner).to_pylist() for s in args]
    out = [list(row) for row in zip(*cols)]
    return Series.from_pylist(out, args[0].name, DataType.list(inner))
