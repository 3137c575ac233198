"""Series: a named, typed column of values.

Port of ``daft_tpu/series.py``. A Series lives on the host: a single combined
Arrow array (Arrow C++ buffers via pyarrow) whose Arrow type is exactly
``dtype.to_arrow()``, or a plain Python list for the ``Python`` object dtype.
Fixed-width columns reach the GPU as dense numpy batches that the AI providers
copy to the device themselves.

Not ported yet: the device seam (``from_jax``/``to_jax``),
``approx_count_distinct`` (it needs the sketch kernels), and lazy ``File``
handles for File columns (``to_pylist`` returns their Arrow rows).

CPU kernels delegate to ``pyarrow.compute`` (Arrow C++ SIMD kernels — the
native-code analogue of the reference's arrow-rs + hand-rolled kernels in
src/daft-core/src/array/ops/*).
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType, TypeId, unify_dtypes
from daft_tpu_torch.errors import DaftTypeError, DaftValueError

_ARITH_PROMOTE = {"add", "sub", "mul"}


def _combine(arr: Union[pa.Array, pa.ChunkedArray]) -> pa.Array:
    if isinstance(arr, pa.ChunkedArray):
        return arr.combine_chunks()
    return arr


class Series:
    __slots__ = ("_name", "_dtype", "_data")

    def __init__(self, name: str, dtype: DataType, data: Union[pa.Array, list]):
        self._name = name
        self._dtype = dtype
        self._data = data

    # ------------------------------------------------------------------ #
    # Constructors                                                        #
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_arrow(
        arr: Union[pa.Array, pa.ChunkedArray],
        name: str = "series",
        dtype: Optional[DataType] = None,
    ) -> "Series":
        arr = _combine(arr)
        if dtype is None:
            dtype = DataType.from_arrow(arr.type)
        target = dtype.to_arrow()
        if arr.type != target:
            arr = arr.cast(target)
        return Series(name, dtype, arr)

    @staticmethod
    def from_pylist(
        data: Sequence[Any], name: str = "series", dtype: Optional[DataType] = None
    ) -> "Series":
        if dtype is None:
            inferred = DataType.null()
            for v in data:
                inferred = unify_dtypes(inferred, DataType.infer_from_py(v))
                if inferred.is_python():
                    break
            # A column of np.ndarrays with differing shapes is a ragged Tensor.
            if inferred.id == TypeId.FIXED_SHAPE_TENSOR:
                shapes = {tuple(v.shape) for v in data if v is not None}
                if len(shapes) > 1:
                    inferred = DataType.tensor(inferred.inner)
            dtype = inferred
        if dtype.is_python():
            return Series(name, dtype, list(data))
        arrow_type = dtype.to_arrow()
        try:
            arr = _py_to_arrow(data, dtype, arrow_type)
        except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError) as e:
            raise DaftTypeError(f"Cannot build {dtype!r} series from values: {e}") from e
        return Series(name, dtype, arr)

    @staticmethod
    def from_numpy(arr: "np.ndarray", name: str = "series", dtype: Optional[DataType] = None) -> "Series":
        arr = np.asarray(arr)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        if arr.dtype == object:
            return Series.from_pylist(list(arr), name, dtype)
        if arr.ndim == 1:
            dt = dtype or DataType.from_numpy(arr.dtype)
            if dt.id == TypeId.BFLOAT16:
                pa_arr = pa.Array.from_buffers(
                    pa.binary(2), len(arr),
                    [None, pa.py_buffer(np.ascontiguousarray(arr).view(np.uint8).tobytes())],
                )
                return Series(name, dt, pa_arr)
            return Series.from_arrow(pa.array(arr), name, dt)
        # ndim >= 2: one tensor row per leading index
        inner = DataType.from_numpy(arr.dtype)
        dt = dtype or DataType.tensor(inner, tuple(arr.shape[1:]))
        flat = pa.array(np.ascontiguousarray(arr).reshape(-1))
        n = int(np.prod(arr.shape[1:]))
        fsl = pa.FixedSizeListArray.from_arrays(flat, n)
        return Series.from_arrow(fsl.cast(dt.to_arrow()), name, dt)

    @staticmethod
    def null(name: str, dtype: DataType, length: int) -> "Series":
        if dtype.is_python():
            return Series(name, dtype, [None] * length)
        return Series(name, dtype, pa.nulls(length, dtype.to_arrow()))

    @staticmethod
    def full(name: str, value: Any, length: int, dtype: Optional[DataType] = None) -> "Series":
        dtype = dtype or DataType.infer_from_py(value)
        if dtype.is_python():
            return Series(name, dtype, [value] * length)
        scalar = pa.scalar(_py_scalar_for(value, dtype), dtype.to_arrow())
        # repeat scalar
        arr = pa.repeat(scalar, length) if hasattr(pa, "repeat") else pa.array([scalar.as_py()] * length, dtype.to_arrow())
        return Series(name, dtype, _combine(arr))

    @staticmethod
    def concat(series_list: Sequence["Series"]) -> "Series":
        if not series_list:
            raise DaftValueError("Cannot concat zero series")
        first = series_list[0]
        dtype = first.dtype
        for s in series_list[1:]:
            dtype = unify_dtypes(dtype, s.dtype)
        if dtype.is_python():
            out: list = []
            for s in series_list:
                out.extend(s.cast(dtype)._data)
            return Series(first.name, dtype, out)
        arrs = [s.cast(dtype)._data for s in series_list]
        return Series(first.name, dtype, _combine(pa.chunked_array(arrs)))

    # ------------------------------------------------------------------ #
    # Introspection                                                       #
    # ------------------------------------------------------------------ #
    @property
    def name(self) -> str:
        return self._name

    @property
    def dtype(self) -> DataType:
        return self._dtype

    def __len__(self) -> int:
        return len(self._data)

    def rename(self, name: str) -> "Series":
        return Series(name, self._dtype, self._data)

    def __repr__(self) -> str:
        return f"Series[{self._name}: {self._dtype!r}; len={len(self)}]"

    def null_count(self) -> int:
        if self._dtype.is_python():
            return sum(1 for v in self._data if v is None)
        return self._data.null_count

    # ------------------------------------------------------------------ #
    # Conversions                                                         #
    # ------------------------------------------------------------------ #
    def to_arrow(self) -> pa.Array:
        if self._dtype.is_python():
            raise DaftTypeError("Python object series has no Arrow representation")
        return self._data

    def scalar(self):
        """Element 0 as a Python value WITHOUT materializing the whole
        column — kernels read broadcast literal arguments through this
        (a literal arrives as a full-length Series)."""
        if len(self) == 0:
            return None
        if self._dtype.is_python():
            return self._data[0]
        return self.slice(0, 1).to_pylist()[0]

    def to_pylist(self) -> list:
        if self._dtype.is_python():
            return list(self._data)
        tid = self._dtype.id
        if tid in (TypeId.TENSOR, TypeId.FIXED_SHAPE_TENSOR):
            return _tensor_to_pylist(self)
        if tid == TypeId.BFLOAT16:
            vals, mask = self.to_numpy_masked()
            return [
                None if (mask is not None and mask[i]) else float(vals[i])
                for i in range(len(vals))
            ]
        return self._data.to_pylist()

    def to_numpy(self) -> "np.ndarray":
        """Dense numpy view/copy; nulls become zeros for fixed-width dtypes."""
        values, _ = self.to_numpy_masked()
        return values

    def to_numpy_masked(self) -> "tuple[np.ndarray, Optional[np.ndarray]]":
        """(values, null_mask) — mask is True where value is null, or None if no nulls."""
        dt = self._dtype
        if dt.is_python():
            mask = np.array([v is None for v in self._data])
            return np.array(self._data, dtype=object), (mask if mask.any() else None)
        arr = self._data
        mask = None
        if arr.null_count:
            mask = np.asarray(pc.is_null(arr))
        if dt.id == TypeId.BFLOAT16:
            import ml_dtypes

            buf = arr.buffers()[-1]
            vals = np.frombuffer(buf, dtype=ml_dtypes.bfloat16, count=len(arr) + arr.offset)[arr.offset:]
            if mask is not None:
                vals = vals.copy()
                vals[mask] = 0
            return vals, mask
        if dt.is_device_representable() and dt.shape != ():
            flat_dt = dt.to_numpy()
            if mask is not None:
                arr = _fill_null_fixed(arr, dt)
            values = np.asarray(arr.flatten())
            return values.astype(flat_dt, copy=False).reshape((len(self),) + dt.shape), mask
        if mask is not None and (dt.is_numeric() or dt.is_boolean()):
            filled = pc.fill_null(arr, _zero_scalar(dt))
            return np.asarray(filled), mask
        try:
            return np.asarray(arr), mask
        except Exception:
            return np.array(arr.to_pylist(), dtype=object), mask

    def to_pandas(self):
        import pandas as pd

        if self._dtype.is_python():
            return pd.Series(self._data, name=self._name)
        return self._data.to_pandas()

    # ------------------------------------------------------------------ #
    # Selection / layout                                                  #
    # ------------------------------------------------------------------ #
    def slice(self, start: int, length: Optional[int] = None) -> "Series":
        if self._dtype.is_python():
            end = None if length is None else start + length
            return Series(self._name, self._dtype, self._data[start:end])
        return Series(self._name, self._dtype, self._data.slice(start, length))

    def head(self, n: int) -> "Series":
        return self.slice(0, n)

    def take(self, indices: "Series | np.ndarray | Sequence[int]") -> "Series":
        idx = indices._data if isinstance(indices, Series) else pa.array(np.asarray(indices))
        if self._dtype.is_python():
            idx_np = np.asarray(idx)
            return Series(self._name, self._dtype, [self._data[i] if i is not None else None for i in idx_np.tolist()])
        return Series(self._name, self._dtype, _combine(pc.take(self._data, idx)))

    def filter(self, mask: "Series") -> "Series":
        if not mask.dtype.is_boolean():
            raise DaftTypeError(f"Filter mask must be boolean, got {mask.dtype!r}")
        if self._dtype.is_python():
            m = np.asarray(pc.fill_null(mask._data, False))
            return Series(self._name, self._dtype, [v for v, keep in zip(self._data, m) if keep])
        return Series(
            self._name, self._dtype,
            _combine(pc.filter(self._data, mask._data, null_selection_behavior="drop")),
        )

    # ------------------------------------------------------------------ #
    # Casting                                                             #
    # ------------------------------------------------------------------ #
    def cast(self, dtype: DataType) -> "Series":
        if dtype == self._dtype:
            return self
        src = self._dtype
        if dtype.is_python():
            return Series(self._name, dtype, self.to_pylist())
        if src.is_python():
            return Series.from_pylist(self._data, self._name, dtype)
        if src.id == TypeId.BFLOAT16 or dtype.id == TypeId.BFLOAT16:
            vals, mask = self.to_numpy_masked()
            out = Series.from_numpy(vals.astype(dtype.to_numpy()), self._name, dtype)
            return out._with_mask(mask)
        # Logical-type casts that share flat storage (embedding <-> fsl <-> tensor).
        if _same_storage(src, dtype):
            try:
                return Series(self._name, dtype, self._data.cast(dtype.to_arrow()))
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError) as e:
                raise DaftTypeError(f"Cannot cast {src!r} to {dtype!r}: {e}") from e
        if src.id == TypeId.LIST and dtype.id in (TypeId.EMBEDDING, TypeId.FIXED_SIZE_LIST, TypeId.FIXED_SHAPE_TENSOR, TypeId.FIXED_SHAPE_IMAGE):
            try:
                arr = self._data.cast(dtype.to_arrow())
                return Series(self._name, dtype, arr)
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError) as e:
                raise DaftTypeError(f"Cannot cast {src!r} to {dtype!r}: {e}") from e
        try:
            return Series(self._name, dtype, self._data.cast(dtype.to_arrow()))
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError) as e:
            raise DaftTypeError(f"Cannot cast {src!r} to {dtype!r}: {e}") from e

    def _with_mask(self, mask: Optional[np.ndarray]) -> "Series":
        if mask is None or self._dtype.is_python():
            return self
        arr = self._data
        validity = pa.array(~mask)
        out = pc.if_else(validity, arr, pa.nulls(len(arr), arr.type))
        return Series(self._name, self._dtype, _combine(out))

    # ------------------------------------------------------------------ #
    # Null handling                                                       #
    # ------------------------------------------------------------------ #
    def is_null(self) -> "Series":
        if self._dtype.is_python():
            return Series.from_pylist([v is None for v in self._data], self._name, DataType.bool())
        return Series(self._name, DataType.bool(), _combine(pc.is_null(self._data)))

    def not_null(self) -> "Series":
        if self._dtype.is_python():
            return Series.from_pylist([v is not None for v in self._data], self._name, DataType.bool())
        return Series(self._name, DataType.bool(), _combine(pc.is_valid(self._data)))

    def fill_null(self, fill: "Series") -> "Series":
        if self._dtype.is_python():
            fills = fill._data if fill.dtype.is_python() else fill.to_pylist()
            if len(fills) == 1:
                fills = list(fills) * len(self._data)
            return Series(self._name, self._dtype,
                          [f if v is None else v for v, f in zip(self._data, fills)])
        if len(fill) == 1:
            out = pc.fill_null(self._data, fill._data[0])
        else:
            out = pc.if_else(pc.is_valid(self._data), self._data, fill.cast(self._dtype)._data)
        return Series(self._name, self._dtype, _combine(out))

    def drop_null(self) -> "Series":
        return Series(self._name, self._dtype, _combine(self._data.drop_null()))

    def coalesce(self, other: "Series") -> "Series":
        """self where non-null, else the aligned value from `other`."""
        common = unify_dtypes(self._dtype, other.dtype)
        a = self if self._dtype == common else self.cast(common)
        b = other if other.dtype == common else other.cast(common)
        return a.fill_null(b)

    # ------------------------------------------------------------------ #
    # Arithmetic / comparison / logic                                     #
    # ------------------------------------------------------------------ #
    def _binary_numeric(self, other: "Series", op: str) -> "Series":
        lhs, rhs = self, other
        if op == "add" and (lhs.dtype.is_string() or rhs.dtype.is_string()):
            out = pc.binary_join_element_wise(
                lhs.cast(DataType.string())._data, rhs.cast(DataType.string())._data,
                pa.scalar("", pa.large_string()),
            )
            return Series(lhs.name, DataType.string(), _combine(out))
        mixed_temporal = (
            op in ("add", "sub") and lhs.dtype.is_temporal()
            and rhs.dtype.is_temporal()
            and (lhs.dtype.id != rhs.dtype.id
                 or (op == "sub"
                     and lhs.dtype.id in (TypeId.TIMESTAMP, TypeId.DATE))))
        if mixed_temporal:
            # Mixed temporal arithmetic (ts/date ± duration, ts-ts, date-date)
            # dispatches straight to Arrow — no unify/cast step applies.
            kern = pc.add_checked if op == "add" else pc.subtract_checked
            out = kern(lhs._data, rhs._data)
            return Series(lhs.name, DataType.from_arrow(out.type), _combine(out))
        out_dtype = unify_dtypes(lhs.dtype, rhs.dtype)
        if not out_dtype.is_numeric() and not (
            out_dtype.is_temporal() and op in ("add", "sub")
        ):
            raise DaftTypeError(f"Cannot {op} {lhs.dtype!r} and {rhs.dtype!r}")
        if op in ("truediv",):
            out_dtype = DataType.float64() if out_dtype.id != TypeId.FLOAT32 else DataType.float32()
        kern = {
            "add": pc.add_checked, "sub": pc.subtract_checked, "mul": pc.multiply_checked,
            "truediv": pc.divide, "mod": _arrow_mod, "floordiv": _arrow_floordiv,
            "pow": pc.power_checked,
        }[op]
        a = lhs.cast(out_dtype)._data if not lhs.dtype.is_temporal() else lhs._data
        b = rhs.cast(out_dtype)._data if not rhs.dtype.is_temporal() else rhs._data
        if op == "truediv":
            a = lhs.cast(out_dtype)._data
            b = rhs.cast(out_dtype)._data
        out = kern(a, b)
        return Series(lhs.name, DataType.from_arrow(out.type), _combine(out))

    def __add__(self, other: "Series") -> "Series":
        return self._binary_numeric(other, "add")

    def __sub__(self, other: "Series") -> "Series":
        return self._binary_numeric(other, "sub")

    def __mul__(self, other: "Series") -> "Series":
        return self._binary_numeric(other, "mul")

    def __truediv__(self, other: "Series") -> "Series":
        return self._binary_numeric(other, "truediv")

    def __floordiv__(self, other: "Series") -> "Series":
        return self._binary_numeric(other, "floordiv")

    def __mod__(self, other: "Series") -> "Series":
        return self._binary_numeric(other, "mod")

    def __pow__(self, other: "Series") -> "Series":
        return self._binary_numeric(other, "pow")

    def negate(self) -> "Series":
        return Series(self._name, self._dtype, _combine(pc.negate(self._data)))

    def abs(self) -> "Series":
        return Series(self._name, self._dtype, _combine(pc.abs(self._data)))

    def _compare(self, other: "Series", op: str) -> "Series":
        common = unify_dtypes(self.dtype, other.dtype)
        if common.is_python():
            raise DaftTypeError(f"Cannot compare {self.dtype!r} and {other.dtype!r}")
        kern = {"eq": pc.equal, "ne": pc.not_equal, "lt": pc.less,
                "le": pc.less_equal, "gt": pc.greater, "ge": pc.greater_equal}[op]
        out = kern(self.cast(common)._data, other.cast(common)._data)
        return Series(self._name, DataType.bool(), _combine(out))

    def eq(self, other: "Series") -> "Series":
        return self._compare(other, "eq")

    def ne(self, other: "Series") -> "Series":
        return self._compare(other, "ne")

    def lt(self, other: "Series") -> "Series":
        return self._compare(other, "lt")

    def le(self, other: "Series") -> "Series":
        return self._compare(other, "le")

    def gt(self, other: "Series") -> "Series":
        return self._compare(other, "gt")

    def ge(self, other: "Series") -> "Series":
        return self._compare(other, "ge")

    def eq_null_safe(self, other: "Series") -> "Series":
        common = unify_dtypes(self.dtype, other.dtype)
        a, b = self.cast(common)._data, other.cast(common)._data
        eq = pc.equal(a, b)
        both_null = pc.and_(pc.is_null(a), pc.is_null(b))
        out = pc.fill_null(eq, False)
        out = pc.or_(out, both_null)
        return Series(self._name, DataType.bool(), _combine(out))

    def and_(self, other: "Series") -> "Series":
        return Series(self._name, DataType.bool(), _combine(pc.and_kleene(self._data, other._data)))

    def or_(self, other: "Series") -> "Series":
        return Series(self._name, DataType.bool(), _combine(pc.or_kleene(self._data, other._data)))

    def xor_(self, other: "Series") -> "Series":
        return Series(self._name, DataType.bool(), _combine(pc.xor(self._data, other._data)))

    def not_(self) -> "Series":
        return Series(self._name, DataType.bool(), _combine(pc.invert(self._data)))

    def is_in(self, values: "Series") -> "Series":
        common = unify_dtypes(self.dtype, values.dtype)
        if common.is_python():
            # Mixed-type value sets (e.g. checkpoint keys accumulated across
            # runs) can't form an Arrow value set — python membership.
            vals = set(values.to_pylist())
            data = self.to_pylist() if not self._dtype.is_python() else self._data
            return Series.from_pylist([v in vals for v in data], self._name,
                                      DataType.bool())
        out = pc.is_in(self.cast(common)._data, value_set=values.cast(common)._data)
        return Series(self._name, DataType.bool(), _combine(out))

    def between(self, lower: "Series", upper: "Series") -> "Series":
        return self.ge(lower).and_(self.le(upper))

    def if_else(self, if_true: "Series", if_false: "Series") -> "Series":
        """self is the boolean predicate."""
        if not self._dtype.is_boolean():
            raise DaftTypeError("if_else predicate must be boolean")
        out_dtype = unify_dtypes(if_true.dtype, if_false.dtype)
        if out_dtype.is_python():
            pred = np.asarray(pc.fill_null(self._data, False))
            t = if_true.cast(out_dtype).to_pylist()
            f = if_false.cast(out_dtype).to_pylist()
            t = t * len(pred) if len(t) == 1 else t
            f = f * len(pred) if len(f) == 1 else f
            return Series(if_true.name, out_dtype, [tv if p else fv for p, tv, fv in zip(pred, t, f)])
        t = if_true.cast(out_dtype)._data
        f = if_false.cast(out_dtype)._data
        if len(if_true) == 1 and len(self) != 1:
            t = t[0]
        if len(if_false) == 1 and len(self) != 1:
            f = f[0]
        out = pc.if_else(self._data, t, f)
        return Series(if_true.name, out_dtype, _combine(out))

    # ------------------------------------------------------------------ #
    # Sorting / hashing                                                   #
    # ------------------------------------------------------------------ #
    def argsort(self, descending: bool = False, nulls_first: Optional[bool] = None) -> "Series":
        order = "descending" if descending else "ascending"
        placement = "at_start" if (nulls_first if nulls_first is not None else descending) else "at_end"
        idx = pc.array_sort_indices(self._data, order=order, null_placement=placement)
        return Series(self._name, DataType.uint64(), _combine(idx.cast(pa.uint64())))

    def sort(self, descending: bool = False, nulls_first: Optional[bool] = None) -> "Series":
        return self.take(self.argsort(descending, nulls_first))

    def search_sorted(self, keys: "Series", descending: bool = False) -> "Series":
        hay = self.to_numpy()
        needles = keys.cast(self.dtype).to_numpy()
        if descending:
            idx = len(hay) - np.searchsorted(hay[::-1], needles, side="right")
        else:
            idx = np.searchsorted(hay, needles, side="left")
        return Series.from_numpy(idx.astype(np.uint64), keys.name, DataType.uint64())

    def hash(self, seed: Optional["Series"] = None) -> "Series":
        """Deterministic 64-bit hash (vectorised FNV over value bytes),
        stable across processes and hosts (``kernels/hashing.py``)."""
        from daft_tpu_torch.kernels.hashing import hash_series

        return hash_series(self, seed)

    # ------------------------------------------------------------------ #
    # Aggregations (global)                                               #
    # ------------------------------------------------------------------ #
    def _agg_scalar(self, value: Any, dtype: DataType) -> "Series":
        return Series.from_pylist([value], self._name, dtype)

    def sum(self) -> "Series":
        if not self._dtype.is_numeric():
            raise DaftTypeError(f"Cannot sum {self._dtype!r}")
        out_dtype = _sum_dtype(self._dtype)
        v = pc.sum(self.cast(out_dtype)._data)
        return self._agg_scalar(v.as_py(), out_dtype)

    def mean(self) -> "Series":
        v = pc.mean(self._data)
        return self._agg_scalar(v.as_py(), DataType.float64())

    def min(self) -> "Series":
        return self._agg_scalar(pc.min(self._data).as_py(), self._dtype)

    def max(self) -> "Series":
        return self._agg_scalar(pc.max(self._data).as_py(), self._dtype)

    def count(self, mode: str = "valid") -> "Series":
        if self._dtype.is_python():
            n = len(self._data) if mode == "all" else sum(v is not None for v in self._data)
            return self._agg_scalar(n, DataType.uint64())
        arrow_mode = {"valid": "only_valid", "null": "only_null", "all": "all"}.get(mode, mode)
        return self._agg_scalar(pc.count(self._data, mode=arrow_mode).as_py(), DataType.uint64())

    def count_distinct(self) -> "Series":
        return self._agg_scalar(pc.count_distinct(self._data).as_py(), DataType.uint64())

    def stddev(self, ddof: int = 0) -> "Series":
        return self._agg_scalar(pc.stddev(self._data, ddof=ddof).as_py(), DataType.float64())

    def variance(self, ddof: int = 0) -> "Series":
        return self._agg_scalar(pc.variance(self._data, ddof=ddof).as_py(), DataType.float64())

    def skew(self) -> "Series":
        vals, mask = self.to_numpy_masked()
        vals = vals[~mask] if mask is not None else vals
        vals = vals.astype(np.float64)
        n = len(vals)
        if n == 0:
            return self._agg_scalar(None, DataType.float64())
        m = vals.mean()
        s2 = ((vals - m) ** 2).mean()
        if s2 == 0:
            return self._agg_scalar(0.0, DataType.float64())
        m3 = ((vals - m) ** 3).mean()
        return self._agg_scalar(float(m3 / s2**1.5), DataType.float64())

    def any_value(self, ignore_nulls: bool = False) -> "Series":
        data = self.drop_null() if ignore_nulls and len(self) else self
        v = data.to_pylist()[0] if len(data) else None
        return Series.from_pylist([v], self._name, self._dtype)

    def agg_list(self) -> "Series":
        out_dtype = DataType.list(self._dtype)
        if self._dtype.is_python():
            return Series(self._name, DataType.python(), [list(self._data)])
        offsets = pa.array([0, len(self._data)], pa.int64())
        lst = pa.LargeListArray.from_arrays(offsets, self._data)
        return Series(self._name, out_dtype, lst.cast(out_dtype.to_arrow()))

    def agg_concat(self) -> "Series":
        if not self._dtype.is_list():
            raise DaftTypeError("agg_concat requires a list column")
        flat = self._data.flatten()
        offsets = pa.array([0, len(flat)], pa.int64())
        out_dtype = DataType.list(self._dtype.inner)
        lst = pa.LargeListArray.from_arrays(offsets, flat)
        return Series(self._name, out_dtype, lst.cast(out_dtype.to_arrow()))

    def approx_percentile(self, q: Union[float, List[float]]) -> "Series":
        qs = [q] if isinstance(q, float) else list(q)
        vals = pc.approximate_median(self._data) if qs == [0.5] else None
        arr = self.drop_null().to_numpy().astype(np.float64)
        if len(arr) == 0:
            res = [None] * len(qs)
        else:
            res = [float(np.quantile(arr, qq)) for qq in qs]
        if isinstance(q, float):
            return self._agg_scalar(res[0], DataType.float64())
        return Series.from_pylist([res], self._name, DataType.list(DataType.float64()))

    # ------------------------------------------------------------------ #
    # Misc                                                                #
    # ------------------------------------------------------------------ #
    def unique(self) -> "Series":
        return Series(self._name, self._dtype, _combine(self._data.unique()))

    def value_counts(self) -> "tuple[Series, Series]":
        vc = self._data.value_counts()
        return (
            Series(self._name, self._dtype, _combine(vc.field("values"))),
            Series("count", DataType.int64(), _combine(vc.field("counts"))),
        )

    def __iter__(self) -> Iterable[Any]:
        return iter(self.to_pylist())


# ---------------------------------------------------------------------- #
# helpers                                                                 #
# ---------------------------------------------------------------------- #
def _py_to_arrow(data: Sequence[Any], dtype: DataType, arrow_type: pa.DataType) -> pa.Array:
    tid = dtype.id
    if tid in (TypeId.FIXED_SHAPE_TENSOR, TypeId.EMBEDDING, TypeId.FIXED_SHAPE_IMAGE):
        # Rows are np arrays / sequences: flatten into fixed-size-list storage.
        n = int(np.prod(dtype.shape))
        inner_np = dtype.to_numpy()
        flat = np.zeros((len(data), n), dtype=inner_np)
        validity = np.ones(len(data), dtype=bool)
        for i, v in enumerate(data):
            if v is None:
                validity[i] = False
            else:
                flat[i] = np.asarray(v).reshape(-1)
        fsl = pa.FixedSizeListArray.from_arrays(pa.array(flat.reshape(-1)), n)
        out = fsl.cast(arrow_type)
        if not validity.all():
            out = pc.if_else(pa.array(validity), out, pa.nulls(len(data), arrow_type))
            out = _combine(out)
        return out
    if tid == TypeId.TENSOR:
        datas, shapes = [], []
        for v in data:
            if v is None:
                datas.append(None)
                shapes.append(None)
            else:
                v = np.asarray(v)
                datas.append(v.reshape(-1).tolist())
                shapes.append(list(v.shape))
        return pa.array(
            [None if d is None else {"data": d, "shape": s} for d, s in zip(datas, shapes)],
            arrow_type,
        )
    if tid == TypeId.BFLOAT16:
        import ml_dtypes

        vals = np.array([0 if v is None else v for v in data], dtype=ml_dtypes.bfloat16)
        arr = pa.Array.from_buffers(
            pa.binary(2), len(vals), [None, pa.py_buffer(vals.tobytes())]
        )
        validity = pa.array([v is not None for v in data])
        if not all(v is not None for v in data):
            arr = _combine(pc.if_else(validity, arr, pa.nulls(len(data), arr.type)))
        return arr
    return pa.array(list(data), arrow_type)


def _tensor_to_pylist(s: Series) -> list:
    dt = s.dtype
    if dt.id == TypeId.FIXED_SHAPE_TENSOR:
        vals, mask = s.to_numpy_masked()
        out = [vals[i] for i in range(len(s))]
        if mask is not None:
            out = [None if mask[i] else out[i] for i in range(len(s))]
        return out
    out = []
    for row in s._data.to_pylist():
        if row is None:
            out.append(None)
        else:
            out.append(np.array(row["data"], dtype=dt.inner.to_numpy()).reshape(row["shape"]))
    return out


def _fill_null_fixed(arr: pa.Array, dt: DataType) -> pa.Array:
    """Replace null rows of a fixed-size-list array with zero rows."""
    n = int(np.prod(dt.shape))
    zero_row = np.zeros((n,), dtype=dt.to_numpy())
    zeros = pa.FixedSizeListArray.from_arrays(
        pa.array(np.tile(zero_row, len(arr))), n
    ).cast(arr.type)
    return _combine(pc.if_else(pc.is_valid(arr), arr, zeros))


def _zero_scalar(dt: DataType):
    if dt.is_boolean():
        return False
    if dt.is_floating():
        return 0.0
    return 0


def _py_scalar_for(value: Any, dtype: DataType) -> Any:
    if isinstance(value, np.generic):
        return value.item()
    return value


def _same_storage(a: DataType, b: DataType) -> bool:
    """Fixed-size logical types that share flat storage (same element count
    and inner type) can re-interpret without copying."""
    pairs = {TypeId.EMBEDDING, TypeId.FIXED_SIZE_LIST, TypeId.FIXED_SHAPE_TENSOR, TypeId.FIXED_SHAPE_IMAGE}
    if a.id in pairs and b.id in pairs:
        try:
            na = int(np.prod(a.shape))
            nb = int(np.prod(b.shape))
            return na == nb
        except Exception:
            return False
    return False


def _arrow_mod(a, b):
    # Arrow lacks a modulo kernel: a - floor(a/b)*b with sign semantics of Python.
    fa = pc.cast(a, pa.float64())
    fb = pc.cast(b, pa.float64())
    q = pc.floor(pc.divide(fa, fb))
    out = pc.subtract(fa, pc.multiply(q, fb))
    if pa.types.is_integer(a.type if hasattr(a, "type") else pa.int64()) and pa.types.is_integer(
        b.type if hasattr(b, "type") else pa.int64()
    ):
        return pc.cast(out, a.type)
    return out


def _arrow_floordiv(a, b):
    out = pc.floor(pc.divide(pc.cast(a, pa.float64()), pc.cast(b, pa.float64())))
    if pa.types.is_integer(a.type) and pa.types.is_integer(b.type):
        return pc.cast(out, a.type)
    return out


def _sum_dtype(dt: DataType) -> DataType:
    if dt.is_signed_integer():
        return DataType.int64()
    if dt.is_unsigned_integer():
        return DataType.uint64()
    if dt.id == TypeId.FLOAT32:
        return DataType.float32()
    return DataType.float64()
