"""Window function evaluation (port of ``daft_tpu/execution/window_eval.py``).

Reference: the four window blocking sinks in src/daft-local-execution/src/sinks
(window_partition_only, window_partition_and_order_by,
window_partition_and_dynamic_frame, window_order_by_only) and daft/window.py:
partition_by with an optional order_by; row_number, rank, dense_rank,
percent_rank, lag, lead, first_value, last_value, whole-partition aggregates
and ``rows_between`` frames (sum, mean, count, min, max).

The rows, their order and the values are the JAX package's, in linear work
(ROADMAP C.39). The JAX package takes ``np.nonzero(group_ids == g)`` once per
partition and walks every row in Python with a dict per group, which is
O(rows x partitions). Here each window spec sorts its rows ONCE by
(partition, order keys, row) — the JAX package's global order within each
partition — as one sort of distinct packed int64 keys (a numeric order key
ranked by its own values), and computes on the segments of that order with
whole-array passes:

* ranks from key-change flags (rank: the last change's position; dense_rank:
  a cumulative count of changes);
* lag / lead / first_value / last_value from positions within a segment;
* whole-partition aggregates through one grouped reduction
  (``expressions/agg_eval.py``);
* ``rows_between`` frames through per-segment prefix sums; min and max through
  per-segment running extrema (a frame unbounded on one side) or a sparse
  table (a frame bounded on both sides).

Ranks, counts, integer sums, min, max and the navigation functions equal the
JAX package's bit for bit, and so do a frame's float sums and means: each
segment's prefix sums are taken in the same sequential order. A
whole-partition float sum or mean comes from a grouped (sequential) sum where
the JAX package takes Arrow's ``sum`` per partition, so it agrees within the
tolerance of two summation orders.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.evaluator import evaluate
from daft_tpu_torch.expressions.expr import Alias, AggOp, ColumnRef, Expr, WindowExpr
from daft_tpu_torch.recordbatch import RecordBatch, _group_codes
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series


class WindowWork:
    """Whole-array passes over a window's rows, in rows: the measure that
    ``tests/test_torch_window.py`` bounds by a constant times the rows,
    whatever the number of partitions. Each pass adds the length of the
    array it walks; a sort adds its rows once."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rows = 0

    def add(self, n: int) -> None:
        with self._lock:
            self.rows += int(n)

    def reset(self) -> None:
        with self._lock:
            self.rows = 0


window_work = WindowWork()


def eval_windows(rb: RecordBatch, window_exprs: Sequence[Expr], out_schema: Schema) -> RecordBatch:
    out_cols = list(rb.columns())
    segments: Dict[tuple, _Segments] = {}
    for e in window_exprs:
        w = e
        while isinstance(w, Alias):
            w = w.child
        if not isinstance(w, WindowExpr):
            raise DaftValueError(f"Expected window expression, got {e!r}")
        out_cols.append(_eval_one(rb, w, segments).rename(e.name()))
    cols = []
    for f in out_schema:
        c = next(c for c in out_cols if c.name == f.name)
        cols.append(c.cast(f.dtype) if c.dtype != f.dtype else c)
    return RecordBatch(out_schema, cols, len(rb))


class _Segments:
    """The rows of one window spec sorted once, stably, by (partition, order
    keys): ``perm`` lists the rows in that order, ``group`` is each sorted
    position's partition, ``starts`` / ``sizes`` the partitions' segments and
    ``pos`` each sorted position's place within its segment. The partition
    ids are shared by the specs that partition alike (``groups``)."""

    def __init__(self, rb: RecordBatch, w: WindowExpr, groups: Dict[tuple, np.ndarray]):
        n = len(rb)
        gkey = tuple(p.key() for p in w.partition_by)
        group_ids = groups.get(gkey)
        if group_ids is None:
            if w.partition_by:
                group_ids, _ = _group_codes([evaluate(k, rb) for k in w.partition_by])
                window_work.add(n)
            else:
                group_ids = np.zeros(n, dtype=np.int64)
            groups[gkey] = group_ids
        self.group_ids = group_ids
        num_groups = int(group_ids.max()) + 1 if n else 0
        self.order_keys: List[Series] = [evaluate(k, rb) for k in w.order_by]
        descending = list(w.descending) if w.descending else [False] * len(self.order_keys)
        self.perm, self.group = _sorted_rows(group_ids, num_groups, self.order_keys, descending)
        self.sizes = np.bincount(group_ids, minlength=num_groups).astype(np.int64)
        self.starts = np.zeros(num_groups, dtype=np.int64)
        if num_groups:
            np.cumsum(self.sizes[:-1], out=self.starts[1:])
        self.pos = np.arange(n, dtype=np.int64) - self.starts[self.group]
        window_work.add(2 * n)
        self._changes: Optional[np.ndarray] = None

    def key_changes(self) -> np.ndarray:
        """True at each sorted position whose order keys differ (as Python
        values compare, the JAX package's test) from the previous row of its
        partition, and at every partition's first row."""
        if self._changes is not None:
            return self._changes
        n = len(self.perm)
        change = self.pos == 0
        take = self.perm.astype(np.uint64)
        for key in self.order_keys:
            change[1:] |= _differs_from_previous(key.take(take))
            window_work.add(n)
        self._changes = change
        return change


def _order_rank(order_keys: List[Series], descending: List[bool]) -> tuple:
    """Each row's place in the JAX package's global order by the order keys
    (Arrow's stable sort: nulls first exactly when the first key descends, a
    float NaN next to the nulls, -0.0 equal to 0.0), as ``(rank, bits,
    unique)``: ``unique`` when no two rows share a rank, else ties keep row
    order. A single numeric key is ranked by its own values (an integer's
    offset, a float's dense code); other keys take the stable argsort."""
    n = len(order_keys[0])
    key = order_keys[0]
    if len(order_keys) == 1 and key.dtype.is_numeric() and not key.dtype.is_logical() and n:
        ranked = _numeric_rank(key, descending[0])
        if ranked is not None:
            window_work.add(2 * n)
            return ranked[0], ranked[1], False
    batch = RecordBatch(Schema([Field(f"__k{i}", k.dtype) for i, k in enumerate(order_keys)]),
                        [k.rename(f"__k{i}") for i, k in enumerate(order_keys)], n)
    order_idx = batch.argsort([batch.get_column(f"__k{i}") for i in range(len(order_keys))],
                              descending).to_numpy().astype(np.int64)
    rank = np.empty(n, dtype=np.int64)
    rank[order_idx] = np.arange(n, dtype=np.int64)
    window_work.add(2 * n)
    return rank, max(int(n - 1).bit_length(), 1), True


def _numeric_rank(key: Series, descending: bool) -> Optional[tuple]:
    """(rank, bits) of a numeric key's rows in Arrow's order, ties equal;
    None for an integer range too wide to offset."""
    vals, mask = key.to_numpy_masked()
    null = mask if mask is not None else np.zeros(len(vals), dtype=bool)
    nan = ~null & np.isnan(vals) if vals.dtype.kind == "f" else np.zeros(len(vals), dtype=bool)
    real = ~null & ~nan
    if vals.dtype.kind == "f":
        uniq, codes = np.unique(vals[real], return_inverse=True)
        k = len(uniq)
        codes = codes.astype(np.int64)
    else:
        v = vals[real].astype(np.int64)
        lo, hi = (int(v.min()), int(v.max())) if len(v) else (0, 0)
        if hi - lo >= (1 << 40):
            return None
        codes, k = v - lo, hi - lo + 1
    if descending:
        codes = (k - 1) - codes
    rank = np.empty(len(vals), dtype=np.int64)
    if descending:  # nulls, then NaN, then the values
        rank[null], rank[nan], rank[real] = 0, 1, codes + 2
    else:  # the values, then NaN, then nulls
        rank[real], rank[nan], rank[null] = codes, k, k + 1
    return rank, (k + 2).bit_length()


#: Bits of an int64 sort key: (partition, order rank, row) pack when they fit.
_PACK_BITS = 63


def _sorted_rows(group_ids: np.ndarray, num_groups: int, order_keys: List[Series],
                 descending: List[bool]) -> tuple:
    """The rows by (partition, order keys, row), the JAX package's global
    order within each partition, and each sorted position's partition. Each
    row's (partition, order rank, row) packs into one distinct int64, so one
    unstable sort of those gives the stable order (and the partitions, from
    the keys' high bits); a stable argsort by partition over the ranks where
    they do not pack."""
    n = len(group_ids)
    row_bits = max(int(n - 1).bit_length(), 1)
    group_bits = max(int(num_groups - 1).bit_length(), 1)
    if order_keys:
        rank, rank_bits, unique = _order_rank(order_keys, descending)
    else:
        rank, rank_bits, unique = None, 0, False
    tail_bits = rank_bits if unique else rank_bits + row_bits
    window_work.add(2 * n)
    if group_bits + tail_bits <= _PACK_BITS:
        packed = group_ids.astype(np.int64) << np.int64(tail_bits)
        if rank is not None:
            packed |= rank << np.int64(0 if unique else row_bits)
        if not unique:
            packed |= np.arange(n, dtype=np.int64)
        packed.sort()
        group = packed >> np.int64(tail_bits)
        low = packed & np.int64((1 << (rank_bits if unique else row_bits)) - 1)
        if not unique:
            return low, group
        order_idx = np.empty(n, dtype=np.int64)
        order_idx[rank] = np.arange(n, dtype=np.int64)
        return order_idx[low], group
    by_rank = np.argsort(rank, kind="stable") if rank is not None else np.arange(n)
    perm = by_rank[np.argsort(group_ids[by_rank], kind="stable")]
    return perm, group_ids[perm]


def _differs_from_previous(s: Series) -> np.ndarray:
    """``s[i] != s[i-1]`` for i >= 1 as the Python values compare: two nulls
    are equal, a null and a value differ, NaN differs from everything."""
    if s.dtype.is_python() or s.dtype.is_nested():
        vals = s.to_pylist()
        return np.fromiter((a != b for a, b in zip(vals[1:], vals[:-1])), dtype=bool,
                           count=max(len(vals) - 1, 0))
    arr = s.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    cur, prev = arr.slice(1), arr.slice(0, len(arr) - 1) if len(arr) else arr
    ne = np.asarray(pc.fill_null(pc.not_equal(cur, prev), False), dtype=bool)
    one_null = np.asarray(pc.xor(pc.is_valid(cur), pc.is_valid(prev)), dtype=bool)
    return ne | one_null


def _eval_one(rb: RecordBatch, w: WindowExpr, cache: Dict[tuple, "_Segments"]) -> Series:
    key = (tuple(p.key() for p in w.partition_by), tuple(o.key() for o in w.order_by),
           tuple(w.descending))
    seg = cache.get(key)
    if seg is None:
        seg = cache[key] = _Segments(rb, w, cache.setdefault("groups", {}))
    n = len(rb)

    if w.func in ("lag", "lead") or \
            (w.func in ("first_value", "last_value") and w.frame is None):
        return _eval_offset_fn(rb, w, seg, n)

    if w.func in ("row_number", "rank", "dense_rank", "percent_rank"):
        out = np.zeros(n, dtype=np.float64 if w.func == "percent_rank" else np.uint64)
        if w.func == "row_number":
            out[seg.perm] = seg.pos + 1
        else:
            change = seg.key_changes()
            if w.func == "dense_rank":
                dense = np.cumsum(change)
                out[seg.perm] = dense - dense[seg.starts[seg.group]] + 1
            else:
                last = np.maximum.accumulate(np.where(change, np.arange(n), 0)) if n else change
                rank = last - seg.starts[seg.group] + 1
                if w.func == "percent_rank":
                    denom = np.maximum(seg.sizes[seg.group] - 1, 1).astype(np.float64)
                    out[seg.perm] = (rank.astype(np.float64) - 1.0) / denom
                else:
                    out[seg.perm] = rank
        window_work.add(2 * n)
        return Series.from_numpy(out, w.func)

    # Aggregate windows: whole-partition, or a rows_between frame
    # (reference: window_partition_and_order_by / dynamic-frame sinks).
    assert w.child is not None
    child = evaluate(w.child, rb)
    if w.frame is not None:
        return _eval_rows_frame(w, child, seg, n)
    if n == 0:
        return Series.null(w.func, child.dtype, 0)
    # One grouped reduction over the partition ids, spread back to the rows.
    gb = RecordBatch(Schema([Field("__g", DataType.int64()), Field("__v", child.dtype)]),
                     [Series.from_numpy(seg.group_ids, "__g"), child.rename("__v")], n)
    per = gb.agg([Alias(AggOp(w.func, ColumnRef("__v")), "__r")], [ColumnRef("__g")])
    window_work.add(2 * n)
    slot = np.empty(len(per), dtype=np.int64)
    slot[per.get_column("__g").to_numpy().astype(np.int64)] = np.arange(len(per))
    return per.get_column("__r").take(slot[seg.group_ids].astype(np.uint64)).rename(child.name)


def _frame_bound(bound, n: int):
    """Normalise a rows_between bound to an int offset or +/-n sentinel."""
    from daft_tpu_torch.window import Window

    if bound == Window.unbounded_preceding:
        return -n
    if bound == Window.unbounded_following:
        return n
    if bound == Window.current_row:
        return 0
    return int(bound)


def _segmented_accumulate(ufunc, vals: np.ndarray, starts: np.ndarray,
                          sizes: np.ndarray) -> np.ndarray:
    """``ufunc.accumulate`` restarted at every segment (segments laid out
    back to back in ``vals``). Each segment is accumulated alone in its own
    order, so its values equal ``ufunc.accumulate`` over that segment alone
    bit for bit. Segments go into padded 2-D blocks by their length's power of
    two, so the padding stays under the rows themselves."""
    out = np.empty_like(vals)
    if len(vals) == 0:
        return out
    nz = np.nonzero(sizes > 0)[0]
    cls = np.ceil(np.log2(sizes[nz])).astype(np.int64)
    order = np.argsort(cls, kind="stable")
    bounds = np.searchsorted(cls[order], np.unique(cls), side="right")
    lo = 0
    for hi in bounds:
        segs = nz[order[lo:hi]]
        lo = hi
        lens = sizes[segs]
        width = int(lens.max())
        cols = np.arange(width, dtype=np.int64)
        mask = cols[None, :] < lens[:, None]
        idx = (starts[segs][:, None] + cols[None, :])[mask]
        block = np.zeros((len(segs), width), dtype=vals.dtype)
        block[mask] = vals[idx]
        out[idx] = ufunc.accumulate(block, axis=1)[mask]
    window_work.add(2 * len(vals))
    return out


def _eval_rows_frame(w: WindowExpr, child: Series, seg: _Segments, n: int) -> Series:
    """Rolling aggregate over a rows frame [i+start, i+end] within each
    partition, in sort order. sum / mean / count come from each segment's
    prefix sums (exact int64 for an integer sum), min / max from running
    extrema or a sparse table; any orderable dtype for min / max."""
    kind, start_b, end_b = w.frame
    if kind != "rows":
        raise DaftValueError("Only rows_between frames are supported (range pending)")
    if w.func not in ("sum", "mean", "min", "max", "count"):
        raise DaftValueError(f"Window frames not supported for {w.func}")
    if w.func in ("sum", "mean") and not child.dtype.is_numeric():
        raise DaftValueError(f"Cannot {w.func} over {child.dtype!r}")
    start_off = _frame_bound(start_b, n)
    end_off = _frame_bound(end_b, n)
    is_int_sum = w.func == "sum" and child.dtype.is_integer()
    numeric = child.dtype.is_numeric()
    sorted_child = child.take(seg.perm.astype(np.uint64))
    if numeric:
        vals, null_mask = sorted_child.to_numpy_masked()
        acc_vals = vals.astype(np.int64) if is_int_sum else vals.astype(np.float64)
    else:
        null_mask = np.asarray(pc.is_null(sorted_child.to_arrow()), dtype=bool) \
            if not sorted_child.dtype.is_python() \
            else np.array([v is None for v in sorted_child.to_pylist()], dtype=bool)
        acc_vals = None
    valid = ~null_mask if null_mask is not None else np.ones(n, dtype=bool)

    # Frame bounds within each segment, then as sorted positions [lo, hi).
    m = seg.sizes[seg.group]
    lo = np.clip(seg.pos + start_off, 0, m)
    hi = np.clip(seg.pos + end_off + 1, 0, m)
    empty = hi <= lo
    base = seg.starts[seg.group]
    if valid.all():
        cnt = np.maximum(hi - lo, 0)
    else:
        ccnt = _segmented_accumulate(np.add, valid.astype(np.int64), seg.starts, seg.sizes)
        cnt = _prefix_diff(ccnt, base, lo, hi, start_off, end_off, n)
    window_work.add(4 * n)
    if w.func == "count":
        # SQL: count over an empty frame is 0, never null.
        out = np.where(empty, 0, cnt).astype(np.uint64)
        return Series.from_numpy(_unsort(out, seg.perm), child.name)
    no_data = empty | (cnt == 0)
    if w.func in ("sum", "mean"):
        gv = np.where(valid, acc_vals, 0)
        csum = _segmented_accumulate(np.add, gv, seg.starts, seg.sizes)
        s = _prefix_diff(csum, base, lo, hi, start_off, end_off, n)
        if w.func == "mean":
            with np.errstate(invalid="ignore", divide="ignore"):
                out_num = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
        else:
            out_num = s
    elif numeric:
        fill = np.inf if w.func == "min" else -np.inf
        ufunc = np.minimum if w.func == "min" else np.maximum
        out_num = _range_reduce(ufunc, np.where(valid, acc_vals, fill), seg, lo, hi,
                                start_off, end_off, n)
    else:
        return _frame_extreme_any(w.func, sorted_child, valid, no_data, seg, lo, hi,
                                  start_off, end_off, n)
    window_work.add(2 * n)
    result = Series.from_numpy(_unsort(out_num, seg.perm), child.name)
    out_valid = _unsort(~no_data, seg.perm)
    if not out_valid.all():
        result = result._with_mask(~out_valid)
    if w.func in ("sum", "min", "max") and child.dtype.is_integer() and not is_int_sum:
        result = result.cast(DataType.int64())
    return result


def _prefix_diff(inclusive: np.ndarray, base: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                 start_off: int, end_off: int, n: int) -> np.ndarray:
    """``csum[hi] - csum[lo]`` where csum is a segment's exclusive prefix
    (csum[0] = 0), from its inclusive prefix laid out at ``base``. A frame
    that starts at the segment's start subtracts 0, and one that ends at the
    current row reads the row's own prefix: no gather for either."""
    zero = inclusive.dtype.type(0)
    if end_off == 0 and start_off > -n:
        at_hi = inclusive  # hi - 1 is the row's own place
    elif end_off == 0:
        return inclusive.copy()
    else:
        at_hi = np.where(hi > 0, inclusive[np.maximum(base + hi - 1, 0)], zero)
    if start_off <= -n:
        return at_hi - zero
    at_lo = np.where(lo > 0, inclusive[np.maximum(base + lo - 1, 0)], zero)
    return at_hi - at_lo


def _unsort(sorted_vals: np.ndarray, perm: np.ndarray) -> np.ndarray:
    out = np.empty_like(sorted_vals)
    out[perm] = sorted_vals
    return out


def _range_reduce(ufunc, vals: np.ndarray, seg: _Segments, lo: np.ndarray, hi: np.ndarray,
                  start_off: int, end_off: int, n: int) -> np.ndarray:
    """``ufunc.reduce(vals[base+lo : base+hi])`` for every sorted position
    with a non-empty frame (the others get any value). A frame open on the
    left reads a per-segment running value, one open on the right the same
    over the reversed segments; a frame bounded on both sides reads a sparse
    table of ``ceil(log2(width))`` levels."""
    base = seg.starts[seg.group]
    if n == 0:
        return vals.copy()
    safe_hi = np.maximum(hi, 1)
    if start_off <= -n:
        run = _segmented_accumulate(ufunc, vals, seg.starts, seg.sizes)
        return run[base + safe_hi - 1]
    if end_off >= n:
        # Reverse each segment in place of its positions, accumulate, read.
        rev_pos = base + (seg.sizes[seg.group] - 1 - seg.pos)
        rev = vals[rev_pos]
        run = _segmented_accumulate(ufunc, rev, seg.starts, seg.sizes)
        m = seg.sizes[seg.group]
        safe_lo = np.minimum(lo, m - 1)
        return run[base + (m - 1 - safe_lo)]
    width = max(min(end_off - start_off + 1, n), 1)
    levels = [vals]
    step = 1
    while 2 * step <= width:
        prev = levels[-1]
        nxt = prev.copy()
        nxt[:n - step] = ufunc(prev[:n - step], prev[step:])
        levels.append(nxt)
        step *= 2
        window_work.add(n)
    length = np.maximum(hi - lo, 1)
    k = np.floor(np.log2(length)).astype(np.int64)
    out = np.empty(n, dtype=vals.dtype)
    for lvl in np.unique(k):
        sel = np.nonzero(k == lvl)[0]
        # An empty frame (hi <= lo) reads any in-range cell: it is masked.
        m = seg.sizes[seg.group[sel]]
        a = base[sel] + np.minimum(lo[sel], m - 1)
        b = np.maximum(base[sel] + np.minimum(hi[sel], m) - (1 << int(lvl)), a)
        table = levels[int(lvl)]
        out[sel] = ufunc(table[a], table[b])
    window_work.add(2 * n)
    return out


def _frame_extreme_any(func: str, sorted_child: Series, valid: np.ndarray, no_data: np.ndarray,
                       seg: _Segments, lo, hi, start_off: int, end_off: int, n: int) -> Series:
    """min / max over a frame of any orderable dtype: the values' dense ranks
    (one sort, as Python orders them) through the same range reduction, read
    back as a row holding that rank."""
    pyvals = sorted_child.to_pylist()
    idx = [i for i in range(n) if valid[i]]
    idx.sort(key=lambda i: pyvals[i])
    codes = np.zeros(n, dtype=np.int64)
    rep = np.zeros(max(len(idx), 1), dtype=np.int64)
    code = -1
    prev = None
    for j, i in enumerate(idx):
        if j == 0 or pyvals[i] != prev:
            code += 1
            rep[code] = i
            prev = pyvals[i]
        codes[i] = code
    window_work.add(2 * n)
    sentinel = np.int64(2 ** 62) if func == "min" else np.int64(-1)
    codes = np.where(valid, codes, sentinel)
    ufunc = np.minimum if func == "min" else np.maximum
    best = _range_reduce(ufunc, codes, seg, lo, hi, start_off, end_off, n)
    src = np.where(no_data, 0, rep[np.clip(best, 0, len(rep) - 1)])
    taken = sorted_child.take(_unsort(src, seg.perm).astype(np.uint64))
    out_valid = _unsort(~no_data, seg.perm)
    if not out_valid.all():
        taken = taken._with_mask(~out_valid)
    return taken


def _eval_offset_fn(rb: RecordBatch, w: WindowExpr, seg: _Segments, n: int) -> Series:
    """lag/lead/first_value/last_value within each partition in sort order
    (reference: window_partition_and_order_by sink's navigation functions)."""
    child = evaluate(w.child, rb)
    src_sorted = np.zeros(n, dtype=np.int64)
    if w.func in ("lag", "lead"):
        offset = int(w.kwargs.get("offset", 1))
        if offset < 1:
            raise DaftValueError(f"{w.func} offset must be at least 1, got {offset}")
        if w.func == "lag":
            ok = seg.pos >= offset
            src_sorted[ok] = np.nonzero(ok)[0] - offset
        else:
            ok = seg.pos + offset < seg.sizes[seg.group]
            src_sorted[ok] = np.nonzero(ok)[0] + offset
    else:
        ok = np.ones(n, dtype=bool)
        first = seg.starts[seg.group]
        src_sorted = first if w.func == "first_value" else first + seg.sizes[seg.group] - 1
    window_work.add(2 * n)
    out_idx = np.zeros(n, dtype=np.int64)
    out_idx[seg.perm] = seg.perm[src_sorted] if n else src_sorted
    valid = _unsort(ok, seg.perm)
    taken = child.take(np.where(valid, out_idx, 0).astype(np.uint64))
    if not valid.all():
        default = w.kwargs.get("default")
        if default is not None:
            dseries = Series.full(child.name, default, n, child.dtype)
            taken = Series.from_numpy(valid, "m").if_else(taken, dseries)
        else:
            taken = taken._with_mask(~valid)
    return taken

