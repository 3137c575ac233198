"""Build-once / probe-many equi-join index for streaming hash joins (port of
``daft_tpu/execution/join_index.py``).

The executor's in-memory hash-join path streams the probe side morsel by
morsel. Routing every morsel through Acero's ``Table.join`` would rebuild
the build-side hash table PER MORSEL — O(build x morsels) wasted work that
gets worse the finer the pipeline slices the probe stream. This module
builds a reusable index over the build side ONCE (sorted-key binary
search: ``np.argsort`` at build, two ``searchsorted`` per probe morsel)
and answers per-morsel probes with pure vectorized numpy, on the host as in
the JAX package.

Scope (everything else falls back to the per-call Acero join):

* equi-keys whose unified dtypes map to sortable numpy kinds — ints,
  uints, bools, dates/timestamps (floats are excluded: NaN breaks
  searchsorted's ordering contract; strings would pay object conversion).
  MULTI-key joins pack into one int64 domain when the per-key build
  ranges' product fits (mixed-radix: ``Σ (k_i - lo_i) * stride_i``) —
  probe values outside a build key's range are definitionally unmatched
  and mask out before packing, so aliasing across packed lanes is
  impossible;
* probe-driven join types — inner / left / semi / anti (right & outer
  track unmatched BUILD rows across the whole probe side, which is a
  blocking shape, not a streaming one). Semi/anti build MEMBERSHIP-ONLY
  indexes (no row gathering, so no argsort of the build side).

Output row order is probe-major (probe rows in input order; duplicate
build matches in build order — the stable argsort), where Acero's
threaded join emits nondeterministic order.

Null semantics match the SQL / Acero contract: null keys never match
(inner/semi drop them, left emits them unmatched, anti keeps them).

``join_counters`` records what each hash join of the executor did: its
route and the rows on each side.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series

PROBE_JOIN_TYPES = ("inner", "left", "semi", "anti")

#: numpy dtype kinds with a total order searchsorted can rely on.
_SORTABLE_KINDS = frozenset("iubM")


def _key_values(key: Series):
    """(values, null_mask|None) when the key is index-eligible, else None."""
    if key.dtype.is_python():
        return None
    vals, mask = key.to_numpy_masked()
    if not isinstance(vals, np.ndarray) or vals.dtype.kind not in _SORTABLE_KINDS:
        return None
    return vals, mask


def _as_int64(vals: np.ndarray) -> Optional[np.ndarray]:
    """Order-preserving int64 view/cast of a sortable key array, or None
    when one doesn't exist (huge uint64 values)."""
    kind = vals.dtype.kind
    if kind == "M":
        return vals.view(np.int64)
    if kind == "b":
        return vals.astype(np.int64)
    if kind == "u":
        if vals.dtype.itemsize == 8 and len(vals) \
                and int(vals.max()) > (1 << 62):
            return None
        return vals.astype(np.int64, copy=False)
    if kind == "i":
        return vals.astype(np.int64, copy=False)
    return None


class JoinIndex:
    """Key index over one join build side, with two representations:

    * **dense (CSR)** — when the int key range is at most ~4x the key
      count (TPC-H's sequential surrogate keys), a direct-address offset
      table answers a probe row in O(1): two vectorized gathers instead
      of a cache-missy binary search. ~25x faster per morsel.
    * **sorted** — otherwise, stable-argsorted keys + ``searchsorted``.

    Both keep equal build keys in original relative order, so
    duplicate-match expansion is deterministic.
    """

    #: Direct addressing wins whenever the offset table is affordable —
    #: it is transient int32, so allow spans well past the key count
    #: (57k filtered orderkeys spread over a 1.5M surrogate range is the
    #: common TPC-H shape) with an absolute ceiling on table size.
    DENSE_SPAN_FACTOR = 32
    DENSE_SPAN_MAX = 1 << 25  # 32M entries = 128MB int32, needs n >= 1M

    def __init__(self, keys_int: np.ndarray, rows: Optional[np.ndarray],
                 key_dtype):
        """``keys_int``: the build side's non-null keys as int64, in build
        order. ``rows``: their original build-row positions, or None for a
        MEMBERSHIP-ONLY index (semi/anti never gather build rows, so they
        skip the stable argsort entirely — the dominant build cost on
        multi-million-row sides)."""
        self.key_dtype = key_dtype
        #: [(lo, hi, stride, dtype)] per key for multi-key packing;
        #: None for single-key indexes.
        self.key_specs = None
        self.offsets: Optional[np.ndarray] = None
        self.key_min = 0
        self.key_max = -1
        self.sorted_keys: Optional[np.ndarray] = None
        self.sorted_rows: Optional[np.ndarray] = None
        n = len(keys_int)
        if n == 0:
            self.sorted_keys = keys_int
            self.sorted_rows = rows
            return
        lo_k, hi_k = int(keys_int.min()), int(keys_int.max())
        span = hi_k - lo_k + 1
        if 0 < span <= min(max(self.DENSE_SPAN_FACTOR * n, 1 << 16),
                           self.DENSE_SPAN_MAX):
            self.key_min = lo_k
            self.key_max = hi_k
            # offsets[k - key_min] .. offsets[k - key_min + 1] is the
            # slice of sorted_rows holding key k's build rows (bincount
            # needs no sort at all — dense membership is O(n + span)).
            counts = np.bincount(keys_int - lo_k, minlength=span)
            offsets = np.concatenate(
                [np.zeros(1, dtype=np.int64), np.cumsum(counts)])
            self.offsets = offsets.astype(np.int32, copy=False) \
                if n < (1 << 31) else offsets
            if rows is not None:
                order = np.argsort(keys_int, kind="stable")
                self.sorted_rows = rows[order]
            return
        if rows is None:
            self.sorted_keys = np.sort(keys_int)  # values only: no argsort
            return
        order = np.argsort(keys_int, kind="stable")
        self.sorted_keys = keys_int[order]
        self.sorted_rows = rows[order]

    @staticmethod
    def try_build(build_keys: Sequence[Series], how: str,
                  build_rb: RecordBatch) -> Optional["JoinIndex"]:
        """An index over ``build_rb``'s join key(s), or None when this
        join shape is out of scope. The decision is plan/data-driven only
        (never thread-count-driven), so serial and parallel runs take the
        same path."""
        if how not in PROBE_JOIN_TYPES or not build_keys:
            return None
        if any(c.dtype.is_python() for c in build_rb.columns()):
            return None
        per = []
        mask = None
        for k in build_keys:
            kv = _key_values(k)
            if kv is None:
                return None
            vals, m = kv
            iv = _as_int64(vals)
            if iv is None:
                return None
            per.append((iv, vals.dtype))
            if m is not None:
                mask = m if mask is None else (mask | m)
        membership_only = how in ("semi", "anti")
        n = len(per[0][0])
        if mask is not None:
            keep = np.nonzero(~mask)[0]
        else:
            keep = np.arange(n, dtype=np.int64)
        key_specs = None
        if len(per) == 1:
            packed = per[0][0][keep] if mask is not None else per[0][0]
            key_dtype = per[0][1]
        else:
            # Mixed-radix packing of the BUILD's per-key ranges. Strides
            # from the last key up; overflow-guarded against int64.
            if len(keep) == 0:
                packed = np.empty(0, dtype=np.int64)
                key_specs = [(0, -1, 1, d) for _, d in per]
            else:
                dims = []
                for iv, d in per:
                    kv_kept = iv[keep]
                    dims.append((int(kv_kept.min()), int(kv_kept.max()), d))
                total = 1
                for lo, hi, _ in dims:
                    total *= (hi - lo + 1)
                    if total > (1 << 62):
                        return None
                key_specs = []
                stride = 1
                for lo, hi, d in reversed(dims):
                    key_specs.append((lo, hi, stride, d))
                    stride *= (hi - lo + 1)
                key_specs.reverse()
                packed = np.zeros(len(keep), dtype=np.int64)
                for (iv, _), (lo, _hi, strd, _d) in zip(per, key_specs):
                    packed += (iv[keep] - lo) * strd
            key_dtype = None
        idx = JoinIndex(packed,
                        None if membership_only else keep.astype(np.int64),
                        key_dtype)
        idx.key_specs = key_specs
        return idx

    # ------------------------------------------------------------------ #
    def _pack_probe(self, probe_keys: Sequence[Series]):
        """(packed int64 values, miss_mask|None) for a probe morsel, or
        None when a runtime dtype defeats the index. ``miss_mask`` marks
        rows that definitionally cannot match: null keys, and (multi-key)
        values outside the build's packed range — masked BEFORE packing
        so they can never alias another lane."""
        if self.key_specs is None:
            kv = _key_values(probe_keys[0])
            if kv is None:
                return None
            vals, mask = kv
            if self.key_dtype is not None and vals.dtype != self.key_dtype \
                    and not (vals.dtype.kind in "iu"
                             and self.key_dtype.kind in "iu"):
                # Executor casts both sides to the plan's unified key
                # dtype; anything else is exotic runtime drift — bail.
                return None
            ivals = _as_int64(vals)
            if ivals is None:
                return None
            return ivals, mask
        packed = None
        miss = None
        for k, (lo, hi, stride, _d) in zip(probe_keys, self.key_specs):
            kv = _key_values(k)
            if kv is None:
                return None
            iv = _as_int64(kv[0])
            if iv is None:
                return None
            out = (iv < lo) | (iv > hi)
            if kv[1] is not None:
                out = out | kv[1]
            miss = out if miss is None else (miss | out)
            part = (np.where(out, lo, iv) - lo) * stride
            packed = part if packed is None else packed + part
        return packed, miss

    def _lookup(self, probe_keys: Sequence[Series]):
        """(lo, hi) match ranges into ``sorted_rows`` per probe row, or
        None when the probe keys' runtime dtypes defeat the index (the
        caller falls back to the Acero join for this stream)."""
        pk = self._pack_probe(probe_keys)
        if pk is None:
            return None
        ivals, mask = pk
        if self.offsets is not None:
            # Range test on the RAW values, never on (ivals - key_min):
            # that subtraction wraps in int64 for probe keys near
            # INT64_MIN against a build range near INT64_MAX, and a
            # wrapped small-positive rel would falsely "match".
            in_range = (ivals >= self.key_min) & (ivals <= self.key_max)
            rel = np.where(in_range, ivals - self.key_min, 0)
            lo = self.offsets[rel]
            hi = self.offsets[rel + 1]
            miss = ~in_range if mask is None else (~in_range | mask)
            if miss.any():
                lo = np.where(miss, 0, lo)
                hi = np.where(miss, 0, hi)
            return lo, hi
        lo = np.searchsorted(self.sorted_keys, ivals, side="left")
        hi = np.searchsorted(self.sorted_keys, ivals, side="right")
        if mask is not None:
            lo = np.where(mask, 0, lo)
            hi = np.where(mask, 0, hi)
        return lo, hi

    def probe(self, probe_rb: RecordBatch, probe_keys: Sequence[Series],
              build_rb: RecordBatch, how: str) -> Optional[RecordBatch]:
        """Join one probe morsel against the indexed build side; returns
        the joined batch with ``probe_rb``'s columns followed by
        ``build_rb``'s (callers pre-rename overlaps), or None on dtype
        fallback."""
        ranges = self._lookup(probe_keys)
        if ranges is None:
            return None
        lo, hi = ranges
        counts = hi - lo
        if how == "semi":
            return probe_rb.take(np.nonzero(counts > 0)[0].astype(np.uint64))
        if how == "anti":
            return probe_rb.take(np.nonzero(counts == 0)[0].astype(np.uint64))
        if how == "inner":
            total = int(counts.sum())
            probe_idx = np.repeat(np.arange(len(counts)), counts)
            if total:
                base = np.repeat(np.cumsum(counts) - counts, counts)
                starts = np.repeat(lo, counts)
                build_idx = self.sorted_rows[
                    starts + (np.arange(total) - base)]
            else:
                build_idx = np.empty(0, dtype=np.int64)
            return _assemble(probe_rb, build_rb, probe_idx, build_idx, None)
        # left outer: unmatched probe rows emit once with null build cols.
        counts_or1 = np.maximum(counts, 1)
        total = int(counts_or1.sum())
        probe_idx = np.repeat(np.arange(len(counts)), counts_or1)
        base = np.repeat(np.cumsum(counts_or1) - counts_or1, counts_or1)
        pos = np.repeat(lo, counts_or1) + (np.arange(total) - base)
        matched = np.repeat(counts > 0, counts_or1)
        safe_pos = np.where(matched, pos, 0)
        build_idx = self.sorted_rows[np.clip(safe_pos, 0,
                                             max(len(self.sorted_rows) - 1, 0))] \
            if len(self.sorted_rows) else np.zeros(total, dtype=np.int64)
        return _assemble(probe_rb, build_rb, probe_idx, build_idx, ~matched)


def _assemble(probe_rb: RecordBatch, build_rb: RecordBatch,
              probe_idx: np.ndarray, build_idx: np.ndarray,
              build_null_mask: Optional[np.ndarray]) -> RecordBatch:
    import pyarrow as pa

    probe_cols = [c.take(probe_idx.astype(np.uint64))
                  for c in probe_rb.columns()]
    if build_null_mask is not None and build_null_mask.any():
        idx_arr = pa.array(build_idx, mask=build_null_mask)
    else:
        idx_arr = pa.array(build_idx)
    build_cols = [_take_arrow(c, idx_arr) for c in build_rb.columns()]
    cols = probe_cols + build_cols
    schema = Schema([Field(c.name, c.dtype) for c in cols])
    return RecordBatch(schema, cols, len(probe_idx))


def _take_arrow(s: Series, idx_arr) -> Series:
    """``pc.take`` with a (possibly null-masked) index array: null indices
    produce null values — how left-join build columns go null without a
    per-column mask pass."""
    import pyarrow.compute as pc

    taken = pc.take(s.to_arrow(), idx_arr)
    return Series.from_arrow(taken, s.name, s.dtype)


class JoinCounters:
    """What each hash join did (the port's own tally: the JAX package counts
    no join in its metrics registry, and the analyzed plan prints none): one
    record per join, in the order the joins started, with its ``how``, its
    key names, the build side's rows, and per probe route the morsels and
    rows it took and the rows it gave (``dense`` / ``sorted``: the index's
    two forms; ``acero``: Arrow's join per probe morsel, or over both
    collected sides for right / outer joins)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._joins: List[dict] = []

    def start(self, how: str, on: Sequence[str], build_rows: int) -> dict:
        rec = {"how": how, "on": list(on), "build_rows": build_rows, "routes": {}}
        with self._lock:
            self._joins.append(rec)
        return rec

    def record_probe(self, rec: dict, route: str, rows_in: int, rows_out: int) -> None:
        with self._lock:
            r = rec["routes"].setdefault(route, {"morsels": 0, "rows_in": 0, "rows_out": 0})
            r["morsels"] += 1
            r["rows_in"] += rows_in
            r["rows_out"] += rows_out

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [{**j, "routes": {k: dict(v) for k, v in j["routes"].items()}}
                    for j in self._joins]


join_counters = JoinCounters()
