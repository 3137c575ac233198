"""Deterministic hashing of byte strings (port of ``daft_tpu/kernels/hashing.py``).

``hash_bytes_batch`` is the JAX package's numpy path, bit for bit: a 64-bit
polynomial (FNV-flavoured) sum over each string's bytes, plus its length,
through the splitmix64 finaliser. The hashing tokenizer takes its token ids
from it, so a port that differed by one bit would embed other tokens. The JAX
package first tries its native library (``daft_tpu/_native.py``), whose
results are the same; the port has no native library. ``hash_series``
(``Series.hash``) and ``combine_hashes`` give the row hashes that
``RecordBatch.partition_by_hash`` buckets on, so a group's rows land in one
bucket whatever the chunk.
"""

from __future__ import annotations

import threading

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType, TypeId

_NULL_HASH = np.uint64(0x9E3779B97F4A7C15)
_FNV_PRIME = np.uint64(1099511628211)
_FNV_OFFSET = np.uint64(14695981039346656037)

_pow_table = np.empty(0, dtype=np.uint64)
_POW_LOCK = threading.Lock()


def _powers(n: int) -> np.ndarray:
    """``_FNV_PRIME ** i`` mod 2**64 for i < n, from a table that grows to
    at least 4096 entries and is shared by every caller."""
    global _pow_table
    table = _pow_table
    if len(table) < n:
        with _POW_LOCK:
            table = _pow_table
            if len(table) < n:
                size = max(n, 4096)
                with np.errstate(over="ignore"):
                    table = np.empty(size, dtype=np.uint64)
                    table[0] = np.uint64(1)
                    np.multiply.accumulate(np.full(size - 1, _FNV_PRIME, dtype=np.uint64),
                                           out=table[1:])
                _pow_table = table
    return table[:n]


def _finalize(h: np.ndarray) -> np.ndarray:
    # xorshift-multiply avalanche (splitmix64 finaliser)
    with np.errstate(over="ignore"):
        h = h.copy()
        h ^= h >> np.uint64(30)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(31)
    return h


def hash_bytes_batch(data: np.ndarray, starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Hash a batch of variable-length byte strings.

    ``data`` is the concatenated uint8 byte buffer; value i spans
    ``data[starts[i] : starts[i] + lengths[i]]``. Returns (n,) uint64.
    """
    n = len(starts)
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    total = int(lengths.sum())
    if total == 0:
        return np.full(n, _finalize(np.array([_FNV_OFFSET]))[0], dtype=np.uint64)
    # Position of each byte within its own value.
    flat_idx = np.arange(total, dtype=np.int64)
    value_ids = np.repeat(np.arange(n, dtype=np.int64), lengths)
    value_starts_rep = np.repeat(np.cumsum(lengths, dtype=np.int64) - lengths, lengths)
    pos = flat_idx - value_starts_rep
    # Gather the bytes (the values need not be contiguous in ``data``).
    gather = np.repeat(starts.astype(np.int64), lengths) + pos
    b = data[gather].astype(np.uint64)
    with np.errstate(over="ignore"):
        weighted = b * _powers(int(lengths.max()))[pos]
    sums = np.zeros(n, dtype=np.uint64)
    np.add.at(sums, value_ids, weighted)  # wraps mod 2^64
    with np.errstate(over="ignore"):
        out = _FNV_OFFSET + sums + lengths.astype(np.uint64) * np.uint64(0x100000001B3)
    return _finalize(out)


def _hash_fixed_width(vals: np.ndarray) -> np.ndarray:
    """Hash fixed-width values bitwise; vals is (n,) or (n, k) numeric."""
    if len(vals) == 0:
        return np.empty(0, dtype=np.uint64)
    if vals.ndim == 1:
        vals = vals.reshape(len(vals), 1)
    raw = np.ascontiguousarray(vals).view(np.uint8).reshape(len(vals), -1)
    width = raw.shape[1]
    with np.errstate(over="ignore"):
        acc = np.full(len(vals), _FNV_OFFSET, dtype=np.uint64)
        p = _powers(width)
        acc = acc + (raw.astype(np.uint64) * p[None, :]).sum(axis=1, dtype=np.uint64)
    return _finalize(acc)


def _hash_reprs(values) -> np.ndarray:
    """Row hashes of the canonical reprs (Python objects, nested types)."""
    import hashlib

    out = np.empty(len(values), dtype=np.uint64)
    for i, v in enumerate(values):
        if v is None:
            out[i] = _NULL_HASH
        else:
            d = hashlib.sha1(repr(v).encode()).digest()
            out[i] = np.frombuffer(d[:8], dtype=np.uint64)[0]
    return out


def hash_series(s, seed=None):
    """64-bit deterministic hash of each row of a Series -> UInt64 Series."""
    from daft_tpu_torch.series import Series

    dt = s.dtype
    n = len(s)
    if dt.id == TypeId.NULL:
        out = np.full(n, _NULL_HASH, dtype=np.uint64)
    elif dt.is_python():
        out = _hash_reprs(s._data)
    elif dt.is_string() or dt.id == TypeId.BINARY:
        arr = s._data
        # large_string/large_binary: int64 offsets buffer + data buffer
        offsets = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                                count=len(arr) + 1 + arr.offset)[arr.offset:]
        databuf = arr.buffers()[2]
        data = np.frombuffer(databuf, dtype=np.uint8) if databuf is not None else np.empty(0, np.uint8)
        starts = offsets[:-1]
        lengths = (offsets[1:] - starts).astype(np.int64)
        out = hash_bytes_batch(data, starts.astype(np.int64), lengths)
    elif dt.is_device_representable():
        vals, _ = s.to_numpy_masked()
        if dt.is_floating():
            # Normalise -0.0 == 0.0 and NaNs to a canonical bit pattern.
            vals = vals.astype(np.float64, copy=True)
            vals[vals == 0.0] = 0.0
            vals[np.isnan(vals)] = np.nan
        if dt.is_boolean():
            vals = vals.astype(np.uint8)
        out = _hash_fixed_width(vals.reshape(n, -1) if vals.ndim > 1 else vals)
    elif dt.is_temporal() or dt.id == TypeId.DECIMAL128 or dt.id == TypeId.FIXED_SIZE_BINARY:
        if dt.id == TypeId.FIXED_SIZE_BINARY:
            return hash_series(Series("h", DataType.binary(), s._data.cast(pa.large_binary())),
                               seed).rename(s.name)
        t = s._data.type
        if pa.types.is_date32(t) or pa.types.is_time32(t):
            # 32-bit temporals have no direct int64 cast in Arrow: go
            # through their physical int32 first.
            vals = np.asarray(pc.cast(pc.cast(s._data, pa.int32(), safe=False), pa.int64()))
        else:
            vals = np.asarray(pc.cast(s._data, pa.int64(), safe=False))
        out = _hash_fixed_width(vals)
    else:
        out = _hash_reprs(s.to_pylist())
    # Null rows hash to a fixed sentinel (nulls group and join as equal keys
    # in hash partitioning).
    if not dt.is_python() and not dt.is_null() and s._data.null_count:
        mask = np.asarray(pc.is_null(s._data))
        out = out.copy()
        out[mask] = _NULL_HASH
    if seed is not None:
        seed_vals = seed.to_numpy().astype(np.uint64)
        with np.errstate(over="ignore"):
            out = _finalize(out * _FNV_PRIME ^ seed_vals)
    return Series.from_numpy(out, s.name, DataType.uint64())


def combine_hashes(hashes: list) -> np.ndarray:
    """Combine per-column row hashes into one row hash."""
    acc = hashes[0].astype(np.uint64, copy=True)
    for h in hashes[1:]:
        with np.errstate(over="ignore"):
            acc = _finalize(acc * _FNV_PRIME + h.astype(np.uint64))
    return acc
