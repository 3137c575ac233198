"""Deterministic hashing of byte strings (port of ``daft_tpu/kernels/hashing.py``).

``hash_bytes_batch`` is the JAX package's numpy path, bit for bit: a 64-bit
polynomial (FNV-flavoured) sum over each string's bytes, plus its length,
through the splitmix64 finaliser. The hashing tokenizer takes its token ids
from it, so a port that differed by one bit would embed other tokens. The JAX
package first tries its native library (``daft_tpu/_native.py``), whose
results are the same; the port has no native library. Not ported yet:
``hash_series``, ``combine_hashes`` and the fixed-width hash.
"""

from __future__ import annotations

import threading

import numpy as np

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
