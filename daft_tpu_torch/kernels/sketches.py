"""Sketch kernels: HyperLogLog and quantile sketches.

Port of ``daft_tpu/kernels/sketches.py`` (reference: src/hyperloglog for
approx_count_distinct and src/daft-sketch for approx percentiles): numpy
sketches with mergeable state, as in the JAX package. The HLL registers are
built on the numpy path alone; the JAX package's native ``hll_build``
(``daft_tpu/_native.py``) computes the same registers bit for bit.
"""

from __future__ import annotations

import numpy as np

HLL_PRECISION = 14  # 2^14 registers, ~0.8% standard error (matches reference NUM_REGISTERS)
_M = 1 << HLL_PRECISION


def hll_sketch(series) -> np.ndarray:
    """Build an HLL register array (uint8[2^p]) from a Series' row hashes."""
    hashes = series.hash().to_numpy().astype(np.uint64)
    return hll_from_hashes(hashes)


def _bit_length_u64(x: np.ndarray) -> np.ndarray:
    """Exact vectorised bit length of uint64 values (0 -> 0)."""
    v = x.copy()
    bl = np.zeros(len(x), dtype=np.uint64)
    for s in (32, 16, 8, 4, 2, 1):
        ge = v >= (np.uint64(1) << np.uint64(s))
        bl[ge] += np.uint64(s)
        v[ge] >>= np.uint64(s)
    bl += (v > 0).astype(np.uint64)
    return bl


def hll_from_hashes(hashes: np.ndarray) -> np.ndarray:
    registers = np.zeros(_M, dtype=np.uint8)
    if len(hashes) == 0:
        return registers
    idx = (hashes >> np.uint64(64 - HLL_PRECISION)).astype(np.int64)
    rest = hashes << np.uint64(HLL_PRECISION)
    # rank = leading zeros of the top (64-p) bits of rest, + 1.
    lz = np.uint64(64) - _bit_length_u64(rest)
    rank = np.minimum(lz + np.uint64(1), np.uint64(64 - HLL_PRECISION + 1)).astype(np.uint8)
    np.maximum.at(registers, idx, rank)
    return registers


def hll_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(a, b)


def hll_estimate(registers: np.ndarray) -> int:
    m = float(_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv = np.exp2(-registers.astype(np.float64)).sum()
    e = alpha * m * m / inv
    if e <= 2.5 * m:
        zeros = int((registers == 0).sum())
        if zeros:
            e = m * np.log(m / zeros)
    return int(round(e))


def hll_count_distinct(series) -> int:
    return hll_estimate(hll_sketch(series))


class MergeableQuantileSketch:
    """Simple mergeable quantile sketch: keeps a bounded uniform sample.

    Stand-in for the reference's DDSketch (src/daft-sketch) with the same
    merge/finalize surface; upgraded accuracy is a later-round item.
    """

    MAX_SAMPLES = 8192

    def __init__(self, values: np.ndarray | None = None):
        self.values = np.empty(0, dtype=np.float64) if values is None else values

    @staticmethod
    def from_series(series) -> "MergeableQuantileSketch":
        vals = series.drop_null().to_numpy().astype(np.float64)
        sk = MergeableQuantileSketch(vals)
        sk._downsample()
        return sk

    def merge(self, other: "MergeableQuantileSketch") -> "MergeableQuantileSketch":
        out = MergeableQuantileSketch(np.concatenate([self.values, other.values]))
        out._downsample()
        return out

    def _downsample(self) -> None:
        if len(self.values) > self.MAX_SAMPLES:
            # Deterministic stride-based downsample keeps order statistics stable.
            stride = len(self.values) / self.MAX_SAMPLES
            idx = (np.arange(self.MAX_SAMPLES) * stride).astype(np.int64)
            self.values = np.sort(self.values)[idx]

    def quantile(self, q: float):
        if len(self.values) == 0:
            return None
        return float(np.quantile(self.values, q))


class DDSketch:
    """DDSketch: quantile sketch with relative-error guarantee alpha.

    Reference: src/daft-sketch (DDSketch serde for approx percentiles) and
    the DDSketch paper (Masson et al., VLDB'19). Values map to logarithmic
    buckets i = ceil(log_gamma(|x|)) with gamma = (1+a)/(1-a); any quantile
    read back from bucket midpoints has relative error <= a. Merging is
    bucket-wise addition, so distributed two-phase aggregation is exact in
    sketch space (vectorised numpy; buckets stored sparsely).
    """

    def __init__(self, alpha: float = 0.01):
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = np.log(self.gamma)
        self.pos: dict = {}   # bucket index -> count (x > 0)
        self.neg: dict = {}   # bucket index -> count (x < 0), indexed on |x|
        self.zeros = 0
        self.count = 0

    # -- build ----------------------------------------------------------- #
    def add_array(self, values: np.ndarray) -> "DDSketch":
        v = np.asarray(values, dtype=np.float64)
        v = v[np.isfinite(v)]  # NaN and +/-inf have no log bucket
        self.count += len(v)
        self.zeros += int((v == 0).sum())
        for store, sel in ((self.pos, v[v > 0]), (self.neg, -v[v < 0])):
            if len(sel) == 0:
                continue
            idx = np.ceil(np.log(sel) / self._log_gamma).astype(np.int64)
            uniq, counts = np.unique(idx, return_counts=True)
            for i, c in zip(uniq, counts):
                store[int(i)] = store.get(int(i), 0) + int(c)
        return self

    @staticmethod
    def from_series(series, alpha: float = 0.01) -> "DDSketch":
        vals = series.drop_null().to_numpy().astype(np.float64)
        return DDSketch(alpha).add_array(vals)

    # -- merge ----------------------------------------------------------- #
    def merge(self, other: "DDSketch") -> "DDSketch":
        assert abs(self.alpha - other.alpha) < 1e-12, "alpha mismatch"
        out = DDSketch(self.alpha)
        for store_name in ("pos", "neg"):
            a = getattr(self, store_name)
            b = getattr(other, store_name)
            merged = dict(a)
            for k, c in b.items():
                merged[k] = merged.get(k, 0) + c
            setattr(out, store_name, merged)
        out.zeros = self.zeros + other.zeros
        out.count = self.count + other.count
        return out

    # -- read ------------------------------------------------------------ #
    def quantile(self, q: float):
        if self.count == 0:
            return None
        rank = q * (self.count - 1)
        # Walk: negatives (descending |x|), zeros, positives (ascending).
        acc = 0
        for i in sorted(self.neg, reverse=True):
            acc += self.neg[i]
            if acc > rank:
                return -self._bucket_mid(i)
        if self.zeros and acc + self.zeros > rank:
            return 0.0
        acc += self.zeros
        for i in sorted(self.pos):
            acc += self.pos[i]
            if acc > rank:
                return self._bucket_mid(i)
        # numeric edge: return max bucket
        store = self.pos or self.neg
        i = max(store) if store is self.pos else min(store)
        return self._bucket_mid(i) if store is self.pos else -self._bucket_mid(i)

    def _bucket_mid(self, i: int) -> float:
        return 2.0 * self.gamma ** i / (self.gamma + 1.0)

    # -- serde (the two-phase agg wire format) --------------------------- #
    def to_bytes(self) -> bytes:
        import pickle

        return pickle.dumps({
            "alpha": self.alpha, "pos": self.pos, "neg": self.neg,
            "zeros": self.zeros, "count": self.count,
        })

    @staticmethod
    def from_bytes(data: bytes) -> "DDSketch":
        import pickle

        d = pickle.loads(data)
        sk = DDSketch(d["alpha"])
        sk.pos, sk.neg = d["pos"], d["neg"]
        sk.zeros, sk.count = d["zeros"], d["count"]
        return sk
