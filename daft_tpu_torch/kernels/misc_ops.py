"""Misc scalar kernels: hashing, null fills, coalesce, minhash and the
great-circle distance (port of ``daft_tpu/kernels/misc_ops.py``; reference:
src/daft-functions, src/daft-minhash, src/daft-geo).

Host numpy and Arrow, as in the JAX package. ``minhash`` takes the numpy path
that sits beside the JAX package's native ``minhash_rows``
(``daft_tpu/_native.py``): the same wrapping uint64 arithmetic, so every
non-null row's signature equals the native path's bit for bit. The list and
sketch finalizers (``list_count_distinct``, ``list_quantile``, ``pow_3_2``,
``dd_quantile``) serve the aggregations' two-phase finals, and ``udaf_apply`` /
``udaf_finalize`` the UDAFs' (over a list of values, or a merged partial state).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType, TypeId, unify_dtypes
from daft_tpu_torch.errors import DaftTypeError
from daft_tpu_torch.kernels.registry import register_kernel, same_dtype
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series

_MERSENNE_61 = np.uint64((1 << 61) - 1)


@register_kernel("hash", lambda f, k: Field(f[0].name, DataType.uint64()))
def _hash(args, seed=None, **kwargs):
    s = args[0]
    seed_series = None
    if seed is not None:
        seed_series = Series.from_numpy(np.full(len(s), seed, dtype=np.uint64))
    return s.hash(seed_series)


@register_kernel("fill_null", same_dtype)
def _fill_null(args, **kwargs):
    return args[0].fill_null(args[1].cast(args[0].dtype))


def _coalesce_resolver(fields, kwargs):
    dt = fields[0].dtype
    for f in fields[1:]:
        dt = unify_dtypes(dt, f.dtype)
    return Field(fields[0].name, dt)


@register_kernel("coalesce", _coalesce_resolver)
def _coalesce(args, **kwargs):
    dt = args[0].dtype
    for a in args[1:]:
        dt = unify_dtypes(dt, a.dtype)
    out = args[0].cast(dt)
    for a in args[1:]:
        out = out.fill_null(a.cast(dt))
    return out


#: List element types whose distinct values Arrow's dictionary encoding
#: tells apart as a Python set of ``to_pylist`` values does, with the
#: integers; floats too where they hold no NaN and no -0.0 (a set holds every
#: NaN apart and -0.0 with 0.0).
_ARROW_DISTINCT = (TypeId.BOOL, TypeId.STRING, TypeId.BINARY, TypeId.DATE, TypeId.TIMESTAMP)


@register_kernel("list_count_distinct", lambda f, k: Field(f[0].name, DataType.uint64()))
def _list_count_distinct(args, **kwargs):
    """Distinct-element count per list row, nulls left out (used by
    two-phase count_distinct). Lists of integers, strings, dates, ... (and
    floats without NaN or -0.0) count their (row, dictionary code) pairs, the
    same counts as the JAX package's set per row; other elements take that
    set."""
    s = args[0]
    inner = s.dtype.inner if s.dtype.id == TypeId.LIST else None
    if inner is not None and (inner.is_integer() or inner.id in _ARROW_DISTINCT
                              or inner.id in (TypeId.FLOAT32, TypeId.FLOAT64)):
        arr = s.to_arrow()
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        flat = pc.list_flatten(arr)
        keep = pc.is_valid(flat)
        values = flat.filter(keep)
        if inner.is_floating():
            v = values.to_numpy()
            if np.isnan(v).any() or np.signbit(v[v == 0]).any():
                return _count_distinct_by_set(s)  # NaN or -0.0: the set's semantics
        enc = pc.dictionary_encode(values)
        k = max(len(enc.dictionary), 1)
        rows = pc.list_parent_indices(arr).filter(keep).to_numpy().astype(np.int64)
        pairs = np.unique(rows * k + enc.indices.to_numpy().astype(np.int64))
        counts = np.bincount(pairs // k, minlength=len(arr))
        return Series.from_numpy(counts.astype(np.uint64), s.name)
    return _count_distinct_by_set(s)


def _count_distinct_by_set(s: Series) -> Series:
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(0)
        else:
            out.append(len({x for x in v if x is not None}))
    return Series.from_pylist(out, s.name, DataType.uint64())


def _quantile_resolver(fields, kwargs):
    q = kwargs.get("percentiles")
    if isinstance(q, (list, tuple)):
        return Field(fields[0].name, DataType.list(DataType.float64()))
    return Field(fields[0].name, DataType.float64())


@register_kernel("list_quantile", _quantile_resolver)
def _list_quantile(args, percentiles=0.5, **kwargs):
    """Quantile(s) of each list row (two-phase approx_percentile finalizer)."""
    s = args[0]
    multi = isinstance(percentiles, (list, tuple))
    qs = list(percentiles) if multi else [percentiles]
    out = []
    for v in s.to_pylist():
        vals = [x for x in (v or []) if x is not None]
        if not vals:
            out.append(None)
        else:
            # One conversion and one vectorised quantile call per row.
            arr = np.asarray(vals, dtype=np.float64)
            res = [float(x) for x in np.atleast_1d(np.quantile(arr, qs))]
            out.append(res if multi else res[0])
    dt = DataType.list(DataType.float64()) if multi else DataType.float64()
    return Series.from_pylist(out, s.name, dt)


@register_kernel("pow_3_2", lambda f, k: Field(f[0].name, DataType.float64()))
def _pow_3_2(args, **kwargs):
    s = args[0]
    vals, mask = s.to_numpy_masked()
    with np.errstate(all="ignore"):
        out = np.power(vals.astype(np.float64), 1.5)
    return Series.from_numpy(out, s.name)._with_mask(mask)


@register_kernel("minhash", lambda f, k: Field(
    f[0].name, DataType.fixed_size_list(DataType.uint32(), k["num_hashes"])))
def _minhash(args, num_hashes: int = 64, ngram_size: int = 1, seed: int = 1, **kwargs):
    """MinHash signature over word ngrams (reference: src/daft-minhash/src/lib.rs):
    the universal family h_i(x) = (a_i * x + b_i) mod p over 64-bit token
    hashes (``kernels/hashing.hash_bytes_batch``)."""
    from daft_tpu_torch.kernels.hashing import hash_bytes_batch

    s = args[0]
    if not s.dtype.is_string():
        raise DaftTypeError("minhash requires a string column")
    rng = np.random.default_rng(seed)
    a = rng.integers(1, _MERSENNE_61, size=num_hashes, dtype=np.uint64)
    b = rng.integers(0, _MERSENNE_61, size=num_hashes, dtype=np.uint64)
    n = len(s)
    validity = np.ones(n, dtype=bool)
    # Every row's ngram tokens in one flat byte buffer, hashed once.
    all_grams: list = []
    row_token_counts = np.zeros(n, dtype=np.int64)
    for i, text in enumerate(s.to_pylist()):
        if text is None:
            validity[i] = False
            continue
        words = text.split()
        if len(words) >= ngram_size and words:
            grams = [" ".join(words[j:j + ngram_size]) for j in range(len(words) - ngram_size + 1)]
        else:
            grams = [" ".join(words)] if words else [""]
        row_token_counts[i] = len(grams)
        all_grams.extend(g.encode() for g in grams)
    if all_grams:
        lens = np.array([len(g) for g in all_grams], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        data = np.frombuffer(b"".join(all_grams), dtype=np.uint8)
        token_hashes = hash_bytes_batch(data, starts, lens)
    else:
        token_hashes = np.empty(0, dtype=np.uint64)
    row_offsets = np.concatenate([[0], np.cumsum(row_token_counts)]).astype(np.int64)
    out = np.zeros((n, num_hashes), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(n):
            th = token_hashes[row_offsets[i]:row_offsets[i + 1]]
            if len(th) == 0:
                continue  # a null row: masked below
            hv = (th[None, :] * a[:, None] + b[:, None]) % _MERSENNE_61
            out[i] = hv.min(axis=1).astype(np.uint32)
    res = Series.from_numpy(out, s.name, DataType.fixed_size_list(DataType.uint32(), num_hashes))
    if not validity.all():
        res = res._with_mask(~validity)
    return res


def _geo_resolver(fields, kwargs):
    if len(fields) != 4:
        raise DaftTypeError(
            f"great_circle_distance takes (lat1, lon1, lat2, lon2); got {len(fields)} args"
        )
    for f in fields:
        if not f.dtype.is_numeric() and not f.dtype.is_null():
            raise DaftTypeError(
                f"great_circle_distance needs numeric coordinates; {f.name!r} is {f.dtype!r}"
            )
    return Field(fields[0].name, DataType.float64())


@register_kernel("great_circle_distance", _geo_resolver)
def _great_circle_distance(args, radius: float = 6371000.0, **kwargs):
    """Haversine great-circle distance in meters between (lat1, lon1) and
    (lat2, lon2) degree columns. Rows with a null, non-finite or out-of-range
    coordinate (|lat| > 90, |lon| > 180) are null."""
    vals, mask = [], None
    for a in args[:4]:
        v, m = a.to_numpy_masked()
        vals.append(v.astype(np.float64))
        if m is not None:
            mask = m if mask is None else (mask | m)
    lat1d, lon1d, lat2d, lon2d = vals
    with np.errstate(invalid="ignore"):
        invalid = (
            ~np.isfinite(lat1d) | ~np.isfinite(lon1d)
            | ~np.isfinite(lat2d) | ~np.isfinite(lon2d)
            | (np.abs(lat1d) > 90.0) | (np.abs(lat2d) > 90.0)
            | (np.abs(lon1d) > 180.0) | (np.abs(lon2d) > 180.0)
        )
    mask = invalid if mask is None else (mask | invalid)
    lat1, lon1, lat2, lon2 = (np.radians(v) for v in vals)
    with np.errstate(invalid="ignore"):
        h = (np.sin((lat2 - lat1) / 2.0) ** 2
             + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2.0) ** 2)
        out = 2.0 * radius * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))
    out = np.where(mask, 0.0, out) if mask.any() else out
    return Series.from_numpy(out, args[0].name)._with_mask(mask if mask.any() else None)


@register_kernel("dd_quantile", lambda f, k: Field(
    f[0].name,
    DataType.list(DataType.float64())
    if isinstance(k.get("percentiles"), (list, tuple)) else DataType.float64()))
def _dd_quantile(args, percentiles=0.5, **kwargs):
    """Finalize DDSketch two-phase approx_percentile (reference: daft-sketch)."""
    from daft_tpu_torch.kernels.sketches import DDSketch

    multi = isinstance(percentiles, (list, tuple))
    out = []
    for blob in args[0].to_pylist():
        if blob is None:
            out.append(None)
            continue
        sk = DDSketch.from_bytes(bytes(blob))
        if multi:
            out.append([sk.quantile(float(q)) for q in percentiles]
                       if sk.count else None)
        else:
            out.append(sk.quantile(float(percentiles)))
    dt = DataType.list(DataType.float64()) if multi else DataType.float64()
    return Series.from_pylist(out, args[0].name, dt)


@register_kernel("udaf_apply", lambda f, k: Field(f[0].name, k["udaf"].return_dtype))
def _udaf_apply(args, udaf=None, **kwargs):
    """Apply a UDAF to each list row (two-phase UDAF finalizer)."""
    s = args[0]
    out = []
    for v in s.to_pylist():
        vals = [x for x in (v or []) if x is not None]
        out.append(udaf.apply(vals))
    return Series.from_pylist(out, s.name, udaf.return_dtype)


@register_kernel("udaf_finalize", lambda f, k: Field(f[0].name, k["udaf"].return_dtype))
def _udaf_finalize(args, udaf=None, **kwargs):
    """Finalize each merged partial state of a UDAF with ``merge``."""
    out = [None if blob is None else udaf.finalize_state(bytes(blob))
           for blob in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, udaf.return_dtype)
