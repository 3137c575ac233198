"""Long-tail scalar kernels (port of ``daft_tpu/kernels/extended_ops.py``):
numeric extras, bitwise ops and shifts, string case, distance and codec ops,
JSON queries, serialize / deserialize, binary codecs and compression,
partition transforms, similarity metrics, file helpers and ``try_cast``.

The kernels that carry a ``jax_fn`` in the JAX package carry a ``torch_fn``
here, and only those: the host implementations are the JAX package's (numpy
in f64, or Arrow compute), with each kernel's own null rule, and the torch
lowering of each runs on ``cfg.device`` through the relational device layer.
None of them has the same rules on both paths (``torch_same_rules``, the JAX
package's ``jax_exact``), so the device takes them only where no input it
reads is nullable, and only at 32-bit outputs: ``cosine_similarity`` resolves
to f64 and runs there only inside a 32-bit expression, as in the JAX package.
Every other kernel here runs on the host, as in the JAX package.

``pmod`` by 0 differs between the routes, as in the JAX package: the host
gives null, the device ``jnp.mod``'s value (0 for integers, NaN for floats;
ROADMAP C.26). ``compress`` with zstd imports ``zstandard`` when it runs.
"""

from __future__ import annotations

import base64
import json
import math
import re
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.kernels.registry import (
    as_tensor_like,
    float_preserving,
    register_kernel,
    returns,
    same_dtype,
)
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series

_STR = DataType.string()
_BOOL = DataType.bool()
_I64 = DataType.int64()
_F64 = DataType.float64()
_BIN = DataType.binary()


def _wrap(out, name, dtype=None):
    return Series.from_arrow(out, name, dtype)


def _scalar(args, i):
    return args[i].scalar()


def _or_masks(am, bm):
    return am if bm is None else (bm if am is None else am | bm)


def _float_unary(name, np_fn, torch_fn):
    @register_kernel(name, float_preserving, torch_fn=lambda a: torch_fn(a[0]))
    def _k(args, **kwargs):
        vals, mask = args[0].to_numpy_masked()
        with np.errstate(all="ignore"):
            out = np_fn(vals.astype(np.float64))
        return Series.from_numpy(out, args[0].name)._with_mask(mask)
    return _k


# The scale constants round to the operand's dtype first, as jnp.radians and
# jnp.degrees do (a Python float is weakly typed in torch as in jnp).
_float_unary("csc", lambda x: 1.0 / np.sin(x), lambda x: 1.0 / torch.sin(x))
_float_unary("sec", lambda x: 1.0 / np.cos(x), lambda x: 1.0 / torch.cos(x))
_float_unary("cot", lambda x: 1.0 / np.tan(x), lambda x: 1.0 / torch.tan(x))
_float_unary("atanh", np.arctanh, torch.atanh)
_float_unary("acosh", np.arccosh, torch.acosh)
_float_unary("asinh", np.arcsinh, torch.asinh)
_float_unary("radians", np.radians, lambda x: x * (math.pi / 180.0))
_float_unary("degrees", np.degrees, lambda x: x * (180.0 / math.pi))


@register_kernel("negate", same_dtype, torch_fn=lambda a: -a[0])
def _negate(args, **kwargs):
    vals, mask = args[0].to_numpy_masked()
    return Series.from_numpy(-vals, args[0].name, args[0].dtype)._with_mask(mask)


@register_kernel("hypot", float_preserving,
                 torch_fn=lambda a: torch.hypot(as_tensor_like(a[0], a[1]),
                                                as_tensor_like(a[1], a[0])))
def _hypot(args, **kwargs):
    a, am = args[0].to_numpy_masked()
    b, bm = args[1].to_numpy_masked()
    return Series.from_numpy(np.hypot(a.astype(np.float64), b.astype(np.float64)),
                             args[0].name)._with_mask(_or_masks(am, bm))


def _pmod_torch(a):
    # jnp.mod: the device layer's ``%`` (XLA's values for a zero divisor).
    from daft_tpu_torch.ops.device_eval import _binary

    return _binary("mod", a[0], a[1])


@register_kernel("pmod", same_dtype, torch_fn=_pmod_torch)
def _pmod(args, **kwargs):
    a, am = args[0].to_numpy_masked()
    b, bm = args[1].to_numpy_masked()
    with np.errstate(all="ignore"):
        out = np.mod(a, np.where(b == 0, 1, b))
    mask = _or_masks(am, bm)
    mask = (b == 0) if mask is None else mask | (b == 0)
    return Series.from_numpy(out, args[0].name, args[0].dtype)._with_mask(mask)


def _bitwise(name, arrow_fn, torch_fn):
    @register_kernel(name, same_dtype, torch_fn=lambda a: torch_fn(a[0], a[1]))
    def _k(args, **kwargs):
        out = arrow_fn(args[0].to_arrow(), args[1].cast(args[0].dtype).to_arrow())
        return Series.from_arrow(out, args[0].name, args[0].dtype)
    return _k


_bitwise("bitwise_and", pc.bit_wise_and, lambda x, y: x & y)
_bitwise("bitwise_or", pc.bit_wise_or, lambda x, y: x | y)
_bitwise("bitwise_xor", pc.bit_wise_xor, lambda x, y: x ^ y)


@register_kernel("bitwise_not", same_dtype, torch_fn=lambda a: ~a[0])
def _bnot(args, **kwargs):
    return Series.from_arrow(pc.bit_wise_not(args[0].to_arrow()), args[0].name, args[0].dtype)


def _cos_sim_torch(a):
    x, y = a[0], a[1]
    den = torch.linalg.vector_norm(x, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
    return (x * y).sum(-1) / den.clamp(min=1e-12)


@register_kernel("cosine_similarity", returns(_F64), torch_fn=_cos_sim_torch)
def _cos_sim(args, **kwargs):
    a = args[0].to_numpy().astype(np.float64)
    b = args[1].to_numpy().astype(np.float64)
    if b.shape[0] == 1 and a.shape[0] != 1:
        b = np.broadcast_to(b, a.shape)
    num = (a * b).sum(-1)
    den = np.clip(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12, None)
    return Series.from_numpy(num / den, args[0].name, _F64)


@register_kernel("factorial", returns(_I64))
def _factorial(args, **kwargs):
    out = [None if v is None else math.factorial(int(v)) for v in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, _I64)


@register_kernel("bin", returns(_STR))
def _bin(args, **kwargs):
    out = [None if v is None else bin(int(v))[2:] for v in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("conv", returns(_STR))
def _conv(args, from_base: int = 10, to_base: int = 16, **kwargs):
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"

    def do(v):
        if v is None:
            return None
        n = int(str(v), from_base)
        if n == 0:
            return "0"
        neg = n < 0
        n = -n if neg else n
        s = ""
        while n:
            s = digits[n % to_base] + s
            n //= to_base
        return ("-" if neg else "") + s

    return Series.from_pylist([do(v) for v in args[0].to_pylist()], args[0].name, _STR)


@register_kernel("shift_left", same_dtype)
def _shl(args, **kwargs):
    return _wrap(pc.shift_left(args[0].to_arrow(), args[1].cast(args[0].dtype).to_arrow()),
                 args[0].name, args[0].dtype)


@register_kernel("shift_right", same_dtype)
def _shr(args, **kwargs):
    return _wrap(pc.shift_right(args[0].to_arrow(), args[1].cast(args[0].dtype).to_arrow()),
                 args[0].name, args[0].dtype)


# ------------------------------------------------------------------ #
# string case conversions                                             #
# ------------------------------------------------------------------ #
_WORD_RE = re.compile(r"[A-Za-z0-9]+")


def _words(s: str):
    # split camelCase + delimiters into word list
    s = re.sub(r"([a-z0-9])([A-Z])", r"\1 \2", s)
    return _WORD_RE.findall(s)


def _case_kernel(name, fn):
    @register_kernel(name, returns(_STR))
    def _k(args, **kwargs):
        out = [None if v is None else fn(v) for v in args[0].cast(_STR).to_pylist()]
        return Series.from_pylist(out, args[0].name, _STR)
    return _k


_case_kernel("str_to_camel_case",
             lambda s: "".join(w.lower() if i == 0 else w.capitalize()
                               for i, w in enumerate(_words(s))))
_case_kernel("str_to_upper_camel_case",
             lambda s: "".join(w.capitalize() for w in _words(s)))
_case_kernel("str_to_snake_case", lambda s: "_".join(w.lower() for w in _words(s)))
_case_kernel("str_to_upper_snake_case", lambda s: "_".join(w.upper() for w in _words(s)))
_case_kernel("str_to_kebab_case", lambda s: "-".join(w.lower() for w in _words(s)))
_case_kernel("str_to_upper_kebab_case", lambda s: "-".join(w.upper() for w in _words(s)))
_case_kernel("str_to_title_case", lambda s: " ".join(w.capitalize() for w in _words(s)))
_case_kernel("str_swapcase", lambda s: s.swapcase())


@register_kernel("str_translate", returns(_STR))
def _translate(args, **kwargs):
    src, dst = _scalar(args, 1), _scalar(args, 2)
    table = str.maketrans(src, dst[:len(src)].ljust(len(src)))
    out = [None if v is None else v.translate(table) for v in args[0].cast(_STR).to_pylist()]
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("str_substring_index", returns(_STR))
def _substring_index(args, **kwargs):
    delim, count = _scalar(args, 1), int(_scalar(args, 2))

    def do(v):
        if v is None:
            return None
        parts = v.split(delim)
        if count > 0:
            return delim.join(parts[:count])
        if count < 0:
            return delim.join(parts[count:])
        return ""

    return Series.from_pylist([do(v) for v in args[0].cast(_STR).to_pylist()],
                              args[0].name, _STR)


_SOUNDEX_MAP = {**{c: "1" for c in "BFPV"}, **{c: "2" for c in "CGJKQSXZ"},
                **{c: "3" for c in "DT"}, "L": "4", **{c: "5" for c in "MN"},
                "R": "6"}


@register_kernel("str_soundex", returns(_STR))
def _soundex(args, **kwargs):
    def do(v):
        if v is None or not v:
            return v
        s = v.upper()
        first = s[0]
        codes = [_SOUNDEX_MAP.get(c, "") for c in s]
        out = [codes[0]]
        for c in codes[1:]:
            if c and c != out[-1]:
                out.append(c)
            elif not c:
                out.append("")
        body = "".join(c for c in out[1:] if c)
        return (first + body + "000")[:4]

    return Series.from_pylist([do(v) for v in args[0].cast(_STR).to_pylist()],
                              args[0].name, _STR)


@register_kernel("ascii", returns(_I64))
def _ascii(args, **kwargs):
    out = [None if v is None else (ord(v[0]) if v else 0)
           for v in args[0].cast(_STR).to_pylist()]
    return Series.from_pylist(out, args[0].name, _I64)


@register_kernel("chr", returns(_STR))
def _chr(args, **kwargs):
    out = [None if v is None else chr(int(v)) for v in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("space", returns(_STR))
def _space(args, **kwargs):
    out = [None if v is None else " " * int(v) for v in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("format_string", returns(_STR))
def _format_string(args, fmt: str = "", **kwargs):
    cols = [a.to_pylist() for a in args]
    n = len(cols[0]) if cols else 0
    out = []
    for i in range(n):
        row = [c[i] for c in cols]
        out.append(None if any(v is None for v in row) else fmt % tuple(row))
    return Series.from_pylist(out, args[0].name if args else "format", _STR)


# ------------------------------------------------------------------ #
# string distances / similarity                                       #
# ------------------------------------------------------------------ #
def _pairs(args):
    a = args[0].cast(_STR).to_pylist()
    b = args[1].cast(_STR).to_pylist()
    if len(b) == 1 and len(a) != 1:
        b = b * len(a)
    return a, b


def _levenshtein(s, t):
    if s == t:
        return 0
    if not s:
        return len(t)
    if not t:
        return len(s)
    prev = list(range(len(t) + 1))
    for i, cs in enumerate(s):
        cur = [i + 1]
        for j, ct in enumerate(t):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (cs != ct)))
        prev = cur
    return prev[-1]


@register_kernel("levenshtein_distance", returns(_I64))
def _lev(args, **kwargs):
    a, b = _pairs(args)
    out = [None if (x is None or y is None) else _levenshtein(x, y)
           for x, y in zip(a, b)]
    return Series.from_pylist(out, args[0].name, _I64)


def _damerau(s, t):
    d = {}
    ls, lt = len(s), len(t)
    for i in range(-1, ls + 1):
        d[(i, -1)] = i + 1
    for j in range(-1, lt + 1):
        d[(-1, j)] = j + 1
    for i in range(ls):
        for j in range(lt):
            cost = 0 if s[i] == t[j] else 1
            d[(i, j)] = min(d[(i - 1, j)] + 1, d[(i, j - 1)] + 1,
                            d[(i - 1, j - 1)] + cost)
            if i and j and s[i] == t[j - 1] and s[i - 1] == t[j]:
                d[(i, j)] = min(d[(i, j)], d[(i - 2, j - 2)] + 1)
    return d[(ls - 1, lt - 1)]


@register_kernel("damerau_levenshtein_distance", returns(_I64))
def _damerau_k(args, **kwargs):
    a, b = _pairs(args)
    out = [None if (x is None or y is None) else _damerau(x, y) for x, y in zip(a, b)]
    return Series.from_pylist(out, args[0].name, _I64)


def _jaro(s, t):
    if s == t:
        return 1.0
    ls, lt = len(s), len(t)
    if not ls or not lt:
        return 0.0
    window = max(ls, lt) // 2 - 1
    sm = [False] * ls
    tm = [False] * lt
    matches = 0
    for i in range(ls):
        lo, hi = max(0, i - window), min(i + window + 1, lt)
        for j in range(lo, hi):
            if not tm[j] and s[i] == t[j]:
                sm[i] = tm[j] = True
                matches += 1
                break
    if not matches:
        return 0.0
    k = trans = 0
    for i in range(ls):
        if sm[i]:
            while not tm[k]:
                k += 1
            if s[i] != t[k]:
                trans += 1
            k += 1
    trans //= 2
    return (matches / ls + matches / lt + (matches - trans) / matches) / 3.0


@register_kernel("jaro_similarity", returns(_F64))
def _jaro_k(args, **kwargs):
    a, b = _pairs(args)
    out = [None if (x is None or y is None) else _jaro(x, y) for x, y in zip(a, b)]
    return Series.from_pylist(out, args[0].name, _F64)


@register_kernel("jaro_winkler_similarity", returns(_F64))
def _jaro_winkler(args, **kwargs):
    a, b = _pairs(args)

    def jw(x, y):
        j = _jaro(x, y)
        prefix = 0
        for cx, cy in zip(x[:4], y[:4]):
            if cx != cy:
                break
            prefix += 1
        return j + prefix * 0.1 * (1 - j)

    out = [None if (x is None or y is None) else jw(x, y) for x, y in zip(a, b)]
    return Series.from_pylist(out, args[0].name, _F64)


@register_kernel("hamming_distance_str", returns(_I64))
def _hamming_str(args, **kwargs):
    a, b = _pairs(args)

    def ham(x, y):
        if len(x) != len(y):
            raise DaftValueError("hamming_distance requires equal-length strings")
        return sum(cx != cy for cx, cy in zip(x, y))

    out = [None if (x is None or y is None) else ham(x, y) for x, y in zip(a, b)]
    return Series.from_pylist(out, args[0].name, _I64)


# ------------------------------------------------------------------ #
# JSON                                                                #
# ------------------------------------------------------------------ #
_JSON_PATH = re.compile(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]")


def _json_get(doc, path: str):
    cur = doc
    for m in _JSON_PATH.finditer(path):
        if cur is None:
            return None
        key, idx = m.group(1), m.group(2)
        try:
            cur = cur[key] if key is not None else cur[int(idx)]
        except (KeyError, IndexError, TypeError):
            return None
    return cur


@register_kernel("json_query", returns(_STR))
def _json_query(args, query: str = ".", **kwargs):
    def do(v):
        if v is None:
            return None
        try:
            got = _json_get(json.loads(v), query)
        except json.JSONDecodeError:
            return None
        if got is None:
            return None
        return got if isinstance(got, str) else json.dumps(got)

    return Series.from_pylist([do(v) for v in args[0].cast(_STR).to_pylist()],
                              args[0].name, _STR)


@register_kernel("json_array_length", returns(_I64))
def _json_array_length(args, **kwargs):
    def do(v):
        if v is None:
            return None
        try:
            got = json.loads(v)
        except json.JSONDecodeError:
            return None
        return len(got) if isinstance(got, list) else None

    return Series.from_pylist([do(v) for v in args[0].cast(_STR).to_pylist()],
                              args[0].name, _I64)


@register_kernel("json_object_keys",
                 lambda f, k: Field(f[0].name, DataType.list(DataType.string())))
def _json_object_keys(args, **kwargs):
    def do(v):
        if v is None:
            return None
        try:
            got = json.loads(v)
        except json.JSONDecodeError:
            return None
        return list(got.keys()) if isinstance(got, dict) else None

    return Series.from_pylist([do(v) for v in args[0].cast(_STR).to_pylist()],
                              args[0].name, DataType.list(DataType.string()))


# ------------------------------------------------------------------ #
# serialize / deserialize                                             #
# ------------------------------------------------------------------ #
@register_kernel("serialize", returns(_STR))
def _serialize(args, format: str = "json", **kwargs):
    if format != "json":
        raise DaftValueError(f"serialize format {format!r} not supported (json only)")
    out = [None if v is None else json.dumps(v, default=str) for v in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, _STR)


def _deserialize_impl(args, format, strict):
    if format != "json":
        raise DaftValueError(f"deserialize format {format!r} not supported (json only)")

    def do(v):
        if v is None:
            return None
        try:
            return json.loads(v)
        except json.JSONDecodeError:
            if strict:
                raise DaftValueError(f"invalid JSON: {v[:80]!r}")
            return None

    return Series.from_pylist([do(v) for v in args[0].cast(_STR).to_pylist()],
                              args[0].name, DataType.python())


@register_kernel("deserialize", returns(DataType.python()))
def _deserialize(args, format: str = "json", **kwargs):
    return _deserialize_impl(args, format, strict=True)


@register_kernel("try_deserialize", returns(DataType.python()))
def _try_deserialize(args, format: str = "json", **kwargs):
    return _deserialize_impl(args, format, strict=False)


# ------------------------------------------------------------------ #
# binary encode/decode/compress                                       #
# ------------------------------------------------------------------ #
_CODECS = {
    "base64": (lambda b: base64.b64encode(b), lambda b: base64.b64decode(b)),
    "hex": (lambda b: b.hex().encode(), lambda b: bytes.fromhex(b.decode())),
    "utf-8": (lambda b: b, lambda b: b),
}


def _codec_impl(args, codec, direction, strict, name):
    if codec not in _CODECS:
        raise DaftValueError(f"Unknown codec {codec!r} (base64/hex/utf-8)")
    enc, dec = _CODECS[codec]
    fn = enc if direction == "encode" else dec

    def do(v):
        if v is None:
            return None
        b = v.encode() if isinstance(v, str) else bytes(v)
        try:
            return fn(b)
        except Exception:
            if strict:
                raise DaftValueError(f"cannot {direction} {codec}: {v!r}")
            return None

    vals = [do(v) for v in args[0].to_pylist()]
    if direction == "encode" and codec == "hex":
        return Series.from_pylist([None if v is None else v.decode() for v in vals],
                                  name, _STR)
    return Series.from_pylist(vals, name, _BIN)


@register_kernel("encode", returns(_BIN))
def _encode(args, codec: str = "base64", **kwargs):
    return _codec_impl(args, codec, "encode", True, args[0].name)


@register_kernel("decode", returns(_BIN))
def _decode(args, codec: str = "base64", **kwargs):
    return _codec_impl(args, codec, "decode", True, args[0].name)


@register_kernel("try_encode", returns(_BIN))
def _try_encode(args, codec: str = "base64", **kwargs):
    return _codec_impl(args, codec, "encode", False, args[0].name)


@register_kernel("try_decode", returns(_BIN))
def _try_decode(args, codec: str = "base64", **kwargs):
    return _codec_impl(args, codec, "decode", False, args[0].name)


def _compression(codec):
    if codec in ("zlib", "deflate"):
        return zlib.compress, zlib.decompress
    if codec == "gzip":
        import gzip

        return gzip.compress, gzip.decompress
    if codec == "zstd":
        import zstandard

        return (lambda b: zstandard.ZstdCompressor().compress(b),
                lambda b: zstandard.ZstdDecompressor().decompress(b))
    raise DaftValueError(f"Unknown compression codec {codec!r} (zlib/gzip/zstd)")


def _compress_impl(args, codec, direction, strict):
    comp, decomp = _compression(codec)
    fn = comp if direction == "compress" else decomp

    def do(v):
        if v is None:
            return None
        b = v.encode() if isinstance(v, str) else bytes(v)
        try:
            return fn(b)
        except Exception:
            if strict:
                raise DaftValueError(f"cannot {direction} with {codec}")
            return None

    return Series.from_pylist([do(v) for v in args[0].to_pylist()], args[0].name, _BIN)


@register_kernel("compress", returns(_BIN))
def _compress(args, codec: str = "zstd", **kwargs):
    return _compress_impl(args, codec, "compress", True)


@register_kernel("decompress", returns(_BIN))
def _decompress(args, codec: str = "zstd", **kwargs):
    return _compress_impl(args, codec, "decompress", True)


@register_kernel("try_compress", returns(_BIN))
def _try_compress(args, codec: str = "zstd", **kwargs):
    return _compress_impl(args, codec, "compress", False)


@register_kernel("try_decompress", returns(_BIN))
def _try_decompress(args, codec: str = "zstd", **kwargs):
    return _compress_impl(args, codec, "decompress", False)


# ------------------------------------------------------------------ #
# misc                                                                #
# ------------------------------------------------------------------ #
@register_kernel("uuid", returns(_STR))
def _uuid(args, **kwargs):
    import uuid as _uuid_mod

    n = len(args[0]) if args else 1
    return Series.from_pylist([str(_uuid_mod.uuid4()) for _ in range(n)], "uuid", _STR)


@register_kernel("random_int", returns(_I64))
def _random_int(args, lower: int = 0, upper: int = 2 ** 63 - 1, seed=None, **kwargs):
    n = len(args[0]) if args else 1
    rng = np.random.default_rng(seed)
    return Series.from_numpy(rng.integers(lower, upper, n), "random_int", _I64)


@register_kernel("eq_null_safe", returns(_BOOL))
def _eq_null_safe(args, **kwargs):
    a, b = args[0], args[1].cast(args[0].dtype)
    an, bn = a.is_null().to_numpy(), b.is_null().to_numpy()
    eq = np.asarray(pc.fill_null(pc.equal(a.to_arrow(), b.to_arrow()), False))
    out = np.where(an & bn, True, np.where(an ^ bn, False, eq))
    return Series.from_numpy(out, a.name, _BOOL)


@register_kernel("simhash", returns(DataType.uint64()))
def _simhash(args, ngram_size: int = 2, **kwargs):
    import hashlib

    def _h64(b: bytes) -> np.uint64:
        return np.frombuffer(hashlib.blake2b(b, digest_size=8).digest(),
                             dtype=np.uint64)[0]

    def do(v):
        if v is None:
            return None
        toks = [v[i:i + ngram_size] for i in range(max(len(v) - ngram_size + 1, 1))]
        acc = np.zeros(64, dtype=np.int64)
        for t in toks:
            h = _h64(t.encode())
            bits = (h >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
            acc += np.where(bits.astype(bool), 1, -1)
        bits = (acc > 0).astype(np.uint64)
        return int((bits << np.arange(64, dtype=np.uint64)).sum())

    return Series.from_pylist([do(v) for v in args[0].cast(_STR).to_pylist()],
                              args[0].name, DataType.uint64())


# ------------------------------------------------------------------ #
# partition transforms (reference: daft/functions/partition.py,        #
# iceberg partition spec)                                             #
# ------------------------------------------------------------------ #
def _epoch_parts(args, unit):
    arr = args[0].cast(DataType.timestamp("us")).to_arrow()
    us = np.asarray(arr.cast(pa.int64()), dtype=np.int64)
    div = {"hours": 3_600_000_000, "days": 86_400_000_000}[unit]
    mask = args[0].is_null().to_numpy()
    out = np.floor_divide(us, div).astype(np.int32)
    return Series.from_numpy(out, args[0].name,
                             DataType.int32())._with_mask(mask if mask.any() else None)


@register_kernel("partition_days", returns(DataType.int32()))
def _partition_days(args, **kwargs):
    return _epoch_parts(args, "days")


@register_kernel("partition_hours", returns(DataType.int32()))
def _partition_hours(args, **kwargs):
    return _epoch_parts(args, "hours")


def _ym(args):
    from daft_tpu_torch.kernels.registry import get_kernel

    ys = get_kernel("dt_year")([args[0]]).to_numpy().astype(np.int64)
    ms = get_kernel("dt_month")([args[0]]).to_numpy().astype(np.int64)
    return ys, ms


@register_kernel("partition_months", returns(DataType.int32()))
def _partition_months(args, **kwargs):
    ys, ms = _ym(args)
    mask = args[0].is_null().to_numpy()
    out = ((ys - 1970) * 12 + ms - 1).astype(np.int32)
    return Series.from_numpy(out, args[0].name,
                             DataType.int32())._with_mask(mask if mask.any() else None)


@register_kernel("partition_years", returns(DataType.int32()))
def _partition_years(args, **kwargs):
    ys, _ = _ym(args)
    mask = args[0].is_null().to_numpy()
    return Series.from_numpy((ys - 1970).astype(np.int32), args[0].name,
                             DataType.int32())._with_mask(mask if mask.any() else None)


@register_kernel("partition_iceberg_bucket", returns(DataType.int32()))
def _iceberg_bucket(args, n: int = 16, **kwargs):
    h = args[0].hash().to_numpy().astype(np.uint64)
    mask = args[0].is_null().to_numpy()
    out = ((h & np.uint64(0x7FFFFFFF)) % np.uint64(n)).astype(np.int32)
    return Series.from_numpy(out, args[0].name,
                             DataType.int32())._with_mask(mask if mask.any() else None)


@register_kernel("partition_iceberg_truncate", same_dtype)
def _iceberg_truncate(args, w: int = 10, **kwargs):
    s = args[0]
    if s.dtype.is_numeric():
        vals, mask = s.to_numpy_masked()
        out = vals - np.mod(vals, w)
        return Series.from_numpy(out, s.name, s.dtype)._with_mask(mask)
    out = [None if v is None else v[:w] for v in s.cast(_STR).to_pylist()]
    return Series.from_pylist(out, s.name, _STR)


@register_kernel("hamming_distance", returns(_I64))
def _hamming(args, **kwargs):
    a = args[0].to_numpy()
    b = args[1].to_numpy()
    if b.shape[0] == 1 and a.shape[0] != 1:
        b = np.broadcast_to(b, a.shape)
    return Series.from_numpy((a != b).sum(-1).astype(np.int64), args[0].name, _I64)


@register_kernel("pearson_correlation", returns(_F64))
def _pearson(args, **kwargs):
    a = args[0].to_numpy().astype(np.float64)
    b = args[1].to_numpy().astype(np.float64)
    if b.shape[0] == 1 and a.shape[0] != 1:
        b = np.broadcast_to(b, a.shape)
    am = a - a.mean(-1, keepdims=True)
    bm = b - b.mean(-1, keepdims=True)
    num = (am * bm).sum(-1)
    den = np.clip(np.sqrt((am * am).sum(-1) * (bm * bm).sum(-1)), 1e-12, None)
    return Series.from_numpy(num / den, args[0].name, _F64)


@register_kernel("jaccard_similarity", returns(_F64))
def _jaccard(args, **kwargs):
    a = args[0].to_pylist()
    b = args[1].to_pylist()
    if len(b) == 1 and len(a) != 1:
        b = b * len(a)

    def do(x, y):
        if x is None or y is None:
            return None
        sx, sy = set(x), set(y)
        union = len(sx | sy)
        return (len(sx & sy) / union) if union else 1.0

    return Series.from_pylist([do(x, y) for x, y in zip(a, b)], args[0].name, _F64)


# ------------------------------------------------------------------ #
# file helpers (reference: daft/functions/file_.py)                   #
# ------------------------------------------------------------------ #
@register_kernel("file_size", returns(_I64))
def _file_size(args, **kwargs):
    import os

    def do(v):
        if v is None:
            return None
        try:
            return os.path.getsize(v)
        except OSError:
            return None

    return Series.from_pylist([do(v) for v in args[0].cast(_STR).to_pylist()],
                              args[0].name, _I64)


@register_kernel("file_exists", returns(_BOOL))
def _file_exists(args, **kwargs):
    import os

    out = [None if v is None else os.path.exists(v)
           for v in args[0].cast(_STR).to_pylist()]
    return Series.from_pylist(out, args[0].name, _BOOL)


@register_kernel("guess_mime_type", returns(_STR))
def _guess_mime(args, **kwargs):
    import mimetypes

    out = [None if v is None else mimetypes.guess_type(v)[0]
           for v in args[0].cast(_STR).to_pylist()]
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("try_cast", lambda f, k: Field(f[0].name, k["dtype"]))
def _try_cast(args, dtype=None, **kwargs):
    try:
        return args[0].cast(dtype)
    except Exception:
        out = []
        for v in args[0].to_pylist():
            try:
                out.append(Series.from_pylist([v], "x").cast(dtype).scalar())
            except Exception:
                out.append(None)
        return Series.from_pylist(out, args[0].name, dtype)
