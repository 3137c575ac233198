"""String kernels over Arrow C++ utf8 compute (port of
``daft_tpu/kernels/string_ops.py``).

Reference: src/daft-functions-utf8. Strings have no device lowering in either
package, so this family runs on the host over Arrow memory. Each kernel keeps
the JAX package's engine: Arrow's RE2 (``match_substring_regex``) for
``str_match``, ``str_like`` and ``str_ilike``, Python ``re`` for
``str_extract``, ``str_extract_all`` and ``str_count_matches``. The two
engines disagree on some inputs: Python's ``$`` also matches before a
final newline, where RE2's does not, and RE2 refuses backreferences and
lookarounds. Swapping one engine for the other would change rows.
"""

from __future__ import annotations

import re

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.kernels.registry import register_kernel, returns, same_dtype
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series

_STR = DataType.string()
_BOOL = DataType.bool()


def _s(args, i=0):
    return args[i].cast(_STR)


def _wrap(out, name, dtype=None):
    return Series.from_arrow(out, name, dtype)


@register_kernel("str_contains", returns(_BOOL))
def _contains(args, **kwargs):
    return _wrap(pc.match_substring(_s(args).to_arrow(), args[1].scalar()), args[0].name, _BOOL)


@register_kernel("str_startswith", returns(_BOOL))
def _startswith(args, **kwargs):
    return _wrap(pc.starts_with(_s(args).to_arrow(), args[1].scalar()), args[0].name, _BOOL)


@register_kernel("str_endswith", returns(_BOOL))
def _endswith(args, **kwargs):
    return _wrap(pc.ends_with(_s(args).to_arrow(), args[1].scalar()), args[0].name, _BOOL)


@register_kernel("str_match", returns(_BOOL))
def _match(args, **kwargs):
    return _wrap(pc.match_substring_regex(_s(args).to_arrow(), args[1].scalar()), args[0].name, _BOOL)


@register_kernel("str_length", returns(DataType.uint64()))
def _length(args, **kwargs):
    return _wrap(pc.utf8_length(_s(args).to_arrow()).cast(pa.uint64()), args[0].name, DataType.uint64())


@register_kernel("str_length_bytes", returns(DataType.uint64()))
def _length_bytes(args, **kwargs):
    return _wrap(pc.binary_length(_s(args).to_arrow()).cast(pa.uint64()), args[0].name, DataType.uint64())


@register_kernel("str_lower", returns(_STR))
def _lower(args, **kwargs):
    return _wrap(pc.utf8_lower(_s(args).to_arrow()), args[0].name, _STR)


@register_kernel("str_upper", returns(_STR))
def _upper(args, **kwargs):
    return _wrap(pc.utf8_upper(_s(args).to_arrow()), args[0].name, _STR)


@register_kernel("str_capitalize", returns(_STR))
def _capitalize(args, **kwargs):
    return _wrap(pc.utf8_capitalize(_s(args).to_arrow()), args[0].name, _STR)


@register_kernel("str_reverse", returns(_STR))
def _reverse(args, **kwargs):
    return _wrap(pc.utf8_reverse(_s(args).to_arrow()), args[0].name, _STR)


@register_kernel("str_lstrip", returns(_STR))
def _lstrip(args, **kwargs):
    return _wrap(pc.utf8_ltrim_whitespace(_s(args).to_arrow()), args[0].name, _STR)


@register_kernel("str_rstrip", returns(_STR))
def _rstrip(args, **kwargs):
    return _wrap(pc.utf8_rtrim_whitespace(_s(args).to_arrow()), args[0].name, _STR)


@register_kernel("str_strip", returns(_STR))
def _strip(args, **kwargs):
    return _wrap(pc.utf8_trim_whitespace(_s(args).to_arrow()), args[0].name, _STR)


def _resolve_split(fields, kwargs):
    return Field(fields[0].name, DataType.list(_STR))


@register_kernel("str_split", _resolve_split)
def _split(args, regex: bool = False, **kwargs):
    pattern = args[1].scalar()
    arr = _s(args).to_arrow()
    out = pc.split_pattern_regex(arr, pattern) if regex else pc.split_pattern(arr, pattern)
    return _wrap(out, args[0].name, DataType.list(_STR))


@register_kernel("str_extract", returns(_STR))
def _extract(args, index: int = 0, **kwargs):
    pattern = args[1].scalar()
    cre = re.compile(pattern)
    out = []
    for v in _s(args).to_pylist():
        if v is None:
            out.append(None)
            continue
        m = cre.search(v)
        out.append(m.group(index) if m else None)
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("str_extract_all", lambda f, k: Field(f[0].name, DataType.list(_STR)))
def _extract_all(args, index: int = 0, **kwargs):
    pattern = args[1].scalar()
    cre = re.compile(pattern)
    out = []
    for v in _s(args).to_pylist():
        if v is None:
            out.append(None)
        else:
            out.append([m.group(index) for m in cre.finditer(v)])
    return Series.from_pylist(out, args[0].name, DataType.list(_STR))


@register_kernel("str_replace", returns(_STR))
def _replace(args, regex: bool = False, **kwargs):
    arr = _s(args).to_arrow()
    pattern = args[1].scalar()
    replacement = args[2].scalar()
    if regex:
        out = pc.replace_substring_regex(arr, pattern, replacement)
    else:
        out = pc.replace_substring(arr, pattern, replacement)
    return _wrap(out, args[0].name, _STR)


@register_kernel("str_left", returns(_STR))
def _left(args, **kwargs):
    n = int(args[1].scalar())
    return _wrap(pc.utf8_slice_codeunits(_s(args).to_arrow(), 0, n), args[0].name, _STR)


@register_kernel("str_right", returns(_STR))
def _right(args, **kwargs):
    n = int(args[1].scalar())
    arr = _s(args).to_arrow()
    lens = pc.utf8_length(arr)
    starts = pc.max_element_wise(pc.subtract(lens, n), 0)
    out = [None if v is None else v[int(s):] for v, s in zip(arr.to_pylist(), starts.to_pylist())]
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("str_find", returns(DataType.int64()))
def _find(args, **kwargs):
    sub = args[1].scalar()
    out = pc.find_substring(_s(args).to_arrow(), sub)
    return _wrap(out.cast(pa.int64()), args[0].name, DataType.int64())


@register_kernel("str_rpad", returns(_STR))
def _rpad(args, **kwargs):
    length = int(args[1].scalar())
    pad = args[2].scalar()
    out = pc.utf8_slice_codeunits(pc.ascii_rpad(_s(args).to_arrow(), length, padding=pad), 0, length)
    return _wrap(out, args[0].name, _STR)


@register_kernel("str_lpad", returns(_STR))
def _lpad(args, **kwargs):
    length = int(args[1].scalar())
    pad = args[2].scalar()
    arr = _s(args).to_arrow()
    out = []
    for v in arr.to_pylist():
        if v is None:
            out.append(None)
        elif len(v) >= length:
            out.append(v[len(v) - length:])
        else:
            padded = (pad * length) + v
            out.append(padded[-length:])
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("str_repeat", returns(_STR))
def _repeat(args, **kwargs):
    n = int(args[1].scalar())
    out = pc.binary_repeat(_s(args).to_arrow(), n)
    return _wrap(out, args[0].name, _STR)


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


@register_kernel("str_like", returns(_BOOL))
def _like(args, **kwargs):
    pattern = _like_to_regex(args[1].scalar())
    return _wrap(pc.match_substring_regex(_s(args).to_arrow(), pattern), args[0].name, _BOOL)


@register_kernel("str_ilike", returns(_BOOL))
def _ilike(args, **kwargs):
    pattern = _like_to_regex(args[1].scalar())
    return _wrap(
        pc.match_substring_regex(_s(args).to_arrow(), pattern, ignore_case=True),
        args[0].name, _BOOL,
    )


@register_kernel("str_substr", returns(_STR))
def _substr(args, length=None, **kwargs):
    starts = args[1].to_pylist()
    lengths = args[2].to_pylist() if len(args) >= 3 else None
    uniq_start = set(starts)
    uniq_len = set(lengths) if lengths is not None else {length}
    if len(uniq_start) == 1 and len(uniq_len) == 1:
        # Scalar fast path via the Arrow C++ kernel.
        start = int(starts[0] or 0)
        ln = uniq_len.pop()
        stop = None if ln is None else start + int(ln)
        return _wrap(pc.utf8_slice_codeunits(_s(args).to_arrow(), start, stop),
                     args[0].name, _STR)
    # Per-row starts/lengths.
    out = []
    vals = _s(args).to_pylist()
    n = len(vals)
    starts = starts * n if len(starts) == 1 else starts
    if lengths is None:
        lengths = [length] * n
    elif len(lengths) == 1:
        lengths = lengths * n
    for v, st, ln in zip(vals, starts, lengths):
        if v is None or st is None:
            out.append(None)
        else:
            st = max(0, int(st))
            out.append(v[st:] if ln is None else v[st:st + int(ln)])
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("str_to_date", returns(DataType.date()))
def _to_date(args, format: str = "%Y-%m-%d", **kwargs):
    out = pc.strptime(_s(args).to_arrow(), format=format, unit="s")
    return _wrap(out.cast(pa.date32()), args[0].name, DataType.date())


@register_kernel("str_to_datetime", lambda f, k: Field(f[0].name, DataType.timestamp("us", k.get("timezone"))))
def _to_datetime(args, format: str = "%Y-%m-%d %H:%M:%S", timezone=None, **kwargs):
    out = pc.strptime(_s(args).to_arrow(), format=format, unit="us")
    dtype = DataType.timestamp("us", timezone)
    if timezone:
        out = pc.assume_timezone(out, timezone)
    return _wrap(out, args[0].name, dtype)


@register_kernel("str_normalize", returns(_STR))
def _normalize(args, remove_punct=False, lowercase=False, nfd_unicode=False, white_space=False, **kwargs):
    import string as _string
    import unicodedata

    out = []
    for v in _s(args).to_pylist():
        if v is None:
            out.append(None)
            continue
        if nfd_unicode:
            v = unicodedata.normalize("NFD", v)
        if lowercase:
            v = v.lower()
        if remove_punct:
            v = v.translate(str.maketrans("", "", _string.punctuation))
        if white_space:
            v = " ".join(v.split())
        out.append(v)
    return Series.from_pylist(out, args[0].name, _STR)


@register_kernel("str_count_matches", returns(DataType.uint64()))
def _count_matches(args, patterns=None, whole_words=False, case_sensitive=True, **kwargs):
    pats = patterns if isinstance(patterns, (list, tuple)) else [patterns]
    flags = 0 if case_sensitive else re.IGNORECASE
    if whole_words:
        cre = re.compile("|".join(rf"\b{re.escape(p)}\b" for p in pats), flags)
    else:
        cre = re.compile("|".join(re.escape(p) for p in pats), flags)
    out = [None if v is None else len(cre.findall(v)) for v in _s(args).to_pylist()]
    return Series.from_pylist(out, args[0].name, DataType.uint64())


@register_kernel("concat_ws", returns(_STR))
def _concat_ws(args, **kwargs):
    sep = pa.scalar(args[0].scalar(), pa.large_string())
    arrays = [a.cast(_STR).to_arrow() for a in args[1:]]
    out = pc.binary_join_element_wise(*arrays, sep, null_handling="skip")
    return _wrap(out, args[1].name if len(args) > 1 else "literal", _STR)
