"""Hive-style partitioned reads: `k=v` path parsing, dtype inference,
partition-column materialization, and scan-task pruning (port of
``daft_tpu/io/hive.py``).

Reference: src/daft-scan/src/hive.rs (parse_hive_partitioning: URL-decoded
``key=value`` path segments, ``__HIVE_DEFAULT_PARTITION__`` nulls, dtype
inference over int64/float64/date/string) and the read-side pruning of
partition predicates before tasks are built. The writers produce this layout
(io/writers.py).
"""

from __future__ import annotations

import datetime
import os
import re
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.schema import Field, Schema

HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"

# Strict numeric shapes for partition values. Python's int()/float() accept
# underscore separators ("2024_01" -> 202401): a value like month=2024_01
# must stay a STRING. The nan/inf spellings stay valid floats (Rust
# str::parse in the reference's hive.rs; the writer emits 'nan' for NaN
# partitions via str()). \Z (not $) so a %0A-decoded trailing newline does
# not slip through.
_INT_RE = re.compile(r"[+-]?[0-9]+\Z")
_FLOAT_RE = re.compile(
    r"[+-]?(([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?|nan|inf|infinity)\Z",
    re.IGNORECASE)


def parse_hive_path(path: str, root: Optional[str] = None) -> Dict[str, str]:
    """Extract ``k=v`` partition segments from a file path, in order.

    Only DIRECTORY segments BELOW ``root`` count (segments above the dataset
    root are never partitions, and the filename is skipped); keys/values are
    URL-decoded (the writer percent-escapes separators, io/writers.py
    _hive_escape). Reference: hive.rs parse_hive_partitioning parses below
    the glob root.
    """
    norm = _strip_scheme(path.replace("\\", "/"))
    if root:
        r = _strip_scheme(root.replace("\\", "/")).rstrip("/")
        if norm.startswith(r + "/"):
            norm = norm[len(r) + 1:]
    parts: Dict[str, str] = {}
    for seg in norm.split("/")[:-1]:
        if "=" not in seg:
            continue
        k, v = seg.split("=", 1)
        if not k:
            continue
        parts[urllib.parse.unquote(k)] = urllib.parse.unquote(v)
    return parts


def dataset_roots(paths: Sequence[str]) -> List[str]:
    """The dataset root of each user-supplied read path: the directory prefix
    up to the first glob metacharacter (the whole path for a plain
    directory), normalized the way glob_paths normalizes file paths so
    prefix-matching against FileInfo.path works."""
    roots = []
    for p in paths:
        cut = len(p)
        for ch in "*?[":
            i = p.find(ch)
            if i != -1:
                cut = min(cut, i)
        root = p[:cut]
        if cut < len(p):
            root = root.rpartition("/")[0]
        if "://" not in p:
            root = os.path.abspath(os.path.expanduser(root)) if root else root
        roots.append(root.rstrip("/"))
    return roots


def _strip_scheme(s: str) -> str:
    return s.split("://", 1)[1] if "://" in s else s


def _root_for(path: str, roots: Sequence[str]) -> Optional[str]:
    """Longest dataset root that is a directory-prefix of ``path``. Schemes
    are stripped on both sides."""
    norm = _strip_scheme(path.replace("\\", "/"))
    best = None
    for r in roots:
        rn = _strip_scheme(r.replace("\\", "/")).rstrip("/")
        if norm == rn or norm.startswith(rn + "/"):
            if best is None or len(rn) > len(best):
                best = rn
    return best


def _infer_one(values: Sequence[Optional[str]]) -> DataType:
    """Narrowest dtype that parses every non-null partition value
    (int64 -> float64 -> date -> bool -> string), matching hive.rs's
    inference ladder."""
    non_null = [v for v in values if v is not None]
    if not non_null:
        return DataType.string()

    def all_parse(fn) -> bool:
        try:
            for v in non_null:
                fn(v)
            return True
        except (ValueError, TypeError):
            return False

    if all(_INT_RE.match(v) for v in non_null):
        return DataType.int64()
    if all(_FLOAT_RE.match(v) for v in non_null):
        return DataType.float64()
    if all_parse(datetime.date.fromisoformat):
        return DataType.date()
    if all(v.lower() in ("true", "false") for v in non_null):
        return DataType.bool()
    return DataType.string()


def _coerce(value: Optional[str], dtype: DataType) -> Any:
    """Path string -> python value of ``dtype`` (covers user-declared dtypes
    beyond the inference ladder: any integer/float width, bool, date)."""
    if value is None:
        return None
    if dtype == DataType.date():
        return datetime.date.fromisoformat(value)
    if dtype == DataType.bool():
        return value.lower() == "true"
    try:
        kind = dtype.to_numpy().kind
    except Exception:
        kind = "U"
    if kind in "iu":
        if not _INT_RE.match(value):
            raise DaftValueError(
                f"Hive partition value {value!r} is not a valid integer for "
                f"declared dtype {dtype!r} (strict pattern; underscores and "
                f"whitespace are not digits)")
        return int(value)
    if kind == "f":
        if not _FLOAT_RE.match(value):
            raise DaftValueError(
                f"Hive partition value {value!r} is not a valid float for "
                f"declared dtype {dtype!r} (strict pattern; underscores "
                f"and whitespace are rejected)")
        return float(value)
    if kind == "M":
        return datetime.datetime.fromisoformat(value)
    if kind in "USO" or dtype == DataType.string():
        return value
    raise DaftValueError(
        f"Unsupported declared partition dtype {dtype!r} for hive value "
        f"{value!r} (supported: integer/float/bool/date/timestamp/string)")


def attach_hive_partitions(files, roots: Sequence[str] = (),
                           declared: Optional[Dict[str, DataType]] = None) -> List[Field]:
    """Parse each file's hive segments (below its dataset root), set
    ``FileInfo.partition_values`` to TYPED values, and return the
    partition-column fields (in first-seen path order). All files must agree
    on the partition key set. A user-declared schema dtype for a partition
    column overrides inference (reference: hive.rs coerces to the table
    schema)."""
    raw: List[Dict[str, str]] = []
    keys: List[str] = []
    for f in files:
        parts = parse_hive_path(f.path, _root_for(f.path, roots))
        raw.append(parts)
        for k in parts:
            if k not in keys:
                keys.append(k)
    if not keys:
        return []
    for f, parts in zip(files, raw):
        missing = [k for k in keys if k not in parts]
        if missing:
            raise DaftValueError(
                f"Inconsistent hive partitioning: {f.path!r} lacks partition "
                f"key(s) {missing} present in sibling files")
    fields = []
    for k in keys:
        vals = [None if parts[k] == HIVE_NULL else parts[k] for parts in raw]
        dtype = (declared or {}).get(k) or _infer_one(vals)
        fields.append(Field(k, dtype))
        for f, v in zip(files, vals):
            pv = dict(f.partition_values or {})
            pv[k] = _coerce(v, dtype)
            f.partition_values = pv
    return fields


def _split_conjuncts(expr) -> List:
    from daft_tpu_torch.expressions.expr import Alias, BinaryOp

    while isinstance(expr, Alias):
        expr = expr.child
    if isinstance(expr, BinaryOp) and expr.op == "and":
        return _split_conjuncts(expr.left) + _split_conjuncts(expr.right)
    return [expr]


def prune_files_by_partition(files, filters, schema: Schema):
    """Drop files whose partition values make a partition-only conjunct of
    the pushdown filter non-true (False OR null, per SQL WHERE semantics).
    Reference: hive.rs partition pruning + daft-scan pushdown application.
    """
    if filters is None:
        return files
    part_files = [f for f in files if f.partition_values]
    if not part_files:
        return files
    # Keys present in EVERY file's metadata are prunable.
    common = set(part_files[0].partition_values)
    for f in part_files[1:]:
        common &= set(f.partition_values)
    if len(part_files) != len(files):
        return files  # mixed metadata: pruning would drop rows from bare files
    conjuncts = [c for c in _split_conjuncts(filters)
                 if c.column_refs() and c.column_refs() <= common]
    if not conjuncts:
        return files
    from daft_tpu_torch.expressions.evaluator import evaluate
    from daft_tpu_torch.recordbatch import RecordBatch
    from daft_tpu_torch.series import Series

    part_fields = [f for f in schema if f.name in common]
    kept = []
    for f in files:
        cols = [Series.from_pylist([f.partition_values[pf.name]], pf.name, pf.dtype)
                for pf in part_fields]
        rb = RecordBatch(Schema(part_fields), cols, 1)
        keep = True
        for c in conjuncts:
            try:
                v = evaluate(c, rb).to_pylist()[0]
            except Exception:
                continue  # unevaluable conjunct: never prune on it
            if v is not True:
                keep = False
                break
        if keep:
            kept.append(f)
    return kept
