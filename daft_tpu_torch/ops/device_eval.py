"""Fused device evaluation of projection expressions (port of
``daft_tpu/ops/device_eval.py``).

The numeric subgraph of a projection runs on ``cfg.device`` as one program per
morsel: a closure over torch ops, built once per expression set and dtype
signature and cached (the JAX package jits the same tree into one XLA
computation). Eager torch launches one kernel per op; fusing the chain is left
to a later change.

Inputs pad to a small set of bucket sizes (``cfg.device_batch_buckets``) as in
the JAX package, so a program sees O(#buckets) shapes. On CUDA the columns are
staged through pinned host buffers (one set per morsel in flight, one buffer
per column and dtype in a set), copied ``non_blocking``, and every output of
a morsel comes back in one device→host fetch (one synchronisation). A pool
worker issues all of this on its own stream (``device.worker_stream``), so
the synchronisation waits for its own morsel only; the cached programs hold
no device tensors, so any thread's stream may run them.

Null semantics: nullable inputs stage zero-filled with host-side validity
masks; each fused output's validity is the AND-reduce of its referenced
inputs' validities, which is exact against the host for arithmetic /
comparison / cast chains. Expressions whose null propagation differs from
that law — Kleene and/or, IfElse, registry kernels with their own null rules —
take the host path when any referenced input is nullable.

Unlike the JAX package, a device error is not caught here: the only host
routes are those the plan, the dtypes or the data decide, each one counted in
``device_eval_counters``.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from daft_tpu_torch import metrics, profiling
from daft_tpu_torch.datatype import DataType, TypeId
from daft_tpu_torch.device import resolve_device
from daft_tpu_torch.errors import DaftError
from daft_tpu_torch.expressions.expr import (
    Alias,
    BinaryOp,
    Cast,
    ColumnRef,
    Expr,
    FunctionCall,
    IfElse,
    Literal,
    UnaryOp,
)
from daft_tpu_torch.series import Series

_FUSABLE_BINARY = {
    "add", "sub", "mul", "truediv", "floordiv", "mod", "pow",
    "eq", "ne", "lt", "le", "gt", "ge", "and", "or", "xor",
}
_FUSABLE_UNARY = {"not", "negate", "abs"}


class DeviceEvalCounters:
    """Where the relational layer's rows went. ``fused_exprs`` / ``fused_rows`` count expressions and
    expression-rows that ran on the device; ``host_exprs`` / ``host_rows``
    the same for each reason a route stayed on the host (a projection's
    expression: the bare reason; a filter/project chain: ``chain_<reason>``;
    a global aggregation's chunk: ``agg_<reason>``); ``chain_morsels`` /
    ``chain_rows`` the morsels and rows each compiled-chain kind ran;
    ``program_hits`` / ``program_misses`` the program cache.

    Beside these tallies the metrics registry gets the JAX package's series at
    the JAX package's sites: ``daft_device_fused_exprs_total`` /
    ``daft_device_fused_rows_total`` (:meth:`record_fused`),
    ``daft_device_fallback_exprs_total{reason}`` (:meth:`record_fallback`,
    where the JAX package records a fallback: the chains' ``below_min_rows``
    is not one), ``daft_compiled_chain_morsels_total`` / ``_rows_total``
    (:meth:`record_chain`) and ``daft_stage_fusions_total``; the profiler
    gets the device-against-host split of the ambient operator
    (``profiling.note_device``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.fused_exprs = 0
            self.fused_rows = 0
            self.host_exprs: Dict[str, int] = {}
            self.host_rows: Dict[str, int] = {}
            self.chain_morsels: Dict[str, int] = {}
            self.chain_rows: Dict[str, int] = {}
            self.program_hits = 0
            self.program_misses = 0
            self.stage_fusions = 0

    def record_fused(self, nexprs: int, rows: int) -> None:
        with self._lock:
            self.fused_exprs += nexprs
            self.fused_rows += rows * nexprs
        metrics.DEVICE_FUSED_EXPRS.inc(nexprs)
        metrics.DEVICE_FUSED_ROWS.inc(rows * nexprs)
        profiling.note_device(rows * nexprs, fused=True)

    @staticmethod
    def record_fallback(reason: str, nexprs: int = 1, rows: int = 0) -> None:
        """The registry's and the profiler's side of a host route, at the
        JAX package's ``record_fallback`` sites. The profiler counts
        expression-rows on both sides, as :meth:`record_fused` does."""
        metrics.DEVICE_FALLBACKS.labels(reason).inc(nexprs)
        profiling.note_device(rows * nexprs, fused=False)

    def record_host(self, reason: str, nexprs: int = 1, rows: int = 0) -> None:
        with self._lock:
            self.host_exprs[reason] = self.host_exprs.get(reason, 0) + nexprs
            self.host_rows[reason] = self.host_rows.get(reason, 0) + rows * nexprs

    def record_chain(self, kind: str, rows: int) -> None:
        with self._lock:
            self.chain_morsels[kind] = self.chain_morsels.get(kind, 0) + 1
            self.chain_rows[kind] = self.chain_rows.get(kind, 0) + rows
        metrics.COMPILED_CHAIN_MORSELS.labels(kind).inc()
        metrics.COMPILED_CHAIN_ROWS.labels(kind).inc(rows)

    def record_program(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.program_hits += 1
            else:
                self.program_misses += 1

    def record_stage_fusions(self, n: int) -> None:
        with self._lock:
            self.stage_fusions += n
        metrics.STAGE_FUSIONS.inc(n)

    def snapshot(self) -> dict:
        with self._lock:
            return {"fused_exprs": self.fused_exprs, "fused_rows": self.fused_rows,
                    "host_exprs": dict(self.host_exprs), "host_rows": dict(self.host_rows),
                    "chain_morsels": dict(self.chain_morsels),
                    "chain_rows": dict(self.chain_rows),
                    "program_hits": self.program_hits, "program_misses": self.program_misses,
                    "stage_fusions": self.stage_fusions}


device_eval_counters = DeviceEvalCounters()


class PhaseTimer:
    """Split of the device programs' time, on when ``enabled``: ``stage_s``
    is host time spent filling the staging buffers; ``h2d_ms``, ``device_ms``
    and ``d2h_ms`` are stream time (CUDA events) of the host→device copies,
    the program's work and the device→host fetch, summed over morsels (and so
    over the pool's workers, whose streams overlap). Each thread keeps its
    own morsel's events; the totals are summed under a lock."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.totals = {"stage_s": 0.0, "h2d_ms": 0.0, "device_ms": 0.0, "d2h_ms": 0.0}
        self._local.events = []

    def _events(self) -> list:
        ev = getattr(self._local, "events", None)
        if ev is None:
            ev = self._local.events = []
        return ev

    def host(self, seconds: float) -> None:
        if self.enabled:
            with self._lock:
                self.totals["stage_s"] += seconds

    def mark(self, device: torch.device) -> None:
        """An event on the calling thread's current stream at a phase
        boundary: before the copies in, before the program, before the
        fetch, after the fetch (recorded before its synchronisation)."""
        if self.enabled and device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            self._events().append(ev)

    def settle(self) -> None:
        """After the fetch's synchronisation, which completed the morsel's
        four events: fold the calling thread's morsel events in."""
        ev, self._local.events = self._events(), []
        if len(ev) == 4:
            spans = [(key, a.elapsed_time(b)) for key, a, b in
                     (("h2d_ms", ev[0], ev[1]), ("device_ms", ev[1], ev[2]),
                      ("d2h_ms", ev[2], ev[3]))]
            with self._lock:
                for key, ms in spans:
                    self.totals[key] += ms


phase_timer = PhaseTimer()

# Device-side dtypes are capped at 32 bits, as in the JAX package (which had no
# native f64/i64 on the TPU): 64-bit expressions stay on the host, so routing
# equals the JAX package's. The H100 computes in 64 bits; lifting the cap is a
# later change.
_MAX_ITEMSIZE = 4


def _dtype_ok(dt: DataType) -> bool:
    if not dt.is_device_representable():
        return False
    if dt.id == TypeId.BFLOAT16 or dt.is_boolean():
        return True
    try:
        base = dt.inner if (dt.shape != () and dt.is_logical()) or \
            dt.id == TypeId.FIXED_SIZE_LIST else dt
        np_dt = base.to_numpy()
    except (DaftError, TypeError, ValueError, KeyError, NotImplementedError):
        return False  # dtype has no numpy image: not device-representable
    return np_dt.itemsize <= _MAX_ITEMSIZE


def _root_same_rules_kernel(expr: Expr) -> bool:
    """True when the expression root (through aliases) is a registry kernel
    whose host impl runs its torch function (``torch_same_rules``)."""
    while isinstance(expr, Alias):
        expr = expr.child
    if not isinstance(expr, FunctionCall):
        return False
    from daft_tpu_torch.kernels.registry import get_kernel, has_kernel

    if not has_kernel(expr.fn_name):
        return False
    k = get_kernel(expr.fn_name)
    return k.torch_fn is not None and k.torch_same_rules


def _out_dtype_ok(expr: Expr, dtype: DataType) -> bool:
    """A 64-bit OUTPUT is allowed when the root kernel has the same rules on
    both paths: its host impl computes 32-bit and upcasts (the embedding
    distances resolve to f64 but compute in f32), which the device path
    mirrors by casting after the fetch."""
    if _dtype_ok(dtype):
        return True
    if not dtype.is_device_representable():
        return False
    return _root_same_rules_kernel(expr)


def _unfusable_reason(expr: Expr, schema) -> Optional[str]:
    """None when ``expr`` can run on the device, else the host route's reason:
    ``dtype_64bit`` where only the 32-bit cap keeps it off the device,
    ``not_fusable`` for anything else (an unresolvable expression, a node or
    dtype the device path has no lowering for, no column at all)."""
    try:
        out_field = expr.to_field(schema)
    except (DaftError, TypeError, KeyError, NotImplementedError):
        return "not_fusable"
    wide = False
    if not _out_dtype_ok(expr, out_field.dtype):
        if not out_field.dtype.is_device_representable():
            return "not_fusable"
        wide = True
    if not expr.column_refs():
        return "not_fusable"
    for node in expr.walk():
        if isinstance(node, ColumnRef):
            f = schema.get(node.name_)
            if f is None or not f.dtype.is_device_representable():
                return "not_fusable"
            wide = wide or not _dtype_ok(f.dtype)
        elif isinstance(node, Literal):
            if not (node.dtype.is_numeric() or node.dtype.is_boolean()):
                return "not_fusable"
        elif isinstance(node, (Alias, IfElse)):
            continue
        elif isinstance(node, Cast):
            if not node.dtype.is_device_representable():
                return "not_fusable"
            wide = wide or not _dtype_ok(node.dtype)
        elif isinstance(node, BinaryOp):
            if node.op not in _FUSABLE_BINARY or not _literal_fits(node, schema):
                return "not_fusable"
        elif isinstance(node, UnaryOp):
            if node.op not in _FUSABLE_UNARY:
                return "not_fusable"
        elif isinstance(node, FunctionCall):
            from daft_tpu_torch.kernels.registry import get_kernel, has_kernel

            if not has_kernel(node.fn_name) or get_kernel(node.fn_name).torch_fn is None:
                return "not_fusable"
        else:
            return "not_fusable"
    return "dtype_64bit" if wide else None


def _literal_fits(node: BinaryOp, schema) -> bool:
    """False when a Python int literal beyond int32 meets an integer operand:
    jnp (64-bit types off) raises while tracing it and the JAX package takes
    the host, where torch would wrap it without a word (``int32 <
    3_000_000_000`` would be False). A literal within int32 but beyond the
    operand's own range wraps into its dtype on both paths."""
    for lit, other in ((node.left, node.right), (node.right, node.left)):
        if not isinstance(lit, Literal):
            continue
        v = _lit_value(lit.value)
        if isinstance(v, int) and not isinstance(v, bool) and not -(1 << 31) <= v < (1 << 31):
            if other.to_field(schema).dtype.is_integer():
                return False
    return True


def _is_fusable(expr: Expr, schema) -> bool:
    return _unfusable_reason(expr, schema) is None


def _nullable_safe(expr: Expr) -> bool:
    """True when the expression's null propagation is exactly the AND-reduce
    of its input validities (output null iff ANY referenced input null)."""
    from daft_tpu_torch.kernels.registry import get_kernel, has_kernel

    for node in expr.walk():
        if isinstance(node, IfElse):
            return False
        if isinstance(node, FunctionCall):
            # Registry kernels define their own null rules, except those with
            # the same rules on both paths (any input null -> output null).
            if not (has_kernel(node.fn_name) and get_kernel(node.fn_name).torch_same_rules):
                return False
        if isinstance(node, BinaryOp) and node.op in ("and", "or", "xor"):
            return False  # Kleene logic: true OR null = true, not null
    return True


# --------------------------------------------------------------------- #
# The expression tree on tensors                                        #
# --------------------------------------------------------------------- #
class _Wide:
    """A uint16 / uint32 lane held in a wider signed tensor (int32 / int64),
    since torch's kernels lack those unsigned types: values stay in
    [0, 2**bits) and every result of unsigned arithmetic is wrapped, which is
    what XLA's native unsigned arithmetic gives."""

    __slots__ = ("t", "bits")

    def __init__(self, t: torch.Tensor, bits: int):
        self.t = t
        self.bits = bits


def _wrap_unsigned(t: torch.Tensor, bits: int) -> _Wide:
    t = t.to(torch.int64) & ((1 << bits) - 1)
    return _Wide(t.to(torch.int32) if bits == 16 else t, bits)


def _kind(x):
    """The JAX dtype class of an operand (64-bit off): ('u', bits),
    ('i', bits), ('f', dtype), ('b',) for bool, ('wi',) / ('wf',) for a
    weakly typed Python int / float."""
    if isinstance(x, _Wide):
        return ("u", x.bits)
    if isinstance(x, bool):
        return ("b",)
    if isinstance(x, int):
        return ("wi",)
    if isinstance(x, float):
        return ("wf",)
    if x.dtype == torch.bool:
        return ("b",)
    if x.dtype.is_floating_point:
        return ("f", x.dtype)
    if x.dtype == torch.uint8:
        return ("u", 8)
    return ("i", torch.iinfo(x.dtype).bits)


def _promote_wide(*xs):
    """Result class of an op over operands one of which is a uint16/uint32
    lane, by JAX's promotion with 64-bit types off: floats win; unsigned with
    unsigned, bool or a Python int stays unsigned (the wider); unsigned with
    a signed type becomes int32 (int64 in JAX's lattice, canonicalised to
    int32)."""
    kinds = [_kind(x) for x in xs]
    floats = [k[1] for k in kinds if k[0] == "f"]
    if floats:
        return ("f", functools.reduce(torch.promote_types, floats))
    if any(k[0] == "wf" for k in kinds):
        return ("f", torch.float32)
    if any(k[0] == "i" for k in kinds):
        return ("i", 32)
    return ("u", max(k[1] for k in kinds if k[0] == "u"))


def _as_kind(x, kind):
    """Operand ``x`` in the representation of result class ``kind``."""
    raw = x.t if isinstance(x, _Wide) else x
    if not isinstance(raw, torch.Tensor):
        return raw & ((1 << kind[1]) - 1) if kind[0] == "u" and isinstance(raw, int) else raw
    if kind[0] == "f":
        return raw.to(kind[1])
    if kind[0] == "i":
        return raw.to(torch.int64).to(torch.int32)
    return raw.to(torch.int64)


def _lit_value(v):
    # A numpy scalar becomes a Python scalar: Python scalars are weakly typed
    # in torch as in jnp, so an f32 column compared with 0.05 compares in f32.
    return v.item() if isinstance(v, np.generic) else v


def _tensors(a, b):
    """``a`` and ``b`` as tensors on the device of the one that is a tensor
    (a Python scalar becomes a 0-d tensor, which torch promotes weakly)."""
    dev = (a if isinstance(a, torch.Tensor) else b).device
    return torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)


def _int_floordiv(a, b, unsigned_max: Optional[int]):
    """Integer ``a // b`` as JAX's floor_divide over XLA's division gives it:
    x // 0 is -2 (x != 0) or -1 (x == 0) for signed types and the type's
    largest value for unsigned ones; MIN // -1 is MIN. torch's integer
    division by zero raises on the CPU and is undefined on CUDA."""
    a, b = _tensors(a, b)
    if unsigned_max is not None:
        q = a // torch.where(b == 0, 1, b)
        return torch.where(b == 0, torch.full_like(q, unsigned_max), q)
    q = a // torch.where((b == 0) | (b == -1), 1, b)
    q = torch.where(b == -1, -a, q)
    return torch.where(b == 0, torch.where(a == 0, -1, -2).to(q.dtype), q)


def _int_mod(a, b, unsigned: bool):
    """Integer ``a % b`` as jnp.remainder gives it: a divisor of 0 counts as
    1 (x % 0 is 0). A signed divisor of -1 is taken as 1 too: same result,
    and no trap on MIN % -1."""
    a, b = _tensors(a, b)
    bad = (b == 0) if unsigned else (b == 0) | (b == -1)
    return a % torch.where(bad, 1, b)


def _is_int(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not x.dtype.is_floating_point and x.dtype != torch.bool
    return isinstance(x, int) and not isinstance(x, bool)


def _arith(op: str, a, b, unsigned_max: Optional[int] = None):
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "pow":
        return a ** b
    if _is_int(a) and _is_int(b):
        if op == "floordiv":
            return _int_floordiv(a, b, unsigned_max)
        return _int_mod(a, b, unsigned_max is not None)
    a, b = _tensors(a, b)
    return _float_mod(a, b) if op == "mod" else _float_floordiv(a, b)


def _float_mod(a, b):
    """Float ``a % b`` as jnp.remainder computes it: fmod, then add ``b``
    where the remainder is nonzero and its sign differs from ``b``'s."""
    mod = torch.fmod(a, b)
    plus = ((mod < 0) != (b < 0)) & (mod != 0)
    return torch.where(plus, mod + b, mod)


def _float_floordiv(a, b):
    """Float ``a // b`` as jnp.floor_divide computes it: CPython's divmod,
    each step rounded in the operands' dtype (one rounding of ``a // b``
    differs in bf16: -17.875 // -0.142578125 is 126 there, not 125), then
    rounded half away from zero. x // 0.0 is NaN (through fmod), where
    torch gives inf."""
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    fix = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    div = torch.where(fix, div - 1, div)
    t = torch.trunc(div)
    # div - t is exact, and t + sign(div) only happens below 2**mantissa.
    return torch.where((div - t).abs() >= 0.5, t + torch.sign(div), t)


_COMPARE = {
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b, "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b, "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "and": lambda a, b: a & b, "or": lambda a, b: a | b, "xor": lambda a, b: a ^ b,
}


def _binary(op: str, a, b):
    if op == "truediv":
        # Integers divide in f32, as the JAX package casts them.
        def f32(x):
            x = x.t if isinstance(x, _Wide) else x
            return x if not isinstance(x, torch.Tensor) or x.dtype.is_floating_point \
                else x.to(torch.float32)
        return f32(a) / f32(b)
    if isinstance(a, _Wide) or isinstance(b, _Wide):
        kind = _promote_wide(a, b)
        x, y = _as_kind(a, kind), _as_kind(b, kind)
        if op in _COMPARE:
            out = _COMPARE[op](x, y)
            return _Wide(out, kind[1]) if kind[0] == "u" and out.dtype != torch.bool else out
        if kind[0] == "u":
            return _wrap_unsigned(_arith(op, x, y, (1 << kind[1]) - 1), kind[1])
        out = _arith(op, x, y)
        return out.to(torch.int32) if kind[0] == "i" else out
    if op in _COMPARE:
        return _COMPARE[op](a, b)
    return _arith(op, a, b, 255 if torch.result_type(a, b) == torch.uint8 else None)


_TORCH_DTYPES = {
    TypeId.BOOL: torch.bool, TypeId.INT8: torch.int8, TypeId.INT16: torch.int16,
    TypeId.INT32: torch.int32, TypeId.UINT8: torch.uint8,
    TypeId.BFLOAT16: torch.bfloat16, TypeId.FLOAT32: torch.float32,
}
_WIDE_BITS = {TypeId.UINT16: 16, TypeId.UINT32: 32}


def _cast(v, dtype: DataType):
    base = dtype.inner if dtype.shape != () else dtype
    raw = v.t if isinstance(v, _Wide) else v
    bits = _WIDE_BITS.get(base.id)
    target = torch.int64 if bits else _TORCH_DTYPES[base.id]
    if raw.dtype.is_floating_point and target != torch.bool and not target.is_floating_point:
        # XLA's float -> integer convert saturates and maps NaN to 0; torch's
        # is undefined out of range.
        lo, hi = (0, (1 << bits) - 1) if bits else \
            (torch.iinfo(target).min, torch.iinfo(target).max)
        out = torch.nan_to_num(raw.float(), nan=0.0).clamp(lo, hi).to(torch.int64).clamp(lo, hi)
        return _Wide(out, bits) if bits else out.to(target)
    if bits:
        return _wrap_unsigned(raw, bits)
    if isinstance(v, _Wide) and target != torch.bool and not target.is_floating_point:
        raw = raw.to(torch.int64)  # narrowing from the wide lane wraps, as XLA's convert does
    return raw.to(target)


def _unary(op: str, v):
    if isinstance(v, _Wide):
        if op == "abs":
            return v
        return _wrap_unsigned(-v.t if op == "negate" else ~v.t, v.bits)
    if op == "not":
        return ~v
    if op == "negate":
        return -v
    return torch.abs(v)


def _if_else(p, t, f):
    if isinstance(t, _Wide) or isinstance(f, _Wide):
        kind = _promote_wide(t, f)
        out = torch.where(p, _as_kind(t, kind), _as_kind(f, kind))
        return _Wide(out.to(torch.int32) if kind == ("u", 16) else out, kind[1]) \
            if kind[0] == "u" else out
    return torch.where(p, t, f)


def _eval_tree(expr: Expr, cols: Dict[str, object]):
    """``expr`` over the staged columns: a tensor, a ``_Wide`` lane, or a
    Python scalar for a literal-only subtree."""
    if isinstance(expr, ColumnRef):
        return cols[expr.name_]
    if isinstance(expr, Literal):
        return _lit_value(expr.value)
    if isinstance(expr, Alias):
        return _eval_tree(expr.child, cols)
    if isinstance(expr, Cast):
        return _cast(_eval_tree(expr.child, cols), expr.dtype)
    if isinstance(expr, UnaryOp):
        return _unary(expr.op, _eval_tree(expr.child, cols))
    if isinstance(expr, IfElse):
        return _if_else(_eval_tree(expr.pred, cols), _eval_tree(expr.if_true, cols),
                        _eval_tree(expr.if_false, cols))
    if isinstance(expr, BinaryOp):
        return _binary(expr.op, _eval_tree(expr.left, cols), _eval_tree(expr.right, cols))
    if isinstance(expr, FunctionCall):
        from daft_tpu_torch.kernels.registry import get_kernel

        fn = get_kernel(expr.fn_name).torch_fn
        vals = [_eval_tree(a, cols) for a in expr.args]
        if not any(isinstance(a, _Wide) for a in vals):
            return fn(vals, **expr.kwargs)
        kind = _promote_wide(*vals)
        if kind[0] == "f":
            return fn([a.t if isinstance(a, _Wide) else a for a in vals], **expr.kwargs)
        # Integer operands meet in their promoted class, as jnp's promotion
        # has them meet: int32 when a signed operand is among them (a uint32
        # lane wraps), else the widest unsigned lane, whose integer result
        # wraps as XLA's native unsigned arithmetic does (-x, ~x, a | b).
        out = fn([_as_kind(a, kind) for a in vals], **expr.kwargs)
        return _wrap_unsigned(out, kind[1]) if kind[0] == "u" and _is_int(out) else out
    raise AssertionError(f"unfusable node slipped through: {type(expr).__name__}")


# --------------------------------------------------------------------- #
# Programs, buckets, staging and the fetch                              #
# --------------------------------------------------------------------- #
_PROGRAMS: Dict[tuple, Callable] = {}
_PROGRAMS_LOCK = threading.Lock()


def cached_program(key: tuple, build: Callable[[], Callable],
                   chain: bool = False) -> Callable:
    """The program for ``key``, built on first sight; counted as a hit or a
    miss in ``device_eval_counters``. A compiled chain's program (``chain``)
    also counts in the registry's ``daft_compile_cache_*`` series and its
    build time in ``daft_compile_seconds``, as the JAX package counts its
    chain executables (not its projections' programs)."""
    t0 = time.perf_counter()
    with _PROGRAMS_LOCK:
        fn = _PROGRAMS.get(key)
        hit = fn is not None
        if not hit:
            fn = _PROGRAMS[key] = build()
    device_eval_counters.record_program(hit)
    if chain:
        if hit:
            metrics.COMPILE_CACHE_HITS.inc()
        else:
            metrics.COMPILE_CACHE_MISSES.inc()
            metrics.COMPILE_SECONDS.observe(time.perf_counter() - t0)
    return fn


def reset_programs() -> None:
    """Drop the cached programs, the padded lengths seen and every pinned
    staging buffer."""
    with _PROGRAMS_LOCK:
        _PROGRAMS.clear()
        _SHAPES_SEEN.clear()
    _PINNED.clear()


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    # Beyond the largest bucket: round up to the next multiple of it.
    top = buckets[-1] if buckets else 1
    return ((n + top - 1) // top) * top


#: Padded lengths already used per program key: a morsel's tail pads into an
#: already-used larger shape rather than open a new one (the JAX package's
#: compile-saving rule, kept so both see the same shapes).
_SHAPES_SEEN: Dict[tuple, set] = {}

#: Never pad beyond this multiple of the real row count.
_PAD_REUSE_FACTOR = 8


def _bucket_reusing(n: int, buckets: Sequence[int], key: tuple) -> int:
    natural = _bucket(n, buckets)
    with _PROGRAMS_LOCK:
        seen = _SHAPES_SEEN.setdefault(key, set())
        if natural in seen:
            return natural
        candidates = [b for b in seen if n <= b <= _PAD_REUSE_FACTOR * max(n, 1)]
        if candidates:
            return min(candidates)
        seen.add(natural)
        return natural


def dtype_sig(cols_np: Dict[str, np.ndarray]) -> tuple:
    return tuple(sorted((k, str(v.dtype), v.shape[1:]) for k, v in cols_np.items()))


def _staging_dtype(dt: np.dtype) -> np.dtype:
    """The numpy dtype a column is staged as: uint16 / uint32 widen to
    int32 / int64 (``_Wide``), bf16 travels as its int16 bits."""
    if dt == np.uint16:
        return np.dtype(np.int32)
    if dt == np.uint32:
        return np.dtype(np.int64)
    if dt.name == "bfloat16":
        return np.dtype(np.int16)
    return dt


def _as_device_value(t: torch.Tensor, dt: np.dtype):
    if dt == np.uint16:
        return _Wide(t, 16)
    if dt == np.uint32:
        return _Wide(t, 32)
    if dt.name == "bfloat16":
        return t.view(torch.bfloat16)
    return t


class _Pinned:
    """Pinned host staging buffers, in sets: one set per morsel in flight.
    A thread's first ``get`` for a morsel takes a free set (or makes one),
    and its ``release``, called by ``fetch`` after the synchronisation that
    ordered the set's copies, gives it back. So a buffer is filled again
    only after the copy that last read it is done, and two workers' morsels
    never share one. A set holds one buffer per (slot, dtype), grown to the
    largest morsel the set has staged; a morsel's columns are views of their
    front. The bytes held are at most the morsels ever in flight at once
    (the pool's workers) times the largest morsel, and ``clear`` drops them
    all."""

    def __init__(self, pin_memory: bool = True) -> None:
        self._pin = pin_memory
        self._lock = threading.Lock()
        self._sets: List[Dict[tuple, torch.Tensor]] = []  # every set, held or free
        self._free: List[Dict[tuple, torch.Tensor]] = []
        self._local = threading.local()

    def _held(self) -> Optional[Dict[tuple, torch.Tensor]]:
        bufs = getattr(self._local, "bufs", None)
        # A set dropped by ``clear`` while this thread held it is not reused.
        return bufs if bufs is not None and any(b is bufs for b in self._sets) else None

    def holding(self) -> bool:
        """True when the calling thread holds a set its fetch never gave
        back (its last morsel failed between the copies and the fetch)."""
        with self._lock:
            return self._held() is not None

    def get(self, slot: str, shape: tuple, dtype: np.dtype) -> torch.Tensor:
        n = int(np.prod(shape))
        key = (slot, dtype.str)
        with self._lock:
            bufs = self._held()
            if bufs is None:
                if self._free:
                    bufs = self._free.pop()
                else:
                    bufs = {}
                    self._sets.append(bufs)
                self._local.bufs = bufs
            buf = bufs.get(key)
            if buf is None or buf.numel() < n:
                tdt = torch.from_numpy(np.empty(0, dtype)).dtype
                buf = bufs[key] = torch.empty(n, dtype=tdt, pin_memory=self._pin)
        return buf[:n].view(shape)

    def release(self) -> None:
        """Give the calling thread's set back (after its copies are done)."""
        with self._lock:
            bufs = self._held()
            self._local.bufs = None
            if bufs is not None:
                self._free.append(bufs)

    def held_bytes(self) -> int:
        with self._lock:
            return sum(b.numel() * b.element_size() for bufs in self._sets
                       for b in bufs.values())

    def clear(self) -> None:
        with self._lock:
            self._sets.clear()
            self._free.clear()


_PINNED = _Pinned()


def pinned_bytes() -> int:
    """Bytes of pinned staging memory the device path holds."""
    return _PINNED.held_bytes()


def stage(cols_np: Dict[str, np.ndarray], padded: int, n: int, device: torch.device,
          fill: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """Host columns (``n`` rows each) as device values of ``padded`` rows,
    zero-padded (``fill`` gives another pad value per column)."""
    t0 = time.perf_counter()
    if device.type == "cuda" and _PINNED.holding():
        # This thread's last morsel failed after its copies were issued: let
        # them finish before its buffers are filled again.
        torch.cuda.current_stream(device).synchronize()
    hosts = {}
    for name, v in cols_np.items():
        sdt = _staging_dtype(v.dtype)
        src = v.view(sdt) if v.dtype.name == "bfloat16" else v
        shape = (padded,) + v.shape[1:]
        pad = (fill or {}).get(name, 0)
        if device.type == "cuda":
            host = _PINNED.get(name, shape, sdt).numpy()
        elif padded == n and src.dtype == sdt and src.flags.writeable and src.flags.c_contiguous:
            hosts[name] = src
            continue
        else:
            host = np.empty(shape, sdt)
        host[:n] = src
        host[n:] = pad
        hosts[name] = host
    phase_timer.host(time.perf_counter() - t0)
    phase_timer.mark(device)
    out = {}
    for name, host in hosts.items():
        t = torch.from_numpy(host)
        if device.type == "cuda":
            t = t.to(device, non_blocking=True)
        out[name] = _as_device_value(t, cols_np[name].dtype)
    phase_timer.mark(device)
    return out


def fetch(values: Sequence[object], device: torch.device) -> List[np.ndarray]:
    """Device values to host numpy arrays with one synchronisation: each
    copies ``non_blocking`` into fresh pinned memory (PyTorch's caching host
    allocator), then the calling thread's current stream (a pool worker's
    own) is synchronised once, which also ends the morsel's staging copies:
    its pinned set goes back to the free list."""
    phase_timer.mark(device)
    outs = []
    for v in values:
        wide = v.bits if isinstance(v, _Wide) else None
        t = v.t if wide else v
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        if device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t = host
        outs.append((t, wide, bf16))
    # The last mark goes on the stream before the synchronisation, which
    # then completes every event of the morsel before settle() reads them.
    phase_timer.mark(device)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
        _PINNED.release()
    phase_timer.settle()
    arrays = []
    for t, wide, bf16 in outs:
        a = t.numpy()
        if wide:
            a = a.astype(np.uint16 if wide == 16 else np.uint32)
        elif bf16:
            import ml_dtypes

            a = a.view(ml_dtypes.bfloat16)
        arrays.append(a)
    return arrays


def _compiled_for(exprs: Sequence[Expr]) -> Callable:
    return lambda cols: [_eval_tree(e, cols) for e in exprs]


def try_evaluate_fused(rb, exprs: Sequence[Expr]) -> Optional[Dict[int, Series]]:
    """Evaluate the fusable subset of ``exprs`` on ``cfg.device``.

    Returns {expr_index: Series} for the fused expressions, or None if nothing
    was fused. Unreturned indices are evaluated on the host.
    """
    from daft_tpu_torch.context import get_context

    cfg = get_context().execution_config
    n = len(rb)
    nontrivial = [
        i for i, e in enumerate(exprs)
        # Trivial column refs / literals aren't worth a device round-trip.
        if not (isinstance(e, (ColumnRef, Literal)) or (
            isinstance(e, Alias) and isinstance(e.child, (ColumnRef, Literal))))
    ]
    if n < cfg.device_eval_min_rows:
        if nontrivial:
            device_eval_counters.record_host("below_min_rows", len(nontrivial), rows=n)
            device_eval_counters.record_fallback("below_min_rows", len(nontrivial), rows=n)
        return None
    schema = rb.schema
    chosen: List[int] = []
    needed_cols: set = set()
    for i in nontrivial:
        reason = _unfusable_reason(exprs[i], schema)
        if reason is None:
            chosen.append(i)
            needed_cols |= exprs[i].column_refs()
        else:
            device_eval_counters.record_host(reason, rows=n)
            # The JAX package's registry label for every refusal here.
            device_eval_counters.record_fallback("not_fusable", rows=n)
    if not chosen:
        return None
    cols_np: Dict[str, np.ndarray] = {}
    null_masks: Dict[str, np.ndarray] = {}
    for name in sorted(needed_cols):
        vals, mask = rb.get_column(name).to_numpy_masked()
        cols_np[name] = vals
        if mask is not None:
            null_masks[name] = mask
    if null_masks:
        # Kleene and/or, IfElse and kernels with their own null rules stay
        # on the host when an input they read is nullable.
        safe = [i for i in chosen
                if not (exprs[i].column_refs() & set(null_masks)) or _nullable_safe(exprs[i])]
        if len(safe) < len(chosen):
            device_eval_counters.record_host("nullable_unsafe", len(chosen) - len(safe), rows=n)
            device_eval_counters.record_fallback("nullable_unsafe", len(chosen) - len(safe),
                                                 rows=n)
        chosen = safe
        if not chosen:
            return None
    device = resolve_device(cfg.device)
    chosen_exprs = [exprs[i] for i in chosen]
    key = ("project", tuple(e.key() for e in chosen_exprs), dtype_sig(cols_np))
    padded = _bucket_reusing(n, cfg.device_batch_buckets, key)
    fn = cached_program(key + (padded,), lambda: _compiled_for(chosen_exprs))
    cols_dev = stage(cols_np, padded, n, device)
    outs = fn(cols_dev)
    outs_host = fetch([_slice(o, n) for o in outs], device)
    result: Dict[int, Series] = {}
    for i, e, arr in zip(chosen, chosen_exprs, outs_host):
        target = e.to_field(schema).dtype
        s = Series.from_numpy(arr, e.name(), _np_result_dtype(target, arr))
        if s.dtype != target:
            s = s.cast(target)
        out_mask = None
        for ref in e.column_refs():
            m = null_masks.get(ref)
            if m is not None:
                out_mask = m if out_mask is None else (out_mask | m)
        result[i] = s._with_mask(out_mask)
    device_eval_counters.record_fused(len(chosen), n)
    return result


def _slice(v, n: int):
    return _Wide(v.t[:n], v.bits) if isinstance(v, _Wide) else v[:n]


def _np_result_dtype(target: DataType, arr: np.ndarray) -> DataType:
    if target.is_device_representable():
        # A 64-bit target of a same-rules kernel arrives as the device's
        # 32-bit array: build the Series at the array's own dtype, the caller
        # then casts up to the resolved target.
        try:
            if target.shape == () and not target.is_logical() and target.to_numpy() != arr.dtype:
                return DataType.from_numpy(arr.dtype)
        except (DaftError, TypeError, ValueError, KeyError, NotImplementedError):
            pass  # no numpy image for the target: keep the resolved dtype
        return target
    return DataType.from_numpy(arr.dtype)
