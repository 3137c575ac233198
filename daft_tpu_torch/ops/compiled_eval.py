"""Whole-chain device evaluation: filter → project → global partial
aggregation as ONE program per morsel or chunk (port of
``daft_tpu/ops/compiled_eval.py``).

Where ``ops/device_eval.py`` runs the numeric subgraph of a single projection,
this runs an entire relational chain — every Filter predicate and Project
expression between two pipeline breakers, optionally ending in the partial
phase of a global aggregation — as one program per micropartition on
``cfg.device``: the columns go to the device once, the chain runs there, and
one fetch brings back the keep mask and the computed columns (or, under an
aggregation, O(aggs) scalars). The JAX package traces the chain into one XLA
executable; the port's program is a closure over eager torch ops, one kernel
launch per op (fusing them is left to a later change).

Program discipline:

* **Plan fingerprint** — programs are cached on a canonical chain fingerprint
  (step kinds + ``Expr.key()`` forms + input dtypes + trailing shapes) and the
  padded length, with hit/miss counts (``device_eval_counters``). The
  fingerprint is a pure function of plan + schema + config.
* **Bucket shapes** — inputs pad to the device-eval bucket ladder. Elementwise
  chains reuse already-used larger buckets (outputs slice back to ``[:n]``);
  aggregation chains use the FIXED ladder, so a chunk's padded length — and
  with it the order of its float sums — is a pure function of its row count.

A chain that cannot run on the device whole stays interpreted, decided by
plan and dtype: 64-bit columns, kernels without a torch lowering, Kleene null
rules, integer sums (they promote past 32 bits on the host). Each such route
is counted. A device error raises: nothing here turns it into the host path.
The JAX package's fused-vs-interpreted A/B guard and its self-disable switch
are not ported (``compiled_eval_enabled=False`` is the only off switch), so
the registry's ``daft_compiled_eval_enabled`` gauge reads 1 whenever a chain
is considered. The chains' morsels and rows, their program cache and their
host routes count in the metrics registry as in the JAX package
(``device_eval.DeviceEvalCounters``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from daft_tpu_torch import metrics
from daft_tpu_torch.device import resolve_device
from daft_tpu_torch.errors import DaftError
from daft_tpu_torch.expressions.expr import AggOp, Alias, ColumnRef, Expr, Literal
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.ops import device_eval as de
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series

_ELIGIBILITY_ERRORS = (DaftError, KeyError, TypeError, ValueError,
                       NotImplementedError, AttributeError)


class _ChainIneligible(Exception):
    """The chain cannot run on the device whole; ``reason`` names the route."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason


def _unalias(e: Expr) -> Expr:
    while isinstance(e, Alias):
        e = e.child
    return e


def _trivial_source(e: Expr) -> Optional[str]:
    """The source column name when ``e`` is a bare passthrough (possibly
    renamed) column reference; None for anything computed."""
    inner = _unalias(e)
    return inner.name_ if isinstance(inner, ColumnRef) else None


def _trivial_literal(e: Expr) -> Optional[Literal]:
    inner = _unalias(e)
    return inner if isinstance(inner, Literal) else None


def _or_masks(refs, masks: Dict[str, Optional[np.ndarray]]) -> Optional[np.ndarray]:
    m = None
    for ref in refs:
        rm = masks.get(ref)
        if rm is not None:
            m = rm if m is None else (m | rm)
    return m


def _refuse(expr: Expr, schema: Schema, env: Set[str], what: str) -> None:
    """Raise _ChainIneligible unless ``expr`` runs on the device over the
    names of ``env``."""
    reason = de._unfusable_reason(expr, schema)
    if reason is None and not expr.column_refs() <= env:
        missing = expr.column_refs() - env
        reason = "dtype_64bit" if all(
            schema.get(r) is not None and schema.get(r).dtype.is_device_representable()
            for r in missing) else "not_fusable"
    if reason is not None:
        raise _ChainIneligible(reason, what)


class _ChainWalk:
    """Forward walk of a filter/project chain that validates it for the
    device and resolves, per step, which names live in the device env vs pass
    through host-side. Pure function of plan + schema, so eligibility never
    varies with the data; raises _ChainIneligible on the first construct the
    device path cannot run."""

    def __init__(self, steps, input_schema: Schema):
        from daft_tpu_torch.expressions.evaluator import resolve_schema

        self.steps = list(steps)
        self.input_schema = input_schema
        schema = input_schema
        # Device env membership + transitive input deps per current name.
        env_deps: Dict[str, Set[str]] = {
            f.name: {f.name} for f in schema if de._dtype_ok(f.dtype)}
        # Host passthrough: current name -> source input column.
        host: Dict[str, str] = {f.name: f.name for f in schema}
        literals: Dict[str, Literal] = {}
        self.preds: List[Expr] = []
        prog_steps: List[tuple] = []
        for kind, payload in self.steps:
            if kind == "filter":
                _refuse(payload, schema, set(env_deps), f"filter {payload!r}")
                self.preds.append(payload)
                prog_steps.append(("filter", payload))
                continue
            new_env: Dict[str, Set[str]] = {}
            new_host: Dict[str, str] = {}
            new_literals: Dict[str, Literal] = {}
            proj: List[Tuple[str, Expr]] = []  # device outputs only
            for e in payload:
                name = e.name()
                src = _trivial_source(e)
                lit = _trivial_literal(e)
                if src is not None:
                    if src in host:
                        new_host[name] = host[src]
                    if src in env_deps:
                        new_env[name] = env_deps[src]
                        proj.append((name, e))
                    if src not in host and src not in env_deps:
                        raise _ChainIneligible("not_fusable", f"unknown column {src!r}")
                elif lit is not None:
                    new_literals[name] = lit
                else:
                    _refuse(e, schema, set(env_deps), f"expr {name!r}")
                    new_env[name] = set().union(*(env_deps[r] for r in e.column_refs()))
                    proj.append((name, e))
            env_deps, host, literals = new_env, new_host, new_literals
            prog_steps.append(("project", proj))
            schema = resolve_schema(payload, schema)
        self.env_deps = env_deps
        self.host = host
        self.literals = literals
        self.prog_steps = prog_steps
        self.final_schema = schema

    def fingerprint_steps(self) -> tuple:
        return tuple(
            (k, p.key()) if k == "filter" else (k, tuple(e.key() for e in p))
            for k, p in self.steps)

    def nullable_gate(self, masked: Set[str]) -> bool:
        """True when every device expression's null propagation matches the
        AND-reduce law for the masks actually present (data-driven). Walks
        with the evolving set of masked names, so a filter ABOVE a projection
        is checked against the projected namespace."""
        if not masked:
            return True
        cur = set(masked)
        for kind, payload in self.prog_steps:
            if kind == "filter":
                if (payload.column_refs() & cur) and not de._nullable_safe(payload):
                    return False
                continue
            nxt = set()
            for name, e in payload:
                if e.column_refs() & cur:
                    if _trivial_source(e) is None and not de._nullable_safe(e):
                        return False
                    nxt.add(name)
            cur = nxt
        return True

    def pred_null_mask(self, null_masks: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
        """OR of every predicate's null mask, each resolved in the
        predicate's OWN (possibly post-projection) namespace — a null in any
        predicate input drops the row (SQL filter semantics). None when no
        predicate touches a masked column."""
        cur: Dict[str, Optional[np.ndarray]] = dict(null_masks)
        combined = None
        for kind, payload in self.prog_steps:
            if kind == "filter":
                m = _or_masks(payload.column_refs(), cur)
                if m is not None:
                    combined = m if combined is None else (combined | m)
                continue
            cur = {name: _or_masks(e.column_refs(), cur) for name, e in payload}
        return combined

    def mask_env(self, null_masks: Dict[str, np.ndarray]) -> Dict[str, Optional[np.ndarray]]:
        """Final-namespace null masks: OR-reduce of each output's referenced
        input masks, resolved through the project steps."""
        cur: Dict[str, Optional[np.ndarray]] = dict(null_masks)
        for kind, payload in self.prog_steps:
            if kind == "project":
                cur = {name: _or_masks(e.column_refs(), cur) for name, e in payload}
        return cur


def _prune_prog(prog_steps, out_needed: Set[str]) -> Tuple[list, Set[str]]:
    """Drop project outputs that no later step or final output reads — host
    passthroughs never stage. Returns the pruned steps and the set of INPUT
    columns the program reads."""
    needed = set(out_needed)
    pruned: List[tuple] = []
    for kind, payload in reversed(prog_steps):
        if kind == "filter":
            needed |= payload.column_refs()
            pruned.append((kind, payload))
            continue
        kept = [(name, e) for name, e in payload if name in needed]
        needed = set()
        for _, e in kept:
            needed |= e.column_refs()
        pruned.append((kind, kept))
    pruned.reverse()
    return pruned, needed


def _trace_env_fn(prog_steps):
    """The chain body over a device column env: folds project steps into the
    env and ANDs filter masks; returns (keep_or_None, env)."""
    def fold(cols: Dict[str, object]):
        env = dict(cols)
        keep = None
        for kind, payload in prog_steps:
            if kind == "filter":
                m = de._eval_tree(payload, env)
                m = m.t if isinstance(m, de._Wide) else m
                m = m.to(torch.bool)
                keep = m if keep is None else (keep & m)
            else:
                env = {name: de._eval_tree(_unalias(e), env) for name, e in payload}
        return keep, env

    return fold


def _read_columns(rb: RecordBatch, names) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    cols_np: Dict[str, np.ndarray] = {}
    null_masks: Dict[str, np.ndarray] = {}
    for name in names:
        vals, mask = rb.get_column(name).to_numpy_masked()
        cols_np[name] = vals
        if mask is not None:
            null_masks[name] = mask
    return cols_np, null_masks


# --------------------------------------------------------------------- #
# Filter/project chain programs                                         #
# --------------------------------------------------------------------- #
class ChainSpec:
    """A validated, fingerprinted filter/project chain.

    Built ONCE per stage from plan + schema + config. Per-morsel calls run
    the chain's program, or return None for the data-driven host routes
    (a morsel under ``device_eval_min_rows``; nullable columns under
    non-AND-reduce null rules), each counted."""

    def __init__(self, walk: _ChainWalk, out_schema: Schema, cfg):
        self.walk = walk
        self.out_schema = out_schema
        self.cfg = cfg
        self.out_names = [f.name for f in out_schema]
        # Assembly prefers the host source for pure passthroughs (no device
        # round-trip for untouched columns); only computed outputs fetch.
        self.dev_out = [n for n in self.out_names
                        if n in walk.env_deps and n not in walk.host and n not in walk.literals]
        for n in self.out_names:
            if n not in walk.env_deps and n not in walk.host and n not in walk.literals:
                raise _ChainIneligible("not_fusable", f"output {n!r} unresolvable")
        for n in self.dev_out:
            f = walk.final_schema.get(n)
            if f is None or not de._dtype_ok(f.dtype):
                raise _ChainIneligible("dtype_64bit", f"output {n!r}")
        if not self.dev_out and not walk.preds:
            raise _ChainIneligible("nothing_on_device")
        self.prog_steps, needed = _prune_prog(walk.prog_steps, set(self.dev_out))
        self.src_cols = sorted(needed)
        self.fingerprint = (
            "chain", walk.fingerprint_steps(), tuple(self.out_names),
            tuple((n, str(walk.input_schema.get(n).dtype)) for n in self.src_cols))

    def _build_run(self):
        fold = _trace_env_fn(self.prog_steps)
        dev_out = self.dev_out

        def run(cols: Dict[str, object]):
            keep, env = fold(cols)
            return keep, [env[n] for n in dev_out]

        return run

    def run_morsel(self, mp: MicroPartition) -> Optional[MicroPartition]:
        """One evaluation of the whole chain over a morsel on the device, or
        None to take the interpreted per-step path."""
        rb = mp.combined()
        n = len(rb)
        if n < self.cfg.device_eval_min_rows:
            de.device_eval_counters.record_host("chain_below_min_rows", rows=n)
            return None
        cols_np, null_masks = _read_columns(rb, self.src_cols)
        if not self.walk.nullable_gate(set(null_masks)):
            de.device_eval_counters.record_host("chain_nullable_unsafe", rows=n)
            de.device_eval_counters.record_fallback("nullable_unsafe", rows=n)
            return None
        device = resolve_device(self.cfg.device)
        shape_key = (self.fingerprint, de.dtype_sig(cols_np))
        # Elementwise outputs slice back to [:n], so bucket reuse is safe.
        padded = de._bucket_reusing(n, self.cfg.device_batch_buckets, shape_key)
        fn = de.cached_program(shape_key + (padded,), self._build_run, chain=True)
        keep, outs = fn(de.stage(cols_np, padded, n, device))
        fetched = de.fetch(([keep[:n]] if keep is not None else []) +
                           [de._slice(o, n) for o in outs], device)
        keep_np = None
        if keep is not None:
            keep_np, fetched = fetched[0], fetched[1:]
            # Pred null lanes drop (SQL filter semantics), each predicate's
            # mask resolved in its own namespace.
            pred_mask = self.walk.pred_null_mask(null_masks)
            if pred_mask is not None:
                keep_np = keep_np & ~pred_mask
        return self._assemble(rb, n, keep_np, fetched, null_masks)

    def _assemble(self, rb: RecordBatch, n: int, keep_np: Optional[np.ndarray], outs_np,
                  null_masks: Dict[str, np.ndarray]) -> MicroPartition:
        final_masks = self.walk.mask_env(null_masks)
        out_n = int(keep_np.sum()) if keep_np is not None else n
        keep_series = Series.from_numpy(keep_np, "__keep") if keep_np is not None else None
        dev_arrays = dict(zip(self.dev_out, outs_np))
        cols: List[Series] = []
        for name in self.out_names:
            target = self.out_schema.get(name).dtype
            if name in dev_arrays:
                arr = dev_arrays[name]
                mask = final_masks.get(name)
                if keep_np is not None:
                    arr = arr[keep_np]
                    mask = mask[keep_np] if mask is not None else None
                s = Series.from_numpy(np.ascontiguousarray(arr), name,
                                      de._np_result_dtype(target, arr))
                if s.dtype != target:
                    s = s.cast(target)
                if mask is not None:
                    s = s._with_mask(np.ascontiguousarray(mask))
            elif name in self.walk.literals:
                lit = self.walk.literals[name]
                s = Series.full(name, lit.value, out_n, lit.dtype)
                if s.dtype != target:
                    s = s.cast(target)
            else:
                src = self.walk.host[name]
                s = rb.get_column(src)
                if keep_series is not None:
                    s = s.filter(keep_series)
                if s.name != name:
                    s = s.rename(name)
                if s.dtype != target:
                    s = s.cast(target)
            cols.append(s)
        de.device_eval_counters.record_chain("filter_project", n)
        de.device_eval_counters.record_fused(max(len(self.dev_out) + len(self.walk.preds), 1), n)
        return MicroPartition(self.out_schema, [RecordBatch(self.out_schema, cols, out_n)])


def _enabled(cfg) -> bool:
    """The config knob; sets the registry's enabled gauge (the JAX
    package's ``enabled`` primes it the same way)."""
    if not cfg.compiled_eval_enabled:
        return False
    metrics.COMPILED_EVAL_ENABLED.set(1)
    return True


def build_chain_spec(steps, input_schema: Schema, out_schema: Schema,
                     cfg) -> Tuple[Optional[ChainSpec], Optional[str]]:
    """(spec, None) when the WHOLE chain runs on the device (pure plan +
    config eligibility), else (None, the host route's reason)."""
    if not steps:
        return None, "nothing_on_device"
    if not _enabled(cfg):
        return None, "compiled_eval_disabled"
    try:
        return ChainSpec(_ChainWalk(steps, input_schema), out_schema, cfg), None
    except _ChainIneligible as e:
        return None, e.reason
    except _ELIGIBILITY_ERRORS:
        return None, "not_fusable"


# --------------------------------------------------------------------- #
# Chain + global-aggregation partial phase                              #
# --------------------------------------------------------------------- #
def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


class AggChainSpec:
    """Filter/project chain fused with the PARTIAL phase of a global
    (no-group-by) aggregation: one program computes the keep mask, the
    projected environment and masked partial reductions, returning O(aggs)
    scalars per chunk instead of a filtered morsel.

    Reductions are shape-sensitive, so this spec pads with the FIXED bucket
    ladder (never the reuse ladder): the padded length is a pure function of
    the row count, so a chunk's float sums are the same in every run (the
    determinism contract of the JAX package). Validity masks ride as input
    arrays, the row mask is built on the device from ``n``, so varying ``n``
    within a bucket never makes a new program.
    """

    def __init__(self, walk: _ChainWalk, agg_plan, partial_schema: Schema, cfg):
        if agg_plan.group_by:
            raise _ChainIneligible("grouped")
        self.walk = walk
        self.cfg = cfg
        self.partial_schema = partial_schema
        schema = walk.final_schema
        # Partial aggs: Alias(AggOp(op, child), "__p<i>_<s>"). The device
        # takes {sum, count, min, max} whose resolved partial field stays
        # 32-bit (integer sums promote to 64 bits on the host and stay there).
        self.aggs: List[Tuple[str, str, Expr, object, str]] = []
        for pe in agg_plan.partial_exprs:
            name = pe.name()
            agg = _unalias(pe)
            if not isinstance(agg, AggOp) or agg.op not in ("sum", "count", "min", "max"):
                raise _ChainIneligible("not_fusable", f"agg op {getattr(agg, 'op', '?')}")
            child = agg.child
            field = partial_schema.get(name)
            if field is None:
                raise _ChainIneligible("not_fusable", f"partial field {name!r}")
            if agg.op == "count":
                mode = (agg.kwargs or {}).get("mode", "valid")
                if mode not in ("valid", "all"):
                    raise _ChainIneligible("not_fusable", f"count mode {mode!r}")
                if _trivial_source(child) is None:
                    _refuse(child, schema, set(walk.env_deps), "count child")
                elif _trivial_source(child) not in walk.env_deps:
                    raise _ChainIneligible("not_fusable", "count child")
                self.aggs.append((name, "count", child, field.dtype, mode))
                continue
            _refuse(child, schema, set(walk.env_deps), f"agg child {name!r}")
            child_np = child.to_field(schema).dtype.to_numpy()
            if child_np.kind not in "fiu":
                raise _ChainIneligible("not_fusable", "agg child kind")
            if agg.op == "sum" and child_np.kind != "f":
                # Integer sums promote past 32 bits on the host; floats keep
                # their width, so f32 sums match the partial field.
                raise _ChainIneligible("int_sum_promotes", name)
            if not de._dtype_ok(field.dtype):
                raise _ChainIneligible("dtype_64bit", f"partial field {name!r}")
            self.aggs.append((name, agg.op, child, field.dtype, ""))
        if not self.aggs:
            raise _ChainIneligible("not_fusable", "no partial aggs")
        final_refs: Set[str] = set()
        for _, _, child, _, _ in self.aggs:
            final_refs |= child.column_refs()
        self.prog_steps, needed = _prune_prog(walk.prog_steps, final_refs)
        self.src_cols = sorted(needed)
        self.fingerprint = (
            "agg_chain", walk.fingerprint_steps(),
            tuple((nm, op, child.key(), mode) for nm, op, child, _, mode in self.aggs),
            tuple((nm, str(walk.input_schema.get(nm).dtype)) for nm in self.src_cols))

    def _agg_nullable_gate(self, masked: Set[str]) -> bool:
        if not masked:
            return True
        if not self.walk.nullable_gate(masked):
            return False
        # Masked names in the FINAL namespace that agg children touch.
        cur = set(masked)
        for kind, payload in self.walk.prog_steps:
            if kind == "project":
                cur = {name for name, e in payload if e.column_refs() & cur}
        for _, _, child, _, _ in self.aggs:
            if (child.column_refs() & cur) and _trivial_source(child) is None \
                    and not de._nullable_safe(child):
                return False
        return True

    def _build_run(self):
        fold = _trace_env_fn(self.prog_steps)
        aggs = [(name, op, child, mode) for name, op, child, _dt, mode in self.aggs]

        def run(cols: Dict[str, object], valids: Dict[str, torch.Tensor], n: int, padded: int,
                device: torch.device):
            keep, env = fold(cols)
            rows = torch.arange(padded, device=device) < n
            keep = rows if keep is None else (keep & rows)
            if "__pred_valid__" in valids:
                keep = keep & valids["__pred_valid__"]
            outs = []
            for name, op, child, mode in aggs:
                avalid = valids.get(f"__v_{name}")
                sel = keep if avalid is None else (keep & avalid)
                cnt = sel.sum()
                if op == "count":
                    c = (keep if mode == "all" else sel).sum()
                    outs.append((c, c, None))
                    continue
                v = de._eval_tree(_unalias(child), env)
                bits = v.bits if isinstance(v, de._Wide) else None
                v = v.t if bits else v
                if op == "sum":
                    outs.append((torch.where(sel, v, 0).sum(), cnt, None))
                    continue
                if v.dtype.is_floating_point:
                    lo, hi = float("inf"), float("-inf")
                elif bits:
                    lo, hi = (1 << bits) - 1, 0
                else:
                    info = torch.iinfo(v.dtype)
                    lo, hi = info.max, info.min
                red = torch.where(sel, v, lo).min() if op == "min" else torch.where(sel, v, hi).max()
                outs.append((red, cnt, bits))
            return outs

        return run

    def run_chunk(self, rb: RecordBatch) -> Optional[RecordBatch]:
        """Partial-aggregate one chunk on the device; None takes the
        interpreted steps + host aggregation (counted)."""
        n = len(rb)
        if n < max(self.cfg.device_eval_min_rows, 1):
            de.device_eval_counters.record_host("agg_below_min_rows", rows=n)
            return None
        cols_np, null_masks = _read_columns(rb, self.src_cols)
        if not self._agg_nullable_gate(set(null_masks)):
            de.device_eval_counters.record_host("agg_nullable_unsafe", rows=n)
            de.device_eval_counters.record_fallback("nullable_unsafe", rows=n)
            return None
        device = resolve_device(self.cfg.device)
        # FIXED bucketing: reductions must see a padded length that is a
        # pure function of n (class docstring).
        padded = de._bucket(n, self.cfg.device_batch_buckets)
        valids: Dict[str, np.ndarray] = {}
        # Each predicate's null mask resolved in its own namespace.
        pred_mask = self.walk.pred_null_mask(null_masks)
        if pred_mask is not None:
            valids["__pred_valid__"] = ~pred_mask
        mask_env = self.walk.mask_env(null_masks)
        for name, _op, child, _dt, _mode in self.aggs:
            m = _or_masks(child.column_refs(), mask_env)
            if m is not None:
                valids[f"__v_{name}"] = ~m
        shape_key = (self.fingerprint, padded, de.dtype_sig(cols_np), tuple(sorted(valids)))
        fn = de.cached_program(shape_key, self._build_run, chain=True)
        staged = de.stage({**cols_np, **valids}, padded, n, device,
                          fill={k: False for k in valids})
        outs = fn({k: staged[k] for k in cols_np}, {k: staged[k] for k in valids}, n, padded,
                  device)
        # ONE fetch for the chunk: every value and count, packed as f64
        # (exact for f32 values, 32-bit integers and counts below 2**53).
        packed = torch.stack([x.to(torch.float64) for v, c, _ in outs for x in (v, c)])
        host = de.fetch([packed], device)[0]
        null_one = np.ones(1, dtype=bool)
        cols: List[Series] = []
        for i, ((name, op, child, dtype, mode), (v, _c, bits)) in enumerate(zip(self.aggs, outs)):
            count = int(host[2 * i + 1])
            if op == "count":
                s = Series.from_numpy(np.array([count], dtype=np.uint64), name)
            else:
                np_dt = np.dtype(np.uint16 if bits == 16 else np.uint32) if bits else _np_dtype(v)
                arr = np.array([host[2 * i]]).astype(np_dt)
                s = Series.from_numpy(arr, name, de._np_result_dtype(dtype, arr))
                if count == 0:
                    # Host partials over zero qualifying rows are null
                    # (arrow min_count=1 semantics).
                    s = s._with_mask(null_one)
            if s.dtype != dtype:
                s = s.cast(dtype)
            cols.append(s)
        de.device_eval_counters.record_chain("filter_project_agg", n)
        de.device_eval_counters.record_fused(max(len(self.aggs), 1), n)
        return RecordBatch(Schema([Field(c.name, c.dtype) for c in cols]), cols, 1)


def build_agg_chain_spec(steps, agg_plan, input_schema: Schema, partial_schema: Schema,
                         cfg) -> Tuple[Optional[AggChainSpec], Optional[str]]:
    """(spec, None) when the whole chain INCLUDING every partial aggregation
    runs on the device; else (None, the host route's reason)."""
    if not _enabled(cfg):
        return None, "compiled_eval_disabled"
    try:
        return AggChainSpec(_ChainWalk(steps, input_schema), agg_plan, partial_schema, cfg), None
    except _ChainIneligible as e:
        return None, e.reason
    except _ELIGIBILITY_ERRORS:
        return None, "not_fusable"
