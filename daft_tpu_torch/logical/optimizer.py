"""Logical plan optimizer (port of ``daft_tpu/logical/optimizer.py``).

Reference: src/daft-logical-plan/src/optimization/optimizer.rs:127-280 — an
ordered list of rule batches, each run to fixed point, then a final column
pruning pass. The batches are the JAX package's, in its order:

* UnnestSubqueries — IN / EXISTS / scalar subqueries, correlated or not,
  into semi / anti / left / cross joins and grouped aggregates, and a
  subquery with non-equi correlation through the row-id technique
  (``MonotonicallyIncreasingId``) (reference: rules/unnest_subquery.rs);
* DetectMonotonicId — ``monotonically_increasing_id()`` in a projection into
  the MonotonicallyIncreasingId plan op (rules/detect_monotonic_id.rs);
* SimplifyExpressions — constant folding, boolean and numeric identities,
  null propagation (reference: rules/simplify_expressions.rs + daft-algebra);
* SplitUDFs — isolates UDF calls into UDFProject nodes (rules/split_udfs.rs);
* SimplifyNullFilteredJoin, EliminateCrossJoin, PushDownFilter and
  PushDownSemiAnti (top-down), DropRepartition — outer joins whose padded
  side a filter rejects become inner, a filtered cross join with cross-side
  equalities becomes an inner join, filters and semi / anti joins move
  toward the relations that own their columns, a repartition over a
  repartition drops the inner one (rules/push_down_filter.rs,
  push_down_anti_semi_join.rs, eliminate_cross_join.rs,
  simplify_null_filtered_join.rs, drop_repartition.rs);
* PushDownLimit — composes limits, Sort + Limit into TopN, a scan's limit;
* EnrichWithStats — parquet footers into the scan's row counts and column
  stats (rules/enrich_with_stats.rs);
* PushDownAggregation — a global count over a bare parquet scan from the
  footers (rules/push_down_aggregation.rs);
* FilterNullJoinKey with PushDownFilter — not-null filters on join keys
  with evidence of nulls (rules/filter_null_join_key.rs);
* ReorderJoins (top-down) — DP over the connected subsets of up to 10
  inner-joined relations, the smaller side of each join as its build side
  (rules/reorder_joins/);
* PushDownProjection — a scan's columns pruned to what the plan reads;

and ``prune_columns`` last. Left out of the batches: PushDownShard, with the
``Shard`` node it rewrites (ROADMAP A.8), which is left out of the rules'
type lists too; and the feedback plane's observed cardinalities that
override the join-order estimates in the JAX package are not ported (A.8).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

from daft_tpu_torch.errors import DaftError
from daft_tpu_torch.expressions.expr import (
    AggOp,
    Alias,
    BinaryOp,
    ColumnRef,
    Exists,
    Expr,
    InSubquery,
    Literal,
    Subquery,
    UnaryOp,
)
from daft_tpu_torch.logical import plan as lp

_log = logging.getLogger("daft_tpu_torch.optimizer")


class Rule:
    name = "rule"
    top_down = False  # apply at a node before recursing into its children

    def rewrite(self, node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
        """Return a replacement for this node, or None to keep it."""
        raise NotImplementedError


def _rewrite_bottom_up(node: lp.LogicalPlan, rule: Rule,
                       _memo: Optional[dict] = None) -> lp.LogicalPlan:
    # Memoized per pass so DAG-shared subtrees (decorrelated subqueries)
    # stay SHARED through rewrites — executor-level subplan caching keys on
    # object identity.
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(node))
    if hit is not None:
        return hit
    orig = node
    new_children = [_rewrite_bottom_up(c, rule, _memo) for c in node.children()]
    if any(a is not b for a, b in zip(new_children, node.children())):
        node = node.with_children(new_children)
    replaced = rule.rewrite(node)
    out = replaced if replaced is not None else node
    _memo[id(orig)] = out
    return out


def _rewrite_top_down(node: lp.LogicalPlan, rule: Rule,
                      _memo: Optional[dict] = None) -> lp.LogicalPlan:
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(node))
    if hit is not None:
        return hit
    orig = node
    replaced = rule.rewrite(node)
    if replaced is not None:
        node = replaced
    new_children = [_rewrite_top_down(c, rule, _memo) for c in node.children()]
    if any(a is not b for a, b in zip(new_children, node.children())):
        node = node.with_children(new_children)
    _memo[id(orig)] = node
    return node


class Optimizer:
    # Rules like PushDownFilter move a predicate ONE level per pass; deep
    # join chains (TPC-H Q8 has 8 relations ⇒ 7 join levels) need at least
    # that many passes to carry a filter to its leaf. Batches exit early at
    # fixed point, so the ceiling only bounds pathological non-convergence.
    MAX_PASSES = 24

    def __init__(self, cfg=None):
        from daft_tpu_torch.context import get_context

        self.cfg = cfg or get_context().execution_config
        self.batches: List[List[Rule]] = [
            [UnnestSubqueries()],
            [DetectMonotonicId()],
            [SimplifyExpressions()],
            [SplitUDFs()],
            [SimplifyNullFilteredJoin(), EliminateCrossJoin(), PushDownFilter(),
             PushDownSemiAnti(), DropRepartition()],
            [PushDownLimit()],
            [EnrichWithStats()],
            [PushDownAggregation()],
            [FilterNullJoinKey(), PushDownFilter()],
            [ReorderJoins(self.cfg)],
            [PushDownProjection()],
        ]

    def optimize(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        for batch in self.batches:
            for _ in range(self.MAX_PASSES):
                changed = False
                for rule in batch:
                    rewriter = _rewrite_top_down if rule.top_down else _rewrite_bottom_up
                    try:
                        new_plan = rewriter(plan, rule)
                    except Exception:
                        # A crashing rewrite rule must be DIAGNOSABLE, never a
                        # silent skip: log the rule and the plan root, keep
                        # the pre-rule plan, and continue with the batch
                        # (optimizations are best-effort; correctness comes
                        # from the unoptimized plan being valid).
                        _log.warning(
                            "optimizer rule %s crashed on plan node %s; "
                            "keeping the pre-rule plan", rule.name,
                            type(plan).__name__, exc_info=True)
                        continue
                    if new_plan is not plan:
                        plan = new_plan
                        changed = True
                if not changed:
                    break
        # Final pass: prune unused columns through joins / in-memory sources
        # (scan-source pruning happened via PushDownProjection's pushdowns).
        plan = prune_columns(plan)
        return plan


# ---------------------------------------------------------------------- #
class SimplifyExpressions(Rule):
    name = "SimplifyExpressions"

    def rewrite(self, node):
        if isinstance(node, lp.Project):
            schema = node.children()[0].schema
            new = [simplify_expr(e, schema) for e in node.exprs]
            if any(a is not b for a, b in zip(new, node.exprs)):
                return lp.Project(node.children()[0], new)
        if isinstance(node, lp.Filter):
            p = simplify_expr(node.predicate, node.children()[0].schema)
            if isinstance(p, Literal) and p.value is True:
                return node.children()[0]
            if p is not node.predicate:
                return lp.Filter(node.children()[0], p)
        return None


def _lit_is(v, value: bool) -> bool:
    return isinstance(v, Literal) and v.value is value


def _is_zero(n: Expr) -> bool:
    return isinstance(n, Literal) and not isinstance(n.value, bool) \
        and n.value == 0


def _is_one(n: Expr) -> bool:
    return isinstance(n, Literal) and not isinstance(n.value, bool) \
        and n.value == 1


def _is_null_lit(n: Expr) -> bool:
    return isinstance(n, Literal) and n.value is None


_NULL_PROPAGATING = {"eq", "ne", "lt", "le", "gt", "ge", "add", "sub", "mul",
                     "truediv", "floordiv", "mod", "pow", "xor"}


def simplify_expr(e: Expr, schema=None) -> Expr:
    """Algebraic simplification (reference: src/daft-algebra/src/simplify/
    {numeric.rs,boolean.rs,null.rs}): constant folding, boolean and numeric
    identities, null-literal propagation, bool-comparison elimination.
    Identity eliminations that could change the expression's dtype (e.g.
    int32_col * 1int64) only fire when ``schema`` proves the dtype is
    preserved."""

    def same_dtype(a: Expr, whole: Expr) -> bool:
        if schema is None:
            return False
        try:
            return a.to_field(schema).dtype == whole.to_field(schema).dtype
        except (DaftError, KeyError, TypeError, NotImplementedError):
            return False  # unresolvable field: identity rewrite not provably safe

    def fold(n: Expr):
        if isinstance(n, BinaryOp):
            l, r = n.left, n.right
            if isinstance(l, Literal) and isinstance(r, Literal):
                try:
                    from daft_tpu_torch.expressions.evaluator import evaluate
                    from daft_tpu_torch.recordbatch import RecordBatch

                    rb = RecordBatch.from_pydict({"__one": [0]})
                    res = evaluate(n, rb)
                    vals = res.to_pylist()
                    return Literal(vals[0], res.dtype)
                except Exception:
                    # Folding is opportunistic; a non-foldable pair (e.g.
                    # division by zero surfacing at plan time) stays symbolic
                    # — but leave a trace so a mis-typed literal is findable.
                    _log.debug("constant fold of %s failed", n.op,
                               exc_info=True)
                    return None
            # NULL literal propagates through comparisons/arithmetic
            # (null.rs) — NOT through Kleene and/or. The replacement keeps
            # the ORIGINAL dtype (an untyped None would silently turn the
            # declared Int64 column into Arrow null type downstream).
            if n.op in _NULL_PROPAGATING and (_is_null_lit(l) or _is_null_lit(r)):
                if schema is None:
                    return None
                try:
                    return Literal(None, n.to_field(schema).dtype)
                except (DaftError, KeyError, TypeError, NotImplementedError):
                    return None  # dtype unresolvable: keep the symbolic form
            # Kleene boolean identities (boolean.rs): the short-circuit
            # absorptions hold even for null operands.
            if n.op == "and":
                if _lit_is(r, True):
                    return l
                if _lit_is(l, True):
                    return r
                if _lit_is(l, False) or _lit_is(r, False):
                    return Literal(False)
            if n.op == "or":
                if _lit_is(r, False):
                    return l
                if _lit_is(l, False):
                    return r
                if _lit_is(l, True) or _lit_is(r, True):
                    return Literal(True)
            # bool_col == true -> bool_col ; == false -> NOT col ; etc.
            if n.op in ("eq", "ne"):
                for a, b in ((l, r), (r, l)):
                    if isinstance(b, Literal) and isinstance(b.value, bool) \
                            and same_dtype(a, n):
                        want_not = (n.op == "eq") != b.value
                        return UnaryOp("not", a) if want_not else a
            # Numeric identities (numeric.rs), dtype-preserving only.
            if n.op == "mul":
                if _is_one(r) and same_dtype(l, n):
                    return l
                if _is_one(l) and same_dtype(r, n):
                    return r
            if n.op == "truediv" and _is_one(r) and same_dtype(l, n):
                return l
            if n.op == "add":
                if _is_zero(r) and same_dtype(l, n):
                    return l
                if _is_zero(l) and same_dtype(r, n):
                    return r
            if n.op == "sub" and _is_zero(r) and same_dtype(l, n):
                return l
        if isinstance(n, UnaryOp) and n.op == "not":
            c = n.child
            if isinstance(c, UnaryOp) and c.op == "not":
                return c.child
            if isinstance(c, Literal) and isinstance(c.value, bool):
                return Literal(not c.value)
        if isinstance(n, UnaryOp) and n.op == "negate":
            c = n.child
            if isinstance(c, UnaryOp) and c.op == "negate":
                return c.child
        return None

    return e.transform(fold)


# ---------------------------------------------------------------------- #
class SplitUDFs(Rule):
    """Project with UDF calls → chain of UDFProject nodes + final Project.

    Reference: rules/split_udfs.rs — isolating each expensive UDF into its own
    operator is what enables batching/backpressure/accelerator placement.
    """

    name = "SplitUDFs"

    def rewrite(self, node):
        if not isinstance(node, lp.Project):
            return None
        if not any(e.has_udf() for e in node.exprs):
            return None
        base = node.children()[0]
        final_exprs: List[Expr] = []
        counter = 0
        for e in node.exprs:
            if not e.has_udf():
                final_exprs.append(e)
                continue
            # Hoist every UdfCall subtree into its own UDFProject.
            def hoist(n: Expr):
                nonlocal base, counter
                from daft_tpu_torch.expressions.expr import UdfCall

                if isinstance(n, UdfCall):
                    tmp = f"__udf_{counter}"
                    counter += 1
                    passthrough = [ColumnRef(f.name) for f in base.schema]
                    base = lp.UDFProject(base, Alias(n, tmp), passthrough)
                    return ColumnRef(tmp)
                return None

            rewritten = e.transform(hoist)
            final_exprs.append(Alias(rewritten, e.name()) if rewritten.name() != e.name() else rewritten)
        return lp.Project(base, final_exprs)


# ---------------------------------------------------------------------- #
def _substitute(e: Expr, mapping: dict) -> Expr:
    def sub(n: Expr):
        if isinstance(n, ColumnRef) and n.name_ in mapping:
            return mapping[n.name_]
        return None

    return e.transform(sub)


def _strip_alias(e: Expr) -> Expr:
    while isinstance(e, Alias):
        e = e.child
    return e


class PushDownFilter(Rule):
    name = "PushDownFilter"

    def rewrite(self, node):
        if not isinstance(node, lp.Filter):
            return None
        child = node.children()[0]
        pred = node.predicate
        if isinstance(child, lp.Filter):
            conj: List[Expr] = []
            _flatten_and(child.predicate, conj)
            _flatten_and(pred, conj)
            # dedup by key: repeated derivation/merge must not stack copies
            seen: dict = {}
            for c in conj:
                seen.setdefault(c.key(), c)
            return lp.Filter(child.children()[0], _and_all(list(seen.values())))
        if isinstance(child, lp.Project):
            mapping = {e.name(): _strip_alias(e) for e in child.exprs}
            if all(not mapping[n].has_udf() for n in pred.column_refs() if n in mapping):
                try:
                    new_pred = _substitute(pred, mapping)
                    new_pred.to_field(child.children()[0].schema)
                except (DaftError, KeyError, TypeError, NotImplementedError):
                    return None  # predicate does not type below the project
                return lp.Project(lp.Filter(child.children()[0], new_pred), child.exprs)
        # NOTE: MonotonicallyIncreasingId is NOT pass-through — filtering before
        # id assignment would renumber the surviving rows.
        if isinstance(child, (lp.Sort, lp.Repartition)):
            grand = child.children()[0]
            if all(n in grand.schema for n in pred.column_refs()):
                return child.with_children([lp.Filter(grand, pred)])
        if isinstance(child, lp.Concat):
            return lp.Concat([lp.Filter(c, pred) for c in child.children()])
        if isinstance(child, lp.Join) and child.how in ("inner", "left", "right",
                                                        "semi", "anti"):
            # Split the predicate: each conjunct pushes independently to the
            # side that produces all its columns (reference:
            # rules/push_down_filter.rs splits conjuncts the same way —
            # multi-relation WHERE clauses otherwise never push).
            left, right = child.children()
            left_names = set(left.schema.column_names())
            right_names = set(right.schema.column_names())
            conjuncts: List[Expr] = []
            _flatten_and(pred, conjuncts)
            to_left, to_right, keep = [], [], []
            for c in conjuncts:
                refs = c.column_refs()
                if refs and refs <= left_names and not c.has_subquery() \
                        and child.how in ("inner", "left", "semi", "anti"):
                    to_left.append(c)
                elif refs and refs <= right_names and not (refs & left_names) \
                        and not c.has_subquery() and child.how in ("inner", "right"):
                    to_right.append(c)
                else:
                    keep.append(c)
            # Cross-relation OR conjuncts cannot move, but their side-local
            # implications can prefilter each side (kept conjunct stays for
            # exactness). Idempotent via the existing-conjunct check.
            for c in keep:
                ors: List[Expr] = []
                _flatten_or(c, ors)
                if len(ors) < 2:
                    continue
                for names, target, sink, ok in (
                        (left_names, left, to_left,
                         child.how in ("inner", "left", "semi", "anti")),
                        (right_names, right, to_right,
                         child.how in ("inner", "right"))):
                    if not ok:
                        continue
                    derived = _derive_or_side(ors, names)
                    if derived is not None and \
                            not _already_filtering(target, derived) \
                            and derived.key() not in {x.key() for x in sink}:
                        sink.append(derived)
            if not to_left and not to_right:
                return None
            new_left = lp.Filter(left, _and_all(to_left)) if to_left else left
            new_right = lp.Filter(right, _and_all(to_right)) if to_right else right
            out: lp.LogicalPlan = child.with_children([new_left, new_right])
            if keep:
                out = lp.Filter(out, _and_all(keep))
            return out
        if isinstance(child, lp.ScanSource):
            pd = child.pushdowns
            conj = []
            if pd.filters is not None:
                _flatten_and(pd.filters, conj)
            _flatten_and(pred, conj)
            seen = {}
            for c in conj:
                seen.setdefault(c.key(), c)
            combined = _and_all(list(seen.values()))
            if pd.filters is not None and combined.key() == pd.filters.key():
                return None  # nothing new — avoid a no-op rewrite loop
            return child.with_pushdowns(pd.with_changes(filters=combined))
        return None


class EliminateCrossJoin(Rule):
    """Filter(CrossJoin) with cross-side equality conjuncts → inner Join
    (reference: rules/eliminate_cross_join.rs)."""

    name = "EliminateCrossJoin"

    def rewrite(self, node):
        if not isinstance(node, lp.Filter):
            return None
        child = node.children()[0]
        if not isinstance(child, lp.Join) or child.how != "cross":
            return None
        left, right = child.children()
        left_names = set(left.schema.column_names())
        # Cross-join output renames right-side collisions; only act when the
        # sides are disjoint so predicate refs map unambiguously.
        right_names = set(right.schema.column_names())
        if left_names & right_names:
            return None
        conjuncts: List[Expr] = []

        def flatten(e: Expr):
            if isinstance(e, BinaryOp) and e.op == "and":
                flatten(e.left)
                flatten(e.right)
            else:
                conjuncts.append(e)

        flatten(node.predicate)
        left_on, right_on, rest = [], [], []
        for c in conjuncts:
            if isinstance(c, BinaryOp) and c.op == "eq":
                l_refs, r_refs = c.left.column_refs(), c.right.column_refs()
                if l_refs and r_refs:
                    if l_refs <= left_names and r_refs <= right_names:
                        left_on.append(c.left)
                        right_on.append(c.right)
                        continue
                    if l_refs <= right_names and r_refs <= left_names:
                        left_on.append(c.right)
                        right_on.append(c.left)
                        continue
            rest.append(c)
        if not left_on:
            return None
        joined = lp.Join(left, right, left_on, right_on, "inner",
                         suffix=child.suffix, prefix=child.prefix)
        if not rest:
            return joined
        pred = rest[0]
        for c in rest[1:]:
            pred = BinaryOp("and", pred, c)
        return lp.Filter(joined, pred)


class PushDownLimit(Rule):
    name = "PushDownLimit"

    def rewrite(self, node):
        if not isinstance(node, lp.Limit):
            return None
        child = node.children()[0]
        n = node.limit + node.offset
        if isinstance(child, lp.Limit):
            # Compose: inner yields [o_in, o_in+l_in); outer takes [o_out, o_out+l_out)
            # of that -> offset o_in+o_out, limit min(l_out, l_in - o_out).
            new_limit = max(0, min(node.limit, child.limit - node.offset))
            return lp.Limit(child.children()[0], new_limit, node.offset + child.offset)
        if isinstance(child, (lp.Project,)):
            return child.with_children([lp.Limit(child.children()[0], node.limit, node.offset)])
        if isinstance(child, lp.Sort):
            return lp.TopN(child.children()[0], child.sort_by, child.descending,
                           child.nulls_first, node.limit, node.offset)
        if isinstance(child, lp.ScanSource) and node.offset == 0:
            pd = child.pushdowns
            if pd.filters is None and (pd.limit is None or pd.limit > n):
                inner = child.with_pushdowns(pd.with_changes(limit=n))
                return lp.Limit(inner, node.limit, node.offset)
        return None


class DropRepartition(Rule):
    name = "DropRepartition"

    def rewrite(self, node):
        if isinstance(node, lp.Repartition):
            child = node.children()[0]
            if isinstance(child, lp.Repartition):
                return node.with_children(child.children())
        return None


class PushDownSemiAnti(Rule):
    """Push semi/anti joins toward the relation producing their keys
    (reference: rules/push_down_anti_semi_join.rs). A semi/anti join only
    filters left rows, so it commutes below projections, filters, and the
    key-owning side of inner/left joins — without this, a subquery's
    semi join runs over a fully-joined intermediate (TPC-H Q18: the
    60-order `IN` filter otherwise applies AFTER customer⋈orders⋈lineitem)."""

    name = "PushDownSemiAnti"
    top_down = True

    def rewrite(self, node):
        if not isinstance(node, lp.Join) or node.how not in ("semi", "anti"):
            return None
        left, right = node.children()
        keys = set()
        for e in node.left_on:
            keys |= e.column_refs()
        if not keys:
            return None
        if isinstance(left, lp.Project):
            mapping = {e.name(): _strip_alias(e) for e in left.exprs}
            if all(isinstance(mapping.get(k), ColumnRef) for k in keys):
                ref_map = {k: mapping[k] for k in keys}
                new_on = [_substitute(e, ref_map) for e in node.left_on]
                inner = lp.Join(left.children()[0], right, new_on,
                                list(node.right_on), node.how)
                return lp.Project(inner, left.exprs)
            return None
        # NOTE: no Filter branch here — hoisting a filter above the semi join
        # would be the exact inverse of PushDownFilter's join branch (which
        # already pushes filters below semi/anti joins) and the two rules
        # would ping-pong without converging.
        if isinstance(left, lp.Join) and left.how in ("inner", "left", "semi", "anti"):
            a, b = left.children()
            if keys <= set(a.schema.column_names()):
                new_a = lp.Join(a, right, list(node.left_on),
                                list(node.right_on), node.how)
                return left.with_children([new_a, b])
            if left.how == "inner" and keys <= set(b.schema.column_names()) \
                    and not (keys & set(a.schema.column_names())):
                new_b = lp.Join(b, right, list(node.left_on),
                                list(node.right_on), node.how)
                return left.with_children([a, new_b])
        return None


class SimplifyNullFilteredJoin(Rule):
    """Downgrade left/right/outer joins whose null-producing side is
    null-filtered above the join (reference:
    optimization/rules/simplify_null_filtered_join.rs):
    ``A LEFT JOIN B WHERE B.x > 0`` ≡ ``A INNER JOIN B WHERE B.x > 0`` —
    the padded-null rows can never pass the predicate. Unblocks
    ReorderJoins (which only touches inner joins)."""

    name = "SimplifyNullFilteredJoin"

    def rewrite(self, node):
        if not isinstance(node, lp.Filter):
            return None
        child = node.children()[0]
        if not isinstance(child, lp.Join) or child.how not in ("left", "right", "outer"):
            return None
        left, right = child.children()
        conjuncts: List[Expr] = []
        _flatten_and(node.predicate, conjuncts)
        left_cols = set(left.schema.column_names())
        # Right-side output columns may be suffixed; map back to originals.
        right_cols = set(child.schema.column_names()) - left_cols
        if child.how in ("right", "outer"):
            # Merged equi-keys are COALESCED across sides on right/outer
            # joins (executor._join_and_fix): they are non-null on padded
            # rows from either side, so predicates on them reject neither
            # side's nulls.
            merged = {l.name() for l, r in zip(child.left_on, child.right_on)
                      if isinstance(l, ColumnRef) and isinstance(r, ColumnRef)
                      and l.name() == r.name()}
            left_cols -= merged
            right_cols -= merged

        def removes_nulls_of(side_cols) -> bool:
            for c in conjuncts:
                refs = c.column_refs()
                if not refs or not (refs & side_cols):
                    continue
                if self._null_rejecting(c):
                    return True
            return False

        rejects_left = removes_nulls_of(left_cols)
        rejects_right = removes_nulls_of(right_cols)
        how = child.how
        # Rejecting RIGHT-side nulls eliminates the rows padded with right
        # nulls — the LEFT-unmatched ones — leaving matched + right-unmatched
        # (a RIGHT join); symmetrically for the left side.
        if how == "left" and rejects_right:
            how = "inner"
        elif how == "right" and rejects_left:
            how = "inner"
        elif how == "outer":
            if rejects_left and rejects_right:
                how = "inner"
            elif rejects_right:
                how = "right"
            elif rejects_left:
                how = "left"
        if how == child.how:
            return None
        new_join = lp.Join(left, right, child.left_on, child.right_on, how,
                           child.strategy, child.suffix, child.prefix)
        return lp.Filter(new_join, node.predicate)

    @staticmethod
    def _null_rejecting(c: Expr) -> bool:
        """Conservatively: does this conjunct evaluate false-or-null whenever
        its referenced columns are null? Comparisons and arithmetic propagate
        null (row dropped); not_null rejects by definition. IS NULL,
        coalesce-like kernels, and Kleene or can PASS null rows — excluded."""
        def propagating(n: Expr) -> bool:
            # Null-propagating trees only (ColumnRef / Literal / arithmetic)
            # — null-MASKING kernels (fill_null, coalesce, is_null) can turn
            # a padded-null row into a passing one.
            for sub in n.walk():
                if isinstance(sub, (ColumnRef, Literal)):
                    continue
                if isinstance(sub, BinaryOp) and sub.op in _NULL_PROPAGATING:
                    continue
                if isinstance(sub, UnaryOp) and sub.op in ("negate", "abs"):
                    continue
                return False
            return True

        if isinstance(c, UnaryOp) and c.op == "not_null":
            return propagating(c.child)
        if isinstance(c, BinaryOp) and c.op in ("eq", "ne", "lt", "le", "gt", "ge"):
            return propagating(c.left) and propagating(c.right)
        return False


class DetectMonotonicId(Rule):
    """Rewrite projections containing ``monotonically_increasing_id()`` into
    the MonotonicallyIncreasingId plan op (reference:
    optimization/rules/detect_monotonic_id.rs)."""

    name = "DetectMonotonicId"

    @staticmethod
    def _has_call(e: Expr) -> bool:
        from daft_tpu_torch.expressions.expr import FunctionCall

        return any(isinstance(n, FunctionCall)
                   and n.fn_name == "monotonically_increasing_id"
                   for n in e.walk())

    def rewrite(self, node):
        from daft_tpu_torch.expressions.expr import FunctionCall

        if not isinstance(node, lp.Project):
            return None
        if not any(self._has_call(e) for e in node.exprs):
            return None
        tmp = "__mono_id"
        child = lp.MonotonicallyIncreasingId(node.children()[0], tmp)

        def sub(n: Expr):
            if isinstance(n, FunctionCall) and \
                    n.fn_name == "monotonically_increasing_id":
                return ColumnRef(tmp)
            return None

        return lp.Project(child, [e.transform(sub) for e in node.exprs])


class EnrichWithStats(Rule):
    """Materialize parquet footer statistics into the scan's FileInfos: exact
    row counts, per-column null counts and min/max (reference:
    optimization/rules/{enrich_with_stats.rs,materialize_scans.rs}). The
    stats feed cardinality estimates (ScanSource.approx_stats), ReorderJoins'
    broadcast-side choice, PushDownAggregation's metadata-only count, and
    FilterNullJoinKey's null evidence. Pure side-table mutation: the plan
    shape never changes, so the rule engine's fixpoint is unaffected."""

    name = "EnrichWithStats"
    MAX_FOOTER_READS = 64

    def rewrite(self, node):
        if not isinstance(node, lp.ScanSource):
            return None
        info = node.scan_info
        if getattr(info, "file_format", None) != "parquet" or \
                getattr(info, "_stats_enriched", False):
            return None
        info._stats_enriched = True
        import pyarrow.parquet as pq

        from daft_tpu_torch.io.scan import resolve_filesystem

        col_stats: dict = {}
        try:
            files = info.files()
        except Exception:
            _log.debug("stats enrichment: listing files failed; skipping",
                       exc_info=True)
            return None

        def read_footer(f):
            try:
                fs, p = resolve_filesystem(f.path, info.read_options.get("io_config"))
                return f, pq.ParquetFile(fs.open_input_file(p)).metadata
            except Exception:
                # Unreadable footer: keep going without stats, but leave a
                # trace — systematic footer failures mean IO misconfig.
                _log.debug("stats enrichment: unreadable parquet footer %s",
                           getattr(f, "path", f), exc_info=True)
                return f, None

        targets = files[:self.MAX_FOOTER_READS]
        if len(targets) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(8, len(targets)),
                                    thread_name_prefix="daft-footer") as pool:
                metas = list(pool.map(read_footer, targets))
        else:
            metas = [read_footer(f) for f in targets]
        for f, meta in metas:
            if meta is None:
                continue
            f.num_rows = meta.num_rows
            for rg in range(meta.num_row_groups):
                g = meta.row_group(rg)
                for ci in range(g.num_columns):
                    c = g.column(ci)
                    path = c.path_in_schema
                    st = c.statistics
                    if "." in path:
                        # Nested leaf: leaf-level null counts don't compose
                        # into a root-column null count — mark unknown.
                        root = path.split(".", 1)[0]
                        col_stats.setdefault(
                            root, {"null_count": None, "min": None,
                                   "max": None})["null_count"] = None
                        continue
                    slot = col_stats.setdefault(
                        path, {"null_count": 0, "min": None, "max": None})
                    if st is None or st.null_count is None:
                        slot["null_count"] = None  # unknown -> never trust
                    elif slot["null_count"] is not None:
                        slot["null_count"] += st.null_count
                    if st is not None and st.has_min_max:
                        if slot["min"] is None or st.min < slot["min"]:
                            slot["min"] = st.min
                        if slot["max"] is None or st.max > slot["max"]:
                            slot["max"] = st.max
        info._column_stats = col_stats
        return None


class PushDownAggregation(Rule):
    """Global COUNT over a bare parquet scan answers from footer metadata
    (reference: optimization/rules/push_down_aggregation.rs): every file's
    exact row count is known after EnrichWithStats, so the scan (and its IO)
    disappears entirely."""

    name = "PushDownAggregation"

    def rewrite(self, node):
        from daft_tpu_torch.expressions.expr import Literal
        from daft_tpu_torch.micropartition import MicroPartition

        if not isinstance(node, lp.Aggregate) or node.group_by:
            return None
        if len(node.agg_exprs) != 1:
            return None
        agg = _strip_alias(node.agg_exprs[0])
        if not isinstance(agg, AggOp) or agg.op != "count":
            return None
        mode = agg.kwargs.get("mode", "valid") if agg.kwargs else "valid"
        child = node.children()[0]
        if not isinstance(child, lp.ScanSource):
            return None
        pd = child.pushdowns
        if pd.filters is not None or pd.limit is not None or pd.shard is not None:
            return None
        info = child.scan_info
        if not getattr(info, "_stats_enriched", False):
            return None
        files = info.files()
        if not files or any(f.num_rows is None for f in files):
            return None
        total = sum(f.num_rows for f in files)
        if mode != "all":
            # count(col): subtract the column's footer null count (exact);
            # bail if any footer lacked it.
            ref = agg.child
            if not isinstance(ref, ColumnRef):
                return None
            stats = getattr(info, "_column_stats", {}).get(ref.name())
            if mode == "valid":
                if not stats or stats["null_count"] is None:
                    return None
                total -= stats["null_count"]
            elif mode == "null":
                if not stats or stats["null_count"] is None:
                    return None
                total = stats["null_count"]
            else:
                return None
        name = node.agg_exprs[0].name()
        import numpy as np

        part = MicroPartition.from_pydict(
            {name: np.array([total], dtype=np.uint64)})
        return lp.InMemorySource([part], node.schema)


class FilterNullJoinKey(Rule):
    """Insert not-null filters on join sides whose null keys can never
    survive the join (reference: optimization/rules/filter_null_join_key.rs)
    — shrinking join inputs before the hash table is built, and giving the
    filter pushdown a predicate to carry to the scan.

    Fires only with EVIDENCE of nulls (in-memory key columns measured, or
    parquet footer null counts from EnrichWithStats): without evidence the
    inserted filter is a pure per-row cost. _already_filtering guards
    idempotence against the filter-pushdown ping-pong."""

    name = "FilterNullJoinKey"

    # sides whose null-keyed rows are always discarded
    FILTERABLE = {"inner": (0, 1), "left": (1,), "right": (0,),
                  "semi": (0, 1), "anti": (1,)}

    def rewrite(self, node):
        if not isinstance(node, lp.Join) or node.how not in self.FILTERABLE:
            return None
        sides = [node.children()[0], node.children()[1]]
        keys = [node.left_on, node.right_on]
        changed = False
        for i in self.FILTERABLE[node.how]:
            preds = []
            for k in keys[i]:
                if not isinstance(k, ColumnRef):
                    continue
                nn = UnaryOp("not_null", k)
                if _already_filtering(sides[i], nn):
                    continue
                if self._may_have_nulls(sides[i], k.name()):
                    preds.append(nn)
            if preds:
                sides[i] = lp.Filter(sides[i], _and_all(preds))
                changed = True
        if not changed:
            return None
        return node.with_children(sides)

    @staticmethod
    def _may_have_nulls(side, col: str) -> bool:
        """True only with positive evidence of nulls in `col`."""
        node = side
        while isinstance(node, (lp.Filter, lp.Sort, lp.Limit)):
            node = node.children()[0]
        if isinstance(node, lp.Project):
            mapping = {p.name(): _strip_alias(p) for p in node.exprs}
            m = mapping.get(col)
            if not isinstance(m, ColumnRef):
                return False
            return FilterNullJoinKey._may_have_nulls(node.children()[0], m.name())
        if isinstance(node, lp.InMemorySource):
            cache = getattr(node, "_nullcount_cache", None)
            if cache is None:
                cache = node._nullcount_cache = {}
            if col not in cache:
                n = 0
                try:
                    # Per-batch null_count is O(1) arrow metadata — never
                    # combined() here (a full concat per optimizer pass).
                    for part in node.partitions:
                        for rb in part.record_batches():
                            n += rb.get_column(col).null_count()
                except Exception:
                    _log.debug("null-count measurement for %r failed; "
                               "assuming none", col, exc_info=True)
                    n = 0
                cache[col] = n
            return cache[col] > 0
        if isinstance(node, lp.ScanSource):
            stats = getattr(node.scan_info, "_column_stats", {}).get(col)
            return bool(stats and stats.get("null_count"))
        return False


class PushDownProjection(Rule):
    """Column pruning: intersect each scan's columns with what the plan above
    actually reads (reference: rules/push_down_projection.rs)."""

    name = "PushDownProjection"

    def rewrite(self, node):
        # Run once from the root: the rule engine calls us at every node, but
        # we only act at the root-most call per pass by pruning scans reachable
        # without passing another pruning barrier. Simplest correct approach:
        # apply locally — Project directly above a ScanSource prunes it.
        if isinstance(node, (lp.Project, lp.UDFProject, lp.Aggregate, lp.Filter, lp.Explode)):
            child = node.children()[0]
            required = self._required_columns(node)
            if required is None:
                return None
            target = child
            # Walk through pass-through nodes that don't change the column set.
            passthrough: List[lp.LogicalPlan] = []
            while isinstance(target, (lp.Filter, lp.Sort, lp.Limit, lp.Sample, lp.Repartition)):
                if isinstance(target, lp.Filter):
                    required = required | target.predicate.column_refs()
                if isinstance(target, lp.Sort):
                    for e in target.sort_by:
                        required = required | e.column_refs()
                passthrough.append(target)
                target = target.children()[0]
            if isinstance(target, lp.ScanSource):
                current = target.pushdowns.columns
                schema_names = [f.name for f in target.schema]
                wanted = tuple(n for n in schema_names if n in required)
                if wanted and current != wanted and set(wanted) < set(schema_names):
                    new_scan = target.with_pushdowns(target.pushdowns.with_changes(columns=wanted))
                    rebuilt: lp.LogicalPlan = new_scan
                    for p in reversed(passthrough):
                        rebuilt = p.with_children([rebuilt])
                    return node.with_children([rebuilt])
        return None

    @staticmethod
    def _required_columns(node) -> Optional[set]:
        req: set = set()
        if isinstance(node, lp.Project):
            for e in node.exprs:
                req |= e.column_refs()
        elif isinstance(node, lp.UDFProject):
            req |= node.udf_expr.column_refs()
            for e in node.passthrough:
                req |= e.column_refs()
        elif isinstance(node, lp.Aggregate):
            for e in node.agg_exprs + node.group_by:
                req |= e.column_refs()
        elif isinstance(node, lp.Filter):
            return None  # handled when walking from a projecting ancestor
        elif isinstance(node, lp.Explode):
            return None
        return req


# ---------------------------------------------------------------------- #
def _flatten_and(e: Expr, out: List[Expr]) -> None:
    if isinstance(e, BinaryOp) and e.op == "and":
        _flatten_and(e.left, out)
        _flatten_and(e.right, out)
    else:
        out.append(e)


def _and_all(conjuncts: Sequence[Expr]) -> Expr:
    pred = conjuncts[0]
    for c in conjuncts[1:]:
        pred = BinaryOp("and", pred, c)
    return pred


def _flatten_or(e: Expr, out: List[Expr]) -> None:
    if isinstance(e, BinaryOp) and e.op == "or":
        _flatten_or(e.left, out)
        _flatten_or(e.right, out)
    else:
        out.append(e)


def _derive_or_side(disjuncts: Sequence[Expr], names: set) -> Optional[Expr]:
    """Side-local implication of an OR-of-ANDs: when EVERY disjunct carries
    at least one conjunct entirely over `names`, the OR of those per-disjunct
    parts is implied by the whole predicate and can prefilter that side
    (reference: the optimizer's filter derivation for multi-relation
    disjunctions — TPC-H Q7/Q19's cross-relation ORs are unpushable
    otherwise)."""
    parts: List[Expr] = []
    for d in disjuncts:
        conj: List[Expr] = []
        _flatten_and(d, conj)
        side = [x for x in conj if x.column_refs() and x.column_refs() <= names
                and not x.has_subquery() and not x.has_udf()]
        if not side:
            return None
        parts.append(_and_all(side))
    out = parts[0]
    for p in parts[1:]:
        out = BinaryOp("or", out, p)
    return out


def _already_filtering(side, expr: Expr) -> bool:
    """Is `expr` (or its pushed-down image) already filtering `side`?
    Follows the same descent PushDownFilter uses — through Filters, Projects
    (with substitution), Sorts — so OR-derivation stays idempotent across
    passes even after the derived filter has been pushed to a leaf."""
    node, e = side, expr
    while True:
        if isinstance(node, lp.Filter):
            conj: List[Expr] = []
            _flatten_and(node.predicate, conj)
            if e.key() in {c.key() for c in conj}:
                return True
            node = node.children()[0]
            continue
        if isinstance(node, lp.Project):
            mapping = {p.name(): _strip_alias(p) for p in node.exprs}
            try:
                e = _substitute(e, mapping)
            except (DaftError, KeyError, TypeError, NotImplementedError):
                return False  # unmappable through the project: not filtered
            node = node.children()[0]
            continue
        if isinstance(node, (lp.Sort, lp.Repartition)):
            node = node.children()[0]
            continue
        if isinstance(node, lp.Concat):
            # Pushdown distributes a filter into every branch.
            return all(_already_filtering(c, e) for c in node.children())
        if isinstance(node, lp.Join):
            # A pushed filter lands on whichever join side owns its columns —
            # follow the same routing or the check misses it and derivation
            # re-fires every pass on nested-join sides.
            refs = e.column_refs()
            for side_node in node.children():
                if refs and refs <= set(side_node.schema.column_names()):
                    node = side_node
                    break
            else:
                return False
            continue
        if isinstance(node, lp.ScanSource) and node.pushdowns.filters is not None:
            conj = []
            _flatten_and(node.pushdowns.filters, conj)
            return e.key() in {c.key() for c in conj}
        return False


class UnnestSubqueries(Rule):
    """Rewrite IN/EXISTS/scalar subqueries in filters into joins.

    Reference: src/daft-logical-plan/src/optimization/rules/unnest_subquery.rs —
    EXISTS/IN become semi/anti joins keyed on the correlated equalities (or a
    constant key when uncorrelated); scalar subqueries become a cross join of
    the single-row result (uncorrelated) or a grouped aggregate left-joined on
    the correlation keys (correlated).

    NOTE on NOT IN: SQL three-valued logic makes ``x NOT IN (subquery)``
    reject every row when the subquery yields any NULL. Like most pragmatic
    engines we lower to an anti join over the non-null subquery values.
    """

    name = "UnnestSubqueries"

    def rewrite(self, node):
        if not isinstance(node, lp.Filter) or not node.predicate.has_subquery():
            return None
        base = node.children()[0]
        original_cols = [f.name for f in base.schema]
        conjuncts: List[Expr] = []
        _flatten_and(node.predicate, conjuncts)
        # Plain conjuncts filter the base BEFORE any subquery join: the
        # row-id technique wraps base in MonotonicallyIncreasingId, which
        # blocks later filter pushdown, so filtering afterwards would run
        # the semi/anti matching over the full unfiltered input.
        plain = [c for c in conjuncts if not c.has_subquery()]
        conjuncts = [c for c in conjuncts if c.has_subquery()]
        if plain:
            base = lp.Filter(base, _and_all(plain))
        remaining: List[Expr] = []
        self._counter = 0
        for c in conjuncts:
            inner_c, neg = c, False
            while isinstance(inner_c, UnaryOp) and inner_c.op == "not":
                neg = not neg
                inner_c = inner_c.child
            if isinstance(inner_c, Exists):
                base = self._semi_anti(base, inner_c.plan, inner_c.corr,
                                       None, None, inner_c.negated ^ neg,
                                       inner_c.extra)
                continue
            if isinstance(inner_c, InSubquery):
                base = self._semi_anti(base, inner_c.plan, inner_c.corr,
                                       inner_c.child, inner_c.value,
                                       inner_c.negated ^ neg, inner_c.extra)
                continue
            if c.has_subquery():
                c, base = self._rewrite_scalars(c, base)
            remaining.append(c)
        out = base
        if remaining:
            out = lp.Filter(out, _and_all(remaining))
        if [f.name for f in out.schema] != original_cols:
            out = lp.Project(out, [ColumnRef(n) for n in original_cols])
        return out

    def _uniq(self, stem: str) -> str:
        self._counter += 1
        return f"__sq{self._counter}_{stem}"

    def _semi_anti(self, base, plan, corr, in_child, in_value, negated, extra=()):
        """EXISTS / IN → semi (anti when negated) join on the correlation
        equalities plus, for IN, value-column equality; uncorrelated EXISTS
        joins on a constant key. Non-equi correlated predicates (``extra``)
        use the row-id technique: tag outer rows, inner-join on the equi
        keys, filter the non-equi predicates, then semi/anti join the outer
        side against the surviving row ids."""
        left_on: List[Expr] = []
        proj: List[Expr] = []
        right_on: List[Expr] = []
        if in_value is not None:
            v = self._uniq("v")
            proj.append(Alias(in_value, v))
            left_on.append(in_child)
            right_on.append(ColumnRef(v))
        for j, (outer_e, inner_e) in enumerate(corr):
            k = self._uniq(f"k{j}")
            proj.append(Alias(inner_e, k))
            left_on.append(outer_e)
            right_on.append(ColumnRef(k))
        if extra:
            rewritten = self._ne_exists_via_agg(base, plan, corr, in_value,
                                                left_on, proj, right_on,
                                                negated, extra)
            if rewritten is not None:
                return rewritten
            # Inner columns referenced by the non-equi predicates travel
            # through the join under their reserved __in_<name> aliases.
            inner_refs = sorted({ref[5:] for e in extra for ref in e.column_refs()
                                 if ref.startswith("__in_")})
            proj.extend(Alias(ColumnRef(r), f"__in_{r}") for r in inner_refs)
            rowid = self._uniq("rowid")
            base_id = lp.MonotonicallyIncreasingId(base, rowid)
            # The matching join only needs the row id, the equi keys, and the
            # outer columns the extra predicates read — never the full base
            # row (wide payload columns would be duplicated per inner match).
            needed = {rowid}
            for e in left_on:
                needed |= e.column_refs()
            for e in extra:
                needed |= {r for r in e.column_refs() if not r.startswith("__in_")}
            narrow = lp.Project(base_id, [ColumnRef(n) for n in sorted(needed)
                                          if n in base_id.schema])
            right = lp.Project(plan, proj)
            if left_on:
                joined = lp.Join(narrow, right, left_on, right_on, "inner")
            else:
                joined = lp.Join(narrow, right, [], [], "cross")
            matched = lp.Filter(joined, _and_all(list(extra)))
            return lp.Join(base_id, matched, [ColumnRef(rowid)], [ColumnRef(rowid)],
                           "anti" if negated else "semi")
        return self._semi_anti_tail(base, plan, proj, left_on, right_on,
                                    in_value, negated)

    def _ne_exists_via_agg(self, base, plan, corr, in_value, left_on, proj,
                           right_on, negated, extra):
        """Decorrelate ``EXISTS(inner WHERE corr-equi AND inner.X <> outer.Y)``
        WITHOUT the row-id self-join: per correlation group, a row with
        ``X <> Y`` exists iff the group has ≥2 distinct X values
        (``min(X) != max(X)``) or its single value differs from Y. So one
        grouped min/max aggregate + a left join replaces tagging every outer
        row, inner-joining the full inner relation, and semi-joining back —
        on TPC-H q21 that was two 6M×6M lineitem self-joins.

        Applies only to the single-predicate ``<>`` shape (multi-predicate
        conjunctions need a simultaneous witness row; they keep the general
        row-id path). Null semantics check out: Y null ⇒ EXISTS false (flag
        gated on not_null(Y)); empty/all-null group ⇒ min null ⇒ false; the
        negated flag is exactly NOT EXISTS for each of those cases.

        Returns the rewritten plan, or None when the shape doesn't match.
        """
        if in_value is not None or not corr or len(extra) != 1:
            return None
        e = extra[0]
        if not (isinstance(e, BinaryOp) and e.op == "ne"):
            return None
        sides = [e.left, e.right]
        inner_side = [s for s in sides if isinstance(s, ColumnRef)
                      and s.name().startswith("__in_")]
        outer_side = [s for s in sides if not any(
            r.startswith("__in_") for r in s.column_refs())]
        if len(inner_side) != 1 or len(outer_side) != 1:
            return None
        x = inner_side[0].name()[5:]
        outer_y = outer_side[0]
        if x not in plan.schema:
            return None
        xv = self._uniq("x")
        mn, mx = self._uniq("mn"), self._uniq("mx")
        inner = lp.Project(plan, list(proj) + [Alias(ColumnRef(x), xv)])
        agg = lp.Aggregate(inner,
                           [Alias(AggOp("min", ColumnRef(xv)), mn),
                            Alias(AggOp("max", ColumnRef(xv)), mx)],
                           [ColumnRef(p.name()) for p in proj])
        joined = lp.Join(base, agg, list(left_on), list(right_on), "left")
        flag: Expr = BinaryOp(
            "and",
            BinaryOp("and", UnaryOp("not_null", outer_y),
                     UnaryOp("not_null", ColumnRef(mn))),
            BinaryOp("or", BinaryOp("ne", ColumnRef(mn), ColumnRef(mx)),
                     BinaryOp("ne", ColumnRef(mn), outer_y)))
        if negated:
            flag = UnaryOp("not", flag)
        return lp.Filter(joined, flag)

    def _semi_anti_tail(self, base, plan, proj, left_on, right_on, in_value,
                        negated):
        if not proj:  # uncorrelated EXISTS
            one = self._uniq("one")
            proj.append(Alias(Literal(1), one))
            left_on.append(Literal(1))
            right_on.append(ColumnRef(one))
        right = lp.Project(plan, proj)
        if negated and in_value is not None:
            # Pragmatic NOT IN: drop NULL subquery values (see class note).
            right = lp.Filter(right, UnaryOp("not_null", right_on[0]))
        how = "anti" if negated else "semi"
        return lp.Join(base, right, left_on, right_on, how)

    def _rewrite_scalars(self, c: Expr, base):
        """Replace subquery nodes that appear INSIDE a larger predicate (e.g.
        under OR): scalar Subquery becomes a joined-in column; InSubquery /
        Exists become boolean membership columns via a deduplicated left
        join whose match flag is null for non-members."""

        def rw(n: Expr):
            nonlocal base
            if isinstance(n, (InSubquery, Exists)):
                if n.extra:
                    from daft_tpu_torch.errors import DaftPlanError

                    raise DaftPlanError(
                        "IN/EXISTS with non-equi correlation is only supported "
                        "as a top-level AND conjunct of a filter")
                flag = self._uniq("flag")
                left_on: List[Expr] = []
                keys: List[Expr] = []
                if isinstance(n, InSubquery):
                    left_on.append(n.child)
                    keys.append(Alias(n.value, self._uniq("v")))
                for j, (outer_e, inner_e) in enumerate(n.corr):
                    left_on.append(outer_e)
                    keys.append(Alias(inner_e, self._uniq(f"k{j}")))
                if not keys:  # uncorrelated EXISTS
                    left_on.append(Literal(1))
                    keys.append(Alias(Literal(1), self._uniq("one")))
                dedup = lp.Distinct(lp.Project(n.plan, keys))
                right = lp.Project(
                    dedup,
                    [ColumnRef(k.name()) for k in keys] + [Alias(Literal(True), flag)])
                base = lp.Join(base, right, left_on,
                               [ColumnRef(k.name()) for k in keys], "left")
                matched: Expr = UnaryOp("not_null", ColumnRef(flag))
                return UnaryOp("not", matched) if n.negated else matched
            if not isinstance(n, Subquery):
                return None
            name = self._uniq("val")
            if n.corr:
                group_by = [inner for _, inner in n.corr]
                agg = lp.Aggregate(n.plan, [Alias(n.value, name)], group_by)
                keys = []
                proj = []
                for j, g in enumerate(group_by):
                    k = self._uniq(f"gk{j}")
                    proj.append(Alias(ColumnRef(g.name()), k))
                    keys.append(ColumnRef(k))
                proj.append(ColumnRef(name))
                right = lp.Project(agg, proj)
                base = lp.Join(base, right, [o for o, _ in n.corr], keys, "left")
            else:
                if n.value.has_agg():
                    right = lp.Aggregate(n.plan, [Alias(n.value, name)], [])
                else:
                    right = lp.Limit(lp.Project(n.plan, [Alias(n.value, name)]), 1, 0)
                base = lp.Join(base, right, [], [], "cross")
            return ColumnRef(name)

        return c.transform(rw), base


# ---------------------------------------------------------------------- #
class ReorderJoins(Rule):
    """Cost-based join reordering over chains of inner equi-joins.

    Reference: src/daft-logical-plan/src/optimization/rules/reorder_joins/ —
    the reference enumerates join orders with DP-CCP over a join hypergraph
    enriched with stats. Here: collect the maximal region of inner
    ColumnRef-equi-joins, estimate relation cardinalities via approx_stats,
    run DP over connected subsets (exact for <= 10 relations), and rebuild
    the cheapest tree. The output column set is restored with a Project.

    Only fires when every non-key output column name is unique across
    relations, so reordering cannot change suffix-renaming semantics.
    """

    name = "ReorderJoins"
    top_down = True  # fire at the TOPMOST join so the region is maximal
    MAX_RELATIONS = 10

    def __init__(self, cfg=None):
        self.cfg = cfg

    def rewrite(self, node):
        if not isinstance(node, lp.Join) or not self._reorderable(node):
            return None
        if getattr(node, "_reordered", False):
            return None
        # Collect the join region: relations (non-join leaves) + edges.
        relations: List[lp.LogicalPlan] = []
        edges: List[tuple] = []  # (left_rel_idx, right_rel_idx, left_expr, right_expr)

        def collect(j) -> None:
            for side in j.children():
                if self._reorderable(side) and isinstance(side, lp.Join):
                    collect(side)
                else:
                    relations.append(side)

        def owner(e: Expr, rels_cols) -> Optional[int]:
            refs = e.column_refs()
            if not refs:
                return None
            for i, cols in enumerate(rels_cols):
                if refs <= cols:
                    return i
            return None

        collect(node)
        if not (2 < len(relations) <= self.MAX_RELATIONS):
            return None
        rels_cols = [set(r.schema.column_names()) for r in relations]
        # Names must be unambiguous: every column name owned by one relation.
        all_names: dict = {}
        for i, cols in enumerate(rels_cols):
            for n in cols:
                all_names.setdefault(n, []).append(i)
        shared = {n for n, owners in all_names.items() if len(owners) > 1}

        def collect_edges(j) -> bool:
            ok = True
            for side in j.children():
                if self._reorderable(side) and isinstance(side, lp.Join):
                    ok = ok and collect_edges(side)
            for l, r in zip(j.left_on, j.right_on):
                li, ri = owner(l, rels_cols), owner(r, rels_cols)
                if li is None or ri is None or li == ri:
                    return False
                # Shared names are only tolerable as merged equi-keys.
                if (l.column_refs() | r.column_refs()) & shared:
                    if not (isinstance(l, ColumnRef) and isinstance(r, ColumnRef)
                            and l.name_ == r.name_):
                        return False
                edges.append((li, ri, l, r))
            return True

        if not collect_edges(node):
            return None
        non_key_shared = shared - {
            l.name_ for _, _, l, r in edges
            if isinstance(l, ColumnRef) and isinstance(r, ColumnRef) and l.name_ == r.name_
        }
        if non_key_shared:
            return None

        order = self._dp_order(relations, edges)
        if order is None:
            return None
        new_plan = self._build(order, relations, edges)
        if new_plan is None:
            return None
        try:
            out_names = [f.name for f in node.schema]
            if set(out_names) - set(new_plan.schema.column_names()):
                return None
            rebuilt = lp.Project(new_plan, [ColumnRef(n) for n in out_names])
        except Exception:
            _log.debug("join reorder: output projection rebuild failed; "
                       "keeping original order", exc_info=True)
            return None
        if self._tree_shape(rebuilt) == self._tree_shape(node):
            return None
        return rebuilt

    @staticmethod
    def _reorderable(n) -> bool:
        return (isinstance(n, lp.Join) and n.how == "inner"
                and n.strategy in (None, "auto")
                and all(e.column_refs() and not e.has_udf() and not e.has_subquery()
                        for e in list(n.left_on) + list(n.right_on)))

    @staticmethod
    def _tree_shape(n) -> tuple:
        if isinstance(n, lp.Join):
            return ("J", ReorderJoins._tree_shape(n.children()[0]),
                    ReorderJoins._tree_shape(n.children()[1]))
        if isinstance(n, lp.Project):
            return ReorderJoins._tree_shape(n.children()[0])
        return ("R", id(n))

    @staticmethod
    def _ndv(rel, exprs) -> Optional[float]:
        """Actual number-of-distinct-values of a join key (single column or
        composite tuple) when the relation's data is already in memory
        (reference: EnrichWithStats feeding the join-order cost model).
        Low-cardinality keys (e.g. nationkey) are exactly where the
        rows-as-NDV proxy causes catastrophic orders. Measured on the BASE
        source beneath any filters: the System-R containment formula wants
        the key space, while filter effects enter through the row counts."""
        if not all(isinstance(e, ColumnRef) for e in exprs):
            return None
        while isinstance(rel, lp.Filter):
            rel = rel.children()[0]
        if not isinstance(rel, lp.InMemorySource):
            return None
        # Memoize on the source NODE: DataFrames keep their InMemorySource
        # alive across queries, so a workload touching the same table many
        # times (e.g. a TPC-H suite) measures each key space once.
        key = tuple(e.name_ for e in exprs)
        cache = getattr(rel, "_ndv_cache", None)
        if cache is None:
            cache = rel._ndv_cache = {}
        if key in cache:
            return cache[key]
        cache[key] = out = ReorderJoins._ndv_measure(rel, exprs)
        return out

    @staticmethod
    def _ndv_measure(rel, exprs) -> Optional[float]:
        total_rows = sum(len(p) for p in rel.partitions)
        if total_rows == 0 or total_rows > 5_000_000:
            return None
        try:
            import pyarrow as pa
            import pyarrow.compute as pc

            names = [e.name_ for e in exprs]
            if len(names) == 1:
                chunks = [p.combined().get_column(names[0]).to_arrow()
                          for p in rel.partitions]
                return float(pc.count_distinct(pa.chunked_array(chunks)).as_py())
            tables = [pa.table({n: p.combined().get_column(n).to_arrow()
                                for n in names}) for p in rel.partitions]
            combined = pa.concat_tables(tables)
            return float(combined.group_by(names).aggregate([]).num_rows)
        except Exception:
            _log.debug("NDV measurement failed; falling back to row-count "
                       "proxy", exc_info=True)
            return None

    def _dp_order(self, relations, edges):
        """DP over connected subsets (DP-CCP style): best[mask] = (cost, rows,
        plan_desc). Returns a nested tuple describing the join tree."""
        n = len(relations)
        rows = [max(r.approx_stats().num_rows, 1.0) for r in relations]
        ndv_cache: dict = {}

        def ndv(idx, exprs):
            key = (idx, tuple(e.key() for e in exprs))
            if key not in ndv_cache:
                ndv_cache[key] = self._ndv(relations[idx], exprs)
            return ndv_cache[key]
        # Connectivity + per-pair selectivity from edges. Each equi-key pair
        # contributes 1/max(distinct) ~ 1/max(rows) of the smaller side —
        # without NDV stats, use the standard |L||R|/max(|L|,|R|) estimate
        # per edge between the two sides.
        best: dict = {}
        for i in range(n):
            best[1 << i] = (0.0, rows[i], i)

        def join_sel(mask_a, mask_b):
            # System-R: |L||R| / max(V(L,a), V(R,b)) — but edges between the
            # SAME relation pair form one composite key, so their NDVs
            # multiply per side and cap at that side's cardinality (naive
            # per-edge independence estimated lineitem⋈partsupp on
            # (suppkey, partkey) at ~0.04% of its true size, inverting the
            # whole TPC-H Q9 join order). Distinct relation pairs still
            # multiply independently.
            groups: dict = {}
            for li, ri, le, re_ in edges:
                if ((mask_a >> li) & 1 and (mask_b >> ri) & 1) or \
                   ((mask_b >> li) & 1 and (mask_a >> ri) & 1):
                    groups.setdefault((li, ri), []).append((le, re_))
            if not groups:
                return None
            sel = 1.0
            for (li, ri), pairs in groups.items():
                # Key space per side: measured NDV (composite measured as a
                # tuple — per-column independence overestimates FK pair
                # spaces by orders of magnitude). Sides without measurable
                # data contribute nothing; with no measurement at all, fall
                # back to the smaller side's cardinality (exact for FK→PK).
                vl = ndv(li, [p[0] for p in pairs])
                vr = ndv(ri, [p[1] for p in pairs])
                known = [v for v in (vl, vr) if v]
                v = max(known) if known else min(rows[li], rows[ri])
                sel *= 1.0 / max(v, 1.0)
            return sel

        full = (1 << n) - 1
        # Enumerate subsets by popcount so splits are ready.
        masks = sorted(range(1, full + 1), key=lambda m: bin(m).count("1"))
        for mask in masks:
            if mask in best and bin(mask).count("1") == 1:
                continue
            entry = None
            sub = (mask - 1) & mask
            while sub:
                other = mask ^ sub
                if sub > other:  # visit each unordered split once
                    sub = (sub - 1) & mask
                    continue
                a, b = sub, other
                if a in best and b in best:
                    sel = join_sel(a, b)
                    if sel is not None:
                        ca, ra, pa = best[a]
                        cb, rb, pb = best[b]
                        out_rows = max(ra * rb * sel, 1.0)
                        # cost: intermediate rows produced + build-side size
                        cost = ca + cb + out_rows + min(ra, rb)
                        if entry is None or cost < entry[0]:
                            # build on the smaller side: right = build
                            plan = (pa, pb) if ra >= rb else (pb, pa)
                            entry = (cost, out_rows, plan)
                sub = (sub - 1) & mask
            if entry is not None:
                best[mask] = entry
        if full not in best:
            return None
        return best[full][2]

    def _build(self, desc, relations, edges):
        """Materialise the DP tree description into Join nodes."""
        if isinstance(desc, int):
            return relations[desc]
        left = self._build(desc[0], relations, edges)
        right = self._build(desc[1], relations, edges)
        if left is None or right is None:
            return None
        left_cols = set(left.schema.column_names())
        right_cols = set(right.schema.column_names())
        left_on, right_on = [], []
        for li, ri, le, re_ in edges:
            if le.column_refs() <= left_cols and re_.column_refs() <= right_cols:
                left_on.append(le)
                right_on.append(re_)
            elif re_.column_refs() <= left_cols and le.column_refs() <= right_cols:
                left_on.append(re_)
                right_on.append(le)
        if not left_on:
            return None
        try:
            j = lp.Join(left, right, left_on, right_on, "inner")
            j._reordered = True  # don't re-enumerate subtrees of a DP result
            return j
        except Exception:
            _log.debug("join reorder: Join construction failed; keeping "
                       "original order", exc_info=True)
            return None


# ---------------------------------------------------------------------- #
# Column pruning through joins and in-memory sources                      #
# ---------------------------------------------------------------------- #
def prune_columns(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    """Top-down required-column analysis that inserts narrowing Projects on
    join inputs and above in-memory sources (reference: the column-pruning
    side of rules/push_down_projection.rs; scan pruning itself is handled by
    PushDownProjection's pushdown path).

    Join collision renaming depends on which names exist on BOTH sides, so a
    pruned side keeps any (otherwise-unused) column whose name collides with
    a kept column on the other side — output names never change."""

    def all_names(n: lp.LogicalPlan) -> set:
        return set(n.schema.column_names())

    def narrow(child: lp.LogicalPlan, keep: set) -> lp.LogicalPlan:
        names = child.schema.column_names()
        wanted = [c for c in names if c in keep]
        if len(wanted) == len(names) or not wanted:
            return rec(child, set(names))
        pruned = rec(child, set(wanted))
        if set(pruned.schema.column_names()) == set(wanted):
            return pruned
        return lp.Project(pruned, [ColumnRef(c) for c in wanted])

    def refs(exprs) -> set:
        out: set = set()
        for e in exprs:
            out |= e.column_refs()
        return out

    def rec(node: lp.LogicalPlan, required: set) -> lp.LogicalPlan:
        if isinstance(node, lp.Join) and node.how != "cross":
            left, right = node.children()
            lnames, rnames = all_names(left), all_names(right)
            lkeys, rkeys = refs(node.left_on), refs(node.right_on)
            lreq = (required & lnames) | (lkeys & lnames)
            # Map join-output names back to right-side input names.
            rreq = set(rkeys)
            for f in right.schema:
                out_name = (f"{node.prefix}{node.suffix}{f.name}"
                            if f.name in lnames else f.name)
                if out_name in required or f.name in required:
                    rreq.add(f.name)
            if node.how in ("semi", "anti"):
                rreq = rkeys & rnames
            # Preserve collision-driven renames: a kept right column keeps
            # its suffixed name only while the left column exists (and vice
            # versa for the un-suffixed name staying unambiguous).
            lreq |= {c for c in rreq if c in lnames}
            rreq |= {c for c in lreq if c in rnames} if node.how not in ("semi", "anti") else set()
            new_left = narrow(left, lreq)
            new_right = narrow(right, rreq)
            if new_left is left and new_right is right:
                return node
            return node.with_children([new_left, new_right])
        if isinstance(node, lp.InMemorySource):
            return node  # narrowed by the caller via narrow()
        if isinstance(node, lp.Project):
            child = node.children()[0]
            new_child = narrow(child, refs(node.exprs))
            return node if new_child is child else node.with_children([new_child])
        if isinstance(node, lp.UDFProject):
            child = node.children()[0]
            need = refs([node.udf_expr]) | refs(node.passthrough)
            new_child = narrow(child, need)
            return node if new_child is child else node.with_children([new_child])
        if isinstance(node, lp.Aggregate):
            child = node.children()[0]
            new_child = narrow(child, refs(node.agg_exprs) | refs(node.group_by))
            return node if new_child is child else node.with_children([new_child])
        if isinstance(node, lp.Filter):
            child = node.children()[0]
            new_child = rec(child, required | node.predicate.column_refs())
            return node if new_child is child else node.with_children([new_child])
        if isinstance(node, (lp.Sort, lp.TopN)):
            child = node.children()[0]
            new_child = rec(child, required | refs(node.sort_by))
            return node if new_child is child else node.with_children([new_child])
        if isinstance(node, (lp.Limit, lp.Sample, lp.Distinct)):
            child = node.children()[0]
            new_child = rec(child, required)
            return node if new_child is child else node.with_children([new_child])
        if isinstance(node, lp.Repartition):
            child = node.children()[0]
            new_child = rec(child, required | refs(getattr(node, "partition_by", []) or []))
            return node if new_child is child else node.with_children([new_child])
        if isinstance(node, (lp.Concat, lp.Intersect, lp.Except)):
            new_children = [rec(c, set(c.schema.column_names())) for c in node.children()]
            if all(a is b for a, b in zip(new_children, node.children())):
                return node
            return node.with_children(new_children)
        # Conservative default (Explode/Unpivot/Window/Pivot/AsofJoin/Sink/...):
        # children keep their full column sets, but keep descending so joins
        # below still benefit.
        new_children = [rec(c, set(c.schema.column_names())) for c in node.children()]
        if all(a is b for a, b in zip(new_children, node.children())):
            return node
        return node.with_children(new_children)

    return rec(plan, set(plan.schema.column_names()))
