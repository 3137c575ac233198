"""Logical plan optimizer (port of ``daft_tpu/logical/optimizer.py``).

Reference: src/daft-logical-plan/src/optimization/optimizer.rs:127-280 — an
ordered list of rule batches, each run to fixed point. The port has these
rules, in the JAX package's batch order:

* SplitUDFs — isolates UDF calls into UDFProject nodes so the executor runs
  them in their own operator (reference: rules/split_udfs.rs);
* PushDownFilter, in both of its batches — merges stacked filters, moves a
  filter through projections (substituting the projected expressions), past
  sorts, into both sides of a concat, into the join sides that own its
  conjuncts (with the side-local implications of cross-side ORs), and into
  a scan's pushdowns, where hive partitions prune files (reference:
  rules/push_down_filter.rs);
* PushDownLimit — composes limits, moves a limit below a projection, fuses a
  sort with the limit above it into a TopN, and sets a scan's limit
  pushdown when no filter is pushed into it (reference:
  rules/push_down_limit.rs);
* PushDownProjection — prunes a scan's columns to what the plan above it
  reads (reference: rules/push_down_projection.rs).

The node types the port lacks (``Sample``, ``Repartition``, ``Shard``,
``Explode``) are left out of the rules' type lists (A.3.5 / A.8). Not ported
yet (A.3.3): SimplifyExpressions, UnnestSubqueries, DetectMonotonicId,
PushDownSemiAnti, PushDownShard, DropRepartition, EnrichWithStats,
PushDownAggregation, FilterNullJoinKey, ReorderJoins, SimplifyNullFilteredJoin,
EliminateCrossJoin and the final column pruning. A join therefore builds on
the right side as the user wrote it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from daft_tpu_torch.errors import DaftError
from daft_tpu_torch.expressions.expr import Alias, BinaryOp, ColumnRef, Expr, UdfCall
from daft_tpu_torch.logical import plan as lp


class Rule:
    name = "rule"

    def rewrite(self, node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
        """Return a replacement for this node, or None to keep it."""
        raise NotImplementedError


def _rewrite_bottom_up(node: lp.LogicalPlan, rule: Rule) -> lp.LogicalPlan:
    new_children = [_rewrite_bottom_up(c, rule) for c in node.children()]
    if any(a is not b for a, b in zip(new_children, node.children())):
        node = node.with_children(new_children)
    replaced = rule.rewrite(node)
    return replaced if replaced is not None else node


class Optimizer:
    MAX_PASSES = 24

    def __init__(self):
        self.batches: List[List[Rule]] = [
            [SplitUDFs()],
            [PushDownFilter()],
            [PushDownLimit()],
            [PushDownFilter()],
            [PushDownProjection()],
        ]

    def optimize(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        for batch in self.batches:
            for _ in range(self.MAX_PASSES):
                changed = False
                for rule in batch:
                    new_plan = _rewrite_bottom_up(plan, rule)
                    if new_plan is not plan:
                        plan = new_plan
                        changed = True
                if not changed:
                    break
        return plan


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


class PushDownLimit(Rule):
    name = "PushDownLimit"

    def rewrite(self, node):
        if not isinstance(node, lp.Limit):
            return None
        child = node.children()[0]
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
            n = node.limit + node.offset
            pd = child.pushdowns
            if pd.filters is None and (pd.limit is None or pd.limit > n):
                inner = child.with_pushdowns(pd.with_changes(limit=n))
                return lp.Limit(inner, node.limit, node.offset)
        return None


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
        if isinstance(child, lp.Sort):
            grand = child.children()[0]
            if all(n in grand.schema for n in pred.column_refs()):
                return child.with_children([lp.Filter(grand, pred)])
        if isinstance(child, lp.Concat):
            return lp.Concat([lp.Filter(c, pred) for c in child.children()])
        if isinstance(child, lp.Join) and child.how in ("inner", "left", "right",
                                                        "semi", "anti"):
            # Split the predicate: each conjunct pushes independently to the
            # side that produces all its columns (reference:
            # rules/push_down_filter.rs splits conjuncts the same way).
            left, right = child.children()
            left_names = set(left.schema.column_names())
            right_names = set(right.schema.column_names())
            conjuncts: List[Expr] = []
            _flatten_and(pred, conjuncts)
            to_left, to_right, keep = [], [], []
            for c in conjuncts:
                refs = c.column_refs()
                if refs and refs <= left_names \
                        and child.how in ("inner", "left", "semi", "anti"):
                    to_left.append(c)
                elif refs and refs <= right_names and not (refs & left_names) \
                        and child.how in ("inner", "right"):
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
                    if derived is not None \
                            and not _already_filtering(target, derived) \
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


class PushDownProjection(Rule):
    """Column pruning: intersect each scan's columns with what the plan above
    actually reads (reference: rules/push_down_projection.rs). A Project,
    UDFProject or Aggregate above a scan, through pass-through Filter / Sort /
    Limit nodes, prunes it."""

    name = "PushDownProjection"

    def rewrite(self, node):
        if isinstance(node, (lp.Project, lp.UDFProject, lp.Aggregate, lp.Filter)):
            child = node.children()[0]
            required = self._required_columns(node)
            if required is None:
                return None
            target = child
            # Walk through pass-through nodes that don't change the column set.
            passthrough: List[lp.LogicalPlan] = []
            while isinstance(target, (lp.Filter, lp.Sort, lp.Limit)):
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
    (TPC-H Q7/Q19's cross-relation ORs are unpushable otherwise)."""
    parts: List[Expr] = []
    for d in disjuncts:
        conj: List[Expr] = []
        _flatten_and(d, conj)
        side = [x for x in conj if x.column_refs() and x.column_refs() <= names
                and not x.has_udf()]
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
        if isinstance(node, lp.Sort):
            node = node.children()[0]
            continue
        if isinstance(node, lp.Concat):
            # Pushdown distributes a filter into every branch.
            return all(_already_filtering(c, e) for c in node.children())
        if isinstance(node, lp.Join):
            # A pushed filter lands on whichever join side owns its columns.
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
