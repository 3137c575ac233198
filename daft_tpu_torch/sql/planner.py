"""SQL AST → LogicalPlanBuilder lowering (port of ``daft_tpu/sql/planner.py``).

Reference: src/daft-sql/src/planner.rs — resolves table names against bound
DataFrames, plans joins/filters/aggregations and subqueries onto the same
LogicalPlanBuilder the DataFrame API uses. Subqueries become ``Subquery`` /
``InSubquery`` / ``Exists`` nodes with their correlations, which the
optimizer's ``UnnestSubqueries`` turns into joins.

The port has no sessions or catalogs (ROADMAP A.8): ``CREATE TABLE``,
``DROP TABLE``, ``INSERT``, ``SHOW TABLES``, ``USE`` and a ``SET`` of a
session variable raise ``DaftNotImplementedError`` naming A.8, and a table
name resolves only
against the bound DataFrames and the query's CTEs. ``SET`` of an execution or
planning config key applies it live, as in the JAX package. ``EXPLAIN
ANALYZE`` raises naming A.9.5 (the profiler); plain ``EXPLAIN`` and
``DESCRIBE`` work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from daft_tpu_torch.errors import DaftNotImplementedError, DaftValueError
from daft_tpu_torch.expressions.expr import (
    AggOp,
    Alias,
    BinaryOp,
    ColumnRef,
    Exists,
    Expr,
    FunctionCall,
    InSubquery,
    Subquery,
)
from daft_tpu_torch.sql.parser import (
    SelectStmt,
    SubqueryExpr,
    SubqueryRef,
    TableRef,
    parse_sql,
)


class _OuterRef(Expr):
    """Marker for a column resolved to the OUTER query scope while planning a
    correlated subquery (reference: outer-reference binding in
    src/daft-sql/src/planner.rs + rules/unnest_subquery.rs)."""

    __slots__ = ("name_",)

    def __init__(self, name: str):
        self.name_ = name

    def name(self) -> str:
        return self.name_

    def to_field(self, schema):
        raise DaftValueError(f"unresolved outer reference {self.name_!r}")

    def _attrs_key(self):
        return (self.name_,)

    def __repr__(self):
        return f"outer({self.name_})"


def plan_sql(query: str, bindings: Dict[str, object]):
    stmt = parse_sql(query)
    return _execute_statement(stmt, bindings)


#: The session statements, which need the sessions and catalogs of A.8.
_SESSION_STATEMENTS = {"CreateTableStmt": "CREATE TABLE", "DropTableStmt": "DROP TABLE",
                       "InsertStmt": "INSERT", "ShowTablesStmt": "SHOW TABLES",
                       "UseStmt": "USE"}


def _execute_statement(stmt, bindings: Dict[str, object]):
    """Dispatch a statement (reference: src/daft-sql/src/exec.rs): SELECT
    returns its DataFrame, EXPLAIN and DESCRIBE small DataFrames of text."""
    from daft_tpu_torch.dataframe.creation import from_pydict
    from daft_tpu_torch.sql.parser import DescribeStmt, ExplainStmt, SetStmt

    if isinstance(stmt, SelectStmt):
        return _plan_select(stmt, bindings, dict(stmt.ctes))
    if isinstance(stmt, SetStmt):
        return _set(stmt)
    kind = type(stmt).__name__
    if kind in _SESSION_STATEMENTS:
        raise DaftNotImplementedError(
            f"{_SESSION_STATEMENTS[kind]} runs against a session and its catalogs, which "
            f"are not ported to daft_tpu_torch yet: ROADMAP A.8")
    if isinstance(stmt, ExplainStmt):
        if stmt.analyze:
            raise DaftNotImplementedError(
                "EXPLAIN ANALYZE needs the profiler's operator spans, which are not ported "
                "to daft_tpu_torch yet: ROADMAP A.9.5")
        target = stmt.stmt
        if not isinstance(target, SelectStmt):
            # EXPLAIN never executes side effects; the session statements
            # themselves are A.8.
            return _execute_statement(target, bindings)
        inner = _plan_select(target, bindings, dict(target.ctes))
        return from_pydict({"plan": [inner._builder.explain_string(show_all=True)]})
    if isinstance(stmt, DescribeStmt):
        if isinstance(stmt.target, SelectStmt):
            schema = _plan_select(stmt.target, bindings, dict(stmt.target.ctes)).schema
        elif stmt.target in bindings:
            schema = bindings[stmt.target].schema
        else:
            raise DaftValueError(f"Unknown table {stmt.target!r} for DESCRIBE")
        return from_pydict({
            "column_name": [f.name for f in schema],
            "type": [repr(f.dtype) for f in schema],
        })
    raise DaftValueError(f"Unsupported SQL statement {type(stmt).__name__}")


def _set(stmt):
    """``SET key = value``: an execution or planning config key applies
    live and the statement returns its one-row frame (the JAX package's
    planner); any other key is a session variable (A.8)."""
    import dataclasses

    from daft_tpu_torch import context
    from daft_tpu_torch.dataframe.creation import from_pydict

    key = stmt.name.lower()
    ctx = context.get_context()
    if key in {f.name for f in dataclasses.fields(type(ctx.execution_config))}:
        context.set_execution_config(**{key: stmt.value})
    elif key in {f.name for f in dataclasses.fields(type(ctx.planning_config))}:
        context.set_planning_config(**{key: stmt.value})
    else:
        raise DaftNotImplementedError(
            f"SET {key}: {key!r} is no execution or planning config key, so it is a session "
            f"variable, and sessions are not ported to daft_tpu_torch yet: ROADMAP A.8")
    return from_pydict({"name": [key], "value": [str(stmt.value)]})


def _rename_positional(df, cols):
    """Apply derived-table column aliases: t(x, y) renames by position."""
    names = [f.name for f in df.schema]
    if len(cols) > len(names):
        raise DaftValueError(
            f"column alias list has {len(cols)} names but the table exposes "
            f"{len(names)} columns")
    return df.with_columns_renamed(dict(zip(names, cols)))


def _resolve_source(src, bindings, ctes):
    from daft_tpu_torch.dataframe.dataframe import DataFrame
    from daft_tpu_torch.sql.parser import ValuesRef

    if isinstance(src, ValuesRef):
        from daft_tpu_torch.dataframe.creation import from_pydict
        from daft_tpu_torch.expressions.expr import Literal as _Lit

        width = len(src.rows[0]) if src.rows else 0
        for i, row in enumerate(src.rows):
            if len(row) != width:
                raise DaftValueError(
                    f"VALUES row {i} has {len(row)} columns, expected {width}")
        cols = {}
        for j in range(width):
            vals = []
            for row in src.rows:
                cell = row[j]
                if not isinstance(cell, _Lit):
                    raise DaftValueError(
                        "VALUES rows must be literals in this engine")
                vals.append(cell.value)
            cols[f"col{j}"] = vals
        df = from_pydict(cols)
        if src.column_aliases:
            df = _rename_positional(df, src.column_aliases)
        return df
    if isinstance(src, SubqueryRef):
        df = _plan_select(src.query, bindings, ctes)
        if src.column_aliases:
            df = _rename_positional(df, src.column_aliases)
        return df
    from daft_tpu_torch.sql.parser import TableFuncRef

    if isinstance(src, TableFuncRef):
        # Table-valued functions (reference: src/daft-sql/src/table_provider/).
        import daft_tpu_torch as _dt

        if src.name == "range":
            import numpy as np

            from daft_tpu_torch.dataframe.creation import from_pydict

            vals = [int(a) for a in src.args]
            if len(vals) == 1:
                start, stop, step = 0, vals[0], 1
            elif len(vals) == 2:
                start, stop, step = vals[0], vals[1], 1
            elif len(vals) == 3:
                start, stop, step = vals
            else:
                raise DaftValueError("range() takes 1-3 integer arguments")
            return from_pydict({"id": np.arange(start, stop, step)})
        reader = getattr(_dt, src.name)
        return reader(*src.args, **src.kwargs)
    assert isinstance(src, TableRef)
    name = src.name
    if name in ctes:
        return _plan_select(ctes[name], bindings, ctes)
    if name in bindings:
        obj = bindings[name]
        if isinstance(obj, DataFrame):
            return obj
    # The JAX package looks the name up in the session's catalogs next (A.8).
    raise DaftValueError(f"Unknown table {name!r} in SQL query")


def _src_alias(src) -> str:
    from daft_tpu_torch.sql.parser import TableFuncRef, ValuesRef

    if isinstance(src, SubqueryRef):
        return src.alias or "__subquery"
    if isinstance(src, ValuesRef):
        return src.alias or "__values"
    if isinstance(src, TableFuncRef):
        return src.alias or src.name
    return src.alias or src.name


def _plan_from(stmt: SelectStmt, bindings, ctes):
    """Plan the FROM clause + JOINs; returns (df, scope).

    ``scope`` maps each table alias (or name) to {source column → output
    column}: joins rename collision columns (``<alias>.<col>``), and
    qualified references MUST resolve through this mapping — stripping the
    qualifier silently rebinds ``m.name`` to the left side in self-joins."""
    from daft_tpu_torch.expressions.expression import Expression

    if stmt.source is None:
        # SELECT without FROM: single-row evaluation.
        from daft_tpu_torch.dataframe.creation import from_pydict

        return from_pydict({"__dummy": [1]}), {}
    df = _resolve_source(stmt.source, bindings, ctes)
    a0 = _src_alias(stmt.source)
    scope: dict = {a0: {c: c for c in df.column_names}}
    for join in stmt.joins:
        right = _resolve_source(join.right, bindings, ctes)
        ra = _src_alias(join.right)
        right_names = list(right.column_names)
        left_names = set(df.column_names)
        merged: set = set()
        if join.how == "cross":
            df = df.cross_join(right, suffix=f"{ra}.")
        elif join.using:
            df = df.join(right, on=join.using, how=join.how, suffix=f"{ra}.")
            merged = set(join.using)
        else:
            left_on, right_on, lf, rf = _split_join_condition(
                join.on, df, right, join.how, scope, ra)
            for f in lf:
                df = df.where(Expression(f))
            for f in rf:
                right = right.where(Expression(f))
            df = df.join(
                right,
                left_on=[Expression(e) for e in left_on],
                right_on=[Expression(e) for e in right_on],
                how=join.how,
                suffix=f"{ra}.",
            )
            merged = {r.name() for l, r in zip(left_on, right_on)
                      if isinstance(l, ColumnRef) and isinstance(r, ColumnRef)
                      and l.name_ == r.name_}
        if join.how in ("semi", "anti"):
            scope[ra] = {}  # right columns do not survive semi/anti joins
        else:
            scope[ra] = {c: (c if c in merged or c not in left_names
                             else f"{ra}.{c}")
                         for c in right_names}
    return df, scope


def _plan_select(stmt: SelectStmt, bindings, ctes):
    from daft_tpu_torch.expressions.expression import Expression

    df, scope = _plan_from(stmt, bindings, ctes)
    # Table-qualifier resolution: `t.c` parses as struct_get(col(t), name=c);
    # when t is a table name/alias rather than a struct column, resolve
    # through the FROM scope's rename map (reference: qualified-identifier
    # binding in daft-sql's planner).
    colnames = set(df.column_names)
    dequal = lambda e: _dequalify(e, colnames, scope)
    if stmt.where is not None:
        w = _resolve_subqueries(dequal(stmt.where), df, scope, bindings, ctes)
        df = df.where(Expression(w))

    # Projections: expand *, attach aliases.
    proj_exprs: List[Expr] = []
    for e, alias in stmt.projections:
        if e is None:
            for name in df.column_names:
                if name != "__dummy":
                    proj_exprs.append(ColumnRef(name))
        else:
            e = dequal(e)
            proj_exprs.append(Alias(e, alias) if alias else e)
    stmt.group_by = [dequal(g) for g in stmt.group_by]
    if stmt.having is not None:
        stmt.having = _resolve_subqueries(dequal(stmt.having), df, scope,
                                          bindings, ctes)
    for o in stmt.order_by:
        o.expr = dequal(o.expr)

    has_agg = bool(stmt.group_by) or any(e.has_agg() for e in proj_exprs)
    if has_agg:
        group_exprs = list(stmt.group_by)
        # A projection that is exactly a group key passes through.
        group_keys = {g.key() for g in group_exprs}
        agg_exprs = [e for e in proj_exprs if _strip_alias(e).key() not in group_keys]
        keys_in_proj = [e for e in proj_exprs if _strip_alias(e).key() in group_keys]
        # HAVING: rewrite aggregate subtrees to reference agg output columns;
        # unmatched aggregates become hidden agg columns dropped after filter.
        hidden_aggs: List[Expr] = []
        having_rewritten: Optional[Expr] = None
        if stmt.having is not None:
            existing = {_strip_alias(e).key(): e.name() for e in agg_exprs}

            def rw(n: Expr):
                if isinstance(n, AggOp):
                    k = n.key()
                    if k in existing:
                        return ColumnRef(existing[k])
                    name = f"__having_{len(hidden_aggs)}"
                    hidden_aggs.append(Alias(n, name))
                    existing[k] = name
                    return ColumnRef(name)
                return None

            having_rewritten = stmt.having.transform(rw)
        gdf = df.groupby(*[Expression(g) for g in group_exprs]) if group_exprs else None
        all_aggs = agg_exprs + hidden_aggs
        if gdf is not None:
            out = gdf.agg(*[Expression(e) for e in all_aggs])
        else:
            out = df.agg(*[Expression(e) for e in all_aggs])
        if having_rewritten is not None:
            out = out.where(Expression(having_rewritten))
            if hidden_aggs:
                out = out.exclude(*[e.name() for e in hidden_aggs])
        # Re-order columns to match projection order (and re-apply aliases on
        # group keys, whose agg output columns carry the key's own name).
        want_exprs = []
        for e in proj_exprs:
            nm = e.name()
            strip = _strip_alias(e)
            src = strip.name() if strip.key() in group_keys else nm
            if src not in out.column_names:
                want_exprs = None
                break
            want_exprs.append(Expression(Alias(ColumnRef(src), nm)) if src != nm
                              else Expression(ColumnRef(nm)))
        if want_exprs is not None:
            out = out.select(*want_exprs)
        df = out
    else:
        # ORDER BY may reference pre-projection columns (SQL scoping): carry
        # them through as hidden columns and drop after the sort.
        hidden: List[str] = []
        if stmt.order_by:
            proj_names = {e.name() for e in proj_exprs}
            order_refs = set()
            for o in stmt.order_by:
                order_refs |= o.expr.column_refs()
            hidden = sorted((order_refs - proj_names) & set(df.column_names))
        df = df.select(*[Expression(e) for e in proj_exprs + [ColumnRef(h) for h in hidden]])
        if hidden:
            if stmt.distinct:
                raise DaftValueError("ORDER BY on non-projected columns with DISTINCT")
            df = df.sort(
                [Expression(o.expr) for o in stmt.order_by],
                [o.desc for o in stmt.order_by],
                nulls_first=[o.nulls_first if o.nulls_first is not None else o.desc
                             for o in stmt.order_by],
            )
            df = df.exclude(*hidden)
            stmt.order_by = []
        if stmt.having is not None:
            raise DaftValueError("HAVING requires GROUP BY / aggregation")

    if stmt.distinct:
        df = df.distinct()
    if stmt.set_ops:
        # SQL precedence: INTERSECT binds tighter than UNION/EXCEPT; within a
        # precedence level, set ops associate left-to-right.
        arms = [(None, df)] + [
            (mode, _plan_select(other, bindings, ctes))
            for mode, other in stmt.set_ops]
        reduced = [arms[0]]
        for mode, rhs in arms[1:]:
            if mode == "intersect":
                pmode, lhs = reduced[-1]
                reduced[-1] = (pmode, lhs.intersect(rhs))
            elif mode == "intersect_all":
                pmode, lhs = reduced[-1]
                reduced[-1] = (pmode, lhs.intersect_all(rhs))
            else:
                reduced.append((mode, rhs))
        df = reduced[0][1]
        for mode, rhs in reduced[1:]:
            if mode == "all":
                df = df.concat(rhs)
            elif mode == "distinct":
                df = df.concat(rhs).distinct()
            elif mode == "except":
                df = df.except_distinct(rhs)
            else:
                df = df.except_all(rhs)
    if stmt.order_by:
        df = df.sort(
            [Expression(o.expr) for o in stmt.order_by],
            [o.desc for o in stmt.order_by],
            nulls_first=[o.nulls_first if o.nulls_first is not None else o.desc
                         for o in stmt.order_by],
        )
    if stmt.limit is not None:
        df = df.limit(stmt.limit, offset=stmt.offset or 0)
    elif stmt.offset:
        df = df.offset(stmt.offset)
    return df


def _strip_alias(e: Expr) -> Expr:
    while isinstance(e, Alias):
        e = e.child
    return e


def _split_join_condition(on: Optional[Expr], left_df, right_df,
                          how: str = "inner", scope=None,
                          right_alias: Optional[str] = None):
    """Decompose an ON condition into (left_on, right_on, left_filters,
    right_filters). Single-side non-equi conjuncts become prefilters on that
    side when that is semantics-preserving (always for inner; for outer joins
    only the side whose unmatched rows are dropped anyway).

    Qualified refs resolve against ``scope`` (the accumulated left side) and
    ``right_alias`` — qualifiers are authoritative about which side a column
    comes from, which name-membership alone cannot decide in self-joins."""
    from daft_tpu_torch.expressions.expr import FunctionCall

    if on is None:
        raise DaftValueError("JOIN requires ON or USING")
    conjuncts: List[Expr] = []

    def flatten(e: Expr):
        if isinstance(e, BinaryOp) and e.op == "and":
            flatten(e.left)
            flatten(e.right)
        else:
            conjuncts.append(e)

    flatten(on)
    left_names = set(left_df.column_names)
    right_names = set(right_df.column_names)
    scope = scope or {}

    def resolve(e: Expr):
        """Resolve qualifiers → (expr, side tags from qualifiers)."""
        sides = set()

        def rw(n: Expr):
            if isinstance(n, FunctionCall) and n.fn_name == "struct_get" \
                    and len(n.args) == 1:
                q = n.args[0]
                if isinstance(q, ColumnRef) and q.name_ not in left_names \
                        and q.name_ not in right_names:
                    c = n.kwargs["name"]
                    if q.name_ == right_alias and c in right_names:
                        sides.add("right")
                        return ColumnRef(c)
                    if q.name_ in scope and c in scope[q.name_]:
                        sides.add("left")
                        return ColumnRef(scope[q.name_][c])
                    return ColumnRef(c)
            return None

        return e.transform(rw), sides

    def side_of(expr: Expr, sides) -> str:
        if sides == {"left"}:
            return "l"
        if sides == {"right"}:
            return "r"
        if len(sides) > 1:
            return "mixed"
        refs = expr.column_refs()
        in_l, in_r = refs <= left_names, refs <= right_names
        if in_l and not in_r:
            return "l"
        if in_r and not in_l:
            return "r"
        if in_l and in_r:
            return "either"
        return "mixed"

    left_on, right_on = [], []
    left_filters, right_filters = [], []
    for c in conjuncts:
        if isinstance(c, BinaryOp) and c.op == "eq":
            l, ls = resolve(c.left)
            r, rs = resolve(c.right)
            sl, sr = side_of(l, ls), side_of(r, rs)
            if sl in ("l", "either") and sr in ("r", "either"):
                left_on.append(l)
                right_on.append(r)
                continue
            if sl == "r" and sr in ("l", "either") or \
                    sl == "either" and sr == "l":
                left_on.append(r)
                right_on.append(l)
                continue
            cq = BinaryOp("eq", l, r)
            side = sl if sl == sr else ("mixed" if "mixed" in (sl, sr) else sl)
        else:
            cq, tags = resolve(c)
            side = side_of(cq, tags)
        if side in ("r", "either") and how in ("inner", "left", "semi", "anti"):
            right_filters.append(cq)
            continue
        if side in ("l", "either") and how in ("inner", "right"):
            left_filters.append(cq)
            continue
        raise DaftValueError(
            f"Unsupported {how}-join condition (not an equi key or a "
            f"prefilterable single-side predicate): {c!r}")
    return left_on, right_on, left_filters, right_filters


def _dequalify(e: Expr, column_names: set, scope=None) -> Expr:
    """struct_get(col(q), name=c) -> the column ``q.c`` resolves to when q is
    a table alias (via ``scope``'s rename map), else col(c) when q is not a
    real column."""
    from daft_tpu_torch.expressions.expr import FunctionCall

    scope = scope or {}

    def rw(n: Expr):
        if isinstance(n, FunctionCall) and n.fn_name == "struct_get" and len(n.args) == 1:
            inner = n.args[0]
            if isinstance(inner, ColumnRef) and inner.name_ not in column_names:
                c = n.kwargs["name"]
                if inner.name_ in scope:
                    return ColumnRef(scope[inner.name_].get(c, c))
                return ColumnRef(c)
        return None

    return e.transform(rw)


# ---------------------------------------------------------------------- #
# Subquery resolution (reference: src/daft-sql/src/planner.rs subquery     #
# lowering + src/daft-logical-plan rules/unnest_subquery.rs)               #
# ---------------------------------------------------------------------- #
def _resolve_subqueries(e: Expr, outer_df, outer_scope, bindings, ctes):
    """Replace parser-level SubqueryExpr holders inside `e` with planned
    Subquery/InSubquery/Exists nodes, extracting correlated predicates
    against `outer_df`'s scope."""

    def rw(n: Expr):
        if isinstance(n, SubqueryExpr):
            return _plan_subquery(n, outer_df, outer_scope, bindings, ctes)
        return None

    return e.transform(rw)


def _plan_subquery(holder: SubqueryExpr, outer_df, outer_scope, bindings, ctes):
    from daft_tpu_torch.expressions.expression import Expression

    stmt = holder.stmt
    complex_shape = bool(stmt.group_by or stmt.having or stmt.set_ops or
                         stmt.order_by or stmt.limit is not None)
    if complex_shape:
        # Uncorrelated-only path: delegate to the full SELECT planner. Any
        # reference into the outer scope would be silently rebound to a
        # same-named inner column by _dequalify — reject it up front.
        _reject_correlation(stmt, outer_df, outer_scope, bindings, ctes)
        inner = _plan_select(stmt, bindings, ctes)
        plan = inner._builder.plan
        names = plan.schema.column_names()
        if holder.kind == "exists":
            return Exists(plan, (), holder.negated)
        if len(names) != 1:
            raise DaftValueError(
                f"{holder.kind} subquery must produce one column, got {names}")
        if holder.kind == "in":
            return InSubquery(holder.operand, plan, ColumnRef(names[0]),
                              (), holder.negated)
        return Subquery(plan, ColumnRef(names[0]))

    inner_df, inner_scope = _plan_from(stmt, bindings, ctes)
    filters, corr, extra = _classify_where(
        stmt.where, inner_df, inner_scope, outer_df, outer_scope,
        bindings, ctes)
    for f in filters:
        inner_df = inner_df.where(Expression(f))
    plan = inner_df._builder.plan

    if holder.kind == "exists":
        return Exists(plan, corr, holder.negated, extra)

    # IN / scalar need the single projection expression.
    projs = [p for p in stmt.projections if p[0] is not None]
    if len(stmt.projections) != 1 or not projs:
        if holder.kind == "in":
            raise DaftValueError("IN subquery must select exactly one column")
        raise DaftValueError("scalar subquery must select exactly one expression")
    value = _dequalify(projs[0][0], set(inner_df.column_names), inner_scope)
    if holder.kind == "in":
        return InSubquery(holder.operand, plan, value, corr, holder.negated, extra)
    if extra:
        raise DaftValueError(
            "scalar subqueries support only equality correlation")
    return Subquery(plan, value, corr)


def _reject_correlation(stmt, outer_df, outer_scope, bindings, ctes):
    """Raise when a GROUP BY/HAVING/ORDER BY/LIMIT subquery references the
    outer scope — decorrelation of those shapes is not supported, and letting
    them through would silently rebind outer refs to inner columns."""
    inner_df, inner_scope = _plan_from(stmt, bindings, ctes)
    inner_cols = set(inner_df.column_names)
    outer_cols = set(outer_df.column_names)
    exprs = [e for e, _ in stmt.projections if e is not None]
    exprs += [e for e in (stmt.where, stmt.having) if e is not None]
    exprs += list(stmt.group_by)
    exprs += [o.expr for o in stmt.order_by]
    for e in exprs:
        for n in e.walk():
            if isinstance(n, FunctionCall) and n.fn_name == "struct_get" \
                    and len(n.args) == 1:
                q = n.args[0]
                if isinstance(q, ColumnRef) and q.name_ not in inner_cols \
                        and q.name_ not in inner_scope and q.name_ in outer_scope:
                    raise DaftValueError(
                        f"correlated reference {q.name_}.{n.kwargs['name']} is not "
                        "supported in subqueries with GROUP BY/HAVING/ORDER BY/LIMIT")
            elif isinstance(n, ColumnRef):
                if n.name_ not in inner_cols and n.name_ not in inner_scope \
                        and n.name_ in outer_cols:
                    raise DaftValueError(
                        f"correlated reference {n.name_!r} is not supported in "
                        "subqueries with GROUP BY/HAVING/ORDER BY/LIMIT")


def _classify_where(where, inner_df, inner_scope, outer_df, outer_scope,
                    bindings, ctes):
    """Split a subquery's WHERE into (inner filters, correlated equality
    pairs, non-equi correlated predicates). Inner refs win over outer refs
    for both qualifiers and bare names (SQL scoping); qualified refs go
    through the owning scope's rename map."""
    if where is None:
        return [], [], []
    inner_cols = set(inner_df.column_names)
    outer_cols = set(outer_df.column_names)

    def scope(e: Expr) -> Expr:
        def rw(n: Expr):
            if isinstance(n, FunctionCall) and n.fn_name == "struct_get" and len(n.args) == 1:
                q = n.args[0]
                if isinstance(q, ColumnRef) and q.name_ not in inner_cols:
                    c = n.kwargs["name"]
                    if q.name_ in inner_scope:
                        return ColumnRef(inner_scope[q.name_].get(c, c))
                    if q.name_ in outer_scope:
                        return _OuterRef(outer_scope[q.name_].get(c, c))
                    if q.name_ in outer_cols:
                        return _OuterRef(c)
                    return ColumnRef(c)
            elif isinstance(n, ColumnRef):
                if n.name_ not in inner_cols and n.name_ in outer_cols:
                    return _OuterRef(n.name_)
            return None

        return e.transform(rw)

    conjuncts: List[Expr] = []

    def flatten(e: Expr):
        if isinstance(e, BinaryOp) and e.op == "and":
            flatten(e.left)
            flatten(e.right)
        else:
            conjuncts.append(e)

    flatten(where)
    filters: List[Expr] = []
    corr: List[Tuple[Expr, Expr]] = []
    extra: List[Expr] = []
    for c in conjuncts:
        c = scope(c)
        outers = [x for x in c.walk() if isinstance(x, _OuterRef)]
        if not outers:
            filters.append(_resolve_subqueries(c, inner_df, inner_scope,
                                               bindings, ctes))
            continue
        if c.has_subquery() or any(isinstance(x, SubqueryExpr) for x in c.walk()):
            raise DaftValueError(
                f"correlated predicate may not itself contain a subquery: {c!r}")
        if isinstance(c, BinaryOp) and c.op == "eq":
            sides = [c.left, c.right]
            outer_side = [s for s in sides
                          if any(isinstance(x, _OuterRef) for x in s.walk())
                          and not s.column_refs()]
            inner_side = [s for s in sides
                          if not any(isinstance(x, _OuterRef) for x in s.walk())]
            if len(outer_side) == 1 and len(inner_side) == 1:
                corr.append((_outer_to_col(outer_side[0]), inner_side[0]))
                continue
        # Non-equi (or mixed-side) correlated predicate: outer refs become
        # natural column refs, inner refs go through the __in_ channel.
        # (Single pass — transform() does not revisit replacements, so an
        # outer ref that shares its name with an inner column stays outer.)
        def mark(n: Expr):
            if isinstance(n, _OuterRef):
                return ColumnRef(n.name_)
            if isinstance(n, ColumnRef) and n.name_ in inner_cols \
                    and not n.name_.startswith("__in_"):
                return ColumnRef(f"__in_{n.name_}")
            return None

        extra.append(c.transform(mark))
    return filters, corr, extra


def _outer_to_col(e: Expr) -> Expr:
    def rw(n: Expr):
        if isinstance(n, _OuterRef):
            return ColumnRef(n.name_)
        return None

    return e.transform(rw)


