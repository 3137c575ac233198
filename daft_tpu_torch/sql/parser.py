"""SQL tokenizer + parser (port of ``daft_tpu/sql/parser.py``).

Reference: src/daft-sql (~9.1k LoC, sqlparser-rs based). A hand-written
tokenizer + Pratt expression parser + recursive-descent statement parser
producing an AST that ``sql/planner.py`` lowers to LogicalPlanBuilder ops,
with the JAX package's keyword table, precedence and error messages, window
functions (``... OVER ([PARTITION BY ...] [ORDER BY ...] [ROWS BETWEEN
...])``), ``count(DISTINCT ...)`` and ``ARRAY[...]`` included.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.expr import (
    AggOp,
    BinaryOp,
    Cast,
    ColumnRef,
    Expr,
    FunctionCall,
    IfElse,
    IsIn,
    Literal,
    UnaryOp,
)


class SQLParseError(DaftValueError):
    pass


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<float>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)
  | (?P<int>\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|<>|!=|\|\||::|[-+*/%(),.<>=\[\]])
""", re.VERBOSE)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "between", "like", "ilike",
    "is", "null", "true", "false", "case", "when", "then", "else", "end",
    "cast", "distinct", "join", "inner", "left", "right", "full", "outer",
    "cross", "on", "union", "all", "with", "asc", "desc", "nulls", "first",
    "last", "semi", "anti", "using", "interval", "exists", "intersect",
    "except", "for",
}


@dataclass
class Token:
    kind: str  # ident | qident | int | float | str | op | kw | eof
    value: str
    pos: int


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SQLParseError(f"Unexpected character {text[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        value = m.group()
        if kind == "ident" and value.lower() in KEYWORDS:
            out.append(Token("kw", value.lower(), m.start()))
        elif kind == "qident":
            out.append(Token("ident", value[1:-1].replace('""', '"'), m.start()))
        else:
            out.append(Token(kind, value, m.start()))
    out.append(Token("eof", "", len(text)))
    return out


# ---------------------------------------------------------------------- #
# AST for statements                                                      #
# ---------------------------------------------------------------------- #
class SubqueryExpr(Expr):
    """Parsed-but-unplanned subquery expression (``(SELECT ...)`` scalar,
    ``IN (SELECT ...)``, ``EXISTS (SELECT ...)``); the SQL planner resolves
    it into Subquery/InSubquery/Exists with a built plan and correlations
    (reference: sqlparser Expr::Subquery/InSubquery/Exists lowering in
    src/daft-sql/src/planner.rs)."""

    __slots__ = ("stmt", "kind", "operand", "negated")

    def __init__(self, stmt, kind: str, operand: Optional[Expr] = None,
                 negated: bool = False):
        assert kind in ("scalar", "in", "exists")
        self.stmt = stmt
        self.kind = kind
        self.operand = operand
        self.negated = negated

    def children(self):
        return (self.operand,) if self.operand is not None else ()

    def with_children(self, children):
        return SubqueryExpr(self.stmt, self.kind,
                            children[0] if children else None, self.negated)

    def to_field(self, schema):
        raise SQLParseError("unresolved SQL subquery expression")

    def _attrs_key(self):
        return (id(self.stmt), self.kind, self.negated)

    def __repr__(self):
        return f"sql_subquery[{self.kind}]"


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass
class SubqueryRef:
    query: "SelectStmt"
    alias: Optional[str] = None
    column_aliases: Optional[List[str]] = None


@dataclass
class ValuesRef:
    """VALUES (...), (...) — an inline rowset (reference: sqlparser-rs
    Values; daft-sql plans it as an in-memory table)."""

    rows: List[List[Expr]]
    alias: Optional[str] = None
    column_aliases: Optional[List[str]] = None


TABLE_FUNCTIONS = {"read_parquet", "read_csv", "read_json", "read_text",
                   "range"}


@dataclass
class TableFuncRef:
    """FROM read_parquet('path') — table-valued function (reference:
    src/daft-sql/src/table_provider/ read_parquet/read_csv/read_json)."""

    name: str
    args: List[object]
    kwargs: Dict[str, object] = field(default_factory=dict)
    alias: Optional[str] = None


# -- session statements (reference: src/daft-sql/src/statement.rs) -------- #
@dataclass
class ExplainStmt:
    stmt: object
    analyze: bool = False


@dataclass
class CreateTableStmt:
    name: str
    select: "SelectStmt"
    temp: bool = False
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class DropTableStmt:
    name: str
    if_exists: bool = False


@dataclass
class InsertStmt:
    name: str
    source: object  # SelectStmt | ValuesRef


@dataclass
class ShowTablesStmt:
    pattern: Optional[str] = None


@dataclass
class UseStmt:
    """USE <catalog>[.<namespace>] (reference: daft-sql Statement::Use)."""

    name: str


@dataclass
class DescribeStmt:
    """DESCRIBE <table> | DESCRIBE <select> (reference: daft-sql describe)."""

    target: object  # str table name | SelectStmt


@dataclass
class SetStmt:
    """SET <name> = <literal> (reference: daft-sql Statement::Set session
    variables; engine-config keys apply to the execution/planning config)."""

    name: str
    value: object


@dataclass
class JoinClause:
    right: Union[TableRef, SubqueryRef]
    how: str
    on: Optional[Expr]
    using: Optional[List[str]]


@dataclass
class OrderItem:
    expr: Expr
    desc: bool = False
    nulls_first: Optional[bool] = None


@dataclass
class SelectStmt:
    projections: List[Tuple[Optional[Expr], Optional[str]]]  # (expr|None for *, alias)
    source: Optional[Union[TableRef, SubqueryRef]] = None
    joins: List[JoinClause] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    # Left-to-right set-operation chain: [("all"|"distinct"|"intersect"|
    # "intersect_all"|"except"|"except_all", stmt), ...]
    set_ops: List[Tuple[str, "SelectStmt"]] = field(default_factory=list)
    ctes: Dict[str, "SelectStmt"] = field(default_factory=dict)


# ---------------------------------------------------------------------- #
# Parser                                                                  #
# ---------------------------------------------------------------------- #
_AGG_FUNCS = {"sum", "min", "max", "count", "avg", "mean", "stddev", "stddev_pop",
              "variance", "var_pop", "skew", "any_value",
              "count_distinct", "approx_count_distinct", "list", "array_agg",
              "bool_and", "bool_or"}

_FUNC_MAP = {
    # name -> kernel name (1:1 unless noted)
    "upper": "str_upper", "lower": "str_lower", "length": "str_length",
    "char_length": "str_length", "trim": "str_strip", "ltrim": "str_lstrip",
    "rtrim": "str_rstrip", "reverse": "str_reverse", "capitalize": "str_capitalize",
    "contains": "str_contains", "starts_with": "str_startswith",
    "ends_with": "str_endswith", "regexp_match": "str_match",
    "split": "str_split", "replace": "str_replace", "lpad": "str_lpad",
    "rpad": "str_rpad", "repeat": "str_repeat", "left": "str_left",
    "right": "str_right", "find": "str_find",
    "abs": None, "ceil": "ceil", "ceiling": "ceil", "floor": "floor",
    "round": "round", "sqrt": "sqrt", "cbrt": "cbrt", "exp": "exp", "ln": "ln",
    "log": "log", "log2": "log2", "log10": "log10", "sin": "sin", "cos": "cos",
    "tan": "tan", "asin": "asin", "acos": "acos", "atan": "atan", "atan2": "atan2",
    "sign": "sign", "clip": "clip", "pow": None, "power": None,
    "coalesce": "coalesce", "hash": "hash", "minhash": "minhash",
    "concat_ws": "concat_ws", "cosine_distance": "cosine_distance",
    "year": "dt_year", "month": "dt_month", "day": "dt_day", "hour": "dt_hour",
    "minute": "dt_minute", "second": "dt_second", "day_of_week": "dt_day_of_week",
    "date_trunc": None, "to_date": "str_to_date", "to_datetime": "str_to_datetime",
    "list_get": "list_get", "list_sum": "list_sum", "list_mean": "list_mean",
    "list_min": "list_min", "list_max": "list_max", "list_sort": "list_sort",
    "list_join": "list_join", "list_contains": "list_contains",
    "fill_null": "fill_null", "ifnull": "fill_null", "nvl": "fill_null",
    "is_nan": "is_nan", "fill_nan": "fill_nan",
}

_TYPE_MAP = {
    "int": DataType.int64, "integer": DataType.int64, "bigint": DataType.int64,
    "smallint": DataType.int16, "tinyint": DataType.int8,
    "float": DataType.float64, "real": DataType.float32, "double": DataType.float64,
    "float32": DataType.float32, "float64": DataType.float64,
    "bool": DataType.bool, "boolean": DataType.bool,
    "text": DataType.string, "string": DataType.string, "varchar": DataType.string,
    "binary": DataType.binary, "bytes": DataType.binary,
    "date": DataType.date, "timestamp": DataType.timestamp,
    "bfloat16": DataType.bfloat16,
}


class Parser:
    def __init__(self, text: str):
        self.tokens = tokenize(text)
        self.i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            raise SQLParseError(f"Expected {value or kind}, got {got.value!r} at {got.pos}")
        return t

    def accept_kw(self, *kws: str) -> Optional[str]:
        t = self.peek()
        if t.kind == "kw" and t.value in kws:
            self.next()
            return t.value
        return None

    # -- statements --------------------------------------------------------
    def parse_statement(self):
        stmt = self._parse_statement_inner()
        self.expect("eof")
        return stmt

    def _parse_statement_inner(self):
        """SELECT plus session statements (reference:
        src/daft-sql/src/statement.rs — Select / CreateTable / DropTable /
        Insert / Explain / ShowTables)."""
        t = self.peek()
        word = t.value.lower() if t.kind in ("ident", "kw") else ""
        if word == "explain":
            self.next()
            analyze = self._accept_word("analyze")
            return ExplainStmt(self._parse_statement_inner(), analyze)
        if word == "create":
            self.next()
            or_replace = False
            if self._accept_word("or"):
                self._expect_word("replace")
                or_replace = True
            temp = self._accept_word("temp") or self._accept_word("temporary")
            self._expect_word("table")
            if_not_exists = False
            if self._accept_word("if"):
                self._expect_word("not")
                self._expect_word("exists")
                if_not_exists = True
            name = self._qualified_name()
            self.expect("kw", "as")
            select = self._parse_statement_inner()
            if not isinstance(select, SelectStmt):
                raise SQLParseError("CREATE TABLE ... AS requires a SELECT")
            return CreateTableStmt(name, select, temp=temp,
                                   or_replace=or_replace,
                                   if_not_exists=if_not_exists)
        if word == "drop":
            self.next()
            self._expect_word("table")
            if_exists = False
            if self._accept_word("if"):
                self._expect_word("exists")
                if_exists = True
            return DropTableStmt(self._qualified_name(), if_exists=if_exists)
        if word == "insert":
            self.next()
            self._expect_word("into")
            name = self._qualified_name()
            if self._at_values():
                return InsertStmt(name, self._parse_values())
            select = self._parse_statement_inner()
            if not isinstance(select, SelectStmt):
                raise SQLParseError("INSERT INTO requires SELECT or VALUES")
            return InsertStmt(name, select)
        if word == "show":
            self.next()
            self._expect_word("tables")
            pattern = None
            if self._accept_word("like"):
                pattern = self.expect("str").value[1:-1].replace("''", "'")
            return ShowTablesStmt(pattern)
        if word == "use":
            self.next()
            return UseStmt(self._qualified_name())
        if word in ("describe", "desc"):
            self.next()
            nxt = self.peek()
            nxt_word = nxt.value.lower() if nxt.kind in ("ident", "kw") else ""
            if nxt_word in ("select", "with") and nxt.kind == "kw":
                inner = self._parse_statement_inner()
                if not isinstance(inner, SelectStmt):
                    raise SQLParseError("DESCRIBE takes a table or a SELECT")
                return DescribeStmt(inner)
            return DescribeStmt(self._qualified_name())
        if word == "set":
            self.next()
            name = self._qualified_name()
            if not (self.accept("op", "=") or self._accept_word("to")):
                raise SQLParseError("SET requires '=' or TO")
            return SetStmt(name, self._literal_arg())
        ctes: Dict[str, SelectStmt] = {}
        if self.accept_kw("with"):
            while True:
                name = self.expect("ident").value
                self.expect("kw", "as")
                self.expect("op", "(")
                ctes[name] = self.parse_select()
                self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        stmt = self.parse_select()
        stmt.ctes = ctes
        return stmt

    def _qualified_name(self) -> str:
        """Dotted identifier: table, ns.table, catalog.ns.table."""
        name = self._ident_like()
        while self.accept("op", "."):
            name += "." + self._ident_like()
        return name

    def _accept_word(self, word: str) -> bool:
        """Accept an ident-or-keyword token by (case-insensitive) word."""
        t = self.peek()
        if t.kind in ("ident", "kw") and (t.value or "").lower() == word:
            self.next()
            return True
        return False

    def _expect_word(self, word: str) -> None:
        t = self.next()
        if (t.value or "").lower() != word:
            raise SQLParseError(f"Expected {word.upper()!r}, got {t.value!r}")

    def _at_values(self) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.value.lower() == "values"

    def _parse_values(self) -> ValuesRef:
        self.next()  # 'values'
        rows = []
        while True:
            self.expect("op", "(")
            row = [self.parse_expr()]
            while self.accept("op", ","):
                row.append(self.parse_expr())
            self.expect("op", ")")
            rows.append(row)
            if not self.accept("op", ","):
                break
        return ValuesRef(rows)

    def parse_select(self, in_union: bool = False) -> SelectStmt:
        if self._at_values():
            # Top-level VALUES: select * from the inline rowset.
            return SelectStmt(projections=[(None, None)],
                              source=self._parse_values())
        self.expect("kw", "select")
        stmt = SelectStmt(projections=[])
        stmt.distinct = bool(self.accept_kw("distinct"))
        if not stmt.distinct:
            self.accept_kw("all")  # SELECT ALL is the default
        while True:
            if self.accept("op", "*"):
                stmt.projections.append((None, None))
            else:
                e = self.parse_expr()
                alias = None
                if self.accept_kw("as"):
                    alias = self._ident_like()
                elif self.peek().kind == "ident":
                    alias = self.next().value
                stmt.projections.append((e, alias))
            if not self.accept("op", ","):
                break
        if self.accept_kw("from"):
            stmt.source = self.parse_table_factor()
            while True:
                how = self._parse_join_kind()
                if how is None:
                    break
                right = self.parse_table_factor()
                on = None
                using = None
                if how != "cross":
                    if self.accept_kw("on"):
                        on = self.parse_expr()
                    elif self.accept_kw("using"):
                        self.expect("op", "(")
                        using = [self._ident_like()]
                        while self.accept("op", ","):
                            using.append(self._ident_like())
                        self.expect("op", ")")
                    else:
                        raise SQLParseError("JOIN requires ON or USING")
                stmt.joins.append(JoinClause(right, how, on, using))
        if self.accept_kw("where"):
            stmt.where = self.parse_expr()
        if self.accept_kw("group"):
            self.expect("kw", "by")
            stmt.group_by.append(self.parse_expr())
            while self.accept("op", ","):
                stmt.group_by.append(self.parse_expr())
        if self.accept_kw("having"):
            stmt.having = self.parse_expr()
        # Set operations: collected as a flat left-to-right chain so the
        # planner can apply SQL's left-associativity (with INTERSECT binding
        # tighter than UNION/EXCEPT). The right arms must NOT consume
        # trailing ORDER BY/LIMIT — those apply to the whole result.
        if not in_union:
            while True:
                if self.accept_kw("union"):
                    mode = "all" if self.accept_kw("all") else "distinct"
                elif self.accept_kw("intersect"):
                    mode = "intersect_all" if self.accept_kw("all") else "intersect"
                elif self.accept_kw("except"):
                    mode = "except_all" if self.accept_kw("all") else "except"
                else:
                    break
                stmt.set_ops.append((mode, self.parse_select(in_union=True)))
        if in_union:
            return stmt
        if self.accept_kw("order"):
            self.expect("kw", "by")
            while True:
                e = self.parse_expr()
                desc = False
                if self.accept_kw("desc"):
                    desc = True
                elif self.accept_kw("asc"):
                    desc = False
                nulls_first = None
                if self.accept_kw("nulls"):
                    which = self.accept_kw("first", "last")
                    nulls_first = which == "first"
                stmt.order_by.append(OrderItem(e, desc, nulls_first))
                if not self.accept("op", ","):
                    break
        if self.accept_kw("limit"):
            stmt.limit = int(self.expect("int").value)
        if self.accept_kw("offset"):
            stmt.offset = int(self.expect("int").value)
        return stmt

    def _parse_join_kind(self) -> Optional[str]:
        if self.accept_kw("cross"):
            self.expect("kw", "join")
            return "cross"
        if self.accept_kw("join") or self.accept_kw("inner"):
            self.accept_kw("join")
            return "inner"
        if self.accept_kw("semi"):
            self.expect("kw", "join")
            return "semi"
        if self.accept_kw("anti"):
            self.expect("kw", "join")
            return "anti"
        for kw, how in (("left", "left"), ("right", "right"), ("full", "outer")):
            if self.accept_kw(kw):
                self.accept_kw("outer")
                # LEFT SEMI / LEFT ANTI override the outer kind.
                if self.accept_kw("semi"):
                    how = "semi"
                elif self.accept_kw("anti"):
                    how = "anti"
                self.expect("kw", "join")
                return how
        return None

    def _table_alias(self):
        """[AS] alias [(col, ...)] after a derived table."""
        alias = None
        cols = None
        self.accept_kw("as")
        if self.peek().kind == "ident":
            alias = self.next().value
            if self.accept("op", "("):
                cols = [self._ident_like()]
                while self.accept("op", ","):
                    cols.append(self._ident_like())
                self.expect("op", ")")
        return alias, cols

    def parse_table_factor(self) -> Union[TableRef, SubqueryRef, ValuesRef]:
        if self.accept("op", "("):
            if self._at_values():
                v = self._parse_values()
                self.expect("op", ")")
                v.alias, v.column_aliases = self._table_alias()
                return v
            sub = self.parse_select()
            self.expect("op", ")")
            alias, cols = self._table_alias()
            return SubqueryRef(sub, alias, cols)
        name = self._ident_like()
        if name.lower() in TABLE_FUNCTIONS and self.peek().kind == "op" \
                and self.peek().value == "(":
            self.next()  # consume "("
            args: List[object] = []
            kwargs: Dict[str, object] = {}
            if not self.accept("op", ")"):
                while True:
                    if (self.peek().kind == "ident"
                            and self.peek(1).kind == "op"
                            and self.peek(1).value == "="):
                        k = self.next().value
                        self.next()
                        kwargs[k] = self._literal_arg()
                    else:
                        args.append(self._literal_arg())
                    if not self.accept("op", ","):
                        break
                self.expect("op", ")")
            alias, _ = self._table_alias()
            return TableFuncRef(name.lower(), args, kwargs, alias)
        while self.accept("op", "."):
            name += "." + self._ident_like()
        alias = None
        if self.accept_kw("as"):
            alias = self._ident_like()
        elif self.peek().kind == "ident":
            alias = self.next().value
        return TableRef(name, alias)

    def _literal_arg(self):
        """A literal argument of a table function: string/number/bool."""
        t = self.next()
        if t.kind == "str":
            return t.value[1:-1].replace("''", "'")
        if t.kind == "int":
            return int(t.value)
        if t.kind == "float":
            return float(t.value)
        if t.kind == "kw" and t.value in ("true", "false"):
            return t.value == "true"
        if t.kind == "op" and t.value == "-" and self.peek().kind in ("int", "float"):
            n = self.next()
            return -(int(n.value) if n.kind == "int" else float(n.value))
        raise SQLParseError(f"Table function arguments must be literals, got {t.value!r}")

    def _ident_like(self) -> str:
        t = self.peek()
        if t.kind in ("ident",):
            return self.next().value
        raise SQLParseError(f"Expected identifier, got {t.value!r} at {t.pos}")

    # -- expressions (Pratt) ----------------------------------------------
    def parse_expr(self) -> Expr:
        return self._parse_or()

    def _parse_or(self) -> Expr:
        left = self._parse_and()
        while self.accept_kw("or"):
            left = BinaryOp("or", left, self._parse_and())
        return left

    def _parse_and(self) -> Expr:
        left = self._parse_not()
        while self.accept_kw("and"):
            left = BinaryOp("and", left, self._parse_not())
        return left

    def _parse_not(self) -> Expr:
        if self.accept_kw("not"):
            return UnaryOp("not", self._parse_not())
        return self._parse_comparison()

    def _parse_comparison(self) -> Expr:
        left = self._parse_additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            op = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le",
                  ">": "gt", ">=": "ge"}[t.value]
            return BinaryOp(op, left, self._parse_additive())
        negate = False
        if self.peek().kind == "kw" and self.peek().value == "not":
            if self.peek(1).kind == "kw" and self.peek(1).value in ("in", "between", "like", "ilike"):
                self.next()
                negate = True
        if self.accept_kw("in"):
            self.expect("op", "(")
            if self.peek().kind == "kw" and self.peek().value == "select":
                stmt = self.parse_select()
                self.expect("op", ")")
                return SubqueryExpr(stmt, "in", left, negated=negate)
            items = [self._literal_value()]
            while self.accept("op", ","):
                items.append(self._literal_value())
            self.expect("op", ")")
            e: Expr = IsIn(left, Literal(items))
            return UnaryOp("not", e) if negate else e
        if self.accept_kw("between"):
            lo = self._parse_additive()
            self.expect("kw", "and")
            hi = self._parse_additive()
            e = BinaryOp("and", BinaryOp("ge", left, lo), BinaryOp("le", left, hi))
            return UnaryOp("not", e) if negate else e
        if self.accept_kw("like"):
            pat = self._parse_additive()
            e = FunctionCall("str_like", [left, pat])
            return UnaryOp("not", e) if negate else e
        if self.accept_kw("ilike"):
            pat = self._parse_additive()
            e = FunctionCall("str_ilike", [left, pat])
            return UnaryOp("not", e) if negate else e
        if self.accept_kw("is"):
            neg = bool(self.accept_kw("not"))
            self.expect("kw", "null")
            return UnaryOp("not_null" if neg else "is_null", left)
        return left

    def _parse_additive(self) -> Expr:
        left = self._parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                self.next()
                right = self._parse_multiplicative()
                if t.value == "||":
                    left = BinaryOp("add", Cast(left, DataType.string()),
                                    Cast(right, DataType.string()))
                else:
                    left = BinaryOp("add" if t.value == "+" else "sub", left, right)
            else:
                return left

    def _parse_multiplicative(self) -> Expr:
        left = self._parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                op = {"*": "mul", "/": "truediv", "%": "mod"}[t.value]
                left = BinaryOp(op, left, self._parse_unary())
            else:
                return left

    def _parse_unary(self) -> Expr:
        if self.accept("op", "-"):
            return UnaryOp("negate", self._parse_unary())
        if self.accept("op", "+"):
            return self._parse_unary()
        return self._parse_postfix()

    def _parse_postfix(self) -> Expr:
        e = self._parse_primary()
        while True:
            if self.accept("op", "::"):
                e = Cast(e, self._parse_type())
            elif self.accept("op", "["):
                idx = self.parse_expr()
                self.expect("op", "]")
                e = FunctionCall("list_get", [e, idx])
            elif self.accept("op", "."):
                name = self._ident_like()
                e = FunctionCall("struct_get", [e], {"name": name})
            else:
                return e

    def _parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "int":
            self.next()
            return Literal(int(t.value))
        if t.kind == "float":
            self.next()
            return Literal(float(t.value))
        if t.kind == "str":
            self.next()
            return Literal(t.value[1:-1].replace("''", "'"))
        if t.kind == "kw":
            if self.accept_kw("true"):
                return Literal(True)
            if self.accept_kw("false"):
                return Literal(False)
            if self.accept_kw("null"):
                return Literal(None)
            if self.accept_kw("case"):
                return self._parse_case()
            if self.accept_kw("cast"):
                self.expect("op", "(")
                inner = self.parse_expr()
                self.expect("kw", "as")
                dtype = self._parse_type()
                self.expect("op", ")")
                return Cast(inner, dtype)
            if self.accept_kw("interval"):
                raw = self.expect("str").value[1:-1]
                # INTERVAL '1' DAY — a standalone unit word after the quoted
                # count. Only known unit words are consumed, so an implicit
                # alias (INTERVAL '1 day' d) still parses.
                t2 = self.peek()
                if t2.kind == "ident" and t2.value.lower().rstrip("s") in (
                        "year", "month", "week", "day", "hour", "minute",
                        "second", "millisecond", "microsecond"):
                    raw = f"{raw} {self.next().value}"
                return Literal(_parse_interval(raw))
            if self.accept_kw("not"):
                return UnaryOp("not", self._parse_not())
            if self.accept_kw("exists"):
                self.expect("op", "(")
                stmt = self.parse_select()
                self.expect("op", ")")
                return SubqueryExpr(stmt, "exists")
        if self.accept("op", "("):
            if self.peek().kind == "kw" and self.peek().value == "select":
                stmt = self.parse_select()
                self.expect("op", ")")
                return SubqueryExpr(stmt, "scalar")
            inner = self.parse_expr()
            self.expect("op", ")")
            return inner
        if t.kind == "ident":
            self.next()
            low = t.value.lower()
            if low == "date" and self.peek().kind == "str":
                raw = self.next().value[1:-1]
                import datetime as _dt

                return Literal(_dt.date.fromisoformat(raw))
            if low == "timestamp" and self.peek().kind == "str":
                raw = self.next().value[1:-1]
                import datetime as _dt

                return Literal(_dt.datetime.fromisoformat(raw))
            if low == "array" and self.peek().kind == "op" and self.peek().value == "[":
                self.next()
                items = [self.parse_expr()]
                while self.accept("op", ","):
                    items.append(self.parse_expr())
                self.expect("op", "]")
                return FunctionCall("list_pack", items)
            if low in ("current_date", "current_timestamp") and not (
                    self.peek().kind == "op" and self.peek().value == "("):
                # Deferred: evaluated at execution time in UTC (the dummy
                # literal arg only carries the row count to the kernel).
                fn = "today" if low == "current_date" else "now"
                return FunctionCall(fn, [Literal(1)])
            if self.peek().kind == "op" and self.peek().value == "(":
                return self._maybe_over(self._parse_function(t.value))
            # qualified column a.b -> struct access is handled postfix; here a
            # bare identifier is a column ref.
            return ColumnRef(t.value)
        raise SQLParseError(f"Unexpected token {t.value!r} at {t.pos}")

    def _parse_case(self) -> Expr:
        branches = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect("kw", "then")
            val = self.parse_expr()
            branches.append((cond, val))
        default: Expr = Literal(None)
        if self.accept_kw("else"):
            default = self.parse_expr()
        self.expect("kw", "end")
        out = default
        for cond, val in reversed(branches):
            out = IfElse(cond, val, out)
        return out

    def _peek_from_form(self) -> bool:
        """True when the call uses SUBSTRING(x FROM n [FOR m]) syntax: scan
        ahead for a FROM before the matching close-paren at depth 0."""
        depth = 0
        j = 0
        while True:
            t = self.peek(j)
            if t.kind == "eof":
                return False
            if t.kind == "op" and t.value == "(":
                depth += 1
            elif t.kind == "op" and t.value == ")":
                if depth == 0:
                    return False
                depth -= 1
            elif t.kind == "op" and t.value == "," and depth == 0:
                return False
            elif t.kind == "kw" and t.value == "from" and depth == 0:
                return True
            j += 1

    _EXTRACT_UNITS = {
        "year": "dt_year", "month": "dt_month", "day": "dt_day",
        "hour": "dt_hour", "minute": "dt_minute", "second": "dt_second",
        "dow": "dt_day_of_week", "doy": "dt_day_of_year",
        "week": "dt_week_of_year", "quarter": "dt_quarter",
    }

    def _parse_function(self, name: str) -> Expr:
        name_l = name.lower()
        self.expect("op", "(")
        if name_l == "count" and self.accept("op", "*"):
            self.expect("op", ")")
            return AggOp("count", Literal(1), {"mode": "all"})
        # SQL-standard special argument syntaxes (reference: daft-sql planner
        # handles these through sqlparser-rs's dedicated AST nodes).
        if name_l == "extract":
            unit = self._ident_like().lower()
            self.expect("kw", "from")
            inner = self.parse_expr()
            self.expect("op", ")")
            fn = self._EXTRACT_UNITS.get(unit)
            if fn is None:
                raise SQLParseError(f"EXTRACT: unknown unit {unit!r}")
            return FunctionCall(fn, [inner])
        if name_l in ("substring", "substr") and self._peek_from_form():
            inner = self._parse_additive()
            self.expect("kw", "from")
            start = self._parse_additive()
            length: Optional[Expr] = None
            if self.accept_kw("for"):
                length = self._parse_additive()
            self.expect("op", ")")
            # SQL FROM is 1-based; str_slice is 0-based.
            args = [inner, BinaryOp("sub", start, Literal(1))]
            if length is not None:
                args.append(length)
            return FunctionCall("str_substr", args)
        if name_l == "position":
            needle = self._parse_additive()
            self.expect("kw", "in")
            hay = self.parse_expr()
            self.expect("op", ")")
            # 1-based; 0 when absent (str_find is 0-based, -1 when absent).
            return BinaryOp("add", FunctionCall("str_find", [hay, needle]),
                            Literal(1))
        if name_l == "try_cast":
            inner = self.parse_expr()
            self.expect("kw", "as")
            dtype = self._parse_type()
            self.expect("op", ")")
            return FunctionCall("try_cast", [inner], {"dtype": dtype})
        if name_l == "nullif":
            a = self.parse_expr()
            self.expect("op", ",")
            b = self.parse_expr()
            self.expect("op", ")")
            return IfElse(BinaryOp("eq", a, b), Literal(None), a)
        if name_l in ("greatest", "least"):
            args = [self.parse_expr()]
            while self.accept("op", ","):
                args.append(self.parse_expr())
            self.expect("op", ")")
            # n-ary kernel: a nested-IfElse fold would re-embed the
            # accumulator twice per step (2^n tree growth for wide calls).
            fn = "elementwise_max" if name_l == "greatest" else "elementwise_min"
            return FunctionCall(fn, args)
        distinct = bool(self.accept_kw("distinct"))
        args: List[Expr] = []
        if not self.accept("op", ")"):
            args.append(self.parse_expr())
            while self.accept("op", ","):
                args.append(self.parse_expr())
            self.expect("op", ")")
        if name_l in _AGG_FUNCS:
            op = {"avg": "mean", "array_agg": "list", "stddev_pop": "stddev",
                  "var_pop": "variance", "mean": "mean"}.get(name_l, name_l)
            if distinct:
                if name_l != "count":
                    raise SQLParseError(
                        f"DISTINCT inside {name_l}() is not supported (only COUNT(DISTINCT ...))"
                    )
                op = "count_distinct"
            return AggOp(op, args[0] if args else Literal(1))
        if name_l in ("row_number", "rank", "dense_rank", "percent_rank"):
            from daft_tpu_torch.expressions.expr import WindowExpr

            return WindowExpr(name_l, None, (), (), ())
        if name_l in ("lag", "lead"):
            from daft_tpu_torch.expressions.expr import WindowExpr

            def _int_lit(e, what):
                if isinstance(e, Literal) and isinstance(e.value, int):
                    return e.value
                if isinstance(e, UnaryOp) and e.op in ("neg", "negate") \
                        and isinstance(e.child, Literal) \
                        and isinstance(e.child.value, int):
                    return -e.child.value
                raise SQLParseError(f"{name_l} {what} must be an integer literal")

            offset = _int_lit(args[1], "offset") if len(args) > 1 else 1
            fn = name_l
            if offset < 0:  # lag(v, -n) == lead(v, n)
                fn = "lead" if name_l == "lag" else "lag"
                offset = -offset
            default = None
            if len(args) > 2:
                if not isinstance(args[2], Literal):
                    raise SQLParseError(f"{name_l} default must be a literal")
                default = args[2].value
            kwargs = {"offset": offset, "default": default}
            return WindowExpr(fn, args[0], (), (), (), None, kwargs)
        if name_l in ("first_value", "last_value"):
            from daft_tpu_torch.expressions.expr import WindowExpr

            return WindowExpr(name_l, args[0], (), (), ())
        if name_l == "abs":
            return UnaryOp("abs", args[0])
        if name_l in ("pow", "power"):
            return BinaryOp("pow", args[0], args[1])
        if name_l == "if":
            return IfElse(args[0], args[1], args[2])
        if name_l == "date_trunc":
            unit = args[0]
            assert isinstance(unit, Literal)
            return FunctionCall("dt_truncate", [args[1]], {"interval": f"1 {unit.value}"})
        if name_l == "substr" or name_l == "substring":
            # SQL is 1-based: shift start by -1 as an expression so per-row
            # (column) starts work too.
            start = BinaryOp("sub", args[1], Literal(1))
            if isinstance(args[1], Literal):
                start = Literal(max(0, args[1].value - 1))
            call_args = [args[0], start]
            if len(args) >= 3:
                call_args.append(args[2])
            return FunctionCall("str_substr", call_args)
        kernel = _FUNC_MAP.get(name_l, name_l)
        if kernel is None:
            kernel = name_l
        return FunctionCall(kernel, args)

    def _maybe_over(self, e: Expr) -> Expr:
        """``fn(...) OVER ([PARTITION BY ...] [ORDER BY ...] [ROWS BETWEEN
        ...])`` → WindowExpr (reference: daft-sql window-function planning
        over Expr::Over)."""
        p = self.peek()
        if not (p.kind == "ident" and p.value.lower() == "over"):
            return e
        from daft_tpu_torch.expressions.expr import WindowExpr

        self.next()
        self.expect("op", "(")
        partition: List[Expr] = []
        order: List[Expr] = []
        desc: List[bool] = []
        frame = None
        if self.peek().kind == "ident" and self.peek().value.lower() == "partition":
            self.next()
            self.expect("kw", "by")
            partition.append(self.parse_expr())
            while self.accept("op", ","):
                partition.append(self.parse_expr())
        if self.accept_kw("order"):
            self.expect("kw", "by")
            while True:
                order.append(self.parse_expr())
                d = False
                if self.accept_kw("desc"):
                    d = True
                else:
                    self.accept_kw("asc")
                desc.append(d)
                if not self.accept("op", ","):
                    break
        if self.peek().kind == "ident" and self.peek().value.lower() == "rows":
            self.next()
            self.expect("kw", "between")
            start = self._parse_frame_bound()
            self.expect("kw", "and")
            end = self._parse_frame_bound()
            frame = ("rows", start, end)
        self.expect("op", ")")
        if isinstance(e, WindowExpr):
            return WindowExpr(e.func, e.child, tuple(partition), tuple(order),
                              tuple(desc), frame, e.kwargs)
        if isinstance(e, AggOp):
            if frame is None and order:
                # SQL default for an ordered aggregate window is a running
                # frame (standard: RANGE UNBOUNDED PRECEDING..CURRENT ROW;
                # lowered as ROWS — identical except on order-key ties).
                from daft_tpu_torch.window import Window

                frame = ("rows", Window.unbounded_preceding, Window.current_row)
            return WindowExpr(e.op, e.child, tuple(partition), tuple(order),
                              tuple(desc), frame)
        raise SQLParseError("OVER requires an aggregate or window function")

    def _parse_frame_bound(self):
        from daft_tpu_torch.window import Window

        t = self.peek()
        word = t.value.lower() if t.kind in ("ident", "kw") else ""
        if word == "unbounded":
            self.next()
            direction = self._ident_like().lower()
            return (Window.unbounded_preceding if direction == "preceding"
                    else Window.unbounded_following)
        if word == "current":
            self.next()
            self._ident_like()  # ROW
            return Window.current_row
        v = self._literal_value()
        direction = self._ident_like().lower()
        return -int(v) if direction == "preceding" else int(v)

    def _parse_type(self) -> DataType:
        name = self._ident_like().lower()
        if name in _TYPE_MAP:
            return _TYPE_MAP[name]()
        raise SQLParseError(f"Unknown type {name!r}")

    def _literal_value(self):
        t = self.next()
        if t.kind == "op" and t.value == "-":
            inner = self._literal_value()
            if not isinstance(inner, (int, float)):
                raise SQLParseError("Expected numeric literal after '-'")
            return -inner
        if t.kind == "int":
            return int(t.value)
        if t.kind == "float":
            return float(t.value)
        if t.kind == "str":
            return t.value[1:-1].replace("''", "'")
        if t.kind == "kw" and t.value in ("true", "false"):
            return t.value == "true"
        if t.kind == "kw" and t.value == "null":
            return None
        raise SQLParseError(f"Expected literal, got {t.value!r} at {t.pos}")


def _parse_interval(raw: str):
    import datetime

    m = re.match(r"(\d+)\s+(\w+)", raw)
    if not m:
        raise SQLParseError(f"Bad interval: {raw!r}")
    n, unit = int(m.group(1)), m.group(2).lower().rstrip("s")
    mapping = {"day": "days", "hour": "hours", "minute": "minutes",
               "second": "seconds", "week": "weeks", "millisecond": "milliseconds",
               "microsecond": "microseconds"}
    if unit not in mapping:
        raise SQLParseError(f"Unsupported interval unit {unit!r}")
    return datetime.timedelta(**{mapping[unit]: n})


def parse_sql(text: str) -> SelectStmt:
    return Parser(text).parse_statement()


def parse_expression(text: str):
    """Parse a scalar SQL expression -> Expression (daft.sql_expr)."""
    from daft_tpu_torch.expressions.expression import Expression

    p = Parser(text)
    e = p.parse_expr()
    p.expect("eof")
    return Expression(e)
