"""``daft_tpu_torch.sql`` / ``sql_expr`` (``daft_tpu_torch/sql/``) against the
JAX package's ``daft_tpu.sql``, on the CPU.

Mirrors ``tests/test_sql.py`` case for case: each query runs through both
packages on the same tables (``device="cpu"`` for the port) and must give
the JAX package's rows and the value that the JAX test asserts, window
functions, ``count(DISTINCT ...)``, ``INTERSECT ALL`` and ``ARRAY[...]``
included (ROADMAP A.3.5). The cases that need what the port lacks assert
that it raises ``DaftNotImplementedError`` naming the item: sessions,
catalogs, a ``SET`` of a session variable and ``USE`` (A.8), ``EXPLAIN
ANALYZE`` (A.9.5). A ``SET`` of an execution or planning config key applies
live, as in the JAX package.
The connector cases (``read_sql``) are not SQL-planner cases and stay with
the JAX package (A.8).
"""

import warnings

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.errors import DaftNotImplementedError

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")

PEOPLE = {"name": ["ann", "bob", "cat", "dan"], "age": [25, 32, 19, 45],
          "dept": ["eng", "eng", "ops", "ops"]}
SALARIES = {"name": ["ann", "bob", "cat", "dan"], "salary": [100.0, 120.0, 80.0, 95.0]}
CUST = {"c_id": [1, 2, 3], "name": ["a", "b", "c"]}
ORDERS = {"o_id": [10, 11], "c_id": [1, 3], "total": [5.0, 50.0]}


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu"):
            yield


def _both(query: str, **tables) -> dict:
    """The port's rows, after holding them equal to the JAX package's."""
    outs = []
    for pkg in (daft_tpu, daft_tpu_torch):
        frames = {k: pkg.from_pydict(v) for k, v in tables.items()}
        outs.append(pkg.sql(query, **frames).to_pydict())
    assert outs[1] == outs[0]
    return outs[1]


# (id, query, tables, expected rows) — tests/test_sql.py's assertions.
CASES = [
    ("select_where_order",
     "SELECT name, age + 1 AS age1 FROM people WHERE age > 20 ORDER BY age DESC",
     {"people": PEOPLE}, {"name": ["dan", "bob", "ann"], "age1": [46, 33, 26]}),
    ("join_groupby",
     "SELECT dept, sum(salary) AS total, count(*) AS n FROM people "
     "JOIN salaries ON people.name = salaries.name GROUP BY dept ORDER BY dept",
     {"people": PEOPLE, "salaries": SALARIES},
     {"dept": ["eng", "ops"], "total": [220.0, 175.0], "n": [2, 2]}),
    ("case_when",
     "SELECT CASE WHEN age >= 30 THEN 'senior' ELSE 'junior' END AS level "
     "FROM people ORDER BY name", {"people": PEOPLE},
     {"level": ["junior", "senior", "junior", "senior"]}),
    ("cte", "WITH adults AS (SELECT * FROM people WHERE age >= 21) "
     "SELECT count(*) AS n FROM adults", {"people": PEOPLE}, {"n": [3]}),
    ("having", "SELECT dept, avg(age) AS m FROM people GROUP BY dept "
     "HAVING count(*) > 1 ORDER BY dept", {"people": PEOPLE},
     {"dept": ["eng", "ops"], "m": [28.5, 32.0]}),
    ("like", "SELECT upper(name) AS u FROM people WHERE name LIKE 'a%'",
     {"people": PEOPLE}, {"u": ["ANN"]}),
    ("in_between", "SELECT name FROM people WHERE age BETWEEN 20 AND 40 AND dept IN ('eng') "
     "ORDER BY name", {"people": PEOPLE}, {"name": ["ann", "bob"]}),
    ("cast_concat", "SELECT cast(age AS string) || '!' AS s FROM people ORDER BY age LIMIT 1",
     {"people": PEOPLE}, {"s": ["19!"]}),
    ("distinct", "SELECT DISTINCT dept FROM people ORDER BY dept", {"people": PEOPLE},
     {"dept": ["eng", "ops"]}),
    ("union_all", "SELECT name FROM people UNION ALL SELECT name FROM people ORDER BY name",
     {"people": PEOPLE}, {"name": ["ann", "ann", "bob", "bob", "cat", "cat", "dan", "dan"]}),
    ("union", "SELECT dept FROM people UNION SELECT dept FROM people ORDER BY dept",
     {"people": PEOPLE}, {"dept": ["eng", "ops"]}),
    ("derived_table", "SELECT count(*) AS n FROM (SELECT * FROM people WHERE dept = 'eng') t",
     {"people": PEOPLE}, {"n": [2]}),
    ("is_null", "SELECT count(*) AS n FROM df WHERE x IS NULL", {"df": {"x": [1, None, 3]}},
     {"n": [1]}),
    ("is_not_null", "SELECT count(*) AS n FROM df WHERE x IS NOT NULL",
     {"df": {"x": [1, None, 3]}}, {"n": [2]}),
    ("left_semi_join", "SELECT name FROM people LEFT SEMI JOIN salaries "
     "ON people.name = salaries.name ORDER BY name", {"people": PEOPLE, "salaries": SALARIES},
     {"name": ["ann", "bob", "cat", "dan"]}),
    ("anti_join", "SELECT name FROM people ANTI JOIN only ON people.name = only.name "
     "ORDER BY name", {"people": PEOPLE, "only": {"name": ["ann"], "x": [1]}},
     {"name": ["bob", "cat", "dan"]}),
    ("union_order_limit_applies_to_whole",
     "SELECT age FROM people UNION ALL SELECT age FROM people ORDER BY age LIMIT 3",
     {"people": PEOPLE}, {"age": [19, 19, 25]}),
    ("in_negative_numbers", "SELECT x FROM df WHERE x IN (-1, 3) ORDER BY x",
     {"df": {"x": [-1, 2, 3]}}, {"x": [-1, 3]}),
    ("substr_per_row", "SELECT substr(s, start, n) AS sub FROM df",
     {"df": {"s": ["abcdef", "xyzw"], "start": [2, 1], "n": [3, 2]}}, {"sub": ["bcd", "xy"]}),
    ("in_subquery", "SELECT name FROM cust WHERE c_id IN (SELECT c_id FROM orders) "
     "ORDER BY name", {"cust": CUST, "orders": ORDERS}, {"name": ["a", "c"]}),
    ("not_in_subquery", "SELECT name FROM cust WHERE c_id NOT IN (SELECT c_id FROM orders)",
     {"cust": CUST, "orders": ORDERS}, {"name": ["b"]}),
    ("exists_correlated", "SELECT name FROM cust WHERE NOT EXISTS (SELECT 1 FROM orders "
     "WHERE orders.c_id = cust.c_id AND total > 10.0) ORDER BY name",
     {"cust": CUST, "orders": ORDERS}, {"name": ["a", "b"]}),
    ("scalar_subquery_uncorrelated",
     "SELECT name FROM cust WHERE c_id < (SELECT avg(c_id) FROM orders)",
     {"cust": CUST, "orders": ORDERS}, {"name": ["a"]}),
    ("scalar_subquery_correlated", "SELECT part, qty FROM items WHERE qty < (SELECT 0.5 * "
     "avg(qty) FROM items i2 WHERE i2.part = items.part) ORDER BY part",
     {"items": {"part": [1, 1, 2, 2], "qty": [1.0, 9.0, 4.0, 6.0]}},
     {"part": [1], "qty": [1.0]}),
    ("exists_non_equi_self_correlation", "SELECT sk FROM li l1 WHERE EXISTS (SELECT 1 FROM "
     "li l2 WHERE l2.ok = l1.ok AND l2.sk <> l1.sk) ORDER BY sk",
     {"li": {"ok": [1, 1, 2, 3], "sk": [10, 20, 30, 40]}}, {"sk": [10, 20]}),
    ("not_exists_non_equi_self_correlation", "SELECT sk FROM li l1 WHERE NOT EXISTS (SELECT 1 "
     "FROM li l2 WHERE l2.ok = l1.ok AND l2.sk <> l1.sk) ORDER BY sk",
     {"li": {"ok": [1, 1, 2, 3], "sk": [10, 20, 30, 40]}}, {"sk": [30, 40]}),
    ("in_subquery_with_grouped_having", "SELECT name FROM cust WHERE c_id IN (SELECT c_id "
     "FROM orders GROUP BY c_id HAVING sum(total) > 10.0)", {"cust": CUST, "orders": ORDERS},
     {"name": ["c"]}),
    ("scalar_subquery_in_having", "SELECT c_id, sum(total) AS t FROM orders GROUP BY c_id "
     "HAVING sum(total) > (SELECT sum(total) * 0.5 FROM orders)", {"orders": ORDERS},
     {"c_id": [3], "t": [50.0]}),
    ("self_join_aliases", "SELECT e.name, m.name AS mgr_name FROM emp e "
     "JOIN emp m ON e.mgr = m.id WHERE m.name = 'a'",
     {"emp": {"id": [1, 2], "mgr": [2, 1], "name": ["a", "b"]}},
     {"name": ["b"], "mgr_name": ["a"]}),
    ("self_join_qualified_select_and_order", "SELECT e.id, e.sal, m.sal AS mgr_sal FROM emp e "
     "JOIN emp m ON e.mgr = m.id ORDER BY m.sal DESC",
     {"emp": {"id": [1, 2, 3], "mgr": [2, 3, 1], "sal": [10, 20, 30]}},
     {"id": [2, 1, 3], "sal": [20, 10, 30], "mgr_sal": [30, 20, 10]}),
    ("qualified_ambiguous_key_both_sides", "SELECT a.v, b.v AS bv FROM t a JOIN t b "
     "ON a.id = b.id ORDER BY a.v", {"t": {"id": [1, 2], "v": [10, 20]}},
     {"v": [10, 20], "bv": [10, 20]}),
    ("extract_year", "SELECT EXTRACT(YEAR FROM DATE '2024-01-02') AS y", {}, {"y": [2024]}),
    ("extract_quarter", "SELECT EXTRACT(QUARTER FROM DATE '2024-05-02') AS q", {}, {"q": [2]}),
    ("substring_from_for", "SELECT SUBSTRING('hello' FROM 2 FOR 3) AS s", {}, {"s": ["ell"]}),
    ("substring_from", "SELECT SUBSTRING('hello' FROM 2) AS s", {}, {"s": ["ello"]}),
    ("position", "SELECT POSITION('l' IN 'hello') AS p", {}, {"p": [3]}),
    ("position_absent", "SELECT POSITION('z' IN 'hello') AS p", {}, {"p": [0]}),
    ("nullif", "SELECT NULLIF(1, 1) AS a, NULLIF(2, 1) AS b", {}, {"a": [None], "b": [2]}),
    ("greatest_least", "SELECT GREATEST(1,5,3) AS g, LEAST(4,2,9) AS l", {},
     {"g": [5], "l": [2]}),
    ("try_cast", "SELECT TRY_CAST('abc' AS INT) AS x, TRY_CAST('7' AS INT) AS y", {},
     {"x": [None], "y": [7]}),
    ("union_all_literals", "SELECT 1 AS x UNION ALL SELECT 1 AS x", {}, {"x": [1, 1]}),
    ("intersect", "SELECT 1 AS x INTERSECT SELECT 1 AS x", {}, {"x": [1]}),
    ("except", "SELECT 1 AS x EXCEPT SELECT 1 AS x", {}, {"x": []}),
    ("values", "VALUES (1, 'a'), (2, 'b')", {}, {"col0": [1, 2], "col1": ["a", "b"]}),
    ("values_derived", "SELECT x + 1 AS y FROM (VALUES (1),(2),(3)) v(x) WHERE x > 1", {},
     {"y": [3, 4]}),
    ("values_join", "SELECT a.x, b.y FROM (VALUES (1),(2)) a(x) JOIN (VALUES (1, 'one'), "
     "(2, 'two')) b(x, y) ON a.x = b.x ORDER BY a.x", {}, {"x": [1, 2], "y": ["one", "two"]}),
    ("current_date_timestamp_not_null", "SELECT CURRENT_DATE IS NOT NULL AS a, "
     "CURRENT_TIMESTAMP IS NOT NULL AS b", {}, {"a": [True], "b": [True]}),
    ("except_left_associative", "SELECT 1 AS x EXCEPT SELECT 1 AS x EXCEPT SELECT 1 AS x", {},
     {"x": []}),
    ("greatest_least_nary", "SELECT GREATEST(a,b,c) g, LEAST(a,b,c) l FROM df",
     {"df": {"a": [1, 5, None], "b": [3, 2, 4], "c": [2, 9, 1]}},
     {"g": [3, 9, 4], "l": [1, 2, 1]}),
    ("greatest_bool", "SELECT GREATEST(a,b) g FROM df",
     {"df": {"a": [True, False, None], "b": [False, True, True]}}, {"g": [True, True, True]}),
    ("greatest_null_literal", "SELECT GREATEST(a, NULL) g FROM df", {"df": {"a": [1, 2]}},
     {"g": [1, 2]}),
    ("greatest_least_mixed_bool_int", "SELECT GREATEST(b, i) AS g, LEAST(b, i) AS l FROM t",
     {"t": {"b": [True, False, None], "i": [0, 5, 2]}}, {"g": [1, 5, 2], "l": [0, 0, 2]}),
    ("ne_exists_nulls", "SELECT ok FROM li l1 WHERE EXISTS (SELECT 1 FROM li l2 "
     "WHERE l2.ok = l1.ok AND l2.sk <> l1.sk) ORDER BY ok",
     {"li": {"ok": [1, 1, 2, 3, 1], "sk": [10, 20, 30, 40, None]}}, {"ok": [1, 1]}),
    ("ne_not_exists_nulls", "SELECT ok, sk FROM li l1 WHERE NOT EXISTS (SELECT 1 FROM li l2 "
     "WHERE l2.ok = l1.ok AND l2.sk <> l1.sk) ORDER BY ok",
     {"li": {"ok": [1, 1, 2, 3, 1], "sk": [10, 20, 30, 40, None]}},
     {"ok": [1, 2, 3], "sk": [None, 30, 40]}),
    ("exists_under_or", "SELECT c_id FROM cust WHERE c_id = 1 OR EXISTS (SELECT 1 FROM orders "
     "WHERE orders.c_id = cust.c_id) ORDER BY c_id",
     {"cust": {"c_id": [1, 2, 3]}, "orders": {"c_id": [3]}}, {"c_id": [1, 3]}),
    ("range", "SELECT count(*) AS n FROM range(10)", {}, {"n": [10]}),
    ("range_step", "SELECT id FROM range(2, 8, 2) ORDER BY id", {}, {"id": [2, 4, 6]}),
]


@pytest.mark.parametrize("query, tables, want", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_query_equals_the_jax_package(query, tables, want):
    assert _both(query, **tables) == want


def test_sql_expr():
    people = daft_tpu_torch.from_pydict(PEOPLE)
    out = people.where(daft_tpu_torch.sql_expr("age > 30 AND dept = 'ops'")).to_pydict()
    assert out["name"] == ["dan"]


def test_caller_frame_lookup():
    people = daft_tpu_torch.from_pydict(PEOPLE)  # noqa: F841 — found by name
    assert daft_tpu_torch.sql("SELECT count(*) AS n FROM people").to_pydict() == {"n": [4]}


def test_parse_errors_name_the_jax_packages_token():
    from daft_tpu.sql.parser import SQLParseError as JParseError
    from daft_tpu_torch.sql.parser import SQLParseError

    for bad in ("1 +", "a + * b", "(a", "cast(a as blob)"):
        msgs = []
        for pkg, err in ((daft_tpu, JParseError), (daft_tpu_torch, SQLParseError)):
            with pytest.raises(err) as e:
                pkg.sql_expr(bad)
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0]
    for bad in ("SELECT FROM t", "SELECT a FROM t WHERE", "SELECT a FROM t JOIN u",
                "SELECT a b c FROM t", "SELECT * FROM t LIMIT x"):
        msgs = []
        for pkg in (daft_tpu, daft_tpu_torch):
            with pytest.raises(Exception) as e:
                pkg.sql(bad, t=pkg.from_pydict({"a": [1]}), u=pkg.from_pydict({"a": [1]}))
            msgs.append((type(e.value).__name__, str(e.value)))
        assert msgs[1] == msgs[0]
    with pytest.raises(Exception, match="Unknown table"):
        daft_tpu_torch.sql("SELECT * FROM nonexistent_table_xyz")


def test_distinct_in_sum_rejected():
    from daft_tpu_torch.sql.parser import SQLParseError

    with pytest.raises(SQLParseError):
        daft_tpu_torch.sql("SELECT sum(DISTINCT age) FROM people",
                           people=daft_tpu_torch.from_pydict(PEOPLE))


def test_count_distinct_raises_naming_its_item():
    """``count(DISTINCT ...)`` runs (A.3.5 brought its list partials), global
    and grouped, with the JAX package's rows."""
    people = {**PEOPLE, "age": [25, 32, 25, None]}
    assert _both("SELECT count(DISTINCT age) AS n FROM people", people=people) == {"n": [2]}
    assert _both("SELECT dept, count(DISTINCT age) AS n FROM people GROUP BY dept "
                 "ORDER BY dept", people=people) == {"dept": ["eng", "ops"], "n": [2, 1]}


def test_correlated_complex_subquery_rejected():
    cust = daft_tpu_torch.from_pydict({"c_id": [1, 2], "total": [1.0, 1000.0]})
    orders = daft_tpu_torch.from_pydict({"c_id": [1, 3], "total": [5.0, 50.0]})
    with pytest.raises(Exception, match="correlated reference"):
        daft_tpu_torch.sql("SELECT c_id FROM cust WHERE c_id IN (SELECT c_id FROM orders "
                           "WHERE total > cust.total GROUP BY c_id)", cust=cust, orders=orders)


def test_ne_exists_takes_the_aggregate_rewrite():
    """The ``<>``-EXISTS decorrelation is a grouped min/max and a left join,
    in both packages: no row-id node in the optimized plan."""
    from daft_tpu_torch.logical import plan as lp
    from daft_tpu_torch.logical.optimizer import Optimizer

    li = daft_tpu_torch.from_pydict({"ok": [1, 1, 2, 3, 1], "sk": [10, 20, 30, 40, None]})
    df = daft_tpu_torch.sql("SELECT ok FROM li l1 WHERE EXISTS (SELECT 1 FROM li l2 "
                            "WHERE l2.ok = l1.ok AND l2.sk <> l1.sk)", li=li)
    plan = Optimizer().optimize(df._builder.plan)
    aggs = [repr(n.agg_exprs) for n in plan.walk() if isinstance(n, lp.Aggregate)]
    assert len(aggs) == 1 and "min" in aggs[0] and "max" in aggs[0]
    # The left join became inner: the flag rejects its padded rows.
    assert [j.how for j in plan.walk() if isinstance(j, lp.Join)] == ["inner"]


def test_interval_and_timestamp_literals():
    out = _both("SELECT DATE '2024-01-01' + INTERVAL '1' DAY AS d")
    assert str(out["d"][0])[:10] == "2024-01-02"
    t = _both("SELECT TIMESTAMP '2024-01-02T03:04:05' AS t")["t"][0]
    assert (t.year, t.hour) == (2024, 3)
    assert list(_both("SELECT INTERVAL '1 day' d")) == ["d"]


def test_setop_precedence():
    got = _both("SELECT 1 AS x UNION SELECT 2 AS x INTERSECT SELECT 2 AS x")
    assert sorted(got["x"]) == [1, 2]


def test_values_width_mismatch():
    with pytest.raises(Exception, match="columns"):
        daft_tpu_torch.sql("VALUES (1, 2), (3)")


def test_intersect_all_raises_naming_its_item():
    """``INTERSECT ALL`` / ``EXCEPT ALL`` run through the row_number window
    (A.3.5), as multisets, with the JAX package's rows."""
    got = _both("SELECT x FROM (VALUES (1),(1),(1),(2)) a(x) INTERSECT ALL "
                "SELECT x FROM (VALUES (1),(1),(3)) b(x)")
    assert sorted(got["x"]) == [1, 1]
    got = _both("SELECT x FROM (VALUES (1),(1),(1),(2)) a(x) EXCEPT ALL "
                "SELECT x FROM (VALUES (1),(3)) b(x)")
    assert sorted(got["x"]) == [1, 1, 2]


def test_array_literal_raises_naming_its_item():
    """``ARRAY[...]`` packs its items into a list (A.3.5), as in the JAX
    package."""
    assert _both("SELECT ARRAY[1,2,3] AS a") == {"a": [[1, 2, 3]]}
    assert _both("SELECT ARRAY[v, v * 2] AS a FROM t", t={"v": [1, None]}) == \
        {"a": [[1, 2], [None, None]]}


def test_wide_greatest_stays_linear():
    df = daft_tpu_torch.from_pydict({"a": [1, 5, None], "b": [3, 2, 4], "c": [2, 9, 1]})
    cols = ",".join(["a", "b", "c"] * 12)
    assert daft_tpu_torch.sql(f"SELECT GREATEST({cols}) g FROM df", df=df).to_pydict() == \
        {"g": [3, 9, 4]}


def test_current_timestamp_is_one_instant_per_statement():
    import datetime

    df = daft_tpu_torch.from_pydict({"i": list(range(400))})
    with daft_tpu_torch.execution_config_ctx(default_morsel_size=50, num_compute_threads=4):
        out = daft_tpu_torch.sql("SELECT i, CURRENT_TIMESTAMP t, CURRENT_DATE d FROM df",
                                 df=df).to_pydict()
    assert len(set(out["t"])) == 1 and len(set(out["d"])) == 1
    now = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
    assert abs((now - out["t"][0]).total_seconds()) < 120


WINDOW_QUERIES = [
    "SELECT g, v, sum(v) OVER (PARTITION BY g) AS s FROM t",
    "SELECT row_number() OVER (PARTITION BY g ORDER BY v DESC) AS rn FROM t",
    "SELECT lag(v) OVER (PARTITION BY g ORDER BY v) AS prev FROM t",
    "SELECT sum(v) OVER (PARTITION BY g ORDER BY v ROWS BETWEEN UNBOUNDED PRECEDING "
    "AND CURRENT ROW) AS run FROM t",
    "SELECT rank() OVER (ORDER BY v) AS r, dense_rank() OVER (ORDER BY v) AS dr FROM t",
    "SELECT avg(v) OVER (ORDER BY v ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) AS ma FROM t",
    "SELECT v, sum(v) OVER (ORDER BY v) AS s FROM t",
    "SELECT v, lag(v, -1) OVER (ORDER BY v) AS nxt FROM t",
]


@pytest.mark.parametrize("query", WINDOW_QUERIES)
def test_window_functions_raise_naming_their_item(query):
    """Window functions in SQL (A.3.5): the JAX package's rows and order, the
    running-frame default of an ordered aggregate included."""
    assert _both(query, t={"g": ["a", "a", "a", "b", "b"], "v": [1, 2, 3, 5, 2]})


SESSION_STATEMENTS = [
    "CREATE TEMP TABLE adults AS SELECT * FROM people WHERE age >= 21",
    "CREATE OR REPLACE TABLE adults AS SELECT 1 AS x",
    "DROP TABLE adults",
    "DROP TABLE IF EXISTS adults",
    "INSERT INTO t SELECT name, age FROM people",
    "INSERT INTO t VALUES ('zed', 99)",
    "SHOW TABLES",
    "SHOW TABLES LIKE 'bar%'",
    "USE cat2",
    "SET my_session_variable = 4096",
    "EXPLAIN CREATE TABLE nope AS SELECT * FROM people",
]


@pytest.mark.parametrize("statement", SESSION_STATEMENTS)
def test_session_statements_raise_naming_their_item(statement):
    with pytest.raises(DaftNotImplementedError, match=r"A\.8"):
        daft_tpu_torch.sql(statement, people=daft_tpu_torch.from_pydict(PEOPLE))


def test_set_applies_a_config_key_live_as_in_the_jax_package():
    """``SET`` of an execution or planning config key changes the context's
    config at once and returns its one-row frame, in both packages."""
    outs = []
    for pkg in (daft_tpu, daft_tpu_torch):
        ctx = pkg.get_context()
        with pkg.execution_config_ctx(), pkg.planning_config_ctx():
            rows = [pkg.sql(q).to_pydict() for q in (
                "SET default_morsel_size = 4096", "SET num_preview_rows = 3",
                "SET default_io_config = 'cfg'")]
            outs.append((rows, ctx.execution_config.default_morsel_size,
                         ctx.execution_config.num_preview_rows,
                         ctx.planning_config.default_io_config))
        assert ctx.execution_config.default_morsel_size == 256 * 1024
    assert outs[1] == outs[0]
    assert outs[1][0][0] == {"name": ["default_morsel_size"], "value": ["4096"]}
    assert outs[1][1:] == (4096, 3, "cfg")


def test_explain():
    out = daft_tpu_torch.sql("EXPLAIN SELECT name FROM people WHERE age > 20",
                             people=daft_tpu_torch.from_pydict(PEOPLE)).to_pydict()
    assert len(out["plan"]) == 1
    text = out["plan"][0]
    assert "Filter" in text and "== Optimized Logical Plan ==" in text
    assert "== Physical Plan ==" in text


def test_explain_analyze_raises_naming_its_item():
    with pytest.raises(DaftNotImplementedError, match=r"A\.9\.5"):
        daft_tpu_torch.sql("EXPLAIN ANALYZE SELECT count(*) AS n FROM people",
                           people=daft_tpu_torch.from_pydict(PEOPLE))


def test_describe():
    people = {"people": PEOPLE}
    d = _both("DESCRIBE people", **people)
    assert d["column_name"] == ["name", "age", "dept"]
    d2 = _both("DESCRIBE SELECT age + 1 AS b FROM people", **people)
    assert d2["column_name"] == ["b"]


def test_table_function_read_parquet(tmp_path):
    daft_tpu_torch.from_pydict(PEOPLE).write_parquet(str(tmp_path))
    assert _both(f"SELECT count(*) AS n FROM read_parquet('{tmp_path}')") == {"n": [4]}
    out = _both(f"SELECT p.name FROM read_parquet('{tmp_path}') p WHERE p.age > 40")
    assert out["name"] == ["dan"]


def test_table_functions_read_csv_and_json(tmp_path):
    daft_tpu_torch.from_pydict(PEOPLE).write_csv(str(tmp_path / "csv"))
    daft_tpu_torch.from_pydict(PEOPLE).write_json(str(tmp_path / "json"))
    for fn, sub in (("read_csv", "csv"), ("read_json", "json")):
        out = _both(f"SELECT name FROM {fn}('{tmp_path / sub}') WHERE age < 30 ORDER BY name")
        assert out == {"name": ["ann", "cat"]}
