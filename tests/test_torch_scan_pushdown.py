"""The port's scan pushdowns (daft_tpu_torch/logical/optimizer.py:
PushDownFilter, PushDownLimit's scan case, PushDownProjection) against the
JAX package's, on the CPU.

Mirrors tests/test_optimizer.py's filter, projection and limit pushdowns into
a scan and its filter pushdown through a join. For each query both packages
optimize the same plan over the same files: every scan of the optimized plan
carries the same ``Pushdowns`` (columns, filters by their printed form,
limit), the same files survive hive pruning, and the results are equal
(exact).
"""

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.logical import plan as lp
from daft_tpu_torch.logical.optimizer import Optimizer

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")

PKGS = (daft_tpu, daft_tpu_torch)


@pytest.fixture(autouse=True)
def _configs():
    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
        yield


def _optimized(df):
    return Optimizer().optimize(df._builder.plan)


def _scans(df):
    plan = df._builder.optimize().plan
    return [n for n in plan.walk() if type(n).__name__ == "ScanSource"]


def _pushdowns(df):
    return [(s.pushdowns.columns, repr(s.pushdowns.filters), s.pushdowns.limit)
            for s in _scans(df)]


@pytest.fixture
def files(tmp_path):
    daft_tpu_torch.from_pydict({"a": list(range(100)), "b": [f"x{i % 5}" for i in range(100)],
                                "c": [i * 0.5 for i in range(100)]}).write_parquet(
        str(tmp_path / "t"))
    daft_tpu_torch.from_pydict({"a": list(range(0, 100, 3)), "d": list(range(34))}).write_parquet(
        str(tmp_path / "u"))
    daft_tpu_torch.from_pydict({"k": ["p", "q", "r"] * 4, "n": [1, 2] * 6,
                                "v": list(range(12))}).write_parquet(
        str(tmp_path / "h"), partition_cols=["k", "n"])
    return str(tmp_path)


def test_filter_pushdown_into_scan(files):
    df = daft_tpu_torch.read_parquet(files + "/t")
    plan = _optimized(df.select("a", "b").where(daft_tpu_torch.col("a") > 1))
    scans = [n for n in plan.walk() if isinstance(n, lp.ScanSource)]
    assert scans and scans[0].pushdowns.filters is not None


def test_projection_pushdown_into_scan(files):
    plan = _optimized(daft_tpu_torch.read_parquet(files + "/t").select("a"))
    scans = [n for n in plan.walk() if isinstance(n, lp.ScanSource)]
    assert scans[0].pushdowns.columns == ("a",)
    assert plan.schema.column_names() == ["a"]


def test_limit_pushdown(files):
    plan = _optimized(daft_tpu_torch.read_parquet(files + "/t").limit(5))
    scans = [n for n in plan.walk() if isinstance(n, lp.ScanSource)]
    assert scans[0].pushdowns.limit == 5
    assert isinstance(plan, lp.Limit)  # the limit stays above the scan


def test_limit_with_offset_or_filter_is_not_pushed(files):
    c = daft_tpu_torch.col
    for df in (daft_tpu_torch.read_parquet(files + "/t").limit(5, offset=2),
               daft_tpu_torch.read_parquet(files + "/t").where(c("a") > 3).limit(5)):
        scans = [n for n in _optimized(df).walk() if isinstance(n, lp.ScanSource)]
        assert scans[0].pushdowns.limit is None


def test_filter_merge():
    df = daft_tpu_torch.from_pydict({"a": [1, 2, 3]})
    c = daft_tpu_torch.col
    q = df.where(c("a") > 1).where(c("a") < 3)
    assert len([n for n in _optimized(q).walk() if isinstance(n, lp.Filter)]) == 1
    assert q.to_pydict() == {"a": [2]}


def test_filter_pushdown_through_join():
    left = daft_tpu_torch.from_pydict({"k": [1, 2], "a": [10, 20]})
    right = daft_tpu_torch.from_pydict({"k": [1, 2], "b": [100, 200]})
    joined = left.join(right, on="k").where(daft_tpu_torch.col("a") > 10)
    join_nodes = [n for n in _optimized(joined).walk() if isinstance(n, lp.Join)]
    assert join_nodes
    # The filter sits below the join, on the left side.
    assert any(isinstance(n, lp.Filter) for n in join_nodes[0].children()[0].walk())
    assert joined.to_pydict()["a"] == [20]


def test_or_across_join_sides_prefilters_each_side():
    """A cross-side OR stays above the join; each side gets its implied
    prefilter (the kept conjunct keeps the answer exact)."""
    def q(pkg):
        c = pkg.col
        left = pkg.from_pydict({"k": [1, 2, 3, 4], "a": [10, 20, 30, 40]})
        right = pkg.from_pydict({"k": [1, 2, 3, 4], "b": [1, 2, 3, 4]})
        return left.join(right, on="k").where(((c("a") == 10) & (c("b") == 1))
                                              | ((c("a") == 30) & (c("b") == 3)))

    plan = _optimized(q(daft_tpu_torch))
    join = [n for n in plan.walk() if isinstance(n, lp.Join)][0]
    assert isinstance(plan.children()[0], lp.Filter) or isinstance(plan, lp.Filter)
    assert all(isinstance(side, lp.Filter) for side in join.children())
    outs = [q(pkg).sort("k").to_pydict() for pkg in PKGS]
    assert outs[0] == outs[1] == {"k": [1, 3], "a": [10, 30], "b": [1, 3]}


def _queries(files):
    """(name, build(pkg)) pairs over the same files."""
    def t(pkg):
        return pkg.read_parquet(files + "/t")

    def h(pkg):
        return pkg.read_parquet(files + "/h", hive_partitioning=True)

    return {
        "project": lambda pkg: t(pkg).select("a", (pkg.col("c") * 2).alias("c2")),
        "filter_project": lambda pkg: t(pkg).where(pkg.col("a") > 50).select("b"),
        "project_then_filter": lambda pkg: t(pkg).with_column("z", pkg.col("a") + 1)
        .where(pkg.col("z") > 90),
        "two_filters": lambda pkg: t(pkg).where(pkg.col("a") > 5).where(pkg.col("b") == "x1"),
        "limit": lambda pkg: t(pkg).limit(7),
        "sort_limit": lambda pkg: t(pkg).sort("c", desc=True).limit(3),
        "agg": lambda pkg: t(pkg).where(pkg.col("a") < 40).agg(pkg.col("c").sum().alias("s")),
        "groupby": lambda pkg: t(pkg).groupby("b").agg(pkg.col("a").count().alias("n")),
        "join": lambda pkg: t(pkg).join(pkg.read_parquet(files + "/u"), on="a")
        .where((pkg.col("d") > 3) & (pkg.col("b") != "x0")).select("a", "d"),
        "hive_prune": lambda pkg: h(pkg).where((pkg.col("k") == "q") & (pkg.col("v") > 2)),
        "hive_prune_int": lambda pkg: h(pkg).where(pkg.col("n") == 2).select("v"),
    }


@pytest.mark.parametrize("name", ["project", "filter_project", "project_then_filter",
                                  "two_filters", "limit", "sort_limit", "agg", "groupby",
                                  "join", "hive_prune", "hive_prune_int"])
def test_pushdowns_equal_the_jax_package(files, name):
    build = _queries(files)[name]
    jdf, tdf = build(daft_tpu), build(daft_tpu_torch)
    assert _pushdowns(tdf) == _pushdowns(jdf)
    # A TopN is no pass-through node for the rules: its scan reads whole.
    assert any(p != (None, "None", None) for p in _pushdowns(tdf)) == (name != "sort_limit")
    # The same files survive hive pruning.
    from daft_tpu.context import get_context as jctx
    from daft_tpu_torch.context import get_context as tctx

    for js, ts in zip(_scans(jdf), _scans(tdf)):
        jfiles = [f.path for task in js.scan_info.to_scan_tasks(
            js.pushdowns, jctx().execution_config) for f in task.files]
        tfiles = [f.path for task in ts.scan_info.to_scan_tasks(
            ts.pushdowns, tctx().execution_config) for f in task.files]
        assert tfiles == jfiles
        if name.startswith("hive_prune"):
            assert 0 < len(tfiles) < len(ts.scan_info.files())
    got, want = tdf.to_pydict(), jdf.to_pydict()
    if name in ("groupby", "join", "hive_prune", "hive_prune_int"):
        got, want = sorted(zip(*got.values())), sorted(zip(*want.values()))
    assert got == want
