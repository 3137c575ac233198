"""Hive-partitioned reads in the port (daft_tpu_torch/io/hive.py, the scan's
partition pruning and the readers' partition columns) against the JAX
package's, on the CPU.

Mirrors every test of tests/test_hive.py, the underscore case included
(``month=2024_01`` stays a string: the strict ``_INT_RE`` / ``_FLOAT_RE``
patterns). Each writes its layout once and reads it through both packages:
schemas, partition values, rows (sorted by ``v``, exact) and the pruned-file
counts of ``io_stats`` must be equal.
"""

import datetime
import math
import os

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.io.hive import _coerce, _infer_one, parse_hive_path, prune_files_by_partition

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")

PKGS = (daft_tpu, daft_tpu_torch)


@pytest.fixture(autouse=True)
def _configs():
    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
        yield


def _schema(df):
    return [(f.name, repr(f.dtype)) for f in df.schema]


def _both(fn):
    """``fn(pkg)`` for each package; the two results must be equal."""
    outs = [fn(pkg) for pkg in PKGS]
    assert outs[0] == outs[1]
    return outs[1]


@pytest.fixture
def hive_dir(tmp_path):
    """Two-level hive layout: dt=…/region=…/part.parquet (3 x 2 partitions),
    written by the port."""
    df = daft_tpu_torch.from_pydict({
        "dt": ["2024-01-01"] * 4 + ["2024-01-02"] * 4 + ["2024-01-03"] * 4,
        "region": ["eu", "us"] * 6,
        "v": list(range(12)),
    })
    d = str(tmp_path / "tbl")
    df.write_parquet(d, partition_cols=["dt", "region"])
    return d


def test_parse_hive_path():
    from daft_tpu.io.hive import parse_hive_path as jparse

    for p in ("/data/tbl/dt=2024-01-01/region=eu%2Fwest/f.parquet", "/data/plain/f.parquet"):
        assert parse_hive_path(p) == jparse(p)
    assert parse_hive_path("/data/tbl/dt=2024-01-01/region=eu%2Fwest/f.parquet") == \
        {"dt": "2024-01-01", "region": "eu/west"}
    assert parse_hive_path("/data/plain/f.parquet") == {}


def test_parse_hive_path_ignores_segments_above_root():
    p = "/data/run=3/tbl/dt=2024-01-01/f.parquet"
    assert parse_hive_path(p, root="/data/run=3/tbl") == {"dt": "2024-01-01"}
    assert parse_hive_path("s3://bkt/env=prod/t/k=1/f.pq",
                           root="s3://bkt/env=prod/t") == {"k": "1"}


def test_hive_read_scoped_to_dataset_root(tmp_path):
    base = tmp_path / "run=7" / "tbl"
    daft_tpu_torch.from_pydict({"k": ["a", "b"], "v": [1, 2]}).write_parquet(
        str(base), partition_cols=["k"])

    def run(pkg):
        df = pkg.read_parquet(str(base), hive_partitioning=True)
        return _schema(df), df.sort("v").to_pydict()

    schema, out = _both(run)
    names = [n for n, _ in schema]
    assert "run" not in names and "k" in names
    assert out["k"] == ["a", "b"]


def test_hive_read_materializes_partition_columns(hive_dir):
    def run(pkg):
        df = pkg.read_parquet(hive_dir, hive_partitioning=True)
        return _schema(df), df.sort("v").to_pydict()

    schema, out = _both(run)
    assert dict(schema)["dt"] == repr(daft_tpu_torch.DataType.date())
    assert out["v"] == list(range(12))
    assert out["region"][:2] == ["eu", "us"]
    assert set(out["dt"]) == {datetime.date(2024, 1, d) for d in (1, 2, 3)}


def test_hive_partition_dtype_inference(tmp_path):
    d = str(tmp_path / "t")
    for y, n in (("2023", "1"), ("2024", "2")):
        sub = os.path.join(d, f"year={y}", f"num={n}.5")
        os.makedirs(sub)
        daft_tpu_torch.from_pydict({"v": [1, 2]}).write_parquet(sub)

    def run(pkg):
        df = pkg.read_parquet(d, hive_partitioning=True)
        return _schema(df), df.sort("year").to_pydict()

    schema, out = _both(run)
    assert dict(schema)["year"] == repr(daft_tpu_torch.DataType.int64())
    assert dict(schema)["num"] == repr(daft_tpu_torch.DataType.float64())
    assert out["year"] == [2023, 2023, 2024, 2024]
    assert out["num"] == [1.5, 1.5, 2.5, 2.5]


def test_hive_underscore_value_stays_string(tmp_path):
    """month=2024_01 stays a string (Python's int() would read 202401)."""
    d = str(tmp_path / "t")
    for m in ("2024_01", "2024_02"):
        sub = os.path.join(d, f"month={m}")
        os.makedirs(sub)
        daft_tpu_torch.from_pydict({"v": [1]}).write_parquet(sub)

    def run(pkg):
        df = pkg.read_parquet(d, hive_partitioning=True)
        return _schema(df), df.sort("month").to_pydict()

    schema, out = _both(run)
    assert dict(schema)["month"] == repr(daft_tpu_torch.DataType.string())
    assert out["month"] == ["2024_01", "2024_02"]


def test_hive_strict_numeric_inference_unit():
    from daft_tpu.io.hive import _infer_one as jinfer

    DT = daft_tpu_torch.DataType
    cases = [(["1", "-2", "+3"], DT.int64()), (["1.5", "2", "-3e2", ".5"], DT.float64()),
             (["1.5", "nan", "-inf", "Infinity"], DT.float64())]
    cases += [(vals, DT.string()) for vals in (["1_000"], ["2024_01"], [" 1"], ["1 "],
                                               ["123\n"], ["1.5\n"])]
    for vals, want in cases:
        assert _infer_one(vals) == want, vals
        assert repr(jinfer(vals)) == repr(want), vals


def test_hive_declared_numeric_dtype_rejects_loose_values():
    DT = daft_tpu_torch.DataType
    assert _coerce("2024", DT.int64()) == 2024
    assert _coerce("2.5", DT.float64()) == 2.5
    assert math.isnan(_coerce("nan", DT.float64()))
    assert _coerce("-inf", DT.float64()) == float("-inf")
    with pytest.raises(DaftValueError):
        _coerce("2024_01", DT.int64())
    with pytest.raises(DaftValueError):
        _coerce("1_000.5", DT.float64())


def _pruned(pkg, run):
    before = pkg.io_stats()
    out = run(pkg)
    after = pkg.io_stats()
    return (out, after.files_pruned - before.files_pruned,
            after.files_opened - before.files_opened)


def test_hive_filter_prunes_files(hive_dir):
    def run(pkg):
        c = pkg.col
        return (pkg.read_parquet(hive_dir, hive_partitioning=True)
                .where((c("dt") == datetime.date(2024, 1, 2)) & (c("region") == "eu"))
                .sort("v").to_pydict())

    out, pruned, opened = _both(lambda pkg: _pruned(pkg, run))
    assert out["v"] == [4, 6]
    # 6 partition dirs; only dt=2024-01-02/region=eu survives the pushdown.
    assert pruned == 5 and opened == 1


def test_hive_prune_mixed_predicate(hive_dir):
    """Partition-only conjuncts prune; data-column conjuncts still filter."""
    def run(pkg):
        c = pkg.col
        return (pkg.read_parquet(hive_dir, hive_partitioning=True)
                .where((c("dt") > datetime.date(2024, 1, 1)) & (c("v") % 2 == 0))
                .sort("v").to_pydict())

    out, pruned, _ = _both(lambda pkg: _pruned(pkg, run))
    assert out["v"] == [4, 6, 8, 10]
    assert pruned == 2  # dt=01-01's two dirs


def test_hive_csv_roundtrip(tmp_path):
    d = str(tmp_path / "c")
    daft_tpu_torch.from_pydict({"k": ["a", "a", "b", "b"], "v": [1, 2, 3, 4]}).write_csv(
        d, partition_cols=["k"])
    out = _both(lambda pkg: pkg.read_csv(d, hive_partitioning=True)
                .where(pkg.col("k") == "b").sort("v").to_pydict())
    assert out["v"] == [3, 4] and out["k"] == ["b", "b"]


def test_hive_json_roundtrip(tmp_path):
    d = str(tmp_path / "j")
    daft_tpu_torch.from_pydict({"k": [1, 1, 2], "v": [1.5, 2.5, 3.5]}).write_json(
        d, partition_cols=["k"])
    out = _both(lambda pkg: pkg.read_json(d, hive_partitioning=True).sort("v").to_pydict())
    assert out == {"v": [1.5, 2.5, 3.5], "k": [1, 1, 2]}


def test_hive_null_partition(tmp_path):
    d = str(tmp_path / "n")
    daft_tpu_torch.from_pydict({"k": ["x", None, "y"], "v": [1, 2, 3]}).write_parquet(
        d, partition_cols=["k"])
    out = _both(lambda pkg: pkg.read_parquet(d, hive_partitioning=True).sort("v").to_pydict())
    assert out["v"] == [1, 2, 3] and out["k"] == ["x", None, "y"]


def test_hive_declared_schema_overrides_inference(hive_dir):
    def run(pkg):
        schema = pkg.Schema([pkg.Field("v", pkg.DataType.int64()),
                             pkg.Field("dt", pkg.DataType.string()),
                             pkg.Field("region", pkg.DataType.string())])
        df = pkg.read_parquet(hive_dir, schema=schema, hive_partitioning=True)
        return df.where(pkg.col("dt") == "2024-01-02").sort("v").to_pydict()

    out = _both(run)
    assert out["v"] == [4, 5, 6, 7] and set(out["dt"]) == {"2024-01-02"}


def test_hive_percent_value_roundtrip(tmp_path):
    """Values containing literal % (and / =) survive write -> read."""
    d = str(tmp_path / "p")
    vals = ["a%2Fb", "x/y", "k=v", "plain"]
    daft_tpu_torch.from_pydict({"k": vals, "v": [1, 2, 3, 4]}).write_parquet(
        d, partition_cols=["k"])
    out = _both(lambda pkg: pkg.read_parquet(d, hive_partitioning=True).sort("v").to_pydict())
    assert out["k"] == vals


def test_hive_layout_written_by_each_package_is_the_same(tmp_path):
    """Both writers lay out the same partition directories, and each reads
    the other's."""
    data = {"k": ["a", None, "b/c", "a"], "n": [1, 2, 1, 2], "v": [1.0, 2.0, 3.0, 4.0]}
    layouts, reads = [], []
    for pkg in PKGS:
        d = tmp_path / pkg.__name__
        pkg.from_pydict(data).write_parquet(str(d), partition_cols=["k", "n"])
        layouts.append(sorted(os.path.relpath(r, d) for r, _, fs in os.walk(d) if fs))
        reads.append([p.read_parquet(str(d), hive_partitioning=True).sort("v").to_pydict()
                      for p in PKGS])
    assert layouts[0] == layouts[1]
    assert reads[0][0] == reads[0][1] == reads[1][0] == reads[1][1]
    assert reads[0][0]["k"] == data["k"] and reads[0][0]["n"] == data["n"]


def test_prune_helper_respects_unprunable_files():
    from daft_tpu_torch.io.scan import FileInfo

    files = [FileInfo("a", partition_values={"p": 1}), FileInfo("b")]
    filt = (daft_tpu_torch.col("p") == 1)._expr
    schema = daft_tpu_torch.Schema([daft_tpu_torch.Field("p", daft_tpu_torch.DataType.int64())])
    # A bare file (no partition metadata) blocks pruning entirely.
    assert prune_files_by_partition(files, filt, schema) == files


def test_inconsistent_partition_keys_raise(tmp_path):
    for sub in ("k=1", "other"):
        daft_tpu_torch.from_pydict({"v": [1]}).write_parquet(str(tmp_path / sub))
    for pkg in PKGS:
        with pytest.raises(Exception, match="Inconsistent hive partitioning"):
            pkg.read_parquet(str(tmp_path), hive_partitioning=True)
