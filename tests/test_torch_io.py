"""The port's scan and local-file layer (daft_tpu_torch/io: scan.py,
formats.py, reads.py, writers.py, iostats.py, retry.py, circuit.py,
source.py, sink.py, mock.py; the executor's PhysicalScan and Write) against
the JAX package's, on the CPU.

Mirrors every test of tests/test_io.py, the local-only tests of
tests/test_io_native.py (ranged reads, multipart upload and its resume,
``with_retries``) and tests/test_io_plugins.py's WARC, plugin and mock-source
tests. Each reads the same files through both packages: files written by
either package are read by the other, with the same rows (compared exactly,
sorted where the engine leaves the order open) and the same schema. Then the
scan into the device layer (q06 and q01 over a small ``tools/lineitem.py``
table written to parquet: the port at 1 and 4 threads gives the same bytes
and equals the JAX package, with the JAX package's routes), the IO pool (task
order; a limit, a reader error and an expired deadline leave no ``daft-scan``
thread; the error wrapped as the JAX executor wraps it), and photos read from
files into the tiny CLIP tower (bf16 tolerance 3e-2, that of
tests/test_torch_engine.py).
"""

import contextlib
import gzip
import os
import threading
import time

import numpy as np
import pyarrow.fs as pafs
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.execution.executor import Executor as JExecutor
from daft_tpu_torch.errors import (
    DaftExecutionError,
    DaftIOError,
    DaftTimeoutError,
    DaftValueError,
)
from daft_tpu_torch.execution.executor import Executor as TExecutor
from daft_tpu_torch.io import retry as tretry
from daft_tpu_torch.logical import plan as tlp
from daft_tpu_torch.ops import device_eval as tde
from daft_tpu_torch.tools import lineitem

pytestmark = pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning")

PKGS = (daft_tpu, daft_tpu_torch)
BF16_TOL = 3e-2


@pytest.fixture(autouse=True)
def _configs():
    with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
        yield


def _df(pkg):
    return pkg.from_pydict({
        "a": list(range(100)),
        "b": [f"s{i % 7}" for i in range(100)],
        "c": np.linspace(0, 1, 100),
    })


def _schema(df):
    return [(f.name, repr(f.dtype)) for f in df.schema]


def _rows(out: dict) -> list:
    return sorted(zip(*out.values()), key=repr)


def _written(tmp_path, fmt: str, **kw):
    """The fixture table written by each package into a directory of its own."""
    dirs = {}
    for pkg in PKGS:
        d = str(tmp_path / f"{fmt}_{pkg.__name__}")
        res = getattr(_df(pkg), f"write_{fmt}")(d, **kw)
        dirs[pkg] = (d, res.to_pydict())
    return dirs


# --------------------------------------------------------------------- #
# tests/test_io.py                                                        #
# --------------------------------------------------------------------- #
def test_parquet_roundtrip(tmp_path):
    dirs = _written(tmp_path, "parquet")
    for d, res in dirs.values():
        assert res["num_rows"] == [100]
        outs = []
        for pkg in PKGS:
            back = pkg.read_parquet(d)
            assert back.schema.column_names() == ["a", "b", "c"]
            out = back.where(pkg.col("a") < 5).select("a").sort("a").to_pydict()
            assert out["a"] == [0, 1, 2, 3, 4]
            outs.append((_schema(back), back.to_pydict()))
        assert outs[0] == outs[1]


@pytest.mark.parametrize("fmt", ["csv", "json"])
def test_csv_and_json_roundtrip(tmp_path, fmt):
    read = {"csv": "read_csv", "json": "read_json"}[fmt]
    for d, _ in _written(tmp_path, fmt).values():
        outs = [(_schema(getattr(pkg, read)(d)), _rows(getattr(pkg, read)(d).to_pydict()))
                for pkg in PKGS]
        assert len(outs[0][1]) == 100
        assert outs[0] == outs[1]


def test_ipc_write(tmp_path):
    import pyarrow as pa

    for d, res in _written(tmp_path, "ipc").values():
        with pa.ipc.open_file(res["path"][0]) as f:
            t = f.read_all()
        assert t.num_rows == 100 and t.column_names == ["a", "b", "c"]


def test_partitioned_write(tmp_path):
    for pkg in PKGS:
        d = tmp_path / pkg.__name__
        _df(pkg).write_parquet(str(d), partition_cols=[pkg.col("b")])
        subdirs = sorted(os.listdir(d))
        assert len(subdirs) == 7 and subdirs[0].startswith("b=")
        outs = [_rows(p.read_parquet(str(d) + "/b=s0").to_pydict()) for p in PKGS]
        assert outs[0] == outs[1] and len(outs[0]) > 0


def test_glob_read(tmp_path):
    for d, _ in _written(tmp_path, "parquet").values():
        outs = [pkg.read_parquet(d + "/*.parquet").to_pydict() for pkg in PKGS]
        assert len(outs[0]["a"]) == 100 and outs[0] == outs[1]


def test_from_glob_path(tmp_path):
    for d, _ in _written(tmp_path, "parquet").values():
        outs = [pkg.from_glob_path(d + "/*.parquet").to_pydict() for pkg in PKGS]
        assert len(outs[0]["path"]) >= 1 and "path" in outs[0]
        assert outs[0] == outs[1]


def test_limit_pushdown_reads_less(tmp_path):
    for d, _ in _written(tmp_path, "parquet").values():
        outs = [pkg.read_parquet(d).limit(3).to_pydict() for pkg in PKGS]
        assert len(outs[0]["a"]) == 3 and outs[0] == outs[1]


def test_multi_file_scan(tmp_path):
    for pkg in PKGS:
        for i in range(3):
            _df(pkg).write_parquet(str(tmp_path / pkg.__name__ / f"d{i}"))
    for writer in PKGS:
        paths = [str(tmp_path / writer.__name__ / f"d{i}") for i in range(3)]
        outs = [_rows(pkg.read_parquet(paths).to_pydict()) for pkg in PKGS]
        assert len(outs[0]) == 300 and outs[0] == outs[1]


def test_read_text(tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("hello\nworld\n")
    for pkg in PKGS:
        assert pkg.read_text(str(p)).to_pydict()["text"] == ["hello", "world"]


def test_io_stats_counters(tmp_path):
    """Reads/writes are accounted (reference: src/daft-io/src/stats.rs)."""
    dt = daft_tpu_torch
    dt.reset_io_stats()
    dt.from_pydict({"a": list(range(1000))}).write_parquet(str(tmp_path / "o"))
    s1 = dt.io_stats()
    assert s1.puts >= 1 and s1.bytes_written > 0
    dt.read_parquet(str(tmp_path / "o")).where(dt.col("a") > 10).collect()
    s2 = dt.io_stats()
    assert s2.gets >= 1 and s2.files_opened >= 1 and s2.bytes_read > 0


def test_read_range_and_chunked_upload(tmp_path):
    for pkg in PKGS:
        path = str(tmp_path / f"blob_{pkg.__name__}.bin")
        payload = bytes(range(256)) * 1000
        assert pkg.chunked_upload(path, payload, chunk_size=4096) == len(payload)
        assert pkg.read_range(path, 0, 16) == payload[:16]
        assert pkg.read_range(path, 1000, 24) == payload[1000:1024]
        assert pkg.io_stats().bytes_written >= len(payload)


def test_parallel_glob_fanout(tmp_path):
    from daft_tpu.io.scan import glob_paths as jglob
    from daft_tpu_torch.io.scan import glob_paths as tglob

    for sub in ("a", "b", "c"):
        d = tmp_path / sub
        d.mkdir()
        daft_tpu_torch.from_pydict({"x": [1, 2]}).write_parquet(str(d))
    paths = [str(tmp_path / s) for s in ("a", "b", "c")]
    tinfos, jinfos = tglob(paths), jglob(paths)
    assert len(tinfos) >= 3
    assert [(f.path, f.size_bytes) for f in tinfos] == [(f.path, f.size_bytes) for f in jinfos]
    for pkg in PKGS:
        assert sorted(pkg.read_parquet(paths).to_pydict()["x"]) == [1, 1, 1, 2, 2, 2]


def test_listing_skips_hidden_files_and_sorts_by_path(tmp_path):
    from daft_tpu.io.scan import glob_paths as jglob
    from daft_tpu_torch.io.scan import glob_paths as tglob

    for name in ("b.parquet", "a.parquet", "_SUCCESS", ".hidden", "sub/c.parquet"):
        p = tmp_path / name
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(b"x")
    got = [f.path for f in tglob([str(tmp_path)])]
    assert got == [f.path for f in jglob([str(tmp_path)])]
    assert [os.path.relpath(p, tmp_path) for p in got] == ["a.parquet", "b.parquet",
                                                           "sub/c.parquet"]


def test_missing_path_and_remote_scheme_raise(tmp_path):
    """A missing path raises ``Path not found`` in both packages; a scheme no
    filesystem knows raises pyarrow's error in both (the JAX package's
    ``pafs.FileSystem.from_uri``); ``filesystem_for`` gives the JAX package's
    kind of filesystem for each scheme, or None where pyarrow resolves the
    URI. The object stores and HTTP themselves are held in
    tests/test_torch_remote_io.py, test_torch_s3.py and test_torch_gcs.py."""
    import pyarrow as pa

    with pytest.raises(DaftIOError, match="Path not found"):
        daft_tpu_torch.read_parquet(str(tmp_path / "nope"))
    with pytest.raises(daft_tpu.errors.DaftIOError, match="Path not found"):
        daft_tpu.read_parquet(str(tmp_path / "nope"))
    for pkg in (daft_tpu, daft_tpu_torch):
        with pytest.raises(pa.ArrowInvalid, match="Unrecognized filesystem type"):
            pkg.read_parquet("nofs://bucket/key.parquet")
    from daft_tpu.io.config import IOConfig as JIOConfig
    from daft_tpu.io.config import S3Config as JS3Config
    from daft_tpu.io.config import filesystem_for as jfs_for
    from daft_tpu_torch.io.config import IOConfig, S3Config, filesystem_for

    for scheme in ("file", "http", "https", "hf"):
        assert filesystem_for(scheme, IOConfig()) is None is jfs_for(scheme, JIOConfig())
    native = filesystem_for("s3", IOConfig(s3=S3Config(anonymous=True, use_native_client=True)))
    jnative = jfs_for("s3", JIOConfig(s3=JS3Config(anonymous=True, use_native_client=True)))
    assert isinstance(native, pafs.PyFileSystem) and native.type_name == "py::daft-s3"
    assert jnative.type_name == native.type_name


def test_file_url_reads_like_a_local_path(tmp_path):
    d, _ = _written(tmp_path, "parquet")[daft_tpu_torch]
    assert daft_tpu_torch.read_parquet("file://" + d).to_pydict() == \
        daft_tpu_torch.read_parquet(d).to_pydict()


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json", "ipc"])
def test_overwrite_replaces_what_the_jax_package_appends(tmp_path, fmt):
    """C.32: the JAX package stores ``write_mode="overwrite"`` and appends, so
    a second write leaves both writes' rows; the port's overwrite leaves only
    the second write's files, as Daft does."""
    read = {"parquet": "read_parquet", "csv": "read_csv", "json": "read_json",
            "ipc": None}[fmt]
    counts = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg.__name__)
        getattr(_df(pkg), f"write_{fmt}")(d)
        res = getattr(_df(pkg).limit(30), f"write_{fmt}")(d, write_mode="overwrite").to_pydict()
        files = sorted(os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs)
        counts[pkg] = len(files)
        if pkg is daft_tpu_torch:
            assert files == sorted(res["path"])
            if read:
                assert _rows(getattr(pkg, read)(d).to_pydict()) == \
                    _rows(_df(pkg).limit(30).to_pydict())
        elif read:
            assert len(getattr(pkg, read)(d).to_pydict()["a"]) == 130
    assert counts == {daft_tpu: 2, daft_tpu_torch: 1}


def test_partitioned_overwrite_drops_the_old_partitions(tmp_path):
    dt = daft_tpu_torch
    d = str(tmp_path / "hive")
    _df(dt).write_parquet(d, partition_cols=[dt.col("b")])
    _df(dt).where(dt.col("b") == "s3").write_parquet(d, partition_cols=[dt.col("b")],
                                                     write_mode="overwrite")
    back = dt.read_parquet(d, hive_partitioning=True).to_pydict()
    assert set(back["b"]) == {"s3"} and sorted(back["a"]) == list(range(3, 100, 7))


def test_unknown_write_mode_raises(tmp_path):
    with pytest.raises(DaftValueError, match="write_mode"):
        _df(daft_tpu_torch).write_parquet(str(tmp_path), write_mode="upsert")


def test_writer_rolls_files_by_target_size(tmp_path):
    """A small target file size rolls the writer into several files in both
    packages; reading them back gives the rows whatever order the string
    sort of the file names gives."""
    n = 5000
    data = {"a": np.arange(n), "b": np.random.default_rng(0).random(n)}
    outs = {}
    for pkg in PKGS:
        with pkg.execution_config_ctx(parquet_target_filesize=4000, default_morsel_size=500):
            # The filter's stage splits the input into morsels of 500 rows.
            res = (pkg.from_pydict(data).where(pkg.col("a") >= 0)
                   .write_parquet(str(tmp_path / pkg.__name__)).to_pydict())
        assert len(res["path"]) == 10 and sum(res["num_rows"]) == n
        outs[pkg] = [_rows(p.read_parquet(str(tmp_path / pkg.__name__)).to_pydict())
                     for p in PKGS]
    assert outs[daft_tpu][0] == outs[daft_tpu][1] == outs[daft_tpu_torch][0] \
        == outs[daft_tpu_torch][1] == _rows(data)


# --------------------------------------------------------------------- #
# tests/test_io_native.py, the local-only tests                          #
# --------------------------------------------------------------------- #
IO_MODULES = {"jax": ("daft_tpu.io.iostats", "daft_tpu.io.retry", "daft_tpu.errors"),
              "port": ("daft_tpu_torch.io.iostats", "daft_tpu_torch.io.retry",
                       "daft_tpu_torch.errors")}


def _mods(which):
    import importlib

    return [importlib.import_module(m) for m in IO_MODULES[which]]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_parallel_ranged_read(tmp_path, which):
    iostats, _, _ = _mods(which)
    p = tmp_path / "x.bin"
    data = bytes(range(256)) * 100
    p.write_bytes(data)
    ranges = [(0, 10), (100, 50), (25000, 600), (len(data) - 7, 7)]
    out = iostats.parallel_ranged_read(str(p), ranges, max_concurrency=4)
    for (start, length), got in zip(ranges, out):
        assert got == data[start:start + length]


@pytest.mark.parametrize("which", ["jax", "port"])
def test_parallel_ranged_read_retries(tmp_path, monkeypatch, which):
    iostats, retry, _ = _mods(which)
    p = tmp_path / "x.bin"
    p.write_bytes(b"0123456789")
    real = iostats.read_range
    fails = {"n": 0}

    def flaky(path, start, length, io_config=None):
        if start == 4 and fails["n"] < 2:
            fails["n"] += 1
            raise ConnectionError("transient")
        return real(path, start, length, io_config)

    monkeypatch.setattr(iostats, "read_range", flaky)
    monkeypatch.setattr("time.sleep", lambda s: None)
    out = iostats.parallel_ranged_read(str(p), [(0, 4), (4, 4)],
                                       policy=retry.RetryPolicy(max_retries=3, backoff_base_s=0.0))
    assert out == [b"0123", b"4567"]
    assert fails["n"] == 2


class _FlakyFS:
    """Delegating pyarrow-fs wrapper: the first `fail_first` part writes raise."""

    def __init__(self, inner, fail_first: int = 0):
        self.inner = inner
        self.fail_first = fail_first
        self.part_writes = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def open_output_stream(self, path, *a, **kw):
        if ".daft-parts/" in path:
            self.part_writes += 1
            if self.part_writes <= self.fail_first:
                raise ConnectionError(f"injected failure #{self.part_writes}")
        return self.inner.open_output_stream(path, *a, **kw)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_multipart_upload_roundtrip_with_retries(tmp_path, monkeypatch, which):
    iostats, retry, _ = _mods(which)
    monkeypatch.setattr("time.sleep", lambda s: None)
    iostats.reset_io_stats()
    target = str(tmp_path / "big.bin")
    fs = _FlakyFS(pafs.LocalFileSystem(), fail_first=2)
    up = iostats.MultipartUpload(target, part_size=1 << 20, max_concurrency=3, filesystem=fs,
                                 policy=retry.RetryPolicy(max_retries=3, backoff_base_s=0.0))
    payload = np.random.default_rng(0).integers(0, 256, 5 * (1 << 20) + 1234,
                                                dtype=np.uint8).tobytes()
    for off in range(0, len(payload), 700_000):
        up.write(payload[off:off + 700_000])
    assert up.close() == len(payload)
    assert open(target, "rb").read() == payload
    assert not os.path.exists(target + ".daft-parts")
    assert iostats.IO_STATS.snapshot().retries >= 2


@pytest.mark.parametrize("which", ["jax", "port"])
def test_multipart_upload_resume_skips_staged_parts(tmp_path, which):
    iostats, _, _ = _mods(which)
    target = str(tmp_path / "out.bin")
    part0 = b"A" * (1 << 20)
    part1 = b"B" * 1000
    os.makedirs(target + ".daft-parts")  # a previous attempt staged part 00000
    with open(target + ".daft-parts/00000", "wb") as f:
        f.write(part0)

    class CountingFS(_FlakyFS):
        def __init__(self, inner):
            super().__init__(inner)
            self.paths = []

        def open_output_stream(self, path, *a, **kw):
            self.paths.append(path)
            return super().open_output_stream(path, *a, **kw)

    fs = CountingFS(pafs.LocalFileSystem())
    up = iostats.MultipartUpload(target, part_size=1 << 20, filesystem=fs)
    up.write(part0)
    up.write(part1)
    assert up.close() == len(part0) + len(part1)
    assert open(target, "rb").read() == part0 + part1
    assert not any(p.endswith("/00000") for p in fs.paths)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_multipart_failure_keeps_parts_for_resume(tmp_path, monkeypatch, which):
    iostats, retry, errors = _mods(which)
    monkeypatch.setattr("time.sleep", lambda s: None)
    target = str(tmp_path / "f.bin")
    fs = _FlakyFS(pafs.LocalFileSystem(), fail_first=99)
    up = iostats.MultipartUpload(target, part_size=1000, filesystem=fs,
                                 policy=retry.RetryPolicy(max_retries=1, backoff_base_s=0.0))
    up.write(b"x" * 2500)
    with pytest.raises(errors.DaftIOError, match="resume"):
        up.close()
    assert not os.path.exists(target)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_with_retries_respects_policy(monkeypatch, which):
    _, retry, _ = _mods(which)
    sleeps = []
    monkeypatch.setattr("time.sleep", lambda s: sleeps.append(s))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TimeoutError("slow")
        return 42

    assert retry.with_retries(flaky, retry.RetryPolicy(max_retries=4, backoff_base_s=0.1)) == 42
    assert calls["n"] == 3 and len(sleeps) == 2
    assert sleeps[1] > sleeps[0] * 0.9  # backoff grows (jitter aside)
    with pytest.raises(ValueError):
        retry.with_retries(lambda: (_ for _ in ()).throw(ValueError("fatal")),
                           retry.RetryPolicy(max_retries=5))


def test_retry_and_breaker_seed_the_same_jitter_as_the_jax_package():
    from daft_tpu.io import circuit as jcircuit
    from daft_tpu.io import retry as jretry
    from daft_tpu_torch.io import circuit as tcircuit

    for mod_j, mod_t, seed_fn in ((jretry, tretry, "seed_retry_jitter"),
                                  (jcircuit, tcircuit, "seed_circuit_jitter")):
        getattr(mod_j, seed_fn)(7)
        getattr(mod_t, seed_fn)(7)
        assert [mod_j._jitter_rng.random() for _ in range(4)] == \
            [mod_t._jitter_rng.random() for _ in range(4)]
        getattr(mod_j, seed_fn)(None)
        getattr(mod_t, seed_fn)(None)
    assert jretry.RetryPolicy().sleep_s(0, "3") == tretry.RetryPolicy().sleep_s(0, "3") == 3.0


def test_circuit_breaker_opens_and_closes():
    from daft_tpu_torch.errors import DaftCircuitOpenError
    from daft_tpu_torch.io.circuit import CircuitBreaker

    b = CircuitBreaker("file://test", failure_threshold=2, open_base_s=0.05, open_cap_s=1.0,
                       half_open_probes=1)
    b.allow()
    b.record_failure()
    assert b.state() == "closed"
    b.record_failure()
    assert b.state() == "open"
    with pytest.raises(DaftCircuitOpenError):
        b.allow()
    time.sleep(0.06)
    b.allow()  # the half-open probe
    assert b.state() == "half_open"
    with pytest.raises(DaftCircuitOpenError, match="probe quota"):
        b.allow()
    b.record_success()
    assert b.state() == "closed"


# --------------------------------------------------------------------- #
# tests/test_io_plugins.py                                               #
# --------------------------------------------------------------------- #
def test_warc_reader(tmp_path):
    rec = (b"WARC/1.0\r\nWARC-Type: response\r\nWARC-Record-ID: <urn:uuid:1>\r\n"
           b"WARC-Target-URI: http://x.test/\r\nWARC-Date: 2024-01-01T00:00:00Z\r\n"
           b"Content-Length: 11\r\n\r\nhello world\r\n\r\n")
    path = tmp_path / "t.warc.gz"
    path.write_bytes(gzip.compress(rec * 3))
    outs = []
    for pkg in PKGS:
        w = pkg.read_warc(str(path))
        d = w.to_pydict()
        assert len(d["warc_content"]) == 3
        assert d["warc_content"][0] == b"hello world"
        assert d["WARC-Type"] == ["response"] * 3
        outs.append((_schema(w), d))
    assert outs[0] == outs[1]


def _range_source(pkg):
    from importlib import import_module

    src = import_module(f"{pkg.__name__}.io.source")
    mp = import_module(f"{pkg.__name__}.micropartition")

    class RangeTask(src.DataSourceTask):
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def schema(self):
            return pkg.Schema([pkg.Field("x", pkg.DataType.int64())])

        def execute(self):
            yield mp.MicroPartition.from_pydict({"x": list(range(self.lo, self.hi))})

    class RangeSource(src.DataSource):
        def schema(self):
            return pkg.Schema([pkg.Field("x", pkg.DataType.int64())])

        def get_tasks(self, pushdowns=None):
            return [RangeTask(0, 5), RangeTask(5, 10)]

    return src.read_source(RangeSource())


def test_data_source_plugin():
    outs = []
    for pkg in PKGS:
        c = pkg.col
        df = _range_source(pkg)
        out = (df.to_pydict()["x"], df.where(c("x") > 6).to_pydict()["x"],
               df.limit(3).to_pydict()["x"],
               df.select((c("x") * 2).alias("y")).sum("y").to_pydict()["y"])
        assert out == (list(range(10)), [7, 8, 9], [0, 1, 2], [90])
        outs.append(out)
    assert outs[0] == outs[1]


def test_data_sink_plugin():
    from daft_tpu_torch.io.sink import DataSink, WriteResult

    class CollectSink(DataSink):
        def __init__(self):
            self.started = False

        def start(self):
            self.started = True

        def write(self, p):
            return WriteResult(None, len(p))

        def finalize(self, results):
            return {"total": [sum(r.rows for r in results)]}

    sink = CollectSink()
    out = daft_tpu_torch.from_pydict({"a": [1, 2, 3]}).write_sink(sink)
    assert sink.started and out.to_pydict() == {"total": [3]}


@pytest.mark.parametrize("which", ["jax", "port"])
def test_mock_source_transient_retry(which):
    """Transient failures retry and succeed before the first morsel; fatal
    failures and an exhausted retry budget surface."""
    from importlib import import_module

    pkg = daft_tpu if which == "jax" else daft_tpu_torch
    MockSource = import_module(f"{pkg.__name__}.io.mock").MockSource
    read_source = import_module(f"{pkg.__name__}.io.source").read_source
    src = MockSource([{"x": [1, 2]}, {"x": [3, 4]}], transient_failures={0: 2})
    assert sorted(read_source(src).to_pydict()["x"]) == [1, 2, 3, 4]
    assert src.attempts(0) == 3  # 2 failures + 1 success
    with pytest.raises(Exception, match="fatal"):
        read_source(MockSource([{"x": [1]}], fatal_tasks={0})).to_pydict()
    with pytest.raises(Exception, match="transient"):
        read_source(MockSource([{"x": [1]}], transient_failures={0: 99})).to_pydict()


def test_retry_happens_only_before_the_first_morsel():
    """A transient failure after a morsel reached the consumer is not
    retried (a retry would duplicate rows): it reaches the caller."""
    from daft_tpu_torch.errors import DaftTransientError
    from daft_tpu_torch.io.formats import _stream_with_retry
    from daft_tpu_torch.io.scan import ScanTask
    from daft_tpu_torch.micropartition import MicroPartition

    attempts = []

    def make_iter():
        attempts.append(1)
        yield MicroPartition.from_pydict({"x": [1]})
        raise DaftTransientError("late")

    task = ScanTask([], "python_source", daft_tpu_torch.Schema(
        [daft_tpu_torch.Field("x", daft_tpu_torch.DataType.int64())]))
    got = []
    with pytest.raises(DaftTransientError, match="late"):
        for mp in _stream_with_retry(task, make_iter, None):
            got.append(len(mp))
    assert got == [1] and attempts == [1]


# --------------------------------------------------------------------- #
# The scan into the device layer                                        #
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def _small(monkeypatch, threads: int):
    """Morsels of 4096 rows and aggregation chunks of 8192+ in both packages
    (as tests/test_torch_pipeline.py), and every file its own scan task."""
    for cls in (JExecutor, TExecutor):
        monkeypatch.setattr(cls, "AGG_CHUNK_ROWS", 8192)
    with daft_tpu.execution_config_ctx(result_cache_enabled=False, num_compute_threads=4,
                                       default_morsel_size=4096, min_morsel_size=4096,
                                       scan_tasks_min_size_bytes=1), \
            daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False,
                                                num_compute_threads=threads,
                                                default_morsel_size=4096,
                                                scan_tasks_min_size_bytes=1):
        yield


@pytest.fixture(scope="module")
def li_dir(tmp_path_factory):
    """40,000 seeded lineitem rows written by the port in five files (five
    scan tasks in ``_small``), and the columns."""
    cols = lineitem.lineitem_columns(40_000, seed=3)
    d = str(tmp_path_factory.mktemp("lineitem"))
    with daft_tpu_torch.execution_config_ctx(device="cpu", parquet_target_filesize=200_000,
                                             default_morsel_size=8192):
        # The filter (true on every row) splits the table into morsels, and
        # the writer rolls to a new file after each.
        res = (daft_tpu_torch.from_pydict(cols).where(daft_tpu_torch.col("l_quantity") > 0)
               .write_parquet(d).to_pydict())
    assert len(res["path"]) == 5
    return d, cols


def _q06_f32(pkg, df):
    """q06 with its rate bounds as f32 literals: the host and the device
    decide the same rows (C.31)."""
    return lineitem.q06(pkg, df, rate_dtype=pkg.DataType.float32())


SCAN_QUERIES = {
    "q06": lambda pkg, d: lineitem.q06(pkg, pkg.read_parquet(d)).to_pydict(),
    "q06_f32_rates": lambda pkg, d: _q06_f32(pkg, pkg.read_parquet(d)).to_pydict(),
    "q01": lambda pkg, d: lineitem.sorted_groups(lineitem.q01(pkg, pkg.read_parquet(d))
                                                 .to_pydict()),
}


def _jax_chain_kinds() -> dict:
    from daft_tpu import metrics

    snap = metrics.get_registry().snapshot()
    return {k: int(v) for k, v in snap.label_totals("daft_compiled_chain_rows_total",
                                                    "kind").items() if v}


@pytest.mark.parametrize("name", list(SCAN_QUERIES))
def test_scan_queries_equal_the_jax_package_at_1_and_4_threads(name, monkeypatch, li_dir):
    d, cols = li_dir
    run = SCAN_QUERIES[name]
    outs, snaps = {}, {}
    for threads in (1, 4):
        with _small(monkeypatch, threads):
            tde.device_eval_counters.reset()
            outs[threads] = run(daft_tpu_torch, d)
            snaps[threads] = tde.device_eval_counters.snapshot()
            if threads == 4:
                before = _jax_chain_kinds()
                outs["jax"] = run(daft_tpu, d)
                after = _jax_chain_kinds()
    assert outs[1] == outs[4] == outs["jax"]  # bit for bit
    assert snaps[1] == snaps[4]
    jax_kinds = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert {k: v for k, v in snaps[4]["chain_rows"].items()} == \
        {k: v for k, v in jax_kinds.items() if v}
    if name.startswith("q06"):
        # The filter went into the scan and ran on the host: no device chain
        # holds a filter.
        assert "filter_project" not in snaps[4]["chain_rows"]
    if name == "q06_f32_rates":
        np.testing.assert_allclose(outs[4]["revenue"][0], lineitem.q06_reference(cols),
                                   rtol=1e-5)
    if name == "q06":
        np.testing.assert_allclose(outs[4]["revenue"][0],
                                   lineitem.q06_reference(cols, host_literals=True), rtol=1e-5)


def test_scan_q06_reads_four_of_nine_columns(li_dir):
    d, _ = li_dir
    plans = [lineitem.q06(pkg, pkg.read_parquet(d))._builder.optimize().plan for pkg in PKGS]
    scans = [[n for n in p.walk() if type(n).__name__ == "ScanSource"][0] for p in plans]
    assert scans[0].pushdowns.columns == scans[1].pushdowns.columns \
        == ("l_extendedprice", "l_discount")
    assert repr(scans[0].pushdowns.filters) == repr(scans[1].pushdowns.filters)
    # The reader decodes the projection and the filter's columns, 4 of 9, in
    # every batch it reads (counted where the parquet reader decodes).
    dt = daft_tpu_torch
    dt.reset_io_stats()
    lineitem.q06(dt, dt.read_parquet(d)).collect()
    s = dt.io_stats()
    assert s.parquet_batches >= 5 and s.parquet_columns == 4 * s.parquet_batches
    dt.reset_io_stats()
    dt.read_parquet(d).collect()
    s = dt.io_stats()
    assert s.parquet_batches >= 5 and s.parquet_columns == 9 * s.parquet_batches


def test_q06_host_and_device_routes_decide_different_rows_in_both_packages():
    """C.31: a Python float literal is weakly typed on the device (the rate
    bounds compare in f32) but an f64 scalar on the host, so q06's
    ``l_discount <= 0.07`` keeps the 0.07 rows on the device and drops them
    on the host, in both packages alike. f32-typed bounds agree on every
    route."""
    cols = lineitem.lineitem_columns(20_000, seed=5)
    got = {}
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg is daft_tpu_torch else {"result_cache_enabled": False}
        for route, on in (("device", True), ("host", False)):
            with pkg.execution_config_ctx(device_eval=on, compiled_eval_enabled=on,
                                          device_eval_min_rows=1, **kw):
                got[(pkg, route)] = lineitem.q06(pkg, pkg.from_pydict(cols)).to_pydict()
                got[(pkg, route, "f32")] = _q06_f32(pkg, pkg.from_pydict(cols)).to_pydict()
    ref_dev, ref_host = lineitem.q06_reference(cols), lineitem.q06_reference(cols,
                                                                            host_literals=True)
    assert ref_host < 0.9 * ref_dev
    for pkg in PKGS:
        np.testing.assert_allclose(got[(pkg, "device")]["revenue"][0], ref_dev, rtol=1e-5)
        np.testing.assert_allclose(got[(pkg, "host")]["revenue"][0], ref_host, rtol=1e-5)
        for route in ("device", "host"):
            np.testing.assert_allclose(got[(pkg, route, "f32")]["revenue"][0], ref_dev,
                                       rtol=1e-5)


# --------------------------------------------------------------------- #
# The IO pool                                                           #
# --------------------------------------------------------------------- #
def _scan_threads(before):
    return [t for t in threading.enumerate()
            if t.ident not in before and t.is_alive() and t.name.startswith("daft-scan")]


def _wait_no_scan_threads(before, seconds: float = 10.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if not _scan_threads(before):
            return []
        time.sleep(0.02)
    return [t.name for t in _scan_threads(before)]


@pytest.fixture
def many_files(tmp_path):
    """Twelve files of 3,000 rows each, written one per directory so each
    file's rows are known: file i holds i*3000 .. (i+1)*3000."""
    d = tmp_path / "many"
    for i in range(12):
        daft_tpu_torch.from_pydict({"x": np.arange(i * 3000, (i + 1) * 3000)}).write_parquet(
            str(d / f"part{i:02d}"))
    return str(d)


def test_scan_tasks_yield_in_task_order(many_files):
    before = {t.ident for t in threading.enumerate()}
    outs = {}
    for pkg in PKGS:
        with pkg.execution_config_ctx(scan_tasks_min_size_bytes=1, default_morsel_size=1000):
            plan = pkg.read_parquet(many_files)._builder.optimize().plan
            outs[pkg] = pkg.read_parquet(many_files).to_pydict()["x"]
    assert outs[daft_tpu_torch] == list(range(36_000)) == outs[daft_tpu]
    assert type(plan).__name__ == "ScanSource"
    assert _wait_no_scan_threads(before) == []


def test_scan_runs_several_tasks_on_the_io_pool(many_files, monkeypatch):
    from daft_tpu_torch.io import formats

    names = set()
    real = formats.read_scan_task

    def spy(task, morsel_rows):
        names.add(threading.current_thread().name.split("_")[0])
        yield from real(task, morsel_rows)

    monkeypatch.setattr(formats, "read_scan_task", spy)
    with daft_tpu_torch.execution_config_ctx(scan_tasks_min_size_bytes=1):
        assert len(daft_tpu_torch.read_parquet(many_files).to_pydict()["x"]) == 36_000
    assert names == {"daft-scan"}
    names.clear()
    with daft_tpu_torch.execution_config_ctx():  # one file, one task: read inline
        daft_tpu_torch.read_parquet(os.path.join(many_files, "part03")).to_pydict()
    assert names == {threading.current_thread().name}


def test_limit_releases_the_scan_threads(many_files):
    before = {t.ident for t in threading.enumerate()}
    with daft_tpu_torch.execution_config_ctx(scan_tasks_min_size_bytes=1,
                                             default_morsel_size=100):
        df = daft_tpu_torch.read_parquet(many_files)
        plan = df.limit(5)._builder.optimize().plan
        out = df.limit(5).to_pydict()["x"]
    assert out == [0, 1, 2, 3, 4]
    scan = [n for n in plan.walk() if isinstance(n, tlp.ScanSource)][0]
    assert scan.pushdowns.limit == 5
    assert _wait_no_scan_threads(before) == []


def test_reader_error_is_wrapped_and_releases_the_scan_threads(many_files):
    bad = os.path.join(many_files, "part07")
    victim = os.path.join(bad, os.listdir(bad)[0])
    with open(victim, "wb") as f:
        f.write(b"PAR1 this is not parquet")
    before = {t.ident for t in threading.enumerate()}
    errs = {}
    for pkg, err_cls in ((daft_tpu_torch, DaftExecutionError),
                         (daft_tpu, daft_tpu.errors.DaftExecutionError)):
        with pkg.execution_config_ctx(scan_tasks_min_size_bytes=1):
            with pytest.raises(err_cls, match="Scan failed") as info:
                pkg.read_parquet(many_files).to_pydict()
        errs[pkg] = info.value
    assert type(errs[daft_tpu_torch].__cause__).__name__ == \
        type(errs[daft_tpu].__cause__).__name__
    assert _wait_no_scan_threads(before) == []


def test_expired_deadline_releases_the_scan_threads(many_files, monkeypatch):
    from daft_tpu_torch.io import formats

    real = formats._read_parquet_file

    def slow(*args, **kwargs):
        for mp in real(*args, **kwargs):
            time.sleep(0.05)
            yield mp

    monkeypatch.setattr(formats, "_read_parquet_file", slow)
    before = {t.ident for t in threading.enumerate()}
    with daft_tpu_torch.execution_config_ctx(scan_tasks_min_size_bytes=1,
                                             default_morsel_size=500):
        t0 = time.perf_counter()
        with pytest.raises(DaftTimeoutError):
            daft_tpu_torch.read_parquet(many_files).where(
                daft_tpu_torch.col("x") >= 0).collect(timeout=0.2)
        assert time.perf_counter() - t0 < 2.0
    assert _wait_no_scan_threads(before) == []
    # The next scan is still exact.
    with daft_tpu_torch.execution_config_ctx(scan_tasks_min_size_bytes=1):
        assert daft_tpu_torch.read_parquet(many_files).to_pydict()["x"] == list(range(36_000))


def test_empty_scan_after_pruning_yields_the_schema(tmp_path):
    d = str(tmp_path / "h")
    daft_tpu_torch.from_pydict({"k": ["a", "b"], "v": [1, 2]}).write_parquet(
        d, partition_cols=["k"])
    for pkg in PKGS:
        out = pkg.read_parquet(d, hive_partitioning=True).where(pkg.col("k") == "zz").to_pydict()
        assert out == {"v": [], "k": []}


# --------------------------------------------------------------------- #
# Photos read from files into the tiny CLIP tower                        #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    import flax.serialization as fs
    import flax.traverse_util as tu

    from daft_tpu.models.clip import CLIPConfig as JaxCLIPConfig
    from daft_tpu.models.clip import init_clip_params

    _, params = init_clip_params(JaxCLIPConfig.tiny(), seed=0)
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(fs.to_state_dict(params),
                                                          sep="/").items()}
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    np.savez(path, **flat)
    return str(path)


def _photos(tmp_path, n: int = 10):
    import io

    from PIL import Image

    rng = np.random.default_rng(20)
    d = tmp_path / "photos"
    d.mkdir()
    raws = []
    for i in range(n):
        h, w = int(rng.integers(20, 60)), int(rng.integers(20, 60))
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            buf, format="PNG" if i % 3 == 0 else "JPEG")
        raws.append(buf.getvalue())
        (d / f"img{i:03d}.bin").write_bytes(raws[-1])
    return str(d), raws


def test_photos_from_files_and_parquet_shards_into_the_tower(tmp_path, tiny_npz):
    from daft_tpu.functions import media as jmedia
    from daft_tpu.functions.ai import embed_image as jembed
    from daft_tpu_torch.functions import media as tmedia
    from daft_tpu_torch.functions.ai import embed_image as tembed

    d, raws = _photos(tmp_path)
    shards = str(tmp_path / "shards")
    with daft_tpu_torch.execution_config_ctx(device="cpu", parquet_target_filesize=1,
                                             default_morsel_size=4):
        daft_tpu_torch.from_pydict({"image": raws}).write_parquet(shards)
    embs = {}
    for pkg, media, embed, kw in ((daft_tpu, jmedia, jembed, {"provider": "flax"}),
                                  (daft_tpu_torch, tmedia, tembed,
                                   {"provider": "cuda", "device": "cpu"})):
        expr = embed(pkg.col("img"), model="tiny", weights_path=tiny_npz, batch_size=4, **kw)
        files = pkg.from_glob_path(d).with_column(
            "img", media.decode_image_file(media.image_file(pkg.col("path")), mode="RGB"))
        embs[(pkg, "files")] = np.asarray(
            files.with_column("emb", expr).to_pydict()["emb"], np.float32)
        shard = pkg.read_parquet(shards).with_column(
            "img", pkg.col("image").image.decode(mode="RGB"))
        embs[(pkg, "parquet")] = np.asarray(
            shard.with_column("emb", expr).to_pydict()["emb"], np.float32)
    for path in ("files", "parquet"):
        port, ref = embs[(daft_tpu_torch, path)], embs[(daft_tpu, path)]
        assert port.shape == ref.shape == (len(raws), 32)
        np.testing.assert_allclose(port, ref, atol=BF16_TOL, rtol=BF16_TOL)
    # The two sources hold the same photos in the same order.
    np.testing.assert_array_equal(embs[(daft_tpu_torch, "files")],
                                  embs[(daft_tpu_torch, "parquet")])
