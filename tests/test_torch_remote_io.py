"""Remote IO in the port beside the JAX package's: the ranged HTTP and hf://
source (``daft_tpu_torch/io/http_source.py``), the scheme resolution of
``io/scan.py::resolve_filesystem``, ranged reads and multipart uploads
(``io/iostats.py``), ``url.download`` / ``url.upload``
(``kernels/uri_ops.py``), remote ``File``s, ``set_storage_option`` and
``read_huggingface``.

Mirrors ``tests/test_io_native.py`` case for case and the URL case of
``tests/test_io_plugins.py``. The stubs of
``daft_tpu_torch/tools/object_stores.py`` stand in for the stores; each case
runs both packages against one stub and holds the port to the JAX package on
the rows (or the error type raised) and on the requests the stub saw
(method, path, query, ``Range``, the body's SHA-256, the status). Beyond the
JAX files: ``url.download`` over s3://, gs://, http:// and https:// with
``on_error`` ``raise`` and ``null``, ``url.upload`` into both object stores
read back, a remote ``File``'s bytes and size, parquet over https:// (the
HTTP stub over TLS with the repo's loopback certificate, trusted through
``SSL_CERT_FILE``) and a certificate that is not trusted refused alike, the breaker opening on an endpoint that
answers only 503 and closing after its cooldown, a write to s3:// dropping
the result cache's entry, a stub served from a child process, and the stubs
leaving no thread or process behind.
"""

import http.server
import json
import os
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.io import circuit as jcircuit
from daft_tpu.io import gcs_auth as jauth
from daft_tpu.io import http_source as jhttp
from daft_tpu.io import iostats as jiostats
from daft_tpu.io import retry as jretry
from daft_tpu.io import scan as jscan
from daft_tpu_torch.io import circuit as tcircuit
from daft_tpu_torch.io import gcs_auth as tauth
from daft_tpu_torch.io import http_source as thttp
from daft_tpu_torch.io import iostats as tiostats
from daft_tpu_torch.io import retry as tretry
from daft_tpu_torch.io import scan as tscan
from daft_tpu_torch.tools.object_stores import (LOOPBACK_CERT, ChildStub, GcsStub, HttpStub,
                                                Request, S3Stub)
from torch_isolation import caches_reset  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning"),
              pytest.mark.usefixtures("caches_reset")]

JAX = SimpleNamespace(name="jax", pkg=daft_tpu, http=jhttp, io=jiostats, retry=jretry,
                      scan=jscan, circuit=jcircuit, auth=jauth)
PORT = SimpleNamespace(name="port", pkg=daft_tpu_torch, http=thttp, io=tiostats, retry=tretry,
                       scan=tscan, circuit=tcircuit, auth=tauth)


def _ctx(p, **kw):
    if p is PORT:
        return daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False, **kw)
    return daft_tpu.execution_config_ctx(result_cache_enabled=False, **kw)


def _both(stub, run):
    """``run(p)`` through each package against ``stub``: (outcome, requests)
    of the port, held equal to the JAX package's."""
    out = {}
    for p in (JAX, PORT):
        stub.take_log()
        try:
            got = ("ok", run(p))
        except Exception as e:  # noqa: BLE001 — the outcome compared
            got = ("raised", type(e).__name__)
        out[p.name] = (got, stub.take_log())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    return out["port"]


@pytest.fixture(scope="module")
def http_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("httproot")
    t = pa.table({"a": list(range(1000)), "b": [f"s{i}" for i in range(1000)]})
    pq.write_table(t, root / "data.parquet", row_group_size=100)
    (root / "blob.bin").write_bytes(bytes(range(256)) * 64)
    # hf-shaped layout: {base}/datasets/org/repo/resolve/main/file
    hfdir = root / "datasets" / "org" / "repo" / "resolve" / "main"
    hfdir.mkdir(parents=True)
    pq.write_table(t.slice(0, 10), hfdir / "part0.parquet")
    return root


@pytest.fixture
def http(http_root):
    stub = HttpStub(str(http_root))
    yield stub
    stub.close()


def _trust(monkeypatch, cert):
    """Both packages' HTTPS clients trust ``cert`` (None: the system's
    store): urllib's shared opener keeps the context it was built with, so
    it is rebuilt at the next request."""
    if cert is None:
        monkeypatch.delenv("SSL_CERT_FILE", raising=False)
    else:
        monkeypatch.setenv("SSL_CERT_FILE", cert)
    urllib.request.install_opener(None)


@pytest.fixture
def https(http_root, monkeypatch):
    """The HTTP stub over TLS, its loopback certificate trusted."""
    stub = HttpStub(str(http_root), tls=True)
    _trust(monkeypatch, LOOPBACK_CERT)
    yield stub
    stub.close()
    monkeypatch.undo()
    urllib.request.install_opener(None)


# --------------------------------------------------------------------- #
# tests/test_io_native.py                                                #
# --------------------------------------------------------------------- #
def test_read_parquet_over_http_with_ranged_reads(http):
    """The parquet reader issues ranged GETs (the footer, the row groups)
    through ``HttpReadableFile``, never one whole-object fetch per touch."""
    def run(p):
        p.io.reset_io_stats()
        with _ctx(p):
            out = p.pkg.read_parquet(f"{http.url}/data.parquet").where(
                p.pkg.col("a") < 5).to_pydict()
        s = p.io.IO_STATS.snapshot()
        return out, s.gets >= 2, s.files_opened >= 1

    outcome, reqs = _both(http, run)
    assert outcome == ("ok", ({"a": [0, 1, 2, 3, 4], "b": ["s0", "s1", "s2", "s3", "s4"]},
                              True, True))
    assert reqs[0].method == "HEAD" and all(r.range for r in reqs if r.method == "GET")


def test_read_parquet_over_https_through_the_loopback_certificate(https):
    """The same reads over https://: the TLS path of ``HttpReadableFile``
    sends what the plain one sends."""
    assert https.url.startswith("https://127.0.0.1:")

    def run(p):
        with _ctx(p):
            return p.pkg.read_parquet(f"{https.url}/data.parquet").where(
                p.pkg.col("a") < 5).to_pydict()

    outcome, reqs = _both(https, run)
    assert outcome == ("ok", {"a": [0, 1, 2, 3, 4], "b": ["s0", "s1", "s2", "s3", "s4"]})
    assert reqs[0].method == "HEAD" and all(r.range for r in reqs if r.method == "GET")


def test_https_refuses_a_certificate_it_does_not_trust(https, monkeypatch):
    """Without the loopback certificate in its store, each package's read and
    download raise the same error type, and no request reaches the stub."""
    _trust(monkeypatch, None)

    def run(p):
        with _ctx(p):
            return p.pkg.read_parquet(f"{https.url}/data.parquet").to_pydict()

    outcome, reqs = _both(https, run)
    assert outcome[0] == "raised" and reqs == []
    outcome, reqs = _both(https, lambda p: _download(p, [f"{https.url}/blob.bin"]))
    assert outcome == ("raised", "DaftIOError") and reqs == []


def _download(p, urls, **kw):
    with _ctx(p):
        return p.pkg.from_pydict({"u": urls}).select(
            p.pkg.col("u").url.download(**kw)).to_pydict()["u"]


def test_http_readable_file_ranges(http):
    def run(p):
        f = p.http.HttpReadableFile(f"{http.url}/blob.bin")
        size = f.size()
        f.seek(256)
        a = f.read(4)
        f.seek(-4, 2)
        return size, a, f.read()

    outcome, reqs = _both(http, run)
    assert outcome == ("ok", (256 * 64, bytes([0, 1, 2, 3]), bytes([252, 253, 254, 255])))
    assert [r.range for r in reqs] == [None, "bytes=256-259", "bytes=16380-16383"]


def test_http_get_server_ignoring_range(http_root):
    """A server that ignores Range answers 200 with the whole body:
    ``http_get`` slices it locally."""
    with HttpStub(str(http_root), ranges=False) as stub:
        outcome, reqs = _both(stub, lambda p: p.http.http_get(f"{stub.url}/blob.bin", 256, 4))
    assert outcome == ("ok", bytes([0, 1, 2, 3])) and reqs[0].status == 200


def test_hf_url_resolution():
    for path in ("hf://datasets/org/repo/f.parquet", "hf://datasets/org/repo@v2/dir/f.parquet",
                 "hf://org/repo/f.txt", "hf://spaces/org/repo/app.py"):
        assert thttp.resolve_hf_url(path) == jhttp.resolve_hf_url(path)
    assert thttp.resolve_hf_url("hf://datasets/org/repo@v2/dir/f.parquet") == \
        "https://huggingface.co/datasets/org/repo/resolve/v2/dir/f.parquet"
    for p in (JAX, PORT):
        with pytest.raises(p.pkg.errors.DaftIOError):
            p.http.resolve_hf_url("hf://justonepart")


def test_read_parquet_hf_scheme(http, monkeypatch):
    for p in (JAX, PORT):
        monkeypatch.setattr(p.http, "HF_RESOLVE_BASE", http.url)

    def run(p):
        with _ctx(p):
            return p.pkg.read_parquet("hf://datasets/org/repo/part0.parquet").to_pydict()["a"]

    outcome, reqs = _both(http, run)
    assert outcome == ("ok", list(range(10)))
    assert reqs[0].path == "/datasets/org/repo/resolve/main/part0.parquet"


def test_parallel_ranged_read(tmp_path):
    p = tmp_path / "x.bin"
    data = bytes(range(256)) * 100
    p.write_bytes(data)
    ranges = [(0, 10), (100, 50), (25000, 600), (len(data) - 7, 7)]
    out = tiostats.parallel_ranged_read(str(p), ranges, max_concurrency=4)
    assert out == jiostats.parallel_ranged_read(str(p), ranges, max_concurrency=4)
    for (start, length), got in zip(ranges, out):
        assert got == data[start:start + length]


def test_parallel_ranged_read_retries(tmp_path, monkeypatch):
    p = tmp_path / "x.bin"
    p.write_bytes(b"0123456789")
    monkeypatch.setattr("time.sleep", lambda s: None)
    results = {}
    for pk in (JAX, PORT):
        real = pk.io.read_range
        fails = {"n": 0}

        def flaky(path, start, length, io_config=None, real=real, fails=fails):
            if start == 4 and fails["n"] < 2:
                fails["n"] += 1
                raise ConnectionError("transient")
            return real(path, start, length, io_config)

        monkeypatch.setattr(pk.io, "read_range", flaky)
        out = pk.io.parallel_ranged_read(str(p), [(0, 4), (4, 4)], policy=pk.retry.RetryPolicy(
            max_retries=3, backoff_base_s=0.0))
        results[pk.name] = (out, fails["n"])
    assert results["port"] == results["jax"] == ([b"0123", b"4567"], 2)


class _FlakyFS:
    """Delegating pyarrow-fs wrapper: the first ``fail_first`` part writes
    raise."""

    def __init__(self, inner, fail_first: int = 0):
        self.inner = inner
        self.fail_first = fail_first
        self.part_writes = 0
        self.paths = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def open_output_stream(self, path, *a, **kw):
        self.paths.append(path)
        if ".daft-parts/" in path:
            self.part_writes += 1
            if self.part_writes <= self.fail_first:
                raise ConnectionError(f"injected failure #{self.part_writes}")
        return self.inner.open_output_stream(path, *a, **kw)


def test_multipart_upload_roundtrip_with_retries(tmp_path, monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)
    payload = np.random.default_rng(0).integers(0, 256, 5 * (1 << 20) + 1234,
                                                dtype=np.uint8).tobytes()
    for p in (JAX, PORT):
        p.io.reset_io_stats()
        target = str(tmp_path / f"{p.name}.bin")
        fs = _FlakyFS(pafs.LocalFileSystem(), fail_first=2)
        up = p.io.MultipartUpload(target, part_size=1 << 20, max_concurrency=3, filesystem=fs,
                                  policy=p.retry.RetryPolicy(max_retries=3, backoff_base_s=0.0))
        for off in range(0, len(payload), 700_000):
            up.write(payload[off:off + 700_000])
        assert up.close() == len(payload)
        assert open(target, "rb").read() == payload
        assert not os.path.exists(target + ".daft-parts")
        assert p.io.IO_STATS.snapshot().retries >= 2


def test_multipart_upload_resume_skips_staged_parts(tmp_path):
    part0, part1 = b"A" * (1 << 20), b"B" * 1000
    written = {}
    for p in (JAX, PORT):
        target = str(tmp_path / f"{p.name}.bin")
        os.makedirs(target + ".daft-parts")  # a previous attempt staged part 00000
        with open(target + ".daft-parts/00000", "wb") as f:
            f.write(part0)
        fs = _FlakyFS(pafs.LocalFileSystem())
        up = p.io.MultipartUpload(target, part_size=1 << 20, filesystem=fs)
        up.write(part0)
        up.write(part1)
        assert up.close() == len(part0) + len(part1)
        assert open(target, "rb").read() == part0 + part1
        written[p.name] = [os.path.relpath(x, str(tmp_path)).replace(p.name, "T") for x in fs.paths]
    assert written["port"] == written["jax"]
    assert not any(x.endswith("/00000") for x in written["port"])


def test_multipart_failure_keeps_parts_for_resume(tmp_path, monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)
    for p in (JAX, PORT):
        target = str(tmp_path / f"{p.name}.bin")
        fs = _FlakyFS(pafs.LocalFileSystem(), fail_first=99)
        up = p.io.MultipartUpload(target, part_size=1000, filesystem=fs,
                                  policy=p.retry.RetryPolicy(max_retries=1, backoff_base_s=0.0))
        up.write(b"x" * 2500)
        with pytest.raises(p.pkg.errors.DaftIOError, match="resume"):
            up.close()
        assert not os.path.exists(target)


def test_with_retries_respects_policy(monkeypatch):
    for p in (JAX, PORT):
        sleeps = []
        monkeypatch.setattr("time.sleep", lambda s, sleeps=sleeps: sleeps.append(s))
        calls = {"n": 0}

        def flaky(calls=calls):
            calls["n"] += 1
            if calls["n"] < 3:
                raise TimeoutError("slow")
            return 42

        assert p.retry.with_retries(flaky, p.retry.RetryPolicy(max_retries=4,
                                                               backoff_base_s=0.1)) == 42
        assert calls["n"] == 3 and len(sleeps) == 2
        assert sleeps[1] > sleeps[0] * 0.9  # the backoff grows (jitter aside)
        with pytest.raises(ValueError):
            p.retry.with_retries(lambda: (_ for _ in ()).throw(ValueError("fatal")),
                                 p.retry.RetryPolicy(max_retries=5))


def test_glob_keeps_full_uri_for_remote(http):
    def run(p):
        return [(f.path, f.size_bytes) for f in p.scan.glob_paths([f"{http.url}/data.parquet"])]

    outcome, _ = _both(http, run)
    (path, size), = outcome[1]
    assert path == f"{http.url}/data.parquet" and size > 0


def test_read_huggingface_repo_listing(http, monkeypatch):
    """A repo-level ``read_huggingface`` lists the parquet files through the
    dataset-viewer API, then reads them as ranged HTTP objects."""
    http.routes["/api/datasets/org/repo/parquet"] = json.dumps({"default": {"train": [
        f"{http.url}/datasets/org/repo/resolve/main/part0.parquet"]}}).encode()
    for p in (JAX, PORT):
        monkeypatch.setattr(p.http, "HF_RESOLVE_BASE", http.url)

    def run(p):
        with _ctx(p):
            return p.pkg.read_huggingface("org/repo").to_pydict()["a"]

    outcome, reqs = _both(http, run)
    assert outcome == ("ok", list(range(10)))
    assert reqs[0].path == "/api/datasets/org/repo/parquet"


def test_http_url_with_query_string_not_globbed(http):
    """'?' in an HTTP URL starts a query string (presigned URLs), never a
    glob wildcard."""
    def run(p):
        with _ctx(p):
            return len(p.pkg.read_parquet(f"{http.url}/data.parquet?sig=abc123").to_pydict()["a"])

    outcome, reqs = _both(http, run)
    assert outcome == ("ok", 1000) and all(r.query == "sig=abc123" for r in reqs)


# --------------------------------------------------------------------- #
# tests/test_io_plugins.py::test_url_download_upload                      #
# --------------------------------------------------------------------- #
def test_url_download_upload(tmp_path):
    for i in range(2):
        (tmp_path / f"f{i}.bin").write_bytes(f"payload-{i}".encode())
    for p in (JAX, PORT):
        col = p.pkg.col
        with _ctx(p):
            df = p.pkg.from_pydict({"p": [str(tmp_path / "f0.bin"), str(tmp_path / "f1.bin"),
                                          None]})
            out = df.with_column("d", col("p").url.download(on_error="null")).to_pydict()
            assert out["d"] == [b"payload-0", b"payload-1", None]
            up = p.pkg.from_pydict({"d": [b"abc"]})
            res = up.with_column("loc", col("d").url.upload(
                location=str(tmp_path / f"up-{p.name}"))).to_pydict()
            assert open(res["loc"][0], "rb").read() == b"abc"
            with pytest.raises(Exception):
                p.pkg.from_pydict({"p": ["/nope/missing"]}).select(
                    col("p").url.download()).to_pydict()


# --------------------------------------------------------------------- #
# Beyond the JAX files                                                   #
# --------------------------------------------------------------------- #
@pytest.fixture
def stores(monkeypatch, tmp_path):
    """An S3, a GCS and an HTTP stub over one directory of objects, and each
    package's IOConfig for them; the GCS credential chain static."""
    for var in ("AWS_ACCESS_KEY_ID", "GOOGLE_APPLICATION_CREDENTIALS", "GCE_METADATA_HOST",
                "DAFT_GCS_ENDPOINT", "STORAGE_EMULATOR_HOST", "DAFT_NATIVE_GCS"):
        monkeypatch.delenv(var, raising=False)
    for p in (JAX, PORT):
        monkeypatch.setattr(p.auth, "_METADATA_PROBE", False)
        p.auth._PROVIDER_CACHE.clear()
        p.circuit.reset_circuit_breakers()
    objs = tmp_path / "objs"
    objs.mkdir()
    for i in range(6):
        (objs / f"o{i}.bin").write_bytes(bytes([i]) * (100 + i))
    s3, gcs, http = S3Stub(root=str(tmp_path / "s3")), GcsStub(root=str(tmp_path / "gcs")), \
        HttpStub(str(tmp_path))
    https = HttpStub(str(tmp_path), tls=True)
    _trust(monkeypatch, LOOPBACK_CERT)
    s3.mount("bkt", str(objs))
    gcs.mount("bkt", str(objs))

    def io_config(p):
        m = p.pkg
        return m.IOConfig(s3=m.S3Config(endpoint_url=s3.url, region_name=s3.region,
                                        key_id=s3.key_id, access_key=s3.secret,
                                        use_native_client=True, num_tries=2),
                          gcs=m.GCSConfig(endpoint_url=gcs.url, token="t0"))

    yield SimpleNamespace(s3=s3, gcs=gcs, gs=gcs, http=http, https=https, objs=objs,
                          io_config=io_config,
                          urls={"s3": "s3://bkt", "gs": "gs://bkt", "http": f"{http.url}/objs",
                                "https": f"{https.url}/objs"})
    for stub in (s3, gcs, http, https):
        stub.close()
    monkeypatch.undo()
    urllib.request.install_opener(None)
    for p in (JAX, PORT):
        p.auth._PROVIDER_CACHE.clear()
        p.circuit.reset_circuit_breakers()


def _with_io(p, stores, fn):
    with p.pkg.planning_config_ctx(default_io_config=stores.io_config(p)), _ctx(p):
        return fn()


@pytest.mark.parametrize("on_error", ["raise", "null"])
@pytest.mark.parametrize("scheme", ["s3", "gs", "http", "https"])
def test_url_download_over_each_scheme_equals_the_jax_series(stores, scheme, on_error):
    """The same URLs, a missing object and a null among them, give the same
    Series (``on_error="null"``) or the same error type (``"raise"``), and
    the stub sees the same requests, as a set: the downloads run on a pool
    of ``max_connections``."""
    stub = getattr(stores, scheme)
    base = stores.urls[scheme]
    urls = [f"{base}/o{i}.bin" for i in range(6)] + [None, f"{base}/missing.bin"]

    def run(p):
        def q():
            return p.pkg.from_pydict({"u": urls}).select(
                p.pkg.col("u").url.download(on_error=on_error, max_connections=4)).to_pydict()
        return _with_io(p, stores, q)["u"]

    out = {}
    for p in (JAX, PORT):
        stub.take_log()
        try:
            got = ("ok", run(p))
        except Exception as e:  # noqa: BLE001
            got = ("raised", type(e).__name__, "missing.bin" in str(e))
        out[p.name] = (got, sorted(stub.take_log()))
    assert out["port"] == out["jax"]
    if on_error == "null":
        assert out["port"][0] == ("ok", [bytes([i]) * (100 + i) for i in range(6)] + [None, None])
    else:
        assert out["port"][0] == ("raised", "DaftIOError", True)


@pytest.mark.parametrize("scheme", ["s3", "gs"])
def test_url_upload_to_an_object_store_reads_back(stores, scheme):
    """``url.upload`` writes each row's bytes under the location and
    ``url.download`` reads them back; the JAX package's rows read back alike
    (the names are random, so the bytes are compared)."""
    location = f"{scheme}://out/emb"
    rows = [np.arange(i, i + 8, dtype=np.float32).tobytes() for i in range(5)] + [None]
    got = {}
    for p in (JAX, PORT):
        def q():
            up = p.pkg.from_pydict({"b": rows}).select(
                p.pkg.col("b").url.upload(location=location).alias("loc")).to_pydict()["loc"]
            back = p.pkg.from_pydict({"loc": up}).select(
                p.pkg.col("loc").url.download()).to_pydict()["loc"]
            return up, back

        up, back = _with_io(p, stores, q)
        assert all(u.startswith(location + "/") for u in up[:5]) and up[5] is None
        got[p.name] = back
    assert got["port"] == got["jax"] == rows
    assert not stores.s3.bad_auth and not stores.gcs.bad_auth


@pytest.mark.parametrize("scheme", ["s3", "gs", "http", "https"])
def test_remote_file_bytes_and_size(stores, scheme):
    url = f"{stores.urls[scheme]}/o3.bin"

    def run(p):
        def q():
            f = p.pkg.File.from_path(url)
            with f.open() as fh:
                head = fh.read(5)
            return f.read(), f.size(), head
        return _with_io(p, stores, q)

    outcome, _ = _both(getattr(stores, scheme), run)
    assert outcome == ("ok", (bytes([3]) * 103, 103, bytes([3]) * 5))


def test_breaker_opens_on_an_endpoint_answering_503_then_closes(stores):
    """An endpoint that answers only 503: the download raises naming the URL
    (the S3 client's retries spent, then the breaker open, failing fast);
    once it answers again and the breaker's cooldown has passed, the next
    query reads the bytes. The same in both packages."""
    url = "s3://bkt/o1.bin"
    out = {}
    for p in (JAX, PORT):
        def q():
            return p.pkg.from_pydict({"u": [url]}).select(
                p.pkg.col("u").url.download()).to_pydict()["u"]

        stores.s3.fail_all = 503
        errors = []
        try:
            for _ in range(4):  # 2 tries each: the 5th failure opens the circuit
                with pytest.raises(p.pkg.errors.DaftError) as ei:
                    _with_io(p, stores, q)
                errors.append("o1.bin" in str(ei.value))
            breaker = p.circuit.breaker_for(stores.s3.url)
            opened = breaker.state()
        finally:
            stores.s3.fail_all = None
        deadline = time.monotonic() + 40
        while True:
            try:
                got = _with_io(p, stores, q)
                break
            except p.pkg.errors.DaftError:
                assert time.monotonic() < deadline, "the breaker never closed"
                time.sleep(0.2)
        out[p.name] = (errors, opened, got, breaker.state())
    assert out["port"] == out["jax"]
    assert out["port"] == ([True] * 4, "open", [bytes([1]) * 101], "closed")


def test_write_to_s3_drops_the_result_cache_entry(stores):
    """A query over s3:// is served from the result cache until
    a write under its prefix, which drops the entry; the next read sees the
    new rows. The port writes through the native client (C.51: the JAX
    package's writers hand a remote root to pyarrow's URI resolution, which
    ignores the IOConfig, so its side only reads the port's objects)."""
    from daft_tpu_torch.metrics import get_registry

    def hits():
        return get_registry().snapshot().counter_total("daft_result_cache_hits_total")

    loc = "s3://out/t"
    cache = dict(device="cpu", result_cache_enabled=True, plan_cache_enabled=True)
    with daft_tpu_torch.planning_config_ctx(default_io_config=stores.io_config(PORT)), \
            daft_tpu_torch.execution_config_ctx(**cache):
        dt = daft_tpu_torch
        written = dt.from_pydict({"a": [1, 2, 3]}).write_parquet(loc).to_pydict()["path"]
        assert len(written) == 1 and written[0].startswith(loc + "/")
        q = lambda: dt.read_parquet(loc).agg(dt.col("a").sum().alias("s"))  # noqa: E731
        first = q().to_pydict()
        before = hits()
        second = q().to_pydict()
        served = hits() - before
        dt.from_pydict({"a": [10]}).write_parquet(loc)
        third = q().to_pydict()
    assert (first, second, third) == ({"s": [6]}, {"s": [6]}, {"s": [16]})
    assert served == 1
    with daft_tpu.planning_config_ctx(default_io_config=stores.io_config(JAX)), _ctx(JAX):
        assert daft_tpu.read_parquet(loc).agg(daft_tpu.col("a").sum().alias("s")).to_pydict() \
            == third
    assert not stores.s3.bad_auth


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json"])
def test_each_writer_writes_under_an_s3_root(stores, fmt, monkeypatch):
    """Every writer puts its files under an object-store root through the
    native client (C.51) and the reader gets the rows back; an overwrite
    there raises, since the port replaces files under local roots only.
    ``io_stats`` counts one PUT and its bytes per file written, through the
    native client (which counts its own) and through Arrow's
    ``S3FileSystem`` (which counts none, so the writer does)."""
    monkeypatch.setenv("AWS_EC2_METADATA_DISABLED", "true")  # no instance metadata lookups
    data = {"a": [1, 2, 3], "b": ["x", "y", "z"]}
    dt = daft_tpu_torch
    native = stores.io_config(PORT)
    arrow = dt.IOConfig(s3=dt.S3Config(endpoint_url=stores.s3.url, region_name=stores.s3.region,
                                       key_id=stores.s3.key_id, access_key=stores.s3.secret))
    puts = {}
    for client, io_config in (("native", native), ("arrow", arrow)):
        loc = f"s3://out/{fmt}-{client}"
        with dt.planning_config_ctx(default_io_config=io_config), _ctx(PORT):
            dt.reset_io_stats()
            written = getattr(dt.from_pydict(data), f"write_{fmt}")(loc).to_pydict()
            s = dt.io_stats()
            puts[client] = (s.puts, s.bytes_written > 0)
            back = getattr(dt, f"read_{fmt}")(loc).sort("a").to_pydict()
            if client == "native":
                with pytest.raises(dt.errors.DaftValueError, match="overwrite"):
                    getattr(dt.from_pydict(data), f"write_{fmt}")(loc, write_mode="overwrite")
        assert back == data and written["num_rows"] == [3]
    assert puts == {"native": (1, True), "arrow": (1, True)}
    assert [r.method for r in stores.s3.take_log() if r.method == "PUT"] == ["PUT"] * 3
    assert not stores.s3.bad_auth, stores.s3.bad_auth[:1]


def test_set_storage_option_and_the_lists_of_what_is_left_out():
    from daft_tpu.io.config import get_storage_options as jget
    from daft_tpu_torch.dataframe import dataframe as tdf
    from daft_tpu_torch.io.config import get_storage_options as tget
    from daft_tpu_torch.kernels import registry

    daft_tpu.DataFrame.set_storage_option("multipart_size", 8 << 20)
    daft_tpu_torch.DataFrame.set_storage_option("multipart_size", 8 << 20)
    assert tget() == jget() and tget()["multipart_size"] == str(8 << 20)
    assert "set_storage_option" not in tdf._LEFT_OUT and registry.LEFT_OUT == {}
    assert "read_huggingface" not in daft_tpu_torch._NOT_PORTED
    assert daft_tpu_torch.read_huggingface.__module__ == "daft_tpu_torch.io.reads"


def test_azure_schemes_resolve_as_in_the_jax_package():
    from daft_tpu.io.config import AzureConfig as JAzure
    from daft_tpu.io.config import IOConfig as JIO
    from daft_tpu.io.config import filesystem_for as jfor
    from daft_tpu_torch.io.config import AzureConfig, IOConfig, filesystem_for

    key = "a2V5"  # base64 of the account key: no request is made to build the filesystem
    for scheme in ("az", "abfs", "abfss"):
        port = filesystem_for(scheme, IOConfig(azure=AzureConfig(storage_account="acct",
                                                                 access_key=key)))
        jax = jfor(scheme, JIO(azure=JAzure(storage_account="acct", access_key=key)))
        assert type(port) is type(jax) is pafs.AzureFileSystem


def test_stubs_join_every_thread_on_close(http_root):
    """Each stub's server and handler threads end on ``close()``, kept-alive
    connections included."""
    import urllib.request

    before = set(threading.enumerate())
    stubs = [S3Stub(anonymous=True), GcsStub(allow_anonymous=True), HttpStub(str(http_root))]
    for stub in stubs:
        try:
            urllib.request.urlopen(f"{stub.url}/blob.bin", timeout=10).read()
        except Exception:  # noqa: BLE001 — a 404 is an answer too
            pass
    for stub in stubs:
        stub.close()
    assert set(threading.enumerate()) - before == set()


def test_a_stub_in_a_child_process_serves_both_packages_alike_and_ends_on_close(tmp_path):
    """``ChildStub`` serves from a child process what the stub serves in
    process: both packages' downloads see the same requests, its log comes
    back as ``Request`` s, an assigned attribute and a method reach the stub
    (a 503 answered and retried), and ``close()`` ends the child."""
    objs = tmp_path / "objs"
    objs.mkdir()
    for i in range(4):
        (objs / f"o{i}.bin").write_bytes(bytes([i]) * (50 + i))
    stub = ChildStub("s3", region="us-east-1")
    try:
        stub.mount("bkt", str(objs))
        urls = [f"s3://bkt/o{i}.bin" for i in range(4)]

        def run(p):
            cfg = p.pkg.IOConfig(s3=p.pkg.S3Config(
                endpoint_url=stub.url, region_name=stub.region, key_id=stub.key_id,
                access_key=stub.secret, use_native_client=True))
            p.circuit.reset_circuit_breakers()
            p.io.reset_io_stats()
            with p.pkg.planning_config_ctx(default_io_config=cfg), _ctx(p):
                rows = p.pkg.from_pydict({"u": urls}).select(
                    p.pkg.col("u").url.download(max_connections=1)).to_pydict()["u"]
            return rows, p.io.io_stats().retries

        stub.fail_first_get_every(3)
        out = {}
        for p in (JAX, PORT):
            stub.take_log()
            stub.reset_counters()
            out[p.name] = (run(p), stub.take_log(), stub.injected)
        assert out["port"] == out["jax"]
        (rows, retries), log, injected = out["port"]
        assert rows == [bytes([i]) * (50 + i) for i in range(4)]
        assert retries == injected == 2 and all(isinstance(r, Request) for r in log)
        assert [r.status for r in log].count(503) == 2 and stub.bad_auth == []
        stub.fail_all = 503
        assert stub.fail_all == 503
    finally:
        stub.close()
    assert stub._proc.returncode == 0  # the child closed its stub and exited


def test_the_same_url_through_another_store_is_another_source(tmp_path):
    """ROADMAP C.54: with both caches on, ``s3://bkt/t.parquet`` through two
    endpoints that hold different objects reads each endpoint's rows, with
    the IOConfig given to the reader or as the context's default. The port
    keys a remote scan on the IOConfig it resolves with; the JAX package's
    key drops it and serves the first endpoint's plan."""
    from daft_tpu_torch import plancache as tpc

    rows = {"one": [1, 2], "two": [7, 8, 9]}
    for name, a in rows.items():
        (tmp_path / name).mkdir()
        pq.write_table(pa.table({"a": a}), tmp_path / name / "t.parquet")
    with S3Stub() as one, S3Stub() as two:
        one.mount("bkt", str(tmp_path / "one"))
        two.mount("bkt", str(tmp_path / "two"))
        got = []
        with daft_tpu_torch.execution_config_ctx(device="cpu", plan_cache_enabled=True,
                                                 result_cache_enabled=True):
            tpc.reset_caches()
            for stub in (one, two, one):
                cfg = daft_tpu_torch.IOConfig(s3=daft_tpu_torch.S3Config(
                    endpoint_url=stub.url, region_name=stub.region, key_id=stub.key_id,
                    access_key=stub.secret, use_native_client=True))
                got.append(daft_tpu_torch.read_parquet("s3://bkt/t.parquet", io_config=cfg)
                           .to_pydict()["a"])
                with daft_tpu_torch.planning_config_ctx(default_io_config=cfg):
                    got.append(daft_tpu_torch.read_parquet("s3://bkt/t.parquet").to_pydict()["a"])
            tpc.reset_caches()
    assert got == [rows["one"]] * 2 + [rows["two"]] * 2 + [rows["one"]] * 2
