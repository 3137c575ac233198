"""The port's sigv4 signer and native S3 client (``daft_tpu_torch/io/sigv4.py``,
``io/s3_client.py``) beside the JAX package's, over one S3 stub.

Mirrors ``tests/test_s3_native.py`` case for case and
``tests/test_cloud_catalogs.py::test_sigv4_aws_reference_vector``. The stub
(``daft_tpu_torch/tools/object_stores.py::S3Stub``) serves a directory in
place, path-style, and checks every request's signature with its own
``hmac`` code. Each case runs the same steps through both packages against
the one stub, its objects cleared between the two runs, and holds the port
to the JAX package on what came back (or the error type raised) and on the
requests the stub saw: method, path, query, ``Range``, the body's SHA-256 and
the status. Beyond the JAX file: the port's sigv4 headers equal the JAX
package's at a fixed ``now=``, a wrong secret is refused, 503 ``SlowDown``
answers are retried and counted, listings page through continuation tokens,
the handler publishes a write once and never on unwind, and Arrow's
``S3FileSystem`` reads the stub as the native client does.
"""

import datetime
import hashlib
import os
from types import SimpleNamespace

import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.io import config as jconfig
from daft_tpu.io import iostats as jiostats
from daft_tpu.io import s3_client as js3
from daft_tpu.io import sigv4 as jsigv4
from daft_tpu_torch.io import config as tconfig
from daft_tpu_torch.io import iostats as tiostats
from daft_tpu_torch.io import s3_client as ts3
from daft_tpu_torch.io import sigv4 as tsigv4
from daft_tpu_torch.tools.object_stores import S3Stub
from torch_isolation import caches_reset  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning"),
              pytest.mark.usefixtures("caches_reset")]

KEY_ID, SECRET, REGION = "AKIDFIXTURE", "fixture-secret", "fix-region"

JAX = SimpleNamespace(name="jax", pkg=daft_tpu, cfg=jconfig, s3=js3, sigv4=jsigv4, io=jiostats)
PORT = SimpleNamespace(name="port", pkg=daft_tpu_torch, cfg=tconfig, s3=ts3, sigv4=tsigv4,
                       io=tiostats)


@pytest.fixture
def s3(monkeypatch, tmp_path):
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN", "DAFT_NATIVE_S3"):
        monkeypatch.delenv(var, raising=False)
    stub = S3Stub(KEY_ID, SECRET, REGION, root=str(tmp_path / "store"))
    yield stub
    stub.close()


def _cfg(p, stub, **kw):
    args = dict(region_name=REGION, endpoint_url=stub.url, key_id=KEY_ID, access_key=SECRET,
                use_native_client=True)
    args.update(kw)
    return p.cfg.S3Config(**args)


def _both(stub, run):
    """``run(p)`` through each package against ``stub``, cleared before each:
    (outcome, requests) of the port, held equal to the JAX package's."""
    out = {}
    for p in (JAX, PORT):
        stub.clear()
        stub.take_log()
        try:
            got = ("ok", run(p))
        except Exception as e:  # noqa: BLE001 — the outcome compared
            got = ("raised", type(e).__name__, getattr(e, "status", None))
        out[p.name] = (got, stub.take_log())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert not stub.bad_auth, stub.bad_auth[:1]
    return out["port"]


# --------------------------------------------------------------------- #
# tests/test_s3_native.py                                                #
# --------------------------------------------------------------------- #
def test_key_needing_percent_encoding_signs_single_encoded(s3):
    """The path is signed as sent (single encoding): the stub recomputes the
    signature from the received path."""
    key = "dir with space/a+b#c.bin"

    def run(p):
        c = p.s3.S3Client(_cfg(p, s3))
        c.put_object("bkt", key, b"payload")
        return [c.get_object("bkt", key), c.get_object("bkt", key, start=2, length=3)]

    (outcome, reqs) = _both(s3, run)
    assert outcome == ("ok", [b"payload", b"ylo"])
    assert reqs[0].path == "/bkt/dir%20with%20space/a%2Bb%23c.bin"


def test_put_get_ranged_list_delete(s3):
    def run(p):
        c = p.s3.S3Client(_cfg(p, s3))
        c.put_object("bkt", "dir/a.bin", b"0123456789abcdef")
        out = [c.get_object("bkt", "dir/a.bin"), c.get_object("bkt", "dir/a.bin", 4, 6)]
        c.put_object("bkt", "dir/b.bin", b"xy")
        out.append([(o.key, o.size) for o in c.list_objects("bkt", prefix="dir/")])
        c.delete_object("bkt", "dir/b.bin")
        out.append([o.key for o in c.list_objects("bkt", prefix="dir/")])
        return out

    outcome, reqs = _both(s3, run)
    assert outcome[1] == [b"0123456789abcdef", b"456789",
                          [("dir/a.bin", 16), ("dir/b.bin", 2)], ["dir/a.bin"]]
    assert [r.range for r in reqs if r.method == "GET" and r.path == "/bkt/dir/a.bin"] == \
        [None, "bytes=4-9"]
    assert reqs[0].body_sha256 == hashlib.sha256(b"0123456789abcdef").hexdigest()


def test_engine_reads_parquet_through_native_client(s3, tmp_path):
    """read_parquet over s3:// with ``use_native_client``: the glob, the open
    and the ranged parquet reads ride the signed client, the same requests
    in both packages."""
    data = tmp_path / "data" / "tbl"
    data.mkdir(parents=True)
    pq.write_table(pa.table({"a": list(range(50)), "b": ["v"] * 50}), data / "t.parquet")
    s3.mount("data", str(tmp_path / "data"))

    def run(p):
        io_cfg = p.cfg.IOConfig(s3=_cfg(p, s3))
        with p.pkg.execution_config_ctx(result_cache_enabled=False):
            return (p.pkg.read_parquet("s3://data/tbl", io_config=io_cfg)
                    .where(p.pkg.col("a") >= 45).sort("a").to_pydict())

    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        outcome, reqs = _both(s3, run)
    assert outcome[1]["a"] == [45, 46, 47, 48, 49]
    assert any(r.range for r in reqs)  # ranged reads, never a whole-object fetch per touch


def test_list_prefix_with_space_signs_percent20(s3):
    """The sent query uses %20 (never '+'), as the canonical query does."""
    def run(p):
        c = p.s3.S3Client(_cfg(p, s3))
        c.put_object("bkt", "dir with space/a.bin", b"xy")
        return [(o.key, o.size) for o in c.list_objects("bkt", prefix="dir with space/")]

    outcome, reqs = _both(s3, run)
    assert outcome == ("ok", [("dir with space/a.bin", 2)])
    assert "prefix=dir%20with%20space%2F" in reqs[-1].query


def test_zero_length_get_short_circuits(s3):
    """length=0 returns b'' and sends no request (``bytes=N-(N-1)`` would be
    an invalid Range, HTTP 416)."""
    def run(p):
        c = p.s3.S3Client(_cfg(p, s3))
        c.put_object("bkt", "k.bin", b"0123456789")
        return [c.get_object("bkt", "k.bin", start=4, length=0),
                c.get_object("bkt", "k.bin", start=4, length=3)]

    outcome, reqs = _both(s3, run)
    assert outcome == ("ok", [b"", b"456"])
    assert [(r.method, r.range) for r in reqs] == [("PUT", None), ("GET", "bytes=4-6")]


def test_selector_recursive_and_allow_not_found(s3):
    """``get_file_info_selector`` honours ``selector.recursive`` (delimiter
    '/' and Directory entries from CommonPrefixes) and
    ``selector.allow_not_found``."""
    def run(p):
        c = p.s3.S3Client(_cfg(p, s3))
        for k in ("d/x.bin", "d/y.bin", "d/sub/z.bin"):
            c.put_object("bkt", k, b"abc")
        fs = pafs.PyFileSystem(p.s3.S3FileSystemHandler(c))
        rec = sorted(i.path for i in fs.get_file_info(pafs.FileSelector("bkt/d", recursive=True)))
        flat = {i.path: i.type for i in fs.get_file_info(pafs.FileSelector("bkt/d"))}
        try:
            fs.get_file_info(pafs.FileSelector("bkt/nope", recursive=True))
            missing = None
        except FileNotFoundError:
            missing = "FileNotFoundError"
        allowed = fs.get_file_info(pafs.FileSelector("bkt/nope", recursive=True,
                                                     allow_not_found=True))
        return rec, flat, missing, allowed

    outcome, _ = _both(s3, run)
    assert outcome[1] == (["bkt/d/sub/z.bin", "bkt/d/x.bin", "bkt/d/y.bin"],
                          {"bkt/d/sub": pafs.FileType.Directory,
                           "bkt/d/x.bin": pafs.FileType.File,
                           "bkt/d/y.bin": pafs.FileType.File},
                          "FileNotFoundError", [])


def test_anonymous_requests_unsigned(monkeypatch, tmp_path):
    """The credential chain: anonymous and nothing set give None; the
    environment, then an explicit config, which beats it. An anonymous
    client's requests carry no Authorization header."""
    def chain(p):
        monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
        out = [p.sigv4.resolve_credentials(p.cfg.S3Config(anonymous=True)),
               p.sigv4.resolve_credentials(None)]
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
        env = p.sigv4.resolve_credentials(None)
        cfg = p.sigv4.resolve_credentials(p.cfg.S3Config(key_id="cfg", access_key="ca"))
        monkeypatch.delenv("AWS_ACCESS_KEY_ID")
        return out + [(env.key_id, env.secret_key), (cfg.key_id, cfg.secret_key)]

    assert chain(PORT) == chain(JAX) == [None, None, ("k", "s"), ("cfg", "ca")]
    with S3Stub(KEY_ID, SECRET, REGION, root=str(tmp_path), anonymous=True) as stub:
        (tmp_path / "pub").mkdir()
        (tmp_path / "pub" / "obj").write_bytes(b"public-bytes")
        outcome, reqs = _both(stub, lambda p: p.s3.S3Client(
            p.cfg.S3Config(endpoint_url=stub.url, anonymous=True)).get_object("pub", "obj", 0, 6))
    assert outcome == ("ok", b"public")


# --------------------------------------------------------------------- #
# tests/test_cloud_catalogs.py::test_sigv4_aws_reference_vector          #
# --------------------------------------------------------------------- #
def test_sigv4_aws_reference_vector():
    """AWS's published sigv4 example (GET iam ListUsers, 2015-08-30)."""
    headers = tsigv4.sign_request(
        "GET", "https://iam.amazonaws.com/", region="us-east-1", service="iam",
        credentials=tsigv4.AwsCredentials("AKIDEXAMPLE",
                                          "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"),
        headers={"Content-Type": "application/x-www-form-urlencoded; charset=utf-8"},
        query={"Action": "ListUsers", "Version": "2010-05-08"},
        now=datetime.datetime(2015, 8, 30, 12, 36, 0, tzinfo=datetime.timezone.utc))
    assert headers["Authorization"] == (
        "AWS4-HMAC-SHA256 "
        "Credential=AKIDEXAMPLE/20150830/us-east-1/iam/aws4_request, "
        "SignedHeaders=content-type;host;x-amz-date, "
        "Signature=5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")


# --------------------------------------------------------------------- #
# Beyond the JAX file                                                    #
# --------------------------------------------------------------------- #
NOW = datetime.datetime(2026, 3, 1, 8, 30, 5, tzinfo=datetime.timezone.utc)


@pytest.mark.parametrize("case", [
    dict(method="GET", url="http://127.0.0.1:9/bkt/dir%20a/k.bin", service="s3",
         headers={"Range": "bytes=0-9"}),
    dict(method="PUT", url="http://127.0.0.1:9/bkt/k", service="s3", payload=b"\x00" * 33),
    dict(method="GET", url="http://127.0.0.1:9/bkt", service="s3",
         query={"list-type": "2", "prefix": "a b/+c", "continuation-token": "x=="}),
    dict(method="POST", url="https://glue.us-east-1.amazonaws.com/a b", service="glue",
         payload=b'{"x": 1}', token="session-token"),
], ids=["ranged-get", "put", "list", "glue-session"])
def test_sigv4_headers_equal_the_jax_package_at_a_fixed_now(case):
    case = dict(case)
    token = case.pop("token", None)

    def sign(p):
        creds = p.sigv4.AwsCredentials(KEY_ID, SECRET, token)
        return p.sigv4.sign_request(case["method"], case["url"], region=REGION,
                                    service=case["service"], credentials=creds,
                                    headers=case.get("headers"), query=case.get("query"),
                                    payload=case.get("payload", b""), now=NOW)

    assert sign(PORT) == sign(JAX)
    assert sign(PORT)["x-amz-date"] == "20260301T083005Z"


def test_signed_url_and_headers_sends_percent20(monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", KEY_ID)
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", SECRET)

    def run(p):
        url, headers = p.sigv4.signed_url_and_headers(
            "GET", "http://127.0.0.1:9/bkt", region=REGION, service="s3",
            query={"prefix": "a b"})
        return url, sorted(headers)

    assert run(PORT) == run(JAX)
    assert run(PORT)[0] == "http://127.0.0.1:9/bkt?prefix=a%20b"


def test_a_wrong_secret_is_refused_by_the_stub(s3):
    """The stub's own check refuses a signature made with another secret:
    403 ``SignatureDoesNotMatch`` as ``DaftIOError`` with ``status`` 403, in
    both packages, after the same single request."""
    def run(p):
        return p.s3.S3Client(_cfg(p, s3, access_key="not-the-secret")).get_object("bkt", "k")

    out = {}
    for p in (JAX, PORT):
        s3.take_log()
        with pytest.raises(Exception) as ei:
            run(p)
        out[p.name] = (type(ei.value).__name__, ei.value.status, s3.take_log())
    assert out["port"] == out["jax"] and out["port"][:2] == ("DaftIOError", 403)
    assert len(s3.bad_auth) == 2
    s3.bad_auth.clear()


def test_slowdown_answers_are_retried_and_counted(s3):
    """The stub answers the first GET of every second object with 503
    ``SlowDown`` and ``Retry-After: 0``: each is retried once, and the IO
    stats count one retry per injected answer, in both packages."""
    def run(p):
        c = p.s3.S3Client(_cfg(p, s3))
        for i in range(5):
            c.put_object("bkt", f"o{i}", bytes([i]) * 7)
        s3.reset_counters()
        s3.fail_first_get_every(2)
        before = p.io.io_stats().retries
        try:
            got = [c.get_object("bkt", f"o{i}") for i in range(5)]
        finally:
            s3.fail_first_get_every(0)
        return got, p.io.io_stats().retries - before, s3.counters()["injected"]

    outcome, reqs = _both(s3, run)
    got, retries, injected = outcome[1]
    assert got == [bytes([i]) * 7 for i in range(5)] and retries == injected == 3
    assert [r.status for r in reqs if r.method == "GET"].count(503) == 3


def test_listing_pages_through_continuation_tokens(s3):
    def run(p):
        c = p.s3.S3Client(_cfg(p, s3))
        for i in range(7):
            c.put_object("bkt", f"t/part-{i}.bin", b"x" * (i + 1))
        c.put_object("bkt", "t/sub/leaf.bin", b"zz")
        return ([(o.key, o.size) for o in c.list_objects("bkt", prefix="t/", page_size=3)],
                [(o.key, o.is_prefix) for o in c.list_objects("bkt", prefix="t/",
                                                              delimiter="/", page_size=3)])

    outcome, reqs = _both(s3, run)
    flat, delimited = outcome[1]
    assert flat == [(f"t/part-{i}.bin", i + 1) for i in range(7)] + [("t/sub/leaf.bin", 2)]
    # A page's common prefixes come before its objects: t/sub/ shares the last page.
    assert delimited == [(f"t/part-{i}.bin", False) for i in range(6)] + [("t/sub/", True),
                                                                          ("t/part-6.bin", False)]
    assert sum("continuation-token=" in r.query for r in reqs) == 2 + 2


def test_handler_publishes_a_write_once_and_never_on_unwind(s3):
    def run(p):
        fs = pafs.PyFileSystem(p.s3.S3FileSystemHandler(p.s3.S3Client(_cfg(p, s3))))
        with fs.open_output_stream("bkt/out/x.bin") as out:
            out.write(b"hello ")
            out.write(b"s3")
        try:
            with fs.open_output_stream("bkt/out/broken.bin") as out:
                out.write(b"partial")
                raise RuntimeError("boom")
        except Exception as e:  # noqa: BLE001 — the abort surfaces as either error
            aborted = type(e).__name__ in ("RuntimeError", "DaftIOError", "OSError")
        return (open(os.path.join(s3.root, "bkt", "out", "x.bin"), "rb").read(),
                os.path.exists(os.path.join(s3.root, "bkt", "out", "broken.bin")), aborted)

    outcome, reqs = _both(s3, run)
    assert outcome == ("ok", (b"hello s3", False, True))
    assert [r.method for r in reqs] == ["PUT"]


def test_arrow_s3_filesystem_reads_the_stub_as_the_native_client_does(s3, tmp_path, monkeypatch):
    """Without ``use_native_client``, s3:// takes Arrow's ``S3FileSystem``
    (the JAX package's ``filesystem_for``): against the same stub it reads the
    rows the native client reads, in both packages, every request signed."""
    monkeypatch.setenv("AWS_EC2_METADATA_DISABLED", "true")  # no instance metadata lookups
    data = tmp_path / "data" / "tbl"
    data.mkdir(parents=True)
    pq.write_table(pa.table({"a": list(range(20))}), data / "t.parquet")
    s3.mount("data", str(tmp_path / "data"))
    rows = {}
    for p in (JAX, PORT):
        for native in (False, True):
            io_cfg = p.cfg.IOConfig(s3=_cfg(p, s3, use_native_client=native))
            fs = p.cfg.filesystem_for("s3", io_cfg)
            assert isinstance(fs, pafs.PyFileSystem) is native
            ctx = daft_tpu_torch.execution_config_ctx(device="cpu") if p is PORT else \
                daft_tpu.execution_config_ctx()
            with ctx:
                rows[(p.name, native)] = p.pkg.read_parquet(
                    "s3://data/tbl", io_config=io_cfg).sort("a").to_pydict()
    assert len(set(map(str, rows.values()))) == 1 and rows[("port", False)]["a"] == list(range(20))
    assert not s3.bad_auth, s3.bad_auth[:1]
