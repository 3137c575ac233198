"""The port's GCS client and its credential chain (``daft_tpu_torch/io/gcs_client.py``,
``io/gcs_auth.py``) beside the JAX package's, over one GCS stub.

Mirrors ``tests/test_gcs_native.py`` case for case. The stub
(``daft_tpu_torch/tools/object_stores.py::GcsStub``) serves the JSON API over
a directory in place, with the OAuth2 token endpoint (the service-account
JWT checked with the RSA public operation, the refresh-token grant) and the
metadata server's token path. Each case runs the same steps through both
packages against the stub and holds the port to the JAX package on what came
back (or the error type raised) and on the requests the stub saw: method,
path, query, ``Range``, the body's SHA-256, the status. The service-account
key is made here in Python from a seed (no ``openssl``), in its PKCS#1 and
PKCS#8 forms. Beyond the JAX file: the JWT assertion is byte-equal between
the packages for the same key, claims and clock.
"""

import base64
import json
import os
import random
from types import SimpleNamespace

import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.io import config as jconfig
from daft_tpu.io import gcs_auth as jauth
from daft_tpu.io import gcs_client as jgcs
from daft_tpu.io import iostats as jiostats
from daft_tpu.io import retry as jretry
from daft_tpu_torch.io import config as tconfig
from daft_tpu_torch.io import gcs_auth as tauth
from daft_tpu_torch.io import gcs_client as tgcs
from daft_tpu_torch.io import iostats as tiostats
from daft_tpu_torch.io import retry as tretry
from daft_tpu_torch.tools.object_stores import GcsStub
from torch_isolation import caches_reset  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning"),
              pytest.mark.usefixtures("caches_reset")]

JAX = SimpleNamespace(name="jax", pkg=daft_tpu, cfg=jconfig, auth=jauth, gcs=jgcs,
                      io=jiostats, retry=jretry)
PORT = SimpleNamespace(name="port", pkg=daft_tpu_torch, cfg=tconfig, auth=tauth, gcs=tgcs,
                       io=tiostats, retry=tretry)


def _fast(p):
    return p.retry.RetryPolicy(max_retries=4, backoff_base_s=0.01, backoff_cap_s=0.05)


@pytest.fixture
def env(monkeypatch, tmp_path):
    """The ADC chain isolated from the host: no env credentials, no
    well-known file, no metadata probe, in both packages."""
    for var in ("GOOGLE_APPLICATION_CREDENTIALS", "GCE_METADATA_HOST", "STORAGE_EMULATOR_HOST",
                "DAFT_GCS_ENDPOINT", "DAFT_NATIVE_GCS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    for p in (JAX, PORT):
        p.auth._PROVIDER_CACHE.clear()
        monkeypatch.setattr(p.auth, "_METADATA_PROBE", False)
    yield monkeypatch
    for p in (JAX, PORT):
        p.auth._PROVIDER_CACHE.clear()


@pytest.fixture
def gcs(env, tmp_path):
    stub = GcsStub(root=str(tmp_path / "store"))
    yield stub
    stub.close()


def _cfg(p, stub, **kw):
    args = dict(endpoint_url=stub.url, token="t0")
    args.update(kw)
    return p.cfg.GCSConfig(**args)


def _client(p, cfg, **kw):
    return p.gcs.GCSClient(cfg, policy=_fast(p), **kw)


def _both(stub, run, clear=True):
    """``run(p)`` through each package against ``stub`` (cleared before each
    unless ``clear`` is False): (outcome, requests) of the port, held equal
    to the JAX package's."""
    out = {}
    for p in (JAX, PORT):
        if clear:
            stub.clear()
        stub.take_log()
        p.auth._PROVIDER_CACHE.clear()
        try:
            got = ("ok", run(p))
        except Exception as e:  # noqa: BLE001 — the outcome compared
            got = ("raised", type(e).__name__)
        out[p.name] = (got, stub.take_log())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert not stub.bad_auth, stub.bad_auth[:1]
    return out["port"]


# --------------------------------------------------------------------- #
# A service-account key made from a seed                                  #
# --------------------------------------------------------------------- #
def _probable_prime(n: int, rng: random.Random) -> bool:
    if n < 4:
        return n in (2, 3)
    for small in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % small == 0:
            return n == small
    d, r = n - 1, 0
    while d % 2 == 0:
        d, r = d // 2, r + 1
    for _ in range(24):
        x = pow(rng.randrange(2, n - 2), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def _der(tag: int, body: bytes) -> bytes:
    n = len(body)
    length = bytes([n]) if n < 0x80 else \
        bytes([0x80 | ((n.bit_length() + 7) // 8)]) + n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag]) + length + body


def _der_int(x: int) -> bytes:
    return _der(0x02, x.to_bytes(x.bit_length() // 8 + 1, "big"))


def _pem(kind: str, der: bytes) -> str:
    b64 = base64.b64encode(der).decode()
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return f"-----BEGIN {kind}-----\n" + "\n".join(lines) + f"\n-----END {kind}-----\n"


def _rsa_key(seed: int = 24, bits: int = 1024):
    """(n, e, d, PKCS#1 PEM, PKCS#8 PEM) of an RSA key drawn from ``seed``."""
    rng = random.Random(seed)
    e = 65537
    while True:
        ps = []
        while len(ps) < 2:
            c = rng.getrandbits(bits // 2) | (1 << (bits // 2 - 1)) | (1 << (bits // 2 - 2)) | 1
            if _probable_prime(c, rng):
                ps.append(c)
        p, q = ps
        phi = (p - 1) * (q - 1)
        if p != q and phi % e:
            break
    n, d = p * q, pow(e, -1, phi)
    pkcs1 = _der(0x30, b"".join(_der_int(x) for x in (
        0, n, e, d, p, q, d % (p - 1), d % (q - 1), pow(q, -1, p))))
    rsa_oid = bytes.fromhex("06092a864886f70d010101")
    pkcs8 = _der(0x30, _der_int(0) + _der(0x30, rsa_oid + b"\x05\x00") + _der(0x04, pkcs1))
    return n, e, d, _pem("RSA PRIVATE KEY", pkcs1), _pem("PRIVATE KEY", pkcs8)


KEY = _rsa_key()


def _sa_json(tmp_path, url):
    info = {"type": "service_account", "client_email": "sa@fixture.test",
            "private_key": KEY[4], "private_key_id": "kid-1", "token_uri": f"{url}/token"}
    path = tmp_path / "sa.json"
    path.write_text(json.dumps(info))
    return path, info


# --------------------------------------------------------------------- #
# Client basics                                                          #
# --------------------------------------------------------------------- #
def test_put_get_ranged_list_delete(gcs):
    def run(p):
        c = _client(p, _cfg(p, gcs))
        c.put_object("bkt", "dir/a.bin", b"0123456789abcdef")
        out = [c.get_object("bkt", "dir/a.bin"), c.get_object("bkt", "dir/a.bin", 4, 6),
               c.get_object("bkt", "dir/a.bin", start=12), c.head_object("bkt", "dir/a.bin")]
        c.put_object("bkt", "dir/b.bin", b"xy")
        out.append([(o.key, o.size) for o in c.list_objects("bkt", prefix="dir/")])
        c.delete_object("bkt", "dir/b.bin")
        out.append([o.key for o in c.list_objects("bkt", prefix="dir/")])
        return out

    outcome, reqs = _both(gcs, run)
    assert outcome[1] == [b"0123456789abcdef", b"456789", b"cdef", 16,
                          [("dir/a.bin", 16), ("dir/b.bin", 2)], ["dir/a.bin"]]
    assert [r.range for r in reqs if "alt=media" in r.query] == [None, "bytes=4-9", "bytes=12-"]


def test_key_with_slash_space_and_zero_length_get(gcs):
    key = "dir with space/a+b#c.bin"

    def run(p):
        c = _client(p, _cfg(p, gcs))
        c.put_object("bkt", key, b"payload")
        gets = gcs.media_gets
        out = [c.get_object("bkt", key), c.get_object("bkt", key, start=2, length=3)]
        out.append(c.get_object("bkt", key, start=5, length=0))  # no request (416 guard)
        return out + [gcs.media_gets - gets]

    outcome, reqs = _both(gcs, run)
    assert outcome == ("ok", [b"payload", b"ylo", b"", 2])
    assert reqs[1].path == "/storage/v1/b/bkt/o/dir%20with%20space%2Fa%2Bb%23c.bin"


def test_list_pagination_and_delimiter(gcs):
    def run(p):
        c = _client(p, _cfg(p, gcs))
        for i in range(7):
            c.put_object("bkt", f"t/part-{i}.bin", b"x" * (i + 1))
        c.put_object("bkt", "t/sub/leaf.bin", b"zz")
        gcs.page_size = 2  # force pagination
        gcs.list_calls = 0
        try:
            files = [(o.key, o.size) for o in c.list_objects("bkt", prefix="t/")
                     if not o.is_prefix]
            calls = gcs.list_calls
            got = list(c.list_objects("bkt", prefix="t/", delimiter="/"))
        finally:
            gcs.page_size = 1000
        return (files, calls, [o.key for o in got if o.is_prefix],
                [o.key for o in got if not o.is_prefix])

    outcome, _ = _both(gcs, run)
    files, calls, prefixes, direct = outcome[1]
    assert files == [(f"t/part-{i}.bin", i + 1) for i in range(7)] + [("t/sub/leaf.bin", 2)]
    assert calls >= 4 and prefixes == ["t/sub/"]
    assert direct == [f"t/part-{i}.bin" for i in range(7)]


def test_429_backoff_then_success(gcs):
    def run(p):
        c = _client(p, _cfg(p, gcs))
        c.put_object("bkt", "k", b"v" * 10)
        gcs.fail_next = [429, 503]
        before = p.io.io_stats().retries
        return c.get_object("bkt", "k"), p.io.io_stats().retries - before

    outcome, reqs = _both(gcs, run)
    assert outcome == ("ok", (b"v" * 10, 2))
    assert [r.status for r in reqs] == [200, 429, 503, 200]


def test_retries_exhausted_raises(gcs):
    def run(p):
        c = p.gcs.GCSClient(_cfg(p, gcs), policy=p.retry.RetryPolicy(max_retries=1,
                                                                     backoff_base_s=0.01))
        c.put_object("bkt", "k", b"v")
        gcs.fail_next = [429, 429, 429]
        try:
            return c.get_object("bkt", "k")
        finally:
            gcs.fail_next = []

    outcome, reqs = _both(gcs, run)
    assert outcome == ("raised", "DaftTransientError")
    assert [r.status for r in reqs] == [200, 429, 429]


def test_anonymous_requests_unsigned(gcs):
    gcs.allow_anonymous = True
    os.makedirs(os.path.join(gcs.root, "pub"))
    with open(os.path.join(gcs.root, "pub", "obj"), "wb") as f:
        f.write(b"public-bytes")

    def run(p):
        c = _client(p, p.cfg.GCSConfig(endpoint_url=gcs.url, anonymous=True))
        assert c.provider is None
        return c.get_object("pub", "obj"), c.get_object("pub", "obj", start=0, length=6)

    outcome, _ = _both(gcs, run, clear=False)
    assert outcome == ("ok", (b"public-bytes", b"public"))


def test_writer_roundtrip_resumable(gcs):
    data = bytes(range(256)) * 7  # 1792 bytes -> 4 chunks of <= 512

    def run(p):
        c = _client(p, _cfg(p, gcs), resumable_threshold=256, resumable_chunk=512)
        c.put_object("bkt", "big/obj.bin", data)
        c.put_object("bkt", "small.bin", b"tiny")  # the simple media path
        return (open(os.path.join(gcs.root, "bkt", "big", "obj.bin"), "rb").read() == data,
                c.get_object("bkt", "big/obj.bin", start=512, length=16),
                open(os.path.join(gcs.root, "bkt", "small.bin"), "rb").read())

    outcome, reqs = _both(gcs, run)
    assert outcome == ("ok", (True, data[512:528], b"tiny"))
    assert [r.status for r in reqs if r.method == "PUT"] == [308, 308, 308, 200]


# --------------------------------------------------------------------- #
# Auth chain                                                             #
# --------------------------------------------------------------------- #
def test_metadata_server_token_cache_and_refresh(env, tmp_path):
    env.setenv("GCE_METADATA_HOST", "")  # set below per stub

    def run(p):
        with GcsStub(root=str(tmp_path / p.name)) as stub:
            env.setenv("GCE_METADATA_HOST", stub.host)
            prov = p.auth.MetadataServerProvider(policy=_fast(p))
            t1 = prov.token()
            first = (t1, prov.token(), stub.metadata_count)
            stub.metadata_expires_in = 1  # below the 60 s skew: every call refreshes
            prov2 = p.auth.MetadataServerProvider(policy=_fast(p))
            return first, (prov2.token(), prov2.token()), stub.metadata_count, stub.take_log()

    assert run(PORT) == run(JAX)
    first, second, count, _ = run(PORT)
    assert first == ("mtok-1", "mtok-1", 1) and second == ("mtok-2", "mtok-3") and count == 3


def test_metadata_auth_end_to_end(gcs, env):
    env.setenv("GCE_METADATA_HOST", gcs.host)

    def run(p):
        c = _client(p, p.cfg.GCSConfig(endpoint_url=gcs.url))  # no token: ADC -> metadata
        assert isinstance(c.provider, p.auth.MetadataServerProvider)
        c.put_object("bkt", "k", b"v")
        return c.get_object("bkt", "k")

    outcome, reqs = _both(gcs, run)
    assert outcome == ("ok", b"v")
    assert reqs[0].path == GcsStub.METADATA_TOKEN_PATH


def test_service_account_jwt_exchange(gcs, tmp_path):
    """The service-account chain: the JWT, signed by the pure-Python RSA
    signer, verified by the stub with the public key, exchanged for a
    token. The PKCS#1 and PKCS#8 encodings parse to the same key."""
    n, e, d, pem1, pem8 = KEY
    for p in (JAX, PORT):
        k1, k8 = p.auth.load_rsa_private_key(pem1), p.auth.load_rsa_private_key(pem8)
        assert (k1.n, k1.e, k1.d) == (k8.n, k8.e, k8.d) == (n, e, d)
    gcs.sa_key = (n, e)
    path, _ = _sa_json(tmp_path, gcs.url)

    def run(p):
        c = _client(p, p.cfg.GCSConfig(endpoint_url=gcs.url, credentials_path=str(path)))
        c.put_object("bkt", "k", b"sa-bytes")
        return c.get_object("bkt", "k")

    outcome, reqs = _both(gcs, run)
    assert outcome == ("ok", b"sa-bytes") and reqs[0].path == "/token"
    for claims in gcs.jwt_claims:
        assert claims["iss"] == "sa@fixture.test" and claims["aud"] == f"{gcs.url}/token"
        assert claims["scope"] == tauth.GCS_SCOPE and claims["exp"] - claims["iat"] == 3600


def test_adc_env_var_and_authorized_user(gcs, tmp_path, env):
    info = {"type": "authorized_user", "client_id": "cid", "client_secret": "cs",
            "refresh_token": "rt-1", "token_uri": f"{gcs.url}/token"}
    path = tmp_path / "adc.json"
    path.write_text(json.dumps(info))
    env.setenv("GOOGLE_APPLICATION_CREDENTIALS", str(path))

    def run(p):
        c = _client(p, p.cfg.GCSConfig(endpoint_url=gcs.url))
        assert isinstance(c.provider, p.auth.AuthorizedUserProvider)
        c.put_object("bkt", "k", b"au-bytes")
        anonymous = p.auth.resolve_gcs_token_provider(p.cfg.GCSConfig(anonymous=True))
        return c.get_object("bkt", "k"), anonymous  # config-level anonymous beats env creds

    outcome, reqs = _both(gcs, run)
    assert outcome == ("ok", (b"au-bytes", None))
    assert reqs[0].method == "POST" and reqs[0].path == "/token"


def test_expired_server_side_token_is_refreshed(gcs, env):
    """A 401 (the token revoked before its local expiry) drops the cache and
    the retry fetches a new one."""
    env.setenv("GCE_METADATA_HOST", gcs.host)

    def run(p):
        c = _client(p, p.cfg.GCSConfig(endpoint_url=gcs.url))
        c.put_object("bkt", "k", b"v")
        before = gcs.metadata_count
        gcs.tokens.discard(f"mtok-{before}")  # server-side revocation
        got = c.get_object("bkt", "k")
        gcs.bad_auth.clear()
        return got, gcs.metadata_count - before

    outcome, reqs = _both(gcs, run)
    assert outcome == ("ok", (b"v", 1))
    assert [r.status for r in reqs if "alt=media" in r.query] == [401, 200]


# --------------------------------------------------------------------- #
# pyarrow handler + engine path                                          #
# --------------------------------------------------------------------- #
def test_selector_contract(gcs):
    def run(p):
        c = _client(p, _cfg(p, gcs))
        for k in ("d/x.bin", "d/y.bin", "d/sub/z.bin"):
            c.put_object("bkt", k, b"abc")
        fs = pafs.PyFileSystem(p.gcs.GcsFileSystemHandler(c))
        rec = sorted(i.path for i in fs.get_file_info(pafs.FileSelector("bkt/d", recursive=True)))
        flat = {i.path: i.type for i in fs.get_file_info(pafs.FileSelector("bkt/d"))}
        try:
            fs.get_file_info(pafs.FileSelector("bkt/nope", recursive=True))
            missing = None
        except FileNotFoundError:
            missing = "FileNotFoundError"
        allowed = fs.get_file_info(pafs.FileSelector("bkt/nope", recursive=True,
                                                     allow_not_found=True))
        c.put_object("bkt", "emptydir/", b"")  # a marker: the directory exists, empty
        empty = fs.get_file_info(pafs.FileSelector("bkt/emptydir", recursive=True))
        return (rec, flat, missing, allowed, empty, fs.get_file_info("bkt").type,
                fs.get_file_info("emptybkt").type)

    outcome, _ = _both(gcs, run)
    assert outcome[1] == (["bkt/d/sub/z.bin", "bkt/d/x.bin", "bkt/d/y.bin"],
                          {"bkt/d/sub": pafs.FileType.Directory,
                           "bkt/d/x.bin": pafs.FileType.File,
                           "bkt/d/y.bin": pafs.FileType.File},
                          "FileNotFoundError", [], [], pafs.FileType.Directory,
                          pafs.FileType.NotFound)


def _parquet_bucket(stub, bucket, rows):
    d = os.path.join(stub.root, bucket, "tbl")
    os.makedirs(d)
    pq.write_table(pa.table({"a": rows, "b": ["v"] * len(rows)}), os.path.join(d, "t.parquet"))


def _run_query(p, build):
    ctx = daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False) \
        if p is PORT else daft_tpu.execution_config_ctx(result_cache_enabled=False)
    with ctx:
        return build().to_pydict()


def test_engine_reads_parquet_native_by_default(gcs):
    """read_parquet over gs:// takes the native client with no opt-in."""
    _parquet_bucket(gcs, "data", list(range(50)))

    def run(p):
        io_cfg = p.cfg.IOConfig(gcs=_cfg(p, gcs))
        return _run_query(p, lambda: p.pkg.read_parquet("gs://data/tbl", io_config=io_cfg)
                          .where(p.pkg.col("a") >= 45).sort("a"))

    outcome, reqs = _both(gcs, run, clear=False)
    assert outcome[1]["a"] == [45, 46, 47, 48, 49]
    assert any(r.range for r in reqs)


def test_engine_reads_native_without_io_config(gcs, env):
    """With no io_config at all, gs:// resolves to the native client (the
    endpoint from DAFT_GCS_ENDPOINT, auth through the ADC chain: anonymous
    here)."""
    gcs.allow_anonymous = True
    env.setenv("DAFT_GCS_ENDPOINT", gcs.url)
    _parquet_bucket(gcs, "nocfg", [1, 2, 3])

    def run(p):
        return _run_query(p, lambda: p.pkg.read_parquet("gs://nocfg/tbl").sort("a"))["a"]

    outcome, _ = _both(gcs, run, clear=False)
    assert outcome == ("ok", [1, 2, 3])


def test_native_escape_hatch(gcs, env):
    """``DAFT_NATIVE_GCS=0`` and ``use_native_client=False`` take Arrow's
    ``GcsFileSystem``, in both packages."""
    def run(p):
        fs = p.cfg.filesystem_for("gs", p.cfg.IOConfig(gcs=_cfg(p, gcs)))
        env.setenv("DAFT_NATIVE_GCS", "0")
        fs2 = p.cfg.filesystem_for("gs", p.cfg.IOConfig(gcs=p.cfg.GCSConfig(anonymous=True)))
        env.delenv("DAFT_NATIVE_GCS")
        fs3 = p.cfg.filesystem_for("gs", p.cfg.IOConfig(
            gcs=p.cfg.GCSConfig(anonymous=True, use_native_client=False)))
        return fs.type_name, type(fs2).__name__, type(fs3).__name__

    assert run(PORT) == run(JAX) == ("py::daft-gcs", "GcsFileSystem", "GcsFileSystem")


def test_writer_path_through_handler(gcs):
    """``open_output_stream`` publishes on a clean close and never on unwind."""
    def run(p):
        fs = pafs.PyFileSystem(p.gcs.GcsFileSystemHandler(_client(p, _cfg(p, gcs))))
        with fs.open_output_stream("bkt/out/x.bin") as out:
            out.write(b"hello ")
            out.write(b"gcs")
        try:
            with fs.open_output_stream("bkt/out/broken.bin") as out:
                out.write(b"partial")
                raise RuntimeError("boom")
        except Exception:  # noqa: BLE001 — the abort surfaces as either error
            pass
        return (open(os.path.join(gcs.root, "bkt", "out", "x.bin"), "rb").read(),
                os.path.exists(os.path.join(gcs.root, "bkt", "out", "broken.bin")))

    outcome, reqs = _both(gcs, run)
    assert outcome == ("ok", (b"hello gcs", False)) and [r.method for r in reqs] == ["POST"]


# --------------------------------------------------------------------- #
# Beyond the JAX file                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("pem", ["pkcs1", "pkcs8"])
def test_service_account_jwt_is_byte_equal(pem):
    """The same key, claims and clock give the same assertion, byte for
    byte, and its signature checks with the public key."""
    n, e, _, pem1, pem8 = KEY
    info = {"client_email": "sa@fixture.test", "private_key": pem1 if pem == "pkcs1" else pem8,
            "private_key_id": "kid-1", "token_uri": "http://127.0.0.1:9/token"}
    port = tauth.make_signed_jwt(info, now=1_750_000_000.0)
    assert port == jauth.make_signed_jwt(info, now=1_750_000_000.0)
    with GcsStub() as stub:
        stub.sa_key = (n, e)
        ok, claims = stub.verify_jwt(port)
    assert ok and claims == {"iss": "sa@fixture.test", "scope": tauth.GCS_SCOPE,
                             "aud": "http://127.0.0.1:9/token", "iat": 1_750_000_000,
                             "exp": 1_750_003_600}
