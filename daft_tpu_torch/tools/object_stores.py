"""In-process object-store stubs: S3, GCS and plain HTTP on ``127.0.0.1``.

Each stub serves a local directory in place (an object is a file under the
bucket's directory; nothing is copied into memory), counts the requests and
bytes it served, keeps a log of what it saw on the wire (method, path, query,
``Range``, the body's SHA-256, the status), and can answer with 503 / 429 and
a ``Retry-After`` on a schedule. Each binds ``127.0.0.1:0``; ``close()`` shuts
the server down, breaks its open connections and joins every thread it
started.

- :class:`S3Stub` is path-style (``/{bucket}/{key}``): ranged GET, HEAD, PUT,
  DELETE and ListObjectsV2 with ``prefix`` / ``delimiter`` / ``max-keys`` and
  continuation. It verifies every request's AWS Signature Version 4 with its
  own ``hmac`` / ``hashlib`` code and answers ``403 SignatureDoesNotMatch``
  where the signature is wrong.
- :class:`GcsStub` serves the JSON API (``/storage/v1/b/{bucket}/o``: ranged
  ``alt=media`` GET, metadata, paginated list with ``delimiter``, media and
  resumable upload, DELETE), the OAuth2 token endpoint (``/token``: the
  service-account JWT, checked with the RSA public operation, and the
  refresh-token grant) and the GCE metadata server's token path.
- :class:`HttpStub` serves a directory over GET and HEAD, with or without
  ``Range``, plus fixed bodies at given paths (a Hugging Face dataset-viewer
  listing, for one). ``tls=True`` serves it as ``https://127.0.0.1``, with
  the self-signed certificate ``loopback_tls/cert.pem`` (for ``127.0.0.1``
  and ``localhost``) and its key beside it; a client trusts it through
  ``SSL_CERT_FILE=`` :data:`LOOPBACK_CERT`, and needs no network to check
  it. They were made with ``openssl req -x509 -newkey rsa:2048 -nodes
  -sha256 -days 36500 -subj "/CN=daft_tpu_torch loopback stub" -addext
  "subjectAltName=IP:127.0.0.1,DNS:localhost" -addext
  "basicConstraints=critical,CA:TRUE" -addext
  "keyUsage=critical,digitalSignature,keyEncipherment,keyCertSign" -addext
  "extendedKeyUsage=serverAuth"``; the key guards nothing but this loopback
  stub.

:class:`ChildStub` serves any of the three from a child Python process, so
that the requests it answers take no share of the caller's interpreter lock;
its attributes and methods reach the stub over a pipe.

The stubs import nothing of either engine package: the tests hold both
packages against one stub, and ``chip_smoke.py`` serves the card's files
through them.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import io
import json
import os
import pickle
import re
import shutil
import socket
import ssl
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, NamedTuple, Optional, Tuple
from urllib.parse import quote, unquote, urlsplit
from xml.sax.saxutils import escape

_CHUNK = 1 << 20
_TLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loopback_tls")
#: The loopback stubs' self-signed certificate: point ``SSL_CERT_FILE`` here.
LOOPBACK_CERT = os.path.join(_TLS_DIR, "cert.pem")
_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


class Request(NamedTuple):
    """One request as the stub saw it on the wire."""

    method: str
    path: str
    query: str
    range: Optional[str]
    body_sha256: Optional[str]
    status: int


class _Server(ThreadingHTTPServer):
    """A threading server that tracks its connections so ``close`` can break
    kept-alive ones and join every handler thread."""

    daemon_threads = False
    block_on_close = True
    # socketserver's default backlog of 5 drops the SYNs of a burst of
    # connections (the client resends after a second): a pool of 32
    # downloads connects at once.
    request_queue_size = 1024

    def __init__(self, handler, tls: bool = False):
        super().__init__(("127.0.0.1", 0), handler)
        self.conns: set = set()
        self.conns_lock = threading.Lock()
        self.tls_context = None
        if tls:
            self.tls_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self.tls_context.load_cert_chain(LOOPBACK_CERT, os.path.join(_TLS_DIR, "key.pem"))

    def get_request(self):
        sock, addr = super().get_request()
        if self.tls_context is not None:
            # The handshake runs on the connection's own thread, at its first
            # read, so a slow or failing client holds up no other.
            sock = self.tls_context.wrap_socket(sock, server_side=True,
                                                do_handshake_on_connect=False)
        return sock, addr

    def handle_error(self, request, client_address):
        # A client that refuses the certificate or hangs up is its own
        # outcome, not the stub's fault.
        if not isinstance(sys.exc_info()[1], (ssl.SSLError, ConnectionError)):
            super().handle_error(request, client_address)

    def process_request(self, request, client_address):
        with self.conns_lock:
            self.conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self.conns_lock:
            self.conns.discard(request)
        super().shutdown_request(request)


def _unchunk(stream) -> bytes:
    """The payload of a chunked body read from ``stream``: ``<hex size>[;ext]``
    CRLF, the bytes, CRLF, until a chunk of size 0 and its trailer lines (as
    both HTTP/1.1's chunked transfer coding and S3's aws-chunked encoding
    frame a body)."""
    out = []
    while True:
        size = int(stream.readline().split(b";")[0].strip() or b"0", 16)
        if size == 0:
            while stream.readline().strip():
                pass
            return b"".join(out)
        out.append(stream.read(size))
        stream.readline()


def _split_query(raw: str) -> List[Tuple[str, str]]:
    """Strict RFC 3986 decoding: ``+`` stays a plus, as on strict S3- and
    GCS-compatible endpoints."""
    out = []
    for part in raw.split("&") if raw else []:
        k, _, v = part.partition("=")
        out.append((unquote(k), unquote(v)))
    return out


class _Stub:
    """The server, the log, the counters and the fault schedule that the three
    stubs share."""

    name = "stub"

    def __init__(self, root: Optional[str] = None, tls: bool = False):
        self.tls = tls
        self._own_root = root is None
        self.root = root if root is not None else tempfile.mkdtemp(prefix=f"{self.name}-")
        self.lock = threading.Lock()
        self.log: List[Request] = []
        self.requests = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.injected = 0
        self.fail_all: Optional[int] = None
        self.fail_next: List[int] = []
        self.retry_after = "0"
        self._fail_every = 0
        self._fail_status = 503
        self._first_gets: set = set()
        self._server = _Server(self._handler_class(), tls)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name=f"{self.name}-serve", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://127.0.0.1:{self._server.server_address[1]}"

    @property
    def host(self) -> str:
        return f"127.0.0.1:{self._server.server_address[1]}"

    def close(self) -> None:
        """Stop serving, break open connections and join every thread."""
        self._server.shutdown()
        with self._server.conns_lock:
            conns = list(self._server.conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._server.server_close()
        self._thread.join()
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ #
    def take_log(self) -> List[Request]:
        """The requests seen since the last call, in arrival order; clears
        the log and the per-run sequences (upload ids)."""
        with self.lock:
            out, self.log = self.log, []
            self._reset_sequences()
        return out

    def _reset_sequences(self) -> None:
        pass

    def reset_counters(self) -> None:
        with self.lock:
            self.requests = self.bytes_out = self.bytes_in = self.injected = 0
            self._first_gets = set()

    def counters(self) -> dict:
        with self.lock:
            return {"requests": self.requests, "bytes_out": self.bytes_out,
                    "bytes_in": self.bytes_in, "injected": self.injected}

    def fail_first_get_every(self, n: int, status: int = 503, retry_after: str = "0") -> None:
        """Answer the first GET of the 1st, (n+1)th, (2n+1)th ... object to be
        fetched with ``status`` and ``Retry-After``; 0 turns it off."""
        with self.lock:
            self._fail_every = n
            self._fail_status = status
            self.retry_after = retry_after
            self._first_gets = set()

    def _fault(self, method: str, obj: Optional[Tuple[str, str]]) -> Optional[int]:
        """The status to inject for this request, if any (counted)."""
        with self.lock:
            if self.fail_all is not None:
                self.injected += 1
                return self.fail_all
            if obj is None or method != "GET":
                return None
            if self.fail_next:
                self.injected += 1
                return self.fail_next.pop(0)
            if self._fail_every and obj not in self._first_gets:
                self._first_gets.add(obj)
                if len(self._first_gets) % self._fail_every == 1 or self._fail_every == 1:
                    self.injected += 1
                    return self._fail_status
        return None

    def _record(self, req: Request, sent: int, received: int) -> None:
        with self.lock:
            self.log.append(req)
            self.requests += 1
            self.bytes_out += sent
            self.bytes_in += received

    def _handler_class(self):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # Objects as files under a directory                                   #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _safe_join(base: str, key: str) -> str:
        parts = [p for p in key.split("/") if p]
        if any(p in (".", "..") for p in parts):
            raise ValueError(f"unsafe key {key!r}")
        return os.path.join(base, *parts)

    @staticmethod
    def _walk_keys(base: str) -> Dict[str, int]:
        """Every file under ``base`` as key -> size."""
        out = {}
        for dirpath, _, files in os.walk(base):
            rel = os.path.relpath(dirpath, base)
            for f in files:
                key = f if rel == "." else f"{rel.replace(os.sep, '/')}/{f}"
                out[key] = os.path.getsize(os.path.join(dirpath, f))
        return out


class _Handler(BaseHTTPRequestHandler):
    """Shared plumbing: every response has a Content-Length (keep-alive),
    bodies stream from disk, each request lands in the stub's log."""

    protocol_version = "HTTP/1.1"
    timeout = 60
    disable_nagle_algorithm = True  # a body's last segment must not wait on the client's ACK
    stub: _Stub = None  # set per stub class

    def log_message(self, *a):
        pass

    def _begin(self):
        u = urlsplit(self.path)
        self._raw_path, self._raw_query = u.path, u.query
        self._sent = 0
        self._received = 0
        self._body_sha = None

    def _read_body(self) -> bytes:
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            body = _unchunk(self.rfile)
        else:
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
        self._received = len(body)
        if "aws-chunked" in (self.headers.get("Content-Encoding") or ""):
            # The AWS SDK's streaming upload: the payload in chunks of its
            # own (each with its signature or none), a checksum trailer last.
            body = _unchunk(io.BytesIO(body))
        if self.command in ("PUT", "POST"):
            self._body_sha = hashlib.sha256(body).hexdigest()
        return body

    def _finish(self, status: int):
        self.stub._record(Request(self.command, self._raw_path, self._raw_query,
                                  self.headers.get("Range"), self._body_sha, status),
                          self._sent, self._received)

    def _send(self, status: int, body: bytes = b"", headers: Optional[dict] = None):
        # Logged before the body goes out: a client that has its answer
        # finds its request in the log.
        sending = body if self.command != "HEAD" else b""
        self._sent += len(sending)
        self._finish(status)
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if sending:
            self.wfile.write(sending)

    def _send_file(self, path: str, rng: Optional[str], honour_range: bool = True,
                   headers: Optional[dict] = None):
        """200 with the whole file, or 206 with the range asked for; the
        bytes stream from disk. An unsatisfiable range answers 416."""
        size = os.path.getsize(path)
        start, end, status = 0, size - 1, 200
        if rng and honour_range and rng.startswith("bytes="):
            spec = rng[len("bytes="):].split(",")[0]
            a, _, b = spec.partition("-")
            if a:
                start = int(a)
                end = min(int(b), size - 1) if b else size - 1
            else:  # suffix range: the last N bytes
                start, end = max(size - int(b), 0), size - 1
            if start >= size or start > end:
                return self._send(416, b"", {"Content-Range": f"bytes */{size}"})
            status = 206
        n = end - start + 1
        if self.command != "HEAD":
            self._sent += n
        self._finish(status)
        self.send_response(status)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        if status == 206:
            self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
        self.send_header("Content-Length", str(n))
        self.send_header("Accept-Ranges", "bytes" if honour_range else "none")
        self.end_headers()
        if self.command != "HEAD":
            with open(path, "rb") as f:
                f.seek(start)
                left = n
                while left:
                    buf = f.read(min(_CHUNK, left))
                    if not buf:
                        break
                    self.wfile.write(buf)
                    left -= len(buf)


# --------------------------------------------------------------------- #
# S3                                                                     #
# --------------------------------------------------------------------- #
def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_expected(method: str, raw_path: str, raw_query: str, headers, secret: str,
                   region: str, service: str = "s3") -> Tuple[str, str]:
    """The Authorization header AWS would expect for this received request,
    recomputed from the wire: (expected, reason it cannot be computed or '')."""
    auth = headers.get("Authorization", "")
    if not auth.startswith("AWS4-HMAC-SHA256 "):
        return "", "no AWS4-HMAC-SHA256 Authorization header"
    fields = dict(part.strip().split("=", 1) for part in
                  auth[len("AWS4-HMAC-SHA256 "):].split(","))
    key_id, datestamp, reg, svc, _ = fields["Credential"].split("/")
    signed = fields["SignedHeaders"].split(";")
    amz_date = headers.get("x-amz-date", "")
    if not amz_date.startswith(datestamp):
        return "", f"x-amz-date {amz_date!r} outside the credential's day {datestamp}"
    canonical_headers = ""
    for name in signed:
        value = headers.get(name)
        if value is None:
            return "", f"signed header {name!r} missing"
        canonical_headers += f"{name}:{' '.join(value.strip().split())}\n"
    pairs = sorted((quote(k, safe="-_.~"), quote(v, safe="-_.~"))
                   for k, v in _split_query(raw_query))
    canonical_query = "&".join(f"{k}={v}" for k, v in pairs)
    payload_hash = headers.get("x-amz-content-sha256") or _EMPTY_SHA256
    # S3 signs the path as sent (single encoding).
    canonical = "\n".join([method, raw_path or "/", canonical_query, canonical_headers,
                           ";".join(signed), payload_hash])
    scope = f"{datestamp}/{reg}/{svc}/aws4_request"
    to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
    k = _hmac(("AWS4" + secret).encode(), datestamp)
    for part in (region, service, "aws4_request"):
        k = _hmac(k, part)
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    return (f"AWS4-HMAC-SHA256 Credential={key_id}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}"), ""


def _s3_error(code: str, message: str) -> bytes:
    return (f"<?xml version=\"1.0\" encoding=\"UTF-8\"?><Error><Code>{code}</Code>"
            f"<Message>{escape(message)}</Message></Error>").encode()


_S3_NS = "http://s3.amazonaws.com/doc/2006-03-01/"


class _BucketStub(_Stub):
    """Buckets as directories: a mounted directory, else ``root/<bucket>``;
    a key ending in ``/`` written with no body is a directory marker."""

    def __init__(self, root: Optional[str] = None):
        self.buckets: Dict[str, str] = {}
        self.markers: set = set()
        self.bad_auth: List[Tuple[str, str]] = []
        super().__init__(root)

    def mount(self, bucket: str, directory: str) -> None:
        """Serve ``directory`` in place as ``bucket``."""
        self.buckets[bucket] = os.path.abspath(directory)

    def bucket_dir(self, bucket: str, create: bool = False) -> Optional[str]:
        d = self.buckets.get(bucket)
        if d is None:
            d = os.path.join(self.root, bucket)
            if create:
                os.makedirs(d, exist_ok=True)
                self.buckets[bucket] = d
            elif not os.path.isdir(d):
                return None
        return d

    def keys(self, bucket: str) -> Dict[str, int]:
        """Every object of ``bucket`` as key -> size, markers included."""
        d = self.bucket_dir(bucket)
        out = self._walk_keys(d) if d else {}
        for b, k in self.markers:
            if b == bucket:
                out[k] = 0
        return out

    def clear(self) -> None:
        """Drop every object the stub holds under its own root (mounted
        directories stay as they are) and every directory marker."""
        with self.lock:
            for name in os.listdir(self.root) if self._own_root else []:
                path = os.path.join(self.root, name)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
            self.markers.clear()
            self.buckets = {b: d for b, d in self.buckets.items()
                            if not d.startswith(self.root + os.sep)}


class S3Stub(_BucketStub):
    """A path-style S3 endpoint over local directories, one per bucket, that
    verifies each request's sigv4 signature (``key_id`` / ``secret`` in
    ``region``). ``anonymous=True`` takes unsigned requests too. Besides the
    single PUT it takes a multipart upload (create, parts, complete, abort),
    as Arrow's ``S3FileSystem`` writes every object; the parts wait in
    memory until the upload completes."""

    name = "s3-stub"

    def __init__(self, key_id: str = "AKIDSTUB", secret: str = "stub-secret",
                 region: str = "us-east-1", root: Optional[str] = None,
                 anonymous: bool = False):
        self.key_id, self.secret, self.region = key_id, secret, region
        self.anonymous = anonymous
        self.uploads: Dict[str, Tuple[str, str, Dict[int, bytes]]] = {}
        super().__init__(root)

    def _handler_class(self):
        stub = self

        class H(_Handler):
            def _auth_ok(self) -> bool:
                if "Authorization" not in self.headers and stub.anonymous:
                    return True
                want, why = sigv4_expected(self.command, self._raw_path, self._raw_query,
                                           self.headers, stub.secret, stub.region)
                got = self.headers.get("Authorization", "")
                if want and hmac.compare_digest(want, got) \
                        and f"Credential={stub.key_id}/" in got:
                    return True
                with stub.lock:
                    stub.bad_auth.append((got, want or why))
                self._send(403, _s3_error("SignatureDoesNotMatch", why or "signature mismatch"),
                           {"Content-Type": "application/xml"})
                return False

            def _bucket_key(self):
                parts = self._raw_path.lstrip("/").split("/", 1)
                return unquote(parts[0]), unquote(parts[1]) if len(parts) > 1 else ""

            def _dispatch(self):
                self._begin()
                body = self._read_body() if self.command in ("PUT", "POST") else b""
                if not self._auth_ok():
                    return
                bucket, key = self._bucket_key()
                fault = stub._fault(self.command, (bucket, key) if key else None)
                if fault is not None:
                    code = "SlowDown" if fault == 503 else "TooManyRequests"
                    return self._send(fault, _s3_error(code, "injected"),
                                      {"Retry-After": stub.retry_after,
                                       "Content-Type": "application/xml"})
                declared = self.headers.get("x-amz-content-sha256")
                if self.command == "PUT" and declared and not declared.startswith(
                        ("UNSIGNED", "STREAMING")) \
                        and declared != hashlib.sha256(body).hexdigest():
                    return self._send(400, _s3_error("XAmzContentSHA256Mismatch", key))
                try:
                    getattr(self, f"_s3_{self.command.lower()}")(bucket, key, body)
                except ValueError as e:
                    self._send(400, _s3_error("InvalidArgument", str(e)))

            do_GET = do_HEAD = do_PUT = do_DELETE = do_POST = _dispatch

            def _path(self, bucket, key):
                d = stub.bucket_dir(bucket)
                return None if d is None else stub._safe_join(d, key)

            def _s3_head(self, bucket, key, body):
                if not key:
                    return self._send(200 if stub.bucket_dir(bucket) else 404)
                p = self._path(bucket, key)
                if (bucket, key) in stub.markers:
                    return self._send(200, b"", {"Content-Type": "application/x-directory"})
                if p is None or not os.path.isfile(p):
                    return self._send(404)
                self._send_file(p, None, headers=self._object_headers(p))

            @staticmethod
            def _object_headers(p):
                st = os.stat(p)
                return {"Last-Modified": time.strftime("%a, %d %b %Y %H:%M:%S GMT",
                                                       time.gmtime(st.st_mtime)),
                        "ETag": f"\"{st.st_size:x}-{st.st_mtime_ns:x}\"",
                        "Content-Type": "binary/octet-stream"}

            def _s3_get(self, bucket, key, body):
                if not key:
                    return self._list(bucket)
                p = self._path(bucket, key)
                if (bucket, key) in stub.markers:
                    return self._send(200, b"")
                if p is None or not os.path.isfile(p):
                    return self._send(404, _s3_error("NoSuchKey", key),
                                      {"Content-Type": "application/xml"})
                self._send_file(p, self.headers.get("Range"), headers=self._object_headers(p))

            def _list(self, bucket):
                if stub.bucket_dir(bucket) is None:
                    return self._send(404, _s3_error("NoSuchBucket", bucket),
                                      {"Content-Type": "application/xml"})
                q = dict(_split_query(self._raw_query))
                prefix, delimiter = q.get("prefix", ""), q.get("delimiter", "")
                max_keys = int(q.get("max-keys") or 1000)
                after = q.get("continuation-token") or q.get("start-after") or ""
                if q.get("continuation-token"):
                    after = base64.urlsafe_b64decode(after.encode()).decode()
                entries = []  # (sort key, is_prefix, key, size)
                seen = set()
                for k, size in sorted(stub.keys(bucket).items()):
                    if not k.startswith(prefix):
                        continue
                    rest = k[len(prefix):]
                    if delimiter and delimiter in rest:
                        p = prefix + rest.split(delimiter)[0] + delimiter
                        if p not in seen:
                            seen.add(p)
                            entries.append((p, True, p, 0))
                    else:
                        entries.append((k, False, k, size))
                entries.sort()
                entries = [e for e in entries if e[0] > after]
                page, rest = entries[:max_keys], entries[max_keys:]
                parts = [f"<?xml version=\"1.0\" encoding=\"UTF-8\"?>"
                         f"<ListBucketResult xmlns=\"{_S3_NS}\"><Name>{escape(bucket)}</Name>"
                         f"<Prefix>{escape(prefix)}</Prefix><KeyCount>{len(page)}</KeyCount>"
                         f"<MaxKeys>{max_keys}</MaxKeys>"]
                if delimiter:
                    parts.append(f"<Delimiter>{escape(delimiter)}</Delimiter>")
                parts.append(f"<IsTruncated>{'true' if rest else 'false'}</IsTruncated>")
                if rest:
                    token = base64.urlsafe_b64encode(page[-1][0].encode()).decode()
                    parts.append(f"<NextContinuationToken>{token}</NextContinuationToken>")
                stamp = datetime.datetime.now(datetime.timezone.utc).strftime(
                    "%Y-%m-%dT%H:%M:%S.000Z")
                for _, is_prefix, k, size in page:
                    if is_prefix:
                        parts.append(f"<CommonPrefixes><Prefix>{escape(k)}</Prefix>"
                                     f"</CommonPrefixes>")
                    else:
                        parts.append(f"<Contents><Key>{escape(k)}</Key><LastModified>{stamp}"
                                     f"</LastModified><ETag>\"{size:x}\"</ETag><Size>{size}"
                                     f"</Size><StorageClass>STANDARD</StorageClass></Contents>")
                parts.append("</ListBucketResult>")
                self._send(200, "".join(parts).encode(), {"Content-Type": "application/xml"})

            def _s3_put(self, bucket, key, body):
                q = dict(_split_query(self._raw_query))
                if "uploadId" in q:  # one part of a multipart upload
                    with stub.lock:
                        upload = stub.uploads.get(q["uploadId"])
                        if upload is not None:
                            upload[2][int(q["partNumber"])] = body
                    if upload is None:
                        return self._send(404, _s3_error("NoSuchUpload", q["uploadId"]))
                    return self._send(200, b"", {"ETag": f"\"{hashlib.md5(body).hexdigest()}\""})
                self._store(bucket, key, body)

            def _s3_post(self, bucket, key, body):
                q = dict(_split_query(self._raw_query))
                if "uploads" in q:
                    upload_id = uuid.uuid4().hex
                    with stub.lock:
                        stub.uploads[upload_id] = (bucket, key, {})
                    return self._send(200, (
                        f"<?xml version=\"1.0\" encoding=\"UTF-8\"?><InitiateMultipartUploadResult "
                        f"xmlns=\"{_S3_NS}\"><Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}"
                        f"</Key><UploadId>{upload_id}</UploadId></InitiateMultipartUploadResult>"
                    ).encode(), {"Content-Type": "application/xml"})
                if "uploadId" not in q:
                    return self._send(400, _s3_error("InvalidRequest", "POST"))
                with stub.lock:
                    upload = stub.uploads.pop(q["uploadId"], None)
                if upload is None:
                    return self._send(404, _s3_error("NoSuchUpload", q["uploadId"]))
                numbers = [int(n) for n in re.findall(rb"<PartNumber>(\d+)</PartNumber>", body)]
                data = b"".join(upload[2][n] for n in numbers)
                self._store(bucket, key, data, respond=False)
                self._send(200, (
                    f"<?xml version=\"1.0\" encoding=\"UTF-8\"?><CompleteMultipartUploadResult "
                    f"xmlns=\"{_S3_NS}\"><Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
                    f"<ETag>\"{hashlib.md5(data).hexdigest()}-{len(numbers)}\"</ETag>"
                    f"</CompleteMultipartUploadResult>").encode(),
                    {"Content-Type": "application/xml"})

            def _store(self, bucket, key, body, respond=True):
                d = stub.bucket_dir(bucket, create=True)
                if key.endswith("/"):
                    with stub.lock:
                        stub.markers.add((bucket, key))
                    os.makedirs(stub._safe_join(d, key), exist_ok=True)
                    return self._send(200, b"", {"ETag": "\"0\""})
                p = stub._safe_join(d, key)
                os.makedirs(os.path.dirname(p), exist_ok=True)
                tmp = f"{p}.{threading.get_ident()}.part"
                with open(tmp, "wb") as f:
                    f.write(body)
                os.replace(tmp, p)
                if respond:
                    self._send(200, b"", {"ETag": f"\"{hashlib.md5(body).hexdigest()}\""})

            def _s3_delete(self, bucket, key, body):
                upload_id = dict(_split_query(self._raw_query)).get("uploadId")
                if upload_id is not None:  # abort a multipart upload
                    with stub.lock:
                        stub.uploads.pop(upload_id, None)
                    return self._send(204)
                with stub.lock:
                    stub.markers.discard((bucket, key))
                p = self._path(bucket, key)
                if p is not None and os.path.isfile(p):
                    os.remove(p)
                self._send(204)

        H.stub = stub
        return H


# --------------------------------------------------------------------- #
# GCS                                                                    #
# --------------------------------------------------------------------- #
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


class GcsStub(_BucketStub):
    """The GCS JSON API over local directories (one per bucket), with the
    OAuth2 token endpoint and the metadata server's token path on the same
    port. Bearer tokens in ``tokens`` are accepted; ``allow_anonymous``
    takes requests with none."""

    name = "gcs-stub"
    METADATA_TOKEN_PATH = "/computeMetadata/v1/instance/service-accounts/default/token"

    def __init__(self, root: Optional[str] = None, tokens=("t0",),
                 allow_anonymous: bool = False):
        self.tokens = set(tokens)
        self.allow_anonymous = allow_anonymous
        self.page_size = 1000
        self.metadata_count = 0
        self.metadata_expires_in = 3600
        self.token_count = 0
        self.sa_key: Optional[Tuple[int, int]] = None  # (n, e) of the service account
        self.refresh_tokens = {"rt-1"}
        self.jwt_claims: List[dict] = []
        self.uploads: Dict[str, dict] = {}
        self.list_calls = 0
        self.media_gets = 0
        self._upload_seq = 0
        super().__init__(root)

    def _reset_sequences(self) -> None:
        self._upload_seq = 0

    def verify_jwt(self, assertion: str) -> Tuple[bool, dict]:
        """RS256 check with the public (n, e): EMSA-PKCS1-v1_5 over SHA-256."""
        signing, _, sig_b64 = assertion.rpartition(".")
        n, e = self.sa_key
        k = (n.bit_length() + 7) // 8
        sig = base64.urlsafe_b64decode(sig_b64 + "=" * (-len(sig_b64) % 4))
        em = pow(int.from_bytes(sig, "big"), e, n).to_bytes(k, "big")
        digest_info = _SHA256_DIGEST_INFO + hashlib.sha256(signing.encode()).digest()
        ok = em[:2] == b"\x00\x01" and em.endswith(b"\x00" + digest_info)
        payload = signing.split(".")[1]
        claims = json.loads(base64.urlsafe_b64decode(payload + "=" * (-len(payload) % 4)))
        with self.lock:
            self.jwt_claims.append(claims)
        return ok, claims

    def _handler_class(self):
        stub = self

        class H(_Handler):
            def _json(self, status, doc, headers=None):
                self._send(status, json.dumps(doc).encode(),
                           {"Content-Type": "application/json", **(headers or {})})

            def _authorized(self) -> bool:
                auth = self.headers.get("Authorization")
                if auth is None:
                    if stub.allow_anonymous:
                        return True
                    with stub.lock:
                        stub.bad_auth.append(("missing", self._raw_path))
                    self._send(401)
                    return False
                if auth.startswith("Bearer ") and auth[len("Bearer "):] in stub.tokens:
                    return True
                with stub.lock:
                    stub.bad_auth.append((auth, self._raw_path))
                self._send(401)
                return False

            # token endpoints
            def _metadata_token(self):
                if self.headers.get("Metadata-Flavor") != "Google":
                    return self._send(403)
                with stub.lock:
                    stub.metadata_count += 1
                    tok = f"mtok-{stub.metadata_count}"
                    stub.tokens.add(tok)
                self._json(200, {"access_token": tok, "expires_in": stub.metadata_expires_in,
                                 "token_type": "Bearer"})

            def _oauth_token(self, form):
                grant = form.get("grant_type", "")
                if grant == "urn:ietf:params:oauth:grant-type:jwt-bearer":
                    if stub.sa_key is None or not stub.verify_jwt(form["assertion"])[0]:
                        return self._json(400, {"error": "invalid_grant"})
                elif grant == "refresh_token":
                    if form.get("refresh_token") not in stub.refresh_tokens:
                        return self._json(400, {"error": "invalid_grant"})
                else:
                    return self._json(400, {"error": "unsupported_grant_type"})
                with stub.lock:
                    stub.token_count += 1
                    tok = f"xtok-{stub.token_count}"
                    stub.tokens.add(tok)
                self._json(200, {"access_token": tok, "expires_in": 3600,
                                 "token_type": "Bearer"})

            def _path(self, bucket, key):
                d = stub.bucket_dir(bucket)
                return None if d is None else stub._safe_join(d, key)

            def _list(self, bucket, q):
                with stub.lock:
                    stub.list_calls += 1
                prefix, delimiter = q.get("prefix", ""), q.get("delimiter", "")
                max_results = int(q.get("maxResults") or stub.page_size)
                items, prefixes = [], []
                for k, size in sorted(stub.keys(bucket).items()):
                    if not k.startswith(prefix):
                        continue
                    rest = k[len(prefix):]
                    if delimiter and delimiter in rest:
                        p = prefix + rest.split(delimiter)[0] + delimiter
                        if p not in prefixes:
                            prefixes.append(p)
                    else:
                        items.append((k, size))
                start = int(q.get("pageToken") or 0)
                page = items[start:start + max_results]
                doc = {"kind": "storage#objects",
                       "items": [{"name": k, "bucket": bucket, "size": str(s)} for k, s in page]}
                if start == 0 and prefixes:
                    doc["prefixes"] = prefixes
                if start + max_results < len(items):
                    doc["nextPageToken"] = str(start + max_results)
                self._json(200, doc)

            def do_GET(self):
                self._begin()
                if self._raw_path.startswith("/computeMetadata/"):
                    if self._raw_path != stub.METADATA_TOKEN_PATH:
                        return self._send(404)
                    return self._metadata_token()
                if not self._authorized():
                    return
                q = dict(_split_query(self._raw_query))
                parts = self._raw_path.split("/")
                # /storage/v1/b/{bucket}/o[/{object}]
                if len(parts) < 6 or parts[1:4] != ["storage", "v1", "b"] or parts[5] != "o":
                    return self._send(404)
                bucket = unquote(parts[4])
                if len(parts) < 7 or not parts[6]:
                    return self._list(bucket, q)
                key = unquote("/".join(parts[6:]))
                media = q.get("alt") == "media"
                fault = stub._fault("GET", (bucket, key) if media else None)
                if fault is not None:
                    return self._send(fault, b"", {"Retry-After": stub.retry_after})
                p = self._path(bucket, key)
                marker = (bucket, key) in stub.markers
                if not marker and (p is None or not os.path.isfile(p)):
                    return self._send(404)
                if media:
                    with stub.lock:
                        stub.media_gets += 1
                    if marker:
                        return self._send(200)
                    return self._send_file(p, self.headers.get("Range"))
                size = 0 if marker else os.path.getsize(p)
                self._json(200, {"kind": "storage#object", "name": key, "bucket": bucket,
                                 "size": str(size)})

            def do_POST(self):
                self._begin()
                body = self._read_body()
                if self._raw_path == "/token":
                    return self._oauth_token(dict(_split_form(body.decode())))
                if not self._authorized():
                    return
                if stub.fail_all is not None:
                    with stub.lock:
                        stub.injected += 1
                    return self._send(stub.fail_all, b"", {"Retry-After": stub.retry_after})
                q = dict(_split_query(self._raw_query))
                parts = self._raw_path.split("/")
                # /upload/storage/v1/b/{bucket}/o
                if len(parts) < 7 or parts[1:5] != ["upload", "storage", "v1", "b"]:
                    return self._send(404)
                bucket, name = unquote(parts[5]), q.get("name", "")
                if q.get("uploadType") == "media":
                    self._store(bucket, name, body)
                    return self._json(200, {"name": name, "bucket": bucket,
                                             "size": str(len(body))})
                if q.get("uploadType") == "resumable":
                    with stub.lock:
                        uid = f"u{stub._upload_seq}"
                        stub._upload_seq += 1
                        stub.uploads[uid] = {"bucket": bucket, "name": name,
                                             "buf": bytearray()}
                    loc = (f"http://{self.headers['Host']}/upload/storage/v1/b/"
                           f"{quote(bucket, safe='')}/o?uploadType=resumable&upload_id={uid}")
                    return self._json(200, {}, {"Location": loc})
                self._send(400)

            def _store(self, bucket, name, data: bytes):
                d = stub.bucket_dir(bucket, create=True)
                if name.endswith("/"):
                    with stub.lock:
                        stub.markers.add((bucket, name))
                    os.makedirs(stub._safe_join(d, name), exist_ok=True)
                    return
                p = stub._safe_join(d, name)
                os.makedirs(os.path.dirname(p), exist_ok=True)
                tmp = f"{p}.{threading.get_ident()}.part"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, p)

            def do_PUT(self):
                self._begin()
                body = self._read_body()
                if not self._authorized():
                    return
                q = dict(_split_query(self._raw_query))
                with stub.lock:
                    up = stub.uploads.get(q.get("upload_id", ""))
                if up is None:
                    return self._send(404)
                spec = self.headers["Content-Range"].split(" ")[1]
                rng, total = spec.split("/")
                start, end = (int(x) for x in rng.split("-"))
                if start != len(up["buf"]):
                    return self._send(400, b"out-of-order resumable chunk")
                up["buf"].extend(body)
                if end + 1 == int(total):
                    self._store(up["bucket"], up["name"], bytes(up["buf"]))
                    return self._json(200, {"name": up["name"], "size": total})
                self._send(308, b"", {"Range": f"bytes=0-{end}"})

            def do_DELETE(self):
                self._begin()
                if not self._authorized():
                    return
                parts = self._raw_path.split("/")
                bucket, key = unquote(parts[4]), unquote("/".join(parts[6:]))
                with stub.lock:
                    stub.markers.discard((bucket, key))
                p = self._path(bucket, key)
                if p is not None and os.path.isfile(p):
                    os.remove(p)
                self._send(204)

        H.stub = stub
        return H


def _split_form(body: str) -> List[Tuple[str, str]]:
    from urllib.parse import parse_qsl

    return parse_qsl(body, keep_blank_values=True)


# --------------------------------------------------------------------- #
# HTTP                                                                   #
# --------------------------------------------------------------------- #
class HttpStub(_Stub):
    """A directory over GET / HEAD. ``ranges=False`` ignores ``Range`` (200
    with the whole body). ``routes``
    maps a path to a fixed body (a listing API, say) and ``mounts`` a path
    prefix to another directory served in place, both before ``root``.
    ``tls=True`` serves over TLS with :data:`LOOPBACK_CERT`."""

    name = "http-stub"

    def __init__(self, root: str, ranges: bool = True,
                 routes: Optional[Dict[str, bytes]] = None,
                 mounts: Optional[Dict[str, str]] = None, tls: bool = False):
        self.ranges = ranges
        self.routes: Dict[str, bytes] = dict(routes or {})
        self.mounts: Dict[str, str] = dict(mounts or {})
        super().__init__(root, tls)

    def route(self, path: str, body: bytes) -> None:
        """Serve ``body`` at ``path``, before the directories."""
        self.routes[path] = body

    def _handler_class(self):
        stub = self

        class H(_Handler):
            def _serve(self):
                self._begin()
                path = unquote(self._raw_path)
                fault = stub._fault(self.command, ("", path))
                if fault is not None:
                    return self._send(fault, b"", {"Retry-After": stub.retry_after})
                if path in stub.routes:
                    return self._send(200, stub.routes[path],
                                      {"Content-Type": "application/json"})
                base, rest = stub.root, path
                for prefix, directory in stub.mounts.items():
                    if path.startswith(prefix):
                        base, rest = directory, path[len(prefix):]
                        break
                try:
                    p = stub._safe_join(base, rest)
                except ValueError:
                    return self._send(400)
                if not os.path.isfile(p):
                    return self._send(404)
                self._send_file(p, self.headers.get("Range"), honour_range=stub.ranges)

            do_GET = do_HEAD = _serve

        H.stub = stub
        return H


# --------------------------------------------------------------------- #
# A stub in a child process                                              #
# --------------------------------------------------------------------- #
_KINDS = {"s3": S3Stub, "gcs": GcsStub, "http": HttpStub}
_CHILD_WAIT_S = 30.0


class ChildStub:
    """A stub (``kind`` ``"s3"``, ``"gcs"`` or ``"http"``, built with
    ``kwargs``) served by a child Python process. Reading an attribute
    returns a copy of the stub's (assign the attribute to change it);
    ``take_log()`` and ``log`` give :class:`Request` s. ``close()`` closes
    the stub in the child and waits for the child to exit; the child also
    exits when the caller's end of its pipe closes."""

    def __init__(self, kind: str, **kwargs):
        # -P: the child's path holds no script directory that could shadow
        # the standard library.
        proc = subprocess.Popen([sys.executable, "-P", os.path.abspath(__file__), "--child"],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        object.__setattr__(self, "_proc", proc)
        object.__setattr__(self, "_lock", threading.Lock())
        try:
            self._ask("open", kind, (), kwargs)
            object.__setattr__(self, "url", self._ask("get", "url")[1])
            object.__setattr__(self, "host", self._ask("get", "host")[1])
        except BaseException:
            proc.kill()
            proc.wait()
            raise

    def _ask(self, op: str, name: str, args: tuple = (), kwargs: Optional[dict] = None):
        with self._lock:
            pickle.dump((op, name, args, kwargs or {}), self._proc.stdin)
            self._proc.stdin.flush()
            status, value = pickle.load(self._proc.stdout)
        if status == "err":
            raise RuntimeError(f"the child's stub failed at {op} {name!r}: {value}")
        return value

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        what, value = self._ask("get", name)
        if what == "method":
            def call(*args, **kwargs):
                out = self._ask("call", name, args, kwargs)
                return [Request(*r) for r in out] if name == "take_log" else out
            return call
        return [Request(*r) for r in value] if name == "log" else value

    def __setattr__(self, name: str, value) -> None:
        self._ask("set", name, (value,))

    def close(self) -> None:
        """Close the stub in the child and wait for the child to exit."""
        if self._proc.poll() is None:
            try:
                self._ask("close", "")
            finally:
                self._proc.stdin.close()
                try:
                    self._proc.wait(_CHILD_WAIT_S)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                    self._proc.wait()
        self._proc.stdout.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _plain(value):
    """``value`` with each :class:`Request` as a plain tuple: the child's
    class is ``__main__``'s, which the caller cannot unpickle."""
    if isinstance(value, list):
        return [tuple(v) if isinstance(v, Request) else v for v in value]
    return value


def _serve_child() -> None:
    """The child's loop: one pickled (op, name, args, kwargs) in, one
    pickled (status, value) out, until ``close`` or the end of input."""
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # nothing but replies goes down the pipe
    stub = None
    while True:
        try:
            op, name, args, kwargs = pickle.load(inp)
        except EOFError:
            break
        try:
            if op == "open":
                stub, value = _KINDS[name](*args, **kwargs), None
            elif op == "get":
                attr = getattr(stub, name)
                value = ("method", None) if callable(attr) else ("value", _plain(attr))
            elif op == "set":
                setattr(stub, name, args[0])
                value = None
            elif op == "call":
                value = _plain(getattr(stub, name)(*args, **kwargs))
            elif op == "close":
                stub.close()
                stub = value = None
            else:
                raise ValueError(f"unknown op {op!r}")
            reply = ("ok", value)
        except Exception as e:  # noqa: BLE001 — sent back and raised there
            reply = ("err", f"{type(e).__name__}: {e}")
        pickle.dump(reply, out)
        out.flush()
        if op == "close":
            break
    if stub is not None:
        stub.close()


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    _serve_child()


__all__ = ["LOOPBACK_CERT", "ChildStub", "GcsStub", "HttpStub", "Request", "S3Stub",
           "sigv4_expected"]
