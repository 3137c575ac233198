"""Native GCS client: ranged reads, listing, resumable writes over the
JSON API (port of ``daft_tpu/io/gcs_client.py``).

Reference: src/daft-io/src/google_cloud.rs — the reference's first-party
Google Cloud Storage client (ADC credential chain, ranged gets, paginated
listing, anonymous public-bucket access) rather than an SDK. The transport
is the stdlib HTTP stack under the shared retry policy (io/retry.py), auth
is the ADC chain in io/gcs_auth.py (service-account JWT exchange, metadata
server, static token, anonymous), every request reports into io/iostats.py,
and the surface is both a direct client and a pyarrow ``FileSystemHandler``
so gs:// scans and writers ride it transparently. Native is the DEFAULT for
gs://; opt back out to Arrow's GcsFileSystem with
``GCSConfig(use_native_client=False)`` or DAFT_NATIVE_GCS=0.
"""

from __future__ import annotations

import io
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterator, Optional, Tuple

import pyarrow.fs as pafs

from daft_tpu_torch.errors import DaftIOError, DaftTransientError
from daft_tpu_torch.io.gcs_auth import TokenProvider, resolve_gcs_token_provider
from daft_tpu_torch.io.iostats import IO_STATS
from daft_tpu_torch.io.retry import RetryPolicy, with_retries

GCS_DEFAULT_ENDPOINT = "https://storage.googleapis.com"

# Resumable-upload chunks must be multiples of 256 KiB (GCS contract);
# 8 MiB matches the reference's part sizing.
RESUMABLE_CHUNK = 8 * 1024 * 1024


class GCSObject:
    __slots__ = ("key", "size", "is_prefix")

    def __init__(self, key: str, size: int, is_prefix: bool = False):
        self.key = key
        self.size = size
        self.is_prefix = is_prefix


def _resolve_endpoint(cfg, endpoint_url: Optional[str]) -> str:
    from daft_tpu_torch.config import daft_env

    ep = (endpoint_url
          or getattr(cfg, "endpoint_url", None)
          or daft_env("DAFT_GCS_ENDPOINT")
          or daft_env("STORAGE_EMULATOR_HOST")
          or GCS_DEFAULT_ENDPOINT)
    if "://" not in ep:  # STORAGE_EMULATOR_HOST convention is host:port
        ep = "http://" + ep
    return ep.rstrip("/")


class GCSClient:
    """Bearer-authed requests against the GCS JSON API (or an emulator)."""

    def __init__(self, gcs_config=None, endpoint_url: Optional[str] = None,
                 policy: Optional[RetryPolicy] = None,
                 resumable_threshold: int = RESUMABLE_CHUNK,
                 resumable_chunk: int = RESUMABLE_CHUNK):
        self.cfg = gcs_config
        self.endpoint = _resolve_endpoint(gcs_config, endpoint_url)
        tries = getattr(gcs_config, "num_tries", 3) \
            if gcs_config is not None else 3
        # num_tries is TOTAL attempts (policy_from_config convention):
        # max_retries = num_tries - 1.
        self.policy = policy or RetryPolicy(max_retries=max(tries - 1, 0))
        # Shared per-endpoint breaker: repeated transient failures against
        # this host fail fast instead of re-hitting it (io/circuit.py).
        from daft_tpu_torch.io.circuit import breaker_for

        self.breaker = breaker_for(self.endpoint)
        self.provider: Optional[TokenProvider] = \
            resolve_gcs_token_provider(gcs_config, self.policy)
        self.resumable_threshold = resumable_threshold
        self.resumable_chunk = resumable_chunk

    # ------------------------------------------------------------------ #
    def _object_url(self, bucket: str, key: str, upload: bool = False) -> str:
        b = urllib.parse.quote(bucket, safe="")
        if upload:
            return f"{self.endpoint}/upload/storage/v1/b/{b}/o"
        base = f"{self.endpoint}/storage/v1/b/{b}/o"
        # Object names are a single path segment in the JSON API: '/' must
        # be %2F (quote with safe="").
        return f"{base}/{urllib.parse.quote(key, safe='')}" if key else base

    def _auth_headers(self) -> dict:
        if self.provider is None:
            return {}
        return {"Authorization": f"Bearer {self.provider.token()}"}

    def _request(self, method: str, url: str, query: Optional[dict] = None,
                 payload: bytes = b"", headers: Optional[dict] = None
                 ) -> Tuple[int, bytes, dict]:
        # %20 (never '+') in query values: GCS decodes per RFC 3986.
        full = url + (f"?{urllib.parse.urlencode(query, quote_via=urllib.parse.quote)}"
                      if query else "")

        # Zero-byte uploads must still send a body (Content-Length: 0) —
        # `payload or None` would elide it and real endpoints answer 411.
        body_arg = payload if (payload or method in ("PUT", "POST")) else None

        def attempt():
            hdrs = dict(headers or {})
            hdrs.update(self._auth_headers())
            req = urllib.request.Request(full, data=body_arg,
                                         headers=hdrs, method=method)
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    body = resp.read()
                    dt = time.perf_counter() - t0
                    # Count EVERY control-plane verb (list/metadata/delete/
                    # resumable chunks), like the S3 client — per-endpoint
                    # request series must not undercount gs:// workloads.
                    if method in ("PUT", "POST"):
                        IO_STATS.count_put(len(payload), dt,
                                           endpoint=self.endpoint, verb=method)
                    else:
                        IO_STATS.count_get(len(body), dt,
                                           endpoint=self.endpoint, verb=method)
                    return resp.status, body, dict(resp.headers)
            except urllib.error.HTTPError as e:
                body = e.read()
                if e.code == 308:
                    # Resumable-upload "Resume Incomplete" — a success
                    # sentinel, not an error (urllib has no 308 handler).
                    # Count it like the 2xx path: intermediate chunks are
                    # real uploaded bytes, not failures.
                    IO_STATS.count_put(len(payload),
                                       time.perf_counter() - t0,
                                       endpoint=self.endpoint, verb=method)
                    return e.code, body, dict(e.headers)
                if e.code == 401 and self.provider is not None:
                    # Token revoked/expired server-side before our local
                    # expiry: drop the cache so the retry re-fetches.
                    self.provider.invalidate()
                    raise DaftTransientError(
                        f"GCS {method} {full}: HTTP 401 (token refreshed "
                        f"for retry)") from e
                if e.code in self.policy.retryable_statuses:
                    err = DaftTransientError(
                        f"GCS {method} {full}: HTTP {e.code}")
                    err.retry_after = e.headers.get("Retry-After")
                    err.status = e.code
                    raise err from e
                err = DaftIOError(
                    f"GCS {method} {full}: HTTP {e.code}: {body[:300]!r}")
                err.status = e.code
                raise err from e
            except (urllib.error.URLError, TimeoutError, ConnectionError,
                    OSError) as e:
                raise DaftTransientError(f"GCS {method} {full}: {e}") from e

        return with_retries(
            attempt, self.policy, describe=f"GCS {method} {full}",
            is_retryable=lambda e: isinstance(e, DaftTransientError),
            on_retry=lambda: IO_STATS.count_retry(endpoint=self.endpoint),
            breaker=self.breaker)

    # ------------------------------------------------------------------ #
    def get_object(self, bucket: str, key: str, start: Optional[int] = None,
                   length: Optional[int] = None) -> bytes:
        """Whole-object or ranged GET. A zero-length request short-circuits
        to b'' — ``bytes=N-(N-1)`` is an invalid Range (HTTP 416)."""
        if length is not None and length <= 0:
            return b""
        headers = {}
        if start is not None:
            end = "" if length is None else str(start + length - 1)
            headers["Range"] = f"bytes={start}-{end}"
        _, body, _ = self._request("GET", self._object_url(bucket, key),
                                   query={"alt": "media"}, headers=headers)
        return body

    def object_metadata(self, bucket: str, key: str) -> dict:
        _, body, _ = self._request("GET", self._object_url(bucket, key))
        return json.loads(body)

    def head_object(self, bucket: str, key: str) -> int:
        return int(self.object_metadata(bucket, key).get("size", 0))

    def list_objects(self, bucket: str, prefix: str = "",
                     delimiter: str = "",
                     page_size: Optional[int] = None) -> Iterator[GCSObject]:
        """Paginated ``objects.list``; with a delimiter, common prefixes are
        yielded as ``is_prefix`` entries (reference: google_cloud.rs ls)."""
        token: Optional[str] = None
        while True:
            query = {"prefix": prefix}
            if delimiter:
                query["delimiter"] = delimiter
            if token:
                query["pageToken"] = token
            if page_size:
                query["maxResults"] = str(page_size)
            _, body, _ = self._request(
                "GET", self._object_url(bucket, ""), query=query)
            doc = json.loads(body)
            for p in doc.get("prefixes", []):
                yield GCSObject(p, 0, is_prefix=True)
            for item in doc.get("items", []):
                yield GCSObject(item["name"], int(item.get("size", 0)))
            token = doc.get("nextPageToken")
            if not token:
                return

    # ------------------------------------------------------------------ #
    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        """Simple media upload below the resumable threshold; chunked
        resumable session above it (reference: google_cloud.rs writes +
        multipart.rs part sizing)."""
        if data and len(data) >= self.resumable_threshold:
            self._resumable_upload(bucket, key, data)
        else:
            self._request(
                "POST", self._object_url(bucket, key, upload=True),
                query={"uploadType": "media", "name": key}, payload=data,
                headers={"Content-Type": "application/octet-stream"})

    def _resumable_upload(self, bucket: str, key: str, data: bytes) -> None:
        _, _, headers = self._request(
            "POST", self._object_url(bucket, key, upload=True),
            query={"uploadType": "resumable", "name": key},
            headers={"X-Upload-Content-Length": str(len(data))})
        session = headers.get("Location")
        if not session:
            raise DaftIOError(
                f"GCS resumable upload of {bucket}/{key}: initiation "
                f"response lacks a session Location header")
        total = len(data)
        for off in range(0, total, self.resumable_chunk):
            chunk = data[off:off + self.resumable_chunk]
            end = off + len(chunk) - 1
            status, _, _ = self._request(
                "PUT", session, payload=chunk,
                headers={"Content-Range": f"bytes {off}-{end}/{total}"})
            if off + len(chunk) < total and status not in (308,):
                raise DaftIOError(
                    f"GCS resumable upload of {bucket}/{key}: expected 308 "
                    f"for intermediate chunk, got {status}")
            if off + len(chunk) == total and status not in (200, 201):
                raise DaftIOError(
                    f"GCS resumable upload of {bucket}/{key}: expected "
                    f"200/201 for final chunk, got {status}")

    def delete_object(self, bucket: str, key: str) -> None:
        self._request("DELETE", self._object_url(bucket, key))


class _GcsReadableFile(io.RawIOBase):
    """Seekable ranged-read file over the native client."""

    def __init__(self, client: GCSClient, bucket: str, key: str):
        self._c = client
        self._bucket = bucket
        self._key = key
        self._size = client.head_object(bucket, key)
        self._pos = 0
        IO_STATS.count_open()

    def readable(self):
        return True

    def seekable(self):
        return True

    def size(self) -> int:
        return self._size

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = self._size + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if self._pos >= self._size:
            return b""
        length = self._size - self._pos if n is None or n < 0 else \
            min(n, self._size - self._pos)
        data = self._c.get_object(self._bucket, self._key, self._pos, length)
        self._pos += len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)


def _not_found(exc: BaseException) -> bool:
    return getattr(exc, "status", None) == 404


class GcsFileSystemHandler(pafs.FileSystemHandler):
    """pyarrow seam: scans/readers/writers open gs:// paths through the
    native client (the default; DAFT_NATIVE_GCS=0 opts back to Arrow)."""

    def __init__(self, client: GCSClient):
        self.client = client

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        path = path.lstrip("/")
        bucket, _, key = path.partition("/")
        return bucket, key

    def get_type_name(self):
        return "daft-gcs"

    def _classify_prefix(self, p: str, bucket: str, key: str) -> pafs.FileInfo:
        for _ in self.client.list_objects(
                bucket, prefix=key.rstrip("/") + "/" if key else "",
                page_size=1):
            return pafs.FileInfo(p, pafs.FileType.Directory)
        return pafs.FileInfo(p, pafs.FileType.NotFound)

    def get_file_info(self, paths):
        out = []
        for p in paths if isinstance(paths, list) else [paths]:
            bucket, key = self._split(p)
            if not key:
                # Bucket root: never an object (head_object("") would hit
                # the LIST endpoint and misreport a zero-size File).
                out.append(self._classify_prefix(p, bucket, key))
                continue
            try:
                size = self.client.head_object(bucket, key)
                out.append(pafs.FileInfo(p, pafs.FileType.File, size=size))
            except DaftIOError as e:
                if not _not_found(e):
                    raise  # 403 etc. must surface, not read as NotFound
                out.append(self._classify_prefix(p, bucket, key))
        return out if isinstance(paths, list) else out[0]

    def get_file_info_selector(self, selector):
        """Honors ``selector.recursive`` (delimiter listing + Directory
        entries from common prefixes) and ``selector.allow_not_found``."""
        bucket, key = self._split(selector.base_dir)
        prefix = key.rstrip("/") + "/" if key else ""
        delimiter = "" if selector.recursive else "/"
        out = []
        listed_any = False
        for obj in self.client.list_objects(bucket, prefix=prefix,
                                            delimiter=delimiter):
            listed_any = True
            if obj.is_prefix:
                out.append(pafs.FileInfo(f"{bucket}/{obj.key.rstrip('/')}",
                                         pafs.FileType.Directory))
            elif not obj.key.endswith("/"):  # skip zero-byte dir markers
                out.append(pafs.FileInfo(f"{bucket}/{obj.key}",
                                         pafs.FileType.File, size=obj.size))
        if not listed_any and prefix:
            # Object stores have implicit directories: a fully empty
            # listing (not even a marker) means the base_dir does not
            # exist. A marker-only listing is an existing empty dir -> [],
            # and the bucket root always "exists" (a nonexistent bucket
            # fails the list call itself).
            if getattr(selector, "allow_not_found", False):
                return []
            raise FileNotFoundError(selector.base_dir)
        return out

    def open_input_file(self, path):
        import pyarrow as pa

        bucket, key = self._split(path)
        return pa.PythonFile(_GcsReadableFile(self.client, bucket, key),
                             mode="r")

    def open_input_stream(self, path):
        return self.open_input_file(path)

    def open_output_stream(self, path, metadata=None):
        import pyarrow as pa

        bucket, key = self._split(path)
        client = self.client

        class _Out(io.BytesIO):
            # Same abort contract as the S3 handler: upload exactly once,
            # and never from a close() running during exception unwind — a
            # failed serializer GC-closing its stream must not publish a
            # truncated object as a live key.
            _uploaded = False

            def close(self):
                import sys

                if self._uploaded or self.closed:
                    return
                if sys.exc_info()[0] is not None:
                    super().close()
                    raise DaftIOError(
                        f"aborted gcs upload of {bucket}/{key}: stream "
                        f"closed during exception unwind; object not written")
                self._uploaded = True
                client.put_object(bucket, key, self.getvalue())
                super().close()

        return pa.PythonFile(_Out(), mode="w")

    def open_append_stream(self, path, metadata=None):
        raise NotImplementedError("GCS objects are immutable; no append")

    def create_dir(self, path, recursive):
        pass  # prefixes are implicit

    def delete_dir(self, path):
        bucket, key = self._split(path)
        for obj in list(self.client.list_objects(
                bucket, prefix=key.rstrip("/") + "/")):
            self.client.delete_object(bucket, obj.key)

    def delete_dir_contents(self, path, missing_dir_ok=False):
        self.delete_dir(path)

    def delete_root_dir_contents(self):
        raise NotImplementedError

    def delete_file(self, path):
        bucket, key = self._split(path)
        self.client.delete_object(bucket, key)

    def move(self, src, dest):
        sb, sk = self._split(src)
        db, dk = self._split(dest)
        self.client.put_object(db, dk, self.client.get_object(sb, sk))
        self.client.delete_object(sb, sk)

    def copy_file(self, src, dest):
        sb, sk = self._split(src)
        db, dk = self._split(dest)
        self.client.put_object(db, dk, self.client.get_object(sb, sk))

    def normalize_path(self, path):
        return path

    def __eq__(self, other):
        # Config identity matters: same endpoint under different
        # credentials is NOT the same filesystem (pyarrow merges datasets
        # across handlers that compare equal).
        return isinstance(other, GcsFileSystemHandler) and \
            other.client.endpoint == self.client.endpoint and \
            other.client.cfg == self.client.cfg

    def __ne__(self, other):
        return not self.__eq__(other)
