"""AWS Signature Version 4 request signing + credential resolution (port of
``daft_tpu/io/sigv4.py``).

Reference: the native per-cloud clients in src/daft-io
(src/daft-io/src/s3_like.rs credential chains and signed requests,
object_io.rs:287-330 ranged gets). This is the pure-stdlib signer those
clients need: canonical request -> string-to-sign -> HMAC chain ->
Authorization header, plus the standard credential chain
(explicit config -> AWS_* environment -> anonymous).
"""
from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


@dataclass(frozen=True)
class AwsCredentials:
    key_id: str
    secret_key: str
    session_token: Optional[str] = None


def resolve_credentials(s3_config=None) -> Optional[AwsCredentials]:
    """Credential chain: explicit S3Config keys -> AWS_* env vars -> None
    (anonymous). Reference: s3_like.rs provider chain."""
    if s3_config is not None:
        if getattr(s3_config, "anonymous", False):
            return None
        if getattr(s3_config, "key_id", None):
            if not getattr(s3_config, "access_key", None):
                from daft_tpu_torch.errors import DaftValueError

                raise DaftValueError(
                    "S3Config.key_id is set without access_key — signing "
                    "with an empty secret would fail every request with "
                    "SignatureDoesNotMatch")
            return AwsCredentials(s3_config.key_id, s3_config.access_key,
                                  getattr(s3_config, "session_token", None))
    key = os.environ.get("AWS_ACCESS_KEY_ID")
    if key:
        secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
        if not secret:
            from daft_tpu_torch.errors import DaftValueError

            raise DaftValueError(
                "AWS_ACCESS_KEY_ID is set without AWS_SECRET_ACCESS_KEY — "
                "signing with an empty secret would fail every request with "
                "SignatureDoesNotMatch")
        return AwsCredentials(key, secret, os.environ.get("AWS_SESSION_TOKEN"))
    return None


def _uri_encode(s: str, encode_slash: bool) -> str:
    safe = "-._~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def _canonical_query(query: Mapping[str, str]) -> str:
    pairs = sorted((_uri_encode(k, True), _uri_encode(str(v), True))
                   for k, v in query.items())
    return "&".join(f"{k}={v}" for k, v in pairs)


def sign_request(method: str, url: str, *, region: str, service: str,
                 credentials: AwsCredentials,
                 headers: Optional[Dict[str, str]] = None,
                 query: Optional[Mapping[str, str]] = None,
                 payload: bytes = b"",
                 payload_sha256: Optional[str] = None,
                 now: Optional[datetime.datetime] = None) -> Dict[str, str]:
    """Return the headers (including ``Authorization``) for a sigv4-signed
    request. ``url`` is scheme://host/path (query passed separately)."""
    parsed = urllib.parse.urlsplit(url)
    host = parsed.netloc
    path = parsed.path or "/"
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = payload_sha256 or (
        hashlib.sha256(payload).hexdigest() if payload else EMPTY_SHA256)

    all_headers = {k.lower(): str(v).strip() for k, v in (headers or {}).items()}
    all_headers["host"] = host
    all_headers["x-amz-date"] = amz_date
    if service in ("s3", "s3tables"):
        # S3-family services require the payload hash as a signed header;
        # other services (glue, iam, ...) exclude it — matching AWS's own
        # sigv4 test vectors.
        all_headers["x-amz-content-sha256"] = payload_hash
    if credentials.session_token:
        all_headers["x-amz-security-token"] = credentials.session_token

    signed_names = sorted(all_headers)
    canonical_headers = "".join(f"{k}:{all_headers[k]}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    # SigV4 canonical-URI rule: S3 uses the request path AS SENT (single
    # encoding — callers pass the already-percent-encoded path); every other
    # service double-encodes. Re-encoding an S3 path turns %20 into %2520
    # and fails real AWS with SignatureDoesNotMatch.
    canonical_uri = path if service == "s3" else _uri_encode(path, False)
    canonical_request = "\n".join([
        method.upper(),
        canonical_uri,
        _canonical_query(query or {}),
        canonical_headers,
        signed_headers,
        payload_hash,
    ])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])

    def hmac_sha256(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = hmac_sha256(("AWS4" + credentials.secret_key).encode(), datestamp)
    k = hmac_sha256(k, region)
    k = hmac_sha256(k, service)
    k = hmac_sha256(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()

    out = {k: v for k, v in all_headers.items() if k != "host"}
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={credentials.key_id}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}")
    return out


def signed_url_and_headers(method: str, url: str, *, region: str,
                           service: str, s3_config=None,
                           headers: Optional[Dict[str, str]] = None,
                           query: Optional[Mapping[str, str]] = None,
                           payload: bytes = b"") -> Tuple[str, Dict[str, str]]:
    """Convenience: resolve the credential chain and sign; anonymous
    configurations return the headers unsigned."""
    creds = resolve_credentials(s3_config)
    # %20 (never '+') so the sent query matches the canonical encoding
    # (_canonical_query): strict S3-compatible endpoints reject '+' for
    # values with spaces with SignatureDoesNotMatch.
    full = url if not query else \
        f"{url}?{urllib.parse.urlencode(dict(query), quote_via=urllib.parse.quote)}"
    if creds is None:
        return full, dict(headers or {})
    return full, sign_request(method, url, region=region, service=service,
                              credentials=creds, headers=headers,
                              query=query, payload=payload)
