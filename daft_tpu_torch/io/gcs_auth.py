"""Google Cloud auth for the native GCS client: ADC chain + token caching
(port of ``daft_tpu/io/gcs_auth.py``).

Reference: src/daft-io/src/google_cloud.rs — the reference resolves
credentials through Application Default Credentials (explicit service-account
JSON, the well-known gcloud ADC file, then the GCE/TPU-VM metadata server)
and refreshes OAuth2 access tokens before expiry. This is that chain in pure
stdlib: service-account keys are exchanged via a self-signed RS256 JWT
(RSASSA-PKCS1-v1_5 implemented directly — the container has no
``cryptography`` wheel), authorized-user ADC uses the refresh-token grant,
and the metadata server is probed once per process. Every token fetch rides
the shared retry policy (io/retry.py).
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Optional, Tuple

from daft_tpu_torch.errors import DaftIOError, DaftTransientError, DaftValueError
from daft_tpu_torch.io.retry import RetryPolicy, with_retries

GCS_SCOPE = "https://www.googleapis.com/auth/devstorage.read_write"
OAUTH2_TOKEN_URI = "https://oauth2.googleapis.com/token"
METADATA_DEFAULT_HOST = "metadata.google.internal"
METADATA_TOKEN_PATH = "/computeMetadata/v1/instance/service-accounts/default/token"
WELL_KNOWN_ADC = os.path.join("~", ".config", "gcloud",
                              "application_default_credentials.json")

# --------------------------------------------------------------------- #
# Pure-stdlib RSASSA-PKCS1-v1_5 / SHA-256 (no `cryptography` in the      #
# image; key sizes are small and signing is once per token lifetime).    #
# --------------------------------------------------------------------- #

# DER DigestInfo prefix for SHA-256 (RFC 8017 §9.2 notes).
_SHA256_DIGEST_INFO = bytes.fromhex(
    "3031300d060960864801650304020105000420")


@dataclass(frozen=True)
class RsaPrivateKey:
    n: int
    e: int
    d: int

    @property
    def byte_length(self) -> int:
        return (self.n.bit_length() + 7) // 8


def _der_read(buf: bytes, pos: int) -> Tuple[int, bytes, int]:
    """Read one TLV at ``pos``: returns (tag, value, next_pos)."""
    tag = buf[pos]
    length = buf[pos + 1]
    pos += 2
    if length & 0x80:
        nbytes = length & 0x7F
        length = int.from_bytes(buf[pos:pos + nbytes], "big")
        pos += nbytes
    return tag, buf[pos:pos + length], pos + length


def load_rsa_private_key(pem: str) -> RsaPrivateKey:
    """Parse a PKCS#8 (``BEGIN PRIVATE KEY``) or PKCS#1
    (``BEGIN RSA PRIVATE KEY``) PEM into (n, e, d)."""
    b64 = "".join(line.strip() for line in pem.splitlines()
                  if line.strip() and not line.startswith("-----"))
    try:
        der = base64.b64decode(b64)
        _, body, _ = _der_read(der, 0)  # outer SEQUENCE
        _, _, pos = _der_read(body, 0)  # version INTEGER
        tag, value, pos = _der_read(body, pos)
        if tag == 0x30:  # PKCS#8: AlgorithmIdentifier then OCTET STRING
            tag, wrapped, _ = _der_read(body, pos)
            if tag != 0x04:
                raise ValueError(f"expected OCTET STRING, got tag {tag:#x}")
            _, body, _ = _der_read(wrapped, 0)  # inner PKCS#1 SEQUENCE
            _, _, pos = _der_read(body, 0)      # inner version INTEGER
            tag, value, pos = _der_read(body, pos)
        ints = [int.from_bytes(value, "big")]   # n
        for _ in range(2):                      # e, d
            _, value, pos = _der_read(body, pos)
            ints.append(int.from_bytes(value, "big"))
        return RsaPrivateKey(n=ints[0], e=ints[1], d=ints[2])
    except (ValueError, IndexError) as exc:
        raise DaftValueError(
            f"Unparseable RSA private key in service-account JSON: {exc}"
        ) from exc


def rsa_sign_pkcs1v15_sha256(key: RsaPrivateKey, message: bytes) -> bytes:
    """EMSA-PKCS1-v1_5 padding + modular exponentiation (RFC 8017 §8.2.1)."""
    digest_info = _SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    k = key.byte_length
    if k < len(digest_info) + 11:
        raise DaftValueError("RSA key too small for SHA-256 signatures")
    padding = b"\xff" * (k - len(digest_info) - 3)
    em = b"\x00\x01" + padding + b"\x00" + digest_info
    sig = pow(int.from_bytes(em, "big"), key.d, key.n)
    return sig.to_bytes(k, "big")


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def make_signed_jwt(sa_info: dict, scope: str = GCS_SCOPE,
                    lifetime_s: int = 3600,
                    now: Optional[float] = None) -> str:
    """Self-signed JWT assertion from a service-account JSON (RFC 7523)."""
    iat = int(now if now is not None else time.time())
    header = {"alg": "RS256", "typ": "JWT"}
    if sa_info.get("private_key_id"):
        header["kid"] = sa_info["private_key_id"]
    claims = {
        "iss": sa_info["client_email"],
        "scope": scope,
        "aud": sa_info.get("token_uri", OAUTH2_TOKEN_URI),
        "iat": iat,
        "exp": iat + lifetime_s,
    }
    signing_input = b".".join(
        _b64url(json.dumps(part, separators=(",", ":")).encode())
        for part in (header, claims))
    key = load_rsa_private_key(sa_info["private_key"])
    signature = rsa_sign_pkcs1v15_sha256(key, signing_input)
    return (signing_input + b"." + _b64url(signature)).decode()


# --------------------------------------------------------------------- #
# Token providers                                                        #
# --------------------------------------------------------------------- #


@dataclass(frozen=True)
class GcsToken:
    token: str
    expires_at: float  # monotonic seconds; float("inf") = never expires


class TokenProvider:
    """Cached OAuth2 access token with expiry-aware refresh. Subclasses
    implement ``_fetch``; callers only see ``token()``."""

    # Refresh this many seconds BEFORE the server-reported expiry, matching
    # google-auth's clock-skew guard.
    expiry_skew_s = 60.0

    def __init__(self, policy: Optional[RetryPolicy] = None):
        self._policy = policy or RetryPolicy(max_retries=2)
        self._lock = threading.Lock()
        self._cached: Optional[GcsToken] = None
        self.fetch_count = 0  # observability + test hook

    def _fresh(self, tok: Optional[GcsToken]) -> bool:
        return tok is not None and \
            time.monotonic() < tok.expires_at - self.expiry_skew_s

    def token(self) -> str:
        # The network fetch (with its retry backoff, up to seconds) happens
        # OUTSIDE the lock so a refresh never serializes every IO thread in
        # the process; concurrent refreshes both produce valid tokens.
        with self._lock:
            cached = self._cached
        if self._fresh(cached):
            return cached.token
        fetched = with_retries(
            self._fetch, self._policy,
            describe=f"{type(self).__name__} token fetch",
            # Only transient failures retry: DaftIOError subclasses OSError
            # (in the default retryable set), but a 400 invalid_grant from
            # a revoked key must fail fast, not back off — especially since
            # this nests inside each client request's own retry loop.
            is_retryable=lambda e: isinstance(e, DaftTransientError))
        with self._lock:
            self._cached = fetched
            self.fetch_count += 1
            return fetched.token

    def invalidate(self) -> None:
        """Drop the cached token (e.g. after a 401) so the next request
        re-fetches."""
        with self._lock:
            self._cached = None

    def _fetch(self) -> GcsToken:
        raise NotImplementedError


class StaticTokenProvider(TokenProvider):
    """A user-supplied bearer token (GCSConfig.token)."""

    def __init__(self, token: str):
        super().__init__()
        self._static = token

    def _fetch(self) -> GcsToken:
        return GcsToken(self._static, float("inf"))


def _post_form(url: str, fields: dict) -> dict:
    data = urllib.parse.urlencode(fields).encode()
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        if e.code in (408, 429, 500, 502, 503, 504):
            raise DaftTransientError(
                f"GCS token endpoint {url}: HTTP {e.code}") from e
        raise DaftIOError(
            f"GCS token endpoint {url}: HTTP {e.code}: {body[:300]!r}") from e
    except (urllib.error.URLError, TimeoutError, ConnectionError, OSError) as e:
        raise DaftTransientError(f"GCS token endpoint {url}: {e}") from e


def _token_from_response(doc: dict) -> GcsToken:
    if "access_token" not in doc:
        raise DaftIOError(f"GCS token response lacks access_token: "
                          f"{str(doc)[:200]}")
    expires_in = float(doc.get("expires_in", 3600))
    return GcsToken(doc["access_token"], time.monotonic() + expires_in)


class ServiceAccountProvider(TokenProvider):
    """Service-account JSON -> self-signed JWT -> token exchange."""

    def __init__(self, sa_info: dict, scope: str = GCS_SCOPE,
                 policy: Optional[RetryPolicy] = None):
        super().__init__(policy)
        for field in ("client_email", "private_key"):
            if field not in sa_info:
                raise DaftValueError(
                    f"service-account JSON lacks {field!r}")
        self._info = sa_info
        self._scope = scope

    def _fetch(self) -> GcsToken:
        assertion = make_signed_jwt(self._info, self._scope)
        doc = _post_form(self._info.get("token_uri", OAUTH2_TOKEN_URI), {
            "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
            "assertion": assertion,
        })
        return _token_from_response(doc)


class AuthorizedUserProvider(TokenProvider):
    """gcloud authorized-user ADC file -> refresh-token grant."""

    def __init__(self, info: dict, policy: Optional[RetryPolicy] = None):
        super().__init__(policy)
        self._info = info

    def _fetch(self) -> GcsToken:
        doc = _post_form(self._info.get("token_uri", OAUTH2_TOKEN_URI), {
            "grant_type": "refresh_token",
            "client_id": self._info.get("client_id", ""),
            "client_secret": self._info.get("client_secret", ""),
            "refresh_token": self._info["refresh_token"],
        })
        return _token_from_response(doc)


class MetadataServerProvider(TokenProvider):
    """GCE / TPU-VM metadata server tokens. Host is overridable via
    GCE_METADATA_HOST (the google-auth convention), which is also how the
    mock server in tests plugs in."""

    def __init__(self, host: Optional[str] = None,
                 policy: Optional[RetryPolicy] = None):
        super().__init__(policy)
        host = host or os.environ.get("GCE_METADATA_HOST") \
            or METADATA_DEFAULT_HOST
        self._base = host if "://" in host else f"http://{host}"

    def _fetch(self) -> GcsToken:
        req = urllib.request.Request(
            self._base + METADATA_TOKEN_PATH,
            headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return _token_from_response(json.loads(resp.read()))
        except urllib.error.HTTPError as e:
            if e.code in (408, 429, 500, 502, 503, 504):
                raise DaftTransientError(
                    f"metadata server token: HTTP {e.code}") from e
            raise DaftIOError(f"metadata server token: HTTP {e.code}") from e
        except (urllib.error.URLError, TimeoutError, ConnectionError, OSError) as e:
            raise DaftTransientError(f"metadata server token: {e}") from e


_METADATA_PROBE: Optional[bool] = None
_METADATA_PROBE_LOCK = threading.Lock()


def _on_gce_dmi() -> Optional[bool]:
    """BIOS product name says definitively whether this is a GCE/TPU VM —
    no network involved. None = indeterminate (non-Linux, no DMI)."""
    try:
        with open("/sys/class/dmi/id/product_name") as f:
            return "Google" in f.read()
    except OSError:
        return None


def metadata_server_available() -> bool:
    """One cheap check per process: is a GCE-style metadata server
    reachable? The DMI heuristic answers without touching the network
    (urlopen's timeout does NOT bound getaddrinfo, and resolving
    metadata.google.internal off-GCE can stall for the resolver timeout);
    the HTTP probe only runs when DMI is indeterminate."""
    global _METADATA_PROBE
    host = os.environ.get("GCE_METADATA_HOST")
    if host:
        return True  # explicit override: trust it
    with _METADATA_PROBE_LOCK:
        if _METADATA_PROBE is not None:
            return _METADATA_PROBE
    # Probe OUTSIDE the lock: the HTTP probe can block for
    # its full timeout, and holding the lock through it would convoy every
    # thread that merely wants the cached answer. A concurrent duplicate
    # probe is an idempotent read-only GET — harmless.
    dmi = _on_gce_dmi()
    if dmi is not None:
        result = dmi
    else:
        req = urllib.request.Request(
            f"http://{METADATA_DEFAULT_HOST}/computeMetadata/v1/",
            headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req, timeout=1):
                result = True
        except (urllib.error.URLError, TimeoutError, ConnectionError,
                OSError, ValueError):
            result = False
    with _METADATA_PROBE_LOCK:
        if _METADATA_PROBE is None:
            _METADATA_PROBE = result
        return _METADATA_PROBE


def _provider_from_adc_file(path: str,
                            policy: Optional[RetryPolicy]) -> TokenProvider:
    try:
        with open(path) as f:
            info = json.load(f)
    except (OSError, ValueError) as exc:
        raise DaftIOError(
            f"Unreadable GCS credentials file {path!r}: {exc}") from exc
    kind = info.get("type")
    if kind == "service_account":
        return ServiceAccountProvider(info, policy=policy)
    if kind == "authorized_user":
        return AuthorizedUserProvider(info, policy=policy)
    raise DaftValueError(
        f"Unsupported ADC credential type {kind!r} in {path!r} "
        f"(expected service_account or authorized_user)")


# Providers are cached process-wide so the per-file client construction in
# the read path reuses one token (providers are thread-safe and refresh
# internally). Keyed by everything the chain below can branch on.
_PROVIDER_CACHE: dict = {}
_PROVIDER_CACHE_LOCK = threading.Lock()


def resolve_gcs_token_provider(gcs_config=None,
                               policy: Optional[RetryPolicy] = None
                               ) -> Optional[TokenProvider]:
    """The ADC chain: explicit config token -> explicit credentials file ->
    GOOGLE_APPLICATION_CREDENTIALS -> well-known gcloud ADC file -> metadata
    server -> anonymous (None). Reference: google_cloud.rs credential
    resolution."""
    cache_key = (
        getattr(gcs_config, "anonymous", False),
        getattr(gcs_config, "token", None),
        getattr(gcs_config, "credentials_path", None),
        os.environ.get("GOOGLE_APPLICATION_CREDENTIALS"),
        os.environ.get("GCE_METADATA_HOST"),
        os.environ.get("HOME"),  # the well-known ADC file lives under it
    )
    with _PROVIDER_CACHE_LOCK:
        if cache_key in _PROVIDER_CACHE:
            return _PROVIDER_CACHE[cache_key]
    provider = _resolve_uncached(gcs_config, policy)
    with _PROVIDER_CACHE_LOCK:
        _PROVIDER_CACHE.setdefault(cache_key, provider)
        return _PROVIDER_CACHE[cache_key]


def _resolve_uncached(gcs_config=None,
                      policy: Optional[RetryPolicy] = None
                      ) -> Optional[TokenProvider]:
    if gcs_config is not None:
        if getattr(gcs_config, "anonymous", False):
            return None
        token = getattr(gcs_config, "token", None)
        if token:
            return StaticTokenProvider(token)
        cred_path = getattr(gcs_config, "credentials_path", None)
        if cred_path:
            return _provider_from_adc_file(cred_path, policy)
    env_path = os.environ.get("GOOGLE_APPLICATION_CREDENTIALS")
    if env_path:
        return _provider_from_adc_file(env_path, policy)
    well_known = os.path.expanduser(WELL_KNOWN_ADC)
    if os.path.exists(well_known):
        return _provider_from_adc_file(well_known, policy)
    if metadata_server_available():
        return MetadataServerProvider(policy=policy)
    return None
