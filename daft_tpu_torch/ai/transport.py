"""HTTP transport for the API-backed AI providers (port of
``daft_tpu/ai/transport.py``).

The protocol implementations (openai / google / lm_studio / vllm) speak
JSON over HTTP through this seam instead of vendor SDKs: a ``Transport`` is
any object with ``post(url, body, headers, timeout) -> dict``. Tests inject
transports that answer from canned responses; the default is
:class:`UrllibTransport`, a stdlib POST under the port's shared retry policy
(``io/retry.py``: exponential backoff with jitter, ``Retry-After``
honoured). A request that still fails after its retries raises
:class:`TransportError`; nothing falls back to another transport.
"""

from __future__ import annotations

import json
from typing import Dict, Mapping, Optional

from daft_tpu_torch.errors import DaftError
from daft_tpu_torch.io.retry import RetryPolicy, with_retries


class TransportError(DaftError):
    """A request failed after exhausting retries."""

    def __init__(self, message: str, status: Optional[int] = None,
                 body: Optional[str] = None, retry_after: Optional[str] = None):
        super().__init__(message)
        self.status = status
        self.body = body
        self.retry_after = retry_after


class UrllibTransport:
    """Stdlib HTTP POST under the shared ``RetryPolicy``. Retryable statuses
    (``io/retry.py::RETRYABLE_HTTP``) and connection errors retry; any
    other status (a 401, a 404) raises at once."""

    def __init__(self, max_retries: int = 5, backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 30.0, timeout_s: float = 60.0):
        self.policy = RetryPolicy(max_retries=max_retries,
                                  backoff_base_s=backoff_base_s,
                                  backoff_cap_s=backoff_cap_s)
        self.timeout_s = timeout_s

    def post(self, url: str, body: Mapping, headers: Optional[Dict[str, str]] = None,
             timeout: Optional[float] = None) -> dict:
        import urllib.error
        import urllib.request

        payload = json.dumps(dict(body)).encode()
        hdrs = {"Content-Type": "application/json", **(headers or {})}

        def attempt() -> dict:
            req = urllib.request.Request(url, data=payload, headers=hdrs, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=timeout or self.timeout_s) as resp:
                    return json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")[:500]
                raise TransportError(
                    f"POST {url} failed with HTTP {e.code}: {detail}",
                    status=e.code, body=detail,
                    retry_after=e.headers.get("Retry-After")) from e
            except (urllib.error.URLError, TimeoutError, ConnectionError, OSError) as e:
                raise TransportError(f"POST {url} failed: {e}") from e

        def retryable(e: BaseException) -> bool:
            status = getattr(e, "status", None)
            if status is not None:
                return status in self.policy.retryable_statuses
            return isinstance(e, TransportError)  # connection level: retry

        return with_retries(attempt, self.policy, describe=f"POST {url}",
                            is_retryable=retryable)
