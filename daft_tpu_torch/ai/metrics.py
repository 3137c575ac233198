"""Token/request accounting for API-backed AI providers (port of
``daft_tpu/ai/metrics.py``; the API providers of ``ai/api_providers.py``
record here).

Reference: daft/ai/metrics.py (record_token_metrics) — usage counters flow
to the tracing subsystem so dashboards can attribute cost per query. The
tallies live on the unified registry (daft_tpu_torch/metrics.py) as
``daft_ai_tokens_total{provider_model,kind}`` /
``daft_ai_requests_total{provider_model}``, so they export over
Prometheus/OTLP and aggregate across workers like every other counter.

:func:`token_metrics` keys its snapshot on ``"provider/model"`` strings —
the historical tuple keys were not JSON-serializable, which broke every
exporter that touched them. Legacy ``(provider, model)`` tuple lookups
still resolve through :class:`TokenMetrics`' key shim so existing call
sites keep working.
"""

from __future__ import annotations

from typing import Dict, Union

_Key = Union[str, tuple]


class TokenMetrics(dict):
    """``{"provider/model": {"input_tokens", "output_tokens", "requests"}}``
    with legacy ``(provider, model)`` tuple keys accepted on lookup. Keys
    are plain strings, so ``json.dumps(token_metrics())`` works."""

    @staticmethod
    def _key(key: _Key) -> str:
        if isinstance(key, tuple):
            return "/".join(str(p) for p in key)
        return key

    def __getitem__(self, key: _Key) -> Dict[str, int]:
        return super().__getitem__(self._key(key))

    def get(self, key: _Key, default=None):
        return super().get(self._key(key), default)

    def __contains__(self, key: _Key) -> bool:
        return super().__contains__(self._key(key))


def record_token_metrics(provider: str, model: str, *, input_tokens: int = 0,
                         output_tokens: int = 0, requests: int = 1) -> None:
    from daft_tpu_torch import metrics

    pm = f"{provider}/{model}"
    if input_tokens:
        metrics.AI_TOKENS.labels(pm, "input").inc(int(input_tokens))
    if output_tokens:
        metrics.AI_TOKENS.labels(pm, "output").inc(int(output_tokens))
    if requests:
        metrics.AI_REQUESTS.labels(pm).inc(int(requests))


def token_metrics() -> TokenMetrics:
    """Snapshot of accumulated usage, keyed by ``provider/model``."""
    from daft_tpu_torch import metrics

    snap = metrics.get_registry().snapshot()
    out = TokenMetrics()

    def slot(pm: str) -> Dict[str, int]:
        return out.setdefault(
            pm, {"input_tokens": 0, "output_tokens": 0, "requests": 0})

    # += not =: in distributed mode the same provider/model appears once
    # locally and once per merged worker snapshot (worker_id label).
    raw = snap.raw.get("daft_ai_tokens_total")
    for s in (raw["series"] if raw else ()):
        kind = s["labels"].get("kind", "input")
        slot(s["labels"].get("provider_model", ""))[
            f"{kind}_tokens"] += int(s.get("value", 0))
    raw = snap.raw.get("daft_ai_requests_total")
    for s in (raw["series"] if raw else ()):
        slot(s["labels"].get("provider_model", ""))["requests"] += \
            int(s.get("value", 0))
    # Registry resets zero series in place rather than dropping them; the
    # historical contract is that reset_token_metrics() CLEARS the dict.
    for pm in [pm for pm, v in out.items() if not any(v.values())]:
        del out[pm]
    return out


def reset_token_metrics() -> None:
    from daft_tpu_torch import metrics

    reg = metrics.get_registry()
    reg.reset("daft_ai_tokens_total")
    reg.reset("daft_ai_requests_total")
