"""Dynamic batch sizing for host UDFs (port of
``daft_tpu/execution/dynamic_batching.py``).

Reference: src/daft-local-execution/src/dynamic_batching/
{latency_constrained_strategy.rs,static_strategy.rs}. The latency-constrained
strategy adapts Algorithm 2 of "Optimizing LLM Inference Throughput via
Memory-aware and SLA-constrained Dynamic Batching" (arXiv:2503.05248):
binary-search the largest batch size whose observed latency stays within a
target, contracting on overshoot, expanding on slack, tightening once in
range.

A UDF with a declared ``batch_size`` (the AI functions: a device batch
shape) keeps fixed morsels of 16 device batches; a host UDF without one has
no shape to keep, so its morsel size follows the measured latency. The
executor applies it unless ``udf_dynamic_batching=False``.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class StaticBatching:
    """Fixed morsel size (reference: static_strategy.rs)."""

    size: int

    def make_state(self) -> "StaticState":
        return StaticState(self.size)


class StaticState:
    def __init__(self, size: int):
        self.size = size

    def record(self, batch_size: int, latency_s: float) -> None:
        pass

    def next_batch_size(self) -> int:
        return self.size


@dataclass(frozen=True)
class LatencyConstrainedBatching:
    """Algorithm 2 (arXiv:2503.05248) binary-search batching."""

    target_latency_s: float = 0.2
    tolerance_s: float = 0.02     # epsilon_D
    alpha: int = 64               # step size for bound moves
    delta: int = 8                # correction nudge
    b_min: int = 1
    b_max: int = 128 * 1024

    def make_state(self) -> "LatencyConstrainedState":
        return LatencyConstrainedState(self)


class LatencyConstrainedState:
    WINDOW = 16

    def __init__(self, strat: LatencyConstrainedBatching):
        self.strat = strat
        self.b_low = strat.b_min
        self.b_high = min(256, strat.b_max)  # small initial search space
        self.current = max(strat.b_min, 1)
        self._lat: deque = deque(maxlen=self.WINDOW)
        self._sizes: deque = deque(maxlen=self.WINDOW)
        self._lock = threading.Lock()

    def record(self, batch_size: int, latency_s: float) -> None:
        with self._lock:
            self._lat.append(latency_s)
            self._sizes.append(batch_size)
            self._recalculate()

    def _recalculate(self) -> None:
        if not self._lat:
            return
        s = self.strat
        t = sum(self._lat) / len(self._lat)          # tau-bar
        b = int(sum(self._sizes) / len(self._sizes))  # b-bar
        # Out-of-band moves pull the search window toward the LATENCY-IMPLIED
        # batch size (b_bar * target/tau_bar) rather than the paper's fixed
        # alpha/delta steps: fixed steps floor the window width at ~alpha
        # (a per-row cost above target/alpha can then never meet the target)
        # and overshoot into a 2<->18 limit cycle on expansion. Proportional
        # pulls converge for any per-row cost; the in-range branch keeps the
        # paper's tightening.
        implied = max(int(b * (s.target_latency_s / max(t, 1e-9))), s.b_min)
        if t > s.target_latency_s + s.tolerance_s:
            # Too slow: contract the ceiling toward the implied size.
            self.b_high = max(min(self.b_high, max(implied, b // 2)), s.b_min)
            self.b_low = max(min(self.b_low - 1 - s.delta, self.b_high),
                             s.b_min)
        elif t < s.target_latency_s - s.tolerance_s:
            # Headroom: raise the ceiling toward the implied size.
            self.b_high = min(max(implied, b + 1), s.b_max)
            self.b_low = max(min(b, self.b_high), s.b_min)
        else:
            # In range: tighten around the observed average.
            half = s.alpha // 2
            self.b_high = min(b + half, s.b_max)
            self.b_low = max(b - half, s.b_min)
        self.current = min(max((self.b_low + self.b_high) // 2, s.b_min),
                           s.b_max)

    def next_batch_size(self) -> int:
        with self._lock:
            return self.current


def dynamic_remorsel(it, state):
    """Re-slice a morsel stream to the batching state's CURRENT size,
    re-queried between output morsels (the feedback path: the consumer
    records each batch's latency into the same state)."""
    from daft_tpu_torch.micropartition import MicroPartition

    pending = []
    pending_rows = 0
    for mp in it:
        pending.append(mp)
        pending_rows += len(mp)
        while pending_rows >= max(state.next_batch_size(), 1):
            want = max(state.next_batch_size(), 1)
            combined = MicroPartition.concat(pending) if len(pending) > 1 else pending[0]
            out = combined.slice(0, want)
            rest = combined.slice(want, len(combined) - want)
            pending = [rest] if len(rest) else []
            pending_rows = len(rest)
            yield out
    if pending_rows:
        yield MicroPartition.concat(pending) if len(pending) > 1 else pending[0]
