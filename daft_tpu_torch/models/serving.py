"""Continuous-batching LLM serving with prefix routing (port of
``daft_tpu/models/serving.py``).

A fixed pool of decode slots (batch dim B) over one KV cache of S positions:
a finished slot is refilled at once instead of idling until the longest
sequence of a static batch completes, and ONE decode step advances every slot
a token. Prompts pad to ``PROMPT_BUCKETS`` for their prefill; requests are
sorted by a blake2b key of their tokens, so identical prompts are admitted
together and share one prefill through a copy of the cache row (prefix
routing).

Where the port departs from the JAX package, the tokens stay the same:

* the cache is written in place: a prefill writes the first ``Pb`` positions
  of its slot's row, a prefix hit copies the source row into the slot's
  (the JAX package builds a fresh row and replaces the old one). What a
  longer request left beyond a slot's position is masked and weighs exactly 0;
* a slot that is not active keeps its position (the JAX package adds 1 to
  every slot's, so a retired slot's climbs past S, where its writes are
  dropped and its positions read NaN). No active slot reads another's row,
  so the active slots' tokens do not change, and no index leaves [0, S);
* ``active`` and the positions are mirrored on the host, so a decode step
  reads one (B,) int32 tensor back from the device.

Sampling at temperature > 0 draws from one seeded ``torch.Generator`` on
the model's device; its draws are not ``jax.random``'s.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.models.lm import EOS_ID, DecoderLM, init_caches, sample


@dataclass
class Request:
    tokens: np.ndarray        # (P,) int32, unpadded
    max_new_tokens: int = 32
    request_id: int = 0
    prefix_key: Optional[str] = None  # set by the router


@dataclass
class _Slot:
    request: Optional[Request] = None
    generated: List[int] = field(default_factory=list)
    remaining: int = 0


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class _PhaseClock:
    """Seconds spent in named phases of a run. On CUDA each span is the
    stream time between two events recorded around it, read once when the
    run ends (so timing adds no synchronisation); on the CPU, where work is
    synchronous, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: Dict[str, list] = {}

    def start(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def stop(self, name: str, started) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.spans.setdefault(name, []).append((started, end))
        else:
            self.spans.setdefault(name, []).append(time.perf_counter() - started)

    def seconds(self, name: str) -> float:
        spans = self.spans.get(name, [])
        if self.cuda and spans:
            spans[-1][1].synchronize()
            return sum(a.elapsed_time(b) for a, b in spans) / 1e3
        return float(sum(spans))


class ContinuousBatcher:
    """Slot-based continuous batching over a ``DecoderLM`` KV cache, on the
    model's device."""

    PROMPT_BUCKETS = (16, 32, 64, 128, 256)

    def __init__(self, model: DecoderLM, num_slots: int = 8, temperature: float = 0.0,
                 seed: int = 0):
        self.model = model
        self.cfg = model.cfg
        self.device = model.lm_head.weight.device
        self.B = num_slots
        self.S = self.cfg.max_seq_len
        self.temperature = temperature
        self._generator = torch.Generator(self.device).manual_seed(seed)
        # Device state: per-layer caches sized for the slot pool.
        self.caches = init_caches(self.cfg, self.B, self.S, device=self.device)
        self.cur_logits = torch.zeros((self.B, self.cfg.vocab_size), dtype=torch.float32,
                                      device=self.device)
        self.positions = torch.zeros(self.B, dtype=torch.int32, device=self.device)
        self.active = torch.zeros(self.B, dtype=torch.bool, device=self.device)
        # Their host mirrors.
        self._positions = np.zeros(self.B, dtype=np.int64)
        self._active = np.zeros(self.B, dtype=bool)
        self.slots = [_Slot() for _ in range(self.B)]
        self._prefill_cache: Dict[tuple, tuple] = {}
        self._counts = {"prefills": 0, "prefix_hits": 0, "kv_positions": 0}
        self.decode_steps = 0
        # The counts and phase times of the most recent run.
        self.last_run_stats: Dict[str, float] = {}

    # -- device work ----------------------------------------------------- #
    def _prefill_impl(self, tokens: torch.Tensor, length: int, slot: int) -> torch.Tensor:
        """Run a (1, Pb) prompt into ``slot``'s cache row; returns the f32
        logits after its last real token."""
        positions = torch.arange(tokens.shape[1], device=self.device)[None, :]
        row = [(ck[slot:slot + 1], cv[slot:slot + 1]) for ck, cv in self.caches]
        logits, _ = self.model(tokens, row, positions)
        return logits[0, length - 1].clone()

    def _copy_row(self, src: int, dst: int) -> None:
        """Share a prefill: copy slot ``src``'s cache rows into ``dst``."""
        for ck, cv in self.caches:
            ck[dst].copy_(ck[src])
            cv[dst].copy_(cv[src])

    def _decode(self) -> np.ndarray:
        """One decode step for the whole pool; returns the (B,) ids it fed."""
        # The cache positions the active slots attend to in this step.
        self._counts["kv_positions"] += int((self._positions + 1)[self._active].sum())
        tok = sample(self.cur_logits, self.temperature, self._generator)
        tok = tok.masked_fill_(~self.active, 0)
        logits, _ = self.model(tok[:, None], self.caches, self.positions[:, None])
        self.cur_logits = logits[:, 0]
        self.positions += self.active
        self._positions += self._active
        return tok.cpu().numpy()

    # -- admission ------------------------------------------------------- #
    def _stage(self, padded: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(padded)
        if self.device.type == "cuda":  # pinned, so the copy does not wait on the stream
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def _prefill(self, req: Request, slot: int) -> None:
        P = len(req.tokens)
        Pb = min(_bucket(P, self.PROMPT_BUCKETS), self.S)
        key = (req.prefix_key, Pb)
        shared_src = self._prefill_cache.get(key)
        if shared_src is not None and req.prefix_key is not None:
            src_slot, next_logits, pos = shared_src
            if self.slots[src_slot].request is not None and \
                    self.slots[src_slot].request.prefix_key == req.prefix_key:
                # Prefix hit: a copy of the cache row on the device, no recompute.
                self._copy_row(src_slot, slot)
                self._admit(req, slot, next_logits, pos)
                self._counts["prefix_hits"] += 1
                return
        padded = np.zeros((1, Pb), np.int32)
        padded[0, :P] = req.tokens[:Pb]
        next_logits = self._prefill_impl(self._stage(padded), min(P, Pb), slot)
        self._counts["prefills"] += 1
        if req.prefix_key is not None:
            self._prefill_cache[key] = (slot, next_logits, min(P, Pb))
        self._admit(req, slot, next_logits, min(P, Pb))

    def _admit(self, req: Request, slot: int, next_logits: torch.Tensor, pos: int) -> None:
        self.cur_logits[slot] = next_logits
        self.positions[slot] = pos
        self.active[slot] = True
        self._positions[slot] = pos
        self._active[slot] = True
        self.slots[slot] = _Slot(request=req, generated=[], remaining=req.max_new_tokens)

    def _retire(self, slot: int, results: Dict[int, List[int]]) -> None:
        s = self.slots[slot]
        if s.request is not None:
            results[s.request.request_id] = s.generated
        # Invalidate any prefill-cache entry pointing at this slot.
        self._prefill_cache = {k: v for k, v in self._prefill_cache.items() if v[0] != slot}
        self.slots[slot] = _Slot()
        self.active[slot] = False
        self._active[slot] = False

    # -- main loop ------------------------------------------------------- #
    @torch.no_grad()
    def run(self, requests: Sequence[Request]) -> List[List[int]]:
        """Generate for all requests; returns token lists in request order.
        ``last_run_stats`` then holds ``prefills``, ``prefix_hits``,
        ``decode_steps``, ``kv_positions`` (the cache positions the active
        slots attended to, summed over the decode steps) and the seconds of
        the admissions (``prefill_s``: prefills and row copies) and of the
        decode steps (``decode_s``)."""
        queue = list(requests)
        max_prompt = self.S - 2  # room for >= 1 generated token
        for i, r in enumerate(queue):
            if len(r.tokens) > max_prompt:
                raise DaftValueError(
                    f"prompt of {len(r.tokens)} tokens exceeds the cache "
                    f"capacity ({self.S}); raise max_seq_len or truncate")
            r.request_id = i
            if r.prefix_key is None:
                r.prefix_key = hashlib.blake2b(
                    np.ascontiguousarray(r.tokens).tobytes(), digest_size=8).hexdigest()
        # Prefix routing: adjacent identical prompts share prefills.
        queue.sort(key=lambda r: (r.prefix_key, r.request_id))
        queue.reverse()  # pop() admits in sorted order
        results: Dict[int, List[int]] = {}
        self._counts = {"prefills": 0, "prefix_hits": 0, "kv_positions": 0}
        clock = _PhaseClock(self.device)
        steps = 0
        while queue or self._active.any():
            # Admit into every free slot.
            free = [i for i in range(self.B) if self.slots[i].request is None]
            if queue and free:
                started = clock.start()
                for slot in free[:len(queue)]:
                    self._prefill(queue.pop(), slot)
                clock.stop("prefill_s", started)
            # One decode step for the whole pool.
            started = clock.start()
            tok_host = self._decode()
            clock.stop("decode_s", started)
            steps += 1
            for slot in range(self.B):
                s = self.slots[slot]
                if s.request is None:
                    continue
                t = int(tok_host[slot])
                s.generated.append(t)
                s.remaining -= 1
                if t == EOS_ID or s.remaining <= 0 or self._positions[slot] >= self.S - 1:
                    self._retire(slot, results)
        self.decode_steps = steps
        self.last_run_stats = {**self._counts, "decode_steps": steps,
                               "prefill_s": clock.seconds("prefill_s"),
                               "decode_s": clock.seconds("decode_s")}
        return [results.get(i, []) for i in range(len(requests))]

