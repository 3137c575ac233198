"""Ring attention: sequence-parallel exact attention over a process group
(port of ``daft_tpu/ops/ring_attention.py``).

A long sequence is split along T across the ranks of a ``torch.distributed``
group. Each rank keeps its query rows and passes its K/V block around the
ring, one hop to ``rank + 1`` per step (``dist.batch_isend_irecv``), while it
accumulates its queries' attention with the online softmax in f32: a running
max ``m``, denominator ``l`` and output ``o`` carried across blocks. After
``world_size`` steps every rank has seen every block, so the result is exact
full (non-causal) attention while each rank holds one ``T/n x T/n`` logits
block at a time. The JAX package rotates with ``lax.ppermute`` under
``shard_map`` and computes the per-step products in XLA, outside any Pallas
kernel; here they are ``torch.einsum``, and no hand-written kernel stands
behind them.

Under NCCL, CUDA blocks are sent as they are. Gloo sends host tensors only,
so under gloo a CUDA block goes through pinned host buffers: copied out,
sent and received on the host, copied back (``_Ring``). A peer that is gone
makes the send or receive raise (after the group's timeout); nothing falls
back.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from daft_tpu_torch.errors import DaftValueError


class _Ring:
    """One rank's K/V rotation: send to ``rank + 1`` and receive from
    ``rank - 1`` in one ``batch_isend_irecv``; through pinned host buffers
    when the backend is gloo and the blocks lie on a CUDA device."""

    def __init__(self, group, like: torch.Tensor):
        self.group = group
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.send_to = _global_rank(group, (rank + 1) % world)
        self.recv_from = _global_rank(group, (rank - 1) % world)
        self.device = like.device
        self.staged = dist.get_backend(group) == "gloo" and like.device.type == "cuda"

    def _buffers(self, blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.staged:
            return [torch.empty(b.shape, dtype=b.dtype, pin_memory=True) for b in blocks]
        return [torch.empty_like(b) for b in blocks]

    def rotate(self, blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        outgoing = blocks
        if self.staged:
            outgoing = self._buffers(blocks)
            for host, b in zip(outgoing, blocks):
                host.copy_(b)  # synchronous: the host buffer holds the block before it is sent
        incoming = self._buffers(blocks)
        ops = [dist.P2POp(dist.isend, t, self.send_to, self.group) for t in outgoing]
        ops += [dist.P2POp(dist.irecv, t, self.recv_from, self.group) for t in incoming]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if self.staged:
            return [t.to(self.device) for t in incoming]
        return incoming


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact non-causal attention with K/V rotating around ``group``'s ring.

    q, k, v: this rank's ``[B, T_local, D]`` shards, rank r holding positions
    ``[r * T_local, (r + 1) * T_local)``. Returns ``[B, T_local, D]`` in q's
    dtype: this rank's query rows attended over the whole sequence. The
    softmax runs in f32 with ``scale`` (``D ** -0.5`` by default) applied to
    q, as the JAX function does."""
    n = dist.get_world_size(group)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    qf = q.float() * scale
    m = torch.full(qf.shape[:-1], float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    ring = _Ring(group, k) if n > 1 else None
    k_cur, v_cur = k, v
    for step in range(n):
        s = torch.einsum("btd,bsd->bts", qf, k_cur.float())
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        del s
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bts,bsd->btd", p, v_cur.float())
        m = m_new
        # The JAX scan rotates after every step; the last rotation's blocks
        # are never read, so the port skips it.
        if step + 1 < n:
            k_cur, v_cur = ring.rotate([k_cur, v_cur])
    return (o / l[..., None]).to(q.dtype)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                group=None) -> torch.Tensor:
    """Split global ``[B, T, D]`` tensors by rank along T, run
    :func:`ring_attention` and ``all_gather`` the shards: every rank returns
    the whole ``[B, T, D]`` result. T must divide by the group's size. Under
    gloo a CUDA result is gathered through host buffers."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    T = q.shape[1]
    if T % n:
        raise DaftValueError(f"sequence length {T} does not split over {n} ranks")
    t = T // n

    def shard(x: torch.Tensor) -> torch.Tensor:
        return x[:, rank * t:(rank + 1) * t].contiguous()

    out = ring_attention(shard(q), shard(k), shard(v), group=group)
    staged = dist.get_backend(group) == "gloo" and out.device.type == "cuda"
    local = out.cpu() if staged else out
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=group)
    whole = torch.cat(parts, dim=1)
    return whole.to(out.device) if staged else whole
