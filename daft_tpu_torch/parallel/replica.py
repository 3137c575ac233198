"""Replica device slots: the engine's half of ``chips_per_replica`` (port of
``daft_tpu/parallel/replica.py``).

The reference pins UDF actor replicas to GPU slots through
``CUDA_VISIBLE_DEVICES`` (src/daft-local-execution/src/intermediate_ops/udf.rs:391-406).
Here the UDFProject operator partitions the visible CUDA devices into
``chips_per_replica``-sized groups, and each morsel evaluates inside a
:func:`replica_scope` naming its group. A provider reads
:func:`replica_devices` when it is instantiated and places its tower on
exactly those devices (``ai/cuda_provider.py::CUDACLIPImageEmbedder.setup_mesh``),
so each replica owns its slot with no global state.

The devices come from one function, :func:`visible_devices`: ``cuda:0`` to
``cuda:n-1``. It never returns the CPU; without a CUDA device it raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import queue
from typing import List, Optional, Sequence, Tuple

import torch

from daft_tpu_torch.errors import DaftValueError

_replica_slot: contextvars.ContextVar[Optional[Tuple[int, tuple]]] = \
    contextvars.ContextVar("daft_replica_slot", default=None)

log = logging.getLogger("daft_tpu_torch.parallel")


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device, ``cuda:0`` to ``cuda:n-1``; raises when
    there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise DaftValueError(
            "no CUDA device is visible: replica slots and meshes are made of CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def replica_devices() -> List[torch.device]:
    """The devices of the current replica slot; outside a scope, every
    visible device (a single-replica UDF sees the whole host)."""
    slot = _replica_slot.get()
    if slot is not None:
        return list(slot[1])
    return visible_devices()


def replica_id() -> int:
    """The id of the current replica slot (0 outside a scope)."""
    slot = _replica_slot.get()
    return slot[0] if slot is not None else 0


def in_replica_scope() -> bool:
    """Whether the caller runs inside a :func:`replica_scope`."""
    return _replica_slot.get() is not None


@contextlib.contextmanager
def replica_scope(idx: int, devices: Sequence[torch.device]):
    token = _replica_slot.set((idx, tuple(devices)))
    try:
        yield
    finally:
        _replica_slot.reset(token)


class ReplicaSlots:
    """Partition the visible devices into ``chips_per_replica`` groups and
    lend them to morsel evaluations (the actor pool's slot queue).

    With R groups, at most R morsels evaluate at once; each runs inside a
    :func:`replica_scope` for its group, so the provider instance it makes
    lives on that group's devices."""

    def __init__(self, chips_per_replica: int, devices: Optional[list] = None):
        devs = list(devices if devices is not None else visible_devices())
        cpr = max(1, int(chips_per_replica))
        if cpr > len(devs):
            log.warning("chips_per_replica=%d exceeds the %d visible device(s); "
                        "clamping to one replica over all devices", cpr, len(devs))
            cpr = len(devs)
        n = max(1, len(devs) // cpr)
        stranded = len(devs) - n * cpr
        if stranded:
            log.warning("chips_per_replica=%d leaves %d of %d devices unused "
                        "(%d replica group(s) of %d)", cpr, stranded, len(devs), n, cpr)
        self.groups: List[tuple] = [tuple(devs[i * cpr:(i + 1) * cpr]) for i in range(n)]
        self._free: "queue.Queue[int]" = queue.Queue()
        for i in range(n):
            self._free.put(i)

    @property
    def num_replicas(self) -> int:
        return len(self.groups)

    def run(self, fn, *args, **kwargs):
        """Run ``fn`` holding one replica slot (blocks until a slot frees)."""
        idx = self._free.get()
        try:
            with replica_scope(idx, self.groups[idx]):
                return fn(*args, **kwargs)
        finally:
            self._free.put(idx)
