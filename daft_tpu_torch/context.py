"""Engine context and execution config (port of ``daft_tpu/context.py`` and
``daft_tpu/config.py``).

This slice keeps the knobs the embedding path and the relational layer (the
device layer and the grouped aggregation's cardinality switch) read. ``execution_config_ctx`` changes them for a block of code. Not ported
yet: the planning config, the runner choice (the port runs the local executor
only), tenants, subscribers and the per-query clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Iterator, Tuple


@dataclass(frozen=True)
class ExecutionConfig:
    # Morsel rows for pipeline stages (daft_tpu/config.py's default).
    default_morsel_size: int = 256 * 1024
    # The device the relational layer runs on (device_eval and compiled
    # chains): resolved by ``device.resolve_device`` when a morsel first needs
    # it, so the default raises where no CUDA device is visible.
    device: str = "cuda"
    # Fused evaluation of the numeric subtrees of a projection (ops/device_eval).
    device_eval: bool = True
    device_eval_min_rows: int = 1024
    # Padded lengths of device batches: a program sees O(#buckets) shapes.
    device_batch_buckets: Tuple[int, ...] = (1024, 4096, 16384, 65536, 131072)
    # Whole-chain evaluation (ops/compiled_eval): a filter → project → global
    # partial-aggregation chain runs as ONE cached program per morsel or chunk.
    compiled_eval_enabled: bool = True
    # First-chunk group-reduction ratio above which the grouped aggregation
    # hash-partitions instead of merging chunk partials: a partial pass that
    # keeps more than 30% of its rows feeds a merge nearly the size of the
    # input (daft_tpu/config.py's default).
    high_cardinality_aggregation_threshold: float = 0.3
    # Buckets of the partitioned aggregation, one per worker; 0 = one per
    # visible CPU core. The port aggregates the buckets one after another on
    # the calling thread (the compute pool is ROADMAP A.9.4).
    num_compute_threads: int = 0

    def with_changes(self, **kwargs) -> "ExecutionConfig":
        return dataclasses.replace(self, **kwargs)


class DaftContext:
    def __init__(self) -> None:
        self.execution_config = ExecutionConfig()


_CONTEXT = DaftContext()


def get_context() -> DaftContext:
    return _CONTEXT


@contextlib.contextmanager
def execution_config_ctx(**kwargs) -> Iterator[None]:
    ctx = get_context()
    old = ctx.execution_config
    try:
        ctx.execution_config = old.with_changes(**kwargs)
        yield
    finally:
        ctx.execution_config = old
