"""Engine context and execution config (port of ``daft_tpu/context.py`` and
``daft_tpu/config.py``).

This slice keeps the one knob the embedding path reads: ``default_morsel_size``,
the largest morsel a pipeline stage receives (the UDF operator re-morsels to at
most this). ``execution_config_ctx`` changes it for a block of code. Not ported
yet: the planning config, the runner choice (the port runs the local executor
only), tenants, subscribers and the per-query clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Iterator


@dataclass(frozen=True)
class ExecutionConfig:
    # Morsel rows for pipeline stages (daft_tpu/config.py's default).
    default_morsel_size: int = 256 * 1024

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
