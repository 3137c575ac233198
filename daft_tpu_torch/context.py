"""Engine context: the configs, the runner and the subscribers (port of
``daft_tpu/context.py``).

The configs live in ``config.py``; the default execution config is
``ExecutionConfig.from_env()``, as in the JAX package, and both names are
importable from here too. ``set_execution_config`` / ``set_planning_config``
change them for the process, ``execution_config_ctx`` /
``planning_config_ctx`` for a block of code. ``get_context().runner`` is the
runner every DataFrame materializes through (``runners/native.py``;
``set_runner_native`` installs a fresh one, ``set_runner_distributed`` is
ROADMAP A.8.5). The per-query clock (``query_now``) freezes CURRENT_DATE /
CURRENT_TIMESTAMP once per statement. Event subscribers attach to the
context (``attach_subscriber``) and ``notify`` hands each one every engine
event, after ``tracing.maybe_enable_tracing`` and
``metrics.maybe_enable_metrics`` have attached their env- and
config-gated subscribers.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import logging
import threading
from typing import Iterator, List, Optional

from daft_tpu_torch.config import ExecutionConfig, PlanningConfig


class DaftContext:
    def __init__(self) -> None:
        self.planning_config = PlanningConfig()
        self.execution_config = ExecutionConfig.from_env()
        self._lock = threading.Lock()
        self._runner = None
        self._subscribers: List[object] = []
        # The latest query's RuntimeStats (DataFrame.metrics()).
        self.last_query_stats = None

    # -- runner -----------------------------------------------------------
    @property
    def runner(self):
        """The process's runner: the native runner unless one was set."""
        with self._lock:
            if self._runner is None:
                from daft_tpu_torch.runners.native import NativeRunner

                self._runner = NativeRunner()
            return self._runner

    def set_runner(self, runner) -> None:
        with self._lock:
            self._runner = runner

    # -- subscribers ------------------------------------------------------
    def attach_subscriber(self, subscriber) -> None:
        with self._lock:
            self._subscribers.append(subscriber)

    def detach_subscriber(self, subscriber) -> None:
        with self._lock:
            self._subscribers.remove(subscriber)

    def subscribers(self) -> List[object]:
        return list(self._subscribers)

    def notify(self, event) -> None:
        from daft_tpu_torch.metrics import maybe_enable_metrics
        from daft_tpu_torch.tracing import maybe_enable_tracing

        maybe_enable_tracing(self)
        maybe_enable_metrics(self)
        for s in self.subscribers():
            try:
                s.on_event(event)
            except Exception:
                # One broken subscriber must not kill the query, but a
                # silently dead metrics sink is a debugging trap: say so.
                logging.getLogger("daft_tpu_torch.context").warning(
                    "event subscriber %r raised; event %s dropped",
                    type(s).__name__, type(event).__name__, exc_info=True)


_CONTEXT = DaftContext()


def get_context() -> DaftContext:
    return _CONTEXT


def set_execution_config(config: Optional[ExecutionConfig] = None, **kwargs) -> None:
    ctx = get_context()
    base = config or ctx.execution_config
    ctx.execution_config = base.with_changes(**kwargs) if kwargs else base


def set_planning_config(config: Optional[PlanningConfig] = None, **kwargs) -> None:
    ctx = get_context()
    base = config or ctx.planning_config
    ctx.planning_config = base.with_changes(**kwargs) if kwargs else base


@contextlib.contextmanager
def execution_config_ctx(**kwargs) -> Iterator[None]:
    ctx = get_context()
    old = ctx.execution_config
    try:
        ctx.execution_config = old.with_changes(**kwargs)
        yield
    finally:
        ctx.execution_config = old


@contextlib.contextmanager
def planning_config_ctx(**kwargs) -> Iterator[None]:
    ctx = get_context()
    old = ctx.planning_config
    try:
        ctx.planning_config = old.with_changes(**kwargs)
        yield
    finally:
        ctx.planning_config = old


def set_runner_native() -> None:
    from daft_tpu_torch.runners.native import NativeRunner

    get_context().set_runner(NativeRunner())


def set_runner_distributed(**kwargs) -> None:
    from daft_tpu_torch.errors import DaftNotImplementedError

    raise DaftNotImplementedError(
        "the distributed runner is not ported to daft_tpu_torch yet: ROADMAP A.8.5")


# -- per-query clock --------------------------------------------------------
# CURRENT_DATE / CURRENT_TIMESTAMP are one value per statement, not one per
# morsel: the DataFrame freezes the clock around the executor's stream, and
# the now() / today() kernels read it through query_now(). Outside a query (a
# bare Series evaluation) the wall clock is read directly. Stage threads see
# the frozen value: the pipeline hands each task a copy of the caller's
# contextvars.
_query_clock: contextvars.ContextVar[Optional[datetime.datetime]] = \
    contextvars.ContextVar("daft_torch_query_clock", default=None)


def query_now() -> datetime.datetime:
    frozen = _query_clock.get()
    return frozen if frozen is not None else datetime.datetime.now(datetime.timezone.utc)


def iter_with_frozen_clock(gen):
    """Drain ``gen`` with the query clock frozen during each resumption only,
    so two lazy queries interleaved on one thread cannot reset each other's
    clock: the clock is set right before each ``next()`` and reset before
    control returns to the caller."""
    now = datetime.datetime.now(datetime.timezone.utc)
    while True:
        token = _query_clock.set(now)
        try:
            try:
                item = next(gen)
            finally:
                _query_clock.reset(token)
        except StopIteration:
            return
        yield item


@contextlib.contextmanager
def frozen_clock_scope(at: Optional[datetime.datetime] = None):
    """Freeze the query clock for a synchronous block."""
    token = _query_clock.set(at or datetime.datetime.now(datetime.timezone.utc))
    try:
        yield
    finally:
        _query_clock.reset(token)
