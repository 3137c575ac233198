"""User-defined functions (port of ``daft_tpu/udf/__init__.py``).

Reference: daft/udf/__init__.py — ``@daft.func`` (row-wise), ``@daft.func.batch``
(batch over Series), ``@daft.cls`` / ``@daft.method`` (stateful UDFs with
cpus / gpus / max_concurrency / max_retries / on_error). Calling a UDF builds a
``UdfCall`` expression; the executor's UDFProject operator evaluates it per
morsel, ``max_concurrency`` morsels at once on a pool of the UDF's own. A
stateful UDF's instance is created lazily, once per process, on first use: a
class that holds a model on the card builds it there once. ``gpus`` / ``tpus``
/ ``cpus`` / ``memory_bytes`` are recorded asks, and ``use_process`` is
accepted and does nothing, as in the JAX package. ``chips_per_replica``
partitions the visible CUDA devices into replica slots of that many devices
(``parallel/replica.py``): each morsel evaluates inside one slot's scope,
at most one morsel per slot at a time, and ``replica_devices()`` names the
slot's devices to the code the UDF runs.
"""

from __future__ import annotations

import copy
import functools
import threading
import time
from typing import Callable, List, Optional

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftExecutionError, DaftValueError
from daft_tpu_torch.expressions.expr import UdfCall, ensure_expr
from daft_tpu_torch.expressions.expression import Expression
from daft_tpu_torch.series import Series
from daft_tpu_torch.udf.udaf import Udaf, udaf  # noqa: F401  (public surface)


class Udf:
    """A callable UDF descriptor; calling it builds a UdfCall expression."""

    def __init__(self, fn: Callable, return_dtype: DataType, batch: bool = False,
                 name: Optional[str] = None, max_concurrency: Optional[int] = None,
                 cpus: Optional[float] = None, gpus: Optional[float] = None,
                 tpus: Optional[float] = None, memory_bytes: Optional[int] = None,
                 max_retries: int = 0, on_error: str = "raise",
                 batch_size: Optional[int] = None, use_process: bool = False,
                 chips_per_replica: Optional[int] = None):
        self.fn = fn
        self.return_dtype = return_dtype
        self.batch = batch
        self.name = name or getattr(fn, "__name__", "udf")
        # Morsels evaluated at once (None or 1: one at a time); ``fn`` must
        # then be safe to call from that many threads.
        self.max_concurrency = max_concurrency
        self.cpus = cpus
        self.gpus = gpus
        self.tpus = tpus
        self.memory_bytes = memory_bytes
        self.max_retries = max_retries
        self.on_error = on_error
        self.batch_size = batch_size
        self.use_process = use_process
        # Devices per replica slot (the reference's gpus_per_actor).
        self.chips_per_replica = chips_per_replica
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs) -> Expression:
        exprs = [ensure_expr(a) for a in args]
        return Expression(UdfCall(self, exprs, kwargs))

    # -- engine-side evaluation ------------------------------------------
    def evaluate(self, args: List[Series], kwargs: dict) -> Series:
        """One morsel: retried whole with exponential backoff; after the last
        attempt ``on_error="null"`` nulls every row of the morsel (C.42)."""
        attempts = self.max_retries + 1
        delay = 0.25
        last_err: Optional[BaseException] = None
        for attempt in range(attempts):
            try:
                return self._evaluate_once(args, kwargs)
            except Exception as e:  # noqa: BLE001  (the user's function may raise anything)
                last_err = e
                if attempt + 1 < attempts:
                    # Exponential backoff (reference: python_udf/retry.rs:79-134).
                    time.sleep(min(delay, 10.0))
                    delay *= 2
        if self.on_error == "null":
            return Series.null(self.name, self.return_dtype, len(args[0]) if args else 0)
        raise DaftExecutionError(
            f"UDF {self.name!r} failed after {attempts} attempts: {last_err}") from last_err

    def _evaluate_once(self, args: List[Series], kwargs: dict) -> Series:
        if self.batch:
            out = self.fn(*args, **kwargs)
            return _coerce_output_batch(out, self.name, self.return_dtype)
        cols = [a.to_pylist() for a in args]
        out_rows = [self.fn(*row, **kwargs) for row in zip(*cols)] if cols else []
        return Series.from_pylist(out_rows, self.name, self.return_dtype)

    def override_options(self, **kwargs) -> "Udf":
        """A copy of this UDF with the given attributes replaced."""
        new = copy.copy(self)
        for k, v in kwargs.items():
            setattr(new, k, v)
        return new

    def with_concurrency(self, max_concurrency: int) -> "Udf":
        return self.override_options(max_concurrency=max_concurrency)


def _coerce_output_batch(out, name: str, dtype: DataType) -> Series:
    import numpy as np
    import pyarrow as pa
    import torch

    if isinstance(out, Series):
        return out.cast(dtype) if out.dtype != dtype else out
    if isinstance(out, (pa.Array, pa.ChunkedArray)):
        return Series.from_arrow(out, name, dtype)
    if isinstance(out, np.ndarray):
        return Series.from_numpy(out, name, dtype)
    if isinstance(out, list):
        return Series.from_pylist(out, name, dtype)
    if isinstance(out, torch.Tensor):
        return Series.from_numpy(out.detach().cpu().numpy(), name, dtype)
    raise DaftValueError(f"Batch UDF {name!r} returned unsupported type {type(out)}")


def func(fn: Optional[Callable] = None, *, return_dtype: Optional[DataType] = None, **options):
    """Row-wise UDF decorator (reference: @daft.func, daft/udf/__init__.py:24)."""

    def deco(f):
        rd = return_dtype or _infer_return_dtype(f)
        return Udf(f, rd, batch=False, **options)

    return deco(fn) if fn is not None else deco


def _batch(fn: Optional[Callable] = None, *, return_dtype: Optional[DataType] = None, **options):
    """Batch UDF decorator: fn receives Series (reference: @daft.func.batch)."""

    def deco(f):
        rd = return_dtype or _infer_return_dtype(f)
        return Udf(f, rd, batch=True, **options)

    return deco(fn) if fn is not None else deco


func.batch = _batch


def _infer_return_dtype(f: Callable) -> DataType:
    import typing

    ret = typing.get_type_hints(f).get("return")
    mapping = {
        int: DataType.int64(), float: DataType.float64(), str: DataType.string(),
        bool: DataType.bool(), bytes: DataType.binary(),
    }
    if ret in mapping:
        return mapping[ret]
    raise DaftValueError(
        f"UDF {getattr(f, '__name__', '?')} needs an explicit return_dtype "
        "(or an int/float/str/bool/bytes return annotation)"
    )


# ---------------------------------------------------------------------- #
# Stateful class UDFs                                                     #
# ---------------------------------------------------------------------- #
class _StatefulMethodUdf(Udf):
    """Method UDF bound to a lazily-instantiated stateful class instance.

    The instance is constructed once per process on first use, under a lock
    (the actor-pool replica pattern — reference: @daft.cls + UDFActor,
    daft/execution/ray_actor_pool_udf.py:32-100); a pickled copy drops it.
    """

    def __init__(self, cls_wrapper: "_ClsWrapper", init_args, init_kwargs, method_name: str,
                 return_dtype: DataType, batch: bool, **options):
        self._cls_wrapper = cls_wrapper
        self._init_args = init_args
        self._init_kwargs = init_kwargs
        self._method_name = method_name
        self._instance = None
        self._lock = threading.Lock()

        def call(*args, **kwargs):
            return getattr(self._get_instance(), method_name)(*args, **kwargs)

        call.__name__ = f"{cls_wrapper.cls.__name__}.{method_name}"
        super().__init__(call, return_dtype, batch=batch, **options)

    def _get_instance(self):
        if self._instance is None:
            with self._lock:
                if self._instance is None:
                    self._instance = self._cls_wrapper.cls(*self._init_args, **self._init_kwargs)
        return self._instance

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_instance"] = None
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._instance = None
        self._lock = threading.Lock()


def method(fn: Optional[Callable] = None, *, return_dtype: Optional[DataType] = None,
           batch: bool = False):
    """Mark a method of a @cls-decorated class as a UDF endpoint."""

    def deco(f):
        f.__daft_method__ = {"return_dtype": return_dtype, "batch": batch}
        return f

    return deco(fn) if fn is not None else deco


def _method_batch(fn: Optional[Callable] = None, *, return_dtype: Optional[DataType] = None):
    return method(fn, return_dtype=return_dtype, batch=True)


method.batch = _method_batch


class _ClsWrapper:
    def __init__(self, cls, options: dict):
        self.cls = cls
        self.options = options
        functools.update_wrapper(self, cls, updated=())

    def __call__(self, *init_args, **init_kwargs):
        return _ClsInstance(self, init_args, init_kwargs)


class _ClsInstance:
    def __init__(self, wrapper: _ClsWrapper, init_args, init_kwargs):
        self._wrapper = wrapper
        self._init_args = init_args
        self._init_kwargs = init_kwargs
        self._udfs: dict = {}
        # A bare __call__ on the class acts as the default UDF endpoint.
        for name in dir(wrapper.cls):
            attr = getattr(wrapper.cls, name)
            if callable(attr) and hasattr(attr, "__daft_method__"):
                meta = attr.__daft_method__
                rd = meta["return_dtype"] or _infer_return_dtype(attr)
                self._udfs[name] = _StatefulMethodUdf(
                    wrapper, init_args, init_kwargs, name, rd, meta["batch"],
                    **wrapper.options,
                )

    def __getattr__(self, name: str):
        if name in self._udfs:
            return self._udfs[name]
        raise AttributeError(name)

    def __call__(self, *args, **kwargs) -> Expression:
        if "__call__" in self._udfs:
            return self._udfs["__call__"](*args, **kwargs)
        raise DaftValueError(
            f"{self._wrapper.cls.__name__} has no @daft.method-decorated __call__"
        )


def cls(_cls=None, *, max_concurrency: Optional[int] = None, cpus: Optional[float] = None,
        gpus: Optional[float] = None, tpus: Optional[float] = None,
        memory_bytes: Optional[int] = None, max_retries: int = 0,
        on_error: str = "raise", batch_size: Optional[int] = None,
        use_process: bool = False):
    """Stateful UDF class decorator (reference: @daft.cls, daft/udf/__init__.py)."""
    options = dict(max_concurrency=max_concurrency, cpus=cpus, gpus=gpus, tpus=tpus,
                   memory_bytes=memory_bytes, max_retries=max_retries, on_error=on_error,
                   batch_size=batch_size, use_process=use_process)

    def deco(c):
        return _ClsWrapper(c, options)

    return deco(_cls) if _cls is not None else deco
