"""User-defined functions (port of ``daft_tpu/udf/__init__.py``).

Reference: daft/udf/__init__.py. This slice ports the batch ``Udf`` the AI
functions build on: calling it builds a ``UdfCall`` expression, and the
executor's UDFProject operator evaluates it per morsel, handing ``fn`` whole
Series. ``max_concurrency`` morsels of one UDF run at once on a pool of the
UDF's own (``with_concurrency`` / ``override_options`` set it on a copy).
Not ported yet: row-wise UDFs, retries and ``on_error``, the accelerator asks
and ``chips_per_replica`` (ROADMAP A.10), the ``func`` / ``func.batch`` /
``cls`` / ``method`` decorators and ``udaf`` (A.2).
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, List, Optional

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.expressions.expr import UdfCall, ensure_expr
from daft_tpu_torch.expressions.expression import Expression
from daft_tpu_torch.series import Series


class Udf:
    """A callable batch-UDF descriptor; calling it builds a UdfCall expression."""

    def __init__(self, fn: Callable, return_dtype: DataType, name: Optional[str] = None,
                 batch_size: Optional[int] = None, max_concurrency: Optional[int] = None):
        self.fn = fn
        self.return_dtype = return_dtype
        self.name = name or getattr(fn, "__name__", "udf")
        self.batch_size = batch_size
        # Morsels evaluated at once (None or 1: one at a time); ``fn`` must
        # then be safe to call from that many threads.
        self.max_concurrency = max_concurrency
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs) -> Expression:
        exprs = [ensure_expr(a) for a in args]
        return Expression(UdfCall(self, exprs, kwargs))

    # -- engine-side evaluation ------------------------------------------
    def evaluate(self, args: List[Series], kwargs: dict) -> Series:
        out = self.fn(*args, **kwargs)
        return _coerce_output_batch(out, self.name, self.return_dtype)

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
