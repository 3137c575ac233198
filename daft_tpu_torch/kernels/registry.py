"""Scalar-function kernel registry (port of ``daft_tpu/kernels/registry.py``).

Reference: the reference registers scalar functions into a ``FunctionRegistry``
keyed by name (src/daft-dsl/src/functions/scalar.rs). Each kernel bundles a
host implementation over Series with a field resolver; kernels the device can
run also carry a torch lowering (``torch_fn``) that the relational device layer
calls on device tensors. The registry holds the kernels of ``numeric.py``,
``float_ops.py``, ``embedding_ops.py`` and ``extended_ops.py``; every other name of the JAX
package's registry is not ported yet and raises ``DaftNotImplementedError``
when a plan resolves it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from daft_tpu_torch.errors import DaftNotImplementedError
from daft_tpu_torch.schema import Field


class Kernel:
    __slots__ = ("name", "fn", "resolver", "torch_fn", "torch_same_rules")

    def __init__(
        self,
        name: str,
        fn: Callable,
        resolver: Callable[[List[Field], Dict[str, Any]], Field],
        torch_fn: Optional[Callable] = None,
        torch_same_rules: bool = False,
    ):
        self.name = name
        self.fn = fn                # (args: list[Series], **kwargs) -> Series
        self.resolver = resolver
        self.torch_fn = torch_fn    # (args: list[torch.Tensor], **kwargs) -> torch.Tensor
        # torch_same_rules: the host impl runs this same torch_fn (on the CPU)
        # and applies the any-input-null -> output-null rule, and its resolved
        # output dtype is the 32-bit result cast up. So the device path may
        # take the kernel even where that output is 64-bit, and on nullable
        # inputs. The JAX package's ``jax_exact`` also promised equal bits:
        # there the host impl ran the one jitted program on JAX's default
        # backend. Here a CPU and a CUDA program agree only within their
        # reductions' rounding (PERF.md states the measured gap).
        self.torch_same_rules = torch_same_rules

    def resolve(self, fields: List[Field], kwargs: Dict[str, Any]) -> Field:
        return self.resolver(fields, kwargs)

    def __call__(self, args, **kwargs):
        return self.fn(args, **kwargs)


_REGISTRY: Dict[str, Kernel] = {}


def register_kernel(name: str, resolver, torch_fn=None, torch_same_rules=False):
    """Decorator: register ``fn(args: list[Series], **kwargs) -> Series``."""

    def deco(fn):
        _REGISTRY[name] = Kernel(name, fn, resolver, torch_fn, torch_same_rules)
        return fn

    return deco


def get_kernel(name: str) -> Kernel:
    _ensure_loaded()
    k = _REGISTRY.get(name)
    if k is None:
        raise DaftNotImplementedError(f"function {name!r} is not ported to daft_tpu_torch")
    return k


def has_kernel(name: str) -> bool:
    _ensure_loaded()
    return name in _REGISTRY


_loaded = False
_load_lock = threading.Lock()


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    with _load_lock:
        if _loaded:
            return
        # Imported for their registrations; _loaded flips only after the
        # imports complete.
        from daft_tpu_torch.kernels import (  # noqa: F401
            embedding_ops,
            extended_ops,
            float_ops,
            numeric,
        )

        _loaded = True


# -- shared resolvers ------------------------------------------------------
def same_dtype(fields, kwargs):
    return fields[0]


def returns(dtype):
    def resolver(fields, kwargs):
        return fields[0].with_dtype(dtype)

    return resolver


def float_preserving(fields, kwargs):
    """float32 stays float32, everything else promotes to float64."""
    from daft_tpu_torch.datatype import DataType, TypeId

    dt = fields[0].dtype
    out = DataType.float32() if dt.id in (TypeId.FLOAT32, TypeId.BFLOAT16) else DataType.float64()
    return fields[0].with_dtype(out)


def as_tensor_like(value, like):
    """``value`` as a tensor on ``like``'s device: a Python scalar becomes a
    0-d tensor, which torch promotes like a weakly typed scalar (as jnp does
    a Python scalar), so it never widens ``like``'s dtype."""
    import torch

    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(value, device=like.device if isinstance(like, torch.Tensor) else None)
