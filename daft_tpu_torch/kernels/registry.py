"""Scalar-function kernel registry (port of ``daft_tpu/kernels/registry.py``).

Reference: the reference registers scalar functions into a ``FunctionRegistry``
keyed by name (src/daft-dsl/src/functions/scalar.rs). Each kernel bundles a
host implementation over Series with a field resolver; kernels the device can
run also carry a torch lowering (``torch_fn``) that the relational device layer
calls on device tensors. The registry holds the kernels of ``numeric.py``,
``float_ops.py``, ``embedding_ops.py``, ``extended_ops.py``, ``string_ops.py``,
``temporal_ops.py``, ``binary_ops.py``, ``uri_ops.py``, ``misc_ops.py``,
``image_ops.py``, ``file_ops.py``, ``media_ops.py``, ``list_ops.py`` and
``struct_map_ops.py``. A name of the JAX package's registry
that the port leaves out is in ``LEFT_OUT`` with the ROADMAP item that ports
it, and ``get_kernel`` raises ``DaftNotImplementedError`` naming that item.
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


_REMOTE = "ROADMAP A.8 (remote IO)"

#: Every kernel of the JAX package's registry that the port does not hold,
#: with the ROADMAP item that brings it.
LEFT_OUT: Dict[str, str] = {
    "url_download": _REMOTE,
    "url_upload": _REMOTE,
}


def get_kernel(name: str) -> Kernel:
    _ensure_loaded()
    k = _REGISTRY.get(name)
    if k is None:
        if name in LEFT_OUT:
            raise DaftNotImplementedError(
                f"function {name!r} is not ported to daft_tpu_torch: {LEFT_OUT[name]}")
        raise DaftNotImplementedError(f"function {name!r} is not ported to daft_tpu_torch")
    return k


def has_kernel(name: str) -> bool:
    _ensure_loaded()
    return name in _REGISTRY


def all_kernels() -> Dict[str, Kernel]:
    _ensure_loaded()
    return dict(_REGISTRY)


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
            binary_ops,
            embedding_ops,
            extended_ops,
            file_ops,
            float_ops,
            image_ops,
            list_ops,
            media_ops,
            misc_ops,
            numeric,
            string_ops,
            struct_map_ops,
            temporal_ops,
            uri_ops,
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
