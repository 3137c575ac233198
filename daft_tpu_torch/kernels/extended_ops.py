"""Long-tail numeric kernels with a device lowering (port of the part of
``daft_tpu/kernels/extended_ops.py`` whose kernels carry a ``jax_fn``).

The host implementations are the JAX package's (numpy in f64, or Arrow
compute), with each kernel's own null rule. The torch lowering of each runs
on ``cfg.device`` through the relational device layer. None of them has the
same rules on both paths (``torch_same_rules``, the JAX package's
``jax_exact``), so the device takes them only where no input it reads is
nullable, and only at 32-bit outputs: ``cosine_similarity`` resolves to f64
and runs there only inside a 32-bit expression, as in the JAX package.

``pmod`` by 0 differs between the routes, as in the JAX package: the host
gives null, the device ``jnp.mod``'s value (0 for integers, NaN for floats;
ROADMAP C.26). Not ported yet: the string, binary, JSON, partition and
file kernels of that module, which have no device lowering.
"""

from __future__ import annotations

import math

import numpy as np
import pyarrow.compute as pc
import torch

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.kernels.registry import (
    as_tensor_like,
    float_preserving,
    register_kernel,
    returns,
    same_dtype,
)
from daft_tpu_torch.series import Series

_F64 = DataType.float64()


def _or_masks(am, bm):
    return am if bm is None else (bm if am is None else am | bm)


def _float_unary(name, np_fn, torch_fn):
    @register_kernel(name, float_preserving, torch_fn=lambda a: torch_fn(a[0]))
    def _k(args, **kwargs):
        vals, mask = args[0].to_numpy_masked()
        with np.errstate(all="ignore"):
            out = np_fn(vals.astype(np.float64))
        return Series.from_numpy(out, args[0].name)._with_mask(mask)
    return _k


# The scale constants round to the operand's dtype first, as jnp.radians and
# jnp.degrees do (a Python float is weakly typed in torch as in jnp).
_float_unary("csc", lambda x: 1.0 / np.sin(x), lambda x: 1.0 / torch.sin(x))
_float_unary("sec", lambda x: 1.0 / np.cos(x), lambda x: 1.0 / torch.cos(x))
_float_unary("cot", lambda x: 1.0 / np.tan(x), lambda x: 1.0 / torch.tan(x))
_float_unary("atanh", np.arctanh, torch.atanh)
_float_unary("acosh", np.arccosh, torch.acosh)
_float_unary("asinh", np.arcsinh, torch.asinh)
_float_unary("radians", np.radians, lambda x: x * (math.pi / 180.0))
_float_unary("degrees", np.degrees, lambda x: x * (180.0 / math.pi))


@register_kernel("negate", same_dtype, torch_fn=lambda a: -a[0])
def _negate(args, **kwargs):
    vals, mask = args[0].to_numpy_masked()
    return Series.from_numpy(-vals, args[0].name, args[0].dtype)._with_mask(mask)


@register_kernel("hypot", float_preserving,
                 torch_fn=lambda a: torch.hypot(as_tensor_like(a[0], a[1]),
                                                as_tensor_like(a[1], a[0])))
def _hypot(args, **kwargs):
    a, am = args[0].to_numpy_masked()
    b, bm = args[1].to_numpy_masked()
    return Series.from_numpy(np.hypot(a.astype(np.float64), b.astype(np.float64)),
                             args[0].name)._with_mask(_or_masks(am, bm))


def _pmod_torch(a):
    # jnp.mod: the device layer's ``%`` (XLA's values for a zero divisor).
    from daft_tpu_torch.ops.device_eval import _binary

    return _binary("mod", a[0], a[1])


@register_kernel("pmod", same_dtype, torch_fn=_pmod_torch)
def _pmod(args, **kwargs):
    a, am = args[0].to_numpy_masked()
    b, bm = args[1].to_numpy_masked()
    with np.errstate(all="ignore"):
        out = np.mod(a, np.where(b == 0, 1, b))
    mask = _or_masks(am, bm)
    mask = (b == 0) if mask is None else mask | (b == 0)
    return Series.from_numpy(out, args[0].name, args[0].dtype)._with_mask(mask)


def _bitwise(name, arrow_fn, torch_fn):
    @register_kernel(name, same_dtype, torch_fn=lambda a: torch_fn(a[0], a[1]))
    def _k(args, **kwargs):
        out = arrow_fn(args[0].to_arrow(), args[1].cast(args[0].dtype).to_arrow())
        return Series.from_arrow(out, args[0].name, args[0].dtype)
    return _k


_bitwise("bitwise_and", pc.bit_wise_and, lambda x, y: x & y)
_bitwise("bitwise_or", pc.bit_wise_or, lambda x, y: x | y)
_bitwise("bitwise_xor", pc.bit_wise_xor, lambda x, y: x ^ y)


@register_kernel("bitwise_not", same_dtype, torch_fn=lambda a: ~a[0])
def _bnot(args, **kwargs):
    return Series.from_arrow(pc.bit_wise_not(args[0].to_arrow()), args[0].name, args[0].dtype)


def _cos_sim_torch(a):
    x, y = a[0], a[1]
    den = torch.linalg.vector_norm(x, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
    return (x * y).sum(-1) / den.clamp(min=1e-12)


@register_kernel("cosine_similarity", returns(_F64), torch_fn=_cos_sim_torch)
def _cos_sim(args, **kwargs):
    a = args[0].to_numpy().astype(np.float64)
    b = args[1].to_numpy().astype(np.float64)
    if b.shape[0] == 1 and a.shape[0] != 1:
        b = np.broadcast_to(b, a.shape)
    num = (a * b).sum(-1)
    den = np.clip(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12, None)
    return Series.from_numpy(num / den, args[0].name, _F64)
