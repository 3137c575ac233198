"""Numeric scalar kernels (port of ``daft_tpu/kernels/numeric.py``).

The host side uses Arrow C++ compute and numpy, as the JAX package does; each
kernel also carries a torch lowering that the relational device layer runs on
device tensors (the reference's equivalents are per-array Rust kernels,
src/daft-core/src/array/ops/*).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from daft_tpu_torch.datatype import DataType, unify_dtypes
from daft_tpu_torch.kernels.registry import (
    as_tensor_like,
    float_preserving,
    register_kernel,
    same_dtype,
)
from daft_tpu_torch.series import Series


def _unary_numpy(np_fn):
    def fn(args, **kwargs):
        s = args[0]
        vals, mask = s.to_numpy_masked()
        dtype = np.float32 if s.dtype == DataType.float32() else np.float64
        with np.errstate(all="ignore"):
            out = np_fn(vals.astype(dtype))
        return Series.from_numpy(out, s.name)._with_mask(mask)

    return fn


def _reg_float(name, np_fn, torch_op):
    register_kernel(name, float_preserving, torch_fn=lambda a: torch_op(a[0]))(_unary_numpy(np_fn))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE sqrt. torch's f32 sqrt on a CPU tensor is one ulp off the
    correctly rounded result on some inputs (about 0.7% of |N(0, 4^2)|);
    taking it in f64 and rounding to f32 is exact (double rounding is
    harmless for sqrt from binary64), so the device route equals the host's
    ``np.sqrt`` bit for bit. On CUDA, ``torch.sqrt`` is already correctly
    rounded (``chip_smoke.py`` holds it against ``np.sqrt`` on 1,000,000
    values)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


_reg_float("sqrt", np.sqrt, _sqrt)
_reg_float("cbrt", np.cbrt, lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0))
_reg_float("exp", np.exp, torch.exp)
_reg_float("expm1", np.expm1, torch.expm1)
_reg_float("ln", np.log, torch.log)
_reg_float("log1p", np.log1p, torch.log1p)
_reg_float("log2", np.log2, torch.log2)
_reg_float("log10", np.log10, torch.log10)
_reg_float("sin", np.sin, torch.sin)
_reg_float("cos", np.cos, torch.cos)
_reg_float("tan", np.tan, torch.tan)
_reg_float("asin", np.arcsin, torch.asin)
_reg_float("acos", np.arccos, torch.acos)
_reg_float("atan", np.arctan, torch.atan)
_reg_float("sinh", np.sinh, torch.sinh)
_reg_float("cosh", np.cosh, torch.cosh)
_reg_float("tanh", np.tanh, torch.tanh)


@register_kernel("log", float_preserving,
                 torch_fn=lambda a, base=None: torch.log(a[0]) / math.log(base))
def _log(args, base=None, **kwargs):
    s = args[0]
    vals, mask = s.to_numpy_masked()
    with np.errstate(all="ignore"):
        out = np.log(vals.astype(np.float64)) / np.log(base)
    return Series.from_numpy(out, s.name)._with_mask(mask)


@register_kernel("atan2", float_preserving,
                 torch_fn=lambda a: torch.atan2(as_tensor_like(a[0], a[1]), as_tensor_like(a[1], a[0])))
def _atan2(args, **kwargs):
    y, x = args[0], args[1]
    vals_y, mask = y.to_numpy_masked()
    vals_x, mask_x = x.to_numpy_masked()
    out = np.arctan2(vals_y.astype(np.float64), vals_x.astype(np.float64))
    if mask is None:
        mask = mask_x
    elif mask_x is not None:
        mask = mask | mask_x
    return Series.from_numpy(out, y.name)._with_mask(mask)


def _if_float(op):
    """``op`` on float tensors; integer tensors pass through (jnp's ceil,
    floor and round return integer input unchanged)."""
    return lambda a, **kw: op(a[0], **kw) if a[0].is_floating_point() else a[0]


@register_kernel("ceil", same_dtype, torch_fn=_if_float(torch.ceil))
def _ceil(args, **kwargs):
    s = args[0]
    if s.dtype.is_integer():
        return s
    return Series.from_arrow(pc.ceil(s.to_arrow()), s.name, s.dtype)


@register_kernel("floor", same_dtype, torch_fn=_if_float(torch.floor))
def _floor(args, **kwargs):
    s = args[0]
    if s.dtype.is_integer():
        return s
    return Series.from_arrow(pc.floor(s.to_arrow()), s.name, s.dtype)


@register_kernel("round", same_dtype, torch_fn=_if_float(torch.round))
def _round(args, decimals: int = 0, **kwargs):
    s = args[0]
    if s.dtype.is_integer():
        return s
    return Series.from_arrow(
        pc.round(s.to_arrow(), ndigits=decimals, round_mode="half_to_even"), s.name, s.dtype
    )


def _sign_torch(a):
    x = a[0]
    # jnp.sign keeps NaN; torch.sign maps it to 0.
    return torch.where(torch.isnan(x), x, torch.sign(x)) if x.is_floating_point() else torch.sign(x)


@register_kernel("sign", same_dtype, torch_fn=_sign_torch)
def _sign(args, **kwargs):
    s = args[0]
    return Series.from_arrow(pc.sign(s.to_arrow()).cast(s.dtype.to_arrow()), s.name, s.dtype)


def _clip_torch(a, min=None, max=None):
    if min is None and max is None:
        return a[0]
    return torch.clamp(a[0], min, max)


@register_kernel("clip", same_dtype, torch_fn=_clip_torch)
def _clip(args, min=None, max=None, **kwargs):
    s = args[0]
    vals, mask = s.to_numpy_masked()
    out = np.clip(vals, min, max)
    return Series.from_numpy(out, s.name, s.dtype)._with_mask(mask)


def _promoted_dtype(fields, kwargs):
    """Common supertype across args (null-typed args unify away)."""
    unified = functools.reduce(unify_dtypes, (f.dtype for f in fields))
    return fields[0].with_dtype(unified)


def _elementwise_fold(pc_fn):
    def fn(args, **kwargs):
        # Null-typed args (literal NULL) contribute nothing: SQL
        # GREATEST/LEAST ignore NULLs (skip_nulls=True below).
        live = [s for s in args
                if s.dtype.is_python() or not pa.types.is_null(s.to_arrow().type)]
        if not live:
            return args[0]
        # Cast every arg to the unified dtype the resolver declared: arrow's
        # implicit promotion can't bridge e.g. (bool, int64) and mixed inputs
        # would otherwise raise or return a dtype off the planned schema.
        unified = functools.reduce(unify_dtypes, (s.dtype for s in live))
        if unified.is_python():
            # Non-promotable mix (e.g. bool/int64): per-row Python fold,
            # skipping NULLs like the arrow kernels do.
            pick = max if pc_fn is pc.max_element_wise else min
            rows = zip(*(s.to_pylist() for s in live))
            out_vals = [pick((v for v in row if v is not None), default=None)
                        for row in rows]
            return Series.from_pylist(out_vals, args[0].name, unified)
        arrs = [s.cast(unified).to_arrow() for s in live]
        # arrow has no bool kernel for {min,max}_element_wise: via uint8
        was_bool = pa.types.is_boolean(arrs[0].type)
        if was_bool:
            arrs = [a.cast(pa.uint8()) for a in arrs]
        out = pc_fn(*arrs) if len(arrs) > 1 else arrs[0]
        if was_bool:
            out = out.cast(pa.bool_())
        return Series.from_arrow(out, args[0].name)

    return fn


def _fold_torch(op):
    def fn(a):
        tensor = next((x for x in a if isinstance(x, torch.Tensor)), None)
        return functools.reduce(lambda x, y: op(as_tensor_like(x, tensor), as_tensor_like(y, tensor)), a)

    return fn


register_kernel("elementwise_max", _promoted_dtype,
                torch_fn=_fold_torch(torch.maximum))(_elementwise_fold(pc.max_element_wise))
register_kernel("elementwise_min", _promoted_dtype,
                torch_fn=_fold_torch(torch.minimum))(_elementwise_fold(pc.min_element_wise))
