"""Float special-value kernels (port of ``daft_tpu/kernels/float_ops.py``;
reference: daft Expression.float namespace)."""

from __future__ import annotations

import pyarrow.compute as pc
import torch

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.kernels.registry import register_kernel, returns, same_dtype
from daft_tpu_torch.series import Series

_BOOL = DataType.bool()


@register_kernel("is_nan", returns(_BOOL), torch_fn=lambda a: torch.isnan(a[0]))
def _is_nan(args, **kwargs):
    return Series.from_arrow(pc.is_nan(args[0].to_arrow()), args[0].name, _BOOL)


@register_kernel("is_inf", returns(_BOOL), torch_fn=lambda a: torch.isinf(a[0]))
def _is_inf(args, **kwargs):
    return Series.from_arrow(pc.is_inf(args[0].to_arrow()), args[0].name, _BOOL)


@register_kernel("not_nan", returns(_BOOL), torch_fn=lambda a: ~torch.isnan(a[0]))
def _not_nan(args, **kwargs):
    return Series.from_arrow(pc.invert(pc.is_nan(args[0].to_arrow())), args[0].name, _BOOL)


@register_kernel("fill_nan", same_dtype)
def _fill_nan(args, **kwargs):
    s, fill = args[0], args[1].cast(args[0].dtype)
    arr = s.to_arrow()
    nan_mask = pc.is_nan(arr)
    f = fill.to_arrow()
    if len(fill) == 1:
        f = f[0]
    out = pc.if_else(nan_mask, f, arr)
    return Series.from_arrow(out, s.name, s.dtype)
