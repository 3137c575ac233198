"""Binary kernels (port of ``daft_tpu/kernels/binary_ops.py``; reference:
src/daft-functions-binary). Host Arrow compute, as in the JAX package, and the
``monotonically_increasing_id`` marker that ``DetectMonotonicId`` rewrites."""

from __future__ import annotations

import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.kernels.registry import register_kernel, returns
from daft_tpu_torch.series import Series

_BIN = DataType.binary()


@register_kernel("binary_length", returns(DataType.uint64()))
def _binary_length(args, **kwargs):
    out = pc.binary_length(args[0].to_arrow())
    return Series.from_arrow(out.cast(pa.uint64()), args[0].name, DataType.uint64())


@register_kernel("binary_concat", returns(_BIN))
def _binary_concat(args, **kwargs):
    out = pc.binary_join_element_wise(args[0].to_arrow(), args[1].cast(_BIN).to_arrow(),
                                      pa.scalar(b"", pa.large_binary()))
    return Series.from_arrow(out, args[0].name, _BIN)


@register_kernel("binary_slice", returns(_BIN))
def _binary_slice(args, length=None, **kwargs):
    start = int(args[1].scalar())
    stop = None if length is None else start + int(length)
    out = [None if v is None else v[start:stop] for v in args[0].to_pylist()]
    return Series.from_pylist(out, args[0].name, _BIN)


def _monotonic_id_field(fields, kwargs):
    from daft_tpu_torch.schema import Field

    return Field("id", DataType.uint64())  # zero-arg: no input field to rename


@register_kernel("monotonically_increasing_id", _monotonic_id_field)
def _monotonic_id_marker(args, **kwargs):
    from daft_tpu_torch.errors import DaftPlanError

    raise DaftPlanError(
        "monotonically_increasing_id() must be rewritten by the optimizer "
        "(DetectMonotonicId); it cannot be evaluated as a row expression")
