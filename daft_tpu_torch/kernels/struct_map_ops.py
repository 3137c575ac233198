"""Struct and map kernels (port of ``daft_tpu/kernels/struct_map_ops.py``;
reference: struct/map ops in src/daft-core). Host Arrow, as in the JAX package."""

from __future__ import annotations

import pyarrow.compute as pc

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftTypeError
from daft_tpu_torch.kernels.registry import register_kernel
from daft_tpu_torch.schema import Field
from daft_tpu_torch.series import Series


def _struct_get_resolver(fields, kwargs):
    f = fields[0]
    if not f.dtype.is_struct():
        raise DaftTypeError(f"struct.get on non-struct {f.dtype!r}")
    name = kwargs["name"]
    inner = f.dtype.fields.get(name)
    if inner is None:
        raise DaftTypeError(f"Struct has no field {name!r}")
    return Field(name, inner)


@register_kernel("struct_get", _struct_get_resolver)
def _struct_get(args, name: str = "", **kwargs):
    s = args[0]
    out = pc.struct_field(s.to_arrow(), name)
    return Series.from_arrow(out, name, s.dtype.fields[name])


def _map_get_resolver(fields, kwargs):
    f = fields[0]
    if not f.dtype.is_map():
        raise DaftTypeError(f"map.get on non-map {f.dtype!r}")
    return Field("value", f.dtype._params[1])


@register_kernel("map_get", _map_get_resolver)
def _map_get(args, **kwargs):
    s = args[0]
    key = args[1].scalar()
    value_dtype = s.dtype._params[1]
    out = []
    for row in s.to_arrow().to_pylist():
        if row is None:
            out.append(None)
            continue
        val = None
        for k, v in row:
            if k == key:
                val = v
                break
        out.append(val)
    return Series.from_pylist(out, "value", value_dtype)


@register_kernel("map_keys",
                 lambda f, k: Field(f[0].name, DataType.list(f[0].dtype._params[0])))
def _map_keys(args, **kwargs):
    """Map -> list of keys per row (reference: daft/functions/misc.py map_keys)."""
    s = args[0]
    out = [None if row is None else [k for k, _ in row]
           for row in s.to_arrow().to_pylist()]
    return Series.from_pylist(out, s.name, DataType.list(s.dtype._params[0]))


@register_kernel("map_values",
                 lambda f, k: Field(f[0].name, DataType.list(f[0].dtype._params[1])))
def _map_values(args, **kwargs):
    """Map -> list of values per row (reference: misc.py map_values)."""
    s = args[0]
    out = [None if row is None else [v for _, v in row]
           for row in s.to_arrow().to_pylist()]
    return Series.from_pylist(out, s.name, DataType.list(s.dtype._params[1]))


def _pack_struct_resolver(fields, kwargs):
    names = kwargs.get("names") or [f.name for f in fields]
    return Field("struct", DataType.struct({n: f.dtype for n, f in zip(names, fields)}))


@register_kernel("pack_struct", _pack_struct_resolver)
def _pack_struct(args, names=None, **kwargs):
    """N columns -> one struct column (reference: daft/functions/struct.py
    to_struct)."""
    import pyarrow as pa

    names = names or [s.name for s in args]
    dt = DataType.struct({n: s.dtype for n, s in zip(names, args)})
    arrays = [s.to_arrow() for s in args]
    # combine_chunks: StructArray.from_arrays needs contiguous arrays.
    arrays = [a.combine_chunks() if isinstance(a, pa.ChunkedArray) else a
              for a in arrays]
    out = pa.StructArray.from_arrays(arrays, names=list(names))
    return Series.from_arrow(out.cast(dt.to_arrow()), "struct", dt)


def _select_only(marker: str):
    def resolver(fields, kwargs):
        raise DaftTypeError(
            f"{marker}() is only valid as a top-level expression in "
            f"select()/projections, where it expands structurally; it cannot "
            f"be nested inside other expressions or used in filters")
    return resolver


@register_kernel("unnest", _select_only("unnest"))
def _unnest_marker(args, **kwargs):
    raise DaftTypeError("unreachable: unnest resolves structurally")


@register_kernel("explode", _select_only("explode"))
def _explode_marker(args, **kwargs):
    raise DaftTypeError("unreachable: explode resolves structurally")
