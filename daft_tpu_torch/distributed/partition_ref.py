"""The wire-table form of a partition (port of
``daft_tpu/distributed/partition_ref.py:169-217``).

Spill files (``execution/spill.py``) hold partitions in this form: the
schema rides in the Arrow schema's metadata, so logical types (images,
embeddings, tensors, files) survive the disk, and Python-object columns,
which Arrow cannot hold, travel as per-row pickled binary. The JAX package
pickles with ``cloudpickle``; the port uses the standard ``pickle``, since a
spill file never leaves the process that wrote it (and so holds nothing
another process wrote).

The rest of the module (partition references, shuffle fetches) belongs to
the distributed layer, ROADMAP A.8.
"""

from __future__ import annotations

import pickle
from typing import Optional

import pyarrow as pa

from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Schema

_SCHEMA_KEY = b"daft_schema"


def partition_to_wire_table(mp: MicroPartition) -> pa.Table:
    """``mp`` as an Arrow table with its schema in the metadata."""
    if any(f.dtype.is_python() for f in mp.schema):
        rb = mp.combined()
        arrays = {}
        for c in rb.columns():
            arrays[c.name] = (pa.array([pickle.dumps(v) for v in c.to_pylist()],
                                       pa.large_binary())
                              if c.dtype.is_python() else c.to_arrow())
        table = pa.table(arrays)
    else:
        table = mp.to_arrow_table()
    return table.replace_schema_metadata(
        {**(table.schema.metadata or {}), _SCHEMA_KEY: pickle.dumps(mp.schema)})


def partition_from_wire_table(table: pa.Table,
                              schema: Optional[Schema] = None) -> MicroPartition:
    """The partition :func:`partition_to_wire_table` made; ``schema`` in
    place of the one in the metadata, when given."""
    from daft_tpu_torch.series import Series

    if schema is None and table.schema.metadata and _SCHEMA_KEY in table.schema.metadata:
        schema = pickle.loads(table.schema.metadata[_SCHEMA_KEY])
    if schema is not None and any(f.dtype.is_python() for f in schema):
        cols = []
        for f in schema:
            arr = table.column(f.name)
            if f.dtype.is_python():
                vals = [None if b is None else pickle.loads(b) for b in arr.to_pylist()]
                cols.append(Series.from_pylist(vals, f.name, f.dtype))
            else:
                cols.append(Series.from_arrow(arr.combine_chunks(), f.name, f.dtype))
        return MicroPartition(schema, [RecordBatch(schema, cols, table.num_rows)])
    return MicroPartition.from_arrow_table(table, schema)
