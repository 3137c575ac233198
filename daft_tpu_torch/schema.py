"""Field and Schema (reference: src/daft-schema/src/{field.rs,schema.rs}).

Port of ``daft_tpu/schema.py``.

A Schema is an ordered, name-unique collection of Fields. Field names are
case-sensitive. Schemas are immutable; all "mutations" return new Schemas.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Union

import pyarrow as pa

from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.errors import DaftSchemaError


class Field:
    __slots__ = ("name", "dtype", "metadata")

    def __init__(self, name: str, dtype: DataType, metadata: Optional[dict] = None):
        self.name = str(name)
        self.dtype = dtype
        self.metadata = metadata or {}

    @staticmethod
    def create(name: str, dtype: DataType) -> "Field":
        return Field(name, dtype)

    def rename(self, name: str) -> "Field":
        return Field(name, self.dtype, self.metadata)

    def with_dtype(self, dtype: DataType) -> "Field":
        return Field(self.name, dtype, self.metadata)

    def to_arrow(self) -> pa.Field:
        return pa.field(self.name, self.dtype.to_arrow())

    @staticmethod
    def from_arrow(f: pa.Field) -> "Field":
        return Field(f.name, DataType.from_arrow(f.type), dict(f.metadata or {}))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Field) and self.name == other.name and self.dtype == other.dtype

    def __hash__(self) -> int:
        return hash((self.name, self.dtype))

    def __repr__(self) -> str:
        return f"{self.name}#{self.dtype!r}"


class Schema:
    __slots__ = ("_fields", "_index")

    def __init__(self, fields: Sequence[Field]):
        self._fields: List[Field] = list(fields)
        self._index: Dict[str, int] = {}
        for i, f in enumerate(self._fields):
            if f.name in self._index:
                raise DaftSchemaError(f"Duplicate field name in schema: {f.name!r}")
            self._index[f.name] = i

    # -- constructors -----------------------------------------------------
    @staticmethod
    def empty() -> "Schema":
        return Schema([])

    @staticmethod
    def from_fields(fields: Sequence[Field]) -> "Schema":
        return Schema(fields)

    @staticmethod
    def from_pydict(d: Dict[str, DataType]) -> "Schema":
        return Schema([Field(k, v) for k, v in d.items()])

    @staticmethod
    def from_arrow(schema: pa.Schema) -> "Schema":
        return Schema([Field.from_arrow(f) for f in schema])

    def to_arrow(self) -> pa.Schema:
        return pa.schema([f.to_arrow() for f in self._fields])

    # -- access -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._fields)

    def __iter__(self) -> Iterator[Field]:
        return iter(self._fields)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __getitem__(self, key: Union[str, int]) -> Field:
        if isinstance(key, int):
            return self._fields[key]
        idx = self._index.get(key)
        if idx is None:
            raise DaftSchemaError(
                f"Field {key!r} not found in schema with fields {self.column_names()}"
            )
        return self._fields[idx]

    def get(self, name: str) -> Optional[Field]:
        idx = self._index.get(name)
        return self._fields[idx] if idx is not None else None

    def index_of(self, name: str) -> int:
        idx = self._index.get(name)
        if idx is None:
            raise DaftSchemaError(
                f"Field {name!r} not found in schema with fields {self.column_names()}"
            )
        return idx

    def column_names(self) -> List[str]:
        return [f.name for f in self._fields]

    def names(self) -> List[str]:
        return self.column_names()

    def fields(self) -> List[Field]:
        return list(self._fields)

    def to_pydict(self) -> Dict[str, DataType]:
        return {f.name: f.dtype for f in self._fields}

    # -- transforms -------------------------------------------------------
    def select(self, names: Sequence[str]) -> "Schema":
        return Schema([self[n] for n in names])

    def exclude(self, names: Sequence[str]) -> "Schema":
        drop = set(names)
        return Schema([f for f in self._fields if f.name not in drop])

    def union(self, other: "Schema") -> "Schema":
        """Disjoint union; raises on duplicate names."""
        return Schema(self._fields + other._fields)

    def non_distinct_union(self, other: "Schema") -> "Schema":
        """Union keeping the left field on name collision (reference:
        Schema::non_distinct_union, src/daft-schema/src/schema.rs)."""
        fields = list(self._fields)
        for f in other:
            if f.name not in self._index:
                fields.append(f)
        return Schema(fields)

    def rename(self, mapping: Dict[str, str]) -> "Schema":
        return Schema([f.rename(mapping.get(f.name, f.name)) for f in self._fields])

    def apply_hints(self, hints: "Schema") -> "Schema":
        return Schema([
            hints.get(f.name) or f for f in self._fields
        ])

    def estimate_row_size_bytes(self) -> float:
        """Rough per-row byte estimate for memory budgeting (reference:
        schema size estimation used by scan task sizing)."""
        total = 0.0
        for f in self._fields:
            dt = f.dtype
            try:
                if dt.is_device_representable():
                    import numpy as np

                    shape = dt.shape
                    total += dt.to_numpy().itemsize * (int(np.prod(shape)) if shape else 1)
                elif dt.is_string() or dt.is_binary():
                    total += 32.0
                else:
                    total += 16.0
            except Exception:
                total += 16.0
        return max(total, 1.0)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Schema) and self._fields == other._fields

    def __hash__(self) -> int:
        return hash(tuple(self._fields))

    def __repr__(self) -> str:
        inner = ", ".join(repr(f) for f in self._fields)
        return f"Schema({inner})"

    def _truncated_table_string(self) -> str:
        names = ", ".join(f"{f.name} ({f.dtype!r})" for f in self._fields)
        return names
