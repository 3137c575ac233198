"""Catalog / Table abstractions and the local implementations (port of
``daft_tpu/catalog.py``).

Reference: src/daft-catalog (the Catalog / Table traits and the in-memory
implementation, catalog.rs) and daft/catalog/__init__.py's ABCs.

``InMemoryCatalog`` holds ``MemoryTable`` s (and any ``Table`` handed to it);
``DirectoryCatalog`` serves a local warehouse directory whose parquet
subdirectories are ``ParquetTable`` s. A write through a table invalidates
the query caches under its path (``plancache.invalidate_path``). These
raise ``DaftNotImplementedError`` naming ROADMAP A.8.3, the table formats
and the cloud catalogs: a ``TableFormatTable`` (an iceberg, delta or hudi
directory, also when a ``DirectoryCatalog`` finds one),
``Catalog.from_iceberg``, ``from_glue``, ``from_unity``, ``from_s3tables``
and ``from_gravitino``. ``from_paimon`` and ``from_postgres`` raise as the
JAX package's do, naming the package they need.
"""

from __future__ import annotations

import fnmatch
import os
from typing import Dict, List, Optional

from daft_tpu_torch.errors import DaftNotImplementedError, DaftValueError
from daft_tpu_torch.schema import Schema

#: Where the catalogs and tables this module leaves out are ported.
_TABLE_FORMATS = "ROADMAP A.8.3 (the table formats and cloud catalogs)"


def _invalidate_cached_reads(path: str) -> None:
    """Catalog mutations are writes: drop every cached plan, result and scan
    rooted under the table's path. In-memory tables need no hook: their
    keys are partition identities, so a mutation makes a different key."""
    from daft_tpu_torch.plancache import invalidate_path

    invalidate_path(path)


class Table:
    """A named table: readable as a DataFrame, optionally writable."""

    name: str

    def read(self):
        raise NotImplementedError

    def schema(self) -> Schema:
        return self.read().schema

    def append(self, df) -> None:
        raise DaftValueError(f"Table {self.name!r} is read-only")

    def overwrite(self, df) -> None:
        raise DaftValueError(f"Table {self.name!r} is read-only")


class ViewTable(Table):
    """A table backed by a DataFrame (a temp view)."""

    def __init__(self, name: str, df):
        self.name = name
        self._df = df

    def read(self):
        return self._df


class MemoryTable(Table):
    """A mutable in-memory table."""

    def __init__(self, name: str, df=None, schema: Optional[Schema] = None):
        self.name = name
        self._parts = []
        self._schema = schema
        if df is not None:
            self.append(df)

    def read(self):
        from daft_tpu_torch.dataframe.dataframe import DataFrame
        from daft_tpu_torch.logical.builder import LogicalPlanBuilder
        from daft_tpu_torch.micropartition import MicroPartition

        if not self._parts:
            if self._schema is None:
                raise DaftValueError(f"Table {self.name!r} is empty with no schema")
            return DataFrame(LogicalPlanBuilder.in_memory(
                [MicroPartition.empty(self._schema)], self._schema))
        return DataFrame(LogicalPlanBuilder.in_memory(self._parts, self._parts[0].schema))

    def append(self, df) -> None:
        parts = list(df.iter_partitions())
        if parts:
            if self._schema is None:
                self._schema = parts[0].schema
            self._parts.extend(parts)

    def overwrite(self, df) -> None:
        self._parts = []
        self.append(df)


class ParquetTable(Table):
    """A table backed by parquet files at a local path."""

    def __init__(self, name: str, path: str):
        self.name = name
        self.path = path

    def read(self):
        from daft_tpu_torch.io.reads import read_parquet

        return read_parquet(self.path)

    def append(self, df) -> None:
        df.write_parquet(self.path)
        _invalidate_cached_reads(self.path)

    def overwrite(self, df) -> None:
        df.write_parquet(self.path, write_mode="overwrite")
        _invalidate_cached_reads(self.path)


class TableFormatTable(Table):
    """A table in an open table format (iceberg, delta, hudi) at a directory:
    its readers and writers are ROADMAP A.8.3."""

    def __init__(self, name: str, path: str, fmt: str):
        raise DaftNotImplementedError(
            f"table {name!r} at {path!r} is a {fmt} table; the table formats are not "
            f"ported to daft_tpu_torch yet: {_TABLE_FORMATS}")


class Catalog:
    """Catalog ABC (reference: daft/catalog Catalog)."""

    name: str = "catalog"

    def list_tables(self, pattern: Optional[str] = None) -> List[str]:
        raise NotImplementedError

    def get_table(self, name: str) -> Table:
        raise NotImplementedError

    def create_table(self, name: str, source=None) -> Table:
        raise NotImplementedError

    def drop_table(self, name: str) -> None:
        raise NotImplementedError

    def has_table(self, name: str) -> bool:
        try:
            self.get_table(name)
            return True
        except Exception:  # noqa: BLE001 — any lookup failure means "absent"
            return False


class InMemoryCatalog(Catalog):
    def __init__(self, name: str = "default"):
        self.name = name
        self._tables: Dict[str, Table] = {}

    def list_tables(self, pattern: Optional[str] = None) -> List[str]:
        names = sorted(self._tables)
        if pattern:
            names = [n for n in names if fnmatch.fnmatch(n, pattern)]
        return names

    def get_table(self, name: str) -> Table:
        if name not in self._tables:
            raise DaftValueError(f"Table {name!r} not found in catalog {self.name!r}")
        return self._tables[name]

    def create_table(self, name: str, source=None) -> Table:
        from daft_tpu_torch.dataframe.dataframe import DataFrame

        if isinstance(source, Table):
            t: Table = source
        elif isinstance(source, DataFrame):
            t = MemoryTable(name, source)
        elif isinstance(source, Schema):
            t = MemoryTable(name, schema=source)
        elif isinstance(source, dict):
            # Column data (reference: Catalog.from_pydict table values).
            from daft_tpu_torch.dataframe.creation import from_pydict

            t = MemoryTable(name, from_pydict(source))
        elif source is None:
            t = MemoryTable(name)
        else:
            raise DaftValueError(f"Cannot create table from {type(source)}")
        self._tables[name] = t
        return t

    def drop_table(self, name: str) -> None:
        self._tables.pop(name, None)


def _sniff_table_format(path: str) -> Optional[str]:
    """The open table format of a directory, by its metadata layout."""
    meta = os.path.join(path, "metadata")
    if os.path.isdir(meta) and any(
            f.endswith(".metadata.json") or f == "version-hint.text" for f in os.listdir(meta)):
        return "iceberg"
    if os.path.isdir(os.path.join(path, "_delta_log")):
        return "delta"
    if os.path.isdir(os.path.join(path, ".hoodie")):
        return "hudi"
    import glob as _glob

    if _glob.glob(os.path.join(path, "*.parquet")) or _glob.glob(
            os.path.join(path, "**", "*.parquet"), recursive=True):
        return "parquet"
    return None


class DirectoryCatalog(Catalog):
    """A local warehouse directory whose subdirectories are tables: plain
    parquet is read and written here; an iceberg, delta or hudi
    subdirectory raises naming ROADMAP A.8.3 when it is opened."""

    def __init__(self, warehouse: str, name: str = "warehouse"):
        self.name = name
        self.warehouse = warehouse

    def list_tables(self, pattern: Optional[str] = None) -> List[str]:
        if not os.path.isdir(self.warehouse):
            return []
        out = []
        for entry in sorted(os.listdir(self.warehouse)):
            p = os.path.join(self.warehouse, entry)
            if os.path.isdir(p) and _sniff_table_format(p):
                out.append(entry)
        if pattern:
            out = [n for n in out if fnmatch.fnmatch(n, pattern)]
        return out

    def get_table(self, name: str) -> Table:
        p = os.path.join(self.warehouse, name)
        fmt = _sniff_table_format(p) if os.path.isdir(p) else None
        if fmt is None:
            raise DaftValueError(f"Table {name!r} not found in warehouse {self.warehouse!r}")
        if fmt == "parquet":
            return ParquetTable(name, p)
        return TableFormatTable(name, p, fmt)

    def create_table(self, name: str, source=None) -> Table:
        p = os.path.join(self.warehouse, name)
        os.makedirs(p, exist_ok=True)
        t = ParquetTable(name, p)
        if source is not None and not isinstance(source, Schema):
            t.append(source)
        return t

    def drop_table(self, name: str) -> None:
        import shutil

        p = os.path.join(self.warehouse, name)
        if os.path.isdir(p):
            shutil.rmtree(p)
            _invalidate_cached_reads(p)


def _from_pydict(tables, name: str = "default") -> Catalog:
    """An in-memory catalog from {name: DataFrame | Table | Schema | dict}
    (reference: daft/catalog/__init__.py Catalog.from_pydict)."""
    cat = InMemoryCatalog(name)
    for tname, obj in tables.items():
        cat.create_table(str(tname), obj)
    return cat


def _left_out(kind: str):
    def raise_left_out(*args, **kwargs):
        raise DaftNotImplementedError(
            f"Catalog.from_{kind} is not ported to daft_tpu_torch yet: {_TABLE_FORMATS}")

    return staticmethod(raise_left_out)


def _gated_catalog(kind: str, dep: str):
    raise DaftValueError(
        f"Catalog.from_{kind} requires the {dep} package/service, which is "
        f"not available in this environment")


Catalog.from_pydict = staticmethod(_from_pydict)
for _kind in ("iceberg", "glue", "unity", "s3tables", "gravitino"):
    setattr(Catalog, f"from_{_kind}", _left_out(_kind))
Catalog.from_paimon = staticmethod(lambda *a, **k: _gated_catalog("paimon", "pypaimon"))
Catalog.from_postgres = staticmethod(lambda *a, **k: _gated_catalog("postgres", "psycopg2"))
