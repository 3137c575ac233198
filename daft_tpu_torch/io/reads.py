"""Read entrypoints (port of ``daft_tpu/io/reads.py``; reference:
daft/io/__init__.py:72-86 read_* functions).

Every path resolves through ``io/scan.py::resolve_filesystem`` (local,
``file://``, ``s3://``, ``gs://``, ``http(s)://``, ``hf://``, ``az://``).
Not ported yet: the table formats (``read_iceberg``, ``read_deltalake``,
``read_hudi``), ``read_sql`` and ``read_lance`` (ROADMAP A.8.3).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from daft_tpu_torch.dataframe.dataframe import DataFrame
from daft_tpu_torch.io.formats import infer_schema
from daft_tpu_torch.io.scan import ScanInfo
from daft_tpu_torch.logical.builder import LogicalPlanBuilder
from daft_tpu_torch.schema import Schema


def _read(paths: Union[str, List[str]], file_format: str, schema: Optional[Schema],
          read_options: Optional[Dict[str, Any]] = None, io_config=None,
          hive_partitioning: bool = False) -> DataFrame:
    if isinstance(paths, str):
        paths = [paths]
    read_options = dict(read_options or {})
    if io_config is not None:
        read_options["io_config"] = io_config
    files = None
    part_fields = []
    if hive_partitioning:
        # Parse k=v path segments into typed partition values up front
        # (reference: src/daft-scan/src/hive.rs); the scan layer prunes
        # files against pushdown predicates and readers materialize the
        # partition columns as constants.
        from daft_tpu_torch.io.hive import attach_hive_partitions, dataset_roots
        from daft_tpu_torch.io.scan import glob_paths

        files = glob_paths(paths, read_options.get("io_config"))
        declared = {f.name: f.dtype for f in schema} if schema is not None else None
        part_fields = attach_hive_partitions(files, dataset_roots(paths), declared=declared)
    if schema is None:
        schema = infer_schema(paths, file_format, read_options, files=files)
    if part_fields:
        schema = Schema(list(schema) + [f for f in part_fields if f.name not in schema])
    info = ScanInfo(paths, file_format, schema, read_options, files=files)
    return DataFrame(LogicalPlanBuilder.scan(info))


def read_parquet(path: Union[str, List[str]], schema: Optional[Schema] = None,
                 io_config=None, hive_partitioning: bool = False, **kwargs) -> DataFrame:
    return _read(path, "parquet", schema, io_config=io_config,
                 hive_partitioning=hive_partitioning)


def read_csv(path: Union[str, List[str]], schema: Optional[Schema] = None,
             has_headers: bool = True, delimiter: str = ",", io_config=None,
             hive_partitioning: bool = False, **kwargs) -> DataFrame:
    return _read(path, "csv", schema, {"has_headers": has_headers, "delimiter": delimiter},
                 io_config=io_config, hive_partitioning=hive_partitioning)


def read_json(path: Union[str, List[str]], schema: Optional[Schema] = None,
              io_config=None, hive_partitioning: bool = False, **kwargs) -> DataFrame:
    return _read(path, "json", schema, io_config=io_config,
                 hive_partitioning=hive_partitioning)


def read_text(path: Union[str, List[str]], io_config=None, **kwargs) -> DataFrame:
    return _read(path, "text", None, io_config=io_config)


def from_glob_path(path: Union[str, List[str]], io_config=None) -> DataFrame:
    """List files matching a glob as a DataFrame of (path, size)
    (reference: daft.from_glob_path)."""
    from daft_tpu_torch.dataframe.creation import from_pydict
    from daft_tpu_torch.io.scan import glob_paths

    files = glob_paths([path] if isinstance(path, str) else list(path))
    return from_pydict({
        "path": [f.path for f in files],
        "size": [f.size_bytes for f in files],
    })


def read_warc(path, io_config=None, **kwargs):
    """Read WARC (Common Crawl) archives (reference: daft.read_warc)."""
    from daft_tpu_torch.datatype import DataType
    from daft_tpu_torch.schema import Field

    schema = Schema([
        Field("WARC-Record-ID", DataType.string()),
        Field("WARC-Type", DataType.string()),
        Field("WARC-Target-URI", DataType.string()),
        Field("WARC-Date", DataType.string()),
        Field("Content-Length", DataType.int64()),
        Field("warc_content", DataType.binary()),
    ])
    return _read(path, "warc", schema, io_config=kwargs.get("io_config") or io_config)


def read_huggingface(repo: str, io_config=None, **kwargs):
    """HuggingFace datasets (reference: daft.read_huggingface /
    daft/io/huggingface/__init__.py): repo-level paths list parquet files
    through the dataset-viewer API; file-level hf:// paths resolve to ranged
    HTTP reads (``io/http_source.py``)."""
    path = repo if repo.startswith("hf://") else f"hf://datasets/{repo}"
    return read_parquet(path, io_config=io_config, **kwargs)
