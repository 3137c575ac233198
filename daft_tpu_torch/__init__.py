"""daft_tpu_torch: the PyTorch/CUDA port of daft_tpu, for one NVIDIA H100.

The JAX package ``daft_tpu`` is the reference; this package mirrors its layout
module for module, imports ``torch`` (never ``jax`` nor anything of
``daft_tpu``), and runs its entry points on the GPU unless the caller passes
``device="cpu"``. The port goes slice by slice; it carries the engine's main
path — ``from_pydict`` → ``with_column(embed_image(...))`` → results — with the
CLIP image tower's attention in a hand-written CUDA kernel
(``ops/flash_attention.py``, ``csrc/flash_attention.cu``), the text, zero-shot
and generation paths, and the relational device layer (``where``,
``with_columns``, global ``agg`` through ``ops/device_eval.py`` and
``ops/compiled_eval.py``), and local files through ``read_parquet`` /
``read_csv`` / ``read_json`` / ``read_text`` / ``read_warc`` /
``from_glob_path`` and the ``DataFrame.write_*`` writers, and the expression
library (``.str``, ``.dt``, ``.binary``, ``url.parse``, ``is_in``,
``fill_null`` and ``daft_tpu_torch.functions``) on the host, SQL (``sql``,
``sql_expr``) through the optimizer's full rule set, windows (``Window``,
``Expression.over``), the remaining operators (``explode``, ``pivot``,
``unpivot``, ``sample``, ``repartition``) and the ``.list`` / ``.struct`` /
``.map`` namespaces, and the DataFrame surface: the constructors
(``from_pylist``, ``from_arrow``, ``from_pandas``, ``range``), the preview
and the exporters (``to_arrow``, ``to_pandas``, ``to_torch_*``), the UDF
decorators (``func``, ``func.batch``, ``cls``, ``method``) and the UDAFs
(``udf.udaf``), the media functions and the media sources (``read_mcap``,
``read_video_frames``, ``from_files``). Names of the
JAX package's top level that the port lacks raise ``AttributeError`` naming
their ROADMAP item. ``ROADMAP.md`` lists what is still to port.
"""

from daft_tpu_torch.cancellation import cancel_query
from daft_tpu_torch.context import (
    execution_config_ctx,
    get_context,
    planning_config_ctx,
    set_execution_config,
    set_planning_config,
)
from daft_tpu_torch.dataframe import DataFrame
from daft_tpu_torch.dataframe.creation import from_arrow, from_pandas, from_pydict, from_pylist
from daft_tpu_torch.datatype import DataType, ImageFormat, ImageMode, TimeUnit
from daft_tpu_torch.errors import (
    DaftAdmissionError,
    DaftCancelledError,
    DaftError,
    DaftTimeoutError,
)
from daft_tpu_torch.expressions import Expression, col, element, interval, lit
from daft_tpu_torch.io.config import IOConfig
from daft_tpu_torch.io.iostats import chunked_upload, io_stats, read_range, reset_io_stats
from daft_tpu_torch.io.reads import (
    from_glob_path,
    read_csv,
    read_json,
    read_parquet,
    read_text,
    read_warc,
)
from daft_tpu_torch.io.sink import DataSink
from daft_tpu_torch.io.source import DataSource, DataSourceTask, read_source
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series
from daft_tpu_torch.sql import sql, sql_expr
from daft_tpu_torch.window import Window

__version__ = "0.1.0"

#: The storage configs beside ``IOConfig`` (``io/config.py``), resolved lazily.
_IO_CONFIGS = ("S3Config", "S3Credentials", "GCSConfig", "AzureConfig", "HTTPConfig",
               "CosConfig", "TosConfig", "GooseFSConfig", "GravitinoConfig", "UnityConfig",
               "HuggingFaceConfig")

#: The sources of ``io/media_sources.py``, resolved lazily.
_MEDIA_SOURCES = ("read_mcap", "read_kafka", "read_paimon", "read_video_frames", "from_files")

#: Names of the JAX package's top level that the port lacks, by ROADMAP item.
_NOT_PORTED = {
    **dict.fromkeys(("read_iceberg", "read_deltalake", "read_lance", "read_hudi", "read_sql",
                     "read_huggingface"), "A.8 (the table formats and connectors)"),
    **dict.fromkeys(("Session", "current_session", "Catalog", "set_runner_native",
                     "register_table", "submit_query", "invalidate_cache_path",
                     "recent_queries"), "A.8 (sessions, catalogs, runners, the plan cache, "
                                        "the query service and the flight recorder)"),
    **dict.fromkeys(("set_tenant", "current_tenant", "set_tenant_policy", "TenantPolicy",
                     "set_request_priority"), "A.8 (admission)"),
    **dict.fromkeys(("register_view", "read_view", "view_freshness", "get_view_registry"),
                    "A.8 (streaming views)"),
}


def __getattr__(name: str):
    # Lazy imports keep `import daft_tpu_torch` light and cycle-free.
    if name == "range":
        from daft_tpu_torch.dataframe.creation import range as range_

        return range_
    if name == "File":
        from daft_tpu_torch.io.file import File

        return File
    if name in _IO_CONFIGS:
        from daft_tpu_torch.io import config as io_config

        return getattr(io_config, name)
    if name in ("func", "cls", "method", "udf"):
        import daft_tpu_torch.udf as udf

        return udf if name == "udf" else getattr(udf, name)
    if name in _MEDIA_SOURCES:
        from daft_tpu_torch.io import media_sources

        return getattr(media_sources, name)
    if name == "functions":
        import daft_tpu_torch.functions as functions

        return functions
    if name in _NOT_PORTED:
        raise AttributeError(f"module 'daft_tpu_torch' has no attribute {name!r}: it is not "
                             f"ported yet, ROADMAP {_NOT_PORTED[name]}")
    raise AttributeError(f"module 'daft_tpu_torch' has no attribute {name!r}")


__all__ = [
    "DaftAdmissionError",
    "DaftCancelledError",
    "DaftError",
    "DaftTimeoutError",
    "DataFrame",
    "DataSink",
    "DataSource",
    "DataSourceTask",
    "DataType",
    "Expression",
    "Field",
    "File",
    "IOConfig",
    "ImageFormat",
    "ImageMode",
    "MicroPartition",
    "RecordBatch",
    "Schema",
    "Series",
    "TimeUnit",
    "Window",
    "cancel_query",
    "chunked_upload",
    "col",
    "element",
    "execution_config_ctx",
    "from_arrow",
    "from_glob_path",
    "from_pandas",
    "from_pydict",
    "from_pylist",
    "functions",
    "get_context",
    "interval",
    "io_stats",
    "lit",
    "planning_config_ctx",
    "range",
    "read_csv",
    "read_json",
    "read_parquet",
    "read_range",
    "read_source",
    "read_text",
    "read_warc",
    "reset_io_stats",
    "set_execution_config",
    "set_planning_config",
    "sql",
    "sql_expr",
    "udf",
    *_IO_CONFIGS,
]
