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
``.map`` namespaces. ``ROADMAP.md`` lists what is still to port.
"""

from daft_tpu_torch.context import execution_config_ctx, get_context
from daft_tpu_torch.dataframe import DataFrame
from daft_tpu_torch.dataframe.creation import from_pydict
from daft_tpu_torch.datatype import DataType, ImageFormat, ImageMode, TimeUnit
from daft_tpu_torch.errors import DaftError
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

__all__ = [
    "DataFrame",
    "DataType",
    "DaftError",
    "Expression",
    "DataSink",
    "DataSource",
    "DataSourceTask",
    "Field",
    "IOConfig",
    "ImageFormat",
    "ImageMode",
    "MicroPartition",
    "RecordBatch",
    "Schema",
    "Series",
    "TimeUnit",
    "Window",
    "chunked_upload",
    "col",
    "element",
    "execution_config_ctx",
    "from_glob_path",
    "from_pydict",
    "get_context",
    "interval",
    "io_stats",
    "lit",
    "read_csv",
    "read_json",
    "read_parquet",
    "read_range",
    "read_source",
    "read_text",
    "read_warc",
    "reset_io_stats",
    "sql",
    "sql_expr",
]
