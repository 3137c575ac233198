"""daft_tpu_torch: the PyTorch/CUDA port of daft_tpu, for one NVIDIA H100.

The JAX package ``daft_tpu`` is the reference; this package mirrors its layout
module for module, imports ``torch`` (never ``jax`` nor anything of
``daft_tpu``), and runs its entry points on the GPU unless the caller passes
``device="cpu"``. The port goes slice by slice; this one carries the engine's
main path — ``from_pydict`` → ``with_column(embed_image(...))`` → results —
with the CLIP image tower's attention in a hand-written CUDA kernel
(``ops/flash_attention.py``, ``csrc/flash_attention.cu``). ``ROADMAP.md`` lists
what is still to port.
"""

from daft_tpu_torch.context import execution_config_ctx, get_context
from daft_tpu_torch.dataframe import DataFrame
from daft_tpu_torch.dataframe.creation import from_pydict
from daft_tpu_torch.datatype import DataType, ImageFormat, ImageMode, TimeUnit
from daft_tpu_torch.errors import DaftError
from daft_tpu_torch.expressions import Expression, col, lit
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.recordbatch import RecordBatch
from daft_tpu_torch.schema import Field, Schema
from daft_tpu_torch.series import Series

__all__ = [
    "DataFrame",
    "DataType",
    "DaftError",
    "Expression",
    "Field",
    "ImageFormat",
    "ImageMode",
    "MicroPartition",
    "RecordBatch",
    "Schema",
    "Series",
    "TimeUnit",
    "col",
    "execution_config_ctx",
    "from_pydict",
    "get_context",
    "lit",
]
