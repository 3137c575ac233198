"""AI expression functions (port of ``daft_tpu/functions/ai.py``).

Reference: daft/functions/ai/__init__.py (embed_image:157) — resolve a
provider, get a protocol descriptor, and wrap it into a stateful batch UDF.
This slice ports ``embed_image`` over fixed-shape image columns. Not ported yet: ``embed_text``, ``classify_text``,
``classify_image``, ``prompt``/``llm_generate``, uint8 tensor columns, and
decoding of variable-shape ``Image`` and encoded-bytes columns.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np

from daft_tpu_torch.ai.provider import load_provider
from daft_tpu_torch.datatype import DataType, TypeId
from daft_tpu_torch.errors import DaftTypeError
from daft_tpu_torch.expressions.expression import Expression
from daft_tpu_torch.series import Series
from daft_tpu_torch.udf import Udf


class _ProtocolUdf(Udf):
    """Batch UDF over a lazily-instantiated protocol implementation.

    The instance (model weights in device memory) is created once, on the
    first batch — the actor-pool replica pattern (reference:
    daft/ai/_expressions.py + @daft.cls wrapping in functions/ai).
    """

    def __init__(self, descriptor, call, return_dtype: DataType, name: str):
        self._descriptor = descriptor
        self._call = call
        self._instance = None
        self._instance_lock = threading.Lock()
        udf_opts = descriptor.get_udf_options()

        def fn(*series):
            # Device-batch chunking lives inside the protocol impls; here we
            # just hand over the morsel.
            return self._call(self._get_instance(), *series)

        fn.__name__ = name
        super().__init__(fn, return_dtype, name=name, batch_size=udf_opts.batch_size)

    def _get_instance(self):
        if self._instance is None:
            with self._instance_lock:
                if self._instance is None:
                    self._instance = self._descriptor.instantiate()
        return self._instance


def _images_to_numpy(series: Series, size: int) -> np.ndarray:
    """A dense (B, size, size, 3) uint8 batch from a fixed-shape image Series.
    Columns of the model's size are zero-copy reshapes; other sizes
    host-resize (PIL) first, matching the reference's preprocessing step."""
    dt = series.dtype
    if dt.id != TypeId.FIXED_SHAPE_IMAGE:
        raise DaftTypeError(f"embed_image takes a fixed-shape image column, got {dt!r}")
    vals, _ = series.to_numpy_masked()
    h, w, c = dt.shape
    if (h, w) != (size, size) or c != 3:
        vals = _host_resize_batch(vals, size)
    return np.ascontiguousarray(vals)


def _host_resize_batch(vals: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image as PILImage

    out = np.zeros((vals.shape[0], size, size, 3), dtype=np.uint8)
    for i in range(vals.shape[0]):
        arr = vals[i]
        img = PILImage.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr[..., :3])
        out[i] = np.asarray(img.convert("RGB").resize((size, size), PILImage.BILINEAR))
    return out


def embed_image(image: Expression, *, provider: Union[str, object, None] = None,
                model: Optional[str] = None, **options) -> Expression:
    """Embed an image column (reference: daft/functions/ai/__init__.py:157).
    The default provider is ``cuda``; ``device="cpu"`` runs it on the CPU."""
    p = load_provider(provider)
    desc = p.get_image_embedder(model, **options)
    dims = desc.get_dimensions() or 768
    dtype = DataType.embedding(DataType.float32(), dims)

    def call(inst, series: Series) -> Series:
        batch = _images_to_numpy(series, inst.cfg.image_size)
        return Series.from_numpy(inst.embed_image(batch), "embedding", dtype)

    return _ProtocolUdf(desc, call, dtype, "embed_image")(image)
