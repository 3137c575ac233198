"""AI expression functions (port of ``daft_tpu/functions/ai.py``).

Reference: daft/functions/ai/__init__.py (embed_text:72, embed_image:157,
classify_text:250, classify_image:329, prompt:430) — resolve a provider, get
a protocol descriptor, and wrap it into a stateful batch UDF. Image columns
may be fixed-shape images, uint8 tensor / embedding / fixed-size-list
columns, variable-shape images or encoded bytes; the last two are decoded and
resized on the host with PIL, as the JAX package does.
"""

from __future__ import annotations

import io
import threading
from typing import Optional, Sequence, Union

import numpy as np

from daft_tpu_torch.ai.provider import load_provider
from daft_tpu_torch.datatype import DataType, ImageMode, TypeId
from daft_tpu_torch.errors import DaftTypeError
from daft_tpu_torch.expressions.expression import Expression
from daft_tpu_torch.series import Series
from daft_tpu_torch.udf import Udf


class _ProtocolUdf(Udf):
    """Batch UDF over a lazily-instantiated protocol implementation.

    The instance (model weights in device memory) is created on the first
    batch, one per replica slot: with ``chips_per_replica`` the executor
    runs each morsel inside a slot's scope, and the instance made there
    lives on that slot's devices (the actor-pool replica pattern; reference:
    daft/ai/_expressions.py + @daft.cls wrapping in functions/ai). Without
    it every morsel sees slot 0 and shares one instance.
    """

    def __init__(self, descriptor, call, return_dtype: DataType, name: str):
        self._descriptor = descriptor
        self._call = call
        self._instances: dict = {}
        self._instance_lock = threading.Lock()
        udf_opts = descriptor.get_udf_options()

        def fn(*series):
            # Device-batch chunking lives inside the protocol impls; here we
            # just hand over the morsel.
            return self._call(self._get_instance(), *series)

        fn.__name__ = name
        super().__init__(fn, return_dtype, batch=True, name=name,
                         batch_size=udf_opts.batch_size,
                         max_concurrency=udf_opts.max_concurrency,
                         tpus=udf_opts.tpus,
                         chips_per_replica=udf_opts.chips_per_replica)

    def _get_instance(self):
        """The instance of the current replica slot (``replica_id()``),
        made inside the slot's scope on its first morsel."""
        from daft_tpu_torch.parallel.replica import replica_id

        rid = replica_id()
        inst = self._instances.get(rid)
        if inst is None:
            with self._instance_lock:
                inst = self._instances.get(rid)
                if inst is None:
                    inst = self._instances[rid] = self._descriptor.instantiate()
        return inst


def _images_to_numpy(series: Series, size: int) -> np.ndarray:
    """A dense (B, size, size, 3) uint8 batch from an image-bearing Series.
    Fixed-shape columns of the model's size are zero-copy reshapes; other
    fixed sizes, variable-shape images and encoded bytes are decoded and
    resized (PIL, bilinear) on the host, matching the reference's
    preprocessing step. Null rows of the last two give black images."""
    dt = series.dtype
    if dt.id == TypeId.FIXED_SHAPE_IMAGE:
        vals, _ = series.to_numpy_masked()
        h, w, c = dt.shape
        if (h, w) != (size, size) or c != 3:
            vals = _host_resize_batch(vals, size)
        return np.ascontiguousarray(vals)
    if dt.id in (TypeId.FIXED_SHAPE_TENSOR, TypeId.EMBEDDING, TypeId.FIXED_SIZE_LIST):
        vals, _ = series.to_numpy_masked()
        if vals.ndim == 2 and vals.shape[1] == size * size * 3:
            return vals.reshape(-1, size, size, 3).astype(np.uint8)
        if vals.ndim == 4:
            return vals.astype(np.uint8)
        raise DaftTypeError(f"Cannot interpret {dt!r} as {size}x{size}x3 images")
    if dt.id == TypeId.IMAGE:
        from PIL import Image as PILImage

        out = np.zeros((len(series), size, size, 3), dtype=np.uint8)
        for i, row in enumerate(series.to_arrow().to_pylist()):
            if row is None:
                continue
            m = ImageMode(row["mode"])
            arr = np.frombuffer(row["data"], dtype=m.pixel_dtype.to_numpy()).reshape(
                row["height"], row["width"], row["channel"])
            img = PILImage.fromarray(arr.squeeze(-1) if arr.shape[2] == 1 else arr)
            out[i] = np.asarray(img.convert("RGB").resize((size, size), PILImage.BILINEAR))
        return out
    if dt.is_binary():
        from PIL import Image as PILImage

        out = np.zeros((len(series), size, size, 3), dtype=np.uint8)
        for i, raw in enumerate(series.to_pylist()):
            if raw is None:
                continue
            img = PILImage.open(io.BytesIO(raw)).convert("RGB")
            out[i] = np.asarray(img.resize((size, size), PILImage.BILINEAR))
        return out
    raise DaftTypeError(f"expected an image column, got {dt!r}")


def _host_resize_batch(vals: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image as PILImage

    out = np.zeros((vals.shape[0], size, size, 3), dtype=np.uint8)
    for i in range(vals.shape[0]):
        arr = vals[i]
        img = PILImage.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr[..., :3])
        out[i] = np.asarray(img.convert("RGB").resize((size, size), PILImage.BILINEAR))
    return out


def embed_text(text: Expression, *, provider: Union[str, object, None] = None,
               model: Optional[str] = None, **options) -> Expression:
    """Embed a string column (reference: daft/functions/ai/__init__.py:72).
    The default provider is ``cuda`` and the default model
    ``all-MiniLM-L6-v2``; a model name with "clip" or "vit" in it takes the
    CLIP text tower. ``weights_path`` takes a local HF checkpoint directory
    (BERT, or CLIP for a CLIP model name) with its tokenizer files, or a
    JAX-package checkpoint: an ``.npz``, a flax ``.msgpack`` (read with
    ``msgpack``) or an orbax directory (read with ``tensorstore``).
    ``device="cpu"`` runs it on the CPU. The API providers (``openai``,
    ``google``, ``lm_studio``, ``vllm``) take ``base_url``, ``api_key`` and
    ``dimensions``; ``transformers`` takes a local model directory."""
    p = load_provider(provider)
    desc = p.get_text_embedder(model, **options)
    dtype = DataType.embedding(DataType.float32(), desc.get_dimensions() or 384)

    def call(inst, series: Series) -> Series:
        return Series.from_numpy(inst.embed_text(series.to_pylist()), "embedding", dtype)

    return _ProtocolUdf(desc, call, dtype, "embed_text")(text)


def embed_image(image: Expression, *, provider: Union[str, object, None] = None,
                model: Optional[str] = None, **options) -> Expression:
    """Embed an image column (reference: daft/functions/ai/__init__.py:157).
    The default provider is ``cuda``; ``weights_path`` takes a local HF CLIP
    checkpoint directory or a JAX-package ``.npz``, flax ``.msgpack`` or
    orbax directory; ``device="cpu"`` runs it on the CPU."""
    p = load_provider(provider)
    desc = p.get_image_embedder(model, **options)
    dims = desc.get_dimensions() or 768
    dtype = DataType.embedding(DataType.float32(), dims)

    def call(inst, series: Series) -> Series:
        batch = _images_to_numpy(series, inst.cfg.image_size)
        return Series.from_numpy(inst.embed_image(batch), "embedding", dtype)

    return _ProtocolUdf(desc, call, dtype, "embed_image")(image)


def classify_text(text: Expression, labels: Sequence[str], *,
                  provider: Union[str, object, None] = None,
                  model: Optional[str] = None, **options) -> Expression:
    """The label of each string, zero-shot through the CLIP text tower
    (reference: daft/functions/ai/__init__.py:250); default model
    ``ViT-B/32``."""
    p = load_provider(provider)
    desc = p.get_text_classifier(model, **options)
    labels = list(labels)

    def call(inst, series: Series) -> Series:
        out = inst.classify_text(series.to_pylist(), labels)
        return Series.from_pylist(out, "label", DataType.string())

    return _ProtocolUdf(desc, call, DataType.string(), "classify_text")(text)


def classify_image(image: Expression, labels: Sequence[str], *,
                   provider: Union[str, object, None] = None,
                   model: Optional[str] = None, **options) -> Expression:
    """The label of each image, zero-shot against "a photo of a {label}"
    (reference: daft/functions/ai/__init__.py:329); default model
    ``ViT-B/32``. Takes the image columns ``embed_image`` takes."""
    p = load_provider(provider)
    desc = p.get_image_classifier(model, **options)
    labels = list(labels)

    def call(inst, series: Series) -> Series:
        batch = _images_to_numpy(series, inst.image_embedder.cfg.image_size)
        out = inst.classify_image(batch, labels)
        return Series.from_pylist(out, "label", DataType.string())

    return _ProtocolUdf(desc, call, DataType.string(), "classify_image")(image)


def prompt(text: Expression, *, provider: Union[str, object, None] = None,
           model: Optional[str] = None, **options) -> Expression:
    """Generate text per row (reference: daft/functions/ai/__init__.py:430):
    the decoder LM behind continuous batching; default model ``default-lm``.
    Options ``max_new_tokens`` (32), ``temperature`` (0: greedy), ``seed``,
    ``weights_path`` and ``device`` (``"cpu"`` runs it on the CPU)."""
    p = load_provider(provider)
    desc = p.get_prompter(model, **options)

    def call(inst, series: Series) -> Series:
        return Series.from_pylist(inst.prompt(series.to_pylist()), "response", DataType.string())

    return _ProtocolUdf(desc, call, DataType.string(), "prompt")(text)


def llm_generate(text: Expression, *, model: Optional[str] = None,
                 provider: Union[str, object, None] = None, **options) -> Expression:
    """Batched LLM generation (reference: daft/functions/llm.py llm_generate,
    which hands rows to vLLM); here ``prompt``'s continuous batcher."""
    return prompt(text, provider=provider, model=model, **options)
