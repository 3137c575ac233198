"""AI protocols + descriptors (port of ``daft_tpu/ai/protocols.py``).

Reference: daft/ai/protocols.py:15-60 — each protocol is paired with a
Descriptor that carries instantiation options and the UDF's batch size. This
slice ports the image embedder. Not ported yet: the TextEmbedder,
TextClassifier, ImageClassifier and Prompter protocols and their descriptors,
and the replica options (concurrency, accelerator ask).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

import numpy as np


@dataclass
class UDFOptions:
    """Scheduling options the descriptor hands to the UDF operator
    (reference: get_udf_options, daft/ai/transformers/protocols/image_embedder.py:45-50)."""

    batch_size: int = 256


@runtime_checkable
class ImageEmbedder(Protocol):
    def embed_image(self, images: np.ndarray) -> np.ndarray: ...


class ImageEmbedderDescriptor:
    """Recipe for instantiating an image embedder inside a UDF."""

    protocol = "image_embedder"

    def get_udf_options(self) -> UDFOptions:
        return UDFOptions()

    def get_dimensions(self) -> Optional[int]:
        """Embedding dimensionality, when known statically."""
        return None

    def instantiate(self) -> ImageEmbedder:
        raise NotImplementedError
