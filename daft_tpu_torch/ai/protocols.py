"""AI protocols + descriptors (port of ``daft_tpu/ai/protocols.py``).

Reference: daft/ai/protocols.py:15-60 — each protocol is paired with a
Descriptor that carries instantiation options and the UDF's batch size. This
slice ports the text and image embedders and the text and image classifiers.
Not ported yet: the Prompter protocol and its descriptor, and the replica
options (concurrency, accelerator ask).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np


@dataclass
class UDFOptions:
    """Scheduling options the descriptor hands to the UDF operator
    (reference: get_udf_options, daft/ai/transformers/protocols/image_embedder.py:45-50)."""

    batch_size: int = 256


@runtime_checkable
class TextEmbedder(Protocol):
    def embed_text(self, texts: Sequence[Optional[str]]) -> np.ndarray: ...


@runtime_checkable
class ImageEmbedder(Protocol):
    def embed_image(self, images: np.ndarray) -> np.ndarray: ...


@runtime_checkable
class TextClassifier(Protocol):
    def classify_text(self, texts: Sequence[Optional[str]], labels: Sequence[str]) -> List[str]: ...


@runtime_checkable
class ImageClassifier(Protocol):
    def classify_image(self, images: np.ndarray, labels: Sequence[str]) -> List[str]: ...


@runtime_checkable
class Prompter(Protocol):
    def prompt(self, prompts: Sequence[Optional[str]]) -> List[str]: ...


class Descriptor:
    """Recipe for instantiating a protocol implementation inside a UDF."""

    protocol = "base"

    def get_udf_options(self) -> UDFOptions:
        return UDFOptions()

    def get_dimensions(self) -> Optional[int]:
        """Embedding dimensionality, when known statically."""
        return None

    def instantiate(self):
        raise NotImplementedError


class TextEmbedderDescriptor(Descriptor):
    protocol = "text_embedder"


class ImageEmbedderDescriptor(Descriptor):
    protocol = "image_embedder"


class TextClassifierDescriptor(Descriptor):
    protocol = "text_classifier"


class ImageClassifierDescriptor(Descriptor):
    protocol = "image_classifier"


class PrompterDescriptor(Descriptor):
    protocol = "prompter"
