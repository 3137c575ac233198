"""The ``transformers`` provider: a text embedder over a Hugging Face
``transformers`` model from local weights (port of
``daft_tpu/ai/torch_provider.py``; reference: daft/ai/transformers).

``TorchTextEmbedder`` loads ``AutoTokenizer`` / ``AutoModel`` from a local
directory (or a name already in the local Hugging Face cache), mean-pools
the last hidden state over the attention mask (sequences cut at 256 tokens),
L2-normalises and returns f32. As every entry point of the port, it runs on
the GPU unless ``device="cpu"`` is passed, and raises where no CUDA device is
visible. ``transformers`` is imported at instantiation, never before.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from daft_tpu_torch.ai.protocols import Descriptor, UDFOptions
from daft_tpu_torch.ai.provider import Provider
from daft_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from daft_tpu_torch.errors import DaftValueError


class TorchTextEmbedder:
    """A sentence-transformers-style mean-pooled embedder over a
    ``transformers`` model, on ``device``."""

    def __init__(self, model_name: str, device: str = DEFAULT_DEVICE, **options):
        from transformers import AutoModel, AutoTokenizer

        self.device = resolve_device(device)
        self.tokenizer = AutoTokenizer.from_pretrained(model_name)
        self.model = AutoModel.from_pretrained(model_name).to(self.device)
        self.model.eval()

    @property
    def dimensions(self) -> int:
        return int(self.model.config.hidden_size)

    def embed_text(self, texts: Sequence[Optional[str]]) -> np.ndarray:
        clean = [t or "" for t in texts]
        with torch.inference_mode():
            enc = self.tokenizer(clean, padding=True, truncation=True, max_length=256,
                                 return_tensors="pt").to(self.device)
            out = self.model(**enc).last_hidden_state
            mask = enc["attention_mask"].unsqueeze(-1).float()
            pooled = (out * mask).sum(1) / mask.sum(1).clamp(min=1.0)
            pooled = torch.nn.functional.normalize(pooled, dim=-1)
        return pooled.cpu().numpy().astype(np.float32)


class _TorchDescriptor(Descriptor):
    def __init__(self, kind: str, model: str, options: Dict[str, Any]):
        self.kind = kind
        self.model = model
        self.options = options
        # Fail where the user calls, not on the first batch.
        resolve_device(self.options.get("device", DEFAULT_DEVICE))

    def get_provider(self) -> str:
        return "transformers"

    def get_model(self) -> str:
        return self.model

    def get_udf_options(self) -> UDFOptions:
        return UDFOptions(batch_size=self.options.get("batch_size", 64),
                          max_concurrency=self.options.get("max_concurrency", 1))

    def get_dimensions(self) -> Optional[int]:
        return self.options.get("dimensions")

    def instantiate(self):
        if self.kind == "text_embedder":
            return TorchTextEmbedder(self.model, **self.options)
        raise DaftValueError(f"transformers provider: {self.kind} not supported yet")


class TorchTransformersProvider(Provider):
    name = "transformers"

    def __init__(self, **options):
        self.options = options

    def get_text_embedder(self, model: Optional[str] = None, **options) -> _TorchDescriptor:
        return _TorchDescriptor("text_embedder",
                                model or "sentence-transformers/all-MiniLM-L6-v2",
                                {**self.options, **options})
