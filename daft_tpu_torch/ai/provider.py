"""Provider registry (port of ``daft_tpu/ai/provider.py``; reference: daft/ai/provider.py).

A Provider vends protocol descriptors. Built-in: ``cuda`` (the port's models,
the default) and ``cuda_random`` (same architectures, random weights from a
seed — for benchmarking and for machines without checkpoints), the API
providers ``openai``, ``google``, ``lm_studio`` and ``vllm``
(``ai/api_providers.py``) and ``transformers`` (``ai/torch_provider.py``).
Third-party providers register via ``register_provider``; the built-ins
never replace one registered first under their name.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from daft_tpu_torch.errors import DaftValueError

_PROVIDERS: Dict[str, Callable[..., "Provider"]] = {}

DEFAULT_PROVIDER = "cuda"


class Provider:
    name = "base"

    def get_text_embedder(self, model: Optional[str] = None, **options):
        raise DaftValueError(f"Provider {self.name!r} has no text embedder")

    def get_image_embedder(self, model: Optional[str] = None, **options):
        raise DaftValueError(f"Provider {self.name!r} has no image embedder")

    def get_text_classifier(self, model: Optional[str] = None, **options):
        raise DaftValueError(f"Provider {self.name!r} has no text classifier")

    def get_image_classifier(self, model: Optional[str] = None, **options):
        raise DaftValueError(f"Provider {self.name!r} has no image classifier")

    def get_prompter(self, model: Optional[str] = None, **options):
        raise DaftValueError(f"Provider {self.name!r} has no prompter")


def register_provider(name: str, factory: Callable[..., Provider]) -> None:
    _PROVIDERS[name] = factory


def load_provider(provider: "str | Provider | None", **options) -> Provider:
    if isinstance(provider, Provider):
        return provider
    name = provider or DEFAULT_PROVIDER
    if name not in _PROVIDERS:
        _ensure_builtins()
    if name not in _PROVIDERS:
        raise DaftValueError(
            f"Unknown AI provider {name!r}; registered: {sorted(_PROVIDERS)}"
        )
    return _PROVIDERS[name](**options)


def _ensure_builtins() -> None:
    from daft_tpu_torch.ai.api_providers import (
        GoogleProvider,
        LMStudioProvider,
        OpenAIProvider,
        VLLMProvider,
    )
    from daft_tpu_torch.ai.cuda_provider import CUDAProvider
    from daft_tpu_torch.ai.torch_provider import TorchTransformersProvider

    _PROVIDERS.setdefault("cuda", lambda **kw: CUDAProvider(**kw))
    _PROVIDERS.setdefault("cuda_random", lambda **kw: CUDAProvider(random_init=True, **kw))
    _PROVIDERS.setdefault("openai", lambda **kw: OpenAIProvider(**kw))
    _PROVIDERS.setdefault("google", lambda **kw: GoogleProvider(**kw))
    _PROVIDERS.setdefault("lm_studio", lambda **kw: LMStudioProvider(**kw))
    _PROVIDERS.setdefault("vllm", lambda **kw: VLLMProvider(**kw))
    _PROVIDERS.setdefault("transformers", lambda **kw: TorchTransformersProvider(**kw))
