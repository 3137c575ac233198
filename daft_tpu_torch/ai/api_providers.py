"""API-backed AI providers: openai / lm_studio / vllm (the OpenAI wire
format) and google (the Gemini API) (port of ``daft_tpu/ai/api_providers.py``).

Reference: daft/ai/{openai,google,lm_studio,vllm}. The reference wraps vendor
SDKs; here the protocol implementations speak the same wire formats through
the injectable ``ai/transport.py`` seam, so their requests are the JAX
package's byte for byte and tests answer them from canned responses.

* ``openai``     — api.openai.com; needs ``OPENAI_API_KEY`` (or ``api_key=``).
* ``lm_studio``  — an OpenAI-compatible local server, by default
                   http://localhost:1234/v1, no key.
* ``vllm``       — an OpenAI-compatible ``vllm serve`` endpoint, by default
                   http://localhost:8000/v1, no key. The reference embeds a
                   vLLM engine in-process; in-process serving here is the
                   ``cuda`` provider's ``ContinuousBatcher``.
* ``google``     — generativelanguage.googleapis.com (Gemini); needs
                   ``GEMINI_API_KEY`` / ``GOOGLE_API_KEY``.

Token usage goes to ``ai/metrics.py::record_token_metrics``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from daft_tpu_torch.ai.metrics import record_token_metrics
from daft_tpu_torch.ai.protocols import Descriptor, UDFOptions
from daft_tpu_torch.ai.provider import Provider
from daft_tpu_torch.ai.transport import UrllibTransport
from daft_tpu_torch.errors import DaftValueError

# Embedding model profiles: width, and whether the API takes a dimensions
# override (reference: _ModelProfile in daft/ai/openai/protocols/text_embedder.py).
_OPENAI_EMBED_MODELS: Dict[str, Dict[str, Any]] = {
    "text-embedding-ada-002": {"dims": 1536, "override": False},
    "text-embedding-3-small": {"dims": 1536, "override": True},
    "text-embedding-3-large": {"dims": 3072, "override": True},
}
_GOOGLE_EMBED_MODELS: Dict[str, int] = {
    "text-embedding-004": 768,
    "gemini-embedding-001": 3072,
}

_EMBED_BATCH = 256  # inputs per embeddings request (the API caps it at 2048)


class OpenAICompatTextEmbedder:
    """POST {base_url}/embeddings in the OpenAI wire format, batched,
    reassembled by ``index``, with usage accounting."""

    def __init__(self, provider: str, model: str, base_url: str,
                 api_key: Optional[str], dimensions: Optional[int] = None,
                 transport=None, batch_size: int = _EMBED_BATCH):
        self.provider = provider
        self.model = model
        self.url = base_url.rstrip("/") + "/embeddings"
        self.headers = {"Authorization": f"Bearer {api_key}"} if api_key else {}
        self.dimensions = dimensions
        self.transport = transport or UrllibTransport()
        self.batch_size = batch_size

    def embed_text(self, texts: Sequence[Optional[str]]) -> np.ndarray:
        clean = ["" if t is None else str(t) for t in texts]
        out: List[List[float]] = []
        for start in range(0, len(clean), self.batch_size):
            chunk = clean[start:start + self.batch_size]
            body: Dict[str, Any] = {"model": self.model, "input": chunk}
            if self.dimensions is not None:
                body["dimensions"] = self.dimensions
            resp = self.transport.post(self.url, body, self.headers)
            data = sorted(resp["data"], key=lambda d: d["index"])
            if len(data) != len(chunk):
                raise DaftValueError(
                    f"{self.provider}: {len(chunk)} inputs but {len(data)} embeddings returned")
            out.extend(d["embedding"] for d in data)
            usage = resp.get("usage") or {}
            record_token_metrics(self.provider, self.model,
                                 input_tokens=usage.get("prompt_tokens", 0))
        return np.asarray(out, dtype=np.float32)


class OpenAICompatPrompter:
    """POST {base_url}/chat/completions, one request per prompt (reference:
    daft/ai/openai/protocols/prompter.py); a null prompt answers ``""``."""

    def __init__(self, provider: str, model: str, base_url: str,
                 api_key: Optional[str], system_message: Optional[str] = None,
                 temperature: Optional[float] = None,
                 max_completion_tokens: Optional[int] = None, transport=None):
        self.provider = provider
        self.model = model
        self.url = base_url.rstrip("/") + "/chat/completions"
        self.headers = {"Authorization": f"Bearer {api_key}"} if api_key else {}
        self.system_message = system_message
        self.temperature = temperature
        self.max_completion_tokens = max_completion_tokens
        self.transport = transport or UrllibTransport()

    def prompt(self, prompts: Sequence[Optional[str]]) -> List[str]:
        outs: List[str] = []
        for p in prompts:
            if p is None:
                outs.append("")
                continue
            messages = []
            if self.system_message:
                messages.append({"role": "system", "content": self.system_message})
            messages.append({"role": "user", "content": str(p)})
            body: Dict[str, Any] = {"model": self.model, "messages": messages}
            if self.temperature is not None:
                body["temperature"] = self.temperature
            if self.max_completion_tokens is not None:
                body["max_completion_tokens"] = self.max_completion_tokens
            resp = self.transport.post(self.url, body, self.headers)
            outs.append(resp["choices"][0]["message"].get("content") or "")
            usage = resp.get("usage") or {}
            record_token_metrics(self.provider, self.model,
                                 input_tokens=usage.get("prompt_tokens", 0),
                                 output_tokens=usage.get("completion_tokens", 0))
        return outs


class GoogleTextEmbedder:
    """POST models/{model}:batchEmbedContents on the Gemini API (reference:
    daft/ai/google/protocols/)."""

    def __init__(self, model: str, base_url: str, api_key: str,
                 dimensions: Optional[int] = None, transport=None, batch_size: int = 100):
        self.model = model
        self.url = f"{base_url.rstrip('/')}/models/{model}:batchEmbedContents"
        self.headers = {"x-goog-api-key": api_key} if api_key else {}
        self.dimensions = dimensions
        self.transport = transport or UrllibTransport()
        self.batch_size = batch_size

    def embed_text(self, texts: Sequence[Optional[str]]) -> np.ndarray:
        clean = ["" if t is None else str(t) for t in texts]
        out: List[List[float]] = []
        for start in range(0, len(clean), self.batch_size):
            chunk = clean[start:start + self.batch_size]
            reqs = []
            for t in chunk:
                r: Dict[str, Any] = {"model": f"models/{self.model}",
                                     "content": {"parts": [{"text": t}]}}
                if self.dimensions is not None:
                    r["outputDimensionality"] = self.dimensions
                reqs.append(r)
            resp = self.transport.post(self.url, {"requests": reqs}, self.headers)
            embs = resp["embeddings"]
            if len(embs) != len(chunk):
                raise DaftValueError(f"google: {len(chunk)} inputs but {len(embs)} embeddings")
            out.extend(e["values"] for e in embs)
            record_token_metrics("google", self.model, requests=1)
        return np.asarray(out, dtype=np.float32)


class GooglePrompter:
    """POST models/{model}:generateContent, one request per prompt."""

    def __init__(self, model: str, base_url: str, api_key: str,
                 system_message: Optional[str] = None,
                 temperature: Optional[float] = None, transport=None):
        self.model = model
        self.url = f"{base_url.rstrip('/')}/models/{model}:generateContent"
        self.headers = {"x-goog-api-key": api_key} if api_key else {}
        self.system_message = system_message
        self.temperature = temperature
        self.transport = transport or UrllibTransport()

    def prompt(self, prompts: Sequence[Optional[str]]) -> List[str]:
        outs: List[str] = []
        for p in prompts:
            if p is None:
                outs.append("")
                continue
            body: Dict[str, Any] = {"contents": [{"parts": [{"text": str(p)}]}]}
            if self.system_message:
                body["systemInstruction"] = {"parts": [{"text": self.system_message}]}
            if self.temperature is not None:
                body["generationConfig"] = {"temperature": self.temperature}
            resp = self.transport.post(self.url, body, self.headers)
            cands = resp.get("candidates") or []
            text = ""
            if cands:
                parts = cands[0].get("content", {}).get("parts", [])
                text = "".join(pt.get("text", "") for pt in parts)
            outs.append(text)
            usage = resp.get("usageMetadata") or {}
            record_token_metrics("google", self.model,
                                 input_tokens=usage.get("promptTokenCount", 0),
                                 output_tokens=usage.get("candidatesTokenCount", 0))
        return outs


# ---------------------------------------------------------------------- #
class _ApiDescriptor(Descriptor):
    """A picklable recipe: the transport is made (or the injected one used)
    at instantiation."""

    def __init__(self, provider: str, kind: str, model: str, options: Dict[str, Any]):
        self.provider = provider
        self.kind = kind
        self.model = model
        self.options = dict(options)

    def get_provider(self) -> str:
        return self.provider

    def get_model(self) -> str:
        return self.model

    def get_options(self) -> Dict[str, Any]:
        return dict(self.options)

    def get_udf_options(self) -> UDFOptions:
        # API calls wait on the network: modest batches, several at once
        # (reference: UDFOptions in the openai text embedder).
        return UDFOptions(batch_size=self.options.get("batch_size", 128),
                          max_concurrency=self.options.get("max_concurrency", 4))

    def get_dimensions(self) -> Optional[int]:
        if self.kind != "text_embedder":
            return None
        if self.options.get("dimensions"):
            return int(self.options["dimensions"])
        if self.provider == "google":
            return _GOOGLE_EMBED_MODELS.get(self.model)
        prof = _OPENAI_EMBED_MODELS.get(self.model)
        return prof["dims"] if prof else None

    def instantiate(self):
        o = self.options
        transport = o.get("transport")
        base_url = o.get("base_url")
        if self.provider == "google":
            key = o.get("api_key") or os.environ.get("GEMINI_API_KEY") \
                or os.environ.get("GOOGLE_API_KEY")
            if not key and transport is None:
                raise DaftValueError(
                    "google provider needs api_key= or GEMINI_API_KEY/GOOGLE_API_KEY set")
            base = base_url or "https://generativelanguage.googleapis.com/v1beta"
            if self.kind == "text_embedder":
                return GoogleTextEmbedder(self.model, base, key or "", o.get("dimensions"),
                                          transport)
            if self.kind == "prompter":
                return GooglePrompter(self.model, base, key or "", o.get("system_message"),
                                      o.get("temperature"), transport)
            raise DaftValueError(f"google provider: no {self.kind}")
        # The OpenAI wire format (openai / lm_studio / vllm).
        if self.provider == "openai":
            key = o.get("api_key") or os.environ.get("OPENAI_API_KEY")
            if not key and transport is None:
                raise DaftValueError("openai provider needs api_key= or OPENAI_API_KEY set")
            base = base_url or "https://api.openai.com/v1"
        else:  # lm_studio / vllm: local OpenAI-compatible servers, no key
            key = o.get("api_key")
            base = base_url or ("http://localhost:1234/v1" if self.provider == "lm_studio"
                                else "http://localhost:8000/v1")
        if self.kind == "text_embedder":
            dims = o.get("dimensions")
            prof = _OPENAI_EMBED_MODELS.get(self.model)
            if dims and prof and not prof["override"]:
                raise DaftValueError(
                    f"model {self.model!r} does not support overriding dimensions")
            return OpenAICompatTextEmbedder(self.provider, self.model, base, key, dims,
                                            transport, o.get("request_batch_size", _EMBED_BATCH))
        if self.kind == "prompter":
            return OpenAICompatPrompter(self.provider, self.model, base, key,
                                        o.get("system_message"), o.get("temperature"),
                                        o.get("max_completion_tokens"), transport)
        raise DaftValueError(f"{self.provider} provider: no {self.kind}")

    def __getstate__(self):
        # An injected transport that does not pickle is dropped: the copy
        # makes the default transport from the remaining options.
        state = dict(self.__dict__)
        opts = dict(state["options"])
        t = opts.get("transport")
        if t is not None:
            try:
                pickle.dumps(t)
            except Exception:  # noqa: BLE001 -- whatever pickling raises, drop it
                opts.pop("transport")
        state["options"] = opts
        return state


class _BaseApiProvider(Provider):
    DEFAULT_TEXT_EMBEDDER = "text-embedding-3-small"
    DEFAULT_PROMPTER = "gpt-4o-mini"

    def __init__(self, name: Optional[str] = None, **options):
        if name:
            self.name = name
        self.options = options

    def _merged(self, options: Dict[str, Any]) -> Dict[str, Any]:
        return {**self.options, **options}

    def get_text_embedder(self, model: Optional[str] = None, **options) -> _ApiDescriptor:
        return _ApiDescriptor(self.name, "text_embedder", model or self.DEFAULT_TEXT_EMBEDDER,
                              self._merged(options))

    def get_prompter(self, model: Optional[str] = None, **options) -> _ApiDescriptor:
        return _ApiDescriptor(self.name, "prompter", model or self.DEFAULT_PROMPTER,
                              self._merged(options))


class OpenAIProvider(_BaseApiProvider):
    name = "openai"


class LMStudioProvider(_BaseApiProvider):
    name = "lm_studio"
    DEFAULT_TEXT_EMBEDDER = "text-embedding-nomic-embed-text-v1.5"
    DEFAULT_PROMPTER = "local-model"


class VLLMProvider(_BaseApiProvider):
    name = "vllm"
    DEFAULT_TEXT_EMBEDDER = "intfloat/e5-small-v2"
    DEFAULT_PROMPTER = "meta-llama/Llama-3.1-8B-Instruct"


class GoogleProvider(_BaseApiProvider):
    name = "google"
    DEFAULT_TEXT_EMBEDDER = "text-embedding-004"
    DEFAULT_PROMPTER = "gemini-2.0-flash"
