"""The HF ``BertModel`` encoder with sentence-transformers' mean pooling (port
of ``daft_tpu/models/bert.py``), the model of a local BERT checkpoint such as
all-MiniLM-L6-v2 (``models/convert.py``).

The JAX module's arithmetic step by step: word + position (``arange(L)``) +
token-type (zeros) embeddings added in f32, the embedding LayerNorm in f32
and cast to the model dtype; per layer separate q / k / v Dense layers,
attention through ``layers.masked_attention`` with a (B, 1, 1, L) key mask of
the ids that are not 0 ([PAD]), post-LN residuals (LayerNorm in f32 at the
config's eps, 1e-12, cast back) and the exact erf GELU. The output is mean
pooled over the non-pad positions in f32 (the divisor clipped at 1) and
L2-normalised (the norm clipped at 1e-6). Parameters live in the dtype the
JAX package computes in: the model dtype for the Dense layers, f32 for the
embeddings and LayerNorms. Module names follow the flax layout, so
``load_flax_params`` copies a flax state dict name for name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from daft_tpu_torch.models.checkpoint import copy_flax_params
from daft_tpu_torch.models.layers import LayerNorm, masked_attention, resolve_act


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_position: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12
    hidden_act: str = "gelu_exact"
    dtype: Any = torch.float32
    embed_dim: int = 384

    @staticmethod
    def from_hf(d: dict, dtype=torch.float32) -> "BertConfig":
        """From an HF BertModel ``config.json`` dict."""
        act = d.get("hidden_act", "gelu")
        return BertConfig(
            vocab_size=d["vocab_size"], hidden=d["hidden_size"],
            layers=d["num_hidden_layers"], heads=d["num_attention_heads"],
            intermediate=d["intermediate_size"],
            max_position=d.get("max_position_embeddings", 512),
            type_vocab=d.get("type_vocab_size", 2),
            ln_eps=d.get("layer_norm_eps", 1e-12),
            hidden_act="gelu_exact" if act == "gelu" else act,
            dtype=dtype, embed_dim=d["hidden_size"])


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.hidden, cfg.dtype
        self.q, self.k, self.v, self.attn_out = (
            nn.Linear(d, d, dtype=dt, device=device) for _ in range(4))
        self.attn_ln = LayerNorm(d, cfg.ln_eps, device=device)
        self.fc1 = nn.Linear(d, cfg.intermediate, dtype=dt, device=device)
        self.fc2 = nn.Linear(cfg.intermediate, d, dtype=dt, device=device)
        self.out_ln = LayerNorm(d, cfg.ln_eps, device=device)
        self.act = resolve_act(cfg.hidden_act)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, L, d = x.shape
        q, k, v = (proj(x).view(B, L, self.cfg.heads, d // self.cfg.heads)
                   for proj in (self.q, self.k, self.v))
        a = self.attn_out(masked_attention(q, k, v, mask).reshape(B, L, d))
        x = self.attn_ln(x + a).to(self.cfg.dtype)
        h = self.fc2(self.act(self.fc1(x)))
        return self.out_ln(x + h).to(self.cfg.dtype)


class BertEncoder(nn.Module):
    flax_prefixes = ("params/",)

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position, cfg.hidden, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab, cfg.hidden, device=device)
        self.emb_ln = LayerNorm(cfg.hidden, cfg.ln_eps, device=device)
        self.layers = nn.ModuleList(BertLayer(cfg, device=device) for _ in range(cfg.layers))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, L) int32 or int64, 0 = [PAD], L <= max_position.
        Returns (B, embed_dim) f32, mean-pooled and L2-normalised; a row with
        no token pools to an exact zero vector."""
        L = tokens.shape[1]
        positions = torch.arange(L, device=tokens.device)
        x = (self.word_embeddings(tokens) + self.position_embeddings(positions)[None]
             + self.token_type_embeddings.weight[0])
        x = self.emb_ln(x).to(self.cfg.dtype)
        valid = tokens != 0
        mask = valid[:, None, None, :]  # (B, 1, 1, L): keys, bidirectional
        for layer in self.layers:
            x = layer(x, mask)
        weights = valid.to(torch.float32)[:, :, None]
        pooled = (x.float() * weights).sum(dim=1) / weights.sum(dim=1).clamp(min=1.0)
        return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp(min=1e-6)

    def flax_names(self) -> Dict[str, tuple]:
        """flax key (below ``params/``) -> (torch name, how it maps)."""
        names = {f"{e}/embedding": (f"{e}.weight", "same")
                 for e in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
        norms = {"emb_ln": "emb_ln"}
        for i in range(self.cfg.layers):
            for dense in ("q", "k", "v", "attn_out", "fc1", "fc2"):
                names[f"layer_{i}/{dense}/kernel"] = (f"layers.{i}.{dense}.weight", "dense")
                names[f"layer_{i}/{dense}/bias"] = (f"layers.{i}.{dense}.bias", "same")
            norms.update({f"layer_{i}/{ln}": f"layers.{i}.{ln}" for ln in ("attn_ln", "out_ln")})
        for key, tname in norms.items():
            names[f"{key}/scale"] = (f"{tname}.weight", "same")
            names[f"{key}/bias"] = (f"{tname}.bias", "same")
        return names


def load_flax_params(encoder: BertEncoder, flat: Dict[str, np.ndarray]) -> list:
    """Copy a flat flax state dict (``params/layer_0/q/kernel``; the
    ``params/`` prefix may be left out) into ``encoder``
    (``checkpoint.copy_flax_params``). Returns the torch names loaded."""
    return copy_flax_params(encoder, flat, encoder.flax_names(), encoder.flax_prefixes,
                            "BERT")
