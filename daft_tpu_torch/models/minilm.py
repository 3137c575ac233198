"""MiniLM-style sentence encoder, the shape of all-MiniLM-L6-v2 (port of
``daft_tpu/models/minilm.py``).

A bidirectional pre-norm transformer over token ids (0 = pad) with a
key-padding mask, mean-pooled over the tokens that are not padding and
L2-normalised inside the model. The token and position embeddings are added
in f32 and then cast to the model dtype, as the JAX encoder does. A row with
no token (an empty or ``None`` string) attends over keys that are all masked,
which the masked attention path keeps finite, and pools to an exact zero
vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from daft_tpu_torch.models.checkpoint import copy_flax_params, load_flat
from daft_tpu_torch.models.layers import (
    TransformerBlock,
    flax_block_names,
    init_random_params_,
)


@dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    hidden: int = 384
    layers: int = 6
    heads: int = 12
    max_length: int = 256
    embed_dim: int = 384
    dtype: Any = torch.bfloat16

    @staticmethod
    def tiny() -> "MiniLMConfig":
        return MiniLMConfig(vocab_size=512, hidden=64, layers=2, heads=2,
                            max_length=32, embed_dim=64)

    @staticmethod
    def from_name(name: str) -> "MiniLMConfig":
        if "tiny" in name.lower():
            return MiniLMConfig.tiny()
        return MiniLMConfig()


class MiniLMEncoder(nn.Module):
    def __init__(self, cfg: MiniLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.hidden, dtype=torch.float32,
                                      device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.max_length, cfg.hidden, device=device))
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg.hidden, cfg.heads, dtype=cfg.dtype, device=device)
            for _ in range(cfg.layers))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, L) int32 or int64, 0 = pad, L <= max_length. Returns
        (B, embed_dim) f32, mean-pooled and L2-normalised (norm clipped at
        1e-6)."""
        cfg = self.cfg
        L = tokens.shape[1]
        # Add, then cast: the JAX encoder adds the positions in f32.
        x = (self.tok_embed(tokens) + self.pos_embed[:, :L]).to(cfg.dtype)
        valid = tokens != 0
        mask = valid[:, None, None, :]  # (B, 1, 1, L): keys, bidirectional
        for block in self.blocks:
            x = block(x, mask)
        weights = valid.to(torch.float32)[:, :, None]
        pooled = (x.float() * weights).sum(dim=1) / weights.sum(dim=1).clamp(min=1.0)
        return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp(min=1e-6)

    def flax_names(self) -> Dict[str, tuple]:
        """flax key (below ``params/``) -> (torch name, how it maps)."""
        names = {"tok_embed/embedding": ("tok_embed.weight", "same"),
                 "pos_embed": ("pos_embed", "same")}
        for i in range(self.cfg.layers):
            names.update(flax_block_names(f"block_{i}", f"blocks.{i}"))
        return names


def init_random_(encoder: MiniLMEncoder, generator: torch.Generator) -> MiniLMEncoder:
    """Random weights from ``generator`` (``layers.init_random_params_``),
    normal(0.02) for both embeddings as flax draws them."""
    return init_random_params_(encoder, generator,
                               {"tok_embed.weight": 0.02, "pos_embed": 0.02})


def load_flax_params(encoder: MiniLMEncoder, flat: Dict[str, np.ndarray]) -> list:
    """Copy a flat flax state dict (``params/tok_embed/embedding``,
    ``params/pos_embed``, ``params/block_i/...``; the ``params/`` prefix may
    be left out) into ``encoder`` (``checkpoint.copy_flax_params``). Returns
    the torch names loaded; raises if none matched or a shape disagrees."""
    return copy_flax_params(encoder, flat, encoder.flax_names(), ("params/",), "MiniLM")


def load_params(path: str, encoder: MiniLMEncoder) -> MiniLMEncoder:
    """Load a JAX-package checkpoint (``.npz``, flax ``.msgpack`` or an orbax
    directory; ``checkpoint.load_flat``) into ``encoder``."""
    tree = ["params/" + k for k in encoder.flax_names()]
    load_flax_params(encoder, load_flat(path, tree))
    return encoder
