"""Decoder-only LM with a KV cache (port of ``daft_tpu/models/lm.py``).

The model ``prompt`` / ``llm_generate`` run: learned positions, pre-norm
blocks, an f32 ``ln_f`` and an f32 ``lm_head`` with no bias. The JAX package's
arithmetic is kept where it differs from the port's other towers:

* the token embedding is f32 and is cast to the model dtype first; the f32
  positions are then cast and added in the model dtype (CLIP text's order, not
  MiniLM's add-then-cast);
* ``CachedSelfAttention`` multiplies q by the scale in the model dtype (bf16
  rounds 128 ** -0.5 to 0.0883789), takes q·k in the model dtype, writes
  ``finfo(float32).min`` into masked logits, softmaxes in f32 and casts P to
  the model dtype for P·V. It is plain torch, as the JAX package leaves it to
  XLA: no hand-written kernel stands behind it, and it never reaches the
  flash-attention kernel or PyTorch's fused attention
  (``models/layers.py::masked_attention`` accumulates q·k in f32 and does not
  apply here).

The cache of each layer is a pair of (B, H, S, head_dim) tensors (the JAX
package's is (B, S, H, head_dim)): q·kᵀ and P·V then read it through views,
with no copy. The forward writes the new K/V into it in place at
``positions`` and returns the same tensors. A position must lie in
[0, S): the JAX package drops a write past S and reads NaN from ``pos_embed``
past ``max_seq_len``, where torch indexing raises (or faults on the card), so
the callers here keep every position in range.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.models.checkpoint import copy_flax_params, load_flat
from daft_tpu_torch.models.layers import MLP, LayerNorm, flax_block_names, init_random_params_

Caches = List[Tuple[torch.Tensor, torch.Tensor]]

EOS_ID = 2  # a generated EOS ends its request (the JAX package's default)


@dataclass(frozen=True)
class DecoderLMConfig:
    vocab_size: int = 32000
    hidden: int = 2048
    layers: int = 16
    heads: int = 16
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16

    @staticmethod
    def tiny() -> "DecoderLMConfig":
        return DecoderLMConfig(vocab_size=512, hidden=64, layers=2, heads=2, max_seq_len=64)

    @staticmethod
    def from_name(name: str) -> "DecoderLMConfig":
        n = name.lower()
        if "tiny" in n:
            return DecoderLMConfig.tiny()
        if "8b" in n:
            return DecoderLMConfig(vocab_size=128256, hidden=4096, layers=32, heads=32)
        return DecoderLMConfig()


class CachedSelfAttention(nn.Module):
    """Self-attention over an explicit KV cache, for prefill (T = prompt
    length) and decode (T = 1)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        if dim % num_heads:
            raise DaftValueError(f"width {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.out = nn.Linear(dim, dim, dtype=dtype, device=device)
        # The scale as the model dtype holds it, as a Python number: q * it
        # rounds once, like the JAX package's product in that dtype.
        self.scale = torch.tensor((dim // num_heads) ** -0.5, dtype=dtype).item()

    def forward(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                positions: torch.Tensor):
        """x: (B, T, D); cache_{k,v}: (B, H, S, head_dim), written in place at
        ``positions``: (B, T) integer, each in [0, S). Returns (B, T, D)."""
        B, T, d = x.shape
        H = self.num_heads
        q, k, v = (t.view(B, T, H, d // H) for t in self.qkv(x).split(d, dim=-1))
        rows = torch.arange(B, device=x.device)[:, None]
        cache_k[rows, :, positions] = k
        cache_v[rows, :, positions] = v
        logits = torch.matmul((q * self.scale).transpose(1, 2),
                              cache_k.transpose(-1, -2)).float()  # (B, H, T, S)
        # Valid keys: cache slots <= the query's position.
        slot = torch.arange(cache_k.shape[2], device=x.device)
        masked_out = slot[None, None, None, :] > positions[:, None, :, None]
        logits = logits.masked_fill_(masked_out, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, cache_v).transpose(1, 2).reshape(B, T, d)
        return self.out(out)


class DecoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = CachedSelfAttention(dim, num_heads, dtype, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        self.mlp = MLP(dim, 4 * dim, dim, dtype, device=device)

    def forward(self, x, cache_k, cache_v, positions):
        x = x + self.attn(self.ln1(x).to(self.dtype), cache_k, cache_v, positions)
        return x + self.mlp(self.ln2(x).to(self.dtype))


class DecoderLM(nn.Module):
    def __init__(self, cfg: DecoderLMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.hidden, dtype=torch.float32,
                                      device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.max_seq_len, cfg.hidden, device=device))
        self.blocks = nn.ModuleList(DecoderBlock(cfg.hidden, cfg.heads, cfg.dtype, device=device)
                                    for _ in range(cfg.layers))
        self.ln_f = LayerNorm(cfg.hidden, device=device)
        self.lm_head = nn.Linear(cfg.hidden, cfg.vocab_size, bias=False, dtype=torch.float32,
                                 device=device)

    def forward(self, tokens: torch.Tensor, caches: Caches, positions: torch.Tensor):
        """tokens, positions: (B, T) integer; caches: one (k, v) per layer,
        written in place. Returns ((B, T, vocab) f32 logits, caches)."""
        dtype = self.cfg.dtype
        x = self.tok_embed(tokens).to(dtype)
        x = x + self.pos_embed[0][positions].to(dtype)
        for block, (ck, cv) in zip(self.blocks, caches):
            x = block(x, ck, cv, positions)
        return self.lm_head(self.ln_f(x)), caches

    def flax_names(self) -> Dict[str, tuple]:
        """flax key (below ``params/``) -> (torch name, how it maps)."""
        names = {"tok_embed/embedding": ("tok_embed.weight", "same"),
                 "pos_embed": ("pos_embed", "same"),
                 "ln_f/scale": ("ln_f.weight", "same"),
                 "ln_f/bias": ("ln_f.bias", "same"),
                 "lm_head/kernel": ("lm_head.weight", "dense")}
        for i in range(self.cfg.layers):
            names.update(flax_block_names(f"block_{i}", f"blocks.{i}"))
        return names


def init_caches(cfg: DecoderLMConfig, batch: int, seq_len: Optional[int] = None,
                device=None) -> Caches:
    """Zeroed (k, v) per layer, each (batch, heads, seq_len, head_dim)."""
    S = seq_len or cfg.max_seq_len
    shape = (batch, cfg.heads, S, cfg.hidden // cfg.heads)
    return [(torch.zeros(shape, dtype=cfg.dtype, device=device),
             torch.zeros(shape, dtype=cfg.dtype, device=device)) for _ in range(cfg.layers)]


def init_random_(model: DecoderLM, generator: torch.Generator) -> DecoderLM:
    """Random weights from ``generator`` (``layers.init_random_params_``):
    normal(0.02) for the token embedding and normal(0.01) for the positions,
    as flax draws them."""
    return init_random_params_(model, generator, {"tok_embed.weight": 0.02, "pos_embed": 0.01})


def load_flax_params(model: DecoderLM, flat: Dict[str, np.ndarray]) -> list:
    """Copy a flat flax state dict (``params/tok_embed/embedding``,
    ``params/block_i/...``, ``params/lm_head/kernel``; the ``params/`` prefix
    may be left out) into ``model``, each array cast to its parameter's dtype
    (the embeddings, LayerNorms and ``lm_head`` stay f32). Returns the torch
    names loaded; raises if none matched or a shape disagrees."""
    return copy_flax_params(model, flat, model.flax_names(), ("params/",), "decoder LM")


def load_params(path: str, model: DecoderLM) -> DecoderLM:
    """Load a JAX-package checkpoint (``.npz``, flax ``.msgpack`` or an orbax
    directory; ``checkpoint.load_flat``) into ``model``."""
    tree = ["params/" + k for k in model.flax_names()]
    load_flax_params(model, load_flat(path, tree))
    return model


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B,) int32 ids from (B, vocab) f32 logits: the argmax at temperature 0
    (the lowest index on a tie, as ``jnp.argmax``), else a draw from
    softmax(logits / temperature) with ``generator``. The draws are not
    ``jax.random``'s."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.no_grad()
def generate(model: DecoderLM, prompt_tokens: torch.Tensor, prompt_lengths: torch.Tensor,
             max_new_tokens: int = 32) -> torch.Tensor:
    """Greedy generation for a static batch: one prefill, then one decode
    step per new token (the JAX package's ``generate`` at temperature 0; the
    engine serves through ``serving.ContinuousBatcher``, which also samples).

    prompt_tokens: (B, P) integer, right-padded with 0; prompt_lengths: (B,).
    Returns (B, max_new_tokens) int32 ids, 0 after ``EOS_ID``. The cache holds
    P + max_new_tokens positions, as the JAX package's; a prompt that leaves
    no room for its new tokens in ``max_seq_len`` raises.
    """
    cfg = model.cfg
    device = model.lm_head.weight.device
    prompt_tokens = prompt_tokens.to(device)
    lengths = prompt_lengths.to(device=device, dtype=torch.int32)
    B, P = prompt_tokens.shape
    if P + max_new_tokens > cfg.max_seq_len:
        raise DaftValueError(
            f"{P} prompt positions and {max_new_tokens} new tokens exceed max_seq_len "
            f"{cfg.max_seq_len}")
    caches = init_caches(cfg, B, P + max_new_tokens, device=device)
    positions = torch.arange(P, device=device).expand(B, P)
    logits, caches = model(prompt_tokens, caches, positions)
    cur_logits = logits[torch.arange(B, device=device), lengths - 1]
    pos, done = lengths, torch.zeros(B, dtype=torch.bool, device=device)
    out = []
    for step in range(max_new_tokens):
        tok = sample(cur_logits, 0.0).masked_fill_(done, 0)
        out.append(tok)
        if step + 1 == max_new_tokens:
            break  # the JAX scan's last forward feeds nothing it returns
        cur_logits = model(tok[:, None], caches, pos[:, None])[0][:, 0]
        done = done | (tok == EOS_ID)
        pos = pos + 1
    return torch.stack(out, dim=1)
