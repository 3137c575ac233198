"""Shared transformer building blocks (port of ``daft_tpu/models/layers.py``).

The JAX package's mixed precision is kept: matmuls run in the model dtype
(bf16 by default), LayerNorm runs in f32 with eps 1e-6 and is cast back, and
attention accumulates in f32. Module and parameter names follow the flax
layout (``qkv``, ``out``, ``fc1``, ``fc2``, ``ln1``, ``ln2``) so that
``models/clip.py::load_flax_params`` maps a flax checkpoint name for name.

``MultiHeadAttention`` takes the mask-free path only in this slice, and that
path always goes through ``ops/flash_attention.flash_attention`` (the CUDA
kernel on a GPU tensor). Not ported yet: the masked path (the text tower's
causal mask), ``causal_mask`` and ``sinusoidal_positions``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from daft_tpu_torch.errors import DaftNotImplementedError, DaftValueError
from daft_tpu_torch.ops.flash_attention import flash_attention


def resolve_act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry keyed the way HF config.json names them.
    ``gelu`` is flax's default GELU, the tanh approximation."""
    table = {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": F.gelu,
        "gelu_python": F.gelu,
        "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_fast": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
        "relu": F.relu,
        "silu": F.silu,
        "swish": F.silu,
        "tanh": torch.tanh,
    }
    if name not in table:
        raise DaftValueError(
            f"Unsupported activation {name!r} (checkpoint hidden_act); "
            f"supported: {sorted(table)}")
    return table[name]


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 parameters, f32 arithmetic,
    f32 output whatever the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int, dtype=torch.bfloat16,
                 act: str = "gelu", device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_dim, out_dim, dtype=dtype, device=device)
        self.act = resolve_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        if dim % num_heads:
            raise DaftValueError(f"width {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.out = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            raise DaftNotImplementedError("masked attention is not ported yet")
        B, T, d = x.shape
        # Views into the fused qkv output in (B, T, H, head_dim): the kernel
        # reads them through their strides, nothing is copied.
        q, k, v = (t.view(B, T, self.num_heads, d // self.num_heads)
                   for t in self.qkv(x).split(d, dim=-1))
        return self.out(flash_attention(q, k, v).reshape(B, T, d))


class TransformerBlock(nn.Module):
    """Pre-norm transformer block (ViT / CLIP / GPT style)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.bfloat16, act: str = "gelu", ln_eps: float = 1e-6, device=None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(dim, ln_eps, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, dtype, device=device)
        self.ln2 = LayerNorm(dim, ln_eps, device=device)
        # round(): converted checkpoints carry the hidden width as a float ratio.
        self.mlp = MLP(dim, round(dim * mlp_ratio), dim, dtype, act, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x).to(self.dtype))
        return x + self.mlp(self.ln2(x).to(self.dtype))
