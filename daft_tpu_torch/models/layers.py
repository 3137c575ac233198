"""Shared transformer building blocks (port of ``daft_tpu/models/layers.py``).

The JAX package's mixed precision is kept: matmuls run in the model dtype
(bf16 by default), LayerNorm runs in f32 with eps 1e-6 and is cast back, and
attention accumulates in f32. Module and parameter names follow the flax
layout (``qkv``, ``out``, ``fc1``, ``fc2``, ``ln1``, ``ln2``) so that
``models/clip.py::load_flax_params`` maps a flax checkpoint name for name.

``MultiHeadAttention`` has two paths. Without a mask it always goes through
``ops/flash_attention.flash_attention`` (the CUDA kernel on a GPU tensor).
With a mask (the text towers' causal and key-padding masks) it runs
``masked_attention``, plain torch with the arithmetic of the JAX package's
``jax.nn.dot_product_attention``; the JAX package leaves that path to XLA, so
no hand-written kernel stands behind it, and it never reaches the mask-free
kernel or PyTorch's fused attention (SDPA).

Under a mesh with a ``tp`` axis (``parallel/mesh.py::shard_module_``) a Dense
layer whose spec splits it becomes a ``ShardedLinear``: one weight shard per
tp device, the outputs gathered (column shards) or the partial products
summed in f32 (row shards) on the lead device. ``qkv``'s columns are
``[q | k | v]``, so its shards are not head-aligned (at ViT-L/14 and tp 4 the
second shard holds q's last 256 columns and k's first 512): its output is
gathered before the heads split, and attention runs once, on the lead
device. Without a mesh, or at tp 1, no layer is replaced.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.ops.flash_attention import flash_attention

# What jax.nn.dot_product_attention writes into a masked logit: a large
# finite number, not -inf, so a row whose keys are all masked (an empty
# string, a padded row) softmaxes to a uniform row instead of NaN.
MASK_FILL = -0.7 * torch.finfo(torch.float32).max


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


class ShardedLinear(nn.Module):
    """A Dense layer split over the tensor-parallel devices ``devices``, one
    weight shard on each; the input arrives and the output leaves on the
    lead device, ``devices[0]``. ``column``: shard i holds outputs
    ``[i*n, (i+1)*n)`` with their bias, and the shards' outputs are
    concatenated on the lead device. ``row``: shard i holds inputs
    ``[i*n, (i+1)*n)``, multiplies its slice of the input, and the partial
    products are summed on the lead device in f32 with the bias, then cast
    back to the input's dtype."""

    def __init__(self, kind: str, in_features: int, out_features: int, devices: list,
                 weights: list, biases: Optional[list], bias: Optional[torch.Tensor]):
        super().__init__()
        self.kind = kind
        self.in_features, self.out_features = in_features, out_features
        self.devices = list(devices)
        self.weights = nn.ParameterList(weights)
        self.biases = nn.ParameterList(biases) if biases is not None else None
        self.bias = bias

    @classmethod
    @torch.no_grad()
    def from_linear(cls, linear: nn.Linear, kind: str, devices: list) -> "ShardedLinear":
        """``linear`` split into ``len(devices)`` shards by ``kind``; each
        shard is a copy of its own, so the whole weight can be freed."""
        tp = len(devices)
        dim = {"column": 0, "row": 1}[kind]
        size = linear.weight.shape[dim]
        if size % tp:
            raise DaftValueError(f"{kind} shards of a Linear of {size} features over {tp} "
                                 f"devices do not divide")
        n = size // tp
        grad = linear.weight.requires_grad

        def copy_to(t: torch.Tensor, dev) -> nn.Parameter:
            out = torch.empty(t.shape, dtype=t.dtype, device=dev)
            return nn.Parameter(out.copy_(t), requires_grad=grad)

        weights = [copy_to(linear.weight.narrow(dim, i * n, n), d) for i, d in enumerate(devices)]
        biases, bias = None, None
        if linear.bias is not None and kind == "column":
            biases = [copy_to(linear.bias.narrow(0, i * n, n), d) for i, d in enumerate(devices)]
        elif linear.bias is not None:
            bias = copy_to(linear.bias, devices[0])
        return cls(kind, linear.in_features, linear.out_features, devices, weights, biases, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = self.devices[0]
        if self.kind == "column":
            biases = self.biases if self.biases is not None else [None] * len(self.weights)
            outs = [F.linear(x.to(d), w, b) for d, w, b in zip(self.devices, self.weights, biases)]
            return torch.cat([o.to(lead) for o in outs], dim=-1)
        n = self.in_features // len(self.weights)
        acc = None
        for i, (d, w) in enumerate(zip(self.devices, self.weights)):
            part = F.linear(x[..., i * n:(i + 1) * n].to(d), w).to(lead, torch.float32)
            acc = part if acc is None else acc + part
        if self.bias is not None:
            acc = acc + self.bias.float()
        return acc.to(x.dtype)

    def shard_nbytes(self) -> List[int]:
        """The bytes of weights (and biases) each shard holds; a row layer's
        bias counts on the lead device's shard."""
        out = [w.numel() * w.element_size() for w in self.weights]
        if self.biases is not None:
            out = [o + b.numel() * b.element_size() for o, b in zip(out, self.biases)]
        if self.bias is not None:
            out[0] += self.bias.numel() * self.bias.element_size()
        return out


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        if dim % num_heads:
            raise DaftValueError(f"width {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.out = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, T, dim). ``mask``: bool, True where a query may attend to a
        key, of shape (1|B, 1, T, T) (causal) or (B, 1, 1, T) (key padding)."""
        B, T, d = x.shape
        # Views into the fused qkv output in (B, T, H, head_dim): the kernel
        # reads them through their strides, nothing is copied.
        q, k, v = (t.view(B, T, self.num_heads, d // self.num_heads)
                   for t in self.qkv(x).split(d, dim=-1))
        if mask is None:
            out = flash_attention(q, k, v)
        else:
            out = masked_attention(q, k, v, mask)
        return self.out(out.reshape(B, T, d))


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Softmax attention over (B, T, H, D) with a bool ``mask`` broadcast to
    (B, H, T, T), as ``jax.nn.dot_product_attention`` computes it: q·k
    accumulated in f32 (bf16 products are exact in f32, so this is XLA's
    BF16_BF16_F32) and scaled by D ** -0.5 in f32 (in the product's
    epilogue), masked logits set to ``MASK_FILL``, softmax in f32, the
    probabilities cast to v's dtype for the product with v. The f32 logits
    take B·H·T² elements; no more than two such f32 tensors are alive at once."""
    B, T, H, D = q.shape
    if mask.dtype != torch.bool or mask.dim() != 4:
        raise DaftValueError(
            f"attention mask must be a 4-D bool tensor, got {mask.dtype} {tuple(mask.shape)}")
    # Inverted before it is broadcast, so no (B, H, T, T) bool is written.
    masked_out = (~mask).expand(B, H if mask.shape[1] == 1 else mask.shape[1], T, T)
    # The logits are referenced only by softmax's argument, so they are freed
    # before P is cast.
    probs = torch.softmax(_scaled_logits(q, k).masked_fill_(masked_out, MASK_FILL), dim=-1)
    return torch.matmul(probs.to(v.dtype), v.transpose(1, 2)).transpose(1, 2)


def _scaled_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, T, T) f32 q·kᵀ · D ** -0.5 from (B, T, H, D) q and k."""
    B, T, H, D = q.shape
    qf, kf = (t.permute(0, 2, 1, 3).to(torch.float32, memory_format=torch.contiguous_format)
              .reshape(B * H, T, D) for t in (q, k))
    # beta=0 ignores the (broadcast) input; alpha scales in the epilogue.
    return torch.baddbmm(qf.new_zeros(1, 1, 1), qf, kf.transpose(1, 2),
                         beta=0.0, alpha=D ** -0.5).view(B, H, T, T)


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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x).to(self.dtype), mask)
        return x + self.mlp(self.ln2(x).to(self.dtype))


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) bool, True on and below the diagonal."""
    return torch.tril(torch.ones((1, 1, seq_len, seq_len), dtype=torch.bool, device=device))


def sinusoidal_positions(length: int, dim: int) -> torch.Tensor:
    """(length, dim) f32: sin on the even columns, cos on the odd ones."""
    pos = torch.arange(length, dtype=torch.float32)[:, None]
    rate = -torch.log(torch.tensor(10000.0)) / dim
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * rate)
    out = torch.zeros((length, dim), dtype=torch.float32)
    out[:, 0::2] = torch.sin(pos * div)
    out[:, 1::2] = torch.cos(pos * div)
    return out


def flax_block_names(flax_prefix: str, torch_prefix: str) -> Dict[str, tuple]:
    """The flax keys of one ``TransformerBlock`` (``block_0/attn/qkv/kernel``)
    -> (torch parameter name, how the array maps onto it): a Dense kernel
    (in, out) is transposed onto a Linear weight, the rest copy as they are."""
    names = {}
    for ln in ("ln1", "ln2"):
        names[f"{flax_prefix}/{ln}/scale"] = (f"{torch_prefix}.{ln}.weight", "same")
        names[f"{flax_prefix}/{ln}/bias"] = (f"{torch_prefix}.{ln}.bias", "same")
    for dense in ("attn/qkv", "attn/out", "mlp/fc1", "mlp/fc2"):
        tname = f"{torch_prefix}.{dense.replace('/', '.')}"
        names[f"{flax_prefix}/{dense}/kernel"] = (f"{tname}.weight", "dense")
        names[f"{flax_prefix}/{dense}/bias"] = (f"{tname}.bias", "same")
    return names


@torch.no_grad()
def init_random_params_(module: nn.Module, generator: torch.Generator,
                        normal_std: Dict[str, float]) -> nn.Module:
    """Random weights from ``generator``, made on the parameters' device, in
    the order of ``named_parameters``: normal with the given std for the
    parameters ``normal_std`` names (embeddings, as in flax), normal with
    variance 1/fan_in for every other Linear weight, zero biases, unit
    LayerNorms. The numbers are not ``jax.random``'s."""
    for name, param in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in normal_std:
            param.copy_(torch.randn(param.shape, generator=generator, device=param.device)
                        * normal_std[name])
        elif leaf == "weight" and param.dim() == 2:
            std = 1.0 / math.sqrt(param.shape[1])
            param.copy_(torch.randn(param.shape, generator=generator, device=param.device) * std)
        elif leaf == "bias":
            param.zero_()
        elif leaf == "weight":
            param.fill_(1.0)
    return module
