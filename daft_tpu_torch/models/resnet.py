"""ResNet-18 (port of ``daft_tpu/models/resnet.py``; image classification parity
with the reference's benchmark model, BASELINE.md row 'Image classification,
ResNet18').

The JAX model's arithmetic, layer for layer: convolutions in ``cfg.dtype``
(HWIO kernels become OIHW weights), BatchNorm in inference mode computed in
f32 from f32 scale, bias, mean and var (eps 1e-5) and rounded back to
``cfg.dtype``, max-pool padded with -inf, the 1x1 stride-2 shortcut without
padding (flax's ``SAME`` at these sizes), the global mean pooled in f32 and
rounded to ``cfg.dtype`` (``jnp.mean`` of a bf16 array), then an f32 Dense
head. Activations are NCHW views of NHWC memory (``channels_last``), the
JAX model's layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from daft_tpu_torch.device import resolve_device
from daft_tpu_torch.errors import DaftValueError

BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (2, 2, 2, 2)
    num_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16

    @staticmethod
    def tiny() -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=16)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True, dtype=float32)`` over the
    channels of an NCHW tensor: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in f32, in flax's order, cast to ``dtype``."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        c = (1, -1, 1, 1)
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale
        return ((x.float() - self.mean.view(c)) * mul.view(c) + self.bias.view(c)).to(dtype)


def _conv(c_in: int, c_out: int, k: int, stride: int, padding: int, dtype, device) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding, bias=False,
                     dtype=dtype, device=device)


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, filters: int, strides: int = 1,
                 dtype: Any = torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = _conv(c_in, filters, 3, strides, 1, dtype, device)
        self.bn0 = BatchNorm(filters, device)
        self.conv1 = _conv(filters, filters, 3, 1, 1, dtype, device)
        self.bn1 = BatchNorm(filters, device)
        # flax adds the projection where the residual's shape differs.
        self.shortcut = self.bn_shortcut = None
        if strides != 1 or c_in != filters:
            self.shortcut = _conv(c_in, filters, 1, strides, 0, dtype, device)
            self.bn_shortcut = BatchNorm(filters, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x), self.dtype))
        y = self.bn1(self.conv1(y), self.dtype)
        residual = x
        if self.shortcut is not None:
            residual = self.bn_shortcut(self.shortcut(x), self.dtype)
        return F.relu(y + residual)


class ResNet18(nn.Module):
    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.stem = _conv(3, cfg.width, 7, 2, 3, cfg.dtype, device)
        self.bn = BatchNorm(cfg.width, device)
        blocks, c_in = [], cfg.width
        for i, n_blocks in enumerate(cfg.stage_sizes):
            filters = cfg.width * (2 ** i)
            for j in range(n_blocks):
                strides = 2 if (i > 0 and j == 0) else 1
                blocks.append(BasicBlock(c_in, filters, strides, cfg.dtype, device))
                c_in = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(c_in, cfg.num_classes, dtype=torch.float32, device=device)
        self.register_buffer("pixel_mean", torch.tensor(IMAGENET_MEAN, device=device),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(IMAGENET_STD, device=device),
                             persistent=False)
        self.to(memory_format=torch.channels_last)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (B, H, W, 3) uint8 or float. Returns (B, num_classes) f32
        logits."""
        cfg = self.cfg
        x = pixels.to(torch.float32)
        if not torch.is_floating_point(pixels):
            x = x / 255.0
        x = ((x - self.pixel_mean) / self.pixel_std).to(cfg.dtype)
        x = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC batch
        x = F.relu(self.bn(self.stem(x), cfg.dtype))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.blocks:
            x = block(x)
        x = x.float().mean(dim=(2, 3)).to(cfg.dtype).float()
        return self.head(x)

    def flax_names(self) -> Dict[str, tuple]:
        """flax variable key (``params/...`` or ``batch_stats/...``) -> (torch
        parameter or buffer name, how it maps: ``conv`` HWIO -> OIHW, ``dense``
        (in, out) -> (out, in), ``same``)."""
        names: Dict[str, tuple] = {"params/stem/kernel": ("stem.weight", "conv"),
                                   "params/head/kernel": ("head.weight", "dense"),
                                   "params/head/bias": ("head.bias", "same")}

        def bn(flax: str, torch_name: str) -> None:
            for leaf in ("scale", "bias"):
                names[f"params/{flax}/{leaf}"] = (f"{torch_name}.{leaf}", "same")
            for leaf in ("mean", "var"):
                names[f"batch_stats/{flax}/{leaf}"] = (f"{torch_name}.{leaf}", "same")

        bn("BatchNorm_0", "bn")
        k = 0
        for i, n_blocks in enumerate(self.cfg.stage_sizes):
            for j in range(n_blocks):
                flax, block = f"stage{i}_block{j}", f"blocks.{k}"
                pairs = [("0", "conv0", "bn0"), ("1", "conv1", "bn1")]
                if self.blocks[k].shortcut is not None:
                    pairs.append(("2", "shortcut", "bn_shortcut"))
                for n, conv, norm in pairs:
                    names[f"params/{flax}/Conv_{n}/kernel"] = (f"{block}.{conv}.weight", "conv")
                    bn(f"{flax}/BatchNorm_{n}", f"{block}.{norm}")
                k += 1
        return names


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = value
    return flat


@torch.no_grad()
def load_flax_resnet(model: ResNet18, variables: Mapping) -> ResNet18:
    """Copy the JAX ``ResNet18``'s variables (``{"params": ...,
    "batch_stats": ...}``, nested, leaves as numpy arrays) into ``model``,
    each array cast to its parameter's or buffer's dtype. Every parameter
    and BatchNorm statistic must be filled and every key used: a missing or
    unknown key, or a shape that disagrees, raises."""
    names = model.flax_names()
    flat = _flatten(variables)
    missing = sorted(set(names) - set(flat))
    unknown = sorted(set(flat) - set(names))
    if missing or unknown:
        raise DaftValueError(f"ResNet variables: missing {missing}, unknown {unknown}")
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    for key, (tname, how) in names.items():
        a = np.asarray(flat[key], dtype=np.float32)
        if how == "conv":
            a = a.transpose(3, 2, 0, 1)
        elif how == "dense":
            a = a.T
        target = targets[tname]
        if tuple(a.shape) != tuple(target.shape):
            raise DaftValueError(
                f"ResNet variable {key!r} has shape {a.shape} for {tname} {tuple(target.shape)}")
        target.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(target.dtype))
    return model


@torch.no_grad()
def init_resnet_params(cfg: ResNetConfig, seed: int = 0, device=None) -> ResNet18:
    """A ``ResNet18`` on ``device`` (``resolve_device``: the GPU unless the
    caller asks for the CPU) with random weights from a ``torch.Generator``
    seeded with ``seed``, drawn in the order of ``named_parameters`` and then
    of the BatchNorm buffers: convolutions and the head normal with variance
    2 / fan_in, head bias 0, BatchNorm scale uniform in [0.5, 1.5], bias, mean
    normal(0, 0.1), var uniform in [0.5, 1.5]. flax's init leaves the
    statistics at 0 and 1, which would leave BatchNorm's arithmetic
    unexercised; the numbers are not ``jax.random``'s."""
    dev = resolve_device(device)
    model = ResNet18(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(t: torch.Tensor, kind: str, a: float, b: float) -> None:
        x = torch.empty(t.shape, dtype=torch.float32, device=dev)
        x = x.normal_(a, b, generator=gen) if kind == "normal" else x.uniform_(a, b, generator=gen)
        t.copy_(x)

    for name, p in model.named_parameters():
        if name.endswith(".scale"):
            draw(p, "uniform", 0.5, 1.5)
        elif name.endswith(".bias") and name != "head.bias":
            draw(p, "normal", 0.0, 0.1)
        elif name == "head.bias":
            p.zero_()
        else:
            draw(p, "normal", 0.0, (2.0 / (p[0].numel())) ** 0.5)
    for name, buf in model.named_buffers():
        if name.endswith(".mean"):
            draw(buf, "normal", 0.0, 0.1)
        elif name.endswith(".var"):
            draw(buf, "uniform", 0.5, 1.5)
    return model
