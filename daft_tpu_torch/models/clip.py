"""CLIP image tower (port of ``daft_tpu/models/clip.py``).

``CLIPImageEncoder`` is the JAX package's forward step by step: pixels arrive
NHWC (uint8 or float in [0, 1]) and are normalised on the device, patchified,
given the class token and positions, ``ln_pre``, ``vision_layers`` pre-norm
``TransformerBlock``s, ``ln_post`` on the class token and the ``proj`` Dense in
f32. The patchify is a reshape and one matmul with the flax conv kernel (a
stride-p, kernel-p conv with no padding is exactly that); the JAX package left
it to XLA's convolution, and a plain product keeps the f32 path off cuDNN's
TF32 default.

Parameters live in the dtype the JAX package computes in: the model dtype
(bf16 by default) for the patch embedding and the blocks, f32 for the
LayerNorms, ``cls``, ``pos_embed`` and ``proj``. ``init_random_`` fills them
from an explicit ``torch.Generator`` on the parameters' device;
``load_flax_params`` copies a flax state dict in.

Not ported yet: ``CLIPTextEncoder`` and ``CLIPModel`` (the text tower and the
contrastive head), and HF checkpoint conversion (``models/convert.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.models.layers import LayerNorm, TransformerBlock


@dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 224
    patch_size: int = 14
    vision_width: int = 1024
    vision_layers: int = 24
    vision_heads: int = 16
    text_width: int = 768
    text_layers: int = 12
    text_heads: int = 12
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 768
    dtype: Any = torch.bfloat16
    hidden_act: str = "gelu"
    ln_eps: float = 1e-6
    vision_mlp_ratio: float = 4.0
    text_mlp_ratio: float = 4.0

    @staticmethod
    def vit_b_32() -> "CLIPConfig":
        return CLIPConfig(patch_size=32, vision_width=768, vision_layers=12,
                          vision_heads=12, text_width=512, text_layers=12,
                          text_heads=8, embed_dim=512)

    @staticmethod
    def vit_b_16() -> "CLIPConfig":
        return CLIPConfig(patch_size=16, vision_width=768, vision_layers=12,
                          vision_heads=12, text_width=512, text_layers=12,
                          text_heads=8, embed_dim=512)

    @staticmethod
    def vit_l_14() -> "CLIPConfig":
        return CLIPConfig()  # defaults are ViT-L/14

    @staticmethod
    def tiny() -> "CLIPConfig":
        """Test-sized config."""
        return CLIPConfig(image_size=32, patch_size=16, vision_width=64,
                          vision_layers=2, vision_heads=2, text_width=64,
                          text_layers=2, text_heads=2, vocab_size=512,
                          context_length=16, embed_dim=32)

    @staticmethod
    def from_name(name: str) -> "CLIPConfig":
        key = name.lower().replace("openai/clip-", "").replace("clip-", "")
        table = {
            "vit-b/32": CLIPConfig.vit_b_32, "vit-base-patch32": CLIPConfig.vit_b_32,
            "vit-b/16": CLIPConfig.vit_b_16, "vit-base-patch16": CLIPConfig.vit_b_16,
            "vit-l/14": CLIPConfig.vit_l_14, "vit-large-patch14": CLIPConfig.vit_l_14,
            "tiny": CLIPConfig.tiny,
        }
        if key in table:
            return table[key]()
        return CLIPConfig.vit_l_14()


# OpenAI CLIP normalisation constants.
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


class CLIPImageEncoder(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        if cfg.image_size % cfg.patch_size:
            raise DaftValueError(
                f"image_size {cfg.image_size} is not a multiple of patch_size {cfg.patch_size}")
        self.cfg = cfg
        w, p = cfg.vision_width, cfg.patch_size
        n_patches = (cfg.image_size // p) ** 2
        self.register_buffer("mean", torch.tensor(CLIP_IMAGE_MEAN, device=device), persistent=False)
        self.register_buffer("std", torch.tensor(CLIP_IMAGE_STD, device=device), persistent=False)
        # The flax conv kernel (p, p, 3, w) flattened to (p*p*3, w), stored as
        # a Linear weight (w, p*p*3).
        self.patch_embed = nn.Linear(p * p * 3, w, bias=False, dtype=cfg.dtype, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, w, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, w, device=device))
        self.ln_pre = LayerNorm(w, cfg.ln_eps, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(w, cfg.vision_heads, cfg.vision_mlp_ratio, cfg.dtype,
                             cfg.hidden_act, cfg.ln_eps, device=device)
            for _ in range(cfg.vision_layers))
        self.ln_post = LayerNorm(w, cfg.ln_eps, device=device)
        self.proj = nn.Linear(w, cfg.embed_dim, bias=False, dtype=torch.float32, device=device)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (B, H, W, 3) uint8, or float in [0, 1]. Returns (B, embed_dim) f32."""
        cfg = self.cfg
        x = pixels.float()
        if not pixels.is_floating_point():
            x = x / 255.0
        x = ((x - self.mean) / self.std).to(cfg.dtype)
        B, H, W, C = x.shape
        p = cfg.patch_size
        patches = (x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
                   .reshape(B, (H // p) * (W // p), p * p * C))
        x = self.patch_embed(patches)
        cls = self.cls.to(cfg.dtype).expand(B, 1, cfg.vision_width)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        x = self.ln_pre(x).to(cfg.dtype)
        for block in self.blocks:
            x = block(x)
        return self.proj(self.ln_post(x[:, 0]))


def embed(encoder: CLIPImageEncoder, pixels: torch.Tensor) -> torch.Tensor:
    """``encoder``'s embeddings of ``pixels``, L2-normalised with the norm
    clipped at 1e-6 (``daft_tpu/ai/flax_provider.py``'s forward)."""
    with torch.inference_mode():
        emb = encoder(pixels)
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-6)


@torch.no_grad()
def init_random_(encoder: CLIPImageEncoder, generator: torch.Generator) -> CLIPImageEncoder:
    """Random weights from ``generator``, made on the parameters' device:
    normal(0.02) for ``cls``/``pos_embed`` as in flax, normal with variance
    1/fan_in for every Linear weight, zero biases, unit LayerNorms. The numbers
    are not ``jax.random``'s."""
    for name, param in encoder.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in ("cls", "pos_embed"):
            param.copy_(torch.randn(param.shape, generator=generator, device=param.device) * 0.02)
        elif leaf == "weight" and param.dim() == 2:
            std = 1.0 / math.sqrt(param.shape[1])
            param.copy_(torch.randn(param.shape, generator=generator, device=param.device) * std)
        elif leaf == "bias":
            param.zero_()
        elif leaf == "weight":
            param.fill_(1.0)
    return encoder


def _flax_to_torch_names(cfg: CLIPConfig) -> Dict[str, tuple]:
    """flax state-dict key (relative to the vision tower) -> (torch parameter
    name, how the array maps onto it)."""
    names = {
        "cls": ("cls", "same"),
        "pos_embed": ("pos_embed", "same"),
        "patch_embed/kernel": ("patch_embed.weight", "conv"),
        "proj/kernel": ("proj.weight", "dense"),
    }
    for ln in ("ln_pre", "ln_post"):
        names[f"{ln}/scale"] = (f"{ln}.weight", "same")
        names[f"{ln}/bias"] = (f"{ln}.bias", "same")
    for i in range(cfg.vision_layers):
        for ln in ("ln1", "ln2"):
            names[f"block_{i}/{ln}/scale"] = (f"blocks.{i}.{ln}.weight", "same")
            names[f"block_{i}/{ln}/bias"] = (f"blocks.{i}.{ln}.bias", "same")
        for dense in ("attn/qkv", "attn/out", "mlp/fc1", "mlp/fc2"):
            tname = f"blocks.{i}.{dense.replace('/', '.')}"
            names[f"block_{i}/{dense}/kernel"] = (f"{tname}.weight", "dense")
            names[f"block_{i}/{dense}/bias"] = (f"{tname}.bias", "same")
    return names


_VISION_PREFIXES = ("params/vision/", "vision/")


@torch.no_grad()
def load_flax_params(encoder: CLIPImageEncoder, flat: Dict[str, np.ndarray]) -> list:
    """Copy a flat flax state dict (``/``-joined keys, as the JAX package's
    ``.npz`` checkpoints hold them) into ``encoder``. Keys may be relative to
    the vision tower (``block_0/attn/qkv/kernel``) or carry the full model's
    prefix (``params/vision/block_0/attn/qkv/kernel``); other towers' keys are
    ignored, and parameters the dict lacks keep their values, as the JAX
    loader does. A Dense kernel (in, out) becomes a Linear weight (out, in);
    the patch conv kernel (p, p, 3, w) becomes the patchify weight
    (w, p*p*3); LayerNorm scale/bias, ``cls`` and ``pos_embed`` copy as they
    are. Each array is cast to its parameter's dtype. Returns the torch names
    loaded; raises if none matched or a shape disagrees."""
    params = dict(encoder.named_parameters())
    names = _flax_to_torch_names(encoder.cfg)
    loaded = []
    for key, arr in flat.items():
        for prefix in _VISION_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key not in names:
            continue
        tname, how = names[key]
        a = np.asarray(arr, dtype=np.float32)
        if how == "dense":
            a = a.T
        elif how == "conv":
            a = a.reshape(-1, a.shape[-1]).T
        target = params[tname]
        if tuple(a.shape) != tuple(target.shape):
            raise DaftValueError(
                f"checkpoint {key!r} has shape {a.shape} for {tname} {tuple(target.shape)}")
        target.copy_(torch.tensor(a, dtype=target.dtype))
        loaded.append(tname)
    if not loaded:
        raise DaftValueError("no CLIP vision-tower parameter found in the checkpoint")
    return loaded


def load_params(path: str, encoder: CLIPImageEncoder) -> CLIPImageEncoder:
    """Load a JAX-package ``.npz`` checkpoint into ``encoder``."""
    from daft_tpu_torch.models.checkpoint import load_npz

    load_flax_params(encoder, load_npz(path))
    return encoder
