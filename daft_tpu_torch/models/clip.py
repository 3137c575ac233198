"""CLIP image and text towers and the dual encoder (port of
``daft_tpu/models/clip.py``).

``CLIPImageEncoder`` is the JAX package's forward step by step: pixels arrive
NHWC (uint8 or float in [0, 1]) and are normalised on the device, patchified,
given the class token and positions, ``ln_pre``, ``vision_layers`` pre-norm
``TransformerBlock``s, ``ln_post`` on the class token and the ``proj`` Dense in
f32. The patchify is a reshape and one matmul with the flax conv kernel (a
stride-p, kernel-p conv with no padding is exactly that); the JAX package left
it to XLA's convolution, and a plain product keeps the f32 path off cuDNN's
TF32 default. ``CLIPTextEncoder`` embeds token ids (f32 table, cast to the
model dtype, then the positions added in that dtype), runs causal pre-norm
blocks through the masked attention path, ``ln_final`` in f32 over every
position, pools each row's last non-pad token (or, for a converted
checkpoint, its end-of-text token) and projects in f32.
``CLIPModel`` holds both towers and the contrastive ``logit_scale``.

Parameters live in the dtype the JAX package computes in: the model dtype
(bf16 by default) for the patch embedding and the blocks, f32 for the
LayerNorms, ``cls``, the embeddings, ``proj`` and ``logit_scale``.
``init_random_`` fills them from an explicit ``torch.Generator`` on the
parameters' device; ``load_flax_params`` copies a flax state dict in.

A converted HF checkpoint (``models/convert.py``) sets the options only it
needs: the text tower's own activation and LayerNorm eps, and pooling at the
first end-of-text id or at the highest id instead of the last non-pad token.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.models.checkpoint import copy_flax_params, load_npz
from daft_tpu_torch.models.layers import (
    LayerNorm,
    TransformerBlock,
    causal_mask,
    flax_block_names,
    init_random_params_,
)

# flax's initial ``logit_scale`` (log 1/0.07).
LOGIT_SCALE_INIT = 2.6592


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
    # What only a converted HF checkpoint sets (models/convert.py): the text
    # tower's own activation and LayerNorm eps (None: the vision tower's),
    # and where it pools. "last_nonpad": the last non-pad token (the hashing
    # tokenizer's ids, pad = 0); "first_eos": the first position holding
    # ``eos_token_id``; "argmax_id": the position of the highest id (HF's
    # legacy branch for configs with eos_token_id 2, as OpenAI's ship, whose
    # end-of-text id is the top of the vocabulary).
    text_hidden_act: Optional[str] = None
    text_ln_eps: Optional[float] = None
    text_pool: str = "last_nonpad"
    eos_token_id: Optional[int] = None

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
    # The prefixes a flax key may carry above the tower's own names.
    flax_prefixes = ("params/vision/", "vision/")

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

    def flax_names(self) -> Dict[str, tuple]:
        """flax key (relative to the tower) -> (torch name, how it maps)."""
        names = {
            "cls": ("cls", "same"),
            "pos_embed": ("pos_embed", "same"),
            "patch_embed/kernel": ("patch_embed.weight", "conv"),
            "proj/kernel": ("proj.weight", "dense"),
        }
        for ln in ("ln_pre", "ln_post"):
            names[f"{ln}/scale"] = (f"{ln}.weight", "same")
            names[f"{ln}/bias"] = (f"{ln}.bias", "same")
        for i in range(self.cfg.vision_layers):
            names.update(flax_block_names(f"block_{i}", f"blocks.{i}"))
        return names


class CLIPTextEncoder(nn.Module):
    flax_prefixes = ("params/text/", "text/")

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.text_width
        act = cfg.text_hidden_act or cfg.hidden_act
        eps = cfg.ln_eps if cfg.text_ln_eps is None else cfg.text_ln_eps
        self.tok_embed = nn.Embedding(cfg.vocab_size, w, dtype=torch.float32, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.context_length, w, device=device))
        self.blocks = nn.ModuleList(
            TransformerBlock(w, cfg.text_heads, cfg.text_mlp_ratio, cfg.dtype, act, eps,
                             device=device)
            for _ in range(cfg.text_layers))
        self.ln_final = LayerNorm(w, eps, device=device)
        self.proj = nn.Linear(w, cfg.embed_dim, bias=False, dtype=torch.float32, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, L) int32 or int64, L <= context_length. Returns
        (B, embed_dim) f32, the projection of each row's pooled token."""
        cfg = self.cfg
        L = tokens.shape[1]
        # Cast, then add: the JAX tower adds the positions in the model dtype.
        x = self.tok_embed(tokens).to(cfg.dtype) + self.pos_embed[:, :L].to(cfg.dtype)
        mask = causal_mask(L, device=tokens.device)
        for block in self.blocks:
            x = block(x, mask)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), self.pool_positions(
            tokens, cfg.text_pool, cfg.eos_token_id)]
        return self.proj(pooled)

    @staticmethod
    def pool_positions(tokens: torch.Tensor, text_pool: str = "last_nonpad",
                       eos_token_id: Optional[int] = None) -> torch.Tensor:
        """Each row's pooled position by ``text_pool`` (``CLIPConfig``): the
        last non-pad token (an all-pad row pools position 0), the first
        ``eos_token_id`` (position 0 where there is none; a vocabulary id 0
        mid-sequence does not move it) or the highest id, the first of ties."""
        if text_pool == "first_eos" and eos_token_id is not None:
            return torch.argmax((tokens == eos_token_id).to(torch.int32), dim=1)
        if text_pool == "argmax_id":
            return torch.argmax(tokens, dim=1)
        return ((tokens != 0).sum(dim=1) - 1).clamp(min=0)

    def flax_names(self) -> Dict[str, tuple]:
        """flax key (relative to the tower) -> (torch name, how it maps)."""
        names = {
            "tok_embed/embedding": ("tok_embed.weight", "same"),
            "pos_embed": ("pos_embed", "same"),
            "ln_final/scale": ("ln_final.weight", "same"),
            "ln_final/bias": ("ln_final.bias", "same"),
            "proj/kernel": ("proj.weight", "dense"),
        }
        for i in range(self.cfg.text_layers):
            names.update(flax_block_names(f"block_{i}", f"blocks.{i}"))
        return names


def l2_normalize(emb: torch.Tensor) -> torch.Tensor:
    """``emb`` over its L2 norm, the norm clipped at 1e-6."""
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-6)


class CLIPModel(nn.Module):
    """Both towers and the contrastive logit scale."""

    flax_prefixes = ("params/",)

    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.vision = CLIPImageEncoder(cfg, device=device)
        self.text = CLIPTextEncoder(cfg, device=device)
        self.logit_scale = nn.Parameter(
            torch.tensor(LOGIT_SCALE_INIT, dtype=torch.float32, device=device))

    def forward(self, pixels: torch.Tensor, tokens: torch.Tensor):
        """Returns (logits (B_img, B_txt), img, txt): the L2-normalised
        embeddings and exp(logit_scale) times their cosine similarities."""
        img = l2_normalize(self.vision(pixels))
        txt = l2_normalize(self.text(tokens))
        logits = torch.exp(self.logit_scale) * img @ txt.T
        return logits, img, txt

    def flax_names(self) -> Dict[str, tuple]:
        """flax key (below ``params/``) -> (torch name, how it maps)."""
        names = {"logit_scale": ("logit_scale", "same")}
        for tower in ("vision", "text"):
            names.update({f"{tower}/{k}": (f"{tower}.{t}", how)
                          for k, (t, how) in getattr(self, tower).flax_names().items()})
        return names


CLIPModule = Union[CLIPImageEncoder, CLIPTextEncoder, CLIPModel]


def embed(encoder: Union[CLIPImageEncoder, CLIPTextEncoder], inputs: torch.Tensor) -> torch.Tensor:
    """``encoder``'s embeddings of ``inputs`` (pixels or token ids),
    L2-normalised with the norm clipped at 1e-6 (the forwards of
    ``daft_tpu/ai/flax_provider.py``)."""
    with torch.inference_mode():
        return l2_normalize(encoder(inputs))


# The embeddings flax draws from normal(std), by torch name.
_EMBED_STD = {"vision": {"cls": 0.02, "pos_embed": 0.02},
              "text": {"tok_embed.weight": 0.02, "pos_embed": 0.01}}


@torch.no_grad()
def init_random_(module: CLIPModule, generator: torch.Generator) -> CLIPModule:
    """Random weights from ``generator`` (``layers.init_random_params_``):
    normal(0.02) for ``cls``, the vision ``pos_embed`` and the token table,
    normal(0.01) for the text ``pos_embed``, as flax draws them; a
    ``CLIPModel``'s ``logit_scale`` takes flax's 2.6592."""
    if isinstance(module, CLIPModel):
        module.logit_scale.fill_(LOGIT_SCALE_INIT)
        std = {f"{tower}.{k}": v for tower, table in _EMBED_STD.items() for k, v in table.items()}
    else:
        std = _EMBED_STD["vision" if isinstance(module, CLIPImageEncoder) else "text"]
    return init_random_params_(module, generator, std)


def load_flax_params(module: CLIPModule, flat: Dict[str, np.ndarray]) -> list:
    """Copy a flat flax state dict (``/``-joined keys, as the JAX package's
    ``.npz`` checkpoints hold them) into a tower or a ``CLIPModel``. A tower
    takes keys relative to itself (``block_0/attn/qkv/kernel``) or under the
    full model's prefix (``params/vision/block_0/attn/qkv/kernel``) and
    ignores the other tower's; a ``CLIPModel`` takes ``params/vision/...``,
    ``params/text/...`` and ``params/logit_scale``. The patch conv kernel
    (p, p, 3, w) becomes the patchify weight (w, p*p*3), the token table
    (vocab, width) the ``nn.Embedding`` weight as it is
    (``checkpoint.copy_flax_params``). Returns the torch names loaded; raises
    if none matched or a shape disagrees."""
    return copy_flax_params(module, flat, module.flax_names(), module.flax_prefixes,
                            type(module).__name__)


def load_params(path: str, module: CLIPModule) -> CLIPModule:
    """Load a JAX-package ``.npz`` checkpoint into ``module``."""
    load_flax_params(module, load_npz(path))
    return module
