"""Local HF checkpoint directories -> the port's modules (port of
``daft_tpu/models/convert.py``).

A local HF checkpoint directory holds ``config.json``, the weights
(``model.safetensors`` or ``pytorch_model.bin``) and its tokenizer files.
``convert_bert`` and ``convert_clip`` turn an HF ``BertModel`` /
``CLIPModel`` state dict into the flat flax state dict that the JAX
package's converter makes, key for key (``/``-joined, below ``params/``):
a torch Linear weight (out, in) becomes a flax kernel (in, out), the q / k /
v projections of a CLIP layer concatenate into the fused ``qkv`` Dense, the
patch conv weight (w, 3, p, p) becomes the flax kernel (p, p, 3, w).
``load_hf_checkpoint`` builds ``models/bert.py::BertEncoder`` or a CLIP
tower or ``CLIPModel`` from ``config.json`` and copies that dict in
(``checkpoint.copy_flax_params``). Unlike an ``.npz`` checkpoint, an HF
checkpoint must fill every parameter: a missing tensor raises ``KeyError``
while converting, as in the JAX package, and a parameter the dict leaves
unset raises, so no random value is ever served in place of a weight.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.models import bert, clip
from daft_tpu_torch.models.checkpoint import copy_flax_params


def is_hf_checkpoint_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json"))


def hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def load_hf_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Numpy state dict from a local HF checkpoint directory: safetensors
    where the package imports, else ``pytorch_model.bin`` (or ``.pt``)
    through ``torch.load(weights_only=True)``."""
    st = os.path.join(path, "model.safetensors")
    safetensors_blocked = False
    if os.path.exists(st):
        try:
            from safetensors.numpy import load_file

            return dict(load_file(st))
        except ImportError:
            safetensors_blocked = True  # fall through to .bin, but say so on failure
    for name in ("pytorch_model.bin", "pytorch_model.pt"):
        binp = os.path.join(path, name)
        if os.path.exists(binp):
            sd = torch.load(binp, map_location="cpu", weights_only=True)
            return {k: v.detach().numpy() for k, v in sd.items()}
    if safetensors_blocked:
        raise DaftValueError(
            f"{path!r} has model.safetensors but the safetensors package is "
            f"not installed and no pytorch_model.bin fallback exists")
    raise DaftValueError(
        f"No loadable weights (model.safetensors / pytorch_model.bin) in {path!r}")


def _strip_prefix(sd: Dict[str, np.ndarray], prefixes=("bert.", "model.")) -> Dict[str, np.ndarray]:
    """Drop the first of ``prefixes`` that some key carries (sentence-
    transformers and task-head checkpoints nest the encoder under it)."""
    for p in prefixes:
        if any(k.startswith(p) for k in sd):
            return {k[len(p):] if k.startswith(p) else k: v for k, v in sd.items()}
    return sd


def _dense(sd, name: str, key: str) -> Dict[str, np.ndarray]:
    out = {f"{key}/kernel": sd[f"{name}.weight"].T.copy()}
    if f"{name}.bias" in sd:
        out[f"{key}/bias"] = sd[f"{name}.bias"].copy()
    return out


def _ln(sd, name: str, key: str) -> Dict[str, np.ndarray]:
    return {f"{key}/scale": sd[f"{name}.weight"].copy(), f"{key}/bias": sd[f"{name}.bias"].copy()}


# --------------------------------------------------------------------------- #
# BERT (the MiniLM family)                                                    #
# --------------------------------------------------------------------------- #
def convert_bert(sd: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """HF BertModel state dict -> the flat flax dict of ``BertEncoder``."""
    sd = _strip_prefix(sd)
    e = "embeddings"
    flat = {f"params/{n}/embedding": sd[f"{e}.{n}.weight"].copy()
            for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    flat.update(_ln(sd, f"{e}.LayerNorm", "params/emb_ln"))
    for i in range(cfg.layers):
        p, key = f"encoder.layer.{i}", f"params/layer_{i}"
        for name, sub in (("q", "attention.self.query"), ("k", "attention.self.key"),
                          ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                          ("fc1", "intermediate.dense"), ("fc2", "output.dense")):
            flat.update(_dense(sd, f"{p}.{sub}", f"{key}/{name}"))
        flat.update(_ln(sd, f"{p}.attention.output.LayerNorm", f"{key}/attn_ln"))
        flat.update(_ln(sd, f"{p}.output.LayerNorm", f"{key}/out_ln"))
    return flat


# --------------------------------------------------------------------------- #
# CLIP                                                                        #
# --------------------------------------------------------------------------- #
def _clip_block(sd, p: str, key: str) -> Dict[str, np.ndarray]:
    """One HF CLIPEncoderLayer -> ``layers.TransformerBlock`` (fused qkv)."""
    flat = {f"{key}/attn/qkv/kernel": np.concatenate(
                [sd[f"{p}.self_attn.{x}_proj.weight"].T for x in ("q", "k", "v")], axis=1),
            f"{key}/attn/qkv/bias": np.concatenate(
                [sd[f"{p}.self_attn.{x}_proj.bias"] for x in ("q", "k", "v")])}
    flat.update(_ln(sd, f"{p}.layer_norm1", f"{key}/ln1"))
    flat.update(_ln(sd, f"{p}.layer_norm2", f"{key}/ln2"))
    flat.update(_dense(sd, f"{p}.self_attn.out_proj", f"{key}/attn/out"))
    flat.update(_dense(sd, f"{p}.mlp.fc1", f"{key}/mlp/fc1"))
    flat.update(_dense(sd, f"{p}.mlp.fc2", f"{key}/mlp/fc2"))
    return flat


def convert_clip(sd: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """HF CLIPModel state dict -> the flat flax dict of ``CLIPModel``."""
    v, vk = "vision_model", "params/vision"
    # HF's vision pre-LN is spelled "pre_layrnorm" (sic) in released
    # checkpoints; newer configs use "pre_layernorm".
    pre_ln = f"{v}.pre_layrnorm" if f"{v}.pre_layrnorm.weight" in sd else f"{v}.pre_layernorm"
    flat = {
        f"{vk}/patch_embed/kernel":
            sd[f"{v}.embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0).copy(),
        f"{vk}/cls": sd[f"{v}.embeddings.class_embedding"].reshape(1, 1, -1).copy(),
        f"{vk}/pos_embed": sd[f"{v}.embeddings.position_embedding.weight"][None].copy(),
        f"{vk}/proj/kernel": sd["visual_projection.weight"].T.copy(),
    }
    flat.update(_ln(sd, pre_ln, f"{vk}/ln_pre"))
    flat.update(_ln(sd, f"{v}.post_layernorm", f"{vk}/ln_post"))
    for i in range(cfg.vision_layers):
        flat.update(_clip_block(sd, f"{v}.encoder.layers.{i}", f"{vk}/block_{i}"))
    t, tk = "text_model", "params/text"
    flat.update({
        f"{tk}/tok_embed/embedding": sd[f"{t}.embeddings.token_embedding.weight"].copy(),
        f"{tk}/pos_embed": sd[f"{t}.embeddings.position_embedding.weight"][None].copy(),
        f"{tk}/proj/kernel": sd["text_projection.weight"].T.copy(),
    })
    flat.update(_ln(sd, f"{t}.final_layer_norm", f"{tk}/ln_final"))
    for i in range(cfg.text_layers):
        flat.update(_clip_block(sd, f"{t}.encoder.layers.{i}", f"{tk}/block_{i}"))
    flat["params/logit_scale"] = np.asarray(
        sd.get("logit_scale", np.asarray(2.6592, np.float32)), np.float32)
    return flat


def clip_config_from_hf(d: dict, dtype=torch.float32) -> clip.CLIPConfig:
    """``CLIPConfig`` from an HF CLIPModel ``config.json`` dict."""
    tc, vc = d["text_config"], d["vision_config"]
    act = vc.get("hidden_act", "quick_gelu")
    tact = tc.get("hidden_act", "quick_gelu")
    return clip.CLIPConfig(
        image_size=vc.get("image_size", 224),
        patch_size=vc.get("patch_size", 32),
        vision_width=vc.get("hidden_size", 768),
        vision_layers=vc.get("num_hidden_layers", 12),
        vision_heads=vc.get("num_attention_heads", 12),
        text_width=tc.get("hidden_size", 512),
        text_layers=tc.get("num_hidden_layers", 12),
        text_heads=tc.get("num_attention_heads", 8),
        vocab_size=tc.get("vocab_size", 49408),
        context_length=tc.get("max_position_embeddings", 77),
        embed_dim=d.get("projection_dim", 512),
        dtype=dtype,
        hidden_act="gelu_exact" if act == "gelu" else act,
        text_hidden_act="gelu_exact" if tact == "gelu" else tact,
        ln_eps=vc.get("layer_norm_eps", 1e-5),
        text_ln_eps=tc.get("layer_norm_eps", 1e-5),
        # transformers' CLIPTextTransformer takes eos_token_id == 2 as the
        # legacy marker (OpenAI's configs) and pools at the highest id (the
        # end-of-text id tops the vocabulary); any other value pools at the
        # first position holding it.
        text_pool="argmax_id" if tc.get("eos_token_id", 49407) == 2 else "first_eos",
        eos_token_id=tc.get("eos_token_id", 49407),
        vision_mlp_ratio=vc.get("intermediate_size", vc.get("hidden_size", 768) * 4)
        / vc.get("hidden_size", 768),
        text_mlp_ratio=tc.get("intermediate_size", tc.get("hidden_size", 512) * 4)
        / tc.get("hidden_size", 512),
    )


# --------------------------------------------------------------------------- #
# Entry point                                                                 #
# --------------------------------------------------------------------------- #
def load_hf_checkpoint(path: str, dtype=torch.float32, device="cpu",
                       tower: Optional[str] = None) -> Tuple[str, nn.Module]:
    """(model_type, module) from a local HF checkpoint directory, every
    parameter on ``device`` from the checkpoint, frozen and in eval mode.
    ``bert`` gives a ``BertEncoder``; ``clip`` a ``CLIPModel``, or only its
    ``"vision"`` or ``"text"`` tower."""
    cfgd = hf_config(path)
    mtype = cfgd.get("model_type", "")
    if mtype not in ("bert", "clip"):
        raise DaftValueError(
            f"Unsupported model_type {mtype!r} in {path}/config.json (supported: bert, clip)")
    sd = load_hf_state_dict(path)
    if mtype == "bert":
        cfg = bert.BertConfig.from_hf(cfgd, dtype=dtype)
        module, flat = bert.BertEncoder(cfg, device=device), convert_bert(sd, cfg)
    else:
        cfg = clip_config_from_hf(cfgd, dtype=dtype)
        module = {None: clip.CLIPModel, "vision": clip.CLIPImageEncoder,
                  "text": clip.CLIPTextEncoder}[tower](cfg, device=device)
        flat = convert_clip(sd, cfg)
    loaded = copy_flax_params(module, flat, module.flax_names(), module.flax_prefixes,
                              type(module).__name__)
    unset = sorted(set(dict(module.named_parameters())) - set(loaded))
    if unset:
        raise DaftValueError(f"{path!r} leaves {len(unset)} parameter(s) unset: {unset[:5]}")
    return mtype, module.eval().requires_grad_(False)
