"""The port's CLIP image tower against the JAX package's, on the CPU.

Weights come from the flax init of ``CLIPConfig.tiny()`` and reach the torch
modules through ``load_flax_params``; inputs are made with numpy and handed to
both. Tolerances: 2e-5 in f32 (the same arithmetic, summed in another order)
and 3e-2 in bf16 (the two frameworks round to bf16 at different places), as in
tests/test_pallas.py.
"""

import dataclasses

import flax.linen as fnn
import flax.serialization as fs
import flax.traverse_util as tu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daft_tpu.models import clip as jclip
from daft_tpu.models import layers as jlayers
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.models import clip as tclip
from daft_tpu_torch.models import layers as tlayers
from daft_tpu_torch.models.checkpoint import load_npz

F32_TOL = 2e-5
BF16_TOL = 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _pair(dtype_name):
    """(flax model, flax params, flat flax state dict, torch encoder with those weights)."""
    jdt, tdt, _ = DTYPES[dtype_name]
    model, params = jclip.init_clip_params(dataclasses.replace(jclip.CLIPConfig.tiny(), dtype=jdt),
                                           seed=0)
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(fs.to_state_dict(params), sep="/").items()}
    enc = tclip.CLIPImageEncoder(dataclasses.replace(tclip.CLIPConfig.tiny(), dtype=tdt),
                                 device="cpu")
    tclip.load_flax_params(enc, flat)
    return model, params, flat, enc


def _close(out: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32),
                               atol=tol, rtol=tol)


def _tokens(dtype_name, seed=0):
    jdt, tdt, _ = DTYPES[dtype_name]
    x = np.random.default_rng(seed).normal(size=(2, 5, 64)).astype(np.float32)
    return jnp.asarray(x, dtype=jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_mlp_matches_flax(dtype_name):
    jdt, _, tol = DTYPES[dtype_name]
    _, params, _, enc = _pair(dtype_name)
    p = params["params"]["vision"]["block_0"]["mlp"]
    jx, tx = _tokens(dtype_name)
    ref = jlayers.MLP(256, 64, jdt, act=jlayers.resolve_act("gelu")).apply({"params": p}, jx)
    with torch.no_grad():
        _close(enc.blocks[0].mlp(tx), ref, tol)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_attention_matches_flax(dtype_name):
    jdt, _, tol = DTYPES[dtype_name]
    _, params, _, enc = _pair(dtype_name)
    p = params["params"]["vision"]["block_0"]["attn"]
    jx, tx = _tokens(dtype_name, seed=1)
    ref = jlayers.MultiHeadAttention(2, jdt).apply({"params": p}, jx)
    with torch.no_grad():
        _close(enc.blocks[0].attn(tx), ref, tol)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_transformer_block_matches_flax(dtype_name):
    jdt, _, tol = DTYPES[dtype_name]
    _, params, _, enc = _pair(dtype_name)
    p = params["params"]["vision"]["block_1"]
    jx, tx = _tokens(dtype_name, seed=2)
    ref = jlayers.TransformerBlock(2, dtype=jdt).apply({"params": p}, jx)
    with torch.no_grad():
        _close(enc.blocks[1](tx), ref, tol)


@pytest.mark.parametrize("pixels", ["uint8", "float"])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_image_encoder_matches_flax(dtype_name, pixels):
    _, _, tol = DTYPES[dtype_name]
    model, params, _, enc = _pair(dtype_name)
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    if pixels == "float":
        px = rng.random((3, 32, 32, 3), dtype=np.float32)
    ref = model.apply(params, jnp.asarray(px), method=model.encode_image)
    with torch.no_grad():
        out = enc(torch.from_numpy(px))
    assert out.dtype == torch.float32 and out.shape == (3, 32)
    _close(out, ref, tol)


def test_embed_is_unit_norm_like_the_provider():
    model, params, _, enc = _pair("f32")
    px = np.random.default_rng(4).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ref = np.asarray(model.apply(params, jnp.asarray(px), method=model.encode_image))
    ref = ref / np.clip(np.linalg.norm(ref, axis=-1, keepdims=True), 1e-6, None)
    out = tclip.embed(enc, torch.from_numpy(px))
    _close(out, ref, F32_TOL)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=-1), 1.0, atol=1e-5)


def test_npz_checkpoint_round_trip(tmp_path):
    """The ``.npz`` layout the JAX package's loader reads loads into the port."""
    model, params, flat, _ = _pair("f32")
    path = tmp_path / "tiny.npz"
    np.savez(path, **flat)
    assert set(load_npz(str(path))) == set(flat)
    enc = tclip.load_params(str(path), tclip.CLIPImageEncoder(
        dataclasses.replace(tclip.CLIPConfig.tiny(), dtype=torch.float32), device="cpu"))
    px = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ref = model.apply(params, jnp.asarray(px), method=model.encode_image)
    with torch.no_grad():
        _close(enc(torch.from_numpy(px)), ref, F32_TOL)


def test_load_flax_params_maps_every_vision_parameter():
    _, _, flat, enc = _pair("f32")
    loaded = tclip.load_flax_params(enc, flat)
    assert sorted(loaded) == sorted(name for name, _ in enc.named_parameters())
    # Dense (in, out) -> Linear (out, in); conv HWIO (p, p, 3, W) -> (W, p*p*3).
    np.testing.assert_array_equal(enc.blocks[0].attn.qkv.weight.detach().numpy(),
                                  flat["params/vision/block_0/attn/qkv/kernel"].T)
    np.testing.assert_array_equal(enc.patch_embed.weight.detach().numpy(),
                                  flat["params/vision/patch_embed/kernel"].reshape(-1, 64).T)


@pytest.mark.parametrize("case", ["shape", "nothing"])
def test_load_flax_params_rejects_a_foreign_checkpoint(case):
    enc = tclip.CLIPImageEncoder(tclip.CLIPConfig.tiny(), device="cpu")
    flat = ({"params/vision/proj/kernel": np.zeros((3, 3), np.float32)} if case == "shape"
            else {"params/text/proj/kernel": np.zeros((64, 32), np.float32)})
    with pytest.raises(DaftValueError):
        tclip.load_flax_params(enc, flat)


def test_layer_norm_is_flax_f32_with_eps_1e6():
    x = np.random.default_rng(6).normal(size=(2, 5, 64)).astype(np.float32) * 1e-3
    ln = tlayers.LayerNorm(64, device="cpu")
    ref = fnn.LayerNorm(dtype=jnp.float32, epsilon=1e-6).apply(
        {"params": {"scale": jnp.ones(64), "bias": jnp.zeros(64)}}, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        out = ln(torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.float32
    _close(out, ref, F32_TOL)


@pytest.mark.parametrize("name", ["gelu", "gelu_exact", "quick_gelu", "silu", "relu", "tanh"])
def test_resolve_act_matches_flax(name):
    x = np.linspace(-4, 4, 33, dtype=np.float32)
    ref = jlayers.resolve_act(name)(jnp.asarray(x))
    _close(tlayers.resolve_act(name)(torch.from_numpy(x)), ref, 1e-6)


def test_resolve_act_rejects_unknown():
    with pytest.raises(DaftValueError):
        tlayers.resolve_act("mish")


@pytest.mark.parametrize("name,width,layers,embed", [
    ("ViT-L/14", 1024, 24, 768), ("openai/clip-vit-base-patch32", 768, 12, 512),
    ("ViT-B/16", 768, 12, 512), ("tiny", 64, 2, 32)])
def test_config_names_match_the_jax_package(name, width, layers, embed):
    t, j = tclip.CLIPConfig.from_name(name), jclip.CLIPConfig.from_name(name)
    assert (t.vision_width, t.vision_layers, t.embed_dim) == (width, layers, embed)
    for field in ("image_size", "patch_size", "vision_width", "vision_layers", "vision_heads",
                  "embed_dim", "ln_eps", "vision_mlp_ratio", "hidden_act"):
        assert getattr(t, field) == getattr(j, field), field
    np.testing.assert_array_equal(tclip.CLIP_IMAGE_MEAN, jclip.CLIP_IMAGE_MEAN)
    np.testing.assert_array_equal(tclip.CLIP_IMAGE_STD, jclip.CLIP_IMAGE_STD)
