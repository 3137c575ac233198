"""The port's text paths against the JAX package's, on the CPU: masked
attention, the CLIP text tower and ``CLIPModel``, MiniLM, and ``embed_text`` /
``classify_text`` / ``classify_image`` (and the image column kinds
``embed_image`` decodes) through the engine.

Weights come from the flax inits of the tiny configs and reach the port
through ``load_flax_params`` or the JAX package's ``.npz`` layout; inputs are
made with numpy from seeds. Tolerances: 2e-5 in f32 (the same arithmetic,
summed in another order) and 3e-2 in bf16 (the frameworks round to bf16 at
different places), as in tests/test_pallas.py; token ids, masks, labels and
the zero vector of an empty string are compared exactly.
"""

import dataclasses
import functools
import io

import flax.serialization as fs
import flax.traverse_util as tu
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import daft_tpu
import daft_tpu_torch
from daft_tpu.functions import ai as jai
from daft_tpu.models import clip as jclip
from daft_tpu.models import layers as jlayers
from daft_tpu.models import minilm as jminilm
from daft_tpu_torch.ai import cuda_provider, protocols
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.functions import ai as tai
from daft_tpu_torch.models import clip as tclip
from daft_tpu_torch.models import layers as tlayers
from daft_tpu_torch.models import minilm as tminilm
from daft_tpu_torch.utils.tokenizer import HashingTokenizer

F32_TOL = 2e-5
BF16_TOL = 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
WORDS = ("cat dog bird fish tree car boat house river stone red blue green "
         "small large quick slow bright dark over under near far photo of a").split()
TEXTS = ["hello world", "", None, "a b c d", "a photo of a cat", "the quick brown fox",
         " ".join(WORDS), "x"]


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in tu.flatten_dict(fs.to_state_dict(params), sep="/").items()}


def _close(out: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32),
                               atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def _clip(dtype_name: str):
    """(flax model, flax params, flat state dict, port CLIPModel on those weights)."""
    jdt, tdt, _ = DTYPES[dtype_name]
    model, params = jclip.init_clip_params(
        dataclasses.replace(jclip.CLIPConfig.tiny(), dtype=jdt), seed=0)
    flat = _flat(params)
    tmodel = tclip.CLIPModel(dataclasses.replace(tclip.CLIPConfig.tiny(), dtype=tdt),
                             device="cpu")
    tclip.load_flax_params(tmodel, flat)
    return model, params, flat, tmodel


@functools.lru_cache(maxsize=None)
def _minilm(dtype_name: str):
    jdt, tdt, _ = DTYPES[dtype_name]
    model, params = jminilm.init_minilm_params(
        dataclasses.replace(jminilm.MiniLMConfig.tiny(), dtype=jdt), seed=0)
    flat = _flat(params)
    enc = tminilm.MiniLMEncoder(dataclasses.replace(tminilm.MiniLMConfig.tiny(), dtype=tdt),
                                device="cpu")
    tminilm.load_flax_params(enc, flat)
    return model, params, flat, enc


def _x(dtype_name, shape=(3, 7, 64), seed=0):
    jdt, tdt, _ = DTYPES[dtype_name]
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x, dtype=jdt), torch.from_numpy(x).to(tdt)


def _mask(kind: str, B=3, T=7) -> np.ndarray:
    if kind == "causal":
        return np.tril(np.ones((1, 1, T, T), dtype=bool))
    valid = np.ones((B, T), dtype=bool)
    valid[1, 4:] = False
    valid[2, :] = False  # every key masked: an empty string's row
    return valid[:, None, None, :]


# --------------------------------------------------------------------- #
# layers                                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["causal", "key_padding"])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_masked_attention_matches_flax(dtype_name, kind):
    jdt, _, tol = DTYPES[dtype_name]
    _, params, _, tm = _clip(dtype_name)
    p = params["params"]["text"]["block_0"]["attn"]
    jx, tx = _x(dtype_name)
    mask = _mask(kind)
    ref = jlayers.MultiHeadAttention(2, jdt).apply({"params": p}, jx, jnp.asarray(mask))
    with torch.no_grad():
        out = tm.text.blocks[0].attn(tx, torch.from_numpy(mask))
    assert bool(torch.isfinite(out).all())
    _close(out, ref, tol)


@pytest.mark.parametrize("kind", ["causal", "key_padding"])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_transformer_block_with_a_mask_matches_flax(dtype_name, kind):
    jdt, _, tol = DTYPES[dtype_name]
    _, params, _, tm = _clip(dtype_name)
    p = params["params"]["text"]["block_1"]
    jx, tx = _x(dtype_name, seed=1)
    mask = _mask(kind)
    ref = jlayers.TransformerBlock(2, dtype=jdt).apply({"params": p}, jx, jnp.asarray(mask))
    with torch.no_grad():
        _close(tm.text.blocks[1](tx, torch.from_numpy(mask)), ref, tol)


def test_masked_path_never_reaches_the_kernel_or_sdpa(monkeypatch):
    """A masked call runs the plain masked attention; a mask-free call goes to
    ``flash_attention`` (the CUDA kernel on a GPU tensor)."""
    calls = []

    def spy(q, k, v):
        calls.append(q.shape)
        return torch.zeros_like(q)

    def refuse(*args, **kwargs):
        raise AssertionError("scaled_dot_product_attention called")

    monkeypatch.setattr(tlayers, "flash_attention", spy)
    monkeypatch.setattr(F, "scaled_dot_product_attention", refuse)
    attn = tlayers.MultiHeadAttention(64, 2, torch.float32, device="cpu")
    x = torch.zeros(1, 4, 64)
    with torch.no_grad():
        attn(x, mask=torch.ones(1, 1, 4, 4, dtype=torch.bool))
        assert calls == []
        attn(x)
    assert calls == [(1, 4, 2, 32)]


@pytest.mark.parametrize("mask", [torch.ones(1, 1, 4, 4), torch.ones(4, 4, dtype=torch.bool)])
def test_masked_attention_rejects_a_mask_that_is_not_4d_bool(mask):
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(DaftValueError):
        tlayers.masked_attention(q, q, q, mask)


def test_masked_attention_fills_like_jax():
    """Masked logits take -0.7 * f32 max, so an all-masked row is uniform over
    its keys (the mean of v) where -inf would give NaN."""
    assert tlayers.MASK_FILL == pytest.approx(-0.7 * np.finfo(np.float32).max)
    v = torch.arange(8, dtype=torch.float32).reshape(1, 4, 1, 2).repeat(1, 1, 1, 16)
    mask = torch.zeros(1, 1, 1, 4, dtype=torch.bool)
    out = tlayers.masked_attention(torch.ones(1, 4, 1, 32), torch.ones(1, 4, 1, 32), v, mask)
    torch.testing.assert_close(out, v.mean(dim=1, keepdim=True).expand(1, 4, 1, 32))


@pytest.mark.parametrize("T", [1, 7, 77])
def test_causal_mask_is_exact(T):
    np.testing.assert_array_equal(tlayers.causal_mask(T).numpy(), np.asarray(jlayers.causal_mask(T)))


@pytest.mark.parametrize("length,dim", [(16, 64), (77, 768), (256, 384)])
def test_sinusoidal_positions_match_flax(length, dim):
    """Both frameworks' f32 exp, sin and cos are within an ulp of the true
    value but not always on the same side of it (XLA's CPU polynomials are not
    torch's), so a position's angle can differ by one ulp of ``length``: the
    tolerance is two such ulps."""
    ref = np.asarray(jlayers.sinusoidal_positions(length, dim))
    out = tlayers.sinusoidal_positions(length, dim)
    assert out.dtype == torch.float32 and out.shape == (length, dim)
    tol = 2 * float(np.spacing(np.float32(length)))
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=0)


# --------------------------------------------------------------------- #
# CLIP text tower and CLIPModel                                         #
# --------------------------------------------------------------------- #
def _clip_tokens() -> np.ndarray:
    """(6, 16) ids in [1, 512) with zero padding; row 3 is all pad."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(1, 512, (6, 16)).astype(np.int32)
    for row, n in enumerate([5, 16, 9, 0, 1, 12]):
        tokens[row, n:] = 0
    return tokens


@pytest.mark.parametrize("source", ["ids", "tokenizer"])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_text_encoder_matches_flax(dtype_name, source):
    """On seeded ids, and on the hashing tokenizer's ids of ``TEXTS`` (empty
    and ``None`` rows all pad, a long row cut at the context length)."""
    _, _, tol = DTYPES[dtype_name]
    model, params, _, tm = _clip(dtype_name)
    tokens = _clip_tokens() if source == "ids" else HashingTokenizer(512, 16).encode_batch(TEXTS)[0]
    ref = model.apply(params, jnp.asarray(tokens), method=model.encode_text)
    with torch.no_grad():
        out = tm.text(torch.from_numpy(tokens))
    assert out.dtype == torch.float32 and out.shape == (len(tokens), 32)
    _close(out, ref, tol)


def test_text_pool_positions_are_the_last_non_pad_token():
    tokens = torch.from_numpy(_clip_tokens())
    assert tclip.CLIPTextEncoder.pool_positions(tokens).tolist() == [4, 15, 8, 0, 0, 11]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_clip_model_logits_match_flax(dtype_name):
    _, _, tol = DTYPES[dtype_name]
    model, params, _, tm = _clip(dtype_name)
    px = np.random.default_rng(12).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    tokens = _clip_tokens()
    ref = model.apply(params, jnp.asarray(px), jnp.asarray(tokens))
    with torch.no_grad():
        out = tm(torch.from_numpy(px), torch.from_numpy(tokens))
    assert out[0].shape == (3, 6)
    # The logits are exp(2.6592) = 14.3 times cosines.
    for o, r, t in zip(out, ref, (tol * 15, tol, tol)):
        _close(o, r, t)


def test_load_flax_params_maps_every_clip_parameter():
    _, _, flat, _ = _clip("f32")
    model = tclip.CLIPModel(tclip.CLIPConfig.tiny(), device="cpu")
    assert sorted(tclip.load_flax_params(model, flat)) == sorted(n for n, _ in model.named_parameters())
    text = tclip.CLIPTextEncoder(tclip.CLIPConfig.tiny(), device="cpu")
    assert sorted(tclip.load_flax_params(text, flat)) == sorted(n for n, _ in text.named_parameters())
    # The token table (vocab, width) is the nn.Embedding weight as it stands.
    np.testing.assert_array_equal(text.tok_embed.weight.detach().numpy(),
                                  flat["params/text/tok_embed/embedding"])
    assert model.logit_scale.item() == pytest.approx(float(flat["params/logit_scale"]))
    vision_only = {k: v for k, v in flat.items() if k.startswith("params/vision/")}
    with pytest.raises(DaftValueError):
        tclip.load_flax_params(text, vision_only)


def test_npz_round_trip_of_the_text_tower(tmp_path):
    model, params, flat, _ = _clip("f32")
    path = tmp_path / "clip.npz"
    np.savez(path, **flat)
    text = tclip.load_params(str(path), tclip.CLIPTextEncoder(
        dataclasses.replace(tclip.CLIPConfig.tiny(), dtype=torch.float32), device="cpu"))
    tokens = _clip_tokens()
    ref = model.apply(params, jnp.asarray(tokens), method=model.encode_text)
    with torch.no_grad():
        _close(text(torch.from_numpy(tokens)), ref, F32_TOL)


def test_random_init_of_the_clip_model_follows_its_seed():
    cfg = tclip.CLIPConfig.tiny()
    model, again = (tclip.init_random_(tclip.CLIPModel(cfg, device="cpu"),
                                       torch.Generator().manual_seed(3)) for _ in range(2))
    for (name, a), (_, b) in zip(model.named_parameters(), again.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert model.logit_scale.item() == pytest.approx(2.6592)
    for p, std in ((model.text.tok_embed.weight, 0.02), (model.text.pos_embed, 0.01),
                   (model.vision.pos_embed, 0.02)):
        assert p.std().item() == pytest.approx(std, rel=0.15)
    assert not model.text.blocks[0].attn.qkv.bias.any()
    assert bool((model.text.ln_final.weight == 1).all())


def test_text_config_fields_match_the_jax_package():
    for name in ("ViT-L/14", "ViT-B/32", "openai/clip-vit-base-patch16", "tiny"):
        t, j = tclip.CLIPConfig.from_name(name), jclip.CLIPConfig.from_name(name)
        for field in ("text_width", "text_layers", "text_heads", "vocab_size", "context_length",
                      "embed_dim", "text_mlp_ratio", "hidden_act", "ln_eps"):
            assert getattr(t, field) == getattr(j, field), (name, field)
    for name in ("all-MiniLM-L6-v2", "tiny-minilm"):
        t, j = tminilm.MiniLMConfig.from_name(name), jminilm.MiniLMConfig.from_name(name)
        for field in ("vocab_size", "hidden", "layers", "heads", "max_length", "embed_dim"):
            assert getattr(t, field) == getattr(j, field), (name, field)


# --------------------------------------------------------------------- #
# MiniLM                                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_minilm_matches_flax_and_pools_empty_strings_to_zero(dtype_name):
    _, _, tol = DTYPES[dtype_name]
    model, params, _, enc = _minilm(dtype_name)
    tokens, lengths = HashingTokenizer(512, 32).encode_batch(TEXTS)
    ref = np.asarray(model.apply(params, jnp.asarray(tokens)), np.float32)
    with torch.no_grad():
        out = enc(torch.from_numpy(tokens))
    assert out.dtype == torch.float32 and out.shape == (len(TEXTS), 64)
    _close(out, ref, tol)
    empty = lengths == 0
    assert empty.tolist() == [t is None or t == "" for t in TEXTS]
    # Rows with no token: exactly zero in both; the rest unit-norm.
    assert not ref[empty].any() and not out.numpy()[empty].any()
    np.testing.assert_allclose(np.linalg.norm(out.numpy()[~empty], axis=1), 1.0, atol=1e-5)


def test_load_flax_params_maps_every_minilm_parameter(tmp_path):
    model, params, flat, _ = _minilm("f32")
    enc = tminilm.MiniLMEncoder(dataclasses.replace(tminilm.MiniLMConfig.tiny(),
                                                    dtype=torch.float32), device="cpu")
    assert sorted(tminilm.load_flax_params(enc, flat)) == sorted(n for n, _ in enc.named_parameters())
    path = tmp_path / "minilm.npz"
    np.savez(path, **flat)
    fresh = tminilm.load_params(str(path), tminilm.init_random_(
        tminilm.MiniLMEncoder(enc.cfg, device="cpu"), torch.Generator().manual_seed(1)))
    tokens, _ = HashingTokenizer(512, 32).encode_batch(TEXTS)
    with torch.no_grad():
        _close(fresh(torch.from_numpy(tokens)), model.apply(params, jnp.asarray(tokens)), F32_TOL)
    with pytest.raises(DaftValueError):
        tminilm.load_flax_params(enc, {"params/vision/cls": np.zeros((1, 1, 64), np.float32)})


# --------------------------------------------------------------------- #
# Engine                                                                #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The JAX package's tiny CLIP and MiniLM weights in its ``.npz`` layout."""
    d = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for name, flat in (("clip", _clip("f32")[2]), ("minilm", _minilm("f32")[2])):
        paths[name] = str(d / f"{name}.npz")
        np.savez(paths[name], **flat)
    return paths


def _texts(n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = [" ".join(rng.choice(WORDS, rng.integers(1, 40))) for _ in range(n)]
    out[3], out[7] = "", None
    return out


def _run(pkg, fn, values, **kw):
    df = pkg.from_pydict({"id": list(range(len(values))), "x": values})
    expr = fn(pkg.col("x"), **kw)
    with pkg.execution_config_ctx(default_morsel_size=16):
        return df.with_column("y", expr).select("id", "y").collect().to_pydict(), expr


@pytest.mark.parametrize("model,path", [("tiny", "minilm"), ("clip-tiny", "clip")])
def test_embed_text_through_the_engine(npz, model, path):
    texts = _texts(37)
    ref, _ = _run(daft_tpu, jai.embed_text, texts, provider="flax", model=model,
                  weights_path=npz[path])
    out, expr = _run(daft_tpu_torch, tai.embed_text, texts, provider="cuda", model=model,
                     weights_path=npz[path], device="cpu")
    assert out["id"] == ref["id"] == list(range(37))
    emb, ref_emb = np.asarray(out["y"], np.float32), np.asarray(ref["y"], np.float32)
    assert emb.shape == ref_emb.shape
    np.testing.assert_allclose(emb, ref_emb, atol=BF16_TOL, rtol=BF16_TOL)
    # The last morsel (rows 32..36) equals a direct forward of the instance's tower.
    inst = expr._expr.udf._get_instance()
    tokens, _ = inst.tokenizer.encode_batch(texts[32:])
    direct = inst.forward(torch.from_numpy(np.pad(tokens, ((0, 3), (0, 0)))))[:5]
    np.testing.assert_array_equal(emb[32:], direct.numpy())
    assert inst.last_forward_stats["rows"] == 5 and inst.last_forward_stats["chunks"] == 1
    if path == "minilm":  # the empty and None strings: exact zero vectors
        assert not emb[[3, 7]].any() and not ref_emb[[3, 7]].any()
    else:
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)


@pytest.fixture
def f32_tiny_clip(monkeypatch):
    """``model="tiny"`` names an f32 CLIP in both packages for this test."""
    for cls, dt in ((jclip.CLIPConfig, jnp.float32), (tclip.CLIPConfig, torch.float32)):
        tiny = cls.tiny
        monkeypatch.setattr(cls, "tiny", staticmethod(
            lambda tiny=tiny, dt=dt: dataclasses.replace(tiny(), dtype=dt)))


LABELS = ["cat", "dog", "bird", "car", "tree", "boat", "house"]


def _margins(sims: np.ndarray) -> np.ndarray:
    top = np.sort(sims, axis=1)
    return top[:, -1] - top[:, -2]


def test_classify_text_gives_the_jax_labels(npz, f32_tiny_clip):
    texts = _texts(30, seed=1)
    ref, _ = _run(daft_tpu, jai.classify_text, texts, labels=LABELS, provider="flax",
                  model="tiny", weights_path=npz["clip"])
    out, expr = _run(daft_tpu_torch, tai.classify_text, texts, labels=LABELS,
                     provider="cuda", model="tiny", weights_path=npz["clip"], device="cpu")
    inst = expr._expr.udf._get_instance()
    sims = inst.text_embedder.embed_text(texts) @ inst.text_embedder.embed_text(LABELS).T
    assert _margins(sims).min() > 1e-4
    assert out["y"] == ref["y"]
    assert out["y"] == [LABELS[i] for i in sims.argmax(axis=1)]


def test_classify_image_gives_the_jax_labels(npz, f32_tiny_clip):
    imgs = np.random.default_rng(5).integers(0, 256, (30, 32 * 32 * 3), dtype=np.uint8)

    def run(pkg, fn, **kw):
        df = pkg.from_pydict({"id": list(range(30)),
                              "x": pkg.Series.from_numpy(imgs, "x", pkg.DataType.image("RGB", 32, 32))})
        expr = fn(pkg.col("x"), LABELS, model="tiny", weights_path=npz["clip"], **kw)
        with pkg.execution_config_ctx(default_morsel_size=16):
            return df.with_column("y", expr).select("id", "y").to_pydict(), expr

    ref, _ = run(daft_tpu, jai.classify_image, provider="flax")
    out, expr = run(daft_tpu_torch, tai.classify_image, provider="cuda", device="cpu")
    inst = expr._expr.udf._get_instance()
    lab = inst.text_embedder.embed_text([f"a photo of a {l}" for l in LABELS])
    sims = inst.image_embedder.embed_image(imgs) @ lab.T
    assert _margins(sims).min() > 1e-4
    assert out["y"] == ref["y"]
    assert out["y"] == [LABELS[i] for i in sims.argmax(axis=1)]


def test_classifier_embeds_each_label_list_once(npz):
    clf = cuda_provider.CUDACLIPClassifier("tiny", npz["clip"], device="cpu")
    calls = []
    embed_text = clf.text_embedder.embed_text
    clf.text_embedder.embed_text = lambda texts: calls.append(list(texts)) or embed_text(texts)
    imgs = np.zeros((2, 32, 32, 3), np.uint8)
    for _ in range(2):
        clf.classify_image(imgs, ["cat", "dog"])
        clf.classify_text(["a cat"], ["cat", "dog"])
    assert calls == [["a photo of a cat", "a photo of a dog"], ["a cat"], ["cat", "dog"], ["a cat"]]


def _encoded(sizes, seed=0):
    from PIL import Image as PILImage

    rng = np.random.default_rng(seed)
    raws, arrays = [], []
    for h, w in sizes:
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        buf = io.BytesIO()
        PILImage.fromarray(a).save(buf, format="PNG")
        raws.append(buf.getvalue())
        arrays.append(a)
    return raws, arrays


SIZES = [(20, 30), (32, 32), (64, 17), (9, 9), (40, 40)]


@pytest.mark.parametrize("kind", ["encoded", "image", "tensor"])
def test_embed_image_decodes_every_image_column_kind(npz, kind):
    raws, arrays = _encoded(SIZES)

    def column(pkg):
        if kind == "encoded":
            return pkg.Series.from_pylist(raws + [None], "x", pkg.DataType.binary())
        if kind == "image":
            rows = [{"data": a.tobytes(), "channel": 3, "height": a.shape[0],
                     "width": a.shape[1], "mode": 3} for a in arrays]
            return pkg.Series.from_pylist(rows + [None], "x", pkg.DataType.image("RGB"))
        flat = np.stack([np.resize(a, (32, 32, 3)) for a in arrays])
        return pkg.Series.from_numpy(flat, "x", pkg.DataType.tensor(pkg.DataType.uint8(), (32, 32, 3)))

    def run(pkg, fn, **kw):
        df = pkg.from_pydict({"x": column(pkg)})
        return df.with_column("y", fn(pkg.col("x"), model="tiny", weights_path=npz["clip"],
                                      **kw)).to_pydict()["y"]

    ref = np.asarray(run(daft_tpu, jai.embed_image, provider="flax"), np.float32)
    out = np.asarray(run(daft_tpu_torch, tai.embed_image, provider="cuda", device="cpu"),
                     np.float32)
    assert out.shape == ref.shape == (len(SIZES) + (kind != "tensor"), 32)
    np.testing.assert_allclose(out, ref, atol=BF16_TOL, rtol=BF16_TOL)


def test_decoded_images_equal_their_fixed_shape_column():
    """Decoding is the PIL bilinear resize of the JAX package: a variable-shape
    column and its encoded bytes give the same batch, and a null row black."""
    raws, arrays = _encoded(SIZES, seed=3)
    enc = tai._images_to_numpy(
        daft_tpu_torch.Series.from_pylist(raws + [None], "x", daft_tpu_torch.DataType.binary()), 32)
    rows = [{"data": a.tobytes(), "channel": 3, "height": a.shape[0], "width": a.shape[1],
             "mode": 3} for a in arrays]
    img = tai._images_to_numpy(daft_tpu_torch.Series.from_pylist(
        rows, "x", daft_tpu_torch.DataType.image("RGB")), 32)
    ref = jai._images_to_numpy(daft_tpu.Series.from_pylist(
        raws + [None], "x", daft_tpu.DataType.binary()), 32)
    np.testing.assert_array_equal(enc, ref)
    np.testing.assert_array_equal(img, ref[:-1])
    assert enc.dtype == np.uint8 and not enc[-1].any()
    with pytest.raises(daft_tpu_torch.errors.DaftTypeError):
        tai._images_to_numpy(daft_tpu_torch.Series.from_pylist([1, 2], "x"), 32)


# --------------------------------------------------------------------- #
# Provider                                                              #
# --------------------------------------------------------------------- #
PROTOCOLS = {"text_embedder": protocols.TextEmbedder, "image_embedder": protocols.ImageEmbedder,
             "text_classifier": protocols.TextClassifier,
             "image_classifier": protocols.ImageClassifier}


@pytest.mark.parametrize("kind,model,cls,dims", [
    ("text_embedder", None, "CUDAMiniLMTextEmbedder", 384),
    ("text_embedder", "tiny", "CUDAMiniLMTextEmbedder", 64),
    ("text_embedder", "clip-tiny", "CUDACLIPTextEmbedder", 32),
    ("text_embedder", "ViT-L/14", "CUDACLIPTextEmbedder", 768),
    ("image_classifier", "tiny", "CUDACLIPClassifier", None),
    ("text_classifier", "tiny", "CUDACLIPClassifier", None),
    ("image_embedder", "tiny", "CUDACLIPImageEmbedder", 32),
])
def test_descriptors_route_like_the_jax_package(kind, model, cls, dims):
    from daft_tpu.ai.provider import load_provider as jax_provider

    desc = getattr(cuda_provider.CUDAProvider(), f"get_{kind}")(model, device="cpu")
    ref = getattr(jax_provider("flax_random"), f"get_{kind}")(model)
    assert desc.protocol == desc.kind == kind
    assert desc.model == ref.model
    assert desc.get_dimensions() == ref.get_dimensions() == dims
    assert desc.get_udf_options().batch_size == ref.get_udf_options().batch_size == 256
    if model is not None and "L/14" not in model:
        inst = desc.instantiate()
        assert type(inst).__name__ == cls
        assert isinstance(inst, PROTOCOLS[kind])
        if kind == "text_embedder":
            assert inst.max_batch == 512 and inst.dimensions == dims


def test_classifier_default_model_is_vit_b_32():
    p = cuda_provider.CUDAProvider()
    assert p.get_image_classifier(device="cpu").model == "ViT-B/32"
    assert p.get_text_classifier(device="cpu").model == "ViT-B/32"


@pytest.mark.parametrize("fn", ["embed_text", "classify_text", "classify_image"])
def test_text_entry_points_raise_without_a_gpu_unless_asked_for_the_cpu(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (daft_tpu_torch.col("x"),) + ((["a", "b"],) if fn.startswith("classify") else ())
    with pytest.raises(DaftValueError, match="device='cpu'"):
        getattr(tai, fn)(*args, model="tiny")
    getattr(tai, fn)(*args, model="tiny", device="cpu")


def test_cpu_staging_keeps_the_token_dtype():
    tokens = np.array([[300, 49407, 0]], dtype=np.int32)
    staged = cuda_provider._Stager(torch.device("cpu"))(tokens, 8)
    assert staged.dtype == torch.int32 and staged.shape == (8, 3)
    np.testing.assert_array_equal(staged[:1].numpy(), tokens)
    assert not staged[1:].any()
