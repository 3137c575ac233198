"""The port's HF checkpoint conversion (daft_tpu_torch/models/convert.py,
models/bert.py, the CLIP text options, the vocab-file tokenizers and the
provider's HF branches) against the JAX package's, on the CPU. Mirrors
tests/test_convert.py.

Tiny HF BERT and CLIP models are built from ``transformers`` configs in the
test itself (seeded, no network) and saved as checkpoint directories with
``save_pretrained(safe_serialization=False)``. Both packages convert the
same directory. Tolerances: the converted flat dicts are equal key for key
and bit for bit; token ids are equal exactly; embeddings agree with the JAX
package's at cosine 1e-5 in f32 and at the JAX file's 5e-2 on the bf16
engine path; the HF torch model, the reference both converters follow, at
that file's 1e-4 in f32.
"""

import dataclasses
import json
import os
import shutil

import flax.traverse_util as tu
import jax.numpy as jnp
import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.ai import flax_provider
from daft_tpu.models import convert as jconvert
from daft_tpu.utils import tokenizer as jtok
from daft_tpu_torch.ai import cuda_provider
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.functions import ai as tai
from daft_tpu_torch.models import convert as tconvert
from daft_tpu_torch.utils import tokenizer as ttok

transformers = pytest.importorskip("transformers")
torch = pytest.importorskip("torch")

F32_COS_TOL = 1e-5   # the same f32 arithmetic, summed in another order
BF16_COS_TOL = 5e-2  # bf16 engine path (tests/test_convert.py's tolerance)
HF_COS_TOL = 1e-4    # against HF's torch model in f32 (tests/test_convert.py's)

BERT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
              "the", "quick", "brown", "fox", "jump", "##s", "##ed", "over",
              "lazy", "dog", "##gy", "data", "##frame", "runs", "on", "tpu",
              "!", ",", ".", "a", "b", "c", "深", "度", "学"]
BERT_TEXTS = ["the quick brown fox jumps over the lazy dog", "dataframe runs on tpu !",
              "a b c , the doggy jumped .", "unknownword the fox", "深度学 the fox", ""]
CLIP_WORDS = ["the", "quick", "brown", "fox", "dog", "cat", "photo", "of", "a", "on", "tpu"]
CLIP_TEXTS = ["the quick brown fox", "a photo of a cat on tpu", "dog cat dog", "the % fox", ""]


def _cos(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _assert_cos(a, b, tol):
    np.testing.assert_allclose(_cos(a, b), 1.0, atol=tol)


def _jax_flat(params) -> dict:
    return {k: np.asarray(v) for k, v in tu.flatten_dict(params, sep="/").items()}


# --------------------------------------------------------------------- #
# Fixtures: tiny HF checkpoint directories                              #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert_ckpt")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join(BERT_VOCAB) + "\n")
    cfg = transformers.BertConfig(
        vocab_size=len(BERT_VOCAB), hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2)
    torch.manual_seed(0)
    model = transformers.BertModel(cfg).eval()
    model.save_pretrained(str(d), safe_serialization=False)
    transformers.BertTokenizer(str(vocab)).save_pretrained(str(d))
    return str(d)


def _clip_vocab_and_merges(d):
    """A tiny real BPE: characters and whole-word merges of CLIP_WORDS, the
    start and end of text last (the end-of-text id is the highest)."""
    chars = sorted({c for w in CLIP_WORDS for c in w})
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    merges = []
    for w in CLIP_WORDS:
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            merges.append((parts[0], parts[1]))
            parts = [parts[0] + parts[1]] + parts[2:]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    lines = ["#version: 0.2"] + [f"{a} {b}" for a, b in dict.fromkeys(merges)]
    (d / "merges.txt").write_text("\n".join(lines) + "\n")
    return vocab


def _make_clip_dir(d, legacy: bool):
    vocab = _clip_vocab_and_merges(d)
    cfg = transformers.CLIPConfig(
        text_config={"vocab_size": len(vocab), "hidden_size": 32,
                     "num_hidden_layers": 2, "num_attention_heads": 4,
                     "intermediate_size": 64, "max_position_embeddings": 16,
                     # OpenAI's configs ship eos_token_id 2: HF's legacy branch
                     "eos_token_id": 2 if legacy else vocab["<|endoftext|>"],
                     "bos_token_id": vocab["<|startoftext|>"]},
        # Head dim 32: the smallest the flash-attention kernel takes.
        vision_config={"image_size": 32, "patch_size": 16, "hidden_size": 64,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "intermediate_size": 128},
        projection_dim=24)
    torch.manual_seed(1)
    model = transformers.CLIPModel(cfg).eval()
    model.save_pretrained(str(d), safe_serialization=False)
    return str(d), model, vocab


@pytest.fixture(scope="module", params=["first_eos", "argmax_id"])
def clip_dir(request, tmp_path_factory):
    return _make_clip_dir(tmp_path_factory.mktemp(f"clip_{request.param}"),
                          legacy=request.param == "argmax_id")


@pytest.fixture(scope="module")
def eos_clip_dir(tmp_path_factory):
    return _make_clip_dir(tmp_path_factory.mktemp("clip_eos"), legacy=False)


def _images(n=3, seed=2):
    return np.random.default_rng(seed).integers(0, 255, (n, 32, 32, 3), dtype=np.uint8)


def _token_rows(vocab, sentences, L=16):
    rows = np.zeros((len(sentences), L), dtype=np.int64)
    for i, words in enumerate(sentences):
        ids = [vocab["<|startoftext|>"]] + [vocab[w + "</w>"] for w in words] + \
            [vocab["<|endoftext|>"]]
        rows[i, :len(ids)] = ids
    return rows


# --------------------------------------------------------------------- #
# Conversion                                                            #
# --------------------------------------------------------------------- #
def test_bert_flat_keys_equal_the_jax_converter(bert_dir):
    sd = tconvert.load_hf_state_dict(bert_dir)
    jsd = jconvert.load_hf_state_dict(bert_dir)
    assert sd.keys() == jsd.keys()
    from daft_tpu.models.bert import BertConfig as JBertConfig
    from daft_tpu_torch.models.bert import BertConfig

    cfgd = tconvert.hf_config(bert_dir)
    cfg, jcfg = BertConfig.from_hf(cfgd), JBertConfig.from_hf(cfgd)
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    ours, ref = tconvert.convert_bert(sd, cfg), _jax_flat(jconvert.convert_bert(jsd, jcfg))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes(), k


def test_clip_flat_keys_equal_the_jax_converter(clip_dir):
    d, _, _ = clip_dir
    sd = tconvert.load_hf_state_dict(d)
    _, jmodel, jparams = jconvert.load_hf_checkpoint(d, dtype=jnp.float32)
    cfg = tconvert.clip_config_from_hf(tconvert.hf_config(d))
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jmodel.cfg, f.name), f.name
    ours, ref = tconvert.convert_clip(sd, cfg), _jax_flat(jparams)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes(), k


def test_converted_parameters_equal_the_hf_tensors(bert_dir, eos_clip_dir):
    """After the layout transposes, every checked parameter of the converted
    modules is the HF tensor exactly (f32)."""
    sd = {k: v for k, v in torch.load(os.path.join(bert_dir, "pytorch_model.bin"),
                                      weights_only=True).items()}
    _, enc = tconvert.load_hf_checkpoint(bert_dir)
    assert torch.equal(enc.layers[1].q.weight, sd["encoder.layer.1.attention.self.query.weight"])
    assert torch.equal(enc.layers[0].fc2.bias, sd["encoder.layer.0.output.dense.bias"])
    assert torch.equal(enc.emb_ln.weight, sd["embeddings.LayerNorm.weight"])
    assert torch.equal(enc.word_embeddings.weight, sd["embeddings.word_embeddings.weight"])
    d, hf, _ = eos_clip_dir
    hsd = hf.state_dict()
    _, model = tconvert.load_hf_checkpoint(d)
    p = "vision_model.encoder.layers.1.self_attn"
    assert torch.equal(model.vision.blocks[1].attn.qkv.weight, torch.cat(
        [hsd[f"{p}.{x}_proj.weight"] for x in "qkv"]))
    conv = hsd["vision_model.embeddings.patch_embedding.weight"]  # (w, 3, p, p)
    assert torch.equal(model.vision.patch_embed.weight, conv.permute(0, 2, 3, 1).reshape(64, -1))
    assert torch.equal(model.vision.cls[0, 0], hsd["vision_model.embeddings.class_embedding"])
    assert torch.equal(model.vision.ln_pre.weight, hsd["vision_model.pre_layrnorm.weight"])
    assert torch.equal(model.text.proj.weight, hsd["text_projection.weight"])
    assert torch.equal(model.text.tok_embed.weight,
                       hsd["text_model.embeddings.token_embedding.weight"])
    assert torch.equal(model.logit_scale, hsd["logit_scale"])


# --------------------------------------------------------------------- #
# Forwards against the JAX package and HF                               #
# --------------------------------------------------------------------- #
def test_bert_conversion_parity(bert_dir):
    """f32: the converted BertEncoder on WordPiece ids equals the JAX
    package's (cosine 1e-5) and HF's sentence-transformers head (1e-4); an
    empty string pools to zero in both packages."""
    from daft_tpu.ai.torch_provider import TorchTextEmbedder

    ref = flax_provider.FlaxMiniLMTextEmbedder(
        "all-MiniLM-L6-v2", weights_path=bert_dir, dtype=jnp.float32).embed_text(BERT_TEXTS)
    _, enc = tconvert.load_hf_checkpoint(bert_dir)
    tokens, _ = ttok.tokenizer_from_dir(bert_dir, 64).encode_batch(BERT_TEXTS)
    with torch.inference_mode():
        ours = enc(torch.from_numpy(tokens)).numpy()
    _assert_cos(ours[:-1], ref[:-1], F32_COS_TOL)
    assert not ours[-1].any() and not ref[-1].any()
    _assert_cos(ours[:-1], TorchTextEmbedder(bert_dir).embed_text(BERT_TEXTS[:-1]), HF_COS_TOL)


def test_bert_embedder_in_bf16_matches_the_jax_embedder(bert_dir):
    ours = cuda_provider.CUDAMiniLMTextEmbedder(
        "all-MiniLM-L6-v2", weights_path=bert_dir, device="cpu")
    ref = flax_provider.FlaxMiniLMTextEmbedder("all-MiniLM-L6-v2", weights_path=bert_dir)
    assert ours.encoder.cfg.dtype == torch.bfloat16 and ours.tokenizer.max_length == 64
    assert ours.dimensions == ref.cfg.embed_dim == 32
    _assert_cos(ours.embed_text(BERT_TEXTS[:-1]), ref.embed_text(BERT_TEXTS[:-1]), BF16_COS_TOL)


def test_clip_image_conversion_parity(eos_clip_dir):
    d, hf, _ = eos_clip_dir
    from daft_tpu_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, embed

    imgs = _images()
    _, jmodel, jparams = jconvert.load_hf_checkpoint(d, dtype=jnp.float32)
    ref = np.asarray(jmodel.apply(jparams, jnp.asarray(imgs), method=jmodel.encode_image))
    _, enc = tconvert.load_hf_checkpoint(d, tower="vision")
    with torch.inference_mode():
        ours = enc(torch.from_numpy(imgs)).numpy()
    _assert_cos(ours, ref, F32_COS_TOL)
    x = (imgs.astype(np.float32) / 255.0 - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD
    with torch.inference_mode():
        theirs = hf.get_image_features(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2)))
    _assert_cos(ours, theirs.numpy(), HF_COS_TOL)
    # bf16 through the providers
    port = cuda_provider.CUDACLIPImageEmbedder("tiny", weights_path=d, device="cpu")
    jax = flax_provider.FlaxCLIPImageEmbedder("tiny", weights_path=d, batch_size=4)
    assert port.dimensions == jax.dimensions == 24 and port.cfg.image_size == 32
    _assert_cos(port.embed_image(imgs), jax.embed_image(imgs), BF16_COS_TOL)
    # One engine chunk (padded to its bucket) against a direct forward.
    np.testing.assert_allclose(port.embed_image(imgs),
                               embed(port.encoder, torch.from_numpy(imgs)).numpy(), atol=1e-5)


def test_clip_text_conversion_parity(clip_dir):
    """Both pooling branches: an explicit end-of-text id pools its first
    position; the legacy eos_token_id 2 pools the highest id."""
    d, hf, vocab = clip_dir
    rows = _token_rows(vocab, (["the", "quick", "fox"], ["a", "photo", "of", "a", "dog"]))
    _, jmodel, jparams = jconvert.load_hf_checkpoint(d, dtype=jnp.float32)
    ref = np.asarray(jmodel.apply(jparams, jnp.asarray(rows, jnp.int32),
                                  method=jmodel.encode_text))
    _, enc = tconvert.load_hf_checkpoint(d, tower="text")
    assert enc.cfg.text_pool == jmodel.cfg.text_pool
    with torch.inference_mode():
        ours = enc(torch.from_numpy(rows)).numpy()
        theirs = hf.get_text_features(input_ids=torch.from_numpy(rows),
                                      attention_mask=torch.from_numpy((rows != 0).astype(np.int64)))
    _assert_cos(ours, ref, F32_COS_TOL)
    _assert_cos(ours, theirs.numpy(), HF_COS_TOL)
    port = cuda_provider.CUDACLIPTextEmbedder("clip-tiny", weights_path=d, device="cpu")
    jax = flax_provider.FlaxCLIPTextEmbedder("clip-tiny", weights_path=d)
    assert port.dimensions == jax.dimensions == 24
    _assert_cos(port.embed_text(CLIP_TEXTS[:-1]), jax.embed_text(CLIP_TEXTS[:-1]), BF16_COS_TOL)


def test_clip_text_pooling_with_token_id_zero_mid_sequence(clip_dir):
    """HF pools at the end-of-text position (the first holding its id, or
    the highest id); a vocabulary id 0 mid-sequence must not move it
    (last-non-pad would)."""
    d, hf, vocab = clip_dir
    zero_tok = next(k for k, v in vocab.items() if v == 0)
    ids = [vocab["<|startoftext|>"], vocab[zero_tok],
           next(v for k, v in vocab.items() if k.endswith("</w>") and v > 0),
           vocab["<|endoftext|>"]]
    rows = np.zeros((1, 16), dtype=np.int64)
    rows[0, :len(ids)] = ids
    _, jmodel, jparams = jconvert.load_hf_checkpoint(d, dtype=jnp.float32)
    ref = np.asarray(jmodel.apply(jparams, jnp.asarray(rows, jnp.int32), method=jmodel.encode_text))
    _, enc = tconvert.load_hf_checkpoint(d, tower="text")
    with torch.inference_mode():
        ours = enc(torch.from_numpy(rows)).numpy()
        theirs = hf.get_text_features(
            input_ids=torch.from_numpy(rows),
            attention_mask=torch.from_numpy((np.arange(16) < len(ids)).astype(np.int64)[None]))
        theirs = theirs.numpy()
    assert enc.pool_positions(torch.from_numpy(rows), enc.cfg.text_pool,
                              enc.cfg.eos_token_id).tolist() == [3]
    _assert_cos(ours, ref, F32_COS_TOL)
    _assert_cos(ours, theirs, HF_COS_TOL)


def test_pool_positions_follow_text_pool():
    from daft_tpu_torch.models.clip import CLIPTextEncoder

    t = torch.tensor([[49406, 320, 0, 49407, 0], [49406, 49407, 5, 0, 0], [0, 0, 0, 0, 0]])
    assert CLIPTextEncoder.pool_positions(t).tolist() == [2, 2, 0]  # counts non-pad ids
    assert CLIPTextEncoder.pool_positions(t, "first_eos", 49407).tolist() == [3, 1, 0]
    assert CLIPTextEncoder.pool_positions(t, "argmax_id", 2).tolist() == [3, 1, 0]


# --------------------------------------------------------------------- #
# Tokenizers                                                            #
# --------------------------------------------------------------------- #
def test_wordpiece_tokenizer_parity(bert_dir):
    path = os.path.join(bert_dir, "vocab.txt")
    hf = transformers.BertTokenizer(path)
    ours, ref = ttok.WordPieceTokenizer(path, 32), jtok.WordPieceTokenizer(path, 32)
    for text in ["the quick brown fox jumps!", "doggy , jumped over tpu.",
                 "unknownword the fox", "", "深度学 the fox", "深度habla"]:
        assert ours.encode_one(text) == ref.encode_one(text) == hf(text)["input_ids"], text
    for a, b in zip(ours.encode_batch(BERT_TEXTS + [None]), ref.encode_batch(BERT_TEXTS + [None])):
        np.testing.assert_array_equal(a, b)


def test_clip_bpe_tokenizer_parity(eos_clip_dir):
    d, _, _ = eos_clip_dir
    vj, mt = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
    hf = transformers.CLIPTokenizer(vj, mt)
    ours, ref = ttok.MergesBPETokenizer(vj, mt, 16), jtok.MergesBPETokenizer(vj, mt, 16)
    for text in ["the quick brown fox", "a photo of a cat on tpu", "dog cat dog"]:
        assert ours.encode_one(text) == ref.encode_one(text) == hf(text)["input_ids"], text
    for a, b in zip(ours.encode_batch(CLIP_TEXTS), ref.encode_batch(CLIP_TEXTS)):
        np.testing.assert_array_equal(a, b)


def test_gpt2_bpe_tokenizer_parity(tmp_path):
    """The byte-level gpt2 dialect against the JAX package's and HF's
    GPT2Tokenizer on a tiny fixture; ``tokenizer_from_dir`` picks it."""
    words = ["the", "dog", "cat", "run"]
    bm = ttok._bytes_to_unicode()
    assert bm == jtok._bytes_to_unicode()
    vocab, merges = {}, []
    for w in [" " + x for x in words] + words:
        parts = [bm[b] for b in w.encode()]
        for c in parts:
            vocab.setdefault(c, len(vocab))
        while len(parts) > 1:
            merges.append((parts[0], parts[1]))
            parts = [parts[0] + parts[1]] + parts[2:]
        vocab.setdefault(parts[0], len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    lines = ["#version: 0.2"] + [f"{a} {b}" for a, b in dict.fromkeys(merges)]
    (tmp_path / "merges.txt").write_text("\n".join(lines) + "\n")
    hf = transformers.GPT2Tokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    ours = ttok.tokenizer_from_dir(str(tmp_path), 16)
    ref = jtok.tokenizer_from_dir(str(tmp_path), 16)
    assert ours.style == ref.style == "gpt2"
    for text in ["the dog", "cat run the", "dog"]:
        assert ours.encode_one(text) == ref.encode_one(text) == hf(text)["input_ids"], text


def test_greedy_bpe_tokenizer_parity(tmp_path):
    """``BPETokenizer`` over a one-token-per-line and a tiktoken (base64
    rank) vocabulary: the JAX package's ids."""
    import base64

    pieces = [b"the", b"th", b"e", b"dog", b"do", b"g", b"a", b"cat", b"!"]
    (tmp_path / "lines.txt").write_bytes(b"\n".join(pieces) + b"\n")
    (tmp_path / "ranks.tiktoken").write_bytes(b"\n".join(
        base64.b64encode(p) + b" " + str(i * 3).encode() for i, p in enumerate(pieces)) + b"\n")
    texts = ["the dog", "a cat!", "thedog xyz", "", None, "dog " * 20]
    for name in ("lines.txt", "ranks.tiktoken"):
        ours = ttok.BPETokenizer(str(tmp_path / name), 8)
        ref = jtok.BPETokenizer(str(tmp_path / name), 8)
        assert ours.vocab == ref.vocab and ours.vocab_size == ref.vocab_size
        for a, b in zip(ours.encode_batch(texts), ref.encode_batch(texts)):
            np.testing.assert_array_equal(a, b)


def test_bpe_unknown_piece_maps_to_unk_keeps_positions(eos_clip_dir):
    d, _, vocab = eos_clip_dir
    ours = ttok.MergesBPETokenizer(os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"),
                                   max_length=16)
    # '%' is not in the vocabulary: it becomes unk (the end-of-text id) and
    # keeps its position, so the end of text the model pools stays last.
    with_unk, clean = ours.encode_one("the % fox"), ours.encode_one("the fox")
    assert len(with_unk) == len(clean) + 1
    assert with_unk[2] == vocab["<|endoftext|>"]
    assert with_unk == jtok.MergesBPETokenizer(
        os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt"), 16).encode_one("the % fox")


# --------------------------------------------------------------------- #
# Provider and engine                                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,model", [("text_embedder", "all-MiniLM-L6-v2"),
                                        ("text_embedder", "clip-tiny"),
                                        ("image_embedder", "tiny")])
def test_get_dimensions_reads_config_json(bert_dir, eos_clip_dir, kind, model):
    from daft_tpu.ai.provider import load_provider as jax_provider

    d = eos_clip_dir[0] if "tiny" in model else bert_dir
    desc = getattr(cuda_provider.CUDAProvider(), f"get_{kind}")(model, weights_path=d,
                                                                 device="cpu")
    ref = getattr(jax_provider("flax"), f"get_{kind}")(model, weights_path=d)
    assert desc.get_dimensions() == ref.get_dimensions() == (32 if d == bert_dir else 24)
    assert desc.instantiate().dimensions == desc.get_dimensions()


def _copy_dir(src, dst, drop=()):
    shutil.copytree(src, dst)
    for name in drop:
        os.remove(os.path.join(dst, name))
    return str(dst)


def test_unsupported_model_type_raises(bert_dir, tmp_path):
    d = _copy_dir(bert_dir, tmp_path / "gpt2")
    cfg = tconvert.hf_config(d)
    (tmp_path / "gpt2" / "config.json").write_text(json.dumps({**cfg, "model_type": "gpt2"}))
    with pytest.raises(DaftValueError, match="Unsupported model_type 'gpt2'"):
        tconvert.load_hf_checkpoint(d)
    with pytest.raises(DaftValueError, match="Unsupported model_type"):
        cuda_provider.CUDAMiniLMTextEmbedder("all-MiniLM-L6-v2", weights_path=d, device="cpu")


def test_a_missing_tensor_raises(bert_dir, tmp_path):
    d = tmp_path / "bert_missing"
    _copy_dir(bert_dir, d)
    sd = torch.load(d / "pytorch_model.bin", weights_only=True)
    del sd["encoder.layer.1.output.dense.weight"]
    torch.save(sd, d / "pytorch_model.bin")
    with pytest.raises(KeyError, match="encoder.layer.1.output.dense.weight"):
        tconvert.load_hf_checkpoint(str(d))
    with pytest.raises(KeyError):
        cuda_provider.CUDAMiniLMTextEmbedder("all-MiniLM-L6-v2", weights_path=str(d),
                                             device="cpu")


def test_a_parameter_the_conversion_leaves_unset_raises(bert_dir, monkeypatch):
    """Every parameter must come from the checkpoint: one the converted dict
    does not name raises instead of keeping an unset value."""
    convert_bert = tconvert.convert_bert
    monkeypatch.setattr(tconvert, "convert_bert", lambda sd, cfg: {
        k: v for k, v in convert_bert(sd, cfg).items() if k != "params/layer_0/fc1/bias"})
    with pytest.raises(DaftValueError, match=r"1 parameter\(s\) unset: \['layers.0.fc1.bias'\]"):
        tconvert.load_hf_checkpoint(bert_dir)


def test_missing_weights_or_tokenizer_files_raise(bert_dir, eos_clip_dir, tmp_path):
    with pytest.raises(DaftValueError, match="No loadable weights"):
        tconvert.load_hf_state_dict(_copy_dir(bert_dir, tmp_path / "no_w", ["pytorch_model.bin"]))
    d = _copy_dir(bert_dir, tmp_path / "no_vocab", ["vocab.txt"])
    with pytest.raises(DaftValueError, match=r"no tokenizer files \(vocab.txt\)"):
        cuda_provider.CUDAMiniLMTextEmbedder("all-MiniLM-L6-v2", weights_path=d, device="cpu")
    d = _copy_dir(eos_clip_dir[0], tmp_path / "no_merges", ["merges.txt"])
    with pytest.raises(DaftValueError, match=r"vocab.json \+ merges.txt"):
        cuda_provider.CUDACLIPTextEmbedder("clip-tiny", weights_path=d, device="cpu")
    # The image tower needs no tokenizer.
    image = cuda_provider.CUDACLIPImageEmbedder("tiny", weights_path=d, device="cpu")
    assert image.dimensions == 24


def test_a_checkpoint_of_the_wrong_kind_raises(bert_dir, eos_clip_dir):
    with pytest.raises(DaftValueError, match="expects a bert checkpoint, got 'clip'"):
        cuda_provider.CUDAMiniLMTextEmbedder("all-MiniLM-L6-v2", weights_path=eos_clip_dir[0],
                                             device="cpu")
    for cls in (cuda_provider.CUDACLIPTextEmbedder, cuda_provider.CUDACLIPImageEmbedder):
        with pytest.raises(DaftValueError, match="expects a clip checkpoint, got 'bert'"):
            cls("clip-tiny", weights_path=bert_dir, device="cpu")


def test_cuda_random_drops_the_checkpoint_and_serves_random_weights(bert_dir):
    """``cuda_random`` drops ``weights_path`` and makes the named model's
    random weights, as ``flax_random`` does."""
    inst = daft_tpu_torch.ai.provider.load_provider("cuda_random").get_text_embedder(
        "tiny", weights_path=bert_dir, device="cpu").instantiate()
    assert type(inst.encoder).__name__ == "MiniLMEncoder"
    assert type(inst.tokenizer).__name__ == "HashingTokenizer"


def test_embed_text_through_engine_with_local_checkpoint(bert_dir):
    """The engine's embed_text over a local BERT checkpoint (bf16, on the
    CPU on request) against the JAX engine's and HF's."""
    from daft_tpu.ai.torch_provider import TorchTextEmbedder
    from daft_tpu.functions.ai import embed_text as jembed_text

    texts = ["the quick brown fox", "tpu dataframe !", "a lazy dog jumps"]
    ours = np.asarray(daft_tpu_torch.from_pydict({"t": texts}).with_column("e", tai.embed_text(
        daft_tpu_torch.col("t"), model="all-MiniLM-L6-v2", weights_path=bert_dir,
        device="cpu")).to_pydict()["e"], np.float32)
    ref = np.asarray(daft_tpu.from_pydict({"t": texts}).with_column("e", jembed_text(
        daft_tpu.col("t"), provider="flax", model="all-MiniLM-L6-v2",
        weights_path=bert_dir)).to_pydict()["e"], np.float32)
    assert ours.shape == (3, 32)
    _assert_cos(ours, ref, BF16_COS_TOL)
    _assert_cos(ours, TorchTextEmbedder(bert_dir).embed_text(texts), BF16_COS_TOL)


def test_embed_image_through_engine_with_local_checkpoint(eos_clip_dir):
    from daft_tpu.functions.ai import embed_image as jembed_image

    imgs = _images(5, seed=4).reshape(5, -1)

    def run(pkg, fn, **kw):
        s = pkg.Series.from_numpy(imgs, "img", pkg.DataType.image("RGB", 32, 32))
        return np.asarray(pkg.from_pydict({"img": s}).with_column("e", fn(
            pkg.col("img"), model="tiny", weights_path=eos_clip_dir[0], **kw)).to_pydict()["e"],
            np.float32)

    ours = run(daft_tpu_torch, tai.embed_image, device="cpu")
    assert ours.shape == (5, 24)
    _assert_cos(ours, run(daft_tpu, jembed_image, provider="flax"), BF16_COS_TOL)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=1), 1.0, atol=1e-3)


@pytest.mark.parametrize("fn", ["classify_text", "classify_image"])
def test_classify_through_engine_with_local_checkpoint(eos_clip_dir, fn):
    """classify_* over a local CLIP checkpoint: each row's label is the
    argmax of the instance's own similarities, and the similarities agree
    with the JAX classifier's on the same directory (bf16, 5e-2)."""
    d = eos_clip_dir[0]
    labels = ["cat", "dog", "fox"]
    if fn == "classify_text":
        data, rows = {"x": CLIP_TEXTS[:-1]}, CLIP_TEXTS[:-1]
    else:
        rows = _images(4, seed=5)
        data = {"x": daft_tpu_torch.Series.from_numpy(rows.reshape(4, -1), "x",
                                                      daft_tpu_torch.DataType.image("RGB", 32, 32))}
    expr = getattr(tai, fn)(daft_tpu_torch.col("x"), labels, weights_path=d, device="cpu")
    out = daft_tpu_torch.from_pydict(data).with_column("l", expr).to_pydict()["l"]
    inst = expr._expr.udf._get_instance()
    jinst = flax_provider.FlaxCLIPClassifier("tiny", weights_path=d)
    if fn == "classify_text":
        emb, jemb = inst.text_embedder.embed_text(rows), jinst.text_embedder.embed_text(rows)
        lab, jlab = (e.text_embedder.embed_text(labels) for e in (inst, jinst))
    else:
        emb, jemb = inst.image_embedder.embed_image(rows), jinst.image_embedder.embed_image(rows)
        prompts = [f"a photo of a {l}" for l in labels]
        lab, jlab = (e.text_embedder.embed_text(prompts) for e in (inst, jinst))
    assert out == [labels[i] for i in (emb @ lab.T).argmax(axis=1)]
    np.testing.assert_allclose(emb @ lab.T, jemb @ jlab.T, atol=BF16_COS_TOL)
