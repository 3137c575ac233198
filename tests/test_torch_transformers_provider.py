"""The port's ``transformers`` provider (``daft_tpu_torch/ai/torch_provider.py``)
beside the JAX package's ``daft_tpu/ai/torch_provider.py``, on the CPU.

A tiny BERT directory is built from a ``transformers.BertConfig`` in the
test (seeded, no network), as ``tests/test_torch_convert.py`` builds one.
Both packages' ``TorchTextEmbedder`` load it and must give the same
embeddings bit for bit (the same torch CPU arithmetic); the engine's route
gives the same bytes as the direct call. Without ``device="cpu"`` the port
raises where no CUDA device is visible, and without ``transformers`` both
packages raise the same ``ImportError`` at instantiation.
"""

import sys

import numpy as np
import pytest
import torch

import daft_tpu_torch
from daft_tpu.ai.torch_provider import TorchTextEmbedder as JaxTorchTextEmbedder
from daft_tpu.ai.torch_provider import TorchTransformersProvider as JaxProvider
from daft_tpu_torch import col
from daft_tpu_torch.ai.provider import load_provider
from daft_tpu_torch.ai.torch_provider import TorchTextEmbedder
from daft_tpu_torch.errors import DaftValueError

transformers = pytest.importorskip("transformers")

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "quick", "brown", "fox",
         "jump", "##s", "##ed", "over", "lazy", "dog", "data", "##frame", "runs", "on", "gpu"]
TEXTS = ["the quick brown fox jumps over the lazy dog", "dataframe runs on gpu",
         "", None, "unknownword the fox", "dog " * 300]


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert_tf")
    vocab = d / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    cfg = transformers.BertConfig(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=4, intermediate_size=64,
                                  max_position_embeddings=512, type_vocab_size=2)
    torch.manual_seed(0)
    transformers.BertModel(cfg).eval().save_pretrained(str(d), safe_serialization=False)
    transformers.BertTokenizer(str(vocab)).save_pretrained(str(d))
    return str(d)


def test_embeddings_equal_the_jax_packages_bit_for_bit(bert_dir):
    ref = JaxTorchTextEmbedder(bert_dir).embed_text(TEXTS)
    emb = TorchTextEmbedder(bert_dir, device="cpu")
    out = emb.embed_text(TEXTS)
    assert emb.device.type == "cpu" and emb.dimensions == 32
    assert out.dtype == ref.dtype == np.float32 and out.shape == (len(TEXTS), 32)
    assert out.tobytes() == ref.tobytes()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_engine_route_gives_the_direct_bytes(bert_dir):
    from daft_tpu_torch.functions.ai import embed_text

    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        df = daft_tpu_torch.from_pydict({"t": TEXTS})
        got = df.with_column("e", embed_text(col("t"), provider="transformers", model=bert_dir,
                                             device="cpu", dimensions=32)).to_pydict()["e"]
    ref = JaxTorchTextEmbedder(bert_dir).embed_text(TEXTS)
    assert np.stack([np.asarray(v, np.float32) for v in got]).tobytes() == ref.tobytes()


def test_descriptor_matches_the_jax_packages(bert_dir):
    for kw in ({}, {"dimensions": 32, "batch_size": 8}):
        j = JaxProvider().get_text_embedder(**kw)
        t = load_provider("transformers", device="cpu").get_text_embedder(**kw)
        assert (t.get_provider(), t.get_model(), t.get_dimensions()) == \
            (j.get_provider(), j.get_model(), j.get_dimensions())
        assert (t.get_udf_options().batch_size, t.get_udf_options().max_concurrency) == \
            (j.get_udf_options().batch_size, j.get_udf_options().max_concurrency)


def test_without_cuda_it_raises_and_never_falls_back(bert_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DaftValueError, match="no CUDA device"):
        load_provider("transformers").get_text_embedder(bert_dir)
    with pytest.raises(DaftValueError, match="no CUDA device"):
        TorchTextEmbedder(bert_dir)


def test_without_transformers_both_packages_raise_the_same_import_error(bert_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    errors = []
    for desc in (JaxProvider().get_text_embedder(bert_dir),
                 load_provider("transformers", device="cpu").get_text_embedder(bert_dir)):
        with pytest.raises(ImportError) as e:
            desc.instantiate()
        errors.append((type(e.value), str(e.value)))
    assert errors[1] == errors[0]


def test_other_protocols_raise_as_in_the_jax_package():
    for p in (JaxProvider(), load_provider("transformers", device="cpu")):
        with pytest.raises(Exception, match="has no prompter"):
            p.get_prompter()
