"""The port's checkpoints beside the JAX package's, on the CPU: the
pipeline-progress checkpoints (``daft_tpu_torch/checkpoint.py``,
``DataFrame.with_checkpoint`` and the writers' ``checkpoint=``) and the
weight files ``weights_path`` reads (``daft_tpu_torch/models/checkpoint.py``:
``.npz``, flax ``.msgpack`` and orbax directories).

Mirrors ``tests/test_observability.py::test_checkpoint_resume`` and
``test_checkpoint_mixed_type_keys`` through both packages (the same rows and
the same keys sealed), counts a UDF's calls to show that a checkpointed write
runs the pipeline once, and mirrors ``tests/test_ai.py::
test_weights_path_orbax_dir``. The weight files are written on the test side
with ``flax.serialization.to_bytes`` (a bf16 leaf; a chunked leaf under a
small ``MAX_CHUNK_SIZE``) and the JAX package's ``save_params`` (orbax) from
the tiny MiniLM, CLIP and LM params. Each must read equal to the ``.npz`` of
the same arrays, load the same parameters bit for bit, and give the JAX
forward's outputs at 2e-5 in f32 (the same arithmetic summed in another
order; 3e-2 on the engine's bf16 path, as in tests/test_torch_text.py). A
missing key, an extra key and a wrong shape behave per format as in the JAX
package, except where a test names the difference (ROADMAP C.44).
"""

import copy
import dataclasses
import json
import sys

import flax.serialization as fs
import flax.traverse_util as tu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu import checkpoint as jckpt
from daft_tpu.functions import ai as jai
from daft_tpu.models import checkpoint as jweights
from daft_tpu.models import clip as jclip
from daft_tpu.models import lm as jlm
from daft_tpu.models import minilm as jminilm
from daft_tpu_torch import checkpoint as tckpt
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.functions import ai as tai
from daft_tpu_torch.models import checkpoint as tweights
from daft_tpu_torch.models import clip as tclip
from daft_tpu_torch.models import lm as tlm
from daft_tpu_torch.models import minilm as tminilm
from daft_tpu_torch.utils.tokenizer import HashingTokenizer
from torch_isolation import caches_reset  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 3e-2
PKGS = (daft_tpu, daft_tpu_torch)
CKPT = {daft_tpu: jckpt, daft_tpu_torch: tckpt}

pytestmark = [pytest.mark.filterwarnings("ignore:Specifying null_placement:FutureWarning"),
              pytest.mark.usefixtures("caches_reset")]


@pytest.fixture(autouse=True)
def _cpu():
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        yield


# --------------------------------------------------------------------- #
# Pipeline-progress checkpoints                                         #
# --------------------------------------------------------------------- #
def _cfg(pkg, path):
    m = CKPT[pkg]
    return m.CheckpointConfig(m.CheckpointStore(str(path)), on="key")


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_checkpoint_resume(pkg, tmp_path):
    """tests/test_observability.py::test_checkpoint_resume, in each package."""
    cfg = _cfg(pkg, tmp_path / "ckpt")
    df = pkg.from_pydict({"key": ["a", "b", "c", "d"], "v": [1, 2, 3, 4]})
    out1 = df.with_checkpoint(cfg)
    assert out1.count_rows() == 4
    out1.write_parquet(str(tmp_path / "out1"), checkpoint=cfg)
    assert cfg.store.load_keys() == {"a", "b", "c", "d"}
    df2 = pkg.from_pydict({"key": ["a", "b", "c", "d", "e"], "v": [1, 2, 3, 4, 5]})
    remaining = df2.with_checkpoint(cfg)
    assert remaining.to_pydict()["key"] == ["e"]
    remaining.write_parquet(str(tmp_path / "out2"), checkpoint=cfg)
    assert "e" in cfg.store.load_keys()
    cfg.store.clear()
    assert cfg.store.load_keys() == set()


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_checkpoint_mixed_type_keys(pkg, tmp_path):
    """tests/test_observability.py::test_checkpoint_mixed_type_keys: int and
    str keys sealed by different runs must not break ``filter_done``."""
    cfg = _cfg(pkg, tmp_path / "ckpt")
    cfg.store.append_keys([1, 2])
    cfg.store.append_keys(["a", "b"])
    assert cfg.store.load_keys() == {1, 2, "a", "b"}
    out = cfg.filter_done(pkg.from_pydict({"key": [1, "a", 3, "c"], "v": [10, 20, 30, 40]}))
    out = out.to_pydict()
    assert out["key"] == [3, "c"]
    assert out["v"] == [30, 40]


def _resume_run(pkg, root):
    """Three runs over growing inputs; each run's written rows and the keys
    sealed after it."""
    cfg = _cfg(pkg, root / "ckpt")
    seen = []
    for n, name in ((6, "r1"), (6, "r2"), (9, "r3")):
        df = pkg.from_pydict({"key": list(range(n)), "v": [float(i) * 1.5 for i in range(n)]})
        df.with_checkpoint(cfg).write_parquet(str(root / name), checkpoint=cfg)
        files = sorted((root / name).rglob("*.parquet"))
        written = pkg.read_parquet(str(root / name)).to_pydict() if files else {"key": []}
        order = np.argsort(written["key"], kind="stable")
        seen.append(({k: [v[i] for i in order] for k, v in written.items()},
                     sorted(cfg.store.load_keys()), len(files) > 0))
    return seen


def test_resume_equals_the_jax_packages(tmp_path):
    ref = _resume_run(daft_tpu, tmp_path / "jax")
    out = _resume_run(daft_tpu_torch, tmp_path / "torch")
    assert out == ref
    assert [len(rows["key"]) for rows, _, _ in out] == [6, 0, 3]
    assert out[-1][1] == list(range(9))


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_checkpointed_write_runs_the_pipeline_once(pkg, tmp_path):
    calls = []

    def double(s):
        calls.append(len(s))
        return s.to_numpy() * 2

    udf = pkg.udf.Udf(double, pkg.DataType.int64(), batch=True)
    cfg = _cfg(pkg, tmp_path / "ckpt")
    df = pkg.from_pydict({"key": list(range(100)), "v": list(range(100))})
    df.with_column("w", udf(pkg.col("v"))).write_parquet(str(tmp_path / "o"), checkpoint=cfg)
    assert sum(calls) == 100
    assert cfg.store.load_keys() == set(range(100))
    assert sorted(pkg.read_parquet(str(tmp_path / "o")).to_pydict()["w"]) == \
        [2 * i for i in range(100)]


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_seal_runs_the_frame_and_skips_null_keys(pkg, tmp_path):
    cfg = _cfg(pkg, tmp_path / "ckpt")
    cfg.seal(pkg.from_pydict({"key": ["x", None, "y", "x"]}))
    assert cfg.store.load_keys() == {"x", "y"}
    assert cfg.filter_done(pkg.from_pydict({"key": ["x", "z"]})).to_pydict() == {"key": ["z"]}


def test_a_store_under_file_url_is_the_local_directory(tmp_path):
    local = tckpt.CheckpointStore(str(tmp_path / "c"))
    local.append_keys([3, 1])
    assert tckpt.CheckpointStore("file://" + str(tmp_path / "c")).load_keys() == {1, 3}


@pytest.mark.parametrize("url", ["s3://bucket/ckpt", "gs://bucket/ckpt"])
def test_a_remote_store_raises_naming_a8(url, tmp_path, monkeypatch):
    """A store under an object-store URL: remote IO came with ROADMAP A.8.2,
    so it no longer raises; the keys round-trip through the stub, and the
    JAX package's store reads what the port's wrote."""
    from daft_tpu.io import gcs_auth as jgcs_auth
    from daft_tpu_torch.io import gcs_auth as tgcs_auth
    from daft_tpu_torch.tools.object_stores import GcsStub, S3Stub

    for mod in (jgcs_auth, tgcs_auth):  # no ADC probe: the token is static
        monkeypatch.setattr(mod, "_METADATA_PROBE", False)
        mod._PROVIDER_CACHE.clear()
    stub = S3Stub(root=str(tmp_path)) if url.startswith("s3") else GcsStub(root=str(tmp_path))
    (tmp_path / "bucket").mkdir()  # an S3 bucket exists before its keys

    def io_config(pkg):
        if url.startswith("s3"):
            return pkg.IOConfig(s3=pkg.S3Config(endpoint_url=stub.url, region_name=stub.region,
                                                key_id=stub.key_id, access_key=stub.secret,
                                                use_native_client=True))
        return pkg.IOConfig(gcs=pkg.GCSConfig(endpoint_url=stub.url, token="t0"))

    try:
        with daft_tpu_torch.planning_config_ctx(default_io_config=io_config(daft_tpu_torch)):
            store = tckpt.CheckpointStore(url)
            assert store.load_keys() == set()
            store.append_keys([3, 1])
            store.append_keys([2])
            port = store.load_keys()
        with daft_tpu.planning_config_ctx(default_io_config=io_config(daft_tpu)):
            jax = jckpt.CheckpointStore(url).load_keys()
    finally:
        stub.close()
    assert port == jax == {1, 2, 3} and not stub.bad_auth


# --------------------------------------------------------------------- #
# Weight files                                                          #
# --------------------------------------------------------------------- #
def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in tu.flatten_dict(fs.to_state_dict(tree), sep="/").items()}


def _tree(flat: dict) -> dict:
    return tu.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


#: name -> (the JAX init, the leaf stored as bf16)
MODELS = {
    "minilm": (lambda: jminilm.init_minilm_params(
        dataclasses.replace(jminilm.MiniLMConfig.tiny(), dtype=jnp.float32), seed=3),
        "params/pos_embed"),
    "clip": (lambda: jclip.init_clip_params(
        dataclasses.replace(jclip.CLIPConfig.tiny(), dtype=jnp.float32), seed=3),
        "params/vision/pos_embed"),
    "lm": (lambda: jlm.init_lm_params(
        dataclasses.replace(jlm.DecoderLMConfig.tiny(), dtype=jnp.float32), seed=3),
        "params/pos_embed"),
}


def _ports(name):
    """The port's modules for ``name`` in f32 on the CPU (random weights)."""
    if name == "minilm":
        return [tminilm.MiniLMEncoder(
            dataclasses.replace(tminilm.MiniLMConfig.tiny(), dtype=torch.float32), device="cpu")]
    if name == "clip":
        cfg = dataclasses.replace(tclip.CLIPConfig.tiny(), dtype=torch.float32)
        return [tclip.CLIPImageEncoder(cfg, device="cpu"), tclip.CLIPTextEncoder(cfg, device="cpu")]
    return [tlm.DecoderLM(dataclasses.replace(tlm.DecoderLMConfig.tiny(), dtype=torch.float32),
                          device="cpu")]


LOADERS = {"minilm": tminilm.load_params, "clip": tclip.load_params, "lm": tlm.load_params}


def _forwards(name, model, params, modules):
    """(JAX outputs, port outputs) of each module on seeded inputs."""
    out = []
    with torch.no_grad():
        if name == "minilm":
            tokens, _ = HashingTokenizer(512, 32).encode_batch(["hello world", "", "a b c d"])
            out.append((model.apply(params, jnp.asarray(tokens)),
                        modules[0](torch.from_numpy(tokens))))
        elif name == "clip":
            px = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
            tokens = np.random.default_rng(6).integers(1, 512, (2, 16)).astype(np.int32)
            tokens[0, 5:] = 0
            out.append((model.apply(params, jnp.asarray(px), method=model.encode_image),
                        modules[0](torch.from_numpy(px))))
            out.append((model.apply(params, jnp.asarray(tokens), method=model.encode_text),
                        modules[1](torch.from_numpy(tokens))))
        else:
            toks = np.random.default_rng(7).integers(0, 512, (2, 8)).astype(np.int32)
            pos = np.tile(np.arange(8), (2, 1))
            jcfg = dataclasses.replace(jlm.DecoderLMConfig.tiny(), dtype=jnp.float32)
            ref, _ = model.apply(params, jnp.asarray(toks), jlm.init_caches(jcfg, 2, 16),
                                 jnp.asarray(pos, jnp.int32))
            tcaches = tlm.init_caches(modules[0].cfg, 2, 16, device="cpu")
            got, _ = modules[0](torch.from_numpy(toks), tcaches, torch.from_numpy(pos))
            out.append((ref, got))
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Per model: the JAX model and params (one leaf rounded to bf16), and
    the same arrays as an ``.npz`` (f32) and a flax ``.msgpack`` (the leaf
    stored as bf16)."""
    d = tmp_path_factory.mktemp("weights")
    out = {}
    for name, (init, bf16_key) in MODELS.items():
        model, params = init()
        flat = _flat(params)
        bf = {k: (jnp.asarray(v, jnp.bfloat16) if k == bf16_key else v) for k, v in flat.items()}
        ref = {k: np.asarray(v, np.float32) if k == bf16_key else v for k, v in bf.items()}
        np.savez(d / f"{name}.npz", **ref)
        (d / f"{name}.msgpack").write_bytes(fs.to_bytes(_tree(bf)))
        out[name] = dict(model=model, tree=_tree(bf), ref=ref, npz=str(d / f"{name}.npz"),
                         msgpack=str(d / f"{name}.msgpack"), bf16_key=bf16_key, dir=d)
    return out


def _state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _assert_same_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_msgpack_reads_equal_the_npz_and_the_jax_forward(weights, name):
    w = weights[name]
    flat = tweights.load_flat(w["msgpack"])
    assert flat.keys() == w["ref"].keys()
    for k, v in w["ref"].items():
        assert flat[k].dtype == v.dtype and np.array_equal(flat[k], v), k
    assert tweights.checkpoint_format(w["msgpack"]) == "msgpack"
    assert tweights.load_flat(w["npz"]).keys() == w["ref"].keys()
    via_npz, via_msgpack = _ports(name), _ports(name)
    for a, b in zip(via_npz, via_msgpack):
        LOADERS[name](w["npz"], a)
        LOADERS[name](w["msgpack"], b)
        _assert_same_params(_state(a), _state(b))
    jparams = jweights.load_params(w["msgpack"], w["tree"])
    assert jparams is not None
    for ref, got in _forwards(name, w["model"], jparams, via_msgpack):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_chunked_leaves_read_as_flax_writes_them(weights, monkeypatch, tmp_path):
    w = weights["minilm"]
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 256)
    blob = fs.to_bytes(w["tree"])
    assert b"__msgpack_chunked_array__" in blob
    path = tmp_path / "chunked.msgpack"
    path.write_bytes(blob)
    flat = tweights.load_flat(str(path))
    assert flat.keys() == w["ref"].keys()
    for k, v in w["ref"].items():
        assert np.array_equal(flat[k], v), k
    a, b = _ports("minilm")[0], _ports("minilm")[0]
    tminilm.load_params(str(path), a)
    tminilm.load_params(w["npz"], b)
    _assert_same_params(_state(a), _state(b))
    # And flax reads its own file back to the same arrays.
    back = _flat(fs.from_bytes(w["tree"], blob))
    assert all(np.array_equal(np.asarray(back[k], np.float32), v) for k, v in w["ref"].items())


def test_scalar_and_complex_leaves(tmp_path):
    tree = {"params": {"s": np.float32(2.5), "i": np.int64(3), "c": 1 + 2j, "p": 7,
                       "a": np.arange(6, dtype=np.int16).reshape(2, 3)}}
    path = tmp_path / "leaves.msgpack"
    path.write_bytes(fs.to_bytes(tree))
    flat = tweights.load_flat(str(path))
    ref = fs.msgpack_restore(path.read_bytes())["params"]
    assert sorted(flat) == ["params/a", "params/c", "params/i", "params/p", "params/s"]
    for k in ("s", "i", "a"):
        assert flat[f"params/{k}"].dtype == np.asarray(ref[k]).dtype
        assert np.array_equal(flat[f"params/{k}"], np.asarray(ref[k])), k
    assert complex(flat["params/c"]) == ref["c"] == 1 + 2j
    assert int(flat["params/p"]) == 7


@pytest.mark.parametrize("name", ["minilm", "clip"])
def test_orbax_directory_reads_equal_the_npz_and_the_jax_forward(weights, name, tmp_path):
    pytest.importorskip("tensorstore")
    pytest.importorskip("orbax.checkpoint")
    w = weights[name]
    d = str(tmp_path / f"{name}_orbax")
    jweights.save_params(w["tree"], d)
    assert tweights.checkpoint_format(d) == "orbax"
    flat = tweights.load_flat(d)
    assert flat.keys() == w["ref"].keys()
    for k, v in w["ref"].items():
        assert np.array_equal(flat[k], v), k
    via_orbax, via_npz = _ports(name), _ports(name)
    for a, b in zip(via_orbax, via_npz):
        LOADERS[name](d, a)
        LOADERS[name](w["npz"], b)
        _assert_same_params(_state(a), _state(b))
    like = _tree({k: np.asarray(v, np.float32) for k, v in w["ref"].items()})
    jparams = jweights.load_params(d, like)
    for ref, got in _forwards(name, w["model"], jparams, via_orbax):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_weights_path_orbax_dir(tmp_path):
    """tests/test_ai.py::test_weights_path_orbax_dir: an orbax directory
    through ``embed_text(weights_path=...)``. The JAX test compares with
    ``flax_random`` at the same seed; the port's random weights come from
    torch's generator, so the port is held to the ``.npz`` of the same
    params (the same bytes) and to the JAX package on that directory."""
    pytest.importorskip("tensorstore")
    pytest.importorskip("orbax.checkpoint")
    _, params = jminilm.init_minilm_params(jminilm.MiniLMConfig.tiny(), seed=7)
    d = str(tmp_path / "w")
    jweights.save_params(params, d)
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **_flat(params))

    def embed(pkg, fn, provider, path, **kw):
        df = pkg.from_pydict({"t": ["hello", "a b c", ""]})
        out = df.with_column("e", fn(pkg.col("t"), provider=provider, model="tiny",
                                     weights_path=path, seed=7, **kw)).to_pydict()["e"]
        return np.asarray(out, np.float32)

    e1 = embed(daft_tpu_torch, tai.embed_text, "cuda", d, device="cpu")
    e2 = embed(daft_tpu_torch, tai.embed_text, "cuda", npz, device="cpu")
    ref = embed(daft_tpu, jai.embed_text, "flax", d)
    assert e1.tobytes() == e2.tobytes()
    np.testing.assert_allclose(e1, ref, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("fn_name", ["embed_text", "prompt"])
def test_engine_msgpack_route_gives_the_npz_bytes(weights, fn_name):
    name = "minilm" if fn_name == "embed_text" else "lm"
    w = weights[name]
    fn = getattr(tai, fn_name)
    kw = {"max_new_tokens": 5} if fn_name == "prompt" else {}
    outs = []
    for path in (w["npz"], w["msgpack"]):
        df = daft_tpu_torch.from_pydict({"t": ["hello world", None, "a b c", "hello world"]})
        outs.append(df.with_column("y", fn(daft_tpu_torch.col("t"), provider="cuda",
                                           model="tiny", weights_path=path, device="cpu",
                                           **kw)).to_pydict()["y"])
    if fn_name == "embed_text":
        assert np.asarray(outs[0], np.float32).tobytes() == np.asarray(outs[1], np.float32).tobytes()
    else:
        assert outs[0] == outs[1] and all(isinstance(s, str) for s in outs[0])


# -- keys and shapes the model does not expect, per format ---------------------------
def _write(fmt, flat, path):
    if fmt == "npz":
        np.savez(path + ".npz", **flat)
        return path + ".npz"
    if fmt == "msgpack":
        with open(path + ".msgpack", "wb") as f:
            f.write(fs.to_bytes(_tree(flat)))
        return path + ".msgpack"
    pytest.importorskip("tensorstore")
    pytest.importorskip("orbax.checkpoint")
    jweights.save_params(_tree(flat), path)
    return path


def _jax_outcome(path, like, model, tokens):
    """``"loads"`` or the name of what the JAX package raises, loading and
    then running the forward."""
    try:
        params = jweights.load_params(path, like)
        model.apply(params, jnp.asarray(tokens))
    except Exception as e:  # noqa: BLE001 -- the outcome is what is compared
        return type(e).__name__
    return "loads"


FORMATS = ["npz", "msgpack", "orbax"]
#: (case, format) -> what both packages do, where they agree.
AGREED = {("missing", "npz"): "loads", ("missing", "msgpack"): "raises",
          ("missing", "orbax"): "raises", ("extra", "npz"): "loads",
          ("extra", "msgpack"): "loads", ("extra", "orbax"): "raises"}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", ["missing", "extra", "shape"])
def test_foreign_trees_load_or_raise_as_in_the_jax_package(weights, tmp_path, case, fmt):
    model, params = jminilm.init_minilm_params(jminilm.MiniLMConfig.tiny(), seed=3)
    flat = _flat(params)
    if case == "missing":
        del flat["params/pos_embed"]
    elif case == "extra":
        flat["params/extra/kernel"] = np.ones((2, 2), np.float32)
    else:
        flat["params/pos_embed"] = np.zeros((3, 3), np.float32)
    path = _write(fmt, flat, str(tmp_path / f"{case}_{fmt}"))
    tokens, _ = HashingTokenizer(512, 32).encode_batch(["hello world", "a b"])
    jax_outcome = _jax_outcome(path, params, model, tokens)
    enc = tminilm.MiniLMEncoder(tminilm.MiniLMConfig.tiny(), device="cpu")
    before = _state(enc)
    try:
        tminilm.load_params(path, enc)
        port_outcome = "loads"
    except DaftValueError:
        port_outcome = "raises"
    if case == "shape":
        # C.44: the JAX package loads the array and flax refuses its shape at
        # the forward; the port refuses it at the load. Both fail the batch.
        assert jax_outcome == "ScopeParamShapeError" and port_outcome == "raises"
        return
    assert port_outcome == AGREED[case, fmt]
    assert (jax_outcome == "loads") == (port_outcome == "loads"), jax_outcome
    if case == "missing" and fmt == "npz":
        # The model keeps its own value for the key the file lacks.
        assert torch.equal(enc.pos_embed.detach(), before["pos_embed"])


def test_a_tower_is_held_to_the_whole_clip_tree(weights, tmp_path):
    """The JAX package loads the whole CLIP model for either tower, so a
    ``.msgpack`` without the text tower fails the image tower too."""
    vision_only = {k: v for k, v in weights["clip"]["ref"].items()
                   if not k.startswith("params/text/")}
    path = _write("msgpack", vision_only, str(tmp_path / "vision_only"))
    cfg = dataclasses.replace(tclip.CLIPConfig.tiny(), dtype=torch.float32)
    with pytest.raises(DaftValueError, match="missing"):
        tclip.load_params(path, tclip.CLIPImageEncoder(cfg, device="cpu"))
    with pytest.raises(ValueError):
        jclip.load_params(path, jclip.CLIPConfig.tiny())
    # The .npz reader takes what it finds, in both packages.
    npz = _write("npz", vision_only, str(tmp_path / "vision_only"))
    tclip.load_params(npz, tclip.CLIPImageEncoder(cfg, device="cpu"))
    jclip.load_params(npz, jclip.CLIPConfig.tiny())


# -- files that cannot be read ---------------------------------------------------------
def test_an_unreadable_msgpack_raises(tmp_path):
    path = tmp_path / "broken.msgpack"
    path.write_bytes(b"\x92\x01")
    with pytest.raises(DaftValueError, match="msgpack"):
        tweights.load_flat(str(path))
    with pytest.raises(ValueError):
        fs.msgpack_restore(path.read_bytes())


def test_a_directory_without_metadata_raises(tmp_path):
    with pytest.raises(DaftValueError, match="_METADATA"):
        tweights.load_flat(str(tmp_path))


def test_missing_readers_raise_import_errors_naming_them(tmp_path, monkeypatch, weights):
    (tmp_path / "_METADATA").write_text(json.dumps({"tree_metadata": {}}))
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        tweights.load_flat(str(tmp_path))
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="msgpack"):
        tweights.load_flat(weights["minilm"]["msgpack"])


def test_the_readers_import_their_libraries_only_when_called():
    import subprocess

    code = ("import sys, daft_tpu_torch\n"
            "from daft_tpu_torch.models import checkpoint, clip, minilm, lm\n"
            "from daft_tpu_torch.ai import provider, api_providers, torch_provider, cuda_provider\n"
            "import daft_tpu_torch.checkpoint\n"
            "provider.load_provider('transformers')\n"
            "bad = [m for m in ('msgpack', 'tensorstore', 'transformers', 'jax', 'flax')"
            " if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_copy_of_the_tree_is_untouched(weights):
    """Reading never writes into the arrays it returns from the file."""
    w = weights["minilm"]
    a = tweights.load_flat(w["msgpack"])
    b = copy.deepcopy(a)
    enc = _ports("minilm")[0]
    tminilm.load_flax_params(enc, a)
    assert all(np.array_equal(a[k], b[k]) for k in a)
