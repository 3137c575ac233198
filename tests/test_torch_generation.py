"""The port's generation path against the JAX package's, on the CPU: the
cached attention, the decoder LM and its caches, ``generate``, the continuous
batcher, and ``prompt`` / ``llm_generate`` through the engine.

Weights come from the flax init of the tiny config and reach the port through
``load_flax_params`` or the JAX package's ``.npz`` layout; inputs are made
with numpy from seeds. Tolerances: 2e-5 in f32 and 3e-2 in bf16, as in
tests/test_pallas.py. Tokens are compared exactly, on f32 weights (bf16
rounding differs between the frameworks and would flip near-ties), at
temperature 0: the frameworks' random draws never agree.
"""

import dataclasses
import functools

import flax.serialization as fs
import flax.traverse_util as tu
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.functions import ai as jai
from daft_tpu.models import lm as jlm
from daft_tpu.models import serving as jserving
from daft_tpu_torch.ai import cuda_provider, protocols
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.functions import ai as tai
from daft_tpu_torch.models import lm as tlm
from daft_tpu_torch.models import serving as tserving

F32_TOL = 2e-5
BF16_TOL = 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in tu.flatten_dict(fs.to_state_dict(params), sep="/").items()}


def _close(out: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32),
                               atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def _lm(dtype_name: str):
    """(flax model, flax params, flat state dict, port DecoderLM on those weights)."""
    jdt, tdt, _ = DTYPES[dtype_name]
    model, params = jlm.init_lm_params(dataclasses.replace(jlm.DecoderLMConfig.tiny(), dtype=jdt),
                                       seed=0)
    flat = _flat(params)
    tmodel = tlm.DecoderLM(dataclasses.replace(tlm.DecoderLMConfig.tiny(), dtype=tdt),
                           device="cpu")
    tlm.load_flax_params(tmodel, flat)
    return model, params, flat, tmodel.eval().requires_grad_(False)


def _caches(dtype_name: str, B: int, S: int, seed=None):
    """Caches for both packages: zeros, or normal values from ``seed``; the
    JAX package's (B, S, H, hd), the port's (B, H, S, hd)."""
    jdt, tdt, _ = DTYPES[dtype_name]
    cfg = tlm.DecoderLMConfig.tiny()
    shape = (B, S, cfg.heads, cfg.hidden // cfg.heads)
    out = []
    for i in range(cfg.layers):
        pair = [np.zeros(shape, np.float32) if seed is None else
                np.random.default_rng(seed + 2 * i + j).normal(size=shape).astype(np.float32)
                for j in range(2)]
        out.append(([jnp.asarray(a, jdt) for a in pair],
                    [torch.from_numpy(a).to(tdt).transpose(1, 2).contiguous() for a in pair]))
    return out


def _cache_close(tcache: torch.Tensor, jcache, tol: float) -> None:
    _close(tcache.transpose(1, 2), jcache, tol)


# --------------------------------------------------------------------- #
# Model                                                                 #
# --------------------------------------------------------------------- #
# (positions of each of the 2 rows): a prefill of 8 from 0 into zeroed
# caches, and decode steps at middle positions into caches holding values.
PHASES = {"prefill": (np.tile(np.arange(8), (2, 1)), None),
          "decode": (np.array([[5], [11]]), 7)}


@pytest.mark.parametrize("phase", sorted(PHASES))
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_cached_attention_matches_flax(dtype_name, phase):
    jdt, tdt, tol = DTYPES[dtype_name]
    _, params, _, tmodel = _lm(dtype_name)
    positions, seed = PHASES[phase]
    x = np.random.default_rng(1).normal(size=positions.shape + (64,)).astype(np.float32)
    (jk, jv), (tk, tv) = _caches(dtype_name, 2, 16, seed)[0]
    ref, ref_k, ref_v = jlm.CachedSelfAttention(2, jdt).apply(
        {"params": params["params"]["block_0"]["attn"]}, jnp.asarray(x, jdt), jk, jv,
        jnp.asarray(positions, jnp.int32))
    out = tmodel.blocks[0].attn(torch.from_numpy(x).to(tdt), tk, tv, torch.from_numpy(positions))
    _close(out, ref, tol)
    _cache_close(tk, ref_k, tol)  # written in place
    _cache_close(tv, ref_v, tol)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_decoder_lm_logits_and_caches_match_flax(dtype_name):
    """A prefill of ragged prompts, then a decode step at two positions."""
    _, params, _, tmodel = _lm(dtype_name)
    model = jlm.DecoderLM(dataclasses.replace(jlm.DecoderLMConfig.tiny(),
                                              dtype=DTYPES[dtype_name][0]))
    tol = DTYPES[dtype_name][2]
    rng = np.random.default_rng(2)
    tokens = rng.integers(3, 512, (2, 8)).astype(np.int32)
    caches = _caches(dtype_name, 2, 16)
    jcaches = [tuple(j) for j, _ in caches]
    tcaches = [tuple(t) for _, t in caches]
    for toks, pos in ((tokens, np.tile(np.arange(8), (2, 1))),
                      (np.array([[7], [300]], np.int32), np.array([[8], [6]]))):
        ref, jcaches = model.apply(params, jnp.asarray(toks), jcaches, jnp.asarray(pos, jnp.int32))
        out, returned = tmodel(torch.from_numpy(toks), tcaches, torch.from_numpy(pos))
        assert returned is tcaches  # written in place
        assert out.dtype == torch.float32 and out.shape == (2, toks.shape[1], 512)
        _close(out, ref, tol)
        for (tk, tv), (jk, jv) in zip(tcaches, jcaches):
            _cache_close(tk, jk, tol)
            _cache_close(tv, jv, tol)


def test_load_flax_params_maps_every_leaf_and_keeps_the_head_f32(tmp_path):
    _, _, flat, _ = _lm("f32")
    model = tlm.DecoderLM(tlm.DecoderLMConfig.tiny(), device="cpu")
    path = tmp_path / "lm.npz"
    np.savez(path, **flat)
    tlm.load_params(str(path), model)
    loaded = tlm.load_flax_params(model, flat)
    assert len(loaded) == len(flat) == len(set(loaded))
    assert set(loaded) == {name for name, _ in model.named_parameters()}
    dtypes = {name: p.dtype for name, p in model.named_parameters()}
    for name in ("tok_embed.weight", "pos_embed", "lm_head.weight", "ln_f.weight",
                 "blocks.0.ln1.weight"):
        assert dtypes[name] == torch.float32, name
    assert dtypes["blocks.1.attn.qkv.weight"] == dtypes["blocks.0.mlp.fc2.bias"] == torch.bfloat16
    np.testing.assert_array_equal(model.lm_head.weight.detach().numpy(),
                                  flat["params/lm_head/kernel"].T)
    np.testing.assert_array_equal(model.tok_embed.weight.detach().numpy(),
                                  flat["params/tok_embed/embedding"])
    with pytest.raises(DaftValueError):
        tlm.load_flax_params(model, {"params/vision/cls": np.zeros((1, 1, 64), np.float32)})


@pytest.mark.parametrize("name", ["default-lm", "tiny", "llama-8b"])
def test_configs_match_the_jax_package(name):
    ref, cfg = jlm.DecoderLMConfig.from_name(name), tlm.DecoderLMConfig.from_name(name)
    fields = ("vocab_size", "hidden", "layers", "heads", "max_seq_len")
    assert [getattr(cfg, f) for f in fields] == [getattr(ref, f) for f in fields]
    assert cfg.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


def test_random_init_follows_its_seed():
    def make(seed):
        m = tlm.DecoderLM(tlm.DecoderLMConfig.tiny(), device="cpu")
        return tlm.init_random_(m, torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.lm_head.weight, c.lm_head.weight)
    assert a.lm_head.weight.dtype == torch.float32
    assert float(a.pos_embed.detach().std()) == pytest.approx(0.01, rel=0.05)


@pytest.mark.parametrize("lengths,max_new", [([10, 7, 4, 9], 20), ([3, 12], 52)])
def test_generate_equals_the_jax_package_token_for_token(lengths, max_new):
    model, params, _, _ = _lm("f32")
    tmodel = _lm("f32")[3]
    P = max(lengths)
    rng = np.random.default_rng(3)
    tokens = np.zeros((len(lengths), P), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(3, 512, n)
    ref = np.asarray(jlm.generate(model, params, jnp.asarray(tokens),
                                  jnp.asarray(lengths, jnp.int32), max_new))
    out = tlm.generate(tmodel, torch.from_numpy(tokens), torch.tensor(lengths), max_new)
    assert out.dtype == torch.int32 and out.shape == (len(lengths), max_new)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_rejects_a_run_past_max_seq_len():
    tmodel = _lm("f32")[3]
    with pytest.raises(DaftValueError, match="max_seq_len"):
        tlm.generate(tmodel, torch.ones((1, 20), dtype=torch.int32), torch.tensor([20]), 45)


# --------------------------------------------------------------------- #
# Continuous batcher                                                    #
# --------------------------------------------------------------------- #
def _traffic(name: str):
    """(prompts, max_new_tokens per request, slots) of a named mix."""
    if name == "throughput_mix":  # tests/test_serving.py's mix; its positions peak at S - 1
        rng = np.random.default_rng(1)
        prompts = [rng.integers(3, 512, rng.integers(4, 14)).astype(np.int32) for _ in range(48)]
        return prompts, [int(m) for m in rng.integers(2, 60, 48)], 4
    if name == "static_schedule":  # every request fills the cache
        rng = np.random.default_rng(0)
        return [rng.integers(3, 512, 10).astype(np.int32) for _ in range(6)], [54] * 6, 3
    if name == "past_the_cache":  # a slot retires full while the other decodes on
        rng = np.random.default_rng(7)
        prompts = [rng.integers(3, 512, n).astype(np.int32) for n in (50, 4, 45, 6)]
        return prompts, [60, 59, 40, 58], 2
    if name == "long_then_short":  # slots reused after longer requests
        rng = np.random.default_rng(4)
        prompts = [rng.integers(3, 512, 45 if i % 2 else 5).astype(np.int32) for i in range(10)]
        return prompts, [int(m) for m in rng.integers(3, 16, 10)], 2
    rng = np.random.default_rng(5)  # repeats: prefix routing shares prefills
    base = [rng.integers(3, 512, n).astype(np.int32) for n in (6, 20, 9)]
    return [base[i % 3].copy() for i in range(11)], [5, 9, 7, 5, 9, 7, 5, 9, 7, 5, 9], 4


def _requests(pkg, prompts, maxes):
    return [pkg.Request(tokens=p.copy(), max_new_tokens=m) for p, m in zip(prompts, maxes)]


def _batch(tmodel, prompts, maxes, slots, **options):
    """The port's batcher over ``prompts``; ``maxes`` one count or one per
    prompt. Returns (tokens per request, the batcher)."""
    if isinstance(maxes, int):
        maxes = [maxes] * len(prompts)
    batcher = tserving.ContinuousBatcher(tmodel, num_slots=slots, **options)
    return batcher.run(_requests(tserving, prompts, maxes)), batcher


@pytest.mark.parametrize("traffic", ["throughput_mix", "past_the_cache", "static_schedule",
                                     "long_then_short", "repeats"])
def test_batcher_equals_the_jax_batcher(traffic):
    model, params, _, tmodel = _lm("f32")
    prompts, maxes, slots = _traffic(traffic)
    jb = jserving.ContinuousBatcher(model, params, num_slots=slots)
    jpositions, jdecode = [], jb._decode

    def record(*args):
        out = jdecode(*args)
        jpositions.append(int(np.asarray(out[2]).max()))
        return out

    jb._decode = record
    ref = jb.run(_requests(jserving, prompts, maxes))
    tb = tserving.ContinuousBatcher(tmodel, num_slots=slots)
    admitted = []
    prefill = tb._prefill
    tb._prefill = lambda req, slot: admitted.append((slot, len(req.tokens))) or prefill(req, slot)
    out = tb.run(_requests(tserving, prompts, maxes))
    assert out == ref
    assert tb.decode_steps == jb.decode_steps == tb.last_run_stats["decode_steps"]
    assert [len(o) for o in out] == [len(r) for r in ref] and all(out)
    # The port's positions never leave the cache and match their host mirror.
    assert np.array_equal(tb.positions.numpy(), tb._positions)
    assert tb._positions.max() < tb.S
    if traffic == "past_the_cache":  # the JAX batcher's retired slot climbed past S
        assert max(jpositions) > jb.S
    if traffic == "long_then_short":
        reused = [any(n < m for s2, m in admitted[:i] if s2 == s) for i, (s, n) in enumerate(admitted)]
        assert any(reused)
    if traffic == "repeats":
        assert tb.last_run_stats["prefix_hits"] >= 1
        assert out[0] == out[3] == out[6] == out[9] and out[1] == out[4] == out[7]


def test_identical_prompts_share_one_prefill():
    _, _, _, tmodel = _lm("f32")
    base = np.random.default_rng(2).integers(3, 512, 8).astype(np.int32)
    b = tserving.ContinuousBatcher(tmodel, num_slots=6)
    calls = []
    impl = b._prefill_impl
    b._prefill_impl = lambda *a: calls.append(a[1]) or impl(*a)
    out = b.run([tserving.Request(tokens=base.copy(), max_new_tokens=6) for _ in range(6)])
    assert all(o == out[0] for o in out)
    assert calls == [8]
    assert b.last_run_stats["prefills"] == 1 and b.last_run_stats["prefix_hits"] == 5


def test_shuffled_admission_changes_no_requests_tokens():
    tmodel = tlm.init_random_(tlm.DecoderLM(tlm.DecoderLMConfig.tiny(), device="cpu"),
                              torch.Generator().manual_seed(0)).requires_grad_(False)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 512, rng.integers(4, 12)).astype(np.int32) for _ in range(10)]
    a, _ = _batch(tmodel, prompts, 8, 4)
    order = list(range(10))[::-1]
    b, _ = _batch(tmodel, [prompts[i] for i in order], 8, 4)
    for i, oi in enumerate(order):
        assert a[oi] == b[i], (i, oi)


def test_a_reused_slot_sees_nothing_of_the_longer_request_before():
    """One slot, one batcher across runs (as the prompter keeps it): a short
    request after a long one gives the tokens and the logits of a fresh batcher."""
    tmodel = _lm("bf16")[3]
    rng = np.random.default_rng(6)
    long, short = rng.integers(3, 512, 40).astype(np.int32), rng.integers(3, 512, 5).astype(np.int32)
    used = tserving.ContinuousBatcher(tmodel, num_slots=1)
    used.run([tserving.Request(tokens=long, max_new_tokens=20)])
    assert used._positions[0] >= 45
    fresh = tserving.ContinuousBatcher(tmodel, num_slots=1)
    a = used.run([tserving.Request(tokens=short, max_new_tokens=10)])
    b = fresh.run([tserving.Request(tokens=short, max_new_tokens=10)])
    assert a == b
    assert torch.equal(used.cur_logits, fresh.cur_logits)


def test_per_request_max_new_tokens_and_the_decode_step_count():
    tmodel = _lm("f32")[3]
    prompts, maxes, slots = _traffic("throughput_mix")
    out, batcher = _batch(tmodel, prompts, maxes, slots)
    assert all(len(o) <= m for o, m in zip(out, maxes))
    static = sum(max(maxes[i:i + slots]) for i in range(0, len(maxes), slots))
    assert static / batcher.decode_steps > 1.5
    # Request i's k-th new token attends to its P_i + k cache positions.
    assert batcher.last_run_stats["kv_positions"] == sum(
        len(o) * len(p) + len(o) * (len(o) + 1) // 2 for o, p in zip(out, prompts))


def test_a_prompt_past_the_cache_capacity_raises():
    tmodel = _lm("f32")[3]
    long_prompt = np.arange(tmodel.cfg.max_seq_len + 10, dtype=np.int32) % 100 + 3
    with pytest.raises(DaftValueError, match="cache capacity"):
        _batch(tmodel, [long_prompt], 4, 2)


def test_sampling_is_repeatable_with_its_seed():
    tmodel = _lm("bf16")[3]
    prompts, maxes, _ = _traffic("long_then_short")

    def run(seed):
        return _batch(tmodel, prompts, maxes, 3, temperature=0.8, seed=seed)[0]

    a, b, c = run(7), run(7), run(8)
    assert a == b and a != c
    ids = [t for row in a + c for t in row]
    assert ids and min(ids) >= 0 and max(ids) < tmodel.cfg.vocab_size


# --------------------------------------------------------------------- #
# Provider and engine                                                   #
# --------------------------------------------------------------------- #
@pytest.fixture
def f32_tiny_lm(monkeypatch):
    """``model="tiny"`` names an f32 decoder LM in both packages for this test."""
    for cls, dt in ((jlm.DecoderLMConfig, jnp.float32), (tlm.DecoderLMConfig, torch.float32)):
        tiny = cls.tiny
        monkeypatch.setattr(cls, "tiny", staticmethod(
            lambda tiny=tiny, dt=dt: dataclasses.replace(tiny(), dtype=dt)))


def _texts(n: int, seed: int = 0) -> list:
    words = "cat dog bird fish tree car boat house river stone red blue green".split()
    rng = np.random.default_rng(seed)
    out = [" ".join(rng.choice(words, rng.integers(1, 50))) for _ in range(n)]
    out[3], out[7] = "", None
    out[10:13] = [out[2]] * 3  # repeats share one prefill
    return out


def _run(pkg, fn, values, **kw):
    df = pkg.from_pydict({"id": list(range(len(values))), "x": values})
    expr = fn(pkg.col("x"), **kw)
    with pkg.execution_config_ctx(default_morsel_size=16):
        return df.with_column("y", expr).select("id", "y").collect().to_pydict(), expr


@pytest.mark.parametrize("fn", ["prompt", "llm_generate"])
def test_prompt_equals_the_flax_prompter_on_shared_weights(tmp_path, f32_tiny_lm, fn):
    path = tmp_path / "lm.npz"
    np.savez(path, **_lm("f32")[2])
    texts = _texts(37)
    ref, _ = _run(daft_tpu, getattr(jai, fn), texts, provider="flax", model="tiny",
                  weights_path=str(path), max_new_tokens=8)
    out, expr = _run(daft_tpu_torch, getattr(tai, fn), texts, provider="cuda", model="tiny",
                     weights_path=str(path), max_new_tokens=8, device="cpu")
    assert out["id"] == ref["id"] == list(range(37))
    assert out["y"] == ref["y"]
    assert all(isinstance(r, str) and r for r in out["y"])
    inst = expr._expr.udf._get_instance()
    assert inst.model.cfg.dtype == torch.float32 and inst.prompt_len == 32
    # The last morsel: rows 32..36, of which none repeats another.
    stats = inst.last_forward_stats
    assert stats["prefills"] + stats["prefix_hits"] == 5 and stats["decode_steps"] >= 8
    assert set(stats) == {"tokenize_s", "prefills", "prefix_hits", "decode_steps",
                          "kv_positions", "prefill_s", "decode_s"}


@pytest.mark.parametrize("fn", ["prompt", "llm_generate"])
def test_prompt_through_the_engine_with_random_weights(fn):
    texts = [f"tell me about topic {i % 3}" for i in range(9)] + ["", None]
    out, expr = _run(daft_tpu_torch, getattr(tai, fn), texts, provider="cuda_random",
                     model="tiny", max_new_tokens=4, device="cpu")
    r = out["y"]
    assert len(r) == 11 and all(isinstance(x, str) and x for x in r)
    assert r[0] == r[3] == r[6] and r[1] == r[4] == r[7] and r[9] == r[10]
    assert all(1 <= int(t) < 512 for x in r for t in x.split()) and all(len(x.split()) <= 4 for x in r)
    inst = expr._expr.udf._get_instance()
    assert inst.last_forward_stats["prefix_hits"] >= 1
    assert inst.prompt(texts) == r  # the batcher is kept across calls


def test_prompter_descriptor_routes_like_the_jax_package():
    from daft_tpu.ai.provider import load_provider as jax_provider

    desc = cuda_provider.CUDAProvider().get_prompter(device="cpu")
    ref = jax_provider("flax_random").get_prompter()
    assert desc.protocol == desc.kind == "prompter"
    assert desc.model == ref.model == "default-lm"
    assert desc.get_dimensions() is None and ref.get_dimensions() is None
    assert desc.get_udf_options().batch_size == ref.get_udf_options().batch_size == 256
    inst = cuda_provider.CUDAProvider().get_prompter(
        "tiny", device="cpu", max_new_tokens=3, temperature=0.5, seed=4).instantiate()
    assert isinstance(inst, cuda_provider.CUDAPrompter)
    assert isinstance(inst, protocols.Prompter)
    assert (inst.max_new_tokens, inst.temperature) == (3, 0.5)
    with pytest.raises(DaftValueError, match="no prompter"):
        daft_tpu_torch.ai.provider.Provider().get_prompter()


def test_prompt_raises_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tai.prompt, tai.llm_generate):
        with pytest.raises(DaftValueError, match="device='cpu'"):
            fn(daft_tpu_torch.col("x"), model="tiny")
        fn(daft_tpu_torch.col("x"), model="tiny", device="cpu")
    with pytest.raises(DaftValueError, match="device='cpu'"):
        cuda_provider.CUDAPrompter("tiny")
