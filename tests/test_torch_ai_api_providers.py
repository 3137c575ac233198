"""The port's API-backed AI providers (``daft_tpu_torch/ai/api_providers.py``,
``ai/transport.py``) beside the JAX package's, on the CPU, with no network.

Mirrors ``tests/test_ai_api_providers.py`` case for case against the port:
canned JSON answers injected through the transport seam, the wire formats,
batching, the retries, ``dimensions`` and the engine's path. Beyond it:
each of ``openai`` / ``lm_studio`` / ``vllm`` / ``google`` × embedder /
prompter behind one responder in both packages (equal requests, outputs
equal bit for bit), one ``UrllibTransport`` round trip in each package
against a real ``http.server`` on 127.0.0.1 (a 429, then a 200), the
descriptor's pickling with a transport that does not pickle, and the
registry (``tests/test_ai.py::test_all_providers_registered``). Tolerance:
none; every comparison is exact.
"""

import http.server
import json
import pickle
import threading

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.ai.provider import load_provider as jax_load_provider
from daft_tpu.ai.transport import UrllibTransport as JaxUrllibTransport
from daft_tpu_torch import col
from daft_tpu_torch.ai.metrics import reset_token_metrics, token_metrics
from daft_tpu_torch.ai.provider import load_provider
from daft_tpu_torch.ai.transport import TransportError, UrllibTransport


@pytest.fixture(autouse=True)
def _cpu():
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        yield


class MockTransport:
    """Records requests; answers from a responder (or raises)."""

    def __init__(self, responder):
        self.responder = responder
        self.requests = []

    def post(self, url, body, headers=None, timeout=None):
        self.requests.append({"url": url, "body": json.loads(json.dumps(dict(body))),
                              "headers": dict(headers or {})})
        return self.responder(url, body)


def _openai_embed_responder(dims=4):
    def respond(url, body):
        assert url.endswith("/embeddings")
        inputs = body["input"]
        return {
            "object": "list",
            # reversed order: the embedder must reassemble by index
            "data": [{"index": i, "embedding": [float(i)] * dims}
                     for i in reversed(range(len(inputs)))],
            "usage": {"prompt_tokens": 3 * len(inputs)},
        }
    return respond


# -- tests/test_ai_api_providers.py, case for case ------------------------------
def test_openai_embed_wire_format_and_order():
    t = MockTransport(_openai_embed_responder())
    reset_token_metrics()
    emb = load_provider("openai", api_key="sk-test", transport=t) \
        .get_text_embedder("text-embedding-3-small").instantiate()
    out = emb.embed_text(["a", "b", "c"])
    assert out.shape == (3, 4)
    np.testing.assert_array_equal(out[:, 0], [0.0, 1.0, 2.0])  # index order
    req = t.requests[0]
    assert req["body"]["model"] == "text-embedding-3-small"
    assert req["body"]["input"] == ["a", "b", "c"]
    assert req["headers"]["Authorization"] == "Bearer sk-test"
    assert token_metrics()[("openai", "text-embedding-3-small")]["input_tokens"] == 9


def test_openai_embed_batches_requests():
    t = MockTransport(_openai_embed_responder())
    emb = load_provider("openai", api_key="k", transport=t, request_batch_size=2) \
        .get_text_embedder().instantiate()
    out = emb.embed_text([f"t{i}" for i in range(5)])
    assert out.shape == (5, 4)
    assert len(t.requests) == 3  # 2 + 2 + 1


def test_openai_dimensions_override_rules():
    p = load_provider("openai", api_key="k", transport=MockTransport(_openai_embed_responder()))
    d = p.get_text_embedder("text-embedding-3-large")
    assert d.get_dimensions() == 3072
    d2 = p.get_text_embedder("text-embedding-3-large", dimensions=256)
    assert d2.get_dimensions() == 256
    with pytest.raises(Exception, match="does not support overriding"):
        p.get_text_embedder("text-embedding-ada-002", dimensions=10).instantiate()


def test_openai_prompter_messages():
    def respond(url, body):
        assert url.endswith("/chat/completions")
        user = body["messages"][-1]["content"]
        return {"choices": [{"message": {"role": "assistant", "content": f"echo:{user}"}}],
                "usage": {"prompt_tokens": 5, "completion_tokens": 2}}

    t = MockTransport(respond)
    pr = load_provider("openai", api_key="k", transport=t) \
        .get_prompter("gpt-4o-mini", system_message="be brief", temperature=0.2).instantiate()
    out = pr.prompt(["hi", None, "yo"])
    assert out == ["echo:hi", "", "echo:yo"]
    assert t.requests[0]["body"]["messages"][0] == {"role": "system", "content": "be brief"}
    assert t.requests[0]["body"]["temperature"] == 0.2


def test_lm_studio_defaults_no_key():
    t = MockTransport(_openai_embed_responder())
    emb = load_provider("lm_studio", transport=t).get_text_embedder("m").instantiate()
    emb.embed_text(["x"])
    assert t.requests[0]["url"].startswith("http://localhost:1234/v1")
    assert "Authorization" not in t.requests[0]["headers"]


def test_vllm_endpoint_default():
    t = MockTransport(_openai_embed_responder())
    emb = load_provider("vllm", transport=t).get_text_embedder("m").instantiate()
    emb.embed_text(["x"])
    assert t.requests[0]["url"].startswith("http://localhost:8000/v1")


def test_google_embed_wire_format():
    def respond(url, body):
        assert ":batchEmbedContents" in url
        return {"embeddings": [{"values": [0.1, 0.2]} for _ in body["requests"]]}

    t = MockTransport(respond)
    emb = load_provider("google", api_key="g-key", transport=t) \
        .get_text_embedder("text-embedding-004").instantiate()
    out = emb.embed_text(["hello", "world"])
    assert out.shape == (2, 2)
    req = t.requests[0]
    assert req["headers"]["x-goog-api-key"] == "g-key"
    assert req["body"]["requests"][0]["content"]["parts"] == [{"text": "hello"}]
    assert load_provider("google").get_text_embedder().get_dimensions() == 768


def test_google_prompter():
    def respond(url, body):
        assert ":generateContent" in url
        txt = body["contents"][0]["parts"][0]["text"]
        return {"candidates": [{"content": {"parts": [{"text": txt.upper()}]}}],
                "usageMetadata": {"promptTokenCount": 4, "candidatesTokenCount": 1}}

    t = MockTransport(respond)
    pr = load_provider("google", api_key="k", transport=t) \
        .get_prompter("gemini-2.0-flash").instantiate()
    assert pr.prompt(["abc"]) == ["ABC"]


def test_missing_credentials_actionable(monkeypatch):
    for var in ("OPENAI_API_KEY", "GEMINI_API_KEY", "GOOGLE_API_KEY"):
        monkeypatch.delenv(var, raising=False)
    for name, match in (("openai", "OPENAI_API_KEY"), ("google", "GEMINI_API_KEY")):
        with pytest.raises(Exception, match=match):
            load_provider(name).get_text_embedder().instantiate()


def test_transport_retries_on_429(monkeypatch):
    """UrllibTransport retries retryable statuses with backoff, honours
    Retry-After, and succeeds when the server recovers."""
    import urllib.error

    calls = {"n": 0}

    class FakeResp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return json.dumps({"ok": True}).encode()

    def fake_urlopen(req, timeout=None):
        calls["n"] += 1
        if calls["n"] < 3:
            raise urllib.error.HTTPError(req.full_url, 429, "rate limited",
                                         {"Retry-After": "0"}, None)
        return FakeResp()

    sleeps = []
    monkeypatch.setattr("urllib.request.urlopen", fake_urlopen)
    monkeypatch.setattr("time.sleep", lambda s: sleeps.append(s))
    t = UrllibTransport(max_retries=5, backoff_base_s=0.01)
    assert t.post("http://x/v1/embeddings", {"a": 1}) == {"ok": True}
    assert calls["n"] == 3
    assert len(sleeps) == 2


def test_transport_gives_up_on_permanent_error(monkeypatch):
    import urllib.error

    def fake_urlopen(req, timeout=None):
        raise urllib.error.HTTPError(req.full_url, 401, "unauthorized", {}, None)

    monkeypatch.setattr("urllib.request.urlopen", fake_urlopen)
    t = UrllibTransport(max_retries=3)
    with pytest.raises(TransportError, match="401") as ei:
        t.post("http://x/v1/embeddings", {})
    assert ei.value.status == 401


def test_transport_exhausts_retries(monkeypatch):
    import urllib.error

    calls = {"n": 0}

    def fake_urlopen(req, timeout=None):
        calls["n"] += 1
        raise urllib.error.HTTPError(req.full_url, 503, "down", {}, None)

    monkeypatch.setattr("urllib.request.urlopen", fake_urlopen)
    monkeypatch.setattr("time.sleep", lambda s: None)
    t = UrllibTransport(max_retries=2)
    with pytest.raises(TransportError, match="503"):
        t.post("http://x/v1/embeddings", {})
    assert calls["n"] == 3  # the first attempt and 2 retries


def test_engine_embed_text_through_openai_mock():
    """``df.with_column(embed_text(provider=...))`` through the engine's UDF
    path with a mock transport."""
    from daft_tpu_torch.functions.ai import embed_text

    t = MockTransport(_openai_embed_responder(dims=8))
    provider = load_provider("openai", api_key="k", transport=t, dimensions=8)
    df = daft_tpu_torch.from_pydict({"s": [f"text {i}" for i in range(6)]})
    out = df.with_column("e", embed_text(col("s"), provider=provider,
                                         model="text-embedding-3-small")).to_pydict()
    assert len(out["e"]) == 6
    assert np.asarray(out["e"][0]).shape == (8,)


def test_engine_prompt_through_lm_studio_mock():
    from daft_tpu_torch.functions.ai import prompt as prompt_fn

    def respond(url, body):
        return {"choices": [{"message": {"content": "ok"}}]}

    provider = load_provider("lm_studio", transport=MockTransport(respond))
    df = daft_tpu_torch.from_pydict({"q": ["a", "b"]})
    out = df.with_column("r", prompt_fn(col("q"), provider=provider)).to_pydict()
    assert out["r"] == ["ok", "ok"]


# -- tests/test_ai.py::test_all_providers_registered ------------------------------
def test_all_providers_registered(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    for name in ("transformers", "openai", "google", "lm_studio", "vllm", "cuda"):
        assert load_provider(name).name == name
    assert load_provider("cuda_random").name == "cuda"
    # An API provider without credentials raises where it is instantiated
    # (in the worker), not where it is looked up (at plan time).
    desc = load_provider("openai").get_text_embedder()
    with pytest.raises(Exception, match="OPENAI_API_KEY"):
        desc.instantiate()


def test_a_provider_registered_first_keeps_its_name():
    from daft_tpu_torch.ai import provider as tprovider

    mine = tprovider.Provider()
    tprovider.register_provider("vllm", lambda **kw: mine)
    try:
        assert load_provider("vllm") is mine
        tprovider._ensure_builtins()
        assert load_provider("vllm") is mine
    finally:
        del tprovider._PROVIDERS["vllm"]
    assert load_provider("vllm").name == "vllm"


# -- both packages behind one responder ----------------------------------------------
def _vector(text: str, dims: int) -> list:
    rng = np.random.default_rng(sum(map(ord, text)) + 7 * len(text))
    return [float(v) for v in rng.standard_normal(dims).astype(np.float32)]


def _responder(url, body):
    """OpenAI and Gemini answers whose numbers depend on the inputs."""
    if url.endswith("/embeddings"):
        dims = body.get("dimensions", 6)
        return {"data": [{"index": i, "embedding": _vector(t, dims)}
                         for i, t in reversed(list(enumerate(body["input"])))],
                "usage": {"prompt_tokens": sum(len(t) for t in body["input"])}}
    if url.endswith("/chat/completions"):
        user = body["messages"][-1]["content"]
        return {"choices": [{"message": {"content": f"{user[::-1]}|{len(body['messages'])}"}}],
                "usage": {"prompt_tokens": len(user), "completion_tokens": 3}}
    if url.endswith(":batchEmbedContents"):
        return {"embeddings": [{"values": _vector(r["content"]["parts"][0]["text"],
                                                  r.get("outputDimensionality", 6))}
                               for r in body["requests"]]}
    assert url.endswith(":generateContent")
    txt = body["contents"][0]["parts"][0]["text"]
    return {"candidates": [{"content": {"parts": [{"text": txt.upper()}, {"text": "!"}]}}],
            "usageMetadata": {"promptTokenCount": len(txt), "candidatesTokenCount": 2}}


TEXTS = ["alpha", None, "", "über straße", "x" * 40, "the quick brown fox"]


@pytest.mark.parametrize("name", ["openai", "lm_studio", "vllm", "google"])
@pytest.mark.parametrize("kind", ["text_embedder", "prompter"])
def test_requests_and_outputs_equal_the_jax_packages(name, kind):
    options = {"api_key": "key-1", "base_url": "http://127.0.0.1:9/v9"}
    if kind == "text_embedder":
        options.update(dimensions=8, request_batch_size=4)
        model = "text-embedding-3-small" if name == "openai" else "embed-model"
    else:
        options.update(system_message="be brief", temperature=0.5, max_completion_tokens=7)
        model = "chat-model"
    outs, requests = [], []
    for load in (jax_load_provider, load_provider):
        t = MockTransport(_responder)
        provider = load(name, transport=t, **options)
        desc = getattr(provider, f"get_{kind}")(model)
        inst = desc.instantiate()
        outs.append(inst.embed_text(TEXTS) if kind == "text_embedder" else inst.prompt(TEXTS))
        requests.append(t.requests)
        assert desc.get_dimensions() == (8 if kind == "text_embedder" else None)
    # Embedders: batches of 4 (google's 100); prompters: one per non-null prompt.
    expect = {("text_embedder", True): 1, ("text_embedder", False): 2}.get(
        (kind, name == "google"), 5)
    assert requests[1] == requests[0] and len(requests[0]) == expect
    if kind == "text_embedder":
        assert outs[1].dtype == outs[0].dtype == np.float32
        assert outs[1].tobytes() == outs[0].tobytes()
    else:
        assert outs[1] == outs[0]


@pytest.mark.parametrize("name", ["openai", "lm_studio", "vllm", "google"])
def test_defaults_equal_the_jax_packages(name, monkeypatch):
    monkeypatch.setenv("OPENAI_API_KEY", "env-key")
    monkeypatch.setenv("GEMINI_API_KEY", "gem-key")
    seen = []
    for load in (jax_load_provider, load_provider):
        p = load(name)
        emb, pr = p.get_text_embedder(), p.get_prompter()
        t_emb, t_pr = emb.instantiate(), pr.instantiate()
        seen.append((emb.get_model(), pr.get_model(), emb.get_dimensions(),
                     emb.get_udf_options().batch_size, emb.get_udf_options().max_concurrency,
                     t_emb.url, t_emb.headers, t_pr.url, t_pr.headers,
                     type(t_emb.transport).__name__))
    assert seen[1] == seen[0]
    assert seen[1][3:5] == (128, 4)


def test_google_key_falls_back_to_google_api_key(monkeypatch):
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)
    monkeypatch.setenv("GOOGLE_API_KEY", "g2")
    emb = load_provider("google").get_text_embedder().instantiate()
    assert emb.headers == {"x-goog-api-key": "g2"}


def test_count_mismatch_raises_in_both_packages():
    def short(url, body):
        return {"data": [{"index": 0, "embedding": [1.0]}]}

    errors = []
    for load in (jax_load_provider, load_provider):
        emb = load("vllm", transport=MockTransport(short)).get_text_embedder("m").instantiate()
        with pytest.raises(Exception) as e:
            emb.embed_text(["a", "b"])
        errors.append((type(e.value).__name__, str(e.value)))
    assert errors[1] == errors[0] and errors[0][0] == "DaftValueError"


class _Unpicklable:
    def __init__(self):
        self.lock = threading.Lock()

    def post(self, url, body, headers=None, timeout=None):
        return _responder(url, body)


def test_descriptor_pickles_without_an_unpicklable_transport():
    t = _Unpicklable()
    desc = load_provider("lm_studio", transport=t, base_url="http://127.0.0.1:9/v1") \
        .get_text_embedder("m")
    copy = pickle.loads(pickle.dumps(desc))
    assert "transport" not in copy.get_options() and "transport" in desc.get_options()
    assert copy.get_options()["base_url"] == "http://127.0.0.1:9/v1"
    assert isinstance(copy.instantiate().transport, UrllibTransport)
    # A transport that pickles goes with the copy.
    m = MockTransport(_responder)
    kept = pickle.loads(pickle.dumps(load_provider("vllm", transport=m).get_text_embedder("m")))
    assert isinstance(kept.get_options()["transport"], MockTransport)
    # The JAX package drops the same options.
    jdesc = jax_load_provider("lm_studio", transport=t, base_url="http://127.0.0.1:9/v1") \
        .get_text_embedder("m")
    assert sorted(pickle.loads(pickle.dumps(jdesc)).get_options()) == \
        sorted(copy.get_options())


# -- one round trip over HTTP in each package ----------------------------------------
class _Server:
    """A server on 127.0.0.1 that answers the first ``fail`` POSTs with 429
    (``Retry-After: 0``) and the rest with the OpenAI embeddings answer."""

    def __init__(self, fail: int):
        self.fail = fail
        self.seen = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                outer.seen.append((self.path, body, self.headers.get("Authorization")))
                if len(outer.seen) <= outer.fail:
                    payload, status = b'{"error": "slow down"}', 429
                else:
                    payload, status = json.dumps(_responder(self.path, body)).encode(), 200
                self.send_response(status)
                if status == 429:
                    self.send_header("Retry-After", "0")
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def test_urllib_round_trip_retries_a_429_in_both_packages():
    outs, seen = [], []
    for transport, load in ((JaxUrllibTransport, jax_load_provider),
                            (UrllibTransport, load_provider)):
        server = _Server(fail=1)
        with server as base:
            emb = load("vllm", base_url=base, api_key="k",
                       transport=transport(max_retries=3, backoff_base_s=0.0)) \
                .get_text_embedder("m", dimensions=5).instantiate()
            outs.append(emb.embed_text(["a", "bc", None]))
        seen.append(server.seen)
    assert [len(s) for s in seen] == [2, 2]  # one 429, then the answer
    assert seen[1] == seen[0]
    assert seen[0][0] == ("/v1/embeddings", {"model": "m", "input": ["a", "bc", ""],
                                             "dimensions": 5}, "Bearer k")
    assert outs[1].tobytes() == outs[0].tobytes() and outs[1].shape == (3, 5)


def test_urllib_transport_raises_when_the_server_is_down():
    server = _Server(fail=0)
    with server as base:
        pass  # the server is shut down again at once
    t = UrllibTransport(max_retries=1, backoff_base_s=0.0, timeout_s=5)
    with pytest.raises(TransportError) as e:
        t.post(base + "/embeddings", {"model": "m", "input": ["a"]})
    assert e.value.status is None


def test_engine_raises_a_transport_error_after_its_retries():
    from daft_tpu_torch.functions.ai import embed_text

    server = _Server(fail=100)
    with server as base:
        provider = load_provider("vllm", base_url=base,
                                 transport=UrllibTransport(max_retries=2, backoff_base_s=0.0))
        df = daft_tpu_torch.from_pydict({"s": ["a", "b"]})
        with pytest.raises(Exception) as e:
            df.with_column("e", embed_text(col("s"), provider=provider, model="m")).collect()
    chain, err = [], e.value
    while err is not None:
        chain.append(err)
        err = err.__cause__
    assert any(isinstance(x, TransportError) and x.status == 429 for x in chain)
    assert len(server.seen) == 3
