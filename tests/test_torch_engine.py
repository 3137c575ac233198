"""The port's engine path against the JAX package's, on the CPU.

``from_pydict -> with_column(embed_image(...)) -> to_pydict`` runs through
``daft_tpu`` (provider ``flax``) and through ``daft_tpu_torch`` (provider
``cuda`` with ``device="cpu"``) on the same rows and the same tiny CLIP
weights, saved once as the JAX package's ``.npz`` layout. The embeddings are
computed in bf16 by both towers, so they agree within 3e-2 (the bf16
tolerance of tests/test_pallas.py); row order and count agree exactly.
"""

import json
import subprocess
import sys

import flax.serialization as fs
import flax.traverse_util as tu
import numpy as np
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.functions.ai import embed_image as jax_embed_image
from daft_tpu.models.clip import CLIPConfig as JaxCLIPConfig
from daft_tpu.models.clip import init_clip_params
from daft_tpu_torch.ai import cuda_provider
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.functions.ai import embed_image as torch_embed_image
from daft_tpu_torch.ops.flash_attention import flash_attention
from daft_tpu_torch.udf import Udf

BF16_TOL = 3e-2
ROWS = 45          # morsels of 16, 16, 13; device chunks of 4 (the last one 1 row)
MORSEL = 16
BATCH = 4


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory):
    _, params = init_clip_params(JaxCLIPConfig.tiny(), seed=0)
    flat = {k: np.asarray(v) for k, v in tu.flatten_dict(fs.to_state_dict(params), sep="/").items()}
    path = tmp_path_factory.mktemp("ckpt") / "tiny.npz"
    np.savez(path, **flat)
    return str(path)


def _images():
    return np.random.default_rng(0).integers(0, 256, (ROWS, 32 * 32 * 3), dtype=np.uint8)


def _embed(pkg, embed_image, path, **options):
    imgs = pkg.Series.from_numpy(_images(), "img", pkg.DataType.image("RGB", 32, 32))
    df = pkg.from_pydict({"id": list(range(ROWS)), "img": imgs})
    expr = embed_image(pkg.col("img"), model="tiny", weights_path=path, batch_size=BATCH,
                       **options)
    with pkg.execution_config_ctx(default_morsel_size=MORSEL):
        return df.with_column("emb", expr).select("id", "emb").to_pydict(), expr


def test_embed_image_matches_the_jax_package(tiny_npz):
    ref, _ = _embed(daft_tpu, jax_embed_image, tiny_npz, provider="flax",
                    staging_mode="overlap")
    before = flash_attention.launch_count
    out, expr = _embed(daft_tpu_torch, torch_embed_image, tiny_npz, provider="cuda",
                       device="cpu")
    assert flash_attention.launch_count == before  # CPU tensors take the plain version
    assert out["id"] == ref["id"] == list(range(ROWS))
    emb, ref_emb = np.asarray(out["emb"], np.float32), np.asarray(ref["emb"], np.float32)
    assert emb.shape == ref_emb.shape == (ROWS, 32)
    np.testing.assert_allclose(emb, ref_emb, atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
    stats = expr._expr.udf._get_instance().last_forward_stats
    # The last morsel: 13 rows in chunks of 4, 4, 4, 1.
    assert (stats["rows"], stats["chunks"], stats["mode"]) == (13, 4, "overlap")
    assert stats["stage_s"] >= 0 and stats["fwd_fetch_s"] >= 0


def _relational(pkg):
    df = pkg.from_pydict({"a": list(range(20)), "s": [f"r{i}" for i in range(20)],
                          "b": [i * 0.5 if i % 3 else None for i in range(20)]})
    with pkg.execution_config_ctx(default_morsel_size=4):
        out = (df.with_column("k", pkg.col("a").alias("ignored"))
               .with_column("seven", pkg.lit(7))
               .select("s", "k", "seven", pkg.col("b").alias("bb"))
               .limit(9, offset=3))
        return out.to_pydict(), out.column_names


def test_relational_round_trip_matches_the_jax_package():
    assert _relational(daft_tpu_torch) == _relational(daft_tpu)


@pytest.mark.parametrize("n,offset", [(0, 0), (5, 0), (50, 0), (4, 18), (3, 30)])
def test_limit_matches_the_jax_package(n, offset):
    def run(pkg):
        df = pkg.from_pydict({"a": list(range(20))})
        with pkg.execution_config_ctx(default_morsel_size=3):
            return df.limit(n, offset=offset).to_pydict()

    assert run(daft_tpu_torch) == run(daft_tpu)


def test_udf_project_remorsels_to_sixteen_device_batches():
    """The executor hands a UDF of batch size b morsels of min(16 * b,
    default_morsel_size) rows, whatever the input partitioning."""
    seen = []

    def double(s):
        seen.append(len(s))
        return np.asarray(s.to_pylist()) * 2

    udf = Udf(double, daft_tpu_torch.DataType.int64(), batch=True, batch_size=2)
    df = daft_tpu_torch.from_pydict({"a": list(range(50))})
    with daft_tpu_torch.execution_config_ctx(default_morsel_size=100):
        out = df.with_column("d", udf(daft_tpu_torch.col("a"))).to_pydict()
    assert seen == [32, 18]
    assert out["d"] == [2 * i for i in range(50)]
    seen.clear()
    with daft_tpu_torch.execution_config_ctx(default_morsel_size=10):
        df.with_column("d", udf(daft_tpu_torch.col("a"))).collect()
    assert seen == [10] * 5


def test_split_udfs_isolates_the_udf():
    from daft_tpu_torch.logical import plan as lp

    df = daft_tpu_torch.from_pydict({"a": [1, 2]})
    udf = Udf(lambda s: s, daft_tpu_torch.DataType.int64(), batch=True)
    plan = df.with_column("u", udf(daft_tpu_torch.col("a")))._builder.optimize().plan
    assert isinstance(plan, lp.Project)
    assert isinstance(plan.children()[0], lp.UDFProject)


def test_cuda_provider_raises_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DaftValueError, match="device='cpu'"):
        torch_embed_image(daft_tpu_torch.col("img"), model="tiny")
    with pytest.raises(DaftValueError, match="device='cpu'"):
        torch_embed_image(daft_tpu_torch.col("img"), provider="cuda_random", model="tiny")
    torch_embed_image(daft_tpu_torch.col("img"), model="tiny", device="cpu")


def test_entry_raises_without_a_gpu(monkeypatch):
    from daft_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DaftValueError):
        entry()


@pytest.mark.parametrize("n,bucket", [(1, 8), (8, 8), (9, 32), (100, 128), (1025, 2048)])
def test_bucket_ladder_matches_the_jax_package(n, bucket):
    from daft_tpu.ai.flax_provider import _bucket as jax_bucket

    assert cuda_provider._bucket(n) == jax_bucket(n) == bucket


def test_chunked_forward_pads_to_buckets_and_keeps_order():
    arr = np.arange(11, dtype=np.float32)[:, None]
    shapes = []

    def fwd(x):
        shapes.append(tuple(x.shape))
        return x * 2

    stats = {}
    out = cuda_provider._chunked_forward(fwd, arr, 4, 1, cuda_provider._Stager(torch.device("cpu")),
                                         stats_out=stats)
    np.testing.assert_array_equal(out, arr * 2)
    assert shapes == [(8, 1)] * 3  # chunks of 4, 4, 3, each padded to the bucket of 8
    assert stats["chunks"] == 3 and stats["rows"] == 11


def test_package_imports_no_jax_and_nothing_of_daft_tpu():
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import daft_tpu_torch, daft_tpu_torch.functions.ai, daft_tpu_torch.ai.cuda_provider\n"
        "import daft_tpu_torch.entry, daft_tpu_torch.models.clip, daft_tpu_torch.ops.build\n"
        "import daft_tpu_torch.models.minilm, daft_tpu_torch.utils.tokenizer\n"
        "import daft_tpu_torch.kernels.hashing, daft_tpu_torch.models.lm\n"
        "import daft_tpu_torch.models.serving, daft_tpu_torch.tools.lineitem\n"
        "import daft_tpu_torch.ops.device_eval, daft_tpu_torch.ops.compiled_eval\n"
        "import daft_tpu_torch.execution.executor, daft_tpu_torch.kernels.registry\n"
        "import daft_tpu_torch.io.file, daft_tpu_torch.kernels.image_ops\n"
        "import daft_tpu_torch.kernels.file_ops, daft_tpu_torch.functions.media\n"
        "import daft_tpu_torch.functions, daft_tpu_torch.models.resnet\n"
        "import daft_tpu_torch.execution.join_index, daft_tpu_torch.tools.tpch\n"
        "import daft_tpu_torch.logical.plan, daft_tpu_torch.logical.builder\n"
        "import daft_tpu_torch.logical.optimizer, daft_tpu_torch.physical.plan\n"
        "import daft_tpu_torch.physical.translate, daft_tpu_torch.dataframe.dataframe\n"
        "import daft_tpu_torch.udf, daft_tpu_torch.udf.udaf, daft_tpu_torch.io.media_sources\n"
        "import daft_tpu_torch.kernels.media_ops\n"
        "import daft_tpu_torch.metrics, daft_tpu_torch.profiling, daft_tpu_torch.tracing\n"
        "import daft_tpu_torch.subscribers.events, daft_tpu_torch.subscribers.event_log\n"
        "import daft_tpu_torch.execution.analyze, daft_tpu_torch.ai.metrics\n"
        "import daft_tpu_torch.utils.jsonl_sink\n"
        "import daft_tpu_torch.execution.admission, daft_tpu_torch.querylog, daft_tpu_torch.slo\n"
        "import daft_tpu_torch.query_service, daft_tpu_torch.distributed.flight\n"
        "import daft_tpu_torch.subscribers.dashboard, daft_tpu_torch.runners.native\n"
        "import daft_tpu_torch.io.sigv4, daft_tpu_torch.io.s3_client, daft_tpu_torch.io.gcs_auth\n"
        "import daft_tpu_torch.io.gcs_client, daft_tpu_torch.io.http_source\n"
        "import daft_tpu_torch.tools.object_stores, daft_tpu_torch.kernels.uri_ops\n"
        "daft_tpu_torch.kernels.registry.get_kernel('cosine_distance')\n"
        "daft_tpu_torch.kernels.registry.get_kernel('image_resize')\n"
        "new = set(sys.modules) - before\n"
        "print(json.dumps(sorted(m for m in new if m.split('.')[0] in\n"
        "                        ('jax', 'jaxlib', 'flax', 'optax', 'daft_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                         text=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("threads", [4, 0])
def test_shed_ladder_thread_cap_gives_the_uncapped_bytes(threads):
    """At shed level 2 the front door halves a newly admitted query's
    ``num_compute_threads``; the stage pool gives the same bytes at any
    count, so the capped run's Arrow table is the uncapped run's."""
    import time as _time

    from daft_tpu_torch import col
    from daft_tpu_torch.execution.admission import get_controller
    from daft_tpu_torch.subscribers.events import QueryAdmitted

    def query():
        rng = np.random.default_rng(5)
        df = daft_tpu_torch.from_pydict({"g": rng.integers(0, 30, 20_000),
                                         "v": rng.standard_normal(20_000)})
        return df.where(col("v") > -0.5).groupby("g").agg(col("v").sum().alias("s")).sort("g")

    admitted = []

    class Tap:
        def on_event(self, e):
            if isinstance(e, QueryAdmitted):
                admitted.append(e.compute_threads_cap)

    ctl = get_controller()
    ctx = daft_tpu_torch.get_context()
    tap = Tap()
    with daft_tpu_torch.execution_config_ctx(device="cpu", num_compute_threads=threads,
                                             result_cache_enabled=False,
                                             default_morsel_size=1024):
        plain = query().to_arrow()
        ctx.attach_subscriber(tap)
        with ctl._cond:
            ctl._shed_level = 2
            ctl._shed_changed_at = _time.monotonic() + 3600
            ctl._hist_read_at = _time.monotonic() + 3600
        try:
            capped = query().to_arrow()
        finally:
            ctx.detach_subscriber(tap)
            ctl.reset()
    assert admitted and admitted[-1] >= 1
    if threads:
        assert admitted[-1] == threads // 2
    assert capped.equals(plain)
