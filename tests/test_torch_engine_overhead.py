"""The engine-overhead watchdog of the port, on the CPU.

The mirror of ``tests/benchmarks/test_engine_overhead.py`` with the
``cuda_random`` provider on ``device="cpu"``: the same tiny CLIP forward run
(a) standalone through ``CUDACLIPImageEmbedder.embed_image`` and (b) through
``read -> UDFProject(embed_image) -> collect`` at a matched batch, with
``default_morsel_size = N``. The engine may cost at most 15 % over the bare
forward. Standalone and engine runs alternate in ABBA blocks in one process;
the verdict is the median of the per-block ratios, a failing verdict
escalates once to 9 blocks, and a confirmed failure re-runs the engine side
under the profiler and fails with ``gap_breakdown``'s per-operator
attribution. ``gap_breakdown`` gives the JAX package's text, character for
character, over one stub profile.

Two settings keep the two sides comparable on a CPU that other processes
share (``daft_tpu_torch/tools/cpu_watchdog.py`` measures both):

* The engine evaluates the serial UDF on the thread that pulls it, a stage's
  feeder made for the query, so the standalone forward runs on a thread made
  for the call too. PyTorch runs its intra-op work on OpenMP teams, one per
  calling thread, and libgomp throttles every team's spinning while their
  workers outnumber the CPUs: a standalone side on the main thread would
  keep its team alive through the engine's runs and slow only those.
* Both sides run with ``INTRA_OP_THREADS`` intra-op threads. With one per
  CPU, a worker that another process preempts stalls each of the forward's
  barriers, and the same forward's wall spreads several-fold from run to
  run; the engine's own work outside the forward is a few milliseconds
  either way.

``test_serial_udf_is_attributed_to_its_operator`` holds the profiler's
attribution of the UDF's inline evaluation.
"""

from __future__ import annotations

import statistics
import threading
import time

import numpy as np
import pytest
import torch

import daft_tpu_torch
from daft_tpu.perf_report import gap_breakdown as jax_gap_breakdown
from daft_tpu_torch import col
from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.functions.ai import embed_image
from daft_tpu_torch.perf_report import gap_breakdown

#: Engine wall / standalone wall must stay under this.
OVERHEAD_LIMIT = 1.15
#: Corpus size: 24 chunks at B=512, 12 at B=1024 (tiny CLIP, 32x32 images).
N = 12288
MODEL = "tiny"
BLOCKS = 3
ESCALATED_BLOCKS = 9
#: PyTorch's intra-op threads on both sides while the ratio is measured.
INTRA_OP_THREADS = 2


@pytest.fixture
def intra_op_threads():
    """torch's intra-op threads at ``INTRA_OP_THREADS`` for the test; threads
    made meanwhile take the setting, and the caller's is restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(INTRA_OP_THREADS)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, (N, 32, 32, 3), dtype=np.uint8)


def _engine_frame(imgs):
    series = daft_tpu_torch.Series.from_numpy(
        imgs.reshape(N, -1), "img", DataType.image("RGB", 32, 32))
    return daft_tpu_torch.from_pydict({"img": series})


def _expr(batch: int):
    return embed_image(col("img"), provider="cuda_random", model=MODEL, batch_size=batch,
                       device="cpu")


def _measure_pairs(imgs, batch: int, blocks: int) -> tuple:
    """(ratios, standalone_s, engine_s): per-ABBA-block engine/standalone
    wall ratios plus the median wall of each side."""
    from daft_tpu_torch.ai.cuda_provider import CUDACLIPImageEmbedder

    emb = CUDACLIPImageEmbedder(MODEL, batch_size=batch, device="cpu")
    df = _engine_frame(imgs)
    expr = _expr(batch)

    def on_fresh_thread(fn):
        out = []
        t = threading.Thread(target=lambda: out.append(fn()))
        t.start()
        t.join()
        assert out, "the forward raised on its thread"
        return out[0]

    def standalone_once() -> float:
        def forward() -> float:
            t0 = time.perf_counter()
            out = emb.embed_image(imgs)
            wall = time.perf_counter() - t0
            assert out.shape[0] == N
            return wall
        return on_fresh_thread(forward)

    def engine_once() -> float:
        with daft_tpu_torch.execution_config_ctx(default_morsel_size=N):
            t0 = time.perf_counter()
            q = df.with_column("emb", expr).select("emb")
            q.collect()
            wall = time.perf_counter() - t0
        assert len(q.to_pydict()["emb"]) == N
        return wall

    # Warm both sides (the instance, the first chunk's shapes) before
    # anything is timed.
    on_fresh_thread(lambda: emb.embed_image(imgs[:batch]))
    engine_once()

    ratios, st_walls, en_walls = [], [], []
    for b in range(blocks):
        order = (standalone_once, engine_once) if b % 2 == 0 else \
            (engine_once, standalone_once)
        ts = [fn() for fn in order]
        st, en = (ts if b % 2 == 0 else (ts[1], ts[0]))
        st_walls.append(st)
        en_walls.append(en)
        ratios.append(en / st)
    return ratios, statistics.median(st_walls), statistics.median(en_walls)


def _profiled_breakdown(imgs, batch: int, standalone_s: float, engine_s: float) -> str:
    """One profiled engine pass -> per-operator gap attribution."""
    df = _engine_frame(imgs)
    with daft_tpu_torch.execution_config_ctx(default_morsel_size=N):
        q = df.with_column("emb", _expr(batch)).select("emb")
        q.collect(profile=True)
    return gap_breakdown(q.query_profile, standalone_s, engine_s)


@pytest.mark.parametrize("batch", [512, 1024])
def test_engine_overhead_within_budget(corpus, batch, intra_op_threads):
    ratios, st, en = _measure_pairs(corpus, batch, BLOCKS)
    verdict = statistics.median(ratios)
    if verdict >= OVERHEAD_LIMIT:
        # Escalate once: noise rarely survives 3x the paired sample, a real
        # engine tax does.
        ratios, st, en = _measure_pairs(corpus, batch, ESCALATED_BLOCKS)
        verdict = statistics.median(ratios)
    if verdict >= OVERHEAD_LIMIT:
        breakdown = _profiled_breakdown(corpus, batch, st, en)
        pytest.fail(
            f"engine path costs x{verdict:.3f} over the standalone forward "
            f"at B={batch} (budget x{OVERHEAD_LIMIT}); attribution:\n"
            f"{breakdown}")
    print(f"B={batch}: engine x{verdict:.3f} standalone "
          f"({N / en:.0f} vs {N / st:.0f} img/s)")


def test_gap_breakdown_names_operators(corpus):
    """The failure path's attribution names the engine's operators with
    their self-times."""
    df = _engine_frame(corpus)
    with daft_tpu_torch.execution_config_ctx(default_morsel_size=N):
        q = df.with_column("emb", _expr(512)).select("emb")
        q.collect(profile=True)
    text = gap_breakdown(q.query_profile, 0.10, 0.15)
    assert "UDFProject" in text
    assert "gap +0.050s" in text
    assert "<unattributed (plan/dispatch)>" in text


@pytest.mark.parametrize("max_concurrency", [None, 2], ids=["serial", "pool"])
def test_serial_udf_is_attributed_to_its_operator(max_concurrency):
    """A UDF's CPU time and the device rows it notes land on its
    UDFProject's row of the profile, evaluated inline (serial) or on the
    UDF's pool."""
    from daft_tpu_torch import profiling
    from daft_tpu_torch.udf import Udf

    burn_s = 0.05

    def burn(x):
        c0 = time.thread_time()
        while time.thread_time() - c0 < burn_s:
            pass
        profiling.note_device(len(x), True)
        return x

    rows, morsel = 64, 16
    udf = Udf(burn, DataType.int64(), batch=True, max_concurrency=max_concurrency)
    df = daft_tpu_torch.from_pydict({"x": np.arange(rows, dtype=np.int64)})
    with daft_tpu_torch.execution_config_ctx(default_morsel_size=morsel,
                                             udf_dynamic_batching=False):
        q = df.with_column("y", udf(col("x"))).select("y")
        q.collect(profile=True)
    assert q.to_pydict()["y"] == list(range(rows))
    table = q.query_profile.operator_table(by="plan_node")
    (row,) = [r for r in table if r["operator"] == "UDFProject"]
    assert row["device_rows"] == rows
    if profiling.cpu_sampling_enabled():
        # Four morsels of at least burn_s CPU each, less a tenth for the
        # clocks' granularity.
        assert row["self_cpu_ns"] >= 0.9 * (rows // morsel) * burn_s * 1e9
    assert sum(r["device_rows"] for r in table) == rows


class _StubProfile:
    """A profile whose per-plan-node table is fixed."""

    ROWS = [
        {"operator": "UDFProject", "plan_node": "UDFProject#1", "self_wall_ns": 61_234_567,
         "self_cpu_ns": 12_345_678, "rows": 12288, "morsels": 2},
        {"operator": "InMemorySource", "plan_node": "InMemorySource#0",
         "self_wall_ns": 1_500_000, "self_cpu_ns": 1_499_999, "rows": 12288, "morsels": 1},
        {"operator": "Project", "self_wall_ns": 250, "self_cpu_ns": 0, "rows": 7, "morsels": 123456},
    ]

    def operator_table(self, by: str = "operator"):
        assert by == "plan_node"
        return [dict(r) for r in self.ROWS]


@pytest.mark.parametrize("profile", [_StubProfile(), None], ids=["stub", "none"])
@pytest.mark.parametrize("walls", [(0.10, 0.15), (0.5, 0.25), (1.0, 1.0)],
                         ids=["slower", "faster", "equal"])
def test_gap_breakdown_is_the_jax_package_text(profile, walls):
    assert gap_breakdown(profile, *walls) == jax_gap_breakdown(profile, *walls)
