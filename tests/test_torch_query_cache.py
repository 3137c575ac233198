"""The plan cache, the result / scan cache and write invalidation in the
port (``daft_tpu_torch/plancache.py``, ``runners/``) beside the JAX
package's, on the CPU with ``device="cpu"``.

Mirrors ``tests/test_query_cache.py`` case for case: the plan cache's hit
(the optimizer does not run) and its config digest, identity-keyed
in-memory frames, a result-cache repeat (the same bytes), nondeterministic
plans, a partial iteration and a cancelled query (no entry, no bytes, no
claim), the single-flight stampede, write invalidation at 1 and 4 threads,
a stale source without a hook, the scan tier across two queries, the
pinned-bytes bound, the ``#dup`` claim, tenant-fair eviction, EXPLAIN
ANALYZE's cache lines, the shared fingerprint and path overlap on segment
boundaries. Rows are exact. Beyond the JAX file: the two packages decide
alike, with the same note, whether each of about 20 queries is
plan-cacheable and result-cacheable; a hit gives the miss's bytes in the
same order; a UDF plan hits the plan cache and never the result cache;
with both caches off the routes and the morsels are those of a miss.

The front door's cases (the admission charge of the cached bytes, the HTTP
and Flight submit paths, the query-log schema and a live record) run on the
port's dashboard server, Flight server and recorder. The case that waits:
the worker death mid-build
(``test_worker_death_mid_build_does_not_poison_entry``), ROADMAP A.8.5.
"""

import json
import os
import tempfile
import threading
import urllib.error
import urllib.request

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import plancache as jpc
from daft_tpu_torch import col, metrics, plancache
from daft_tpu_torch.context import execution_config_ctx, get_context
from daft_tpu_torch.execution.admission import get_controller, set_tenant
from torch_isolation import admission_windows_reset  # noqa: F401

pytestmark = pytest.mark.usefixtures("admission_windows_reset")


@pytest.fixture(autouse=True)
def fresh_caches():
    plancache.reset_caches()
    get_controller().reset()
    set_tenant(None)
    with execution_config_ctx(device="cpu"):
        yield
    plancache.reset_caches()
    get_controller().reset()
    set_tenant(None)


def make_df(n=2000, seed=0, pkg=daft_tpu_torch):
    import random

    rng = random.Random(seed)
    return pkg.from_pydict({
        "k": [rng.randrange(50) for _ in range(n)],
        "v": [float(rng.randrange(1000)) for _ in range(n)],
    })


def agg_query(df, c=col):
    return (df.where(c("k") < 40)
            .with_column("w", c("v") * 2)
            .groupby("k").agg(c("w").sum().alias("s"))
            .sort("k"))


def _counter(c):
    return c._default_child().value()


# --------------------------------------------------------------------- #
# Plan cache                                                              #
# --------------------------------------------------------------------- #
def test_plan_cache_hit_skips_optimize():
    """The second arrival of a shape is served by the plan cache: the
    optimizer never runs and the hit counter moves."""
    from daft_tpu_torch.logical.optimizer import Optimizer

    df = make_df()
    calls = {"n": 0}
    orig = Optimizer.optimize

    def counting(self, plan):
        calls["n"] += 1
        return orig(self, plan)

    with execution_config_ctx(result_cache_enabled=False):
        Optimizer.optimize = counting
        try:
            r1 = agg_query(df).to_pydict()
            n_after_first = calls["n"]
            h0 = _counter(metrics.PLAN_CACHE_HITS)
            r2 = agg_query(df).to_pydict()
            assert calls["n"] == n_after_first, "optimizer ran on a repeat"
        finally:
            Optimizer.optimize = orig
    assert r1 == r2
    assert _counter(metrics.PLAN_CACHE_HITS) == h0 + 1
    jdf = make_df(pkg=daft_tpu)
    with daft_tpu.execution_config_ctx(result_cache_enabled=False):
        assert agg_query(jdf, daft_tpu.col).to_pydict() == r1


def test_plan_cache_key_includes_config_digest():
    """A per-query override of a planning-relevant knob keys a different
    plan-cache entry; a runtime-only knob does not."""
    df = make_df()
    with execution_config_ctx(result_cache_enabled=False):
        agg_query(df).collect()
        m0 = _counter(metrics.PLAN_CACHE_MISSES)
        with execution_config_ctx(default_morsel_size=4096):
            agg_query(df).collect()
        assert _counter(metrics.PLAN_CACHE_MISSES) == m0 + 1
        h0 = _counter(metrics.PLAN_CACHE_HITS)
        with execution_config_ctx(num_compute_threads=1):
            agg_query(df).collect()
        assert _counter(metrics.PLAN_CACHE_HITS) == h0 + 1


def test_distinct_in_memory_frames_never_collide():
    a = daft_tpu_torch.from_pydict({"x": [1.0, 2.0]})
    b = daft_tpu_torch.from_pydict({"x": [3.0, 4.0]})
    ra = a.agg(col("x").sum().alias("s")).to_pydict()
    rb = b.agg(col("x").sum().alias("s")).to_pydict()
    assert ra["s"][0] == 3.0 and rb["s"][0] == 7.0


# --------------------------------------------------------------------- #
# Result cache                                                            #
# --------------------------------------------------------------------- #
def test_result_cache_repeat_byte_identical():
    df = make_df()
    r1 = agg_query(df).to_pydict()
    h0 = _counter(metrics.RESULT_CACHE_HIT_BYTES)
    r2 = agg_query(df).to_pydict()
    assert _counter(metrics.RESULT_CACHE_HIT_BYTES) > h0
    assert r1 == r2


def test_result_cache_hit_gives_the_miss_bytes_in_order():
    """A hit streams the partitions the miss yielded: the same Arrow bytes
    in the same order, partition for partition."""
    df = make_df(20_000, seed=4)
    with execution_config_ctx(default_morsel_size=3000):
        q1 = df.where(col("k") < 45).with_column("w", col("v") * 3)
        miss = list(q1.iter_partitions())
        h0 = _counter(metrics.RESULT_CACHE_HIT_BYTES)
        hit = list(df.where(col("k") < 45).with_column("w", col("v") * 3).iter_partitions())
        assert _counter(metrics.RESULT_CACHE_HIT_BYTES) > h0
    assert len(miss) == len(hit) > 1
    for a, b in zip(miss, hit):
        assert a.to_arrow_table().equals(b.to_arrow_table())


def test_nondeterministic_plans_never_result_cached():
    df = make_df(100)
    q = df.with_column("t", daft_tpu_torch.sql_expr("CURRENT_TIMESTAMP")).select(col("t"))
    key = plancache.compute_query_key(q._builder.plan, get_context().execution_config)
    assert not key.result_cacheable
    assert "now" in key.reason
    key2 = plancache.compute_query_key(df.sample(fraction=0.5)._builder.plan,
                                       get_context().execution_config)
    assert not key2.result_cacheable
    key3 = plancache.compute_query_key(df.sample(fraction=0.5, seed=7)._builder.plan,
                                       get_context().execution_config)
    assert key3.result_cacheable


def test_partial_iteration_never_caches():
    df = make_df()
    it = iter(agg_query(df).iter_partitions())
    next(it)
    it.close()  # GeneratorExit mid-stream
    h0 = _counter(metrics.RESULT_CACHE_HIT_BYTES)
    full = agg_query(df).to_pydict()
    assert _counter(metrics.RESULT_CACHE_HIT_BYTES) == h0
    assert len(full["k"]) == 40
    assert plancache.get_result_cache().stats()["building"] == 0


def test_cancelled_query_leaves_no_entry_or_bytes():
    from daft_tpu_torch.errors import DaftCancelledError, DaftTimeoutError

    df = make_df(60_000, seed=3)
    with pytest.raises((DaftTimeoutError, DaftCancelledError)):
        agg_query(df).collect(timeout=0.000001)
    st = plancache.get_result_cache().stats()
    assert st["building"] == 0
    assert st["bytes"] == 0 and st["entries"] == 0
    assert st["tenant_bytes"] == {}


def test_concurrent_same_fingerprint_builds_once():
    df = make_df(20_000, seed=1)
    expected = agg_query(df).to_pydict()
    plancache.reset_caches()
    m0 = metrics.RESULT_CACHE_MISSES.labels("result").value()
    results = [None] * 8
    errors = []
    cfg = get_context().execution_config

    def run(i):
        try:
            with execution_config_ctx(**{"device": cfg.device}):
                results[i] = agg_query(df).to_pydict()
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert all(r == expected for r in results)
    misses = metrics.RESULT_CACHE_MISSES.labels("result").value() - m0
    assert misses == 1, f"expected 1 build, got {misses}"


@pytest.mark.parametrize("threads", [1, 4])
def test_invalidation_on_write_1_and_4_threads(threads, tmp_path):
    """After a write through the writers to a cached source, the next read
    re-executes and equals an uncached run, at 1 and 4 compute threads, as
    the JAX package's does."""
    out = []
    for pkg in (daft_tpu, daft_tpu_torch):
        d = str(tmp_path / pkg.__name__)
        extra = {"device": "cpu"} if pkg is daft_tpu_torch else {}
        c = pkg.col
        with pkg.execution_config_ctx(num_compute_threads=threads, **extra):
            pkg.from_pydict({"a": list(range(100)),
                             "b": [float(i) for i in range(100)]}).write_parquet(d)

            def q():
                return pkg.read_parquet(d).where(c("a") < 50).agg(c("b").sum().alias("s"))

            r1 = q().to_pydict()
            assert q().to_pydict() == r1  # cached repeat
            pkg.from_pydict({"a": [1] * 5, "b": [100.0] * 5}).write_parquet(d)
            r2 = q().to_pydict()
            with pkg.execution_config_ctx(result_cache_enabled=False, plan_cache_enabled=False):
                cold = q().to_pydict()
            assert r2 == cold, (threads, r2, cold)
            assert r2["s"][0] == r1["s"][0] + 500.0
            out.append((r1, r2))
    assert out[0] == out[1]


def test_stale_source_never_serves_without_hook():
    d = tempfile.mkdtemp()
    daft_tpu_torch.from_pydict({"a": [1.0, 2.0]}).write_parquet(d)

    def q():
        return daft_tpu_torch.read_parquet(d).agg(col("a").sum().alias("s"))

    assert q().to_pydict()["s"][0] == 3.0
    f = [os.path.join(d, p) for p in os.listdir(d)][0]
    st = os.stat(f)
    os.utime(f, ns=(st.st_atime_ns, st.st_mtime_ns + 10_000_000))
    h0 = _counter(metrics.RESULT_CACHE_HIT_BYTES)
    assert q().to_pydict()["s"][0] == 3.0  # re-executed, still correct
    assert _counter(metrics.RESULT_CACHE_HIT_BYTES) == h0


@pytest.mark.parametrize("where", ["root", "partition"])
def test_file_added_by_another_process_never_serves_stale(where, tmp_path):
    """A file that another process adds to a scanned directory, with no
    write hook, makes the plan-cache and result-cache entries stale: the
    next query misses both and reads the new file. ``partition`` adds it
    to an existing hive partition's directory, below the scan's root.
    Rows are exact."""
    import subprocess
    import sys

    d = str(tmp_path / "t")
    daft_tpu_torch.from_pydict({"p": [1, 1, 2], "a": [1.0, 2.0, 3.0]}).write_parquet(
        d, partition_cols=["p"] if where == "partition" else None)

    def q():
        return daft_tpu_torch.read_parquet(d).agg(col("a").sum().alias("s"))

    assert q().to_pydict()["s"][0] == 6.0
    hits = _counter(metrics.RESULT_CACHE_HIT_BYTES)
    assert q().to_pydict()["s"][0] == 6.0
    assert _counter(metrics.RESULT_CACHE_HIT_BYTES) > hits  # served from the cache
    target = d
    if where == "partition":
        target = os.path.join(d, sorted(n for n in os.listdir(d) if n.startswith("p="))[0])
    code = ("import sys, pyarrow as pa, pyarrow.parquet as pq; "
            "cols = {'a': pa.array([100.0])} if sys.argv[2] == 'partition' else "
            "{'p': pa.array([3]), 'a': pa.array([100.0])}; "
            "pq.write_table(pa.table(cols), sys.argv[1] + '/added.parquet')")
    subprocess.run([sys.executable, "-c", code, target, where], check=True, timeout=120)
    misses = _counter(metrics.PLAN_CACHE_MISSES)
    hits = _counter(metrics.RESULT_CACHE_HIT_BYTES)
    assert q().to_pydict()["s"][0] == 106.0
    assert _counter(metrics.RESULT_CACHE_HIT_BYTES) == hits
    assert _counter(metrics.PLAN_CACHE_MISSES) == misses + 1
    with execution_config_ctx(result_cache_enabled=False, plan_cache_enabled=False):
        assert q().to_pydict() == {"s": [106.0]}


def test_scan_cache_serves_across_different_queries():
    d = tempfile.mkdtemp()
    daft_tpu_torch.from_pydict({"a": list(range(1000)),
                                "b": [float(i) for i in range(1000)]}).write_parquet(d)
    s0 = metrics.RESULT_CACHE_HITS.labels("scan").value()
    r1 = (daft_tpu_torch.read_parquet(d).where(col("a") < 500)
          .agg(col("b").sum().alias("s")).to_pydict())
    r2 = (daft_tpu_torch.read_parquet(d).where(col("a") < 500)
          .agg(col("b").mean().alias("m")).to_pydict())
    assert metrics.RESULT_CACHE_HITS.labels("scan").value() == s0 + 1
    assert r1["s"][0] == 124750.0 and r2["m"][0] == 249.5


@pytest.mark.parametrize("morsel", [64, 1000])
def test_scan_hit_yields_the_fresh_morsels(morsel, tmp_path):
    """The scan tier's key holds the morsel size: a hit yields the fresh
    stream's morsels at the same boundaries and bytes."""
    d = str(tmp_path)
    daft_tpu_torch.from_pydict({"a": list(range(1000)),
                                "b": [float(i) for i in range(1000)]}).write_parquet(d)
    with execution_config_ctx(default_morsel_size=morsel, result_cache_enabled=True):
        with execution_config_ctx(result_cache_scan_outputs=False):
            cold = list(daft_tpu_torch.read_parquet(d).iter_partitions())
        s0 = metrics.RESULT_CACHE_HITS.labels("scan").value()
        first = list(daft_tpu_torch.read_parquet(d).where(col("a") >= 0).iter_partitions())
        second = list(daft_tpu_torch.read_parquet(d).where(col("a") >= 0)
                      .with_column("c", col("b") * 2.0).iter_partitions())
        assert metrics.RESULT_CACHE_HITS.labels("scan").value() == s0 + 1
    assert [len(p) for p in cold] == [len(p) for p in first] == [len(p) for p in second]
    assert len(cold) == -(-1000 // morsel)
    for a, b, c in zip(cold, first, second):
        assert a.to_arrow_table().equals(b.to_arrow_table())
        assert c.to_arrow_table().select(["a", "b"]).equals(b.to_arrow_table())


def test_plan_cache_pinned_bytes_bounded():
    from daft_tpu_torch.plancache import PlanCache, QueryKey

    plan = daft_tpu_torch.from_pydict({"x": [1.0]})._builder.plan
    pc = PlanCache(size=100, max_pinned_bytes=10_000)

    def put(fp, pinned):
        pc.put(QueryKey(fp=fp, text="", roots=[], result_cacheable=True,
                        pinned_bytes=pinned), plan, plan, "r")

    for fp in ("a", "b", "c"):
        put(fp, 4_000)
    st = pc.stats()
    assert st["pinned_bytes"] <= 10_000 and st["entries"] == 2, st
    put("huge", 50_000)
    st = pc.stats()
    assert st["entries"] == 2 and st["pinned_bytes"] <= 10_000, st


def test_dup_build_does_not_release_original_claim():
    cache = plancache.ResultCache(max_bytes=1_000, max_entry_bytes=500)
    o1, h1 = cache.lookup_or_claim("k", "result", "t")
    assert o1 == "build"
    o2, h2 = cache.lookup_or_claim("k", "result", "t", wait_s=0.0)
    assert o2 == "build" and h2.key.endswith("#dup")
    h2.abort()
    assert cache.stats()["building"] == 1, "dup abort released the claim"
    h1.abort()
    assert cache.stats()["building"] == 0


# --------------------------------------------------------------------- #
# Tenant-fair eviction                                                    #
# --------------------------------------------------------------------- #
class _FakeMP:
    def __init__(self, n):
        self.n = n

    def size_bytes(self):
        return self.n

    def __len__(self):
        return 1


def test_tenant_fair_eviction():
    stats = []
    for mod in (jpc, plancache):
        cache = mod.ResultCache(max_bytes=10_000, max_entry_bytes=5_000)

        def insert(key, tenant, nbytes):
            outcome, h = cache.lookup_or_claim(key, "result", tenant)
            assert outcome == "build"
            h.add(_FakeMP(nbytes))
            return h.commit()

        assert insert("v1", "victim", 2_000)
        assert insert("v2", "victim", 2_000)
        for i in range(12):
            insert(f"h{i}", "hostile", 2_500)
        st = cache.stats()
        assert st["tenant_bytes"].get("victim", 0) == 4_000, st
        assert st["tenant_bytes"].get("hostile", 0) <= 5_000, st
        assert cache.get("v1") is not None
        assert cache.get("v2") is not None
        stats.append(st)
    assert stats[0] == stats[1]


def test_shrink_tenant_reclaims_cached_bytes():
    """The cache's half of the admission charge: a tenant's committed bytes
    are accounted to it and ``shrink_tenant`` gives them back to zero."""
    df = make_df(5_000, seed=5)
    set_tenant("acme")
    try:
        agg_query(df).collect()
    finally:
        set_tenant(None)
    held = plancache.get_result_cache().stats()["tenant_bytes"]["acme"]
    assert held > 0
    assert plancache.get_result_cache().shrink_tenant("acme", held) >= held
    assert "acme" not in plancache.get_result_cache().stats()["tenant_bytes"]


def test_cache_bytes_charged_to_admission_and_reclaimed():
    """Committed bytes land on the tenant's admission ledger; a shrink
    reclaims them and the ledger returns to zero."""
    df = make_df(5_000, seed=5)
    set_tenant("acme")
    try:
        agg_query(df).collect()
    finally:
        set_tenant(None)
    ctl = get_controller()
    snap = ctl.snapshot()["acme"]
    assert snap["cache_bytes"] > 0
    assert snap["cache_bytes"] == plancache.get_result_cache().stats()["tenant_bytes"]["acme"]
    freed = plancache.get_result_cache().shrink_tenant("acme", snap["cache_bytes"])
    assert freed >= snap["cache_bytes"]
    assert ctl.snapshot()["acme"]["cache_bytes"] == 0


def test_admission_reclaims_cached_bytes_a_live_query_needs():
    """Under a memory limit a tenant's cached results over its quota yield
    to its next live query: the admission evicts them (``tenant-quota``)."""
    from daft_tpu_torch.execution.resource_manager import memory_limit

    df = make_df(5_000, seed=6)
    daft_tpu_torch.set_tenant_policy("tight", max_memory_fraction=0.5)
    with memory_limit(1 << 20):
        set_tenant("tight")
        try:
            agg_query(df).collect()
            cached = get_controller().snapshot()["tight"]["cache_bytes"]
            assert cached > 0
            ticket = get_controller().admit("live", tenant="tight")
            try:
                # One share (limit/4) reserved; quota limit/2: the cache keeps
                # at most the rest.
                snap = get_controller().snapshot()["tight"]
                assert snap["mem_reserved"] + snap["cache_bytes"] <= (1 << 19)
            finally:
                ticket.release()
        finally:
            set_tenant(None)


# --------------------------------------------------------------------- #
# The front door (HTTP and Flight)                                        #
# --------------------------------------------------------------------- #
def _post(url, body, timeout=60):
    req = urllib.request.Request(f"{url}/api/query", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


@pytest.fixture()
def front_door():
    from daft_tpu_torch.query_service import get_table_registry
    from daft_tpu_torch.subscribers.dashboard import DashboardServer

    dash = DashboardServer(port=0).start()
    sub = dash.subscriber()
    get_context().attach_subscriber(sub)
    try:
        dash.register_table("t", make_df(3_000, seed=9))
        yield dash
    finally:
        get_context().detach_subscriber(sub)
        dash.shutdown()
        get_table_registry().clear()


def test_http_submit_and_cache_hit(front_door):
    sql = "SELECT k, SUM(v) AS s FROM t WHERE k < 10 GROUP BY k ORDER BY k"
    s, r, _ = _post(front_door.url, {"sql": sql, "tenant": "web"})
    assert s == 200 and r["outcome"] == "success"
    assert r["row_count"] == 10 and not r["result_cache_hit"]
    assert r["query_id"] and r["plan_fingerprint"]
    s, r2, _ = _post(front_door.url, {"sql": sql, "tenant": "web"})
    assert s == 200 and r2["result_cache_hit"]
    assert r2["data"] == r["data"]
    # The wire query's record is a real one, and its answer the in-process
    # query's.
    rec = daft_tpu_torch.recent_queries(1)[0]
    assert rec["tenant"] == "web" and rec["result_cache_hit"] is True
    local = daft_tpu_torch.sql(sql, t=make_df(3_000, seed=9)).to_pydict()
    assert r["data"] == local and r["columns"] == ["k", "s"]


def test_http_timeout_maps_to_504_with_record(front_door):
    from daft_tpu_torch.querylog import get_recorder

    before = get_recorder().stats()["by_outcome"].get("timeout", 0)
    s, r, _ = _post(front_door.url, {"sql": "SELECT SUM(v) AS s FROM t", "tenant": "web",
                                     "timeout_s": 1e-7})
    assert s == 504 and r["kind"] == "DaftTimeoutError"
    assert get_recorder().stats()["by_outcome"]["timeout"] == before + 1


def test_http_shed_maps_to_429_with_retry_after(front_door):
    from daft_tpu_torch.querylog import get_recorder

    daft_tpu_torch.set_tenant_policy("throttled", max_concurrent_queries=1, queue_depth=1,
                                     priority=-1)
    before = get_recorder().stats()["by_outcome"].get("shed", 0)
    seen = {"429": 0, "retry_after": True}
    lock = threading.Lock()

    def post_one(i):
        # Distinct shapes: real concurrent work, so the 1-deep queue fills.
        s, r, headers = _post(front_door.url, {"sql": f"SELECT SUM(v + {i}) AS s FROM t",
                                               "tenant": "throttled"})
        with lock:
            if s == 429:
                seen["429"] += 1
                if not headers.get("Retry-After") or "retry_after_s" not in r:
                    seen["retry_after"] = False

    threads = [threading.Thread(target=post_one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen["429"] >= 1, "no shed despite a 1-deep queue under a burst"
    assert seen["retry_after"], "a 429 without Retry-After / retry_after_s"
    shed = get_recorder().stats()["by_outcome"].get("shed", 0) - before
    assert shed >= seen["429"], "shed wire queries under-recorded"


def test_http_bad_sql_is_400(front_door):
    s, r, _ = _post(front_door.url, {"sql": "SELECT FROM nothing"})
    assert s == 400
    s, r, _ = _post(front_door.url, {"no_sql": 1})
    assert s == 400
    # Malformed field values are the client's errors too, never 500s.
    s, r, _ = _post(front_door.url, {"sql": "SELECT k FROM t", "timeout_s": "abc"})
    assert s == 400 and r["kind"] == "BadRequest"
    s, r, _ = _post(front_door.url, {"sql": "SELECT k FROM t", "priority": "high"})
    assert s == 400


def test_request_priority_can_only_lower(front_door):
    """A wire request's priority=-1 sheds at level 1 even for a default
    tenant; a request cannot raise itself above its tenant's policy."""
    from daft_tpu_torch.execution.admission import TenantPolicy, set_request_priority

    ctl = get_controller()
    pol = TenantPolicy(tenant="web", priority=0)
    assert ctl._effective_priority(pol) == 0
    set_request_priority(-1)
    try:
        assert ctl._effective_priority(pol) == -1
        set_request_priority(5)
        assert ctl._effective_priority(pol) == 0  # cannot outrank the policy
    finally:
        set_request_priority(None)


def test_flight_do_get_roundtrip(front_door):
    fl = pytest.importorskip("pyarrow.flight")
    from daft_tpu_torch.distributed.flight import start_query_server

    srv = start_query_server()
    try:
        client = fl.FlightClient(srv.address)
        reader = client.do_get(fl.Ticket(json.dumps({
            "sql": "SELECT COUNT(k) AS n FROM t", "tenant": "web"}).encode()))
        assert reader.read_all().to_pydict() == {"n": [3000]}
        with pytest.raises(fl.FlightError):
            client.do_get(fl.Ticket(b"not json")).read_all()
        client.close()
    finally:
        srv.shutdown()


# --------------------------------------------------------------------- #
# Visibility                                                              #
# --------------------------------------------------------------------- #
def test_explain_analyze_prints_cache_lines(capsys):
    df = make_df(500, seed=11)
    agg_query(df).collect()  # warm both caches
    agg_query(df).explain(analyze=True)
    out = capsys.readouterr().out
    assert "result cache: HIT (" in out
    plancache.reset_caches()
    agg_query(df).explain(analyze=True)
    out = capsys.readouterr().out
    assert "plan cache: MISS" in out or "result cache: MISS" in out


def test_schema_reader_accepts_v1_through_v6(tmp_path):
    from daft_tpu_torch.querylog import (
        QUERYLOG_SCHEMA_VERSION,
        load_query_log,
        validate_record,
    )

    assert QUERYLOG_SCHEMA_VERSION == 6
    v1 = {"schema_version": 1, "query_id": "q1", "tenant": "default", "runner": "native",
          "ts": 1.0, "outcome": "success", "duration_s": 0.1, "plan_fingerprint": "ab",
          "error_kind": "", "admission_wait_s": 0.0, "shed_level": 0, "rows_out": 1,
          "bytes_out": 8}
    assert validate_record(v1) == []
    v2 = dict(v1, schema_version=2, plan_cache_hit=True, result_cache_hit=False)
    assert validate_record(v2) == []
    v3 = dict(v2, schema_version=3, mem={})
    assert validate_record(v3) == []
    v4 = dict(v3, schema_version=4, view={})
    assert validate_record(v4) == []
    assert validate_record(dict(v4, view={"view": "totals", "role": "serve", "watermark": 1.0,
                                          "staleness_s": 0.5, "delta_count": 3})) == []
    v5 = dict(v4, schema_version=5)
    assert validate_record(v5) == []
    assert validate_record(dict(v5, integrity={"verified": 3, "failed": 1,
                                               "quarantined": 1})) == []
    v6 = dict(v5, schema_version=6)
    assert validate_record(v6) == []
    assert validate_record(dict(v6, query_fingerprint="ab12", estimates={
        "complete": True, "corrected": False, "epoch": 0,
        "nodes": [{"node": "cd34", "op": "Filter", "est_rows": 100.0, "rows": 43,
                   "qerr": 2.326, "exact": True}]})) == []
    # A record missing its version's new fields is invalid; an unknown
    # version is rejected.
    assert validate_record(dict(v1, schema_version=2))
    assert validate_record(dict(v2, schema_version=3))
    assert validate_record(dict(v3, schema_version=4))
    assert validate_record(dict(v4, schema_version=7))
    p = tmp_path / "log.jsonl"
    with open(p, "w") as f:
        for rec in (v1, v2, v3, v4):
            f.write(json.dumps(rec) + "\n")
        f.write('{"torn')
    assert len(load_query_log(str(p))) == 4


def test_live_records_are_schema_valid_v6():
    from daft_tpu_torch.querylog import validate_record

    make_df(100, seed=13).agg(col("v").sum().alias("s")).collect()
    rec = daft_tpu_torch.recent_queries(1)[0]
    assert validate_record(rec) == []
    assert rec["schema_version"] == 6
    assert isinstance(rec["plan_cache_hit"], bool)
    assert isinstance(rec["result_cache_hit"], bool)
    assert isinstance(rec["mem"], dict)
    assert rec["view"] == {}  # not a view query: the block present and empty


@pytest.mark.parametrize("text", ["abc", "", "ümlaut\nplan", "x" * 1000])
def test_shared_fingerprint_helper(text):
    """One hashing scheme, the JAX package's: the same text gives the same
    16-hex key in both packages."""
    assert plancache.fingerprint(text) == jpc.fingerprint(text)
    assert len(plancache.fingerprint(text)) == 16


def test_path_overlap_respects_segment_boundaries():
    from daft_tpu_torch.plancache import _path_overlaps

    assert _path_overlaps("/data/foo", "/data/foo")
    assert _path_overlaps("/data/foo/part.parquet", "/data/foo")
    assert _path_overlaps("/data", "/data/foo")
    assert _path_overlaps("/data/foo/", "/data/foo")
    assert not _path_overlaps("/data/foobar", "/data/foo")
    assert not _path_overlaps("/data/foo", "/data/foobar")
    assert not _path_overlaps("/data/foobar/x.parquet", "/data/foo")
    assert not _path_overlaps("/data/foo.bak", "/data/foo")
    assert _path_overlaps("s3://b/data/foo/x", "s3://b/data/foo")
    assert not _path_overlaps("s3://b/data/foobar/x", "s3://b/data/foo")


def test_invalidate_sibling_prefix_keeps_entry(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    foo = tmp_path / "foo"
    foobar = tmp_path / "foobar"
    foo.mkdir()
    foobar.mkdir()
    pq.write_table(pa.table({"k": [1, 2], "v": [1.0, 2.0]}), str(foo / "a.parquet"))
    df = daft_tpu_torch.read_parquet(str(foo / "*.parquet"))
    df.groupby("k").agg(col("v").sum().alias("s")).collect()
    n0 = plancache.get_result_cache().stats()["entries"]
    assert n0 >= 1
    assert daft_tpu_torch.invalidate_cache_path(str(foobar)) == 0
    assert plancache.get_result_cache().stats()["entries"] == n0
    assert daft_tpu_torch.invalidate_cache_path(str(foo)) >= 1
    assert plancache.get_result_cache().stats()["entries"] == 0


# --------------------------------------------------------------------- #
# Beyond the JAX file                                                     #
# --------------------------------------------------------------------- #
def _udf_apply(pkg, df):
    return df.with_column("u", df["v"].apply(lambda x: x + 1, pkg.DataType.float64()))


#: name -> build(pkg, df, tmp) -> DataFrame; each is keyed in both packages.
PARITY_QUERIES = {
    "filter": lambda p, df, d: df.where(p.col("k") < 10),
    "agg": lambda p, df, d: agg_query(df, p.col),
    "project": lambda p, df, d: df.with_column("w", p.col("v") * 2 + 1),
    "sort_limit": lambda p, df, d: df.sort("v", desc=True).limit(5),
    "distinct": lambda p, df, d: df.select("k").distinct(),
    "join": lambda p, df, d: df.join(df.select("k").distinct(), on="k"),
    "udf_apply": lambda p, df, d: _udf_apply(p, df),
    "udf_batch": lambda p, df, d: df.with_column("u", p.udf.Udf(
        lambda s: s, p.DataType.float64(), batch=True)(p.col("v"))),
    "now": lambda p, df, d: df.with_column("t", p.sql_expr("CURRENT_TIMESTAMP")),
    "today": lambda p, df, d: df.with_column("t", p.sql_expr("CURRENT_DATE")),
    "random": lambda p, df, d: df.with_column("r", p.functions.random_int(p.lit(0), seed=None)),
    "uuid": lambda p, df, d: df.with_column("u", p.functions.uuid()),
    "sample_unseeded": lambda p, df, d: df.sample(fraction=0.5),
    "sample_seeded": lambda p, df, d: df.sample(fraction=0.5, seed=3),
    "in_subquery": lambda p, df, d: p.sql(
        "SELECT * FROM t WHERE k IN (SELECT k FROM t WHERE v > 500)", t=df),
    "correlated": lambda p, df, d: p.sql(
        "SELECT k, v FROM t AS a WHERE v > (SELECT AVG(v) FROM t AS b WHERE b.k = a.k)", t=df),
    "scan": lambda p, df, d: p.read_parquet(d).where(p.col("k") < 5),
    "scan_agg": lambda p, df, d: p.read_parquet(d).groupby("k").agg(p.col("v").sum()),
    "sql_group": lambda p, df, d: p.sql("SELECT k, SUM(v) AS s FROM t GROUP BY k", t=df),
    "window": lambda p, df, d: df.select(
        "k", p.col("v").sum().over(p.Window().partition_by("k")).alias("s")),
    "in_memory_twice": lambda p, df, d: df.concat(df),
}


@pytest.mark.parametrize("name", sorted(PARITY_QUERIES))
def test_cacheability_parity(name, tmp_path):
    """Both packages decide alike whether a query is plan-cacheable and
    result-cacheable, with the same note, and key the scan roots alike."""
    d = str(tmp_path)
    make_df(200).write_parquet(d)
    keys = []
    for pkg, mod in ((daft_tpu, jpc), (daft_tpu_torch, plancache)):
        q = PARITY_QUERIES[name](pkg, make_df(200, pkg=pkg), d)
        keys.append(mod.compute_query_key(q._builder.plan, pkg.get_context().execution_config))
    j, t = keys
    assert (t.plan_cacheable, t.result_cacheable, t.reason, t.roots) == \
        (j.plan_cacheable, j.result_cacheable, j.reason, j.roots)
    assert len(t.fp) == 16


def test_udf_plan_hits_the_plan_cache_never_the_result_cache():
    """A UDF keys on its identity: two frames built alike over one UDF
    expression share a plan-cache entry, and neither result is cached."""
    df = make_df(300)
    expr = col("v").apply(lambda x: x + 1, daft_tpu_torch.DataType.float64())
    ph0 = _counter(metrics.PLAN_CACHE_HITS)
    rh0 = metrics.RESULT_CACHE_HITS.labels("result").value()
    rm0 = metrics.RESULT_CACHE_MISSES.labels("result").value()
    outs = [df.with_column("u", expr).to_pydict() for _ in range(2)]
    assert outs[0] == outs[1]
    assert _counter(metrics.PLAN_CACHE_HITS) == ph0 + 1
    assert metrics.RESULT_CACHE_HITS.labels("result").value() == rh0
    assert metrics.RESULT_CACHE_MISSES.labels("result").value() == rm0
    assert plancache.get_result_cache().stats()["entries"] == 0


@pytest.mark.parametrize("caches", ["off", "on"])
def test_routes_and_morsels_of_a_miss(caches):
    """With both caches off, and on a miss with them on, a query runs the
    same routes and morsel boundaries."""
    from daft_tpu_torch.ops.device_eval import device_eval_counters

    on = caches == "on"
    df = make_df(30_000, seed=9)
    runs = []
    for cfg in ({"result_cache_enabled": False, "plan_cache_enabled": False},
                {"result_cache_enabled": on, "plan_cache_enabled": on}):
        plancache.reset_caches()
        device_eval_counters.reset()
        with execution_config_ctx(default_morsel_size=4096, device_eval_min_rows=1, **cfg):
            parts = list(df.where(col("v") > 100.0).with_column("w", col("v") * 2.0)
                         .iter_partitions())
        snap = device_eval_counters.snapshot()
        runs.append(([len(p) for p in parts], snap["fused_exprs"], snap["host_exprs"],
                     [p.to_arrow_table() for p in parts]))
    assert runs[0][:3] == runs[1][:3]
    assert all(a.equals(b) for a, b in zip(runs[0][3], runs[1][3]))


def test_failed_build_leaves_no_entry():
    """A query that fails mid-stream aborts its build: no entry, no claim,
    and the next run of the shape misses."""
    from daft_tpu_torch.errors import DaftError

    def boom(x):
        raise RuntimeError("boom")

    df = make_df(100)
    q = df.with_column("b", col("v").apply(boom, daft_tpu_torch.DataType.float64()))
    with pytest.raises((RuntimeError, DaftError)):
        q.collect()
    st = plancache.get_result_cache().stats()
    assert st["entries"] == 0 and st["building"] == 0


def test_unfingerprintable_plan_runs_uncached(monkeypatch, caplog):
    """A failed key computation runs the query uncached and logs it, as
    the JAX package does."""
    def broken(plan, cfg):
        raise RuntimeError("no key")

    monkeypatch.setattr(plancache, "compute_query_key", broken)
    with caplog.at_level("WARNING", logger="daft_tpu_torch.plancache"):
        out = make_df(50).where(col("k") < 10).to_pydict()
    assert out["k"] and all(k < 10 for k in out["k"])
    assert "running uncached" in caplog.text
    assert plancache.get_result_cache().stats()["entries"] == 0
