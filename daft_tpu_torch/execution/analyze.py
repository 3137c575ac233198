"""EXPLAIN ANALYZE instrumentation (port of ``daft_tpu/execution/analyze.py``):
run a query and report row/wall counts plus engine-health deltas —
per-operator stats, device-eval fusion coverage, out-of-core spill volume,
IO traffic, and memory permit pressure.

Reference seam: the reference's explain(analyze) attaches runtime stats to
the plan text (src/daft-local-execution runtime_stats + EXPLAIN ANALYZE in
daft-sql). All deltas come from ONE before/after pair of unified-registry
snapshots (daft_tpu_torch/metrics.py): anything the registry learns to count
shows up here for free.

The ``plan cache: HIT|MISS`` and ``result cache: HIT (<n> bytes)|MISS``
lines say whether the run skipped optimize + translate, or execution
altogether (``plancache``). The memory line sets the peak beside the
admission reservation, and the ``flight record`` line repeats the query's
record (``querylog``): its tenant, outcome, admission wait, shed level and
plan fingerprint, ``[autoprofiled]`` when the tail sampler profiled it.
Left out until the modules the JAX package reads for them are ported: the
``shuffle`` line (the distributed shuffle, ROADMAP A.8.5) and the
``planner`` line with the operator table's ``est_rows`` / ``q_err`` values
(``feedback``, A.8.6), which therefore show ``-`` as the JAX package shows
them for a node without an estimate.
"""

from __future__ import annotations

import time


def flight_record_line(rec: dict) -> str:
    """The analyzed plan's ``flight record:`` line for one query record.
    ``[autoprofiled]`` marks a record the tail sampler profiled; the
    analyzed run itself is profiled by its own scope, so the sampler never
    takes it, in both packages alike."""
    return (f"flight record: tenant={rec['tenant']} "
            f"outcome={rec['outcome']} "
            f"admission_wait={rec['admission_wait_s']:.3f}s "
            f"shed_level={rec['shed_level']} "
            f"fingerprint={rec['plan_fingerprint']}"
            + (" [autoprofiled]" if rec.get("autoprofiled") else ""))


def analyze_suffix(df) -> str:
    """Collect ``df`` and format the '== Analyze ==' plan-text suffix."""
    from daft_tpu_torch import profiling
    from daft_tpu_torch.metrics import get_registry

    reg = get_registry()
    s0 = reg.snapshot()
    # Run the query under a profiling scope so the per-operator table comes
    # from real operator spans (wall/self-CPU/spill/permit-wait per plan
    # node, workers included) instead of only aggregate registry deltas.
    # The scope's own handle — not the process-global last_profile(), which
    # a concurrently finishing profiled query can replace — attributes the
    # table; it stays None when df was already materialized (no fresh run).
    t0 = time.perf_counter()
    with profiling.collect_profile() as req:
        df.collect()
    wall = time.perf_counter() - t0
    prof = req.profile
    s1 = reg.snapshot()

    def d(name: str) -> float:
        return s1.counter_total(name) - s0.counter_total(name)

    rows = sum(len(p) for p in df._result or [])
    lines = [f"\n== Analyze ==\nrows: {rows}, wall: {wall:.4f}s"]
    fused = int(d("daft_device_fused_exprs_total"))
    fused_rows = int(d("daft_device_fused_rows_total"))
    before = s0.label_totals("daft_device_fallback_exprs_total", "reason")
    after = s1.label_totals("daft_device_fallback_exprs_total", "reason")
    reasons = {k: int(v - before.get(k, 0)) for k, v in after.items()
               if v - before.get(k, 0)}
    lines.append(f"device eval: fused_exprs={fused}, fused_rows={fused_rows}"
                 + (f", fallbacks={reasons}" if reasons else ""))
    hits = int(d("daft_compile_cache_hits_total"))
    misses = int(d("daft_compile_cache_misses_total"))
    chain_morsels = int(d("daft_compiled_chain_morsels_total"))
    if hits or misses or chain_morsels:
        ch0 = s0.hist("daft_compile_seconds")
        ch1 = s1.hist("daft_compile_seconds")
        enabled = s1.value("daft_compiled_eval_enabled")
        lines.append(
            f"compiled chains: morsels={chain_morsels}, "
            f"cache_hits={hits}, cache_misses={misses}, "
            f"compile_s={ch1['sum'] - ch0['sum']:.4f}"
            + ("" if enabled else " [SELF-DISABLED]"))
    # Query-cache visibility (plancache.py): one line per cache tier. HIT
    # means this run skipped optimize + translate (plan) or execution
    # altogether (result: bytes served from memory).
    pc_hit = int(d("daft_plan_cache_hits_total"))
    pc_miss = int(d("daft_plan_cache_misses_total"))
    if pc_hit or pc_miss:
        lines.append(f"plan cache: {'HIT' if pc_hit else 'MISS'}")
    rc_hit = int(d("daft_result_cache_hits_total"))
    rc_miss = int(d("daft_result_cache_misses_total"))
    if rc_hit or rc_miss:
        if rc_hit:
            hit_bytes = int(d("daft_result_cache_hit_bytes_total"))
            lines.append(f"result cache: HIT ({hit_bytes} bytes)")
        else:
            lines.append("result cache: MISS")
    spilled = int(d("daft_spill_bytes_total"))
    if spilled:
        lines.append(f"spill: bytes={spilled}, "
                     f"files={int(d('daft_spill_files_total'))}")
    # Integrity plane (integrity.py): digest verifications over
    # the run's bracket — silent when the plane saw no traffic, LOUD when
    # anything failed (a quarantined artifact healed through lineage is
    # exactly the kind of fact EXPLAIN ANALYZE must not hide).
    iv = int(d("daft_integrity_verified_total"))
    if_ = int(d("daft_integrity_failed_total"))
    if iv or if_:
        line = f"integrity: verified={iv}"
        if if_:
            line += (f", FAILED={if_}, "
                     f"quarantined={int(d('daft_integrity_quarantined_total'))}")
        lines.append(line)
    io_bytes = int(d("daft_io_bytes_total"))
    io_reqs = int(d("daft_io_requests_total"))
    if io_bytes or io_reqs:
        line = f"io: bytes={io_bytes}, requests={io_reqs}"
        retries = int(d("daft_io_retries_total"))
        if retries:
            line += f", retries={retries}"
        lines.append(line)
    h0 = s0.hist("daft_memory_permit_wait_seconds")
    h1 = s1.hist("daft_memory_permit_wait_seconds")
    waits = int(h1["count"] - h0["count"])
    if waits:
        lines.append(f"memory permits: waits={waits}, "
                     f"wait_s={h1['sum'] - h0['sum']:.4f}")
    # Memory observatory (execution/memledger.py): the run's reconciled
    # byte profile — reserved vs peak-held vs spilled, backpressure stall,
    # and (below) a per-operator peak column on the profiler table.
    mem_by_op = {}
    if prof is not None:
        from daft_tpu_torch.execution.memledger import get_ledger

        memprof = get_ledger().profile_for(prof.query_id)
        if memprof is not None and memprof.get("peak_held_bytes"):
            line = (f"memory: peak_held={memprof['peak_held_bytes']}, "
                    f"charged={memprof['charged_bytes']}")
            if memprof.get("reserved_bytes"):
                over, under = memprof["over_bytes"], memprof["under_bytes"]
                delta = f"+{over}" if over else f"-{under}" if under else "exact"
                line += (f", reserved={memprof['reserved_bytes']}"
                         f" ({delta} vs reservation)")
            if memprof.get("spilled_bytes"):
                line += f", spilled={memprof['spilled_bytes']}"
            if memprof.get("stall_s"):
                line += f", stall_s={memprof['stall_s']:.4f}"
            if memprof.get("residual_bytes"):
                line += f", RESIDUAL={memprof['residual_bytes']}"
            lines.append(line)
            mem_by_op = memprof.get("by_operator") or {}
    if prof is not None:
        # The flight recorder's line: the same record the always-on query
        # log kept for this run, beside the profiler's table, so the two
        # planes cannot disagree about what happened.
        from daft_tpu_torch.querylog import get_recorder

        rec = get_recorder().record_for(prof.query_id)
        if rec is not None:
            lines.append(flight_record_line(rec))
    # The planner's estimates (feedback) are ROADMAP A.8.6: "-" for every
    # est_rows / q_err below. Plan-node granularity (HashJoin#3, not just
    # HashJoin): two Filters never share a row.
    table = prof.operator_table(by="plan_node") if prof is not None else []
    if table:
        lines.append("operators (by self time):")
        lines.append(f"  {'operator':<22} {'rows':>10} {'est_rows':>10} "
                     f"{'q_err':>7} {'wall_ms':>9} "
                     f"{'self_ms':>9} {'cpu_ms':>8} {'spill':>10} "
                     f"{'permit_ms':>9} {'peak_mem':>10}")
        for r in table:
            # Per-operator peak bytes from the memory ledger (keyed by
            # operator TYPE; a plan with several nodes of one type shares
            # the row).
            peak = (mem_by_op.get(r["operator"]) or {}).get("peak", 0)
            lines.append(
                f"  {r['operator']:<22} {r['rows']:>10} {'-':>10} "
                f"{'-':>7} "
                f"{r['wall_ns'] / 1e6:>9.1f} {r['self_wall_ns'] / 1e6:>9.1f} "
                f"{r['self_cpu_ns'] / 1e6:>8.1f} {r['spill_bytes']:>10} "
                f"{r['permit_wait_ns'] / 1e6:>9.1f} {peak:>10}")
    else:
        # No fresh profile (pre-materialized df): fall back to the coarse
        # RuntimeStats counters so analyze still says SOMETHING per op.
        ops = getattr(df, "metrics", None)
        if callable(ops):
            m = df.metrics()
            if m:
                per_op = ", ".join(
                    f"{op}: rows_out={c['rows_out']} cpu_ms={c['cpu_ns'] // 1_000_000}"
                    for op, c in sorted(m.items()))
                lines.append(f"operators: {per_op}")
    return "\n".join(lines)
