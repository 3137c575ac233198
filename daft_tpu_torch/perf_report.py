"""Engine-overhead gap attribution (port of ``daft_tpu/perf_report.py``'s
``gap_breakdown``).

The rest of the JAX module (the benchmark trajectory, its diffs and
regression reports) is ROADMAP A.8.
"""

from __future__ import annotations


def gap_breakdown(profile, standalone_s: float, engine_s: float) -> str:
    """Explain an engine-vs-standalone wall gap operator by operator: the
    profiled engine run's per-plan-node self times
    (``QueryProfile.operator_table(by="plan_node")``), each as seconds and as
    a share of the gap, in the JAX package's text, so a failing watchdog
    names the layer (morsel re-batching, fetch ordering, dispatch) instead of
    a bare ratio."""
    gap = engine_s - standalone_s
    lines = [f"engine {engine_s:.3f}s vs standalone {standalone_s:.3f}s "
             f"(x{engine_s / standalone_s:.3f}, gap {gap:+.3f}s)"]
    if profile is None:
        lines.append("  (no profile attached)")
        return "\n".join(lines)
    accounted = 0.0
    for r in profile.operator_table(by="plan_node"):
        self_s = r["self_wall_ns"] / 1e9
        accounted += self_s
        share = (self_s / gap * 100.0) if gap > 1e-9 else 0.0
        lines.append(
            f"  {r.get('plan_node', r['operator']):<24} self "
            f"{self_s:8.3f}s  cpu {r['self_cpu_ns'] / 1e9:7.3f}s  "
            f"rows {r['rows']:>9}  morsels {r['morsels']:>5}"
            + (f"  ({share:5.1f}% of gap)" if gap > 1e-9 else ""))
    residual = engine_s - accounted
    lines.append(f"  {'<unattributed (plan/dispatch)>':<24} self "
                 f"{residual:8.3f}s")
    return "\n".join(lines)
