"""``ExecutionConfig.from_env`` in the port against the JAX package's, on
the CPU.

For each ``DAFT_*`` variable the port's ``from_env`` honours, set under
``monkeypatch``, both packages' ``from_env()`` give the same value for every
field both configs have (exact equality: the values are ints, floats,
strings and booleans parsed from the same text). Unset, the port's
``from_env()`` is its dataclass defaults. The variables read where the JAX
package reads them (``DAFT_SPILL_DIR``, ``DAFT_PROFILE_CPU``,
``DAFT_MEMORY_LIMIT`` of a new ``MemoryManager``, ``DAFT_TENANT``,
``DAFT_MEM_SAMPLER``, ``DAFT_QUERY_RECORDER`` at each query's start) are
held at those places. The front door's fields have the JAX package's
defaults.
"""

import dataclasses
import os
import subprocess
import sys

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import config as jconfig
from daft_tpu_torch import config as tconfig

#: variable -> the values each case sets, as text.
VARIABLES = {
    # Moves no field of the port's config: a new MemoryManager reads it
    # (test_memory_limit_from_env), and the config field comes with the fleet.
    "DAFT_MEMORY_LIMIT": ["1048576"],
    "DAFT_TPU_DEVICE_EVAL": ["0", "false", "1"],
    "DAFT_COMPILED_EVAL": ["0", "off", "1"],
    "DAFT_COMPUTE_THREADS": ["1", "4"],
    "DAFT_QUERY_TIMEOUT_S": ["2.5"],
    "DAFT_METRICS": ["0", "no", "1"],
    "DAFT_METRICS_FILE": ["/tmp/metrics.jsonl"],
    "DAFT_PROFILE": ["1", "0"],
    "DAFT_PROFILE_FILE": ["/tmp/trace.json"],
    "DAFT_PLAN_CACHE": ["0", "1"],
    "DAFT_PLAN_CACHE_SIZE": ["7"],
    "DAFT_RESULT_CACHE": ["0", "FALSE", "1"],
    "DAFT_RESULT_CACHE_BYTES": ["4096"],
    "DAFT_MEMLEDGER": ["0", "1"],
    "DAFT_MEM_SAMPLER": ["0", "1"],
    "DAFT_INTEGRITY": ["0", "1"],
    "DAFT_INTEGRITY_VERIFY_ON_WRITE": ["1", "0"],
    "DAFT_ADMISSION": ["0", "off", "1"],
    "DAFT_ADMISSION_MAX_CONCURRENT": ["3"],
    "DAFT_ADMISSION_QUEUE_DEPTH": ["5"],
    "DAFT_ADMISSION_POLICIES": ['{"gold": {"priority": 1}}'],
    "DAFT_QUERY_RECORDER": ["0", "1"],
    "DAFT_QUERY_LOG": ["/tmp/qlog.jsonl"],
    "DAFT_SLO_LATENCY_P99_S": ["0.25"],
    "DAFT_SLO_ERROR_RATE": ["0.01"],
    "DAFT_SLO_AUTOPROFILE": ["5"],
}

#: The front door's fields (admission, the flight recorder, the SLO plane):
#: the JAX package's names and defaults.
FRONT_DOOR_FIELDS = (
    "admission_enabled", "admission_max_concurrent_queries", "admission_queue_depth",
    "admission_max_memory_fraction", "admission_policies", "admission_overload_queue_fraction",
    "admission_permit_wait_p95_s", "admission_shed_cooldown_s", "query_recorder_enabled",
    "query_log_path", "slo_latency_p99_s", "slo_error_rate", "slo_fast_window_s",
    "slo_slow_window_s", "slo_fast_burn", "slo_slow_burn", "slo_autoprofile_count",
    "slo_slow_query_s")

_CASES = [pytest.param(var, val, id=f"{var}={val}")
          for var, vals in VARIABLES.items() for val in vals]


@pytest.fixture
def clean_env(monkeypatch):
    for name in list(os.environ):
        if name.startswith("DAFT_"):
            monkeypatch.delenv(name)
    return monkeypatch


def _shared_fields(jcfg, tcfg):
    tnames = {f.name for f in dataclasses.fields(tcfg)}
    return sorted(f.name for f in dataclasses.fields(jcfg) if f.name in tnames)


@pytest.mark.parametrize("var, value", _CASES)
def test_from_env_matches_the_jax_package(clean_env, var, value):
    clean_env.setenv(var, value)
    jcfg = jconfig.ExecutionConfig.from_env()
    tcfg = tconfig.ExecutionConfig.from_env()
    shared = _shared_fields(jcfg, tcfg)
    assert len(shared) >= 25
    for name in shared:
        assert getattr(tcfg, name) == getattr(jcfg, name), (var, value, name)
    # The variable moved a field where the JAX package's moves one.
    moved_j = {n for n in shared if getattr(jcfg, n) != getattr(jconfig.ExecutionConfig(), n)}
    moved_t = {n for n in shared if getattr(tcfg, n) != getattr(tconfig.ExecutionConfig(), n)}
    assert moved_t == moved_j


def test_unset_gives_the_port_defaults(clean_env):
    assert tconfig.ExecutionConfig.from_env() == tconfig.ExecutionConfig()
    cfg = tconfig.ExecutionConfig()
    assert (cfg.plan_cache_enabled, cfg.plan_cache_size, cfg.plan_cache_max_pinned_bytes,
            cfg.result_cache_enabled, cfg.result_cache_max_bytes,
            cfg.result_cache_max_entry_bytes, cfg.result_cache_scan_outputs,
            cfg.mem_sampler_enabled, cfg.device) == \
        (True, 256, 256 << 20, True, 1 << 30, 256 << 20, True, True, "cuda")
    jcfg = jconfig.ExecutionConfig()
    for name in ("plan_cache_enabled", "plan_cache_size", "plan_cache_max_pinned_bytes",
                 "result_cache_enabled", "result_cache_max_bytes",
                 "result_cache_max_entry_bytes", "result_cache_scan_outputs",
                 "mem_sampler_enabled"):
        assert getattr(cfg, name) == getattr(jcfg, name), name


def test_front_door_fields_have_the_jax_packages_defaults():
    tcfg, jcfg = tconfig.ExecutionConfig(), jconfig.ExecutionConfig()
    for name in FRONT_DOOR_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("raw", ["0", "1"])
def test_query_recorder_read_at_every_query(clean_env, raw):
    """``DAFT_QUERY_RECORDER`` is read at each query's start, over the
    config, in both packages: an A/B can alternate in one process."""
    from daft_tpu import querylog as jql
    from daft_tpu_torch import querylog as tql

    clean_env.setenv("DAFT_QUERY_RECORDER", raw)
    for ql, cfg in ((tql, tconfig.ExecutionConfig(query_recorder_enabled=raw != "1")),
                    (jql, jconfig.ExecutionConfig(query_recorder_enabled=raw != "1"))):
        assert (ql.get_recorder().begin("env-q", cfg) is not None) is (raw == "1")


def test_context_module_still_exports_the_configs():
    from daft_tpu_torch.context import ExecutionConfig, PlanningConfig

    assert ExecutionConfig is tconfig.ExecutionConfig
    assert PlanningConfig is tconfig.PlanningConfig


def test_default_context_config_is_from_env():
    """A new process builds its default config from the environment, as
    the JAX package's context does."""
    code = ("import daft_tpu_torch as dt; c = dt.get_context().execution_config; "
            "print(c.num_compute_threads, c.result_cache_enabled, c.plan_cache_size)")
    env = dict(os.environ, DAFT_COMPUTE_THREADS="1", DAFT_RESULT_CACHE="0",
               DAFT_PLAN_CACHE_SIZE="9")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert out == ["1", "False", "9"]


@pytest.mark.parametrize("flag, expect", [("0", False), ("false", False), ("off", False),
                                          ("", False), ("1", True), ("yes", True)])
def test_daft_env_flag_matches(clean_env, flag, expect):
    clean_env.setenv("DAFT_X_FLAG", flag)
    assert tconfig.daft_env_flag("DAFT_X_FLAG") is expect
    assert jconfig.daft_env_flag("DAFT_X_FLAG") is expect
    clean_env.delenv("DAFT_X_FLAG")
    assert tconfig.daft_env_flag("DAFT_X_FLAG", True) is jconfig.daft_env_flag("DAFT_X_FLAG", True)


def test_spill_dir_from_env(clean_env, tmp_path):
    from daft_tpu.execution.spill import SpillDir as JSpillDir
    from daft_tpu_torch.execution.spill import SpillDir as TSpillDir

    clean_env.setenv("DAFT_SPILL_DIR", str(tmp_path))
    for cls in (JSpillDir, TSpillDir):
        assert os.path.dirname(cls().root) == str(tmp_path)
        assert os.path.dirname(cls(root=str(tmp_path / "x")).root) == str(tmp_path / "x")


def test_memory_limit_from_env(clean_env):
    from daft_tpu.execution.resource_manager import MemoryManager as JMM
    from daft_tpu_torch.execution.resource_manager import MemoryManager as TMM

    clean_env.setenv("DAFT_MEMORY_LIMIT", "123456")
    assert TMM().limit == JMM().limit == 123456
    assert TMM(limit_bytes=7).limit == JMM(limit_bytes=7).limit == 7
    clean_env.delenv("DAFT_MEMORY_LIMIT")
    assert TMM().limit is None and JMM().limit is None


def test_tenant_from_env(clean_env):
    from daft_tpu.execution import admission as jadm
    from daft_tpu_torch.execution import admission as tadm

    assert tadm.current_tenant() == jadm.current_tenant() == "default"
    clean_env.setenv("DAFT_TENANT", "acme")
    assert tadm.current_tenant() == jadm.current_tenant() == "acme"
    assert tadm.resolve_tenant("x") == jadm.resolve_tenant("x") == "x"
    tadm.set_tenant("ctx")
    try:
        assert tadm.current_tenant() == "ctx"
    finally:
        tadm.set_tenant(None)


@pytest.mark.parametrize("raw, expect", [("1", True), ("0", False), ("off", False)])
def test_profile_cpu_from_env(clean_env, raw, expect):
    from daft_tpu_torch import profiling

    clean_env.setenv("DAFT_PROFILE_CPU", raw)
    clean_env.setattr(profiling, "_sample_cpu", None)
    assert profiling.cpu_sampling_enabled() is expect


@pytest.mark.parametrize("raw", ["0", "1"])
def test_mem_sampler_from_env(clean_env, raw):
    from daft_tpu_torch.execution.memledger import MemoryLedger

    clean_env.setenv("DAFT_MEM_SAMPLER", raw)
    led = MemoryLedger()
    sampler = led.ensure_sampler(tconfig.ExecutionConfig())
    try:
        assert (sampler is not None) is (raw == "1")
        assert led.ensure_sampler(tconfig.ExecutionConfig(mem_sampler_enabled=False)) is sampler
    finally:
        if sampler is not None:
            sampler.stop()
    clean_env.delenv("DAFT_MEM_SAMPLER")
    assert MemoryLedger().ensure_sampler(tconfig.ExecutionConfig(mem_sampler_enabled=False)) is None


def test_query_timeout_from_env_bounds_a_query(clean_env):
    """``DAFT_QUERY_TIMEOUT_S`` through the default config bounds a query in
    both packages as ``query_timeout_s`` does."""
    clean_env.setenv("DAFT_QUERY_TIMEOUT_S", "0.000001")
    for pkg, cfgmod in ((daft_tpu, jconfig), (daft_tpu_torch, tconfig)):
        cfg = cfgmod.ExecutionConfig.from_env()
        assert cfg.query_timeout_s == 1e-6
        df = pkg.from_pydict({"x": list(range(20_000))})
        overrides = {"device": "cpu"} if pkg is daft_tpu_torch else {}
        with pkg.execution_config_ctx(query_timeout_s=cfg.query_timeout_s,
                                      result_cache_enabled=False, **overrides):
            with pytest.raises((pkg.DaftTimeoutError, pkg.DaftCancelledError)):
                df.where(pkg.col("x") > 3).collect()
