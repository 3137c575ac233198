"""The port's fused device evaluation (daft_tpu_torch/ops/device_eval.py)
against the JAX package's (daft_tpu/ops/device_eval.py), on the CPU.

Each test builds the same numpy-seeded inputs in both packages and runs the
JAX device path (XLA on the CPU) and the port's (torch with device="cpu").
Elementwise outputs and null masks must be equal bit for bit; transcendental
functions and float ``pow`` (two libm implementations) are held at rtol 1e-6
in f32 and one bf16 step (8e-3) in bf16; the embedding distances at rtol 1e-6
(f32 reductions in another order). Mirrors tests/test_device_eval.py (all but
the EXPLAIN test: the port has no EXPLAIN yet).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.ops import device_eval as jde
from daft_tpu_torch.context import ExecutionConfig
from daft_tpu_torch.errors import DaftValueError
from daft_tpu_torch.ops import device_eval as tde

PKGS = (daft_tpu, daft_tpu_torch)
F32_TOL = 1e-6   # two libm implementations of one f32 function
BF16_TOL = 8e-3  # one bf16 step


@pytest.fixture(autouse=True)
def low_threshold():
    with daft_tpu.execution_config_ctx(device_eval=True, device_eval_min_rows=1), \
            daft_tpu_torch.execution_config_ctx(device="cpu", device_eval=True,
                                                device_eval_min_rows=1):
        yield


def _rb(pkg, data):
    """A RecordBatch of ``pkg`` from numpy arrays (their dtypes kept) or lists."""
    return pkg.RecordBatch.from_pydict(
        {k: pkg.Series.from_numpy(v, k) if isinstance(v, np.ndarray) else v
         for k, v in data.items()})


def _typed_rb(pkg, data, dtypes):
    df = pkg.from_pydict(data).with_columns(
        {k: pkg.col(k).cast(getattr(pkg.DataType, v)()) for k, v in dtypes.items()})
    parts = df.collect()._result if pkg is daft_tpu_torch else df._materialize().partitions
    return parts[0].combined()


def _fused(pkg, rb, build):
    """``build(pkg)`` (one expression) through ``pkg``'s device path: the
    Series, or None where the device path did not take it."""
    ev = jde if pkg is daft_tpu else tde
    out = ev.try_evaluate_fused(rb, [build(pkg)._expr])
    return None if out is None else out.get(0)


def _both(data, build, dtypes=None):
    rbs = [(_typed_rb(p, data, dtypes) if dtypes else _rb(p, data)) for p in PKGS]
    return [_fused(p, rb, build) for p, rb in zip(PKGS, rbs)]


def _assert_equal(jax_s, port_s, rtol=0.0):
    assert jax_s is not None, "the JAX package's device path did not take the expression"
    assert port_s is not None, "the port's device path did not take the expression"
    assert repr(jax_s.dtype) == repr(port_s.dtype)
    jv, jm = jax_s.to_numpy_masked()
    pv, pm = port_s.to_numpy_masked()
    assert (jm is None) == (pm is None) and (jm is None or np.array_equal(jm, pm))
    if jv.dtype == ml_dtypes.bfloat16:
        jv, pv = jv.astype(np.float32), pv.astype(np.float32)
    if rtol:
        np.testing.assert_allclose(pv, jv, rtol=rtol, equal_nan=True)
    else:
        np.testing.assert_array_equal(pv, jv)


# -- mirrors of tests/test_device_eval.py -------------------------------------
def test_fusion_fires_on_null_free():
    j, p = _both({"x": np.arange(100, dtype=np.int32)},
                 lambda pkg: (pkg.col("x") * 2 + 1).alias("y"))
    _assert_equal(j, p)
    np.testing.assert_array_equal(p.to_numpy(), np.arange(100) * 2 + 1)


def test_fusion_fires_on_nullable_with_exact_null_propagation():
    xs = [1, None, 3, None, 5] * 40
    ys = [10, 20, None, 40, 50] * 40
    j, p = _both({"x": xs, "y": ys}, lambda pkg: ((pkg.col("x") + pkg.col("y")) * 2).alias("z"),
                 dtypes={"x": "int32", "y": "int32"})
    _assert_equal(j, p)
    assert p.to_pylist() == [None if (a is None or b is None) else (a + b) * 2
                             for a, b in zip(xs, ys)]


def test_nullable_comparison_propagates_nulls():
    j, p = _both({"x": [1, None, 3] * 50}, lambda pkg: (pkg.col("x") > 1).alias("b"),
                 dtypes={"x": "int32"})
    _assert_equal(j, p)
    assert p.to_pylist() == [False, None, True] * 50


def test_unsafe_exprs_skip_device_when_nullable():
    """IfElse / Kleene or must NOT ride the and-reduce mask path; the host
    path answers with Kleene semantics."""
    xs = [True, None, False] * 50
    data = {"p": xs, "v": [1.0, 2.0, 3.0] * 50}
    j, p = _both(data, lambda pkg: (pkg.col("p") | pkg.lit(True)).alias("k"))
    assert j is None and p is None
    tde.device_eval_counters.reset()
    got = daft_tpu_torch.from_pydict({"p": xs}).select(
        (daft_tpu_torch.col("p") | daft_tpu_torch.lit(True)).alias("k")).to_pydict()["k"]
    assert got == [True, True, True] * 50
    # Counted twice: the chain's route, then the projection's expression.
    assert tde.device_eval_counters.snapshot()["host_exprs"] == {
        "chain_nullable_unsafe": 1, "nullable_unsafe": 1}


@pytest.mark.parametrize("build, safe", [
    (lambda pkg: ((pkg.col("a") + 1) * pkg.col("b") > 2).alias("s"), True),
    (lambda pkg: pkg.col("a") | pkg.col("b"), False),
    (lambda pkg: pkg.col("a").is_null().if_else(pkg.lit(0), pkg.col("a")), False),
    (lambda pkg: pkg.col("a").embedding.cosine_distance(pkg.col("b")), True),
    (lambda pkg: pkg.col("a").sqrt(), False),
], ids=["arith", "kleene_or", "if_else", "same_rules_kernel", "plain_kernel"])
def test_nullable_safe_classifier(build, safe):
    assert jde._nullable_safe(build(daft_tpu)._expr) is safe
    assert tde._nullable_safe(build(daft_tpu_torch)._expr) is safe


def test_metrics_count_fused_and_fallback():
    """Fusion coverage is observable: a numeric projection records fused
    exprs/rows in both packages; an expression without a device lowering
    records its host route instead of vanishing silently."""
    data = {"x": np.arange(64, dtype=np.int32)}
    jde.device_eval_metrics.reset()
    tde.device_eval_counters.reset()
    _assert_equal(*_both(data, lambda pkg: (pkg.col("x") * 2).alias("y")))
    jsnap, psnap = jde.device_eval_metrics.snapshot(), tde.device_eval_counters.snapshot()
    assert (jsnap["fused_exprs"], jsnap["fused_rows"]) == (1, 64)
    assert (psnap["fused_exprs"], psnap["fused_rows"]) == (1, 64)

    fdata = {"f": np.linspace(0, 1, 64, dtype=np.float32)}
    jde.device_eval_metrics.reset()
    tde.device_eval_counters.reset()
    j, p = _both(fdata, lambda pkg: pkg.col("f").float.fill_nan(0.0).alias("g"))
    assert j is None and p is None
    assert jde.device_eval_metrics.snapshot()["fallback_reasons"].get("not_fusable") == 1
    assert tde.device_eval_counters.snapshot()["host_exprs"] == {"not_fusable": 1}


@pytest.mark.parametrize("fn", ["cosine_distance", "l2_distance", "dot", "l2_normalize"])
def test_embedding_distance_kernels_fuse(fn):
    """The same-rules embedding kernels fuse into the device graph although
    they resolve to f64; the port's device path equals the JAX package's
    within f32 reduction rounding (rtol 1e-6), and its own host path."""
    n, dim = 128, 16
    rng = np.random.default_rng(5)
    a = rng.standard_normal((n, dim)).astype(np.float32)
    b = rng.standard_normal((n, dim)).astype(np.float32)

    def data(pkg):
        emb = pkg.DataType.embedding(pkg.DataType.float32(), dim)
        return {"a": pkg.Series.from_numpy(a, "a", emb), "b": pkg.Series.from_numpy(b, "b", emb)}

    def build(pkg):
        e = pkg.col("a").embedding
        return (e.l2_normalize() if fn == "l2_normalize" else getattr(e, fn)(pkg.col("b"))).alias("d")

    jax_df = daft_tpu.from_pydict(data(daft_tpu))
    port_df = daft_tpu_torch.from_pydict(data(daft_tpu_torch))
    tde.device_eval_counters.reset()
    port = np.asarray(port_df.select(build(daft_tpu_torch)).to_pydict()["d"])
    assert tde.device_eval_counters.snapshot()["fused_exprs"] == 1, \
        "distance kernels must ride the fused device path"
    jax = np.asarray(jax_df.select(build(daft_tpu)).to_pydict()["d"])
    with daft_tpu_torch.execution_config_ctx(device_eval=False, compiled_eval_enabled=False):
        host = np.asarray(port_df.select(build(daft_tpu_torch)).to_pydict()["d"])
    np.testing.assert_allclose(port, jax, rtol=F32_TOL, atol=1e-6)
    np.testing.assert_allclose(port, host, rtol=F32_TOL, atol=1e-6)


def test_engine_parity_host_vs_device_on_nullable():
    """Same query, device path on vs off, and against the JAX package."""
    n = 5000
    rng = np.random.default_rng(3)
    xs = [None if i % 7 == 0 else float(rng.random()) for i in range(n)]

    def run(pkg, **cfg):
        df = pkg.from_pydict({"x": xs}).with_column("x", pkg.col("x").cast(pkg.DataType.float32()))
        with pkg.execution_config_ctx(**cfg):
            return df.select(((pkg.col("x") * 3 - 1) / 2).alias("y")).to_pydict()["y"]

    dev = run(daft_tpu_torch)
    host = run(daft_tpu_torch, device_eval=False, compiled_eval_enabled=False)
    jde.device_eval_metrics.reset()
    jax = run(daft_tpu)
    assert jde.device_eval_metrics.snapshot()["fused_rows"] > 0
    assert [v is None for v in dev] == [v is None for v in host] == [v is None for v in jax]
    dv = np.asarray([v for v in dev if v is not None])
    # Two f32 roundings per row apart at most: XLA contracts x * 3 - 1 into
    # one fused multiply-add, and the host computes f64 intermediates (the
    # Python literals unify to f64 there); eager torch rounds every op.
    for other in (jax, host):
        np.testing.assert_allclose(dv, [v for v in other if v is not None],
                                   rtol=F32_TOL, atol=2.5e-7)


def test_fusion_coverage_floor_on_representative_pipeline():
    """A q01/q06-shaped f32 pipeline (filter -> arithmetic projections ->
    agg) rides the compiled chain: one program per chunk, a program-cache hit
    when the same shape runs again, no host route, and the JAX package's
    answer."""
    n = 4096
    rng = np.random.default_rng(7)
    data = {"price": rng.uniform(900, 105000, n).astype(np.float32),
            "disc": rng.uniform(0.0, 0.1, n).astype(np.float32),
            "tax": rng.uniform(0.0, 0.08, n).astype(np.float32),
            "qty": rng.uniform(1, 50, n).astype(np.float32)}

    def build(pkg):
        c = pkg.col
        return (pkg.from_pydict(data).where((c("qty") < 24.0) & (c("disc") >= 0.02))
                .with_columns({"disc_price": c("price") * (1 - c("disc")),
                               "charge": c("price") * (1 - c("disc")) * (1 + c("tax"))})
                .agg(c("disc_price").sum().alias("rev"), c("charge").sum().alias("charge")))

    tde.device_eval_counters.reset()
    got = build(daft_tpu_torch).to_pydict()
    snap = tde.device_eval_counters.snapshot()
    assert snap["fused_exprs"] >= 2 and snap["fused_rows"] > 0, snap
    assert snap["host_exprs"] == {}, snap
    assert snap["chain_morsels"] == {"filter_project_agg": 1}, snap
    assert snap["program_misses"] == 1 and snap["program_hits"] == 0, snap
    build(daft_tpu_torch).to_pydict()
    snap = tde.device_eval_counters.snapshot()
    assert snap["program_hits"] == 1 and snap["program_misses"] == 1, snap
    with daft_tpu.execution_config_ctx(result_cache_enabled=False):
        want = build(daft_tpu).to_pydict()
    for k in ("rev", "charge"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


# -- one parity case per admitted dtype and fusable op ------------------------
_INT_DTYPES = ["int8", "int16", "int32", "uint8", "uint16", "uint32"]
_NUMERIC_DTYPES = _INT_DTYPES + ["bfloat16", "float32"]
_BINARY = ["add", "sub", "mul", "truediv", "floordiv", "mod", "pow",
           "eq", "ne", "lt", "le", "gt", "ge"]
_OPS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b, "mul": lambda a, b: a * b,
    "truediv": lambda a, b: a / b, "floordiv": lambda a, b: a // b,
    "mod": lambda a, b: a % b, "pow": lambda a, b: a ** b,
    "eq": lambda a, b: a == b, "ne": lambda a, b: a != b, "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b, "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    "and": lambda a, b: a & b, "or": lambda a, b: a | b, "xor": lambda a, b: a ^ b,
}


def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _operands(dtype: str, n: int = 257):
    """Seeded operands of ``dtype``: signed values in [-20, 20], unsigned in
    [0, 40] (so unsigned subtraction wraps), floats with their signs; the
    divisors hold zeros; ``e`` is a small non-negative exponent column."""
    rng = np.random.default_rng(abs(hash(dtype)) % 1000)
    if dtype.startswith("uint"):
        a, b = rng.integers(0, 41, n), rng.integers(0, 41, n)
    elif dtype.startswith("int"):
        a, b = rng.integers(-20, 21, n), rng.integers(-20, 21, n)
    else:
        a, b = rng.standard_normal(n) * 8, rng.standard_normal(n) * 8
        a[:8] = [0.0, -0.0, 1.5, -1.5, 7.0, -7.0, np.inf, -np.inf]
    b[::9] = 0
    e = rng.integers(0, 4, n)
    dt = _np_dtype(dtype)
    return {"a": a.astype(dt), "b": b.astype(dt), "e": e.astype(dt)}


@pytest.mark.parametrize("op", _BINARY)
@pytest.mark.parametrize("dtype", _NUMERIC_DTYPES)
def test_binary_op_parity(dtype, op):
    data = _operands(dtype)
    rhs = "e" if op == "pow" else "b"

    def build(pkg):
        r = _OPS[op](pkg.col("a"), pkg.col(rhs))
        if op == "truediv" and dtype in _INT_DTYPES:
            # Integers divide in f32 on the device; the quotient resolves to
            # f64, which alone would keep it on the host in both packages.
            r = r.cast(pkg.DataType.float32())
        return r.alias("r")

    j, p = _both(data, build)
    tol = (BF16_TOL if dtype == "bfloat16" else F32_TOL) \
        if op == "pow" and dtype in ("bfloat16", "float32") else 0.0
    _assert_equal(j, p, rtol=tol)


@pytest.mark.parametrize("op", ["add", "mul", "floordiv", "mod", "lt", "ge"])
@pytest.mark.parametrize("dtype", _NUMERIC_DTYPES)
def test_python_literal_parity(dtype, op):
    """A Python literal is weakly typed on both paths: it adapts to the
    column's dtype and never widens it."""
    data = _operands(dtype)
    lit = 3 if op in ("add", "mul", "floordiv", "mod") else 2.5
    j, p = _both(data, lambda pkg: _OPS[op](pkg.col("a"), lit).alias("r"))
    _assert_equal(j, p)


@pytest.mark.parametrize("op", ["negate", "abs", "cast_f32", "cast_i32", "cast_u16", "cast_bool"])
@pytest.mark.parametrize("dtype", _NUMERIC_DTYPES)
def test_unary_op_parity(dtype, op):
    data = _operands(dtype)
    if dtype in ("bfloat16", "float32") and op.startswith("cast_"):
        # Out of range, inf and NaN included: XLA's convert saturates.
        data["a"][8:12] = [3e9, -3e9, np.nan, 7e4]

    def build(pkg):
        a = pkg.col("a")
        if op == "negate":
            return (-a).alias("r")
        if op == "abs":
            return a.abs().alias("r")
        target = {"cast_f32": "float32", "cast_i32": "int32", "cast_u16": "uint16",
                  "cast_bool": "bool"}[op]
        return a.cast(getattr(pkg.DataType, target)()).alias("r")

    _assert_equal(*_both(data, build))


@pytest.mark.parametrize("op", ["and", "or", "xor", "eq", "ne", "not"])
def test_bool_op_parity(op):
    rng = np.random.default_rng(1)
    data = {"a": rng.random(200) < 0.5, "b": rng.random(200) < 0.5}
    build = (lambda pkg: (~pkg.col("a")).alias("r")) if op == "not" else \
        (lambda pkg: _OPS[op](pkg.col("a"), pkg.col("b")).alias("r"))
    _assert_equal(*_both(data, build))


@pytest.mark.parametrize("dtype", ["int32", "uint32", "float32"])
def test_if_else_parity(dtype):
    data = _operands(dtype)
    _assert_equal(*_both(data, lambda pkg: (pkg.col("a") > pkg.col("b")).if_else(
        pkg.col("a"), pkg.col("b") * 2).alias("r")))


def test_zero_divisors_and_negative_operands():
    """Integer division by zero and by -1 at the type's extremes, and modulo
    with mixed signs, as XLA through jnp gives them: x // 0 is -2 (x != 0)
    or -1 (x == 0), x % 0 is 0, MIN // -1 is MIN; unsigned x // 0 is the
    type's largest value. torch alone raises on the CPU for a zero divisor."""
    lo = np.iinfo(np.int32).min
    a = np.array([7, -7, 7, -7, 0, lo, lo, 5, -5, 2 ** 31 - 1], dtype=np.int32)
    b = np.array([0, 0, -2, 2, 0, -1, 0, -3, 3, -1], dtype=np.int32)
    for op in ("floordiv", "mod"):
        j, p = _both({"a": a, "b": b}, lambda pkg: _OPS[op](pkg.col("a"), pkg.col("b")).alias("r"))
        _assert_equal(j, p)
    j, p = _both({"a": a, "b": b}, lambda pkg: (pkg.col("a") // 0).alias("r"))
    _assert_equal(j, p)
    assert p.to_pylist() == [-2, -2, -2, -2, -1, -2, -2, -2, -2, -2]
    u = np.array([7, 0, 4294967295], dtype=np.uint32)
    for op in ("floordiv", "mod"):
        _assert_equal(*_both({"a": u, "b": np.zeros(3, np.uint32)},
                             lambda pkg: _OPS[op](pkg.col("a"), pkg.col("b")).alias("r")))


@pytest.mark.parametrize("dtype, literal", [("int32", 3_000_000_000), ("int8", 300),
                                            ("uint32", -1), ("uint8", 256)])
def test_int_literal_beyond_the_operand(dtype, literal):
    """A Python int beyond int32 meeting an integer column: jnp raises while
    tracing and the JAX package takes the host; torch would wrap it
    silently (int32 < 3_000_000_000 would be False), so the port takes the
    host too, which compares exactly. Within int32 but beyond the column's
    own range, the literal wraps into its dtype on both device paths."""
    data = {"a": np.arange(1, 11).astype(dtype)}
    build = lambda pkg: (pkg.col("a") < literal).alias("r")  # noqa: E731
    j, p = _both(data, build)
    if literal >= 1 << 31:
        assert j is None and p is None
        out = daft_tpu_torch.from_pydict(data).select(build(daft_tpu_torch)).to_pydict()["r"]
        assert out == [True] * 10
    else:
        _assert_equal(j, p)


def test_negative_integer_exponent_is_torch_defined():
    """XLA's integer pow with a negative exponent is implementation-defined
    (the JAX package gives arbitrary values on the CPU) and the host raises;
    the port's device path gives torch's: 0 unless the base is 1 or -1."""
    data = {"a": np.array([7, -7, 1, -1, 2], np.int32), "e": np.array([-1, -2, -3, -3, -1], np.int32)}
    rb = _rb(daft_tpu_torch, data)
    out = tde.try_evaluate_fused(rb, [(daft_tpu_torch.col("a") ** daft_tpu_torch.col("e"))._expr])
    assert out[0].to_pylist() == [0, 0, 1, -1, 0]


def test_q06_boundary_literals_compare_in_f32():
    """q06's BETWEEN 0.05 AND 0.07 on an f32 column: the Python literals are
    weakly typed, so both device paths compare in f32, where f32(0.07) <=
    0.07 holds (in f64 it would not: f32(0.07) > 0.07). The rows on the
    bounds and one f32 step to each side are all decided alike."""
    edges = []
    for v in (0.05, 0.06, 0.07):
        f = np.float32(v)
        edges += [np.nextafter(f, np.float32(0)), f, np.nextafter(f, np.float32(1))]
    disc = np.array(edges * 4, dtype=np.float32)
    j, p = _both({"d": disc}, lambda pkg: ((pkg.col("d") >= 0.05) & (pkg.col("d") <= 0.07)).alias("r"))
    _assert_equal(j, p)
    f32_rule = (disc >= np.float32(0.05)) & (disc <= np.float32(0.07))
    assert p.to_pylist() == f32_rule.tolist()
    assert float(np.float32(0.07)) > 0.07 and p.to_pylist()[7]  # f32(0.07) kept


@pytest.mark.parametrize("fn", ["sqrt", "exp", "ln", "sin", "tanh", "log1p", "ceil", "floor",
                                "round", "sign", "clip", "log2_base", "atan2", "is_nan",
                                "is_inf", "not_nan", "elementwise_max", "elementwise_min"])
def test_numeric_kernel_parity(fn):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(300) * 4).astype(np.float32)
    x[:4] = [np.nan, np.inf, -np.inf, 0.0]
    y = (rng.standard_normal(300) * 4).astype(np.float32)
    data = {"x": x if fn not in ("sqrt", "ln", "log1p", "log2_base") else np.abs(x), "y": y}

    def build(pkg):
        c = pkg.col("x")
        if fn == "clip":
            return c.clip(-1.0, 2.0).alias("r")
        if fn == "log2_base":
            return c.log(2.0).alias("r")
        if fn == "atan2":
            return c.atan2(pkg.col("y")).alias("r")
        if fn in ("is_nan", "is_inf", "not_nan"):
            return getattr(c.float, fn)().alias("r")
        if fn.startswith("elementwise"):
            from_mod = daft_tpu_torch if pkg is daft_tpu_torch else daft_tpu
            expr_mod = from_mod.expressions.expr
            return pkg.expressions.Expression(expr_mod.FunctionCall(
                fn, [c._expr, pkg.col("y")._expr])).alias("r")
        return getattr(c, fn)().alias("r")

    # sqrt too differs by an ulp: XLA's CPU sqrt is not correctly rounded.
    exact = fn in ("ceil", "floor", "round", "sign", "clip", "is_nan", "is_inf", "not_nan",
                   "elementwise_max", "elementwise_min")
    _assert_equal(*_both(data, build), rtol=0.0 if exact else F32_TOL)


def test_default_config_raises_without_a_cuda_device(monkeypatch):
    """A fusable projection at device_eval_min_rows with the default config
    (device "cuda") raises where no CUDA device is visible: it never runs on
    the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExecutionConfig()
    n = cfg.device_eval_min_rows
    df = daft_tpu_torch.from_pydict({"x": np.arange(n, dtype=np.float32)})
    with daft_tpu_torch.execution_config_ctx(**vars(cfg)):
        with pytest.raises(DaftValueError, match="no CUDA device"):
            df.with_column("y", daft_tpu_torch.col("x") * 2).to_pydict()
        # Below the floor the host takes it, by the same rule as the JAX package.
        out = df.limit(n - 1).with_column("y", daft_tpu_torch.col("x") * 2).to_pydict()
        assert out["y"][:3] == [0.0, 2.0, 4.0]
