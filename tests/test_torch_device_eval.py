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

import zlib

import ml_dtypes
import numpy as np
import pyarrow as pa
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


def _assert_equal(jax_s, port_s, rtol=0.0, atol=0.0):
    assert jax_s is not None, "the JAX package's device path did not take the expression"
    assert port_s is not None, "the port's device path did not take the expression"
    assert repr(jax_s.dtype) == repr(port_s.dtype)
    jv, jm = jax_s.to_numpy_masked()
    pv, pm = port_s.to_numpy_masked()
    assert (jm is None) == (pm is None) and (jm is None or np.array_equal(jm, pm))
    if jv.dtype == ml_dtypes.bfloat16:
        jv, pv = jv.astype(np.float32), pv.astype(np.float32)
    if rtol or atol:
        np.testing.assert_allclose(pv, jv, rtol=rtol, atol=atol, equal_nan=True)
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
    # Through the engine, a Kleene or that SimplifyExpressions cannot fold
    # away (``p | True`` folds to True before the device layer sees it).
    c = daft_tpu_torch.col
    got = daft_tpu_torch.from_pydict({"p": xs, "v": np.float32(data["v"])}).select(
        (c("p") | (c("v") > 0)).alias("k")).to_pydict()["k"]
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
    rng = np.random.default_rng(zlib.crc32(dtype.encode()) % 1000)
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


def _assert_same_bits(jax_s, port_s):
    """Equal bit for bit, the signs of zeros included; NaN matches NaN."""
    jv, pv = (s.to_numpy().astype(np.float32) for s in (jax_s, port_s))
    nan = np.isnan(jv)
    np.testing.assert_array_equal(np.isnan(pv), nan)
    np.testing.assert_array_equal(pv[~nan].view(np.uint32), jv[~nan].view(np.uint32))


def test_bf16_floordiv_rounds_each_divmod_step():
    """jnp.floor_divide on floats is CPython's divmod, each step rounded in
    the operands' dtype: in bf16, -17.875 // -0.142578125 is 126 (one
    rounding of the quotient gives 125)."""
    a = np.array([-17.875, 1.0], dtype=ml_dtypes.bfloat16)
    b = np.array([-0.142578125, 0.0], dtype=ml_dtypes.bfloat16)
    j, p = _both({"a": a, "b": b}, lambda pkg: (pkg.col("a") // pkg.col("b")).alias("r"))
    _assert_same_bits(j, p)
    assert float(p.to_numpy()[0]) == 126.0
    assert np.isnan(float(p.to_numpy()[1]))  # x // 0.0 is NaN, as jnp's fmod gives it


@pytest.mark.parametrize("op", ["floordiv", "mod"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_float_divmod_sweep_is_bit_equal(dtype, op):
    """100,000 seeded float pairs (zeros of both signs, infinities and zero
    divisors among them): ``//`` and ``%`` equal the JAX device path bit for
    bit."""
    n = 100_000
    rng = np.random.default_rng(zlib.crc32(f"{dtype}-{op}".encode()))
    a, b = rng.standard_normal(n) * 8, rng.standard_normal(n) * 8
    a[:8] = [0.0, -0.0, 1.5, -1.5, 7.0, -7.0, np.inf, -np.inf]
    b[::9], b[1::90] = 0.0, -0.0
    dt = _np_dtype(dtype)
    j, p = _both({"a": a.astype(dt), "b": b.astype(dt)},
                 lambda pkg: _OPS[op](pkg.col("a"), pkg.col("b")).alias("r"))
    _assert_same_bits(j, p)


def test_f32_subnormals_are_kept_as_the_host_keeps_them():
    """f32 subnormals (3e-39, and 1e-20 squared): the port's device path
    keeps them, as the JAX package's host path does; XLA's CPU device path
    flushes them to zero on input and output (``d * 2.0`` is 0 there, and
    ``d > 0.0`` False). ``d + 0.0`` is equal on every path."""
    n = 4096
    data = {"d": np.full(n, 3e-39, np.float32), "s": np.full(n, 1e-20, np.float32)}
    exprs = {"d2": lambda pkg: pkg.col("d") * 2.0, "pos": lambda pkg: pkg.col("d") > 0.0,
             "ss": lambda pkg: pkg.col("s") * pkg.col("s"), "d0": lambda pkg: pkg.col("d") + 0.0}
    want = {"d2": np.float32(3e-39) * np.float32(2), "pos": True,
            "ss": np.float32(1e-20) * np.float32(1e-20), "d0": np.float32(3e-39)}
    assert 0 < want["ss"] < np.finfo(np.float32).tiny  # the product is subnormal
    rb = _rb(daft_tpu_torch, data)
    with daft_tpu.execution_config_ctx(device_eval=False, compiled_eval_enabled=False,
                                       result_cache_enabled=False):
        host = daft_tpu.from_pydict(data).select(
            *[f(daft_tpu).alias(k) for k, f in exprs.items()]).to_pydict()
    for k, f in exprs.items():
        port = tde.try_evaluate_fused(rb, [f(daft_tpu_torch).alias(k)._expr])[0].to_numpy()
        np.testing.assert_array_equal(port, np.full(n, want[k]))
        np.testing.assert_array_equal(port, np.asarray(host[k], port.dtype))
    j, p = _both(data, exprs["d0"])
    _assert_equal(j, p)


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


# The extended_ops lowerings (kernels/extended_ops.py): name -> (build, rtol).
# Exact where the port computes what XLA computes (a scale by an f32
# constant, negation, jnp.mod, bitwise ops); rtol 1e-6 for the libm functions
# and jnp.hypot's formula against torch.hypot. cosine_similarity is held at
# atol 1e-6 instead: a value in [-1, 1] from f32 dot products summed in
# another order cancels near 0, where no relative tolerance holds.
_EXT_DATA_SEED = 5
_EXTENDED = {
    "csc": (lambda p: p.col("x").csc(), F32_TOL),
    "sec": (lambda p: p.col("x").sec(), F32_TOL),
    "cot": (lambda p: p.col("x").cot(), F32_TOL),
    "atanh": (lambda p: p.col("t").arctanh(), F32_TOL),
    "acosh": (lambda p: p.col("a").arccosh(), F32_TOL),
    "asinh": (lambda p: p.col("x").arcsinh(), F32_TOL),
    "radians": (lambda p: p.col("x").radians(), 0.0),
    "degrees": (lambda p: p.col("x").degrees(), 0.0),
    "negate": (lambda p: p.col("i").negate(), 0.0),
    "negate_uint16": (lambda p: p.col("u").negate(), 0.0),
    "hypot": (lambda p: p.col("x").hypot(p.col("y")), F32_TOL),
    "pmod": (lambda p: p.col("i").pmod(p.col("j")), 0.0),
    "pmod_float": (lambda p: p.col("x").pmod(p.col("y")), 0.0),
    "bitwise_and": (lambda p: p.col("i").bitwise_and(p.col("j")), 0.0),
    "bitwise_or": (lambda p: p.col("i").bitwise_or(p.col("j")), 0.0),
    "bitwise_xor": (lambda p: p.col("i").bitwise_xor(p.col("j")), 0.0),
    "bitwise_not": (lambda p: p.col("i").bitwise_not(), 0.0),
    "bitwise_not_uint16": (lambda p: p.col("u").bitwise_not(), 0.0),
    # f64 out: only inside a 32-bit expression does the device take it.
    "cosine_similarity": (lambda p: p.col("e").embedding.cosine_similarity(p.col("q"))
                          .cast(p.DataType.float32()), 0.0),
}


def _extended_data(pkg):
    """300 seeded rows: f32 operands with zeros among the divisors of pmod,
    int32 operands in -50..50 and -5..5 (zeros included), uint16, and 16-wide
    f32 embeddings."""
    rng = np.random.default_rng(_EXT_DATA_SEED)
    x = (rng.standard_normal(300) * 4).astype(np.float32)
    y = (rng.standard_normal(300) * 4).astype(np.float32)
    y[:5] = 0.0
    emb = pkg.DataType.embedding(pkg.DataType.float32(), 16)
    cols = {"x": x, "y": y, "a": np.abs(x) + np.float32(1), "t": np.tanh(x) * np.float32(0.99),
            "i": rng.integers(-50, 50, 300).astype(np.int32),
            "j": rng.integers(-5, 6, 300).astype(np.int32),
            "u": rng.integers(0, 60000, 300).astype(np.uint16)}
    rb = {k: pkg.Series.from_numpy(v, k) for k, v in cols.items()}
    for k in ("e", "q"):
        rb[k] = pkg.Series.from_numpy(rng.standard_normal((300, 16)).astype(np.float32), k, emb)
    return pkg.RecordBatch.from_pydict(rb)


def _check_extended(fn):
    """The JAX package's device route and the port's take the kernel alike and
    agree at the stated tolerance; pmod by 0 gives jnp.mod's values there
    (0, NaN), not the host's null (ROADMAP C.26)."""
    build, rtol = _EXTENDED[fn]
    j, p = [_fused(pkg, _extended_data(pkg), lambda q: build(q).alias("r")) for pkg in PKGS]
    _assert_equal(j, p, rtol=rtol, atol=F32_TOL if fn == "cosine_similarity" else 0.0)
    if fn.startswith("pmod"):
        vals, mask = p.to_numpy_masked()
        assert mask is None
        zero = _extended_data(daft_tpu_torch).get_column("j" if fn == "pmod" else "y").to_numpy() == 0
        assert zero.any()
        assert (vals[zero] == 0).all() if fn == "pmod" else np.isnan(vals[zero]).all()
    if fn == "cosine_similarity":
        # Alone it resolves to f64: both device paths leave it to the host.
        tde.device_eval_counters.reset()
        assert [_fused(pkg, _extended_data(pkg), lambda q: q.col("e").embedding
                       .cosine_similarity(q.col("q")).alias("r")) for pkg in PKGS] == [None, None]
        assert tde.device_eval_counters.snapshot()["host_exprs"] == {"dtype_64bit": 1}


@pytest.mark.parametrize("fn", sorted(_EXTENDED))
def test_extended_ops_route_nullable_inputs_to_the_host(fn):
    """None of the extended_ops kernels has the same rules on both paths, so a
    nullable input they read (the last row of every column is null) sends them to the host on both device paths
    (counted as ``nullable_unsafe``), and the two hosts agree bit for bit."""
    build, _ = _EXTENDED[fn]
    rbs = []
    for pkg in PKGS:
        rb = _extended_data(pkg)
        masked = [pkg.Series.from_arrow(
            pa.array(c.to_arrow().to_pylist()[:-1] + [None], c.to_arrow().type), c.name, c.dtype)
            for c in rb.columns()]
        rbs.append(pkg.RecordBatch.from_pydict({c.name: c for c in masked}))
    tde.device_eval_counters.reset()
    assert [_fused(pkg, rb, lambda q: build(q).alias("r")) for pkg, rb in zip(PKGS, rbs)] == \
        [None, None]
    assert tde.device_eval_counters.snapshot()["host_exprs"] == {"nullable_unsafe": 1}
    with daft_tpu.execution_config_ctx(device_eval=False), \
            daft_tpu_torch.execution_config_ctx(device_eval=False):
        j, p = [rb.eval_expression_list([build(pkg).alias("r")._expr]).get_column("r")
                for pkg, rb in zip(PKGS, rbs)]
    assert repr(j.dtype) == repr(p.dtype)
    # Null for all but cosine_similarity, whose host impl reads a null row as
    # zeros in both packages (0.0 there).
    assert j.to_pylist()[-1] == p.to_pylist()[-1]
    assert (p.to_pylist()[-1] is None) == (fn != "cosine_similarity")
    np.testing.assert_array_equal(*(np.asarray(s.to_pylist()[:-1], dtype=np.float64)
                                    for s in (j, p)))


def _kernel_call(pkg, fn, *names):
    """``fn`` over columns ``names`` as a bare registry FunctionCall."""
    expr_mod = (daft_tpu_torch if pkg is daft_tpu_torch else daft_tpu).expressions.expr
    return pkg.expressions.Expression(expr_mod.FunctionCall(fn, [pkg.col(n)._expr for n in names]))


# Integer kernels over operands of mixed signedness, by kernel and operand
# columns: int32 "k" in -200000..200000 (negatives and values past 16 bits),
# uint16 "u" and uint32 "w" (values past 2**31). The operands meet in jnp's
# promoted class (int32 when a signed one is among them, a uint32 lane
# wrapping); only an all-unsigned result wraps to its lane. Exact.
_MIXED = {
    "bitwise_or_i32_u16": ("bitwise_or", "k", "u"),
    "bitwise_xor_i32_u16": ("bitwise_xor", "k", "u"),
    "bitwise_and_u16_i32": ("bitwise_and", "u", "k"),
    "bitwise_or_u32_u16": ("bitwise_or", "w", "u"),
    "elementwise_min_i32_u16": ("elementwise_min", "k", "u"),
    "elementwise_max_i32_u16": ("elementwise_max", "k", "u"),
    "elementwise_max_u32_u16": ("elementwise_max", "w", "u"),
}


def _check_mixed(case):
    rng = np.random.default_rng(7)
    data = {"k": rng.integers(-200_000, 200_000, 300).astype(np.int32),
            "u": rng.integers(0, 1 << 16, 300).astype(np.uint16),
            "w": rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)}
    data["k"][:3] = [-5, 100_000, -1]
    data["u"][:3] = [1, 5, 3]
    fn, *names = _MIXED[case]
    _assert_equal(*_both(data, lambda pkg: _kernel_call(pkg, fn, *names).alias("r")))


def test_sqrt_f32_on_a_cpu_tensor_equals_numpy_bit_for_bit():
    """The port's f32 ``sqrt`` lowering on a CPU tensor is correctly rounded:
    it equals ``np.sqrt`` on 100,000 values of |N(0, 4^2)| (seed 2), where a
    bare ``torch.sqrt`` is one ulp off on some of them."""
    from daft_tpu_torch.kernels.registry import get_kernel

    x = np.abs(np.random.default_rng(2).standard_normal(100_000) * 4).astype(np.float32)
    got = get_kernel("sqrt").torch_fn([torch.from_numpy(x)])
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))


@pytest.mark.parametrize("fn", ["sqrt", "exp", "ln", "sin", "tanh", "log1p", "ceil", "floor",
                                "round", "sign", "clip", "log2_base", "atan2", "is_nan",
                                "is_inf", "not_nan", "elementwise_max", "elementwise_min",
                                "round_1", "round_2", *sorted(_EXTENDED), *sorted(_MIXED)])
def test_numeric_kernel_parity(fn):
    if fn.startswith("round_"):
        return _check_round_decimals(int(fn[-1]))
    if fn in _EXTENDED:
        return _check_extended(fn)
    if fn in _MIXED:
        return _check_mixed(fn)
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
            return _kernel_call(pkg, fn, "x", "y").alias("r")
        return getattr(c, fn)().alias("r")

    # sqrt is correctly rounded on both sides (XLA's CPU sqrt, and the
    # port's f64-then-f32 sqrt on a CPU tensor), so it is held bit for bit.
    exact = fn in ("sqrt", "ceil", "floor", "round", "sign", "clip", "is_nan", "is_inf",
                   "not_nan", "elementwise_max", "elementwise_min")
    _assert_equal(*_both(data, build), rtol=0.0 if exact else F32_TOL)


def _check_round_decimals(decimals: int):
    """``round(decimals)`` on 4096 f32 values, N(0, 100**2): the port's
    device path equals the host (Arrow, half to even) bit for bit. XLA's
    ``jnp.round(x, decimals)`` scales, rounds and unscales, so the JAX
    device path is one f32 step off the host on about a quarter of the
    rows; the port matches the host, not it."""
    x = (np.random.default_rng(0).standard_normal(4096) * 100).astype(np.float32)
    build = lambda pkg: pkg.col("x").round(decimals).alias("r")  # noqa: E731
    j, p = _both({"x": x}, build)
    with daft_tpu.execution_config_ctx(device_eval=False, compiled_eval_enabled=False,
                                       result_cache_enabled=False):
        host = np.asarray(daft_tpu.from_pydict({"x": x}).select(build(daft_tpu))
                          .to_pydict()["r"], np.float32)
    np.testing.assert_array_equal(p.to_numpy(), host)
    np.testing.assert_array_max_ulp(j.to_numpy(), host, maxulp=1)


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


def test_pinned_staging_is_bounded_and_reset_programs_frees_it(monkeypatch):
    """Staging holds one buffer per (slot, dtype), grown to the largest
    morsel the slot staged; a smaller morsel is a view of its front, and
    ``reset_programs`` drops every buffer. Pinning needs a CUDA device, so
    the bookkeeping runs on unpinned buffers here."""
    pinned = tde._Pinned(pin_memory=False)
    monkeypatch.setattr(tde, "_PINNED", pinned)
    f32, i16 = np.dtype(np.float32), np.dtype(np.int16)
    for rows in (1024, 4096, 512, 4096, 2048):
        assert pinned.get("a", (rows,), f32).shape == (rows,)
        assert pinned.get("e", (rows, 8), f32).shape == (rows, 8)
    pinned.get("a", (300,), i16)
    assert tde.pinned_bytes() == 4096 * 4 + 4096 * 8 * 4 + 300 * 2
    assert pinned.get("a", (16,), f32).data_ptr() == pinned.get("a", (4096,), f32).data_ptr()
    tde.reset_programs()
    assert tde.pinned_bytes() == 0
