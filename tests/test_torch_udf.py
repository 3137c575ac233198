"""The port's UDF decorators (``daft_tpu_torch/udf``) against the JAX
package's, on the CPU.

Each case builds the same UDF in both packages (``device="cpu"`` for the
port) over the same seeded data and must give the JAX package's rows, its
errors and its plans: the return dtypes inferred from annotations,
``func.batch`` over every output type the port coerces, retries with their
backoff (``max_retries`` <= 2: the first wait is 0.25 s), ``on_error``
(ROADMAP C.42: ``"null"`` nulls every row of the morsel that holds a failing
row, in both packages), the stateful ``cls`` / ``method`` UDFs,
``Expression.apply`` and a row-wise UDF inside a filter, an aggregation's
input and ``with_columns``, planned by ``SplitUDFs`` as the JAX package
plans it. Exact equality throughout: every path runs on the host.
"""

import warnings

import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.errors import DaftExecutionError as JExecutionError
from daft_tpu.errors import DaftValueError as JValueError
from daft_tpu_torch.errors import DaftExecutionError, DaftNotImplementedError, DaftValueError

PKGS = (daft_tpu, daft_tpu_torch)


@pytest.fixture(autouse=True)
def _cpu():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        with daft_tpu.execution_config_ctx(result_cache_enabled=False), \
                daft_tpu_torch.execution_config_ctx(device="cpu", result_cache_enabled=False):
            yield


def _both(build):
    """``build(pkg)`` in the port, held equal to the JAX package's."""
    jax, port = (build(pkg) for pkg in PKGS)
    assert port == jax
    return port


def _seeded(n: int = 64, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"i": [None if k % 7 == 3 else int(x) for k, x in enumerate(rng.integers(-50, 50, n))],
            "f": [float(x) for x in rng.standard_normal(n)],
            "s": [str(x) for x in rng.choice(["ant", "bee", "", "ümlaut"], n)],
            "g": [int(x) for x in rng.integers(0, 4, n)]}


# -- return dtypes -----------------------------------------------------------
def _ret_int(x) -> int:
    return 0 if x is None else x * 2


def _ret_float(x) -> float:
    return 0.5 if x is None else x / 4


def _ret_str(x) -> str:
    return "null" if x is None else f"<{x}>"


def _ret_bool(x) -> bool:
    return x is not None and x > 0


def _ret_bytes(x) -> bytes:
    return b"" if x is None else str(x).encode()


@pytest.mark.parametrize("fn", [_ret_int, _ret_float, _ret_str, _ret_bool, _ret_bytes],
                         ids=["int", "float", "str", "bool", "bytes"])
def test_return_dtype_inferred_from_annotation(fn):
    def run(pkg):
        udf = pkg.udf.func(fn)
        df = pkg.from_pydict(_seeded()).select(udf(pkg.col("i")).alias("o"))
        return repr(df.schema["o"].dtype), df.to_pydict()

    _both(run)


def test_return_dtype_needs_an_annotation_or_a_dtype():
    def plain(x):
        return x

    for pkg, err in ((daft_tpu, JValueError), (daft_tpu_torch, DaftValueError)):
        with pytest.raises(err, match="needs an explicit return_dtype"):
            pkg.udf.func(plain)
        with pytest.raises(err, match="needs an explicit return_dtype"):
            pkg.udf.func.batch(plain)


# -- func.batch output types -----------------------------------------------------
_OUTPUTS = {
    "numpy": lambda pkg, s: s.to_numpy() * 3,
    "arrow": lambda pkg, s: pa.array(s.to_numpy() * 3),
    "list": lambda pkg, s: [v * 3 for v in s.to_pylist()],
    "series": lambda pkg, s: pkg.Series.from_numpy(s.to_numpy() * 3, "x"),
    # The JAX package has no torch branch: it gets the same values as numpy.
    "torch": lambda pkg, s: (torch.from_numpy(s.to_numpy() * 3) if pkg is daft_tpu_torch
                             else s.to_numpy() * 3),
}


@pytest.mark.parametrize("kind", list(_OUTPUTS))
def test_batch_udf_output_types(kind):
    def run(pkg):
        @pkg.udf.func.batch(return_dtype=pkg.DataType.float64())
        def triple(s):
            return _OUTPUTS[kind](pkg, s)

        return pkg.from_pydict({"f": _seeded()["f"]}).select(triple(pkg.col("f"))).to_pydict()

    out = _both(run)
    np.testing.assert_array_equal(out["f"], np.asarray(_seeded()["f"]) * 3)


def test_batch_udf_output_of_another_type_raises():
    @daft_tpu_torch.udf.func.batch(return_dtype=daft_tpu_torch.DataType.int64())
    def bad(s):
        return {"not": "a column"}

    with pytest.raises(DaftExecutionError, match="unsupported type"):
        daft_tpu_torch.from_pydict({"a": [1]}).select(bad(daft_tpu_torch.col("a"))).to_pydict()


# -- retries and on_error ------------------------------------------------------------
def test_max_retries_fails_once_then_succeeds():
    def run(pkg):
        calls = []

        @pkg.udf.func(return_dtype=pkg.DataType.int64(), max_retries=1)
        def flaky(x):
            calls.append(x)
            if len(calls) == 1:
                raise RuntimeError("transient")
            return x + 1

        out = pkg.from_pydict({"a": [1, 2, 3]}).select(flaky(pkg.col("a"))).to_pydict()
        return out, calls

    out, calls = _both(run)
    assert out == {"a": [2, 3, 4]} and calls[0] == 1


@pytest.mark.parametrize("morsel, dynamic", [(2, False), (3, True), (None, True)],
                         ids=["morsels_of_2", "morsels_of_3_dynamic", "default_dynamic"])
def test_on_error_null_nulls_the_morsel_of_a_failing_row(morsel, dynamic):
    """ROADMAP C.42: the whole morsel is retried and nulled, so the rows that
    come out null are those that share a morsel with a failing row; with the
    same morsel boundaries (the port's dynamic batching is the JAX
    package's) the port's rows are the JAX package's."""
    def run(pkg):
        @pkg.udf.func(return_dtype=pkg.DataType.int64(), on_error="null")
        def tens(x):
            if x % 5 == 2:
                raise ValueError(f"row {x}")
            return x * 10

        cfg = {"udf_dynamic_batching": dynamic}
        if morsel:
            cfg["default_morsel_size"] = morsel
        with pkg.execution_config_ctx(**cfg):
            return pkg.from_pydict({"x": list(range(20))}).select(tens(pkg.col("x"))).to_pydict()

    out = _both(run)["x"]
    assert all(v is None or v == 10 * i for i, v in enumerate(out))
    assert all(out[i] is None for i in range(2, 20, 5))
    # Rows that did not fail, nulled with their morsel, and rows kept.
    assert any(out[i] is None for i in range(20) if i % 5 != 2)
    assert any(v is not None for v in out)


def test_on_error_raise_names_the_attempts():
    for pkg, err in ((daft_tpu, JExecutionError), (daft_tpu_torch, DaftExecutionError)):
        @pkg.udf.func(return_dtype=pkg.DataType.int64(), max_retries=1)
        def boom(x):
            raise ValueError("always")

        with pytest.raises(err, match=r"'boom' failed after 2 attempts: always"):
            pkg.from_pydict({"a": [1, 2]}).select(boom(pkg.col("a"))).to_pydict()


# -- stateful classes ------------------------------------------------------------
def _counting_cls(pkg, built: list, **options):
    @pkg.udf.cls(**options)
    class Offset:
        def __init__(self, k):
            built.append(k)
            self.k = k

        @pkg.udf.method(return_dtype=pkg.DataType.int64())
        def add(self, x):
            return None if x is None else x + self.k

        @pkg.udf.method.batch(return_dtype=pkg.DataType.float64())
        def scale(self, s):
            return s.to_numpy() * self.k

    return Offset


def test_cls_instance_is_built_once():
    def run(pkg):
        built = []
        inst = _counting_cls(pkg, built)(7)
        assert built == []  # lazily, on first use
        with pkg.execution_config_ctx(default_morsel_size=8):
            out = pkg.from_pydict(_seeded()).select(inst.add(pkg.col("i")).alias("a"),
                                                    inst.scale(pkg.col("f")).alias("s")).to_pydict()
        return out, built

    out, built = _both(run)
    # One instance per endpoint, each built once over every morsel.
    assert built == [7, 7]
    assert out["a"] == [None if v is None else v + 7 for v in _seeded()["i"]]


def test_cls_max_concurrency_2_gives_the_rows_of_1():
    def run(pkg, conc):
        inst = _counting_cls(pkg, [], max_concurrency=conc)(3)
        with pkg.execution_config_ctx(default_morsel_size=8):
            return pkg.from_pydict(_seeded(256)).select(inst.add(pkg.col("i"))).to_pydict()

    for conc in (1, 2):
        assert run(daft_tpu_torch, conc) == run(daft_tpu, conc) == run(daft_tpu_torch, 1)


def test_cls_bare_call_endpoint_and_the_error_without_one():
    def run(pkg):
        @pkg.udf.cls
        class Upper:
            @pkg.udf.method(return_dtype=pkg.DataType.string())
            def __call__(self, s):
                return s.upper()

        return pkg.from_pydict({"s": ["ab", "ümlaut"]}).select(Upper()(pkg.col("s"))).to_pydict()

    assert _both(run) == {"s": ["AB", "ÜMLAUT"]}
    for pkg, err in ((daft_tpu, JValueError), (daft_tpu_torch, DaftValueError)):
        inst = _counting_cls(pkg, [])(1)
        with pytest.raises(err, match="Offset has no @daft.method-decorated __call__"):
            inst(pkg.col("a"))
        with pytest.raises(AttributeError):
            inst.missing


def test_method_batch_takes_series():
    def run(pkg):
        inst = _counting_cls(pkg, [])(2)
        return pkg.from_pydict({"f": _seeded()["f"]}).select(inst.scale(pkg.col("f"))).to_pydict()

    np.testing.assert_array_equal(_both(run)["f"], np.asarray(_seeded()["f"]) * 2)


def test_pickled_stateful_method_drops_its_instance():
    """A pickled endpoint (as a process boundary would send it: cloudpickle,
    since the class is defined in a function) comes without its instance and
    builds its own on first use."""
    import cloudpickle

    built = []
    udf = _counting_cls(daft_tpu_torch, built)(5).add
    assert udf._get_instance().k == 5 and built == [5]
    assert udf.__getstate__()["_instance"] is None and "_lock" not in udf.__getstate__()
    copy = cloudpickle.loads(cloudpickle.dumps(udf))
    assert copy._instance is None and udf._instance is not None
    assert copy._get_instance().k == 5 and copy._get_instance() is not udf._get_instance()
    assert copy._lock is not udf._lock and built == [5]


# -- apply, options --------------------------------------------------------------
def test_apply_over_nulls():
    out = _both(lambda pkg: pkg.from_pydict(_seeded()).select(
        pkg.col("i").apply(lambda v: None if v is None else -v, pkg.DataType.int64()).alias("n"),
        pkg.col("s").apply(len, pkg.DataType.int64()).alias("l")).to_pydict())
    assert out["n"] == [None if v is None else -v for v in _seeded()["i"]]


def test_chips_per_replica_names_its_item():
    from daft_tpu_torch.udf import Udf

    # Accepted and recorded since A.10; its slots are CUDA devices, so without
    # one the query raises naming them.
    slotted = Udf(abs, daft_tpu_torch.DataType.int64(), chips_per_replica=2)
    assert slotted.chips_per_replica == 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DaftValueError, match="no CUDA device is visible"):
            daft_tpu_torch.from_pydict({"a": [-1]}).select(
                slotted(daft_tpu_torch.col("a"))).to_pydict()
    udf = daft_tpu_torch.udf.func(return_dtype=daft_tpu_torch.DataType.int64(), gpus=1,
                                  use_process=True, memory_bytes=1 << 20)(abs)
    assert (udf.gpus, udf.use_process, udf.memory_bytes) == (1, True, 1 << 20)
    assert udf.with_concurrency(3).max_concurrency == 3 and udf.max_concurrency is None


# -- planning -----------------------------------------------------------------------
def _signature(plan) -> list:
    """Each node's type and, for a UDFProject, its expression, in order."""
    out = []
    for node in plan.walk():
        udf_expr = getattr(node, "udf_expr", None)
        out.append((type(node).__name__, repr(udf_expr) if udf_expr is not None else ""))
    return out


@pytest.mark.parametrize("query", ["where", "groupby", "with_columns"])
def test_rowwise_udf_is_split_as_the_jax_package_splits_it(query):
    def run(pkg):
        @pkg.udf.func(return_dtype=pkg.DataType.int64())
        def bucket(x):
            return None if x is None else x % 3

        c = pkg.col
        df = pkg.from_pydict(_seeded())
        q = {"where": lambda: df.where(bucket(c("i")) == 1).select("i", "g"),
             "groupby": lambda: df.with_column("b", bucket(c("i"))).groupby("g")
             .agg(c("b").sum().alias("bs")).sort("g"),
             "with_columns": lambda: df.with_columns({"b": bucket(c("i")), "h": c("g") + 1})}[query]()
        opt = import_optimizer(pkg)().optimize(q._builder.plan)
        return _signature(opt), q.to_pydict()

    sig, _ = _both(run)
    # A projected UDF gets a UDFProject of its own; one inside a filter's
    # predicate stays in the Filter, in both packages.
    assert any(kind == "UDFProject" for kind, _ in sig) == (query != "where")


def import_optimizer(pkg):
    from importlib import import_module

    return import_module(f"{pkg.__name__}.logical.optimizer").Optimizer
