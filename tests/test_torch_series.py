"""The port's ``Series`` (``daft_tpu_torch/series.py``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_series.py`` case for case: each case builds the same
Series in both packages and must give the JAX package's values (bit for bit:
both compute on the host with Arrow and numpy) and the value that the JAX
test asserts. Left out: ``to_jax`` / ``from_jax`` (``test_series.py:78-98``);
the embedding and bfloat16 cases keep their other checks.
"""

import numpy as np
import pytest

import daft_tpu.datatype
import daft_tpu.series
import daft_tpu_torch.datatype
import daft_tpu_torch.series

SIDES = ((daft_tpu.series.Series, daft_tpu.datatype.DataType),
         (daft_tpu_torch.series.Series, daft_tpu_torch.datatype.DataType))


def _both(build):
    """``build(Series, DataType)`` in the port, held equal to the JAX
    package's."""
    jax, port = (build(S, D) for S, D in SIDES)
    assert port == jax
    return port


def test_from_pylist_infer():
    out = _both(lambda S, D: (lambda s: (repr(s.dtype), s.dtype == D.int64(), s.to_pylist(),
                                         s.null_count()))(S.from_pylist([1, 2, None])))
    assert out[1:] == (True, [1, 2, None], 1)


def test_arithmetic():
    def run(S, D):
        a = S.from_pylist([1, 2, 3], "a")
        b = S.from_pylist([10, 20, 30], "b")
        return ((a + b).to_pylist(), (b / a).to_pylist(), (b % a).to_pylist(),
                (a ** b.cast(D.int64())).to_pylist()[0])

    assert _both(run) == ([11, 22, 33], [10.0, 10.0, 10.0], [0, 0, 0], 1)


def test_string_concat_add():
    out = _both(lambda S, D: (S.from_pylist(["x", "y"], "a")
                              + S.from_pylist(["1", "2"], "b")).to_pylist())
    assert out == ["x1", "y2"]


def test_comparison_and_logic():
    def run(S, D):
        m = S.from_pylist([1, 2, 3], "a").gt(S.from_pylist([2, 2, 2]))
        return m.to_pylist(), m.not_().to_pylist()

    assert _both(run) == ([False, False, True], [True, True, False])


def test_filter_take_slice():
    def run(S, D):
        a = S.from_pylist([1, 2, 3, 4], "a")
        mask = S.from_pylist([True, False, True, False])
        return a.filter(mask).to_pylist(), a.take([3, 0]).to_pylist(), a.slice(1, 2).to_pylist()

    assert _both(run) == ([1, 3], [4, 1], [2, 3])


def test_cast():
    def run(S, D):
        a = S.from_pylist([1, 2], "a")
        return a.cast(D.float32()).dtype == D.float32(), a.cast(D.string()).to_pylist()

    assert _both(run) == (True, ["1", "2"])


def test_sort_argsort():
    def run(S, D):
        a = S.from_pylist([3, 1, None, 2], "a")
        return a.sort().to_pylist(), a.sort(descending=True).to_pylist()

    assert _both(run) == ([1, 2, 3, None], [None, 3, 2, 1])


def test_aggs():
    def run(S, D):
        a = S.from_pylist([1.0, 2.0, 3.0, None], "a")
        return [a.sum().to_pylist(), a.mean().to_pylist(), a.min().to_pylist(),
                a.max().to_pylist(), a.count().to_pylist(), a.count("all").to_pylist()]

    assert _both(run) == [[6.0], [2.0], [1.0], [3.0], [3], [4]]


def test_hash_deterministic():
    def run(S, D):
        h1 = S.from_pylist(["foo", "bar", None], "a").hash().to_pylist()
        h2 = S.from_pylist(["foo", "bar", None], "a").hash().to_pylist()
        ints = S.from_pylist([1, 2, 1]).hash().to_pylist()
        return h1, h2, ints

    h1, h2, ints = _both(run)  # the port's hashes are the JAX package's
    assert h1 == h2 and h1[0] != h1[1]
    assert ints[0] == ints[2] and ints[0] != ints[1]


def test_embedding_roundtrip():
    data = np.arange(8, dtype=np.float32).reshape(2, 4)
    outs = []
    for S, D in SIDES:
        emb = D.embedding(D.float32(), 4)
        s = S.from_numpy(data, "e", emb)
        assert s.dtype == emb
        outs.append(s.to_numpy())
    np.testing.assert_array_equal(outs[1], data)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_bfloat16_series():
    def run(S, D):
        s = S.from_pylist([1.5, 2.5, None], "b", D.bfloat16())
        return s.dtype == D.bfloat16(), s.to_pylist()

    ok, vals = _both(run)
    assert ok and vals[0] == 1.5 and vals[2] is None


def test_tensor_series():
    rows = [np.ones((2, 2), dtype=np.float32), None, np.zeros((2, 2), dtype=np.float32)]
    outs = [S.from_pylist(rows, "t", D.tensor(D.float32(), (2, 2))).to_pylist()
            for S, D in SIDES]
    for jax_row, port_row, want in zip(outs[0], outs[1], rows):
        if want is None:
            assert jax_row is None and port_row is None
        else:
            np.testing.assert_array_equal(port_row, want)
            np.testing.assert_array_equal(port_row, jax_row)
            assert port_row.dtype == jax_row.dtype


def test_if_else():
    out = _both(lambda S, D: S.from_pylist([True, False, True]).if_else(
        S.from_pylist([1, 1, 1]), S.from_pylist([0, 0, 0])).to_pylist())
    assert out == [1, 0, 1]


def test_is_in():
    out = _both(lambda S, D: S.from_pylist([1, 2, 3]).is_in(S.from_pylist([2, 3])).to_pylist())
    assert out == [False, True, True]


def test_concat():
    def run(S, D):
        out = S.concat([S.from_pylist([1, 2]), S.from_pylist([3.0])])
        return out.dtype == D.float64(), out.to_pylist()

    assert _both(run) == (True, [1.0, 2.0, 3.0])


@pytest.mark.parametrize("values", [
    [1.5, None, -0.0, float("nan")],
    ["a", None, "ümlaut", ""],
    [[1, 2], None, []],
])
def test_values_round_trip_through_arrow_as_in_the_jax_package(values):
    """Floats with NaN and -0.0, strings and lists through ``to_arrow`` and
    back: the port's Arrow arrays hold the JAX package's type and values
    (their reprs tell -0.0 and NaN apart, which Arrow's ``equals`` does not
    for NaN)."""
    outs = [S.from_arrow(S.from_pylist(values, "v").to_arrow(), "v").to_arrow()
            for S, _ in SIDES]
    assert outs[1].type == outs[0].type
    assert repr(outs[1].to_pylist()) == repr(outs[0].to_pylist())
