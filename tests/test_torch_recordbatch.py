"""The port's ``RecordBatch`` and ``MicroPartition`` against the JAX
package's, on the CPU.

Mirrors ``tests/test_recordbatch.py`` case for case: each case runs on the
same batch in both packages (expressions built with each package's ``col``)
and must give the JAX package's rows and the value that the JAX test
asserts. Added: ``RecordBatch.hash_rows`` and ``MicroPartition.agg``, which
the port gains in this slice, held to the JAX package's values.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu.recordbatch
import daft_tpu_torch
import daft_tpu_torch.recordbatch

PKGS = (daft_tpu, daft_tpu_torch)
DATA = {"a": [1, 2, 3, 4], "b": ["x", "y", "x", "z"], "c": [1.0, 2.0, 3.0, 4.0]}


def _both(build):
    """``build(pkg, RecordBatch)``'s value in the port, held equal to the JAX
    package's."""
    jax, port = (build(p, p.RecordBatch) for p in PKGS)
    assert port == jax
    return port


def test_eval_projection():
    out = _both(lambda p, RB: RB.from_pydict(DATA).eval_expression_list(
        [p.col("a")._expr, (p.col("a") * 2 + p.col("c")).alias("d")._expr]).to_pydict())
    assert out == {"a": [1, 2, 3, 4], "d": [3.0, 6.0, 9.0, 12.0]}


def test_filter():
    def run(p, RB):
        rb = RB.from_pydict(DATA)
        return rb.filter(rb.eval_expression((p.col("b") == "x")._expr)).to_pydict()["a"]

    assert _both(run) == [1, 3]


def test_sort_multi():
    def run(p, RB):
        rb = RB.from_pydict(DATA)
        return rb.sort([rb.get_column("b"), rb.get_column("a")], [False, True]).to_pydict()

    out = _both(run)
    assert out["b"] == ["x", "x", "y", "z"] and out["a"] == [3, 1, 2, 4]


def test_agg_grouped():
    out = _both(lambda p, RB: RB.from_pydict(DATA).agg(
        [p.col("a").sum()._expr, p.col("c").mean()._expr], [p.col("b")._expr]).to_pydict())
    assert out["b"] == ["x", "y", "z"] and out["a"] == [4, 2, 4]


def test_agg_global():
    out = _both(lambda p, RB: RB.from_pydict(DATA).agg(
        [p.col("a").sum().alias("s")._expr, p.col("a").count().alias("n")._expr]).to_pydict())
    assert out == {"s": [10], "n": [4]}


def test_joins():
    def run(p, RB):
        rb = RB.from_pydict(DATA)
        right = RB.from_pydict({"b": ["x", "z"], "v": [10, 20]})
        keys = ([rb.get_column("b")], [right.get_column("b")])
        return (sorted(rb.hash_join(right, *keys, "inner").to_pydict()["v"]),
                sorted(rb.hash_join(right, *keys, "semi").to_pydict()["a"]),
                rb.hash_join(right, *keys, "anti").to_pydict()["a"])

    assert _both(run) == ([10, 10, 20], [1, 3, 4], [2])


def test_partition_by_hash():
    def run(p, RB):
        rb = RB.from_pydict(DATA)
        return [part.to_pydict() for part in rb.partition_by_hash([rb.get_column("b")], 3)]

    parts = _both(run)  # each key in the bucket the JAX package chose
    assert sum(len(p["a"]) for p in parts) == 4
    seen = set()
    for p in parts:
        assert not (set(p["b"]) & seen)
        seen |= set(p["b"])


def test_explode():
    out = _both(lambda p, RB: RB.from_pydict({"i": [1, 2, 3], "l": [[1, 2], [], None]})
                .explode(["l"]).to_pydict())
    assert out == {"i": [1, 1, 2, 3], "l": [1, 2, None, None]}


def test_unpivot():
    out = _both(lambda p, RB: RB.from_pydict(DATA).unpivot(["b"], ["a", "c"]).to_pydict())
    assert len(out["b"]) == 8 and set(out["variable"]) == {"a", "c"}


def test_distinct():
    assert _both(lambda p, RB: len(RB.from_pydict({"a": [1, 1, 2], "b": ["x", "x", "y"]})
                                   .distinct())) == 2


def test_quantiles():
    def run(p, RB):
        rb = RB.from_pydict(DATA)
        return rb.quantiles(2, [rb.get_column("a")], [False]).to_pydict()

    assert len(_both(run)["a"]) == 1


def test_partition_by_range():
    def run(p, RB):
        rb = RB.from_pydict({"k": [5, 1, 9, 3, 7, None]})
        bounds = RB.from_pydict({"k": [4, 8]})
        return [part.to_pydict()["k"] for part in
                rb.partition_by_range([rb.get_column("k")], bounds, [False])]

    assert _both(run) == [[1, 3], [5, 7], [9, None]]


def test_explode_misaligned_raises():
    msgs = []
    for p in PKGS:
        with pytest.raises(Exception) as e:
            p.RecordBatch.from_pydict({"a": [[1, 2], [3]], "b": [[10], [20, 30]]}).explode(["a", "b"])
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[1] == msgs[0]


def test_group_codes_no_stride_collision():
    """Distinct key tuples never share a group, even when a key past the
    first exceeds a mixed-radix stride of 1,000,003."""
    n = 1_100_000
    outs = []
    for p in PKGS:
        S = p.Series
        k1 = S.from_numpy((np.arange(n) % 2).astype(np.int64), "k1")
        k2 = S.from_numpy(np.arange(n, dtype=np.int64), "k2")
        codes, first_idx = __import__(f"{p.__name__}.recordbatch",
                                      fromlist=["x"])._group_codes([k1, k2])
        assert len(first_idx) == n and len(np.unique(codes)) == n
        outs.append((codes, first_idx))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_group_codes_huge_keyspace_fallback():
    """The row-tuple route when the mixed-radix key space exceeds int64."""
    base = np.arange(10_000, dtype=np.int64)
    for mod in (daft_tpu.recordbatch, daft_tpu_torch.recordbatch):
        S = (daft_tpu if mod is daft_tpu.recordbatch else daft_tpu_torch).Series
        codes, first_idx = mod._group_codes([S.from_numpy(base, f"k{i}") for i in range(5)])
        assert len(first_idx) == 10_000
        dup = [S.from_numpy(np.zeros(4, dtype=np.int64), f"k{i}") for i in range(5)]
        codes2, first2 = mod._group_codes(dup)
        assert len(first2) == 1 and list(codes2) == [0] * 4


@pytest.mark.parametrize("columns", [None, ["b"], ["a", "c"], []])
def test_hash_rows_equals_the_jax_package(columns):
    """``RecordBatch.hash_rows`` (new in the port) over seeded rows with
    nulls: the JAX package's uint64 hashes, zeros over no column."""
    rng = np.random.default_rng(7)
    data = {"a": [None if i % 7 == 3 else int(x) for i, x in enumerate(rng.integers(-99, 99, 50))],
            "b": rng.choice(["p", "q", "", "ümlaut"], 50).tolist(),
            "c": rng.standard_normal(50).tolist()}
    outs = [p.RecordBatch.from_pydict(data).hash_rows(columns) for p in PKGS]
    assert outs[1].dtype == outs[0].dtype == np.uint64
    np.testing.assert_array_equal(outs[1], outs[0])


def test_micropartition_agg_equals_the_jax_package():
    """``MicroPartition.agg`` (new in the port), grouped and global, over a
    partition of two batches."""
    def run(p, RB):
        mp = p.MicroPartition.concat([p.MicroPartition.from_pydict(DATA)] * 2)
        c = p.col
        grouped = mp.agg([c("a").sum().alias("s")._expr, c("c").mean().alias("m")._expr],
                         [c("b")._expr])
        whole = mp.agg([c("a").max().alias("mx")._expr, c("b").count().alias("n")._expr])
        return grouped.to_pydict(), whole.to_pydict(), repr(grouped.schema)

    grouped, whole, _ = _both(run)
    assert grouped == {"b": ["x", "y", "z"], "s": [8, 4, 8], "m": [2.0, 2.0, 4.0]}
    assert whole == {"mx": [4], "n": [8]}
