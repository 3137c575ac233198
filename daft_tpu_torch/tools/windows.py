"""Window queries and the remaining operators over TPC-H tables, with numpy
references, for ``chip_smoke.py``'s phase 16 and the tests.

The tables are ``tools/tpch.tpch_tables(..., sql=True)``'s (dates as int32
days). Each query builds a ``daft_tpu_torch``-style DataFrame from the
package passed in (``pkg``), and each reference computes the same rows with
numpy alone, independently of the engine:

* :func:`orders_windows` — over the orders placed on or after
  ``since_day`` (an int32 filter: a device chain on the card), the running
  ``sum(o_totalprice)`` per customer by order date (rows unbounded preceding
  to the current row), ``lag(o_orderdate, 1)`` over the same window and
  ``rank()`` per ``o_orderpriority`` by ``o_totalprice`` descending;
* :func:`ratio_sql` — TPC-DS q98's whole-partition ratio,
  ``l_extendedprice / sum(l_extendedprice) OVER (PARTITION BY l_partkey)``;
* :func:`lineitem_row_number`, :func:`exploded_lists`, :func:`with_ids`,
  :func:`q01_pivot`, :func:`suppkey_sets` — ``row_number()`` per order,
  ``explode`` of ``agg_list`` per order, ``monotonically_increasing_id``,
  ``pivot`` of q01's groups by ``l_linestatus`` and ``INTERSECT ALL`` /
  ``EXCEPT ALL`` of two multisets of ``l_suppkey``;
* :func:`order_window` — ``row_number()`` and a whole-order sum per
  ``l_orderkey``, the grace window's query under a memory limit.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.tools.lineitem import Q01_SHIPDATE_MAX

ORDERS_COLUMNS = ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice", "o_orderpriority")
SUPP_A_BELOW, SUPP_B_FROM = 30, 20  # l_quantity < 30 and l_quantity >= 20


def orders_frame(pkg, tables: dict):
    o = tables["orders"]
    return pkg.from_pydict({c: o[c] for c in ORDERS_COLUMNS})


def orders_windows(pkg, frame, since_day: int):
    F = __import__(f"{pkg.__name__}.functions", fromlist=["rank"])
    W, col = pkg.Window, pkg.col
    by_date = W().partition_by("o_custkey").order_by("o_orderdate")
    running = by_date.rows_between(W.unbounded_preceding, W.current_row)
    by_price = W().partition_by("o_orderpriority").order_by("o_totalprice", desc=True)
    return frame.where(col("o_orderdate") >= since_day).select(
        "o_orderkey", "o_custkey", "o_orderdate",
        col("o_totalprice").sum().over(running).alias("running_price"),
        col("o_orderdate").lag(1).over(by_date).alias("prev_date"),
        F.rank().over(by_price).alias("price_rank"))


def _stable_order(*keys: np.ndarray) -> np.ndarray:
    """The rows sorted by ``keys`` (non-negative ints, the most significant
    first), ties in row order: each row's keys and index packed into one
    distinct int64, sorted once (``np.lexsort`` takes seconds more on tens
    of millions of rows)."""
    n = len(keys[0])
    packed = np.zeros(n, dtype=np.int64)
    bits = 0
    for k in keys + (np.arange(n, dtype=np.int64),):
        width = max(int(k.max(initial=0)).bit_length(), 1)
        packed = (packed << np.int64(width)) | k.astype(np.int64)
        bits += width
    if bits > 63:
        raise ValueError(f"the keys take {bits} bits, more than an int64's 63")
    return np.sort(packed) & np.int64((1 << max(int(n - 1).bit_length(), 1)) - 1)


def _segments(keys_sorted: np.ndarray) -> tuple:
    """(first position of each run of equal keys, each position's run) over
    a sorted key array."""
    start = np.ones(len(keys_sorted), dtype=bool)
    start[1:] = keys_sorted[1:] != keys_sorted[:-1]
    return np.flatnonzero(start), np.cumsum(start) - 1, start


def orders_windows_reference(tables: dict, since_day: int) -> dict:
    """numpy: the kept orders in input order; the running sum from an f64
    cumulative sum per customer; the previous order's date per customer
    (-1 for none); the 1-based rank of the price among the priority's."""
    o = tables["orders"]
    keep = o["o_orderdate"] >= since_day
    key, cust = o["o_orderkey"][keep], o["o_custkey"][keep]
    date, price = o["o_orderdate"][keep], o["o_totalprice"][keep]
    n = len(key)
    perm = _stable_order(cust, date - date.min(initial=0))  # then input order
    first, run_of, start = _segments(cust[perm])
    csum = np.cumsum(price[perm].astype(np.float64))
    before = np.concatenate(([0.0], csum))[first]
    running = np.empty(n)
    running[perm] = csum - before[run_of]
    prev = np.empty(n, dtype=np.int64)
    sd = date[perm].astype(np.int64)
    prev[perm] = np.where(start, -1, np.concatenate(([-1], sd[:-1])))
    prio = np.asarray(pc.dictionary_encode(o["o_orderpriority"].filter(pa.array(keep)))
                      .indices).astype(np.int64)
    # Price descending: a non-negative f32's bits order as the value does.
    perm2 = _stable_order(prio, np.uint32(0xFFFFFFFF) - price.astype(np.float32).view(np.uint32))
    p2, c2 = price[perm2], prio[perm2]
    new_seg = np.ones(n, dtype=bool)
    new_seg[1:] = c2[1:] != c2[:-1]
    change = new_seg.copy()
    change[1:] |= p2[1:] != p2[:-1]
    pos = np.arange(n)
    rank = np.empty(n, dtype=np.int64)
    rank[perm2] = (np.maximum.accumulate(np.where(change, pos, 0))
                   - np.maximum.accumulate(np.where(new_seg, pos, 0)) + 1)
    return {"o_orderkey": key, "running_price": running, "prev_date": prev, "price_rank": rank}


def orders_windows_compare(table: pa.Table, ref: dict, rtol: float) -> list:
    """The problems of the port's rows (an Arrow table) against the reference:
    keys, previous dates and ranks exactly, running sums within ``rtol``."""
    problems = []
    key = table.column("o_orderkey").to_numpy()
    if not np.array_equal(key, ref["o_orderkey"]):
        return [f"the kept order keys differ ({len(key)} rows vs {len(ref['o_orderkey'])})"]
    prev = np.asarray(pc.fill_null(table.column("prev_date"), -1)).astype(np.int64)
    if not np.array_equal(prev, ref["prev_date"]):
        problems.append(f"lag(o_orderdate): {int((prev != ref['prev_date']).sum())} rows differ")
    rank = table.column("price_rank").to_numpy().astype(np.int64)
    if not np.array_equal(rank, ref["price_rank"]):
        problems.append(f"rank(): {int((rank != ref['price_rank']).sum())} rows differ")
    run = table.column("running_price").to_numpy().astype(np.float64)
    err = np.abs(run - ref["running_price"]) / np.maximum(np.abs(ref["running_price"]), 1e-30)
    if len(err) and err.max() > rtol:
        problems.append(f"the running sum: max rel err {err.max():.3e} > {rtol}")
    return problems


RATIO_SQL = ("SELECT l_orderkey, l_partkey, l_extendedprice / sum(l_extendedprice) "
             "OVER (PARTITION BY l_partkey) AS ratio FROM lineitem")


def ratio_reference(tables: dict) -> np.ndarray:
    li = tables["lineitem"]
    part, price = li["l_partkey"], li["l_extendedprice"].astype(np.float64)
    return price / np.bincount(part, weights=price)[part]


def lineitem_frame(pkg, tables: dict, columns=("l_orderkey", "l_partkey", "l_suppkey",
                                               "l_quantity", "l_extendedprice",
                                               "l_returnflag", "l_linestatus", "l_shipdate")):
    li = tables["lineitem"]
    return pkg.from_pydict({c: li[c] for c in columns})


def lineitem_row_number(pkg, frame):
    F = __import__(f"{pkg.__name__}.functions", fromlist=["row_number"])
    return frame.select("l_orderkey", F.row_number().over(
        pkg.Window().partition_by("l_orderkey")).alias("rn"))


def row_number_reference(tables: dict) -> np.ndarray:
    """Lines come grouped by order: the line's place in its run, from 1."""
    first, run_of, _ = _segments(tables["lineitem"]["l_orderkey"])
    return np.arange(len(run_of)) - first[run_of] + 1


def exploded_lists(pkg, frame):
    return frame.groupby("l_orderkey").agg_list("l_partkey").explode("l_partkey")


def pairs(orderkey: np.ndarray, partkey: np.ndarray) -> np.ndarray:
    """(order, part) pairs packed one int64 each, sorted: a multiset."""
    return np.sort((orderkey.astype(np.int64) << 32) | partkey.astype(np.int64))


def with_ids(pkg, frame):
    F = __import__(f"{pkg.__name__}.functions", fromlist=["monotonically_increasing_id"])
    return frame.select(F.monotonically_increasing_id().alias("id"), "l_orderkey")


def q01_pivot(pkg, frame):
    """q01's (returnflag, linestatus) groups of ``sum(l_quantity)``, the
    statuses as columns."""
    return (frame.where(pkg.col("l_shipdate") <= Q01_SHIPDATE_MAX)
            .pivot("l_returnflag", "l_linestatus", "l_quantity", "sum", names=["F", "O"])
            .sort("l_returnflag"))


def q01_pivot_reference(tables: dict) -> dict:
    li = tables["lineitem"]
    keep = li["l_shipdate"] <= Q01_SHIPDATE_MAX
    flag = np.asarray(li["l_returnflag"].filter(pa.array(keep)).to_pylist(), object)
    status = np.asarray(li["l_linestatus"].filter(pa.array(keep)).to_pylist(), object)
    qty = li["l_quantity"][keep].astype(np.int64)
    flags = sorted(set(flag.tolist()))
    out = {"l_returnflag": flags, "F": [], "O": []}
    for f in flags:
        for s in ("F", "O"):
            sel = (flag == f) & (status == s)
            out[s].append(int(qty[sel].sum()) if sel.any() else None)
    return out


def suppkey_sets(pkg, frame):
    """(INTERSECT ALL, EXCEPT ALL) of the suppliers of the lines with
    ``l_quantity < 30`` and of those with ``l_quantity >= 20``."""
    col = pkg.col
    a = frame.where(col("l_quantity") < SUPP_A_BELOW).select("l_suppkey")
    b = frame.where(col("l_quantity") >= SUPP_B_FROM).select("l_suppkey")
    return a.intersect_all(b), a.except_all(b)


def suppkey_sets_reference(tables: dict) -> tuple:
    """The two multisets, sorted: min(a, b) and max(a - b, 0) copies of each
    supplier."""
    li = tables["lineitem"]
    supp, qty = li["l_suppkey"], li["l_quantity"]
    size = int(supp.max(initial=0)) + 1
    a = np.bincount(supp[qty < SUPP_A_BELOW], minlength=size)
    b = np.bincount(supp[qty >= SUPP_B_FROM], minlength=size)
    keys = np.arange(size)
    return np.repeat(keys, np.minimum(a, b)), np.repeat(keys, np.maximum(a - b, 0))


def order_window(pkg, frame):
    """``row_number()`` by part key and the whole order's price per
    ``l_orderkey``: every window partitions by the order key, so under a
    memory limit the window goes to grace buckets by it."""
    F = __import__(f"{pkg.__name__}.functions", fromlist=["row_number"])
    W, col = pkg.Window, pkg.col
    return frame.select(
        "l_orderkey", "l_partkey", "l_suppkey",
        F.row_number().over(W().partition_by("l_orderkey").order_by("l_partkey")).alias("rn"),
        col("l_extendedprice").sum().over(W().partition_by("l_orderkey")).alias("order_price"))


def sorted_by(table: pa.Table, keys) -> pa.Table:
    """``table`` sorted by ``keys`` (ascending): rows to compare whatever
    their order (a grace window's buckets come in bucket order)."""
    return table.take(pc.sort_indices(table, sort_keys=[(k, "ascending") for k in keys]))
