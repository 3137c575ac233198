"""Seeded TPC-H ``customer``, ``orders`` and ``lineitem`` for the q03 and q04
joins, with the two queries and their references.

The distributions are those of the TPC-H specification, clause 4.2.3:
``c_custkey`` runs 1..SF * 150,000 and ``c_mktsegment`` is uniform over the
five segments; ``o_orderkey`` is sparse, the first 8 of every 32 keys
(dbgen's ``mk_sparse``: order i of 1..SF * 1,500,000 gets
``((i >> 3) << 5) | (i & 7)``, so SF10's largest key is 60,000,000);
``o_custkey`` is uniform over the customer keys not divisible by 3;
``o_orderdate`` uniform over STARTDATE .. ENDDATE - 151 days;
``o_orderpriority`` uniform over the five priorities and ``o_shippriority``
0. Each order has 1..7 lines; ``l_shipdate`` is the order date + 1..121 days,
``l_commitdate`` the order date + 30..90 and ``l_receiptdate`` the ship date
+ 1..30; quantity, price and discount follow ``tools/lineitem.py``'s rules.
Keys and dates are int32 (days since 1992-01-01), prices and discounts
float32: the 32-bit types the relational device layer admits. Strings are
Arrow large strings taken from a five-word dictionary, with no Python
string per row. ``tools/lineitem.py`` (q01, q06) is a generator of its own.
"""

from __future__ import annotations

import datetime
from typing import List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from daft_tpu_torch.tools.lineitem import EPOCH, LAST_ORDER_DAY

SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
_SEGMENTS = pa.array(SEGMENTS, pa.large_string())
_PRIORITIES = pa.array(PRIORITIES, pa.large_string())

# q03's validation parameters: SEGMENT BUILDING, DATE 1995-03-15.
Q03_SEGMENT = "BUILDING"
Q03_DATE = (datetime.date(1995, 3, 15) - EPOCH).days
Q03_TOP = 10
# q04's validation parameter: DATE 1993-07-01, a quarter of order dates.
Q04_DATE_LO = (datetime.date(1993, 7, 1) - EPOCH).days
Q04_DATE_HI = (datetime.date(1993, 10, 1) - EPOCH).days

#: The columns each query reads, per table.
Q03_COLUMNS = {"customer": ("c_custkey", "c_mktsegment"),
               "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"),
               "lineitem": ("l_orderkey", "l_extendedprice", "l_discount", "l_shipdate")}
Q04_COLUMNS = {"orders": ("o_orderkey", "o_orderdate", "o_orderpriority"),
               "lineitem": ("l_orderkey", "l_commitdate", "l_receiptdate")}


def tpch_tables(scale_factor: float = 10, seed: int = 0) -> dict:
    """``{"customer": {...}, "orders": {...}, "lineitem": {...}}``: each a
    dict of columns (numpy arrays, Arrow arrays for the strings) at
    ``scale_factor``, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    n_cust = int(round(scale_factor * 150_000))
    n_orders = int(round(scale_factor * 1_500_000))
    customer = {"c_custkey": np.arange(1, n_cust + 1, dtype=np.int32),
                "c_mktsegment": _SEGMENTS.take(pa.array(rng.integers(0, 5, n_cust, dtype=np.int8)))}
    i = np.arange(1, n_orders + 1, dtype=np.int64)
    orderkey = (((i >> 3) << 5) | (i & 7)).astype(np.int32)
    # The j-th key not divisible by 3: 1, 2, 4, 5, 7, ...
    j = rng.integers(0, n_cust - n_cust // 3, n_orders, dtype=np.int64)
    orderdate = rng.integers(0, LAST_ORDER_DAY + 1, n_orders, dtype=np.int32)
    orders = {"o_orderkey": orderkey,
              "o_custkey": ((j // 2) * 3 + j % 2 + 1).astype(np.int32),
              "o_orderdate": orderdate,
              "o_orderpriority": _PRIORITIES.take(
                  pa.array(rng.integers(0, 5, n_orders, dtype=np.int8))),
              "o_shippriority": np.zeros(n_orders, np.int32)}
    lines = rng.integers(1, 8, n_orders, dtype=np.int64)
    n_lines = int(lines.sum())
    day = np.repeat(orderdate, lines)
    shipdate = day + rng.integers(1, 122, n_lines, dtype=np.int32)
    commitdate = day + rng.integers(30, 91, n_lines, dtype=np.int32)
    del day
    receiptdate = shipdate + rng.integers(1, 31, n_lines, dtype=np.int32)
    quantity = rng.integers(1, 51, n_lines, dtype=np.int32)
    partkey = rng.integers(1, int(scale_factor * 200_000) + 1, n_lines, dtype=np.int64)
    retail_cents = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)
    del partkey
    price = (quantity * retail_cents / 100.0).astype(np.float32)
    del retail_cents
    discount = (rng.integers(0, 11, n_lines, dtype=np.int32) / 100.0).astype(np.float32)
    lineitem = {"l_orderkey": np.repeat(orderkey, lines), "l_quantity": quantity,
                "l_extendedprice": price, "l_discount": discount, "l_shipdate": shipdate,
                "l_commitdate": commitdate, "l_receiptdate": receiptdate}
    return {"customer": customer, "orders": orders, "lineitem": lineitem}


def q03(pkg, customer, orders, lineitem):
    """TPC-H q03 with ``pkg``'s expressions (``daft_tpu`` or
    ``daft_tpu_torch``) over three DataFrames: the shipping priority of the
    ten unshipped orders of the BUILDING segment with the most revenue,
    revenue = sum(l_extendedprice * (1 - l_discount)) with an f32 literal.
    The joins are written as the JAX package's optimizer orders them:
    lineitem probes ``orders ⋈ customer``, which customer builds."""
    c = pkg.col
    one = pkg.lit(1.0, pkg.DataType.float32())
    build = (orders.where(c("o_orderdate") < Q03_DATE)
             .join(customer.where(c("c_mktsegment") == Q03_SEGMENT),
                   left_on="o_custkey", right_on="c_custkey"))
    return (lineitem.where(c("l_shipdate") > Q03_DATE)
            .join(build, left_on="l_orderkey", right_on="o_orderkey")
            .select("l_orderkey", "o_orderdate", "o_shippriority",
                    (c("l_extendedprice") * (one - c("l_discount"))).alias("revenue"))
            .groupby("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(c("revenue").sum())
            .sort(["revenue", "o_orderdate", "l_orderkey"], desc=[True, False, False])
            .limit(Q03_TOP)
            .select("l_orderkey", "revenue", "o_orderdate", "o_shippriority"))


def q04(pkg, orders, lineitem):
    """TPC-H q04 with ``pkg``'s expressions: per priority, the orders of
    the quarter from 1993-07-01 with a line received after its commit date
    (the EXISTS as a semi join), sorted by priority."""
    c = pkg.col
    late = lineitem.where(c("l_commitdate") < c("l_receiptdate"))
    return (orders.where((c("o_orderdate") >= Q04_DATE_LO) & (c("o_orderdate") < Q04_DATE_HI))
            .join(late, left_on="o_orderkey", right_on="l_orderkey", how="semi")
            .groupby("o_orderpriority")
            .agg(pkg.lit(1).count().alias("order_count"))
            .sort("o_orderpriority"))


def _codes(arr, dictionary) -> np.ndarray:
    return pc.index_in(arr, value_set=dictionary).to_numpy(zero_copy_only=False)


def q03_reference(tables: dict) -> dict:
    """Every q03 group in f64 numpy, in q03's order (revenue descending, then
    order date and key ascending): ``l_orderkey``, ``revenue`` (the f32
    ``1 - l_discount`` as the device computes it, the products and sums in
    f64), ``o_orderdate``, ``o_shippriority``. An order key names its group:
    date and priority are the order's own."""
    cu, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    in_segment = np.zeros(len(cu["c_custkey"]) + 1, bool)
    in_segment[cu["c_custkey"][_codes(cu["c_mktsegment"], _SEGMENTS)
                               == SEGMENTS.index(Q03_SEGMENT)]] = True
    keep = (o["o_orderdate"] < Q03_DATE) & in_segment[o["o_custkey"]]
    top_key = int(o["o_orderkey"].max()) + 1 if len(o["o_orderkey"]) else 1
    order_ok = np.zeros(top_key, bool)
    order_ok[o["o_orderkey"][keep]] = True
    date_of = np.zeros(top_key, np.int32)
    date_of[o["o_orderkey"]] = o["o_orderdate"]
    ship_of = np.zeros(top_key, np.int32)
    ship_of[o["o_orderkey"]] = o["o_shippriority"]
    rows = (li["l_shipdate"] > Q03_DATE) & order_ok[li["l_orderkey"]]
    keys, group = np.unique(li["l_orderkey"][rows], return_inverse=True)
    revenue = np.bincount(group, weights=li["l_extendedprice"][rows].astype(np.float64)
                          * (np.float32(1) - li["l_discount"][rows]), minlength=len(keys))
    order = np.lexsort((keys, date_of[keys], -revenue))
    keys = keys[order]
    return {"l_orderkey": keys, "revenue": revenue[order], "o_orderdate": date_of[keys],
            "o_shippriority": ship_of[keys]}


def q03_compare(out: dict, ref: dict, rtol: float) -> Tuple[List[str], List[str]]:
    """(problems, notes) of q03's result (``to_pydict``) against
    ``q03_reference``. Keys, dates and priorities must be exact and each
    revenue within ``rtol`` of its f64 reference. The rows must be the
    reference's first ten in order; where adjacent revenues lie within
    ``rtol`` of each other either order is accepted (a note says so), and
    the rows must still be the ten largest and ordered by the sort keys
    wherever their revenues are further apart."""
    problems: List[str] = []
    notes: List[str] = []
    k = min(Q03_TOP, len(ref["l_orderkey"]))
    got = list(out["l_orderkey"])
    if len(got) != k:
        return [f"{len(got)} rows, want {k}"], notes
    pos = {int(key): i for i, key in enumerate(ref["l_orderkey"][:4 * k + 16])}
    ref_rev = []
    for key, rev, day, ship in zip(got, out["revenue"], out["o_orderdate"], out["o_shippriority"]):
        i = pos.get(key)
        if i is None:
            i = int(np.flatnonzero(ref["l_orderkey"] == key)[0]) if key in ref["l_orderkey"] else -1
        if i < 0:
            problems.append(f"order {key} is no q03 group")
            continue
        want = float(ref["revenue"][i])
        ref_rev.append(want)
        if abs(rev - want) > rtol * abs(want):
            problems.append(f"order {key}: revenue {rev!r} vs f64 reference {want!r}")
        if (day, ship) != (int(ref["o_orderdate"][i]), int(ref["o_shippriority"][i])):
            problems.append(f"order {key}: date, priority {(day, ship)} vs "
                            f"{(int(ref['o_orderdate'][i]), int(ref['o_shippriority'][i]))}")
    if problems or got == [int(x) for x in ref["l_orderkey"][:k]]:
        return problems, notes
    # Another order than the reference's: only near-ties may explain it.
    low = min(ref_rev)
    kth = float(ref["revenue"][k - 1])
    if low < kth * (1 - rtol):
        problems.append(f"a row of revenue {low!r} is in, below the tenth's {kth!r}")
    left_out = [int(key) for key, rev in zip(ref["l_orderkey"], ref["revenue"])
                if rev > low * (1 + rtol) and int(key) not in got]
    if left_out:
        problems.append(f"orders {left_out[:5]} are out, above the smallest row's revenue")
    for a, b, (ra, rb) in zip(got, got[1:], zip(ref_rev, ref_rev[1:])):
        if rb > ra * (1 + rtol):
            problems.append(f"orders {a}, {b}: revenues {ra!r} < {rb!r} out of order")
    if not problems:
        notes.append(f"near-tie within {rtol}: order {got} accepted for the reference's "
                     f"{[int(x) for x in ref['l_orderkey'][:k]]}")
    return problems, notes


def q04_reference(tables: dict) -> dict:
    """q04 in numpy: per priority (sorted), the count of the quarter's
    orders with a line received after its commit date."""
    o, li = tables["orders"], tables["lineitem"]
    top_key = int(max(o["o_orderkey"].max(initial=0), li["l_orderkey"].max(initial=0))) + 1
    late = np.zeros(top_key, bool)
    late[li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]] = True
    keep = ((o["o_orderdate"] >= Q04_DATE_LO) & (o["o_orderdate"] < Q04_DATE_HI)
            & late[o["o_orderkey"]])
    counts = np.bincount(_codes(o["o_orderpriority"], _PRIORITIES)[keep], minlength=5)
    present = [i for i in range(5) if counts[i]]
    return {"o_orderpriority": [PRIORITIES[i] for i in present],
            "order_count": [int(counts[i]) for i in present]}
