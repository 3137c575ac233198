"""Seeded columns of TPC-H's ``lineitem`` for the q06 and q01 scans.

The distributions are those of the TPC-H specification, clause 4.2.3:
``l_quantity`` uniform in 1..50; ``l_discount`` in 0.00..0.10 and ``l_tax`` in
0.00..0.08, steps of 0.01; ``l_extendedprice`` the quantity times the retail
price of a uniformly drawn part, (90000 + (partkey / 10) mod 20001 + 100 *
(partkey mod 1000)) / 100 with partkey in 1..SF * 200000; ``l_shipdate`` the
order date (uniform in STARTDATE .. ENDDATE - 151 days) plus 1..121 days.
Prices and rates are float32, quantities int32, and ship dates int32 days
since 1992-01-01 (STARTDATE): the 32-bit types the relational device layer
admits. SF10's lineitem has 59,986,052 rows.

q01 adds ``l_partkey`` (int32: SF10's keys are at most 2,000,000),
``l_receiptdate`` (the ship date plus 1..30 days), ``l_returnflag`` (``R`` or
``A`` at random when the receipt date is on or before CURRENTDATE,
1995-06-17, else ``N``) and ``l_linestatus`` (``O`` when the ship date is
after CURRENTDATE, else ``F``), from a generator of their own drawn after the
q06 columns, so those stay byte-identical. The two flags are Arrow strings,
taken from a three-letter dictionary without a Python string per row.
"""

from __future__ import annotations

import datetime

import numpy as np
import pyarrow as pa

SF10_LINEITEM_ROWS = 59_986_052
SF1_LINEITEM_ROWS = 6_001_215
EPOCH = datetime.date(1992, 1, 1)
LAST_ORDER_DAY = (datetime.date(1998, 12, 31) - EPOCH).days - 151

# q06's validation parameters: DATE 1994-01-01, DISCOUNT 0.06, QUANTITY 24.
Q06_DATE_LO = (datetime.date(1994, 1, 1) - EPOCH).days
Q06_DATE_HI = (datetime.date(1995, 1, 1) - EPOCH).days
Q06_DISCOUNT_LO, Q06_DISCOUNT_HI = 0.05, 0.07
Q06_QUANTITY = 24

CURRENT_DAY = (datetime.date(1995, 6, 17) - EPOCH).days
# q01's validation parameter DELTA = 90: l_shipdate <= 1998-12-01 - 90 days.
Q01_SHIPDATE_MAX = (datetime.date(1998, 9, 2) - EPOCH).days
Q01_KEYS = ("l_returnflag", "l_linestatus")
_FLAGS = pa.array(["A", "F", "N", "O", "R"], pa.large_string())
_FLAG_INDEX = {f: i for i, f in enumerate(_FLAGS.to_pylist())}


def lineitem_columns(rows: int, seed: int = 0, scale_factor: int = 10) -> dict:
    """``rows`` rows of q06's five numeric columns and q01's four more, from
    ``seed``."""
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, rows, dtype=np.int32)
    partkey = rng.integers(1, scale_factor * 200_000 + 1, rows, dtype=np.int64)
    retail_cents = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)
    price = (quantity * retail_cents / 100.0).astype(np.float32)
    discount = (rng.integers(0, 11, rows) / 100.0).astype(np.float32)
    tax = (rng.integers(0, 9, rows) / 100.0).astype(np.float32)
    shipdate = (rng.integers(0, LAST_ORDER_DAY + 1, rows, dtype=np.int32)
                + rng.integers(1, 122, rows, dtype=np.int32))
    more = np.random.default_rng((seed, 1))
    receipt = shipdate + more.integers(1, 31, rows, dtype=np.int32)
    returned = more.random(rows) < 0.5
    flag = np.where(receipt <= CURRENT_DAY,
                    np.where(returned, _FLAG_INDEX["R"], _FLAG_INDEX["A"]), _FLAG_INDEX["N"])
    status = np.where(shipdate > CURRENT_DAY, _FLAG_INDEX["O"], _FLAG_INDEX["F"])
    return {"l_quantity": quantity, "l_extendedprice": price, "l_discount": discount,
            "l_tax": tax, "l_shipdate": shipdate, "l_partkey": partkey.astype(np.int32),
            "l_receiptdate": receipt, "l_returnflag": _FLAGS.take(pa.array(flag, pa.int8())),
            "l_linestatus": _FLAGS.take(pa.array(status, pa.int8()))}


def q06(pkg, df):
    """TPC-H q06 over ``df`` with ``pkg``'s expressions (``daft_tpu`` or
    ``daft_tpu_torch``): revenue = sum(l_extendedprice * l_discount) over one
    year of ship dates, the discount band and the quantity cap."""
    c = pkg.col
    return (df.where((c("l_shipdate") >= Q06_DATE_LO) & (c("l_shipdate") < Q06_DATE_HI)
                     & (c("l_discount") >= Q06_DISCOUNT_LO) & (c("l_discount") <= Q06_DISCOUNT_HI)
                     & (c("l_quantity") < Q06_QUANTITY))
            .agg((c("l_extendedprice") * c("l_discount")).sum().alias("revenue")))


def q06_reference(cols: dict) -> float:
    """q06's revenue in f64 numpy: the predicate as the device decides it
    (the rate literals compare in f32 against the f32 column), the products
    and the sum in f64."""
    d = cols["l_discount"]
    keep = ((cols["l_shipdate"] >= Q06_DATE_LO) & (cols["l_shipdate"] < Q06_DATE_HI)
            & (d >= np.float32(Q06_DISCOUNT_LO)) & (d <= np.float32(Q06_DISCOUNT_HI))
            & (cols["l_quantity"] < Q06_QUANTITY))
    return float((cols["l_extendedprice"][keep].astype(np.float64) * d[keep]).sum())


def q01(pkg, df):
    """TPC-H q01 over ``df`` with ``pkg``'s expressions: the pricing summary
    per (l_returnflag, l_linestatus) of the rows shipped on or before
    1998-09-02, with f32-typed ``1 -`` / ``1 +`` literals. Groups come in
    first-occurrence order: sort them on the host (``sorted_groups``)."""
    c = pkg.col
    one = pkg.lit(1.0, pkg.DataType.float32())
    price, disc = c("l_extendedprice"), c("l_discount")
    disc_price = price * (one - disc)
    return (df.where(c("l_shipdate") <= Q01_SHIPDATE_MAX)
            .groupby(*Q01_KEYS)
            .agg(c("l_quantity").sum().alias("sum_qty"),
                 price.sum().alias("sum_base_price"),
                 disc_price.sum().alias("sum_disc_price"),
                 (disc_price * (one + c("l_tax"))).sum().alias("sum_charge"),
                 c("l_quantity").mean().alias("avg_qty"),
                 price.mean().alias("avg_price"),
                 disc.mean().alias("avg_disc"),
                 pkg.lit(1).count().alias("count_order")))


def sorted_groups(out: dict, keys=Q01_KEYS) -> dict:
    """A grouped result's columns (``to_pydict``) with the rows sorted by
    ``keys``."""
    order = sorted(range(len(out[keys[0]])), key=lambda i: tuple(out[k][i] for k in keys))
    return {k: [v[i] for i in order] for k, v in out.items()}


def _flag_bytes(arr) -> np.ndarray:
    """The one-letter flags of a large_string array as their ASCII bytes."""
    offsets = np.frombuffer(arr.buffers()[1], np.int64, count=len(arr) + 1 + arr.offset)[arr.offset:]
    return np.frombuffer(arr.buffers()[2], np.uint8)[offsets[:-1]]


def q01_reference(cols: dict) -> dict:
    """q01 per group in f64 numpy, the rows sorted by the keys: the sums of
    the f32 columns (the f32 ``1 - disc`` and ``1 + tax`` as the device
    computes them, products in f64), exact integer sums and counts."""
    keep = cols["l_shipdate"] <= Q01_SHIPDATE_MAX
    code = (_flag_bytes(cols["l_returnflag"]).astype(np.int64) * 256
            + _flag_bytes(cols["l_linestatus"]))[keep]
    groups = np.flatnonzero(np.bincount(code, minlength=1 << 16))
    lut = np.zeros(1 << 16, np.int64)
    lut[groups] = np.arange(len(groups))
    gid = lut[code]
    price = cols["l_extendedprice"][keep].astype(np.float64)
    disc_price = price * (np.float32(1) - cols["l_discount"][keep])
    charge = disc_price * (np.float32(1) + cols["l_tax"][keep])

    def sums(w):
        return np.bincount(gid, weights=w, minlength=len(groups))

    count = np.bincount(gid, minlength=len(groups))
    # Exact: a group's quantities sum below 2**53 at any scale factor TPC-H runs.
    qty = sums(cols["l_quantity"][keep].astype(np.float64)).astype(np.int64)
    return {"l_returnflag": [chr(g // 256) for g in groups],
            "l_linestatus": [chr(g % 256) for g in groups],
            "sum_qty": qty.tolist(), "sum_base_price": sums(price).tolist(),
            "sum_disc_price": sums(disc_price).tolist(), "sum_charge": sums(charge).tolist(),
            "avg_qty": (qty / count).tolist(), "avg_price": (sums(price) / count).tolist(),
            "avg_disc": (sums(cols["l_discount"][keep].astype(np.float64)) / count).tolist(),
            "count_order": count.tolist()}
