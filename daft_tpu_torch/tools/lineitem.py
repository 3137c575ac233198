"""Seeded numeric columns of TPC-H's ``lineitem`` for the q06 scan.

The distributions are those of the TPC-H specification, clause 4.2.3:
``l_quantity`` uniform in 1..50; ``l_discount`` in 0.00..0.10 and ``l_tax`` in
0.00..0.08, steps of 0.01; ``l_extendedprice`` the quantity times the retail
price of a uniformly drawn part, (90000 + (partkey / 10) mod 20001 + 100 *
(partkey mod 1000)) / 100 with partkey in 1..SF * 200000; ``l_shipdate`` the
order date (uniform in STARTDATE .. ENDDATE - 151 days) plus 1..121 days.
Prices and rates are float32, quantities int32, and ship dates int32 days
since 1992-01-01 (STARTDATE): the 32-bit types the relational device layer
admits. SF10's lineitem has 59,986,052 rows.
"""

from __future__ import annotations

import datetime

import numpy as np

SF10_LINEITEM_ROWS = 59_986_052
EPOCH = datetime.date(1992, 1, 1)
LAST_ORDER_DAY = (datetime.date(1998, 12, 31) - EPOCH).days - 151

# q06's validation parameters: DATE 1994-01-01, DISCOUNT 0.06, QUANTITY 24.
Q06_DATE_LO = (datetime.date(1994, 1, 1) - EPOCH).days
Q06_DATE_HI = (datetime.date(1995, 1, 1) - EPOCH).days
Q06_DISCOUNT_LO, Q06_DISCOUNT_HI = 0.05, 0.07
Q06_QUANTITY = 24


def lineitem_columns(rows: int, seed: int = 0, scale_factor: int = 10) -> dict:
    """``rows`` rows of the five numeric columns, from ``seed``."""
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, rows, dtype=np.int32)
    partkey = rng.integers(1, scale_factor * 200_000 + 1, rows, dtype=np.int64)
    retail_cents = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000)
    price = (quantity * retail_cents / 100.0).astype(np.float32)
    discount = (rng.integers(0, 11, rows) / 100.0).astype(np.float32)
    tax = (rng.integers(0, 9, rows) / 100.0).astype(np.float32)
    shipdate = (rng.integers(0, LAST_ORDER_DAY + 1, rows, dtype=np.int32)
                + rng.integers(1, 122, rows, dtype=np.int32))
    return {"l_quantity": quantity, "l_extendedprice": price, "l_discount": discount,
            "l_tax": tax, "l_shipdate": shipdate}


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
