"""Seeded TPC-H tables for the port's join and expression queries, with the
queries in DataFrame form and independent numpy references.

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
Arrow large strings taken from a dictionary, with no Python string per row.
``tools/lineitem.py`` (q01, q06) is a generator of its own.

``tpch_tables(..., expressions=True)`` adds what q05, q07-q10, q12-q14 and
q19 read, each table and column from a generator of its own, so the columns
above (q03, q04) stay byte-identical: ``part`` (SF * 200,000 parts: a name of
five distinct colours of the spec's 92, ``Brand#MN``, one of the 150 types,
size 1..50, one of the 40 containers), ``supplier`` (SF * 10,000, a uniform
nation), ``partsupp`` (four suppliers per part by the spec's formula
``(p + i * (S / 4 + (p - 1) / S)) mod S + 1``, i = 0..3, a supply cost
1.00..1000.00), the spec's 25 nations and 5 regions, ``c_nationkey``
(uniform), ``o_comment`` (a sentence of seven words from the spec's text
grammar word lists: adjective, noun, verb, adverb, preposition, adjective,
noun), and ``l_partkey`` (the part the price was drawn from), ``l_suppkey``
(the same formula with a uniform i, so every ``(l_partkey, l_suppkey)`` is
in ``partsupp``), ``l_returnflag`` (``R`` or ``A`` at random when the receipt
date is on or before CURRENTDATE 1995-06-17, else ``N``), ``l_shipmode`` and
``l_shipinstruct`` (uniform over the spec's seven modes and four
instructions).
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


def tpch_tables(scale_factor: float = 10, seed: int = 0, expressions: bool = False) -> dict:
    """``{"customer": {...}, "orders": {...}, "lineitem": {...}}``: each a
    dict of columns (numpy arrays, Arrow arrays for the strings) at
    ``scale_factor``, drawn from ``seed``. With ``expressions``, also the
    tables and columns of q05-q19 (``part``, ``supplier``, ``partsupp``,
    ``nation``, ``region`` and the columns the module docstring lists)."""
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
    l_partkey = partkey.astype(np.int32) if expressions else None
    del partkey
    price = (quantity * retail_cents / 100.0).astype(np.float32)
    del retail_cents
    discount = (rng.integers(0, 11, n_lines, dtype=np.int32) / 100.0).astype(np.float32)
    lineitem = {"l_orderkey": np.repeat(orderkey, lines), "l_quantity": quantity,
                "l_extendedprice": price, "l_discount": discount, "l_shipdate": shipdate,
                "l_commitdate": commitdate, "l_receiptdate": receiptdate}
    tables = {"customer": customer, "orders": orders, "lineitem": lineitem}
    if expressions:
        lineitem["l_partkey"] = l_partkey
        _add_expression_tables(tables, scale_factor, seed)
    return tables


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


# --------------------------------------------------------------------------- #
# The tables and columns of q05, q07-q10, q12-q14 and q19                      #
# --------------------------------------------------------------------------- #
#: Days from 1970-01-01 to the day-0 of the int32 dates (1992-01-01).
DAYS_TO_EPOCH = (EPOCH - datetime.date(1970, 1, 1)).days
CURRENT_DAY = (datetime.date(1995, 6, 17) - EPOCH).days

NATIONS = (("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
           ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
           ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
           ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
           ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
           ("UNITED STATES", 1))
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
COLORS = tuple("""almond antique aquamarine azure beige bisque black blanched blue blush
brown burlywood burnished chartreuse chiffon chocolate coral cornflower cornsilk cream cyan
dark deep dim dodger drab firebrick floral forest frosted gainsboro ghost goldenrod green
grey honeydew hot indian ivory khaki lace lavender lawn lemon light lime linen magenta
maroon medium metallic midnight mint misty moccasin navajo navy olive orange orchid pale
papaya peach peru pink plum powder puff purple red rose rosy royal saddle salmon sandy
seashell sienna sky slate smoke snow spring steel tan thistle tomato turquoise violet
wheat white yellow""".split())
TYPES = tuple(f"{a} {b} {c}"
              for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO")
              for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED")
              for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
CONTAINERS = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                   for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"))
BRANDS = tuple(f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6))
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
INSTRUCTIONS = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
RETURNFLAGS = ("A", "N", "R")
# o_comment's sentence: adjective noun verb adverb preposition adjective noun.
_ADJECTIVES = tuple("""special pending unusual express furious sly careful blithe quick
fluffy slow quiet ruthless thin close dogged daring brave stealthy permanent enticing idle
busy regular final ironic even bold silent""".split())
_NOUNS = tuple("""foxes ideas theodolites pinto beans instructions dependencies excuses
platelets asymptotes courts dolphins multipliers sauternes warthogs frets dinos attainments
somas patterns forges braids frays warhorses dugouts notornis epitaphs pearls tithes waters
orbits gifts sheaves depths sentiments decoys realms pains grouches escapades packages
requests accounts deposits""".split())
_VERBS = tuple("""sleep wake are cajole haggle nag use boost affix detect integrate maintain
nod was lose sublate solve thrash promise engage hinder print breach eat grow impress mold
poach serve run dazzle snooze doze unwind kindle play hang believe doubt""".split())
_ADVERBS = tuple("""sometimes always never furiously slyly carefully blithely quickly
fluffily slowly quietly ruthlessly thinly closely doggedly daringly bravely stealthily
permanently enticingly idly busily regularly finally ironically evenly boldly
silently""".split())
_PREPOSITIONS = tuple("""about above across after against along among around at atop before
behind beneath beside besides between beyond by despite during except for from inside into
near of on outside over past since through throughout to toward under until up upon
without with within""".split())


_SPACE = pa.scalar(" ", pa.large_string())


def _dict(words) -> pa.Array:
    return pa.array(words, pa.large_string())


def _take(words, codes: np.ndarray) -> pa.Array:
    return _dict(words).take(pa.array(codes))


def _sentence(rng, n: int) -> pa.Array:
    parts = [_take(words, rng.integers(0, len(words), n, dtype=np.int32))
             for words in (_ADJECTIVES, _NOUNS, _VERBS, _ADVERBS, _PREPOSITIONS,
                           _ADJECTIVES, _NOUNS)]
    return pc.binary_join_element_wise(*parts, _SPACE)


def _distinct_colors(rng, n: int) -> np.ndarray:
    """(n, 5) colour codes, distinct within each row (rows with a repeat are
    drawn again)."""
    codes = rng.integers(0, len(COLORS), (n, 5), dtype=np.int32)
    while True:
        s = np.sort(codes, axis=1)
        bad = np.flatnonzero((s[:, 1:] == s[:, :-1]).any(axis=1))
        if not len(bad):
            return codes
        codes[bad] = rng.integers(0, len(COLORS), (len(bad), 5), dtype=np.int32)


def supplier_of(partkey: np.ndarray, i: np.ndarray, n_supp: int) -> np.ndarray:
    """The spec's i-th supplier (i = 0..3) of each part:
    ``(p + i * (S / 4 + (p - 1) / S)) mod S + 1``, integer divisions."""
    p = partkey.astype(np.int64)
    return ((p + i * (n_supp // 4 + (p - 1) // n_supp)) % n_supp + 1).astype(np.int32)


def _add_expression_tables(tables: dict, scale_factor: float, seed: int) -> None:
    n_part = int(round(scale_factor * 200_000))
    n_supp = int(round(scale_factor * 10_000))
    rng = np.random.default_rng((seed, 2))
    m = rng.integers(0, 5, n_part, dtype=np.int32)
    colors = _distinct_colors(rng, n_part)
    tables["part"] = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int32),
        "p_name": pc.binary_join_element_wise(
            *[_take(COLORS, colors[:, j]) for j in range(5)], _SPACE),
        "p_brand": _take(BRANDS, m * 5 + rng.integers(0, 5, n_part, dtype=np.int32)),
        "p_type": _take(TYPES, rng.integers(0, len(TYPES), n_part, dtype=np.int32)),
        "p_size": rng.integers(1, 51, n_part, dtype=np.int32),
        "p_container": _take(CONTAINERS, rng.integers(0, len(CONTAINERS), n_part,
                                                      dtype=np.int32)),
    }
    del colors
    rng = np.random.default_rng((seed, 3))
    tables["supplier"] = {"s_suppkey": np.arange(1, n_supp + 1, dtype=np.int32),
                          "s_nationkey": rng.integers(0, 25, n_supp, dtype=np.int32)}
    rng = np.random.default_rng((seed, 4))
    ps_partkey = np.repeat(np.arange(1, n_part + 1, dtype=np.int32), 4)
    tables["partsupp"] = {
        "ps_partkey": ps_partkey,
        "ps_suppkey": supplier_of(ps_partkey, np.tile(np.arange(4), n_part), n_supp),
        "ps_supplycost": (rng.integers(100, 100_001, 4 * n_part) / 100.0).astype(np.float32),
    }
    tables["nation"] = {"n_nationkey": np.arange(25, dtype=np.int32),
                        "n_name": _dict([n for n, _ in NATIONS]),
                        "n_regionkey": np.array([r for _, r in NATIONS], np.int32)}
    tables["region"] = {"r_regionkey": np.arange(5, dtype=np.int32), "r_name": _dict(REGIONS)}
    cu, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    rng = np.random.default_rng((seed, 5))
    cu["c_nationkey"] = rng.integers(0, 25, len(cu["c_custkey"]), dtype=np.int32)
    o["o_comment"] = _sentence(np.random.default_rng((seed, 6)), len(o["o_orderkey"]))
    rng = np.random.default_rng((seed, 7))
    n = len(li["l_orderkey"])
    li["l_suppkey"] = supplier_of(li["l_partkey"], rng.integers(0, 4, n), n_supp)
    returned = rng.random(n) < 0.5
    li["l_returnflag"] = _take(RETURNFLAGS, np.where(
        li["l_receiptdate"] <= CURRENT_DAY, np.where(returned, 2, 0), 1).astype(np.int8))
    del returned
    li["l_shipmode"] = _take(SHIPMODES, rng.integers(0, len(SHIPMODES), n, dtype=np.int8))
    li["l_shipinstruct"] = _take(INSTRUCTIONS, rng.integers(0, len(INSTRUCTIONS), n,
                                                            dtype=np.int8))


def _day(y: int, mo: int, d: int) -> int:
    return (datetime.date(y, mo, d) - EPOCH).days


# The validation parameters of each query (TPC-H clause 2.4, "Query
# Validation").
Q05_REGION, Q05_DATE = "ASIA", _day(1994, 1, 1)
Q07_NATIONS = ("FRANCE", "GERMANY")
Q07_DATE_LO, Q07_DATE_HI = _day(1995, 1, 1), _day(1996, 12, 31)
Q08_NATION, Q08_REGION, Q08_TYPE = "BRAZIL", "AMERICA", "ECONOMY ANODIZED STEEL"
Q09_COLOR = "green"
Q10_DATE = _day(1993, 10, 1)
Q10_TOP = 20
Q12_SHIPMODES = ("MAIL", "SHIP")
Q12_DATE = _day(1994, 1, 1)
Q13_PATTERN = "%special%requests%"
Q14_DATE = _day(1995, 9, 1)
Q19_BRANDS = ("Brand#12", "Brand#23", "Brand#34")
Q19_QUANTITIES = (1, 10, 20)
Q19_CONTAINERS = (("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
                  ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
                  ("LG CASE", "LG BOX", "LG PACK", "LG PKG"))
Q19_SIZES = (5, 10, 15)

#: The columns each query reads, per table.
EXPR_COLUMNS = {
    "q05": {"customer": ("c_custkey", "c_nationkey"),
            "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
            "lineitem": ("l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"),
            "supplier": ("s_suppkey", "s_nationkey"),
            "nation": ("n_nationkey", "n_name", "n_regionkey"),
            "region": ("r_regionkey", "r_name")},
    "q07": {"supplier": ("s_suppkey", "s_nationkey"),
            "lineitem": ("l_orderkey", "l_suppkey", "l_extendedprice", "l_discount",
                         "l_shipdate"),
            "orders": ("o_orderkey", "o_custkey"),
            "customer": ("c_custkey", "c_nationkey"),
            "nation": ("n_nationkey", "n_name")},
    "q08": {"part": ("p_partkey", "p_type"),
            "supplier": ("s_suppkey", "s_nationkey"),
            "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice",
                         "l_discount"),
            "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
            "customer": ("c_custkey", "c_nationkey"),
            "nation": ("n_nationkey", "n_name", "n_regionkey"),
            "region": ("r_regionkey", "r_name")},
    "q09": {"part": ("p_partkey", "p_name"),
            "supplier": ("s_suppkey", "s_nationkey"),
            "lineitem": ("l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
                         "l_extendedprice", "l_discount"),
            "partsupp": ("ps_partkey", "ps_suppkey", "ps_supplycost"),
            "orders": ("o_orderkey", "o_orderdate"),
            "nation": ("n_nationkey", "n_name")},
    "q10": {"customer": ("c_custkey", "c_nationkey"),
            "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
            "lineitem": ("l_orderkey", "l_extendedprice", "l_discount", "l_returnflag"),
            "nation": ("n_nationkey", "n_name")},
    "q12": {"orders": ("o_orderkey", "o_orderpriority"),
            "lineitem": ("l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate",
                         "l_shipdate")},
    "q13": {"customer": ("c_custkey",),
            "orders": ("o_orderkey", "o_custkey", "o_comment")},
    "q14": {"lineitem": ("l_partkey", "l_extendedprice", "l_discount", "l_shipdate"),
            "part": ("p_partkey", "p_type")},
    "q19": {"lineitem": ("l_partkey", "l_quantity", "l_extendedprice", "l_discount",
                         "l_shipinstruct", "l_shipmode"),
            "part": ("p_partkey", "p_brand", "p_size", "p_container")},
}


def _year(pkg, day_col):
    """The calendar year of an int32 day (days since 1992-01-01): the day
    plus its offset from 1970-01-01, cast to a date, through ``.dt.year()``."""
    offset = pkg.lit(DAYS_TO_EPOCH, pkg.DataType.int32())
    return (pkg.col(day_col) + offset).cast(pkg.DataType.date()).dt.year()


def _revenue(pkg):
    """l_extendedprice * (1 - l_discount) with an f32 literal (C.31)."""
    one = pkg.lit(1.0, pkg.DataType.float32())
    return pkg.col("l_extendedprice") * (one - pkg.col("l_discount"))


def q05(pkg, t):
    """Local supplier volume: per nation of ASIA, the revenue of 1994's
    orders whose customer and supplier are both of that nation. Each join
    builds on its smaller side (the right one)."""
    c = pkg.col
    nations = t["nation"].join(t["region"].where(c("r_name") == Q05_REGION),
                               left_on="n_regionkey", right_on="r_regionkey")
    supp = t["supplier"].join(nations, left_on="s_nationkey", right_on="n_nationkey")
    orders = (t["orders"].where((c("o_orderdate") >= Q05_DATE)
                                & (c("o_orderdate") < _day(1995, 1, 1)))
              .join(t["customer"], left_on="o_custkey", right_on="c_custkey"))
    return (t["lineitem"].join(orders, left_on="l_orderkey", right_on="o_orderkey")
            .join(supp, left_on=["l_suppkey", "c_nationkey"],
                  right_on=["s_suppkey", "s_nationkey"])
            .select("n_name", _revenue(pkg).alias("revenue"))
            .groupby("n_name").agg(c("revenue").sum())
            .sort("revenue", desc=True))


def q07(pkg, t):
    """Volume shipping: per (supplier nation, customer nation, year) of
    FRANCE and GERMANY, the revenue of 1995-1996's lines shipped between
    them (the OR of the two directions)."""
    c = pkg.col
    n1, n2 = Q07_NATIONS
    pair = t["nation"].where(c("n_name").is_in(list(Q07_NATIONS)))
    supp = t["supplier"].join(pair.select(c("n_nationkey").alias("supp_nationkey"),
                                          c("n_name").alias("supp_nation")),
                              left_on="s_nationkey", right_on="supp_nationkey")
    cust = t["customer"].join(pair.select(c("n_nationkey").alias("cust_nationkey"),
                                          c("n_name").alias("cust_nation")),
                              left_on="c_nationkey", right_on="cust_nationkey")
    orders = t["orders"].join(cust, left_on="o_custkey", right_on="c_custkey")
    return (t["lineitem"].where((c("l_shipdate") >= Q07_DATE_LO)
                                & (c("l_shipdate") <= Q07_DATE_HI))
            .join(supp, left_on="l_suppkey", right_on="s_suppkey")
            .join(orders, left_on="l_orderkey", right_on="o_orderkey")
            .where(((c("supp_nation") == n1) & (c("cust_nation") == n2))
                   | ((c("supp_nation") == n2) & (c("cust_nation") == n1)))
            .select("supp_nation", "cust_nation", _year(pkg, "l_shipdate").alias("l_year"),
                    _revenue(pkg).alias("volume"))
            .groupby("supp_nation", "cust_nation", "l_year")
            .agg(c("volume").sum().alias("revenue"))
            .sort(["supp_nation", "cust_nation", "l_year"]))


def q08(pkg, t):
    """National market share: per year of 1995-1996, BRAZIL's share of
    AMERICA's revenue from ECONOMY ANODIZED STEEL parts."""
    c = pkg.col
    zero = pkg.lit(0.0, pkg.DataType.float32())
    america = (t["nation"].join(t["region"].where(c("r_name") == Q08_REGION),
                                left_on="n_regionkey", right_on="r_regionkey")
               .select(c("n_nationkey").alias("cust_nationkey")))
    cust = t["customer"].join(america, left_on="c_nationkey", right_on="cust_nationkey")
    orders = (t["orders"].where((c("o_orderdate") >= Q07_DATE_LO)
                                & (c("o_orderdate") <= Q07_DATE_HI))
              .join(cust, left_on="o_custkey", right_on="c_custkey"))
    supp = t["supplier"].join(t["nation"].select("n_nationkey", "n_name"),
                              left_on="s_nationkey", right_on="n_nationkey")
    return (t["lineitem"].join(t["part"].where(c("p_type") == Q08_TYPE),
                               left_on="l_partkey", right_on="p_partkey")
            .join(orders, left_on="l_orderkey", right_on="o_orderkey")
            .join(supp, left_on="l_suppkey", right_on="s_suppkey")
            .select(_year(pkg, "o_orderdate").alias("o_year"), _revenue(pkg).alias("volume"),
                    c("n_name").alias("nation"))
            .with_column("brazil_volume",
                         (c("nation") == Q08_NATION).if_else(c("volume"), zero))
            .groupby("o_year").agg(c("brazil_volume").sum(), c("volume").sum())
            .select("o_year", (c("brazil_volume") / c("volume")).alias("mkt_share"))
            .sort("o_year"))


def q09(pkg, t):
    """Product type profit: per nation and year, the profit on parts whose
    name contains ``green``, amount = l_extendedprice * (1 - l_discount) -
    ps_supplycost * l_quantity. The lines join ``partsupp`` on
    ``(l_partkey, l_suppkey)``."""
    c = pkg.col
    green = t["part"].where(c("p_name").str.contains(Q09_COLOR)).select("p_partkey")
    partsupp = t["partsupp"].join(green, left_on="ps_partkey", right_on="p_partkey")
    supp = t["supplier"].join(t["nation"], left_on="s_nationkey", right_on="n_nationkey")
    cost = c("ps_supplycost") * c("l_quantity").cast(pkg.DataType.float32())
    return (t["lineitem"].join(partsupp, left_on=["l_partkey", "l_suppkey"],
                               right_on=["ps_partkey", "ps_suppkey"])
            .join(supp, left_on="l_suppkey", right_on="s_suppkey")
            .join(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
            .select(c("n_name").alias("nation"), _year(pkg, "o_orderdate").alias("o_year"),
                    (_revenue(pkg) - cost).alias("amount"))
            .groupby("nation", "o_year").agg(c("amount").sum().alias("sum_profit"))
            .sort(["nation", "o_year"], desc=[False, True]))


def q10(pkg, t):
    """Returned item reporting: the 20 customers with the most revenue lost
    to returned lines of the quarter from 1993-10-01, with their nation. The
    spec's customer name, balance, address, phone and comment (each a
    function of the key) are left out; ties on revenue break on the key."""
    c = pkg.col
    orders = t["orders"].where((c("o_orderdate") >= Q10_DATE)
                               & (c("o_orderdate") < _day(1994, 1, 1)))
    cust = t["customer"].join(t["nation"], left_on="c_nationkey", right_on="n_nationkey")
    return (t["lineitem"].where(c("l_returnflag") == "R")
            .join(orders, left_on="l_orderkey", right_on="o_orderkey")
            .join(cust, left_on="o_custkey", right_on="c_custkey")
            .select(c("o_custkey").alias("c_custkey"), "n_name", _revenue(pkg).alias("revenue"))
            .groupby("c_custkey", "n_name").agg(c("revenue").sum())
            .sort(["revenue", "c_custkey"], desc=[True, False])
            .limit(Q10_TOP))


def q12(pkg, t):
    """Shipping modes and order priority: per ship mode of MAIL and SHIP,
    the 1994 lines received late but shipped before their commit date, split
    by urgent or high order priority. The orders probe the filtered lines."""
    c = pkg.col
    lines = t["lineitem"].where(c("l_shipmode").is_in(list(Q12_SHIPMODES))
                                & (c("l_commitdate") < c("l_receiptdate"))
                                & (c("l_shipdate") < c("l_commitdate"))
                                & (c("l_receiptdate") >= Q12_DATE)
                                & (c("l_receiptdate") < _day(1995, 1, 1)))
    urgent = c("o_orderpriority").is_in(["1-URGENT", "2-HIGH"])
    return (t["orders"].join(lines, left_on="o_orderkey", right_on="l_orderkey")
            .select("l_shipmode", urgent.if_else(1, 0).alias("high_line_count"),
                    urgent.if_else(0, 1).alias("low_line_count"))
            .groupby("l_shipmode").agg(c("high_line_count").sum(), c("low_line_count").sum())
            .sort("l_shipmode"))


def q13(pkg, t):
    """Customer distribution: how many customers have each count of orders
    whose comment is not like ``%special%requests%`` (a left outer join, so
    customers without such orders count 0)."""
    c = pkg.col
    orders = t["orders"].where(~c("o_comment").str.like(Q13_PATTERN))
    return (t["customer"].join(orders, left_on="c_custkey", right_on="o_custkey", how="left")
            .groupby("c_custkey").agg(c("o_orderkey").count().alias("c_count"))
            .groupby("c_count").agg(c("c_custkey").count().alias("custdist"))
            .sort(["custdist", "c_count"], desc=[True, True]))


def q14(pkg, t):
    """Promotion effect: the percentage of September 1995's revenue from
    PROMO parts."""
    c = pkg.col
    zero = pkg.lit(0.0, pkg.DataType.float32())
    return (t["lineitem"].where((c("l_shipdate") >= Q14_DATE)
                                & (c("l_shipdate") < _day(1995, 10, 1)))
            .join(t["part"], left_on="l_partkey", right_on="p_partkey")
            .select(_revenue(pkg).alias("revenue"), c("p_type"))
            .select(c("p_type").str.startswith("PROMO").if_else(c("revenue"), zero)
                    .alias("promo"), "revenue")
            .agg(c("promo").sum(), c("revenue").sum())
            .select((pkg.lit(100.0) * c("promo") / c("revenue")).alias("promo_revenue")))


def q19(pkg, t):
    """Discounted revenue: the revenue of air lines delivered in person for
    three brand / container / quantity / size bands, OR-ed."""
    c = pkg.col

    def band(i):
        q = Q19_QUANTITIES[i]
        return ((c("p_brand") == Q19_BRANDS[i])
                & c("p_container").is_in(list(Q19_CONTAINERS[i]))
                & (c("l_quantity") >= q) & (c("l_quantity") <= q + 10)
                & c("p_size").between(1, Q19_SIZES[i]))

    return (t["lineitem"].where(c("l_shipmode").is_in(["AIR", "AIR REG"])
                                & (c("l_shipinstruct") == "DELIVER IN PERSON"))
            .join(t["part"], left_on="l_partkey", right_on="p_partkey")
            .where(band(0) | band(1) | band(2))
            .agg(_revenue(pkg).sum().alias("revenue")))


EXPR_QUERIES = {"q05": q05, "q07": q07, "q08": q08, "q09": q09, "q10": q10, "q12": q12,
                "q13": q13, "q14": q14, "q19": q19}


def expr_frames(pkg, tables: dict, name: str) -> dict:
    """``name``'s tables as ``pkg`` DataFrames of the columns it reads."""
    return {tab: pkg.from_pydict({col: tables[tab][col] for col in cols})
            for tab, cols in EXPR_COLUMNS[name].items()}


# -- references ---------------------------------------------------------------
def _np(arr) -> np.ndarray:
    return arr.to_numpy(zero_copy_only=False)


def _year_of_day(days: np.ndarray) -> np.ndarray:
    return (np.datetime64(EPOCH, "D") + days.astype("timedelta64[D]")).astype(
        "datetime64[Y]").astype(np.int64) + 1970


def _by_key(keys: np.ndarray, values: np.ndarray, fill=0) -> np.ndarray:
    """A dense lookup over ``keys`` (non-negative ints): out[key] = value."""
    out = np.full(int(keys.max(initial=0)) + 1, fill, values.dtype)
    out[keys] = values
    return out


def _rev(li, rows) -> np.ndarray:
    """The f32 ``1 - l_discount`` as the device computes it, the product in f64."""
    return li["l_extendedprice"][rows].astype(np.float64) * (np.float32(1) - li["l_discount"][rows])


def _lookups(t: dict) -> dict:
    cu, o, su = t["customer"], t["orders"], t["supplier"]
    nat_region = np.array([r for _, r in NATIONS])
    return {"cust_nation": _by_key(cu["c_custkey"], cu["c_nationkey"], -1),
            "order_cust": _by_key(o["o_orderkey"], o["o_custkey"], 0),
            "order_date": _by_key(o["o_orderkey"], o["o_orderdate"], -1),
            "supp_nation": _by_key(su["s_suppkey"], su["s_nationkey"], -1),
            "nat_region": nat_region}


def _grouped(keys: list, values: np.ndarray):
    """(the distinct key tuples as arrays, sums) of ``values`` per key tuple."""
    packed = np.stack(keys, axis=1) if keys else np.zeros((len(values), 0), np.int64)
    uniq, inv = np.unique(packed, axis=0, return_inverse=True)
    return uniq, np.bincount(inv.reshape(-1), weights=values, minlength=len(uniq))


def q05_reference(t: dict) -> dict:
    lk, o, li = _lookups(t), t["orders"], t["lineitem"]
    region = REGIONS.index(Q05_REGION)
    in_year = (o["o_orderdate"] >= Q05_DATE) & (o["o_orderdate"] < _day(1995, 1, 1))
    order_ok = _by_key(o["o_orderkey"], in_year, False)
    rows = np.flatnonzero(order_ok[li["l_orderkey"]])
    cnat = lk["cust_nation"][lk["order_cust"][li["l_orderkey"][rows]]]
    snat = lk["supp_nation"][li["l_suppkey"][rows]]
    keep = (cnat == snat) & (lk["nat_region"][snat] == region)
    rev = np.bincount(snat[keep], weights=_rev(li, rows[keep]), minlength=25)
    present = np.flatnonzero(np.bincount(snat[keep], minlength=25))
    order = present[np.argsort(-rev[present], kind="stable")]
    return {"n_name": [NATIONS[i][0] for i in order], "revenue": [float(rev[i]) for i in order]}


def q07_reference(t: dict) -> dict:
    lk, li = _lookups(t), t["lineitem"]
    a, b = (next(i for i, (n, _) in enumerate(NATIONS) if n == name) for name in Q07_NATIONS)
    ship = (li["l_shipdate"] >= Q07_DATE_LO) & (li["l_shipdate"] <= Q07_DATE_HI)
    rows = np.flatnonzero(ship)
    snat = lk["supp_nation"][li["l_suppkey"][rows]]
    cnat = lk["cust_nation"][lk["order_cust"][li["l_orderkey"][rows]]]
    keep = ((snat == a) & (cnat == b)) | ((snat == b) & (cnat == a))
    rows, snat, cnat = rows[keep], snat[keep], cnat[keep]
    year = _year_of_day(li["l_shipdate"][rows])
    uniq, sums = _grouped([snat, cnat, year], _rev(li, rows))
    out = sorted((NATIONS[s][0], NATIONS[cn][0], int(y), float(v))
                 for (s, cn, y), v in zip(uniq, sums))
    return {"supp_nation": [r[0] for r in out], "cust_nation": [r[1] for r in out],
            "l_year": [r[2] for r in out], "revenue": [r[3] for r in out]}


def q08_reference(t: dict) -> dict:
    lk, o, li, p = _lookups(t), t["orders"], t["lineitem"], t["part"]
    region = REGIONS.index(Q08_REGION)
    brazil = next(i for i, (n, _) in enumerate(NATIONS) if n == Q08_NATION)
    part_ok = _by_key(p["p_partkey"], _np(pc.equal(p["p_type"], Q08_TYPE)), False)
    in_dates = (o["o_orderdate"] >= Q07_DATE_LO) & (o["o_orderdate"] <= Q07_DATE_HI)
    cust_region = lk["nat_region"][lk["cust_nation"][o["o_custkey"]]]
    order_ok = _by_key(o["o_orderkey"], in_dates & (cust_region == region), False)
    rows = np.flatnonzero(part_ok[li["l_partkey"]] & order_ok[li["l_orderkey"]])
    year = _year_of_day(lk["order_date"][li["l_orderkey"][rows]])
    vol = _rev(li, rows)
    is_brazil = lk["supp_nation"][li["l_suppkey"][rows]] == brazil
    years = np.unique(year)
    share = [float(vol[(year == y) & is_brazil].sum() / vol[year == y].sum()) for y in years]
    return {"o_year": [int(y) for y in years], "mkt_share": share}


def q09_reference(t: dict) -> dict:
    lk, li, p, ps = _lookups(t), t["lineitem"], t["part"], t["partsupp"]
    green = _by_key(p["p_partkey"], _np(pc.match_substring(p["p_name"], Q09_COLOR)), False)
    rows = np.flatnonzero(green[li["l_partkey"]])
    span = int(ps["ps_suppkey"].max(initial=0)) + 1
    ps_key = ps["ps_partkey"].astype(np.int64) * span + ps["ps_suppkey"]
    order = np.argsort(ps_key, kind="stable")
    line_key = li["l_partkey"][rows].astype(np.int64) * span + li["l_suppkey"][rows]
    at = order[np.searchsorted(ps_key, line_key, sorter=order)]
    cost = ps["ps_supplycost"][at].astype(np.float64) * li["l_quantity"][rows]
    amount = _rev(li, rows) - cost
    nation = lk["supp_nation"][li["l_suppkey"][rows]]
    year = _year_of_day(lk["order_date"][li["l_orderkey"][rows]])
    uniq, sums = _grouped([nation, year], amount)
    out = sorted(((NATIONS[n][0], -int(y), float(v)) for (n, y), v in zip(uniq, sums)))
    return {"nation": [r[0] for r in out], "o_year": [-r[1] for r in out],
            "sum_profit": [r[2] for r in out]}


def q10_reference(t: dict) -> dict:
    """Every customer with returned revenue, in q10's order (revenue
    descending, then key); the query keeps the first ``Q10_TOP``."""
    lk, o, li = _lookups(t), t["orders"], t["lineitem"]
    in_quarter = (o["o_orderdate"] >= Q10_DATE) & (o["o_orderdate"] < _day(1994, 1, 1))
    order_ok = _by_key(o["o_orderkey"], in_quarter, False)
    returned = _np(pc.equal(li["l_returnflag"], "R"))
    rows = np.flatnonzero(order_ok[li["l_orderkey"]] & returned)
    cust = lk["order_cust"][li["l_orderkey"][rows]]
    keys, inv = np.unique(cust, return_inverse=True)
    rev = np.bincount(inv, weights=_rev(li, rows), minlength=len(keys))
    order = np.lexsort((keys, -rev))
    keys = keys[order]
    return {"c_custkey": [int(k) for k in keys],
            "n_name": [NATIONS[n][0] for n in lk["cust_nation"][keys]],
            "revenue": [float(r) for r in rev[order]]}


def q12_reference(t: dict) -> dict:
    o, li = t["orders"], t["lineitem"]
    mode = _codes(li["l_shipmode"], _dict(SHIPMODES))
    keep = (np.isin(mode, [SHIPMODES.index(m) for m in Q12_SHIPMODES])
            & (li["l_commitdate"] < li["l_receiptdate"])
            & (li["l_shipdate"] < li["l_commitdate"])
            & (li["l_receiptdate"] >= Q12_DATE) & (li["l_receiptdate"] < _day(1995, 1, 1)))
    prio = _by_key(o["o_orderkey"], _codes(o["o_orderpriority"], _PRIORITIES).astype(np.int8), -1)
    urgent = prio[li["l_orderkey"][keep]] <= 1
    modes = mode[keep]
    out = {"l_shipmode": [], "high_line_count": [], "low_line_count": []}
    for m in sorted(set(modes.tolist()), key=lambda i: SHIPMODES[i]):
        out["l_shipmode"].append(SHIPMODES[m])
        out["high_line_count"].append(int((urgent & (modes == m)).sum()))
        out["low_line_count"].append(int((~urgent & (modes == m)).sum()))
    return out


def q13_reference(t: dict) -> dict:
    """Arrow's own SQL LIKE (``match_like``) decides the comments."""
    cu, o = t["customer"], t["orders"]
    kept = ~_np(pc.match_like(o["o_comment"], Q13_PATTERN))
    per_cust = np.bincount(o["o_custkey"][kept], minlength=int(cu["c_custkey"].max()) + 1)
    counts = np.bincount(per_cust[cu["c_custkey"]])
    present = np.flatnonzero(counts)
    order = present[np.lexsort((-present, -counts[present]))]
    return {"c_count": [int(c) for c in order], "custdist": [int(counts[c]) for c in order]}


def q14_reference(t: dict) -> dict:
    li, p = t["lineitem"], t["part"]
    promo = _by_key(p["p_partkey"], _np(pc.starts_with(p["p_type"], "PROMO")), False)
    rows = np.flatnonzero((li["l_shipdate"] >= Q14_DATE) & (li["l_shipdate"] < _day(1995, 10, 1)))
    rev = _rev(li, rows)
    return {"promo_revenue": [float(100.0 * rev[promo[li["l_partkey"][rows]]].sum() / rev.sum())]}


def q19_reference(t: dict) -> dict:
    li, p = t["lineitem"], t["part"]
    air = np.isin(_codes(li["l_shipmode"], _dict(SHIPMODES)), [SHIPMODES.index("AIR")])
    person = _np(pc.equal(li["l_shipinstruct"], "DELIVER IN PERSON"))
    rows = np.flatnonzero(air & person)
    part = li["l_partkey"][rows]
    brand = _by_key(p["p_partkey"], _codes(p["p_brand"], _dict(BRANDS)).astype(np.int16), -1)[part]
    container = _by_key(p["p_partkey"], _codes(p["p_container"], _dict(CONTAINERS))
                        .astype(np.int16), -1)[part]
    size = _by_key(p["p_partkey"], p["p_size"], 0)[part]
    qty = li["l_quantity"][rows]
    keep = np.zeros(len(rows), bool)
    for i in range(3):
        q = Q19_QUANTITIES[i]
        keep |= ((brand == BRANDS.index(Q19_BRANDS[i]))
                 & np.isin(container, [CONTAINERS.index(x) for x in Q19_CONTAINERS[i]])
                 & (qty >= q) & (qty <= q + 10) & (size >= 1) & (size <= Q19_SIZES[i]))
    return {"revenue": [float(_rev(li, rows[keep]).sum())]}


EXPR_REFERENCES = {"q05": q05_reference, "q07": q07_reference, "q08": q08_reference,
                   "q09": q09_reference, "q10": q10_reference, "q12": q12_reference,
                   "q13": q13_reference, "q14": q14_reference, "q19": q19_reference}


def expr_compare(name: str, out: dict, ref: dict, rtol: float) -> List[str]:
    """The problems of query ``name``'s result (``to_pydict``) against its
    reference: the key columns (strings and integers) exact and in order, each
    float within ``rtol`` of the reference. q10 keeps the reference's first
    ``Q10_TOP`` rows; two adjacent customers whose revenues lie within
    ``rtol`` of each other may come in either order."""
    problems: List[str] = []
    if set(out) != set(ref):
        return [f"{name}: columns {sorted(out)}, want {sorted(ref)}"]
    if name == "q10":
        ref = {k: v[:Q10_TOP] for k, v in ref.items()}
        if out["c_custkey"] != ref["c_custkey"]:
            pos = {k: i for i, k in enumerate(ref["c_custkey"])}
            if sorted(out["c_custkey"]) != sorted(ref["c_custkey"]):
                return [f"q10: customers {out['c_custkey']}, want {ref['c_custkey']}"]
            for i, k in enumerate(out["c_custkey"]):
                j = pos[k]
                a, b = ref["revenue"][i], ref["revenue"][j]
                if abs(a - b) > rtol * abs(b):
                    problems.append(f"q10: customer {k} at {i}, the reference's at {j}, "
                                    f"revenues {a!r} and {b!r} further apart than {rtol}")
            ref = {col: [ref[col][pos[k]] for k in out["c_custkey"]] for col in ref}
    for col, want in ref.items():
        got = out[col]
        if len(got) != len(want):
            problems.append(f"{name}.{col}: {len(got)} rows, want {len(want)}")
            continue
        if want and isinstance(want[0], float):
            bad = [(g, w) for g, w in zip(got, want)
                   if g is None or abs(g - w) > rtol * abs(w)]
            if bad:
                problems.append(f"{name}.{col}: {len(bad)} values beyond rtol {rtol}, "
                                f"first {bad[0]}")
        elif list(got) != list(want):
            problems.append(f"{name}.{col}: {list(got)[:8]} vs {list(want)[:8]}")
    return problems
