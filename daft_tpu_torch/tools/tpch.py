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


def tpch_tables(scale_factor: float = 10, seed: int = 0, expressions: bool = False,
                sql: bool = False) -> dict:
    """``{"customer": {...}, "orders": {...}, "lineitem": {...}}``: each a
    dict of columns (numpy arrays, Arrow arrays for the strings) at
    ``scale_factor``, drawn from ``seed``. With ``expressions``, also the
    tables and columns of q05-q19 (``part``, ``supplier``, ``partsupp``,
    ``nation``, ``region`` and the columns the module docstring lists); with
    ``sql``, those and the rest of what q01-q22 read (``add_sql_columns``)."""
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
    expressions = expressions or sql
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
    if sql:
        add_sql_columns(tables, scale_factor, seed)
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


# --------------------------------------------------------------------------- #
# The rest of what q01-q22 read, and the tables in SQL form                    #
# --------------------------------------------------------------------------- #
#: The date columns, int32 days since EPOCH in the tables, ``date32`` in SQL.
DATE_COLUMNS = {"orders": ("o_orderdate",),
                "lineitem": ("l_shipdate", "l_commitdate", "l_receiptdate")}
MANUFACTURERS = tuple(f"Manufacturer#{m}" for m in range(1, 6))
LINESTATUS = ("F", "O")
ORDERSTATUS = ("F", "O", "P")
#: TPC-H 4.2.2.7's v-string alphabet (letters, digits, space, comma, period).
_VCHARS = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ ,.",
                        np.uint8)


def _vstring(rng, n: int, lo: int, hi: int) -> pa.Array:
    """``n`` random strings of ``lo``..``hi`` characters of the v-string
    alphabet, built from two buffers (no Python string per row)."""
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(rng.integers(lo, hi + 1, n), out=offsets[1:])
    data = _VCHARS[rng.integers(0, len(_VCHARS), int(offsets[-1]))]
    return pa.LargeStringArray.from_buffers(n, pa.py_buffer(offsets), pa.py_buffer(data))


def _digits(values: np.ndarray, width: int = 0) -> pa.Array:
    out = pc.cast(pa.array(values), pa.large_string())
    return pc.utf8_lpad(out, width, "0") if width else out


def _joined(parts, sep: str = "") -> pa.Array:
    return pc.binary_join_element_wise(*parts, pa.scalar(sep, pa.large_string()))


def _phones(rng, nationkey: np.ndarray) -> pa.Array:
    """The spec's phone: country code (nation key + 10), then 3, 3 and 4
    random digits, joined by dashes."""
    n = len(nationkey)
    return _joined([_digits(nationkey.astype(np.int32) + 10)]
                   + [_digits(rng.integers(lo, hi + 1, n, dtype=np.int32))
                      for lo, hi in ((100, 999), (100, 999), (1000, 9999))], "-")


def _names(prefix: str, keys: np.ndarray) -> pa.Array:
    """``prefix`` and the key padded to nine digits (``Customer#000000001``)."""
    return _joined([pa.scalar(prefix, pa.large_string()), _digits(keys, 9)])


def _money(rng, n: int) -> np.ndarray:
    """An account balance, -999.99..9999.99 in cents, as float32."""
    return (rng.integers(-99_999, 1_000_000, n) / 100.0).astype(np.float32)


def _supplier_comments(rng, n: int, scale_factor: float) -> pa.Array:
    """Seven-word sentences, where SF * 5 random rows hold ``Customer ...
    Complaints`` and another SF * 5 ``Customer ... Recommends`` (clause
    4.2.3's S_COMMENT), each inside the sentence's words."""
    comments = _sentence(rng, n)
    k = min(max(1, int(round(scale_factor * 5))), n // 2)
    rows = rng.choice(n, 2 * k, replace=False)
    words = rng.integers(0, len(_NOUNS), 2 * k)
    text = comments.take(pa.array(rows)).to_pylist()
    for i, (row_text, w) in enumerate(zip(text, words)):
        head = row_text.split(" ", 3)  # seven words: three before the phrase
        tag = "Complaints" if i < k else "Recommends"
        text[i] = f"{' '.join(head[:3])} Customer {_NOUNS[w]} {tag} {head[3]}"
    mask = np.zeros(n, bool)
    mask[rows] = True
    order = np.argsort(rows)
    return pc.replace_with_mask(comments, pa.array(mask),
                                pa.array([text[i] for i in order], pa.large_string()))


def add_sql_columns(tables: dict, scale_factor: float, seed: int) -> None:
    """Add to ``tpch_tables(..., expressions=True)``'s tables the columns
    that the rest of q01-q22 read, by clause 4.2.3, each from a generator of
    its own (``(seed, 8)`` on), so the columns above stay byte-identical:
    ``l_tax`` (0.00..0.08), ``l_linestatus`` (``O`` when shipped after
    CURRENTDATE, else ``F``); ``o_orderstatus`` (``F`` when all its lines are
    ``F``, ``O`` when all are ``O``, else ``P``) and ``o_totalprice`` (the sum
    of its lines' price * (1 + tax) * (1 - discount)); ``c_name``,
    ``c_address``, ``c_phone``, ``c_acctbal``, ``c_comment``; ``p_mfgr`` (the
    brand's manufacturer); ``s_name``, ``s_address``, ``s_phone``,
    ``s_acctbal``, ``s_comment`` (with the Complaints and Recommends rows);
    ``ps_availqty`` (1..9999)."""
    def gen(k):
        return np.random.default_rng((seed, k))

    li, o, cu = tables["lineitem"], tables["orders"], tables["customer"]
    p, su, ps = tables["part"], tables["supplier"], tables["partsupp"]
    n = len(li["l_orderkey"])
    li["l_tax"] = (gen(8).integers(0, 9, n) / 100.0).astype(np.float32)
    shipped = li["l_shipdate"] <= CURRENT_DAY
    li["l_linestatus"] = _take(LINESTATUS, (~shipped).astype(np.int8))
    key = li["l_orderkey"]
    starts = np.flatnonzero(np.concatenate(([True], key[1:] != key[:-1])))
    assert len(starts) == len(o["o_orderkey"]), "every order has its lines, in key order"
    lines = np.diff(np.append(starts, n))
    n_shipped = np.add.reduceat(shipped.astype(np.int32), starts)
    o["o_orderstatus"] = _take(ORDERSTATUS, np.where(
        n_shipped == lines, 0, np.where(n_shipped == 0, 1, 2)).astype(np.int8))
    del shipped, n_shipped, lines
    charge = (li["l_extendedprice"].astype(np.float64) * (1.0 + li["l_tax"].astype(np.float64))
              * (1.0 - li["l_discount"].astype(np.float64)))
    o["o_totalprice"] = np.add.reduceat(charge, starts).astype(np.float32)
    del charge, starts
    n_cust = len(cu["c_custkey"])
    cu["c_name"] = _names("Customer#", cu["c_custkey"])
    cu["c_address"] = _vstring(gen(9), n_cust, 10, 40)
    cu["c_phone"] = _phones(gen(10), cu["c_nationkey"])
    cu["c_acctbal"] = _money(gen(11), n_cust)
    cu["c_comment"] = _sentence(gen(12), n_cust)
    p["p_mfgr"] = _take(MANUFACTURERS, _codes(p["p_brand"], _dict(BRANDS)) // 5)
    n_supp = len(su["s_suppkey"])
    su["s_name"] = _names("Supplier#", su["s_suppkey"])
    su["s_address"] = _vstring(gen(13), n_supp, 10, 40)
    su["s_phone"] = _phones(gen(14), su["s_nationkey"])
    su["s_acctbal"] = _money(gen(15), n_supp)
    su["s_comment"] = _supplier_comments(gen(16), n_supp, scale_factor)
    ps["ps_availqty"] = gen(17).integers(1, 10_000, len(ps["ps_partkey"]), dtype=np.int32)


def date32(days: np.ndarray) -> pa.Array:
    """int32 days since EPOCH as an Arrow ``date32`` (days since
    1970-01-01): the day plus ``DAYS_TO_EPOCH``, viewed as a date."""
    shifted = days.astype(np.int32) + np.int32(DAYS_TO_EPOCH)
    return pa.Array.from_buffers(pa.date32(), len(shifted), [None, pa.py_buffer(shifted)])


def sql_frames(pkg, tables: dict) -> dict:
    """Every table as a ``pkg`` DataFrame for the SQL queries, each date
    column a ``date32``."""
    out = {}
    for name, cols in tables.items():
        dates = DATE_COLUMNS.get(name, ())
        out[name] = pkg.from_pydict({c: date32(v) if c in dates else v for c, v in cols.items()})
    return out


# -- the SQL queries' references ---------------------------------------------
# The rest of the validation parameters (clause 2.4) the SQL text carries.
Q02_SIZE, Q02_TYPE, Q02_REGION = 15, "BRASS", "EUROPE"
Q11_NATION = "GERMANY"
Q15_DATE = _day(1996, 1, 1)
Q16_BRAND, Q16_TYPE, Q16_SIZES = "Brand#45", "MEDIUM POLISHED", (49, 14, 23, 45, 19, 3, 36, 9)
Q17_BRAND, Q17_CONTAINER = "Brand#23", "MED BOX"
Q18_QUANTITY = 300
Q20_COLOR, Q20_NATION, Q20_DATE = "forest", "CANADA", _day(1994, 1, 1)
Q21_NATION = "SAUDI ARABIA"
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")


def _nation(name: str) -> int:
    return next(i for i, (n, _) in enumerate(NATIONS) if n == name)


def _pylist(arr, rows) -> list:
    return arr.take(pa.array(np.asarray(rows, np.int64))).to_pylist()


def _order_runs(li) -> np.ndarray:
    """The first line of each order (the lines are grouped by order)."""
    key = li["l_orderkey"]
    return np.flatnonzero(np.concatenate(([True], key[1:] != key[:-1])))


def q01_sql_reference(t: dict) -> dict:
    from daft_tpu_torch.tools.lineitem import q01_reference

    return q01_reference(t["lineitem"])


def q02_reference(t: dict) -> dict:
    p, ps, su = t["part"], t["partsupp"], t["supplier"]
    part_ok = _by_key(p["p_partkey"], (p["p_size"] == Q02_SIZE)
                      & _np(pc.ends_with(p["p_type"], Q02_TYPE)), False)
    region = REGIONS.index(Q02_REGION)
    nat_region = np.array([r for _, r in NATIONS])
    supp_row = _by_key(su["s_suppkey"], np.arange(len(su["s_suppkey"])), -1)
    srow = supp_row[ps["ps_suppkey"]]
    in_region = nat_region[su["s_nationkey"][srow]] == region
    best = np.full(int(p["p_partkey"].max(initial=0)) + 1, np.inf, np.float32)
    np.minimum.at(best, ps["ps_partkey"][in_region], ps["ps_supplycost"][in_region])
    rows = np.flatnonzero(in_region & part_ok[ps["ps_partkey"]]
                          & (ps["ps_supplycost"] == best[ps["ps_partkey"]]))
    s = srow[rows]
    cols = {"s_acctbal": [float(v) for v in su["s_acctbal"][s]],
            "s_name": _pylist(su["s_name"], s),
            "n_name": [NATIONS[k][0] for k in su["s_nationkey"][s]],
            "p_partkey": [int(k) for k in ps["ps_partkey"][rows]],
            "p_mfgr": _pylist(p["p_mfgr"], _by_key(p["p_partkey"], np.arange(len(p["p_partkey"])),
                                                    -1)[ps["ps_partkey"][rows]]),
            "s_address": _pylist(su["s_address"], s), "s_phone": _pylist(su["s_phone"], s),
            "s_comment": _pylist(su["s_comment"], s)}
    order = sorted(range(len(rows)), key=lambda i: (-cols["s_acctbal"][i], cols["n_name"][i],
                                                   cols["s_name"][i], cols["p_partkey"][i]))[:100]
    return {k: [v[i] for i in order] for k, v in cols.items()}


def q06_sql_reference(t: dict, host_literals: bool = False) -> dict:
    from daft_tpu_torch.tools.lineitem import q06_reference

    return {"revenue": [q06_reference(t["lineitem"], host_literals)]}


def q10_sql_reference(t: dict) -> dict:
    """q10's reference with the customer's columns that the SQL form returns."""
    ref = q10_reference(t)
    cu = t["customer"]
    row = _by_key(cu["c_custkey"], np.arange(len(cu["c_custkey"])), -1)[
        np.asarray(ref["c_custkey"], np.int64)]
    return {"c_custkey": ref["c_custkey"], "c_name": _pylist(cu["c_name"], row),
            "revenue": ref["revenue"], "c_acctbal": [float(v) for v in cu["c_acctbal"][row]],
            "n_name": ref["n_name"], "c_address": _pylist(cu["c_address"], row),
            "c_phone": _pylist(cu["c_phone"], row), "c_comment": _pylist(cu["c_comment"], row)}


def q11_reference(t: dict, scale_factor: float) -> dict:
    """The value (f64 products of the f32 cost and the int32 quantity, f64
    sums) per part of GERMANY's suppliers above 0.0001 / SF of the total."""
    ps, su = t["partsupp"], t["supplier"]
    nat = _by_key(su["s_suppkey"], su["s_nationkey"], -1)[ps["ps_suppkey"]]
    rows = np.flatnonzero(nat == _nation(Q11_NATION))
    value = ps["ps_supplycost"][rows].astype(np.float64) * ps["ps_availqty"][rows]
    keys, inv = np.unique(ps["ps_partkey"][rows], return_inverse=True)
    sums = np.bincount(inv, weights=value, minlength=len(keys))
    keep = sums > value.sum() * (0.0001 / scale_factor)
    keys, sums = keys[keep], sums[keep]
    order = np.lexsort((keys, -sums))
    return {"ps_partkey": [int(k) for k in keys[order]], "value": [float(v) for v in sums[order]]}


def _q15_revenue(t: dict):
    li = t["lineitem"]
    rows = np.flatnonzero((li["l_shipdate"] >= Q15_DATE) & (li["l_shipdate"] < _day(1996, 4, 1)))
    keys, inv = np.unique(li["l_suppkey"][rows], return_inverse=True)
    return keys, np.bincount(inv, weights=_rev(li, rows), minlength=len(keys))


def q15_reference(t: dict) -> dict:
    """The supplier(s) of the largest revenue of 1996's first quarter. The
    query compares the sums as it computes them (float32), so ``near`` lists
    every supplier within 1e-6 of the largest f64 sum, any of which it may
    return."""
    su = t["supplier"]
    keys, rev = _q15_revenue(t)
    top = rev.max()
    best = keys[rev == top]
    row = _by_key(su["s_suppkey"], np.arange(len(su["s_suppkey"])), -1)[best]
    return {"s_suppkey": [int(k) for k in best], "s_name": _pylist(su["s_name"], row),
            "s_address": _pylist(su["s_address"], row), "s_phone": _pylist(su["s_phone"], row),
            "total_revenue": [float(top)] * len(best),
            "near": [int(k) for k in keys[rev >= top * (1 - 1e-6)]]}


def q17_reference(t: dict) -> dict:
    """The yearly average of the prices of Brand#23 MED BOX lines whose
    quantity is under a fifth of their part's average quantity (over all of
    the part's lines; the compare in f64)."""
    li, p = t["lineitem"], t["part"]
    part_ok = _by_key(p["p_partkey"], _np(pc.equal(p["p_brand"], Q17_BRAND))
                      & _np(pc.equal(p["p_container"], Q17_CONTAINER)), False)
    pk = li["l_partkey"]
    n = np.bincount(pk)
    avg = np.bincount(pk, weights=li["l_quantity"].astype(np.float64)) / np.maximum(n, 1)
    rows = np.flatnonzero(part_ok[pk])
    rows = rows[li["l_quantity"][rows] < 0.2 * avg[pk[rows]]]
    return {"avg_yearly": [float(li["l_extendedprice"][rows].astype(np.float64).sum() / 7.0)]}


def q18_reference(t: dict) -> dict:
    li, o, cu = t["lineitem"], t["orders"], t["customer"]
    starts = _order_runs(li)
    qty = np.add.reduceat(li["l_quantity"].astype(np.int64), starts)
    big = np.flatnonzero(qty > Q18_QUANTITY)  # order rows: the orders are in key order
    order = np.lexsort((o["o_orderkey"][big], o["o_orderdate"][big], -o["o_totalprice"][big]))
    big = big[order][:100]
    cust = o["o_custkey"][big]
    crow = _by_key(cu["c_custkey"], np.arange(len(cu["c_custkey"])), -1)[cust]
    return {"c_name": _pylist(cu["c_name"], crow), "c_custkey": [int(k) for k in cust],
            "o_orderkey": [int(k) for k in o["o_orderkey"][big]],
            "o_orderdate": [int(d) for d in o["o_orderdate"][big]],
            "o_totalprice": [float(v) for v in o["o_totalprice"][big]],
            "total_qty": [int(q) for q in qty[big]]}


def q20_reference(t: dict) -> dict:
    """CANADA's suppliers with a forest part whose available quantity
    exceeds half of 1994's shipped quantity of that part from them (a pair
    with no such lines has a null sum, which no quantity exceeds)."""
    li, p, ps, su = t["lineitem"], t["part"], t["partsupp"], t["supplier"]
    forest = _by_key(p["p_partkey"], _np(pc.starts_with(p["p_name"], Q20_COLOR)), False)
    span = int(max(su["s_suppkey"].max(initial=0), li["l_suppkey"].max(initial=0))) + 1
    rows = np.flatnonzero((li["l_shipdate"] >= Q20_DATE) & (li["l_shipdate"] < _day(1995, 1, 1)))
    line_key = li["l_partkey"][rows].astype(np.int64) * span + li["l_suppkey"][rows]
    keys, inv = np.unique(line_key, return_inverse=True)
    sums = np.bincount(inv, weights=li["l_quantity"][rows].astype(np.float64), minlength=len(keys))
    cand = np.flatnonzero(forest[ps["ps_partkey"]])
    ps_key = ps["ps_partkey"][cand].astype(np.int64) * span + ps["ps_suppkey"][cand]
    at = np.minimum(np.searchsorted(keys, ps_key), max(len(keys) - 1, 0))
    has = (len(keys) > 0) & (keys[at] == ps_key) if len(keys) else np.zeros(len(cand), bool)
    ok = has & (ps["ps_availqty"][cand] > 0.5 * np.where(has, sums[at] if len(keys) else 0, 0))
    supp = np.unique(ps["ps_suppkey"][cand][ok])
    srow = _by_key(su["s_suppkey"], np.arange(len(su["s_suppkey"])), -1)[supp]
    srow = srow[su["s_nationkey"][srow] == _nation(Q20_NATION)]
    names = _pylist(su["s_name"], srow)
    order = sorted(range(len(srow)), key=names.__getitem__)
    return {"s_name": [names[i] for i in order],
            "s_address": [_pylist(su["s_address"], srow)[i] for i in order]}


def q21_reference(t: dict) -> dict:
    """Per SAUDI ARABIA supplier, its late lines of F orders where another
    supplier shipped in the order and no other supplier was late."""
    li, o, su = t["lineitem"], t["orders"], t["supplier"]
    starts = _order_runs(li)
    n = len(li["l_orderkey"])
    order_of = np.repeat(np.arange(len(starts)), np.diff(np.append(starts, n)))
    s = li["l_suppkey"].astype(np.int64)
    late = li["l_receiptdate"] > li["l_commitdate"]
    lo, hi = np.minimum.reduceat(s, starts), np.maximum.reduceat(s, starts)
    big = np.int64(1) << 40
    late_lo = np.minimum.reduceat(np.where(late, s, big), starts)
    late_hi = np.maximum.reduceat(np.where(late, s, -1), starts)
    status_f = _np(pc.equal(o["o_orderstatus"], "F"))
    g = order_of
    other = (lo[g] != hi[g]) | (lo[g] != s)
    only_me_late = (late_lo[g] == s) & (late_hi[g] == s)
    nat = _by_key(su["s_suppkey"], su["s_nationkey"], -1)[li["l_suppkey"]]
    keep = late & status_f[g] & other & only_me_late & (nat == _nation(Q21_NATION))
    supp, counts = np.unique(li["l_suppkey"][keep], return_counts=True)
    srow = _by_key(su["s_suppkey"], np.arange(len(su["s_suppkey"])), -1)[supp]
    names = _pylist(su["s_name"], srow)
    order = sorted(range(len(supp)), key=lambda i: (-counts[i], names[i]))[:100]
    return {"s_name": [names[i] for i in order], "numwait": [int(counts[i]) for i in order]}


def q16_reference(t: dict) -> dict:
    """Per (brand, type, size) of the parts q16 keeps, the distinct suppliers
    of their partsupp rows, less those with ``Customer ... Complaints``
    comments, by count descending, then brand, type and size."""
    p, ps, su = t["part"], t["partsupp"], t["supplier"]
    part_ok = (~_np(pc.equal(p["p_brand"], Q16_BRAND))
               & ~_np(pc.starts_with(p["p_type"], Q16_TYPE))
               & np.isin(p["p_size"], Q16_SIZES))
    prow = _by_key(p["p_partkey"], np.arange(len(p["p_partkey"])), -1)[ps["ps_partkey"]]
    complaints = su["s_suppkey"][_np(pc.match_like(su["s_comment"], "%Customer%Complaints%"))]
    ok = np.flatnonzero(part_ok[prow] & ~np.isin(ps["ps_suppkey"], complaints))
    groups: dict = {}
    for b, ty, sz, supp in zip(_pylist(p["p_brand"], prow[ok]), _pylist(p["p_type"], prow[ok]),
                               p["p_size"][prow[ok]].tolist(), ps["ps_suppkey"][ok].tolist()):
        groups.setdefault((b, ty, sz), set()).add(supp)
    order = sorted(groups, key=lambda k: (-len(groups[k]), k))
    return {"p_brand": [k[0] for k in order], "p_type": [k[1] for k in order],
            "p_size": [k[2] for k in order], "supplier_cnt": [len(groups[k]) for k in order]}


def q22_reference(t: dict) -> dict:
    """Per country code of the seven, the customers without orders whose
    balance is above the codes' average positive balance (f64)."""
    cu, o = t["customer"], t["orders"]
    code = _np(pc.utf8_slice_codeunits(cu["c_phone"], 0, 2))
    in_codes = np.isin(code, np.array(Q22_CODES, object))
    bal = cu["c_acctbal"].astype(np.float64)
    avg = bal[in_codes & (bal > 0.0)].mean()
    has_order = np.zeros(int(cu["c_custkey"].max(initial=0)) + 1, bool)
    has_order[o["o_custkey"]] = True
    keep = in_codes & (bal > avg) & ~has_order[cu["c_custkey"]]
    codes = sorted(set(code[keep].tolist()))
    return {"cntrycode": codes,
            "numcust": [int((code[keep] == c).sum()) for c in codes],
            "totacctbal": [float(bal[keep][code[keep] == c].sum()) for c in codes]}


#: Each SQL query's reference: ``f(tables, scale_factor, host_literals)``.
SQL_REFERENCES = {
    "q01": lambda t, sf, host: q01_sql_reference(t),
    "q02": lambda t, sf, host: q02_reference(t),
    "q03": lambda t, sf, host: q03_reference(t),
    "q04": lambda t, sf, host: q04_reference(t),
    "q05": lambda t, sf, host: q05_reference(t),
    "q06": lambda t, sf, host: q06_sql_reference(t, host),
    "q07": lambda t, sf, host: q07_reference(t),
    "q08": lambda t, sf, host: q08_reference(t),
    "q09": lambda t, sf, host: q09_reference(t),
    "q10": lambda t, sf, host: q10_sql_reference(t),
    "q11": lambda t, sf, host: q11_reference(t, sf),
    "q12": lambda t, sf, host: q12_reference(t),
    "q13": lambda t, sf, host: q13_reference(t),
    "q14": lambda t, sf, host: q14_reference(t),
    "q15": lambda t, sf, host: q15_reference(t),
    "q16": lambda t, sf, host: q16_reference(t),
    "q17": lambda t, sf, host: q17_reference(t),
    "q18": lambda t, sf, host: q18_reference(t),
    "q19": lambda t, sf, host: q19_reference(t),
    "q20": lambda t, sf, host: q20_reference(t),
    "q21": lambda t, sf, host: q21_reference(t),
    "q22": lambda t, sf, host: q22_reference(t),
}


def frame_query(pkg, tables: dict, name: str):
    """Query ``name`` (q03, q04 or one of ``EXPR_QUERIES``) in DataFrame
    form over ``tables`` (int32 days), as ``pkg`` DataFrames."""
    if name in EXPR_QUERIES:
        return EXPR_QUERIES[name](pkg, expr_frames(pkg, tables, name))
    cols = Q03_COLUMNS if name == "q03" else Q04_COLUMNS
    f = {tab: pkg.from_pydict({c: tables[tab][c] for c in cc}) for tab, cc in cols.items()}
    if name == "q03":
        return q03(pkg, f["customer"], f["orders"], f["lineitem"])
    return q04(pkg, f["orders"], f["lineitem"])


def filter_on_host(chain_rows: dict, rows: int) -> bool:
    """Whether a query's filter over a table of ``rows`` rows ran on the
    host, from the device counters' ``chain_rows``: no device chain with a
    filter step saw every row (one that ran only on the rows the host's
    filter kept, such as an aggregation's, does not count). A Python-float
    bound then decides rows in f64, as ``host_literals`` references take it
    (ROADMAP C.31)."""
    return not any("filter" in kind and n >= rows for kind, n in chain_rows.items())


def _as_days(values) -> list:
    """A column of ``to_pydict`` with each ``datetime.date`` as its int day
    since EPOCH (the tables' int32 form)."""
    return [(v - EPOCH).days if isinstance(v, datetime.date) else v for v in values]


def sql_compare(name: str, out: dict, ref: dict, rtol: float) -> List[str]:
    """The problems of SQL query ``name``'s result (``to_pydict``) against
    its reference: dates as int days, keys and strings exact and in order,
    floats within ``rtol``; q03 and q10 take ``q03_compare`` / ``expr_compare``
    (near ties of their float sort keys), q15 any supplier of the reference's
    ``near`` set."""
    out = {k: _as_days(v) for k, v in out.items()}
    if name == "q03":
        ref = {k: np.asarray(v) for k, v in ref.items()}
        return q03_compare(out, ref, rtol)[0]
    if name == "q10":
        return expr_compare(name, out, ref, rtol)
    if name == "q15":
        near, ref = set(ref["near"]), {k: v for k, v in ref.items() if k != "near"}
        if not out["s_suppkey"] or not set(out["s_suppkey"]) <= near:
            return [f"q15: suppliers {out['s_suppkey']}, want some of {sorted(near)}"]
        if out["s_suppkey"] != ref["s_suppkey"]:
            return []  # another supplier within 1e-6 of the largest revenue
    return expr_compare(name, out, ref, rtol)


def frame_compare(name: str, sql_out: dict, frame_out: dict, rtol: float) -> List[str]:
    """The problems of the SQL form's result against the DataFrame form's on
    the same tables, over the DataFrame form's columns (q10's leaves out the
    customer's strings): dates as int days; each float within ``rtol`` (the
    forms' literals differ: ``1 - l_discount`` has an int literal in SQL, an
    f32 one in the DataFrame form); q03 and q10 as ``sql_compare``."""
    frame = {k: _as_days(v) for k, v in frame_out.items()}
    sql_cols = {k: _as_days(sql_out[k]) for k in frame}
    if name == "q03":
        return q03_compare(sql_cols, {k: np.asarray(v) for k, v in frame.items()}, rtol)[0]
    return expr_compare(name, sql_cols, frame, rtol)
