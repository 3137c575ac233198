"""TPC-H q01-q22 as SQL text, for ``daft_tpu_torch.sql``.

The text is the JAX package's TPC-H suite's (its ``tests/benchmarks`` runs
the 22 through ``daft_tpu.sql``) with the specification's validation
parameters (TPC-H clause 2.4) where that suite departs from them: q02's TYPE
BRASS, q11's FRACTION 0.0001 / SF (``sql_text`` fills it in for the scale
factor) and q18's QUANTITY 300, and q19's ship modes as the specification
writes them (``'AIR', 'AIR REG'``). The tables are ``tools/tpch.sql_frames``:
each date column a ``date32``, so the ``DATE '...'`` literals compare as
dates.
"""

QUERIES = {
    "q01": """
SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
       avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem WHERE l_shipdate <= DATE '1998-09-02'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus""",
    "q02": """
SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
FROM part
JOIN partsupp ON p_partkey = ps_partkey
JOIN supplier ON s_suppkey = ps_suppkey
JOIN nation ON s_nationkey = n_nationkey
JOIN region ON n_regionkey = r_regionkey
WHERE p_size = 15 AND p_type LIKE '%BRASS' AND r_name = 'EUROPE'
  AND ps_supplycost = (
    SELECT min(ps_supplycost) FROM partsupp
    JOIN supplier ON s_suppkey = ps_suppkey
    JOIN nation ON s_nationkey = n_nationkey
    JOIN region ON n_regionkey = r_regionkey
    WHERE p_partkey = ps_partkey AND r_name = 'EUROPE')
ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
LIMIT 100""",
    "q03": """
SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
       o_orderdate, o_shippriority
FROM customer
JOIN orders ON c_custkey = o_custkey
JOIN lineitem ON l_orderkey = o_orderkey
WHERE c_mktsegment = 'BUILDING' AND o_orderdate < DATE '1995-03-15'
  AND l_shipdate > DATE '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate, l_orderkey
LIMIT 10""",
    "q04": """
SELECT o_orderpriority, count(*) AS order_count FROM orders
WHERE o_orderdate >= DATE '1993-07-01' AND o_orderdate < DATE '1993-10-01'
  AND EXISTS (SELECT 1 FROM lineitem
              WHERE l_orderkey = o_orderkey AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority ORDER BY o_orderpriority""",
    "q05": """
SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer
JOIN orders ON c_custkey = o_custkey
JOIN lineitem ON l_orderkey = o_orderkey
JOIN supplier ON l_suppkey = s_suppkey AND c_nationkey = s_nationkey
JOIN nation ON s_nationkey = n_nationkey
JOIN region ON n_regionkey = r_regionkey
WHERE r_name = 'ASIA' AND o_orderdate >= DATE '1994-01-01'
  AND o_orderdate < DATE '1995-01-01'
GROUP BY n_name ORDER BY revenue DESC""",
    "q06": """
SELECT sum(l_extendedprice * l_discount) AS revenue FROM lineitem
WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < DATE '1995-01-01'
  AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24""",
    "q07": """
SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue FROM (
  SELECT n1_name AS supp_nation, n2_name AS cust_nation,
         year(l_shipdate) AS l_year,
         l_extendedprice * (1 - l_discount) AS volume
  FROM supplier
  JOIN lineitem ON s_suppkey = l_suppkey
  JOIN orders ON o_orderkey = l_orderkey
  JOIN customer ON c_custkey = o_custkey
  JOIN (SELECT n_nationkey AS n1_key, n_name AS n1_name FROM nation) n1
    ON s_nationkey = n1_key
  JOIN (SELECT n_nationkey AS n2_key, n_name AS n2_name FROM nation) n2
    ON c_nationkey = n2_key
  WHERE l_shipdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'
    AND ((n1_name = 'FRANCE' AND n2_name = 'GERMANY')
      OR (n1_name = 'GERMANY' AND n2_name = 'FRANCE'))
) shipping
GROUP BY supp_nation, cust_nation, l_year
ORDER BY supp_nation, cust_nation, l_year""",
    "q08": """
SELECT o_year, sum(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0.0 END) / sum(volume)
       AS mkt_share
FROM (
  SELECT year(o_orderdate) AS o_year,
         l_extendedprice * (1 - l_discount) AS volume, n2_name AS nation
  FROM part
  JOIN lineitem ON p_partkey = l_partkey
  JOIN supplier ON s_suppkey = l_suppkey
  JOIN orders ON l_orderkey = o_orderkey
  JOIN customer ON o_custkey = c_custkey
  JOIN (SELECT n_nationkey AS n1_key, n_regionkey AS n1_rk FROM nation) n1
    ON c_nationkey = n1_key
  JOIN (SELECT n_nationkey AS n2_key, n_name AS n2_name FROM nation) n2
    ON s_nationkey = n2_key
  JOIN region ON n1_rk = r_regionkey
  WHERE r_name = 'AMERICA' AND o_orderdate BETWEEN DATE '1995-01-01'
    AND DATE '1996-12-31' AND p_type = 'ECONOMY ANODIZED STEEL'
) all_nations
GROUP BY o_year ORDER BY o_year""",
    "q09": """
SELECT nation, o_year, sum(amount) AS sum_profit FROM (
  SELECT n_name AS nation, year(o_orderdate) AS o_year,
         l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity AS amount
  FROM part
  JOIN lineitem ON p_partkey = l_partkey
  JOIN supplier ON s_suppkey = l_suppkey
  JOIN partsupp ON ps_suppkey = l_suppkey AND ps_partkey = l_partkey
  JOIN orders ON o_orderkey = l_orderkey
  JOIN nation ON s_nationkey = n_nationkey
  WHERE p_name LIKE '%green%'
) profit
GROUP BY nation, o_year ORDER BY nation, o_year DESC""",
    "q10": """
SELECT c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) AS revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
FROM customer
JOIN orders ON c_custkey = o_custkey
JOIN lineitem ON l_orderkey = o_orderkey
JOIN nation ON c_nationkey = n_nationkey
WHERE o_orderdate >= DATE '1993-10-01' AND o_orderdate < DATE '1994-01-01'
  AND l_returnflag = 'R'
GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
ORDER BY revenue DESC, c_custkey LIMIT 20""",
    "q11": """
SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
FROM partsupp
JOIN supplier ON ps_suppkey = s_suppkey
JOIN nation ON s_nationkey = n_nationkey
WHERE n_name = 'GERMANY'
GROUP BY ps_partkey
HAVING sum(ps_supplycost * ps_availqty) > (
  SELECT sum(ps_supplycost * ps_availqty) * {q11_fraction} FROM partsupp
  JOIN supplier ON ps_suppkey = s_suppkey
  JOIN nation ON s_nationkey = n_nationkey
  WHERE n_name = 'GERMANY')
ORDER BY value DESC, ps_partkey""",
    "q12": """
SELECT l_shipmode,
       sum(CASE WHEN o_orderpriority = '1-URGENT' OR o_orderpriority = '2-HIGH'
           THEN 1 ELSE 0 END) AS high_line_count,
       sum(CASE WHEN o_orderpriority <> '1-URGENT' AND o_orderpriority <> '2-HIGH'
           THEN 1 ELSE 0 END) AS low_line_count
FROM orders JOIN lineitem ON o_orderkey = l_orderkey
WHERE l_shipmode IN ('MAIL', 'SHIP') AND l_commitdate < l_receiptdate
  AND l_shipdate < l_commitdate AND l_receiptdate >= DATE '1994-01-01'
  AND l_receiptdate < DATE '1995-01-01'
GROUP BY l_shipmode ORDER BY l_shipmode""",
    "q13": """
SELECT c_count, count(*) AS custdist FROM (
  SELECT c_custkey, count(o_orderkey) AS c_count
  FROM customer LEFT JOIN orders ON c_custkey = o_custkey
    AND o_comment NOT LIKE '%special%requests%'
  GROUP BY c_custkey
) c_orders
GROUP BY c_count ORDER BY custdist DESC, c_count DESC""",
    "q14": """
SELECT 100.00 * sum(CASE WHEN p_type LIKE 'PROMO%'
                    THEN l_extendedprice * (1 - l_discount) ELSE 0.0 END)
       / sum(l_extendedprice * (1 - l_discount)) AS promo_revenue
FROM lineitem JOIN part ON l_partkey = p_partkey
WHERE l_shipdate >= DATE '1995-09-01' AND l_shipdate < DATE '1995-10-01'""",
    "q15": """
WITH revenue AS (
  SELECT l_suppkey AS supplier_no, sum(l_extendedprice * (1 - l_discount))
         AS total_revenue
  FROM lineitem WHERE l_shipdate >= DATE '1996-01-01'
    AND l_shipdate < DATE '1996-04-01'
  GROUP BY l_suppkey)
SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier JOIN revenue ON s_suppkey = supplier_no
WHERE total_revenue = (SELECT max(total_revenue) FROM revenue)
ORDER BY s_suppkey""",
    "q16": """
SELECT p_brand, p_type, p_size, count(DISTINCT ps_suppkey) AS supplier_cnt
FROM partsupp JOIN part ON p_partkey = ps_partkey
WHERE p_brand <> 'Brand#45' AND p_type NOT LIKE 'MEDIUM POLISHED%'
  AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
  AND ps_suppkey NOT IN (
    SELECT s_suppkey FROM supplier WHERE s_comment LIKE '%Customer%Complaints%')
GROUP BY p_brand, p_type, p_size
ORDER BY supplier_cnt DESC, p_brand, p_type, p_size""",
    "q17": """
SELECT sum(l_extendedprice) / 7.0 AS avg_yearly
FROM lineitem JOIN part ON p_partkey = l_partkey
WHERE p_brand = 'Brand#23' AND p_container = 'MED BOX'
  AND l_quantity < (SELECT 0.2 * avg(l_quantity) FROM lineitem
                    WHERE l_partkey = p_partkey)""",
    "q18": """
SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity) AS total_qty
FROM customer
JOIN orders ON c_custkey = o_custkey
JOIN lineitem ON o_orderkey = l_orderkey
WHERE o_orderkey IN (
  SELECT l_orderkey FROM lineitem GROUP BY l_orderkey
  HAVING sum(l_quantity) > 300)
GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate, o_orderkey LIMIT 100""",
    "q19": """
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem JOIN part ON p_partkey = l_partkey
WHERE (p_brand = 'Brand#12' AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       AND l_quantity >= 1 AND l_quantity <= 11 AND p_size BETWEEN 1 AND 5
       AND l_shipmode IN ('AIR', 'AIR REG') AND l_shipinstruct = 'DELIVER IN PERSON')
   OR (p_brand = 'Brand#23' AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       AND l_quantity >= 10 AND l_quantity <= 20 AND p_size BETWEEN 1 AND 10
       AND l_shipmode IN ('AIR', 'AIR REG') AND l_shipinstruct = 'DELIVER IN PERSON')
   OR (p_brand = 'Brand#34' AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       AND l_quantity >= 20 AND l_quantity <= 30 AND p_size BETWEEN 1 AND 15
       AND l_shipmode IN ('AIR', 'AIR REG') AND l_shipinstruct = 'DELIVER IN PERSON')""",
    "q20": """
SELECT s_name, s_address FROM supplier
JOIN nation ON s_nationkey = n_nationkey
WHERE n_name = 'CANADA' AND s_suppkey IN (
  SELECT ps_suppkey FROM partsupp
  WHERE ps_partkey IN (SELECT p_partkey FROM part WHERE p_name LIKE 'forest%')
    AND ps_availqty > (SELECT 0.5 * sum(l_quantity) FROM lineitem
                       WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
                         AND l_shipdate >= DATE '1994-01-01'
                         AND l_shipdate < DATE '1995-01-01'))
ORDER BY s_name""",
    "q21": """
SELECT s_name, count(*) AS numwait FROM supplier
JOIN lineitem ON s_suppkey = l_suppkey
JOIN orders ON o_orderkey = l_orderkey
JOIN nation ON s_nationkey = n_nationkey
WHERE o_orderstatus = 'F' AND l_receiptdate > l_commitdate
  AND n_name = 'SAUDI ARABIA'
  AND EXISTS (SELECT 1 FROM lineitem l2
              WHERE l2.l_orderkey = lineitem.l_orderkey
                AND l2.l_suppkey <> lineitem.l_suppkey)
  AND NOT EXISTS (SELECT 1 FROM lineitem l3
                  WHERE l3.l_orderkey = lineitem.l_orderkey
                    AND l3.l_suppkey <> lineitem.l_suppkey
                    AND l3.l_receiptdate > l3.l_commitdate)
GROUP BY s_name ORDER BY numwait DESC, s_name LIMIT 100""",
    "q22": """
SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal FROM (
  SELECT substring(c_phone, 1, 2) AS cntrycode, c_acctbal FROM customer
  WHERE substring(c_phone, 1, 2) IN ('13', '31', '23', '29', '30', '18', '17')
    AND c_acctbal > (SELECT avg(c_acctbal) FROM customer
                     WHERE c_acctbal > 0.00
                       AND substring(c_phone, 1, 2) IN
                           ('13', '31', '23', '29', '30', '18', '17'))
    AND NOT EXISTS (SELECT 1 FROM orders WHERE o_custkey = c_custkey)
) custsale
GROUP BY cntrycode ORDER BY cntrycode""",
}

#: The queries ``daft_tpu_torch.sql`` runs: all 22.
RUNNABLE = tuple(QUERIES)


def sql_text(name: str, scale_factor: float) -> str:
    """Query ``name``'s text at ``scale_factor`` (q11's fraction is
    0.0001 / SF)."""
    return QUERIES[name].replace("{q11_fraction}", repr(0.0001 / scale_factor))
