"""The 22 TPC-H queries as templates of their substitution parameters.

The texts are sqlrs_tpu_torch/benchmarks/tpch_queries.py's, letter for
letter once the spec's validation parameters are filled in (TPC-H v3
clause 2.4; the CPU tests hold them to the package's), with each
substitution parameter of clauses 2.4.1.3-2.4.22.3 a `{NAME}` field. The
package's notes hold: comma-FROM lists are ordered so that every level of
the left-deep join chain has an equality link, Q15 is its view, the query
and the drop, and date windows are literals (the engine reproduces the
reference's interval packing, so windows never go through interval
arithmetic).

`derive(qn, raw, sf)` turns a query's raw parameters (as qgen draws them,
or the validation values) into the fields its text and its oracle read;
`statements(qn, fields)` gives the statements of one execution.
"""

from __future__ import annotations

import numpy as np

Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
       sum(l_extendedprice) as sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
       avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price,
       avg(l_discount) as avg_disc, count(*) as count_order
from lineitem
where l_shipdate <= date '{D1}'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""

Q2 = """
select s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone, s_comment
from part, partsupp, supplier, nation, region
where p_partkey = ps_partkey and s_suppkey = ps_suppkey
  and p_size = {SIZE} and p_type like '%{TYPE}'
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = '{REGION}'
  and ps_supplycost = (
        select min(ps_supplycost)
        from partsupp, supplier, nation, region
        where p_partkey = ps_partkey and s_suppkey = ps_suppkey
          and s_nationkey = n_nationkey and n_regionkey = r_regionkey
          and r_name = '{REGION}')
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
"""

Q3 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = '{SEGMENT}' and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '{DATE}' and l_shipdate > date '{DATE}'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10
"""

Q4 = """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '{DATE}'
  and o_orderdate < date '{DATE_END}'
  and exists (
        select * from lineitem
        where l_orderkey = o_orderkey and l_commitdate < l_receiptdate)
group by o_orderpriority
order by o_orderpriority
"""

Q5 = """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey and n_regionkey = r_regionkey
  and r_name = '{REGION}'
  and o_orderdate >= date '{DATE}'
  and o_orderdate < date '{DATE_END}'
group by n_name
order by revenue desc
"""

Q6 = """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '{DATE}'
  and l_shipdate < date '{DATE_END}'
  and l_discount between {DISC_LO} and {DISC_HI}
  and l_quantity < {QUANTITY}
"""

Q7 = """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (
  select n1.n_name as supp_nation, n2.n_name as cust_nation,
         extract(year from l_shipdate) as l_year,
         l_extendedprice * (1 - l_discount) as volume
  from supplier, lineitem, orders, customer, nation n1, nation n2
  where s_suppkey = l_suppkey and o_orderkey = l_orderkey
    and c_custkey = o_custkey and s_nationkey = n1.n_nationkey
    and c_nationkey = n2.n_nationkey
    and ((n1.n_name = '{NATION1}' and n2.n_name = '{NATION2}')
      or (n1.n_name = '{NATION2}' and n2.n_name = '{NATION1}'))
    and l_shipdate between date '1995-01-01' and date '1996-12-31'
) shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
"""

# FROM reordered: part links to lineitem first (part × supplier has no
# direct equality), then supplier/orders/customer/n1/region/n2 each link
# to an earlier table
Q8 = """
select o_year, sum(case when nation = '{NATION}' then volume else 0.0 end) / sum(volume) as mkt_share
from (
  select extract(year from o_orderdate) as o_year,
         l_extendedprice * (1 - l_discount) as volume,
         n2.n_name as nation
  from part, lineitem, supplier, orders, customer, nation n1, region, nation n2
  where p_partkey = l_partkey and s_suppkey = l_suppkey
    and l_orderkey = o_orderkey and o_custkey = c_custkey
    and c_nationkey = n1.n_nationkey and n1.n_regionkey = r_regionkey
    and r_name = '{REGION}' and s_nationkey = n2.n_nationkey
    and o_orderdate between date '1995-01-01' and date '1996-12-31'
    and p_type = '{TYPE}'
) all_nations
group by o_year
order by o_year
"""

# FROM reordered: part→lineitem→supplier→partsupp→orders→nation
Q9 = """
select nation, o_year, sum(amount) as sum_profit
from (
  select n_name as nation, extract(year from o_orderdate) as o_year,
         l_extendedprice * (1 - l_discount) - ps_supplycost * l_quantity as amount
  from part, lineitem, supplier, partsupp, orders, nation
  where s_suppkey = l_suppkey and ps_suppkey = l_suppkey
    and ps_partkey = l_partkey and p_partkey = l_partkey
    and o_orderkey = l_orderkey and s_nationkey = n_nationkey
    and p_name like '%{COLOR}%'
) profit
group by nation, o_year
order by nation, o_year desc
"""

Q10 = """
select c_custkey, c_name, sum(l_extendedprice * (1 - l_discount)) as revenue,
       c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey and l_orderkey = o_orderkey
  and o_orderdate >= date '{DATE}'
  and o_orderdate < date '{DATE_END}'
  and l_returnflag = 'R' and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address, c_comment
order by revenue desc
limit 20
"""

Q11 = """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
  and n_name = '{NATION}'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
  select sum(ps_supplycost * ps_availqty) * {FRACTION}
  from partsupp, supplier, nation
  where ps_suppkey = s_suppkey and s_nationkey = n_nationkey
    and n_name = '{NATION}')
order by value desc
"""

Q12 = """
select l_shipmode,
       sum(case when o_orderpriority = '1-URGENT' or o_orderpriority = '2-HIGH'
                then 1 else 0 end) as high_line_count,
       sum(case when o_orderpriority <> '1-URGENT' and o_orderpriority <> '2-HIGH'
                then 1 else 0 end) as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey
  and l_shipmode in ('{SHIPMODE1}', '{SHIPMODE2}')
  and l_commitdate < l_receiptdate and l_shipdate < l_commitdate
  and l_receiptdate >= date '{DATE}'
  and l_receiptdate < date '{DATE_END}'
group by l_shipmode
order by l_shipmode
"""

Q13 = """
select c_count, count(*) as custdist
from (
  select c_custkey, count(o_orderkey) as c_count
  from customer left outer join orders
    on c_custkey = o_custkey and o_comment not like '%{WORD1}%{WORD2}%'
  group by c_custkey
) c_orders
group by c_count
order by custdist desc, c_count desc
"""

Q14 = """
select 100.00 * sum(case when p_type like 'PROMO%'
                         then l_extendedprice * (1 - l_discount) else 0.0 end)
       / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '{DATE}'
  and l_shipdate < date '{DATE_END}'
"""

Q15_VIEW = """
create view revenue0 (supplier_no, total_revenue) as
  select l_suppkey, sum(l_extendedprice * (1 - l_discount))
  from lineitem
  where l_shipdate >= date '{DATE}'
    and l_shipdate < date '{DATE_END}'
  group by l_suppkey
"""
Q15 = """
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier, revenue0
where s_suppkey = supplier_no
  and total_revenue = (select max(total_revenue) from revenue0)
order by s_suppkey
"""
Q15_DROP = "drop view revenue0"

Q16 = """
select p_brand, p_type, p_size, count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey
  and p_brand <> '{BRAND}'
  and p_type not like '{TYPE}%'
  and p_size in ({SIZES})
  and ps_suppkey not in (
        select s_suppkey from supplier
        where s_comment like '%Customer%Complaints%')
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
"""

Q17 = """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey
  and p_brand = '{BRAND}' and p_container = '{CONTAINER}'
  and l_quantity < (
        select 0.2 * avg(l_quantity) from lineitem
        where l_partkey = p_partkey)
"""

Q18 = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (
        select l_orderkey from lineitem
        group by l_orderkey having sum(l_quantity) > {QUANTITY})
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100
"""

Q19 = """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where (p_partkey = l_partkey and p_brand = '{BRAND1}'
       and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       and l_quantity >= {QUANTITY1} and l_quantity <= {QUANTITY1_HI}
       and p_size between 1 and 5
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey and p_brand = '{BRAND2}'
       and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       and l_quantity >= {QUANTITY2} and l_quantity <= {QUANTITY2_HI}
       and p_size between 1 and 10
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
   or (p_partkey = l_partkey and p_brand = '{BRAND3}'
       and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       and l_quantity >= {QUANTITY3} and l_quantity <= {QUANTITY3_HI}
       and p_size between 1 and 15
       and l_shipmode in ('AIR', 'AIR REG')
       and l_shipinstruct = 'DELIVER IN PERSON')
"""

Q20 = """
select s_name, s_address
from supplier, nation
where s_suppkey in (
        select ps_suppkey from partsupp
        where ps_partkey in (
                select p_partkey from part where p_name like '{COLOR}%')
          and ps_availqty > (
                select 0.5 * sum(l_quantity) from lineitem
                where l_partkey = ps_partkey and l_suppkey = ps_suppkey
                  and l_shipdate >= date '{DATE}'
                  and l_shipdate < date '{DATE_END}'))
  and s_nationkey = n_nationkey and n_name = '{NATION}'
order by s_name
"""

Q21 = """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F' and l1.l_receiptdate > l1.l_commitdate
  and exists (
        select * from lineitem l2
        where l2.l_orderkey = l1.l_orderkey
          and l2.l_suppkey <> l1.l_suppkey)
  and not exists (
        select * from lineitem l3
        where l3.l_orderkey = l1.l_orderkey
          and l3.l_suppkey <> l1.l_suppkey
          and l3.l_receiptdate > l3.l_commitdate)
  and s_nationkey = n_nationkey and n_name = '{NATION}'
group by s_name
order by numwait desc, s_name
limit 100
"""

Q22 = """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (
  select substring(c_phone from 1 for 2) as cntrycode, c_acctbal
  from customer
  where substring(c_phone from 1 for 2) in ({CODES})
    and c_acctbal > (
          select avg(c_acctbal) from customer
          where c_acctbal > 0.00
            and substring(c_phone from 1 for 2) in
                ({CODES}))
    and not exists (
          select * from orders where o_custkey = c_custkey)
) custsale
group by cntrycode
order by cntrycode
"""

TEMPLATES = {
    1: Q1, 2: Q2, 3: Q3, 4: Q4, 5: Q5, 6: Q6, 7: Q7, 8: Q8, 9: Q9, 10: Q10,
    11: Q11, 12: Q12, 13: Q13, 14: Q14, 15: [Q15_VIEW, Q15, Q15_DROP],
    16: Q16, 17: Q17, 18: Q18, 19: Q19, 20: Q20, 21: Q21, 22: Q22,
}

# the output columns of each query's ORDER BY, in its order: rows whose
# keys tie may come in any order (the comparison sorts each run of ties)
ORDER_KEYS = {
    1: (0, 1), 2: (0, 2, 1, 3), 3: (1, 2), 4: (0,), 5: (1,), 6: (), 7: (0, 1, 2),
    8: (0,), 9: (0, 1), 10: (2,), 11: (1,), 12: (0,), 13: (1, 0), 14: (),
    15: (0,), 16: (3, 0, 1, 2), 17: (), 18: (4, 3), 19: (), 20: (0,), 21: (1, 0),
    22: (0,),
}

# a window's length after its first day, by query: months, or a year
_MONTHS = {4: 3, 10: 3, 14: 1, 15: 3}
_YEARS = {5, 6, 12, 20}

# each nation's region (TPC-H v3 clause 4.2.3), for Q8's REGION
NATION_REGION = {
    "ALGERIA": "AFRICA", "ARGENTINA": "AMERICA", "BRAZIL": "AMERICA",
    "CANADA": "AMERICA", "EGYPT": "MIDDLE EAST", "ETHIOPIA": "AFRICA",
    "FRANCE": "EUROPE", "GERMANY": "EUROPE", "INDIA": "ASIA",
    "INDONESIA": "ASIA", "IRAN": "MIDDLE EAST", "IRAQ": "MIDDLE EAST",
    "JAPAN": "ASIA", "JORDAN": "MIDDLE EAST", "KENYA": "AFRICA",
    "MOROCCO": "AFRICA", "MOZAMBIQUE": "AFRICA", "PERU": "AMERICA",
    "CHINA": "ASIA", "ROMANIA": "EUROPE", "SAUDI ARABIA": "MIDDLE EAST",
    "VIETNAM": "ASIA", "RUSSIA": "EUROPE", "UNITED KINGDOM": "EUROPE",
    "UNITED STATES": "AMERICA",
}


def _add_months(day: str, months: int) -> str:
    m = np.datetime64(day[:7], "M") + months
    return str(m) + day[7:]


def _add_days(day: str, days: int) -> str:
    return str(np.datetime64(day, "D") + days)


def derive(qn: int, raw: dict, sf: float) -> dict:
    """The fields of query qn's text and oracle from its raw parameters:
    every raw parameter as text, plus what the spec derives from them (a
    window's end, Q1's cut-off day, Q6's discount band, Q8's region,
    Q11's fraction of the scale factor, Q19's quantity bands)."""
    f = {k: (", ".join(str(x) for x in v) if isinstance(v, list) else str(v))
         for k, v in raw.items()}
    if qn == 1:
        f["D1"] = _add_days("1998-12-01", -int(raw["DELTA"]))
    if qn in _MONTHS:
        f["DATE_END"] = _add_months(raw["DATE"], _MONTHS[qn])
    if qn in _YEARS:
        f["DATE_END"] = _add_months(raw["DATE"], 12)
    if qn == 6:
        cents = round(float(raw["DISCOUNT"]) * 100)
        f["DISC_LO"] = f"{(cents - 1) / 100:.2f}"
        f["DISC_HI"] = f"{(cents + 1) / 100:.2f}"
    if qn == 8:
        f["REGION"] = NATION_REGION[raw["NATION"]]
    if qn == 11:
        f["FRACTION"] = f"{float(raw['FRACTION']) / sf:.10g}"
    if qn == 16:
        f["SIZES"] = ", ".join(str(int(x)) for x in raw["SIZES"])
    if qn == 19:
        for i in (1, 2, 3):
            f[f"QUANTITY{i}_HI"] = str(int(raw[f"QUANTITY{i}"]) + 10)
    if qn == 22:
        f["CODES"] = ", ".join(f"'{c}'" for c in raw["CODES"])
    return f


def statements(qn: int, fields: dict) -> list[str]:
    """The statements of one execution of query qn with these fields."""
    t = TEMPLATES[qn]
    return [s.format(**fields) for s in (t if isinstance(t, list) else [t])]
