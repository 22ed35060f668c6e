"""TPC-H query 5's join columns (numpy only).

The tables follow the TPC-H specification's shapes from one fixed stream
(the configuration's ``draw_seed``), so every run joins the same tables:
``customers`` customers with c_nationkey uniform over the 25 nations,
``suppliers`` suppliers with s_nationkey likewise, ``orders`` orders whose
o_custkey is uniform over the customer keys that are not multiples of 3 and
whose o_orderdate is uniform over the ``order_days`` days from
``first_date`` (1992-01-01 … 1998-08-02), 1–7 lineitems an order with
l_linenumber 1..k and l_suppkey uniform over the suppliers, and the spec's
fixed nation → region table.  Keys are dense from 1 (the spec's sparse
order keys and dbgen's own streams are not reproduced).

Query 5 (Local Supplier Volume) over one region and one year is, as integer
rows, the six relations

    customer(C, N) orders(O, C) lineitem(O, L, S) supplier(S, N) nation(N, R) region(R),

orders holding the orders of the year and region the one region key: a
cycle C–O–S–N–C through the nation key customer and supplier share.  L, the
line number, keeps lineitem's primary key, so every lineitem row joins once.
``--seed`` draws the mix's variants: one region each, every region once per
five, each with a year from 1993–1997 (the spec's substitution rule).
"""

from __future__ import annotations

import numpy as np

#: the spec's nation → region table (AFRICA 0, AMERICA 1, ASIA 2, EUROPE 3, MIDDLE EAST 4)
NATION_REGION = np.array([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3, 4, 2,
                          3, 3, 1])
REGIONS = 5
#: the years Q5's [DATE] is drawn from
YEARS = (1993, 1994, 1995, 1996, 1997)


def make(config: dict, rng: np.random.Generator) -> dict:
    """The configuration's tables (the same for every ``rng``: they come
    from ``draw_seed``), with each order's year and the orders of each of
    ``YEARS``."""
    del rng
    draw = np.random.default_rng(config["draw_seed"])
    n_cust, n_supp, n_ord = config["customers"], config["suppliers"], config["orders"]
    nations = len(NATION_REGION)
    c_nation = draw.integers(0, nations, n_cust)
    s_nation = draw.integers(0, nations, n_supp)
    with_orders = np.flatnonzero(np.arange(1, n_cust + 1) % 3) + 1
    o_cust = with_orders[draw.integers(0, len(with_orders), n_ord)]
    days = np.datetime64(config["first_date"]) + draw.integers(0, config["order_days"], n_ord)
    o_year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    lines = draw.integers(1, 8, n_ord)
    l_order = np.repeat(np.arange(1, n_ord + 1), lines)
    l_number = np.arange(len(l_order)) - np.repeat(np.cumsum(lines) - lines, lines) + 1
    l_supp = draw.integers(1, n_supp + 1, len(l_order))
    orders = np.stack([np.arange(1, n_ord + 1), o_cust], axis=1)
    return {
        "customer": np.stack([np.arange(1, n_cust + 1), c_nation], axis=1),
        "orders": orders,
        "o_year": o_year,
        "lineitem": np.stack([l_order, l_number, l_supp], axis=1),
        "supplier": np.stack([np.arange(1, n_supp + 1), s_nation], axis=1),
        "nation": np.stack([np.arange(nations), NATION_REGION], axis=1),
        "orders_of_year": {y: orders[o_year == y] for y in YEARS},
    }


def draw_variants(family: str, rng: np.random.Generator, count: int) -> list:
    """``count`` Q5 variants: one region each (every region once per five),
    in an order drawn from ``rng``, each with a year drawn from ``YEARS``."""
    if family != "q5":
        raise ValueError(f"tpch has no query family {family!r}")
    regions = np.concatenate([rng.permutation(REGIONS)
                              for _ in range(-(-count // REGIONS))])[:count]
    years = rng.choice(YEARS, count)
    return [{"region": int(r), "year": int(y)} for r, y in zip(regions, years)]


def query(family: str, data: dict, params: dict) -> list:
    """Q5 over ``params``' region and year as (scheme, rows, table) triples;
    the tables the variants share are the same array objects, and so is a
    year's orders."""
    if family != "q5":
        raise ValueError(f"tpch has no query family {family!r}")
    return [(("C", "N"), data["customer"], None),
            (("O", "C"), data["orders_of_year"][params["year"]], None),
            (("O", "L", "S"), data["lineitem"], None),
            (("S", "N"), data["supplier"], None),
            (("N", "R"), data["nation"], None),
            (("R",), np.array([[params["region"]]]), None)]


def answer_rows(data: dict) -> dict:
    """Q5's result rows of every (region, year) variant, from host masks
    alone: the lineitems whose customer's nation is their supplier's, counted
    by that nation's region and their order's year."""
    o = data["lineitem"][:, 0] - 1
    c_nation = data["customer"][data["orders"][o, 1] - 1, 1]
    s_nation = data["supplier"][data["lineitem"][:, 2] - 1, 1]
    local = c_nation == s_nation
    region, year = NATION_REGION[c_nation[local]], data["o_year"][o[local]]
    return {(r, y): int(((region == r) & (year == y)).sum())
            for r in range(REGIONS) for y in YEARS}
