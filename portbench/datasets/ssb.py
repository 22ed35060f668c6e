"""Star Schema Benchmark join columns (numpy only).

lineorder's (lo_custkey, lo_suppkey, lo_partkey, lo_orderdate) are drawn
uniform and independent over the scale factor's key ranges (order dates over
the date table's days but its last ``orderdate_cutoff_days``, as TPC-H's
generator leaves them), and each dimension's one attribute (c_nation,
s_nation, p_brand1) uniform over its domain, all from the run's seed.  The
date dimension is the calendar from 1992-01-01, keyed yyyymmdd, with d_year.

Query families, over F(A,B,C,D) = lineorder and the dimensions
customer (A,A1), supplier (B,B1), part (C,C1), date (D,D1):

- ``flat``: lineorder joined to customer, supplier and part with every
  fact row kept, the denormalised table of ClickHouse's SSB instructions
  (``lineorder_flat``; lo_orderdate is carried as a column, date is not
  joined);
- ``q41``: SSB Q4.1, all five relations, the customers and suppliers of one
  region (region = nation // 5) and the parts of two manufacturers
  (manufacturer = brand // 200), the date dimension unfiltered.
"""

from __future__ import annotations

import numpy as np

REGIONS = 5
MANUFACTURERS = 5


def date_keys(config: dict) -> np.ndarray:
    """d_datekey (yyyymmdd) of the date table's days, in order."""
    days = np.datetime64(config["first_date"]) + np.arange(config["dates"])
    ymd = days.astype("datetime64[D]").astype(str)
    return np.char.replace(ymd, "-", "").astype(np.int64)


def make(config: dict, rng: np.random.Generator) -> dict:
    n = config["fact_rows"]
    keys = date_keys(config)
    years = keys // 10000
    order_days = config["dates"] - config["orderdate_cutoff_days"]
    fact = np.stack([rng.integers(1, config["customers"] + 1, n),
                     rng.integers(1, config["suppliers"] + 1, n),
                     rng.integers(1, config["parts"] + 1, n),
                     keys[rng.integers(0, order_days, n)]], axis=1)
    return {"fact": fact,
            "c_nation": rng.integers(0, config["nations"], config["customers"]),
            "s_nation": rng.integers(0, config["nations"], config["suppliers"]),
            "p_brand": rng.integers(0, config["brands"], config["parts"]),
            "date": np.stack([keys, years], axis=1)}


def draw_variants(family: str, rng: np.random.Generator, count: int) -> list:
    """``flat``: the whole join, ``count`` times.  ``q41``: one region per
    variant (every region once per five), each with a pair of manufacturers,
    in an order drawn from ``rng``."""
    if family == "flat":
        return [{} for _ in range(count)]
    if family != "q41":
        raise ValueError(f"ssb has no query family {family!r}")
    regions = np.concatenate([rng.permutation(REGIONS)
                              for _ in range(-(-count // REGIONS))])[:count]
    return [{"region": int(r),
             "mfgrs": sorted(int(m) for m in rng.choice(MANUFACTURERS, 2, replace=False))}
            for r in regions]


def query(family: str, data: dict, params: dict) -> list:
    """The query as (scheme, rows, table) triples; a dimension's rows are
    (key, attribute) for the keys its predicate keeps."""
    attrs = [data["c_nation"], data["s_nation"], data["p_brand"]]
    if family == "flat":
        keep = [np.ones(len(a), dtype=bool) for a in attrs]
    elif family == "q41":
        r = params["region"]
        keep = [attrs[0] // 5 == r, attrs[1] // 5 == r, np.isin(attrs[2] // 200, params["mfgrs"])]
    else:
        raise ValueError(f"ssb has no query family {family!r}")
    dims = [np.stack([np.flatnonzero(k) + 1, a[k]], axis=1) for k, a in zip(keep, attrs)]
    spec = [(("A", "B", "C", "D"), data["fact"], None), (("A", "A1"), dims[0], None),
            (("B", "B1"), dims[1], None), (("C", "C1"), dims[2], None)]
    if family == "q41":
        spec.append((("D", "D1"), data["date"], None))
    return spec
