"""The output chain on the device, on the CPU: the binary route's LocalJoin
over the 4-clique self-join R(A,B) S(B,C) T(A,C) U(C,D) V(A,D) W(B,D) of
degree-oriented Graph500 graphs (the ``graph500-s15.clique4`` cell's query at
test sizes), and the general route's CellJoin, which runs the same chain.

* at p = 8 the port's answer equals the plain reference join of
  ``portbench/reference/natural_join.py`` as a multiset, on two labellings of
  each graph;
* its rows equal the JAX package's dataplane run byte for byte, row order
  included: at p = 1 on a one-device mesh here, and at p = 8 on eight host
  devices in a subprocess (this file run as a script);
* a chain level sliced over its machines (forced by a small budget through a
  monkeypatch of ``DataplaneExecutor._level_budget``) gives the same bytes,
  with each sliced level inside the budget;
* the counters ``level_rows_max`` and ``pulled_rows`` read the largest
  level's valid rows and the answer's rows, and only the answer's rows are
  pulled to the host;
* the last two hold for CellJoin as well, on an SSB-shaped star (the
  ``ssb-sf1.flat`` cell's join order: part, fact, customer, supplier) and on
  a cyclic general program (the triangle over its HyperCube shares).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.hypergraph import rho as jrho
from repro.core.planner import heavy_parameter as jheavy
from repro.core.query import JoinQuery, Relation
from repro.core.taxonomy import compute_stats
from repro.mpc.executors import DataplaneExecutor as JaxExecutor
from repro.mpc.program import compile_plan
from repro_torch.core import query as tquery
from repro_torch.core import taxonomy as ttax
from repro_torch.core.hypergraph import rho
from repro_torch.core.planner import heavy_parameter
from repro_torch.mpc import DataplaneExecutor, JoinSession
from repro_torch.mpc import program as tprog

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_general_sweep_card import star  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def load(rel):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location("chain_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CLIQUES = load("portbench/datasets/graph500_cliques.py")
REFERENCE = load("portbench/reference/natural_join.py")
CONFIG = {"edgefactor": 16, "initiator": [0.57, 0.19, 0.19], "draw_seed": 0}


def clique4_spec(scale, variant=0, family="clique4"):
    """The cell's query at ``scale``: (scheme, rows, table) triples under
    labelling ``variant`` of the fixed set; ``family`` "triangle" keeps the
    first three relations."""
    data = CLIQUES.make({**CONFIG, "scale": scale}, np.random.default_rng(0))
    labels = CLIQUES.draw_variants("clique4", np.random.default_rng(0), 2)
    labels = sorted(labels, key=lambda v: v["labels"])
    spec = CLIQUES.query("clique4", data, labels[variant])
    return spec[:3] if family == "triangle" else spec


def port_query(spec):
    return tquery.query_from_arrays(spec)


def compile_both(spec, p):
    """The same query compiled by both packages at the default λ."""
    tq = port_query(spec)
    rows = tq.relations[0].data
    jq = JoinQuery.make([Relation.make(r.scheme, rows, table=r.table) for r in tq.relations])
    lam = heavy_parameter(p, float(rho(tq)))
    assert lam == jheavy(p, float(jrho(jq)))
    return (compile_plan(jq, compute_stats(jq, lam), p),
            tprog.compile_plan(tq, ttax.compute_stats(tq, lam), p))


def assert_same_bytes(got, want):
    assert got.rows.dtype == want.rows.dtype == np.int64
    assert got.rows.shape == want.rows.shape
    assert got.rows.tobytes() == want.rows.tobytes()
    assert got.count == want.count and got.per_h_counts == want.per_h_counts


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("scale", [8, 9, 10])
def test_p8_clique4_equals_the_plain_reference(scale, variant):
    spec = clique4_spec(scale, variant)
    res = JoinSession(p=8, device="cpu").submit(port_query(spec))
    attrs, want = REFERENCE.join([(s, r) for s, r, _ in spec], "cpu")
    assert attrs == ["A", "B", "C", "D"] and want.shape[0] > 0
    assert res.count == want.shape[0] == res.result.rows.shape[0]
    got = torch.from_numpy(res.result.rows)
    both = torch.unique(torch.cat([got, want]), dim=0, return_counts=True)[1]
    assert want.shape[0] == torch.unique(want, dim=0).shape[0]
    assert bool((both == 2).all())      # each reference row once in the answer, nothing else


@pytest.mark.parametrize("family", ["clique4", "triangle"])
def test_p1_rows_equal_the_reference_dataplane_in_order(family):
    jp, tp = compile_both(clique4_spec(8, family=family), 1)
    want = JaxExecutor(mesh=jax.make_mesh((1,), ("join",))).run(jp)
    got = DataplaneExecutor(1, device="cpu").run(tp)
    assert_same_bytes(got, want)


def test_p8_rows_equal_the_reference_dataplane_on_eight_devices():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, __file__], capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-3000:]}"
    for variant in (0, 1):
        assert f"mesh8 clique4 labelling {variant}: identical" in res.stdout, res.stdout


class Levels:
    """Every chain level's valid rows, row width, working bytes and
    machines, by spying on ``_chain_level``; ``budget`` replaces the
    device's."""

    def __init__(self, monkeypatch, budget=None):
        self.levels = []
        chain_level = DataplaneExecutor._chain_level
        spy = self

        def _chain_level(self, op, items):
            need = sum(self._level_bytes(it) for it in items)
            widths = {len(it.payload["scheme"]) for it in items}
            machines = items[0].payload["a"][0].shape[0]
            rows = chain_level(self, op, items)
            spy.levels.append((rows, widths.pop(), need, machines))
            return rows

        monkeypatch.setattr(DataplaneExecutor, "_chain_level", _chain_level)
        if budget is not None:
            monkeypatch.setattr(DataplaneExecutor, "_level_budget", lambda self: budget)


FAMILIES = {
    # query, the op that runs its chain, chain levels, answer columns
    "clique4": (lambda: port_query(clique4_spec(9)), "LocalJoin", 5, 4),
    "triangle": (lambda: port_query(clique4_spec(9, family="triangle")), "LocalJoin", 2, 3),
    "ssb-star": (lambda: tquery.query_from_arrays(star(n=2000), force_general=True),
                 "CellJoin", 3, 7),
    "cyclic": (lambda: tquery.general_query("triangle", n=400, dom_size=16, skew=0.5, seed=3),
               "CellJoin", 2, 3),
}


def lj_counter(res, name, op="LocalJoin"):
    found = {k: v for k, v in res.counters.items() if k.endswith(":" + name)}
    assert found and all(k.startswith(f"execute/op.{op}") for k in found)
    return sum(found.values())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sliced_levels_give_the_same_bytes_within_the_budget(monkeypatch, family):
    make, op, _, _ = FAMILIES[family]
    q = make()
    levels = Levels(monkeypatch)
    base = JoinSession(p=8, device="cpu").submit(q)
    whole = max(rows for rows, _, _, _ in levels.levels)
    budget = max(need for _, _, need, _ in levels.levels) // 3
    assert f"execute/op.{op}/slice" not in base.spans_us

    levels = Levels(monkeypatch, budget)
    session = JoinSession(p=8, device="cpu")
    cold, warm = session.submit(q), session.submit(q)
    for res in (cold, warm):
        assert res.result.rows.tobytes() == base.result.rows.tobytes()
        assert res.count == base.count and res.per_h_counts == base.per_h_counts
        assert f"execute/op.{op}/slice" in res.spans_us
    # every level ran within the budget, or over a single machine
    assert all(need <= budget or machines == 1 for _, _, need, machines in levels.levels)
    assert any(machines < 8 for _, _, _, machines in levels.levels)
    assert all(rows * 4 * w <= budget for rows, w, need, _ in levels.levels if need <= budget)
    # a slice holds fewer rows than the whole level did
    assert lj_counter(warm, "level_rows_max", op) < whole
    assert lj_counter(warm, "pulled_rows", op) == base.count


@pytest.mark.parametrize("family", list(FAMILIES))
def test_counters_read_the_largest_level_and_the_pulled_rows(monkeypatch, family):
    make, op, n_levels, width = FAMILIES[family]
    q = make()
    levels = Levels(monkeypatch)
    session = JoinSession(p=8, device="cpu")
    session.submit(q)
    levels.levels.clear()
    warm = session.submit(q)
    assert len(levels.levels) == n_levels
    assert lj_counter(warm, "level_rows_max", op) == max(rows for rows, _, _, _ in levels.levels)
    assert lj_counter(warm, "pulled_rows", op) == warm.count == warm.result.rows.shape[0]
    # the last level's rows are the answer's (one stage: nothing is heavy)
    assert levels.levels[-1][0] == warm.count
    # only the answer's rows cross to the host in the chain: 4 bytes a value
    lj = {k: v for k, v in warm.counters.items() if k.startswith(f"execute/op.{op}")}
    row_bytes = sum(v for k, v in lj.items() if k.endswith(":d2h_row_bytes"))
    assert row_bytes == warm.count * width * 4
    pulled = sum(v for k, v in lj.items() if k.endswith(":d2h_bytes"))
    assert row_bytes <= pulled < row_bytes + 64 * 1024


def _mesh8_main() -> int:
    """Run as a script with eight host devices: row order at p = 8."""
    assert len(jax.devices()) == 8, jax.devices()
    for variant in (0, 1):
        jp, tp = compile_both(clique4_spec(8, variant), 8)
        want = JaxExecutor().run(jp)
        got = DataplaneExecutor(8, device="cpu").run(tp)
        assert want.p == got.p == 8
        assert_same_bytes(got, want)
        print(f"mesh8 clique4 labelling {variant}: identical ({got.count} rows)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_mesh8_main())
