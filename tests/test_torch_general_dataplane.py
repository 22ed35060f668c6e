"""The port's general (arbitrary-arity) route on the data plane ≡ the JAX
package's, on the CPU.

Twin of tests/test_arity_differential.py's data plane half.  The programs
are compiled at p=8 in both packages (tests/test_torch_general.py holds the
plans equal) and every check is exact:

* rows in order (int64 bytes), count, per-H counts ``{("*",): n}``, retries
  and retry log equal the JAX DataplaneExecutor on a one-device mesh — the
  reference's machine count is its mesh size, so the port runs the same
  program among one machine — under both ``batch_stages`` settings;
* among eight machines, the port's rows equal the simulator's and the
  oracle's as a sorted multiset, and batched ≡ unbatched as bytes;
* the cases are the four families × skew {0, 0.9}, the forced-general
  triangle, the 12-seed random battery and the five edge cases.

Warm repeats, coalescing, injected retries, the session and row order on
eight host devices are in tests/test_torch_general_service.py.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.taxonomy import compute_stats as j_compute_stats
from repro.mpc import program as jprog
from repro.mpc.executors import DataplaneExecutor as JDataplane
from repro_torch.core import query as tq
from repro_torch.core.taxonomy import compute_stats as t_compute_stats
from repro_torch.mpc import DataplaneExecutor as TDataplane
from repro_torch.mpc import program as tprog
from repro_torch.mpc.executors import SimulatorExecutor as TSimExecutor

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_general import EDGE_CASES, EDGE_COUNTS, explicit, family, random_twin  # noqa: E402

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)

P = 8
LAM = 4


def rows_key(rows):
    return sorted(map(tuple, np.asarray(rows).tolist()))


def compile_both(qt, qj, p=P, lam=LAM):
    return (tprog.compile_plan(qt, t_compute_stats(qt, lam), p),
            jprog.compile_plan(qj, j_compute_stats(qj, lam), p))


def mesh1():
    return jax.make_mesh((1,), ("join",))


def assert_same_order(got, want):
    assert got.rows.dtype == want.rows.dtype == np.int64
    assert got.rows.shape == want.rows.shape
    assert got.rows.tobytes() == want.rows.tobytes()
    assert got.count == want.count
    assert got.per_h_counts == want.per_h_counts
    assert got.retries == want.retries
    assert got.retry_log == want.retry_log


def assert_dataplane_parity(qt, qj):
    """Row order against the JAX executor (one machine), and among eight
    machines the oracle's multiset and batched ≡ unbatched bytes."""
    tp, jp = compile_both(qt, qj)
    for batch in (True, False):
        want = JDataplane(mesh=mesh1(), batch_stages=batch).run(jp)
        got = TDataplane(1, device="cpu", batch_stages=batch).run(tp)
        assert_same_order(got, want)
    oracle = tq.reference_join(qt)
    sim = TSimExecutor(p=P).run(tp)
    dp = TDataplane(P, device="cpu", batch_stages=True).run(tp)
    dp_u = TDataplane(P, device="cpu", batch_stages=False).run(tp)
    assert dp.count == sim.count == len(oracle)
    assert rows_key(dp.rows) == rows_key(sim.rows) == rows_key(oracle.data)
    assert dp.per_h_counts == sim.per_h_counts
    if qt.is_general:
        assert dp.per_h_counts == {("*",): len(oracle)}
    assert dp.rows.tobytes() == dp_u.rows.tobytes(), "batched != unbatched bytes"
    assert dp_u.per_h_counts == dp.per_h_counts and dp_u.retries == dp.retries
    return dp


# ---------------------------------------------------------------------------
# families × skew, the forced-general triangle, the 12-seed battery, edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["star3", "snowflake", "path4", "triangle"])
@pytest.mark.parametrize("skew", [0.0, 0.9])
def test_families_both_executors(kind, skew):
    assert_dataplane_parity(*family(kind, n=60, dom_size=6, skew=skew, seed=17))


def test_binary_triangle_forced_general():
    qt, qj = family("triangle", n=120, dom_size=9, skew=0.7, seed=5)
    assert qt.force_general and qt.is_general
    assert tprog.compile_plan(qt, t_compute_stats(qt, LAM), P).general.kind == "hypercube"
    assert_dataplane_parity(qt, qj)


def battery_query(seed):
    """tests/test_arity_differential.py's dataplane battery, both packages."""
    rngs = (np.random.default_rng(5000 + seed), np.random.default_rng(5000 + seed))
    draws = [(int(r.integers(1, 5)), float(r.choice([0.0, 0.8]))) for r in rngs]
    assert draws[0] == draws[1]
    n_rels, skew = draws[0]
    return random_twin(rngs, n_rels=n_rels, max_arity=4, n_attrs=5, tuples_per_rel=20,
                       dom_size=6, skew=skew, share_tables=bool(seed % 3 == 0),
                       allow_empty=True)


@pytest.mark.parametrize("seed", range(12))
def test_dataplane_differential_battery(seed):
    assert_dataplane_parity(*battery_query(seed))


@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_edge_cases_dataplane(name):
    dp = assert_dataplane_parity(*EDGE_CASES[name]())
    if name in EDGE_COUNTS:
        assert dp.count == EDGE_COUNTS[name]
    if name == "empty-relation":
        assert dp.per_h_counts == {("*",): 0}


def test_packed_key_falls_back_to_ranks_past_int32():
    """Shared-attribute values whose mixed-radix product passes int32 key the
    semijoin by dense ranks instead; rows still match the reference."""
    rng = np.random.default_rng(4)
    big = rng.integers(0, 2_000_000_000, size=(40, 1))
    ab = np.concatenate([big, rng.integers(0, 5, size=(40, 1))], axis=1)
    abc = np.concatenate([ab[::2], rng.integers(0, 5, size=(20, 1))], axis=1)
    qt, qj = explicit([(("A", "B"), ab, None), (("A", "B", "C"), abc, None)])
    assert 2_000_000_000 * 5 > np.iinfo(np.int32).max
    dp = assert_dataplane_parity(qt, qj)
    assert dp.count == len(tq.reference_join(qt)) > 0
