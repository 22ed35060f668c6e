"""The harness drives a whole run on the CPU with the timed path broken
underneath, and ``correct`` has to come out false: an answer altered where
the executor produces it, half of an answer left out, the exchange between
the p machines left out, and (where the mix changes query) the previous
query's answer returned unchanged."""

import pytest

from portbench_cells import SMALL, run_small

CELLS = list(SMALL)


def patch_everywhere(monkeypatch, module, name, new):
    """Replace ``module.name`` in every program module that imported it."""
    import sys

    orig = getattr(module, name)
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("repro_torch") and getattr(mod, name, None) is orig:
            monkeypatch.setattr(mod, name, new)


def patch_results(monkeypatch, change):
    """``change(result, previous)`` applied to each executor result as it is produced."""
    from repro_torch.mpc.executors import DataplaneExecutor

    orig = DataplaneExecutor.run_many
    last = []

    def run_many(self, programs, *args, **kwargs):
        results, stats = orig(self, programs, *args, **kwargs)
        out = [change(r, last[0] if last else None) for r in results]
        last[:] = results
        return out, stats

    monkeypatch.setattr(DataplaneExecutor, "run_many", run_many)


def altered(r, _):
    rows = r.rows.copy()
    rows[len(rows) // 2, 0] += 1
    r.rows = rows
    return r


def halved(r, _):
    r.rows = r.rows[: len(r.rows) // 2].copy()
    r.count = len(r.rows)
    return r


def stale(r, previous):
    return previous if previous is not None else r


def no_exchange(monkeypatch):
    from repro_torch.dataplane import exchange

    def exchange_by_partition(rows, counts, part, cap_slot, cap_out, slot=None,
                              slot_counts=None):
        s, p, cap, w = rows.shape
        send, send_counts, ovf_slot = exchange.pack_by_partition(
            rows.reshape(s * p, cap, w), counts.reshape(s * p), part.reshape(s * p, cap),
            p, cap_slot, slot, slot_counts)
        # no all-to-all: each machine keeps what it would have sent
        out, count_out, ovf_out = exchange.compact(send, send_counts, cap_out)
        return (out.reshape(s, p, cap_out, w), count_out.reshape(s, p),
                ovf_slot.reshape(s, p), ovf_out.reshape(s, p))

    patch_everywhere(monkeypatch, exchange, "batched_exchange_by_partition",
                     exchange_by_partition)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered", "halved", "no_exchange"])
def test_fault_is_caught(monkeypatch, cell, fault):
    if fault == "no_exchange":
        no_exchange(monkeypatch)
    else:
        patch_results(monkeypatch, {"altered": altered, "halved": halved}[fault])
    line = run_small(cell)
    assert line["attempted"] >= 1
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_stale_answer_is_caught(monkeypatch):
    patch_results(monkeypatch, stale)
    line = run_small("ssb-sf1.q41-mix")
    assert line["correct"] is False and line["checks"]["rows_gap"]["value"] > 0
