"""Each per-layer reader, the trace reduction and the kernels' byte counts on
synthetic records."""

import json
from pathlib import Path

import pytest
import torch

from portbench import kernel_bytes, trace
from portbench.run import load_module

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py").read


def submit(total, stats, compile_, execute, rounds):
    return {"total_us": total, "stats_us": stats, "compile_us": compile_, "verify_us": 0.0,
            "execute_us": execute, "rounds_us": rounds, "retries": 0, "wall_s": total / 1e6}


GB = 3.35e12 * 1e-3          # bytes the card moves in 1 ms at its memory rate
RECORD = {
    "cold": [submit(9000, 100, 3000, 5000, 1000), submit(7000, 100, 1000, 5000, 1000)],
    "warm": [submit(4000, 1000, 0, 3000, 1000), submit(6000, 1000, 0, 5000, 3000)],
    "kernels": {"hash_partition_pack": {"calls": 2, "bytes": GB},
                "merge_join_counts": {"calls": 3, "bytes": 3 * GB},
                "merge_join_pairs": {"calls": 1, "bytes": 0}},
    "device": {"busy_us": 250.0, "window_us": 1000.0,
               "kernel_us": {"hash_partition_pack": 4000.0, "merge_join_counts": 4000.0}},
}


@pytest.mark.parametrize("name, want", [
    ("service.host_ms", 1.0),                 # total - execute, per warm query
    ("service.cold_query_s", 0.008),          # cold submits' mean wall
    ("compiler.compile_ms", 2.0),             # cold compiles' mean
    ("executor.host_ms", 2.0),                # execute - rounds, per warm query
    ("executor.rounds_ms", 2.0),
    ("device.idle_pct", 75.0),
    ("hash_partition_pack_roofline", 25.0),   # 1 ms of bytes in 4 ms
    ("merge_join_counts_roofline", 75.0),
    ("merge_join_pairs_roofline", None),      # no bytes, no device time: silent
    ("join_kernels_roofline", 50.0),          # 4 ms of bytes in 8 ms
])
def test_reader(name, want):
    got = reader(name)(RECORD)
    assert (got is None) if want is None else got == pytest.approx(want)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_reader_finds_nothing_in_an_empty_record(name):
    empty = {"cold": [], "warm": [], "kernels": {}, "device": None}
    assert reader(name)(empty) is None


def test_reduce_events():
    device = [("mj_counts(int const*)", 10, 30), ("hp_pack(int const*)", 20, 40),
              ("Memcpy HtoD", 60, 70), ("mj_pairs(int const*)", 95, 120)]
    spans = [("submit", 0, 100), ("execute", 6, 90), ("op.LocalJoin", 41, 55)]
    red = trace.reduce_events(device, spans, (0, 100))
    assert red["busy_us"] == 30 + 10 + 5          # merged, cut at the window
    assert red["window_us"] == 100
    assert red["kernel_us"] == {"merge_join_counts": 20, "hash_partition_pack": 20,
                                "merge_join_pairs": 5}
    # idle: [0,10) submit, [40,60) op.LocalJoin (middle 50), [70,95) execute
    assert dict(red["idle_by_span"]) == {"submit": 10, "op.LocalJoin": 20, "execute": 25}
    assert red["device_ops"][0] == ("mj_counts(int const*)", 20)


def test_kernel_bytes():
    keys = torch.zeros((3, 5), dtype=torch.int32)
    assert kernel_bytes.hash_partition_pack(keys, torch.zeros(3), 4, out=None) == (
        4 * 15 + 4 * 3 + 8 * 15 + 4 * 3 * 4)
    assert kernel_bytes.merge_join_counts(keys, torch.zeros((3, 7)), out=None) == (
        4 * 15 + 4 * 21 + 8 * 15)
    a_idx = torch.tensor([[0, 0, 1, 1], [2, 2, 2, 2]], dtype=torch.int32)
    starts = torch.zeros((2, 3), dtype=torch.int32)
    got = kernel_bytes.merge_join_pairs(None, starts, 4, out=(a_idx, a_idx))
    assert int(got) == 8 * 2 * 4 + 8 * (2 + 1)
    assert kernel_bytes.merge_join_pairs(None, starts[:, :0], cap_out=4, out=(a_idx, a_idx)) == 0
    assert kernel_bytes.merge_join_pairs(None, starts, 0, out=(a_idx, a_idx)) == 0


def test_kernel_bytes_wrapper_counts_and_restores():
    from repro_torch.dataplane import join
    from repro_torch.kernels import ops

    orig = join.merge_join_counts
    kb = trace.KernelBytes()
    kb.install()
    try:
        assert join.merge_join_counts is not orig and ops.merge_join_counts is not orig
        a = torch.tensor([[1, 2, 3]], dtype=torch.int32)
        b = torch.tensor([[2, 3, 3, 9]], dtype=torch.int32)
        lower, upper = join.merge_join_counts(a_keys=a, b_keys=b)
        assert (upper - lower).tolist() == [[0, 1, 2]]
    finally:
        kb.remove()
    assert join.merge_join_counts is orig and ops.merge_join_counts is orig
    assert kb.totals() == {"merge_join_counts": {"calls": 1, "bytes": 4 * 3 + 4 * 4 + 8 * 3}}
