"""Sound runs of each cell at a small size on the CPU come out correct, and the
control (the reference in the program's place with narrowed keys) does not."""

import json

import pytest
import torch

from portbench_cells import ROOT, SECONDS, SMALL, run_small

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    line = run_small(cell)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0} for c in line["checks"].values())
    e2e = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == e2e and "setup_s" in e2e
    assert all(m["value"] >= 0 for m in line["metrics"].values())


def test_traced_run_reports_per_layer_metrics():
    """On the CPU the device readers find nothing and stay silent."""
    line = run_small("ssb-sf1.q41-mix", trace=True)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"service.host_ms", "service.cold_query_s",
                                    "compiler.compile_ms", "executor.host_ms",
                                    "executor.rounds_ms"}


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(cell):
    """At these sizes every graph label fits int16, so the triangle's control
    narrows to int8; the SSB part keys (up to 70,000) alias in int16."""
    from portbench.control import control_run

    dtype = torch.int8 if cell.startswith("graph500") else torch.int16
    line = control_run(ROOT, cell, 12345, SECONDS, device="cpu", overrides=SMALL[cell],
                       dtype=dtype)
    assert line["correct"] is False
    assert line["checks"]["rows_gap"]["value"] > 0


@pytest.mark.cuda
def test_small_traced_run_on_the_card():
    """The whole traced path on the card at a small size: kernels built and
    traced, every per-layer reader finds something."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.run import run_cell

    cell = "ssb-sf1.q41-mix"
    line = run_cell(ROOT, cell, 99, 1.0, True, device="cuda", overrides=SMALL[cell])
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert set(line["metrics"]) == {m["name"] for m in BENCH["per_layer"]}
    assert all(0 < line["metrics"][m]["value"] <= 100
               for m in line["metrics"] if m.endswith("_roofline"))
