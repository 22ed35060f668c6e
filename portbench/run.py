#!/usr/bin/env python3
"""Run one cell of the join service's benchmark (``BENCHMARK.json``).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from ``--seed`` (``datasets/``), opens one
``repro_torch`` ``JoinSession`` on the card, submits one small query of the
same family (process-level first use), then each distinct query of the mix
cold and, ``warm_passes`` times (the traffic's, 1 unless it says), once more
warm.  The window then drives the mix for
``--seconds`` (``loops/``), after which the session is freed and every answer
the window returned is held against the plain reference (``reference/``).
The last line of standard output is one JSON object; the numbers compared
are the last lines of standard error.  With ``--trace 1`` the window runs
under torch.profiler and the benchmark's own spans (``trace.py``), and the
line carries the cell's per-layer metrics (``metrics/``) instead of its
end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                      # noqa: E402
import gc                            # noqa: E402
import importlib.util                # noqa: E402
import json                          # noqa: E402
import os                            # noqa: E402
import sys                           # noqa: E402
from contextlib import nullcontext   # noqa: E402
from pathlib import Path             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that must not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_module(path: Path):
    """A benchmark file by path (its name may hold '.' or '-')."""
    spec = importlib.util.spec_from_file_location("portbench_" + path.stem.replace(".", "_")
                                                  .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def submit_record(res) -> dict:
    return {"total_us": res.total_us, "stats_us": res.stats_us, "compile_us": res.compile_us,
            "verify_us": res.verify_us, "execute_us": res.execute_us,
            "rounds_us": float(sum(res.result.round_us.values())), "retries": res.retries}


def load_cell(root: Path, cell_name: str, overrides=None):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"portbench: no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = {**json.loads((root / entry["file"]).read_text()), **(overrides or {})}
    traffic = json.loads((root / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def run_cell(root: Path, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides=None, t_start=None) -> dict:
    """One run of a cell → the result line as a dict (``checks`` last)."""
    import numpy as np
    import torch

    from portbench import compare
    from portbench import trace as tr
    from repro_torch.core.query import JoinQuery, Relation, query_from_arrays
    from repro_torch.mpc import JoinSession

    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, config, traffic = load_cell(root, cell_name, overrides)
    here = root / "portbench"
    dataset = load_module(here / "datasets" / f"{config['dataset']}.py")
    reference = load_module(here / "reference" / f"{config.get('reference', 'natural_join')}.py")
    loop = load_module(here / "loops" / f"{traffic['loop']}.py")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    family = traffic["query"]

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed % (1 << 64))
    data = dataset.make(config, rng)
    specs = [dataset.query(family, data, v)
             for v in dataset.draw_variants(family, rng, traffic["variants"])]
    # one deduplicated copy of each physical table for the whole mix, as a
    # client holding its tables builds its queries
    tables = {}
    for spec in specs:
        for scheme, rows, table in spec:
            if (id(rows), table) not in tables:
                tables[id(rows), table] = Relation.make(scheme, rows, table=table).data
    queries = [JoinQuery.make([Relation(scheme=tuple(scheme), data=tables[id(rows), table],
                                        table=table) for scheme, rows, table in spec])
               for spec in specs]
    log(f"inputs from seed {seed}: {time.perf_counter() - t0:.3f} s")

    session = JoinSession(p=config["machines"], device=dev, verify=False)
    t0 = time.perf_counter()
    small = dataset.make({**config, **traffic["warmup"]}, np.random.default_rng(0))
    small_q = dataset.query(family, small, dataset.draw_variants(family,
                                                                 np.random.default_rng(0), 1)[0])
    session.submit(query_from_arrays(small_q))
    sync()
    log(f"first use (one small query): {time.perf_counter() - t0:.3f} s")

    cold = []
    for q in queries:
        sync()
        t0 = time.perf_counter()
        res = session.submit(q)
        sync()
        cold.append({**submit_record(res), "wall_s": time.perf_counter() - t0})
        if res.plan_cache_hit:
            log("a cold submit found its plan cached (an earlier query had its shape)")
        del res
    for _ in range(traffic.get("warm_passes", 1)):
        for q in queries:
            res = session.submit(q)
            log(f"first warm submit: {res.total_us / 1e6:.3f} s, retries {res.retries}")
            del res
    log("cold submits: " + ", ".join(f"{c['wall_s']:.3f}" for c in cold) + " s")

    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = kbytes = spans = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        kbytes, spans = tr.KernelBytes(), tr.Spans(session)
        kbytes.install()
        spans.install()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()

    def submit(i):
        with tr.span("submit") if trace else nullcontext():
            res = session.submit(queries[i])
        return res.result.rows, res.count, submit_record(res)

    setup_s = time.perf_counter() - t_start
    with tr.span("window") if trace else nullcontext():
        out = loop.run(submit, len(queries), seconds, sync)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    line = {"correct": False, "attempted": out["attempted"], "failed": out["failed"]}
    warm = [a[1][2] for a in out["answers"]]
    retries = sum(w["retries"] for w in warm)
    log(f"window: {out['attempted']} queries in {out['window_s']:.3f} s, "
        f"{out['failed']} failed, {retries} retries")

    record = None
    if trace:
        prof.__exit__(None, None, None)
        spans.remove()
        kbytes.remove()
        red = tr.reduce_events(*tr.profile_events(prof)) if cuda else None
        record = {"cold": cold, "warm": warm, "kernels": kbytes.totals(), "device": red}
        del prof
    # the program's state goes before the reference runs on the card
    del session, queries, submit
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows_gap = count_gap = 0
    by_query = {}
    for i, answer in out["answers"]:
        by_query.setdefault(i, []).append(answer)
    for i, answers in sorted(by_query.items()):
        _, want = reference.join([(s, r) for s, r, _ in specs[i]], dev)
        for rows, count, _ in answers:
            got = (torch.from_numpy(rows).to(dev) if rows is not None
                   else torch.zeros((0, want.shape[1]), dtype=torch.int64, device=dev))
            rows_gap = max(rows_gap, compare.rows_gap(got, want))
            count_gap = max(count_gap, abs(int(count) - want.shape[0]))
            del got
        del want
    log(f"reference and comparison: {time.perf_counter() - t0:.3f} s")
    checks = {"rows_gap": {"value": rows_gap, "limit": 0},
              "count_gap": {"value": count_gap, "limit": 0},
              "failed": {"value": out["failed"], "limit": 0}}
    line["correct"] = bool(out["answers"]) and all(
        c["value"] <= c["limit"] for c in checks.values())

    if not trace:
        values = {"setup_s": setup_s, "peak_gib": window_peak / 2**30, **out["metrics"]}
        metrics = {}
        for m in bench["end_to_end"]:
            if applies(m, cell_name):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, cell_name):
                value = load_module(here / "metrics" / f"{m['name']}.py").read(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                      "count": cell["chips"] if cuda else 1,
                      "memory_peak_bytes": max(setup_peak, window_peak)}
    if trace and record["device"] is not None:
        red = record["device"]
        line["device"].update(busy_s=red["busy_us"] / 1e6, window_s=red["window_us"] / 1e6)
        line["breakdown"] = {
            "device_ops": [[n[:120], us / 1e6] for n, us in red["device_ops"]],
            "idle_gaps": [[n, us / 1e6] for n, us in red["idle_by_span"]]}
    line["checks"] = checks
    return line


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or PyTorch builds lives at a fixed path in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    _, cell, _, _ = load_cell(ROOT, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    line = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                    t_start=T_START)
    found = loaded_forbidden()
    if found:
        log(f"the measured process loaded {', '.join(found)}")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
