"""Row order at p=8: the port's general (arbitrary-arity) route ≡ the JAX
package's DataplaneExecutor on eight host devices.

The JAX executor's machine count is its mesh size, so this runs in a
subprocess — this file run as a script — with ``XLA_FLAGS`` asking for
eight CPU devices, which keeps the flag out of the test process.  The
bench_acyclic.py shapes of star3, snowflake and the forced-general
triangle, one case of the random battery, and star3 coalesced with
snowflake under an injected overflow that re-salts one of them: rows in
order as int64 bytes, counts, per-H counts, retries and retry log must be
identical.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import torch

from repro.mpc import program as jprog
from repro.mpc.executors import DataplaneExecutor as JDataplane
from repro.mpc.faults import FaultPlan as JFaultPlan
from repro.mpc.faults import FaultRule as JFaultRule
from repro_torch.mpc import DataplaneExecutor as TDataplane
from repro_torch.mpc import RunConfig
from repro_torch.mpc.faults import FaultPlan, FaultRule

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_general import family  # noqa: E402
from test_torch_general_dataplane import P, assert_same_order, battery_query, compile_both  # noqa: E402

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)


MESH8_CASES = {
    "star3": lambda: family("star3", n=240, dom_size=20, skew=0.8, seed=11),
    "snowflake": lambda: family("snowflake", n=200, dom_size=18, skew=0.8, seed=12),
    "triangle-general": lambda: family("triangle", n=260, dom_size=24, skew=1.2, seed=14),
    "battery-3": lambda: battery_query(3),
}


def test_p8_row_order_matches_reference_on_eight_devices():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, __file__], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-3000:]}"
    for name in list(MESH8_CASES) + ["coalesced"]:
        assert f"mesh8 {name}: identical" in res.stdout, res.stdout


def _mesh8_main() -> int:
    """Run as a script with eight host devices: row order at p=8."""
    assert len(jax.devices()) == 8, jax.devices()
    progs = {}
    for name, make in MESH8_CASES.items():
        tp, jp = compile_both(*make())
        progs[name] = (tp, jp)
        want = JDataplane().run(jp)
        got = TDataplane(P, device="cpu").run(tp)
        assert want.p == P
        assert_same_order(got, want)
        print(f"mesh8 {name}: identical ({got.count} rows)", flush=True)
    # two structures in one scheduler pass, one of them re-salted by an
    # injected slot overflow in its down sweep
    (ta, ja), (tb, jb) = progs["star3"], progs["snowflake"]

    def plan(F, R):
        return F([R(site="overflow", rate=1.0, count=1, rounds=("yan-down",),
                    channels=("slot",))], seed=3)

    jplan, tplan = plan(JFaultPlan, JFaultRule), plan(FaultPlan, FaultRule)
    wants, _ = JDataplane().run_many([ja, jb], config=jprog.RunConfig(fault_plan=jplan))
    gots, _ = TDataplane(P, device="cpu").run_many([ta, tb],
                                                   config=RunConfig(fault_plan=tplan))
    assert tplan.injected["overflow"] == jplan.injected["overflow"] == 1
    for got, want in zip(gots, wants):
        assert_same_order(got, want)
    print("mesh8 coalesced: identical", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_mesh8_main())
