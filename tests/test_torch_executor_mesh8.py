"""Row order at p=8: the port's DataplaneExecutor ≡ the JAX package's on
eight host devices.

The JAX executor's p is its mesh size, so this runs in a subprocess — this
file run as a script — with ``XLA_FLAGS`` asking for eight CPU devices,
which keeps the flag out of the test process.  Two cases of
tests/test_torch_executor.py (the Zipf triangle and the disconnected light
subquery): rows in order as int64 bytes, counts, retries and retry log must
be identical.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import torch

from repro.mpc.executors import DataplaneExecutor
from repro_torch.mpc import DataplaneExecutor as TorchExecutor

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_executor import CASES, assert_same_order, compile_both  # noqa: E402

# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread per process keeps these tests from starving the others
torch.set_num_threads(1)


MESH8_CASES = ("triangle-zipf", "disconnected")


def test_p8_row_order_matches_reference_on_eight_devices():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, __file__], capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-3000:]}"
    for name in MESH8_CASES:
        assert f"mesh8 {name}: identical" in res.stdout, res.stdout


def _mesh8_main() -> int:
    """Run as a script with eight host devices: row order at p=8."""
    assert len(jax.devices()) == 8, jax.devices()
    for name in MESH8_CASES:
        make, lam, fused = CASES[name]
        jp, tp = compile_both(make(), lam, 8, fused)
        want = DataplaneExecutor().run(jp)
        got = TorchExecutor(8, device="cpu").run(tp)
        assert want.p == 8
        assert_same_order(got, want)
        print(f"mesh8 {name}: identical ({got.count} rows)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_mesh8_main())
