"""The port's training driver (``python -m repro_torch.launch.train``) on the CPU:
the twin of ``test_train_driver.py``'s training half (auto-resume picks up the
latest checkpoint and runs only the remaining steps), the same parameter count as
the JAX driver's, the module entry point, and no fallback: without CUDA the
driver raises unless ``--device cpu`` is passed.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain

ROOT = Path(__file__).resolve().parents[1]


def test_train_driver_and_auto_resume(tmp_path):
    ckpt = str(tmp_path / "run")
    args = [
        "--arch", "mamba2-780m", "--reduced", "--device", "cpu",
        "--steps", "6", "--global-batch", "2", "--seq", "32",
        "--ckpt-dir", ckpt, "--ckpt-every", "2", "--log-every", "10",
    ]
    out1 = ttrain.main(args)
    assert len(out1["history"]) == 6
    assert np.isfinite(out1["history"]).all()
    assert (Path(ckpt) / "heartbeat").exists()

    # a restart with a larger step budget: --resume picks up the latest checkpoint
    # (step 5) and runs only the remaining steps
    args2 = [a if a != "6" else "8" for a in args]
    out2 = ttrain.main(args2 + ["--resume"])
    assert len(out2["history"]) == 2      # steps 6 and 7 only
    assert np.isfinite(out2["history"]).all()

    # resuming with nothing left to do runs no step
    out3 = ttrain.main(args2 + ["--resume"])
    assert out3["history"] == []


def test_train_driver_counts_the_reference_drivers_parameters(tmp_path):
    """Both drivers on reduced h2o-danube-1.8b with int8 compression and 2
    microbatches: the same parameter count, finite losses."""
    args = ["--arch", "h2o-danube-1.8b", "--reduced", "--steps", "2", "--global-batch", "4",
            "--seq", "16", "--compress-grads", "--microbatches", "2", "--log-every", "10"]
    want = jtrain.main(args)
    got = ttrain.main(args + ["--device", "cpu"])
    assert got["n_params"] == want["n_params"]
    assert len(got["history"]) == 2 and np.isfinite(got["history"]).all()


def test_train_driver_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", "mamba2-780m", "--reduced", "--steps", "1"])


def test_train_module_entry_point():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "h2o-danube-1.8b",
         "--reduced", "--device", "cpu", "--steps", "2", "--global-batch", "2", "--seq", "16"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] done: loss" in out.stdout
