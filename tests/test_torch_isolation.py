"""The port stands alone: nothing under src/repro_torch/, and not
chip_smoke.py, imports jax or the JAX package ``repro``.

An AST scan of every import statement, and a subprocess that imports the
port's package, executor and service and then finds neither ``jax`` nor
``repro`` in ``sys.modules``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_has_files_to_scan():
    assert len(PORT_FILES) > 20
    assert (ROOT / "chip_smoke.py") in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, root) for line, root in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.kernels, repro_torch.dataplane\n"
        "import repro_torch.mpc.executors, repro_torch.mpc.service\n"
        "from repro_torch.mpc import JoinSession, DataplaneExecutor, mpc_join\n"
        "import repro_torch.mpc.verify, repro_torch.analysis, repro_torch.graph\n"
        "import repro_torch.core.icp, repro_torch.core.em_model, repro_torch.core.jointree\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(ROOT))
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr[-2000:]
