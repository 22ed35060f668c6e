"""Build and bind the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface (``extern "C"`` launchers) and loaded with
``ctypes``.  Libraries live in ``build/repro_torch_kernels/`` at the root of
the checkout, named by a hash of their source and flags, so an edited source
is rebuilt on its next use and an unchanged one is loaded as it is.  Nothing
is built when this module is imported: the first wrapper call that needs a
kernel builds it, and :func:`build_all` builds every source at once, one
``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: the C functions each source exports: name → (argtypes, source stem)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
LAUNCHERS = {
    "hash_partition_pack_launch": (
        [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P], "hash_partition"),
    "hash_partition_pack_wide_launch": (
        [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P], "hash_partition"),
    "hash_partition_launch": ([_P, _I, _I, _P, _P, _P], "hash_partition"),
    "merge_join_counts_launch": ([_P, _P, _I, _I, _I, _P, _P, _P], "merge_join"),
    "merge_join_pairs_launch": ([_P, _P, _I, _I, _I, _P, _P, _P], "merge_join"),
    "flash_attention_launch": (
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P], "flash_attention"),
    "ssd_chunk_launch": ([_P] * 8 + [_I] * 5 + [_P], "ssd"),
    "blake2b_chunks_launch": ([_P, _L, _I, _P, _P], "digest"),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

#: launches per kernel name since the last ``launches.clear()``: each wrapper
#: adds one where it launches its kernel, and nowhere else (a session's
#: drainer thread launches too, so additions hold ``_count_lock``)
launches: Counter = Counter()
_count_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{digest}.so"


def _start(stem: str) -> Optional[subprocess.Popen]:
    """Start nvcc for one source unless its library is already built."""
    out = _lib_path(stem)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(stem: str, proc: Optional[subprocess.Popen]) -> str:
    """Wait for one nvcc, install its library atomically, return its log."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    out = _lib_path(stem)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {stem}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every kernel source in parallel; returns each source's
    ``nvcc -Xptxas -v`` log (empty when it was already built)."""
    stems = sorted({s for _, s in LAUNCHERS.values()})
    with _lock:
        procs = {stem: _start(stem) for stem in stems}
        try:
            return {stem: _finish(stem, procs[stem]) for stem in stems}
        finally:
            for proc in procs.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()


def launcher(name: str):
    """The ctypes function of one exported C function (each returns an int),
    building its source if needed."""
    argtypes, stem = LAUNCHERS[name]
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            _finish(stem, _start(stem))
            lib = _libs[stem] = ctypes.CDLL(str(_lib_path(stem)))
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launched(name: str, rc: int) -> None:
    """Raise if a launcher reported a CUDA error, else count one launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    with _count_lock:
        launches[name] += 1
