"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` for ``sm_90a``; the hash is taken over the
source, so an edited kernel is never served from a stale library.  The build
happens at first use (or when ``build`` is called up front); ``build`` starts
one ``nvcc`` per source, all at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output with the -Xptxas -v summary, kept beside the library


_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Compile every named kernel that is not built yet, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            log = path.with_suffix(".log")
            results[name] = BuildResult(name, path, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
        results[name] = BuildResult(name, path, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build([name])[name].path))
    return _LIBS[name]
