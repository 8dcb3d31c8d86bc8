"""Build the package's native code and load it with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host code)
has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so``: a ``.cu`` with ``nvcc`` for ``sm_90a``, a
``.cpp`` with the system's C++ compiler (``$CXX``, else ``c++``).  The hash
is taken over the source, the shared headers it may include (``csrc/*.cuh``
for a CUDA source, ``csrc/*.h`` for a host one) and the flags, so an edited
source or header is never served from a stale library.  The build happens
at first use (or when ``build`` is called up front); ``build`` starts one
compiler per source, all at once, and each writes a file of its own that
``os.replace`` puts in place, so processes that build at the same time
never see a torn library.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # the compiler's output (nvcc's with the -Xptxas -v summary), kept beside the library


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()  # one build of a library per process, whatever the thread


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX or put c++ on PATH)")


def _source(name: str) -> Path:
    """``csrc/<name>.cu`` if there is one, else ``csrc/<name>.cpp``."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _command(name: str, out: Path):
    src = _source(name)
    if src.suffix == ".cpp":
        return [_cxx(), *HOST_FLAGS, "-o", str(out), str(src)]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    src = _source(name)
    if src.suffix == ".cpp":
        sources, flags = [src, *sorted(CSRC_DIR.glob("*.h"))], HOST_FLAGS
    else:
        sources, flags = [src, *sorted(CSRC_DIR.glob("*.cuh"))], NVCC_FLAGS
    content = b"".join(s.read_bytes() for s in sources)
    digest = hashlib.sha1(content + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Compile every named source that is not built yet, in parallel."""
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
        cmd = _command(name, tmp)
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
        raise RuntimeError("build failed for " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    with _LOAD_LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build([name])[name].path))
        return _LIBS[name]
