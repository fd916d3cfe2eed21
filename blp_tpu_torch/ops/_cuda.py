"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

No ``--use_fast_math``: K1's exactness rests on IEEE fp32 adds in a fixed
order. The library name carries a hash of the source and the flags, so a
changed source is rebuilt and an unchanged one is loaded as it is. The first
``load`` builds every stale source at once, one ``nvcc`` process each, all
started together. Without ``nvcc`` it raises: there is no fallback on the
card. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("transe_rank", "packed_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the shared library of `csrc/<name>.cu` lives for its current
    source and flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all() -> dict[str, float]:
    """Compile every stale source in parallel. Returns {name: seconds} for
    the sources built (empty when all are current); each build's compiler
    output (ptxas registers, shared memory, spills) is kept beside its
    library as `<name>.log`. Raises with the compiler output on failure."""
    stale = [n for n in SOURCES if not library_path(n).exists()]
    if not stale:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in stale:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failures = {}, []
    for name, (tmp, t0, proc) in procs.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(output)
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
