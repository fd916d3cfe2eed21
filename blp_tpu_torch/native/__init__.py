"""ctypes bindings for the port's native C++ data packer (packer.cpp beside
this file; port of blp_tpu/native).

The library is built on first use with g++ into build/native/, named by a
hash of the source, the flags and the machine type, so a changed source is
rebuilt and an unchanged one loaded as it is. Several processes may ask at once (pytest's
workers, a job's ranks): an fcntl lock on build/native/packer.lock lets one
of them run g++, into a temporary name that is renamed into place, while the
others wait, so no process loads a half-written library. No -march=native:
the build directory may be copied to another machine.

`available()` gates every use. Without g++ (or when the build fails) the
callers take the pure-Python path, whose results are the same. `calls`
counts the native calls that returned a result.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

calls = 0            # native calls that returned a result, in this process
build_error = None   # why the last build or load failed, if one did

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """The library of the current source, flags and machine type."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join((*FLAGS, platform.machine())).encode())
    return BUILD_DIR / f"libblp_packer-{digest.hexdigest()[:12]}.so"


def _build(gxx: str, lib: Path) -> None:
    """Build `lib` unless another process has; holds the build lock."""
    global build_error
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "packer.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        try:
            out = subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp)],
                                 capture_output=True, text=True, timeout=120)
        except subprocess.TimeoutExpired:
            build_error = "g++ ran past 120 s"
            tmp.unlink(missing_ok=True)
            return
        if out.returncode != 0:
            build_error = out.stderr
            tmp.unlink(missing_ok=True)
            return
        os.replace(tmp, lib)


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        path = library_path()
        if not path.exists():
            _build(gxx, path)
            if not path.exists():
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:   # built for another host's libraries
            build_error = str(e)
            return None
        lib.pack_triples.restype = ctypes.c_int64
        lib.pack_triples.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int64]
        lib.count_lines.restype = ctypes.c_int64
        lib.count_lines.argtypes = [ctypes.c_char_p]
        lib.wordpiece_encode_file.restype = ctypes.c_int64
        lib.wordpiece_encode_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def pack_triples(triples_path: str, entities_path: str,
                 relations_path: str) -> np.ndarray | None:
    """(T, 3) int32 [head, tail, rel] triples, ids by line order of the
    entity and relation files; None if unavailable or a name is unknown."""
    global calls
    lib = _load()
    if lib is None:
        return None
    cap = lib.count_lines(triples_path.encode())
    if cap < 0:
        return None
    out = np.zeros((max(cap, 1), 3), np.int32)
    n = lib.pack_triples(triples_path.encode(), entities_path.encode(),
                         relations_path.encode(),
                         out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        return None
    calls += 1
    return out[:n]


def wordpiece_encode_file(text_path: str, entities_path: str, vocab_path: str,
                          *, max_len: int, do_lower: bool,
                          text_data: np.ndarray) -> np.ndarray | None:
    """Tokenize an entity2text TSV into `text_data` ((N, max_len+1) int32,
    zero-initialized, modified in place). Returns a bool mask of rows that
    contain non-ASCII text and must be handled by the Python tokenizer, or
    None if the native library is unavailable.
    """
    global calls
    lib = _load()
    if lib is None:
        return None
    if text_data.dtype != np.int32 or not text_data.flags.c_contiguous \
            or text_data.ndim != 2 or text_data.shape[1] != max_len + 1:
        raise ValueError(f"text_data must be a C-contiguous int32 "
                         f"(N, {max_len + 1}) array, got {text_data.dtype} "
                         f"{text_data.shape}")
    needs_python = np.zeros(text_data.shape[0], np.uint8)
    n = lib.wordpiece_encode_file(
        text_path.encode(), entities_path.encode(), vocab_path.encode(),
        max_len, int(do_lower),
        text_data.ctypes.data_as(ctypes.c_void_p),
        needs_python.ctypes.data_as(ctypes.c_void_p),
        text_data.shape[0])
    if n < 0:
        return None
    calls += 1
    return needs_python.astype(bool)
