"""ctypes bindings to the native C++ IO runtime (``native/csv_io.cpp``).

A copy of ``ssme_tpu/native/__init__.py`` for the port (which cannot
import ``ssme_tpu``: that package imports jax).  It compiles the same
source, at its place in the repository, on demand with g++ into this
package's own ``_build`` directory; every entry point degrades to a
pure-Python path when the toolchain or the library is unavailable.  This
is host IO, not a kernel of the model's path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "csv_io.cpp")
_LIB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_LIB = os.path.join(_LIB_DIR, "libssme_io.so")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False


def _build() -> bool:
    os.makedirs(_LIB_DIR, exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", _LIB]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
        if res.returncode != 0:
            sys.stderr.write(
                f"ssme_tpu_torch: native build failed:\n{res.stderr.decode()}\n")
            return False
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"ssme_tpu_torch: native build unavailable: {e}\n")
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB):
            if _build_attempted or not os.path.exists(_SRC):
                return None
            _build_attempted = True
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.ssme_csv_read.restype = ctypes.POINTER(ctypes.c_float)
        lib.ssme_csv_read.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_long),
                                      ctypes.POINTER(ctypes.c_long)]
        lib.ssme_free.argtypes = [ctypes.c_void_p]
        lib.ssme_writer_open.restype = ctypes.c_void_p
        lib.ssme_writer_open.argtypes = [ctypes.c_char_p]
        lib.ssme_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_long]
        lib.ssme_writer_flush.argtypes = [ctypes.c_void_p]
        lib.ssme_writer_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_read_csv(path: str) -> Optional[np.ndarray]:
    """Parse a headerless CSV via the native reader; None if unavailable
    (caller falls back to Python)."""
    lib = _load()
    if lib is None or not os.path.exists(path):
        return None
    rows = ctypes.c_long(0)
    cols = ctypes.c_long(0)
    ptr = lib.ssme_csv_read(path.encode(), ctypes.byref(rows),
                            ctypes.byref(cols))
    if not ptr:
        return None
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        return arr.reshape(rows.value, cols.value)
    finally:
        lib.ssme_free(ptr)


class StreamWriter:
    """Line-stream writer: native background-thread path when available,
    buffered Python file otherwise.  Used for PMMH sample/message streams
    (the reference's ofstreams, ``ada_pmmh_mvn.h:204-208``)."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _load()
        self._handle = None
        self._file = None
        if self._lib is not None:
            self._handle = self._lib.ssme_writer_open(path.encode())
        if self._handle is None:
            self._file = open(path, "w")

    def write(self, text: str) -> None:
        if self._handle is not None:
            data = text.encode()
            self._lib.ssme_writer_write(self._handle, data, len(data))
        else:
            self._file.write(text)

    def flush(self) -> None:
        if self._handle is not None:
            self._lib.ssme_writer_flush(self._handle)
        else:
            self._file.flush()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ssme_writer_close(self._handle)
            self._handle = None
        elif self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["native_available", "native_read_csv", "StreamWriter"]
