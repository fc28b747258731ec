"""Native helpers built from the port's own sources (counterpart of the
loader half of flexflow_tpu/native/__init__.py).

`csrc/ffloader.cc` is the data loader's C++ worker: an mmap'd .npy file
and a background thread that gathers (shuffled) sample rows into a ring
of batch buffers off the GIL, behind a plain C ABI (ffl_open, ffl_config,
ffl_reset, ffl_next, ffl_close) bound with ctypes. It is compiled with g++
at first use into `_build/` (the file name carries a hash of the source,
so an edited source never loads a stale build; written to a temporary
name and renamed, so a concurrent process never loads half a file), never
at import. A failed build raises with the compiler's output: there is no
fallback and no switch to turn the loader off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
LOADER_SOURCE = _PKG / "csrc" / "ffloader.cc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_loader_lib = None


def loader_library_path() -> Path:
    digest = hashlib.sha256(LOADER_SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libffloader_{digest[:12]}.so"


def build_loader() -> Path:
    """Compile csrc/ffloader.cc unless its library exists; returns the
    library's path. Raises RuntimeError with g++'s output on failure."""
    out = loader_library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(LOADER_SOURCE)],
            capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run to build {LOADER_SOURCE}: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {LOADER_SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_loader_lib() -> ctypes.CDLL:
    """The bound loader library, built on the first call."""
    global _loader_lib
    with _lock:
        if _loader_lib is None:
            lib = ctypes.CDLL(str(build_loader()))
            lib.ffl_open.restype = ctypes.c_void_p
            lib.ffl_open.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                     ctypes.c_long, ctypes.c_long]
            lib.ffl_config.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_long]
            lib.ffl_reset.argtypes = [ctypes.c_void_p]
            lib.ffl_next.restype = ctypes.c_int
            lib.ffl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_long]
            lib.ffl_close.argtypes = [ctypes.c_void_p]
            _loader_lib = lib
        return _loader_lib
