"""Hand-written CUDA kernels: build, load and bind.

Each kernel is one `csrc/*.cu` file with a plain C interface. At first use
it is compiled with nvcc for sm_90a into a shared library under `_build/`
(listed in .gitignore; the file name carries a hash of the source, so an
edited source never loads a stale build) and bound with ctypes. Nothing is
built or loaded when this module is imported: the CPU tests import it on
machines with no nvcc and no card.

Each kernel object counts its launches in `launches`, a plain integer the
launch method bumps once per kernel launch, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
        "CUDA kernels are built from csrc/ at first use on a machine with "
        "the CUDA toolkit")


class CudaKernel:
    """One csrc/*.cu kernel library: its build, its ctypes binding and its
    launch count."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.source.stem}_{digest[:12]}.so"

    def build_command(self, out: Path) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def _load(self):
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.ff_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def function(self):
        """The bound C entry point, building the library first if this
        source has no build yet."""
        with self._lock:
            if self._fn is None:
                if not self.library_path().exists():
                    build([self])
                self._load()
            return self._fn

    def check(self, code: int):
        if code != 0:
            msg = self._lib.ff_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} ({code})")


def build(kernels: Sequence[CudaKernel]) -> Dict[str, float]:
    """Compile every kernel whose library is missing, one nvcc process per
    source, all started together; returns {name: seconds} for the ones
    built. A failed compile raises with nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        out = k.library_path()
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((k, out, tmp, time.monotonic(), subprocess.Popen(
            k.build_command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    secs = {}
    failures = []
    for k, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{k.source.name}:\n{log}")
            continue
        os.replace(tmp, out)
        secs[k.name] = time.monotonic() - t0
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return secs


RAGGED_PAGED_ATTENTION = CudaKernel(
    name="ragged_paged_attention",
    source="ragged_paged_attention.cu",
    symbol="ff_ragged_paged_attention",
    argtypes=[_VOID_P] * 8 + [_INT] * 7 + [ctypes.c_float, _INT, _VOID_P],
    replaces="flexflow_tpu/paged/attention.py:213",
)

KERNELS = (RAGGED_PAGED_ATTENTION,)

# dtypes the kernels take, with the code their C entry points use for each
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch_ragged_paged_attention(q, kc, vc, page_tables, pos, q_lens, anc,
                                  out, scale: float):
    """Launch the ragged paged-attention kernel on the current stream.
    The caller (paged.attention.ragged_flash_attention) has validated
    devices, dtypes, shapes and contiguity."""
    fn = RAGGED_PAGED_ATTENTION.function()
    B, S, H, D = q.shape
    _, P, Hkv, _ = kc.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                  page_tables.data_ptr(), pos.data_ptr(), q_lens.data_ptr(),
                  anc.data_ptr(), out.data_ptr(), B, S, H, Hkv, D, P,
                  page_tables.shape[1], float(scale),
                  KERNEL_DTYPES[q.dtype], stream)
    RAGGED_PAGED_ATTENTION.check(code)
    RAGGED_PAGED_ATTENTION.launches += 1
    return out
