"""Hand-written CUDA kernels: build, load and bind.

Each kernel lives in a `csrc/*.cu` file with a plain C interface (one
file may hold several kernels, each its own entry point). At first use a
file is compiled with nvcc for sm_90a into a shared library under
`_build/` (listed in .gitignore; the file name carries a hash of the
source and the shared headers, so an edited source never loads a stale
build) and bound with ctypes. Nothing is built or loaded when this module
is imported: the CPU tests import it on machines with no nvcc and no
card.

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
        headers = b"".join(h.read_bytes()
                           for h in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha1(self.source.read_bytes() + headers
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
    """Compile every source whose library is missing, one nvcc process per
    source, all started together; returns {source file: seconds} for the
    ones built. A failed compile raises with nvcc's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    started = set()
    for k in kernels:
        out = k.library_path()
        if out.exists() or out in started:
            continue
        started.add(out)
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
        secs[k.source.name] = time.monotonic() - t0
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

_FLASH = "flexflow_tpu/ops/pallas/flash_attention.py"

FLASH_ATTENTION_FWD = CudaKernel(
    name="flash_attention_fwd",
    source="flash_attention_fwd.cu",
    symbol="ff_flash_attention_fwd",
    argtypes=[_VOID_P] * 5 + [_INT] * 7 + [ctypes.c_float, _INT, _VOID_P],
    replaces=f"{_FLASH}:119",
)

FLASH_ATTENTION_DQ = CudaKernel(
    name="flash_attention_dq",
    source="flash_attention_bwd.cu",
    symbol="ff_flash_attention_dq",
    argtypes=[_VOID_P] * 7 + [_INT] * 7 + [ctypes.c_float, _INT, _VOID_P],
    replaces=f"{_FLASH}:178",
)

FLASH_ATTENTION_DKV = CudaKernel(
    name="flash_attention_dkv",
    source="flash_attention_bwd.cu",
    symbol="ff_flash_attention_dkv",
    argtypes=[_VOID_P] * 8 + [_INT] * 7 + [ctypes.c_float, _INT, _VOID_P],
    replaces=f"{_FLASH}:197",
)

KERNELS = (RAGGED_PAGED_ATTENTION, FLASH_ATTENTION_FWD, FLASH_ATTENTION_DQ,
           FLASH_ATTENTION_DKV)

# dtypes the kernels take, with the code their C entry points use for each
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(kernel: CudaKernel, device, *args):
    """Call `kernel`'s C entry point with `args` and the current stream of
    `device`, raise on a non-zero code, and count the launch."""
    fn = kernel.function()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    kernel.check(code)
    kernel.launches += 1


def launch_ragged_paged_attention(q, kc, vc, page_tables, pos, q_lens, anc,
                                  out, scale: float):
    """Launch the ragged paged-attention kernel on the current stream.
    The caller (paged.attention.ragged_flash_attention) has validated
    devices, dtypes, shapes and contiguity."""
    B, S, H, D = q.shape
    _, P, Hkv, _ = kc.shape
    _launch(RAGGED_PAGED_ATTENTION, q.device, q.data_ptr(), kc.data_ptr(),
            vc.data_ptr(), page_tables.data_ptr(), pos.data_ptr(),
            q_lens.data_ptr(), anc.data_ptr(), out.data_ptr(), B, S, H, Hkv,
            D, P, page_tables.shape[1], float(scale), KERNEL_DTYPES[q.dtype])
    return out


def launch_flash_attention_fwd(q, k, v, out, lse, causal: bool,
                               scale: float):
    """K1: out (B, S, H, D) and the fp32 logsumexp lse (B, H, S) of
    attention over q (B, S, H, D), k/v (B, T, Hkv, D). The caller
    (ops.flash_attention) has validated devices, dtypes, shapes and
    contiguity."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    _launch(FLASH_ATTENTION_FWD, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, S, T, H, Hkv, D,
            int(causal), float(scale), KERNEL_DTYPES[q.dtype])
    return out, lse


def launch_flash_attention_dq(q, k, v, dout, lse, delta, dq, causal: bool,
                              scale: float):
    """K2, dq: the query gradient from the saved lse and delta."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    _launch(FLASH_ATTENTION_DQ, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, S, T, H, Hkv, D, int(causal), float(scale),
            KERNEL_DTYPES[q.dtype])
    return dq


def launch_flash_attention_dkv(q, k, v, dout, lse, delta, dk, dv,
                               causal: bool, scale: float):
    """K2, dk/dv: the key and value gradients at Hkv heads, summed over
    each GQA group's query heads inside the kernel."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    _launch(FLASH_ATTENTION_DKV, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, T, H, Hkv, D, int(causal),
            float(scale), KERNEL_DTYPES[q.dtype])
    return dk, dv
