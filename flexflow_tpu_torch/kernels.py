"""Hand-written CUDA kernels: build, load and bind.

Each kernel lives in a `csrc/*.cu` file with a plain C interface (one
file may hold several kernels, each its own entry point). At first use a
file is compiled with nvcc for sm_90a into a shared library under
`_build/` (listed in .gitignore; the file name carries a hash of the
source and the shared headers, so an edited source never loads a stale
build) and bound with ctypes. The headers hold what several sources
share: `flash_wgmma_fwd.cuh` and `flash_wgmma_bwd.cuh` are the
tensor-core flash bodies that K1/K2's sources and K4's sources both
instantiate, each under its own layout tag, and `flash_tf32.cuh` the
3xTF32 fp32 bodies that K4's sources and K2's wrap in kernels of their
own names. Nothing is built or loaded
when this module is imported: the CPU tests import it on machines with
no nvcc and no card.

Each kernel object counts its launches in `launches`, a plain integer the
launch method bumps once per kernel launch, so a run can show that its
main path went through the kernel, and keeps in `build_log` nvcc's
output (ptxas -v: each __global__'s registers and spills) when this
process built its source.
"""

from __future__ import annotations

import ctypes
import fcntl
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
        self.build_log = None
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
    ones built. A failed compile raises with nvcc's output.

    Several processes may build at once (one per card under torchrun):
    each library has a lock file beside it, held with fcntl.flock while
    it is built, and is looked for again once the lock is held, so it is
    built once; nvcc writes to a temporary name that os.replace moves
    into place, so no process loads a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo: Dict[Path, CudaKernel] = {}
    for k in kernels:
        out = k.library_path()
        if not out.exists():
            todo.setdefault(out, k)
    locks = []
    try:
        for out in sorted(todo):
            out.parent.mkdir(parents=True, exist_ok=True)
            fd = os.open(str(out.with_suffix(".lock")),
                         os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(fd, fcntl.LOCK_EX)
            locks.append(fd)
        return _build_locked(todo, kernels)
    finally:
        for fd in locks:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)


def _build_locked(todo: Dict[Path, "CudaKernel"],
                  kernels: Sequence[CudaKernel]) -> Dict[str, float]:
    procs = []
    for out, k in todo.items():
        if out.exists():  # another process built it while this one waited
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
        secs[k.source.name] = time.monotonic() - t0
        for other in kernels:
            if other.source == k.source:
                other.build_log = log
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return secs


RAGGED_PAGED_ATTENTION = CudaKernel(
    name="ragged_paged_attention",
    source="ragged_paged_attention.cu",
    symbol="ff_ragged_paged_attention",
    argtypes=[_VOID_P] * 11 + [_INT] * 9 + [ctypes.c_float, _INT, _INT,
                                            _VOID_P],
    replaces="flexflow_tpu/paged/attention.py:213",
)

RAGGED_PAGED_ATTENTION_INT8 = CudaKernel(
    name="ragged_paged_attention_int8",
    source="ragged_paged_attention.cu",
    symbol="ff_ragged_paged_attention_quant",
    argtypes=[_VOID_P] * 13 + [_INT] * 9 + [ctypes.c_float, _INT, _VOID_P],
    replaces="flexflow_tpu/paged/attention.py:293",
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

# K4, the head-major kernels (q (BH, S, D), k/v (BH, T, D), any D up to
# 256): forward, dq and dk/dv; on the tensor cores in bf16 at D 48, 64, 80,
# 96, 100, 128 and 256 (K1/K2's bodies under the HeadMajor tag, 48..100 on
# tiles zero-padded to 64 / 128 columns, D 100's filled by cp.async since
# its 200-byte rows are no TMA stride) and in fp32 at 64, 128 and 256 (the
# 3xTF32 bodies of csrc/flash_tf32.cuh), every other case on CUDA cores
FLASH_ATTENTION_BH_FWD = CudaKernel(
    name="flash_attention_bh_fwd",
    source="flash_attention_bh_fwd.cu",
    symbol="ff_flash_attention_bh_fwd",
    argtypes=[_VOID_P] * 5 + [_INT] * 5 + [ctypes.c_float, _INT, _VOID_P],
    replaces=f"{_FLASH}:315",
)

# K5, one ring step (`_fwd_carry`): K4's forward folding k/v into carried
# fp32 (m, l, acc), updated in place; a second entry point of K4's source,
# on K4's tensor-core forward body in bf16 at the same seven widths (acc
# read and written two floats at a time: 8-byte aligned), every other case
# on the CUDA-core body
FLASH_ATTENTION_BH_FWD_CARRY = CudaKernel(
    name="flash_attention_bh_fwd_carry",
    source="flash_attention_bh_fwd.cu",
    symbol="ff_flash_attention_bh_fwd_carry",
    argtypes=[_VOID_P] * 6 + [_INT] * 5 + [ctypes.c_float, _INT, _VOID_P],
    replaces=f"{_FLASH}:378",
)

FLASH_ATTENTION_BH_DQ = CudaKernel(
    name="flash_attention_bh_dq",
    source="flash_attention_bh_bwd.cu",
    symbol="ff_flash_attention_bh_dq",
    argtypes=[_VOID_P] * 7 + [_INT] * 5 + [ctypes.c_float, _INT, _VOID_P],
    replaces=f"{_FLASH}:443",
)

FLASH_ATTENTION_BH_DKV = CudaKernel(
    name="flash_attention_bh_dkv",
    source="flash_attention_bh_bwd.cu",
    symbol="ff_flash_attention_bh_dkv",
    argtypes=[_VOID_P] * 8 + [_INT] * 5 + [ctypes.c_float, _INT, _VOID_P],
    replaces=f"{_FLASH}:461",
)

KERNELS = (RAGGED_PAGED_ATTENTION, RAGGED_PAGED_ATTENTION_INT8,
           FLASH_ATTENTION_FWD, FLASH_ATTENTION_DQ, FLASH_ATTENTION_DKV,
           FLASH_ATTENTION_BH_FWD, FLASH_ATTENTION_BH_DQ,
           FLASH_ATTENTION_BH_DKV, FLASH_ATTENTION_BH_FWD_CARRY)

# the largest head dim K4 takes (csrc/flash_bh_common.cuh, kMaxHeadDim)
BH_MAX_HEAD_DIM = 256
# the largest B * H K4 takes (the bh index rides grid.y)
BH_MAX_HEADS = 65535

# dtypes the kernels take for q (and out), with the code their C entry
# points use for each; the fp-pool ragged kernel's K/V may also be fp16
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


_COUNT_LOCK = threading.Lock()


def _launch(kernel: CudaKernel, device, *args):
    """Call `kernel`'s C entry point with `args` and the current stream of
    `device`, raise on a non-zero code, and count the launch."""
    fn = kernel.function()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    kernel.check(code)
    # two serving loops may launch at once (disagg.DisaggPair)
    with _COUNT_LOCK:
        kernel.launches += 1


def launch_ragged_paged_attention(q, kc, vc, page_tables, pos, q_lens, anc,
                                  out, scale: float, plan):
    """Launch the fp-pool ragged paged-attention kernels on the current
    stream (the pools may be of another float dtype than q): the split
    page walk of `plan` = (pages per split, splits), then the combine
    pass; one launch in `launches`. Allocates the fp32 workspace of the
    splits' partials (acc, m, l). The caller
    (paged.attention.ragged_flash_attention) has validated devices,
    dtypes, shapes and contiguity."""
    ws, partials = _split_workspace(q, plan)
    _launch(RAGGED_PAGED_ATTENTION, q.device, q.data_ptr(), kc.data_ptr(),
            vc.data_ptr(), page_tables.data_ptr(), pos.data_ptr(),
            q_lens.data_ptr(), anc.data_ptr(), out.data_ptr(), *partials,
            *_split_shapes(q, kc, page_tables),
            *plan, float(scale), KERNEL_DTYPES[q.dtype],
            KV_KERNEL_DTYPES[kc.dtype])
    return out


def launch_ragged_paged_attention_int8(q, kc, vc, k_scales, v_scales,
                                       page_tables, pos, q_lens, anc, out,
                                       scale: float, plan):
    """Launch the int8-pool ragged paged-attention kernels: the same split
    page walk and combine, int8 pages dequantized on load with their
    (N, Hkv) fp32 scales. Validated by the caller as above."""
    ws, partials = _split_workspace(q, plan)
    _launch(RAGGED_PAGED_ATTENTION_INT8, q.device, q.data_ptr(),
            kc.data_ptr(), vc.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), page_tables.data_ptr(), pos.data_ptr(),
            q_lens.data_ptr(), anc.data_ptr(), out.data_ptr(), *partials,
            *_split_shapes(q, kc, page_tables),
            *plan, float(scale), KERNEL_DTYPES[q.dtype])
    return out


def _split_workspace(q, plan):
    """A fresh fp32 workspace of the splits' partials and the (acc, m, l)
    pointers into it: (B, nsplit, S, H, D) acc, (B, nsplit, S, H) m and
    l. The caller holds the tensor until the launch is enqueued."""
    B, S, H, D = q.shape
    rows = B * plan[1] * S * H
    ws = torch.empty(rows * (D + 2), dtype=torch.float32, device=q.device)
    acc = ws.data_ptr()
    m = acc + rows * D * ws.element_size()
    return ws, (acc, m, m + rows * ws.element_size())


def _split_shapes(q, kc, page_tables):
    """B, S, H, Hkv, D, P, maxp as the ragged entry points take them."""
    B, S, H, D = q.shape
    _, P, Hkv, _ = kc.shape
    return B, S, H, Hkv, D, P, page_tables.shape[1]


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


def launch_flash_attention_bh_fwd(q, k, v, out, lse, causal: bool,
                                  scale: float):
    """K4: out (BH, S, D) and the fp32 logsumexp lse (BH, S) of attention
    over head-major q (BH, S, D), k/v (BH, T, D). The caller
    (ops.flash_attention) has validated devices, dtypes, shapes and
    contiguity."""
    BH, S, D = q.shape
    _launch(FLASH_ATTENTION_BH_FWD, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, S, k.shape[1],
            D, int(causal), float(scale), KERNEL_DTYPES[q.dtype])
    return out, lse


def launch_flash_attention_bh_fwd_carry(q, k, v, m, l, acc, causal: bool,
                                        scale: float):
    """K5: fold head-major k/v (BH, T, D) into the carried fp32 statistics
    m, l (BH, S) and acc (BH, S, D) of q (BH, S, D), in place. Validated
    by the caller (ops.flash_attention.flash_bh_fwd_carry)."""
    BH, S, D = q.shape
    _launch(FLASH_ATTENTION_BH_FWD_CARRY, q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
            acc.data_ptr(), BH, S, k.shape[1], D, int(causal), float(scale),
            KERNEL_DTYPES[q.dtype])
    return m, l, acc


def launch_flash_attention_bh_dq(q, k, v, dout, lse, delta, dq,
                                 causal: bool, scale: float):
    """K4, dq: the query gradient from the caller's lse and delta."""
    BH, S, D = q.shape
    _launch(FLASH_ATTENTION_BH_DQ, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), BH, S, k.shape[1], D, int(causal), float(scale),
            KERNEL_DTYPES[q.dtype])
    return dq


def launch_flash_attention_bh_dkv(q, k, v, dout, lse, delta, dk, dv,
                                  causal: bool, scale: float):
    """K4, dk/dv: the key and value gradients at BH heads from the
    caller's lse and delta."""
    BH, S, D = q.shape
    _launch(FLASH_ATTENTION_BH_DKV, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), BH, S, k.shape[1], D, int(causal),
            float(scale), KERNEL_DTYPES[q.dtype])
    return dk, dv
