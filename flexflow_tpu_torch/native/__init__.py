"""Native helpers built from the port's own sources (counterpart of
flexflow_tpu/native/__init__.py).

`csrc/ffloader.cc` is the data loader's C++ worker: an mmap'd .npy file
and a background thread that gathers (shuffled) sample rows into a ring
of batch buffers off the GIL, behind a plain C ABI (ffl_open, ffl_config,
ffl_reset, ffl_next, ffl_close). `csrc/ffsim.cc` is the strategy search's
engine: (node, view) cost tables evaluated, simulated and annealed
(ffsim_eval, ffsim_simulate, ffsim_mcmc) and the task-DAG list scheduler
of the event simulator (ffsim_tasksim_*). Both are bound with ctypes and
compiled with g++ at first use into `_build/` (the file name carries a
hash of the source, so an edited source never loads a stale build;
written to a temporary name and renamed, so a concurrent process never
loads half a file), never at import. A failed build raises with the
compiler's output: there is no fallback and no switch to turn either off
(the reference's silently degrades to Python).
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
SIM_SOURCE = _PKG / "csrc" / "ffsim.cc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_loader_lib = None
_sim_lib = None


def _library_path(source: Path, stem: str) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}_{digest[:12]}.so"


def _build(source: Path, stem: str) -> Path:
    """Compile `source` unless its library exists; returns the library's
    path. Raises RuntimeError with g++'s output on failure."""
    out = _library_path(source, stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *GXX_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run to build {source}: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def loader_library_path() -> Path:
    return _library_path(LOADER_SOURCE, "ffloader")


def build_loader() -> Path:
    """Compile csrc/ffloader.cc unless its library exists."""
    return _build(LOADER_SOURCE, "ffloader")


def sim_library_path() -> Path:
    return _library_path(SIM_SOURCE, "ffsim")


def build_sim() -> Path:
    """Compile csrc/ffsim.cc unless its library exists."""
    return _build(SIM_SOURCE, "ffsim")


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


# ---------------------------------------------------------------------------
# the search engine (csrc/ffsim.cc)


def get_sim_lib() -> ctypes.CDLL:
    """The bound search engine, built on the first call."""
    global _sim_lib
    with _lock:
        if _sim_lib is None:
            lib = ctypes.CDLL(str(build_sim()))
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.ffsim_create.restype = ctypes.c_void_p
            lib.ffsim_create.argtypes = [ctypes.c_int]
            lib.ffsim_destroy.argtypes = [ctypes.c_void_p]
            lib.ffsim_set_node.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, dp, dp, dp, dp]
            lib.ffsim_add_edge.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, dp]
            lib.ffsim_eval.restype = ctypes.c_double
            lib.ffsim_eval.argtypes = [ctypes.c_void_p, ip, ctypes.c_double,
                                       dp]
            lib.ffsim_simulate.restype = ctypes.c_double
            lib.ffsim_simulate.argtypes = [ctypes.c_void_p, ip]
            lib.ffsim_mcmc.restype = ctypes.c_int
            lib.ffsim_mcmc.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                ctypes.c_uint64, ctypes.c_double, ctypes.c_double,
                ctypes.c_int, ip, dp]
            lib.ffsim_tasksim_build.restype = ctypes.c_void_p
            lib.ffsim_tasksim_build.argtypes = [
                ctypes.c_int, ctypes.c_int, ip, dp, ctypes.c_int, ip, ip]
            lib.ffsim_tasksim_destroy.argtypes = [ctypes.c_void_p]
            lib.ffsim_tasksim_run.restype = ctypes.c_double
            lib.ffsim_tasksim_run.argtypes = [ctypes.c_void_p]
            _sim_lib = lib
        return _sim_lib


def available() -> bool:
    """True once the search engine is built and bound; a failed build
    raises. The search keeps the reference's pure-Python paths behind
    this call (its tests reach them by patching it to return False)."""
    return get_sim_lib() is not None


class NativeSimGraph:
    """Owns one ffsim graph handle; rows are (node, view) cost tables."""

    def __init__(self, n_nodes: int):
        self._lib = get_sim_lib()
        self._h = self._lib.ffsim_create(n_nodes)
        self.n_nodes = n_nodes
        self._n_views = [0] * n_nodes

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ffsim_destroy(self._h)
            self._h = None

    @staticmethod
    def _darr(vals):
        return (ctypes.c_double * len(vals))(*vals)

    def set_node(self, node, compute, comm, sync, memory):
        n = len(compute)
        assert len(comm) == len(sync) == len(memory) == n
        self._n_views[node] = n
        self._lib.ffsim_set_node(
            self._h, node, n, self._darr(compute), self._darr(comm),
            self._darr(sync), self._darr(memory))

    def add_edge(self, src, dst, xfer_matrix):
        flat = [x for row in xfer_matrix for x in row]
        assert len(flat) == self._n_views[src] * self._n_views[dst]
        self._lib.ffsim_add_edge(self._h, src, dst, self._darr(flat))

    def _iarr(self, assignment):
        assert len(assignment) == self.n_nodes
        return (ctypes.c_int * self.n_nodes)(*assignment)

    def eval(self, assignment, overlap: float = 0.0):
        mem = ctypes.c_double()
        t = self._lib.ffsim_eval(self._h, self._iarr(assignment), overlap,
                                 ctypes.byref(mem))
        return t, mem.value

    def simulate(self, assignment) -> float:
        return self._lib.ffsim_simulate(self._h, self._iarr(assignment))

    def mcmc(self, assignment, *, budget: int, alpha: float, seed: int = 0,
             overlap: float = 0.0, memory_limit: float = 0.0,
             use_simulate: bool = False):
        arr = self._iarr(assignment)
        best_cost = ctypes.c_double()
        accepted = self._lib.ffsim_mcmc(
            self._h, budget, alpha, seed, overlap, memory_limit,
            1 if use_simulate else 0, arr, ctypes.byref(best_cost))
        return list(arr), best_cost.value, accepted


def run_task_dag(n_channels: int, channels, durations, dep_src, dep_dst):
    """List-schedule a task DAG on `n_channels` serial channels (per-chip
    compute and per-axis links, csrc/ffsim.cc ffsim_tasksim_build) and
    return the makespan, or None when the scheduler reports a failure.
    The arrays (numpy arrays fine) ship in one call each."""
    import numpy as np

    lib = get_sim_lib()
    ch = np.ascontiguousarray(channels, dtype=np.int32)
    du = np.ascontiguousarray(durations, dtype=np.float64)
    ds = np.ascontiguousarray(dep_src, dtype=np.int32)
    dd = np.ascontiguousarray(dep_dst, dtype=np.int32)
    ip = ctypes.POINTER(ctypes.c_int)
    dp = ctypes.POINTER(ctypes.c_double)
    h = lib.ffsim_tasksim_build(
        n_channels, len(ch), ch.ctypes.data_as(ip), du.ctypes.data_as(dp),
        len(ds), ds.ctypes.data_as(ip), dd.ctypes.data_as(ip))
    try:
        t = lib.ffsim_tasksim_run(h)
    finally:
        lib.ffsim_tasksim_destroy(h)
    return None if t < 0 else t
