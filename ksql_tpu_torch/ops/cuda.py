"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries land
in ``build/ksql_tpu_torch/`` at the root of the checkout, named by a hash of
their sources and flags, and are built at first use.  Nothing here runs at
import time: this module imports on machines without a CUDA toolkit.

Every C entry point takes raw device pointers, 64-bit scalars and the CUDA
stream, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
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
from typing import Callable, Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ksql_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64
#: the C entry points of each kernel library (``csrc/<name>.cu``) and their
#: signatures (all return cudaError_t)
SIGNATURES: Dict[str, Dict[str, List]] = {
    "row_prologue": {"ksql_row_prologue": [
        _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P,
        _P, _P, _P, _P, _P, _P, _P]},
    "probe_insert": {
        "ksql_probe_insert": [
            _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P],
        "ksql_probe_insert_sizes": [_P],
    },
    "fold_and_mark": {
        "ksql_fold_and_mark": [_P, _I, _P, _P, _I, _I, _P, _P, _P, _P],
        "ksql_fold_argset": [_P, _I, _P, _I, _I, _P, _P, _P],
    },
    "evict": {"ksql_evict": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P]},
    "sliced_fold": {"ksql_sliced_fold": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P]},
    "combine_windows": {"ksql_combine_windows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "member_lanes": {"ksql_member_lanes": [
        _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P]},
    "probe_find": {
        "ksql_probe_find": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
        "ksql_probe_find_slots": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P],
        "ksql_probe_gather": [_P, _I, _P, _I, _P, _I, _P, _P],
    },
    "table_upsert": {
        "ksql_table_upsert": [_P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _P],
        "ksql_table_upsert_side": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P],
    },
    "ss_match": {
        "ksql_ss_match_count": [
            _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
        "ksql_ss_match_write": [
            _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I,
            _P, _I, _P, _I, _P, _P],
    },
    "ss_insert": {
        "ksql_ss_insert_prologue": [
            _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
            _P, _P, _P, _P, _P, _P],
        "ksql_ss_insert_write": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I,
            _P, _P, _P, _P],
    },
    "ss_expire": {"ksql_ss_expire": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
        _I, _P, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P]},
    "seg_sort": {"ksql_seg_sort": [_P, _P, _I, _P, _P, _P]},
    "session_items": {
        "ksql_session_prologue": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _P],
        "ksql_session_first": [_P, _P, _P, _I, _P, _P],
        "ksql_session_items": [
            _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
            _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "session_merge": {"ksql_session_merge": [
        _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, *[_P] * 20, _P]},
    "session_write": {
        "ksql_session_delete": [_P, _P, _I, _P, _P, _P, _I, _P],
        "ksql_session_write": [
            _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, *[_P] * 12, _P, _P, _I, *[_P] * 6, _P],
    },
    "suppress_clock": {"ksql_suppress_clock": [
        _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P]},
    "suppress_close": {"ksql_suppress_close": [
        _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _I, _P]},
    "having_verdict": {"ksql_having_verdict": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P]},
    "vec_collect": {
        "ksql_vec_collect_keys": [_I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P],
        "ksql_vec_collect_member": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P],
        "ksql_vec_collect_place": [_I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    },
    "vec_topk": {
        "ksql_vec_topk": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    },
    "vec_hist": {"ksql_vec_hist": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _P]},
    "vec_remove": {
        "ksql_vec_remove": [_P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P],
    },
    "fk_fanout": {"ksql_fk_fanout": [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P]},
    "tap_residual": {"ksql_tap_residual": [
        _P, _I, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P]},
}
KERNELS = tuple(SIGNATURES)

# loaded entry points (by symbol) are immutable code, shared process-wide like
# torch's own extension cache; the lock makes first-use builds from two
# threads safe
_LIBS: Dict[str, Callable[..., int]] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (SRC_DIR / f"{name}.cu", SRC_DIR / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together.  Returns per kernel ``{"seconds",
    "ptxas"}`` (the wall time of its nvcc and its ``-Xptxas -v`` report;
    ``seconds`` is 0 for a library already on disk).  Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    out: Dict[str, dict] = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            out[name] = {"seconds": 0.0, "ptxas": "(cached)"}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            time.perf_counter(), tmp, target,
        )
    failed = []
    for name, (proc, t0, tmp, target) in procs.items():
        log, _ = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def lib(name: str, entry: Optional[str] = None):
    """The loaded C entry point ``entry`` of kernel library ``name`` (built
    at first use); ``entry`` may be left out for a library with one."""
    entries = SIGNATURES[name]
    if entry is None:
        (entry,) = entries
    fn = _LIBS.get(entry)
    if fn is not None:
        return fn
    with _LOCK:
        fn = _LIBS.get(entry)
        if fn is None:
            build([name])
            fn = getattr(ctypes.CDLL(str(_lib_path(name))), entry)
            fn.argtypes = entries[entry]
            fn.restype = ctypes.c_int
            _LIBS[entry] = fn
        return fn


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def host_i64(values: Iterable[int]):
    """A ctypes int64 array in host memory (kernel descriptors passed by
    value: the C side copies it into the launch's parameter struct)."""
    vals = list(values)
    return (ctypes.c_int64 * max(len(vals), 1))(*vals)
