"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C launch function. At first use all
sources are compiled together (one ``nvcc`` process each, started at once)
for ``sm_90a`` into ``build/kernels/`` at the repository root, and loaded
with ``ctypes``. A library's file name carries a hash of its source and
flags, so an edited source is never served from a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# kernel name -> (C function, argtypes); every function returns its
# cudaGetLastError() after the launch
SIGNATURES = {
    # a, b, out, n, op, a_dtype, b_dtype, wa, wb, stream
    "pair_fuse": ("pair_fuse_launch",
                  [_vp, _vp, _vp, _ll, _i, _i, _i, _f, _f, _vp]),
    # updates, weights, out, k, n, dtype, stream
    "fused_agg": ("fused_agg_launch", [_vp, _vp, _vp, _i, _ll, _i, _vp]),
}

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # name -> ptxas report of the last build


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    files = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    src = b"".join(f.read_bytes() for f in files)
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, all in parallel.
    Returns the seconds it took; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    todo = {n: _target(n) for n in SIGNATURES if not _target(n).exists()}
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    if name not in _libs:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def check(name: str, err: int) -> None:
    """Raise if a launch function reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
