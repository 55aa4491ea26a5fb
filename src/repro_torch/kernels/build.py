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
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# kernel name -> (C function, argtypes); every function returns its
# cudaGetLastError() after the launch, and cudaErrorInvalidValue for a launch
# shape (elements a thread, threads a block) outside common.cuh's fixed set
SIGNATURES = {
    # rows (count x 6 int64: a, b, out, n, first block, vector flag), count,
    # op, a_dtype, b_dtype, wa, wb, vec, threads, stream
    "pair_fuse": ("pair_fuse_table_launch",
                  [_vp, _i, _i, _i, _i, _f, _f, _i, _i, _vp]),
    # updates, weights, out, k, n, dtype, vec, threads, stream
    "fused_agg": ("fused_agg_launch",
                  [_vp, _vp, _vp, _i, _ll, _i, _i, _i, _vp]),
    # q, scales, out, k, n, vec, threads, stream
    "quant_agg": ("quant_agg_launch", [_vp, _vp, _vp, _i, _ll, _i, _i, _vp]),
}

#: the launch shapes (elements a thread, threads a block) every library
#: exports: csrc/common.cuh FOR_EACH_SHAPE
SHAPES = tuple((v, t) for v in (4, 8, 16) for t in (128, 256, 512, 1024))
#: each kernel's shape when the caller names none. pair_fuse takes 4
#: elements a thread (one float4 of the fp32 accumulator, 8 bytes of a bf16
#: update): at the main path's leaves of 58.7M-155.6M elements it ran about
#: 1 % faster than 8 x 256, beyond the spread of its runs (0.5075 against
#: 0.5136 ms at 155,582,464; chip_smoke.py phase 13 on an NVIDIA H100 80GB
#: HBM3 at 700 W). fused_agg and quant_agg gained nothing beyond the spread.
DEFAULT_SHAPES = {"pair_fuse": (4, 256), "fused_agg": (8, 256),
                  "quant_agg": (8, 256)}


def default_tile(kernel: str) -> Tuple[int, int]:
    """``kernel``'s default shape as (bn, kb)."""
    vec, threads = DEFAULT_SHAPES[kernel]
    return vec * threads, vec


def launch_shape(kernel: str, bn: Optional[int] = None,
                 kb: Optional[int] = None) -> Tuple[int, int]:
    """(elements a thread, threads a block) from the wrappers' tile
    arguments: ``bn`` the elements a block owns, ``kb`` the elements a
    thread, so threads = bn / kb. ``None`` takes the part of ``kernel``'s
    default (``DEFAULT_SHAPES``). Raises for a shape outside ``SHAPES``."""
    vec = DEFAULT_SHAPES[kernel][0] if kb is None else kb
    threads = DEFAULT_SHAPES[kernel][1] if bn is None else bn // vec
    if bn is not None and bn != vec * threads or (vec, threads) not in SHAPES:
        raise ValueError(
            f"bn={bn}, kb={kb} is no exported launch shape: bn is threads x "
            f"kb with (kb, threads) in {SHAPES}")
    return vec, threads


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
