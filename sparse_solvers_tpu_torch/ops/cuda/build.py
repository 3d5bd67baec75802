"""Build and load the hand-written Hopper kernels.

At first use, nvcc compiles every ``csrc/*.cu`` of the package for
``sm_90a`` (one nvcc per source, all started together), links the objects
into one shared library with a plain C interface, and ctypes loads it. The library lands in ``build/sparse_solvers_tpu_torch/`` beside the
package, under a name that carries a hash of the sources and flags, so a
stale library is never loaded. ``torch.utils.cpp_extension`` is not
used: a source that includes PyTorch's headers takes minutes to compile,
a plain C one seconds.

Every entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; the wrappers raise on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sparse_solvers_tpu_torch"
SOURCES = ("normal_bf16.cu", "scan.cu", "transition.cu", "omp_insert.cu",
           "fused_corr.cu")
HEADERS = ("tile_gemm.cuh", "wgmma_gemm.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (every pointer and the stream as void*)
_SIGNATURES = {
    # D, A16, D16 and P scratches, Q, b, m, n, wgmma, batch tile, column
    # tiles and pass 1's splits and chunk (bm, bn1, splits, chunk, bn2),
    # stream
    "ss_normal_matvec_bf16": (_P,) * 5 + (_I,) * 8 + (_P,),
    # q, c, mask, c_inf, x_act, d_act, indices, gamma, idx, b, n, K,
    # threads, splits, chunk, vec, stream
    "ss_find_max_gamma": (_P,) * 9 + (_I,) * 7 + (_P,),
    # inv, gk, x, d, ca, ind, u1, idx, kk, gamma, vtv, cnew, live, doins,
    # dorm, deg, work, tol, sentinel, b, K, route, threads, cols, vec,
    # shared bytes, stream
    "ss_transition": (_P,) * 17 + (ctypes.c_float,) + (_I,) * 8 + (_P,),
    # inv, u1, kk, vtv, b_act, doins, coef, deg, b, K, threads, shared,
    # vec, shared bytes, stream
    "ss_omp_insert": (_P,) * 8 + (_I,) * 6 + (_P,),
    # D, A, the A16, D16, P1, T and P2 scratches, Q, b, m, n, bf16_mode,
    # batch tile, s1, c1, s2, c2, stream
    "ss_normal_matvec_f32": (_P,) * 8 + (_I,) * 9 + (_P,),
    # X, Y, A, the A16, X16, P1, R and P2 scratches, C, then as K5
    "ss_residual_correlation_f32": (_P,) * 9 + (_I,) * 9 + (_P,),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit's default home."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsstorch_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the first failure's
    output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [proc.communicate() for proc in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{err}{out}")


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(name).stem}.o")
            for name in SOURCES]
    nvcc = _nvcc()
    try:
        _run([[nvcc, *FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
              for name, obj in zip(SOURCES, objs)])
        _run([[nvcc, *FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        for path in (tmp, *objs):
            path.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check_operands(names: str, tensors, expected) -> None:
    """Raise unless each tensor has its expected (shape, dtype) and is
    contiguous — what a kernel takes; ``names`` is space-separated."""
    for name, t, (shape, dtype) in zip(names.split(), tensors, expected):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
