"""Build and load the hand-written Hopper kernels.

At first use, nvcc compiles every ``csrc/*.cu`` of the package into one
shared library with a plain C interface for ``sm_90a``, and ctypes loads
it. The library lands in ``build/sparse_solvers_tpu_torch/`` beside the
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
SOURCES = ("normal_bf16.cu", "scan.cu", "transition.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (every pointer and the stream as void*)
_SIGNATURES = {
    # D, A16, P scratch, Q, b, m, n, stream
    "ss_normal_matvec_bf16": (_P, _P, _P, _P, _I, _I, _I, _P),
    # q, c, mask, c_inf, x_act, d_act, indices, gamma, idx, b, n, K, stream
    "ss_find_max_gamma": (_P,) * 9 + (_I, _I, _I, _P),
    # inv, gk, x, d, ca, ind, u1, idx, kk, gamma, vtv, cnew, live, doins,
    # dorm, deg, tol, sentinel, b, K, stream
    "ss_transition": (_P,) * 16 + (ctypes.c_float, _I, _I, _I, _P),
    "ss_transition_smem_bytes": (_I,),
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
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsstorch_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


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


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
