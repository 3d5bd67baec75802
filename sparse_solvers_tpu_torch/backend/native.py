"""ctypes binding to the C++ host engine of ``csrc/`` — the port's own copy
of what it needs from ``sparse_solvers_tpu/backend/native.py``.

The host engine runs the solvers' fast-path algorithms on the CPU in C++
(insertion-ordered active set, online inverse, threaded batches). The
façades route to it for an explicit ``engine="native"``, and a CPU
façade's ``"auto"`` for problems of at most 2¹⁶ elements
(``api._route_native``). The functions here take and return numpy
arrays; the façades move the results to their device.

The library is built from the repo's ``csrc/sparsesolvers_cpu.cpp`` with
the flags of ``csrc/Makefile``, at first use, into
``build/sparse_solvers_tpu_torch/`` under a name that carries a hash of
the source, the compiler, the flags and the CPU model (``-march=native``),
so a stale library is never loaded. ``csrc/`` itself is never written.
The build holds an exclusive file lock and writes a temporary file that
is renamed into place, so processes that start at once build the library
once and never load a half-written file.

``SS_NATIVE_DISABLE=1`` forbids the route. Runtime BLAS, as in the JAX
package: a CBLAS shared library is discovered (the OpenBLAS builds bundled
inside numpy/scipy wheels, then a system libopenblas) and handed to the
engine's ``ss_blas_load``; ``SS_NATIVE_BLAS=0`` disables discovery,
``SS_NATIVE_BLAS=/path/to/lib.so[:prefix[:suffix[:ilp64]]]`` pins a
library. ``blas_info()`` reports what loaded.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops.cuda.build import BUILD_DIR

SOURCE = (Path(__file__).resolve().parents[2] / "csrc"
          / "sparsesolvers_cpu.cpp")
# csrc/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-Wextra")
LDFLAGS = ("-shared", "-lpthread", "-ldl")

_lock = threading.Lock()
_lib = None
_tried = False
_error: str | None = None            # why the last load failed
_blas = {"active": 0, "path": None}  # filled by _load_blas under _lock


def _cxx() -> str | None:
    """The C++ compiler: $CXX, else g++ on PATH; None if there is none."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` builds for it."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f
                         if line.startswith("model name")), "")
    except OSError:
        return ""


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for this source, compiler, flags and CPU model
    lives."""
    h = hashlib.sha256(" ".join((str(_cxx()), _cpu_model()) + CXXFLAGS
                                + LDFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libsscpu_{h.hexdigest()[:16]}.so"


def build_library(build_dir: Path = BUILD_DIR) -> tuple[Path, bool]:
    """Compile the library into ``build_dir`` unless it is there already.
    Returns (its path, whether this call compiled it). Holds an exclusive
    lock on ``<library>.lock`` throughout, so that of several processes
    that call this at once one compiles and the others wait and load its
    file; the compiler writes a temporary name that is renamed into
    place."""
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
    out = library_path(build_dir)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out, False
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run([cxx, *CXXFLAGS, str(SOURCE), "-o",
                                   str(tmp), *LDFLAGS],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                                   f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out, True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int)

    lib.ss_homotopy_solve_f32.restype = ctypes.c_int
    lib.ss_homotopy_solve_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, f32p, f32p]
    lib.ss_homotopy_solve_f64.restype = ctypes.c_int
    lib.ss_homotopy_solve_f64.argtypes = [
        f64p, ctypes.c_int, ctypes.c_int, f64p, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, f64p, f64p]
    lib.ss_homotopy_solve_batch_f32.restype = None
    lib.ss_homotopy_solve_batch_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, i32p, f32p]
    lib.ss_homotopy_solve_batch_f64.restype = None
    lib.ss_homotopy_solve_batch_f64.argtypes = [
        f64p, ctypes.c_int, ctypes.c_int, f64p, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f64p, i32p, f64p]
    # OMP shares the homotopy entry-point shape
    lib.ss_omp_solve_f32.restype = ctypes.c_int
    lib.ss_omp_solve_f32.argtypes = lib.ss_homotopy_solve_f32.argtypes
    lib.ss_omp_solve_f64.restype = ctypes.c_int
    lib.ss_omp_solve_f64.argtypes = lib.ss_homotopy_solve_f64.argtypes
    # generalized OMP: the picks-per-round entries
    for nm, base in (("ss_omp_solve_pk_f32", lib.ss_omp_solve_f32),
                     ("ss_omp_solve_pk_f64", lib.ss_omp_solve_f64)):
        fn = getattr(lib, nm)
        fn.restype = ctypes.c_int
        a = list(base.argtypes)
        fn.argtypes = a[:7] + [ctypes.c_int] + a[7:]
    lib.ss_omp_solve_batch_f32.restype = None
    lib.ss_omp_solve_batch_f32.argtypes = \
        lib.ss_homotopy_solve_batch_f32.argtypes
    lib.ss_omp_solve_batch_f64.restype = None
    lib.ss_omp_solve_batch_f64.argtypes = \
        lib.ss_homotopy_solve_batch_f64.argtypes
    for nm, base in (
            ("ss_omp_solve_batch_pk_f32", lib.ss_omp_solve_batch_f32),
            ("ss_omp_solve_batch_pk_f64", lib.ss_omp_solve_batch_f64)):
        fn = getattr(lib, nm)
        fn.restype = None
        a = list(base.argtypes)  # (..., k_max, nthreads, X, iters, errs)
        fn.argtypes = a[:8] + [ctypes.c_int] + a[8:]
    lib.ss_irls_create_f32.restype = ctypes.c_void_p
    lib.ss_irls_create_f32.argtypes = [f32p, ctypes.c_int, ctypes.c_int]
    lib.ss_irls_solve_f32.restype = ctypes.c_int
    lib.ss_irls_solve_f32.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_float, ctypes.c_int, f32p, f32p,
        i32p]
    lib.ss_irls_destroy_f32.restype = None
    lib.ss_irls_destroy_f32.argtypes = [ctypes.c_void_p]
    lib.ss_irls_solve_batch_f32.restype = None
    lib.ss_irls_solve_batch_f32.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, f32p, i32p, f32p, i32p]
    lib.ss_irls_create_f64.restype = ctypes.c_void_p
    lib.ss_irls_create_f64.argtypes = [f64p, ctypes.c_int, ctypes.c_int]
    lib.ss_irls_solve_f64.restype = ctypes.c_int
    lib.ss_irls_solve_f64.argtypes = [
        ctypes.c_void_p, f64p, ctypes.c_double, ctypes.c_int, f64p, f64p,
        i32p]
    lib.ss_irls_destroy_f64.restype = None
    lib.ss_irls_destroy_f64.argtypes = [ctypes.c_void_p]
    lib.ss_irls_solve_batch_f64.restype = None
    lib.ss_irls_solve_batch_f64.argtypes = [
        ctypes.c_void_p, f64p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, f64p, i32p, f64p, i32p]
    lib.ss_irls_cg_solve_f32.restype = ctypes.c_int
    lib.ss_irls_cg_solve_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, f32p, f32p, i32p]
    lib.ss_irls_cg_solve_f64.restype = ctypes.c_int
    lib.ss_irls_cg_solve_f64.argtypes = [
        f64p, ctypes.c_int, ctypes.c_int, f64p, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, f64p, f64p, i32p]
    lib.ss_irls_cg_solve_batch_f32.restype = None
    lib.ss_irls_cg_solve_batch_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, f32p, i32p, f32p, i32p]
    lib.ss_irls_cg_solve_batch_f64.restype = None
    lib.ss_irls_cg_solve_batch_f64.argtypes = [
        f64p, ctypes.c_int, ctypes.c_int, f64p, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int, f64p, i32p, f64p, i32p]
    return lib


def _blas_candidates():
    """Yield (path, symbol_prefix, symbol_suffix, ilp64) CBLAS candidates
    in preference order. Wheel-bundled OpenBLAS builds mangle symbol
    names per build flavor:

      numpy.libs/libscipy_openblas64_*.so → scipy_cblas_sgemv64_ (ILP64)
      scipy.libs/libscipy_openblas-*.so   → scipy_cblas_sgemv    (LP64)
      plain libopenblas64_*.so            → cblas_sgemv64_       (ILP64)
      plain libopenblas*.so               → cblas_sgemv          (LP64)

    A candidate whose symbols don't resolve is skipped by ss_blas_load
    (returns 0), so guessing wrong here is harmless."""
    spec = os.environ.get("SS_NATIVE_BLAS", "")
    if spec == "0":
        return
    if spec:
        # a library path may itself contain ':' — the longest ':'-joined
        # prefix that names an existing file is the path, the rest parses
        # as prefix/suffix/ilp64; a pin that names no file falls through
        # to the plain left-split so that its failure surfaces below
        parts = spec.split(":")
        path, rest = parts[0], parts[1:]
        for i in range(len(parts), 0, -1):
            cand = ":".join(parts[:i])
            if os.path.exists(cand):
                path, rest = cand, parts[i:]
                break
        yield (path,
               rest[0] if len(rest) > 0 else "",
               rest[1] if len(rest) > 1 else "",
               int(rest[2]) if len(rest) > 2 else 0)
        return
    for pkg in ("numpy", "scipy"):
        try:
            mod = __import__(pkg)
        except ImportError:
            continue
        libsdir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(mod.__file__))),
            pkg + ".libs")
        for path in sorted(glob.glob(os.path.join(libsdir,
                                                  "lib*openblas*"))):
            base = os.path.basename(path)
            ilp64 = 1 if "openblas64" in base else 0
            prefix = "scipy_" if "scipy_openblas" in base else ""
            yield path, prefix, "64_" if ilp64 else "", ilp64
    import ctypes.util
    sys_lib = ctypes.util.find_library("openblas")
    if sys_lib:
        yield sys_lib, "", "", 0


def _load_blas(lib: ctypes.CDLL) -> None:
    """Hand the first loadable CBLAS candidate to the engine (never
    raises: the engine keeps its scalar loops without one)."""
    lib.ss_blas_load.restype = ctypes.c_int
    lib.ss_blas_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.ss_blas_active.restype = ctypes.c_int
    lib.ss_blas_active.argtypes = []
    lib.ss_blas_set_enabled.restype = None
    lib.ss_blas_set_enabled.argtypes = [ctypes.c_int]
    for path, prefix, suffix, ilp64 in _blas_candidates():
        if lib.ss_blas_load(os.fsencode(path), prefix.encode(),
                            suffix.encode(), int(ilp64)):
            _blas["active"] = int(lib.ss_blas_active())
            _blas["path"] = path
            return
    if os.environ.get("SS_NATIVE_BLAS", "") not in ("", "0"):
        # an explicit pin that did not resolve would otherwise degrade
        # silently to the scalar loops
        import warnings
        warnings.warn(
            "SS_NATIVE_BLAS=%r did not load (missing file or symbols); "
            "the native engine runs with scalar fallbacks — see "
            "blas_info()" % os.environ["SS_NATIVE_BLAS"],
            RuntimeWarning, stacklevel=2)


def blas_info() -> dict:
    """What the engine's runtime-BLAS loader resolved: ``active`` 0 =
    scalar fallbacks, 1 = LP64 CBLAS, 2 = ILP64 CBLAS; ``path`` = the
    loaded shared library. Triggers the library's build and load."""
    lib = get_lib()
    if lib is None:
        return {"active": 0, "path": None}
    return {"active": int(lib.ss_blas_active()), "path": _blas["path"]}


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the host library; None if unavailable
    (``load_error()`` says why)."""
    global _lib, _tried, _error
    if os.environ.get("SS_NATIVE_DISABLE") == "1":
        return None
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                path, _ = build_library()
                _lib = _bind(ctypes.CDLL(str(path)))
                _load_blas(_lib)
            except (OSError, AttributeError, RuntimeError,
                    subprocess.TimeoutExpired) as exc:
                _lib, _error = None, f"{type(exc).__name__}: {exc}"
        return _lib


def load_error() -> str | None:
    """Why the library did not build or load, or None."""
    return _error


def available(build: bool = True) -> bool:
    """Whether the host engine is (or would be) usable.

    ``build=False`` is the side-effect-free probe for ``explain()``: no
    compiler run and no library load beyond what already happened; a
    source that a compiler on this machine could build counts as
    available (a solve would build it)."""
    if build:
        return get_lib() is not None
    if os.environ.get("SS_NATIVE_DISABLE") == "1":
        return False
    if _tried:
        return _lib is not None
    return SOURCE.exists() and _cxx() is not None


def _require() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native backend unavailable")
    return lib


def _types(A: np.ndarray):
    """(numpy dtype, ctypes pointer type, ctypes scalar type, f64) for A's
    precision: float64 stays float64, anything else runs in float32."""
    if A.dtype == np.float64:
        return np.float64, ctypes.POINTER(ctypes.c_double), \
            ctypes.c_double, True
    return np.float32, ctypes.POINTER(ctypes.c_float), ctypes.c_float, False


def _check_batch(Y: np.ndarray, m: int) -> None:
    """The C ABI reads batch·m values with no bounds information, so the
    shape is enforced here for every batch entry point."""
    if Y.ndim != 2 or Y.shape[1] != m:
        raise ValueError(
            f"batch signals must have shape (batch, {m}); got {Y.shape}")


def _check_vector(y: np.ndarray, m: int) -> None:
    """The same bounds contract for the single-solve entry points: the C
    ABI reads m values from the pointer."""
    if y.ndim != 1 or y.shape[0] != m:
        raise ValueError(f"signal must have shape ({m},); got {y.shape}")


_I32P = ctypes.POINTER(ctypes.c_int)


def homotopy_solve(A: np.ndarray, y: np.ndarray, tol: float,
                   max_iterations: int, k_max: int):
    """One homotopy solve on the host, the fast-path algorithm (insertion-
    ordered active set, correlation recurrence); float32 or float64 by A's
    dtype. Returns (x, iter, solution_error)."""
    lib = _require()
    dt, p, ct, f64 = _types(A)
    m, n = A.shape
    Ac = np.ascontiguousarray(A, dt)
    yc = np.ascontiguousarray(y, dt)
    _check_vector(yc, m)
    x = np.zeros(n, dt)
    err = ct()
    fn = lib.ss_homotopy_solve_f64 if f64 else lib.ss_homotopy_solve_f32
    it = fn(Ac.ctypes.data_as(p), m, n, yc.ctypes.data_as(p), float(tol),
            int(max_iterations), int(k_max), x.ctypes.data_as(p),
            ctypes.byref(err))
    return x, it, err.value


def homotopy_solve_batch(A: np.ndarray, Y: np.ndarray, tol: float,
                         max_iterations: int, k_max: int,
                         nthreads: int = 0):
    """Threaded batched homotopy on the host; float32 or float64 by A's
    dtype. Returns (X (batch, n), iters (batch,), errs (batch,))."""
    lib = _require()
    dt, p, _, f64 = _types(A)
    m, n = A.shape
    Ac = np.ascontiguousarray(A, dt)
    Yc = np.ascontiguousarray(Y, dt)
    _check_batch(Yc, m)
    batch = Yc.shape[0]
    X = np.zeros((batch, n), dt)
    iters = np.zeros(batch, np.int32)
    errs = np.zeros(batch, dt)
    fn = lib.ss_homotopy_solve_batch_f64 if f64 \
        else lib.ss_homotopy_solve_batch_f32
    fn(Ac.ctypes.data_as(p), m, n, Yc.ctypes.data_as(p), batch,
       float(tol), int(max_iterations), int(k_max), int(nthreads),
       X.ctypes.data_as(p), iters.ctypes.data_as(_I32P),
       errs.ctypes.data_as(p))
    return X, iters, errs


def omp_solve(A: np.ndarray, y: np.ndarray, tol: float,
              max_iterations: int, k_max: int, picks: int = 1):
    """One OMP solve on the host — the fast path's trajectory (leftmost
    greedy pick, insertion-ordered online-inverse LS, true residual);
    ``picks`` > 1 runs generalized-OMP rounds. Returns (x, iter,
    resid_norm); float32 or float64 by A's dtype."""
    lib = _require()
    dt, p, ct, f64 = _types(A)
    m, n = A.shape
    Ac = np.ascontiguousarray(A, dt)
    yc = np.ascontiguousarray(y, dt)
    _check_vector(yc, m)
    x = np.zeros(n, dt)
    err = ct()
    head = (Ac.ctypes.data_as(p), m, n, yc.ctypes.data_as(p), float(tol),
            int(max_iterations), int(k_max))
    tail = (x.ctypes.data_as(p), ctypes.byref(err))
    if picks > 1:
        fn = lib.ss_omp_solve_pk_f64 if f64 else lib.ss_omp_solve_pk_f32
        it = fn(*head, int(picks), *tail)
    else:
        fn = lib.ss_omp_solve_f64 if f64 else lib.ss_omp_solve_f32
        it = fn(*head, *tail)
    return x, it, err.value


def omp_solve_batch(A: np.ndarray, Y: np.ndarray, tol: float,
                    max_iterations: int, k_max: int, nthreads: int = 0,
                    picks: int = 1):
    """Threaded batched OMP on the host; results bit-identical to
    per-signal ``omp_solve`` calls whatever the thread count. Returns (X
    (batch, n), iters, resid_norms)."""
    lib = _require()
    dt, p, _, f64 = _types(A)
    m, n = A.shape
    Ac = np.ascontiguousarray(A, dt)
    Yc = np.ascontiguousarray(Y, dt)
    _check_batch(Yc, m)
    batch = Yc.shape[0]
    X = np.zeros((batch, n), dt)
    iters = np.zeros(batch, np.int32)
    errs = np.zeros(batch, dt)
    head = (Ac.ctypes.data_as(p), m, n, Yc.ctypes.data_as(p), batch,
            float(tol), int(max_iterations), int(k_max))
    tail = (int(nthreads), X.ctypes.data_as(p), iters.ctypes.data_as(_I32P),
            errs.ctypes.data_as(p))
    if picks > 1:
        fn = (lib.ss_omp_solve_batch_pk_f64 if f64
              else lib.ss_omp_solve_batch_pk_f32)
        fn(*head, int(picks), *tail)
    else:
        fn = (lib.ss_omp_solve_batch_f64 if f64
              else lib.ss_omp_solve_batch_f32)
        fn(*head, *tail)
    return X, iters, errs


def irls_cg_solve(A: np.ndarray, y: np.ndarray, tol: float,
                  max_iterations: int, p: float = 1.0,
                  k_sparsity: int | None = None,
                  cg_max_iterations: int | None = None,
                  cg_tolerance: float | None = None):
    """One CG-IRLS basis-pursuit solve on the host (m <= n), the iteration
    of ``solvers/irls_cg.py``. Returns (x, iter, eps, broke); ``broke`` is
    the spd_failure flag. None knobs select the engine defaults."""
    lib = _require()
    dt, ptr, ct, f64 = _types(A)
    m, n = A.shape
    Ac = np.ascontiguousarray(A, dt)
    yc = np.ascontiguousarray(y, dt)
    _check_vector(yc, m)
    x = np.zeros(n, dt)
    eps = ct()
    broke = ctypes.c_int()
    fn = lib.ss_irls_cg_solve_f64 if f64 else lib.ss_irls_cg_solve_f32
    it = fn(Ac.ctypes.data_as(ptr), m, n, yc.ctypes.data_as(ptr),
            float(tol), int(max_iterations), float(p),
            int(k_sparsity or 0), int(cg_max_iterations or 0),
            float(cg_tolerance or 0.0),
            x.ctypes.data_as(ptr), ctypes.byref(eps), ctypes.byref(broke))
    return x, it, eps.value, bool(broke.value)


def irls_cg_solve_batch(A: np.ndarray, Y: np.ndarray, tol: float,
                        max_iterations: int, p: float = 1.0,
                        k_sparsity: int | None = None,
                        cg_max_iterations: int | None = None,
                        cg_tolerance: float | None = None,
                        nthreads: int = 0):
    """Threaded batched CG-IRLS on the host; each solve runs the single-
    solve code, so results are bit-equal to per-signal ``irls_cg_solve``
    calls whatever the thread count. Returns (X (batch, n), iters, eps,
    broke)."""
    lib = _require()
    dt, ptr, _, f64 = _types(A)
    m, n = A.shape
    Ac = np.ascontiguousarray(A, dt)
    Yc = np.ascontiguousarray(Y, dt)
    _check_batch(Yc, m)
    batch = Yc.shape[0]
    X = np.zeros((batch, n), dt)
    iters = np.zeros(batch, np.int32)
    eps = np.zeros(batch, dt)
    broke = np.zeros(batch, np.int32)
    fn = (lib.ss_irls_cg_solve_batch_f64 if f64
          else lib.ss_irls_cg_solve_batch_f32)
    fn(Ac.ctypes.data_as(ptr), m, n, Yc.ctypes.data_as(ptr), batch,
       float(tol), int(max_iterations), float(p), int(k_sparsity or 0),
       int(cg_max_iterations or 0), float(cg_tolerance or 0.0),
       int(nthreads), X.ctypes.data_as(ptr), iters.ctypes.data_as(_I32P),
       eps.ctypes.data_as(ptr), broke.ctypes.data_as(_I32P))
    return X, iters, eps, broke.astype(bool)


class IrlsNative:
    """Construct-once IRLS on the host: the QR is factored at construction
    and reused across solves (the reference's amortized-state shape,
    src/lib.cpp:51-57). float32 or float64 by A's dtype."""

    def __init__(self, A: np.ndarray):
        lib = _require()
        self._dt, self._p, self._ct, self._f64 = _types(A)
        Ac = np.ascontiguousarray(A, self._dt)
        self._m, self._n = Ac.shape
        self._lib = lib
        create = lib.ss_irls_create_f64 if self._f64 \
            else lib.ss_irls_create_f32
        self._h = create(Ac.ctypes.data_as(self._p), self._m, self._n)
        if not self._h:
            raise ValueError("Irls requires m >= n")

    def solve(self, y: np.ndarray, tol: float, max_iterations: int):
        """Returns (x, iter, eps, spd_failure)."""
        yc = np.ascontiguousarray(y, self._dt)
        _check_vector(yc, self._m)
        x = np.zeros(self._n, self._dt)
        err = self._ct()
        spd = ctypes.c_int()
        fn = self._lib.ss_irls_solve_f64 if self._f64 \
            else self._lib.ss_irls_solve_f32
        it = fn(self._h, yc.ctypes.data_as(self._p), float(tol),
                int(max_iterations), x.ctypes.data_as(self._p),
                ctypes.byref(err), ctypes.byref(spd))
        return x, it, err.value, bool(spd.value)

    def solve_batch(self, Y: np.ndarray, tol: float, max_iterations: int,
                    nthreads: int = 0):
        """Threaded batched solve over the cached QR: one worker workspace
        per thread over the shared factorization, each solve the single-
        solve iteration, so results are bit-equal to per-signal ``solve``
        calls whatever the thread count. Returns (X (batch, n), iters,
        errs, spd)."""
        Yc = np.ascontiguousarray(Y, self._dt)
        _check_batch(Yc, self._m)
        batch = Yc.shape[0]
        X = np.zeros((batch, self._n), self._dt)
        iters = np.zeros(batch, np.int32)
        errs = np.zeros(batch, self._dt)
        spd = np.zeros(batch, np.int32)
        fn = (self._lib.ss_irls_solve_batch_f64 if self._f64
              else self._lib.ss_irls_solve_batch_f32)
        fn(self._h, Yc.ctypes.data_as(self._p), batch, float(tol),
           int(max_iterations), int(nthreads), X.ctypes.data_as(self._p),
           iters.ctypes.data_as(_I32P), errs.ctypes.data_as(self._p),
           spd.ctypes.data_as(_I32P))
        return X, iters, errs, spd.astype(bool)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            destroy = (self._lib.ss_irls_destroy_f64 if self._f64
                       else self._lib.ss_irls_destroy_f32)
            destroy(h)
            self._h = None
