"""Public solver API — the port of ``sparse_solvers_tpu/api.py``'s
``Homotopy``, ``Omp``, ``Irls``, ``IrlsCg`` and ``Cosamp`` façades.

Ported: the five façades whole: for ``Homotopy`` and ``Omp`` every
``solve*`` route, both modes, float32 and float64, with a Gram, without
one and gram-free in the batch drivers, and ``picks`` for gOMP, and
``update_column``; for ``Irls`` the fast (triangular-solve or R⁻¹-gemm
Newton), exact and stabilized loops over a QR computed once; for
``IrlsCg`` the factorization-free loop and ``update_column``; for
``Cosamp`` the support-replacing rounds; the C++ host engine of ``csrc/``
(``engine="native"``, and ``"auto"`` on a CPU façade's problems of at
most 2¹⁶ elements) for ``solve`` and ``solve_batch`` of the first four;
and ``mesh=`` in all five, the construct-once form of the sharded routes
of ``parallel/sharding.py`` (api.py:142-252 of the JAX package). Also the
module functions ``densify_batch``, ``densify_path``, ``lasso_at``,
``lasso_at_batch``, ``reconstruct_signal`` and ``norm_l1``. The port adds
no feature the JAX package lacks.

PyTorch semantics against the JAX façade:
  * every façade takes ``device="cuda"`` and places A, and lazily AᵀA or
    Irls's QR, on that device; the default is "cuda", so a missing GPU is
    an error, never a silent CPU run. On a CPU device every kernel runs
    its plain twin.
  * ``engine="native"`` runs ``solve`` and ``solve_batch`` on the C++
    host engine (``backend/native.py``) and returns the result as tensors
    on the solver's device. ``engine="auto"`` does the same for a problem
    with m·n ≤ 2¹⁶ where the library builds, as the JAX package does,
    but only on a CPU façade: a façade on the card keeps its work on the
    card. Every other call runs the torch routes: the slot-space driver
    or the per-lane core. ``engine="jax"`` names the torch routes, as the
    JAX package's name for its device engine, and never takes the host
    engine.
  * PyTorch runs eagerly: ``_fn`` returns a plain function, nothing is
    compiled or cached per shape, and solutions are tensors on the device.
    The regularization-path helpers work on the host, in numpy, as the
    JAX package's do.
  * ``mesh=`` (a ``parallel.sharding.Mesh`` from ``make_mesh``) is SPMD:
    every rank of the process group constructs the same façade from the
    same A and calls it with the same signals. The whole A stays on the
    host; each rank places its shard on the mesh's device once, at first
    use (with the replicated Gram, or the mesh's QR), pads the batch to
    the data axis and gets the whole answer back on that device.
"""

from __future__ import annotations

import functools
import os
import warnings

import numpy as np
import torch

from . import certify as _certify
from . import convert as _convert
from .backend import native as _native
from .linalg import active_set as _active_set
from .linalg import norms as _norms
from .ops import blas as _blas
from .ops import dispatch as _dispatch
from .ops.operators import DenseOperator
from .reports import HomotopyReport, IrlsReport, OmpReport
from .solvers import cosamp as _cosamp
from .solvers import homotopy as _homotopy
from .solvers import homotopy_batch as _homotopy_batch
from .solvers import irls as _irls
from .solvers import irls_cg as _irls_cg
from .solvers import loops as _loops
from .solvers import omp as _omp
from .solvers import omp_batch as _omp_batch
from .utils import ndview
from .utils import profiling as _profiling

# Gram matrices above this byte size are not precomputed automatically
# (n² entries of the dtype's size; 1 GiB ⇒ n ≈ 16384 in float32) —
# api.py:47.
_GRAM_AUTO_BYTES = 1 << 30

_PRECISION_VALUES = ("highest", "high", "default", "certified")

# Below this m·n the JAX package's "auto" routes to the host engine
# (api.py:305-307); the port's "auto" does so only on a CPU façade, as
# no crossover against the card has set a threshold there.
_NATIVE_AUTO_ELEMS = 1 << 16


def _default_tolerance(dtype) -> float:
    # reference binding default: 10 × machine epsilon (binding.cpp:108-110)
    return float(torch.finfo(dtype).eps) * 10


def _warn_small_problem_jax(engine: str, m: int, n: int,
                            device: torch.device) -> None:
    """On a CPU façade, forcing engine="jax" at a size where "auto" would
    take the host engine (api.py:83-94); a card façade's "auto" takes the
    torch route too, so there is nothing to warn of."""
    if (engine == "jax" and device.type == "cpu"
            and m * n <= _NATIVE_AUTO_ELEMS):
        warnings.warn(
            f"engine='jax' on a {m}x{n} problem: device dispatch latency "
            "will dominate the solve; engine='auto' (default) uses the "
            "native host backend for problems this small",
            RuntimeWarning, stacklevel=3)


def _route_native(engine: str, m: int, n: int, probe: bool,
                  device: torch.device) -> bool:
    """The façades' engine routing (api.py:107-124): an explicit
    ``engine="native"`` takes the host engine; ``"auto"`` does so for
    m·n ≤ 2¹⁶ where the library is available, and only on a CPU façade:
    a façade on the card keeps its work on the card unless the caller
    names the host engine. ``probe=True`` answers without side effects
    (no build, no error on a missing library) — ``explain()``'s contract.
    Where "auto" cannot take the route it answers before the library is
    looked at, so such a façade never builds it."""
    if engine != "native" and (device.type != "cpu"
                               or m * n > _NATIVE_AUTO_ELEMS):
        return False
    if not _native.available(build=not probe):
        if engine == "native":
            if probe:
                return True  # a solve would attempt (and report) it
            raise RuntimeError(
                "native engine requested but the host backend is "
                "unavailable (build failed or SS_NATIVE_DISABLE=1)")
        return False
    return True


def _check_mesh(mesh, engine: str) -> None:
    """Validate the façades' ``mesh=`` argument (api.py:142-161): a
    ``parallel.sharding.Mesh``, as ``make_mesh`` builds one; mesh-sharded
    solving runs the torch routes, never the host engine."""
    from .parallel import sharding as _sh
    if not isinstance(mesh, _sh.Mesh):
        raise ValueError(
            "mesh must be a sparse_solvers_tpu_torch.parallel.sharding.Mesh "
            f"(make_mesh), got {type(mesh).__name__}")
    if engine == "native":
        raise ValueError(
            "mesh-sharded solving runs on the jax engine; drop "
            "engine='native' or the mesh")


def _mesh_prep_batch(mesh, Y: torch.Tensor, m_pad: int):
    """This rank's lanes and rows of a (batch, m) signal block, the batch
    padded with zero signals to the data-axis multiple and the rows to the
    placed A's padded m (api.py:173-189; the zero lanes are trimmed from
    the result). Returns (Y_local, batch_pad)."""
    from .parallel import sharding as _sh
    bpad = (-Y.shape[0]) % mesh.shape[_sh.DATA_AXIS]
    if bpad:
        Y = torch.nn.functional.pad(Y, (0, 0, 0, bpad))
    return _sh.shard_signals(mesh, Y, m_pad, Y.dtype), bpad


def _trim_batch(out, rep, bpad: int, dense: bool):
    """Drop the data-axis padding lanes from a sharded batch result."""
    if not bpad:
        return out, rep
    cut = lambda a: a[:-bpad]
    out = cut(out) if dense else (cut(out[0]), cut(out[1]))
    return out, type(rep)(*(cut(f) for f in rep))


def _certified_error(A: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Certificate: ‖Aᵀ(y − Ax)‖∞ at "high" precision (fp32, TF32 off) —
    the solver's own convergence criterion (homotopy-cpu.cpp:270),
    recomputed from the returned solution, per lane of x (b, n) against
    y (b, m). Looked up at call time, so tests can replace it to force
    certificate failures."""
    with _blas.precision_scope("high"):
        r = y - _blas.xgemm(x, A, trans_b=True)
        c = _blas.xgemm(r, A)
    return c.abs().amax(dim=-1)


def _certified_l2_error(A: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """ℓ₂ residual certificate ‖y − Ax‖₂ at "high" precision (fp32, TF32
    off) — the greedy family's convergence criterion, recomputed from the
    returned solution, per lane of x (b, n) against y (b, m): the JAX
    façade's wrapper of the per-lane OMP core (api.py:1733-1736). The
    driver route reports the driver's own certificate
    (``omp_batch.l2_certificate``) and never calls this. Looked up at call
    time, so tests can replace it to force certificate failures."""
    with _blas.precision_scope("high"):
        return _omp_batch.l2_certificate(A, x, y)


def _f32_key(tolerance, dtype) -> float:
    """The tolerance as the loops compare with it, in A's dtype: two
    tolerances that round alike give the same trips."""
    return float(torch.tensor(float(tolerance), dtype=dtype))


def _first_lane(out):
    """A one-lane result without its lane axis (nested tuples kept)."""
    if isinstance(out, tuple):
        parts = [_first_lane(o) for o in out]
        return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
    return out[0]


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card is
    an error, never a silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch sees no CUDA device; pass "
            "device='cpu' to run the plain PyTorch twins")
    return dev


def _numpy(a) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class _Solver:
    """What every façade shares: A on the solver's device, or on the host
    beside a mesh."""

    def _load(self, A, device, mesh=None) -> None:
        """Place A on ``device``; a CUDA device without a card is an
        error, never a silent CPU run. With a ``mesh`` the solver's device
        is the mesh's and A stays on the host: each rank places its shard
        at first use."""
        self._mesh = mesh
        if mesh is not None:
            self._device = mesh.device
            self._A = ndview.as_matrix(A, device="cpu")
        else:
            self._device = _resolve_device(device)
            self._A = ndview.as_matrix(A, device=self._device)
        self._m, self._n = self._A.shape
        self._A_host = None

    def _host_A(self) -> np.ndarray:
        """A as a host numpy array for the host engine, copied once."""
        if self._A_host is None:
            self._A_host = _numpy(self._A)
        return self._A_host

    def _from_host(self, *arrays):
        """The host engine's numpy results as tensors on the solver's
        device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self._device) for a in arrays)

    def _native_plan(self, mode: str) -> dict:
        """explain()'s plan of a solve that the host engine carries."""
        return {"engine": "native", "mode": mode,
                "backend": "csrc host (C++)", "device": str(self._device)}

    def _replace_column(self, j: int, col) -> None:
        """Replace column j of A on the solver's device with ``col``. A is
        replaced by an updated copy, not written in place: it may be the
        caller's own tensor."""
        if not (0 <= j < self._n):
            raise ValueError(
                f"column index {j} out of range [0, {self._n})")
        v = ndview.as_vector(col, dtype=self.dtype, size=self._m,
                             device=self._A.device)
        A = self._A.clone()
        A[:, j] = v
        self._A = A
        self._A_host = None

    @property
    def shape(self):
        return (self._m, self._n)

    @property
    def dtype(self):
        return self._A.dtype

    def _tol(self, tolerance) -> float:
        return (_default_tolerance(self.dtype)
                if tolerance is None else float(tolerance))

    def _row_shard(self) -> torch.Tensor:
        """This rank's rows of A on the mesh's device."""
        from .parallel import sharding as _sh
        return _sh.shard_rows(self._mesh, self._A)

    def _m_padded(self) -> int:
        """A's row count padded to the mesh's row-axis multiple."""
        from .parallel import sharding as _sh
        S = self._mesh.shape[_sh.ROW_AXIS]
        return self._m + (-self._m) % S

    def _mesh_batch(self, Y: torch.Tensor, run, dense: bool = True):
        """``run(Y_local)`` → (X, report) or (values, indices, report) on
        this rank's lanes and rows of Y, the batch padded to the data axis
        and the padding trimmed; returns what a ``solve_batch`` returns."""
        Yl, bpad = _mesh_prep_batch(self._mesh, Y, self._m_padded())
        out = run(Yl)
        X, rep = _trim_batch(out[0] if dense else out[:2], out[-1], bpad,
                             dense)
        return (X, rep) if dense else (*X, rep)


class _GramSolver(_Solver):
    """What the Homotopy and OMP façades share besides A: its lazy Gram
    (the JAX package's ``_lazy_gram``) and the gram-free drivers'
    transposed copies, the graph-route loops kept from the newest solve's
    key (``loops.Kept``), and the entry points ``solve``, ``solve_batch``
    and their ``_on_device`` forms with the certified re-solve
    (``certify.py``)."""

    # each façade's own: its report classes, and ``_resolved_k_max``,
    # ``_native_fn``, ``_fn`` and ``_solve_batch_mesh``
    _report = _report_arrays = None

    def _load(self, A, device, mesh=None) -> None:
        super()._load(A, device, mesh)
        self._G_cache = None
        self._AT_cache: dict[bool, torch.Tensor] = {}
        # the trip graphs and state buffers of the newest solve's loops,
        # read again by a later solve of the same key
        self._kept = _loops.Kept()
        # the mesh route's shard of A, replicated Gram and transposed
        # copies of the shard, placed at first use
        self._A_mesh = self._G_mesh = None
        self._AT_mesh: dict[bool, torch.Tensor] = {}

    def _gram_auto(self, gram: bool | None) -> bool:
        """``gram=None`` is on while n² values of A's dtype fit in 1 GiB
        (api.py:352-355)."""
        if gram is None:
            return (self._n * self._n * self._A.element_size()
                    <= _GRAM_AUTO_BYTES)
        return bool(gram)

    @classmethod
    def from_numpy(cls, A, G=None, **kwargs):
        """Build a solver whose Gram is the given (n, n) array instead of
        one computed here — tests feed the JAX-computed Gram so that both
        packages step from identical state. The torch routes use it; the
        host engine (``engine="auto"`` at m·n ≤ 2¹⁶) forms its own."""
        solver = cls(A, **kwargs)
        if G is not None:
            solver._G_cache = ndview.as_matrix(G, dtype=solver.dtype,
                                               device=solver._device)
        return solver

    @property
    def _G(self) -> torch.Tensor | None:
        """AᵀA, computed on first use at full precision (TF32 off) — the
        JAX package's ``_lazy_gram`` at HIGHEST; None when the solver runs
        without a Gram."""
        if self._gram_enabled and self._G_cache is None:
            with _blas.precision_scope("highest"):
                self._G_cache = _blas.xgemm(self._A, self._A, trans_a=True)
        return self._G_cache

    def _transposed(self) -> torch.Tensor:
        """The gram-free drivers' transposed copy of A for the scope's
        precision (``homotopy_batch.transposed_copy``), made once per
        solver and precision: bf16 on the one-pass path, A's dtype for a
        re-solve at "high"."""
        key = _blas.current_precision() == "default"
        if key not in self._AT_cache:
            self._AT_cache[key] = _homotopy_batch.transposed_copy(self._A)
        return self._AT_cache[key]

    def _lane_operator(self, A, G, lanes: int) -> DenseOperator:
        """The per-lane cores' operator. In the "default" scope a float32
        A carries the façade's bf16 transposed copy (``_transposed``), so
        that no product rounds A again; the count ``api.bf16_copy_lanes``
        says which lanes' operators carry it."""
        AT = (self._transposed() if _blas.current_precision() == "default"
              and A.dtype == torch.float32 else None)
        _profiling.count("api.bf16_copy_lanes", lanes if AT is not None
                         else 0)
        return DenseOperator(A, G, AT)

    def update_column(self, j: int, col) -> None:
        """Replace column j of the sensing matrix on the solver's device
        (gallery churn) and rewrite the cached Gram's row and column from
        one Aᵀ·col product instead of the O(mn²) rebuild (api.py:215-252);
        the transposed copies and the kept loops, which read the old
        operands, are dropped. No reference analog: its solver holds a
        const view of A (policies.h:42)."""
        self._kept.drop()
        self._replace_column(j, col)
        self._AT_cache.clear()
        self._AT_mesh.clear()
        if self._A_mesh is not None:
            # shard-local column and the replicated Gram's row and column
            # from one all-reduced Aᵀv (sharding.update_column_sharded);
            # before the first placement the lazy one reads the new A
            from .parallel import sharding as _sh
            self._G_mesh = _sh._update_column_local(
                self._mesh, self._A_mesh, self._G_mesh,
                _sh.shard_rows(self._mesh, self._A[:, j], self._m_padded()),
                j)
        if self._G_cache is not None:
            # the new Gram row/col g = Aᵀ_new v, at the precision the lazy
            # Gram was built at (the updated column lands vᵀv on the
            # diagonal)
            with _blas.precision_scope("highest"):
                g = _blas.xgemv(self._A, self._A[:, j], trans=True)
            G = self._G_cache.clone()
            G[:, j] = g
            G[j, :] = g
            self._G_cache = G

    def _mesh_arrays(self):
        """The mesh route's construct-once state: this rank's rows of A
        and, with the Gram on, the replicated AᵀA all-reduced once at
        "highest" (api.py:388-401)."""
        if self._A_mesh is None:
            from .parallel import sharding as _sh
            self._A_mesh = self._row_shard()
            if self._gram_enabled:
                self._G_mesh = _sh._gram_local(self._mesh, self._A_mesh)
        return self._A_mesh, self._G_mesh

    def _mesh_plan(self, batch: int | None, k_max: int, sparse_rule):
        """The mesh plan's shared keys (api.py:465-493): the per-rank lane
        count, the padded m the sharded route tests its crossovers
        against, whether it takes the driver (``sparse_rule(local_b, m)``
        gives the sparse regime) and the q reduction's form."""
        from .parallel import sharding as _sh
        S = self._mesh.shape[_sh.ROW_AXIS]
        local_b = -(-(batch or 1) // self._mesh.shape[_sh.DATA_AXIS])
        bn = _homotopy_batch.route_batch_native(
            local_b, self._n, self._A.dtype,
            sparse_rule(local_b, self._m_padded()))
        ring = bn and S > 1 and self._n >= 128 * S
        # K1 carries q on the driver's one-pass path unless the reduction
        # is split (the ring, or overlap_blocks' auto 4 at n ≥ 512)
        fused_q = (bn and self._precision in ("certified", "default")
                   and not ring and not (S > 1 and self._n >= 512))
        return {"engine": "torch", "device": str(self._device),
                "mode": self._mode, "precision": self._precision,
                "mesh": dict(self._mesh.shape), "sharded": True,
                "gram": self._gram_enabled,
                "gram_cached": self._G_mesh is not None, "k_max": k_max,
                "batch_native": bn, "fused_q": fused_q,
                "overlap_mode": "ppermute" if ring else "psum"}

    def _mesh_single(self, y: torch.Tensor, tol, max_iterations: int):
        """A single solve through the mesh route: one lane of the batch
        route, as (x, report of 0-d tensors)."""
        X, rep = self._solve_batch_mesh(y[None], tol, max_iterations)
        return X[0], type(rep)(*(f[0] for f in rep))

    def _use_native(self, probe: bool = False) -> bool:
        """Whether ``solve``/``solve_batch`` run on the host engine; exact
        mode and a mesh never do (api.py:597-603, :1565-1570)."""
        if (self._engine == "jax" or self._mode == "exact"
                or self._mesh is not None):
            return False
        return _route_native(self._engine, self._m, self._n, probe,
                             self._device)

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 100):
        """Solve for one signal b (m,): Homotopy's min‖x‖₁ s.t. Ax = b, or
        OMP's greedy y ≈ Ax in at most max_iterations support picks.
        Returns (x, report) with x an (n,) tensor on the solver's device
        and a ``HomotopyReport`` or an ``OmpReport``. Under "certified", a
        solution whose certificate misses the tolerance (Homotopy's
        ‖Aᵀ(y−Ax)‖∞, OMP's ‖y−Ax‖₂, each at "high") is re-solved at
        "high" (api.py:605-641, :1771-1803)."""
        with _profiling.span("api.solve", precision=self._precision):
            _profiling.count("api.lanes")
            return self._solve(b, tolerance, max_iterations)

    def _solve(self, b, tolerance, max_iterations: int):
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m,
                             device=self._device)
        tol = self._tol(tolerance)
        _certify.check_max_iterations(max_iterations)
        if self._mesh is not None:
            x, rep = self._mesh_single(y, tol, max_iterations)
            it = _certify.read(rep.iter, int)
            err = _certify.read(rep.solution_error, float)
        elif self._use_native():
            xn, it, err = self._native_fn(batch=False)(
                self._host_A(), _numpy(y), tol, max_iterations,
                self._resolved_k_max(max_iterations))
            x = self._from_host(xn)[0]
        else:
            x, it, err = _certify.certified_one(
                lambda precision=None: self._fn(
                    max_iterations, batch=None, precision=precision)(
                        self._A, self._G, y, tol),
                self._precision == "certified", tol, max_iterations)
        return x, self._report(iter=it, solution_error=err)

    def solve_on_device(self, y: torch.Tensor, tolerance,
                        max_iterations: int = 100):
        """Solve for an (m,) tensor already on the solver's device, without
        the certified re-solve: under "certified" the report's
        solution_error is the certificate, to be checked against the
        tolerance downstream. Returns (x, report arrays of 0-d tensors:
        ``HomotopyReportArrays`` or ``OmpReportArrays``). With a mesh the
        solve takes the sharded route, whose certified re-solve runs
        inside it (as in the JAX package)."""
        if self._mesh is not None:
            return self._mesh_single(y, tolerance, max_iterations)
        return self._fn(max_iterations, batch=None)(self._A, self._G, y,
                                                    tolerance)

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 100, dense: bool = True):
        """Batched solve over signals B of shape (batch, m).

        Returns (X (batch, n), report arrays of per-lane tensors:
        ``HomotopyReportArrays`` or ``OmpReportArrays``), on the solver's
        device. ``dense=False`` returns ``(values, indices, report)``, the
        compact slot-space solution (see
        ``sparse_solvers_tpu.Homotopy.solve_batch``); ``densify_batch``
        rebuilds X exactly. Under "certified", lanes whose certificate
        misses the tolerance (as in ``solve``) are re-solved at "high" and
        merged (api.py:754-784, :1838-1861)."""
        with _profiling.span("api.solve_batch", precision=self._precision):
            return self._solve_batch(B, tolerance, max_iterations, dense)

    def _solve_batch(self, B, tolerance, max_iterations: int, dense: bool):
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m,
                                   device=self._device)
        _profiling.count("api.lanes", Y.shape[0])
        tol = self._tol(tolerance)
        _certify.check_max_iterations(max_iterations)
        if self._mesh is not None:
            return self._solve_batch_mesh(Y, tol, max_iterations, dense)
        if self._use_native():
            k_max = self._resolved_k_max(max_iterations)
            X, iters, errs = self._from_host(*self._native_fn(batch=True)(
                self._host_A(), _numpy(Y), tol, max_iterations, k_max))
            rep = self._report_arrays(iter=iters, solution_error=errs)
            if not dense:
                return (*_active_set.compact_from_dense(X, k_max), rep)
            return X, rep
        return _certify.certified_batch(
            lambda precision=None: self._fn(
                max_iterations, batch=Y.shape[0], precision=precision,
                dense=dense)(self._A, self._G, Y, tol),
            self._precision == "certified", tol, max_iterations, dense)

    def solve_batch_on_device(self, Y: torch.Tensor, tolerance,
                              max_iterations: int = 100,
                              dense: bool = True):
        """Batched solve over a (batch, m) tensor already on the solver's
        device, without host-side conversion or the certified re-solve:
        under "certified" each lane's solution_error is the certificate,
        to be checked against the tolerance downstream. Returns (X,
        report), or ((values, indices), report) when ``dense=False``. With
        a mesh the solve takes the sharded route, whose certified re-solve
        runs inside it (as in the JAX package)."""
        if self._mesh is not None:
            out = self._solve_batch_mesh(Y, tolerance, max_iterations, dense)
            return out if dense else (out[:2], out[2])
        return self._fn(max_iterations, batch=Y.shape[0], dense=dense)(
            self._A, self._G, Y, tolerance)


class Homotopy(_GramSolver):
    """Homotopy path-following solver over a fixed sensing matrix A (m×n).

    Parameters follow ``sparse_solvers_tpu.Homotopy``; ``device`` (default
    "cuda") is where A, the Gram and every solve live. Batches outside the
    sparse-matvec regime take the slot-space driver (float32, fast mode,
    gram-free without a Gram); single solves, the sparse-matvec regime,
    float64 and ``mode="exact"`` take the per-lane core. ``engine``:
    "native" runs ``solve`` and ``solve_batch`` on the C++ host engine
    (fast mode only), "auto" does so where m·n ≤ 2¹⁶, and "jax" never;
    the other entries always take the torch routes. ``mesh`` (a
    ``parallel.sharding.Mesh``) routes ``solve*`` through
    ``homotopy_sharded`` on the mesh's device: each rank's rows of A placed
    once, the replicated Gram all-reduced once, the batch padded to the
    data axis and trimmed; fast mode only, and ``solve_path*`` stay
    single-device.
    """

    _report = HomotopyReport
    _report_arrays = _homotopy.HomotopyReportArrays

    def __init__(self, A, k_max: int | None = None, mode: str = "fast",
                 gram: bool | None = None, precision: str | None = None,
                 engine: str = "auto", mesh=None, device="cuda"):
        if mode not in ("fast", "exact"):
            raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
        if engine not in ("auto", "jax", "native"):
            raise ValueError(
                f"engine must be 'auto', 'jax' or 'native', got {engine!r}")
        if engine == "native" and mode == "exact":
            raise ValueError(
                "engine='native' implements the fast-path algorithm; "
                "mode='exact' requires the jax engine")
        if precision is not None and precision not in _PRECISION_VALUES:
            raise ValueError(
                f"precision must be one of {_PRECISION_VALUES}, "
                f"got {precision!r}")
        if precision == "certified" and mode == "exact":
            raise ValueError(
                "precision='certified' runs the path at one-pass "
                "precision; mode='exact' (operation-for-operation "
                "reference parity) requires 'high' or 'highest'")
        if mesh is not None:
            if mode == "exact":
                raise ValueError(
                    "mesh-sharded solving runs the fast-path "
                    "formulation; mode='exact' is single-device")
            _check_mesh(mesh, engine)
        self._engine = engine
        self._load(A, device, mesh)
        if mesh is None:
            _warn_small_problem_jax(engine, self._m, self._n, self._device)
        self._k_max = k_max
        self._mode = mode
        self._precision = precision or ("certified" if mode == "fast"
                                        else "highest")
        # exact mode never reads the Gram (api.py:355)
        self._gram_enabled = self._gram_auto(gram) and mode == "fast"

    def _plan(self, max_iterations: int, batch: int | None):
        """(k_max, sparse_matvec, batch_native) for a solve of this shape,
        shared by ``_fn`` and ``explain`` (api.py:420-449)."""
        k_max = self._resolved_k_max(max_iterations)
        sparse = (self._mode == "fast"
                  and (batch or 1) * k_max < 2 * self._m
                  and k_max < self._n)
        batch_native = (self._mode == "fast"
                        and _homotopy_batch.route_batch_native(
                            batch, self._n, self._A.dtype, sparse))
        return k_max, sparse, batch_native

    def _resolved_k_max(self, max_iterations: int) -> int:
        """The slot capacity of a solve: ``k_max``, else one past the
        iteration budget, at most n."""
        return self._k_max or min(self._n, max_iterations + 1)

    def _native_fn(self, batch: bool):
        """The host engine's solve, of a batch or of one signal."""
        return (_native.homotopy_solve_batch if batch
                else _native.homotopy_solve)

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan for a solve of this configuration: which engine
        and formulation run and which form of each kernel. No side
        effects (no build of the host library)."""
        if self._use_native(probe=True):
            return self._native_plan(self._mode)
        if self._mesh is not None:
            return self._explain_mesh(batch, max_iterations)
        k_max, sparse, batch_native = self._plan(max_iterations, batch)
        if batch_native:
            formulation = ("slot-space batch driver (scan + transition "
                           "kernels)")
        elif batch is not None:
            formulation = "batched while-loop core (vmapped core's lanes)"
        else:
            formulation = "while-loop core"
        plan = {
            "engine": "torch",
            "device": str(self._device),
            "mode": self._mode,
            "precision": self._precision,
            "gram": self._gram_enabled,
            "k_max": k_max,
            "sparse_matvec": sparse,
            "batch_native": batch_native,
            "formulation": formulation,
            # the core runs plain products and gathers, as the JAX core
            # runs no Pallas kernel
            "kernels": {},
        }
        path_precision = self._precision
        if self._precision == "certified":
            path_precision = plan["path_precision"] = "default"
            plan["certificate"] = ("‖Aᵀ(y−Ax)‖∞ at high precision; "
                                   "solve/solve_batch re-solve lanes that "
                                   "miss the tolerance")
        if batch_native:
            plan["capacity_tiers"] = _homotopy_batch._plan_tiers(
                k_max, max_iterations, None)
            if not self._gram_enabled:
                plan["gram_free"] = True  # the insert's column on the fly
            plan["fused_q"] = path_precision == "default"
            plan["kernels"] = _dispatch.explain(self._device, (
                ("normal_matvec_fused_bf16",) * plan["fused_q"]
                + ("find_max_gamma_fused", "transition")))
        return plan

    def _explain_mesh(self, batch: int | None, max_iterations: int) -> dict:
        """The mesh route's plan (api.py:465-493)."""
        k_max = self._resolved_k_max(max_iterations)
        plan = self._mesh_plan(batch, k_max, lambda b, m: (
            self._gram_enabled and b * k_max < 2 * m and k_max < self._n))
        bn = plan["batch_native"]
        plan["formulation"] = ("row+data sharded solve (parallel/sharding."
                               "homotopy_sharded, " + (
                                   "slot-space driver)" if bn
                                   else "per-lane core)"))
        if self._precision == "certified":
            plan["path_precision"] = "default"
            plan["certificate"] = ("all-reduced ‖Aᵀ(y−Ax)‖∞ at high "
                                   "precision; failing lanes re-solve")
        plan["kernels"] = _dispatch.explain(self._device, (
            ("normal_matvec_fused_bf16",) * plan["fused_q"]
            + ("find_max_gamma_fused", "transition"))) if bn else {}
        return plan

    def _solve_batch_mesh(self, Y: torch.Tensor, tol, max_iterations: int,
                          dense: bool = True):
        """``solve_batch`` through ``homotopy_sharded`` (api.py:403-418),
        the certified re-solve included."""
        from .parallel import sharding as _sh
        A, G = self._mesh_arrays()
        return self._mesh_batch(Y, lambda Yl: _sh._homotopy_placed(
            self._mesh, A, Yl, tol, max_iterations, m=self._m_padded(),
            k_max=self._resolved_k_max(max_iterations),
            gram=self._gram_enabled if G is None else None,
            G=G, precision=self._precision, dense=dense,
            at_cache=self._AT_mesh), dense)

    def _fn(self, max_iterations: int, batch: int | None,
            precision: str | None = None, record_path: bool = False,
            dense: bool = True):
        """The solve function for this shape: ``run(A, G, y, tol)`` →
        (x, report), or ((values, indices), report) when ``dense=False``,
        or (x, report, histories) with ``record_path``. ``y`` is (m,) for
        ``batch=None`` and (batch, m) otherwise. ``precision`` overrides
        the instance setting (the certified re-solve uses it). A solve at
        the instance's precision keeps its loops' graphs for the next solve
        of the same key; the re-solve and the recorded paths keep
        nothing."""
        _certify.check_max_iterations(max_iterations)
        keeping = precision is None and not record_path
        precision = precision or self._precision
        certified = precision == "certified"
        if record_path and certified:
            raise ValueError(
                "record_path needs a concrete precision "
                "(solve_path resolves certified to 'high')")
        # certified: the path runs at one-pass precision, the certificate
        # below restores trust in the result
        path_precision = "default" if certified else precision
        k_max, sparse, batch_native = self._plan(max_iterations, batch)

        def path(A, G, Y, tol):
            with _blas.precision_scope(path_precision):
                if batch_native:
                    # without a Gram the driver runs gram-free
                    AT = self._transposed() if G is None else None
                else:
                    # a recorded path, whose iterates are the product,
                    # keeps reading A
                    op = (DenseOperator(A, G) if record_path
                          else self._lane_operator(A, G, Y.shape[0]))
                    AT = op.AT
                keep = self._kept.entry((
                    batch_native, Y.shape[0], max_iterations, k_max,
                    _f32_key(tol, A.dtype), path_precision, self._mode,
                    sparse, id(A), id(G), id(AT))) if keeping else None
                if batch_native:
                    return _homotopy_batch.solve_homotopy_batch(
                        A, G, Y, tol, max_iterations, k_max, dense=dense,
                        record_path=record_path, AT=AT, keep=keep)
                return _homotopy.solve_homotopy_core(
                    op, self._n, Y, tol, max_iterations, k_max,
                    mode=self._mode, sparse_matvec=sparse,
                    record_path=record_path, compact=not dense, keep=keep)

        def run(A, G, y, tol):
            Y = y if batch is not None else y[None]
            with _profiling.span("api.path"):
                out = path(A, G, Y, tol)
            if certified:
                with _profiling.span("api.certify"):
                    X, rep = out
                    x = (X if dense else _homotopy_batch.densify_batch(
                        X[0], X[1], self._n))
                    err = _certified_error(A, x, Y)
                    out = X, rep._replace(solution_error=err.to(
                        rep.solution_error.dtype))
            if batch is None:  # one lane: drop the lane axis
                out = _first_lane(out)
            return out

        return run

    def _no_mesh_path(self, what: str) -> None:
        if self._mesh is not None:
            raise ValueError(
                f"{what} is single-device (the breakpoint history is not "
                "plumbed through the sharded drivers); construct without "
                "mesh= for path extraction")

    def solve_path(self, b, tolerance: float | None = None,
                   max_iterations: int = 100):
        """The LARS/LASSO regularization path (api.py:643-682): every
        breakpoint of min ½‖y−Ax‖² + λ‖x‖₁ the loop visits as λ decreases
        from ‖Aᵀy‖∞ to the tolerance. Returns ``(lambdas, Xs,
        HomotopyReport)`` as numpy arrays, λ_t the loop's own
        ‖Aᵀ(y−Ax_t)‖∞ at each committed breakpoint (a break iteration's
        duplicate row trimmed). ``precision="certified"`` records at
        "high": the per-breakpoint iterates are the product here."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m,
                             device=self._device)
        tol = self._tol(tolerance)
        _certify.check_max_iterations(max_iterations)
        self._no_mesh_path("solve_path")
        precision = ("high" if self._precision == "certified"
                     else self._precision)
        _, rep, (hv, hi, hl) = self._fn(
            max_iterations, batch=None, precision=precision,
            record_path=True)(self._A, self._G, y, tol)
        it = int(rep.iter)
        lam, Xs = densify_path(hl, hv, hi, it, self._n)
        return lam, Xs, HomotopyReport(iter=it,
                                       solution_error=float(
                                           rep.solution_error))

    def solve_path_batch(self, B, tolerance: float | None = None,
                         max_iterations: int = 100):
        """Batched regularization paths (see ``solve_path``) over signals
        B of shape (batch, m) (api.py:684-716). Returns ``(lambdas,
        values, indices, reports)`` as numpy arrays in the compact
        slot-space form: lane ``l``'s breakpoint ``t`` holds values
        ``values[l, t, j]`` at columns ``indices[l, t, j]`` (sentinel n),
        ``lambdas[l, t]`` its λ; rows past ``reports.iter[l]`` are
        padding. ``densify_path`` rebuilds one lane's dense path."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m,
                                   device=self._device)
        tol = self._tol(tolerance)
        _certify.check_max_iterations(max_iterations)
        self._no_mesh_path("solve_path_batch")
        precision = ("high" if self._precision == "certified"
                     else self._precision)
        _, rep, (hv, hi, hl) = self._fn(
            max_iterations, batch=Y.shape[0], precision=precision,
            record_path=True)(self._A, self._G, Y, tol)
        return (_numpy(hl), _numpy(hv), _numpy(hi),
                _homotopy.HomotopyReportArrays(
                    iter=_numpy(rep.iter),
                    solution_error=_numpy(rep.solution_error)))

class Omp(_GramSolver):
    """Orthogonal Matching Pursuit over a fixed sensing matrix A (m×n) —
    grow each lane's support by the column most correlated with its
    residual (``picks`` of them per round for gOMP), re-solve least
    squares on it, stop at ``‖y − Ax‖₂ ≤ tolerance`` or after
    ``max_iterations`` column picks.

    Parameters follow ``sparse_solvers_tpu.Omp``; ``device`` (default
    "cuda") is where A, the Gram and every solve live. float32 fast-mode
    batches outside the small-batch regime batch·k_max < 2m take the
    slot-space driver (gram-free without a Gram); single solves, that
    regime, float64, ``mode="exact"`` and ``gram=True`` take the per-lane
    core (``solvers/omp.py``). ``gram``: None holds AᵀA while n² values
    fit in 1 GiB, True also pins the Gram-gather correlation update, False
    holds none. ``precision`` "certified" (the fast-mode default) runs the
    pick loop at one-pass precision with a high-precision residual
    certificate per lane, and ``solve``/``solve_batch`` re-solve lanes that
    miss the tolerance at "high". ``engine`` routes as ``Homotopy``'s:
    "native" (fast mode only), and "auto" where m·n ≤ 2¹⁶, run ``solve``
    and ``solve_batch`` on the C++ host engine. ``mesh``: as
    ``Homotopy``'s, through ``omp_sharded``.
    """

    _report = OmpReport
    _report_arrays = _omp.OmpReportArrays

    def __init__(self, A, k_max: int | None = None, mode: str = "fast",
                 gram: bool | None = None, precision: str | None = None,
                 engine: str = "auto", mesh=None, picks: int = 1,
                 device="cuda"):
        if mode not in ("fast", "exact"):
            raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
        if engine not in ("auto", "jax", "native"):
            raise ValueError(
                f"engine must be 'auto', 'jax' or 'native', got {engine!r}")
        if engine == "native" and mode == "exact":
            raise ValueError(
                "engine='native' implements the fast-path algorithm; "
                "mode='exact' requires the jax engine")
        if not isinstance(picks, int) or picks < 1:
            raise ValueError(f"picks must be an int >= 1, got {picks!r}")
        if mesh is not None and mode == "exact":
            raise ValueError(
                "mesh-sharded solving runs the fast-path formulation; "
                "mode='exact' is single-device")
        if precision is not None and precision not in _PRECISION_VALUES:
            raise ValueError(
                "precision must be 'highest', 'high', 'default' or "
                f"'certified', got {precision!r}")
        if precision == "certified" and mode == "exact":
            raise ValueError(
                "precision='certified' runs the pick loop at one-pass "
                "precision with a high-precision residual certificate — "
                "exact mode wants the full-precision trajectory; use "
                "precision='highest'")
        if gram is True and mode == "exact":
            raise ValueError(
                "gram=True pins the precomputed-Gram formulation, but "
                "mode='exact' never reads the cached AᵀA — drop gram=True "
                "or use mode='fast'")
        if k_max is not None and k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        if mesh is not None:
            _check_mesh(mesh, engine)
        self._engine = engine
        self._load(A, device, mesh)
        if picks > self._n:
            raise ValueError(
                f"picks must be <= n = {self._n} (each round selects "
                f"picks inactive columns), got {picks}")
        if mesh is None:
            _warn_small_problem_jax(engine, self._m, self._n, self._device)
        self._k_max = k_max
        self._mode = mode
        self._precision = precision or ("certified" if mode == "fast"
                                        else "highest")
        # an explicit True pins the Gram-gather formulation (auto only
        # routes it); exact mode never reads the Gram (api.py:1530-1536)
        self._gram_forced = gram is True
        self._gram_enabled = self._gram_auto(gram) and mode == "fast"
        self._picks = picks

    def _resolved_k_max(self, max_iterations: int) -> int:
        if self._k_max is not None:
            return min(self._k_max, self._n, self._m)
        return max(1, min(max_iterations, self._m, self._n))

    def _native_fn(self, batch: bool):
        """The host engine's solve, of a batch or of one signal."""
        return functools.partial(
            _native.omp_solve_batch if batch else _native.omp_solve,
            picks=self._picks)

    def _route_corr(self, batch: int | None, max_iterations: int) -> str:
        """The per-lane core's correlation update (api.py:1674-1689): the
        Gram gathers while batch·k_max < 2m or where ``gram=True`` pins
        them, else one column gather and an Aᵀ pass per lane ("sparse")
        below that crossover and two full products past it ("dense")."""
        small = ((batch or 1) * self._resolved_k_max(max_iterations)
                 < 2 * self._m)
        if self._gram_enabled and (self._gram_forced or small):
            return "gram"
        return "sparse" if small else "dense"

    def _route_driver(self, batch: int | None,
                      max_iterations: int = 100) -> bool:
        """The slot-space driver serves float32 fast-mode batches outside
        the small-batch regime batch·k_max < 2m (api.py:1691-1709);
        ``gram=True`` pins the Gram-gather core instead."""
        if batch is None or self._mode != "fast" or self._gram_forced:
            return False
        small = batch * self._resolved_k_max(max_iterations) < 2 * self._m
        return _homotopy_batch.route_batch_native(
            batch, self._n, self._A.dtype, sparse=small)

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan for a solve of this configuration: which engine
        and formulation run and which form of each kernel. No side
        effects (no build of the host library)."""
        k_max = self._resolved_k_max(max_iterations)
        if self._use_native(probe=True):
            return dict(self._native_plan(self._mode), k_max=k_max)
        if self._mesh is not None:
            return self._explain_mesh(batch, k_max)
        driver = self._route_driver(batch, max_iterations)
        plan = {
            "engine": "torch",
            "device": str(self._device),
            "mode": self._mode,
            "precision": self._precision,
            "k_max": k_max,
        }
        if driver:
            plan.update(
                corr="driver", gram_free=not self._gram_enabled,
                formulation=("slot-space OMP batch driver (fused q + "
                             "in-place insert/LS" + (
                                 ")" if self._gram_enabled
                                 else ", gram-free)")))
        else:
            corr = self._route_corr(batch, max_iterations)
            plan.update(corr=corr, formulation=(
                "vmapped OMP loop" if batch is not None else "OMP loop")
                + f" (corr={corr})")
        if self._picks > 1:
            plan["picks"] = self._picks
        path_precision = self._precision
        if self._precision == "certified":
            path_precision = plan["path_precision"] = "default"
            plan["certificate"] = ("‖y−Ax‖₂ at high precision; solve/"
                                   "solve_batch re-solve lanes that miss "
                                   "the tolerance")
        if driver:
            plan["capacity_tiers"] = _homotopy_batch._plan_tiers(
                k_max, max_iterations, None)
            plan["fused_q"] = path_precision == "default"
            plan["kernels"] = _dispatch.explain(self._device, (
                ("normal_matvec_fused_bf16",) * plan["fused_q"]
                + ("omp_insert",)))
        else:
            # the core runs plain products and gathers, as the JAX core
            # runs no Pallas kernel
            plan["kernels"] = {}
        return plan

    def _explain_mesh(self, batch: int | None, k_max: int) -> dict:
        """The mesh route's plan (api.py:1618-1642)."""
        plan = self._mesh_plan(batch, k_max, lambda b, m: b * k_max < 2 * m)
        if self._gram_forced:
            # gram=True pins the Gram-gather per-lane core
            plan.update(batch_native=False, fused_q=False,
                        overlap_mode="psum")
        plan["formulation"] = ("row+data sharded OMP (parallel/sharding."
                               "omp_sharded, " + (
                                   "slot-space driver)"
                                   if plan["batch_native"]
                                   else "per-lane core)"))
        if self._picks > 1:
            plan["picks"] = self._picks
        if self._precision == "certified":
            plan["path_precision"] = "default"
            plan["certificate"] = ("all-reduced ‖y−Ax‖₂ at high precision; "
                                   "failing lanes re-solve")
        plan["kernels"] = _dispatch.explain(self._device, (
            ("normal_matvec_fused_bf16",) * plan["fused_q"]
            + ("omp_insert",))) if plan["batch_native"] else {}
        return plan

    def _mesh_gram_arg(self):
        """``omp_sharded``'s gram argument (api.py:1581-1587): an explicit
        True pins the Gram-gather formulation, an auto-enabled Gram passes
        None (the precomputed G turns it on without pinning), off is
        False."""
        if self._gram_forced:
            return True
        return None if self._gram_enabled else False

    def _solve_batch_mesh(self, Y: torch.Tensor, tol, max_iterations: int,
                          dense: bool = True):
        """``solve_batch`` through ``omp_sharded`` (api.py:1589-1604), the
        certified re-solve included."""
        from .parallel import sharding as _sh
        A, G = self._mesh_arrays()
        return self._mesh_batch(Y, lambda Yl: _sh._omp_placed(
            self._mesh, A, Yl, tol, max_iterations, m=self._m_padded(),
            k_max=self._resolved_k_max(max_iterations),
            gram=self._mesh_gram_arg(), G=G, precision=self._precision,
            dense=dense, picks=self._picks, at_cache=self._AT_mesh), dense)

    def _fn(self, max_iterations: int, batch: int | None,
            precision: str | None = None, dense: bool = True):
        """The solve function for this shape: ``run(A, G, Y, tol)`` →
        (X, report), or ((values, indices), report) when ``dense=False``;
        ``Y`` is (m,) for ``batch=None`` and (batch, m) otherwise. Under
        "certified" the report's error is the certificate: the driver's
        own, or ``_certified_l2_error`` of the core's solution.
        ``precision`` overrides the instance setting (the certified
        re-solve uses it). The driver's solve at the instance's precision
        keeps its loops' graphs for the next solve of the same key; the
        re-solve keeps nothing."""
        _certify.check_max_iterations(max_iterations)
        keeping = precision is None
        precision = precision or self._precision
        certified = precision == "certified"
        # certified: the pick loop runs at one-pass precision, the
        # high-precision certificate restores trust in the result
        path_precision = "default" if certified else precision
        k_max = self._resolved_k_max(max_iterations)
        driver = self._route_driver(batch, max_iterations)
        corr = None if driver else self._route_corr(batch, max_iterations)

        def run(A, G, y, tol):
            Y = y if batch is not None else y[None]
            with _profiling.span("api.path"), _blas.precision_scope(
                    path_precision):
                if driver:
                    # without a Gram the driver runs gram-free; its
                    # post-loop certificate is its own api.certify span
                    AT = None if G is not None else self._transposed()
                    keep = self._kept.entry((
                        Y.shape[0], max_iterations, k_max,
                        _f32_key(tol, A.dtype), path_precision, self._picks,
                        id(A), id(G), id(AT))) if keeping else None
                    return _omp_batch.solve_omp_batch(
                        A, G, Y, tol, max_iterations, k_max, dense=dense,
                        picks=self._picks, AT=AT, keep=keep)
                # G rides along for the per-pick inserts whenever it
                # exists; corr selects only the correlation update
                X, rep = _omp.solve_omp_core(
                    self._lane_operator(A, G, Y.shape[0]), self._n, Y, tol,
                    max_iterations, k_max, mode=self._mode, corr=corr,
                    picks=self._picks)
            if certified:
                with _profiling.span("api.certify"):
                    rep = rep._replace(solution_error=_certified_l2_error(
                        A, X, Y).to(rep.solution_error.dtype))
            if batch is None:
                return _first_lane((X, rep))
            if not dense:
                return _active_set.compact_from_dense(X, k_max), rep
            return X, rep

        return run

class Irls(_Solver):
    """IRLS solver over a fixed sensing matrix A (m×n, m ≥ n), the port of
    ``sparse_solvers_tpu.Irls`` on one device.

    The economy QR of A (``torch.linalg.qr``, TF32 off) is computed once,
    on first use, and reused across every solve (the reference computes it
    in the solver constructor, src/lib.cpp:51-57). ``mode`` "fast" takes
    the collapsed Newton step, "exact" the reference's gemm + Cholesky
    step; ``precision`` ("highest" default, "high", "default"; IRLS has no
    certified variant: its solution_error is the reweighting eps, not a
    residual) sets the products' precision, and triangular solves always
    run at full precision. ``stabilized=True`` normalizes each Newton
    iterate by its maximum (the JAX package's beyond-reference variant).
    With ``SS_IRLS_GEMM=1`` a batched fast solve applies the cached R⁻¹ by
    one product per iteration instead of a triangular solve. ``device``
    (default "cuda") is where A, Q, R and every solve live. ``engine``
    "native" runs ``solve`` and ``solve_batch`` on the C++ host engine
    over its own QR (not with ``stabilized``), "auto" does so where m·n ≤
    2¹⁶ and the loop is not stabilized, and "jax" never. ``mesh`` (a
    ``parallel.sharding.Mesh``) factors A once on the mesh itself
    (``qr_sharded``'s CholeskyQR2 on the row shards, no host QR) and routes
    ``solve*`` through ``irls_sharded`` on the mesh's device.
    """

    def __init__(self, A, engine: str = "auto", mode: str = "fast",
                 precision: str = "highest", stabilized: bool = False,
                 mesh=None, device="cuda"):
        if engine not in ("auto", "jax", "native"):
            raise ValueError(
                f"engine must be 'auto', 'jax' or 'native', got {engine!r}")
        if mode not in ("fast", "exact"):
            raise ValueError(f"mode must be 'fast' or 'exact', got {mode!r}")
        if precision not in ("highest", "high", "default"):
            raise ValueError(
                "precision must be 'highest', 'high' or 'default' "
                f"(IRLS has no certified variant), got {precision!r}")
        if stabilized and engine == "native":
            raise ValueError(
                "stabilized IRLS runs on the jax engine (the native host "
                "backend implements the reference recurrence)")
        if mesh is not None:
            _check_mesh(mesh, engine)
        self._engine = engine
        self._native = None
        self._load(A, device, mesh)
        if mesh is None:
            _warn_small_problem_jax(engine, self._m, self._n, self._device)
        if self._m < self._n:
            raise ValueError(
                "Irls requires m >= n (underdetermined systems not "
                f"supported); got {self._m}x{self._n}"
            )
        self._precision = precision
        self._mode = mode
        self._stabilized = bool(stabilized)
        self._QR_cache = None
        self._Rinv_cache = None
        self._QR_mesh = None  # (this rank's Q rows, R), lazy

    @classmethod
    def from_numpy(cls, A, Q=None, R=None, r_inv=None, **kwargs):
        """Build a solver whose factorization is the given Q (m, n), R
        (n, n) and, optionally, R⁻¹ instead of ones computed here — tests
        feed the JAX package's so that both packages step from identical
        factors (QR sign conventions differ between XLA and LAPACK or
        cuSOLVER; ``convert.irls_factor_from_numpy``). The torch route
        uses them; the host engine (``engine="auto"`` at m·n ≤ 2¹⁶)
        factors A itself."""
        if (Q is None) != (R is None):
            raise ValueError("Q and R are given together or not at all")
        solver = cls(A, **kwargs)
        if Q is not None:
            Q = np.asarray(Q, dtype=np.float64 if solver.dtype
                           == torch.float64 else np.float32)
            Qt, Rt, Rinv = _convert.irls_factor_from_numpy(
                Q, R, solver._device, r_inv)
            solver._QR_cache = (Qt, Rt)
            solver._Rinv_cache = Rinv
        return solver

    def _qr(self):
        """(Q, R), the economy QR of A, computed once at full precision.
        The iteration is invariant to the factorization's column signs in
        exact arithmetic only."""
        if self._QR_cache is None:
            with _blas.precision_scope("highest"):
                self._QR_cache = tuple(torch.linalg.qr(self._A,
                                                       mode="reduced"))
        return self._QR_cache

    @property
    def _Rinv(self) -> torch.Tensor:
        """R⁻¹ for the gemm Newton step (SS_IRLS_GEMM=1), from one
        triangular solve against I, cached."""
        if self._Rinv_cache is None:
            R = self._qr()[1]
            self._Rinv_cache = _blas.xtrsm(
                R, torch.eye(self._n, dtype=R.dtype, device=R.device),
                lower=False)
        return self._Rinv_cache

    def _newton_gemm(self, batched: bool) -> bool:
        """Whether a batched fast solve applies the cached R⁻¹ by product
        (SS_IRLS_GEMM=1, read at each solve as the JAX package reads it)."""
        if not batched or self._mode != "fast":
            return False
        return os.environ.get("SS_IRLS_GEMM") == "1"

    def _use_native(self, probe: bool = False) -> bool:
        """Whether ``solve``/``solve_batch`` run on the host engine; the
        stabilized loop and a mesh never do (api.py:1055-1061)."""
        if (self._engine == "jax" or self._stabilized
                or self._mesh is not None):
            return False
        return _route_native(self._engine, self._m, self._n, probe,
                             self._device)

    def _host_solver(self) -> _native.IrlsNative:
        """The host engine's construct-once IRLS, its QR factored once."""
        if self._native is None:
            self._native = _native.IrlsNative(self._host_A())
        return self._native

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan for a solve of this configuration (the JAX
        façade's keys). No side effects."""
        if self._use_native(probe=True):
            return self._native_plan(self._mode)
        if self._mesh is not None:
            plan = {"engine": "torch", "backend": self._device.type,
                    "device": str(self._device), "mode": self._mode,
                    "precision": self._precision,
                    "mesh": dict(self._mesh.shape), "sharded": True,
                    "formulation": ("row+data sharded IRLS (parallel/"
                                    "sharding.irls_sharded; construction QR "
                                    "= mesh-native CholeskyQR2)"),
                    "qr_cached": self._QR_mesh is not None, "kernels": {}}
            if self._stabilized:
                plan["stabilized"] = True
            return plan
        plan = {"engine": "torch", "backend": self._device.type,
                "device": str(self._device), "mode": self._mode,
                "precision": self._precision,
                "formulation": ("batched IRLS iteration (the vmapped "
                                "loop's lanes)" if batch is not None
                                else "IRLS iteration"),
                "qr_cached": self._QR_cache is not None,
                # plain products, QR, Cholesky and triangular solves, as
                # the JAX loop runs no Pallas kernel
                "kernels": {}}
        if self._newton_gemm(batched=batch is not None):
            plan["newton"] = "gemm(R^-1), cached inverse"
        if self._stabilized:
            plan["stabilized"] = True
        return plan

    def _mesh_qr(self):
        """The mesh route's construct-once factorization: CholeskyQR2 on
        the row shards (``qr_sharded``, no host QR), this rank's Q rows
        and the replicated R, cached (api.py:961-971)."""
        if self._QR_mesh is None:
            from .parallel import sharding as _sh
            self._QR_mesh = _sh._qr_local(self._mesh, self._row_shard())
        return self._QR_mesh

    def _run(self, Y: torch.Tensor, tolerance, max_iterations: int,
             batched: bool):
        """The IRLS loop over the lanes of Y (b, m) at the instance's
        precision; returns (X (b, n), IrlsReportArrays). With a mesh,
        ``irls_sharded`` over the mesh's factorization."""
        _certify.check_max_iterations(max_iterations)
        if self._mesh is not None:
            from .parallel import sharding as _sh
            Q, R = self._mesh_qr()
            newton = "gemm" if self._newton_gemm(batched=True) else "trsm"
            with _blas.precision_scope(self._precision):
                return self._mesh_batch(Y, lambda Yl: _sh._irls_placed(
                    self._mesh, Q, R, Yl, tolerance, max_iterations,
                    mode=self._mode, newton=newton,
                    stabilized=self._stabilized))
        Q, R = self._qr()
        r_inv = self._Rinv if self._newton_gemm(batched) else None
        with _blas.precision_scope(self._precision):
            return _irls.solve_irls(Q, R, Y, tolerance, max_iterations,
                                    mode=self._mode, r_inv=r_inv,
                                    stabilized=self._stabilized)

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 100):
        """Solve min‖x‖₁ s.t. Ax = b; returns (x, IrlsReport) with x an
        (n,) tensor on the solver's device."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m,
                             device=self._device)
        if self._use_native():
            _certify.check_max_iterations(max_iterations)
            xn, it, err, spd = self._host_solver().solve(
                _numpy(y), self._tol(tolerance), max_iterations)
            return self._from_host(xn)[0], IrlsReport(
                iter=it, solution_error=err, spd_failure=spd)
        x, rep = _first_lane(self._run(y[None], self._tol(tolerance),
                                       max_iterations, batched=False))
        return x, IrlsReport(iter=int(rep.iter),
                             solution_error=float(rep.solution_error),
                             spd_failure=bool(rep.spd_failure))

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 100):
        """Batched solve over signals B of shape (batch, m); returns (X
        (batch, n), IrlsReportArrays of per-lane tensors) on the solver's
        device. An empty batch returns (0, n) and (0,) tensors."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m,
                                   device=self._device)
        if self._use_native():
            # the threaded C++ batch over the cached QR: one workspace per
            # thread, each lane the single-solve iteration
            _certify.check_max_iterations(max_iterations)
            X, its, errs, spds = self._from_host(
                *self._host_solver().solve_batch(
                    _numpy(Y), self._tol(tolerance), max_iterations))
            return X, _irls.IrlsReportArrays(iter=its, solution_error=errs,
                                             spd_failure=spds)
        return self._run(Y, self._tol(tolerance), max_iterations,
                         batched=True)

    def solve_on_device(self, y: torch.Tensor, tolerance,
                        max_iterations: int = 100):
        """Solve for an (m,) tensor already on the solver's device; returns
        (x, IrlsReportArrays of 0-d tensors)."""
        return _first_lane(self._run(y[None], tolerance, max_iterations,
                                     batched=False))

    def solve_batch_on_device(self, Y: torch.Tensor, tolerance,
                              max_iterations: int = 100):
        """Batched solve over a (batch, m) tensor already on the solver's
        device; returns (X, IrlsReportArrays)."""
        return self._run(Y, tolerance, max_iterations, batched=True)


class IrlsCg(_Solver):
    """CG-accelerated IRLS for the underdetermined regime (m ≤ n), the port
    of ``sparse_solvers_tpu.IrlsCg`` on one device: the DDFG basis-pursuit
    IRLS with a conjugate-gradient inner solve (arXiv:1509.04063),
    factorization-free — each solve touches A only through products.

    Parameters follow the JAX façade: ``p`` in (0, 1] (1.0, the default,
    is convex ℓ₁), ``k_sparsity`` the K of the ε-rule (default m // 4),
    ``cg_max_iterations`` (default min(m, 128)) and ``cg_tolerance``
    (default tolerance/10 within [10·eps, √eps]), ``precision`` of the
    products. ``device`` (default "cuda") is where A and every solve live;
    ``engine`` "native" runs ``solve`` and ``solve_batch`` on the C++ host
    engine, "auto" does so where m·n ≤ 2¹⁶, and "jax" never. Reports carry
    the reference IRLS fields: solution_error = final ε, spd_failure = an
    inner-CG curvature breakdown. ``mesh`` (a ``parallel.sharding.Mesh``)
    splits A's columns over its "row" axis (placed once, at first use) and
    routes ``solve*`` through ``irls_cg_sharded`` on the mesh's device.
    """

    def __init__(self, A, p: float = 1.0, k_sparsity: int | None = None,
                 cg_max_iterations: int | None = None,
                 cg_tolerance: float | None = None,
                 precision: str = "highest", engine: str = "auto",
                 mesh=None, device="cuda"):
        if precision not in ("highest", "high", "default"):
            raise ValueError(
                "precision must be 'highest', 'high' or 'default', "
                f"got {precision!r}")
        if engine not in ("auto", "jax", "native"):
            raise ValueError(
                f"engine must be 'auto', 'jax' or 'native', got {engine!r}")
        if not (0 < p <= 1.0):
            raise ValueError(f"p must be in (0, 1], got {p}")
        if k_sparsity is not None and k_sparsity < 1:
            raise ValueError(f"k_sparsity must be >= 1, got {k_sparsity}")
        if cg_max_iterations is not None and cg_max_iterations < 1:
            raise ValueError(
                f"cg_max_iterations must be >= 1, got {cg_max_iterations}")
        if cg_tolerance is not None and not cg_tolerance > 0:
            raise ValueError(
                f"cg_tolerance must be > 0, got {cg_tolerance}")
        if mesh is not None:
            _check_mesh(mesh, engine)
        self._engine = engine
        self._load(A, device, mesh)
        self._A_mesh = None  # this rank's columns of A, lazy
        if self._m > self._n:
            raise ValueError(
                "IrlsCg serves the underdetermined regime (m <= n); for "
                f"m > n use Irls (got {self._m}x{self._n})")
        self._p = p
        self._k = k_sparsity
        self._cg_max = cg_max_iterations
        self._cg_tol = cg_tolerance
        self._precision = precision
        if mesh is None:
            _warn_small_problem_jax(engine, self._m, self._n, self._device)

    def update_column(self, j: int, col) -> None:
        """Replace column j of the sensing matrix on the solver's device
        (gallery churn, api.py:1246-1259). CG-IRLS is factorization-free,
        so nothing else needs updating; a mesh's placement is made again
        at the next solve."""
        self._replace_column(j, col)
        self._A_mesh = None

    def _use_native(self, probe: bool = False) -> bool:
        """Whether ``solve``/``solve_batch`` run on the host engine
        (api.py:1261-1264); a mesh never does."""
        if self._engine == "jax" or self._mesh is not None:
            return False
        return _route_native(self._engine, self._m, self._n, probe,
                             self._device)

    def _host_knobs(self) -> dict:
        return dict(p=self._p, k_sparsity=self._k,
                    cg_max_iterations=self._cg_max,
                    cg_tolerance=self._cg_tol)

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan for a solve of this configuration (the JAX
        façade's keys). No side effects."""
        if self._use_native(probe=True):
            return dict(self._native_plan("cg"), factorization_free=True)
        if self._mesh is not None:
            return {"engine": "torch", "backend": self._device.type,
                    "device": str(self._device), "mode": "cg",
                    "precision": self._precision, "p": self._p,
                    "mesh": dict(self._mesh.shape), "sharded": True,
                    "formulation": ("column+data sharded CG-IRLS "
                                    "(parallel/sharding.irls_cg_sharded)"),
                    "factorization_free": True, "kernels": {}}
        return {"engine": "torch", "backend": self._device.type,
                "device": str(self._device), "mode": "cg",
                "precision": self._precision, "p": self._p,
                "formulation": ("batched CG-IRLS iteration (the vmapped "
                                "loop's lanes)" if batch is not None
                                else "CG-IRLS iteration"),
                "factorization_free": True,
                # plain products, as the JAX loop runs no Pallas kernel
                "kernels": {}}

    def _run(self, Y: torch.Tensor, tolerance, max_iterations: int):
        """The CG-IRLS loop over the lanes of Y (b, m) at the instance's
        precision; returns (X (b, n), IrlsReportArrays). With a mesh,
        ``irls_cg_sharded`` over this rank's columns, placed once."""
        _certify.check_max_iterations(max_iterations)
        if self._mesh is not None:
            from .parallel import sharding as _sh
            if self._A_mesh is None:
                self._A_mesh = _sh.shard_columns(self._mesh, self._A)
            bpad = (-Y.shape[0]) % self._mesh.shape[_sh.DATA_AXIS]
            Yl = _sh.shard_lanes(self._mesh, torch.nn.functional.pad(
                Y, (0, 0, 0, bpad)), Y.dtype)
            with _blas.precision_scope(self._precision):
                X, rep = _sh._irls_cg_placed(
                    self._mesh, self._A_mesh, Yl, self._n, tolerance,
                    max_iterations, **self._host_knobs())
            return _trim_batch(X, rep, bpad, dense=True)
        with _blas.precision_scope(self._precision):
            return _irls_cg.solve_irls_cg(
                self._A, Y, tolerance, max_iterations, p=self._p,
                k_sparsity=self._k, cg_max_iterations=self._cg_max,
                cg_tolerance=self._cg_tol)

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 100):
        """Solve min‖x‖₁ s.t. Ax = b; returns (x, IrlsReport) with x an
        (n,) tensor on the solver's device."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m,
                             device=self._device)
        if self._use_native():
            _certify.check_max_iterations(max_iterations)
            xn, it, eps, broke = _native.irls_cg_solve(
                self._host_A(), _numpy(y), self._tol(tolerance),
                max_iterations, **self._host_knobs())
            return self._from_host(xn)[0], IrlsReport(
                iter=it, solution_error=eps, spd_failure=broke)
        x, rep = _first_lane(self._run(y[None], self._tol(tolerance),
                                       max_iterations))
        return x, IrlsReport(iter=int(rep.iter),
                             solution_error=float(rep.solution_error),
                             spd_failure=bool(rep.spd_failure))

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 100):
        """Batched solve over signals B of shape (batch, m); returns (X
        (batch, n), IrlsReportArrays of per-lane tensors) on the solver's
        device. An empty batch returns (0, n) and (0,) tensors."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m,
                                   device=self._device)
        if self._use_native():
            _certify.check_max_iterations(max_iterations)
            X, its, eps, broke = self._from_host(*_native.irls_cg_solve_batch(
                self._host_A(), _numpy(Y), self._tol(tolerance),
                max_iterations, **self._host_knobs()))
            return X, _irls.IrlsReportArrays(iter=its, solution_error=eps,
                                             spd_failure=broke)
        return self._run(Y, self._tol(tolerance), max_iterations)

    def solve_on_device(self, y: torch.Tensor, tolerance,
                        max_iterations: int = 100):
        """Solve for an (m,) tensor already on the solver's device; returns
        (x, IrlsReportArrays of 0-d tensors)."""
        return _first_lane(self._run(y[None], tolerance, max_iterations))

    def solve_batch_on_device(self, Y: torch.Tensor, tolerance,
                              max_iterations: int = 100):
        """Batched solve over a (batch, m) tensor already on the solver's
        device; returns (X, IrlsReportArrays)."""
        return self._run(Y, tolerance, max_iterations)


class Cosamp(_Solver):
    """CoSaMP — Compressive Sampling Matching Pursuit over a fixed sensing
    matrix A (m×n) with target sparsity ``k_sparsity`` (Needell–Tropp
    2009), the port of ``sparse_solvers_tpu.Cosamp`` on one device.

    Each round replaces the support: the 2k largest inactive correlations
    join the current k support columns, one least-squares solve runs on
    the ≤ 3k union (a batched Cholesky of its Gram), and the k largest
    entries survive (``solvers/cosamp.py``). ``k_sparsity`` is required;
    ``max_iterations`` counts rounds (default 20). ``precision`` pins the
    products ("highest" default — the round's Gram feeds a Cholesky;
    "high", "default"; no "certified"). ``engine`` is "jax" (the default,
    as in the JAX package) or "auto", and both run the torch route: CoSaMP
    has no host-engine twin. ``device`` (default "cuda") is where A, its
    transposed copy and every solve live. Reports are ``OmpReport`` /
    ``OmpReportArrays``: iter = rounds committed, solution_error =
    ‖y − Ax‖₂. ``mesh`` (a ``parallel.sharding.Mesh``) places A's rows and
    their transpose once and routes ``solve*`` through ``cosamp_sharded``
    on the mesh's device.
    """

    def __init__(self, A, k_sparsity: int, precision: str = "highest",
                 engine: str = "jax", mesh=None, device="cuda"):
        if engine not in ("auto", "jax"):
            raise ValueError(
                "Cosamp runs on the jax engine (no native twin); got "
                f"engine={engine!r}")
        if precision not in ("highest", "high", "default"):
            raise ValueError(
                "precision must be 'highest', 'high' or 'default', "
                f"got {precision!r}")
        if mesh is not None:
            _check_mesh(mesh, engine)
        self._load(A, device, mesh)
        if not isinstance(k_sparsity, int) or k_sparsity < 1:
            raise ValueError(
                f"k_sparsity must be an int >= 1, got {k_sparsity!r}")
        if k_sparsity >= min(self._m, self._n):
            raise ValueError(
                "k_sparsity must be < min(m, n) = "
                f"{min(self._m, self._n)} (the round needs a nonempty "
                f"inactive candidate pool and an overdetermined union "
                f"LS), got {k_sparsity}")
        self._k = k_sparsity
        self._precision = precision
        self._AT_cache = None
        self._A_mesh = None  # (this rank's rows of A, their transpose)

    def _AT(self) -> torch.Tensor:
        """Aᵀ as a contiguous (n, m) tensor, made once: the rounds gather
        the union's columns as its rows, which reads whole rows where a
        gather of A's columns reads one element a memory sector
        (``tools/profile_small_solve.py`` times both)."""
        if self._AT_cache is None:
            self._AT_cache = self._A.T.contiguous()
        return self._AT_cache

    def explain(self, batch: int | None = None,
                max_iterations: int = 20) -> dict:
        """Execution plan for a solve of this configuration (the JAX
        façade's keys). No side effects."""
        plan = {"engine": "torch", "backend": self._device.type,
                "device": str(self._device), "mode": "cosamp",
                "precision": self._precision, "k_sparsity": self._k,
                "union_capacity": _cosamp.union_capacity(self._m, self._n,
                                                         self._k),
                "formulation": (("batched " if batch is not None else "")
                                + "CoSaMP rounds (union LS via 3k-Gram "
                                "Cholesky)"),
                # gathers, products, sorts and a batched Cholesky, as the
                # JAX rounds run no Pallas kernel
                "kernels": {}}
        if self._mesh is not None:
            plan.update(mesh=dict(self._mesh.shape), sharded=True,
                        formulation=("row+data sharded CoSaMP (all-reduced "
                                     "proxy + union Gram per round)"))
        return plan

    def _run(self, Y: torch.Tensor, tolerance, max_iterations: int):
        """The rounds over the lanes of Y (b, m) at the instance's
        precision; returns (X (b, n), OmpReportArrays). With a mesh,
        ``cosamp_sharded`` over this rank's rows, placed once."""
        _certify.check_max_iterations(max_iterations)
        if self._mesh is not None:
            from .parallel import sharding as _sh
            if self._A_mesh is None:
                A_local = self._row_shard()
                self._A_mesh = A_local, A_local.T.contiguous()
            A_local, AT = self._A_mesh
            return self._mesh_batch(Y, lambda Yl: _sh._cosamp_placed(
                self._mesh, A_local, Yl, self._k, tolerance, max_iterations,
                self._precision, self._m, AT=AT))
        with _profiling.span("api.path"), _blas.precision_scope(
                self._precision):
            return _cosamp.solve_cosamp(self._A, Y, self._k, tolerance,
                                        max_iterations, AT=self._AT())

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 20):
        """Recover a k-sparse x with y ≈ Ax; returns (x, OmpReport) with x
        an (n,) tensor on the solver's device."""
        with _profiling.span("api.solve", precision=self._precision):
            _profiling.count("api.lanes")
            y = ndview.as_vector(b, dtype=self.dtype, size=self._m,
                                 device=self._device)
            x, rep = _first_lane(self._run(y[None], self._tol(tolerance),
                                           max_iterations))
            return x, OmpReport(
                iter=_certify.read(rep.iter, int),
                solution_error=_certify.read(rep.solution_error, float))

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 20):
        """Batched solve over signals B of shape (batch, m); returns (X
        (batch, n), OmpReportArrays of per-lane tensors) on the solver's
        device."""
        with _profiling.span("api.solve_batch", precision=self._precision):
            Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m,
                                       device=self._device)
            _profiling.count("api.lanes", Y.shape[0])
            return self._run(Y, self._tol(tolerance), max_iterations)

    def solve_on_device(self, y: torch.Tensor, tolerance,
                        max_iterations: int = 20):
        """Solve for an (m,) tensor already on the solver's device; returns
        (x, OmpReportArrays of 0-d tensors)."""
        return _first_lane(self._run(y[None], tolerance, max_iterations))

    def solve_batch_on_device(self, Y: torch.Tensor, tolerance,
                              max_iterations: int = 20):
        """Batched solve over a (batch, m) tensor already on the solver's
        device; returns (X, OmpReportArrays)."""
        return self._run(Y, tolerance, max_iterations)


def densify_batch(values, indices, n: int) -> torch.Tensor:
    """Scatter a compact slot-space batch solution (``solve_batch(...,
    dense=False)``) back to the dense (batch, n) form."""
    return _homotopy_batch.densify_batch(values, indices, n)


def densify_path(lambdas, values, indices, iters: int, n: int):
    """Reconstruct one dense regularization path from the compact
    slot-space history (``Homotopy.solve_path`` / ``solve_path_batch``),
    on the host (api.py:2125-2147).

    lambdas: (H,), values/indices: (H, k_max) with sentinel index n for
    empty slots; ``iters`` the lane's report.iter. Returns (lambdas (T,),
    Xs (T, n)) as numpy arrays, with a break-terminated path's duplicate
    last row trimmed."""
    lambdas, values, indices = map(_numpy, (lambdas, values, indices))
    T = int(iters) + 1
    Xs = np.zeros((T, n), values.dtype)
    hv, hi = values[:T], indices[:T]
    valid = hi < n
    rows = np.broadcast_to(np.arange(T)[:, None], hi.shape)
    Xs[rows[valid], hi[valid]] = hv[valid]
    lam = lambdas[:T]
    # a break-terminated path's final iteration commits nothing and
    # records a duplicate of the previous breakpoint — trim it
    if T >= 2 and lam[-1] == lam[-2] and np.array_equal(Xs[-1], Xs[-2]):
        lam, Xs = lam[:-1], Xs[:-1]
    return lam, Xs


def lasso_at(lambdas, Xs, lam):
    """Exact LASSO solution at an arbitrary λ from a recorded path
    (api.py:2150-2181): x(λ) is piecewise linear between breakpoints, so
    it is the linear interpolation over the first bracket [λ_{t+1}, λ_t]
    that contains λ. λ ≥ λ₀ gives x = 0; λ below the recorded end gives
    the final iterate. numpy in, numpy out."""
    lambdas, Xs = _numpy(lambdas), _numpy(Xs)
    lam = float(lam)
    if lam >= lambdas[0]:
        return np.zeros_like(Xs[0])
    for t in range(len(lambdas) - 1):
        hi, lo = lambdas[t], lambdas[t + 1]
        if hi >= lam >= lo and hi > lo:
            w = (hi - lam) / (hi - lo)
            return Xs[t] + w * (Xs[t + 1] - Xs[t])
    return Xs[-1].copy()


def lasso_at_batch(lambdas, values, indices, iters, n: int, lam):
    """Batched ``lasso_at`` over ``Homotopy.solve_path_batch``'s compact
    histories: one dense (batch, n) numpy solution at λ, each lane
    interpolated on its own path from its two bracketing rows
    (api.py:2184-2225)."""
    lambdas, values, indices, iters = map(_numpy, (lambdas, values,
                                                   indices, iters))
    lam = float(lam)
    out = np.zeros((lambdas.shape[0], n), values.dtype)

    def row(vi, ii):
        r = np.zeros(n, values.dtype)
        valid = ii < n
        r[ii[valid]] = vi[valid]
        return r

    for i in range(lambdas.shape[0]):
        T = int(iters[i]) + 1
        la, hv, hi = lambdas[i, :T], values[i, :T], indices[i, :T]
        # densify_path's trim of a break-terminated lane's duplicate row
        if (T >= 2 and la[-1] == la[-2]
                and np.array_equal(row(hv[-1], hi[-1]),
                                   row(hv[-2], hi[-2]))):
            la, hv, hi = la[:-1], hv[:-1], hi[:-1]
        if lam >= la[0]:
            continue  # the λ-max end: x = 0
        for t in range(len(la) - 1):
            top, bot = la[t], la[t + 1]
            if top >= lam >= bot and top > bot:
                w = (top - lam) / (top - bot)
                x0 = row(hv[t], hi[t])
                out[i] = x0 + w * (row(hv[t + 1], hi[t + 1]) - x0)
                break
        else:
            out[i] = row(hv[-1], hi[-1])  # below the recorded end
    return out


def reconstruct_signal(A, x, device="cuda") -> np.ndarray:
    """y = A @ x on ``device`` (reference: ss.h:79-84), returned as a
    numpy array."""
    device = _resolve_device(device)
    A = ndview.as_matrix(A, device=device)
    xv = ndview.as_vector(x, dtype=A.dtype, size=A.shape[1], device=device)
    return _numpy(_blas.xgemv(A, xv))


def norm_l1(A, device="cuda") -> np.ndarray:
    """L1-normalize the columns of A on ``device`` (reference:
    ss.h:88-93, norms.h), returned as a numpy array."""
    return _numpy(_norms.l1_columns(ndview.as_matrix(
        A, device=_resolve_device(device))))
