"""Public solver API — the port of ``sparse_solvers_tpu/api.py``'s
``Homotopy`` and ``Omp`` façades.

Ported: ``Homotopy`` and ``Omp`` whole on one device except the host
engine and ``mesh=`` (every ``solve*`` route, both modes, float32 and
float64, with a Gram, without one and gram-free in the batch drivers, and
``picks`` for gOMP), ``update_column``, and the module functions
``densify_batch``, ``densify_path``, ``lasso_at``, ``lasso_at_batch``,
``reconstruct_signal`` and ``norm_l1``. Every other route raises
``NotImplementedError`` naming its ROADMAP.md item; the port adds no
feature the JAX package lacks.

PyTorch semantics against the JAX façade:
  * ``Homotopy(A, ..., device="cuda")`` and ``Omp(A, ..., device="cuda")``
    place A, and lazily AᵀA, on that device; the default is "cuda", so a
    missing GPU is an error, never a silent CPU run. On a CPU device every
    kernel runs its plain twin.
  * ``engine="auto"`` runs the torch routes: the slot-space driver or the
    per-lane core. The JAX package's auto-routing of tiny problems to the
    C++ host engine is ROADMAP.md Queue 1 item 4's open part.
  * PyTorch runs eagerly: ``_fn`` returns a plain function, nothing is
    compiled or cached per shape, and solutions are tensors on the device.
    The regularization-path helpers work on the host, in numpy, as the
    JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from .linalg import norms as _norms
from .ops import blas as _blas
from .ops import dispatch as _dispatch
from .ops.operators import DenseOperator
from .reports import HomotopyReport, OmpReport
from .solvers import homotopy as _homotopy
from .solvers import homotopy_batch as _homotopy_batch
from .solvers import omp as _omp
from .solvers import omp_batch as _omp_batch
from .utils import ndview

# Gram matrices above this byte size are not precomputed automatically
# (n² entries of the dtype's size; 1 GiB ⇒ n ≈ 16384 in float32) —
# api.py:47.
_GRAM_AUTO_BYTES = 1 << 30

_PRECISION_VALUES = ("highest", "high", "default", "certified")


def _unported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to sparse_solvers_tpu_torch yet: "
        f"ROADMAP.md Queue 1 item {item}")


def _default_tolerance(dtype) -> float:
    # reference binding default: 10 × machine epsilon (binding.cpp:108-110)
    return float(torch.finfo(dtype).eps) * 10


def _check_max_iterations(max_iterations: int) -> int:
    """The reference's caller contract (homotopy-cpu.cpp:193:
    ``assert(max_iter > 0)``) as an edge ValueError."""
    if max_iterations < 1:
        raise ValueError(
            f"max_iterations must be >= 1, got {max_iterations}")
    return max_iterations


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


def _merge_lanes(sel: torch.Tensor, new, old, dense: bool):
    """Per-lane select of a re-solve's output (dense X, or the compact
    (values, indices) pair) over the first solve's."""
    if dense:
        return torch.where(sel[:, None], new, old)
    return (torch.where(sel[:, None], new[0], old[0]),
            torch.where(sel[:, None], new[1], old[1]))


def _compact_from_dense(X: torch.Tensor, k_max: int):
    """The compact (values, indices) form of a dense batch solution, the
    per-lane core's ``dense=False`` (api.py:2103-2115): per lane the ≤
    k_max nonzero coordinates in ascending index order, sentinel n beyond
    them. An exactly-zero active coordinate contributes nothing either
    way."""
    n = X.shape[1]
    nz = X != 0
    order = torch.sort((~nz).to(torch.int8), dim=1,
                       stable=True).indices[:, :k_max]
    keep = nz.gather(1, order)
    vals = torch.where(keep, X.gather(1, order), torch.zeros_like(X[:, :1]))
    idxs = torch.where(keep, order, torch.full_like(order, n))
    return vals, idxs.to(torch.int32)


def _first_lane(out):
    """A one-lane result without its lane axis (nested tuples kept)."""
    if isinstance(out, tuple):
        parts = [_first_lane(o) for o in out]
        return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
    return out[0]


def _numpy(a) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _update_column_impl(solver, j: int, col) -> None:
    """Replace column j of A with ``col`` and rewrite the cached Gram's row
    and column incrementally — one Aᵀ·v product instead of the O(mn²)
    rebuild (api.py:215-252). A and G are replaced by updated copies, not
    written in place: A may be the caller's own tensor."""
    if not (0 <= j < solver._n):
        raise ValueError(f"column index {j} out of range [0, {solver._n})")
    v = ndview.as_vector(col, dtype=solver.dtype, size=solver._m,
                         device=solver._device)
    A = solver._A.clone()
    A[:, j] = v
    solver._A = A
    solver._AT_cache.clear()
    if solver._G_cache is not None:
        # the new Gram row/col g = Aᵀ_new v, at the precision the lazy
        # Gram was built at (the updated column lands vᵀv on the diagonal)
        with _blas.precision_scope("highest"):
            g = _blas.xgemv(A, v, trans=True)
        G = solver._G_cache.clone()
        G[:, j] = g
        G[j, :] = g
        solver._G_cache = G


class _GramSolver:
    """What the façades share: A on the solver's device and its lazy
    Gram (the JAX package's ``_lazy_gram``)."""

    def _load(self, A, device) -> None:
        """Place A on ``device``."""
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but torch sees no CUDA device; pass "
                "device='cpu' to run the plain PyTorch twins")
        self._A = ndview.as_matrix(A, device=self._device)
        self._m, self._n = self._A.shape
        self._G_cache = None
        self._AT_cache: dict[bool, torch.Tensor] = {}

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
        packages step from identical state."""
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

    def update_column(self, j: int, col) -> None:
        """Replace column j of the sensing matrix on the solver's device
        (gallery churn): the cached Gram's row and column are rewritten
        from one Aᵀ·col product instead of the O(mn²) rebuild. No
        reference analog: its solver holds a const view of A
        (policies.h:42)."""
        _update_column_impl(self, j, col)

    @property
    def shape(self):
        return (self._m, self._n)

    @property
    def dtype(self):
        return self._A.dtype

    def _tol(self, tolerance) -> float:
        return (_default_tolerance(self.dtype)
                if tolerance is None else float(tolerance))


class Homotopy(_GramSolver):
    """Homotopy path-following solver over a fixed sensing matrix A (m×n).

    Parameters follow ``sparse_solvers_tpu.Homotopy``; ``device`` (default
    "cuda") is where A, the Gram and every solve live. Batches outside the
    sparse-matvec regime take the slot-space driver (float32, fast mode,
    gram-free without a Gram); single solves, the sparse-matvec regime,
    float64 and ``mode="exact"`` take the per-lane core. ``engine`` "auto"
    and "jax" both run these torch routes.
    """

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
        if engine == "native":
            raise _unported("engine='native' (the C++ host engine)", 4)
        if mesh is not None:
            raise _unported("mesh= (multi-GPU solving)", 10)
        self._load(A, device)
        self._k_max = k_max
        self._mode = mode
        self._precision = precision or ("certified" if mode == "fast"
                                        else "highest")
        # exact mode never reads the Gram (api.py:355)
        self._gram_enabled = self._gram_auto(gram) and mode == "fast"

    def _plan(self, max_iterations: int, batch: int | None):
        """(k_max, sparse_matvec, batch_native) for a solve of this shape,
        shared by ``_fn`` and ``explain`` (api.py:420-449)."""
        k_max = self._k_max or min(self._n, max_iterations + 1)
        sparse = (self._mode == "fast"
                  and (batch or 1) * k_max < 2 * self._m
                  and k_max < self._n)
        batch_native = (self._mode == "fast"
                        and _homotopy_batch.route_batch_native(
                            batch, self._n, self._A.dtype, sparse))
        return k_max, sparse, batch_native

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan for a solve of this configuration: which
        formulation runs and which form of each kernel. No side effects."""
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

    def _fn(self, max_iterations: int, batch: int | None,
            precision: str | None = None, record_path: bool = False,
            dense: bool = True):
        """The solve function for this shape: ``run(A, G, y, tol)`` →
        (x, report), or ((values, indices), report) when ``dense=False``,
        or (x, report, histories) with ``record_path``. ``y`` is (m,) for
        ``batch=None`` and (batch, m) otherwise. ``precision`` overrides
        the instance setting (the certified re-solve uses it)."""
        _check_max_iterations(max_iterations)
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
                    return _homotopy_batch.solve_homotopy_batch(
                        A, G, Y, tol, max_iterations, k_max, dense=dense,
                        record_path=record_path,
                        AT=None if G is not None else self._transposed())
                return _homotopy.solve_homotopy_core(
                    DenseOperator(A, G), self._n, Y, tol, max_iterations,
                    k_max, mode=self._mode, sparse_matvec=sparse,
                    record_path=record_path, compact=not dense)

        def run(A, G, y, tol):
            Y = y if batch is not None else y[None]
            out = path(A, G, Y, tol)
            if certified:
                X, rep = out
                x = (X if dense else
                     _homotopy_batch.densify_batch(X[0], X[1], self._n))
                err = _certified_error(A, x, Y)
                out = X, rep._replace(solution_error=err.to(
                    rep.solution_error.dtype))
            if batch is None:  # one lane: drop the lane axis
                out = _first_lane(out)
            return out

        return run

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 100):
        """Solve min‖x‖₁ s.t. Ax = b; returns (x, HomotopyReport) with x
        an (n,) tensor on the solver's device. Under "certified", a
        solution whose certificate misses the tolerance is re-solved at
        "high" (api.py:605-641)."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m,
                             device=self._device)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        x, rep = self._fn(max_iterations, batch=None)(self._A, self._G, y,
                                                      tol)
        it, err = int(rep.iter), float(rep.solution_error)
        # NaN-safe predicate; a lane that exhausted max_iterations is
        # reported as-is — no precision fixes an iteration budget
        if (self._precision == "certified" and not (err <= tol)
                and it < max_iterations):
            x, rep = self._fn(max_iterations, batch=None,
                              precision="high")(self._A, self._G, y, tol)
            it, err = int(rep.iter), float(rep.solution_error)
        return x, HomotopyReport(iter=it, solution_error=err)

    def solve_on_device(self, y: torch.Tensor, tolerance,
                        max_iterations: int = 100):
        """Solve for an (m,) tensor already on the solver's device, without
        the certified re-solve: under "certified" the report's
        solution_error is the certificate, to be checked against the
        tolerance downstream. Returns (x, HomotopyReportArrays of 0-d
        tensors)."""
        return self._fn(max_iterations, batch=None)(self._A, self._G, y,
                                                    tolerance)

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
        _check_max_iterations(max_iterations)
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
        _check_max_iterations(max_iterations)
        precision = ("high" if self._precision == "certified"
                     else self._precision)
        _, rep, (hv, hi, hl) = self._fn(
            max_iterations, batch=Y.shape[0], precision=precision,
            record_path=True)(self._A, self._G, Y, tol)
        return (_numpy(hl), _numpy(hv), _numpy(hi),
                _homotopy.HomotopyReportArrays(
                    iter=_numpy(rep.iter),
                    solution_error=_numpy(rep.solution_error)))

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 100, dense: bool = True):
        """Batched solve over signals B of shape (batch, m).

        Returns (X (batch, n), HomotopyReportArrays of per-lane tensors),
        on the solver's device. ``dense=False`` returns ``(values,
        indices, report)``, the compact slot-space solution (see
        ``sparse_solvers_tpu.Homotopy.solve_batch``). Under "certified",
        lanes whose certificate misses the tolerance are re-solved at
        "high" and merged (api.py:754-784)."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m,
                                   device=self._device)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        X, rep = self._fn(max_iterations, batch=Y.shape[0], dense=dense)(
            self._A, self._G, Y, tol)
        if self._precision == "certified":
            # NaN-safe predicate: a non-finite certificate counts as
            # failing; lanes that exhausted max_iterations are reported
            # as-is (no precision fixes an iteration budget). The re-solve
            # covers the full batch and the merge keeps the fast result
            # wherever the certificate held.
            errs = rep.solution_error.cpu().numpy()
            bad = (~(errs <= tol)) & (rep.iter.cpu().numpy()
                                      < max_iterations)
            if bad.any():
                Xh, reph = self._fn(max_iterations, batch=Y.shape[0],
                                    precision="high", dense=dense)(
                    self._A, self._G, Y, tol)
                sel = torch.as_tensor(bad, device=self._device)
                X = _merge_lanes(sel, Xh, X, dense)
                rep = type(rep)(
                    iter=torch.where(sel, reph.iter, rep.iter),
                    solution_error=torch.where(sel, reph.solution_error,
                                               rep.solution_error))
        if not dense:
            return X[0], X[1], rep
        return X, rep

    def solve_batch_on_device(self, Y: torch.Tensor, tolerance,
                              max_iterations: int = 100,
                              dense: bool = True):
        """Batched solve over a (batch, m) tensor already on the solver's
        device, without host-side conversion or the certified re-solve:
        under "certified" each lane's solution_error is the certificate,
        to be checked against the tolerance downstream. Returns (X,
        report), or ((values, indices), report) when ``dense=False``."""
        return self._fn(max_iterations, batch=Y.shape[0], dense=dense)(
            self._A, self._G, Y, tolerance)


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
    miss the tolerance at "high". ``engine`` "auto" and "jax" both run
    these torch routes.
    """

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
        if engine == "native":
            raise _unported("engine='native' (the C++ host engine)", 4)
        if mesh is not None:
            raise _unported("mesh= (multi-GPU solving)", 10)
        self._load(A, device)
        if picks > self._n:
            raise ValueError(
                f"picks must be <= n = {self._n} (each round selects "
                f"picks inactive columns), got {picks}")
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
        """Execution plan for a solve of this configuration: which
        formulation runs and which form of each kernel. No side effects."""
        k_max = self._resolved_k_max(max_iterations)
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

    def _fn(self, max_iterations: int, batch: int | None,
            precision: str | None = None, dense: bool = True):
        """The solve function for this shape: ``run(A, G, Y, tol)`` →
        (X, report), or ((values, indices), report) when ``dense=False``;
        ``Y`` is (m,) for ``batch=None`` and (batch, m) otherwise. Under
        "certified" the report's error is the certificate: the driver's
        own, or ``_certified_l2_error`` of the core's solution.
        ``precision`` overrides the instance setting (the certified
        re-solve uses it)."""
        _check_max_iterations(max_iterations)
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
            with _blas.precision_scope(path_precision):
                if driver:
                    # without a Gram the driver runs gram-free
                    return _omp_batch.solve_omp_batch(
                        A, G, Y, tol, max_iterations, k_max, dense=dense,
                        picks=self._picks,
                        AT=None if G is not None else self._transposed())
                # G rides along for the per-pick inserts whenever it
                # exists; corr selects only the correlation update
                X, rep = _omp.solve_omp_core(
                    DenseOperator(A, G), self._n, Y, tol, max_iterations,
                    k_max, mode=self._mode, corr=corr, picks=self._picks)
            if certified:
                rep = rep._replace(solution_error=_certified_l2_error(
                    A, X, Y).to(rep.solution_error.dtype))
            if batch is None:
                return _first_lane((X, rep))
            if not dense:
                return _compact_from_dense(X, k_max), rep
            return X, rep

        return run

    def solve(self, b, tolerance: float | None = None,
              max_iterations: int = 100):
        """Greedy-solve y ≈ Ax with ≤ max_iterations support picks;
        returns (x, OmpReport) with x an (n,) tensor on the solver's
        device. Under "certified", a solution whose certificate misses the
        tolerance is re-solved at "high" (api.py:1771-1803)."""
        y = ndview.as_vector(b, dtype=self.dtype, size=self._m,
                             device=self._device)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        x, rep = self._fn(max_iterations, batch=None)(self._A, self._G, y,
                                                      tol)
        it, err = int(rep.iter), float(rep.solution_error)
        # NaN-safe predicate; a lane that exhausted max_iterations is
        # reported as-is
        if (self._precision == "certified" and not (err <= tol)
                and it < max_iterations):
            x, rep = self._fn(max_iterations, batch=None,
                              precision="high")(self._A, self._G, y, tol)
            it, err = int(rep.iter), float(rep.solution_error)
        return x, OmpReport(iter=it, solution_error=err)

    def solve_on_device(self, y: torch.Tensor, tolerance,
                        max_iterations: int = 100):
        """Solve for an (m,) tensor already on the solver's device, without
        the certified re-solve: under "certified" the report's
        solution_error is the certificate, to be checked against the
        tolerance downstream. Returns (x, OmpReportArrays of 0-d
        tensors)."""
        return self._fn(max_iterations, batch=None)(self._A, self._G, y,
                                                    tolerance)

    def solve_batch(self, B, tolerance: float | None = None,
                    max_iterations: int = 100, dense: bool = True):
        """Batched greedy solve over signals B of shape (batch, m).

        Returns (X (batch, n), OmpReportArrays of per-lane tensors), on
        the solver's device. ``dense=False`` returns ``(values, indices,
        report)``, the compact slot-space solution; ``densify_batch``
        rebuilds X exactly. Under "certified", lanes whose certificate
        misses the tolerance are re-solved at "high" and merged
        (api.py:1838-1861)."""
        Y = ndview.as_signal_batch(B, dtype=self.dtype, size=self._m,
                                   device=self._device)
        tol = self._tol(tolerance)
        _check_max_iterations(max_iterations)
        out, rep = self._fn(max_iterations, batch=Y.shape[0], dense=dense)(
            self._A, self._G, Y, tol)
        if self._precision == "certified":
            # NaN-safe predicate: a non-finite certificate counts as
            # failing; lanes that exhausted max_iterations are reported
            # as-is. The re-solve covers the full batch and the merge
            # keeps the fast result wherever the certificate held.
            errs = rep.solution_error.cpu().numpy()
            bad = (~(errs <= tol)) & (rep.iter.cpu().numpy()
                                      < max_iterations)
            if bad.any():
                outh, reph = self._fn(max_iterations, batch=Y.shape[0],
                                      precision="high", dense=dense)(
                    self._A, self._G, Y, tol)
                sel = torch.as_tensor(bad, device=self._device)
                out = _merge_lanes(sel, outh, out, dense)
                rep = type(rep)(
                    iter=torch.where(sel, reph.iter, rep.iter),
                    solution_error=torch.where(sel, reph.solution_error,
                                               rep.solution_error))
        if not dense:
            return out[0], out[1], rep
        return out, rep

    def solve_batch_on_device(self, Y: torch.Tensor, tolerance,
                              max_iterations: int = 100,
                              dense: bool = True):
        """Batched solve over a (batch, m) tensor already on the solver's
        device, without host-side conversion or the certified re-solve:
        under "certified" each lane's solution_error is the certificate,
        to be checked against the tolerance downstream. Returns (X,
        report), or ((values, indices), report) when ``dense=False``."""
        return self._fn(max_iterations, batch=Y.shape[0], dense=dense)(
            self._A, self._G, Y, tolerance)

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
    A = ndview.as_matrix(A, device=device)
    xv = ndview.as_vector(x, dtype=A.dtype, size=A.shape[1], device=device)
    return _numpy(_blas.xgemv(A, xv))


def norm_l1(A, device="cuda") -> np.ndarray:
    """L1-normalize the columns of A on ``device`` (reference:
    ss.h:88-93, norms.h), returned as a numpy array."""
    return _numpy(_norms.l1_columns(ndview.as_matrix(A, device=device)))
