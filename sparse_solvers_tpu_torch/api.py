"""Public solver API — the port of ``sparse_solvers_tpu/api.py``'s
``Homotopy`` throughput subset.

Ported: the constructor's validation, the lazy Gram, ``_plan`` and
``explain``, ``_fn``, ``solve_batch`` with the certified re-solve merge,
``solve_batch_on_device``, ``_certified_error``, ``_default_tolerance``
and ``_check_max_iterations``. Every other route raises
``NotImplementedError`` naming its ROADMAP.md item; the port adds no
feature the JAX package lacks.

PyTorch semantics against the JAX façade:
  * ``Homotopy(A, ..., device="cuda")`` places A, and lazily AᵀA, on that
    device; the default is "cuda", so a missing GPU is an error, never a
    silent CPU run. On a CPU device every kernel runs its plain twin.
  * ``engine="auto"`` always takes the device driver (the JAX package's
    auto-routing of tiny problems to the C++ host engine comes with
    ROADMAP.md Queue 1 item 4).
  * PyTorch runs eagerly: ``_fn`` returns a plain function, nothing is
    compiled or cached per shape, and results are tensors on the device.
"""

from __future__ import annotations

import torch

from .ops import blas as _blas
from .ops import dispatch as _dispatch
from .solvers import homotopy_batch as _homotopy_batch
from .utils import ndview

# Gram matrices above this byte size are not precomputed automatically
# (n² entries; 1 GiB ⇒ n ≈ 16384 in float32) — api.py:47.
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


class Homotopy:
    """Homotopy path-following solver over a fixed sensing matrix A (m×n),
    batched fast mode on the slot-space driver.

    Parameters follow ``sparse_solvers_tpu.Homotopy``; ``device`` (default
    "cuda") is where A, the Gram and every solve live. Ported: float32 A,
    ``mode="fast"``, ``engine`` "auto" or "jax" (both run the device
    driver here), every ``precision`` including "certified", and a Gram
    (the default while n² float32 fits in 1 GiB).
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
        if mode == "exact":
            raise _unported("mode='exact' (the per-lane core)", 4)
        if engine == "native":
            raise _unported("engine='native' (the C++ host engine)", 4)
        if mesh is not None:
            raise _unported("mesh= (multi-GPU solving)", 10)
        self._device = torch.device(device)
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but torch sees no CUDA device; pass "
                "device='cpu' to run the plain PyTorch twins")
        self._A = ndview.as_matrix(A, device=self._device)
        if self._A.dtype != torch.float32:
            raise _unported("float64 A (the per-lane core)", 4)
        self._m, self._n = self._A.shape
        self._k_max = k_max
        self._precision = precision or "certified"
        if gram is None:
            gram = self._n * self._n * 4 <= _GRAM_AUTO_BYTES
        if not gram:
            raise _unported("the gram-free route (gram=False or n² above "
                            "1 GiB)", 5)
        self._G_cache = None

    @classmethod
    def from_numpy(cls, A, G=None, **kwargs) -> "Homotopy":
        """Build a solver whose Gram is the given (n, n) array instead of
        one computed here — tests feed the JAX-computed Gram so that both
        packages step from identical state."""
        solver = cls(A, **kwargs)
        if G is not None:
            solver._G_cache = ndview.as_matrix(G, dtype=torch.float32,
                                               device=solver._device)
        return solver

    @property
    def _G(self) -> torch.Tensor:
        """AᵀA, computed on first use at fp32 with TF32 off — the JAX
        package's ``_lazy_gram`` at HIGHEST."""
        if self._G_cache is None:
            with _blas.precision_scope("highest"):
                self._G_cache = _blas.xgemm(self._A, self._A, trans_a=True)
        return self._G_cache

    @property
    def shape(self):
        return (self._m, self._n)

    @property
    def dtype(self):
        return self._A.dtype

    def _plan(self, max_iterations: int, batch: int | None):
        """(k_max, sparse_matvec, batch_native) for a solve of this shape,
        shared by ``_fn`` and ``explain`` (api.py:420-449)."""
        k_max = self._k_max or min(self._n, max_iterations + 1)
        sparse = ((batch or 1) * k_max < 2 * self._m and k_max < self._n)
        batch_native = _homotopy_batch.route_batch_native(
            batch, self._n, self._A.dtype, sparse)
        return k_max, sparse, batch_native

    def explain(self, batch: int | None = None,
                max_iterations: int = 100) -> dict:
        """Execution plan for a solve of this configuration: which
        formulation runs and which form of each kernel. No side effects."""
        k_max, sparse, batch_native = self._plan(max_iterations, batch)
        plan = {
            "engine": "torch",
            "device": str(self._device),
            "mode": "fast",
            "precision": self._precision,
            "gram": True,
            "k_max": k_max,
            "sparse_matvec": sparse,
            "batch_native": batch_native,
            "formulation": ("slot-space batch driver (scan + transition "
                            "kernels)" if batch_native else
                            "unported (per-lane core, ROADMAP.md Queue 1 "
                            "item 4)"),
        }
        path_precision = self._precision
        if self._precision == "certified":
            path_precision = plan["path_precision"] = "default"
            plan["certificate"] = ("‖Aᵀ(y−Ax)‖∞ at high precision; "
                                   "solve_batch re-solves lanes that miss "
                                   "the tolerance")
        if batch_native:
            plan["capacity_tiers"] = _homotopy_batch._plan_tiers(
                k_max, max_iterations, None)
            plan["fused_q"] = path_precision == "default"
            plan["kernels"] = _dispatch.explain(self._device)
        return plan

    def _fn(self, max_iterations: int, batch: int | None,
            precision: str | None = None, dense: bool = True):
        """The solve function for this shape: ``run(A, G, Y, tol)`` →
        (X, report), or ((values, indices), report) when ``dense=False``.
        ``precision`` overrides the instance setting (the certified
        re-solve uses it)."""
        _check_max_iterations(max_iterations)
        precision = precision or self._precision
        certified = precision == "certified"
        # certified: the path runs at one-pass precision, the certificate
        # below restores trust in the result
        path_precision = "default" if certified else precision
        k_max, sparse, batch_native = self._plan(max_iterations, batch)
        if not batch_native:
            raise _unported(
                f"the sparse-matvec regime (batch·k_max = {batch * k_max} "
                f"< 2m = {2 * self._m}; the per-lane core)", 4)

        def run(A, G, Y, tol):
            with _blas.precision_scope(path_precision):
                out, rep = _homotopy_batch.solve_homotopy_batch(
                    A, G, Y, tol, max_iterations, k_max, dense=dense)
            if certified:
                x = (out if dense else
                     _homotopy_batch.densify_batch(out[0], out[1], self._n))
                err = _certified_error(A, x, Y)
                rep = rep._replace(solution_error=err.to(
                    rep.solution_error.dtype))
            return out, rep

        return run

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
                if dense:
                    X = torch.where(sel[:, None], Xh, X)
                else:
                    X = (torch.where(sel[:, None], Xh[0], X[0]),
                         torch.where(sel[:, None], Xh[1], X[1]))
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

    def _tol(self, tolerance) -> float:
        return (_default_tolerance(self.dtype)
                if tolerance is None else float(tolerance))

    # --- routes not ported yet (ROADMAP.md Queue 1) -----------------------

    def solve(self, b, tolerance=None, max_iterations: int = 100):
        raise _unported("Homotopy.solve (the per-lane core)", 4)

    def solve_on_device(self, y, tolerance, max_iterations: int = 100):
        raise _unported("Homotopy.solve_on_device (the per-lane core)", 4)

    def solve_path(self, b, tolerance=None, max_iterations: int = 100):
        raise _unported("Homotopy.solve_path (record_path)", 4)

    def solve_path_batch(self, B, tolerance=None, max_iterations: int = 100):
        raise _unported("Homotopy.solve_path_batch (record_path)", 4)

    def update_column(self, j: int, col) -> None:
        raise _unported("Homotopy.update_column", 4)
