"""sparse-solvers-tpu, PyTorch/CUDA port — the solver façades of the JAX
package and every TPU kernel's Hopper counterpart.

A second package beside ``sparse_solvers_tpu`` (the JAX reference, left as
it is): the same layout and names, in PyTorch, with the Pallas TPU
kernels of the throughput paths rewritten by hand in CUDA C++ for Hopper
(``csrc/``, built with nvcc at first use, bound with ctypes). On a CUDA
tensor every kernel launches its hand-written CUDA form; on a CPU tensor
it runs its plain PyTorch twin (``ops/dispatch.py``). The package imports
``torch`` and never ``jax`` or ``sparse_solvers_tpu``.

Ported, the JAX package's whole surface: ``Homotopy`` and ``Omp`` (with
``picks`` for gOMP) — ``solve``, ``solve_batch`` (the slot-space drivers,
with a Gram or gram-free, or the per-lane cores in the small-batch
regimes), ``solve_path``, ``solve_path_batch``, the ``*_on_device``
entries, ``update_column``, both modes, float32 and float64, at every
precision including ``"certified"``; ``Irls`` (a QR computed once; fast
mode with the triangular-solve or R⁻¹-gemm Newton step, exact mode,
stabilized) and the factorization-free ``IrlsCg``, with ``IrlsReport``;
``Cosamp`` (the support-replacing greedy rounds); the C++ host engine of
the repo's ``csrc/`` for ``engine="native"`` and a CPU façade's small
problems (``backend/native.py``); multi-GPU solving over a (data, row)
mesh of processes on torch.distributed (``parallel/``: the sharded routes
of every family and ``mesh=`` in every façade); the module functions
below and ``version``; the K5 and K6 fused correlation kernels
(``ops/cuda/kernels.py``) with the roofline module (``utils/
profiling.py``).
"""

from .api import (Cosamp, Homotopy, Irls, IrlsCg, Omp, densify_batch,
                  densify_path, lasso_at, lasso_at_batch, norm_l1,
                  reconstruct_signal)
from .reports import HomotopyReport, IrlsReport, OmpReport
from .utils.config import version

__all__ = ["Cosamp", "Homotopy", "HomotopyReport", "Irls", "IrlsCg",
           "IrlsReport", "Omp", "OmpReport", "densify_batch", "densify_path",
           "lasso_at", "lasso_at_batch", "norm_l1", "reconstruct_signal",
           "version"]
