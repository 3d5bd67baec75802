"""sparse-solvers-tpu, PyTorch/CUDA port — the Homotopy and OMP/gOMP
façades and every TPU kernel's Hopper counterpart.

A second package beside ``sparse_solvers_tpu`` (the JAX reference, left as
it is): the same layout and names, in PyTorch, with the Pallas TPU
kernels of the throughput paths rewritten by hand in CUDA C++ for Hopper
(``csrc/``, built with nvcc at first use, bound with ctypes). On a CUDA
tensor every kernel launches its hand-written CUDA form; on a CPU tensor
it runs its plain PyTorch twin (``ops/dispatch.py``). The package imports
``torch`` and never ``jax`` or ``sparse_solvers_tpu``.

Ported so far: ``Homotopy`` and ``Omp`` (with ``picks`` for gOMP) on one
device — ``solve``, ``solve_batch`` (the slot-space drivers, with a Gram or
gram-free, or the per-lane cores in the small-batch regimes),
``solve_path``, ``solve_path_batch``, the ``*_on_device`` entries,
``update_column``, both modes, float32 and float64, at every precision
including ``"certified"``; the module functions below; the K5 and K6 fused
correlation kernels (``ops/cuda/kernels.py``) with the roofline module
(``utils/profiling.py``). Everything else raises ``NotImplementedError``
naming its ROADMAP.md item.
"""

from .api import (Homotopy, Omp, densify_batch, densify_path, lasso_at,
                  lasso_at_batch, norm_l1, reconstruct_signal)
from .reports import HomotopyReport, OmpReport

__all__ = ["Homotopy", "HomotopyReport", "Omp", "OmpReport",
           "densify_batch", "densify_path", "lasso_at", "lasso_at_batch",
           "norm_l1", "reconstruct_signal"]
