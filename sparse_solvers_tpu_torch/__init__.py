"""sparse-solvers-tpu, PyTorch/CUDA port — the batched certified Homotopy and
OMP/gOMP paths.

A second package beside ``sparse_solvers_tpu`` (the JAX reference, left as
it is): the same layout and names, in PyTorch, with the Pallas TPU
kernels of the throughput paths rewritten by hand in CUDA C++ for Hopper
(``csrc/``, built with nvcc at first use, bound with ctypes). On a CUDA
tensor every kernel launches its hand-written CUDA form; on a CPU tensor
it runs its plain PyTorch twin (``ops/dispatch.py``). The package imports
``torch`` and never ``jax`` or ``sparse_solvers_tpu``.

Ported so far: ``Homotopy`` and ``Omp`` (with ``picks`` for gOMP) batched
fast-mode solves through their slot-space drivers (``solve_batch``,
``solve_batch_on_device``) at every precision, including ``"certified"``.
Everything else raises ``NotImplementedError`` naming its ROADMAP.md item.
"""

from .api import Homotopy, Omp
from .reports import HomotopyReport, OmpReport
from .solvers.homotopy_batch import densify_batch

__all__ = ["Homotopy", "HomotopyReport", "Omp", "OmpReport",
           "densify_batch"]
