"""sparse-solvers-tpu, PyTorch/CUDA port — the batched certified Homotopy path.

A second package beside ``sparse_solvers_tpu`` (the JAX reference, left as
it is): the same layout and names, in PyTorch, with the three Pallas TPU
kernels of the throughput path rewritten by hand in CUDA C++ for Hopper
(``csrc/``, built with nvcc at first use, bound with ctypes). On a CUDA
tensor every kernel launches its hand-written CUDA form; on a CPU tensor
it runs its plain PyTorch twin (``ops/dispatch.py``). The package imports
``torch`` and never ``jax`` or ``sparse_solvers_tpu``.

Ported so far: ``Homotopy`` batched fast-mode solves through the slot-space
driver (``solve_batch``, ``solve_batch_on_device``) at every precision,
including ``"certified"``. Everything else raises ``NotImplementedError``
naming its ROADMAP.md item.
"""

from .api import Homotopy
from .reports import HomotopyReport
from .solvers.homotopy_batch import densify_batch

__all__ = ["Homotopy", "HomotopyReport", "densify_batch"]
