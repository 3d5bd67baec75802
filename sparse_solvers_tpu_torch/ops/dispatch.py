"""Kernel dispatch — the port of ``sparse_solvers_tpu/ops/dispatch.py``.

The JAX package chooses between its Pallas kernels and plain XLA once per
process, with an environment override and a graceful fallback. Here the
tensor's device decides, per call, and nothing else does:

  * a CUDA tensor launches the kernel written by hand for Hopper
    (``ops/cuda``, sources in ``csrc/``) — or raises: there is no
    environment override and no ``try`` that falls back to the twin;
  * a CPU tensor runs the kernel's plain PyTorch twin, which lives beside
    the wrapper in the same module.

Each wrapper adds one to ``launches[name]`` where it launches its CUDA
kernel, and nowhere else, so a run can show that it went through the
kernels (``chip_smoke.py`` reads the counts around each main path); K1
adds one to ``fallbacks[name]`` as well where it takes its ring route.
"""

from __future__ import annotations

import torch

# kernel name -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "normal_matvec_fused_bf16": (
        "sparse_solvers_tpu_torch/csrc/normal_bf16.cu",
        "sparse_solvers_tpu/ops/pallas/kernels.py:220"),
    "find_max_gamma_fused": (
        "sparse_solvers_tpu_torch/csrc/scan.cu",
        "sparse_solvers_tpu/ops/pallas/scan.py:134"),
    "transition": (
        "sparse_solvers_tpu_torch/csrc/transition.cu",
        "sparse_solvers_tpu/ops/pallas/transition.py:255"),
    "omp_insert": (
        "sparse_solvers_tpu_torch/csrc/omp_insert.cu",
        "sparse_solvers_tpu/ops/pallas/omp_insert.py:108"),
    "normal_matvec_fused": (
        "sparse_solvers_tpu_torch/csrc/fused_corr.cu",
        "sparse_solvers_tpu/ops/pallas/kernels.py:136"),
    "residual_correlation_fused": (
        "sparse_solvers_tpu_torch/csrc/fused_corr.cu",
        "sparse_solvers_tpu/ops/pallas/kernels.py:267"),
}

launches = dict.fromkeys(KERNELS, 0)
# launches that took a kernel's fallback route: K1's cp.async ring where TMA
# cannot describe the operands (``ops/cuda/kernels.py::k1_launch_plan``)
fallbacks = {"normal_matvec_fused_bf16": 0}


def reset_launches() -> None:
    for counts in (launches, fallbacks):
        for name in counts:
            counts[name] = 0


def use_cuda_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the hand kernel), False for CPU
    tensors (run the twin). Mixed or other devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel operands span devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {dev}")


def explain(device, names=KERNELS) -> dict:
    """Which form of each named kernel (default: all) a solve on
    ``device`` runs."""
    cuda = torch.device(device).type == "cuda"
    return {name: (f"cuda ({KERNELS[name][0]})" if cuda
                   else "plain torch twin") for name in names}
