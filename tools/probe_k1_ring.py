"""What bounds K1's ring tile GEMM on the card: its passes timed as built
and in probe forms that leave one part of the work out or deepen the ring.

    python3 tools/probe_k1_ring.py

The ring is K1's fallback route since the TMA → wgmma GEMM
(``csrc/wgmma_gemm.cuh``) took every shape TMA can describe, the cells'
shapes among them; this probe forces the ring
(``k1_launch_plan(..., aligned=False)``) to time it at the main shape. Its
finding, that the copies alone took 0.2042 ms of 0.2512, is what the wgmma
route's design answers.

Each form, in a process of its own, is a copy of
``sparse_solvers_tpu_torch/csrc`` under ``build/k1_probe/`` with one edit
to ``tile_gemm.cuh``'s ring kernel, built and loaded in place of the
package's sources:

  * ``as built``: no edit;
  * ``copies only``: the multiply loop is empty, so the time is what the
    cp.async ring takes to stream the tiles from L2;
  * ``multiply only``: nothing is copied past the prologue, so the time is
    what the warps' ldmatrix loads and mma.sync products take;
  * ``6 stages``, ``BK 64``: the ring deeper, the slices deeper.

The two forms that leave work out compute wrong values on purpose; the
others are checked against the twin (1e-3·max|Q|). Every form runs K1 at
the main path's shape (b=256, m=4096, n=8192) under
``utils/profiling.trace``: the device ms per launch of the D round and of
each pass, medians of 10 calls. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sparse_solvers_tpu_torch.ops.cuda import build  # noqa: E402
from sparse_solvers_tpu_torch.ops.cuda import kernels as K1  # noqa: E402
from sparse_solvers_tpu_torch.utils import profiling  # noqa: E402

B, M, N = 256, 4096, 8192
MULTIPLY = "    for (int kk = 0; kk < TBK; kk += 16) {\n"
REFILL = "    if (kt + TSTAGES - 1 < nk) load_slice(kt + TSTAGES - 1);\n"
FORMS = {
    "as built": [],
    "copies only": [(MULTIPLY, MULTIPLY.replace("kk < TBK", "kk < 0"))],
    "multiply only": [(REFILL, "")],
    "6 stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 6;")],
    "BK 64": [("constexpr int BK = 32;", "constexpr int BK = 64;")],
}
WRONG = ("copies only", "multiply only")  # leave work out: values are wrong
PARTS = (("round", "round_to_bf16_kernel"),
         ("pass 1", "gemm_bf16_async_kernel<__nv_bfloat16, true, 128, 64, 32, 4, false>"),
         ("pass 2", "gemm_bf16_async_kernel<float, false, 128, 64, 32, 4, false>"))


def form_sources(name: str, edits) -> Path:
    """A copy of the kernel sources with `edits` made to the header."""
    out = ROOT / "build" / "k1_probe" / re.sub(r"\W+", "_", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    header = out / "tile_gemm.cuh"
    text = header.read_text()
    start = text.index("namespace ring {")
    end = text.index("}  // namespace ring")
    ring = text[start:end]
    for old, new in edits:
        if ring.count(old) != 1:
            raise RuntimeError(f"{name}: the edit target {old!r} is not "
                               "in the ring kernel once")
        ring = ring.replace(old, new)
    header.write_text(text[:start] + ring + text[end:])
    return out


def part_ms(A16, D, calls: int = 10) -> dict:
    """Median device ms per launch of each part of K1 over `calls` calls."""
    for _ in range(3):
        K1.normal_matvec_fused_bf16(A16, D)
    times = {name: [] for name, _ in PARTS}
    with profiling.trace() as prof:
        for _ in range(calls):
            K1.normal_matvec_fused_bf16(A16, D)
        torch.cuda.synchronize()
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, key in PARTS:
            if key in evt.name:
                times[name].append(evt.device_time_total / 1e3)
    return {name: float(np.median(t)) if t else float("nan")
            for name, t in times.items()}


def run_form(name: str, card: str) -> None:
    """Build the form, check it (as built only) and print its times."""
    build.CSRC = form_sources(name, FORMS[name])  # before the first load
    planner = K1.k1_launch_plan
    K1.k1_launch_plan = lambda b, m, n, aligned=True: planner(b, m, n, False)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    A = torch.randn(M, N, generator=g, device=dev)
    A16 = (A / A.norm(dim=0)).to(torch.bfloat16)
    D = torch.randn(B, N, generator=g, device=dev)
    want = K1.normal_matvec_fused_bf16_plain(A16, D)
    Q = K1.normal_matvec_fused_bf16(A16, D)
    torch.cuda.synchronize()
    err = float((Q - want).abs().max() / want.abs().max())
    if name not in WRONG and not err <= 1e-3:
        raise AssertionError(f"K1 {name}: max|err| / max|Q| = {err}")
    ms = part_ms(A16, D)
    flops = 2 * B * M * N  # one pass
    print(f"{name}: " + ", ".join(
        f"{part} {t:.4f} ms" + (f" ({flops / t / 1e9:.1f} TFLOP/s)"
                                if part != "round" else "")
        for part, t in ms.items())
        + f", sum {sum(ms.values()):.4f} ms; max|err|/max|Q| {err:.2e} "
        f"({build.library_path().name}) [{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k1_ring: torch sees no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    if len(sys.argv) == 3 and sys.argv[1] == "--form":
        run_form(sys.argv[2], card)
        return 0
    print(card, flush=True)
    # one process per form, so that each loads only its own library
    for name in FORMS:
        subprocess.run([sys.executable, __file__, "--form", name],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
