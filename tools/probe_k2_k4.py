"""What bounds K2 and K4 on the card: their launches timed across the launch
shapes their plans could pick, and in probe forms that change or leave out
one part of the kernel.

    python3 tools/probe_k2_k4.py

Each form, in a process of its own, is a copy of
``sparse_solvers_tpu_torch/csrc`` under ``build/k2_k4_probe/`` with edits to
``scan.cu`` or ``omp_insert.cu``, built and loaded in place of the package's
sources (the form ``as built`` has none). The C entries take their launch
numbers from the Python plans, so each form is launched directly at several
shapes:

  * K2 (``ss_find_max_gamma``) at b=256, n=8192, K=96 on ``chip_smoke.py``'s
    inputs, S CTAs per lane (a cluster) by threads per CTA;
  * K4 (``ss_omp_insert``) at b=256 at each OMP and gOMP tier on
    ``chip_smoke.py``'s inputs, by threads per lane, and (as built) in the
    device-memory instantiation.

Each line gives ``chip_smoke.time_ms`` (the median of 20 calls, each timed
by CUDA events behind a spin kernel) and the kernel's own device time under
``utils/profiling.trace`` (the median of 10 launches). The form ``as
built`` also holds every shape to the twin (K2 bit-identical; K4 deg exact,
inv and coef within 1e-5 of their scale), times K2 with its inputs evicted
from the L2 cache, and times one tiny kernel as the floor of a timed
launch. Forms that leave work out compute wrong values on purpose. Needs
one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sparse_solvers_tpu_torch.ops.cuda import build  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# form -> [(source, old, new)]; each old text must occur once
FORMS = {
    "as built": [],
    "K2 UNROLL 4": [("scan.cu", "constexpr int UNROLL = 2;",
                     "constexpr int UNROLL = 4;")],
    "K2 no divisions": [("scan.cu",
                         "const float tl = (ci - cv) / dl, tr = (ci + cv) / dr;",
                         "const float tl = (ci - cv) * dl, tr = (ci + cv) * dr;")],
    "K4 no staging": [("omp_insert.cu",
                       "for (int i = warp; i < E; i += warps)\n"
                       "      for (int g = ln; g < groups; g += 32)\n"
                       "        cp_async",
                       "for (int i = warp; i < 0; i += warps)\n"
                       "      for (int g = ln; g < groups; g += 32)\n"
                       "        cp_async")],
    "K4 no u2": [("omp_insert.cu", "for (int i = warp; i < L; i += warps) {",
                  "for (int i = warp; i < 0; i += warps) {")],
    "K4 no update": [("omp_insert.cu",
                      "for (int i = warp; i < X; i += warps) {",
                      "for (int i = warp; i < 0; i += warps) {")],
}
K2_SHAPES = [(1, 256), (2, 128), (2, 256), (4, 128), (4, 256), (8, 128)]
K4_THREADS = (128, 256, 512)


def form_sources(name: str, edits) -> Path:
    """A copy of the kernel sources with `edits` made."""
    out = ROOT / "build" / "k2_k4_probe" / re.sub(r"\W+", "_", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for source, old, new in edits:
        path = out / source
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the edit target {old!r} is not in "
                               f"{source} once")
        path.write_text(text.replace(old, new))
    return out


def run_form(name: str, card: str) -> None:
    from sparse_solvers_tpu_torch.ops.cuda import omp_insert as K4
    from sparse_solvers_tpu_torch.ops.cuda import scan as K2
    build.CSRC = form_sources(name, FORMS[name])  # before the first load
    checked = name == "as built"
    dev = torch.device("cuda", 0)
    lib = build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    b, n, K = smoke.BATCH, smoke.N, smoke.K_MAX
    tag = f"[{name}; {card}]"

    shipped = K2.scan_launch_plan(b, n)
    arrays, _ = smoke.scan_split_case(b, n, K, [n // 2])
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    gp, ip = K2.find_max_gamma_fused_plain(*args)
    gamma = torch.empty(b, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)

    def scan(splits, threads):
        chunk = -(-(-(-n // splits)) // 4) * 4
        return lambda: build.check(lib.ss_find_max_gamma(
            *(t.data_ptr() for t in args), gamma.data_ptr(), idx.data_ptr(),
            b, n, K, threads, splits, chunk, 4, stream), "K2 probe")

    for splits, threads in K2_SHAPES:
        fn = scan(splits, threads)
        fn()
        torch.cuda.synchronize()
        if checked:
            smoke.check(torch.equal(gamma, gp) and torch.equal(idx, ip),
                        f"K2 S={splits} threads={threads}: differs from twin")
        mark = (" (plan)" if (splits, threads) == (shipped.splits,
                                                   shipped.threads) else "")
        print(f"K2 b={b} n={n} K={K} S={splits} threads={threads}: "
              f"{smoke.time_ms(fn):.4f} ms, device "
              f"{smoke.device_ms(fn, 'gamma_scan'):.4f} ms{mark} {tag}", flush=True)
    if checked:
        flush = torch.empty(16 * 2**20, device=dev)
        fn = scan(shipped.splits, shipped.threads)
        cold = smoke.time_ms(fn, prepare=lambda: flush.fill_(1.0))
        print(f"K2 plan with its inputs evicted from L2 before each call: "
              f"{cold:.4f} ms {tag}", flush=True)
        tiny = torch.zeros(1, device=dev)
        print(f"one tiny kernel (a 1-element fill): "
              f"{smoke.time_ms(lambda: tiny.fill_(1.0)):.4f} ms, device "
              f"{smoke.device_ms(lambda: tiny.fill_(1.0), 'elementwise'):.4f} ms "
              f"{tag}",
              flush=True)

    for K in smoke.OMP_TIERS + smoke.GOMP_TIERS:
        base = [torch.from_numpy(a).to(dev)
                for a in smoke.omp_insert_case(b, K)]
        inv_p, coef_p, deg_p = K4.omp_insert_plain(*base)
        plan = K4.k4_launch_plan(b, K)
        inv = base[0].clone()
        coef = torch.empty((b, K), device=dev)
        deg = torch.empty(b, dtype=torch.bool, device=dev)
        shapes = [(threads, True, False) for threads in
                  sorted({*K4_THREADS, plan.threads})]
        if checked:
            shapes += [(plan.threads, False, False),
                       (plan.threads, True, True), (plan.threads, False, True)]
        for threads, shared, cold in shapes:
            smem = (plan.smem_bytes if shared == plan.shared else
                    plan.smem_bytes - 4 * K * K)

            def fn():
                build.check(lib.ss_omp_insert(
                    *(t.data_ptr() for t in (inv, *base[1:])),
                    coef.data_ptr(), deg.data_ptr(), b, K, threads,
                    int(shared), plan.vec, smem, stream), "K4 probe")

            inv.copy_(base[0])
            fn()
            torch.cuda.synchronize()
            if checked:
                ok = torch.equal(deg, deg_p)
                for got, want in ((inv, inv_p), (coef, coef_p)):
                    scale = max(1.0, float(want.abs().max()))
                    ok &= float((got - want).abs().max()) <= 1e-5 * scale
                smoke.check(ok, f"K4 K={K} threads={threads} shared="
                            f"{shared}: differs from twin")
            if cold:   # inv restored, then evicted from L2 by a 64 MB write
                flush = torch.empty(16 * 2**20, device=dev)
                ms = smoke.time_ms(fn, prepare=lambda: (inv.copy_(base[0]),
                                                        flush.fill_(1.0)))
                print(f"K4 b={b} K={K} threads={threads} "
                      f"{'shared' if shared else 'device memory'}, inv "
                      f"evicted from L2 before each call: {ms:.4f} ms {tag}",
                      flush=True)
                continue
            ms = smoke.time_ms(fn, prepare=lambda: inv.copy_(base[0]))
            dms = smoke.device_ms(fn, "omp_insert",
                                  prepare=lambda: inv.copy_(base[0]))
            mark = (" (plan)" if (threads, shared) == (plan.threads,
                                                       plan.shared) else "")
            print(f"K4 b={b} K={K} threads={threads} "
                  f"{'shared' if shared else 'device memory'}: {ms:.4f} ms, "
                  f"device {dms:.4f} ms{mark} {tag}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k2_k4: torch sees no CUDA device", file=sys.stderr)
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
