"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written Hopper kernels from ``sparse_solvers_tpu_torch/
csrc`` with nvcc and holds each against its plain PyTorch twin on the card
at the shapes of the main paths (K2 at each Homotopy tier, with ties
planted across its split chunks; K3 at each Homotopy tier, at 200 and
260 (its device-memory route), on both sides of its route threshold,
and on insert-only and remove-only mixes, with every vacant slot held at zero; K4 at each OMP and gOMP tier; K5 and K6 at b = 8, 64 and 256, at
"highest" and "default"; K1 and K2 also at the gram-free paths' shape,
m=2048, n=65536), each timed beside its bound, with its launch plan; K1's
line adds its TFLOP/s, its share of its bound, its factor against two
bf16 matmuls and its ring tile. Then it drives the main paths on a
4096x8192 f32 sensing matrix with k=64-sparse signals, tol 1e-2, each
timed and then profiled once (``utils/profiling.trace``: device ms per
hand kernel, K1's share, total device ms and wall ms):

  * ``Homotopy`` batch 256, k_max 96, 128 iterations, "certified" (the
    workload of ``bench.py``);
  * ``Omp`` batch 256, max_iterations 72, so k_max 72, "certified"
    (``benchmarks/bench_omp.py``), and ``Omp(picks=4)`` (gOMP),
    max_iterations 128, on the same problem;
  * the kernel roofline path of ``benchmarks/bench_kernels.py``: K5
    ``normal_matvec_fused`` and K6 ``residual_correlation_fused`` at
    b = 8, 64, 256 at both precisions, timed through
    ``utils/profiling.measure`` beside their twins and two-``matmul``
    library calls, with the roofline share, and each case's launch plan
    (tiles, splits) and the device time of each of its launches in one
    ``torch.profiler`` call;
  * the gram-free paths at 2048x65536 (k=16, batch 256, where AᵀA would
    take 16 GiB; ``benchmarks/bench_gram_free.py``): ``Homotopy(A,
    gram=False)``, 40 iterations, and ``Omp(A, gram=False)``, 24, both
    "certified", each timed and profiled as above, then its re-solve at
    "high" forced for every lane, with the peak of allocated device memory
    held below one n×n tensor;
  * the per-lane Homotopy core: certified single ``solve``s, an 8-lane
    sparse-regime ``solve_batch``, exact against fast mode, float64, and
    ``solve_path``;
  * the per-lane OMP core: certified single ``solve``s (timed), an 8-lane
    small-batch ``solve_batch``, ``gram=True``, exact against fast mode,
    float64 and a gOMP picks=4 ``solve``;

and checks that every lane is certified, recovers its true support, and
went through the kernels of its path (Homotopy K1, K2, K3; OMP K1, K4;
the roofline path K5, K6; the cores none), then small cross-device checks
of the port on the card against the port on the CPU. Then the IRLS
family, each phase one JSON line, with the launch counts read from 0 (the
loops run none of K1 to K6, as the JAX loops reach no ``pallas_call``):

  * ``Irls`` on ``benchmarks/bench_irls_batch.py``'s problem at 2048x1024
    and 4096x2048, batch 256: fast mode with the triangular solve and
    with the R⁻¹ product (``SS_IRLS_GEMM=1``), and exact mode at
    2048x1024, each timed (median of 5 fenced batches after a warm-up)
    with its iterations, spd failures, argmax recovery and peak device
    memory; the gemm and trsm forms agree lane for lane, exact and fast
    pick the same argmax, and 4 single solves match their batch lanes;
  * the stabilized loop on the benchmark's competing pairs (no spd
    failure, every leader found, a lane at the budget at the budget in
    float64 too) and the reference recurrence (spd on every lane);
  * the latency of one ``Irls.solve``;
  * ``IrlsCg`` on ``benchmarks/bench_irls_cg.py``'s 512x4096 and
    1024x65536 configurations: every planted support recovered, no
    breakdown;
  * one profiled batch of fast IRLS and of CG-IRLS at 1024x65536 (device
    time, busy share, top device operations), and cross-device checks.

Then CoSaMP and the C++ host engine, each phase one JSON line with the
card's name and power limit:

  * ``Cosamp(A, 64)`` on the OMP workload (``make_sparse_problem(4096,
    8192, 64, 256, seed=0)``) and ``Cosamp(A, 16)`` at the gram-free shape
    (2048x65536), "highest", tol 1e-2, 20 rounds, through
    ``solve_batch_on_device``: every lane within the tolerance, the top-k
    support exact on every lane, the error against a float64 host
    recompute on 16 lanes, K1 to K6 launched 0 times; the median of 5
    fenced batches with its quartiles, the rounds, the peak device memory
    (below one n×n f32 tensor at 2048x65536), and one profiled batch
    (device ms, busy share, top device operations by time and by count);
  * the host engine (``backend/native.py``, built from ``csrc/`` by g++):
    its build seconds and ``blas_info()``, then at problems of at most 2¹⁶
    elements (128x512 ``Homotopy``, ``Omp`` picks 1 and 4, ``IrlsCg``;
    256x128 ``Irls``, 64 lanes) "auto" plans the torch route on a card
    façade and the host engine on a CPU façade, engine="native" on a card
    façade matches the torch route on the card with equal supports, K1 to
    K6 are launched 0 times on the native calls, and the median latency
    of one ``solve``
    and of one 64-lane ``solve_batch`` on each route. The phase fails if
    the library does not build or load.

Then the mesh phase, each route one JSON line with the card's name and
power limit: a one-rank NCCL process group on the card
(``parallel.distributed.initialize`` through a file store, then
``make_mesh(1, 1)``), and each façade's ``mesh=`` route against its plain
route at the sizes of its earlier phase: ``Homotopy`` (K1, K2, K3) and
``Omp`` (K1, K4) certified at 4096x8192, both gram-free at 2048x65536,
the per-lane route of ``homotopy_sharded`` (``batch_native=False``) on 8
lanes, ``Irls`` at 2048x1024 (the plain route given the mesh's
CholeskyQR2 factors), ``IrlsCg`` at 1024x65536 and ``Cosamp`` at
4096x8192. Each compares iterations and X (bit-equal is expected: a
one-rank all-reduce or gather is a copy; a route that is not says so),
requires K1 to K4's launches equal on both routes and nonzero exactly
where the path has the kernel, reports the collectives of one solve
(``ops/collectives.counts``: all-reduces and gathers with their bytes),
checks every lane (certified with the true support; IRLS argmax recovery
equal on both; CG-IRLS supports, no breakdown) and times 5 fenced
batches of each. The group is destroyed at the end; the mesh routes' launches join
the JSON line's.

Last, the examples phase (``examples_torch/``), each run one JSON line with
its wall seconds, its launches and the card's name and power limit: the
six single-process examples' ``main()`` on the card at their defaults, and
``batch_recovery`` and ``greedy_pursuit`` again at 4096 8192 64 256 (the
main path's width, through their own arguments). Each run counts its
launches from 0 and requires exactly the kernels its plans name (a
Homotopy driver K1, K2, K3; an OMP driver K1, K4; and those at full
width), every route on the card, and its numbers: every support
recovered, 0 failed certificates, the probe's column 7, the lasso path's
KKT identity and its true support. Then ``sharded_recovery.py`` under
``torch.distributed.run --standalone --nproc-per-node=1`` (one NCCL rank
on the card, its own process, killed past a time limit): exit code 0 and
every "matches" flag True. The in-process runs' launches join the JSON
line's.

Any failed check raises, so the script exits non-zero and never prints
its last line. Needs one CUDA card; imports nothing of JAX.

Output: phases on earlier lines, then one JSON line of per-kernel results
(each with its bound: the larger of its bytes over 3.35 TB/s and its
operations over the H100's peak for their type; launches summed over
every path), then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
import warnings

from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the seeded numpy cases the card tests use (numpy only, no jax)
sys.path.insert(0, str(ROOT / "tests"))
from _torch_cases import (make_problem, make_sparse_problem,  # noqa: E402
                          omp_insert_case, scan_split_case, transition_mix,
                          vacant_nonzero)

M, N, K_SPARSE, BATCH = 4096, 8192, 64, 256
TOL, K_MAX, MAX_ITER = 1e-2, 96, 128
OMP_MAX_ITER, GOMP_MAX_ITER, GOMP_PICKS = 72, 128, 4
# the gram-free paths: (m, n, k) and iteration budgets of benchmarks/
# bench_gram_free.py:81-86 (Homotopy) and bench_omp.py:60-64 (OMP, --large)
GF_SHAPE = (2048, 65536, 16)
GF_MAX_ITER, GF_OMP_MAX_ITER = 40, 24
FUSED_BATCHES, FUSED_PRECISIONS = (8, 64, 256), ("highest", "default")
# the capacity tiers of the main paths (solvers/homotopy_batch.py::
# _plan_tiers): K2 on Homotopy's, K4 on OMP's and gOMP's
SCAN_TIERS = (24, 48, K_MAX)
# K3: the Homotopy tiers, the device-memory route, and the capacities on
# each side of the route threshold (ops/cuda/transition.py::
# k3_launch_plan); the mixes of its separate timings
K3_CAPACITIES = SCAN_TIERS + (200, 260)
K3_THRESHOLDS = (128, 129)
K3_MIX_CAPACITIES = (K_MAX, 200, 260)
OMP_TIERS, GOMP_TIERS = (24, 40, OMP_MAX_ITER), (32, 64, GOMP_MAX_ITER)
# the (b, precision) of K5's and K6's entries in the JSON line; the phase
# lines give every case
FUSED_REPORTED = (64, "highest")
HOMOTOPY_KERNELS = ("normal_matvec_fused_bf16", "find_max_gamma_fused",
                    "transition")
OMP_KERNELS = ("normal_matvec_fused_bf16", "omp_insert")
FUSED_KERNELS = ("normal_matvec_fused", "residual_correlation_fused")
HBM_BYTES_PER_S = 3.35e12
# the IRLS workloads of benchmarks/bench_irls_batch.py:60-72 (batch, tol,
# iterations; exact mode at the first shape only) and :105-125 (the
# competing-pair signals, tol 0.3, 60 iterations), and bench_irls_cg.py:
# 96-101 ((m, n, k, batch, outer iterations, CG steps), tol 1e-3)
IRLS_SHAPES, IRLS_BATCH, IRLS_TOL, IRLS_MAX_ITER = ((2048, 1024),
                                                    (4096, 2048)), 256, 1e-3, 50
STAB_TOL, STAB_MAX_ITER = 0.3, 60
CG_CONFIGS = ((512, 4096, 16, 64, 30, 96), (1024, 65536, 24, 32, 25, 96))
CG_TOL = 1e-3
# CoSaMP on the OMP workload and at the gram-free shape (m, n, k), batch
# 256, seed 0, "highest", tol 1e-2, 20 rounds
COSAMP_SHAPES, COSAMP_TOL, COSAMP_ROUNDS = ((M, N, K_SPARSE),
                                            GF_SHAPE), 1e-2, 20
# the host engine: problems of at most 2¹⁶ elements, which a CPU façade's
# "auto" routes to it: (family, m, n, k, tol, iterations); 64 lanes each
HOST_CASES = (("homotopy", 128, 512, 8, 1e-3, 64),
              ("omp", 128, 512, 8, 1e-3, 32),
              ("gomp", 128, 512, 8, 1e-3, 32),
              ("irls_cg", 128, 512, 8, 1e-5, 60),
              ("irls", 256, 128, 1, 1e-3, 50))
HOST_BATCH = 64


def bound(flops: float, nbytes: float, peak_flops: float):
    """(bound_ms, bound_by): the least time the H100 could take for this
    work, the larger of its bytes over the memory rate and its operations
    over their peak rate (NVIDIA's data sheet, SXM, dense)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def result(err, ms, plain, library, bound_ms, bound_by):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": library, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, prepare=None, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call, from CUDA events around
    each call; ``prepare()`` (untimed) runs before every call. A spin
    kernel of a few ms is queued ahead of each timed call, so the host has
    queued the call and its closing event before the card reaches them:
    the events then time the device work, not the Python launch path."""
    for _ in range(warmup):
        if prepare:
            prepare()
        fn()
    pairs = []
    for _ in range(reps):
        if prepare:
            prepare()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def device_ms(fn, keys, prepare=None, calls: int = 10) -> float:
    """Median device ms of the kernel whose name holds one of ``keys`` over
    ``calls`` calls of ``fn`` under ``utils/profiling.trace`` (``prepare``,
    whose kernels are not counted, runs before each): the kernel's own
    time, without the few µs a pair of CUDA events adds around one launch.
    NaN where the profiler kept no such kernel."""
    from sparse_solvers_tpu_torch.utils import profiling
    keys = (keys,) if isinstance(keys, str) else tuple(keys)
    for _ in range(3):
        if prepare:
            prepare()
        fn()
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        for _ in range(calls):
            if prepare:
                prepare()
            fn()
        torch.cuda.synchronize()
    times = [e.device_time_total / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(k in e.name for k in keys)]
    return float(np.median(times)) if times else float("nan")


def check_k1(dev, card, m=M, n=N):
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    g = torch.Generator(device=dev).manual_seed(1)
    A = torch.randn(m, n, generator=g, device=dev)
    A16 = (A / A.norm(dim=0)).to(torch.bfloat16)
    del A
    D = torch.randn(BATCH, n, generator=g, device=dev)
    Q = K1.normal_matvec_fused_bf16(A16, D)
    Qp = K1.normal_matvec_fused_bf16_plain(A16, D)
    torch.cuda.synchronize()
    err = float((Q - Qp).abs().max())
    # An element of P = bf16(D·A16ᵀ) may land on the neighbouring bf16
    # value (relative step 2^-8) when the fp32 sums run in another order;
    # each such flip moves a Q element by about 2^-8·|P_i|·|A_ij|, so
    # 1e-3·max|Q| leaves room for many flips per row.
    limit = 1e-3 * float(Qp.abs().max())
    check(bool(torch.isfinite(Q).all()), "K1: non-finite output")
    check(err <= limit, f"K1: max |Q - twin| = {err} > {limit}")
    check(torch.equal(Q, K1.normal_matvec_fused_bf16(A16, D)),
          "K1: two runs on the same inputs differ (it uses no atomics and "
          "sums split ranges in a fixed order, so each output is one "
          "fixed-order sum)")
    ms = time_ms(lambda: K1.normal_matvec_fused_bf16(A16, D))
    plain = time_ms(lambda: K1.normal_matvec_fused_bf16_plain(A16, D))
    # the library yardstick: two bf16 cuBLAS products, P = D16·A16ᵀ then
    # P·A16; Q comes out rounded to bf16, so it is not the same function
    D16 = D.to(torch.bfloat16)
    library = time_ms(lambda: torch.matmul(torch.matmul(D16, A16.T), A16))
    # A16 read once, D read, Q written; 4·b·m·n bf16 tensor-core operations
    flops = 4 * BATCH * m * n
    b_ms, b_by = bound(flops, m * n * 2 + 2 * BATCH * n * 4, 989e12)
    plan = K1.k1_launch_plan(BATCH, m, n)
    check(plan.route == "wgmma", f"K1 at {m}x{n} plans the {plan.route} "
          "route, not TMA -> wgmma")
    phase(f"K1 normal_matvec_fused_bf16 b={BATCH} m={m} n={n}: max|err| "
          f"{err:.3e} <= {limit:.3e} (1e-3*max|Q|), repeat run "
          f"bit-identical; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s, {100 * b_ms / ms:.1f}% of its bound, "
          f"{ms / library:.2f}x the two bf16 matmuls), twin {plain:.4f} ms, "
          f"two bf16 matmuls {library:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
          f"{plan.route} route, tiles {'x'.join(map(str, plan.tile))} and "
          f"{'x'.join(map(str, plan.tile2))}, pass 1 in {plan.splits} "
          f"range(s) of {plan.chunk}, {plan.kernels} launches, "
          f"{plan.stages} stages, {plan.threads} threads, {plan.smem_bytes} "
          f"B shared, grids {plan.grid1} and {plan.grid2} [{card}]")
    return result(err, ms, plain, library, b_ms, b_by)


def check_k2(dev, card, K, n=N):
    """K2 at b=256 and n positions with K active slots: bit-identical to
    its twin, ties planted across every chunk boundary of its split plan
    and a lane with no valid candidate."""
    from sparse_solvers_tpu_torch.ops.cuda import scan as K2
    b = BATCH
    plan = K2.scan_launch_plan(b, n)
    bounds = [lo for lo, _ in plan.chunks(n)[1:]]
    arrays, expected = scan_split_case(b, n, K, bounds)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    gam, idx = K2.find_max_gamma_fused(*args)
    gp, ip = K2.find_max_gamma_fused_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(idx, ip), "K2: idx differs from the twin")
    check(torch.equal(gam, gp), "K2: gamma not bit-identical to the twin")
    got = {lane: int(idx[lane]) for lane in expected}
    check(got == expected, f"K2: planted lanes gave {got}, not {expected}")
    check(float(gam[b - 1]) == float(np.finfo(np.float32).max),
          "K2: no-candidate lane must give FLT_MAX")
    err = float((gam - gp).abs().max())
    ms = time_ms(lambda: K2.find_max_gamma_fused(*args))
    dms = device_ms(lambda: K2.find_max_gamma_fused(*args),
                    DEVICE_KERNELS[K2.NAME])
    plain = time_ms(lambda: K2.find_max_gamma_fused_plain(*args))
    # every input read once (q, c f32; mask int8; c_inf; the slot vectors),
    # gamma and idx written; about 12 fp32 operations per position
    nbytes = sum(t.numel() * t.element_size() for t in args) + 8 * b
    b_ms, b_by = bound(12 * b * (n + K), nbytes, 67e12)
    phase(f"K2 find_max_gamma_fused b={b} n={n} K={K}: idx exact, gamma "
          f"bit-exact, ties planted across the chunk boundaries {bounds} "
          f"resolved {sorted(got.items())}; kernel {ms:.4f} ms (its own "
          f"device time {dms:.4f} ms), twin "
          f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
          f"{nbytes / 1e6:.1f} MB), {100 * b_ms / ms:.1f}% of its bound; "
          f"plan: S = {plan.splits} CTAs per lane in a cluster, grid "
          f"{plan.grid}, {plan.threads} threads, chunk {plan.chunk}, "
          f"{plan.vec} positions a load [{card}]")
    return result(err, ms, plain, None, b_ms, b_by)


def k3_bounds(base, deg):
    """K3's two bounds on these lanes: ((bound_ms, bound_by), MB) of the
    least bytes any kernel must move for them, and the same for the
    formula earlier runs used. The tighter: each live lane reads its kk×kk
    blocks of inv and gk (a degenerate insert only inv's) and x, d and
    c_act (u1 too on an insert, indices on a remove, to find p); an
    insert writes inv's (kk+1)² block, gk's border row and column
    (2kk+1), x over kk slots (slot kk stays 0), d and c_act through slot
    kk and one index; a remove writes inv's kk² block, gk's rows and
    columns p and l (4kk−4 entries, 2kk−1 when p = l), x, d and c_act
    over kk slots and the indices at p and l (l alone when p = l); a lane
    that neither inserts nor removes writes x, d and c_act only; 24 bytes
    of per-lane scalars a live lane, 2 an inert one. Operations: 2kk² a matvec, 3 an
    updated entry. The earlier formula: 3kk² + 2kk′² + 12kk floats a live
    lane and 40 bytes a lane, 8kk² operations."""
    a = [t.cpu().numpy() for t in base]
    ind, idx, kk = a[5], a[7], a[8].astype(np.int64)
    live, doins, dorm = a[12], a[13], a[14]
    deg = deg.cpu().numpy()
    nbytes = flops = 0
    for lane, L in enumerate(kk):
        if not live[lane]:
            nbytes += 2
            continue
        nbytes += 24 + 4 * L * L
        flops += 2 * L * L
        if deg[lane]:
            nbytes += 4 * L
            continue
        nbytes += 4 * L * L + 12 * L
        flops += 2 * L * L
        if doins[lane]:
            E = L + 1
            nbytes += 4 * (L + E * E + 2 * L + 1 + L + 2 * E + 1)
            flops += 5 * E * E
        elif dorm[lane]:
            p = int(np.flatnonzero(ind[lane, :L] == idx[lane])[0])
            border = 4 * L - 4 if p != L - 1 else 2 * L - 1
            nbytes += 4 * (L + L * L + border + 3 * L
                           + (2 if p != L - 1 else 1))
            flops += 5 * L * L
        else:
            nbytes += 12 * L
            flops += 2 * L * L
    k_new = np.where(doins, kk + 1, kk - 1)
    k_new = np.where((doins | dorm) & ~deg & live, k_new, 0)
    kl = np.where(live, kk, 0)
    old_bytes = 4 * int((3 * kl ** 2 + 2 * k_new ** 2 + 12 * kl).sum()) \
        + 40 * len(kk)
    return ((bound(flops, nbytes, 67e12), nbytes / 1e6),
            (bound(8 * int((kl ** 2).sum()), old_bytes, 67e12),
             old_bytes / 1e6))


def check_k3(dev, card, K, mix="all"):
    """K3 at b=256, capacity K, on ``transition_mix``'s lanes (``mix``
    "all": inserts, removals at p != l and p == l, frozen lanes and a
    planted degenerate insert; "insert" or "remove": every lane does
    that): indices and deg exact, frozen and degenerate lanes
    bit-identical, every vacant slot after the call exactly zero (the
    sentinel in indices), floats within 1e-5 of each tensor's scale.
    Timed (CUDA events and the profiler's device time) beside its twin
    and both bounds (``k3_bounds``), with its launch plan."""
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    b, n = BATCH, N
    tol = 0.01
    plan = K3.k3_launch_plan(K)
    base = [torch.from_numpy(a).to(dev)
            for a in transition_mix(b, K, n, mix=mix)]
    work = [t.clone() for t in base]
    deg = K3.transition(*work, tol, n)
    ref = K3.transition_plain(*base, tol, n)
    torch.cuda.synchronize()
    live, doins, dorm = base[12], base[13], base[14]
    check(torch.equal(work[5], ref[5]), "K3: indices differ from the twin")
    check(torch.equal(deg, ref[6]), "K3: deg differs from the twin")
    if mix == "all":
        check(bool(deg[1]) and int(deg.sum()) == 1,
              "K3: exactly the planted degenerate insert must flag deg")
    for t, t0 in zip(work[:6], base[:6]):
        check(torch.equal(t[~live | deg], t0[~live | deg]),
              "K3: frozen or degenerate lanes not bit-identical")
    kk = base[8].long()
    kk1 = torch.where(dorm & live, kk - 1,
                      torch.where(doins & live & ~deg, kk + 1, kk))
    bad = vacant_nonzero([t.cpu().numpy() for t in work[:6]],
                         kk1.cpu().numpy(), n)
    check(not bad, f"K3: vacant slots not zero (lane, tensor): {bad[:8]}")
    err = 0.0
    for name, got, want in zip(("inv", "gk", "x_act", "d_act", "c_act"),
                               work[:5], ref[:5]):
        e = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        check(e <= 1e-5 * scale,
              f"K3: {name} max |err| {e} > 1e-5 * {scale}")
        err = max(err, e)

    def restore():
        for t, t0 in zip(work, base):
            t.copy_(t0)

    ms = time_ms(lambda: K3.transition(*work, tol, n), prepare=restore)
    dms = device_ms(lambda: K3.transition(*work, tol, n),
                    DEVICE_KERNELS[K3.NAME], prepare=restore)
    plain = time_ms(lambda: K3.transition_plain(*base, tol, n))
    counts = {"insert": int((doins & ~deg).sum()),
              "remove": int(dorm.sum()), "frozen": int((~live).sum()),
              "degenerate": int(deg.sum())}
    ((b_ms, b_by), mb), ((o_ms, o_by), o_mb) = k3_bounds(base, deg)
    tile = (f", a thread's tile {4 * plan.cols}x{plan.cols}"
            if plan.route == "registers" else "")
    phase(f"K3 transition b={b} K={K} mix={mix}: indices and deg exact, "
          f"frozen and degenerate lanes bit-identical, vacant slots zero, "
          f"floats within 1e-5 relative (max|err| {err:.3e}); lanes "
          f"{counts}; kernel {ms:.4f} ms (its own device time {dms:.4f} "
          f"ms), twin {plain:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
          f"{mb:.2f} MB; {100 * b_ms / ms:.1f}% of it in the event time, "
          f"{100 * b_ms / dms:.1f}% in the device time) [earlier formula "
          f"{o_ms:.4f} ms, {o_by}, {o_mb:.2f} MB]; plan: route "
          f"{plan.route}{tile}, {plan.threads} threads, {plan.vec} floats "
          f"a gk load, {plan.smem_bytes} B shared"
          f"{', workspace' if plan.work_floats else ''} [{card}]")
    return result(err, ms, plain, None, float(b_ms), b_by)


def k3_phases(dev, card):
    """check_k3 at each capacity of K3_CAPACITIES and K3_THRESHOLDS, and
    on insert-only and remove-only mixes at K3_MIX_CAPACITIES. The JSON
    line keeps the main path's top tier (K=96, mix "all") with the
    largest error of every phase; its bound_ms is the tighter of
    ``k3_bounds``' two (the earlier formula's stands on the phase line)."""
    res = {K: check_k3(dev, card, K) for K in K3_CAPACITIES + K3_THRESHOLDS}
    errs = [r["max_abs_err"] for r in res.values()]
    for K in K3_MIX_CAPACITIES:
        for mix in ("insert", "remove"):
            errs.append(check_k3(dev, card, K, mix)["max_abs_err"])
        torch.cuda.empty_cache()
    return dict(res[K_MAX], max_abs_err=max(errs))


def check_k4(dev, card, K):
    from sparse_solvers_tpu_torch.ops.cuda import omp_insert as K4
    b = BATCH
    base = [torch.from_numpy(a).to(dev) for a in omp_insert_case(b, K)]
    inv = base[0].clone()
    coef, deg = K4.omp_insert(inv, *base[1:])
    inv_p, coef_p, deg_p = K4.omp_insert_plain(*base)
    torch.cuda.synchronize()
    check(torch.equal(deg, deg_p), "K4: deg differs from the twin")
    check(bool(deg[1]) and int(deg.sum()) == 1,
          "K4: exactly the planted degenerate insert must flag deg")
    gated = base[5] & ~deg
    check(torch.equal(inv[~gated], base[0][~gated]),
          "K4: lanes that are not gated must keep their inverse bit for bit")
    err = 0.0
    for name, got, want in (("inv", inv, inv_p), ("coef", coef, coef_p)):
        e = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        check(e <= 1e-5 * scale, f"K4: {name} max |err| {e} > 1e-5 * {scale}")
        err = max(err, e)
    ms = time_ms(lambda: K4.omp_insert(inv, *base[1:]),
                 prepare=lambda: inv.copy_(base[0]))
    dms = device_ms(lambda: K4.omp_insert(inv, *base[1:]),
                    DEVICE_KERNELS[K4.NAME],
                    prepare=lambda: inv.copy_(base[0]))
    plain = time_ms(lambda: K4.omp_insert_plain(*base))
    # what these lanes need: every lane reads its k×k inverse (u2 and its
    # coef come from it), a gated lane writes it at (k+1)×(k+1); u1, b_act
    # read and coef written; about 6·k² operations per lane
    kk = base[2].long().cpu()
    kg = torch.where(gated.cpu(), kk + 1, torch.zeros_like(kk))
    nbytes = 4 * int((kk ** 2 + kg ** 2).sum() + 3 * b * K) + 12 * b
    b_ms, b_by = bound(6 * int((kk ** 2).sum()), nbytes, 67e12)
    plan = K4.k4_launch_plan(b, K)
    where = "shared memory" if plan.shared else "device memory"
    phase(f"K4 omp_insert b={b} K={K}: deg exact, lanes not gated "
          f"bit-identical, floats within 1e-5 relative (max|err| "
          f"{err:.3e}); lanes gated {int(gated.sum())}, frozen "
          f"{int((~base[5]).sum())}, degenerate {int(deg.sum())}; kernel "
          f"{ms:.4f} ms (its own device time {dms:.4f} ms), twin "
          f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{100 * b_ms / ms:.1f}% of its bound; plan: a block of "
          f"{plan.threads} threads a lane (a warp per "
          f"{K4.K4_ROWS_PER_WARP} rows), "
          f"{plan.vec} columns a load, live block in {where}, "
          f"{plan.smem_bytes} B shared [{card}]")
    return result(err, ms, plain, None, b_ms, b_by)


def fused_case(dev, b):
    """K5's and K6's inputs at the kernel bench's shape (m=4096, n=8192):
    A, D (the X of K6) and Y, seeded on the card."""
    g = torch.Generator(device=dev).manual_seed(5 + b)
    A = torch.randn(M, N, generator=g, device=dev) / M ** 0.5
    D = torch.randn(b, N, generator=g, device=dev)
    Y = torch.randn(b, M, generator=g, device=dev)
    return A, D, Y


def fused_calls(A, D, Y):
    """{name: (kernel, twin, library)} for K5 and K6 on these inputs; the
    library yardstick is two torch.matmuls at the scope's precision (bf16
    cuBLAS on operands rounded beforehand at "default")."""
    from sparse_solvers_tpu_torch.ops import blas
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K
    if blas.current_precision() == "default":
        A16, D16 = A.to(torch.bfloat16), D.to(torch.bfloat16)
        Y16 = Y.to(torch.bfloat16)
        lib5 = lambda: torch.matmul(torch.matmul(D16, A16.T), A16)
        lib6 = lambda: torch.matmul(Y16 - torch.matmul(D16, A16.T), A16)
    else:
        lib5 = lambda: torch.matmul(torch.matmul(D, A.T), A)
        lib6 = lambda: torch.matmul(Y - torch.matmul(D, A.T), A)
    return {
        "normal_matvec_fused": (
            lambda: K.normal_matvec_fused(A, D),
            lambda: K.normal_matvec_fused_plain(A, D), lib5),
        "residual_correlation_fused": (
            lambda: K.residual_correlation_fused(A, D, Y),
            lambda: K.residual_correlation_fused_plain(A, D, Y), lib6),
    }


def check_k5_k6(dev, card):
    """K5 and K6 against their twins at every b and precision: 1e-5 of
    max|ref| at "highest" (fp32 sums in another order), 1e-3 at "default"
    (an element of the bf16 intermediate may land on the neighbouring bf16
    value, as for K1); repeat runs bit-identical. Returns the largest
    error per kernel."""
    from sparse_solvers_tpu_torch.ops import blas
    errs = dict.fromkeys(FUSED_KERNELS, 0.0)
    for b in FUSED_BATCHES:
        A, D, Y = fused_case(dev, b)
        for prec in FUSED_PRECISIONS:
            rel = 1e-5 if prec == "highest" else 1e-3
            with blas.precision_scope(prec):
                for name, (kern, twin, _) in fused_calls(A, D, Y).items():
                    got, want = kern(), twin()
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(got).all()),
                          f"{name}: non-finite output")
                    err = float((got - want).abs().max())
                    lim = rel * float(want.abs().max())
                    check(err <= lim, f"{name} b={b} {prec}: max|err| "
                          f"{err} > {lim}")
                    check(torch.equal(got, kern()),
                          f"{name} b={b} {prec}: two runs differ")
                    errs[name] = max(errs[name], err)
                    phase(f"{name} b={b} m={M} n={N} {prec}: max|err| "
                          f"{err:.3e} <= {lim:.3e} ({rel:g}*max|ref|), "
                          f"repeat run bit-identical")
    return errs


def short_kernel_name(name: str) -> str:
    """A device kernel's name without its return type, namespaces and
    argument list: ``gemm_f32_async_kernel<64, true>``."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return re.sub(r"^void |\w+::", "", name)


# profiled calls per trace that must see every launch of a call
PROFILER_TRIES = 3


def launch_times(fn):
    """Each device kernel of one ``fn()`` call under ``profiling.trace``,
    in launch order: [(short name, device ms)]. A spin kernel goes first
    (the trace can miss the first kernel it sees) and is left out."""
    from sparse_solvers_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        torch.cuda._sleep(1_000_000)
        fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin" not in e.name),
                  key=lambda e: e.time_range.start)
    return [(short_kernel_name(e.name), e.device_time_total / 1e3)
            for e in evts]


def fused_plan_line(name, b, prec, fn, card):
    """K5's or K6's launch plan at (b, m=M, n=N, prec) and the device time
    of each of its launches in one profiled call. A trace that holds fewer
    device kernels than the plan makes (the profiler can drop a short
    session's records) is taken again, up to ``PROFILER_TRIES`` calls in
    all; if none holds them all, the line says so and gives no times.
    Fails if a trace holds a kernel the plan does not make."""
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K
    plan = K.fused_launch_plan(b, M, N, prec)
    s1, s2 = plan.splits
    # "default" rounds A and the batch operand in one launch and always
    # sums pass 1's partials (that sum rounds T); a split pass adds its sum
    want = 2 + (s2 > 1) + (2 if plan.ring == "bf16" else (s1 > 1))
    parts = (("round_to_bf16_kernel", "gemm_bf16_async_kernel")
             if plan.ring == "bf16" else ("gemm_f32_async_kernel",))
    parts += ("sum_splits_kernel",)
    seen = []
    for _ in range(PROFILER_TRIES):
        times = launch_times(fn)
        seen.append(len(times))
        check(len(times) <= want
              and all(any(p in k for p in parts) for k, _ in times),
              f"{name} b={b} {prec}: the profiler saw device kernels that "
              f"the plan ({want} launches of {parts}) does not make: {times}")
        if len(times) == want:
            break
    if len(times) == want:
        per = ", ".join(f"{k} {ms:.4f}" for k, ms in times)
        timed = (f"device ms per launch: {per} (sum "
                 f"{sum(ms for _, ms in times):.4f})")
    else:
        timed = "device ms per launch not measured"
    thread = ("" if plan.thread_tile is None else
              f", {'x'.join(map(str, plan.thread_tile))} per thread")
    phase(f"{name} b={b} {prec} plan: {plan.ring} ring, tile "
          f"{'x'.join(map(str, plan.tile))}{thread}, {plan.stages} stages, "
          f"{plan.threads} threads, {plan.smem_bytes} B shared, S = {s1} "
          f"and {s2}, grids {plan.grid1} and {plan.grid2}; profiled calls "
          f"saw {seen} of the plan's {want} device kernels; {timed} "
          f"[{card}]")


def fused_roofline_path(dev, card):
    """The kernel roofline path (benchmarks/bench_kernels.py:53-88): K5
    and K6 timed through ``profiling.measure`` at every b and precision,
    beside their twins and the library calls, with the roofline share, and
    each case's launch plan and the device time of each launch. Returns
    {name: {(b, precision): (ms, twin_ms, library_ms, bound_ms,
    bound_by)}}."""
    from sparse_solvers_tpu_torch.ops import blas
    from sparse_solvers_tpu_torch.utils import profiling
    chip = profiling.detect_chip() or profiling.CHIPS["h100"]
    out = {name: {} for name in FUSED_KERNELS}
    for b in FUSED_BATCHES:
        A, D, Y = fused_case(dev, b)
        for prec in FUSED_PRECISIONS:
            with blas.precision_scope(prec):
                for name, fns in fused_calls(A, D, Y).items():
                    # each input read once, the output written once
                    nbytes = 4 * (M * N + 2 * b * N
                                  + (b * M if name != FUSED_KERNELS[0]
                                     else 0))
                    flops = 4 * b * M * N
                    rs = [profiling.measure(fn, flops=flops, bytes=nbytes,
                                            reps=10) for fn in fns]
                    b_s = chip.bound_seconds(flops, nbytes, prec)
                    by = ("bytes" if nbytes / (chip.hbm_gbps * 1e9)
                          >= flops / (chip.peak_tflops(prec) * 1e12)
                          else "operations")
                    ms = [r.seconds * 1e3 for r in rs]
                    out[name][(b, prec)] = (*ms, b_s * 1e3, by)
                    phase(f"{name} b={b} {prec} (profiling.measure, 10 "
                          f"launches): kernel {ms[0]:.4f} ms "
                          f"({rs[0].tflops:.2f} TFLOP/s, {rs[0].gbps:.0f} "
                          f"GB/s, {100 * rs[0].fraction_of_peak(prec):.1f}% "
                          f"of the {chip.name} roofline), twin "
                          f"{ms[1]:.4f} ms, two matmuls {ms[2]:.4f} ms, "
                          f"bound {b_s * 1e3:.4f} ms ({by}) [{card}]")
                    fused_plan_line(name, b, prec, fns[0], card)
    return out


def core_paths(dev, card):
    """The per-lane Homotopy core at full width on bench.py's problem
    (``make_problem``, 4096x8192, k=64), each phase with the launch
    counts read from 0: the core runs no kernel of K1 to K6."""
    from sparse_solvers_tpu_torch import Homotopy
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y = make_problem(M, N, K_SPARSE, 8)
    sups = true_supports()

    def no_launches(what):
        check(not any(dispatch.launches.values()),
              f"{what} launched {dispatch.launches}")

    # certified single solves on 4 lanes, then 10 fenced timed runs
    solver = Homotopy(A, precision="certified", device=dev)
    solver.solve(Y[0], TOL)                     # the Gram, once
    dispatch.reset_launches()
    for lane in range(4):
        x, rep = solver.solve(Y[lane], TOL)
        xh = x.cpu().numpy()
        check(rep.solution_error <= TOL,
              f"core solve lane {lane}: certificate {rep.solution_error}")
        top = set(np.argsort(-np.abs(xh))[:K_SPARSE].tolist())
        check(top == sups[lane], f"core solve lane {lane}: support wrong")
    no_launches("core solve")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rep = solver.solve(Y[0], TOL)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    phase(f"core solve {M}x{N} k={K_SPARSE} certified: 4/4 lanes "
          f"certified, top-{K_SPARSE} support exact; {rep.iter} iterations; "
          f"median {med * 1e3:.3f} ms per solve over 10 fenced runs "
          f"(quartiles {q1 * 1e3:.3f}, {q3 * 1e3:.3f}); launches 0 [{card}]")

    # an 8-lane batch in the sparse-matvec regime: the batched core
    batched = Homotopy(A, k_max=K_MAX, precision="certified", device=dev)
    plan = batched.explain(batch=8, max_iterations=MAX_ITER)
    check(plan["formulation"].startswith("batched while-loop core")
          and plan["sparse_matvec"] and plan["kernels"] == {},
          f"8-lane plan {plan}")
    dispatch.reset_launches()
    t0 = time.perf_counter()
    X, rep = batched.solve_batch(Y[:8], TOL, MAX_ITER)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    no_launches("8-lane core batch")
    Xh, errs = X.cpu().numpy(), rep.solution_error.cpu().numpy()
    check(bool((errs <= TOL).all()), f"8-lane core batch: errors {errs}")
    for lane in range(8):
        top = set(np.argsort(-np.abs(Xh[lane]))[:K_SPARSE].tolist())
        check(top == sups[lane], f"8-lane core batch: lane {lane} support")
    phase(f"core solve_batch 8 lanes k_max {K_MAX}: plan "
          f"'{plan['formulation']}', 8/8 certified (max {errs.max():.3e}), "
          f"supports exact, {dt * 1e3:.1f} ms (first call), launches 0")

    # exact against fast mode at "highest" on one lane
    dispatch.reset_launches()
    outs = {mode: Homotopy(A, mode=mode, precision="highest",
                           device=dev).solve(Y[1], TOL)
            for mode in ("fast", "exact")}
    no_launches("exact/fast solves")
    (xf, rf), (xe, re_) = outs["fast"], outs["exact"]
    gap = float((xf - xe).abs().max())
    check(rf.iter == re_.iter and gap <= 1e-5,
          f"exact vs fast: iterations {re_.iter} vs {rf.iter}, max|dX| {gap}")
    phase(f"core exact vs fast highest: {rf.iter} iterations each, "
          f"max|dX| {gap:.3e}")

    # float64: certified, support exact
    dispatch.reset_launches()
    A64, Y64 = make_problem(M, N, K_SPARSE, 1, dtype=np.float64)
    x64, r64 = Homotopy(A64, device=dev).solve(Y64[0], TOL)
    no_launches("float64 solve")
    top = set(np.argsort(-np.abs(x64.cpu().numpy()))[:K_SPARSE].tolist())
    check(x64.dtype == torch.float64 and r64.solution_error <= TOL
          and top == sups[0], f"float64 solve: {r64}, support "
          f"{top == sups[0]}")
    phase(f"core float64 solve: certified {r64.solution_error:.3e}, "
          f"{r64.iter} iterations, support exact")

    # solve_path: the last breakpoint is solve's x; the KKT identity
    dispatch.reset_launches()
    high = Homotopy(A, precision="high", device=dev)
    lam, Xs, rp = high.solve_path(Y[2], TOL)
    xs, rs = high.solve(Y[2], TOL)
    no_launches("solve_path")
    gap = float(np.abs(Xs[-1] - xs.cpu().numpy()).max())
    check(rp.iter == rs.iter and gap <= 1e-6,
          f"solve_path: iterations {rp.iter} vs {rs.iter}, gap {gap}")
    A64h = A.astype(np.float64)
    # rtol 1e-4 and atol 1e-6 (test_api.py:339), on rows before the last,
    # whose λ sits at the f32 rounding floor of an exact recovery
    rows = sorted({0, len(lam) // 3, 2 * len(lam) // 3, len(lam) - 2})
    kkt = max(abs(np.abs(A64h.T @ (Y[2] - A64h @ Xs[t])).max() - lam[t])
              - 1e-4 * lam[t] for t in rows)
    check(kkt <= 1e-6, f"solve_path: KKT gap beyond rtol 1e-4: {kkt}")
    phase(f"core solve_path: {len(lam)} breakpoints, last = solve's x "
          f"(max gap {gap:.1e}), ‖Aᵀ(y−Ax_t)‖∞ = λ_t within rtol 1e-4 and "
          f"atol 1e-6 on rows {rows}")


def true_supports():
    """The supports ``make_problem`` (bench.py's problem) draws, replayed
    from its seed in its draw order (A first, then per lane the support
    and the values)."""
    rng = np.random.RandomState(0)
    rng.randn(M, N)
    sups = []
    for _ in range(BATCH):
        sups.append(set(rng.choice(N, K_SPARSE, replace=False).tolist()))
        rng.uniform(0.5, 1.0, K_SPARSE)
    return sups


# device kernels by the port's kernel they belong to (K1 is its D round
# and its two ring passes)
DEVICE_KERNELS = {
    "normal_matvec_fused_bf16": ("round_to_bf16_kernel",
                                 "gemm_bf16_async_kernel"),
    "find_max_gamma_fused": ("gamma_scan_cluster_kernel",),
    "transition": ("transition_regs_kernel", "transition_mem_kernel"),
    "omp_insert": ("omp_insert_rows_kernel",),
}


def profile_path(name, solver, Yd, card, max_iter):
    """One ``solve_batch_on_device`` under ``utils/profiling.trace``:
    device ms per hand kernel (K1's share first) beside the total device
    ms (every kernel, copy and fill on the card) and the profiled wall
    ms. A trace with no K1 device time (the profiler can drop a session's
    records) is taken again, up to ``PROFILER_TRIES`` runs in all."""
    from sparse_solvers_tpu_torch.utils import profiling
    for _ in range(PROFILER_TRIES):
        torch.cuda.synchronize()
        with profiling.trace() as prof:
            t0 = time.perf_counter()
            solver.solve_batch_on_device(Yd, TOL, max_iter)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        groups = dict.fromkeys(DEVICE_KERNELS, 0.0)
        calls = dict.fromkeys(DEVICE_KERNELS, 0)
        total = 0.0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = evt.self_device_time_total / 1e3
            total += ms
            for kname, parts in DEVICE_KERNELS.items():
                if any(part in evt.key for part in parts):
                    groups[kname] += ms
                    calls[kname] += evt.count
        if groups["normal_matvec_fused_bf16"] > 0:
            break
    k1 = groups.pop("normal_matvec_fused_bf16")
    k1_calls = calls["normal_matvec_fused_bf16"]
    check(k1 > 0 and total > 0, f"{name}: the profiler saw no K1 device "
          f"time ({groups}, total {total})")
    rest = ", ".join(f"{k} {v:.3f} ms in {calls[k]}"
                     for k, v in groups.items() if v)
    phase(f"{name} profile (one solve_batch_on_device under "
          f"profiling.trace): K1 {k1:.3f} ms in {k1_calls} device kernels "
          f"({100 * k1 / total:.1f}% of device time); "
          f"{rest}; other {total - k1 - sum(groups.values()):.3f} ms; total "
          f"device {total:.3f} ms; profiled wall {wall:.3f} ms [{card}]")


def time_path(name, solver, Y, dev, card, max_iter, runs: int = 10):
    """Wall time of ``solve_batch_on_device`` per batch, each run fenced
    by ``torch.cuda.synchronize()``, after one warm-up; counts the lanes
    whose certificate misses the tolerance (``solve_batch`` re-solves
    them). Then one profiled run (``profile_path``)."""
    Yd = torch.from_numpy(Y).to(dev)
    solver.solve_batch_on_device(Yd, TOL, max_iter)
    torch.cuda.synchronize()
    times, resolve = [], 0
    for _ in range(runs):
        t0 = time.perf_counter()
        _, r = solver.solve_batch_on_device(Yd, TOL, max_iter)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        e = r.solution_error.cpu().numpy()
        resolve += int(((~(e <= TOL)) & (r.iter.cpu().numpy()
                                         < max_iter)).sum())
    q1, dt, q3 = np.percentile(times, [25, 50, 75])
    phase(f"{name} timing (solve_batch_on_device, {runs} fenced runs): "
          f"median {dt * 1e3:.3f} ms/batch (quartiles {q1 * 1e3:.3f}, "
          f"{q3 * 1e3:.3f}), {BATCH / dt:.1f} solves/s, iterations max "
          f"{int(r.iter.max())}, lanes needing the re-solve {resolve} of "
          f"{runs * BATCH} [{card}]")
    profile_path(name, solver, Yd, card, max_iter)


def run_path(name, solver, Y, dev, card, max_iter, kernels,
             shape=(M, N, K_SPARSE)):
    """One ``solve_batch`` with the launch counts set to 0 just before and
    read just after; fails unless each of ``kernels`` launched and no
    other kernel did. Then the timed runs. ``shape``: (m, n, k) of the
    problem, for the phase line."""
    from sparse_solvers_tpu_torch.ops import dispatch
    dispatch.reset_launches()
    t0 = time.perf_counter()
    X, rep = solver.solve_batch(Y, TOL, max_iter)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = dict(dispatch.launches)
    m, n, k = shape
    phase(f"{name}: solve_batch {m}x{n} k={k} batch={BATCH} "
          f"tol={TOL} max_iter={max_iter} certified: first call "
          f"{first:.3f} s (Gram or transposed copy included); launches "
          f"{launches}, K1 on its ring {dispatch.fallbacks}")
    check(not any(dispatch.fallbacks.values()),
          f"{name}: K1 fell back to its ring {dispatch.fallbacks}")
    for kname, count in launches.items():
        if kname in kernels:
            check(count > 0, f"{name} never launched kernel {kname}")
        else:
            check(count == 0, f"{name} launched {kname}, not on its path")
    # timed before the host-side checks below, whose multi-threaded numpy
    # BLAS would compete for the cores that launch the solver's kernels
    time_path(name, solver, Y, dev, card, max_iter)
    Xh = X.cpu().numpy()
    errs = rep.solution_error.cpu().numpy()
    iters = rep.iter.cpu().numpy()
    check(np.isfinite(Xh).all(), f"{name}: non-finite solution")
    check(bool((errs <= TOL).all()),
          f"{name}: {int((~(errs <= TOL)).sum())} lanes above tol")
    return Xh, errs, iters, launches


def check_supports(name, Xh, sups, k=K_SPARSE):
    top = np.argsort(-np.abs(Xh), axis=1)[:, :k]
    wrong = [i for i in range(BATCH) if set(top[i].tolist()) != sups[i]]
    check(not wrong, f"{name}: support wrong on lanes {wrong[:8]}")


def check_linf_certificate(name, A64, Y, Xh, errs, lanes):
    """Homotopy's certificate ‖Aᵀ(y − Ax)‖∞ against a float64 host
    recompute on ``lanes``, to rtol 1e-4."""
    c = (Y[lanes].astype(np.float64) - Xh[lanes].astype(np.float64)
         @ A64.T) @ A64
    cert = np.abs(c).max(axis=1)
    check(np.allclose(errs[lanes], cert, rtol=1e-4, atol=0),
          f"{name}: certificate vs float64 host recompute "
          f"{errs[lanes]} vs {cert}")


def check_l2_certificate(name, A64, Y, Xh, errs, lanes, k):
    """OMP's certificate ‖y − Ax‖₂ against a float64 host recompute on
    ``lanes``. Once the support is complete the residual sits at the f32
    rounding floor, so beside rtol 1e-4 each lane is allowed the f32
    evaluation bound of r = y − Ax: (k + 2)·2⁻²⁴·‖|y| + |x|·|A|ᵀ‖₂.
    Returns (the largest gap, the largest allowance)."""
    Yl, Xl = Y[lanes].astype(np.float64), Xh[lanes].astype(np.float64)
    ref = np.linalg.norm(Yl - Xl @ A64.T, axis=1)
    slack = (k + 2) * 2.0 ** -24 * np.linalg.norm(
        np.abs(Yl) + np.abs(Xl) @ np.abs(A64).T, axis=1)
    gap = np.abs(errs[lanes] - ref)
    check(bool((gap <= 1e-4 * ref + slack).all()),
          f"{name}: certificate vs float64 host recompute "
          f"{errs[lanes]} vs {ref} (slack {slack})")
    return gap.max(), (1e-4 * ref + slack).max()


def main_path(dev, card):
    from sparse_solvers_tpu_torch import Homotopy

    A, Y = make_problem(M, N, K_SPARSE, BATCH)
    solver = Homotopy(A, k_max=K_MAX, precision="certified", device=dev)
    Xh, errs, iters, launches = run_path("homotopy main path", solver, Y,
                                         dev, card, MAX_ITER,
                                         HOMOTOPY_KERNELS)
    check_supports("homotopy main path", Xh, true_supports())
    lanes = np.arange(0, BATCH, BATCH // 16)
    check_linf_certificate("homotopy main path", A.astype(np.float64), Y,
                           Xh, errs, lanes)
    phase(f"homotopy main path: {BATCH}/{BATCH} lanes certified <= {TOL} "
          f"(max {errs.max():.4e}), top-{K_SPARSE} support exact on every "
          f"lane, certificate = float64 host recompute to rtol 1e-4 on "
          f"{len(lanes)} lanes; path iterations max {iters.max()} mean "
          f"{iters.mean():.1f}")
    return launches


def omp_paths(dev, card):
    """The certified OMP and gOMP main paths on benchmarks/bench_omp.py's
    problem (seed 0)."""
    from sparse_solvers_tpu_torch import Omp

    A, X0, Y = make_sparse_problem(M, N, K_SPARSE, BATCH, seed=0)
    sups = [set(np.flatnonzero(x).tolist()) for x in X0]
    lanes = np.arange(0, BATCH, BATCH // 16)
    A64 = A.astype(np.float64)
    counts = {}
    for name, picks, max_iter in (("omp main path", 1, OMP_MAX_ITER),
                                  ("gomp main path", GOMP_PICKS,
                                   GOMP_MAX_ITER)):
        solver = Omp(A, precision="certified", picks=picks, device=dev)
        plan = solver.explain(batch=BATCH, max_iterations=max_iter)
        check(plan["corr"] == "driver", f"{name}: plan {plan}")
        Xh, errs, iters, launches = run_path(name, solver, Y, dev, card,
                                             max_iter, OMP_KERNELS)
        k1, k4 = launches["normal_matvec_fused_bf16"], launches["omp_insert"]
        check(k4 >= picks * k1,
              f"{name}: {k4} K4 launches for {k1} q passes at picks={picks}")
        check_supports(name, Xh, sups)
        gap, allowed = check_l2_certificate(name, A64, Y, Xh, errs, lanes,
                                            K_SPARSE)
        phase(f"{name}: plan tiers {plan['capacity_tiers']}, k_max "
              f"{plan['k_max']}, picks {picks}; {BATCH}/{BATCH} lanes "
              f"certified <= {TOL} (max {errs.max():.4e}), top-{K_SPARSE} "
              f"support exact on every lane, certificate = float64 host "
              f"recompute within rtol 1e-4 + f32 evaluation bound on "
              f"{len(lanes)} lanes (max gap {gap:.3e}, max bound "
              f"{allowed:.3e}); iterations max "
              f"{iters.max()} mean {iters.mean():.1f}; q passes {k1}, K4 "
              f"calls {k4}")
        for kname, count in launches.items():
            counts[kname] = counts.get(kname, 0) + count
    return counts


@contextlib.contextmanager
def failing_certificate(module, name: str):
    """Replace ``module.name`` (a certificate seam) so that its first call
    reports every lane as failing, by adding 1 to the real certificate;
    yields the list of its calls."""
    real = getattr(module, name)
    calls = []

    def first_fails(*args):
        err = real(*args)
        calls.append(1)
        return err + 1.0 if len(calls) == 1 else err

    setattr(module, name, first_fails)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def forced_resolve(name, solver, seam, Y, dev, card, max_iter, first,
                   iters):
    """The certified re-solve at "high" on the gram-free route, forced:
    every lane's first certificate fails, so every lane that did not
    exhaust its budget in the certified pass (``iters``, that pass's
    iterations) re-solves on the gram-free driver without K1 (two fp32
    products, TF32 off). Its K1 launches equal the certified pass's
    (``first``, the launch counts of ``run_path``'s call), the peak of
    allocated device memory stays below one n×n f32 tensor, and every
    re-solved lane ends certified (the others keep the failed
    certificate). Returns the launch counts and X."""
    from sparse_solvers_tpu_torch.ops import dispatch
    n = solver.shape[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dispatch.reset_launches()
    with failing_certificate(*seam) as calls:
        t0 = time.perf_counter()
        X, rep = solver.solve_batch(Y, TOL, max_iter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(dispatch.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    errs = rep.solution_error.cpu().numpy()
    k1 = "normal_matvec_fused_bf16"
    check(bool(calls), f"{name}: the certificate seam was never called")
    check(launches[k1] == first[k1], f"{name}: the forced re-solve launched "
          f"K1 {launches[k1]} times against the certified pass's "
          f"{first[k1]}")
    check(peak < n * n * 4, f"{name}: {peak} B of device memory allocated "
          f"at the peak, past one n×n f32 tensor ({n * n * 4} B)")
    check(solver._G_cache is None, f"{name}: a Gram was built")
    redone = iters < max_iter
    check(bool(redone.any()), f"{name}: every lane exhausted its budget")
    check(bool((errs[redone] <= TOL).all()),
          f"{name}: forced re-solve left "
          f"{int((~(errs[redone] <= TOL)).sum())} lanes above tol")
    phase(f"{name} forced re-solve at high (every certificate failed "
          f"once): {wall:.3f} s, launches {launches} (K1 as the certified "
          f"pass alone: the re-solve ran none), peak device memory "
          f"{peak / 2**30:.3f} GiB against {n * n * 4 / 2**30:.0f} GiB for "
          f"an n×n f32 tensor, no Gram, {int(redone.sum())}/{BATCH} lanes "
          f"re-solved, all certified (max {errs[redone].max():.4e}) "
          f"[{card}]")
    return launches, X.cpu().numpy()


def gram_free_paths(dev, card):
    """The gram-free Homotopy and OMP paths at 2048x65536 (k=16, batch
    256, tol 1e-2; benchmarks/bench_gram_free.py:81-86 and
    benchmarks/bench_omp.py:60-64), where AᵀA would take 16 GiB: explain
    says gram-free, the certified solve_batch is timed and profiled as the
    main paths are, then its re-solve at "high" is forced. Returns the
    summed launch counts."""
    from sparse_solvers_tpu_torch import Homotopy, Omp, api
    from sparse_solvers_tpu_torch.solvers import omp_batch

    m, n, k = GF_SHAPE
    A, X0, Y = make_sparse_problem(m, n, k, BATCH, seed=0)
    sups = [set(np.flatnonzero(x).tolist()) for x in X0]
    lanes = np.arange(0, BATCH, BATCH // 16)
    A64 = A.astype(np.float64)
    counts = {}
    for name, make, max_iter, kernels, seam in (
            ("gram-free homotopy path", Homotopy, GF_MAX_ITER,
             HOMOTOPY_KERNELS, (api, "_certified_error")),
            ("gram-free omp path", Omp, GF_OMP_MAX_ITER, OMP_KERNELS,
             (omp_batch, "l2_certificate"))):
        solver = make(A, gram=False, device=dev)
        plan = solver.explain(batch=BATCH, max_iterations=max_iter)
        check(plan.get("gram_free") is True
              and plan["precision"] == "certified"
              and plan.get("corr", "driver") == "driver",
              f"{name}: plan {plan}")
        Xh, errs, iters, launches = run_path(name, solver, Y, dev, card,
                                             max_iter, kernels, GF_SHAPE)
        check_supports(name, Xh, sups, k)
        if make is Homotopy:
            check_linf_certificate(name, A64, Y, Xh, errs, lanes)
            how = "to rtol 1e-4"
        else:
            gap, allowed = check_l2_certificate(name, A64, Y, Xh, errs,
                                                lanes, k)
            how = (f"within rtol 1e-4 + f32 evaluation bound (max gap "
                   f"{gap:.3e}, max bound {allowed:.3e})")
        phase(f"{name}: plan '{plan['formulation']}', gram_free "
              f"{plan['gram_free']}, k_max {plan['k_max']}; {BATCH}/{BATCH} "
              f"lanes certified <= {TOL} (max {errs.max():.4e}), top-{k} "
              f"support exact on every lane, certificate = float64 host "
              f"recompute {how} on {len(lanes)} lanes; iterations max "
              f"{iters.max()} mean {iters.mean():.1f}")
        forced, Xf = forced_resolve(name, solver, seam, Y, dev, card,
                                    max_iter, launches, iters)
        check_supports(f"{name} forced re-solve", Xf, sups, k)
        for kname in launches:
            counts[kname] = counts.get(kname, 0) + launches[kname] \
                + forced[kname]
        del solver
        torch.cuda.empty_cache()
    return counts


def omp_core_paths(dev, card):
    """The per-lane OMP core at full width on bench.py's problem
    (``make_problem``, 4096x8192, k=64), each phase with the launch
    counts read from 0: the core runs no kernel of K1 to K6, as the JAX
    core reaches no pallas_call. Certified single solves (each
    certificate against a float64 recompute, as on the driver paths),
    timed; an 8-lane batch in the small-batch regime; exact against fast
    at "highest"; float64; gram=True; a gOMP picks=4 single solve."""
    from sparse_solvers_tpu_torch import Omp
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y = make_problem(M, N, K_SPARSE, 8)
    A64 = A.astype(np.float64)
    sups = true_supports()

    def no_launches(what):
        check(not any(dispatch.launches.values()),
              f"{what} launched {dispatch.launches}")

    def check_lanes(what, X, errs, lanes, problem=(A64, Y)):
        """Certified lanes (an (l, n) X, its errors) with exact supports,
        each certificate against a float64 recompute on ``problem``."""
        X = X.reshape(len(lanes), -1)
        errs = np.asarray(errs).reshape(-1)
        check(bool((errs <= TOL).all()), f"{what}: errors {errs}")
        check_l2_certificate(what, problem[0], problem[1][lanes], X, errs,
                             np.arange(len(lanes)), K_SPARSE)
        for i, lane in enumerate(lanes):
            top = set(np.argsort(-np.abs(X[i]))[:K_SPARSE].tolist())
            check(top == sups[lane], f"{what}: lane {lane} support wrong")

    solver = Omp(A, device=dev)
    plan = solver.explain()
    check(plan["formulation"] == "OMP loop (corr=gram)"
          and plan["kernels"] == {}, f"OMP core plan {plan}")
    solver.solve(Y[0], TOL)                     # the Gram, once
    dispatch.reset_launches()
    for lane in range(4):
        x, rep = solver.solve(Y[lane], TOL)
        check_lanes(f"OMP core solve lane {lane}", x.cpu().numpy(),
                    [rep.solution_error], [lane])
    no_launches("OMP core solve")
    _, first = solver.solve_on_device(torch.from_numpy(Y[0]).to(dev), TOL)
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rep = solver.solve(Y[0], TOL)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    phase(f"OMP core solve {M}x{N} k={K_SPARSE} certified: plan "
          f"'{plan['formulation']}', 4/4 lanes certified, top-{K_SPARSE} "
          f"support exact, certificate = float64 recompute; {rep.iter} "
          f"picks (the one-pass pass: {int(first.iter)} picks, certificate "
          f"{float(first.solution_error):.3e}"
          f"{', re-solved at high' if float(first.solution_error) > TOL else ''}"
          f"); median {med * 1e3:.3f} ms per solve over 10 fenced runs "
          f"(quartiles {q1 * 1e3:.3f}, {q3 * 1e3:.3f}); launches 0 [{card}]")

    # an 8-lane batch in the small-batch regime, and gram=True pinning
    # the Gram-gather core past the crossover
    for what, s in (("OMP core solve_batch", solver),
                    ("OMP core gram=True", Omp(A, gram=True, device=dev))):
        plan = s.explain(batch=8, max_iterations=OMP_MAX_ITER)
        check(plan["formulation"] == "vmapped OMP loop (corr=gram)",
              f"{what}: plan {plan}")
        wide = s.explain(batch=BATCH, max_iterations=OMP_MAX_ITER)["corr"]
        check(wide == ("gram" if s is not solver else "driver"),
              f"{what}: batch {BATCH} routes to {wide}")
        dispatch.reset_launches()
        t0 = time.perf_counter()
        X, rep = s.solve_batch(Y, TOL, OMP_MAX_ITER)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        no_launches(what)
        check_lanes(what, X.cpu().numpy(), rep.solution_error.cpu().numpy(),
                    list(range(8)))
        phase(f"{what} 8 lanes k_max {plan['k_max']}: plan "
              f"'{plan['formulation']}' (batch {BATCH}: corr {wide}), 8/8 "
              f"certified (max {float(rep.solution_error.max()):.3e}), "
              f"supports exact, picks {rep.iter.tolist()}, {dt * 1e3:.1f} ms "
              f"(first call), launches 0")

    # exact against fast mode at "highest" on one lane
    dispatch.reset_launches()
    outs = {mode: Omp(A, mode=mode, precision="highest",
                      device=dev).solve(Y[1], TOL)
            for mode in ("fast", "exact")}
    no_launches("OMP exact/fast solves")
    (xf, rf), (xe, re_) = outs["fast"], outs["exact"]
    gap = float((xf - xe).abs().max())
    # two f32 routes to the same 64-column least squares
    check(rf.iter == re_.iter and gap <= 1e-4,
          f"OMP exact vs fast: picks {re_.iter} vs {rf.iter}, max|dX| {gap}")
    check_lanes("OMP exact solve", xe.cpu().numpy(), [re_.solution_error],
                [1])
    phase(f"OMP core exact vs fast highest: {rf.iter} picks each, max|dX| "
          f"{gap:.3e} <= 1e-4")

    # float64, and a gOMP picks=4 single solve
    dispatch.reset_launches()
    A64f, Y64 = make_problem(M, N, K_SPARSE, 1, dtype=np.float64)
    x64, r64 = Omp(A64f, device=dev).solve(Y64[0], TOL)
    xg, rg = Omp(A, picks=GOMP_PICKS, device=dev).solve(Y[2], TOL)
    no_launches("OMP float64 and gOMP solves")
    check(x64.dtype == torch.float64, f"float64 solve gave {x64.dtype}")
    check_lanes("OMP float64 solve", x64.cpu().numpy(), [r64.solution_error],
                [0], (A64f, Y64))
    check_lanes("gOMP core solve", xg.cpu().numpy(), [rg.solution_error], [2])
    phase(f"OMP core float64 solve: certified {r64.solution_error:.3e}, "
          f"{r64.iter} picks, support exact; gOMP picks={GOMP_PICKS} solve: "
          f"certified {rg.solution_error:.3e}, {rg.iter} columns, support "
          f"exact; launches 0")


def cross_device(dev):
    from sparse_solvers_tpu_torch import Homotopy, Omp
    A, Y = make_problem(256, 512, 8, 8, seed=5)
    for name, make in (
            ("homotopy", lambda where: Homotopy(A, k_max=64, precision="high",
                                                device=where)),
            ("omp", lambda where: Omp(A, precision="high", device=where))):
        out = {}
        for where in (dev, "cpu"):
            X, rep = make(where).solve_batch(Y, TOL, 64)
            out[where] = (X.cpu().numpy(), rep.iter.cpu().numpy())
        (Xg, ig), (Xc, ic) = out[dev], out["cpu"]
        check(np.array_equal(ig, ic),
              f"cross-device {name}: iterations {ig} vs {ic}")
        err = float(np.abs(Xg - Xc).max())
        check(err <= 1e-5, f"cross-device {name}: max |X_gpu - X_cpu| = "
              f"{err}")
        phase(f"cross-device {name} 256x512 k=8 batch 8 high: iterations "
              f"equal {ig.tolist()}, max |X_gpu - X_cpu| {err:.3e}")
    # the per-lane core: a single solve, an 8-lane sparse-regime batch
    # (8·32 < 2m), a float64 solve
    A64, Y64 = make_problem(256, 512, 8, 8, seed=5, dtype=np.float64)
    for name, make, run, atol in (
            ("core solve", lambda w: Homotopy(A, precision="high", device=w),
             lambda s: s.solve(Y[0], 1e-4, 64), 1e-5),
            ("core batch", lambda w: Homotopy(A, k_max=32, precision="high",
                                              device=w),
             lambda s: s.solve_batch(Y, 1e-4, 31), 1e-5),
            ("core float64", lambda w: Homotopy(A64, device=w),
             lambda s: s.solve(Y64[0], 1e-9, 64), 1e-10)):
        out = {}
        for where in (dev, "cpu"):
            x, rep = run(make(where))
            it = rep.iter if isinstance(rep.iter, int) else rep.iter.tolist()
            out[where] = (x.cpu().numpy(), it)
        (xg, ig), (xc, ic) = out[dev], out["cpu"]
        err = float(np.abs(xg - xc).max())
        check(ig == ic and err <= atol, f"cross-device {name}: iterations "
              f"{ig} vs {ic}, max |dX| {err}")
        phase(f"cross-device {name} 256x512: iterations equal {ig}, max "
              f"|X_gpu - X_cpu| {err:.3e} <= {atol:g}")
    # update_column on the card against a solver built on the changed A
    col = np.random.RandomState(6).randn(256).astype(np.float32)
    col /= np.linalg.norm(col)
    A2 = A.copy()
    A2[:, 11] = col
    s = Homotopy(A, precision="high", device=dev)
    _ = s._G
    s.update_column(11, col)
    gg = float((s._G - Homotopy(A2, precision="high", device=dev)._G)
               .abs().max())
    Xa, ra = s.solve_batch(Y, TOL, 64)
    Xb, rb = Homotopy(A2, precision="high", device=dev).solve_batch(Y, TOL,
                                                                    64)
    err = float((Xa - Xb).abs().max())
    check(gg <= 1e-5 and torch.equal(ra.iter, rb.iter) and err <= 1e-5,
          f"update_column: Gram gap {gg}, max |dX| {err}")
    phase(f"update_column on the card: Gram within {gg:.1e} of the rebuilt "
          f"one, solve_batch iterations equal, max |dX| {err:.3e}")


def irls_json(**fields) -> None:
    """One phase line of the IRLS and CG-IRLS phases, as JSON."""
    phase(json.dumps(fields))


def fenced_ms(run, runs: int):
    """(the wall ms of each of ``runs`` calls of ``run()``, each fenced by
    ``torch.cuda.synchronize()``, and the last call's output)."""
    times, out = [], None
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def timed_batches(run, runs: int = 5):
    """(median ms of ``runs`` calls of ``run()`` after one warm-up, each
    fenced by ``torch.cuda.synchronize()``, its first and third quartiles,
    the last call's output, and the peak of allocated device memory over
    all of them in GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    times, out = fenced_ms(run, runs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return float(med), float(q1), float(q3), out, peak


def irls_stats(X, rep):
    """Host copies of an IRLS batch result: (X, iterations, spd flags)."""
    return (X.cpu().numpy(), rep.iter.cpu().numpy(),
            rep.spd_failure.cpu().numpy())


def irls_batch_phase(dev, card):
    """Phase 1: benchmarks/bench_irls_batch.py's problem (k=1 plus
    uniform(0, 0.02) noise, seed 0 and 1) at 2048x1024 and 4096x2048,
    batch 256, tol 1e-3, 50 iterations: fast mode with the triangular
    solve, fast mode with the R⁻¹ product (SS_IRLS_GEMM=1) and, at
    2048x1024, exact mode; then 4 lanes solved one by one. Returns the
    first shape's (solver, A, Y) for the later phases."""
    import os
    from sparse_solvers_tpu_torch import Irls
    first = None
    for m, n in IRLS_SHAPES:
        A, X0, Y = make_sparse_problem(m, n, 1, IRLS_BATCH, seed=0)
        Y = Y + np.random.RandomState(1).uniform(
            0, 0.02, Y.shape).astype(np.float32)
        truth = X0.argmax(axis=1)
        Yd = torch.from_numpy(Y).to(dev)
        fast = Irls(A, device=dev)
        out = {}
        forms = [("fast_trsm", fast, "0"), ("fast_gemm_newton", fast, "1")]
        if (m, n) == IRLS_SHAPES[0]:
            forms.append(("exact", Irls(A, mode="exact", device=dev), "0"))
        for name, solver, gemm in forms:
            os.environ["SS_IRLS_GEMM"] = gemm
            try:
                plan = solver.explain(batch=IRLS_BATCH)
                check(("newton" in plan) == (gemm == "1"),
                      f"irls {name}: plan {plan}")
                ms, _, _, (X, rep), peak = timed_batches(
                    lambda: solver.solve_batch_on_device(
                        Yd, IRLS_TOL, IRLS_MAX_ITER))
            finally:
                del os.environ["SS_IRLS_GEMM"]
            Xh, it, spd = out[name] = irls_stats(X, rep)
            check(np.isfinite(Xh).all(), f"irls {name} {m}x{n}: non-finite")
            irls_json(phase="irls_batch", formulation=name, m=m, n=n,
                      batch=IRLS_BATCH, tol=IRLS_TOL,
                      max_iterations=IRLS_MAX_ITER, ms_per_batch=ms,
                      solves_per_sec=IRLS_BATCH / ms * 1e3,
                      mean_iters=float(it.mean()), max_iters=int(it.max()),
                      spd_failures=int(spd.sum()),
                      argmax_recovery=float(np.mean(Xh.argmax(axis=1)
                                                    == truth)),
                      peak_gib=peak, card=card)
        (Xt, it_t, spd_t), (Xg, it_g, spd_g) = (out["fast_trsm"],
                                                out["fast_gemm_newton"])
        gap = float(np.abs(Xg - Xt).max())
        check(np.array_equal(it_g, it_t) and np.array_equal(spd_g, spd_t)
              and gap <= 1e-4, f"irls {m}x{n}: gemm vs trsm iterations "
              f"equal {np.array_equal(it_g, it_t)}, spd equal "
              f"{np.array_equal(spd_g, spd_t)}, max|dX| {gap}")
        if "exact" in out:
            ae, af = out["exact"][0].argmax(axis=1), Xt.argmax(axis=1)
            check(np.array_equal(ae, af), f"irls {m}x{n}: exact and fast "
                  f"argmax differ on {int((ae != af).sum())} lanes")
        lanes = []
        for lane in range(4):
            x, r = fast.solve(Y[lane], IRLS_TOL, IRLS_MAX_ITER)
            dx = float(np.abs(x.cpu().numpy() - Xt[lane]).max())
            check(r.iter == it_t[lane] and r.spd_failure == spd_t[lane]
                  and dx <= 1e-4, f"irls {m}x{n} lane {lane}: solve "
                  f"{r} against batch iter {it_t[lane]} spd {spd_t[lane]}, "
                  f"max|dx| {dx}")
            lanes.append(dx)
        irls_json(phase="irls_batch_checks", m=m, n=n,
                  gemm_vs_trsm_max_abs_dx=gap, iterations_equal=True,
                  exact_vs_fast_argmax_equal="exact" in out or None,
                  single_vs_batch_max_abs_dx=max(lanes))
        if first is None:
            first = (fast, A, Y)
        del out
        torch.cuda.empty_cache()
    return first


def irls_stabilized_phase(dev, card, A):
    """Phase 2: benchmarks/bench_irls_batch.py:105-125's competing pairs at
    2048x1024 (seed 7, ρ in [0.9, 0.96], tol 0.3, 60 iterations): the
    stabilized loop has no spd failure and finds every leader, and a lane
    that reaches the budget reaches it in float64 too; the reference
    recurrence spd-bails on every lane."""
    from _torch_cases import bench_competing_pair
    from sparse_solvers_tpu_torch import Irls
    Y, leaders = bench_competing_pair(A, IRLS_BATCH)
    Yd = torch.from_numpy(Y).to(dev)
    for name, stab in (("stabilized_sustained", True),
                       ("reference_recurrence_same_workload", False)):
        solver = Irls(A, stabilized=stab, device=dev)
        ms, _, _, (X, rep), peak = timed_batches(
            lambda: solver.solve_batch_on_device(Yd, STAB_TOL,
                                                 STAB_MAX_ITER))
        Xh, it, spd = irls_stats(X, rep)
        found = float(np.mean(Xh.argmax(axis=1) == leaders))
        irls_json(phase="irls_stabilized", formulation=name,
                  m=A.shape[0], n=A.shape[1], batch=IRLS_BATCH,
                  tol=STAB_TOL, max_iterations=STAB_MAX_ITER,
                  ms_per_batch=ms, solves_per_sec=IRLS_BATCH / ms * 1e3,
                  mean_iters=float(it.mean()), min_iters=int(it.min()),
                  max_iters=int(it.max()),
                  converged_lanes=int(((it < STAB_MAX_ITER) & ~spd).sum()),
                  spd_failures=int(spd.sum()), leader_recovery=found,
                  peak_gib=peak, card=card)
        if stab:
            check(not spd.any() and found == 1.0, f"stabilized: spd "
                  f"{int(spd.sum())}, leaders found {found}")
            stalled = np.flatnonzero(it >= STAB_MAX_ITER)
            if stalled.size:
                # a lane whose runner-up hovers at tol·max never meets the
                # do-while's rule: the JAX package and the float64 oracle
                # stall on such lanes too (ROADMAP.md Queue 3). Such a lane
                # must stall in float64 as well, or float32 is at fault.
                s64 = Irls(A.astype(np.float64), stabilized=True,
                           device=dev)
                _, r64 = s64.solve_batch(Y[stalled].astype(np.float64),
                                         STAB_TOL, STAB_MAX_ITER)
                it64 = r64.iter.cpu().numpy()
                irls_json(phase="irls_stabilized_budget_lanes",
                          lanes=stalled.tolist(),
                          float64_iterations=it64.tolist())
                check(bool((it64 >= STAB_MAX_ITER).all()),
                      f"stabilized: lanes {stalled.tolist()} reach the "
                      f"budget in float32 but stop at {it64.tolist()} in "
                      "float64")
        else:
            check(spd.all(), f"reference recurrence: {int((~spd).sum())} "
                  "lanes did not spd-bail")


def irls_latency_phase(card, solver, Y):
    """Phase 3: one fast-mode Irls.solve at 2048x1024, median of 10 fenced
    runs after a warm-up."""
    solver.solve(Y[0], IRLS_TOL, IRLS_MAX_ITER)
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, rep = solver.solve(Y[0], IRLS_TOL, IRLS_MAX_ITER)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    irls_json(phase="irls_latency", m=solver.shape[0], n=solver.shape[1],
              ms_per_solve=float(np.median(times)) * 1e3,
              iterations=rep.iter, spd_failure=rep.spd_failure, card=card)


def irls_cg_phase(dev, card):
    """Phase 4: benchmarks/bench_irls_cg.py's two configurations (signed
    amplitudes in [0.5, 1.5), K = 2k, tol 1e-3): every lane's top-k
    support is the planted one and no lane breaks down. Returns the last
    configuration's (solver, Y on the card, max_outer) for the profile."""
    from sparse_solvers_tpu_torch import IrlsCg
    last = None
    for m, n, k, batch, max_outer, cg_max in CG_CONFIGS:
        A, X0, Y = make_sparse_problem(m, n, k, batch, signed=True,
                                       amp=(0.5, 1.5))
        solver = IrlsCg(A, k_sparsity=2 * k, cg_max_iterations=cg_max,
                        device=dev)
        Yd = torch.from_numpy(Y).to(dev)
        ms, _, _, (X, rep), peak = timed_batches(
            lambda: solver.solve_batch_on_device(Yd, CG_TOL, max_outer))
        Xh, it, broke = irls_stats(X, rep)
        top = np.argsort(-np.abs(Xh), axis=1)[:, :k]
        hits = [set(top[b].tolist()) == set(np.flatnonzero(X0[b]).tolist())
                for b in range(batch)]
        irls_json(phase="irls_cg", m=m, n=n, k=k, batch=batch, tol=CG_TOL,
                  max_outer=max_outer, cg_max=cg_max, ms_per_batch=ms,
                  solves_per_sec=batch / ms * 1e3,
                  mean_outer_iterations=float(it.mean()),
                  max_outer_iterations=int(it.max()),
                  support_recovery_rate=float(np.mean(hits)),
                  max_abs_err=float(np.abs(Xh - X0).max()),
                  breakdowns=int(broke.sum()), a_bytes=int(A.nbytes),
                  peak_gib=peak, card=card)
        check(all(hits) and not broke.any(), f"irls_cg {m}x{n}: supports "
              f"missed on {batch - sum(hits)} lanes, breakdowns "
              f"{int(broke.sum())}")
        last = (solver, Yd, max_outer)
    return last


def irls_profile(name, run, card, phase="irls_profile"):
    """Phase 5: one call of ``run`` under ``utils/profiling.trace``: total
    device time, its share of the profiled wall time, and the top device
    operations by time and by count. ``phase`` names the JSON line."""
    from sparse_solvers_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    with profiling.trace() as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = [(e.self_device_time_total / 1e3, e.count, e.key)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(ms for ms, _, _ in ops)
    check(total > 0, f"{name} profile: the profiler saw no device time")
    top = sorted(ops, reverse=True)[:6]
    by_count = sorted(ops, key=lambda op: (-op[1], -op[0]))[:6]
    irls_json(phase=phase, path=name, device_ms=total,
              profiled_wall_ms=wall, busy_share=total / wall,
              top_device_ops=[{"name": key[:90], "ms": ms, "calls": count}
                              for ms, count, key in top],
              top_device_ops_by_count=[
                  {"name": key[:90], "ms": ms, "calls": count}
                  for ms, count, key in by_count], card=card)


def irls_cross_device(dev):
    """Phase 6: a small Irls (fast, gemm and exact) and IrlsCg problem
    solved on the CPU and on the card from the same factorization:
    iterations and flags equal, X within 1e-4 (IrlsCg 1e-5)."""
    import os
    from _torch_cases import cs_problem, irls_problem
    from sparse_solvers_tpu_torch import Irls, IrlsCg
    A, Y = irls_problem(60, 30, 8, 3, seed=13, dtype=np.float32)
    Q, R = np.linalg.qr(A)
    Acg, _, _ = cs_problem(64, 256, 5, seed=0, dtype=np.float32)
    Ycg = np.stack([Acg @ cs_problem(64, 256, k, seed=s,
                                     dtype=np.float32)[1]
                    for s, k in ((0, 5), (4, 3), (9, 8))])
    # engine="jax": the torch route on the CPU twin too, where a CPU
    # façade's "auto" would take the host engine at these sizes
    cases = (("irls fast", lambda w: Irls.from_numpy(A, Q=Q, R=R,
                                                     engine="jax", device=w),
              Y, 0.01, 50, 1e-4, "0"),
             ("irls gemm", lambda w: Irls.from_numpy(A, Q=Q, R=R,
                                                     engine="jax", device=w),
              Y, 0.01, 50, 1e-4, "1"),
             ("irls exact", lambda w: Irls.from_numpy(A, Q=Q, R=R,
                                                      mode="exact",
                                                      engine="jax",
                                                      device=w),
              Y, 0.01, 50, 1e-4, "0"),
             ("irls_cg", lambda w: IrlsCg(Acg, engine="jax", device=w), Ycg,
              1e-5, 80, 1e-5, "0"))
    for name, make, Yc, tol, max_it, atol, gemm in cases:
        os.environ["SS_IRLS_GEMM"] = gemm
        try:
            out = {}
            for where in (dev, "cpu"):
                X, rep = make(where).solve_batch(Yc, tol, max_it)
                out[str(where)] = irls_stats(X, rep)
        finally:
            del os.environ["SS_IRLS_GEMM"]
        (Xg, ig, sg), (Xc, ic, sc) = out[str(dev)], out["cpu"]
        err = float(np.abs(Xg - Xc).max())
        check(np.array_equal(ig, ic) and np.array_equal(sg, sc)
              and err <= atol, f"cross-device {name}: iterations {ig} vs "
              f"{ic}, flags {sg} vs {sc}, max|dX| {err}")
        phase(f"cross-device {name}: iterations equal {ig.tolist()}, flags "
              f"equal, max |X_gpu - X_cpu| {err:.3e} <= {atol:g}")


def irls_paths(dev, card):
    """The IRLS and CG-IRLS phases, with the launch counts read from 0:
    their loops run no kernel of K1 to K6, as the JAX loops reach no
    pallas_call."""
    from sparse_solvers_tpu_torch.ops import dispatch
    t0 = time.perf_counter()
    dispatch.reset_launches()
    solver, A, Y = irls_batch_phase(dev, card)
    irls_stabilized_phase(dev, card, A)
    irls_latency_phase(card, solver, Y)
    cg_solver, cg_Y, cg_outer = irls_cg_phase(dev, card)
    Yd = torch.from_numpy(Y).to(dev)
    irls_profile(f"irls fast_trsm {A.shape[0]}x{A.shape[1]}",
                 lambda: solver.solve_batch_on_device(Yd, IRLS_TOL,
                                                      IRLS_MAX_ITER), card)
    m, n = cg_solver.shape
    irls_profile(f"irls_cg {m}x{n}",
                 lambda: cg_solver.solve_batch_on_device(cg_Y, CG_TOL,
                                                         cg_outer), card)
    irls_cross_device(dev)
    torch.cuda.synchronize()
    check(not any(dispatch.launches.values()),
          f"the IRLS paths launched {dispatch.launches}")
    phase(f"IRLS and CG-IRLS paths: launches {dict(dispatch.launches)} (none "
          f"of K1 to K6, as the JAX loops reach no pallas_call); phases "
          f"took {time.perf_counter() - t0:.2f} s")


def cosamp_phase(dev, card, m, n, k):
    """``Cosamp(A, k)`` at "highest" on ``make_sparse_problem(m, n, k, 256,
    seed=0)``, tol 1e-2, 20 rounds, through ``solve_batch_on_device``:
    every lane within the tolerance, the top-k support exact on every
    lane, the reported error against a float64 host recompute on 16 lanes,
    no launch of K1 to K6 (the counts read from 0); the median of 5 fenced
    batches with its quartiles, the rounds, the peak device memory, then
    one profiled batch."""
    from sparse_solvers_tpu_torch import Cosamp
    from sparse_solvers_tpu_torch.ops import dispatch
    name = f"cosamp {m}x{n}"
    A, X0, Y = make_sparse_problem(m, n, k, BATCH, seed=0)
    solver = Cosamp(A, k, device=dev)
    Yd = torch.from_numpy(Y).to(dev)

    def run():
        return solver.solve_batch_on_device(Yd, COSAMP_TOL, COSAMP_ROUNDS)

    dispatch.reset_launches()
    ms, q1, q3, (X, rep), peak = timed_batches(run)
    torch.cuda.synchronize()
    launches = dict(dispatch.launches)
    check(not any(launches.values()), f"{name} launched {launches}")
    Xh = X.cpu().numpy()
    errs = rep.solution_error.cpu().numpy()
    rounds = rep.iter.cpu().numpy()
    check(np.isfinite(Xh).all(), f"{name}: non-finite solution")
    within = int((errs <= COSAMP_TOL).sum())
    check(within == BATCH, f"{name}: {BATCH - within} lanes above tol")
    check_supports(name, Xh, [set(np.flatnonzero(x).tolist()) for x in X0],
                   k)
    lanes = np.arange(0, BATCH, BATCH // 16)
    gap, allowance = check_l2_certificate(name, A.astype(np.float64), Y, Xh,
                                          errs, lanes, k)
    nn_gib = n * n * 4 / 2 ** 30
    if (m, n, k) == GF_SHAPE:
        check(peak < nn_gib, f"{name}: peak {peak:.3f} GiB is not below "
              f"one n×n f32 tensor ({nn_gib:.1f} GiB)")
    plan = solver.explain(batch=BATCH, max_iterations=COSAMP_ROUNDS)
    irls_json(phase="cosamp", m=m, n=n, k=k, batch=BATCH, tol=COSAMP_TOL,
              max_rounds=COSAMP_ROUNDS, precision=plan["precision"],
              union_capacity=plan["union_capacity"], ms_per_batch=ms,
              quartiles_ms=[q1, q3], solves_per_sec=BATCH / ms * 1e3,
              max_rounds_run=int(rounds.max()),
              mean_rounds=float(rounds.mean()), lanes_within_tol=within,
              supports_exact=BATCH, max_error=float(errs.max()),
              certificate_max_gap=float(gap),
              certificate_allowance=float(allowance), launches=launches,
              peak_gib=peak, nn_f32_gib=nn_gib, card=card)
    irls_profile(name, run, card, phase="cosamp_profile")
    del solver, X, Yd
    torch.cuda.empty_cache()


def cosamp_paths(dev, card):
    """CoSaMP at the OMP workload's shape and at the gram-free shape."""
    t0 = time.perf_counter()
    for m, n, k in COSAMP_SHAPES:
        cosamp_phase(dev, card, m, n, k)
    phase(f"CoSaMP phases took {time.perf_counter() - t0:.2f} s")


def host_case(family, m, n, k, tol):
    """(the façade maker(engine, device, precision) of ``family``, A, Y,
    the truth) for a host-engine case."""
    from sparse_solvers_tpu_torch import Homotopy, Irls, IrlsCg, Omp
    if family == "irls":
        A, X0, Y = make_sparse_problem(m, n, k, HOST_BATCH, seed=0)
        Y = Y + np.random.RandomState(1).uniform(
            0, 0.02, Y.shape).astype(np.float32)

        def make(engine, where, precision=None):
            return Irls(A, engine=engine, device=where)
    elif family == "irls_cg":
        A, X0, Y = make_sparse_problem(m, n, k, HOST_BATCH, signed=True,
                                       amp=(0.5, 1.5))

        def make(engine, where, precision=None):
            return IrlsCg(A, k_sparsity=2 * k, engine=engine, device=where)
    else:
        A, X0, Y = make_sparse_problem(m, n, k, HOST_BATCH, seed=0)
        cls, kw = {"homotopy": (Homotopy, {}), "omp": (Omp, {}),
                   "gomp": (Omp, {"picks": 4})}[family]

        def make(engine, where, precision=None):
            return cls(A, engine=engine, precision=precision, device=where,
                       **kw)
    return make, A, Y, X0


def host_engine_phase(dev, card):
    """The C++ host engine on the card's machine, at problems of at most
    2¹⁶ elements: the library builds and loads (the phase fails without
    it); a card façade's "auto" plans the torch route and a CPU façade's
    the host engine; engine="native" on a card façade solves on the host
    and its solutions equal the torch route's on the card ("high" for
    Homotopy and OMP, "highest" for the IRLS family) within 1e-4
    (``Irls`` 1e-3: the host engine factors its own QR) with equal top-k
    supports; no launch of K1 to K6 on the native calls; the median
    latency of one ``solve`` (20 fenced calls) and of one 64-lane
    ``solve_batch`` (10) on each route, the torch route at its façade's
    default precision."""
    from sparse_solvers_tpu_torch.backend import native
    from sparse_solvers_tpu_torch.ops import dispatch
    t0 = time.perf_counter()
    built = native.library_path().exists()
    lib = native.get_lib()
    build_s = time.perf_counter() - t0
    check(lib is not None, f"host library did not build or load: "
          f"{native.load_error()}")
    irls_json(phase="host_engine_build", seconds=build_s,
              library=native.library_path().name, was_built_before=built,
              blas=native.blas_info(), card=card)
    for family, m, n, k, tol, max_it in HOST_CASES:
        make, A, Y, X0 = host_case(family, m, n, k, tol)
        dflt = make("auto", dev)
        routes = {where: make("auto", where).explain(
            batch=HOST_BATCH, max_iterations=max_it)["engine"]
            for where in (dev, "cpu")}
        check(routes == {dev: "torch", "cpu": "native"}, f"host {family}: "
              f"auto planned {routes}")
        host = make("native", dev)
        plan = host.explain(batch=HOST_BATCH, max_iterations=max_it)
        check(plan["engine"] == "native", f"host {family}: native planned "
              f"{plan}")
        ref = make("auto", dev, None if family.startswith("irls") else "high")
        dispatch.reset_launches()
        Xn, rn = host.solve_batch(Y, tol, max_it)
        _, r1 = host.solve(Y[0], tol, max_it)
        native_batch = fenced_ms(lambda: host.solve_batch(Y, tol, max_it),
                                 10)[0]
        native_one = fenced_ms(lambda: host.solve(Y[0], tol, max_it), 20)[0]
        torch.cuda.synchronize()
        launches = dict(dispatch.launches)
        check(not any(launches.values()), f"host {family}: the native "
              f"calls launched {launches}")
        check(Xn.device == dev, f"host {family}: X on {Xn.device}")
        Xt, rt = ref.solve_batch(Y, tol, max_it)
        _, r1t = dflt.solve(Y[0], tol, max_it)
        torch_batch = fenced_ms(lambda: dflt.solve_batch(Y, tol, max_it),
                                10)[0]
        torch_one = fenced_ms(lambda: dflt.solve(Y[0], tol, max_it), 20)[0]
        Xn_h, Xt_h = Xn.cpu().numpy(), Xt.cpu().numpy()
        dx = float(np.abs(Xn_h - Xt_h).max())
        atol = 1e-3 if family == "irls" else 1e-4
        kk = max(k, 1)
        top_n = np.sort(np.argsort(-np.abs(Xn_h), axis=1)[:, :kk], axis=1)
        top_t = np.sort(np.argsort(-np.abs(Xt_h), axis=1)[:, :kk], axis=1)
        same = int((top_n == top_t).all(axis=1).sum())
        truth = np.sort(np.argsort(-np.abs(X0), axis=1)[:, :kk], axis=1)
        recovered = int((top_n == truth).all(axis=1).sum())
        its_equal = int((rn.iter.cpu() == rt.iter.cpu()).sum())
        check(dx <= atol and same == HOST_BATCH, f"host {family}: max|dX| "
              f"{dx} (atol {atol}), supports equal on {same}/{HOST_BATCH}")
        irls_json(phase="host_engine", family=family, m=m, n=n, k=k,
                  batch=HOST_BATCH, tol=tol, max_iterations=max_it,
                  auto_route_card=routes[dev], auto_route_cpu=routes["cpu"],
                  max_abs_dx=dx, atol=atol,
                  supports_equal=same, supports_recovered=recovered,
                  iterations_equal_lanes=its_equal,
                  solve_iterations={"native": r1.iter, "torch": r1t.iter},
                  native_solve_ms=float(np.median(native_one)),
                  native_batch_ms=float(np.median(native_batch)),
                  torch_solve_ms=float(np.median(torch_one)),
                  torch_batch_ms=float(np.median(torch_batch)),
                  torch_precision=dflt.explain()["precision"],
                  launches_native=launches, card=card)


def mesh_compare(name, mesh_run, plain_run, kernels, lanes_ok, card,
                 **fields):
    """One mesh route against its plain route on the same inputs: the
    first call of each counted from 0 (kernel launches, and the mesh
    route's collectives), iterations and X compared (bit-equal expected on
    a one-rank mesh: every all-reduce and gather is a copy), every lane
    checked by ``lanes_ok(X, report)`` → (lanes ok, lanes), then the
    median of 5 fenced batches of each. Prints one JSON line; returns the
    mesh route's launches."""
    from sparse_solvers_tpu_torch.ops import collectives, dispatch
    dispatch.reset_launches()
    collectives.reset_counts()
    Xm, rm = mesh_run()
    torch.cuda.synchronize()
    l_mesh, coll = dict(dispatch.launches), dict(collectives.counts)
    dispatch.reset_launches()
    Xp, rp = plain_run()
    torch.cuda.synchronize()
    l_plain = dict(dispatch.launches)
    for kname in l_mesh:
        check(l_mesh[kname] == l_plain[kname], f"mesh {name}: {kname} "
              f"launched {l_mesh[kname]} times on the mesh, {l_plain[kname]} "
              f"on the plain route")
        check((l_mesh[kname] > 0) == (kname in kernels), f"mesh {name}: "
              f"{kname} launched {l_mesh[kname]} times")
    check(Xm.device == Xp.device and Xm.shape == Xp.shape,
          f"mesh {name}: X {Xm.shape} on {Xm.device}")
    iters_equal = bool((rm.iter == rp.iter).all())
    dx = float((Xm - Xp).abs().max())
    bit_equal = bool(torch.equal(Xm, Xp))
    check(iters_equal and dx <= 1e-5, f"mesh {name}: iterations equal "
          f"{iters_equal}, max|dX| {dx}")
    ok_mesh, lanes = lanes_ok(Xm, rm)
    ok_plain, _ = lanes_ok(Xp, rp)
    mesh_ms, mq1, mq3, _, _ = timed_batches(mesh_run)
    plain_ms, pq1, pq3, _, _ = timed_batches(plain_run)
    irls_json(phase="mesh", route=name, mesh={"data": 1, "row": 1},
              backend="nccl", **fields, mesh_ms_per_batch=mesh_ms,
              mesh_quartiles_ms=[mq1, mq3], plain_ms_per_batch=plain_ms,
              plain_quartiles_ms=[pq1, pq3], iterations_equal=iters_equal,
              max_abs_dx=dx, bit_equal=bit_equal,
              max_iterations_run=int(rm.iter.max()),
              launches_mesh=l_mesh, launches_plain=l_plain,
              all_reduce_per_solve=coll["all_reduce"],
              all_gather_per_solve=coll["all_gather"],
              all_reduce_bytes_per_solve=coll["all_reduce_bytes"],
              all_gather_bytes_per_solve=coll["all_gather_bytes"],
              lanes_ok_mesh=ok_mesh, lanes_ok_plain=ok_plain, lanes=lanes,
              card=card)
    if not bit_equal:
        phase(f"mesh {name}: X is not bit-equal to the plain route's on a "
              f"one-rank mesh (max|dX| {dx}, within 1e-5)")
    check(ok_mesh == ok_plain, f"mesh {name}: {ok_mesh} lanes ok on the "
          f"mesh, {ok_plain} on the plain route")
    return l_mesh


def certified_lanes(tol, sups, k):
    """lanes_ok for the certified greedy and Homotopy routes: the lanes
    whose reported certificate is within ``tol`` and whose top-k support
    is the truth's; all of them must be."""
    def lanes_ok(X, rep):
        errs = rep.solution_error.cpu().numpy()
        top = np.argsort(-np.abs(X.cpu().numpy()), axis=1)[:, :k]
        ok = [bool(errs[i] <= tol) and set(top[i].tolist()) == sups[i]
              for i in range(len(sups))]
        check(all(ok), f"{ok.count(False)} lanes not certified or with a "
              f"wrong support")
        return sum(ok), len(ok)
    return lanes_ok


def mesh_paths(dev, card):
    """The mesh phase: a one-rank NCCL process group on the card
    (``distributed.initialize`` through a file store, ``make_mesh(1, 1)``),
    then each façade's ``mesh=`` route against its plain route at the
    sizes of its earlier phase (``mesh_compare``): Homotopy (K1, K2, K3)
    and Omp (K1, K4) on the 4096x8192 main-path problem, both again
    gram-free at 2048x65536, the per-lane route of ``homotopy_sharded`` on
    8 lanes (no kernel), Irls at 2048x1024 (the plain route given the
    mesh's CholeskyQR2 factors), IrlsCg at 1024x65536 and Cosamp at
    4096x8192. Ends the group. Returns the summed mesh-route launches."""
    import shutil
    import tempfile
    from sparse_solvers_tpu_torch import Cosamp, Homotopy, Irls, IrlsCg, Omp
    from sparse_solvers_tpu_torch.parallel import distributed, sharding
    t0 = time.perf_counter()
    store = tempfile.mkdtemp()
    check(distributed.initialize(init_method=f"file://{store}/init",
                                 world_size=1, rank=0, backend="nccl"),
          "the NCCL group did not initialize")
    launches = {}

    def add(counts):
        for kname, count in counts.items():
            launches[kname] = launches.get(kname, 0) + count

    try:
        mesh = sharding.make_mesh(1, 1)
        check(mesh.device == dev and mesh.backend == "nccl"
              and torch.distributed.get_backend(mesh.row_group) == "nccl",
              f"mesh {mesh}: not an NCCL mesh on {dev}")
        # the main paths' problems: Homotopy on bench.py's, OMP, CoSaMP on
        # benchmarks/bench_omp.py's
        A, Y = make_problem(M, N, K_SPARSE, BATCH)
        Yd = torch.from_numpy(Y).to(dev)
        sups = true_supports()
        mesh_solver = Homotopy(A, k_max=K_MAX, mesh=mesh)
        plain = Homotopy(A, k_max=K_MAX, device=dev)
        add(mesh_compare(
            "homotopy", lambda: mesh_solver.solve_batch(Yd, TOL, MAX_ITER),
            lambda: plain.solve_batch(Yd, TOL, MAX_ITER), HOMOTOPY_KERNELS,
            certified_lanes(TOL, sups, K_SPARSE), card, m=M, n=N,
            k=K_SPARSE, batch=BATCH, max_iterations=MAX_ITER,
            precision="certified"))
        # the per-lane route of homotopy_sharded on 8 lanes (the sparse
        # regime, where the plain façade takes the per-lane core too: no
        # hand kernel), given the façade's Gram
        G = sharding.gram_replicated(mesh, A)
        add(mesh_compare(
            "homotopy_sharded per-lane", lambda: sharding.homotopy_sharded(
                mesh, A, Yd[:8], TOL, MAX_ITER, k_max=K_MAX,
                precision="certified", batch_native=False, G=G),
            lambda: plain.solve_batch(Yd[:8], TOL, MAX_ITER), (),
            certified_lanes(TOL, sups[:8], K_SPARSE), card, m=M, n=N,
            k=K_SPARSE, batch=8, max_iterations=MAX_ITER,
            precision="certified"))
        del mesh_solver, plain, G
        A, X0, Y = make_sparse_problem(M, N, K_SPARSE, BATCH, seed=0)
        Yd = torch.from_numpy(Y).to(dev)
        sups = [set(np.flatnonzero(x).tolist()) for x in X0]
        mesh_solver, plain = Omp(A, mesh=mesh), Omp(A, device=dev)
        add(mesh_compare(
            "omp", lambda: mesh_solver.solve_batch(Yd, TOL, OMP_MAX_ITER),
            lambda: plain.solve_batch(Yd, TOL, OMP_MAX_ITER), OMP_KERNELS,
            certified_lanes(TOL, sups, K_SPARSE), card, m=M, n=N, k=K_SPARSE,
            batch=BATCH, max_iterations=OMP_MAX_ITER, precision="certified"))
        mesh_solver = Cosamp(A, K_SPARSE, mesh=mesh)
        plain = Cosamp(A, K_SPARSE, device=dev)
        add(mesh_compare(
            "cosamp", lambda: mesh_solver.solve_batch(Yd, COSAMP_TOL,
                                                      COSAMP_ROUNDS),
            lambda: plain.solve_batch(Yd, COSAMP_TOL, COSAMP_ROUNDS), (),
            certified_lanes(COSAMP_TOL, sups, K_SPARSE), card, m=M, n=N,
            k=K_SPARSE, batch=BATCH, max_iterations=COSAMP_ROUNDS,
            precision="highest"))
        del mesh_solver, plain
        torch.cuda.empty_cache()
        # the gram-free paths at 2048x65536
        m, n, k = GF_SHAPE
        A, X0, Y = make_sparse_problem(m, n, k, BATCH, seed=0)
        Yd = torch.from_numpy(Y).to(dev)
        sups = [set(np.flatnonzero(x).tolist()) for x in X0]
        for label, cls, max_iter, kernels in (
                ("gram-free homotopy", Homotopy, GF_MAX_ITER,
                 HOMOTOPY_KERNELS),
                ("gram-free omp", Omp, GF_OMP_MAX_ITER, OMP_KERNELS)):
            mesh_solver = cls(A, gram=False, mesh=mesh)
            plain = cls(A, gram=False, device=dev)
            add(mesh_compare(
                label, lambda: mesh_solver.solve_batch(Yd, TOL, max_iter),
                lambda: plain.solve_batch(Yd, TOL, max_iter), kernels,
                certified_lanes(TOL, sups, k), card, m=m, n=n, k=k,
                batch=BATCH, max_iterations=max_iter, precision="certified"))
            del mesh_solver, plain
            torch.cuda.empty_cache()
        # IRLS at 2048x1024 (bench_irls_batch.py's problem); the plain
        # route takes the mesh's factors, so both iterate from one QR
        m, n = IRLS_SHAPES[0]
        A, X0, Y = make_sparse_problem(m, n, 1, IRLS_BATCH, seed=0)
        Y = Y + np.random.RandomState(1).uniform(
            0, 0.02, Y.shape).astype(np.float32)
        Yd = torch.from_numpy(Y).to(dev)
        truth = X0.argmax(axis=1)
        mesh_solver = Irls(A, mesh=mesh)
        Q, R = mesh_solver._mesh_qr()
        plain = Irls.from_numpy(A, Q=Q.cpu().numpy(), R=R.cpu().numpy(),
                                device=dev)

        def irls_lanes(X, rep):
            hit = X.argmax(dim=1).cpu().numpy() == truth
            return int(hit.sum()), len(hit)

        add(mesh_compare(
            "irls", lambda: mesh_solver.solve_batch(Yd, IRLS_TOL,
                                                    IRLS_MAX_ITER),
            lambda: plain.solve_batch(Yd, IRLS_TOL, IRLS_MAX_ITER), (),
            irls_lanes, card, m=m, n=n, batch=IRLS_BATCH,
            max_iterations=IRLS_MAX_ITER, precision="highest",
            factorization="CholeskyQR2 on the mesh, given to both"))
        # CG-IRLS at 1024x65536 (bench_irls_cg.py's second configuration)
        m, n, k, batch, max_outer, cg_max = CG_CONFIGS[1]
        A, X0, Y = make_sparse_problem(m, n, k, batch, signed=True,
                                       amp=(0.5, 1.5))
        Yd = torch.from_numpy(Y).to(dev)
        sups = [set(np.flatnonzero(x).tolist()) for x in X0]
        mesh_solver = IrlsCg(A, k_sparsity=2 * k, cg_max_iterations=cg_max,
                             mesh=mesh)
        plain = IrlsCg(A, k_sparsity=2 * k, cg_max_iterations=cg_max,
                       device=dev)

        def cg_lanes(X, rep):
            top = np.argsort(-np.abs(X.cpu().numpy()), axis=1)[:, :k]
            ok = [set(top[i].tolist()) == sups[i]
                  and not bool(rep.spd_failure[i]) for i in range(batch)]
            check(all(ok), f"irls_cg: {ok.count(False)} lanes missed")
            return sum(ok), len(ok)

        add(mesh_compare(
            "irls_cg", lambda: mesh_solver.solve_batch(Yd, CG_TOL,
                                                       max_outer),
            lambda: plain.solve_batch(Yd, CG_TOL, max_outer), (), cg_lanes,
            card, m=m, n=n, k=k, batch=batch, max_iterations=max_outer,
            cg_max=cg_max, precision="highest"))
        del mesh_solver, plain
        torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    phase(f"mesh phases took {time.perf_counter() - t0:.2f} s; launches "
          f"{launches}")
    return launches


# the examples (examples_torch/): the six single-process ones at their
# defaults, then batch_recovery and greedy_pursuit at bench.py's workload
# through their own arguments; the kernels each run must launch beside
# those its plans name (Homotopy driver K1, K2, K3; OMP driver K1, K4)
EXAMPLES = ("batch_recovery", "irls_recovery", "serving_loop",
            "basis_pursuit", "greedy_pursuit", "lasso_path")
EXAMPLES_FULL = {"batch_recovery": HOMOTOPY_KERNELS,
                 "greedy_pursuit": HOMOTOPY_KERNELS + OMP_KERNELS}
SHARDED_TIMEOUT_S = 300


def load_example(name):
    """``examples_torch/<name>.py`` as a module (its ``main(argv)``
    returns the numbers it prints)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_example(name, out):
    """The example's returned numbers: every support recovered, no failed
    certificate, the probe's column 7, the lasso path's KKT identity."""
    if name == "batch_recovery":
        check(out["support_recovered"] == out["batch"]
              and out["single_solution_error"] <= 1e-2,
              f"batch_recovery: {out}")
    elif name == "irls_recovery":
        check(out["atoms_identified"] == out["batch"],
              f"irls_recovery: {out}")
    elif name == "serving_loop":
        check(out["failed"] == 0 and out["probe_column"] == 7,
              f"serving_loop: {out}")
    elif name == "basis_pursuit":
        check(out["support_recovered"] == out["batch"]
              and out["max_abs_err"] < 1e-2, f"basis_pursuit: {out}")
    elif name == "greedy_pursuit":
        check(all(out[r]["support_recovered"] == out["batch"]
                  for r in ("omp", "homotopy", "gomp"))
              and out["omp"]["mean_iterations"] == out["k"],
              f"greedy_pursuit: {out}")
    elif name == "lasso_path":
        # ‖Aᵀ(y−Ax_t)‖∞ = λ_t, recomputed on the host in float32
        check(out["recovered"] and out["breakpoints"] > 1
              and out["kkt_err"] <= 1e-4 * out["lambdas"][0],
              f"lasso_path: {out}")


def example_run(name, args, card, expect=()):
    """One example's ``main(args)`` on the card with the launch counts set
    to 0 just before and read just after: each kernel its plans name (and
    each of ``expect``) launched, no other; every route on the card; its
    numbers checked. One JSON line; returns the launches."""
    from sparse_solvers_tpu_torch.ops import dispatch
    module = load_example(name)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    out = module.main(list(args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(dispatch.launches)
    named = set(out["kernels"])
    check(named >= set(expect), f"example {name} {args}: its plans name "
          f"{sorted(named)}, not {sorted(expect)}")
    for kname, count in launches.items():
        check((count > 0) == (kname in named), f"example {name} {args}: "
              f"{kname} launched {count} times; its plans name "
              f"{sorted(named)}")
    check(set(out["engines"]) == {"torch"}, f"example {name}: engines "
          f"{out['engines']} (a card façade keeps its work on the card)")
    check_example(name, out)
    numbers = {k: v for k, v in out.items()
               if k not in ("kernels", "engines", "lambdas", "supports")}
    irls_json(phase="examples", example=name, args=list(args),
              wall_s=wall, launches=launches, kernels=sorted(named),
              **numbers, card=card)
    return launches


def sharded_example(card):
    """``examples_torch/sharded_recovery.py`` under ``torch.distributed.run
    --standalone --nproc-per-node=1``: one NCCL rank on the card, its own
    process (and session, killed whole past ``SHARDED_TIMEOUT_S``). Its
    exit code must be 0 and each of its "matches" flags True."""
    import os
    import signal
    env = {k: v for k, v in os.environ.items()
           if k != "SS_SHARDED_DEMO_CPU"}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=1", str(ROOT / "examples_torch" /
                                   "sharded_recovery.py")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=SHARDED_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"sharded_recovery ran past {SHARDED_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        phase(f"  sharded_recovery: {line}")
    check(proc.returncode == 0, f"sharded_recovery exited "
          f"{proc.returncode}: {err[-3000:]}")
    flags = re.findall(r"matches [^:]*: (True|False)", out)
    check(len(flags) >= 2 and all(f == "True" for f in flags),
          f"sharded_recovery: matches flags {flags}")
    check("(cuda, nccl)" in out, "sharded_recovery: not an NCCL mesh on "
          "the card")
    irls_json(phase="examples", example="sharded_recovery",
              launcher="torch.distributed.run --standalone "
                       "--nproc-per-node=1", wall_s=wall,
              matches=[f == "True" for f in flags], card=card)


def examples_phase(card):
    """The examples on the card (``example_run``), then the sharded one
    (``sharded_example``). Returns the summed launches of the in-process
    runs."""
    t0 = time.perf_counter()
    launches = {}
    runs = [(name, ()) for name in EXAMPLES]
    runs += [(name, ("4096", "8192", "64", "256")) for name in EXAMPLES_FULL]
    for name, args in runs:
        for kname, count in example_run(
                name, args, card,
                EXAMPLES_FULL[name] if args else ()).items():
            launches[kname] = launches.get(kname, 0) + count
        torch.cuda.empty_cache()
    sharded_example(card)
    phase(f"examples took {time.perf_counter() - t0:.2f} s; launches "
          f"{launches}")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    # engine="jax" on a CPU façade of at most 2¹⁶ elements warns that
    # "auto" would take the host engine: the cross-device phases pin the
    # torch route on their CPU twins on purpose
    warnings.filterwarnings("ignore", "engine='jax' on a", RuntimeWarning)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    phase(card)
    phase(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)

    from sparse_solvers_tpu_torch.ops import dispatch
    from sparse_solvers_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    build.library()
    phase(f"build: {time.perf_counter() - t0:.2f} s (nvcc and load, "
          f"{build.library_path().name})")

    def tiered(check_k, tiers, top):
        """K2 or K4 at each tier of its paths; the JSON line keeps the top
        tier of Homotopy or of the certified OMP path, with the largest
        error of the tiers."""
        res = {K: check_k(dev, card, K) for K in tiers}
        return dict(res[top], max_abs_err=max(r["max_abs_err"]
                                              for r in res.values()))

    results = {"normal_matvec_fused_bf16": check_k1(dev, card),
               "find_max_gamma_fused": tiered(check_k2, SCAN_TIERS, K_MAX),
               "transition": k3_phases(dev, card)}
    # K1 and K2 at the gram-free paths' shape (phase lines; the JSON line
    # keeps the main path's)
    gf_m, gf_n, _ = GF_SHAPE
    check_k1(dev, card, gf_m, gf_n)
    check_k2(dev, card, GF_MAX_ITER + 1, gf_n)
    torch.cuda.empty_cache()
    results["omp_insert"] = tiered(check_k4, OMP_TIERS + GOMP_TIERS,
                                   OMP_MAX_ITER)
    fused_errs = check_k5_k6(dev, card)
    torch.cuda.synchronize()
    # each main path counts its own launches from 0; the JSON line sums them
    launches = main_path(dev, card)
    for name, count in omp_paths(dev, card).items():
        launches[name] += count
    dispatch.reset_launches()
    fused = fused_roofline_path(dev, card)
    torch.cuda.synchronize()
    for name, count in dispatch.launches.items():
        if name in FUSED_KERNELS:
            check(count > 0, f"the roofline path never launched {name}")
        else:
            check(count == 0, f"the roofline path launched {name}")
        launches[name] += count
    phase(f"roofline path launches {dict(dispatch.launches)}")
    for name in FUSED_KERNELS:
        ms, plain, library, b_ms, by = fused[name][FUSED_REPORTED]
        results[name] = result(fused_errs[name], ms, plain, library, b_ms,
                               by)
    for name, count in gram_free_paths(dev, card).items():
        launches[name] += count
    core_paths(dev, card)
    omp_core_paths(dev, card)
    torch.cuda.synchronize()
    cross_device(dev)
    torch.cuda.synchronize()
    irls_paths(dev, card)
    cosamp_paths(dev, card)
    host_engine_phase(dev, card)
    # the mesh routes run K1 to K4 behind the collectives: their launches
    # join the JSON line's
    for name, count in mesh_paths(dev, card).items():
        launches[name] += count
    # the examples at their defaults and at full width: their launches
    # join the JSON line's too
    for name, count in examples_phase(card).items():
        launches[name] += count
    phase(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    kernels = []
    for name, res in results.items():
        source, replaces = dispatch.KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **res})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
