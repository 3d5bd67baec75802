"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written Hopper kernels from ``sparse_solvers_tpu_torch/
csrc`` with nvcc and holds each against its plain PyTorch twin on the card
at the shapes of the main paths (K3 also at K=200, past a block's shared
memory). Then it drives the three main paths on a 4096x8192 f32 sensing
matrix with k=64-sparse signals, batch 256, tol 1e-2, each at precision
"certified":

  * ``Homotopy``, k_max 96, 128 iterations (the workload of ``bench.py``);
  * ``Omp``, max_iterations 72, so k_max 72 (``benchmarks/bench_omp.py``);
  * ``Omp(picks=4)`` (gOMP), max_iterations 128, on the same problem;

and checks that every lane is certified, recovers its true support, and
went through the kernels of its path (Homotopy K1, K2, K3; OMP K1, K4).
Ends with small cross-device checks of the port on the card against the
port on the CPU. Any failed check raises, so the script exits non-zero and
never prints its last line. Needs one CUDA card; imports nothing of JAX.

Output: phases on earlier lines, then one JSON line of per-kernel results,
then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

from pathlib import Path

import numpy as np
import torch

# the seeded numpy cases the card tests use (numpy only, no jax)
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from _torch_cases import omp_insert_case, transition_mix  # noqa: E402

M, N, K_SPARSE, BATCH = 4096, 8192, 64, 256
TOL, K_MAX, MAX_ITER = 1e-2, 96, 128
OMP_MAX_ITER, GOMP_MAX_ITER, GOMP_PICKS = 72, 128, 4
HOMOTOPY_KERNELS = ("normal_matvec_fused_bf16", "find_max_gamma_fused",
                    "transition")
OMP_KERNELS = ("normal_matvec_fused_bf16", "omp_insert")


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


def check_k1(dev, card):
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    g = torch.Generator(device=dev).manual_seed(1)
    A = torch.randn(M, N, generator=g, device=dev)
    A16 = (A / A.norm(dim=0)).to(torch.bfloat16)
    D = torch.randn(BATCH, N, generator=g, device=dev)
    Q = K1.normal_matvec_fused_bf16(A16, D)
    Qp = K1.normal_matvec_fused_bf16_plain(A16, D)
    torch.cuda.synchronize()
    err = float((Q - Qp).abs().max())
    # An element of P = bf16(D·A16ᵀ) may land on the neighbouring bf16
    # value (relative step 2^-8) when the fp32 sums run in another order;
    # each such flip moves a Q element by about 2^-8·|P_i|·|A_ij|, so
    # 1e-3·max|Q| leaves room for many flips per row.
    bound = 1e-3 * float(Qp.abs().max())
    check(bool(torch.isfinite(Q).all()), "K1: non-finite output")
    check(err <= bound, f"K1: max |Q - twin| = {err} > {bound}")
    check(torch.equal(Q, K1.normal_matvec_fused_bf16(A16, D)),
          "K1: two runs on the same inputs differ (it has no split-K)")
    ms = time_ms(lambda: K1.normal_matvec_fused_bf16(A16, D))
    plain = time_ms(lambda: K1.normal_matvec_fused_bf16_plain(A16, D))
    phase(f"K1 normal_matvec_fused_bf16 b={BATCH} m={M} n={N}: max|err| "
          f"{err:.3e} <= {bound:.3e} (1e-3*max|Q|), repeat run "
          f"bit-identical; kernel {ms:.4f} ms, "
          f"twin {plain:.4f} ms [{card}]")
    return err, ms, plain


def check_k2(dev, card):
    from sparse_solvers_tpu_torch.ops.cuda import scan as K2
    rng = np.random.RandomState(2)
    b, n, K = BATCH, N, K_MAX
    q = rng.uniform(-0.5, 0.5, (b, n)).astype(np.float32)
    c = rng.uniform(-0.5, 0.5, (b, n)).astype(np.float32)
    c_inf = np.ones(b, np.float32)
    mask = np.zeros((b, n), np.int8)
    ind = np.full((b, K), n, np.int32)
    xa = np.zeros((b, K), np.float32)
    da = np.zeros((b, K), np.float32)
    for lane in range(b):
        k = rng.randint(1, K + 1)
        cols = rng.choice(n, k, replace=False)
        mask[lane, cols] = 1
        ind[lane, :k] = cols
        xa[lane, :k] = rng.uniform(0.5, 1.0, k)
        da[lane, :k] = rng.uniform(-1.0, 1.0, k)
    # planted exact ties on cleared lanes, where every other candidate is
    # >= 1/3: lane 0, two inactive positions; lanes 1 and 2, an active
    # slot against an inactive position after / before it; lane 3 has no
    # valid candidate at all
    mask[:4], ind[:4], xa[:4], da[:4] = 0, n, 0.0, 0.0
    for lane, pos in ((0, 700), (0, 5000), (1, 4000), (2, 300)):
        c[lane, pos], q[lane, pos] = 0.5, -1.0   # (1-0.5)/(1+1) = 0.25
    for lane, pos in ((1, 300), (2, 4000)):
        mask[lane, pos], ind[lane, 0] = 1, pos
        xa[lane, 0], da[lane, 0] = 0.25, -1.0    # -0.25/-1 = 0.25
    q[3], c[3], c_inf[3] = 0.0, 0.0, 0.0
    args = [torch.from_numpy(a).to(dev) for a in
            (q, c, mask, c_inf, xa, da, ind)]
    gam, idx = K2.find_max_gamma_fused(*args)
    gp, ip = K2.find_max_gamma_fused_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(idx, ip), "K2: idx differs from the twin")
    check(torch.equal(gam, gp), "K2: gamma not bit-identical to the twin")
    got = idx[:4].tolist()
    check(got == [700, 300, 300, 0], f"K2: planted lanes gave {got}")
    check(float(gam[3]) == float(np.finfo(np.float32).max),
          "K2: no-candidate lane must give FLT_MAX")
    err = float((gam - gp).abs().max())
    ms = time_ms(lambda: K2.find_max_gamma_fused(*args))
    plain = time_ms(lambda: K2.find_max_gamma_fused_plain(*args))
    phase(f"K2 find_max_gamma_fused b={b} n={n} K={K}: idx exact, gamma "
          f"bit-exact, planted ties {got}; kernel {ms:.4f} ms, twin "
          f"{plain:.4f} ms [{card}]")
    return err, ms, plain


def check_k3(dev, card, K):
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    b, n = BATCH, N
    tol = 0.01
    base = [torch.from_numpy(a).to(dev) for a in transition_mix(b, K, n)]
    work = [t.clone() for t in base]
    deg = K3.transition(*work, tol, n)
    ref = K3.transition_plain(*base, tol, n)
    torch.cuda.synchronize()
    live = base[12]
    check(torch.equal(work[5], ref[5]), "K3: indices differ from the twin")
    check(torch.equal(deg, ref[6]), "K3: deg differs from the twin")
    check(bool(deg[1]) and int(deg.sum()) == 1,
          "K3: exactly the planted degenerate insert must flag deg")
    for t, t0 in zip(work[:6], base[:6]):
        check(torch.equal(t[~live], t0[~live]),
              "K3: frozen lanes not bit-identical")
        check(torch.equal(t[1], t0[1]),
              "K3: degenerate lane not left untouched")
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
    plain = time_ms(lambda: K3.transition_plain(*base, tol, n))
    counts = {"insert": int(base[13].sum()), "remove": int(base[14].sum()),
              "frozen": int((~live).sum()), "degenerate": int(deg.sum())}
    where = ("shared memory" if K3.fits_shared_memory(K, dev)
             else "device memory, in place")
    phase(f"K3 transition b={b} K={K} (inv and gk in {where}): indices and "
          f"deg exact, frozen lanes bit-identical, floats within 1e-5 "
          f"relative (max|err| {err:.3e}); lanes {counts}; kernel "
          f"{ms:.4f} ms, twin {plain:.4f} ms [{card}]")
    return err, ms, plain


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
    plain = time_ms(lambda: K4.omp_insert_plain(*base))
    phase(f"K4 omp_insert b={b} K={K}: deg exact, lanes not gated "
          f"bit-identical, floats within 1e-5 relative (max|err| "
          f"{err:.3e}); lanes gated {int(gated.sum())}, frozen "
          f"{int((~base[5]).sum())}, degenerate {int(deg.sum())}; kernel "
          f"{ms:.4f} ms, twin {plain:.4f} ms [{card}]")
    return err, ms, plain


def true_supports():
    """The supports bench.make_problem draws, replayed from its seed in
    its draw order (A first, then per lane the support and the values)."""
    rng = np.random.RandomState(0)
    rng.randn(M, N)
    sups = []
    for _ in range(BATCH):
        sups.append(set(rng.choice(N, K_SPARSE, replace=False).tolist()))
        rng.uniform(0.5, 1.0, K_SPARSE)
    return sups


def time_path(name, solver, Y, dev, card, max_iter, runs: int = 10):
    """Wall time of ``solve_batch_on_device`` per batch, each run fenced
    by ``torch.cuda.synchronize()``, after one warm-up; counts the lanes
    whose certificate misses the tolerance (``solve_batch`` re-solves
    them)."""
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


def run_path(name, solver, Y, dev, card, max_iter, kernels):
    """One ``solve_batch`` with the launch counts set to 0 just before and
    read just after; fails unless each of ``kernels`` launched and no
    other kernel did. Then the timed runs."""
    from sparse_solvers_tpu_torch.ops import dispatch
    dispatch.reset_launches()
    t0 = time.perf_counter()
    X, rep = solver.solve_batch(Y, TOL, max_iter)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = dict(dispatch.launches)
    phase(f"{name}: solve_batch {M}x{N} k={K_SPARSE} batch={BATCH} "
          f"tol={TOL} max_iter={max_iter} certified: first call "
          f"{first:.3f} s (Gram included); launches {launches}")
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


def check_supports(name, Xh, sups):
    top = np.argsort(-np.abs(Xh), axis=1)[:, :K_SPARSE]
    wrong = [i for i in range(BATCH) if set(top[i].tolist()) != sups[i]]
    check(not wrong, f"{name}: support wrong on lanes {wrong[:8]}")


def main_path(dev, card):
    import bench
    from sparse_solvers_tpu_torch import Homotopy

    A, Y = bench.make_problem(M, N, K_SPARSE, BATCH)
    solver = Homotopy(A, k_max=K_MAX, precision="certified", device=dev)
    Xh, errs, iters, launches = run_path("homotopy main path", solver, Y,
                                         dev, card, MAX_ITER,
                                         HOMOTOPY_KERNELS)
    check_supports("homotopy main path", Xh, true_supports())
    lanes = np.arange(0, BATCH, BATCH // 16)
    A64 = A.astype(np.float64)
    c = (Y[lanes].astype(np.float64) - Xh[lanes].astype(np.float64) @ A64.T) @ A64
    cert = np.abs(c).max(axis=1)
    check(np.allclose(errs[lanes], cert, rtol=1e-4, atol=0),
          f"homotopy main path: certificate vs float64 host recompute "
          f"{errs[lanes]} vs {cert}")
    phase(f"homotopy main path: {BATCH}/{BATCH} lanes certified <= {TOL} "
          f"(max {errs.max():.4e}), top-{K_SPARSE} support exact on every "
          f"lane, certificate = float64 host recompute to rtol 1e-4 on "
          f"{len(lanes)} lanes; path iterations max {iters.max()} mean "
          f"{iters.mean():.1f}")
    return launches


def omp_problem():
    """benchmarks/bench_omp.py's problem, drawn in the order of
    benchmarks/_common.py::make_sparse_problem (seed 0, unsigned
    amplitudes 0.5 to 1.0): A (f32, unit columns), X, Y = X·Aᵀ."""
    rng = np.random.RandomState(0)
    A = rng.randn(M, N).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((BATCH, N), np.float32)
    for b in range(BATCH):
        sup = rng.choice(N, K_SPARSE, replace=False)
        X[b, sup] = rng.uniform(0.5, 1.0, K_SPARSE)
    return A, X, (X @ A.T).astype(np.float32)


def omp_paths(dev, card):
    """The certified OMP and gOMP main paths on one problem."""
    from sparse_solvers_tpu_torch import Omp

    A, X0, Y = omp_problem()
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
        # ‖y − Ax‖₂ in float64 on the host, against the certificate. Once
        # the support is complete the residual sits at the f32 rounding
        # floor, so beside rtol 1e-4 each lane is allowed the f32
        # evaluation bound of r = y − Ax: (k + 2)·2⁻²⁴·‖|y| + |x|·|A|ᵀ‖₂
        Yl, Xl = Y[lanes].astype(np.float64), Xh[lanes].astype(np.float64)
        ref = np.linalg.norm(Yl - Xl @ A64.T, axis=1)
        slack = (K_SPARSE + 2) * 2.0 ** -24 * np.linalg.norm(
            np.abs(Yl) + np.abs(Xl) @ np.abs(A64).T, axis=1)
        gap = np.abs(errs[lanes] - ref)
        check(bool((gap <= 1e-4 * ref + slack).all()),
              f"{name}: certificate vs float64 host recompute "
              f"{errs[lanes]} vs {ref} (slack {slack})")
        phase(f"{name}: plan tiers {plan['capacity_tiers']}, k_max "
              f"{plan['k_max']}, picks {picks}; {BATCH}/{BATCH} lanes "
              f"certified <= {TOL} (max {errs.max():.4e}), top-{K_SPARSE} "
              f"support exact on every lane, certificate = float64 host "
              f"recompute within rtol 1e-4 + f32 evaluation bound on "
              f"{len(lanes)} lanes (max gap {gap.max():.3e}, max bound "
              f"{(1e-4 * ref + slack).max():.3e}); iterations max "
              f"{iters.max()} mean {iters.mean():.1f}; q passes {k1}, K4 "
              f"calls {k4}")
        for kname, count in launches.items():
            counts[kname] = counts.get(kname, 0) + count
    return counts


def cross_device(dev):
    import bench
    from sparse_solvers_tpu_torch import Homotopy, Omp
    A, Y = bench.make_problem(256, 512, 8, 8, seed=5)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
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

    results = {"normal_matvec_fused_bf16": check_k1(dev, card),
               "find_max_gamma_fused": check_k2(dev, card),
               "transition": check_k3(dev, card, K_MAX)}
    check_k3(dev, card, 200)
    # K4 at the OMP and gOMP paths' capacities; the JSON line keeps the
    # certified OMP path's times and the larger error of the two
    k4 = [check_k4(dev, card, K) for K in (OMP_MAX_ITER, GOMP_MAX_ITER)]
    results["omp_insert"] = (max(k4[0][0], k4[1][0]),) + k4[0][1:]
    torch.cuda.synchronize()
    # each main path counts its own launches from 0; the JSON line sums them
    launches = main_path(dev, card)
    for name, count in omp_paths(dev, card).items():
        launches[name] += count
    torch.cuda.synchronize()
    cross_device(dev)
    torch.cuda.synchronize()

    kernels = []
    for name, (err, ms, plain) in results.items():
        source, replaces = dispatch.KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
