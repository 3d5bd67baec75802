"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written Hopper kernels from ``sparse_solvers_tpu_torch/
csrc`` with nvcc, holds each against its plain PyTorch twin on the card at
the shapes of the main path, then drives the main path — a batched
``Homotopy`` at precision "certified" on a 4096x8192 f32 sensing matrix,
k=64-sparse signals, batch 256, tol 1e-2, k_max 96, 128 iterations (the
workload of ``bench.py``) — and checks that every lane is certified,
recovers its true support, and went through all three kernels. Ends with a
small cross-device check of the port on the card against the port on the
CPU. Any failed check raises, so the script exits non-zero and never prints
its last line. Needs one CUDA card; imports nothing of JAX.

Output: phases on earlier lines, then one JSON line of per-kernel results,
then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

M, N, K_SPARSE, BATCH = 4096, 8192, 64, 256
TOL, K_MAX, MAX_ITER = 1e-2, 96, 128


def phase(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, prepare=None, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call, from CUDA events around
    each call; ``prepare()`` (untimed) runs before every call."""
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


def k3_inputs(b, K, n, rows=128, seed=3):
    """Valid active-set states (random SPD Grams) with insert lanes,
    removals at p != last and p == last, frozen lanes and a degenerate
    insert — the mix of tests/test_transition_kernel.py at K=96."""
    rng = np.random.RandomState(seed)
    inv = np.zeros((b, K, K), np.float32)
    gk = np.zeros((b, K, K), np.float32)
    ind = np.full((b, K), n, np.int32)
    xa, da, ca, u1 = (np.zeros((b, K), np.float32) for _ in range(4))
    kk = np.zeros(b, np.int32)
    idx = np.zeros(b, np.int32)
    vtv = np.zeros(b, np.float32)
    live = np.ones(b, bool)
    pres = np.zeros(b, bool)
    for lane in range(b):
        k = rng.randint(2, K - 1)
        cols = rng.choice(n, k + 1, replace=False)
        Ag = rng.randn(rows, k + 1) / np.sqrt(rows)
        g = Ag.T @ Ag
        inv[lane, :k, :k] = np.linalg.inv(g[:k, :k])
        gk[lane, :k, :k] = g[:k, :k]
        ind[lane, :k] = cols[:k]
        xa[lane, :k] = rng.randn(k)
        da[lane, :k] = rng.randn(k)
        ca[lane, :k] = rng.randn(k)
        kk[lane] = k
        kind = lane % 4
        if kind == 0 or kind == 2:              # remove at p != l / p == l
            pres[lane] = True
            idx[lane] = ind[lane, k - 1 if kind == 2 else rng.randint(k - 1)]
        else:                                   # insert column cols[k]
            idx[lane] = cols[k]
            u1[lane, :k] = g[k, :k]
            vtv[lane] = g[k, k]
            live[lane] = kind == 1 or lane % 8 == 3   # half of kind 3 frozen
    # degenerate insert: orthonormal active columns, inserted column equal
    # to active column 0 -> den = 1 - 1 = 0 exactly
    d = 5
    inv[d], gk[d] = 0, 0
    inv[d, 0, 0] = inv[d, 1, 1] = gk[d, 0, 0] = gk[d, 1, 1] = 1.0
    ind[d] = n
    ind[d, :2] = (0, 1)
    xa[d], da[d], ca[d], u1[d] = 0, 0, 0, 0
    xa[d, 0], da[d, 0], ca[d, 0], u1[d, 0] = 0.5, 1.0, 0.3, 1.0
    kk[d], idx[d], vtv[d], live[d], pres[d] = 2, 5, 1.0, True, False
    gamma = (rng.rand(b) * 0.1).astype(np.float32)
    cnew = rng.randn(b).astype(np.float32)
    doins = live & ~pres & (kk < K)
    dorm = live & pres
    return (inv, gk, xa, da, ca, ind, u1, idx, kk, gamma, vtv, cnew, live,
            doins, dorm)


def check_k3(dev, card):
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    b, K, n = BATCH, K_MAX, N
    tol = 0.01
    host = k3_inputs(b, K, n)
    base = [torch.from_numpy(a).to(dev) for a in host]
    work = [t.clone() for t in base]
    deg = K3.transition(*work, tol, n)
    ref = K3.transition_plain(*base, tol, n)
    torch.cuda.synchronize()
    live = base[12]
    check(torch.equal(work[5], ref[5]), "K3: indices differ from the twin")
    check(torch.equal(deg, ref[6]), "K3: deg differs from the twin")
    check(bool(deg[5]) and int(deg.sum()) == 1,
          "K3: exactly the planted degenerate insert must flag deg")
    for t, t0 in zip(work[:6], base[:6]):
        check(torch.equal(t[~live], t0[~live]),
              "K3: frozen lanes not bit-identical")
        check(torch.equal(t[5], t0[5]),
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
    phase(f"K3 transition b={b} K={K}: indices and deg exact, frozen lanes "
          f"bit-identical, floats within 1e-5 relative (max|err| "
          f"{err:.3e}); lanes {counts}; kernel {ms:.4f} ms, twin "
          f"{plain:.4f} ms [{card}]")
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


def time_main_path(solver, Y, dev, card, runs: int = 10):
    """Wall time of ``solve_batch_on_device`` per batch, each run fenced
    by ``torch.cuda.synchronize()``, after one warm-up."""
    Yd = torch.from_numpy(Y).to(dev)
    solver.solve_batch_on_device(Yd, TOL, MAX_ITER)
    torch.cuda.synchronize()
    times, resolve = [], 0
    for _ in range(runs):
        t0 = time.perf_counter()
        _, r = solver.solve_batch_on_device(Yd, TOL, MAX_ITER)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        e = r.solution_error.cpu().numpy()
        resolve += int(((~(e <= TOL)) & (r.iter.cpu().numpy()
                                         < MAX_ITER)).sum())
    q1, dt, q3 = np.percentile(times, [25, 50, 75])
    phase(f"main path timing (solve_batch_on_device, {runs} fenced runs): "
          f"median {dt * 1e3:.3f} ms/batch (quartiles {q1 * 1e3:.3f}, "
          f"{q3 * 1e3:.3f}), {BATCH / dt:.1f} solves/s, path iterations "
          f"{int(r.iter.max())}, lanes needing the re-solve {resolve} of "
          f"{runs * BATCH} [{card}]")


def main_path(dev, card):
    import bench
    from sparse_solvers_tpu_torch import Homotopy
    from sparse_solvers_tpu_torch.ops import dispatch

    A, Y = bench.make_problem(M, N, K_SPARSE, BATCH)
    solver = Homotopy(A, k_max=K_MAX, precision="certified", device=dev)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    X, rep = solver.solve_batch(Y, TOL, MAX_ITER)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = dict(dispatch.launches)
    phase(f"main path: solve_batch {M}x{N} k={K_SPARSE} batch={BATCH} "
          f"tol={TOL} k_max={K_MAX} max_iter={MAX_ITER} certified: first "
          f"call {first:.3f} s (Gram included); launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"main path never launched kernel {name}")
    # timed before the host-side checks below, whose multi-threaded numpy
    # BLAS would compete for the cores that launch the solver's kernels
    time_main_path(solver, Y, dev, card)

    Xh = X.cpu().numpy()
    errs = rep.solution_error.cpu().numpy()
    iters = rep.iter.cpu().numpy()
    check(np.isfinite(Xh).all(), "main path: non-finite solution")
    check(bool((errs <= TOL).all()),
          f"main path: {int((~(errs <= TOL)).sum())} lanes above tol")
    sups = true_supports()
    top = np.argsort(-np.abs(Xh), axis=1)[:, :K_SPARSE]
    wrong = [i for i in range(BATCH) if set(top[i].tolist()) != sups[i]]
    check(not wrong, f"main path: support wrong on lanes {wrong[:8]}")
    lanes = np.arange(0, BATCH, BATCH // 16)
    A64 = A.astype(np.float64)
    c = (Y[lanes].astype(np.float64) - Xh[lanes].astype(np.float64) @ A64.T) @ A64
    cert = np.abs(c).max(axis=1)
    check(np.allclose(errs[lanes], cert, rtol=1e-4, atol=0),
          f"main path: certificate vs float64 host recompute "
          f"{errs[lanes]} vs {cert}")
    phase(f"main path: {BATCH}/{BATCH} lanes certified <= {TOL} (max "
          f"{errs.max():.4e}), top-{K_SPARSE} support exact on every lane, "
          f"certificate = float64 host recompute to rtol 1e-4 on "
          f"{len(lanes)} lanes; path iterations max {iters.max()} mean "
          f"{iters.mean():.1f}")
    return launches


def cross_device(dev):
    import bench
    from sparse_solvers_tpu_torch import Homotopy
    A, Y = bench.make_problem(256, 512, 8, 8, seed=5)
    out = {}
    for where in (dev, "cpu"):
        s = Homotopy(A, k_max=64, precision="high", device=where)
        X, rep = s.solve_batch(Y, TOL, 64)
        out[where] = (X.cpu().numpy(), rep.iter.cpu().numpy())
    (Xg, ig), (Xc, ic) = out[dev], out["cpu"]
    check(np.array_equal(ig, ic), f"cross-device: iterations {ig} vs {ic}")
    err = float(np.abs(Xg - Xc).max())
    check(err <= 1e-5, f"cross-device: max |X_gpu - X_cpu| = {err}")
    phase(f"cross-device 256x512 k=8 batch 8 high: iterations equal "
          f"{ig.tolist()}, max |X_gpu - X_cpu| {err:.3e}")


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
               "transition": check_k3(dev, card)}
    torch.cuda.synchronize()
    launches = main_path(dev, card)
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
