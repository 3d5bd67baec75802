"""The port's hand-written CUDA kernels against their PyTorch twins, on the
card. Every test here needs an NVIDIA GPU with nvcc and skips where torch
sees none. This file imports no jax (the card's machine has none); run it
there without the suite's jax conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The shapes are ragged on purpose (n not a multiple of 8, K=13) to reach the
kernels' masked edges, which chip_smoke.py's aligned main-path shapes do
not; K1 also runs a ragged second batch tile (b=130), bases off 16 bytes,
an aligned 256x512x1024 and a bit-identical repeat run, and on its wgmma
route the cells' shapes at b=256, ragged batches (1, 130) with m and n
multiples of 8 but not of a tile, repeat runs of the split route, a
replay of a captured CUDA graph on new D, and the ring forced at aligned
shapes and taken (and counted) for bases off 16 bytes; on integer inputs
(every sum exact in f32) both routes equal the twin bit for bit, a second
batch tile (b=300) and split ranges included. Tolerances: K1
1e-3·max|Q| (a P element may land on the neighbouring bf16 value when
the fp32 sums run in another order), K2 idx and gamma
exact (also split across a cluster, with ties planted across its chunk
boundaries and bases off 16 bytes), K3 indices and deg exact, floats 1e-5 of the tensor's scale, frozen
lanes bit-identical, vacant slots still zero (edge slots, each route on
both sides of its threshold, bases off 16 bytes); K4 deg exact, floats 1e-5 of the tensor's scale,
lanes that are not gated bit-identical; K5 and K6 1e-5·max|ref| at
"highest" and 1e-3·max|ref| at "default" (bf16 flips of the
intermediate, as K1), repeat runs bit-identical, shapes that split the
depth at each batch tile, and K6 on a residual that cancels most of its
sum exactly equal to the twin (every value exact in f32). K1 and K2 also
run at the gram-free drivers' shape (m=2048, n=65536, b=256). Drivers
(with a Gram and gram-free) and the per-lane Homotopy and OMP cores on the
card against the same code on the CPU twins at "high": iterations exact,
X atol 1e-5 (float64: 1e-10). The IRLS family, which has no hand kernel:
the triangular solves under "default" bit-equal to "highest" (TF32 pinned
off), the Cholesky SPD flag per lane, and ``Irls`` (each mode, from one
numpy QR) and ``IrlsCg`` on the card against the CPU: iterations and flags
exact, X within 1e-4 (``Irls`` float32), 1e-5 (``IrlsCg`` float32), 1e-10
(float64). ``Cosamp`` on the card against the CPU (rounds exact, X within
1e-5, float64 1e-10, planted ties exactly), and the C++ host engine behind
a card façade: CUDA tensors equal to the CPU façade's. A card façade's
"auto" keeps small problems on the card; the CPU twins of small problems
pin ``engine="jax"``, as a CPU façade's "auto" would send them to the
host engine. The span store under the CUDA-only profiler: a span holds the
device interval of the K1 launch it waited for to within 50 us, and every
sync that ``torch.cuda.set_sync_debug_mode`` reports in a certified
``solve_batch`` and ``solve`` is a ``solvers.sync`` span. The Homotopy
loops' and the OMP batch driver's CUDA graphs against the same loops
stepped eagerly over a sequence of calls that keep their graphs: X,
iterations and errors bit-equal, launch counts equal; K1 to K4 seen by
the profiler from inside graphs captured in the trace and inside graphs
kept from a call before it; OMP's captures within 1 MiB of the eager
loop's peak memory, and a façade's later calls within 1 MiB of its
first call's peak.
"""

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

from _torch_cases import (compressive_problem, degenerate_case,
                          omp_insert_case, scan_case, scan_split_case,
                          transition_case, transition_edge_case,
                          transition_mix, vacant_nonzero)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)


def _counted(name, fn):
    from sparse_solvers_tpu_torch.ops import dispatch
    before = dispatch.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert dispatch.launches[name] == before + 1
    return out


@pytest.mark.parametrize("m,n,b", [(72, 200, 5), (96, 256, 8),
                                   (64, 130, 1), (1, 8, 70), (130, 67, 65)])
def test_k1_kernel_matches_twin(dev, m, n, b):
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    g = torch.Generator(device=dev).manual_seed(m * n + b)
    A16 = torch.randn(m, n, generator=g, device=dev).to(torch.bfloat16)
    D = torch.randn(b, n, generator=g, device=dev)
    Q = _counted(K1.NAME, lambda: K1.normal_matvec_fused_bf16(A16, D))
    want = K1.normal_matvec_fused_bf16_plain(A16, D)
    assert Q.shape == (b, n) and Q.dtype == torch.float32
    err = float((Q - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()), err


def _k1_case(dev, m, n, b, offset=0):
    """A16 (m, n) bf16 and D (b, n) f32 on the card, seeded; with `offset`
    each starts that many elements into its storage, so neither base is
    16-byte aligned."""
    g = torch.Generator(device=dev).manual_seed(m * n + b + offset)
    A = torch.randn(m * n + offset, generator=g, device=dev)
    A16 = A.to(torch.bfloat16)[offset:].view(m, n)
    D = torch.randn(b * n + offset, generator=g, device=dev)[offset:]
    return A16, D.view(b, n)


@pytest.mark.parametrize("m,n,b,offset", [
    (512, 1024, 256, 0),   # aligned: many ring passes, 2x8 and 2x16 tiles
    (96, 256, 130, 0),     # the second batch tile holds 2 lanes
    (72, 200, 130, 0),
    (96, 256, 130, 1),     # bases off 16 bytes: element-wise staging
    (40, 72, 9, 3),
    (2048, 65536, 256, 0)])  # the gram-free drivers' q pass
def test_k1_ring_tiles_match_twin(dev, m, n, b, offset):
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    A16, D = _k1_case(dev, m, n, b, offset)
    assert A16.is_contiguous() and D.is_contiguous()
    Q = _counted(K1.NAME, lambda: K1.normal_matvec_fused_bf16(A16, D))
    want = K1.normal_matvec_fused_bf16_plain(A16, D)
    err = float((Q - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()), err


def test_k1_repeat_runs_bit_identical(dev):
    """No split-K and no atomics: each Q element is one block's
    fixed-order sum."""
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    A16, D = _k1_case(dev, 512, 1024, 256)
    first = K1.normal_matvec_fused_bf16(A16, D)
    assert torch.equal(first, K1.normal_matvec_fused_bf16(A16, D))


def _k1_close(Q, want):
    err = float((Q - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()), err


@pytest.mark.parametrize("m,n,b", [(4096, 8192, 256), (2048, 65536, 256)])
def test_k1_wgmma_route_at_the_cells_shapes(dev, m, n, b):
    """The cells' two K1 shapes take the wgmma route, pass 1 split (2 and
    8 ranges), and never the ring."""
    from sparse_solvers_tpu_torch.ops import dispatch
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    A16, D = _k1_case(dev, m, n, b)
    plan = K1.k1_launch_plan(b, m, n)
    assert plan.route == "wgmma" and plan.splits > 1
    rings = dispatch.fallbacks[K1.NAME]
    Q = _counted(K1.NAME, lambda: K1.normal_matvec_fused_bf16(A16, D))
    assert dispatch.fallbacks[K1.NAME] == rings
    _k1_close(Q, K1.normal_matvec_fused_bf16_plain(A16, D))


@pytest.mark.parametrize("m,n,b", [
    (72, 200, 1), (72, 200, 130),   # one lane; a 256-lane tile holding 130
    (520, 8200, 130),               # pass 1 in 8 ranges, ragged edges
    (64, 4096, 1)])                 # pass 1 in 4 ranges, one lane
def test_k1_wgmma_ragged_shapes_match_twin(dev, m, n, b):
    """Random data at ragged shapes within K1's tolerance. A second batch
    tile (b=300) is held bit-exact by test_k1_exact_on_integer_inputs: at
    136x1048 on these inputs both routes miss 1e-3·max|Q| by the same
    2.062 (the tensor cores' fp32 accumulation flips more of P's bf16
    rounds than the twin's fp32 sums; few terms in Q's sum make a flip
    large), so the shape says nothing of either route's indexing."""
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    A16, D = _k1_case(dev, m, n, b)
    assert K1.k1_launch_plan(b, m, n).route == "wgmma"
    Q = _counted(K1.NAME, lambda: K1.normal_matvec_fused_bf16(A16, D))
    assert Q.shape == (b, n)
    _k1_close(Q, K1.normal_matvec_fused_bf16_plain(A16, D))


@pytest.mark.parametrize("route", ["wgmma", "ring"])
@pytest.mark.parametrize("m,n,b", [
    (4096, 8192, 256), (2048, 65536, 256), (136, 1048, 300), (72, 200, 1),
    (520, 8200, 130), (64, 4096, 1), (96, 256, 130)])
def test_k1_exact_on_integer_inputs(dev, monkeypatch, route, m, n, b):
    """A16 and D with entries in {-2, ..., 2}: every product and partial
    sum of P and of Q is an integer below 2^24, exact in f32 in any order,
    and P's bf16 round sees the same value, so each route (its tiles,
    edges, split ranges and their sum) must equal the twin bit for bit."""
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    planner = K1.k1_launch_plan
    monkeypatch.setattr(K1, "k1_launch_plan", lambda b, m, n, aligned=True:
                        planner(b, m, n, aligned and route == "wgmma"))
    g = torch.Generator(device=dev).manual_seed(m + n + b)
    A16 = torch.randint(-2, 3, (m, n), generator=g, device=dev).to(
        torch.bfloat16)
    D = torch.randint(-2, 3, (b, n), generator=g, device=dev).float()
    assert K1.k1_launch_plan(b, m, n).route == route
    Q = _counted(K1.NAME, lambda: K1.normal_matvec_fused_bf16(A16, D))
    want = K1.normal_matvec_fused_bf16_plain(A16, D)
    assert float(want.abs().max()) < 2**24
    assert torch.equal(Q, want)


@pytest.mark.parametrize("m,n,b", [(2048, 65536, 256), (520, 8200, 130)])
def test_k1_split_route_repeat_runs_bit_identical(dev, m, n, b):
    """The split ranges are summed in a fixed order, with no atomics."""
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    A16, D = _k1_case(dev, m, n, b)
    assert K1.k1_launch_plan(b, m, n).splits > 1
    first = K1.normal_matvec_fused_bf16(A16, D)
    assert torch.equal(first, K1.normal_matvec_fused_bf16(A16, D))


@pytest.mark.parametrize("m,n,b", [(4096, 8192, 256), (2048, 65536, 256)])
def test_k1_graph_replay_on_new_d(dev, m, n, b):
    """K1 captured in a CUDA graph keeps its tensor maps by value, over
    D16, P and Q in the graph's pool: replayed on new D it matches the twin
    and equals an eager call."""
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    A16, D = _k1_case(dev, m, n, b)
    static_D = D.clone()
    K1.normal_matvec_fused_bf16(A16, static_D)    # built and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_Q = K1.normal_matvec_fused_bf16(A16, static_D)
    g = torch.Generator(device=dev).manual_seed(7)
    for _ in range(2):
        new = torch.randn(D.shape, generator=g, device=dev)
        static_D.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        _k1_close(static_Q, K1.normal_matvec_fused_bf16_plain(A16, new))
        assert torch.equal(static_Q, K1.normal_matvec_fused_bf16(A16, new))


@pytest.mark.parametrize("m,n,b", [(512, 1024, 256), (96, 256, 130),
                                   (2048, 65536, 256)])
def test_k1_ring_forced_at_aligned_shapes_matches_twin(dev, monkeypatch,
                                                       m, n, b):
    """The ring stays K1's fallback: forced where the wgmma route would
    run, it still matches the twin, and the wrapper counts it."""
    from sparse_solvers_tpu_torch.ops import dispatch
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    planner = K1.k1_launch_plan
    monkeypatch.setattr(K1, "k1_launch_plan",
                        lambda b, m, n, aligned=True: planner(b, m, n, False))
    A16, D = _k1_case(dev, m, n, b)
    rings = dispatch.fallbacks[K1.NAME]
    Q = _counted(K1.NAME, lambda: K1.normal_matvec_fused_bf16(A16, D))
    assert dispatch.fallbacks[K1.NAME] == rings + 1
    _k1_close(Q, K1.normal_matvec_fused_bf16_plain(A16, D))


@pytest.mark.parametrize("m,n,b,offset", [(4096, 8192, 256, 1),
                                          (96, 256, 130, 3)])
def test_k1_unaligned_bases_take_the_ring(dev, m, n, b, offset):
    """m and n allow TMA, but A16 starts off 16 bytes: the plan takes the
    ring and the wrapper raises its count."""
    from sparse_solvers_tpu_torch.ops import dispatch
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    A16, D = _k1_case(dev, m, n, b, offset)
    assert A16.data_ptr() % 16 != 0
    assert K1.k1_launch_plan(b, m, n, False).route == "ring"
    rings = dispatch.fallbacks[K1.NAME]
    Q = _counted(K1.NAME, lambda: K1.normal_matvec_fused_bf16(A16, D))
    assert dispatch.fallbacks[K1.NAME] == rings + 1
    _k1_close(Q, K1.normal_matvec_fused_bf16_plain(A16, D))


@pytest.mark.parametrize("n", [200, 384])
def test_k2_kernel_matches_twin(dev, n):
    from sparse_solvers_tpu_torch.ops.cuda import scan as K2
    arrays, planted = scan_case(n)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    g, i = _counted(K2.NAME, lambda: K2.find_max_gamma_fused(*args))
    gp, ip = K2.find_max_gamma_fused_plain(*args)
    assert torch.equal(i, ip) and torch.equal(g, gp)
    assert i[:4].tolist() == planted


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b", [1, 3, 256])
@pytest.mark.parametrize("n", [17, 4099, 8192, 65536])
def test_k2_split_scan_matches_twin(dev, n, b, offset):
    """The split scan at its plan's chunks, with exact ties planted across
    every chunk boundary and a lane with no valid candidate; with `offset`
    1 every (b, n) operand starts one element into its storage, so no base
    is aligned for float4 loads."""
    from sparse_solvers_tpu_torch.ops.cuda import scan as K2
    plan = K2.scan_launch_plan(b, n)
    bounds = [lo for lo, _ in plan.chunks(n)[1:]]
    arrays, expected = scan_split_case(b, n, 24, bounds)
    args = []
    for a in arrays:
        t = torch.from_numpy(a).to(dev)
        if a.ndim == 2 and a.shape[1] == n:
            store = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
            t = store[offset:].view(b, n).copy_(t)
        args.append(t)
    assert (args[0].data_ptr() % 16 == 0) == (offset == 0)
    g, i = _counted(K2.NAME, lambda: K2.find_max_gamma_fused(*args))
    gp, ip = K2.find_max_gamma_fused_plain(*args)
    assert torch.equal(i, ip) and torch.equal(g, gp)
    assert {lane: int(i[lane]) for lane in expected} == expected
    if b > 1:
        assert float(g[b - 1]) == float(np.finfo(np.float32).max)


def _k3_run_and_check(dev, arrays, tol, n, offset=0):
    """K3 on the card against its twin under the kernel's contracts:
    indices and deg exact; inv, gk, x_act, d_act and c_act within 1e-5
    of each tensor's scale; frozen and degenerate lanes bit-identical;
    every vacant slot after the call (≥ kk′) exactly zero, the sentinel
    in indices. With ``offset`` every operand starts that many elements
    into its storage (no float4 loads). Returns deg."""
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    base = [torch.from_numpy(a).to(dev) for a in arrays]
    work = []
    for t in base:
        store = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
        work.append(store[offset:].view(t.shape).copy_(t))
    deg = _counted(K3.NAME, lambda: K3.transition(*work, tol, n))
    want = K3.transition_plain(*base, tol, n)
    assert torch.equal(work[5], want[5]) and torch.equal(deg, want[6])
    for got, w in zip(work[:5], want[:5]):
        scale = max(1.0, float(w.abs().max()))
        assert float((got - w).abs().max()) <= 1e-5 * scale
    live, doins, dorm = base[12], base[13], base[14]
    untouched = ~live | deg
    for got, b0 in zip(work[:6], base[:6]):
        assert torch.equal(got[untouched], b0[untouched])
    kk = base[8].long()
    kk1 = torch.where(dorm & live, kk - 1,
                      torch.where(doins & live & ~deg, kk + 1, kk))
    state = [t.cpu().numpy() for t in work[:6]]
    assert vacant_nonzero(state, kk1.cpu().numpy(), n) == []
    return deg


@pytest.mark.parametrize("case", ["remove_p", "remove_last", "degenerate"])
def test_k3_kernel_matches_twin(dev, case):
    arrays, tol, n = (degenerate_case() if case == "degenerate" else
                      transition_case(case == "remove_last"))
    _k3_run_and_check(dev, arrays, tol, n)


@pytest.mark.parametrize("K", [200, 260])
def test_k3_kernel_matches_twin_beyond_shared_memory(dev, K):
    """inv and gk of K=200 and 260 do not fit in a block's shared memory:
    the kernel works on inv in place in device memory."""
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    assert K3.k3_launch_plan(K).route == "device"
    deg = _k3_run_and_check(dev, transition_mix(12, K, 1000), 0.01, 1000)
    assert bool(deg[1]) and int(deg.sum()) == 1


# capacities on each side of the route threshold (registers → device past
# 128) and of the register tile's column chunks (32, 64, 96), the Homotopy
# tiers, the default k_max 101, and the device route up to 260
K3_CAPACITIES = [3, 13, 24, 32, 33, 48, 64, 65, 96, 97, 101, 128, 129,
                 200, 236, 237, 260]


@pytest.mark.parametrize("K", K3_CAPACITIES)
def test_k3_edge_slots_match_twin(dev, K):
    """An insert into an empty lane and at slot K−1, removals at p = l,
    p = 0, of a lane's only member and at a full lane, a live lane that
    neither inserts nor removes, a frozen lane."""
    arrays, tol, n = transition_edge_case(K)
    deg = _k3_run_and_check(dev, arrays, tol, n)
    assert not bool(deg.any())


@pytest.mark.parametrize("mix", ["all", "insert", "remove"])
@pytest.mark.parametrize("K", [k for k in K3_CAPACITIES if k >= 5])
def test_k3_routes_match_twin_at_their_thresholds(dev, K, mix):
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    route = K3.k3_launch_plan(K).route
    assert route == ("registers" if K <= 128 else "device")
    _k3_run_and_check(dev, transition_mix(12, K, 1000, mix=mix), 0.01, 1000)


@pytest.mark.parametrize("K", [24, 96, 200, 260])
def test_k3_unaligned_bases_match_twin(dev, K):
    """Operands one element into their storage: gk's rows load one float
    at a time."""
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    assert K3.k3_launch_plan(K, aligned=False).vec == 1
    _k3_run_and_check(dev, transition_mix(12, K, 1000), 0.01, 1000,
                      offset=1)


def test_k3_device_route_with_a_workspace_matches_twin(dev):
    """Past the capacity where even the K-vectors leave shared memory,
    they live in a per-lane device workspace; small live sets keep the
    case light."""
    from sparse_solvers_tpu_torch.ops.cuda import transition as K3
    K = next(k for k in range(5000, 7000, 4)
             if K3.k3_launch_plan(k).work_floats)
    _k3_run_and_check(dev, transition_mix(4, K, 20000, k_hi=40), 0.01,
                      20000)


def test_homotopy_beyond_shared_memory_matches_cpu_twins(dev):
    """max_iterations=200 gives k_max = 201; 80-sparse signals run paths of
    162 to 182 iterations, past the tiers [56, 104] into K3 at K=201.

    Over such a path (about 45 removals) the f32 inverse gathers rounding:
    the CPU twins' X itself lies up to 6.3e-3 from the float64 oracle
    (oracle/homotopy.py, same iteration counts). So the card is held to
    the CPU twins' iteration counts exactly, to the true supports, to the
    tolerance, and to X within 1e-2."""
    from sparse_solvers_tpu_torch import Homotopy
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y, Xt = compressive_problem(256, 512, 80, 4, seed=1)
    out = {}
    dispatch.reset_launches()
    for where in (dev, "cpu"):
        solver = Homotopy(A, precision="high", device=where)
        assert solver.explain(batch=4, max_iterations=200)["k_max"] == 201
        X, rep = solver.solve_batch(Y, 0.01, 200)
        assert bool((rep.solution_error <= 0.01).all())
        X = X.cpu().numpy()
        for lane in range(4):
            top = set(np.argsort(-np.abs(X[lane]))[:80].tolist())
            assert top == set(np.flatnonzero(Xt[lane]).tolist())
        out[str(where)] = (X, rep.iter.cpu().numpy())
    (Xg, ig), (Xc, ic) = out[str(dev)], out["cpu"]
    assert ig.min() > 104, ig
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(Xg, Xc, atol=1e-2)
    assert dispatch.launches["transition"] > 0


@pytest.mark.parametrize("K", [13, 24, 40, 64, 72, 128, 300])
@pytest.mark.parametrize("b", [5, 70, 256])
def test_k4_kernel_matches_twin(dev, b, K):
    """The drivers' tiers and ragged capacities, lanes at kk = 0 and K−1;
    K=300 runs the device-memory instantiation."""
    from sparse_solvers_tpu_torch.ops.cuda import omp_insert as K4
    assert K4.k4_launch_plan(b, K).shared == (K < 300)
    base = [torch.from_numpy(a).to(dev) for a in omp_insert_case(b, K)]
    inv = base[0].clone()
    coef, deg = _counted(K4.NAME, lambda: K4.omp_insert(inv, *base[1:]))
    inv_p, coef_p, deg_p = K4.omp_insert_plain(*base)
    assert torch.equal(deg, deg_p) and bool(deg[1])
    gated = base[5] & ~deg
    assert torch.equal(inv[~gated], base[0][~gated])
    for got, want in ((inv, inv_p), (coef, coef_p)):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_driver_on_card_matches_cpu_twins(dev):
    from sparse_solvers_tpu_torch import Homotopy
    A, Y, Xt = compressive_problem(128, 256, 8, 16)
    out = {}
    for where in (dev, "cpu"):
        X, rep = Homotopy(A, k_max=41, precision="high", engine="jax",
                          device=where).solve_batch(Y, 0.01, 40)
        out[str(where)] = (X.cpu().numpy(), rep.iter.cpu().numpy())
    (Xg, ig), (Xc, ic) = out[str(dev)], out["cpu"]
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(Xg, Xc, atol=1e-5)


HOMOTOPY_KERNELS = ("normal_matvec_fused_bf16", "find_max_gamma_fused",
                    "transition")


def test_certified_driver_on_card_launches_its_kernels(dev):
    from sparse_solvers_tpu_torch import Homotopy
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y, Xt = compressive_problem(256, 512, 8, 16, seed=3)
    dispatch.reset_launches()
    X, rep = Homotopy(A, k_max=48, device=dev).solve_batch(Y, 0.01, 64)
    assert all(dispatch.launches[k] > 0 for k in HOMOTOPY_KERNELS)
    assert dispatch.launches["omp_insert"] == 0
    assert bool((rep.solution_error <= 0.01).all())
    X = X.cpu().numpy()
    for lane in range(16):
        top = set(np.argsort(-np.abs(X[lane]))[:8].tolist())
        assert top == set(np.flatnonzero(Xt[lane]).tolist())


@pytest.mark.parametrize("picks", [1, 4])
def test_omp_on_card_matches_cpu_twins(dev, picks):
    from sparse_solvers_tpu_torch import Omp
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y, Xt = compressive_problem(128, 256, 6, 16)
    out = {}
    for where in (dev, "cpu"):
        dispatch.reset_launches()
        X, rep = Omp(A, precision="high", picks=picks, engine="jax",
                     device=where).solve_batch(Y, 0.01, 24)
        out[str(where)] = (X.cpu().numpy(), rep.iter.cpu().numpy(),
                           dict(dispatch.launches))
    (Xg, ig, lg), (Xc, ic, lc) = out[str(dev)], out["cpu"]
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(Xg, Xc, atol=1e-5)
    # "high": K4 only, and the CPU run launched nothing
    assert lg["omp_insert"] > 0 and lg["normal_matvec_fused_bf16"] == 0
    assert not any(lc.values())


@pytest.mark.parametrize("picks", [1, 4])
def test_certified_omp_on_card_launches_k1_and_k4(dev, picks):
    from sparse_solvers_tpu_torch import Omp
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y, Xt = compressive_problem(256, 512, 8, 16, seed=3)
    dispatch.reset_launches()
    X, rep = Omp(A, picks=picks, device=dev).solve_batch(Y, 0.01, 32)
    k1, k4 = (dispatch.launches[k] for k in ("normal_matvec_fused_bf16",
                                              "omp_insert"))
    assert k1 > 0 and k4 >= picks * k1
    assert dispatch.launches["transition"] == 0
    assert bool((rep.solution_error <= 0.01).all())
    X = X.cpu().numpy()
    for lane in range(16):
        top = set(np.argsort(-np.abs(X[lane]))[:8].tolist())
        assert top == set(np.flatnonzero(Xt[lane]).tolist())


# (m, n, b); the last three split both passes' depth (S > 1) at the batch
# tiles of 16, 64 and 128 (the last with a ragged second batch tile)
FUSED_SHAPES = [(72, 200, 5), (96, 256, 8), (64, 130, 1), (1, 8, 70),
                (130, 67, 65), (33, 100, 17), (300, 520, 3),
                (72, 4100, 8), (96, 2050, 64), (40, 1030, 130)]


@pytest.mark.parametrize("m,n,b", FUSED_SHAPES)
@pytest.mark.parametrize("precision,rel", [("highest", 1e-5),
                                           ("default", 1e-3)])
def test_k5_k6_kernels_match_twins(dev, m, n, b, precision, rel):
    from sparse_solvers_tpu_torch.ops import blas
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K
    g = torch.Generator(device=dev).manual_seed(m * n + b)
    A = torch.randn(m, n, generator=g, device=dev)
    D = torch.randn(b, n, generator=g, device=dev)
    Y = torch.randn(b, m, generator=g, device=dev)
    with blas.precision_scope(precision):
        Q = _counted(K.K5_NAME, lambda: K.normal_matvec_fused(A, D))
        C = _counted(K.K6_NAME,
                     lambda: K.residual_correlation_fused(A, D, Y))
        for got, want, again in (
                (Q, K.normal_matvec_fused_plain(A, D),
                 K.normal_matvec_fused(A, D)),
                (C, K.residual_correlation_fused_plain(A, D, Y),
                 K.residual_correlation_fused(A, D, Y))):
            assert got.shape == (b, n) and got.dtype == torch.float32
            err = float((got - want).abs().max())
            assert err <= rel * float(want.abs().max()), err
            assert torch.equal(got, again)


@pytest.mark.parametrize("m,n,b", [(96, 2050, 64), (72, 4100, 8)])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_k6_cancelling_residual_is_exact(dev, m, n, b, precision):
    """Y = X·Aᵀ + noise cancels all but about 1e-4 of each pass-1 sum,
    which runs over split depth ranges. A and X are small integers and the
    noise a multiple of 2⁻¹⁰ below 2⁻², so every product and partial sum
    is exact in f32 and every operand exact in bf16: the kernel, its twin
    and a float64 recompute agree bit for bit at both precisions. Σ
    rounded before Y − Σ, or Y taken once per split, would miss by far."""
    from sparse_solvers_tpu_torch.ops import blas
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K
    rng = np.random.RandomState(m + n + b)
    A = rng.randint(-4, 5, (m, n)).astype(np.float64)
    X = rng.randint(-4, 5, (b, n)).astype(np.float64)
    S = X @ A.T
    Y = S + rng.randint(-255, 256, (b, m)) / 1024.0
    want = ((Y - S) @ A).astype(np.float32)
    assert np.abs(Y - S).max() < 1e-3 * np.abs(S).max()
    assert np.array_equal(Y.astype(np.float32), Y)   # |S| < 2¹³: exact
    assert K.fused_launch_plan(b, m, n, precision).splits[0] > 1
    A, X, Y = (torch.from_numpy(t.astype(np.float32)).to(dev)
               for t in (A, X, Y))
    with blas.precision_scope(precision):
        C = _counted(K.K6_NAME,
                     lambda: K.residual_correlation_fused(A, X, Y))
        twin = K.residual_correlation_fused_plain(A, X, Y)
    assert torch.equal(C, torch.from_numpy(want).to(dev))
    assert torch.equal(C, twin)


def test_k5_k6_edges_and_refusals(dev):
    from sparse_solvers_tpu_torch.ops import dispatch
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K
    A = torch.randn(16, 24, device=dev)
    before = dict(dispatch.launches)
    assert K.normal_matvec_fused(A, torch.zeros(0, 24, device=dev)).shape \
        == (0, 24)
    C = K.residual_correlation_fused(torch.zeros(0, 24, device=dev),
                                     torch.randn(3, 24, device=dev),
                                     torch.zeros(3, 0, device=dev))
    assert C.shape == (3, 24) and not C.any()
    assert dispatch.launches == before
    with pytest.raises(ValueError, match="float32"):
        K.normal_matvec_fused(A.double(), torch.zeros(2, 24, device=dev,
                                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="float32"):
        K.residual_correlation_fused(A, torch.zeros(2, 24, device=dev),
                                     torch.zeros(2, 16, device=dev,
                                                 dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        K.normal_matvec_fused(A.T.contiguous().T, torch.zeros(2, 24,
                                                              device=dev))


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-5),
                                        (np.float64, 1e-10)])
def test_core_on_card_matches_cpu_twins(dev, dtype, atol):
    """A single solve, a sparse-regime batch and exact mode on the card
    against the CPU: equal iterations, X within atol; the core launches
    none of the kernels."""
    from sparse_solvers_tpu_torch import Homotopy
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y, Xt = compressive_problem(128, 256, 6, 4, seed=2)
    A, Y = A.astype(dtype), Y.astype(dtype)
    tol = 1e-3 if dtype == np.float32 else 1e-9
    out = {}
    for where in (dev, "cpu"):
        dispatch.reset_launches()
        fast = Homotopy(A, k_max=24, precision="high", engine="jax",
                        device=where)
        exact = Homotopy(A, mode="exact", precision="highest", device=where)
        x, r = fast.solve(Y[0], tol, 40)
        X, R = fast.solve_batch(Y, tol, 40)
        xe, re_ = exact.solve(Y[1], tol, 40)
        out[str(where)] = ([x.cpu().numpy(), X.cpu().numpy(),
                            xe.cpu().numpy()],
                           [r.iter, R.iter.tolist(), re_.iter])
        assert not any(dispatch.launches.values())
    (xs_g, it_g), (xs_c, it_c) = out[str(dev)], out["cpu"]
    assert it_g == it_c
    for a, b in zip(xs_g, xs_c):
        np.testing.assert_allclose(a, b, atol=atol)


@pytest.mark.parametrize("b", [1, 8])
def test_bf16_mm_matches_twin(dev, b):
    """``blas.bf16_mm`` on the card (cuBLAS: bf16 inputs, fp32 sums and
    result) against its CPU twin at the gram-free shape, both ways over a
    transposed copy (n + 1, m): Aᵀu from (b, m), A x from (b, n). Within
    1e-5 of Σ|a||u|: fp32 sums of up to 65536 exact products in another
    order (an H100 reads under 5e-7 of it)."""
    from sparse_solvers_tpu_torch.ops import blas
    m, n = 2048, 65536
    g = torch.Generator().manual_seed(b)
    AT = torch.randn(n + 1, m, generator=g).to(torch.bfloat16)
    AT[n] = 0
    ATd = AT.to(dev)
    for vec, w, wd in (
            (torch.randn(b, m, generator=g), AT[:n].mT, ATd[:n].mT),
            (torch.randn(b, n, generator=g), AT[:n], ATd[:n])):
        v = vec.to(torch.bfloat16)
        want = blas.bf16_mm(v, w)
        got = blas.bf16_mm(v.to(dev), wd)
        assert got.dtype == torch.float32 and got.shape == want.shape
        scale = blas.bf16_mm(v.abs(), w.abs())
        assert bool(((got.cpu() - want).abs() <= 1e-5 * scale).all())


@pytest.mark.parametrize("family", ["homotopy", "omp"])
def test_certified_solve_with_the_bf16_copy_matches_cpu(dev, family):
    """A certified gram-free ``solve`` on the per-lane core, whose
    operator reads the façade's bf16 copy on the card (kept graphs
    included: three solves) as on the CPU: iterations exact, X within
    1e-4 (bf16 inputs, fp32 sums in another order), every certificate
    within the tolerance."""
    from sparse_solvers_tpu_torch import Homotopy, Omp
    A, Y, _ = compressive_problem(128, 1024, 6, 3, seed=8)
    cls = Homotopy if family == "homotopy" else Omp
    out = {}
    for where in (dev, "cpu"):
        solver = cls(A, gram=False, engine="jax", device=where)
        runs = [solver.solve(Y[i], 1e-2, 24) for i in range(3)]
        assert solver._AT_cache[True].dtype == torch.bfloat16
        out[str(where)] = ([x.cpu().numpy() for x, _ in runs],
                           [(r.iter, r.solution_error) for _, r in runs])
    (xg, rg), (xc, rc) = out[str(dev)], out["cpu"]
    assert [r[0] for r in rg] == [r[0] for r in rc]
    assert all(r[1] <= 1e-2 for r in rg + rc)
    for a, c in zip(xg, xc):
        np.testing.assert_allclose(a, c, atol=1e-4)


@pytest.mark.parametrize("family,picks", [("homotopy", 1), ("omp", 1),
                                          ("omp", 4)])
def test_gram_free_drivers_on_card_match_cpu_twins(dev, family, picks):
    """gram=False past the small-batch regime: the gram-free driver on the
    card against the CPU at "high" (iterations exact, X atol 1e-5), and
    certified on the card through its kernels, every lane within the
    tolerance."""
    from sparse_solvers_tpu_torch import Homotopy, Omp
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y, Xt = compressive_problem(128, 512, 6, 16, seed=7)

    def make(where, **kw):
        if family == "homotopy":
            return Homotopy(A, gram=False, engine="jax", device=where,
                            **kw)
        return Omp(A, gram=False, picks=picks, engine="jax", device=where,
                   **kw)

    out = {}
    for where in (dev, "cpu"):
        solver = make(where, precision="high")
        assert solver.explain(batch=16, max_iterations=24)["gram_free"]
        X, rep = solver.solve_batch(Y, 0.01, 24)
        out[str(where)] = (X.cpu().numpy(), rep.iter.cpu().numpy())
        assert solver._G_cache is None
    (Xg, ig), (Xc, ic) = out[str(dev)], out["cpu"]
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(Xg, Xc, atol=1e-5)
    dispatch.reset_launches()
    X, rep = make(dev).solve_batch(Y, 0.01, 24)
    want = (HOMOTOPY_KERNELS if family == "homotopy"
            else ("normal_matvec_fused_bf16", "omp_insert"))
    assert all(dispatch.launches[k] > 0 for k in want)
    assert bool((rep.solution_error <= 0.01).all())


def test_omp_core_on_card_matches_cpu_twins(dev):
    """The per-lane OMP core: single solves (picks 1 and 4), a small-batch
    regime batch, exact mode and float64 on the card against the CPU;
    equal iterations, X within 1e-5 (float64 1e-10); no kernel
    launches. Tolerances 1e-2 (float64 1e-6) keep tol² above the rss
    identity's rounding floor, below which the last pick is set by
    summation order (ROADMAP.md Queue 3)."""
    from sparse_solvers_tpu_torch import Omp
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y, _ = compressive_problem(128, 256, 6, 4, seed=2)
    runs = (
        (lambda w: Omp(A, precision="high", engine="jax", device=w),
         lambda s: s.solve(Y[0], 1e-2, 40), 1e-5),
        (lambda w: Omp(A, precision="high", picks=4, engine="jax",
                       device=w),
         lambda s: s.solve(Y[1], 1e-2, 40), 1e-5),
        (lambda w: Omp(A, precision="high", engine="jax", device=w),
         lambda s: s.solve_batch(Y, 1e-2, 24), 1e-5),
        (lambda w: Omp(A, mode="exact", device=w),
         lambda s: s.solve(Y[2], 1e-2, 40), 1e-5),
        (lambda w: Omp(A.astype(np.float64), engine="jax", device=w),
         lambda s: s.solve(Y[3].astype(np.float64), 1e-6, 40), 1e-10))
    for make, run, atol in runs:
        out = {}
        for where in (dev, "cpu"):
            dispatch.reset_launches()
            x, rep = run(make(where))
            it = rep.iter if isinstance(rep.iter, int) else rep.iter.tolist()
            out[str(where)] = (x.cpu().numpy(), it)
            assert not any(dispatch.launches.values())
        (xg, ig), (xc, ic) = out[str(dev)], out["cpu"]
        assert ig == ic
        np.testing.assert_allclose(xg, xc, atol=atol)


def test_update_column_on_card_matches_rebuild(dev):
    from sparse_solvers_tpu_torch import Homotopy, Omp
    A, Y, _ = compressive_problem(64, 128, 4, 32, seed=4)
    rng = np.random.RandomState(1)
    col = rng.randn(64).astype(np.float32)
    col /= np.linalg.norm(col)
    A2 = A.copy()
    A2[:, 9] = col
    for cls in (Homotopy, Omp):
        s = cls(A, precision="high", device=dev)
        _ = s._G
        s.update_column(9, col)
        G2 = cls(A2, precision="high", device=dev)._G
        assert float((s._G - G2).abs().max()) <= 1e-5
        Xa, ra = s.solve_batch(Y, 1e-3, 40)
        Xb, rb = cls(A2, precision="high", device=dev).solve_batch(Y, 1e-3,
                                                                  40)
        assert torch.equal(ra.iter, rb.iter)
        assert float((Xa - Xb).abs().max()) <= 1e-5


def test_profiling_measures_on_card(dev):
    """utils/profiling on the card (tests/test_profiling.py's rates
    check): consistent rates, and the H100 spec when the card is one."""
    from sparse_solvers_tpu_torch.utils import profiling
    x = torch.ones(512, 512, device=dev)
    r = profiling.measure(lambda: x @ x, flops=2 * 512 ** 3,
                          bytes=3 * 512 * 512 * 4, reps=5)
    assert r.seconds > 0
    np.testing.assert_allclose(r.tflops, r.flops / r.seconds / 1e12)
    np.testing.assert_allclose(r.gbps, r.bytes / r.seconds / 1e9)
    assert "TFLOP/s" in str(r) and "GB/s" in str(r)
    if "h100" in torch.cuda.get_device_name(0).lower():
        assert profiling.detect_chip() is profiling.CHIPS["h100"]
        assert 0 < r.fraction_of_peak("highest") < 1


def _device_events(prof):
    """(name, start_ns, end_ns) of every operation the profiler recorded
    on the card, as perfbench/trace.py reads them."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def test_spans_share_the_profilers_clock_on_card(dev):
    """Under the CUDA-only profiler the benchmark traces with, a span
    records, and it contains the device interval of the K1 launch it
    issued and waited for (its plan's kernels: here pass 1 splits, so
    four), to within 50 us at each end: spans and device operations lie
    on one clock."""
    from sparse_solvers_tpu_torch.ops.cuda import kernels as K1
    from sparse_solvers_tpu_torch.utils import profiling
    g = torch.Generator(device=dev).manual_seed(5)
    A16 = torch.randn(2048, 4096, generator=g, device=dev).to(torch.bfloat16)
    D = torch.randn(256, 4096, generator=g, device=dev)
    K1.normal_matvec_fused_bf16(A16, D)         # built and warm
    torch.cuda.synchronize()
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with profiling.span("k1"):
            K1.normal_matvec_fused_bf16(A16, D)
            torch.cuda.synchronize()
    [call] = profiling.calls()
    [span] = call.spans
    kernels = [e for e in _device_events(prof)
               if "gemm_bf16_async_kernel" in e[0]
               or "round_to_bf16_kernel" in e[0]]
    assert len(kernels) == K1.k1_launch_plan(256, 2048, 4096).kernels == 4
    slack = 50_000
    assert span.start_ns - slack <= min(e[1] for e in kernels)
    assert max(e[2] for e in kernels) <= span.end_ns + slack


@pytest.mark.parametrize("gram,resolve", [(True, False), (False, False),
                                          (True, True)])
def test_every_sync_of_a_solve_is_a_sync_span(dev, gram, resolve,
                                              monkeypatch):
    """Under torch's sync debug mode, a certified ``solve_batch`` and a
    ``solve`` at test size (with a Gram and without; with lane 0's
    certificate forced to miss, so that both re-solve at "high") warn once
    for every synchronisation they make, and they record exactly as many
    ``solvers.sync`` spans."""
    import warnings
    from sparse_solvers_tpu_torch import Homotopy
    from sparse_solvers_tpu_torch import api as papi
    from sparse_solvers_tpu_torch.utils import profiling
    A, Y, _ = compressive_problem(256, 512, 8, 16, seed=3)
    solver = Homotopy(A, k_max=48, gram=gram, device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    if resolve:
        real = papi._certified_error

        def miss_lane_0(A, x, y):
            err = real(A, x, y)
            # no index put of a host scalar, which would sync itself
            lane = torch.arange(err.shape[0], device=err.device)
            return torch.where(lane == 0, 1.0, err)
        monkeypatch.setattr(papi, "_certified_error", miss_lane_0)
    for _ in range(2):                # built, warm, Gram or copy made
        solver.solve_batch(Yd, 0.01, 64)
        solver.solve(Yd[0], 0.01, 64)
    torch.cuda.synchronize()
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                solver.solve_batch(Yd, 0.01, 64)
                solver.solve(Yd[0], 0.01, 64)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    calls = profiling.calls()
    assert [c.spans[-1].name for c in calls] == ["api.solve_batch",
                                                 "api.solve"]
    assert all(bool(c.counters.get("api.resolved_lanes")) == resolve
               for c in calls)
    spans = [s for c in calls for s in c.spans if s.name == "solvers.sync"]
    assert len(syncs) == len(spans), sorted(
        (w.filename.split("/")[-1], w.lineno) for w in syncs)


def _lane_mix(m, n, ks, seed):
    """Unit-column gaussian A (m, n) and one signal a lane with the
    lane's own sparsity ``ks[i]``: lanes finish on different trips."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((len(ks), n))
    for i, k in enumerate(ks):
        X[i, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    return A.astype(np.float32), (X @ A.T).astype(np.float32), X


def _calls(Y):
    """Three batches of different signals a lane: Y, its lanes reversed
    and rolled by one."""
    return [Y, Y.flip(0).contiguous(), Y.roll(1, 0).contiguous()]


def _driver_case(dev, case):
    """``make()`` → ``run(Y)``, the batch driver's (X, report) on the
    card, its loops kept from one run to the next as a façade keeps them;
    a check of the first call's reports; the calls' signals."""
    from sparse_solvers_tpu_torch.ops import blas
    from sparse_solvers_tpu_torch.solvers import homotopy_batch as hb
    from sparse_solvers_tpu_torch.solvers import loops
    if case == "ragged":
        A, Y, X = _lane_mix(256, 512, [4, 12, 20, 28, 36, 44, 52, 60], 6)
    else:
        A, Y, X = compressive_problem(256, 512 if case != "gram_free"
                                      else 1024, 60 if case == "tiers"
                                      else 20, 16, seed=4)
    A, Y = torch.as_tensor(A, device=dev), torch.as_tensor(Y, device=dev)
    k_max, max_it = (96, 128) if case in ("tiers", "ragged") else (41, 40)
    with blas.precision_scope("default"):
        G = None if case == "gram_free" else A.T @ A
        AT = hb.transposed_copy(A) if G is None else None
    if case == "degenerate":
        # column j of lane 0's support reads a zero Gram row: its insert's
        # Schur complement is 0 and K3 breaks the lane
        idx0 = (Y @ A).abs().argmax(dim=1).tolist()
        j = [s for s in np.flatnonzero(X[0]) if s not in idx0][0]
        G[j, :] = 0
        G[:, j] = 0

    def make():
        keep = loops.Kept().entry("driver")

        def run(Y):
            with blas.precision_scope("default"):
                return hb.solve_homotopy_batch(A, G, Y, 0.01, max_it, k_max,
                                               AT=AT, keep=keep)
        return run

    def check(rep):
        it, err = rep.iter.cpu(), rep.solution_error.cpu()
        if case == "tiers":
            assert int(it.max()) > 48          # the third tier ran
        if case == "ragged":
            assert len(set(it.tolist())) > 3
        if case == "degenerate":
            assert float(err[0]) > 0.01 and int(it[0]) < max_it
            assert int(it.max()) > int(it[0])
    return make, check, _calls(Y)


def _facade_case(dev, case, monkeypatch):
    """``make()`` → ``run(Y)`` on a new certified ``Homotopy`` façade (a
    batch whose lane 0 re-solves at "high", or a single solve); the
    calls' signals."""
    from sparse_solvers_tpu_torch import Homotopy
    from sparse_solvers_tpu_torch import api as papi
    A, Y, _ = compressive_problem(256, 512, 20, 16, seed=3)
    Yd = torch.as_tensor(Y, device=dev)
    if case == "resolve":
        real = papi._certified_error

        def miss_lane_0(A, x, y):
            err = real(A, x, y)
            lane = torch.arange(err.shape[0], device=err.device)
            return torch.where(lane == 0, 1.0, err)
        monkeypatch.setattr(papi, "_certified_error", miss_lane_0)

        def make():
            solver = Homotopy(A, k_max=48, device=dev)
            return lambda Y: solver.solve_batch(Y, 0.01, 64)
        return make, None, _calls(Yd)

    def make():
        solver = Homotopy(A, k_max=48, device=dev)
        return lambda y: solver.solve(y, 0.01, 64)
    return make, None, [Yd[0], Yd[1], Yd[2]]


def _core_case(dev, case):
    """``make()`` → ``run(Y)``, the per-lane core on the card, its loop
    kept from one run to the next; the calls' signals."""
    from sparse_solvers_tpu_torch.ops.operators import DenseOperator
    from sparse_solvers_tpu_torch.solvers import homotopy as core
    from sparse_solvers_tpu_torch.solvers import loops
    A, Y, _ = compressive_problem(128, 512, 10, 4, seed=8)
    dtype = torch.float64 if case == "core_f64" else torch.float32
    A = torch.as_tensor(A, device=dev, dtype=dtype)
    Y = torch.as_tensor(Y, device=dev, dtype=dtype)
    mode = "exact" if case == "core_exact_path" else "fast"
    op = DenseOperator(A, A.T @ A)

    def make():
        keep = loops.Kept().entry("core")
        return lambda Y: core.solve_homotopy_core(
            op, 512, Y, 0.01, 40, 41, mode=mode, use_gk=mode == "fast",
            sparse_matvec=case == "core_f64",
            record_path=case == "core_exact_path", keep=keep)
    return make, None, _calls(Y)


def _omp_case(dev, case):
    """``make(kept)`` → ``run(Y)``, the OMP batch driver's (X, report) at
    "default" on the card over the capacity tiers 24, 40 and 72 (k =
    60), its loops kept from one run to the next where ``kept``; a check
    of the reports: picks 1 with a Gram, gOMP (picks 4) and gram-free;
    the calls' signals."""
    from sparse_solvers_tpu_torch.ops import blas
    from sparse_solvers_tpu_torch.solvers import homotopy_batch as hb
    from sparse_solvers_tpu_torch.solvers import loops
    from sparse_solvers_tpu_torch.solvers import omp_batch
    A, Y, _ = compressive_problem(
        256, 1024 if case == "omp_gram_free" else 512, 60, 16, seed=4)
    A, Y = torch.as_tensor(A, device=dev), torch.as_tensor(Y, device=dev)
    with blas.precision_scope("default"):
        G = None if case == "omp_gram_free" else A.T @ A
        AT = hb.transposed_copy(A) if G is None else None

    def make(kept=True):
        keep = loops.Kept().entry("omp") if kept else None

        def run(Y):
            with blas.precision_scope("default"):
                return omp_batch.solve_omp_batch(
                    A, G, Y, 0.01, 72, 72, AT=AT,
                    picks=4 if case == "gomp" else 1, keep=keep)
        return run

    def check(rep):
        assert int(rep.iter.max().cpu()) > 40      # the third tier ran
    return make, check, _calls(Y)


def _flat_cpu(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat_cpu(o)]
    if isinstance(out, torch.Tensor):
        return [out.cpu()]
    # a single solve's report
    return [torch.tensor(out.iter), torch.tensor(out.solution_error)]


GRAPH_CASES = ("tiers", "gram_free", "ragged", "degenerate", "resolve",
               "single", "core_f64", "core_exact_path", "omp", "gomp",
               "omp_gram_free")


def _graph_case(dev, case, monkeypatch):
    if case in ("resolve", "single"):
        return _facade_case(dev, case, monkeypatch)
    if case.startswith("core"):
        return _core_case(dev, case)
    if case in ("omp", "gomp", "omp_gram_free"):
        return _omp_case(dev, case)
    return _driver_case(dev, case)


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graph_route_bit_equal_to_eager(dev, case, monkeypatch):
    """Each graphed loop on the card through its CUDA graphs against the
    same loop stepped eagerly (``synced_while``, the rule patched to say
    eager), over a sequence of three calls with other signals on one
    façade (or one kept entry), the first capturing and the later ones
    replaying the kept graphs from their first trip: X, iterations,
    errors and every history bit-equal call by call, the hand kernels'
    launch counts equal, and trips replayed in every call. The batch
    driver over three tiers (k = 60, tiers 24, 48, 96), gram-free, lanes
    that finish on different trips, a lane that breaks on a degenerate
    insert; the certified facade's "high" re-solve (lane 0's certificate
    forced to miss) and a single ``solve``; the per-lane core in float64
    with the sparse q and in exact mode with its path recorded (which
    keeps nothing); the OMP batch driver over three tiers with picks 1,
    with picks 4 (gOMP) and gram-free."""
    from sparse_solvers_tpu_torch.ops import dispatch
    from sparse_solvers_tpu_torch.solvers import loops
    make, check, signals = _graph_case(dev, case, monkeypatch)
    make()(signals[0])                     # built and warm
    torch.cuda.synchronize()
    replays = []
    real = loops._TripGraph.replay

    def counted(self):
        replays.append(1)
        return real(self)
    got = {}
    for route in ("graph", "eager"):
        with monkeypatch.context() as mp:
            mp.setattr(loops._TripGraph, "replay", counted)
            if route == "eager":
                mp.setattr(loops, "graph_route", lambda *a, **k: False)
            run = make()
            got[route] = []
            for Y in signals:
                replays.clear()
                dispatch.reset_launches()
                out = run(Y)
                torch.cuda.synchronize()
                got[route].append((_flat_cpu(out), dict(dispatch.launches),
                                   len(replays)))
                if route == "graph" and Y is signals[0]:
                    first = out
    if check is not None:
        check(first[1])
    for (g, gl, gr), (e, el, er) in zip(got["graph"], got["eager"]):
        assert gr > 0 and er == 0
        assert gl == el
        assert len(g) == len(e)
        for a, b in zip(g, e):
            assert torch.equal(a, b)


@pytest.mark.parametrize("warm", [True, False])
def test_traced_call_sees_the_graphs_kernels(dev, warm):
    """Under the CUDA-only profiler the benchmark traces with, a
    ``solve_batch`` at "default" (K1's precision, no certificate to
    re-solve) shows K1, K2 and K3 once a trip: one K2 and one K3 a
    ``solvers.iter`` span, three K1 kernels (two GEMM passes and the
    rounding) a trip. After a warm call (``warm``) every trip replays the
    graphs the façade kept from it, captured before the profiler started:
    a replay a trip, a reuse a tier, no capture. A first call captures
    inside the trace: a replay for each trip after each tier's first, a
    capture a tier."""
    from sparse_solvers_tpu_torch import Homotopy
    from sparse_solvers_tpu_torch.utils import profiling
    A, Y, _ = compressive_problem(256, 512, 40, 16, seed=3)
    solver = Homotopy(A, k_max=96, precision="default", device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    if warm:
        solver.solve_batch(Yd.flip(0).contiguous(), 0.01, 128)
    torch.cuda.synchronize()
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, rep = solver.solve_batch(Yd, 0.01, 128)
        torch.cuda.synchronize()
    [call] = profiling.calls()
    trips = [s for s in call.spans if s.name == "solvers.iter"]
    tiers = [s for s in call.spans if s.name == "solvers.tier"]
    assert len(trips) == int(rep.iter.max())
    names = [e[0] for e in _device_events(prof)]
    k2 = sum("gamma_scan" in n for n in names)
    k3 = sum("transition_regs_kernel" in n for n in names)
    k1 = sum("gemm_bf16_async_kernel" in n or "round_to_bf16_kernel" in n
             for n in names)
    assert k2 == k3 == len(trips)
    assert k1 == 3 * len(trips)
    captures = [s for s in call.spans if s.name == "solvers.capture"]
    if warm:
        assert call.counters["solvers.graph_replays"] == len(trips)
        assert call.counters["solvers.graph_reuses"] == len(tiers)
        assert not captures
    else:
        assert (call.counters["solvers.graph_replays"]
                == len(trips) - len(tiers))
        assert len(captures) == len(tiers)


@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("picks", [1, 4])
def test_traced_omp_call_sees_the_graphs_kernels(dev, picks, warm):
    """The same for ``Omp.solve_batch`` at "default" over the tiers 24,
    40 and 72: one K4 a pick and K1's three kernels a ``solvers.iter``
    span; after a warm call every round replays the kept graphs, one
    reuse and no capture a tier; a first call captures one a tier and
    replays each tier's rounds after its first; with picks 1, a round a
    pick of the longest lane."""
    from sparse_solvers_tpu_torch import Omp
    from sparse_solvers_tpu_torch.utils import profiling
    A, Y, _ = compressive_problem(256, 512, 60, 16, seed=3)
    solver = Omp(A, precision="default", picks=picks, device=dev)
    Yd = torch.as_tensor(Y, device=dev)
    if warm:
        solver.solve_batch(Yd.flip(0).contiguous(), 0.01, 72)
    torch.cuda.synchronize()
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, rep = solver.solve_batch(Yd, 0.01, 72)
        torch.cuda.synchronize()
    [call] = profiling.calls()
    trips = [s for s in call.spans if s.name == "solvers.iter"]
    tiers = [s for s in call.spans if s.name == "solvers.tier"]
    captures = [s for s in call.spans if s.name == "solvers.capture"]
    assert len(tiers) == 3
    if picks == 1:
        assert len(trips) == int(rep.iter.max())
    names = [e[0] for e in _device_events(prof)]
    k4 = sum("omp_insert_rows_kernel" in n for n in names)
    k1 = sum("gemm_bf16_async_kernel" in n or "round_to_bf16_kernel" in n
             for n in names)
    assert k4 == picks * len(trips)
    assert k1 == 3 * len(trips)
    if warm:
        assert call.counters["solvers.graph_replays"] == len(trips)
        assert call.counters["solvers.graph_reuses"] == len(tiers)
        assert not captures
    else:
        assert (call.counters["solvers.graph_replays"]
                == len(trips) - len(tiers))
        assert len(captures) == len(tiers)


@pytest.mark.parametrize("case", ["tiers", "gram_free", "single", "omp"])
def test_later_calls_keep_the_first_calls_peak_memory(dev, case):
    """A façade's second and third calls (other signals, the same key)
    replay the graphs and write into the buffers the first kept: neither
    raises ``torch.cuda.max_memory_allocated()`` above the first call's
    by more than 1 MiB, and the memory held between calls does not
    grow. The certified Homotopy batch driver over its three tiers and
    gram-free, a single certified solve, the certified OMP driver."""
    from sparse_solvers_tpu_torch import Homotopy, Omp
    A, Y, _ = compressive_problem(256, 1024 if case == "gram_free" else 512,
                                  20, 16, seed=6)
    if case == "omp":
        solver = Omp(A, device=dev)
    else:
        solver = Homotopy(A, k_max=96 if case == "tiers" else None,
                          gram=case != "gram_free", device=dev)
    # the same lanes reordered: every call runs the tiers the first ran
    peaks, held = [], []
    for Yc in _calls(torch.as_tensor(Y, device=dev)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        if case == "single":
            out = solver.solve(Yc[0], 0.01, 64)
        else:
            out = solver.solve_batch(Yc, 0.01, 64)
        torch.cuda.synchronize()
        del out
        peaks.append(torch.cuda.max_memory_allocated(dev))
        held.append(torch.cuda.memory_allocated(dev))
    assert max(peaks[1:]) <= peaks[0] + 2 ** 20, peaks
    assert held[2] == held[1], held


@pytest.mark.parametrize("case", ["omp", "gomp", "omp_gram_free"])
def test_omp_capture_leaves_the_peak_memory_of_the_eager_loop(
        dev, case, monkeypatch):
    """The OMP driver's graph route (three captures, one a tier) raises
    ``torch.cuda.max_memory_allocated()`` above the allocations it starts
    from by what the eager loop does, within 1 MiB: a capture holds no
    second cuBLAS workspace or other buffer beside the trip's own."""
    from sparse_solvers_tpu_torch.solvers import loops
    make, _, signals = _omp_case(dev, case)
    run = make(kept=False)
    peaks = {}
    for route in ("eager", "graph", "eager", "graph"):   # warm, then read
        with monkeypatch.context() as mp:
            if route == "eager":
                mp.setattr(loops, "graph_route", lambda *a, **k: False)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = run(signals[0])
            torch.cuda.synchronize()
            peaks[route] = torch.cuda.max_memory_allocated(dev) - base
            del out
    assert abs(peaks["graph"] - peaks["eager"]) <= 2 ** 20, peaks


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_triangular_solves_ignore_the_default_scope(dev, dtype):
    """xtrsm/xtrsv pin TF32 off for their own extent: under "default"
    (which allows TF32 for products) bit-equal to the same call under
    "highest", at the IRLS trsm shape (R 1024×1024, 256 right-hand
    sides); the scope's TF32 setting is back afterwards."""
    from sparse_solvers_tpu_torch.ops import blas
    g = torch.Generator(device=dev).manual_seed(3)
    R = torch.linalg.qr(torch.randn(2048, 1024, generator=g, device=dev,
                                    dtype=dtype))[1]
    B = torch.randn(1024, 256, generator=g, device=dev, dtype=dtype)
    with blas.precision_scope("highest"):
        Xh = blas.xtrsm(R, B, lower=False)
        xh = blas.xtrsv(R.T, B[:, 0], lower=True, trans=True)
    with blas.precision_scope("default"):
        Xd = blas.xtrsm(R, B, lower=False)
        xd = blas.xtrsv(R.T, B[:, 0], lower=True, trans=True)
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.equal(Xd, Xh) and torch.equal(xd, xh)
    with blas.precision_scope("highest"):
        resid = float((R @ Xh - B).abs().max())
    assert resid <= (1e-3 if dtype == torch.float32 else 1e-10)


def test_cholesky_spd_flags_on_card(dev):
    """The SPD flag per lane on the card (SPD, singular, negative
    definite), equal to the CPU's, and the SPD factor within 1e-5."""
    from sparse_solvers_tpu_torch.linalg.cholesky import cholesky_spd
    rng = np.random.RandomState(4)
    noise = rng.randn(8, 8)
    A = np.stack([noise @ noise.T + 8 * np.eye(8), np.ones((8, 8)),
                  -2 * np.eye(8)]).astype(np.float32)
    Lg, fg = cholesky_spd(torch.from_numpy(A).to(dev))
    Lc, fc = cholesky_spd(torch.from_numpy(A))
    assert fg.tolist() == fc.tolist() == [True, False, False]
    np.testing.assert_allclose(Lg[0].cpu().numpy(), Lc[0].numpy(),
                               atol=1e-5)


IRLS_MODES = {"fast": dict(), "exact": dict(mode="exact"),
              "stabilized": dict(stabilized=True), "gemm": dict()}


@pytest.mark.parametrize("mode", sorted(IRLS_MODES))
def test_irls_on_card_matches_cpu(dev, mode, monkeypatch):
    """Irls on the card against the same façade on the CPU, in each mode,
    both from one numpy QR (cuSOLVER's column signs may differ from
    LAPACK's): iterations and spd flags exact, X within 1e-4; a float64
    fast solve within 1e-10. No hand kernel launches."""
    from _torch_cases import irls_problem
    from sparse_solvers_tpu_torch import Irls
    from sparse_solvers_tpu_torch.ops import dispatch
    monkeypatch.setenv("SS_IRLS_GEMM", "1" if mode == "gemm" else "0")
    cases = [(np.float32, 1e-4)] + [(np.float64, 1e-10)] * (mode == "fast")
    for dtype, atol in cases:
        A, Y = irls_problem(60, 30, 8, 3, seed=13, dtype=dtype)
        Q, R = np.linalg.qr(A)
        out = {}
        for where in (dev, "cpu"):
            dispatch.reset_launches()
            s = Irls.from_numpy(A, Q=Q, R=R, engine="jax", device=where,
                                **IRLS_MODES[mode])
            X, rep = s.solve_batch(Y, 0.01, 50)
            out[str(where)] = (X.cpu().numpy(), rep.iter.tolist(),
                               rep.spd_failure.tolist())
            assert not any(dispatch.launches.values())
        (Xg, ig, sg), (Xc, ic, sc) = out[str(dev)], out["cpu"]
        assert ig == ic and sg == sc
        np.testing.assert_allclose(Xg, Xc, atol=atol)


@pytest.mark.parametrize("dtype,tol,atol", [(np.float32, 1e-5, 1e-5),
                                            (np.float64, 1e-8, 1e-10)])
def test_irls_cg_on_card_matches_cpu(dev, dtype, tol, atol):
    """IrlsCg on the card against the CPU: three lanes of 5, 3 and 8
    nonzeros, iterations and breakdown flags exact, X within atol."""
    from _torch_cases import cs_problem
    from sparse_solvers_tpu_torch import IrlsCg
    A, _, _ = cs_problem(64, 256, 5, seed=0, dtype=dtype)
    Y = np.stack([A @ cs_problem(64, 256, k, seed=s, dtype=dtype)[1]
                  for s, k in ((0, 5), (4, 3), (9, 8))])
    out = {}
    for where in (dev, "cpu"):
        X, rep = IrlsCg(A, engine="jax", device=where).solve_batch(Y, tol,
                                                                   80)
        out[str(where)] = (X.cpu().numpy(), rep.iter.tolist(),
                           rep.spd_failure.tolist())
    (Xg, ig, sg), (Xc, ic, sc) = out[str(dev)], out["cpu"]
    assert ig == ic and sg == sc
    np.testing.assert_allclose(Xg, Xc, atol=atol)


@pytest.mark.parametrize("dtype,tol,atol", [(np.float32, 1e-4, 1e-5),
                                            (np.float64, 1e-9, 1e-10)])
def test_cosamp_on_card_matches_cpu(dev, dtype, tol, atol):
    """Cosamp on the card against the CPU port: a batch of 16 lanes and a
    single solve, rounds exact, X and errors within atol; planted ties in
    |c| and |b| (a permutation matrix) pick the same columns, exactly;
    no hand kernel launches."""
    from sparse_solvers_tpu_torch import Cosamp
    from sparse_solvers_tpu_torch.ops import dispatch
    A, Y, Xt = compressive_problem(128, 512, 8, 16, seed=11)
    A, Y = A.astype(dtype), Y.astype(dtype)
    P = np.eye(8)[:, np.random.RandomState(3).permutation(8)].astype(dtype)
    ties = (P @ np.array([0, 1, 1, 0, 0, 1, 1, -1.0])).astype(dtype)
    out = {}
    for where in (dev, "cpu"):
        dispatch.reset_launches()
        X, rep = Cosamp(A, 8, device=where).solve_batch(Y, tol, 20)
        x, r1 = Cosamp(A, 8, device=where).solve(Y[5], tol, 20)
        xt, rt = Cosamp(P, 2, device=where).solve(ties, 1e-6, 10)
        torch.cuda.synchronize()
        assert not any(dispatch.launches.values())
        assert X.device == torch.device(where)
        out[str(where)] = (X.cpu().numpy(), rep.iter.tolist(),
                           rep.solution_error.cpu().numpy(),
                           x.cpu().numpy(), r1.iter, xt.cpu().numpy(),
                           rt.iter)
    g, c = out[str(dev)], out["cpu"]
    assert g[1] == c[1] and g[4] == c[4] and g[6] == c[6] == 1
    np.testing.assert_allclose(g[0], c[0], atol=atol)
    np.testing.assert_allclose(g[2], c[2], atol=atol)
    np.testing.assert_allclose(g[3], c[3], atol=atol)
    np.testing.assert_array_equal(g[5], c[5])
    top = np.argsort(-np.abs(g[0]), axis=1)[:, :8]
    for lane in range(16):
        assert set(top[lane].tolist()) == set(np.flatnonzero(Xt[lane]))


def test_host_route_on_a_card_facade_returns_cuda_tensors(dev):
    """engine="native" on a device="cuda" façade solves on the host engine
    and returns tensors on the card, equal to the CPU façade's; "auto" at
    m·n ≤ 2¹⁶ plans the torch route on the card and the host engine on
    the CPU."""
    from _torch_cases import cs_problem, irls_problem
    from sparse_solvers_tpu_torch import Homotopy, Irls, IrlsCg, Omp
    A, Y, _ = compressive_problem(64, 128, 4, 6, seed=2)
    Ai, Yi = irls_problem(60, 30, 6, 1, seed=13, dtype=np.float32)
    Ac, _, _ = cs_problem(32, 96, 4, seed=2, dtype=np.float32)
    Yc = np.stack([Ac @ cs_problem(32, 96, 4, seed=s, dtype=np.float32)[1]
                   for s in (3, 4)])
    cases = ((lambda w, e: Homotopy(A, engine=e, device=w), Y, 1e-3),
             (lambda w, e: Omp(A, engine=e, device=w), Y, 1e-4),
             (lambda w, e: Omp(A, picks=3, engine=e, device=w), Y, 1e-4),
             (lambda w, e: Irls(Ai, engine=e, device=w), Yi, 1e-3),
             (lambda w, e: IrlsCg(Ac, engine=e, device=w), Yc, 1e-6))
    for make, Ys, tol in cases:
        assert make(dev, "auto").explain()["engine"] == "torch"
        assert make("cpu", "auto").explain()["engine"] == "native"
        out = {}
        for where in (dev, "cpu"):
            solver = make(where, "native")
            x, rep = solver.solve(Ys[0], tol, 40)
            X, reps = solver.solve_batch(Ys, tol, 40)
            assert x.device == X.device == reps.iter.device \
                == torch.device(where)
            out[str(where)] = (x.cpu(), rep, X.cpu(),
                               [t.cpu() for t in reps])
        (xg, rg, Xg, Rg), (xc, rc, Xc, Rc) = out[str(dev)], out["cpu"]
        assert torch.equal(xg, xc) and rg == rc and torch.equal(Xg, Xc)
        assert all(torch.equal(a, b) for a, b in zip(Rg, Rc))
