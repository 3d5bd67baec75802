"""Seeded numpy inputs shared by the PyTorch-port tests.

numpy only (no jax, no torch), so that both the CPU parity tests and the
card tests (which run where jax is not installed) can build the same
cases.
"""

import numpy as np

BIG = float(np.finfo(np.float32).max)

# the port's torch route on the CPU, for tests of problems of m·n ≤ 2¹⁶:
# a CPU façade's "auto" would send them to the C++ host engine
TORCH_ROUTE = {"engine": "jax", "device": "cpu"}


def make_problem(m, n, k, batch, seed=0, dtype=np.float32):
    """The headline workload's problem, a copy of ``bench.make_problem``
    (bench.py:33-46) kept here so the port's scripts need neither bench.py
    nor the JAX side: a Gaussian sensing matrix with unit-L2 columns, drawn
    and normalized in float64, and k-sparse positive signals. The RNG call
    order is part of every recorded problem (``compressive_problem`` draws
    each lane's values before its support, so it is another ensemble).
    Returns (A, Y) in ``dtype``."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(np.float64)
    A = A / np.linalg.norm(A, axis=0)
    X = np.zeros((batch, n))
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        X[b, sup] = rng.uniform(0.5, 1.0, k)
    Y = X @ A.T
    return A.astype(dtype), Y.astype(dtype)


def make_sparse_problem(m, n, k, batch, seed=0, signed=False,
                        amp=(0.5, 1.0)):
    """The benchmarks' shared ensemble, a copy of ``benchmarks/_common.
    make_sparse_problem`` (benchmarks/_common.py:17-36): unit-norm-column
    Gaussian A in float32 with a planted k-sparse ground truth per lane.
    ``signed`` draws the sign vector before the amplitudes; the RNG call
    order is part of every recorded problem. Returns (A, X_true, Y)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((batch, n), np.float32)
    for b in range(batch):
        sup = rng.choice(n, k, replace=False)
        if signed:
            a = rng.choice([-1.0, 1.0], k) * rng.uniform(amp[0], amp[1], k)
        else:
            a = rng.uniform(amp[0], amp[1], k)
        X[b, sup] = a
    return A, X, (X @ A.T).astype(np.float32)


def compressive_problem(m, n, k, batch, seed=0):
    """Unit-column gaussian ensemble with k-sparse positive signals (the
    bench.py workload). Returns (A, Y, X) in float32."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X = np.zeros((batch, n))
    for b in range(batch):
        X[b, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    return (A.astype(np.float32), (X @ A.T).astype(np.float32),
            X.astype(np.float32))


def scan_case(n, K=9, b=6, seed=11):
    """Inputs of the γ scan with planted exact ties on cleared lanes, where
    every other candidate is >= 1/3:
      lane 0: two inactive positions tie             -> idx 20
      lane 1: an active slot ties a later inactive   -> idx 40
      lane 2: an active slot ties an earlier inactive -> idx 40
      lane 3: no valid candidate                     -> (FLT_MAX, 0)
    and random active sets on the other lanes. Returns the seven arrays
    (q, c, mask, c_inf, x_act, d_act, indices) and the expected planted
    idx."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-0.5, 0.5, (b, n)).astype(np.float32)
    c = rng.uniform(-0.5, 0.5, (b, n)).astype(np.float32)
    c_inf = np.ones(b, np.float32)
    mask = np.zeros((b, n), np.int8)
    ind = np.full((b, K), n, np.int32)
    xa = np.zeros((b, K), np.float32)
    da = np.zeros((b, K), np.float32)
    for lane in range(4, b):
        k = rng.randint(1, K + 1)
        cols = rng.choice(n, k, replace=False)
        mask[lane, cols] = 1
        ind[lane, :k] = cols
        xa[lane, :k] = rng.uniform(0.5, 1.0, k)
        da[lane, :k] = rng.uniform(-1.0, 1.0, k)
    hi = n - 50
    for lane, pos in ((0, 20), (0, 30), (1, hi), (2, 40)):
        c[lane, pos], q[lane, pos] = 0.5, -1.0   # (1-0.5)/(1+1) = 0.25
    for lane, pos in ((1, 40), (2, hi)):
        mask[lane, pos], ind[lane, 0] = 1, pos
        xa[lane, 0], da[lane, 0] = 0.25, -1.0    # -0.25/-1 = 0.25
    q[3], c[3], c_inf[3] = 0.0, 0.0, 0.0
    return (q, c, mask, c_inf, xa, da, ind), [20, 40, 40, 0]


def scan_split_case(b, n, K, boundaries, seed=2):
    """Inputs of the γ scan at (b, n, K) with exact ties planted across
    the split scan's chunk boundaries (``boundaries``: the first position
    of every chunk after the first). Lanes are random (active sets of 1 to
    K columns) except the planted ones, which are cleared so that every
    other candidate is >= 1/3 and then given candidates of value 0.25:
      lane 0: inactive pairs (x−1, x) at every boundary x -> the first x−1
              (at n // 2 when there is no boundary);
      lanes 1, 2, ...: one boundary each, in turn, as an inactive pair, an
              active slot at x against an inactive x−1, and an active slot
              at x−1 against an inactive x -> x−1;
      lane b−1 (b > 1): no valid candidate -> (FLT_MAX, 0).
    Returns the seven arrays (q, c, mask, c_inf, x_act, d_act, indices) and
    {lane: expected idx} for the planted lanes."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-0.5, 0.5, (b, n)).astype(np.float32)
    c = rng.uniform(-0.5, 0.5, (b, n)).astype(np.float32)
    c_inf = np.ones(b, np.float32)
    mask = np.zeros((b, n), np.int8)
    ind = np.full((b, K), n, np.int32)
    xa = np.zeros((b, K), np.float32)
    da = np.zeros((b, K), np.float32)
    for lane in range(b):
        k = rng.randint(1, min(K, n) + 1)
        cols = rng.choice(n, k, replace=False)
        mask[lane, cols] = 1
        ind[lane, :k] = cols
        xa[lane, :k] = rng.uniform(0.5, 1.0, k)
        da[lane, :k] = rng.uniform(-1.0, 1.0, k)
    bounds = list(boundaries) or [max(1, n // 2)]
    kinds = [(x, kind) for x in bounds for kind in range(3)]
    planted = [(0, None)] + [(1 + j, xk) for j, xk in
                             enumerate(kinds[:max(0, b - 2)])]
    expected = {}

    def inactive(lane, pos):
        c[lane, pos], q[lane, pos] = 0.5, -1.0   # (1-0.5)/(1+1) = 0.25

    def active(lane, pos):
        mask[lane, pos], ind[lane, 0] = 1, pos
        xa[lane, 0], da[lane, 0] = 0.25, -1.0    # -0.25/-1 = 0.25

    for lane, xk in planted:
        mask[lane], ind[lane], xa[lane], da[lane] = 0, n, 0.0, 0.0
        if xk is None:
            for x in bounds:
                inactive(lane, x - 1)
                if x < n:
                    inactive(lane, x)
            expected[lane] = bounds[0] - 1
            continue
        x, kind = xk
        if kind == 0:
            inactive(lane, x - 1)
            inactive(lane, x)
        elif kind == 1:
            active(lane, x)
            inactive(lane, x - 1)
        else:
            active(lane, x - 1)
            inactive(lane, x)
        expected[lane] = x - 1
    if b > 1:
        last = b - 1
        mask[last], ind[last], xa[last], da[last] = 0, n, 0.0, 0.0
        q[last], c[last], c_inf[last] = 0.0, 0.0, 0.0
        expected[last] = 0
    return (q, c, mask, c_inf, xa, da, ind), expected


def random_states(seed, b, K, n, m=30):
    """Valid per-lane active-set states from random SPD Grams (the recipe
    of tests/test_transition_kernel.py::_random_states)."""
    rng = np.random.RandomState(seed)
    inv = np.zeros((b, K, K), np.float32)
    gk = np.zeros((b, K, K), np.float32)
    ind = np.full((b, K), n, np.int32)
    xa = np.zeros((b, K), np.float32)
    da = np.zeros((b, K), np.float32)
    ca = np.zeros((b, K), np.float32)
    kk = np.zeros(b, np.int32)
    As = rng.randn(b, m, n).astype(np.float32)
    for l in range(b):
        k = rng.randint(2, min(8, K))
        cols = rng.choice(n, k, replace=False)
        Ag = As[l][:, cols]
        g = Ag.T @ Ag
        inv[l, :k, :k] = np.linalg.inv(g)
        gk[l, :k, :k] = g
        ind[l, :k] = cols
        xa[l, :k] = rng.randn(k)
        da[l, :k] = rng.randn(k)
        ca[l, :k] = rng.randn(k)
        kk[l] = k
    return As, inv, gk, ind, xa, da, ca, kk


def transition_case(remove_last, b=8, K=13, n=50):
    """One transition's inputs: even lanes remove (the last live slot when
    ``remove_last``, else a random one), odd lanes insert, the last lane
    is frozen (as in tests/test_transition_kernel.py). Returns the 15
    array arguments (inv, gk, x_act, d_act, c_act, indices, u1, idx, kk,
    gamma, vtv, cnew, live, doins, dorm), tol and the sentinel n."""
    rng = np.random.RandomState(7 + remove_last)
    As, inv, gk, ind, xa, da, ca, kk = random_states(1 + remove_last,
                                                     b, K, n)
    idx = np.zeros(b, np.int32)
    pres = np.zeros(b, bool)
    u1 = np.zeros((b, K), np.float32)
    vtv = np.zeros(b, np.float32)
    for l in range(b):
        if l % 2 == 0:
            slot = kk[l] - 1 if remove_last else rng.randint(kk[l] - 1)
            idx[l] = ind[l, slot]
            pres[l] = True
        else:
            free = [c for c in range(n) if c not in ind[l, :kk[l]]]
            idx[l] = free[rng.randint(len(free))]
            G = As[l].T @ As[l]
            u1[l] = np.where(ind[l] < n,
                             G[idx[l], np.minimum(ind[l], n - 1)], 0)
            vtv[l] = G[idx[l], idx[l]]
    live = np.ones(b, bool)
    live[b - 1] = False
    gamma = (rng.rand(b) * 0.1).astype(np.float32)
    gamma[b - 1] = 0
    cnew = rng.randn(b).astype(np.float32)
    doins = live & ~pres & (kk < K)
    dorm = live & pres
    return ((inv, gk, xa, da, ca, ind, u1, idx, kk, gamma, vtv, cnew, live,
             doins, dorm), 0.01, n)


def transition_mix(b, K, n, seed=3, mix="all", k_hi=None):
    """One transition's inputs at a large capacity, active sets of 2 to K−2
    columns (below ``k_hi`` when given) from random SPD Grams. ``mix``
    "all": inserts, removals at p != last and p == last, frozen lanes,
    and lane 1 a degenerate insert (orthonormal active columns, a copy of
    column 0 inserted: den = 0 exactly); "insert": every lane inserts;
    "remove": every lane removes, at p != last and p == last in turn.
    Returns the 15 arrays of ``transition_case``."""
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
    rows = K + 32
    kinds = {"all": (0, 1, 2, 3), "insert": (1,), "remove": (0, 2)}[mix]
    for lane in range(b):
        k = rng.randint(2, min(K - 1, k_hi or K))
        cols = rng.choice(n, k + 1, replace=False)
        Ag = rng.randn(rows, k + 1) / np.sqrt(rows)
        g = Ag.T @ Ag
        inv[lane, :k, :k] = np.linalg.inv(g[:k, :k])
        gk[lane, :k, :k] = g[:k, :k]
        ind[lane, :k] = cols[:k]
        xa[lane, :k], da[lane, :k], ca[lane, :k] = rng.randn(3, k)
        kk[lane] = k
        kind = kinds[lane % len(kinds)]
        if kind in (0, 2):                      # remove at p != l / p == l
            pres[lane] = True
            idx[lane] = ind[lane, k - 1 if kind == 2 else rng.randint(k - 1)]
        else:                                   # insert column cols[k]
            idx[lane] = cols[k]
            u1[lane, :k] = g[k, :k]
            vtv[lane] = g[k, k]
            live[lane] = kind == 1 or lane % 8 == 3   # half of kind 3 frozen
    if mix == "all":
        d = 1
        inv[d], gk[d], ind[d] = 0, 0, n
        inv[d, 0, 0] = inv[d, 1, 1] = gk[d, 0, 0] = gk[d, 1, 1] = 1.0
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


# the lanes of transition_edge_case, in order
TRANSITION_EDGES = ("insert at kk=0", "insert at kk=K-1", "remove p=l",
                    "remove p=0", "remove to empty (p=l=0)",
                    "remove p=l=K-1 at kk=K", "remove p=0 at kk=K",
                    "live, no toggle", "frozen")


def transition_edge_case(K, n=None, seed=4):
    """One transition's inputs at capacity K (≥ 3) with a lane for each
    edge slot of ``TRANSITION_EDGES``: an insert into an empty lane and
    one at the last slot, removals at p = l, at p = 0, of a lane's only
    member and at a full lane (p = l = K−1 and p = 0), a live lane that
    neither inserts nor removes, and a frozen lane. Every vacant slot is
    zero, as the drivers keep them. Returns the 15 arrays of
    ``transition_case``, tol and the sentinel n."""
    n = n or 4 * K + 10
    rng = np.random.RandomState(seed)
    b = len(TRANSITION_EDGES)
    inv = np.zeros((b, K, K), np.float32)
    gk = np.zeros((b, K, K), np.float32)
    ind = np.full((b, K), n, np.int32)
    xa, da, ca, u1 = (np.zeros((b, K), np.float32) for _ in range(4))
    kk, idx = np.zeros(b, np.int32), np.zeros(b, np.int32)
    vtv = np.zeros(b, np.float32)
    doins, dorm = np.zeros(b, bool), np.zeros(b, bool)
    rows = K + 32

    def state(lane, k):
        """k live slots; returns the Gram of k + 1 columns (the last one
        the insert candidate) and their indices."""
        cols = rng.choice(n, k + 1, replace=False)
        Ag = rng.randn(rows, k + 1) / np.sqrt(rows)
        g = Ag.T @ Ag
        if k:
            inv[lane, :k, :k] = np.linalg.inv(g[:k, :k])
            gk[lane, :k, :k] = g[:k, :k]
            ind[lane, :k] = cols[:k]
            xa[lane, :k], da[lane, :k], ca[lane, :k] = rng.randn(3, k)
        kk[lane] = k
        return g, cols

    for lane, (k, kind, p) in enumerate((
            (0, "insert", None), (K - 1, "insert", None),
            (rng.randint(2, K), "remove", "l"), (rng.randint(2, K), "remove", 0),
            (1, "remove", 0), (K, "remove", "l"), (K, "remove", 0),
            (rng.randint(1, K), None, None), (rng.randint(1, K), "insert", None))):
        g, cols = state(lane, k)
        if kind == "insert":
            idx[lane] = cols[k]
            u1[lane, :k] = g[k, :k]
            vtv[lane] = g[k, k]
            doins[lane] = True
        elif kind == "remove":
            idx[lane] = ind[lane, k - 1 if p == "l" else p]
            dorm[lane] = True
        else:
            idx[lane] = cols[k]        # absent, and the lane does not insert
    live = np.ones(b, bool)
    live[-1] = False
    doins &= live
    gamma = (rng.rand(b) * 0.1).astype(np.float32)
    cnew = rng.randn(b).astype(np.float32)
    return ((inv, gk, xa, da, ca, ind, u1, idx, kk, gamma, vtv, cnew, live,
             doins, dorm), 0.01, n)


def vacant_nonzero(state, kk, sentinel):
    """The (lane, what) pairs whose vacant slots (≥ kk) are not exactly
    zero in inv, gk, x_act, d_act and c_act, or hold another index than
    the sentinel. ``state``: (inv, gk, x_act, d_act, c_act, indices), as
    numpy arrays."""
    inv, gk, xa, da, ca, ind = state
    K = xa.shape[1]
    bad = []
    for lane, k in enumerate(np.asarray(kk)):
        vac = np.arange(K) >= k
        for name, v in (("x_act", xa), ("d_act", da), ("c_act", ca)):
            if np.any(v[lane, vac] != 0):
                bad.append((lane, name))
        for name, M in (("inv", inv), ("gk", gk)):
            if np.any(M[lane][vac, :] != 0) or np.any(M[lane][:, vac] != 0):
                bad.append((lane, name))
        if np.any(ind[lane, vac] != sentinel):
            bad.append((lane, "indices"))
    return bad


def omp_insert_case(b, K, seed=0):
    """One batched OMP insert's inputs (inv, u1, kk, vtv, b_act, doins):
    random SPD states at varied insert slots kk in [0, K−1] (the new
    column's Gram row as u1, b_act filled through slot kk), every fourth
    lane frozen (doins false), and lane 1 a degenerate insert: orthonormal
    active columns with a copy of active column 0 inserted, so den = 1 − 1
    = 0 exactly. The edge slots are planted: lane 0 inserts at kk = 0, and
    lanes 2 and 3 (frozen) sit at kk = K−1. Vacant rows and columns (slots
    ≥ kk) are zero, as the drivers keep them."""
    rng = np.random.RandomState(seed)
    inv = np.zeros((b, K, K), np.float32)
    u1 = np.zeros((b, K), np.float32)
    b_act = np.zeros((b, K), np.float32)
    kk = np.zeros(b, np.int32)
    vtv = np.zeros(b, np.float32)
    rows = K + 32
    edge = np.random.RandomState(seed + 1)

    def state(lane, k, rng):
        Ag = rng.randn(rows, k + 1) / np.sqrt(rows)
        g = Ag.T @ Ag
        inv[lane] = 0
        inv[lane, :k, :k] = np.linalg.inv(g[:k, :k])
        u1[lane] = 0
        u1[lane, :k] = g[k, :k]
        vtv[lane] = g[k, k]
        b_act[lane] = 0
        b_act[lane, :k + 1] = rng.randn(k + 1)
        kk[lane] = k

    for lane in range(b):
        state(lane, rng.randint(0, K), rng)
    for lane, k in ((0, 0), (2, K - 1), (3, K - 1)):
        if lane < b:
            state(lane, k, edge)
    doins = np.arange(b) % 4 != 3
    if b > 1:
        inv[1], u1[1], b_act[1] = 0, 0, 0
        inv[1, 0, 0] = inv[1, 1, 1] = 1.0
        u1[1, 0], vtv[1], kk[1], doins[1] = 1.0, 1.0, min(2, K - 1), True
        b_act[1, :3] = (0.5, -0.25, 0.5)
    return inv, u1, kk, vtv, b_act, doins


def degenerate_case():
    """Two lanes with orthonormal active columns 0 and 1: lane 0 inserts a
    copy of column 0 (den = 1 - 1 = 0 exactly: degenerate), lane 1 an
    orthogonal column (as tests/test_transition_kernel.py:177)."""
    K, n = 4, 8
    inv = np.zeros((2, K, K), np.float32)
    gk = np.zeros((2, K, K), np.float32)
    inv[:, 0, 0] = inv[:, 1, 1] = gk[:, 0, 0] = gk[:, 1, 1] = 1.0
    xa = np.zeros((2, K), np.float32)
    xa[:, 0] = 0.5
    da = np.zeros((2, K), np.float32)
    da[:, 0] = 1.0
    ca = np.zeros((2, K), np.float32)
    ca[:, 0] = 0.3
    ind = np.full((2, K), n, np.int32)
    ind[:, 0], ind[:, 1] = 0, 1
    kk = np.full(2, 2, np.int32)
    idx = np.full(2, 5, np.int32)
    u1 = np.zeros((2, K), np.float32)
    u1[0, 0] = 1.0
    vtv = np.ones(2, np.float32)
    gamma = np.full(2, 0.25, np.float32)
    cnew = np.full(2, 0.7, np.float32)
    live = np.ones(2, bool)
    doins = np.ones(2, bool)
    dorm = np.zeros(2, bool)
    return ((inv, gk, xa, da, ca, ind, u1, idx, kk, gamma, vtv, cnew, live,
             doins, dorm), 0.01, n)


def irls_problem(m, n, batch, k, seed, dtype=np.float64):
    """tests/test_batch.py's IRLS ensemble: ℓ₁-normalized gaussian columns
    and k-sparse positive signals in [0.2, 1). Returns (A, Y)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n)
    A = A / np.abs(A).sum(axis=0)
    Y = []
    for _ in range(batch):
        x = np.zeros(n)
        x[rng.choice(n, k, replace=False)] = rng.uniform(0.2, 1.0, k)
        Y.append(A @ x)
    return A.astype(dtype), np.stack(Y).astype(dtype)


def competing_pair(m, n, b, rho_lo=0.9, rho_hi=0.96, seed=0,
                   dtype=np.float32):
    """tests/test_irls_stabilized.py's ensemble: per lane a leader of 1.0
    and a competitor of ρ ∈ [rho_lo, rho_hi] plus uniform(0, 1e-3) noise.
    Returns (A, Y, leaders)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(dtype)
    A /= np.linalg.norm(A, axis=0)
    Y = np.zeros((b, m), dtype)
    leaders = np.zeros(b, np.int64)
    for i in range(b):
        j1, j2 = rng.choice(n, 2, replace=False)
        x0 = np.zeros(n, dtype)
        x0[j1] = 1.0
        x0[j2] = rng.uniform(rho_lo, rho_hi)
        Y[i] = A @ x0 + rng.uniform(0, 1e-3, m).astype(dtype)
        leaders[i] = j1
    return A, Y, leaders


def bench_competing_pair(A, batch, seed=7):
    """benchmarks/bench_irls_batch.py:105-125's sustained-regime signals
    for A (float32): the ρ of every lane drawn first, then per lane the
    pair and the noise. Returns (Y, leaders)."""
    m, n = A.shape
    rng = np.random.RandomState(seed)
    rho = rng.uniform(0.9, 0.96, batch).astype(np.float32)
    Y = np.zeros((batch, m), np.float32)
    leaders = np.zeros(batch, np.int64)
    for i in range(batch):
        j1, j2 = rng.choice(n, 2, replace=False)
        x0 = np.zeros(n, np.float32)
        x0[j1] = 1.0
        x0[j2] = rho[i]
        Y[i] = A @ x0 + rng.uniform(0, 1e-3, m).astype(np.float32)
        leaders[i] = j1
    return Y, leaders


def cs_problem(m, n, k, seed, dtype=np.float64):
    """tests/test_irls_cg.py's compressed-sensing instance: unit-norm
    gaussian columns and a signed k-sparse truth with |x| in [0.5, 1.5).
    Returns (A, x, y)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(dtype)
    A /= np.linalg.norm(A, axis=0)
    x = np.zeros(n, dtype)
    sup = rng.choice(n, k, replace=False)
    x[sup] = rng.choice([-1.0, 1.0], k) * rng.uniform(0.5, 1.5, k)
    return A, x, (A @ x).astype(dtype)
