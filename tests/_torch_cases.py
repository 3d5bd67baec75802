"""Seeded numpy inputs shared by the PyTorch-port tests.

numpy only (no jax, no torch), so that both the CPU parity tests and the
card tests (which run where jax is not installed) can build the same
cases.
"""

import numpy as np

BIG = float(np.finfo(np.float32).max)


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
