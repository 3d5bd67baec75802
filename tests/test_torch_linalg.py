"""The PyTorch port's ``linalg`` (norms, active_set, online_inverse) against
the JAX package's, on the CPU — mirrors of ``tests/test_norms.py``,
``test_active_set.py`` and ``test_online_inverse.py``.

The port's inverse state carries a lane axis; ``convert.py`` carries a JAX
state across, so each toggle is applied to identical state on both sides
and the results compared (exactly for the integer bookkeeping, to the
dtype's rounding for the inverse).
"""

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import jax.numpy as jnp
from sparse_solvers_tpu.linalg import active_set as jaset
from sparse_solvers_tpu.linalg import norms as jnorms
from sparse_solvers_tpu.linalg import online_inverse as joinv
from sparse_solvers_tpu_torch import convert
from sparse_solvers_tpu_torch.linalg import active_set as aset
from sparse_solvers_tpu_torch.linalg import norms
from sparse_solvers_tpu_torch.linalg import online_inverse as oinv

N, CAP = 20, 10


def test_l1_matrix_and_vector():
    A = np.array([[1.0, 2, 0], [3, 4, 1]], np.float32)
    np.testing.assert_allclose(norms.l1_columns(torch.from_numpy(A)).numpy(),
                               np.asarray(jnorms.l1_columns(jnp.asarray(A))),
                               rtol=1e-7)
    x = np.array([1.0, 2, 3, 4, 5, 0], np.float32)
    np.testing.assert_allclose(
        norms.l1_vector(torch.from_numpy(x)).numpy(),
        [0.06667, 0.1333, 0.2, 0.2666, 0.3333, 0], atol=1e-4)


def test_inf_norm_first_occurrence():
    v = torch.tensor([[1.0, -3.0, 3.0, 2.0], [0.5, 0.0, -0.5, 0.25]])
    nrm, idx = norms.inf_norm_with_index(v)
    assert nrm.tolist() == [3.0, 0.5] and idx.tolist() == [1, 0]
    jn, ji = jnorms.inf_norm_with_index(jnp.asarray(v[0].numpy()))
    assert float(jn) == 3.0 and int(ji) == 1
    assert norms.inf_norm(v).tolist() == [3.0, 0.5]


def test_active_set_random_sequence_matches_jax():
    """200 random inserts/removes against the JAX set and a sorted-list
    model (rank_index_test.cpp's exhaustive walk), with rank_of,
    contains and rank_at at every step."""
    rng = np.random.RandomState(0)
    pidx, jidx, model = aset.empty(N, N), jaset.empty(N, N), []
    for _ in range(200):
        v = int(rng.randint(0, N))
        if v in model:
            pidx, pr = aset.remove(pidx, v, N)
            jidx, jr = jaset.remove(jidx, v, N)
            assert int(pr) == int(jr) == model.index(v)
            model.remove(v)
        else:
            pidx, pr = aset.insert(pidx, v, N)
            jidx, jr = jaset.insert(jidx, v, N)
            model.append(v)
            model.sort()
            assert int(pr) == int(jr) == model.index(v)
        assert pidx.tolist() == np.asarray(jidx).tolist()
        assert pidx.tolist() == model + [N] * (N - len(model))
        w = int(rng.randint(0, N))
        assert int(aset.rank_of(pidx, w)) == int(jaset.rank_of(jidx, w))
        assert bool(aset.contains(pidx, w)) == (w in model)
        if model:
            r = int(rng.randint(len(model)))
            assert int(aset.rank_at(pidx, r)) == model[r]


def test_active_set_lanes_and_sentinel_slots():
    """Per-lane values, and take/scatter with every slot filled and with
    every slot empty (the sentinel never indexes)."""
    idx = aset.empty(CAP, N, lanes=2)
    idx, r = aset.insert(idx, torch.tensor([7, 3]), N)
    assert r.tolist() == [0, 0]
    idx, r = aset.insert(idx, torch.tensor([2, 9]), N)
    assert r.tolist() == [0, 1]
    assert idx[:, :2].tolist() == [[2, 7], [3, 9]]
    assert aset.contains(idx, torch.tensor([7, 7])).tolist() == [True, False]
    v = torch.arange(2 * N, dtype=torch.float32).reshape(2, N) + 1
    full = torch.stack([torch.randperm(N)[:CAP] for _ in range(2)]).int()
    empty = aset.empty(CAP, N, lanes=2)
    for slots in (full, empty, idx):
        got = aset.take(v, slots, N)
        want = np.where(slots.numpy() < N, np.take_along_axis(
            v.numpy(), np.minimum(slots.numpy(), N - 1), 1), 0)
        np.testing.assert_array_equal(got.numpy(), want)
        dense = aset.scatter(got, slots, N)
        ref = np.zeros((2, N), np.float32)
        for lane in range(2):
            live = slots[lane].numpy() < N
            ref[lane, slots[lane].numpy()[live]] = got[lane].numpy()[live]
        np.testing.assert_array_equal(dense.numpy(), ref)
    assert not aset.scatter(aset.take(v, empty, N), empty, N).any()


@pytest.mark.parametrize("A,src,dest", [
    (np.array([[1, 2], [3, 4]]), 0, 1),
    (np.arange(1, 10).reshape(3, 3), 1, 2),
    (np.arange(1, 10).reshape(3, 3), 0, 2),
    (np.arange(1, 17).reshape(4, 4), 1, 3),
    (np.arange(1, 17).reshape(4, 4), 2, 1),
])
def test_square_permute_matches_jax_and_inverts(A, src, dest):
    A = A.astype(np.float32)
    out = oinv.square_permute(torch.from_numpy(A), src, dest)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(joinv.square_permute(jnp.asarray(A), src,
                                                     dest)))
    np.testing.assert_array_equal(
        oinv.square_permute(out, dest, src).numpy(), A)


def test_identity_sweep():
    """Insert then remove every column of I_K: the inverse stays the
    identity and the padding zero (online_inverse_test.cpp:186-218)."""
    K = 10
    A = torch.eye(K)
    st = oinv.init(K, K, torch.float32)
    for k in range(K):
        col = torch.tensor([k])
        st = oinv.insert(st, col, A[:, k][None] @ A, torch.ones(1))
        np.testing.assert_allclose(st.inv[0, :k + 1, :k + 1].numpy(),
                                   np.eye(k + 1), atol=1e-6)
        assert not st.inv[0, k + 1:].any()
    for k in range(K - 1, -1, -1):
        st = oinv.remove(st, torch.tensor([k]))
        np.testing.assert_allclose(st.inv[0, :k, :k].numpy(), np.eye(k),
                                   atol=1e-6)
    assert int(st.k[0]) == 0 and not st.inv.any()


def _jax_state(st):
    return convert.inverse_state_from_numpy(
        st.inv, st.indices, st.mask, st.k, "cpu")


def _same(pst, jst, atol):
    got = convert.inverse_state_to_numpy(pst)
    assert got["indices"][0].tolist() == np.asarray(jst.indices).tolist()
    np.testing.assert_array_equal(got["mask"][0], np.asarray(jst.mask))
    assert int(got["k"][0]) == int(jst.k)
    np.testing.assert_allclose(got["inv"][0], np.asarray(jst.inv), atol=atol)


def test_ordered_toggles_step_with_jax_float64():
    """The exact-mode inverse: a 60-step random walk, each toggle applied
    to the JAX state carried across, equal to the JAX result, and the
    padded buffer equal to inv(A_ΓᵀA_Γ) in rank order."""
    rng = np.random.RandomState(3)
    M, n, cap = 30, 12, 12
    A = rng.randn(M, n)
    G = A.T @ A
    jst = joinv.init(cap, n, jnp.float64)
    members = []
    for _ in range(60):
        col = int(rng.randint(n))
        pst = _jax_state(jst)
        if col in members:
            jst = joinv.remove(jst, jnp.int32(col))
            pst = oinv.remove(pst, torch.tensor([col]))
            members.remove(col)
        else:
            jst = joinv.insert(jst, jnp.int32(col), jnp.asarray(G[:, col]),
                               jnp.asarray(G[col, col]))
            pst = oinv.insert(pst, torch.tensor([col]),
                              torch.from_numpy(G[:, col])[None],
                              torch.tensor([G[col, col]]))
            members.append(col)
        _same(pst, jst, atol=1e-12)
        k = len(members)
        if k:
            sup = sorted(members)
            np.testing.assert_allclose(
                pst.inv[0, :k, :k].numpy(),
                np.linalg.inv(A[:, sup].T @ A[:, sup]), atol=1e-8)


def test_unordered_toggles_step_with_jax():
    """The fast-mode inverse (append insert, swap remove) and the
    companion swap_drop_rowcol, stepped from carried JAX state in f32."""
    rng = np.random.RandomState(0)
    n, cap = 24, 9
    A = rng.randn(48, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    G = (A.T @ A).astype(np.float32)
    jst = joinv.init(cap, n, jnp.float32)
    members = []
    for _ in range(40):
        pst = _jax_state(jst)
        if members and (len(members) >= cap - 1 or rng.rand() < 0.3):
            col = int(members[rng.randint(len(members))])
            jst = joinv.remove_unordered(jst, jnp.int32(col))
            pst = oinv.remove_unordered(pst, torch.tensor([col]))
            members.remove(col)
        else:
            col = int(rng.choice([j for j in range(n) if j not in members]))
            idxs = np.asarray(jst.indices)
            u1 = np.where(idxs < n, G[np.minimum(idxs, n - 1), col], 0
                          ).astype(np.float32)
            jst = joinv.insert_unordered(jst, jnp.int32(col),
                                         jnp.asarray(u1),
                                         jnp.float32(G[col, col]))
            pst = oinv.insert_unordered(pst, torch.tensor([col]),
                                        torch.from_numpy(u1)[None],
                                        torch.tensor([G[col, col]]))
            members.append(col)
        _same(pst, jst, atol=1e-5)
    M = np.arange(25, dtype=np.float32).reshape(5, 5)
    for pos, last in ((1, 3), (3, 3), (0, 4)):
        np.testing.assert_array_equal(
            oinv.swap_drop_rowcol(torch.from_numpy(M), pos, last).numpy(),
            np.asarray(joinv.swap_drop_rowcol(jnp.asarray(M), pos, last)))


def test_out_of_range_slots_index_nothing():
    """A full insert (k = capacity) and a remove from an empty set, the
    cases a frozen lane or the unselected side of a toggle runs: nothing
    raises, the full insert writes no slot, and the lanes stay
    independent."""
    n, cap = 6, 2
    st = oinv.init(cap, n, torch.float32, lanes=2)
    st = oinv.insert_unordered(st, torch.tensor([1, 4]), torch.zeros(2, cap),
                               torch.ones(2))
    st = oinv.insert_unordered(st, torch.tensor([2, 5]), torch.zeros(2, cap),
                               torch.ones(2))
    full = oinv.insert_unordered(st, torch.tensor([3, 0]),
                                 torch.zeros(2, cap), torch.ones(2))
    assert torch.equal(full.indices, st.indices)
    assert torch.equal(full.inv, st.inv)
    gone = oinv.remove(oinv.remove(st, torch.tensor([1, 4])),
                       torch.tensor([2, 5]))
    assert gone.k.tolist() == [0, 0]
    again = oinv.remove(gone, torch.tensor([0, 0]))
    assert again.k.tolist() == [-1, -1]
    oinv.remove_unordered(gone, torch.tensor([0, 0]))
    oinv.insert(full, torch.tensor([0, 1]), torch.zeros(2, n), torch.ones(2))
