"""The PyTorch port's batch driver against the JAX batch driver, on the CPU.

Both run the same seeded problems at "high" precision: the JAX driver with
its Pallas kernels in interpret mode (``use_kernel=False``), the port on
``device="cpu"``, where its kernel wrappers run their plain twins. The
trajectories are compared only at "high": on the CPU, JAX ignores the
one-pass DEFAULT hint (tests/test_pallas.py:73-76) while the port's
"default" really rounds to bf16. Tolerances: iteration counts, slot
indices, kk and broke exact; floats to 1e-5 (f32 sums in another order).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

from _torch_cases import compressive_problem
from sparse_solvers_tpu.ops import blas as jblas
from sparse_solvers_tpu.oracle import homotopy as oracle
from sparse_solvers_tpu.solvers import homotopy_batch as JHB
from sparse_solvers_tpu_torch import convert, densify_batch
from sparse_solvers_tpu_torch.ops import blas as pblas
from sparse_solvers_tpu_torch.solvers import homotopy_batch as PHB


def _gram(A):
    return np.array(jnp.asarray(A).T @ jnp.asarray(A))


def _jax_driver(A, G, Y, tol, max_it, k_max, ladder=None):
    f = jax.jit(partial(JHB.solve_homotopy_batch, max_iterations=max_it,
                        k_max=k_max, use_kernel=False, ladder=ladder))
    with jblas.precision_scope("high"):
        X, R = f(jnp.asarray(A), jnp.asarray(G), jnp.asarray(Y), tol)
    return np.asarray(X), np.asarray(R.iter), np.asarray(R.solution_error)


def _port_driver(A, G, Y, tol, max_it, k_max, ladder=None, dense=True):
    t = torch.from_numpy
    with pblas.precision_scope("high"):
        return PHB.solve_homotopy_batch(t(A), t(G), t(Y), tol, max_it,
                                        k_max, ladder=ladder, dense=dense)


def _assert_state_close(ps, js, step, tied=()):
    """Port state ``ps`` against JAX state ``js``. ``tied`` lanes took a
    terminal tie (see the stepper test): their last inserted slot may
    hold another column, so that slot's index and c_act, and the
    matrices, direction and mask built from it, are not compared."""
    got, want = convert.state_to_numpy(ps), {
        k: np.asarray(v) for k, v in js._asdict().items()}
    ok = np.ones(len(got["it"]), bool)
    ok[list(tied)] = False
    slot_ok = np.ones_like(got["indices"], bool)
    for lane in tied:
        slot_ok[lane, got["kk"][lane] - 1] = False
    msg = lambda k: f"{k} at step {step}"
    for k in ("it", "kk", "broke"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=msg(k))
    np.testing.assert_array_equal(got["indices"][slot_ok],
                                  want["indices"][slot_ok],
                                  err_msg=msg("indices"))
    np.testing.assert_array_equal(got["mask"][ok], want["mask"][ok],
                                  err_msg=msg("mask"))
    close = lambda g, w, k: np.testing.assert_allclose(
        g, w, rtol=1e-5, atol=1e-5, err_msg=msg(k))
    for k in ("c", "c_inf", "x_act"):
        close(got[k], want[k], k)
    close(got["c_act"][slot_ok], want["c_act"][slot_ok], "c_act")
    for k in ("inv", "gk", "d_act"):
        close(got[k][ok], want[k][ok], k)


def test_stepper_parity_step_by_step():
    """The problem of tests/test_batch_native.py:19-40. Both bodies step
    from the JAX initial state carried across with convert.py; the port's
    own init must agree with it too.

    On these exact k-sparse signals each lane's last step is a terminal
    tie: once the true support is in, every inactive candidate equals
    c_inf in exact arithmetic, the step drives ‖c‖∞ to rounding level,
    and which column joins (with value 0) is decided by f32 rounding
    noise. Such a lane must be frozen after that step with its ‖c‖∞ below
    1e-5 of its value before it; the column it inserted is then exempt."""
    A, Y, _ = compressive_problem(128, 256, 8, 16)
    G = _gram(A)
    with jblas.precision_scope("high"):
        jinit, jbody, jlive = JHB.make_stepper(
            jnp.asarray(A), jnp.asarray(G), jnp.asarray(Y), 0.01, 40, 41,
            use_kernel=False)
        jbody = jax.jit(jbody)
        with pblas.precision_scope("high"):
            pinit, pbody, plive = PHB.make_stepper(
                torch.from_numpy(A), torch.from_numpy(G),
                torch.from_numpy(Y), 0.01, 40, 41)
        _assert_state_close(pinit(), jinit, "init")
        js = jinit
        ps = convert.state_from_numpy(
            {k: np.asarray(v) for k, v in jinit._asdict().items()}, "cpu")
        step, tied = 0, set()
        while bool(jnp.any(jlive(js))):
            live = np.asarray(jlive(js))
            assert plive(ps).tolist() == live.tolist()
            before = np.asarray(js.c_inf)
            js, ps = jbody(js), pbody(ps)
            step += 1
            differs = (ps.indices.numpy() != np.asarray(js.indices)).any(1)
            for lane in np.flatnonzero(differs & live):
                assert not bool(jlive(js)[lane])
                assert float(js.c_inf[lane]) < 1e-5 * before[lane]
                tied.add(int(lane))
            _assert_state_close(ps, js, step, sorted(tied))
    assert not bool(plive(ps).any())
    assert step >= 8 and len(tied) < 16


@pytest.mark.parametrize("case", ["well_conditioned", "lane_freeze"])
def test_driver_matches_jax_high(case):
    if case == "well_conditioned":     # tests/test_batch_native.py:19
        A, Y, _ = compressive_problem(128, 256, 8, 16)
        max_it, k_max = 40, 41
    else:                              # tests/test_batch_native.py:43
        rng = np.random.RandomState(1)
        m, n, B = 96, 192, 6
        A = rng.randn(m, n).astype(np.float32)
        A /= np.linalg.norm(A, axis=0)
        X = np.zeros((B, n), np.float32)
        for i in range(B):
            X[i, rng.choice(n, 2 + 3 * i, replace=False)] = rng.uniform(
                0.5, 1, 2 + 3 * i)
        Y = (X @ A.T).astype(np.float32)
        max_it, k_max = 60, 61
    G = _gram(A)
    Xj, ij, ej = _jax_driver(A, G, Y, 0.01, max_it, k_max)
    X, rep = _port_driver(A, G, Y, 0.01, max_it, k_max)
    np.testing.assert_array_equal(rep.iter.numpy(), ij)
    err = rep.solution_error.numpy()
    if case == "well_conditioned":
        np.testing.assert_allclose(X.numpy(), Xj, atol=1e-5)
        np.testing.assert_allclose(err, ej, atol=1e-5)
    else:
        # lanes 4 and 5 hold 14 and 17 nonzeros against 96 rows: there the
        # JAX driver itself sits ~2e-4 from the float64 oracle, so the two
        # f32 drivers are held to 1e-4 (measured 5e-5 apart) and to 1e-5
        # on the four small lanes
        assert len(set(ij.tolist())) > 1
        np.testing.assert_allclose(X.numpy(), Xj, atol=1e-4)
        np.testing.assert_allclose(X.numpy()[:4], Xj[:4], atol=1e-5)
        np.testing.assert_allclose(err, ej, atol=1e-4)


def test_capacity_ladder_case_matches_jax():
    """The ladder case of tests/test_certified.py:166-187 (256x512, k=8,
    b=6, k_max 48, tiers [16, 24, 48]) at "high": the port's three-tier
    run equals the JAX driver's and its own single-tier run."""
    A, Y, Xt = compressive_problem(256, 512, 8, 6)
    assert PHB._plan_tiers(48, 64, None) == [16, 24, 48]
    G = _gram(A)
    Xj, ij, _ = _jax_driver(A, G, Y, 1e-2, 64, 48)
    X, rep = _port_driver(A, G, Y, 1e-2, 64, 48)
    X1, rep1 = _port_driver(A, G, Y, 1e-2, 64, 48, ladder=False)
    np.testing.assert_array_equal(rep.iter.numpy(), ij)
    np.testing.assert_allclose(X.numpy(), Xj, atol=1e-5)
    np.testing.assert_array_equal(rep1.iter.numpy(), ij)
    np.testing.assert_allclose(X1.numpy(), X.numpy(), atol=1e-5)
    for lane in range(6):
        assert (set(np.flatnonzero(X[lane].numpy() > 0.1))
                == set(np.flatnonzero(Xt[lane])))


def test_lanes_match_numpy_oracle():
    """A third check: the float64 NumPy oracle (oracle/homotopy.py), which
    recomputes the active-set inverse densely every iteration."""
    A, Y, _ = compressive_problem(128, 256, 6, 16, seed=4)
    X, rep = _port_driver(A, _gram(A), Y, 0.01, 40, 41)
    for lane in (0, 5, 11):
        xo, it_o, err_o = oracle.solve(A, Y[lane], 0.01, 40)
        assert int(rep.iter[lane]) == it_o
        np.testing.assert_allclose(X[lane].numpy(), xo, atol=1e-4)
        np.testing.assert_allclose(float(rep.solution_error[lane]), err_o,
                                   atol=1e-4)


def test_removals_stay_finite_and_mostly_in_parity():
    """Signed coefficients and noise force removals and near-ties
    (tests/test_batch_native.py:69): no NaN/Inf, iteration parity with the
    JAX driver on most lanes, equal solutions where the iterations agree."""
    rng = np.random.RandomState(3)
    m, n, k, B = 40, 80, 10, 12
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Xt = np.zeros((B, n), np.float32)
    for i in range(B):
        Xt[i, rng.choice(n, k, replace=False)] = rng.randn(k)
    Y = (Xt @ A.T + 0.01 * rng.randn(B, m)).astype(np.float32)
    G = _gram(A)
    Xj, ij, _ = _jax_driver(A, G, Y, 0.05, 60, 61)
    X, rep = _port_driver(A, G, Y, 0.05, 60, 61)
    X, ip = X.numpy(), rep.iter.numpy()
    assert np.isfinite(X).all()
    assert np.isfinite(rep.solution_error.numpy()).all()
    agree = ip == ij
    assert agree.sum() >= B // 2, f"only {agree.sum()}/{B} lanes in parity"
    # 10 signed nonzeros plus noise against 40 rows: near-degenerate
    # supports amplify f32 summation-order differences (measured 2.4e-5)
    np.testing.assert_allclose(X[agree], Xj[agree], atol=1e-4)


def test_compact_output_densifies_to_dense():
    A, Y, _ = compressive_problem(128, 256, 8, 8, seed=2)
    G = _gram(A)
    X, rep = _port_driver(A, G, Y, 0.01, 40, 41)
    (vals, idxs), rep_c = _port_driver(A, G, Y, 0.01, 40, 41, dense=False)
    assert vals.shape == idxs.shape == (8, 41)
    assert idxs.dtype == torch.int32 and int(idxs.max()) == 256
    assert torch.equal(densify_batch(vals, idxs, 256), X)
    assert torch.equal(densify_batch(vals.numpy(), idxs.numpy(), 256), X)
    assert torch.equal(rep_c.iter, rep.iter)


def test_empty_batch_returns_empty():
    A, _, _ = compressive_problem(128, 256, 4, 1)
    G = _gram(A)
    Y0 = np.zeros((0, 128), np.float32)
    X, rep = _port_driver(A, G, Y0, 0.1, 16, 17)
    assert X.shape == (0, 256) and rep.iter.shape == (0,)
    (v, i), _ = _port_driver(A, G, Y0, 0.1, 16, 17, dense=False)
    assert v.shape == i.shape == (0, 17)


def test_remove_to_empty_breaks_with_solution_intact():
    """tests/test_batch_native.py:128: the scan picks the removal of a
    lane's only member; the lane breaks with its solution intact."""
    n = m = 8
    K = 4
    A = torch.eye(m, n)
    init, body, _ = PHB.make_stepper(A, torch.eye(n), torch.zeros(1, m),
                                     0.01, 10, K)
    s = init()._replace(
        it=torch.tensor([1], dtype=torch.int32),
        c=torch.zeros(1, n).index_fill_(1, torch.tensor([3]), 1.0),
        c_inf=torch.tensor([1.0]),
        mask=torch.zeros(1, n, dtype=torch.int8).index_fill_(
            1, torch.tensor([3]), 1),
        inv=torch.zeros(1, K, K).index_put_(
            (torch.tensor([0]),) * 3, torch.tensor([1.0])),
        gk=torch.zeros(1, K, K).index_put_(
            (torch.tensor([0]),) * 3, torch.tensor([1.0])),
        x_act=torch.tensor([[0.9, 0, 0, 0]]),
        d_act=torch.tensor([[-2.0, 0, 0, 0]]),
        c_act=torch.tensor([[1.0, 0, 0, 0]]),
        indices=torch.tensor([[3, n, n, n]], dtype=torch.int32),
        kk=torch.tensor([1], dtype=torch.int32),
        broke=torch.tensor([False]))
    out = body(s)
    assert bool(out.broke[0]) and int(out.kk[0]) == 1
    assert int(out.indices[0, 0]) == 3
    np.testing.assert_allclose(float(out.x_act[0, 0]), 0.9, atol=1e-6)
    assert int(out.mask[0, 3]) == 1


@pytest.mark.parametrize("k_max,max_it,ladder", [
    (96, 128, None), (40, 64, True), (40, 64, None), (48, 64, None),
    (48, 20, None), (41, 40, False), (48, 64, [16, 24, 48]),
    (48, 20, [16, 24, 48]), (9, 30, True)])
def test_plan_tiers_matches_jax(k_max, max_it, ladder):
    assert (PHB._plan_tiers(k_max, max_it, ladder)
            == JHB._plan_tiers(k_max, max_it, ladder))


def test_state_round_trips_through_numpy():
    A, Y, _ = compressive_problem(64, 128, 4, 3)
    init, _, _ = PHB.make_stepper(torch.from_numpy(A),
                                  torch.from_numpy(_gram(A)),
                                  torch.from_numpy(Y), 0.01, 10, 11)
    s = init()
    d = convert.state_to_numpy(s)
    assert d["it"].dtype == np.uint32
    back = convert.state_from_numpy(d, "cpu")
    for a, b in zip(s, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    d.pop("mask")
    with pytest.raises(ValueError, match="mask"):
        convert.state_from_numpy(d, "cpu")
