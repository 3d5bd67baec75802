"""The port's multi-process mesh cases and their launcher (numpy, torch and
the port; no jax).

``CASES`` maps a case name to ``fn(mesh) -> dict of numpy arrays``; the
child program ``_torch_dist_child.py`` runs them on every rank of a gloo
group, and the ``tests/test_torch_mesh_*.py`` files compare what each rank
returns with the JAX package's sharded routes on the same inputs, which
the problem functions below make from a seed. ``Launch`` starts the child
on a world of processes; ``Launch.get`` waits for it and returns each
rank's results.

``instrument`` (in the child) wraps the solvers' eager loop
(``loops.synced_while``, which every loop off a card runs) and CG-IRLS's
inner solve so each case also records the collectives issued inside every
loop trip and every CG matvec: the counter-based form of the JAX tests'
HLO collective counts.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import sparse_solvers_tpu_torch as pt
from sparse_solvers_tpu_torch import certify
from sparse_solvers_tpu_torch.ops import collectives
from sparse_solvers_tpu_torch.parallel import distributed
from sparse_solvers_tpu_torch.parallel import sharding as sh
from sparse_solvers_tpu_torch.solvers import irls_cg as CG
from sparse_solvers_tpu_torch.solvers import loops

ROOT = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "_torch_dist_child.py"
# the subprocess bound of one launch: the gloo timeout (30 s) bounds each
# collective, this the whole run
LAUNCH_TIMEOUT_S = 55
KINDS = ("all_reduce", "all_gather", "ring_step")

# --------------------------------------------------------------- problems


def sparse_problem(seed, m, n, batch, k, dtype=np.float32):
    """Column-normalized Gaussian A and k-sparse signals with values in
    [0.3, 1) (tests/test_sharding.py::_sparse_batch): (A, X0, Y)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n).astype(dtype)
    A /= np.linalg.norm(A, axis=0)
    X0 = np.zeros((batch, n), dtype)
    for i in range(batch):
        X0[i, rng.choice(n, k, replace=False)] = rng.uniform(0.3, 1, k)
    return A, X0, (X0 @ A.T).astype(dtype)


def l1_problem(seed, m, n, batch, k, dtype=np.float64):
    """A with unit ℓ₁ columns and k-sparse signals with values in [0.2, 1)
    (tests/test_sharding.py::_problem): (A, Y)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n)
    A = A / np.abs(A).sum(axis=0)
    Y = []
    for _ in range(batch):
        x = np.zeros(n)
        x[rng.choice(n, k, replace=False)] = rng.uniform(0.2, 1.0, k)
        Y.append(A @ x)
    return A.astype(dtype), np.stack(Y).astype(dtype)


def divergent_problem():
    """Lanes 0-3 1-sparse (a few iterations), lanes 4-7 24-sparse (tens):
    on a mesh with a data axis of 2 the two data slices run very
    different loop counts (test_sharding.py:1084-1120)."""
    rng = np.random.RandomState(21)
    m, n = 64, 512
    A = rng.randn(m, n).astype(np.float32)
    A /= np.linalg.norm(A, axis=0)
    Y = np.zeros((8, m), np.float32)
    for i in range(4):
        x = np.zeros(n, np.float32)
        x[rng.randint(n)] = 1.0
        Y[i] = A @ x
    for i in range(4, 8):
        x = np.zeros(n, np.float32)
        x[rng.choice(n, 24, replace=False)] = rng.uniform(0.2, 1, 24)
        Y[i] = A @ x
    return A, Y


def cg_problem(seed=4, m=16, n=50, batch=8, k=2, dtype=np.float64):
    """An underdetermined problem for CG-IRLS (test_mesh_api.py:122-139):
    (A, X0, Y); n = 50 pads to the column-shard multiple."""
    return sparse_problem(seed, m, n, batch, k, dtype)


P_DRIVER = functools.partial(sparse_problem, 7, 32, 128, 8, 3)
P_CORE = functools.partial(l1_problem, 0, 37, 20, 8, 3)
P_CERT = functools.partial(sparse_problem, 3, 64, 128, 8, 4)
P_CONTRACT = functools.partial(l1_problem, 0, 24, 16, 4, 2, np.float32)
P_OMP_CORE = functools.partial(l1_problem, 7, 37, 24, 8, 3)
P_OMP_SPARSE = functools.partial(l1_problem, 11, 40, 24, 8, 2)
P_OMP_DRIVER = functools.partial(sparse_problem, 29, 64, 256, 8, 5)
P_IRLS = functools.partial(l1_problem, 1, 40, 20, 8, 3)
P_FACADE = functools.partial(sparse_problem, 0, 37, 64, 7, 3)
QR_SHAPES = ((40, 20), (37, 24), (64, 64))
HOM_TOL, HOM_IT = 1e-3, 30
OMP_TOL, OMP_IT = 1e-2, 30
CERT_TOL = 1e-2
UPDATE_J = 5


def update_vector(m: int) -> np.ndarray:
    v = np.random.RandomState(6).randn(m).astype(np.float32)
    return v / np.linalg.norm(v)


def qr_input(m, n, dtype):
    return np.random.RandomState(m + n).randn(m, n).astype(dtype)

# ------------------------------------------------------------ instruments


_RECORD: dict[str, list] = {}


def reset_records() -> None:
    _RECORD.clear()
    _RECORD.update(trips=[], loops=[], matvecs=[], cg_solves=[0])


def _delta(before: dict) -> list[int]:
    return [collectives.counts[k] - before[k] for k in KINDS]


def instrument() -> None:
    """Wrap the solvers' loop and CG-IRLS's inner solve so every trip and
    every CG matvec records the collectives it issued."""
    real_while, real_cg = loops.synced_while, CG._cg_solve

    def synced_while(body, live_fn, state, sync_axes=None, counts=None):
        def counted(s):
            before = dict(collectives.counts)
            s = body(s)
            _RECORD["trips"].append(_delta(before))
            return s
        before, trips0 = dict(collectives.counts), len(_RECORD["trips"])
        state = real_while(counted, live_fn, state, sync_axes, counts)
        total = _delta(before)
        trips = _RECORD["trips"][trips0:]
        # (trips, the loop's own all-reduces: the synced continue flags)
        _RECORD["loops"].append(
            [len(trips), total[0] - sum(t[0] for t in trips)])
        return state

    def cg_solve(body_matvec, *args, **kwargs):
        def counted(V):
            before = dict(collectives.counts)
            out = body_matvec(V)
            _RECORD["matvecs"].append(_delta(before))
            return out
        _RECORD["cg_solves"][0] += 1
        return real_cg(counted, *args, **kwargs)

    loops.synced_while = synced_while
    CG._cg_solve = cg_solve
    reset_records()


def records() -> dict:
    out = {}
    for key in ("trips", "loops", "matvecs"):
        rows = _RECORD[key]
        width = 2 if key == "loops" else len(KINDS)
        out[key] = np.asarray(rows, np.int64).reshape(len(rows), width)
    out["cg_solves"] = np.int64(_RECORD["cg_solves"][0])
    return out

# ------------------------------------------------------------------ cases


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _out(out, prefix: str = "") -> dict:
    """The arrays of a route's (X, report) or (values, indices, report)."""
    *X, rep = out
    res = {f"{prefix}{f}": _np(v) for f, v in zip(rep._fields, rep)}
    if len(X) == 1:
        res[f"{prefix}X"] = _np(X[0])
    else:
        res[f"{prefix}values"], res[f"{prefix}indices"] = map(_np, X)
    return res


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _hom_driver(mesh, **kw):
    A, _, Y = P_DRIVER()
    return _out(sh.homotopy_sharded(mesh, A, Y, HOM_TOL, HOM_IT,
                                    batch_native=True, **kw))


for _name, _kw in (("hom_driver", {}),
                   ("hom_driver_gram_free", dict(gram=False)),
                   ("hom_overlap_blocks", dict(overlap_blocks=4)),
                   ("hom_ppermute", dict(overlap_mode="ppermute")),
                   ("hom_ppermute_gram_free",
                    dict(gram=False, overlap_mode="ppermute"))):
    CASES[_name] = functools.partial(_hom_driver, **_kw)


def _hom_core(mesh, **kw):
    A, Y = P_CORE()
    return _out(sh.homotopy_sharded(mesh, A, Y, 0.01, 50, **kw))


for _name, _kw in (("hom_core", {}), ("hom_core_dense", dict(gram=False)),
                   ("hom_core_split", dict(gram=False, overlap_split=2))):
    CASES[_name] = functools.partial(_hom_core, **_kw)


@case
def hom_compact(mesh):
    A, _, Y = P_DRIVER()
    res = _out(sh.homotopy_sharded(mesh, A, Y, HOM_TOL, HOM_IT,
                                   batch_native=True, dense=False))
    res.update(_out(sh.homotopy_sharded(mesh, A, Y, HOM_TOL, HOM_IT,
                                        batch_native=False, dense=False),
                    "core_"))
    res.update(_out(sh.homotopy_sharded(mesh, A, Y, HOM_TOL, HOM_IT,
                                        batch_native=True), "dense_"))
    return res


@case
def hom_certified(mesh):
    A, _, Y = P_CERT()
    res = {}
    for bn in (True, False):
        res.update(_out(sh.homotopy_sharded(
            mesh, A, Y, CERT_TOL, 60, precision="certified",
            batch_native=bn), f"bn{int(bn)}_"))
    return res


def _force_lane0(real):
    def spoofed(errs, iters, tolerance, max_iterations):
        bad = real(errs, iters, tolerance, max_iterations).copy()
        bad[0] = True
        return bad
    return spoofed


def _resolve(mesh, route, **kw):
    real = certify.failed_lanes
    certify.failed_lanes = _force_lane0(real)
    try:
        res = _out(route(mesh, precision="certified", **kw), "cert_")
    finally:
        certify.failed_lanes = real
    res.update(_out(route(mesh, precision="high", **kw), "high_"))
    return res


@case
def hom_resolve(mesh):
    A, _, Y = P_CERT()
    return _resolve(mesh, lambda mesh, **kw: sh.homotopy_sharded(
        mesh, A, Y, CERT_TOL, 60, batch_native=True, **kw))


@case
def hom_divergence(mesh):
    A, Y = divergent_problem()
    res = _out(sh.homotopy_sharded(mesh, A, Y, 1e-3, 80, batch_native=True,
                                   overlap_mode="ppermute"), "ring_")
    res["ring_loops"] = np.asarray(_RECORD["loops"], np.int64)
    res.update(_out(sh.homotopy_sharded(mesh, A, Y, 1e-3, 80,
                                        batch_native=True,
                                        overlap_mode="psum"), "psum_"))
    return res


def _contract(mesh, **kw):
    A, Y = P_CONTRACT()
    return _out(sh.homotopy_sharded(mesh, A, Y, 1e-2, 8, batch_native=False,
                                    **kw))


CASES["hom_core_sparse_contract"] = functools.partial(_contract, gram=True)
CASES["hom_core_dense_contract"] = functools.partial(_contract, gram=False)


@case
def gram_and_update(mesh):
    A, _, _ = P_DRIVER()
    G = sh.gram_replicated(mesh, A)
    A2, G2 = sh.update_column_sharded(mesh, A, G, update_vector(A.shape[0]),
                                      UPDATE_J)
    A3, none = sh.update_column_sharded(mesh, A, None,
                                        update_vector(A.shape[0]), UPDATE_J)
    return {"G": _np(G), "A2": _np(A2), "G2": _np(G2), "A3": _np(A3),
            "no_gram": np.bool_(none is None)}

# OMP


def _omp_core(mesh, problem=P_OMP_CORE, tol=1e-6, max_it=30, **kw):
    A, Y = problem()
    return _out(sh.omp_sharded(mesh, A, Y, tol, max_it, **kw))


for _name, _kw in (("omp_core_gram", dict(gram=True)),
                   ("omp_core_dense", dict(gram=False)),
                   ("omp_core_sparse", dict(gram=False, k_max=6, max_it=20,
                                            problem=P_OMP_SPARSE)),
                   ("omp_core_gomp", dict(gram=True, picks=4))):
    CASES[_name] = functools.partial(_omp_core, **_kw)


def _omp_driver(mesh, **kw):
    A, _, Y = P_OMP_DRIVER()
    return _out(sh.omp_sharded(mesh, A, Y, OMP_TOL, OMP_IT,
                               batch_native=True, **kw))


for _name, _kw in (("omp_driver", {}),
                   ("omp_driver_gram_free", dict(gram=False)),
                   ("omp_driver_gomp", dict(picks=4)),
                   ("omp_driver_gomp_gram_free", dict(picks=4, gram=False)),
                   ("omp_overlap_blocks", dict(overlap_blocks=4)),
                   ("omp_ppermute", dict(overlap_mode="ppermute"))):
    CASES[_name] = functools.partial(_omp_driver, **_kw)


@case
def omp_compact(mesh):
    A, _, Y = P_OMP_DRIVER()
    res = {}
    for bn in (True, False):
        res.update(_out(sh.omp_sharded(mesh, A, Y, OMP_TOL, OMP_IT,
                                       batch_native=bn, dense=False),
                        f"bn{int(bn)}_"))
        res.update(_out(sh.omp_sharded(mesh, A, Y, OMP_TOL, OMP_IT,
                                       batch_native=bn), f"dense{int(bn)}_"))
    return res


@case
def omp_certified(mesh):
    A, _, Y = P_OMP_DRIVER()
    res = {}
    for bn in (True, False):
        res.update(_out(sh.omp_sharded(mesh, A, Y, OMP_TOL, OMP_IT,
                                       precision="certified",
                                       batch_native=bn), f"bn{int(bn)}_"))
    # with the façades' Gram, all-reduced once at "highest"
    res.update(_out(sh.omp_sharded(mesh, A, Y, OMP_TOL, OMP_IT,
                                   precision="certified", batch_native=True,
                                   G=sh.gram_replicated(mesh, A)), "g_"))
    return res


@case
def omp_resolve(mesh):
    A, _, Y = P_OMP_DRIVER()
    return _resolve(mesh, lambda mesh, **kw: sh.omp_sharded(
        mesh, A, Y, OMP_TOL, OMP_IT, batch_native=True, **kw))


@case
def cosamp(mesh):
    A, _, Y = sparse_problem(5, 40, 96, 8, 4, np.float64)
    return _out(sh.cosamp_sharded(mesh, A, Y, 4, 1e-8, 20))

# IRLS family


def _qr(mesh, m, n, dtype):
    Q, R = sh.qr_sharded(mesh, qr_input(m, n, dtype))
    return {"Q": _np(Q), "R": _np(R)}


for _m, _n in QR_SHAPES:
    for _dt in (np.float32, np.float64):
        CASES[f"qr_{_m}x{_n}_{np.dtype(_dt).name}"] = functools.partial(
            _qr, m=_m, n=_n, dtype=_dt)


@case
def qr_rank_deficient(mesh):
    A = np.random.RandomState(0).randn(24, 6).astype(np.float32)
    A[:, 3] = A[:, 1]
    Q, R = sh.qr_sharded(mesh, A)
    return {"Q": _np(Q), "R": _np(R)}


def _irls(mesh, **kw):
    A, Y = P_IRLS()
    Q, R = np.linalg.qr(A)
    return _out(sh.irls_sharded(mesh, Q, R, Y, 1e-3, 50, **kw))


for _name, _kw in (("irls", {}), ("irls_gemm", dict(newton="gemm")),
                   ("irls_exact", dict(mode="exact")),
                   ("irls_stabilized", dict(stabilized=True))):
    CASES[_name] = functools.partial(_irls, **_kw)


@case
def irls_from_a(mesh):
    A, Y = P_IRLS()
    return _out(sh.irls_sharded_from_a(mesh, A, Y, 1e-3, 50))


@case
def irls_cg(mesh):
    A, _, Y = cg_problem()
    return _out(sh.irls_cg_sharded(mesh, A, Y, 1e-6, 40))

# façades and the process-group helpers


@case
def api_homotopy(mesh):
    A, _, Y = P_FACADE()
    s = pt.Homotopy(A, mesh=mesh, precision="high")
    res = _out(s.solve_batch(Y, 1e-3, 50))
    plan = s.explain(batch=8, max_iterations=50)
    res.update(gram_cached=np.bool_(plan["gram_cached"]),
               plan_sharded=np.bool_(plan["sharded"]),
               plan_mesh=np.array([plan["mesh"]["data"], plan["mesh"]["row"]]),
               plan_k_max=np.int64(plan["k_max"]),
               plan_gram=np.bool_(plan["gram"]))
    x, r = s.solve(Y[0], 1e-3, 50)
    res.update(x0=_np(x), iter0=np.int64(r.iter))
    res.update(_out(s.solve_batch(Y, 1e-3, 50, dense=False), "compact_"))
    Xd, rd = s.solve_batch_on_device(torch.from_numpy(Y), 1e-3, 50)
    res.update(device_X=_np(Xd), device_iter=_np(rd.iter))
    x1, r1 = s.solve_on_device(torch.from_numpy(Y[0]), 1e-3, 50)
    res.update(device_x0=_np(x1))
    cert = pt.Homotopy(A, mesh=mesh)
    res.update(_out(cert.solve_batch(Y, 1e-2, 50), "cert_"))
    return res


@case
def api_omp(mesh):
    A, _, Y = P_FACADE()
    res = {}
    for picks in (1, 2):
        s = pt.Omp(A, mesh=mesh, precision="high", picks=picks)
        res.update(_out(s.solve_batch(Y, 1e-3, 20), f"p{picks}_"))
        x, r = s.solve(Y[0], 1e-3, 20)
        res.update({f"p{picks}_x0": _np(x), f"p{picks}_iter0": r.iter})
    Xd, rd = s.solve_batch_on_device(torch.from_numpy(Y), 1e-3, 20)
    res.update(device_X=_np(Xd), device_iter=_np(rd.iter))
    res.update(_out(pt.Omp(A, mesh=mesh).solve_batch(Y, 1e-2, 20), "cert_"))
    res["sharded"] = np.bool_(pt.Omp(A, mesh=mesh).explain(batch=8)[
        "sharded"])
    return res


@case
def api_irls(mesh):
    A, Y = P_IRLS()
    s = pt.Irls(A, mesh=mesh)
    res = _out(s.solve_batch(Y, 1e-3, 50))
    Xd, rd = s.solve_batch_on_device(torch.from_numpy(Y[:5]), 1e-3, 50)
    res.update(device_X=_np(Xd), device_iter=_np(rd.iter))
    res["qr_cached"] = np.bool_(s.explain()["qr_cached"])
    res["host_qr"] = np.bool_(s._QR_cache is not None)
    return res


@case
def api_irls_cg(mesh):
    A, _, Y = cg_problem(dtype=np.float32)
    s = pt.IrlsCg(A, mesh=mesh)
    res = _out(s.solve_batch(Y[:7], 1e-5, 60))
    Xd, rd = s.solve_batch_on_device(torch.from_numpy(Y[:5]), 1e-5, 60)
    res.update(device_X=_np(Xd), device_iter=_np(rd.iter))
    return res


@case
def api_cosamp(mesh):
    A, _, Y = P_FACADE()
    s = pt.Cosamp(A, 3, mesh=mesh)
    res = _out(s.solve_batch(Y, 1e-3, 20))
    Xd, rd = s.solve_batch_on_device(torch.from_numpy(Y[:5]), 1e-3, 20)
    res.update(device_X=_np(Xd), device_iter=_np(rd.iter))
    return res


@case
def api_update_column(mesh):
    A, _, Y = sparse_problem(6, 37, 48, 4, 2)
    s = pt.Homotopy(A, mesh=mesh, precision="high")
    s.solve_batch(Y, 1e-3, 30)
    s.update_column(UPDATE_J, update_vector(37))
    res = {"placed": np.bool_(s._A_mesh is not None and s._G_mesh is not None),
           "G": _np(s._G_mesh), "A2": _np(s._A)}
    res.update(_out(s.solve_batch(Y, 1e-3, 30)))
    lazy = pt.Homotopy(A, mesh=mesh, precision="high")
    lazy.update_column(3, update_vector(37))
    res["lazy_unplaced"] = np.bool_(lazy._A_mesh is None)
    res.update(_out(lazy.solve_batch(Y, 1e-3, 30), "lazy_"))
    return res


@case
def api_errors(mesh):
    """Refusals, each raised on every rank before any collective."""
    A = np.eye(8, dtype=np.float32)
    msgs = []
    for make in (lambda: pt.Homotopy(A, mesh=mesh, engine="native"),
                 lambda: pt.Homotopy(A, mesh=mesh, mode="exact"),
                 lambda: pt.Omp(A, mesh=mesh, mode="exact"),
                 lambda: pt.Homotopy(A, mesh=mesh).solve_path(np.ones(8)),
                 lambda: pt.Homotopy(A, mesh=mesh).solve_path_batch(
                     np.ones((2, 8))),
                 lambda: sh.homotopy_sharded(mesh, A, np.ones((8, 8)), 1e-2,
                                             0),
                 lambda: sh.homotopy_sharded(mesh, A, np.ones((8, 8)), 1e-2,
                                             8, precision="fast"),
                 lambda: sh.homotopy_sharded(mesh, A, np.ones((3, 8)), 1e-2,
                                             8)):
        try:
            make()
            msgs.append("no error")
        except ValueError as e:
            msgs.append(str(e))
    return {"messages": np.array(msgs)}


@case
def dist_helpers(mesh):
    """The process-group helpers in a live group, and a sharded solve
    equal to this process's own unsharded one (tests/_dist_child.py)."""
    gm = distributed.global_mesh(n_data=mesh.shape["data"], device="cpu")
    rng = np.random.RandomState(0)
    m, n, k, batch = 32, 16, 2, 4
    A = rng.randn(m, n)
    A /= np.linalg.norm(A, axis=0)
    X0 = np.zeros((batch, n))
    for b in range(batch):
        X0[b, rng.choice(n, k, replace=False)] = rng.uniform(0.5, 1.0, k)
    Y = X0 @ A.T
    X, rep = sh.homotopy_sharded(gm, A, Y, 1e-6, 12)
    Xs, reps = pt.Homotopy(A, device="cpu", engine="jax").solve_batch(
        Y, 1e-6, 12)
    return {"initialized": np.bool_(distributed.is_initialized()),
            "again": np.bool_(distributed.initialize()),
            "index": np.int64(distributed.process_index()),
            "count": np.int64(distributed.process_count()),
            "shape": np.array([gm.shape["data"], gm.shape["row"]]),
            "X": _np(X), "iter": _np(rep.iter), "single_X": _np(Xs),
            "single_iter": _np(reps.iter)}

# ---------------------------------------------------------------- launcher


class Launch:
    """One run of the child program on ``world`` gloo ranks over
    ``specs``, started at construction; ``get`` waits for it (bounded by
    ``LAUNCH_TIMEOUT_S``) and returns each rank's results of one spec."""

    def __init__(self, world: int, specs: list[str], tmp: Path):
        self.world, self.specs, self.out = world, specs, tmp / "out"
        self.out.mkdir()
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                            "MASTER_PORT", "LOCAL_RANK")}
        env["PYTHONPATH"] = str(ROOT)
        env["CUDA_VISIBLE_DEVICES"] = ""
        self.t0 = time.monotonic()
        self.procs = [subprocess.Popen(
            [sys.executable, str(CHILD), str(r), str(world),
             str(tmp / "init"), str(self.out), *specs],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(world)]
        self.logs = None

    def wait(self):
        if self.logs is not None:
            return
        self.logs = []
        try:
            for p in self.procs:
                left = LAUNCH_TIMEOUT_S - (time.monotonic() - self.t0)
                out, err = p.communicate(timeout=max(left, 1.0))
                self.logs.append((p.returncode, out, err))
        except subprocess.TimeoutExpired:
            self.close()
            raise AssertionError(
                f"the {self.world}-rank child did not finish within "
                f"{LAUNCH_TIMEOUT_S} s")
        for rc, out, err in self.logs:
            assert rc == 0 and "TORCH_DIST_CHILD_OK" in out, (
                f"child failed (rc={rc}):\n{out}\n{err[-4000:]}")

    def get(self, spec: str) -> list[dict]:
        self.wait()
        shape, name = spec.split(":")
        ranks = []
        for r in range(self.world):
            with np.load(self.out / f"{shape}__{name}.{r}.npz") as f:
                got = dict(f)
            assert "error" not in got, f"{spec} rank {r}:\n{got['error']}"
            ranks.append(got)
        return ranks

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def same_on_every_rank(ranks: list[dict], keys=None) -> dict:
    """Assert every rank returned bit-identical arrays (NaNs in the same
    places) for ``keys`` (default: every result but the instruments) and
    return rank 0's."""
    skip = {"trips", "loops", "matvecs", "cg_solves", "rank", "data_index",
            "n_data", "ring_loops"}
    keys = keys or [k for k in ranks[0]
                    if k not in skip and not k.startswith("count_")]
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    return ranks[0]
