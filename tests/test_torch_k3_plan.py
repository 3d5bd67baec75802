"""K3's launch plan (``ops/cuda/transition.py::k3_launch_plan``) on the CPU.

The live-block transition of ``csrc/transition.cu`` runs only on the card;
which route a capacity takes, and what it asks of the card, is Python that
the CPU reaches. Every capacity takes exactly one route: the registers
route while a thread's tile of the inverse fits the register budget, the
device route beyond, its K-vectors in shared memory while they fit a
block's 232,448 bytes (the kernel has no static shared memory, so
nothing is taken off that) and in a per-lane workspace past that. The
Homotopy tiers and the default k_max take the registers route, gk's rows
load as float4 only where K and the alignment allow, and the plan's
constants are the ones the ``.cu`` file states.
"""

import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

from _torch_cases import (TRANSITION_EDGES, transition_edge_case,
                          transition_mix, vacant_nonzero)
from sparse_solvers_tpu_torch.ops import dispatch
from sparse_solvers_tpu_torch.ops.cuda import transition as K3

CSRC = Path(__file__).resolve().parents[1] / "sparse_solvers_tpu_torch" / "csrc"
MAX_SMEM_BYTES = 232448  # a block's dynamic shared memory on the H100


def _tile_floats(K):
    """A thread's tile of the inverse: rows w + 8r (r < 4C) by columns
    lane + 32c (c < C = ⌈K/32⌉)."""
    return 4 * (-(-K // 32)) ** 2


def _vector_bytes(K):
    return 4 * (K3.K3_VECTORS * (-(-K // 4) * 4) + K3.K3_RED_FLOATS)


def _expected_route(K):
    return "registers" if _tile_floats(K) <= K3.K3_REG_FLOATS else "device"


def test_each_capacity_takes_exactly_one_route():
    routes = {K: K3.k3_launch_plan(K).route for K in range(1, 301)}
    assert set(routes.values()) == set(K3.ROUTES)
    assert routes == {K: _expected_route(K) for K in routes}
    # the routes are contiguous ranges, in order
    order = [K3.ROUTES.index(routes[K]) for K in range(1, 301)]
    assert order == sorted(order)


def test_routes_hand_over_where_the_budget_and_the_cap_stop_fitting():
    last_reg = max(K for K in range(1, 301)
                   if _tile_floats(K) <= K3.K3_REG_FLOATS)
    last_vec = max(K for K in range(5000, 7000)
                   if _vector_bytes(K) <= MAX_SMEM_BYTES)
    assert (last_reg, last_vec) == (128, 5808)
    assert K3.k3_launch_plan(last_reg).route == "registers"
    assert K3.k3_launch_plan(last_reg + 1).route == "device"
    assert K3.k3_launch_plan(last_vec).work_floats == 0
    assert K3.k3_launch_plan(last_vec + 1).work_floats > 0
    assert _vector_bytes(last_vec + 1) > MAX_SMEM_BYTES


@pytest.mark.parametrize("K", [24, 48, 96, 101])
def test_main_path_capacities_take_the_registers_route(K):
    """The Homotopy tiers [24, 48, 96] and the default k_max =
    max_iterations + 1 = 101."""
    plan = K3.k3_launch_plan(K)
    assert plan.route == "registers" and plan.code == 0
    assert 32 * plan.cols >= K and 4 * plan.cols * plan.cols <= 64


@pytest.mark.parametrize("K", [1, 3, 13, 24, 32, 33, 64, 65, 96, 97, 101,
                               128, 129, 200, 236, 237, 260, 1000])
def test_plan_fits_the_card(K):
    plan = K3.k3_launch_plan(K)
    assert plan.threads == (256 if plan.route == "registers" else 512)
    # den's and p's per-warp partials have a slot for every warp
    assert plan.threads // 32 <= K3.K3_RED_FLOATS // 2
    assert 0 <= plan.smem_bytes <= MAX_SMEM_BYTES
    if plan.route == "registers":
        # a warp's rows and a lane's columns cover the capacity
        assert 8 * 4 * plan.cols >= K and 32 * plan.cols >= K
        assert _tile_floats(K) <= K3.K3_REG_FLOATS
        assert plan.smem_bytes == _vector_bytes(K)
    else:
        assert plan.cols == 0 and plan.smem_bytes == _vector_bytes(K)
    assert plan.work_floats == 0 and plan.code == K3.ROUTES.index(
        plan.route)


@pytest.mark.parametrize("K,aligned,vec", [(13, True, 1), (24, True, 4),
                                           (96, True, 4), (96, False, 1),
                                           (101, True, 1), (200, True, 4),
                                           (237, True, 1), (260, True, 4),
                                           (260, False, 1)])
def test_gk_rows_load_float4_where_they_can(K, aligned, vec):
    assert K3.k3_launch_plan(K, aligned).vec == vec


def test_no_capacity_is_refused():
    """Past the capacity where even the K-vectors leave shared memory the
    device route keeps them in a per-lane workspace."""
    last = max(K for K in range(5000, 7000)
               if _vector_bytes(K) <= MAX_SMEM_BYTES)
    plan = K3.k3_launch_plan(last)
    assert (plan.route, plan.work_floats, plan.code) == ("device", 0, 1)
    plan = K3.k3_launch_plan(last + 1)
    assert plan.route == "device" and plan.code == 2
    assert plan.smem_bytes == 0 and 4 * plan.work_floats == _vector_bytes(
        last + 1)
    with pytest.raises(ValueError, match="must be positive"):
        K3.k3_launch_plan(0)


def test_plan_states_the_source_constants():
    c = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);",
        (CSRC / "transition.cu").read_text())}
    assert c["THREADS"] == K3.K3_THREADS
    assert c["MEM_THREADS"] == K3.K3_MEM_THREADS
    assert c["REG_FLOATS"] == K3.K3_REG_FLOATS
    assert c["VECTORS"] == K3.K3_VECTORS
    assert c["RED_FLOATS"] == K3.K3_RED_FLOATS
    # no static shared memory: the plan's cap is the whole 232,448 bytes
    assert re.findall(r"(?<!extern )__shared__",
                      (CSRC / "transition.cu").read_text()) == []


@pytest.mark.parametrize("K", [3, 13, 40])
def test_cpu_tensors_take_the_twin_on_the_edge_slots(K):
    """On CPU tensors the wrapper runs the twin, counts no launch, and
    leaves every vacant slot of the edge lanes zero."""
    dispatch.reset_launches()
    arrays, tol, n = transition_edge_case(K)
    base = [torch.from_numpy(a) for a in arrays]
    work = [t.clone() for t in base]
    deg = K3.transition(*work, tol, n)
    want = K3.transition_plain(*base, tol, n)
    for got, w in zip(work[:6], want[:6]):
        assert torch.equal(got, w)
    assert torch.equal(deg, want[6]) and not bool(deg.any())
    assert not any(dispatch.launches.values())
    kk = arrays[8].astype(np.int64)
    kk1 = np.where(arrays[14], kk - 1, np.where(arrays[13], kk + 1, kk))
    assert vacant_nonzero([t.numpy() for t in work[:6]], kk1, n) == []
    assert len(arrays[8]) == len(TRANSITION_EDGES)


@pytest.mark.parametrize("mix", ["insert", "remove"])
def test_mixes_hold_one_kind_of_lane(mix):
    arrays = transition_mix(16, 24, 500, mix=mix)
    live, doins, dorm = arrays[12], arrays[13], arrays[14]
    assert live.all()
    assert (doins if mix == "insert" else dorm).all()
    assert not (dorm if mix == "insert" else doins).any()
