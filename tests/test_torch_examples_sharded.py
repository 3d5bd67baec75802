"""The port's ``examples_torch/sharded_recovery.py`` against the JAX
package's ``examples/sharded_recovery.py``, on the CPU.

The JAX example runs on 4 virtual CPU devices (``SS_SHARDED_DEMO_CPU=1``,
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), which gives it a
4×1 mesh, and its printed numbers are parsed; the port's runs as 4 gloo
processes under ``torch.distributed.run --standalone`` (the same 4×1
mesh), rank 0 writing the numbers its ``main()`` returns
(``_torch_example_child.py``). Both solve the same seeded problems.

Contract: the mean path lengths of the per-lane solve and of the
gram-free driver, the support recovery, the IRLS mean iterations and the
CG-IRLS support recovery are equal, every "matches" flag is True on both
sides, and the CG-IRLS mean outer iterations differ by at most 1.0 (its
relative change can cross the tolerance one step apart from JAX's).
"""

import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
JAX_TIMEOUT_S = 180
PORT_TIMEOUT_S = 300


def run(cmd, env, timeout):
    """``cmd`` in its own session, the whole session killed if it
    overruns ``timeout`` (torchrun's workers included)."""
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def jax_out():
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env.update(SS_SHARDED_DEMO_CPU="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={RANKS}")
    return run([sys.executable, str(ROOT / "examples" /
                                    "sharded_recovery.py")],
               env, JAX_TIMEOUT_S)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded") / "out.json"
    env = dict(os.environ, SS_SHARDED_DEMO_CPU="1")
    run([sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={RANKS}",
         str(ROOT / "tests" / "_torch_example_child.py"), str(path)],
        env, PORT_TIMEOUT_S)
    return json.loads(path.read_text())


def grab(pattern, text):
    match = re.search(pattern, text)
    assert match, f"no line matching {pattern!r} in:\n{text}"
    return match.groups()


def test_mesh_shape(jax_out, port):
    row, data = grab(r"mesh: (\d+) row-shards x (\d+) data-shards", jax_out)
    assert port["mesh"] == {"row": int(row), "data": int(data)} \
        == {"row": RANKS, "data": 1}
    assert port["world"] == RANKS and port["backend"] == "gloo"


def test_homotopy_paths_and_recovery(jax_out, port):
    mean, share = grab(r"mean path length ([\d.]+); support recovery "
                       r"(\d+)%", jax_out)
    assert f"{port['mean_path_length']:.1f}" == mean
    assert f"{100 * port['support_recovered'] / port['batch']:.0f}" \
        == share == "100"
    (driver,) = grab(r"driver \(gram-free\): mean path length ([\d.]+)",
                     jax_out)
    assert f"{port['driver_mean_path_length']:.1f}" == driver


def test_every_matches_flag_is_true(jax_out, port):
    flags = re.findall(r"matches [^:]*: (True|False)", jax_out)
    assert flags == ["True"] * 3
    assert port["matches"] == {"driver": True, "ring": True,
                               "facade": True}


def test_irls_and_cg_irls(jax_out, port):
    (irls,) = grab(r"mesh facade Irls .*: mean iters ([\d.]+)", jax_out)
    assert f"{port['irls_mean_iterations']:.1f}" == irls
    outer, share = grab(r"CG-IRLS .*: mean outer iterations ([\d.]+); "
                        r"support recovery (\d+)%", jax_out)
    assert abs(port["cg_mean_outer_iterations"] - float(outer)) <= 1.0
    assert f"{100 * port['cg_support_recovered'] / port['batch']:.0f}" \
        == share
