"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``), case for case, at the arguments the CI runs them with.

Each JAX example runs in a subprocess on the CPU (``SS_EXAMPLE_CPU=1``)
and its printed numbers are parsed; the port's example runs in this
process through its ``main(argv)``, which returns the numbers it prints.
Both sides run with ``SS_NATIVE_DISABLE=1``: at these sizes ``"auto"``
would send the JAX side to its host engine, whose build (``make -C
csrc``) races between test workers, and the port's CPU façade to its
own. The problems are drawn from the same seeds in the same order, so
both sides solve the same inputs.

Contract: supports recovered, failed certificates, the probe's column,
atoms identified, spd failures and the lasso path's supports are equal;
mean iterations or rounds are equal for Homotopy, OMP, gOMP and IRLS;
CG-IRLS mean outer iterations may differ by at most 1.0 (its relative
change can cross the tolerance one step apart from JAX's) with ``max |x
− x_true|`` ≤ 1e-3 on both; λ on the lasso path agrees to a relative
1e-4, beside the resolution of JAX's printed λ (5e-6).
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip(
    "torch", reason="the port's tests need torch (pip install .[torch])")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_TIMEOUT_S = 180
# the arguments of .github/workflows/ci.yml's "Examples" step
CI_ARGS = {"batch_recovery": ["64", "128", "4", "8"],
           "irls_recovery": ["128", "64", "8"],
           "serving_loop": [],
           "basis_pursuit": ["96", "768", "6", "16"],
           "greedy_pursuit": ["96", "384", "6", "16"],
           "lasso_path": ["64", "128", "4"]}
# the printed λ's resolution (lasso_path.py prints it to 5 decimals)
LAMBDA_PRINT_ATOL = 5e-6


def run_jax_example(name, args):
    """The JAX example's standard output, run on the CPU with the host
    engine disabled."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_ENABLE_X64")}
    env.update(SS_EXAMPLE_CPU="1", JAX_PLATFORMS="cpu",
               SS_NATIVE_DISABLE="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def load_port_example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_port_example(monkeypatch, name, args, native=False):
    """The port's example's ``main(args)`` on the CPU façade; with
    ``native=False`` the host engine is disabled."""
    monkeypatch.setenv("SS_EXAMPLE_CPU", "1")
    if native:
        monkeypatch.delenv("SS_NATIVE_DISABLE", raising=False)
    else:
        monkeypatch.setenv("SS_NATIVE_DISABLE", "1")
    return load_port_example(name).main(args)


def grab(pattern, text):
    match = re.search(pattern, text)
    assert match, f"no line matching {pattern!r} in:\n{text}"
    return match.groups()


def pct(count, total):
    """A count as the JAX examples print its share: a whole percent."""
    return f"{100 * count / total:.0f}"


def one_decimal(value):
    return f"{value:.1f}"


def check_batch_recovery(jax_out, port):
    mean, share = grab(r"mean path length ([\d.]+); exact support "
                       r"recovery on (\d+)% of signals", jax_out)
    assert one_decimal(port["mean_iterations"]) == mean
    assert pct(port["support_recovered"], port["batch"]) == share
    assert port["support_recovered"] == port["batch"]
    (single_iter,) = grab(r"single solve: iter=(\d+)", jax_out)
    assert port["single_iter"] == int(single_iter)


def check_irls_recovery(jax_out, port):
    mean, share, spd, total = grab(
        r"mean iterations ([\d.]+); atom identified on (\d+)% of signals; "
        r"spd failures (\d+)/(\d+)", jax_out)
    assert one_decimal(port["mean_iterations"]) == mean
    assert pct(port["atoms_identified"], port["batch"]) == share
    assert (port["spd_failures"], port["batch"]) == (int(spd), int(total))


def check_serving_loop(jax_out, port):
    failed, total = grab(r"(\d+)/(\d+) lanes failed certification",
                         jax_out)
    assert (port["failed"], port["total"]) == (int(failed), int(total))
    assert port["failed"] == 0
    (column,) = grab(r"recovers column (\d+)", jax_out)
    assert port["probe_column"] == int(column) == 7


def check_basis_pursuit(jax_out, port):
    exact, batch, err, mean = grab(
        r"support recovered (\d+)/(\d+), max \|x - x_true\| = ([\d.e+-]+), "
        r"mean outer iterations ([\d.]+)", jax_out)
    assert (port["support_recovered"], port["batch"]) == (int(exact),
                                                          int(batch))
    assert abs(port["mean_outer_iterations"] - float(mean)) <= 1.0
    assert port["max_abs_err"] <= 1e-3 and float(err) <= 1e-3


def check_greedy_pursuit(jax_out, port):
    for name in ("omp", "homotopy"):
        exact, batch, mean = grab(
            rf"  {name}: support (\d+)/(\d+), mean iters ([\d.]+)", jax_out)
        assert port[name]["support_recovered"] == int(exact) == int(batch)
        assert one_decimal(port[name]["mean_iterations"]) == mean
    exact, batch, rounds = grab(
        r"gomp\(picks=4\): support (\d+)/(\d+), mean rounds ([\d.]+)",
        jax_out)
    assert port["gomp"]["support_recovered"] == int(exact) == int(batch)
    assert one_decimal(port["gomp"]["mean_rounds"]) == rounds


def check_lasso_path(jax_out, port):
    rows = re.findall(r"λ=([\d.]+)  support=\[([\d, ]*)\]", jax_out)
    assert len(rows) == port["breakpoints"] > 1
    jax_supports = [[int(i) for i in s.split(",") if i.strip()]
                    for _, s in rows]
    assert port["supports"] == jax_supports
    np.testing.assert_allclose(port["lambdas"], [float(v) for v, _ in rows],
                               rtol=1e-4, atol=LAMBDA_PRINT_ATOL)
    (recovered,) = grab(r"\(recovered: (True|False)\)", jax_out)
    assert port["recovered"] is (recovered == "True") is True


CHECKS = {"batch_recovery": check_batch_recovery,
          "irls_recovery": check_irls_recovery,
          "serving_loop": check_serving_loop,
          "basis_pursuit": check_basis_pursuit,
          "greedy_pursuit": check_greedy_pursuit,
          "lasso_path": check_lasso_path}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_example_matches_the_jax_example(monkeypatch, name):
    args = CI_ARGS[name]
    jax_out = run_jax_example(name, args)
    port = run_port_example(monkeypatch, name, args)
    CHECKS[name](jax_out, port)
    # with the host engine disabled every route is the torch one
    assert set(port["engines"]) == {"torch"}


def test_greedy_pursuit_through_the_host_engine(monkeypatch):
    """Without ``SS_NATIVE_DISABLE`` a CPU façade's ``"auto"`` takes the
    port's own host engine at m·n ≤ 2¹⁶, as the JAX package's does; the
    gOMP line pins ``engine="jax"``, the torch route."""
    port = run_port_example(monkeypatch, "greedy_pursuit", CI_ARGS[
        "greedy_pursuit"], native=True)
    assert port["omp"]["engine"] == port["homotopy"]["engine"] == "native"
    assert port["gomp"]["engine"] == "torch"
    for name in ("omp", "homotopy", "gomp"):
        assert port[name]["support_recovered"] == port["batch"] == 16
    assert port["omp"]["mean_iterations"] == port["k"] == 6


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_example_runs_on_the_card_by_default(monkeypatch, name):
    """Without ``SS_EXAMPLE_CPU`` an example asks for the card; where torch
    sees none that is the façade's error, naming ``device='cpu'``."""
    monkeypatch.delenv("SS_EXAMPLE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        load_port_example(name).main(CI_ARGS[name])
