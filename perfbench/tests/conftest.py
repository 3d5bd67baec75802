"""The benchmark's CPU tests: the checkout's root on the import path, so
that ``perfbench`` and ``sparse_solvers_tpu_torch`` import as a run
imports them. Collected only when ``perfbench/tests`` is named; the
repo's own ``tests/`` never imports JAX here."""

import sys
from pathlib import Path

ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
