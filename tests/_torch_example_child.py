"""One rank of ``examples_torch/sharded_recovery.py`` under
``torch.distributed.run``: runs the example's ``main()`` and, on rank 0,
writes the numbers it returns as JSON to the path given.

    python -m torch.distributed.run --standalone --nproc-per-node=4 \\
        tests/_torch_example_child.py OUT.json
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))

import sharded_recovery  # noqa: E402
from sparse_solvers_tpu_torch.parallel import distributed  # noqa: E402


def main() -> int:
    out = sharded_recovery.main()
    if distributed.process_index() == 0:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
