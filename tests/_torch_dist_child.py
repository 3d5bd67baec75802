"""Child program of the port's multi-process mesh tests, the counterpart of
``tests/_dist_child.py``. It imports torch, numpy and the port, never jax.

    python tests/_torch_dist_child.py RANK WORLD INIT_FILE OUT_DIR SPEC...

Each of WORLD processes joins one gloo group through the port's own
``parallel.distributed.initialize`` (a FileStore at INIT_FILE, so parallel
test workers never share a port), then runs the named cases: a SPEC is
``"RxD:case"``, the case of ``_torch_mesh_cases.CASES`` on a mesh of R row
ranks and D data ranks (R·D = WORLD; each distinct mesh is made once, in
the order the specs first name it, on every rank alike). Every case writes
this rank's results to ``OUT_DIR/<R>x<D>__<case>.<RANK>.npz``: its arrays,
the collectives it issued (``ops/collectives.counts``) and, per loop trip
of the batch drivers and per CG matvec, the collectives issued inside it.
A case that raises writes its error instead, and the next case runs.

Exit code 0 plus a last "TORCH_DIST_CHILD_OK" line is the success
contract. The gloo group's timeout bounds every collective, so a hang
fails its case instead of running out the caller's clock.
"""

import os
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import _torch_mesh_cases as cases  # noqa: E402
from sparse_solvers_tpu_torch.ops import collectives  # noqa: E402
from sparse_solvers_tpu_torch.parallel import distributed  # noqa: E402
from sparse_solvers_tpu_torch.parallel import sharding  # noqa: E402

GLOO_TIMEOUT_S = 30


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, out_dir, specs = sys.argv[3], sys.argv[4], sys.argv[5:]
    assert distributed.initialize(init_method=f"file://{init_file}",
                                  world_size=world, rank=rank,
                                  backend="gloo", timeout=GLOO_TIMEOUT_S)
    meshes = {}
    for spec in specs:
        shape = spec.split(":")[0]
        if shape not in meshes:
            n_row, n_data = map(int, shape.split("x"))
            meshes[shape] = sharding.make_mesh(n_row, n_data, device="cpu")
    cases.instrument()
    for spec in specs:
        shape, name = spec.split(":")
        mesh = meshes[shape]
        cases.reset_records()
        collectives.reset_counts()
        try:
            out = cases.CASES[name](mesh)
            out.update(cases.records())
            out.update({f"count_{k}": np.int64(v)
                        for k, v in collectives.counts.items()})
            out.update(rank=np.int64(rank), data_index=np.int64(
                mesh.data_index), n_data=np.int64(mesh.shape["data"]))
        except Exception:  # one case's failure is its own
            out = {"error": np.array(traceback.format_exc())}
        np.savez(os.path.join(out_dir, f"{shape}__{name}.{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    print("TORCH_DIST_CHILD_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
