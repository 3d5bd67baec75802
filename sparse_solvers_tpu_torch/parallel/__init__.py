"""Multi-device layer: the mesh, the sharded routes and the process-group
wiring (``distributed``) — the port of ``sparse_solvers_tpu/parallel``.
The façades' ``mesh=`` argument (api.py) is the construct-once object form
over these functional routes."""

from .sharding import (  # noqa: F401
    DATA_AXIS,
    ROW_AXIS,
    Mesh,
    cosamp_sharded,
    gram_replicated,
    homotopy_sharded,
    irls_cg_sharded,
    irls_sharded,
    irls_sharded_from_a,
    make_mesh,
    omp_sharded,
    qr_sharded,
    shard_inputs,
    update_column_sharded,
)
