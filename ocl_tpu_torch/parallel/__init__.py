"""Distribution layer on torch.distributed (counterpart of ocl_tpu/parallel/).

ocl_tpu shards its XLA programs over a `jax.sharding.Mesh`; the port runs one
process a device of the mesh (`mesh.launch`) and keeps the SPMD program's
semantics by hand: the evaluation fan-out over test rows and NCM exemplars,
a slot-sharded memory bank (`sharded_buffer.py`), and a data-parallel train
step whose BatchNorm statistics and loss are those of the global batch and
whose gradients are summed over the ranks (`dp.py`). Stacked runs and tune
points are dealt to the ranks by experiment/parallel_run.py and
parallel_tune.py.
"""

from ocl_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    current,
    gather_batch,
    get_mesh,
    init,
    launch,
    shard_batch,
    shutdown,
)
