"""The edge-partitioned ("p2") path (counterpart of ``bignn_tpu/parallel``):

  * ``mesh.py``      the ``(dp, graph)`` device mesh;
  * ``partition.py`` the outer-graph edge partition and the sharded inner
                     unions (NumPy);
  * ``halo.py``      the halo exchange and the distributed outer layers, one
                     ``ops.all_to_all`` a layer;
  * ``step.py``      the p2 train step and scorer.

Data parallelism (``dp.py``), feature sharding (``tp.py``), the trainers'
``mesh`` arguments and shards on distinct cards are still to port (ROADMAP
Queue 1 item 5).
"""

from bignn_tpu_torch.parallel.halo import (
    dist_outer_forward,
    halo_exchange,
    p2_overlap_forward,
)
from bignn_tpu_torch.parallel.mesh import (
    Mesh,
    global_put,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
)
from bignn_tpu_torch.parallel.partition import (
    OuterPartitionPlan,
    boundary_drugs,
    build_outer_partition,
    build_sharded_inner,
)
from bignn_tpu_torch.parallel.step import (
    device_put_plan,
    make_p2_score_fn,
    make_p2_train_step,
)

__all__ = [
    "Mesh",
    "OuterPartitionPlan",
    "boundary_drugs",
    "build_outer_partition",
    "build_sharded_inner",
    "device_put_plan",
    "dist_outer_forward",
    "global_put",
    "halo_exchange",
    "init_distributed",
    "make_hybrid_mesh",
    "make_mesh",
    "make_p2_score_fn",
    "make_p2_train_step",
    "p2_overlap_forward",
]
