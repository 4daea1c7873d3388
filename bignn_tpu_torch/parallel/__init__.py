"""The parallel paths (counterpart of ``bignn_tpu/parallel``): one process
driving every shard of a mesh that may name one card several times or lie
over distinct cards, or, for p2, several processes, each on one card
(several may share it) or on several cards of its own:

  * ``mesh.py``      the ``(dp, graph)`` and ``(dp, tp)`` device meshes;
                     the process group (``init_distributed``), the hybrid
                     mesh over the processes and ``global_put``;
  * ``dp.py``        data parallelism: the pair batch split over ``dp``,
                     the replicated encode run once a card, the shards'
                     loss sums added in shard order;
  * ``replicas.py``  the model and optimizer replicated over the cards of
                     one process, the gradients added in slot order;
  * ``tp.py``        feature sharding over ``tp``: Megatron-paired MLPs
                     and column-parallel conv projections, run shard by
                     shard;
  * ``partition.py`` the outer-graph edge partition and the sharded inner
                     unions (NumPy);
  * ``halo.py``      the halo exchange and the distributed outer layers, one
                     ``ops.all_to_all`` a layer;
  * ``comm.py``      the data plane between processes or cards
                     (``make_exchange``) and the replicated state across
                     them: the embedding all-gather and the rank-order
                     gradient sum;
  * ``step.py``      the p2 train step and scorer.

dp and tp run in one process, on one card or several; p2 runs in one
process or across processes.
"""

from bignn_tpu_torch.parallel.comm import (
    CardExchange,
    gather_rows,
    gather_rows_cards,
    make_exchange,
)
from bignn_tpu_torch.parallel.dp import (
    dp_train_step_fn,
    make_replicated_dp_step,
    shard_pairs,
)
from bignn_tpu_torch.parallel.halo import (
    dist_outer_forward,
    halo_exchange,
    p2_overlap_forward,
)
from bignn_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    global_put,
    host_names,
    init_distributed,
    local_device,
    local_devices,
    make_hybrid_mesh,
    make_mesh,
    process_count,
    process_index,
    resolve_distributed,
    shard_device,
    spread_devices,
)
from bignn_tpu_torch.parallel.partition import (
    OuterPartitionPlan,
    boundary_drugs,
    build_outer_partition,
    build_sharded_inner,
)
from bignn_tpu_torch.parallel.replicas import Replicas
from bignn_tpu_torch.parallel.step import (
    device_put_plan,
    make_cards_train_step,
    make_p2_score_fn,
    make_p2_train_step,
)
from bignn_tpu_torch.parallel.tp import (
    gather_params_tp,
    shard_params_tp,
    tp_param_specs,
    tp_train_step_fn,
)

__all__ = [
    "CardExchange",
    "Mesh",
    "OuterPartitionPlan",
    "Replicas",
    "barrier",
    "boundary_drugs",
    "build_outer_partition",
    "build_sharded_inner",
    "device_put_plan",
    "dist_outer_forward",
    "dp_train_step_fn",
    "gather_params_tp",
    "gather_rows",
    "gather_rows_cards",
    "global_put",
    "halo_exchange",
    "host_names",
    "init_distributed",
    "local_device",
    "local_devices",
    "make_exchange",
    "make_hybrid_mesh",
    "make_cards_train_step",
    "make_mesh",
    "make_p2_score_fn",
    "make_p2_train_step",
    "make_replicated_dp_step",
    "p2_overlap_forward",
    "process_count",
    "process_index",
    "resolve_distributed",
    "shard_device",
    "shard_pairs",
    "shard_params_tp",
    "spread_devices",
    "tp_param_specs",
    "tp_train_step_fn",
]
