"""Multi-GPU: process groups and the data-parallel batch (``mesh``), tiled
and spatially sharded inference (``spatial``), tensor and expert
parallelism under JAX's placement rules, for every model (``tensor``); counterpart:
``irdu_tpu/parallel``. JAX's ``batch_sharding`` and ``replicated_sharding``
(``NamedSharding``s) have no torch object: ``shard_batch`` takes this
rank's slice and ``broadcast_params`` replicates rank 0's parameters."""

from irdu_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast_params,
    init_distributed,
    make_mesh,
    shard_batch,
)
from irdu_tpu_torch.parallel.spatial import (
    halo_shard_forward,
    sharded_tiled_forward,
    tiled_forward,
)
from irdu_tpu_torch.parallel.tensor import (
    check_tp_divisibility,
    gather_train_state,
    make_dp_tp_mesh,
    param_shardings,
    shard_train_state,
    spec_for_param,
    train_state_shardings,
)
