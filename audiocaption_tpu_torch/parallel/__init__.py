"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``audiocaption_tpu/parallel/``)."""

from audiocaption_tpu_torch.parallel.mesh import (
    ParallelContext, data_parallel_context, init_distributed, pad_to_world,
    replicate, shard_batch, sync_batch_norm)
from audiocaption_tpu_torch.parallel.tp import (
    DEFAULT_TP_RULES, TensorParallelContext, full_state_dict, make_tp_groups,
    shard_params)
