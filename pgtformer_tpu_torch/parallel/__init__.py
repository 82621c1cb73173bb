"""Several devices over ``torch.distributed``, one process per device (the
port's counterpart of the JAX package's ``parallel/``); see ``group.py``."""

from pgtformer_tpu_torch.parallel.group import (  # noqa: F401
    Group, all_reduce_, barrier, broadcast_, broadcast_tensors_, destroy_group, gather_rows,
    init_group, masked_sum, mean_tensors_, ring_shift, scatter_rows, shard_rows, spawn,
    sync_sum)
