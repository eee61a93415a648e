"""Multi-device scaling on ``torch.distributed``; the counterpart of
``tpu_gpad.parallel``. Scenario batches shard over a mesh of ranks, one
per card (data parallelism); very large single instances can additionally
shard the dual constraint dimension m (tensor parallelism) with one
all-reduce per iteration. Communication is NCCL's collectives over NVLink
or PCIe between cards (gloo's on the CPU): there is no custom comm layer
to build."""

from tpu_gpad_torch.parallel.distrib import (
    make_mesh,
    data_specs,
    pad_dual_rows,
    solve_batch_sharded,
    solve_multi_sharded,
    solve_stagewise_multi_sharded,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "data_specs",
    "pad_dual_rows",
    "solve_batch_sharded",
    "solve_multi_sharded",
    "shard_batch",
]
