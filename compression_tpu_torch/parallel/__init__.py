"""Multi-device and multi-process parallelism (sharded coding, data- and
tensor-parallel training) on torch.distributed; PyTorch counterpart of
compression_tpu/parallel."""

from compression_tpu_torch.parallel.pipeline import BatchCodec, SidecarBatchCodec
from compression_tpu_torch.parallel.sharding import (
    data_parallel_train_step,
    make_mesh,
    replicate,
    shard_batch,
    sharded_encode,
)
