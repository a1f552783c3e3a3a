"""The device mesh over torch.distributed (``buddy_tpu/parallel``)."""

from buddy_tpu_torch.parallel.mesh import (batch_sharding, init_distributed, make_mesh,
                                           replicated_sharding, shard_params,
                                           shard_waveform_batch, waveform_sharding)

__all__ = ["init_distributed", "make_mesh", "batch_sharding", "replicated_sharding",
           "shard_params", "waveform_sharding", "shard_waveform_batch"]
