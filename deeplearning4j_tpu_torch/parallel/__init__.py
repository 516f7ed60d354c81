"""The port's ``parallel`` (reference ``deeplearning4j_tpu/parallel``,
rethought for SPMD ranks over ``torch.distributed``): the mesh and its
groups, ``ParallelWrapper`` (dp, fsdp, tp) and ``ParallelInference``, the
tensor-parallel layers, parameter averaging, ring attention and the
pipelines. The socket half of the reference's ``parallel`` — gradient
sharing over a transport, leases, the scale-out master and workers — is
not ported yet (ROADMAP.md queue 1)."""

from .mesh import (MeshSpec, batch_sharding, bootstrap_distributed,
                   data_parallel_mesh, hybrid_mesh_2d, make_mesh, replicated,
                   shard_params_fsdp)
from .pipeline import (make_pipeline_loss, make_pipeline_train_step,
                       place_params_for_pipeline)
from .pipeline_generic import (make_cg_pipeline_train_step,
                               make_mln_pipeline_loss,
                               make_mln_pipeline_train_step, microbatches,
                               partition_layers, shard_params_pp)
from .tp import (ChannelShardedConvolution, ColumnParallelDense,
                 ColumnParallelOutputLayer, InputChannelShardedConvolution,
                 RowParallelDense, RowShardedEmbedding,
                 RowShardedEmbeddingSequence, ShardedSelfAttention,
                 network_param_shardings)
from .ring_attention import (ring_attention, ring_attention_inner,
                             ring_attention_sharded, ring_hop)
from .param_avg import ParameterAveragingTrainer
from .wrapper import ParallelInference, ParallelWrapper

__all__ = [
    "MeshSpec", "batch_sharding", "bootstrap_distributed",
    "data_parallel_mesh", "hybrid_mesh_2d", "make_mesh", "replicated",
    "shard_params_fsdp",
    "make_pipeline_loss", "make_pipeline_train_step",
    "place_params_for_pipeline", "ring_attention", "ring_attention_inner",
    "ring_attention_sharded", "ring_hop", "ParallelInference",
    "ParallelWrapper", "ParameterAveragingTrainer",
    "ColumnParallelDense", "ColumnParallelOutputLayer", "RowParallelDense",
    "RowShardedEmbedding", "RowShardedEmbeddingSequence",
    "ChannelShardedConvolution", "InputChannelShardedConvolution",
    "ShardedSelfAttention", "network_param_shardings",
    "make_mln_pipeline_loss", "make_mln_pipeline_train_step",
    "shard_params_pp", "make_cg_pipeline_train_step",
    "microbatches", "partition_layers",
]
