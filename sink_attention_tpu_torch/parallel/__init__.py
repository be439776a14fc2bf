"""Parallelism over ``torch.distributed``: a named device mesh
(``mesh``), tensor parallelism (``tp``), pipeline parallelism (``pp``),
the loss and the training step on one device or over a mesh with DP, SP,
TP/EP and FSDP (``train``), and sequence-parallel attention (halo SP,
Ulysses, ring, the dispatcher)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, NamedSharding,
                   PartitionSpec, device_put, gather_tree, make_mesh,
                   make_multihost_mesh, replicated, shard)
from .pp import (make_pp_train_step, pipeline_forward,
                 pipeline_param_shardings, stack_pipeline_params,
                 unstack_pipeline_params)
from .ring import (ring_num_steps, ring_sink_flash_attention,
                   sharded_sink_flash_attention)
from .sp import (broadcast_sink_kv, local_position_offset, reduce_sink_grads,
                 sp_sink_flash_attention)
from .tp import (tp_decoder_layer, tp_local_config, tp_region_in,
                 tp_region_out)
from .train import (cross_entropy_loss, cross_entropy_loss_packed,
                    make_sharded_attn, make_train_step, param_leaves,
                    param_shardings)
from .ulysses import (slice_s_aux_for_rank, ulysses_sink_flash_attention,
                      ulysses_sink_flash_attention_packed)

__all__ = [
    "make_mesh",
    "make_multihost_mesh",
    "replicated",
    "shard",
    "DATA_AXIS",
    "SEQ_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "device_put",
    "gather_tree",
    "broadcast_sink_kv",
    "reduce_sink_grads",
    "local_position_offset",
    "sp_sink_flash_attention",
    "ulysses_sink_flash_attention",
    "ulysses_sink_flash_attention_packed",
    "slice_s_aux_for_rank",
    "ring_sink_flash_attention",
    "ring_num_steps",
    "sharded_sink_flash_attention",
    "stack_pipeline_params",
    "unstack_pipeline_params",
    "pipeline_forward",
    "make_pp_train_step",
    "pipeline_param_shardings",
    "tp_region_in",
    "tp_region_out",
    "tp_local_config",
    "tp_decoder_layer",
    "param_shardings",
    "make_sharded_attn",
    "cross_entropy_loss",
    "cross_entropy_loss_packed",
    "make_train_step",
    "param_leaves",
]
