"""Training and sequence parallelism: the loss, the packed-batch loss and
the step on one device; sequence-parallel attention (halo SP, Ulysses,
ring, the dispatcher) over a ``torch.distributed`` process group."""

from .ring import (ring_num_steps, ring_sink_flash_attention,
                   sharded_sink_flash_attention)
from .sp import (broadcast_sink_kv, local_position_offset, reduce_sink_grads,
                 sp_sink_flash_attention)
from .train import (cross_entropy_loss, cross_entropy_loss_packed,
                    make_train_step, param_leaves)
from .ulysses import (slice_s_aux_for_rank, ulysses_sink_flash_attention,
                      ulysses_sink_flash_attention_packed)

__all__ = [
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
    "cross_entropy_loss",
    "cross_entropy_loss_packed",
    "make_train_step",
    "param_leaves",
]
