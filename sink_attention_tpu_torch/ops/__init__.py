"""Attention ops: the eager oracle and the CUDA-kernel-backed attention
(differentiable prefill, chunk and packed attention, decode), each kernel
with its plain PyTorch version."""

from .decode import (sink_decode_attention, sink_decode_attention_cached,
                     sink_decode_attention_cached_multi,
                     sink_decode_attention_ragged)
from .flash import (merge_partials, sink_flash_attention,
                    sink_flash_attention_chunk, sink_flash_attention_with_lse)
from .packed import sink_flash_attention_packed
from .reference import (eager_sink_attention, eager_sink_attention_packed,
                        packed_sink_window_mask, sink_window_mask)

__all__ = [
    "eager_sink_attention",
    "sink_window_mask",
    "sink_flash_attention",
    "sink_flash_attention_with_lse",
    "sink_flash_attention_chunk",
    "merge_partials",
    "eager_sink_attention_packed",
    "packed_sink_window_mask",
    "sink_flash_attention_packed",
    "sink_decode_attention",
    "sink_decode_attention_cached",
    "sink_decode_attention_cached_multi",
    "sink_decode_attention_ragged",
]
