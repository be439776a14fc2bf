"""sink_attention_tpu_torch: the PyTorch + CUDA port of sink_attention_tpu.

Sink flash attention (causal attention with always-attended sink tokens, a
sliding window and the gpt-oss ``s_aux`` sink logit) on hand-written CUDA
kernels for the NVIDIA H100 (forward, dQ and dK/dV, their packed
multi-segment counterparts, decode), with the rolling sink KV cache, the
gpt-oss model, greedy serving and single-device training, packed batches
included, around it. It imports nothing of the JAX package;
the JAX package is the reference its tests hold it to.

Subpackages (the JAX package's layout):

- ``ops``      -- eager oracle, differentiable prefill and packed
                  attention, decode attention (CUDA kernels, each with its
                  plain PyTorch version)
- ``cache``    -- rolling sink KV cache (mutable)
- ``models``   -- gpt-oss / dense model family, parameter carry-over from
                  JAX
- ``serving``  -- greedy generation
- ``parallel`` -- the training step (one device so far)
- ``utils``    -- device selection, CUDA-event timing
"""

__version__ = "0.1.0"

from .cache import SinkKVCache
from .ops import (eager_sink_attention, eager_sink_attention_packed,
                  merge_partials, sink_decode_attention,
                  sink_decode_attention_cached, sink_flash_attention,
                  sink_flash_attention_chunk, sink_flash_attention_packed,
                  sink_flash_attention_with_lse, sink_window_mask)

__all__ = [
    "__version__",
    "eager_sink_attention",
    "sink_window_mask",
    "sink_flash_attention",
    "sink_flash_attention_with_lse",
    "sink_flash_attention_chunk",
    "merge_partials",
    "eager_sink_attention_packed",
    "sink_flash_attention_packed",
    "sink_decode_attention",
    "sink_decode_attention_cached",
    "SinkKVCache",
]
