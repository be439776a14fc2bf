"""sink_attention_tpu_torch: the PyTorch + CUDA port of sink_attention_tpu.

Sink flash attention (causal attention with always-attended sink tokens, a
sliding window and the gpt-oss ``s_aux`` sink logit) on hand-written CUDA
kernels for the NVIDIA H100, with the rolling sink KV cache, the gpt-oss
model, serving and single-device training around it. It imports nothing of
the JAX package; the JAX package is the reference its tests hold it to.

The kernels (``ops/csrc``, built by ``nvcc`` for ``sm_90a`` on first use):

- the forward, unpacked and packed (multi-segment): one warp-specialised
  kernel on ``wgmma`` and TMA over either mask (one producer warpgroup, two
  consumer warpgroups, a ring of K/V stages, a persistent grid of 128-row
  items);
- the decode: one launch per call, a thread block cluster per sequence and
  KV head that splits the live cache and merges in distributed shared
  memory, over bf16, int8 or fp8 storage, for any GQA group;
- dQ and dK/dV, unpacked and packed: one warp-specialised kernel each on
  ``wgmma`` and TMA over either mask (persistent grids of 128-row and
  128-key items, the GQA sum of dK/dV inside the kernel);
- the per-stage ablation kernels of ``scripts/mfu_ablation.py``: the
  forward kernel above with its softmax cut to one stage, at its 128 x 128
  tiles.

Subpackages (the JAX package's layout):

- ``ops``      -- eager oracle, differentiable prefill and packed
                  attention, decode attention (CUDA kernels, each with its
                  plain PyTorch version), the ablation kernels, the
                  packed-int4 weight matmuls (plain PyTorch)
- ``cache``    -- rolling sink KV cache (mutable; bf16, int8 or fp8 codes
                  with per-token scales) and the ragged batch cache
- ``models``   -- gpt-oss / dense model family, int8 / int4 weight
                  quantization, parameter carry-over from JAX
- ``serving``  -- greedy generation and the continuous-batching engine
- ``parallel`` -- the training step (one device so far)
- ``scripts``  -- the forward kernel's per-stage ablation; the A/B
                  timing of the attention kernels of two checkouts
- ``utils``    -- device selection, CUDA-event timing
"""

__version__ = "0.1.0"

from .cache import RaggedSinkKVCache, SinkKVCache
from .ops import (eager_sink_attention, eager_sink_attention_packed,
                  merge_partials, packed_sink_window_mask,
                  sink_decode_attention, sink_decode_attention_cached,
                  sink_decode_attention_cached_multi,
                  sink_decode_attention_ragged, sink_flash_attention,
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
    "packed_sink_window_mask",
    "sink_flash_attention_packed",
    "sink_decode_attention",
    "sink_decode_attention_cached",
    "sink_decode_attention_cached_multi",
    "sink_decode_attention_ragged",
    "SinkKVCache",
    "RaggedSinkKVCache",
]
