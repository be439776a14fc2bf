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
                  quantization, parameter carry-over from JAX, the HF
                  checkpoint loader (MXFP4 experts, ``from_hf_config``)
- ``serving``  -- greedy, beam and speculative generation, the
                  continuous-batching engine (with ``save_state`` /
                  ``load_state``), tensor-sharded generation
- ``parallel`` -- over ``torch.distributed``: a named device mesh,
                  tensor and pipeline parallelism, the training step on
                  one device or over a mesh (DP, SP, TP/EP, FSDP),
                  sequence-parallel attention (halo SP, Ulysses, ring and
                  the dispatcher)
- ``scripts``  -- the forward kernel's per-stage ablation; the A/B
                  timing of the attention kernels of two checkouts; the
                  golden logits criterion and its random HF checkpoint
- ``utils``    -- device selection, CUDA-event timing, checkpointing, the
                  safetensors format
- ``compat``   -- the reference API's names: the mutable caches, the SP
                  wrapper and utilities, ``subprocess_generate``
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
from .parallel import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, broadcast_sink_kv,
                       local_position_offset, make_mesh, make_multihost_mesh,
                       make_pp_train_step, pipeline_forward,
                       pipeline_param_shardings, reduce_sink_grads,
                       replicated, ring_sink_flash_attention, shard,
                       sp_sink_flash_attention, stack_pipeline_params,
                       ulysses_sink_flash_attention, unstack_pipeline_params)
from .serving import make_sharded_generate
from .compat import (SinkAttentionCache, SinkAttentionSPWrapper,
                     SinkCacheLayer, get_local_position_offset,
                     prepare_sink_kv_for_sp, reduce_sink_kv_grads,
                     subprocess_generate)

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
    "broadcast_sink_kv",
    "reduce_sink_grads",
    "local_position_offset",
    "sp_sink_flash_attention",
    "ulysses_sink_flash_attention",
    "ring_sink_flash_attention",
    "SinkCacheLayer",
    "SinkAttentionCache",
    "SinkAttentionSPWrapper",
    "prepare_sink_kv_for_sp",
    "reduce_sink_kv_grads",
    "get_local_position_offset",
    "subprocess_generate",
    "make_mesh",
    "make_multihost_mesh",
    "replicated",
    "shard",
    "DATA_AXIS",
    "SEQ_AXIS",
    "MODEL_AXIS",
    "stack_pipeline_params",
    "unstack_pipeline_params",
    "pipeline_forward",
    "make_pp_train_step",
    "pipeline_param_shardings",
    "make_sharded_generate",
]
