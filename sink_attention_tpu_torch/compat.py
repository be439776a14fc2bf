"""The reference API's names, over the port.

Counterpart of ``sink_attention_tpu/compat.py``: the reference package
exports 12 names; these are the ones with a counterpart here.

| reference name            | here                                         |
|---------------------------|----------------------------------------------|
| sink_flash_attention      | ops.sink_flash_attention (same signature)    |
| sink_decode_attention     | ops.sink_decode_attention (same signature)   |
| SinkCacheLayer            | compat.SinkCacheLayer (the reference's       |
|                           | update/get_kv/reorder calls over the port's  |
|                           | SinkKVCache)                                 |
| SinkAttentionCache        | compat.SinkAttentionCache (multi-layer)      |
| prepare_sink_kv_for_sp    | parallel.broadcast_sink_kv                   |
| reduce_sink_kv_grads      | parallel.reduce_sink_grads                   |
| get_local_position_offset | parallel.local_position_offset               |
| SinkAttentionSPWrapper    | compat.SinkAttentionSPWrapper                |
| subprocess_generate       | serving.subprocess_eval.subprocess_generate  |

The SP names take a ``torch.distributed`` process group (``group=None``:
the world group), as the reference's do. ``SinkAttentionCache`` matches the
reference cache's behaviour (update, get_kv, get_seq_length, reorder), not
its ``transformers.Cache`` type. The reference's verl and generation
patches have no counterpart: the model layer is owned
(``models.forward_prefill`` runs the kernels), and generation is
``serving.greedy_generate``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .cache import SinkKVCache
from .ops import sink_decode_attention, sink_flash_attention  # re-export
from .parallel import (
    broadcast_sink_kv as prepare_sink_kv_for_sp,  # noqa: F401
    local_position_offset as get_local_position_offset,  # noqa: F401
    reduce_sink_grads as reduce_sink_kv_grads,  # noqa: F401
    sp_sink_flash_attention,
)

__all__ = [
    "sink_flash_attention",
    "sink_decode_attention",
    "SinkCacheLayer",
    "SinkAttentionCache",
    "prepare_sink_kv_for_sp",
    "reduce_sink_kv_grads",
    "get_local_position_offset",
    "SinkAttentionSPWrapper",
    "subprocess_generate",
]


class SinkCacheLayer:
    """The reference's per-layer cache calls over ``SinkKVCache``.

    ``update`` stores the new K/V and returns the K/V to attend: a prefill
    (the first call) returns its full input (the prefill kernel masks), a
    decode step the chronological [sink | window] K/V. The cache is made on
    the first call, on the keys' device and in their dtype.
    """

    def __init__(self, num_sink: int, window_size: int,
                 quant: Optional[str] = None):
        self.num_sink = num_sink
        self.window_size = window_size
        self.quant = quant
        self._cache: Optional[SinkKVCache] = None

    @property
    def is_initialized(self) -> bool:
        return self._cache is not None

    def update(self, key_states, value_states, cache_kwargs=None):
        if self._cache is None:
            B, H_kv, _, D = key_states.shape
            self._cache = SinkKVCache.init(
                B, H_kv, D, num_sink=self.num_sink,
                window_size=self.window_size, dtype=key_states.dtype,
                quant=self.quant, device=key_states.device)
        if self._cache.seen == 0:
            self._cache.prefill(key_states, value_states)
            return key_states, value_states
        if key_states.shape[2] == 1:
            self._cache.append(key_states, value_states)
        else:   # multi-token decode (speculative)
            self._cache.append_many(key_states, value_states)
        return self.get_kv()

    def get_kv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._cache.linearized_kv()

    def get_seq_length(self) -> int:
        return 0 if self._cache is None else self._cache.get_seq_length()

    def get_mask_sizes(self, cache_position=None) -> Tuple[int, int]:
        return self.get_seq_length(), 0

    def get_max_cache_shape(self) -> int:
        return self.num_sink + self.window_size

    @property
    def seen_tokens(self) -> int:
        return 0 if self._cache is None else self._cache.seen

    def reorder_cache(self, beam_idx):
        if self._cache is not None:
            self._cache.reorder(torch.as_tensor(beam_idx))

    @property
    def functional(self) -> Optional[SinkKVCache]:
        """The ``SinkKVCache`` underneath (None before the first update)."""
        return self._cache


class SinkAttentionCache:
    """Multi-layer cache: one :class:`SinkCacheLayer` per layer index."""

    def __init__(self, num_sink: int = 4, window_size: int = 4096,
                 quant: Optional[str] = None):
        self.num_sink = num_sink
        self.window_size = window_size
        self.quant = quant
        self.layers: List[SinkCacheLayer] = []

    def __len__(self):
        return len(self.layers)

    def __getitem__(self, idx):
        return self.layers[idx]

    def __repr__(self):
        return (f"SinkAttentionCache(num_sink={self.num_sink}, "
                f"window_size={self.window_size}, layers={len(self.layers)}, "
                f"seen_tokens={self.seen_tokens})")

    def update(self, key_states, value_states, layer_idx: int,
               cache_kwargs=None):
        while len(self.layers) <= layer_idx:
            self.layers.append(SinkCacheLayer(
                self.num_sink, self.window_size, self.quant))
        return self.layers[layer_idx].update(key_states, value_states,
                                             cache_kwargs)

    def get_seq_length(self, layer_idx: int = 0) -> int:
        if layer_idx < len(self.layers):
            return self.layers[layer_idx].get_seq_length()
        return 0

    def get_max_cache_length(self) -> int:
        return self.num_sink + self.window_size

    def reorder_cache(self, beam_idx):
        for layer in self.layers:
            layer.reorder_cache(beam_idx)

    @property
    def seen_tokens(self) -> int:
        return self.layers[0].seen_tokens if self.layers else 0


class SinkAttentionSPWrapper:
    """SP attention as a callable: the exact halo SP of
    ``parallel.sp_sink_flash_attention`` over ``group``. Unlike the
    reference's wrapper, which attends only the sinks and the local chunk
    and leaves the sink gradients to the caller, the window crosses the
    shard boundary and the sink gradients reduce inside the backward."""

    def __init__(self, num_sink: int = 4, window_size: int = 512,
                 group=None):
        self.num_sink = num_sink
        self.window_size = window_size
        self.group = group

    def __call__(self, q, k, v, s_aux=None):
        return sp_sink_flash_attention(
            q, k, v, num_sink=self.num_sink, window_size=self.window_size,
            s_aux=s_aux, group=self.group)


def subprocess_generate(*args, **kwargs):
    """``serving.subprocess_eval.subprocess_generate`` (imported on call)."""
    from .serving.subprocess_eval import subprocess_generate as _impl
    return _impl(*args, **kwargs)
