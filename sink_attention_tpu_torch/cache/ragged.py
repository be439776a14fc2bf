"""Ragged (per-sequence) rolling sink KV cache for continuous batching.

Counterpart of ``sink_attention_tpu/cache/ragged.py``. The layout is
``SinkKVCache``'s (one [B, H_kv, sink_cap + window_cap, D] buffer per K/V,
int8 codes plus fp32 per-token scales when quantized), but ``sink_len``,
``window_len``, ``write_pos`` and ``seen`` are [B] int32 tensors on the
cache's device: every batch slot holds its own request at its own length
and ring phase, and the decode kernel reads them as its [B, 4] lens table
(``ops.decode.sink_decode_attention_ragged``). A window slot is live iff
``(write_pos - 1 - slot) mod window_size < window_len`` (the circular-age
test).

Unlike the JAX cache (an immutable pytree), this one is mutable: ``insert``,
``clear``, ``append`` and ``append_many_counted`` write in place and return
the cache; ``clone`` gives a copy with buffers and state of its own. The
state
tensors are updated with indexed writes and ``torch.where``, never read to
the host, so a decode loop that deactivates slots on the device needs no
sync.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sink_cache import _buffers, _clone, _put, dequantize

__all__ = ["RaggedSinkKVCache"]


class RaggedSinkKVCache:
    """Per-layer rolling sink KV cache with per-sequence state (mutable).

    Attributes:
        k, v: [B, H_kv, S_total, D] storage (model dtype, or int8 codes).
        k_scale, v_scale: [B, H_kv, S_total] fp32 (all ones unquantized).
        sink_len, window_len, write_pos, seen: [B] int32 on the device.
        num_sink, window_size, sink_cap, window_cap, quant: static layout.
    """

    def __init__(self, k, v, k_scale, v_scale, num_sink: int,
                 window_size: int, sink_cap: int, window_cap: int,
                 quant: Optional[str] = None):
        self.k, self.v = k, v
        self.k_scale, self.v_scale = k_scale, v_scale
        self.num_sink, self.window_size = num_sink, window_size
        self.sink_cap, self.window_cap = sink_cap, window_cap
        self.quant = quant
        zeros = lambda: torch.zeros(k.shape[0], dtype=torch.int32,
                                    device=k.device)
        self.sink_len, self.window_len = zeros(), zeros()
        self.write_pos, self.seen = zeros(), zeros()

    @classmethod
    def init(cls, batch: int, num_kv_heads: int, head_dim: int,
             num_sink: int = 4, window_size: int = 4096,
             dtype: torch.dtype = torch.bfloat16,
             quant: Optional[str] = None,
             device="cuda") -> "RaggedSinkKVCache":
        return cls(*_buffers(batch, num_kv_heads, head_dim, num_sink,
                             window_size, dtype, quant, device))

    # -- helpers ----------------------------------------------------------

    @property
    def batch(self) -> int:
        return self.k.shape[0]

    @property
    def s_total(self) -> int:
        return self.sink_cap + self.window_cap

    def get_seq_length(self) -> torch.Tensor:
        """Valid cached tokens per slot: [B] int32."""
        return self.sink_len + self.window_len

    # -- per-slot prefill insertion ----------------------------------------

    def insert(self, slot: int, k_seq: torch.Tensor, v_seq: torch.Tensor,
               true_len: int) -> "RaggedSinkKVCache":
        """Store one prefilled sequence in batch slot ``slot``.

        k_seq, v_seq: [H_kv, N_pad, D], right-padded (real tokens at
        [0, true_len)). The sinks are the first ``num_sink`` positions; the
        ring holds the last ``min(true_len, window_size)`` real tokens at
        its end, with ``write_pos = 0`` (the JAX insert's layout: it rolls
        the real tokens to the end of the padded sequence and keeps the
        last ``window_size`` slots). The slot's other buffer rows are
        zeroed.
        """
        H, _, D = k_seq.shape
        W, ns, sc = self.window_size, self.num_sink, self.sink_cap
        row = k_seq.new_zeros((2, H, self.s_total, D))
        n_ring = min(true_len, W)
        for i, x in enumerate((k_seq, v_seq)):
            n_s = min(ns, x.shape[1])
            row[i, :, :n_s] = x[:, :n_s]
            row[i, :, sc + W - n_ring:sc + W] = x[:, true_len - n_ring:
                                                  true_len]
        _put(self, slot, row[0], row[1])
        self.sink_len[slot] = min(true_len, ns)
        self.window_len[slot] = min(max(true_len - ns, 0), W)
        self.write_pos[slot] = 0
        self.seen[slot] = true_len
        return self

    def clear(self, slot: int) -> "RaggedSinkKVCache":
        """Mark ``slot`` empty (its data stays but is never attended)."""
        for t in (self.sink_len, self.window_len, self.write_pos, self.seen):
            t[slot] = 0
        return self

    # -- batched decode append ---------------------------------------------

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor,
               active: torch.Tensor) -> "RaggedSinkKVCache":
        """Append one decode token per active slot.

        k_new, v_new: [B, H_kv, 1, D]; active: [B] bool. An inactive slot
        keeps its state and its data: when the window has padding
        (window_cap > window_size) its token is parked in the never-live
        slot ``sink_cap + window_size``; otherwise (every gpt-oss cache:
        W=128, and full layers at max_len a multiple of 128) the touched
        slot is read back and kept by a select, since the next write slot
        of a full ring holds the oldest live token. A token at global
        position < num_sink is promoted to the next sink slot instead of
        the ring.
        """
        if k_new.shape[2] != 1:
            raise ValueError("append takes one token")
        W, sc = self.window_size, self.sink_cap
        rows = torch.arange(self.batch, device=self.k.device)
        pos = sc + self.write_pos.long()
        promote = None
        if self.num_sink > 0:
            promote = self.seen < self.num_sink
            pos = torch.where(promote, self.seen.long(), pos)
        keep = None
        if self.window_cap > W:
            pos = torch.where(active, pos, torch.full_like(pos, sc + W))
        else:
            keep = active[:, None]
        # [B, H_kv, D] rows at (b, :, pos[b])
        _put(self, (rows, slice(None), pos), k_new[:, :, 0], v_new[:, :, 0],
             keep)
        adv = active.to(torch.int32)
        ring_adv = adv
        if promote is not None:
            p = promote.to(torch.int32)
            ring_adv = adv * (1 - p)
            self.sink_len += adv * p
        self.write_pos = (self.write_pos + ring_adv) % W
        self.window_len = torch.clamp(self.window_len + ring_adv, max=W)
        self.seen += adv
        return self

    def append_many_counted(self, k_new: torch.Tensor, v_new: torch.Tensor,
                            counts: torch.Tensor) -> "RaggedSinkKVCache":
        """Append T tokens [B, H_kv, T, D] per slot, slot b keeping only
        its first ``counts[b]`` ([B] int on the device): the per-slot
        speculative-decoding commit, with no host sync. Token i is
        :meth:`append` with ``active = i < counts``, so a rejected token
        changes neither the slot's state nor its live data (the park slot
        or the read-back select)."""
        for i in range(k_new.shape[2]):
            self.append(k_new[:, :, i:i + 1], v_new[:, :, i:i + 1],
                        i < counts)
        return self

    def clone(self) -> "RaggedSinkKVCache":
        """A copy with buffers and state tensors of its own."""
        return _clone(self)

    # -- reads --------------------------------------------------------------

    def dequant_kv(self):
        """Full-capacity buffers [B, H_kv, S_total, D]: fp32 dequantized
        when quantized, else the storage itself."""
        if self.quant:
            return (dequantize(self.k, self.k_scale, self.quant),
                    dequantize(self.v, self.v_scale, self.quant))
        return self.k, self.v

    def linearized_kv_slot(self, slot: int):
        """Chronological [H_kv, sink_len + window_len, D] KV of one slot
        (reads its state to the host; for tests)."""
        sink_len = int(self.sink_len[slot])
        window_len = int(self.window_len[slot])
        write_pos = int(self.write_pos[slot])
        kf, vf = self.dequant_kv()
        kf, vf = kf[slot], vf[slot]
        sc, W = self.sink_cap, self.window_size
        parts_k, parts_v = [kf[:, :sink_len]], [vf[:, :sink_len]]
        if window_len > 0:
            start = (write_pos - window_len) % W   # the oldest live slot
            for parts, buf in ((parts_k, kf), (parts_v, vf)):
                ring = torch.roll(buf[:, sc:sc + W], -start, dims=1)
                parts.append(ring[:, :window_len])
        return torch.cat(parts_k, dim=1), torch.cat(parts_v, dim=1)
