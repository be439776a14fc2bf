"""Rolling sink KV cache, in PyTorch, with int8/fp8 quantized storage.

Counterpart of ``sink_attention_tpu/cache/sink_cache.py``. One buffer per
layer and per K/V: slots ``[0, sink_cap)`` hold the sink tokens, slots
``[sink_cap, sink_cap + window_cap)`` the circular window, both padded to
128-slot multiples (the decode kernel reads the buffer in place, and its
validity test depends on this layout). Unlike the JAX cache, D is stored
unpadded.

Quantized storage (``quant="int8"`` or ``"fp8"``) keeps int8 codes and one
fp32 scale per token and head (:func:`quantize`, bit for bit the JAX
package's): fp8 codes are float8_e4m3fn bit patterns held in int8, with
the subnormal codes flushed to 0. The decode kernel dequantizes in place.

Unlike the JAX cache (an immutable ``flax.struct`` pytree), this cache is
mutable: ``prefill``, ``append`` and its relatives (``append_many``,
``append_many_counted``, ``update``, ``reorder``) write into the buffers in
place and keep ``sink_len``, ``window_len``, ``write_pos`` and ``seen`` as
Python ints; each returns the cache itself. ``clone`` gives a copy with
buffers of its own, where the JAX code keeps the old value of a pure
cache. ``state_dict`` gives every field by name (what a checkpoint saves,
as orbax saves a JAX cache's fields) and ``load_state_dict`` copies such a
dict back in place. Cache state is shared across the batch: batched
decode needs equal lengths.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from ..utils.device import resolve_device

__all__ = ["SinkKVCache", "QUANT_MAX", "quantize", "dequantize"]

LANES = 128
QUANT_MAX = {"int8": 127.0, "fp8": 448.0}


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _check_quant(quant: Optional[str]) -> None:
    if quant not in (None, "int8", "fp8"):
        raise ValueError(f"quant must be None, 'int8' or 'fp8', got "
                         f"{quant!r}")


def quantize(x: torch.Tensor, quant: str, axis: int = -1):
    """Symmetric per-slice quantization along ``axis`` (usually the last,
    head_dim).

    Returns (codes int8 [..., D], scale fp32 [...]) with
    x ~ dequantize(codes, scale). int8: the int values; fp8: e4m3 bit
    patterns in int8, subnormal codes (magnitude bits < 8, below 2^-6 of
    the row's scale) flushed to 0, as in the JAX package. As there, the
    scale broadcasts back over the last axis (``scale[..., None]``), so an
    ``axis`` other than the last gives JAX's result, which is well formed
    only where that broadcast is.
    """
    qmax = QUANT_MAX[quant]
    xf = x.float()
    amax = xf.abs().amax(dim=axis)
    # divided by a tensor: on the card PyTorch divides by a Python number
    # as a product with its reciprocal, one bit off JAX's (and the CPU's)
    # quotient
    scale = amax / amax.new_full((), qmax)
    inv = torch.where(scale > 0, 1.0 / scale.clamp(min=1e-30),
                      torch.zeros_like(scale))
    scaled = (xf * inv[..., None]).clamp(-qmax, qmax)
    if quant == "int8":
        return torch.round(scaled).to(torch.int8), scale
    codes = scaled.to(torch.float8_e4m3fn).view(torch.int8)
    codes = torch.where((codes & 0x7F) >= 8, codes, torch.zeros_like(codes))
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               quant: str = "int8") -> torch.Tensor:
    """fp32 values of ``codes`` [..., D] with per-slice ``scale`` [...]."""
    if quant == "fp8":
        codes = codes.view(torch.float8_e4m3fn)
    return codes.float() * scale[..., None].float()


class SinkKVCache:
    """Per-layer rolling sink KV cache (mutable; see the module docstring).

    Attributes:
        k, v: [B, H_kv, S_total, D] storage: the model dtype, or int8 codes
            when quantized.
        k_scale, v_scale: [B, H_kv, S_total] fp32 (all ones unquantized).
        sink_len, window_len, write_pos, seen: Python ints.
        num_sink, window_size, sink_cap, window_cap, quant: the static
            layout.
    """

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 k_scale: torch.Tensor, v_scale: torch.Tensor,
                 num_sink: int, window_size: int, sink_cap: int,
                 window_cap: int, quant: Optional[str] = None):
        self.k, self.v = k, v
        self.k_scale, self.v_scale = k_scale, v_scale
        self.num_sink, self.window_size = num_sink, window_size
        self.sink_cap, self.window_cap = sink_cap, window_cap
        self.quant = quant
        self.sink_len = self.window_len = self.write_pos = self.seen = 0

    # -- constructors -----------------------------------------------------

    @classmethod
    def init(cls, batch: int, num_kv_heads: int, head_dim: int,
             num_sink: int = 4, window_size: int = 4096,
             dtype: torch.dtype = torch.bfloat16,
             quant: Optional[str] = None, device="cuda") -> "SinkKVCache":
        return cls(*_buffers(batch, num_kv_heads, head_dim, num_sink,
                             window_size, dtype, quant, device))

    # -- helpers ----------------------------------------------------------

    @property
    def s_total(self) -> int:
        return self.sink_cap + self.window_cap

    def get_seq_length(self) -> int:
        """Number of valid cached tokens (sink + window)."""
        return self.sink_len + self.window_len

    def get_max_cache_shape(self) -> int:
        return self.num_sink + self.window_size

    # -- updates (in place; return self) ----------------------------------

    def prefill(self, k: torch.Tensor, v: torch.Tensor) -> "SinkKVCache":
        """Store a prefill sequence [B, H_kv, N, D] into an empty cache.

        The first num_sink tokens go to the sink region, the last
        min(window_size, N - num_sink) tokens to the window region; the
        caller runs the prefill kernel on the full, unevicted KV.
        """
        N = k.shape[2]
        ns, W = self.num_sink, self.window_size
        n_sink = min(N, ns)
        rest = N - n_sink
        n_win = min(rest, W)
        if n_sink > 0:
            _put(self, _slots(0, n_sink), k[:, :, :n_sink], v[:, :, :n_sink])
        if n_win > 0:
            sc = self.sink_cap
            _put(self, _slots(sc, sc + n_win), k[:, :, N - n_win:],
                        v[:, :, N - n_win:])
        self.sink_len, self.window_len = n_sink, n_win
        self.write_pos = n_win % W if rest > 0 else 0
        self.seen = N
        return self

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor,
               keep: bool = True) -> "SinkKVCache":
        """Append one decode token [B, H_kv, 1, D] to the circular window.

        Sink promotion: a token at global position < num_sink goes to the
        (still unfilled) sink region, not the ring, so a prompt shorter
        than num_sink still ends with its first num_sink seen tokens pinned
        (the j < num_sink term of the prefill mask).

        ``keep=False`` makes the call a no-op: the JAX cache writes the
        target slot's old contents back and freezes its state (once the
        ring is full that slot holds the oldest live token); here the
        token is simply not written, which leaves the same buffers.
        """
        if k_new.shape[2] != 1:
            raise ValueError("append takes one token")
        if not keep:
            return self
        W = self.window_size
        if self.num_sink > 0 and self.seen < self.num_sink:
            pos = self.seen
            self.sink_len += 1
        else:
            pos = self.sink_cap + self.write_pos
            self.write_pos = (self.write_pos + 1) % W
            self.window_len = min(self.window_len + 1, W)
        _put(self, _slots(pos, pos + 1), k_new, v_new)
        self.seen += 1
        return self

    def append_many(self, k_new: torch.Tensor, v_new: torch.Tensor
                    ) -> "SinkKVCache":
        """Append T tokens [B, H_kv, T, D] one by one."""
        for i in range(k_new.shape[2]):
            self.append(k_new[:, :, i:i + 1], v_new[:, :, i:i + 1])
        return self

    def append_many_counted(self, k_new: torch.Tensor, v_new: torch.Tensor,
                            count) -> "SinkKVCache":
        """Append the first ``count`` of T tokens [B, H_kv, T, D]: the
        speculative-decoding commit. ``count`` is an int or a 0-dim tensor
        (read to the host once; the state is host ints); as in JAX, token
        i is kept iff i < count. The rejected tokens are not written, so a
        full ring keeps its oldest live tokens."""
        n = min(max(int(count), 0), k_new.shape[2])
        return self.append_many(k_new[:, :, :n], v_new[:, :, :n])

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor
               ) -> "SinkKVCache":
        """HF-style dispatch on N: one token appends, more prefill (into
        an empty cache)."""
        if k_new.shape[2] == 1:
            return self.append(k_new, v_new)
        return self.prefill(k_new, v_new)

    def reorder(self, beam_idx: torch.Tensor) -> "SinkKVCache":
        """Beam-search reorder: batch row b takes row ``beam_idx[b]``'s
        buffers (``index_select`` on dim 0, written back in place)."""
        return _reorder(self, beam_idx)

    def clone(self) -> "SinkKVCache":
        """A copy with buffers (and state) of its own."""
        return _clone(self)

    def state_dict(self) -> dict:
        """Every field by name: the buffers, the length state, the static
        layout."""
        return dict(vars(self))

    def load_state_dict(self, fields: dict) -> None:
        """Copy a :meth:`state_dict` into this cache in place."""
        _load_state_dict(self, fields)

    # -- reads ------------------------------------------------------------

    def dequant_kv(self):
        """Full-capacity buffers [B, H_kv, S_total, D]: fp32 dequantized
        when quantized, else the storage itself."""
        if self.quant:
            return (dequantize(self.k, self.k_scale, self.quant),
                    dequantize(self.v, self.v_scale, self.quant))
        return self.k, self.v

    def linearized_kv(self):
        """Chronological [B, H_kv, sink_len + window_len, D] KV, for tests
        and compatibility paths; the decode kernel reads the buffer in
        place."""
        kf, vf = self.dequant_kv()
        sc, W = self.sink_cap, self.window_size
        parts_k = [kf[:, :, :self.sink_len]]
        parts_v = [vf[:, :, :self.sink_len]]
        if self.window_len > 0:
            wk = kf[:, :, sc:sc + W]
            wv = vf[:, :, sc:sc + W]
            if self.window_len < W:
                parts_k.append(wk[:, :, :self.window_len])
                parts_v.append(wv[:, :, :self.window_len])
            else:
                parts_k.append(torch.roll(wk, -self.write_pos, dims=2))
                parts_v.append(torch.roll(wv, -self.write_pos, dims=2))
        return torch.cat(parts_k, dim=2), torch.cat(parts_v, dim=2)


def _reorder(cache, beam_idx: torch.Tensor):
    """Rows of every buffer of ``cache`` gathered by ``beam_idx`` [B] (any
    permutation or repetition), in place. Returns the cache."""
    idx = beam_idx.to(device=cache.k.device, dtype=torch.long)
    for buf in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        buf.copy_(buf.index_select(0, idx))
    return cache


def _clone(cache):
    """A shallow copy of ``cache`` whose tensors (buffers, and the ragged
    cache's state) are copies."""
    out = copy.copy(cache)
    for name, val in vars(cache).items():
        if isinstance(val, torch.Tensor):
            setattr(out, name, val.clone())
    return out


# the fields that change as the cache fills; every other field that is not
# a tensor is the static layout
_LENGTHS = ("sink_len", "window_len", "write_pos", "seen")


def _load_state_dict(cache, fields: dict) -> None:
    """Copy ``fields`` (a ``state_dict``) into ``cache`` in place: tensors
    keep their storage (``copy_``), the Python-int lengths are set. Raises
    ValueError if the fields are not the cache's, or the saved layout or a
    buffer's shape differs."""
    mine = vars(cache)
    if set(fields) != set(mine):
        raise ValueError(f"the saved cache has the fields {sorted(fields)}, "
                         f"this one {sorted(mine)}")
    for name, val in mine.items():
        if isinstance(val, torch.Tensor):
            if tuple(fields[name].shape) != tuple(val.shape):
                raise ValueError(
                    f"the saved cache's {name} has shape "
                    f"{tuple(fields[name].shape)}, this one "
                    f"{tuple(val.shape)}")
        elif name not in _LENGTHS and fields[name] != val:
            raise ValueError(f"the saved cache has {name}={fields[name]!r}, "
                             f"this one {val!r}")
    for name, val in mine.items():
        if isinstance(val, torch.Tensor):
            val.copy_(fields[name])
        elif name in _LENGTHS:
            setattr(cache, name, int(fields[name]))


def _slots(start: int, stop: int):
    """Index of the slots [start, stop) of every batch row and head."""
    return slice(None), slice(None), slice(start, stop)


def _put(cache, index, k: torch.Tensor, v: torch.Tensor,
         keep: Optional[torch.Tensor] = None) -> None:
    """``cache.k[index] = store(k)``, the same for v and, when quantized,
    the scales (``index`` selects [..., D] rows; the scales stay all ones
    unquantized). With ``keep`` (bool, broadcast against the scales'
    rows) the rows where it is False keep their old contents."""
    for buf, sbuf, x in ((cache.k, cache.k_scale, k),
                         (cache.v, cache.v_scale, v)):
        if cache.quant:
            codes, scale = quantize(x, cache.quant)
        else:
            codes, scale = x.to(buf.dtype), None
        if keep is not None:
            codes = torch.where(keep[..., None], codes, buf[index])
        buf[index] = codes
        if scale is not None:
            sbuf[index] = (scale if keep is None else
                           torch.where(keep, scale, sbuf[index]))


def _buffers(batch: int, num_kv_heads: int, head_dim: int, num_sink: int,
             window_size: int, dtype: torch.dtype, quant: Optional[str],
             device):
    """The zeroed storage of a cache (shared with the ragged cache):
    (k, v, k_scale, v_scale, num_sink, window_size, sink_cap, window_cap,
    quant)."""
    _check_quant(quant)
    sink_cap = LANES if num_sink > 0 else 0
    if num_sink > sink_cap:
        raise ValueError("num_sink > 128 not supported")
    window_cap = _round_up(max(window_size, 1), LANES)
    s_total = sink_cap + window_cap
    shape = (batch, num_kv_heads, s_total, head_dim)
    dev = resolve_device(device)
    store = torch.int8 if quant else dtype
    k = torch.zeros(shape, dtype=store, device=dev)
    v = torch.zeros(shape, dtype=store, device=dev)
    k_scale = torch.ones(shape[:3], dtype=torch.float32, device=dev)
    v_scale = torch.ones(shape[:3], dtype=torch.float32, device=dev)
    return (k, v, k_scale, v_scale, num_sink, window_size, sink_cap,
            window_cap, quant)
