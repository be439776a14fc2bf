"""Single-token decode attention over the rolling sink KV cache.

Counterpart of ``sink_attention_tpu/ops/decode.py``. The kernels are
``csrc/decode.cu`` (they replace the TPU kernel ``_decode_kernel`` in its
three storage branches: bf16, int8 and fp8 codes with per-token fp32
scales): a split-KV pass over 128-slot chunks of the cache buffer, read in
place, then a merge of the partials by their LSE. Beside them sits their
plain PyTorch version, :func:`decode_plain`. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

The quantized kernels compute attention over the dequantized cache in
fp32. The JAX int8 branch instead rounds q and p to 8 bits for the TPU's
s8 x s8 matrix unit, so the port follows the function that branch
approximates, not its rounding.

Both read the per-sequence state from a [B, 4] int32 table
(sink_len, window_len, write_pos, hwm), so a ragged batch
(:func:`sink_decode_attention_ragged`) reuses them unchanged. A window
slot is live iff it is one of the newest ``window_len`` positions behind
``write_pos`` on the ring (the circular-age test).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..cache.sink_cache import dequantize
from . import _build

__all__ = ["sink_decode_attention", "sink_decode_attention_cached",
           "sink_decode_attention_ragged", "decode_kernel", "decode_plain"]

LANES = 128
CHUNK = 128    # slots per CTA of the partial pass; must match csrc/decode.cu
MAX_GROUP = 16  # GQA group limit of the kernel; must match csrc/decode.cu


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _uniform_lens(sink_len: int, window_len: int, write_pos: int,
                  window_size: int, sink_cap: int, batch: int,
                  device) -> torch.Tensor:
    """[B, 4] int32 lens rows from batch-shared cache state."""
    hwm = sink_cap + min(window_len, window_size)
    row = torch.tensor([sink_len, window_len, write_pos, hwm],
                       dtype=torch.int32)
    return row[None, :].expand(batch, 4).contiguous().to(device)


def live_slots(lens: torch.Tensor, s_total: int, sink_cap: int,
               window_size: int) -> torch.Tensor:
    """Bool [B, S_total]: the slots the decode attends, per sequence."""
    slots = torch.arange(s_total, device=lens.device)[None, :]
    sink_len, window_len, write_pos = (lens[:, i:i + 1].long()
                                       for i in range(3))
    sw = slots - sink_cap
    age = torch.where(sw < write_pos, write_pos - 1 - sw,
                      write_pos - 1 - sw + window_size)
    return (slots < sink_len) | ((sw >= 0) & (sw < window_size) &
                                 (age < window_len))


def decode_plain(q, k_buf, v_buf, lens, s_aux=None, *, sink_cap: int,
                 window_size: int, k_scale=None, v_scale=None, quant=None):
    """The kernels' plain PyTorch version, in fp32.

    q [B, H_q, 1, D]; k_buf/v_buf [B, H_kv, S_total, D] (int8 codes with
    k_scale/v_scale [B, H_kv, S_total] when ``quant`` is "int8" or "fp8");
    lens [B, 4] int32; s_aux [H_q] or None. Returns [B, H_q, 1, D] in
    q.dtype.
    """
    B, H_q, _, D = q.shape
    H_kv, s_total = k_buf.shape[1], k_buf.shape[2]
    group = H_q // H_kv
    if quant:
        kf = dequantize(k_buf, k_scale, quant)
        vf = dequantize(v_buf, v_scale, quant)
    else:
        kf, vf = k_buf.float(), v_buf.float()
    live = live_slots(lens, s_total, sink_cap, window_size)  # [B, S]
    qf = q.float().reshape(B, H_kv, group, D) * (1.0 / D ** 0.5)
    s = torch.einsum("bkgd,bksd->bkgs", qf, kf)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    if s_aux is not None:
        aux = s_aux.float().reshape(1, H_kv, group, 1).expand(B, -1, -1, 1)
        s = torch.cat([s, aux], dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bkgs,bksd->bkgd", p[..., :s_total] / denom, vf)
    return out.reshape(B, H_q, 1, D).to(q.dtype)


# The storage branches: the C entry point of csrc/decode.cu and the
# pointer count before its int arguments.
_ENTRY = {None: ("sink_decode_bf16", 8), "int8": ("sink_decode_int8", 10),
          "fp8": ("sink_decode_fp8", 10)}


@functools.lru_cache(maxsize=None)
def _kernel_fn(quant=None):
    lib = _build.load("decode")
    if (lib.sink_decode_chunk(), lib.sink_decode_max_group()) != (
            CHUNK, MAX_GROUP):
        raise RuntimeError("csrc/decode.cu and ops/decode.py disagree on "
                           "CHUNK / MAX_GROUP")
    name, n_ptr = _ENTRY[quant]
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 +
                   [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check_quantized_inputs(q, k_buf, v_buf, k_scale, v_scale, s_aux,
                            quant) -> None:
    """What the int8 and fp8 kernels take: bf16 q, int8 codes, fp32
    scales [B, H_kv, S_total], head_dim 64 or 128, one device."""
    if quant not in ("int8", "fp8"):
        raise ValueError(f"quant must be 'int8' or 'fp8', got {quant!r}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the {quant} decode kernel takes bf16 q, got "
                        f"{q.dtype}")
    if k_buf.dtype != torch.int8 or v_buf.dtype != torch.int8:
        raise TypeError(f"the {quant} decode kernel takes int8 codes, got "
                        f"{k_buf.dtype}, {v_buf.dtype}")
    if k_scale is None or v_scale is None or any(
            t.dtype != torch.float32 for t in (k_scale, v_scale)):
        raise TypeError(f"the {quant} decode kernel takes fp32 scales")
    if (tuple(k_scale.shape) != tuple(k_buf.shape[:3])
            or tuple(v_scale.shape) != tuple(k_buf.shape[:3])):
        raise ValueError("scales must be [B, H_kv, S_total]")
    if q.shape[-1] not in _build.KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not supported by the CUDA "
                         f"kernels (supported: {_build.KERNEL_HEAD_DIMS})")
    devs = {t.device for t in (q, k_buf, v_buf, k_scale, v_scale)}
    if s_aux is not None:
        devs.add(s_aux.device)
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def decode_kernel(q, k_buf, v_buf, lens, s_aux=None, *, sink_cap: int,
                  window_size: int, k_scale=None, v_scale=None, quant=None):
    """Launch ``csrc/decode.cu`` on CUDA tensors (same contract as
    :func:`decode_plain`): ``sink_decode_bf16`` for bf16 storage,
    ``sink_decode_int8`` / ``sink_decode_fp8`` for quantized storage. Each
    branch counts its calls (each launches the partial pass and the
    merge): ``decode_kernel.launches`` (bf16), ``.launches_int8`` and
    ``.launches_fp8``."""
    if quant:
        _check_quantized_inputs(q, k_buf, v_buf, k_scale, v_scale, s_aux,
                                quant)
    else:
        _build.check_attention_inputs(q, k_buf, v_buf, s_aux)
    if not q.is_cuda or lens.device != q.device:
        raise ValueError("decode_kernel takes CUDA tensors on one device")
    B, H_q, n_q, D = q.shape
    _, H_kv, s_total, _ = k_buf.shape
    if n_q != 1:
        raise ValueError("the decode kernel handles a single query token")
    if H_q % H_kv or H_q // H_kv > MAX_GROUP:
        raise ValueError(f"GQA group {H_q}/{H_kv} not supported "
                         f"(at most {MAX_GROUP} query heads per KV head)")
    if (k_buf.shape != v_buf.shape or k_buf.shape[0] != B
            or tuple(lens.shape) != (B, 4) or lens.dtype != torch.int32):
        raise ValueError("bad cache or lens shapes")
    n_split = -(-s_total // CHUNK)
    qc = q.contiguous()
    kc, vc = _build.aligned(k_buf), _build.aligned(v_buf)
    scales = ([k_scale.contiguous(), v_scale.contiguous()] if quant
              else [])
    aux = (s_aux.detach().float().contiguous() if s_aux is not None
           else None)
    part_o = torch.empty((B * H_q, n_split, D), dtype=torch.float32,
                         device=q.device)
    part_lse = torch.empty((B * H_q, n_split), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(qc)
    ptrs = [_build.ptr(t) for t in (qc, kc, vc, *scales, lens.contiguous(),
                                    aux, part_o, part_lse, out)]
    code = _kernel_fn(quant)(*ptrs, B, H_q, H_kv, s_total, D, sink_cap,
                             window_size, 1.0 / (D ** 0.5),
                             _build.stream_ptr(q.device))
    _build.check(code, _ENTRY[quant][0])
    if quant == "int8":
        decode_kernel.launches_int8 += 1
    elif quant == "fp8":
        decode_kernel.launches_fp8 += 1
    else:
        decode_kernel.launches += 1
    return out


decode_kernel.launches = 0
decode_kernel.launches_int8 = 0
decode_kernel.launches_fp8 = 0


def _decode_call(q, k_buf, v_buf, lens, s_aux, **kw):
    if q.device.type == "cpu":
        return decode_plain(q, k_buf, v_buf, lens, s_aux, **kw)
    if q.is_cuda:
        return decode_kernel(q, k_buf, v_buf, lens, s_aux, **kw)
    raise ValueError(f"unsupported device {q.device}")


def sink_decode_attention(q, k, v, s_aux=None):
    """Single-token decode attention over plain (already evicted) KV.

    Every given KV position is attended. q: [B, H_q, 1, D];
    k, v: [B, H_kv, N_kv, D]; s_aux: optional [H_q].
    """
    B, H_kv, n_kv, D = k.shape
    n_pad = _round_up(max(n_kv, 1), LANES)
    pad = (0, 0, 0, n_pad - n_kv)
    kb = torch.nn.functional.pad(k, pad)
    vb = torch.nn.functional.pad(v, pad)
    # sink_len = 0; the whole KV is a not yet wrapped window prefix.
    lens = _uniform_lens(0, n_kv, n_kv, n_pad, 0, B, q.device)
    return _decode_call(q, kb, vb, lens, s_aux, sink_cap=0,
                        window_size=n_pad)


def sink_decode_attention_cached(q, cache, s_aux=None):
    """Single-token decode attention directly over a ``SinkKVCache``.

    Reads the sink + circular window buffer in place (quantized or not): no
    linearisation, no copies. q: [B, H_q, 1, D], for the token whose KV is
    already appended.
    """
    lens = _uniform_lens(cache.sink_len, cache.window_len, cache.write_pos,
                         cache.window_size, cache.sink_cap, q.shape[0],
                         q.device)
    return _decode_call(q, cache.k, cache.v, lens, s_aux,
                        **cache_args(cache))


def cache_args(cache) -> dict:
    """The keyword arguments of :func:`decode_plain` and
    :func:`decode_kernel` that come from a cache's layout."""
    return dict(sink_cap=cache.sink_cap, window_size=cache.window_size,
                k_scale=cache.k_scale, v_scale=cache.v_scale,
                quant=cache.quant)


def ragged_lens(cache) -> torch.Tensor:
    """[B, 4] int32 lens rows of a ``RaggedSinkKVCache``, built on its
    device from its [B] state tensors (no host sync). hwm covers the sink
    region, and the window when the slot has one."""
    hwm = cache.sink_cap + (cache.window_len > 0).to(
        torch.int32) * cache.window_size
    return torch.stack([cache.sink_len, cache.window_len, cache.write_pos,
                        hwm], dim=1).to(torch.int32)


def sink_decode_attention_ragged(q, cache, s_aux=None):
    """Single-token decode over a ``RaggedSinkKVCache``: every batch slot
    attends its own (sink_len[b], window_len[b], write_pos[b]) view of the
    shared buffers, in one launch. An empty slot gives zeros.
    q: [B, H_q, 1, D]."""
    return _decode_call(q, cache.k, cache.v, ragged_lens(cache), s_aux,
                        **cache_args(cache))
