"""Single-token decode attention over the rolling sink KV cache.

Counterpart of ``sink_attention_tpu/ops/decode.py``. The kernel is
``csrc/decode.cu`` (it replaces the TPU kernel ``_decode_kernel`` in its
storage branches: bf16, fp16, fp32, and int8 and fp8 codes with per-token
fp32 scales), one launch per call over the cache buffer, read in place.
Up to head_dim 128 a thread block cluster per (sequence, KV head) splits
the live 128-slot tiles and merges its partials in distributed shared
memory. Past 128 the live range is split over enough CTAs to fill the card
(:func:`split_plan`), each writing an fp32 partial to scratch that the
unit's last CTA merges in the same launch. Beside it sits its plain
PyTorch version, :func:`decode_plain`. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

The quantized kernels compute attention over the dequantized cache. The
JAX int8 branch instead rounds q and p to 8 bits for the TPU's s8 x s8
matrix unit, so the port follows the function that branch approximates,
not its rounding. An fp32 cache is attended in fp32 (JAX pins
``Precision.HIGHEST`` for a non-bf16 cache), an fp16 cache in fp16 with
fp32 accumulation.

Any head_dim runs (the kernel's instances are 64 and 128 wide, the
columns past D zero-filled; past 128 one instance per storage whose depth
is counted at run time streams 32-slot tiles of K, then of V, in 512-byte
chunks of a row, through a ring of four, computing S once per tile). The
cache rows are copied 16 bytes at a
time, so a D whose rows are not whole 16 bytes (D % 8 != 0 in bf16/fp16, D
% 16 != 0 for int8/fp8 codes, D % 4 != 0 in fp32) reaches the kernel
through a zero-padded copy of q and the whole cache buffer made per call
(``decode_kernel.padded_copies`` counts them), and the output is sliced
back: correct, and slow in proportion to the buffer.

The per-sequence state (sink_len, window_len, write_pos) reaches the
kernel as three ints shared by the batch (a ``SinkKVCache``), as the three
[B] int32 tensors of a ``RaggedSinkKVCache``, or as a [B, 4] int32 table
(sink_len, window_len, write_pos, hwm); the kernel reads the tensors on
the device and derives its high-water mark itself, so no call copies state
between host and device. A window slot is live iff it is one of the newest
``window_len`` positions behind ``write_pos`` on the ring (the circular-age
test).

The multi-token ops of speculative decoding's verify pass
(:func:`sink_decode_attention_cached_multi`,
:func:`sink_decode_attention_ragged_multi`) are XLA in the JAX package, so
plain PyTorch here: T draft queries over the pre-append cache plus the
drafts themselves, in one masked softmax.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..cache.sink_cache import dequantize
from . import _build

__all__ = ["sink_decode_attention", "sink_decode_attention_cached",
           "sink_decode_attention_ragged",
           "sink_decode_attention_cached_multi",
           "sink_decode_attention_ragged_multi", "decode_kernel",
           "decode_plain", "cache_state", "cluster_size", "split_plan"]

LANES = 128
TILE = 128       # slots per kernel tile; must match csrc/decode.cu
MAX_CLUSTER = 8  # CTAs per cluster at most; must match csrc/decode.cu
# The split decode past head_dim 128 (csrc/decode.cu's DEEP_* constants,
# which its launch checks the plan against):
DEEP_TILE = 32          # slots per tile
DEEP_SLOTS = 512        # slots of one CTA's pass (a longer range: passes)
DEEP_SPLITS = 512       # ranges of a unit at most
DEEP_MIN_TILES = 2      # tiles of a range at least, where the range allows
DEEP_CTAS_PER_SM = 2    # CTAs the split aims at, per SM of the card


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _uniform_lens(sink_len: int, window_len: int, write_pos: int,
                  window_size: int, sink_cap: int, batch: int,
                  device) -> torch.Tensor:
    """[B, 4] int32 lens rows from batch-shared cache state (the plain
    version's table; the kernel takes the ints themselves)."""
    hwm = sink_cap + min(window_len, window_size)
    row = torch.tensor([sink_len, window_len, write_pos, hwm],
                       dtype=torch.int32)
    return row[None, :].expand(batch, 4).contiguous().to(device)


def lens_table(lens, batch: int, device, sink_cap: int,
               window_size: int) -> torch.Tensor:
    """The [B, 4] int32 table of any form of the state ``lens`` (a table,
    three [B] tensors, or three ints)."""
    if isinstance(lens, torch.Tensor):
        return lens
    if isinstance(lens[0], torch.Tensor):
        sink_len, window_len, write_pos = lens
        hwm = sink_cap + (window_len > 0).to(torch.int32) * window_size
        return torch.stack([sink_len, window_len, write_pos, hwm],
                           dim=1).to(torch.int32)
    return _uniform_lens(*lens, window_size, sink_cap, batch, device)


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
    lens: the state, as a [B, 4] int32 table, three [B] int32 tensors or
    three ints (see :func:`lens_table`); s_aux [H_q] or None. Returns
    [B, H_q, 1, D] in q.dtype.
    """
    B, H_q, _, D = q.shape
    H_kv, s_total = k_buf.shape[1], k_buf.shape[2]
    group = H_q // H_kv
    lens = lens_table(lens, B, q.device, sink_cap, window_size)
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


# The storage branches' C entry points in csrc/decode.cu, by the cache's
# quantization, else by its dtype: head_dim <= 128 (one signature); past
# 128 the split decode's, ``sink_decode_deep_*`` (another).
_ENTRY = {torch.bfloat16: "sink_decode_bf16",
          torch.float16: "sink_decode_f16",
          torch.float32: "sink_decode_f32", "int8": "sink_decode_int8",
          "fp8": "sink_decode_fp8"}


def _entry(branch, deep: bool) -> str:
    name = _ENTRY[branch]
    return name.replace("decode_", "decode_deep_") if deep else name


@functools.lru_cache(maxsize=None)
def _kernel_fn(branch, deep: bool = False):
    lib = _build.load("decode")
    if (lib.sink_decode_tile(), lib.sink_decode_max_cluster()) != (
            TILE, MAX_CLUSTER):
        raise RuntimeError("csrc/decode.cu and ops/decode.py disagree on "
                           "TILE / MAX_CLUSTER")
    fn = getattr(lib, _entry(branch, deep))
    fn.restype = ctypes.c_int
    # the split decode adds the workspace's two pointers and the plan's
    # rows, n_split and split_slots in place of the cluster
    fn.argtypes = ([ctypes.c_void_p] * (12 if deep else 10) +
                   [ctypes.c_int] * (14 if deep else 12) +
                   [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _deep_rows(elem_bytes: int, group: int, d: int) -> int:
    """Query rows a CTA of the split decode takes (csrc/decode.cu's
    ``sink_decode_deep_rows``: up to 16, halved until its shared memory
    fits)."""
    rows = _build.load("decode").sink_decode_deep_rows(elem_bytes, group, d)
    if rows < 1:
        raise ValueError(f"head_dim {d}: one query row of the decode does "
                         "not fit a CTA's shared memory")
    return rows


def _check_quantized_inputs(q, k_buf, v_buf, k_scale, v_scale, s_aux,
                            quant) -> None:
    """What the int8 and fp8 kernels take: bf16 q, int8 codes, fp32
    scales [B, H_kv, S_total], any head_dim, one device."""
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
    _build.kernel_head_dim(q.shape[-1])
    devs = {t.device for t in (q, k_buf, v_buf, k_scale, v_scale)}
    if s_aux is not None:
        devs.add(s_aux.device)
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def _live_end(lens, s_total: int, sink_cap: int, window_size: int) -> int:
    """Where the kernel's live range ends at most: with batch-shared int
    state where its own high-water mark does; device state (a table or
    [B] tensors), unknown to the host, spans the whole buffer."""
    end = s_total
    if not (isinstance(lens, torch.Tensor) or isinstance(lens[0],
                                                         torch.Tensor)):
        sink_len, window_len, write_pos = (int(x) for x in lens)
        end = min(end, sink_len if window_len == 0 else sink_cap + (
            write_pos if write_pos >= window_len else window_size))
    return end


def cluster_size(lens, s_total: int, sink_cap: int,
                 window_size: int) -> int:
    """CTAs per cluster of the decode kernel up to head_dim 128: the
    smallest power of two that covers the live range's 128-slot tiles, at
    most MAX_CLUSTER (the range as :func:`_live_end` bounds it)."""
    c, n_tiles = 1, -(-_live_end(lens, s_total, sink_cap, window_size)
                      // TILE)
    while c < min(n_tiles, MAX_CLUSTER):
        c *= 2
    return c


@functools.lru_cache(maxsize=4096)
def split_plan(units: int, rows: int, elem_bytes: int, end: int,
               n_sm: int):
    """How the split decode (head_dim > 128) covers the live range
    [0, ``end``) of a call with ``units`` = B * H_kv * ceil(group /
    ``rows``) units of ``rows`` query rows over a storage of
    ``elem_bytes`` bytes an element: ``(n_split, split_slots)``, n_split
    CTAs a unit, each over split_slots slots (whole 32-slot tiles). About
    DEEP_CTAS_PER_SM CTAs per SM of the ``n_sm``, no fewer than
    DEEP_MIN_TILES tiles a range where the range allows, no more ranges
    than balance the unit's merge (its last CTA reads n_split x rows x d
    fp32) against one range's K/V bytes (2 x end / n_split x d x
    ``elem_bytes``), and at most DEEP_SPLITS ranges; a range is one pass
    of at most DEEP_SLOTS slots unless DEEP_SPLITS of them do not cover
    the range."""
    tiles = max(1, -(-end // DEEP_TILE))
    least = -(-tiles // (DEEP_SLOTS // DEEP_TILE))  # ranges of one pass
    want = min(-(-DEEP_CTAS_PER_SM * n_sm // units),
               -(-tiles // DEEP_MIN_TILES),
               max(1, math.isqrt(end * elem_bytes // (2 * rows))))
    per = -(-tiles // min(max(least, want), DEEP_SPLITS))  # tiles a range
    return -(-tiles // per), per * DEEP_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The split decode's workspace, per (device, stream): fp32 scratch for the
# partials (each launch writes what it reads) and the arrival counters,
# zeroed once and left zero by every launch (a unit's last CTA resets its
# own). Launches on one stream run in order, so they share it; a warmed
# call allocates nothing.
_WORKSPACE: dict = {}


def _workspace(device, stream: int, n_part: int, n_units: int):
    key = (device.index, stream)
    part, counters = _WORKSPACE.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1 << 16), dtype=torch.float32,
                           device=device)
    if counters is None or counters.numel() < n_units:
        counters = torch.zeros(max(n_units, 1024), dtype=torch.int32,
                               device=device)
    _WORKSPACE[key] = part, counters
    return part, counters


def _state_args(lens, batch: int, device):
    """(three pointers, stride, three ints) of the kernel's state
    arguments for any form of ``lens``: a [B, 4] table's first three
    columns, three [B] tensors read on the device, or three ints."""
    if isinstance(lens, torch.Tensor):
        if (tuple(lens.shape) != (batch, 4) or lens.dtype != torch.int32
                or lens.device != device or not lens.is_contiguous()):
            raise ValueError("lens must be a contiguous [B, 4] int32 table "
                             "on q's device")
        base = lens.data_ptr()
        return [base + 4 * i for i in range(3)], 4, (0,) * 3
    if len(lens) != 3:
        raise ValueError("the state is (sink_len, window_len, write_pos)")
    if isinstance(lens[0], torch.Tensor):
        for t in lens:
            if (tuple(t.shape) != (batch,) or t.dtype != torch.int32
                    or t.device != device or not t.is_contiguous()):
                raise ValueError("the state tensors must be contiguous [B] "
                                 "int32 on q's device")
        return [t.data_ptr() for t in lens], 1, (0,) * 3
    return [None] * 3, 0, tuple(int(x) for x in lens)


def decode_kernel(q, k_buf, v_buf, lens, s_aux=None, *, sink_cap: int,
                  window_size: int, k_scale=None, v_scale=None, quant=None):
    """Launch ``csrc/decode.cu`` on CUDA tensors (same contract as
    :func:`decode_plain`): ``sink_decode_bf16`` / ``_f16`` / ``_f32`` for
    bf16, fp16 or fp32 storage (q of the cache's dtype),
    ``sink_decode_int8`` / ``sink_decode_fp8`` for quantized storage (q
    bf16); one kernel per call, any GQA group, any head_dim. Each
    branch counts its launches: ``decode_kernel.launches`` (the
    unquantized branch, any of its dtypes), ``.launches_int8`` and
    ``.launches_fp8``; ``.coverage`` the (head_dim, dtype) pairs run and
    ``.padded_copies`` the calls that padded D (see the module's
    docstring)."""
    if quant:
        _check_quantized_inputs(q, k_buf, v_buf, k_scale, v_scale, s_aux,
                                quant)
    else:
        _build.check_attention_inputs(q, k_buf, v_buf, s_aux)
    B, H_q, n_q, D = q.shape
    _, H_kv, s_total, _ = k_buf.shape
    if n_q != 1:
        raise ValueError("the decode kernel handles a single query token")
    if H_q % H_kv:
        raise ValueError(f"GQA group {H_q}/{H_kv}: H_q must be a multiple "
                         f"of H_kv")
    if k_buf.shape != v_buf.shape or k_buf.shape[0] != B:
        raise ValueError("bad cache shapes")
    if not q.is_cuda:
        raise ValueError("decode_kernel takes CUDA tensors on one device")
    ptrs, stride, ints = _state_args(lens, B, q.device)
    d_pad = max(_build.padded_head_dim(D, k_buf.element_size()),
                _build.padded_head_dim(D, 4))  # cache rows, q's float4s
    qc = _build.aligned(_build.pad_head_dim(q, d_pad))
    kc, vc = (_build.aligned(_build.pad_head_dim(t, d_pad))
              for t in (k_buf, v_buf))
    # every tensor a pointer is taken from stays referenced until the launch
    scales = ([_build.aligned(t) for t in (k_scale, v_scale)] if quant
              else [None, None])
    aux = (s_aux.detach().float().contiguous() if s_aux is not None
           else None)
    out = torch.empty_like(qc)
    branch = quant or q.dtype
    tensors = (qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
               *(t.data_ptr() if t is not None else None for t in scales),
               *ptrs, aux.data_ptr() if aux is not None else None,
               out.data_ptr())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if d_pad <= 128:
        code = _kernel_fn(branch)(
            *tensors, stride, *ints, B, H_q, H_kv, s_total, d_pad, sink_cap,
            window_size, cluster_size(lens, s_total, sink_cap, window_size),
            1.0 / (D ** 0.5), stream)
    else:  # the split decode, its plan and its workspace
        G, elem = H_q // H_kv, k_buf.element_size()
        rows = _deep_rows(elem, G, d_pad)
        units = B * H_kv * -(-G // rows)
        n_split, split_slots = split_plan(
            units, rows, elem, _live_end(lens, s_total, sink_cap,
                                         window_size),
            _sm_count(q.device.index))
        part, counters = _workspace(q.device, stream,
                                    units * n_split * rows * (d_pad + 2),
                                    units)
        code = _kernel_fn(branch, True)(
            *tensors, part.data_ptr(), counters.data_ptr(), stride, *ints, B,
            H_q, H_kv, s_total, d_pad, sink_cap, window_size, rows, n_split,
            split_slots, 1.0 / (D ** 0.5), stream)
    _build.check(code, _entry(branch, d_pad > 128))
    if quant == "int8":
        decode_kernel.launches_int8 += 1
    elif quant == "fp8":
        decode_kernel.launches_fp8 += 1
    else:
        decode_kernel.launches += 1
    decode_kernel.coverage.add((D, quant or str(q.dtype).replace("torch.",
                                                                 "")))
    decode_kernel.padded_copies += d_pad != D
    return out if d_pad == D else out[..., :D]


_build.counters(decode_kernel)
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
    return _decode_call(q, kb, vb, (0, n_kv, n_kv), s_aux, sink_cap=0,
                        window_size=n_pad)


def cache_state(cache):
    """(sink_len, window_len, write_pos) of a cache: ints for a
    ``SinkKVCache``, its [B] int32 device tensors for a
    ``RaggedSinkKVCache``."""
    return cache.sink_len, cache.window_len, cache.write_pos


def sink_decode_attention_cached(q, cache, s_aux=None):
    """Single-token decode attention directly over a ``SinkKVCache``.

    Reads the sink + circular window buffer in place (quantized or not): no
    linearisation, no copies, and the cache's state goes to the kernel as
    ints. q: [B, H_q, 1, D], for the token whose KV is already appended.
    """
    return _decode_call(q, cache.k, cache.v, cache_state(cache), s_aux,
                        **cache_args(cache))


def cache_args(cache) -> dict:
    """The keyword arguments of :func:`decode_plain` and
    :func:`decode_kernel` that come from a cache's layout."""
    return dict(sink_cap=cache.sink_cap, window_size=cache.window_size,
                k_scale=cache.k_scale, v_scale=cache.v_scale,
                quant=cache.quant)


def ragged_lens(cache) -> torch.Tensor:
    """[B, 4] int32 lens rows of a ``RaggedSinkKVCache``, built on its
    device from its [B] state tensors (no host sync): the plain version's
    table. hwm covers the sink region, and the window when the slot has
    one."""
    return lens_table(cache_state(cache), cache.batch, cache.k.device,
                      cache.sink_cap, cache.window_size)


def sink_decode_attention_ragged(q, cache, s_aux=None):
    """Single-token decode over a ``RaggedSinkKVCache``: every batch slot
    attends its own (sink_len[b], window_len[b], write_pos[b]) view of the
    shared buffers, in one launch that reads the three state tensors on
    the device. An empty slot gives zeros. q: [B, H_q, 1, D]."""
    return _decode_call(q, cache.k, cache.v, cache_state(cache), s_aux,
                        **cache_args(cache))


# ---------------------------------------------------------------------------
# Multi-token decode (speculative verification), plain PyTorch
# ---------------------------------------------------------------------------


def _multi_attention(q, k_new, v_new, cache, state, s_aux=None):
    """T draft tokens' attention over the pre-append ``cache`` and the
    drafts, each sequence at its own ring state.

    q [B, H_q, T, D]; k_new/v_new [B, H_kv, T, D]; state: (sink_len,
    window_len, write_pos, seen), each a [B] tensor on q's device or an
    int shared by the batch (no copy to the device). Draft t sits at
    position ``seen + t`` and attends the sink slots, the window tokens
    still inside its own causal window (so also those that appending all T
    drafts would evict) and drafts 0..t: exactly sequential single-token
    decode. In fp32; returns q.dtype. Requires T <= window_size.
    """
    B, H_q, T, D = q.shape
    H_kv = cache.k.shape[1]
    if H_q % H_kv:
        raise ValueError(f"GQA group {H_q}/{H_kv}: H_q must be a multiple "
                         f"of H_kv")
    if T > cache.window_size:
        raise ValueError(f"{T} draft tokens exceed the window "
                         f"{cache.window_size}")
    group = H_q // H_kv
    sc, W, ns = cache.sink_cap, cache.window_size, cache.num_sink
    dev = q.device
    kf, vf = cache.dequant_kv()
    kf = torch.cat([kf[:, :, :sc + W].float(), k_new.float()], dim=2)
    vf = torch.cat([vf[:, :, :sc + W].float(), v_new.float()], dim=2)

    sink_len, window_len, write_pos, seen = (
        x.long()[:, None] if isinstance(x, torch.Tensor) else int(x)
        for x in state)                                        # [B, 1]
    sink_idx = torch.arange(sc, device=dev)[None]
    age = (write_pos - 1 - torch.arange(W, device=dev)[None]) % W  # 0: newest
    new_pos = (seen + torch.arange(T, device=dev)[None]).expand(B, T)
    col_pos = torch.cat([sink_idx.expand(B, sc), (seen - 1 - age).expand(
        B, W), new_pos], dim=1)                                # [B, S]
    col_valid = torch.cat([(sink_idx < sink_len).expand(B, sc),
                           (age < window_len).expand(B, W),
                           torch.ones((B, T), dtype=torch.bool, device=dev)],
                          dim=1)
    causal = col_pos[:, None, :] <= new_pos[:, :, None]       # [B, T, S]
    # the always-attended term only for columns living in the sink region:
    # a ring token at a position < num_sink (a short prompt) is evicted by
    # age in sequential decode
    sink = torch.cat([(sink_idx < ns).expand(B, sc),
                      torch.zeros((B, W + T), dtype=torch.bool, device=dev)],
                     dim=1)[:, None, :]
    win = col_pos[:, None, :] >= new_pos[:, :, None] - W + 1
    mask = col_valid[:, None, :] & causal & (sink | win)

    qf = q.float().reshape(B, H_kv, group, T, D) * (1.0 / D ** 0.5)
    s = torch.einsum("bhgtd,bhsd->bhgts", qf, kf)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    if s_aux is not None:
        aux = s_aux.float().reshape(1, H_kv, group, 1, 1)
        s = torch.cat([s, aux.expand(B, H_kv, group, T, 1)], dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bhgts,bhsd->bhgtd", p[..., :kf.shape[2]] / denom, vf)
    return out.reshape(B, H_q, T, D).to(q.dtype)


def _cached_multi_attention(q, k_new, v_new, cache, s_aux=None):
    """The attention of :func:`sink_decode_attention_cached_multi` alone:
    ``cache`` (a ``SinkKVCache``, its state shared by the batch) is read,
    neither copied nor advanced."""
    return _multi_attention(q, k_new, v_new, cache,
                            (*cache_state(cache), cache.seen), s_aux)


def sink_decode_attention_cached_multi(q, k_new, v_new, cache, s_aux=None):
    """Multi-token decode attention over a ``SinkKVCache``: speculative
    decoding's verification.

    q/k_new/v_new: [B, H, T, D], the T draft tokens; ``cache`` holds the
    state before them. Returns ``(out [B, H_q, T, D], cache_after)``, where
    ``cache_after`` is a copy of ``cache`` with the drafts appended and
    ``cache`` itself is left as it was (the JAX op returns a new pure
    cache; the rollback state is the argument). The model's verify pass
    takes the attention alone, with no copy (``models.forward_verify``).
    Quantized caches are read dequantized. Requires T <= window_size.
    """
    out = _cached_multi_attention(q, k_new, v_new, cache, s_aux)
    return out, cache.clone().append_many(k_new, v_new)


def sink_decode_attention_ragged_multi(q, k_new, v_new, cache, s_aux=None):
    """Multi-token decode attention over a ``RaggedSinkKVCache``: every
    slot verifies its T drafts against its own pre-append ring view (its
    [B] state read on the device, no host sync). The cache is not
    advanced; the caller commits each slot's accepted prefix with
    ``append_many_counted``. A slot with no cached tokens attends only
    the drafts, causally (finite junk the engine's active mask drops).
    q/k_new/v_new: [B, H, T, D]; returns [B, H_q, T, D]."""
    return _multi_attention(q, k_new, v_new, cache,
                            (*cache_state(cache), cache.seen), s_aux)
