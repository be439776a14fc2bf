"""Differentiable sink flash attention on hand-written CUDA kernels.

Counterpart of ``sink_attention_tpu/ops/flash.py``. Three kernels (those of
``csrc/attention.cuh`` over its sink + window mask), each beside its plain
PyTorch version:

* ``csrc/flash_fwd.cu`` (replaces the TPU kernel ``_fwd_kernel``): O and
  LSE; plain version :func:`flash_fwd_plain`;
* ``csrc/flash_bwd.cu``, ``sink_dq_bf16`` (replaces ``_dq_kernel``) and
  ``sink_dkdv_bf16`` (replaces ``_dkdv_kernel``): dQ, and dK/dV summed over
  the GQA group; plain version of the pair :func:`flash_bwd_plain`.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises. :class:`_SinkAttention` ties them into one autograd function
(the JAX package's ``custom_vjp``): the backward's delta preprocess and
``ds_aux`` epilogue are plain torch, as they are jnp ops outside Pallas in
JAX.

The forward kernel (wgmma and TMA, ``csrc/hopper.cuh``) visits, for each
128-row query block, only the 128-key KV blocks of two ranges: the blocks
holding the sink columns, then the window blocks after them
(:func:`fwd_kv_ranges`, the Python mirror of the JAX package's
``_build_fwd_schedule``); the dQ kernel walks the same table at 64 x 64. The dK/dV kernel visits, for each
64-slot KV block, the query blocks of one range (:func:`dkdv_q_ranges`,
the mirror of ``_dkdv_q_step``). The tables are built on the host, so the
CPU tests check them although the kernels cannot run there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from .reference import _eager_attend, sink_window_mask

__all__ = ["sink_flash_attention", "sink_flash_attention_with_lse",
           "sink_flash_attention_chunk", "merge_partials",
           "attention_backward", "flash_fwd_kernel", "flash_fwd_plain",
           "flash_dq_kernel", "flash_dkdv_kernel", "flash_bwd_plain",
           "fwd_kv_ranges", "dkdv_q_ranges"]

BM = 64  # query rows per tile; must match csrc/flash_bwd.cu, packed.cu
BN = 64  # keys per KV tile; must match csrc/flash_bwd.cu, packed.cu
FWD_BM = 128  # the forward kernel's query rows per CTA (csrc/flash_fwd.cu)
FWD_BN = 128  # the forward kernel's keys per KV tile (csrc/flash_fwd.cu)
# Past the last query position a window is unbounded; clamp it there so the
# kernel's int32 position arithmetic cannot overflow.
_WINDOW_CLAMP = 1 << 30
_PLAIN_ROWS = 1024  # query rows per chunk of the plain versions


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def _fwd_kv_ranges_cached(n_q, n_kv, num_sink, window, q_offset, kv_offset,
                          bm, bn):
    n_q_blocks = _cdiv(n_q, bm)
    n_kv_blocks = _cdiv(n_kv, bn)
    n_kv_local = n_kv_blocks * bn
    if num_sink > 0:
        sink_lo = min(max(-kv_offset, 0), n_kv_local)
        sink_hi = min(max(num_sink - kv_offset, 0), n_kv_local)
        sink_b0, sink_b1 = sink_lo // bn, _cdiv(sink_hi, bn)
    else:
        sink_b0 = sink_b1 = 0
    table = np.zeros((n_q_blocks, 4), np.int32)
    for qi in range(n_q_blocks):
        g_row_start = q_offset + qi * bm
        win_glo = max(g_row_start - window + 1, num_sink)
        win_ghi = min(g_row_start + bm, q_offset + n_q)  # causal, exclusive
        # sink blocks whose columns this q block can see at all (causal)
        s_hi = min(sink_b1, max(_cdiv(win_ghi - kv_offset, bn), 0))
        s_b0, s_b1 = sink_b0, max(min(s_hi, n_kv_blocks), sink_b0)
        w_b0 = w_b1 = 0
        if win_ghi > win_glo:
            win_lo = min(max(win_glo - kv_offset, 0), n_kv_local)
            win_hi = min(max(win_ghi - kv_offset, 0), n_kv_local)
            w_b0 = max(win_lo // bn, sink_b1)
            w_b1 = max(min(_cdiv(win_hi, bn), n_kv_blocks), w_b0)
        table[qi] = (s_b0, s_b1, w_b0, w_b1)
    table.setflags(write=False)
    return table


def fwd_kv_ranges(n_q: int, n_kv: int, num_sink: int, window: int,
                  q_offset: int = 0, kv_offset: int = 0, bm: int = BM,
                  bn: int = BN) -> np.ndarray:
    """int32 [ceil(n_q / bm), 4]: per query block of ``bm`` rows, the KV
    blocks of ``bn`` keys it visits, as two half-open ranges (sink_b0,
    sink_b1) then (win_b0, win_b1).

    The sink range covers the local blocks of global columns [0, num_sink);
    the window range starts after it, so no block is visited twice. Both
    are cut to the causal end of the query block and to [0, n_kv blocks).
    The dQ and ablation kernels take the default 64 x 64 tiles, the forward
    kernel ``bm=FWD_BM, bn=FWD_BN``.
    """
    return _fwd_kv_ranges_cached(int(n_q), int(n_kv), int(num_sink),
                                 int(window), int(q_offset), int(kv_offset),
                                 int(bm), int(bn))


@functools.lru_cache(maxsize=256)
def _dkdv_q_ranges_cached(n_q, n_kv, num_sink, window, q_offset, kv_offset):
    n_q_blocks = _cdiv(n_q, BM)
    table = np.zeros((_cdiv(n_kv, BN), 2), np.int32)
    for ni in range(table.shape[0]):
        c_lo = kv_offset + ni * BN                       # global columns
        c_hi = kv_offset + min((ni + 1) * BN, n_kv) - 1  # of the real slots
        if c_hi < 0:
            continue  # all before the sequence start: read by no query
        c_lo = max(c_lo, 0)
        b0 = min(max((c_lo - q_offset) // BM, 0), n_q_blocks)  # causal
        if num_sink > 0 and c_lo < num_sink:
            b1 = n_q_blocks  # sink columns: every later query reads them
        else:  # the last query whose window reaches column c_hi
            b1 = min((c_hi + window - 1 - q_offset) // BM + 1, n_q_blocks)
        table[ni] = (b0, max(b1, b0))
    table.setflags(write=False)
    return table


def dkdv_q_ranges(n_q: int, n_kv: int, num_sink: int, window: int,
                  q_offset: int = 0, kv_offset: int = 0) -> np.ndarray:
    """int32 [ceil(n_kv / BN), 2]: per KV block, the half-open range of
    query blocks that read it.

    Decided per block, as the JAX package's ``_dkdv_q_step`` with
    ``sink_pass=None``: a block holding global sink columns is read by
    every query block from its causal start on; any other block only up to
    the last query whose window reaches its last column. Blocks wholly
    before the sequence start (negative ``kv_offset``) are read by none.
    So chunked and halo offsets need no static sink/window split.
    """
    return _dkdv_q_ranges_cached(int(n_q), int(n_kv), int(num_sink),
                                 int(window), int(q_offset), int(kv_offset))


def _visible(n_q, n_kv, num_sink, window, q_offset, kv_offset, device):
    """The kernels' mask: the sink + window mask on global positions, and
    no column before the sequence start (a halo's leading slots)."""
    mask = sink_window_mask(n_q, n_kv, num_sink, window, q_offset,
                            kv_offset, device=device)
    return mask & (torch.arange(n_kv, device=device) + kv_offset >= 0)


def flash_fwd_plain(q, k, v, s_aux=None, num_sink: int = 4,
                    window_size: int = 512, q_offset: int = 0,
                    kv_offset: int = 0):
    """The kernel's plain PyTorch version: (out [B,H_q,N_q,D] in q.dtype,
    lse [B,H_q,N_q] fp32), the eager oracle taken over query chunks of
    1024 rows so that its [.., rows, N_kv] score block stays bounded at
    long N."""
    n_kv = k.shape[2]
    return fwd_plain_chunks(q, k, v, s_aux, lambda r0, n: _visible(
        n, n_kv, num_sink, window_size, q_offset + r0, kv_offset,
        q.device)[None, None])


def fwd_plain_chunks(q, k, v, s_aux, chunk_mask):
    """(out, lse) of the eager oracle over query chunks of 1024 rows;
    ``chunk_mask(r0, n)`` is the mask of rows [r0, r0 + n), bool
    [B|1, 1, n, N_kv]."""
    outs, lses = [], []
    for r0 in range(0, max(q.shape[2], 1), _PLAIN_ROWS):
        qc = q[:, :, r0:r0 + _PLAIN_ROWS]
        o, lse = _eager_attend(qc, k, v, chunk_mask(r0, qc.shape[2]), s_aux,
                               True)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def flash_bwd_plain(q, k, v, do, lse, delta, num_sink: int = 4,
                    window_size: int = 512, q_offset: int = 0,
                    kv_offset: int = 0):
    """The plain PyTorch version of the two backward kernels: (dq in
    q.dtype, dk in k.dtype, dv in v.dtype) from the same inputs.

    The kernels' formulas written out in fp32 over query chunks of 1024
    rows: P = exp(S - LSE) recomputed (0 where masked), dP = dO V^T,
    dS = P (dP - delta), dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO,
    dK and dV summed over each GQA group. ``lse`` [B,H_q,N_q] fp32 is the
    forward's (it counts s_aux, so P is the true probability); ``delta``
    [B,H_q,N_q] fp32 is sum_d dO * O, less the LSE cotangent if any.
    """
    n_kv = k.shape[2]
    return bwd_plain_chunks(q, k, v, do, lse, delta, lambda r0, n: _visible(
        n, n_kv, num_sink, window_size, q_offset + r0, kv_offset, q.device))


def bwd_plain_chunks(q, k, v, do, lse, delta, chunk_mask):
    """(dq, dk, dv) of :func:`flash_bwd_plain`'s formulas under the mask
    ``chunk_mask(r0, n)`` of rows [r0, r0 + n), bool broadcastable to
    [B, H_q, n, N_kv]."""
    B, H_q, N_q, D = q.shape
    H_kv, N_kv = k.shape[1], k.shape[2]
    group = H_q // H_kv
    scale = 1.0 / (D ** 0.5)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    dk = torch.zeros(B, H_q, N_kv, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for r0 in range(0, max(N_q, 1), _PLAIN_ROWS):
        rows = slice(r0, r0 + _PLAIN_ROWS)
        qc, doc = q[:, :, rows].float(), do[:, :, rows].float()
        mask = chunk_mask(r0, qc.shape[2])
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale
        p = torch.where(mask, torch.exp(s - lse[:, :, rows, None]), 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", doc, vf)
        ds = p * (dp - delta[:, :, rows, None])
        dqs.append(torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, doc)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc) * scale
    dk = dk.reshape(B, H_kv, group, N_kv, D).sum(dim=2)
    dv = dv.reshape(B, H_kv, group, N_kv, D).sum(dim=2)
    return (torch.cat(dqs, dim=2).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def load_fn(source: str, name: str, n_ptrs: int, n_ints: int = 10):
    """``name`` of the library of ``csrc/<source>.cu``, with its argtypes:
    ``n_ptrs`` pointers, ``n_ints`` ints, the scale and the stream."""
    fn = getattr(_build.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints +
                   [ctypes.c_float, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib = _build.load("flash_fwd")
    if (lib.sink_fwd_block_m(), lib.sink_fwd_block_n()) != (FWD_BM, FWD_BN):
        raise RuntimeError("csrc/flash_fwd.cu and ops/flash.py disagree on "
                           "the tile sizes")
    return load_fn("flash_fwd", "sink_fwd_bf16", 7)


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    lib = _build.load("flash_bwd")
    if (lib.sink_bwd_block_m(), lib.sink_bwd_block_n()) != (BM, BN):
        raise RuntimeError("csrc/flash_bwd.cu and ops/flash.py disagree on "
                           "the tile sizes")
    return (load_fn("flash_bwd", "sink_dq_bf16", 8),
            load_fn("flash_bwd", "sink_dkdv_bf16", 9))


@functools.lru_cache(maxsize=256)
def _table_on(table_fn, device, *key) -> torch.Tensor:
    """The host table ``table_fn(*key)`` on ``device``, copied there once."""
    return torch.from_numpy(np.array(table_fn(*key))).to(device)


def _geometry(q, k, v, num_sink, window_size, q_offset, kv_offset):
    """Shape checks shared by the kernels' wrappers; returns the dims and
    the int geometry the kernels take."""
    if not q.is_cuda:
        raise ValueError("the CUDA attention kernels take CUDA tensors")
    B, H_q, N_q, D = q.shape
    _, H_kv, N_kv, _ = k.shape
    if H_q % H_kv or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    geom = (min(int(num_sink), _WINDOW_CLAMP),
            min(int(window_size), _WINDOW_CLAMP), int(q_offset),
            int(kv_offset))
    return (B, H_q, H_kv, N_q, N_kv, D), geom


def flash_fwd_kernel(q, k, v, s_aux=None, num_sink: int = 4,
                     window_size: int = 512, q_offset: int = 0,
                     kv_offset: int = 0):
    """Launch ``csrc/flash_fwd.cu`` (the wgmma/TMA kernel of
    ``csrc/hopper.cuh``) on CUDA tensors: (out, lse).

    q [B,H_q,N_q,D], k/v [B,H_kv,N_kv,D] bf16 with D in (64, 128);
    s_aux [H_q] or None. ``flash_fwd_kernel.launches`` counts the launches.
    A warmed call (its range table already on the card) synchronises
    nothing.
    """
    _build.check_attention_inputs(q, k, v, s_aux)
    dims, geom = _geometry(q, k, v, num_sink, window_size, q_offset,
                           kv_offset)
    B, H_q, H_kv, N_q, N_kv, D = dims
    ranges = _table_on(fwd_kv_ranges, q.device, N_q, N_kv, *geom, FWD_BM,
                       FWD_BN)
    qc, kc, vc = (_build.aligned(t) for t in (q, k, v))
    aux = (s_aux.detach().float().contiguous() if s_aux is not None
           else None)
    out = torch.empty_like(qc)
    lse = torch.empty((B, H_q, N_q), dtype=torch.float32, device=q.device)
    ptrs = [_build.ptr(t) for t in (qc, kc, vc, aux, ranges, out, lse)]
    code = _kernel_fn()(*ptrs, *dims, *geom, 1.0 / (D ** 0.5),
                        _build.stream_ptr(q.device))
    _build.check(code, "sink_fwd_bf16")
    flash_fwd_kernel.launches += 1
    return out, lse


flash_fwd_kernel.launches = 0


def _bwd_operands(q, k, v, do, lse, delta):
    """The backward kernels' checks and operands: contiguous, aligned q, k,
    v, dO (bf16) and lse, delta (fp32 [B,H_q,N_q])."""
    _build.check_attention_inputs(q, k, v, None)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must match q: {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {tuple(q.shape[:3])}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    return [_build.aligned(t) for t in (q, k, v, do, lse, delta)]


def flash_dq_kernel(q, k, v, do, lse, delta, num_sink: int = 4,
                    window_size: int = 512, q_offset: int = 0,
                    kv_offset: int = 0):
    """Launch ``sink_dq_bf16`` of ``csrc/flash_bwd.cu``: dq [B,H_q,N_q,D]
    bf16. Inputs as :func:`flash_bwd_plain`'s, on the card, bf16 q/k/v/dO
    with D in (64, 128). ``flash_dq_kernel.launches`` counts the launches.
    """
    ops = _bwd_operands(q, k, v, do, lse, delta)
    dims, geom = _geometry(q, k, v, num_sink, window_size, q_offset,
                           kv_offset)
    ranges = _table_on(fwd_kv_ranges, q.device, dims[3], dims[4], *geom)
    dq = torch.empty_like(ops[0])
    ptrs = [_build.ptr(t) for t in (*ops, ranges, dq)]
    code = _bwd_fns()[0](*ptrs, *dims, *geom, 1.0 / (dims[5] ** 0.5),
                         _build.stream_ptr(q.device))
    _build.check(code, "sink_dq_bf16")
    flash_dq_kernel.launches += 1
    return dq


flash_dq_kernel.launches = 0


def flash_dkdv_kernel(q, k, v, do, lse, delta, num_sink: int = 4,
                      window_size: int = 512, q_offset: int = 0,
                      kv_offset: int = 0):
    """Launch ``sink_dkdv_bf16`` of ``csrc/flash_bwd.cu``: (dk, dv)
    [B,H_kv,N_kv,D] bf16, summed over each GQA group inside the kernel.
    Inputs as :func:`flash_dq_kernel`'s. ``flash_dkdv_kernel.launches``
    counts the launches."""
    ops = _bwd_operands(q, k, v, do, lse, delta)
    dims, geom = _geometry(q, k, v, num_sink, window_size, q_offset,
                           kv_offset)
    ranges = _table_on(dkdv_q_ranges, q.device, dims[3], dims[4], *geom)
    dk, dv = torch.empty_like(ops[1]), torch.empty_like(ops[2])
    ptrs = [_build.ptr(t) for t in (*ops, ranges, dk, dv)]
    code = _bwd_fns()[1](*ptrs, *dims, *geom, 1.0 / (dims[5] ** 0.5),
                         _build.stream_ptr(q.device))
    _build.check(code, "sink_dkdv_bf16")
    flash_dkdv_kernel.launches += 1
    return dk, dv


flash_dkdv_kernel.launches = 0


def _fwd(q, k, v, s_aux, num_sink, window_size, q_offset, kv_offset):
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, s_aux, num_sink, window_size,
                               q_offset, kv_offset)
    if q.is_cuda:
        return flash_fwd_kernel(q, k, v, s_aux, num_sink, window_size,
                                q_offset, kv_offset)
    raise ValueError(f"unsupported device {q.device}")


def _dqkv(q, k, v, do, lse, delta, num_sink, window_size, q_offset,
          kv_offset):
    """(dq, dk, dv): the plain version on the CPU, the two kernels on the
    card."""
    args = (num_sink, window_size, q_offset, kv_offset)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, *args)
    if q.is_cuda:
        dq = flash_dq_kernel(q, k, v, do, lse, delta, *args)
        return (dq, *flash_dkdv_kernel(q, k, v, do, lse, delta, *args))
    raise ValueError(f"unsupported device {q.device}")


def attention_backward(q, k, v, s_aux, o, lse, do, dlse=None,
                       num_sink: int = 4, window_size: int = 512,
                       q_offset: int = 0, kv_offset: int = 0, dqkv=None):
    """Gradients (dq, dk, dv, ds_aux or None) of the attention whose
    forward gave (o, lse), for the cotangents dO and (optionally) dLSE.

    The delta preprocess and the ds_aux epilogue are plain torch (JAX
    ``_bwd_impl``); ``dqkv`` computes (dq, dk, dv) from (q, k, v, dO, lse,
    delta, geometry), by default the kernels on the card and their plain
    version on the CPU. An LSE cotangent folds into delta: d lse / d s_j
    is p_j, so dS_j = p_j (dP_j - (delta - dlse)); the same fold gives
    ds_aux = -sum p_aux (delta - dlse).
    """
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    dq, dk, dv = (dqkv or _dqkv)(q, k, v, do, lse, delta, num_sink,
                                 window_size, q_offset, kv_offset)
    ds_aux = None
    if s_aux is not None:
        sink_prob = torch.exp(s_aux.float()[None, :, None] - lse)
        ds_aux = -(sink_prob * delta).sum(dim=(0, 2)).to(s_aux.dtype)
    return dq, dk, dv, ds_aux


class _SinkAttention(torch.autograd.Function):
    """(out, lse) of sink attention, differentiable in q, k, v, s_aux and
    through both outputs (the JAX package's ``_sink_attn`` and
    ``_sink_attn_chunk`` custom_vjps in one).

    The forward's LSE already counts s_aux (m seeded with s_aux, l = 1), so
    P = exp(S - LSE) recomputed in the backward is the true probability
    and the dQ and dK/dV kernels need no s_aux term. Nothing is kept
    between calls but what ``save_for_backward`` holds, so a layer
    recomputed under activation checkpointing runs the forward anew.
    """

    @staticmethod
    def forward(ctx, q, k, v, s_aux, num_sink, window_size, q_offset,
                kv_offset):
        o, lse = _fwd(q, k, v, s_aux, num_sink, window_size, q_offset,
                      kv_offset)
        ctx.save_for_backward(q, k, v, s_aux, o, lse)
        ctx.geometry = (num_sink, window_size, q_offset, kv_offset)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, s_aux, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv, ds_aux = attention_backward(q, k, v, s_aux, o, lse, do,
                                                dlse, *ctx.geometry)
        if not ctx.needs_input_grad[3]:
            ds_aux = None
        return dq, dk, dv, ds_aux, None, None, None, None


def _attention(q, k, v, s_aux, num_sink, window_size, q_offset, kv_offset):
    """(out, lse): through the autograd function where a gradient is
    wanted, else the forward alone."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, s_aux)):
        return _SinkAttention.apply(q, k, v, s_aux, num_sink, window_size,
                                    q_offset, kv_offset)
    return _fwd(q, k, v, s_aux, num_sink, window_size, q_offset, kv_offset)


def sink_flash_attention(q, k, v, num_sink: int = 4, window_size: int = 512,
                         s_aux=None, q_offset: int = 0, kv_offset: int = 0):
    """Flash attention with attention-sink support (differentiable).

    Args:
        q: [B, H_q, N_q, D]; k, v: [B, H_kv, N_kv, D] (GQA/MQA supported).
        num_sink: always-attended leading (global) tokens.
        window_size: causal sliding window (includes self).
        s_aux: optional [H_q] learnable per-head sink logit (gpt-oss).
        q_offset / kv_offset: global position offsets for chunked use.

    Returns:
        [B, H_q, N_q, D] in q.dtype. On CUDA the forward kernel runs, and
        the dQ and dK/dV kernels in the backward.
    """
    return _attention(q, k, v, s_aux, num_sink, window_size, q_offset,
                      kv_offset)[0]


def sink_flash_attention_with_lse(q, k, v, num_sink: int = 4,
                                  window_size: int = 512, s_aux=None,
                                  q_offset: int = 0, kv_offset: int = 0):
    """(out, lse [B,H_q,N_q] fp32, natural log) for partial merging,
    differentiable through both."""
    return _attention(q, k, v, s_aux, num_sink, window_size, q_offset,
                      kv_offset)


def sink_flash_attention_chunk(q, k, v, offsets, num_sink: int = 4,
                               window_size: int = 512):
    """Rectangular chunk attention at ``offsets = (q_offset, kv_offset)``:
    (out, lse) partials for :func:`merge_partials`.

    Takes no s_aux: it is folded in at merge time, so it counts once
    across chunks. ``kv_offset`` may be negative (a halo whose leading
    slots precede the sequence: they are attended by no query and get zero
    gradient). Differentiable in both outputs: the LSE cotangent of a
    downstream merge folds into the backward's delta.
    """
    q_offset, kv_offset = (int(x) for x in offsets)
    return _attention(q, k, v, None, num_sink, window_size, q_offset,
                      kv_offset)


def merge_partials(outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor],
                   s_aux: Optional[torch.Tensor] = None):
    """Merge online-softmax partials: lists of (o [B,H,N,D], lse [B,H,N]).

    Each partial is normalised by its own lse. ``s_aux`` joins as a virtual
    partial with (lse = s_aux, o = 0).
    """
    if len(outs) != len(lses) or not outs:
        raise ValueError("need >= 1 partial and one lse per output")
    lse_stack = torch.stack([l.float() for l in lses])  # [S, B, H, N]
    if s_aux is not None:
        aux = s_aux.float()[None, :, None].expand(lse_stack.shape[1:])
        lse_stack = torch.cat([lse_stack, aux[None]], dim=0)
    m = lse_stack.amax(dim=0)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse_stack - m_safe[None])
    denom = w.sum(dim=0)
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o_stack = torch.stack([o.float() for o in outs])
    out = torch.einsum("sbhn,sbhnd->bhnd", w[:len(outs)], o_stack) / (
        denom_safe[..., None])
    lse_out = m_safe + torch.log(denom_safe)
    lse_out = lse_out.masked_fill(denom == 0.0, float("-inf"))
    return out.to(outs[0].dtype), lse_out
