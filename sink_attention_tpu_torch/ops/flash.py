"""Differentiable sink flash attention on hand-written CUDA kernels.

Counterpart of ``sink_attention_tpu/ops/flash.py``. Three kernels over the
sink + window mask of ``csrc/attention.cuh``, each beside its plain PyTorch
version:

* ``csrc/flash_fwd.cu`` (replaces the TPU kernel ``_fwd_kernel``): O and
  LSE; plain version :func:`flash_fwd_plain`;
* ``csrc/flash_bwd.cu``, ``sink_dq`` (replaces ``_dq_kernel``) and
  ``sink_dkdv`` (replaces ``_dkdv_kernel``): dQ, and dK/dV summed over
  the GQA group; plain version of the pair :func:`flash_bwd_plain`.

The kernels take any head_dim and bf16, fp16 or fp32 inputs, as the JAX
kernels take any head_dim and float type. A head_dim D <= 512 runs in the
instance of D_i = 64, 128, 256 or 512 (``_build.kernel_head_dim``, the key
of the host tables), except D 65-80 and 81-96, which run in narrow
instances of 80 and 96 columns on the 128 instance's tiles (each library
reports the instance it runs, ``_build.instance_of``; the wrappers'
``instances``); any D past 512 runs in the one wide instance
(``csrc/hopper_wide.cuh``: its depth and its 512-column output slices
counted at run time; tables keyed ``_build.WIDE_INSTANCE``). The columns past D read as zeros and are not
written, so no padded copy is made for D % 8 == 0; any other D (100: 3200
over 32 heads) takes a zero-padded copy to the next multiple of 8 (TMA's
16-byte rows; ``padded_copies`` counts them) and its outputs are sliced
back, as JAX's ``_prep`` pads outside its kernels. fp32 inputs are rounded
to bf16 once on the way in and the outputs written as fp32 from the
kernels' fp32 accumulators: what the TPU's matrix unit does with fp32 at
its default precision, held to JAX's TPU tolerances (6e-3 forward, 2e-3
backward).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises. :class:`_SinkAttention` ties them into one autograd function
(the JAX package's ``custom_vjp``): the backward's delta preprocess and
``ds_aux`` epilogue are plain torch, as they are jnp ops outside Pallas in
JAX.

The forward kernel (wgmma and TMA, ``csrc/hopper.cuh``) visits, for each
128-row query block, only the KV blocks of two ranges: the blocks holding
the sink columns, then the window blocks after them (:func:`fwd_kv_ranges`
at ``bn=FWD_BNS[head_dim]``: 128 keys, 64 in the 256 and wide instances, 32
in the 512 instance; the 512 and wide instances' items are the blocks'
64-row halves; the Python mirror of the JAX package's
``_build_fwd_schedule``). The dQ kernel (wgmma and TMA,
``csrc/hopper_dq.cuh``) walks the same two ranges at ``bm=DQ_BM,
bn=DQ_BN[head_dim]`` (128 rows x 128 keys at D = 64, x 64 keys at D = 128,
x 32 at D = 256, 512 and wide), the q blocks with the most KV blocks first
(:func:`dq_block_order`). The dK/dV kernel (wgmma and TMA,
``csrc/hopper_bwd.cuh``) visits, for each KV block of
``DKDV_BNS[head_dim]`` slots (128, 64 in the 256, 512 and wide instances),
the 64-row query blocks of one range (:func:`dkdv_q_ranges` at
``bm=DKDV_BM``, the mirror of ``_dkdv_q_step``), each range cut into pieces
of at most :func:`dkdv_piece_cap` q blocks (only a block holding sink
columns, which every later query reads, is longer), the split blocks'
pieces first, then the others, longest first (:func:`dkdv_piece_table`);
a split block's pieces run on different CTAs and meet in the launch, their
fp32 partials summed in piece order through the stream's workspace
(:func:`dkdv_workspace`). Tables keyed on a head dim key on its instance
(``_build.kernel_head_dim``). The tables are built on the host, so the CPU
tests check them although the kernels cannot run there.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build
from .reference import _eager_attend, rounded, sink_window_mask

__all__ = ["sink_flash_attention", "sink_flash_attention_with_lse",
           "sink_flash_attention_chunk", "merge_partials",
           "attention_backward", "flash_fwd_kernel", "flash_fwd_plain",
           "flash_dq_kernel", "flash_dkdv_kernel", "flash_bwd_plain",
           "fwd_kv_ranges", "dq_block_order", "dkdv_q_ranges",
           "dkdv_block_order", "dkdv_piece_cap", "dkdv_pieces",
           "dkdv_piece_table"]

FWD_BM = 128  # the forward kernels' query rows per item (csrc/hopper.cuh)
# their keys per KV tile by instance head dim (FwdPlan there; a head dim's
# instance is _build.kernel_head_dim; key 513 the wide instance, D > 512,
# csrc/hopper_wide.cuh)
FWD_BNS = {64: 128, 128: 128, 256: 64, 512: 32, _build.WIDE_INSTANCE: 64}
DQ_BM = 128  # the dQ kernel's query rows per work item (csrc/hopper_dq.cuh)
# its keys per KV tile by instance head dim (dq_bn there)
DQ_BN = {64: 128, 128: 64, 256: 32, 512: 32, _build.WIDE_INSTANCE: 32}
DKDV_BM = 64   # the dK/dV kernel's query rows per tile (csrc/hopper_bwd.cuh)
# its keys per work item by instance head dim (dkdv_bn there)
DKDV_BNS = {64: 128, 128: 128, 256: 64, 512: 64, _build.WIDE_INSTANCE: 64}
# The least cap of a dK/dV piece, in q blocks (dkdv_piece_cap), and the
# ints of a row of the piece table (csrc/hopper_bwd.cuh's PIECE_INTS)
DKDV_PIECE_FLOOR = 4
DKDV_PIECE_INTS = 8
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
                  q_offset: int, kv_offset: int, bm: int,
                  bn: int) -> np.ndarray:
    """int32 [ceil(n_q / bm), 4]: per query block of ``bm`` rows, the KV
    blocks of ``bn`` keys it visits, as two half-open ranges (sink_b0,
    sink_b1) then (win_b0, win_b1).

    The sink range covers the local blocks of global columns [0, num_sink);
    the window range starts after it, so no block is visited twice. Both
    are cut to the causal end of the query block and to [0, n_kv blocks).
    The forward kernels take ``bm=FWD_BM, bn=FWD_BNS[head_dim]`` (the
    ablation's stages its 128), the dQ kernel ``bm=DQ_BM,
    bn=DQ_BN[head_dim]``.
    """
    return _fwd_kv_ranges_cached(int(n_q), int(n_kv), int(num_sink),
                                 int(window), int(q_offset), int(kv_offset),
                                 int(bm), int(bn))


def dq_block_order(n_q: int, n_kv: int, num_sink: int, window: int,
                   q_offset: int, kv_offset: int, bm: int,
                   bn: int) -> np.ndarray:
    """int32 [ceil(n_q / bm)]: the query blocks of :func:`fwd_kv_ranges`,
    most KV blocks first (ties in block order): the order in which the dQ
    kernel's persistent CTAs take them, each block across every (batch,
    head) before the next."""
    table = fwd_kv_ranges(n_q, n_kv, num_sink, window, q_offset, kv_offset,
                          bm, bn)
    lengths = table[:, 1] - table[:, 0] + table[:, 3] - table[:, 2]
    return np.argsort(-lengths, kind="stable").astype(np.int32)


@functools.lru_cache(maxsize=256)
def _dkdv_q_ranges_cached(n_q, n_kv, num_sink, window, q_offset, kv_offset,
                          bm, bn):
    n_q_blocks = _cdiv(n_q, bm)
    table = np.zeros((_cdiv(n_kv, bn), 2), np.int32)
    for ni in range(table.shape[0]):
        c_lo = kv_offset + ni * bn                       # global columns
        c_hi = kv_offset + min((ni + 1) * bn, n_kv) - 1  # of the real slots
        if c_hi < 0:
            continue  # all before the sequence start: read by no query
        c_lo = max(c_lo, 0)
        b0 = min(max((c_lo - q_offset) // bm, 0), n_q_blocks)  # causal
        if num_sink > 0 and c_lo < num_sink:
            b1 = n_q_blocks  # sink columns: every later query reads them
        else:  # the last query whose window reaches column c_hi
            b1 = min((c_hi + window - 1 - q_offset) // bm + 1, n_q_blocks)
        table[ni] = (b0, max(b1, b0))
    table.setflags(write=False)
    return table


def dkdv_q_ranges(n_q: int, n_kv: int, num_sink: int, window: int,
                  q_offset: int, kv_offset: int, bm: int,
                  bn: int) -> np.ndarray:
    """int32 [ceil(n_kv / bn), 2]: per KV block of ``bn`` keys, the
    half-open range of query blocks of ``bm`` rows that read it.

    Decided per block, as the JAX package's ``_dkdv_q_step`` with
    ``sink_pass=None``: a block holding global sink columns is read by
    every query block from its causal start on; any other block only up to
    the last query whose window reaches its last column. Blocks wholly
    before the sequence start (negative ``kv_offset``) are read by none.
    So chunked and halo offsets need no static sink/window split. The
    dK/dV kernel takes ``bm=DKDV_BM, bn=DKDV_BNS[head_dim]``.
    """
    return _dkdv_q_ranges_cached(int(n_q), int(n_kv), int(num_sink),
                                 int(window), int(q_offset), int(kv_offset),
                                 int(bm), int(bn))


def dkdv_block_order(n_q: int, n_kv: int, num_sink: int, window: int,
                     q_offset: int, kv_offset: int, bm: int,
                     bn: int) -> np.ndarray:
    """int32 [ceil(n_kv / bn)]: the KV blocks of :func:`dkdv_q_ranges`,
    longest query-block range first (ties in block order): the order of
    :func:`dkdv_piece_table`'s ties. Longest first alone cannot keep a
    block whose range is longer than a CTA's share of the call (a sink
    block beside a short window) from setting the call's time: the piece
    table cuts it."""
    table = dkdv_q_ranges(n_q, n_kv, num_sink, window, q_offset, kv_offset,
                          bm, bn)
    return np.argsort(table[:, 0] - table[:, 1], kind="stable").astype(
        np.int32)


def dkdv_piece_cap(bn: int, window: int, bm: int = DKDV_BM) -> int:
    """The most q blocks of ``bm`` rows a dK/dV piece takes: the longest
    range that a key block of ``bn`` keys without sink columns can have at
    any offset (its first column's q block to the last whose window
    reaches its last column), and no less than ``DKDV_PIECE_FLOOR`` (4:
    measured against 8 on gpt-oss-20b's W = 128 layer with 4 sinks, 12%
    faster, the other rows within spread; half this cap was 10-35% slower,
    the merges of more pieces). Only a block that holds sink columns can
    be longer; at a window as long as the sequence no block is."""
    return max(DKDV_PIECE_FLOOR, _cdiv(bn + window - 1, bm) + 1)


def dkdv_pieces(qb0: torch.Tensor, qb1: torch.Tensor, order: torch.Tensor,
                cap: int, most: int) -> torch.Tensor:
    """The dK/dV kernel's piece table, int32 [1 + U * most, 8], built with
    tensor ops on the inputs' device (no synchronisation).

    ``qb0``, ``qb1`` [U]: each work unit's (key block's) half-open range
    of q blocks; ``order`` [U]: the units, longest range first; ``most``:
    at least the pieces of the longest unit (ceil(n_q_blocks / cap)). A
    unit whose range is longer than ``cap`` is cut into np = ceil(n /
    cap) pieces of consecutive q blocks (the first n % np one longer);
    any other is one piece. Row 0 is (pieces, partial slots, 0, ...); then
    one row a piece: the split units' pieces first, then the others, each
    longest first (ties in ``order``, then piece index): (unit, q0, q1,
    np, piece index, first slot of its unit, 0, 0). A split unit's last
    piece merges the partials, so its pieces start in the first round and
    the merge overlaps the other units' work. The pieces of a split unit
    take np consecutive slots of the workspace's partials; an unsplit unit
    takes none. Rows past the count are padding."""
    dev = qb0.device
    u = order.long()
    n = (qb1.long() - qb0.long())[u].clamp(min=0)
    n_p = torch.where(n > cap, torch.div(n + cap - 1, cap,
                                         rounding_mode="floor"), 1)
    base = torch.div(n, n_p, rounding_mode="floor")
    extra = n - base * n_p
    i = torch.arange(most, device=dev)[None]
    length = base[:, None] + (i < extra[:, None]).long()
    start = qb0.long()[u][:, None] + i * base[:, None] + torch.minimum(
        i, extra[:, None])
    slots = torch.where(n_p > 1, n_p, 0)
    first = torch.cumsum(slots, 0) - slots
    valid = i < n_p[:, None]
    key = torch.where(valid, length + (cap + 1) * (n_p[:, None] > 1),
                      -1).flatten()
    rank = torch.argsort(-key, stable=True)
    cols = [u[:, None].expand(-1, most), start, start + length,
            n_p[:, None].expand(-1, most), i.expand(len(u), -1),
            first[:, None].expand(-1, most)]
    rows = torch.stack([c.flatten() for c in cols], dim=-1)[rank]
    table = torch.zeros(1 + rows.shape[0], DKDV_PIECE_INTS,
                        dtype=torch.int32, device=dev)
    table[1:, :6] = rows.int()
    table[0, 0] = valid.sum()
    table[0, 1] = slots.sum()
    return table


@functools.lru_cache(maxsize=256)
def _dkdv_piece_table_cached(n_q, n_kv, num_sink, window, q_offset,
                             kv_offset, bm, bn):
    key = (n_q, n_kv, num_sink, window, q_offset, kv_offset, bm, bn)
    ranges = torch.from_numpy(np.array(dkdv_q_ranges(*key)))
    cap = dkdv_piece_cap(bn, window, bm)
    table = dkdv_pieces(ranges[:, 0], ranges[:, 1],
                        torch.from_numpy(dkdv_block_order(*key)), cap,
                        max(1, _cdiv(_cdiv(n_q, bm), cap)))
    table = table[:1 + int(table[0, 0])].numpy()
    table.setflags(write=False)
    return table


def dkdv_piece_table(n_q: int, n_kv: int, num_sink: int, window: int,
                     q_offset: int, kv_offset: int, bm: int,
                     bn: int) -> np.ndarray:
    """int32 [1 + pieces, 8]: :func:`dkdv_pieces` of the key blocks of
    :func:`dkdv_q_ranges` in the order of :func:`dkdv_block_order`, at
    the cap of :func:`dkdv_piece_cap`, cut to its pieces: the table the
    dK/dV kernel's persistent CTAs walk, in a snake (a key block that
    holds sink columns is read by every later q block; cut, its pieces
    spread over the card instead of one CTA setting the call's time)."""
    return _dkdv_piece_table_cached(int(n_q), int(n_kv), int(num_sink),
                                    int(window), int(q_offset),
                                    int(kv_offset), int(bm), int(bn))


@functools.lru_cache(maxsize=None)
def _dkdv_partial_sizes(d_pad: int):
    """(floats of a partial row, counters of a pair) at padded head dim
    ``d_pad``: a partial row holds every dK and dV accumulator of an item
    (2 x keys x columns, the wide instance's columns whole 512-column
    slices), a pair one counter per merged result (4, or 4 a slice)."""
    d_i = _build.kernel_head_dim(d_pad)
    slices = _cdiv(d_pad, 512) if d_i == _build.WIDE_INSTANCE else 1
    cols = 512 * slices if d_i == _build.WIDE_INSTANCE else d_i
    return 2 * DKDV_BNS[d_i] * cols, 4 * slices


def dkdv_workspace(device, stream: int, n_rows: int, n_pairs: int,
                   d_pad: int):
    """The dK/dV kernel's workspace pointers on ``stream`` (the stream's
    ``_build.workspace``) for ``n_rows`` partial rows (slots x work units a
    piece) and ``n_pairs`` (key block, batch x KV head) pairs at padded
    head dim ``d_pad``."""
    row, per_pair = _dkdv_partial_sizes(d_pad)
    return _build.workspace(device, stream, n_rows * row, n_pairs * per_pair)


def _visible(n_q, n_kv, num_sink, window, q_offset, kv_offset, device):
    """The kernels' mask: the sink + window mask on global positions, and
    no column before the sequence start (a halo's leading slots)."""
    mask = sink_window_mask(n_q, n_kv, num_sink, window, q_offset,
                            kv_offset, device=device)
    return mask & (torch.arange(n_kv, device=device) + kv_offset >= 0)


def flash_fwd_plain(q, k, v, s_aux=None, num_sink: int = 4,
                    window_size: int = 512, q_offset: int = 0,
                    kv_offset: int = 0, matmul_dtype=None):
    """The kernel's plain PyTorch version: (out [B,H_q,N_q,D] in q.dtype,
    lse [B,H_q,N_q] fp32), the eager oracle taken over query chunks of
    1024 rows so that its [.., rows, N_kv] score block stays bounded at
    long N. With ``matmul_dtype`` (torch.bfloat16: the fp32 kernels'
    precision) the products read their operands rounded to it."""
    n_kv = k.shape[2]
    return fwd_plain_chunks(q, k, v, s_aux, lambda r0, n: _visible(
        n, n_kv, num_sink, window_size, q_offset + r0, kv_offset,
        q.device)[None, None], matmul_dtype)


def fwd_plain_chunks(q, k, v, s_aux, chunk_mask, matmul_dtype=None):
    """(out, lse) of the eager oracle over query chunks of 1024 rows;
    ``chunk_mask(r0, n)`` is the mask of rows [r0, r0 + n), bool
    [B|1, 1, n, N_kv]."""
    outs, lses = [], []
    for r0 in range(0, max(q.shape[2], 1), _PLAIN_ROWS):
        qc = q[:, :, r0:r0 + _PLAIN_ROWS]
        o, lse = _eager_attend(qc, k, v, chunk_mask(r0, qc.shape[2]), s_aux,
                               True, matmul_dtype)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def flash_bwd_plain(q, k, v, do, lse, delta, num_sink: int = 4,
                    window_size: int = 512, q_offset: int = 0,
                    kv_offset: int = 0, matmul_dtype=None):
    """The plain PyTorch version of the two backward kernels: (dq in
    q.dtype, dk in k.dtype, dv in v.dtype) from the same inputs.

    The kernels' formulas written out in fp32 over query chunks of 1024
    rows: P = exp(S - LSE) recomputed (0 where masked), dP = dO V^T,
    dS = P (dP - delta), dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO,
    dK and dV summed over each GQA group. ``lse`` [B,H_q,N_q] fp32 is the
    forward's (it counts s_aux, so P is the true probability); ``delta``
    [B,H_q,N_q] fp32 is sum_d dO * O, less the LSE cotangent if any.
    With ``matmul_dtype`` (torch.bfloat16: the fp32 kernels' precision)
    the products read q, k, v and dO rounded to it, and P and dS in fp32
    (the fp32 kernels carry them as two bf16 terms, about 16 bits).
    """
    n_kv = k.shape[2]
    return bwd_plain_chunks(q, k, v, do, lse, delta, lambda r0, n: _visible(
        n, n_kv, num_sink, window_size, q_offset + r0, kv_offset, q.device),
        matmul_dtype)


def bwd_plain_chunks(q, k, v, do, lse, delta, chunk_mask, matmul_dtype=None):
    """(dq, dk, dv) of :func:`flash_bwd_plain`'s formulas under the mask
    ``chunk_mask(r0, n)`` of rows [r0, r0 + n), bool broadcastable to
    [B, H_q, n, N_kv]."""
    B, H_q, N_q, D = q.shape
    H_kv, N_kv = k.shape[1], k.shape[2]
    group = H_q // H_kv
    scale = 1.0 / (D ** 0.5)
    def mm(t):
        return rounded(t, matmul_dtype)

    kf = mm(k).repeat_interleave(group, dim=1)
    vf = mm(v).repeat_interleave(group, dim=1)
    dk = torch.zeros(B, H_q, N_kv, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for r0 in range(0, max(N_q, 1), _PLAIN_ROWS):
        rows = slice(r0, r0 + _PLAIN_ROWS)
        qc, doc = mm(q[:, :, rows]), mm(do[:, :, rows])
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


def tiles_differ(block_n, by_d) -> bool:
    """True where a library's ``block_n(D)`` disagrees with the host's
    table ``by_d`` {instance head dim: keys} at any instance."""
    return any(block_n(d) != bn for d, bn in by_d.items())


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    lib = _build.load("flash_fwd")
    if (lib.sink_fwd_block_m() != FWD_BM
            or tiles_differ(lib.sink_fwd_block_n, FWD_BNS)):
        raise RuntimeError("csrc/flash_fwd.cu and ops/flash.py disagree on "
                           "the tile sizes")
    return load_fn("flash_fwd", "sink_fwd", 7, 11)


@functools.lru_cache(maxsize=None)
def _bwd_fns():
    lib = _build.load("flash_bwd")
    if (lib.sink_dq_block_m() != DQ_BM or
            tiles_differ(lib.sink_dq_block_n, DQ_BN) or
            lib.sink_dkdv_block_m() != DKDV_BM or
            tiles_differ(lib.sink_dkdv_block_n, DKDV_BNS)):
        raise RuntimeError("csrc/flash_bwd.cu and ops/flash.py disagree on "
                           "the tile sizes")
    return (load_fn("flash_bwd", "sink_dq", 9, 11),
            load_fn("flash_bwd", "sink_dkdv", 11, 12))


@functools.lru_cache(maxsize=256)
def _table_on(table_fn, device, *key) -> torch.Tensor:
    """The host table ``table_fn(*key)`` on ``device``, copied there once."""
    return torch.from_numpy(np.array(table_fn(*key))).to(device)


@functools.lru_cache(maxsize=256)
def _pieces_on(device, *key):
    """(:func:`dkdv_piece_table` of ``key`` on ``device``, copied there
    once; its pieces; its partial slots)."""
    table = dkdv_piece_table(*key)
    return (torch.from_numpy(np.array(table)).to(device), int(table[0, 0]),
            int(table[0, 1]))


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


def kernel_out(like: torch.Tensor, shape, d_pad: int) -> torch.Tensor:
    """An output of the kernels for inputs like ``like``: ``shape`` with
    its last dim ``d_pad``, in ``like``'s dtype (fp32 inputs give fp32
    outputs)."""
    return torch.empty((*shape[:-1], d_pad), dtype=like.dtype,
                       device=like.device)


def unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    """A kernel output cut back to head dim ``d`` (a view; itself if not
    padded)."""
    return t if t.shape[-1] == d else t[..., :d]


def flash_fwd_kernel(q, k, v, s_aux=None, num_sink: int = 4,
                     window_size: int = 512, q_offset: int = 0,
                     kv_offset: int = 0):
    """Launch ``csrc/flash_fwd.cu`` (the wgmma/TMA kernel of
    ``csrc/hopper.cuh``) on CUDA tensors: (out, lse).

    q [B,H_q,N_q,D], k/v [B,H_kv,N_kv,D] bf16, fp16 or fp32, any D;
    s_aux [H_q] or None; out in q's dtype. ``flash_fwd_kernel.launches``
    counts the launches (``padded_copies`` those that padded D, see the
    module's docstring). A warmed call (its range table already on the
    card) synchronises nothing.
    """
    _build.check_attention_inputs(q, k, v, s_aux)
    dims, geom = _geometry(q, k, v, num_sink, window_size, q_offset,
                           kv_offset)
    B, H_q, H_kv, N_q, N_kv, D = dims
    (qc, kc, vc), code, d_pad = _build.kernel_operands(q, k, v)
    ranges = _table_on(fwd_kv_ranges, q.device, N_q, N_kv, *geom, FWD_BM,
                       FWD_BNS[_build.kernel_head_dim(d_pad)])
    aux = (s_aux.detach().float().contiguous() if s_aux is not None
           else None)
    out = kernel_out(q, q.shape, d_pad)
    lse = torch.empty((B, H_q, N_q), dtype=torch.float32, device=q.device)
    ptrs = [_build.ptr(t) for t in (qc, kc, vc, aux, ranges, out, lse)]
    err = _kernel_fn()(*ptrs, *dims[:5], d_pad, *geom, code, 1.0 / (D ** 0.5),
                       _build.stream_ptr(q.device))
    _build.check(err, "sink_fwd")
    _build.note_launch(flash_fwd_kernel, D, q.dtype, d_pad != D,
                       _build.instance_of("flash_fwd", "sink_fwd_instance",
                                          d_pad))
    return unpad(out, D), lse


_build.counters(flash_fwd_kernel)


def _bwd_operands(q, k, v, do, lse, delta):
    """The backward kernels' checks and operands: (q, k, v, dO as
    :func:`_build.kernel_operands` makes them, and lse, delta fp32
    [B,H_q,N_q] contiguous), the dtype code and the padded head dim."""
    _build.check_attention_inputs(q, k, v, None)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO must match q: {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {tuple(q.shape[:3])}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    ops, code, d_pad = _build.kernel_operands(q, k, v, do)
    return ops + [_build.aligned(t) for t in (lse, delta)], code, d_pad


def flash_dq_kernel(q, k, v, do, lse, delta, num_sink: int = 4,
                    window_size: int = 512, q_offset: int = 0,
                    kv_offset: int = 0):
    """Launch ``sink_dq`` of ``csrc/flash_bwd.cu`` (the wgmma/TMA kernel
    of ``csrc/hopper_dq.cuh``): dq [B,H_q,N_q,D] in q's dtype, bitwise
    repeatable. Inputs as :func:`flash_bwd_plain`'s, on the card, q/k/v/dO
    of one type (bf16, fp16, fp32), any D.
    ``flash_dq_kernel.launches`` counts the launches. A warmed call (its
    tables already on the card) synchronises nothing.
    """
    ops, code, d_pad = _bwd_operands(q, k, v, do, lse, delta)
    dims, geom = _geometry(q, k, v, num_sink, window_size, q_offset,
                           kv_offset)
    D = dims[5]
    key = (dims[3], dims[4], *geom, DQ_BM,
           DQ_BN[_build.kernel_head_dim(d_pad)])
    ranges = _table_on(fwd_kv_ranges, q.device, *key)
    order = _table_on(dq_block_order, q.device, *key)
    dq = kernel_out(q, q.shape, d_pad)
    ptrs = [_build.ptr(t) for t in (*ops, ranges, order, dq)]
    err = _bwd_fns()[0](*ptrs, *dims[:5], d_pad, *geom, code,
                        1.0 / (D ** 0.5), _build.stream_ptr(q.device))
    _build.check(err, "sink_dq")
    _build.note_launch(flash_dq_kernel, D, q.dtype, d_pad != D,
                       _build.instance_of("flash_bwd", "sink_dq_instance",
                                          d_pad))
    return unpad(dq, D)


_build.counters(flash_dq_kernel)


def flash_dkdv_kernel(q, k, v, do, lse, delta, num_sink: int = 4,
                      window_size: int = 512, q_offset: int = 0,
                      kv_offset: int = 0):
    """Launch ``sink_dkdv`` of ``csrc/flash_bwd.cu`` (the wgmma/TMA
    kernel of ``csrc/hopper_bwd.cuh``): (dk, dv) [B,H_kv,N_kv,D] in k's
    dtype, summed over each GQA group inside the kernel, bitwise
    repeatable. Inputs as :func:`flash_dq_kernel`'s.
    ``flash_dkdv_kernel.launches`` counts the launches. A warmed call (its
    tables already on the card) synchronises nothing. The key blocks'
    pieces (:func:`dkdv_piece_table`) run spread over the card; a split
    block's pieces meet through the stream's workspace inside the launch,
    summed in piece order."""
    ops, code, d_pad = _bwd_operands(q, k, v, do, lse, delta)
    dims, geom = _geometry(q, k, v, num_sink, window_size, q_offset,
                           kv_offset)
    B, _, H_kv, _, N_kv, D = dims
    bn = DKDV_BNS[_build.kernel_head_dim(d_pad)]
    key = (dims[3], N_kv, *geom, DKDV_BM, bn)
    pieces, n_pieces, n_slots = _pieces_on(q.device, *key)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counters = dkdv_workspace(q.device, stream, n_slots * B * H_kv,
                                    _cdiv(N_kv, bn) * B * H_kv, d_pad)
    dk, dv = kernel_out(k, k.shape, d_pad), kernel_out(v, v.shape, d_pad)
    ptrs = [_build.ptr(t) for t in (*ops, pieces)]
    err = _bwd_fns()[1](*ptrs, part, counters, _build.ptr(dk), _build.ptr(dv),
                        *dims[:5], d_pad, n_pieces, *geom, code,
                        1.0 / (D ** 0.5), stream)
    _build.check(err, "sink_dkdv")
    _build.note_launch(flash_dkdv_kernel, D, q.dtype, d_pad != D,
                       _build.instance_of("flash_bwd", "sink_dkdv_instance",
                                          d_pad))
    return unpad(dk, D), unpad(dv, D)


_build.counters(flash_dkdv_kernel)


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
    """Rectangular chunk attention at ``offsets = (q_offset, kv_offset)``
    or ``(q_offset, kv_offset, col_hi)``: (out, lse) partials for
    :func:`merge_partials`.

    Takes no s_aux: it is folded in at merge time, so it counts once
    across chunks. ``kv_offset`` may be negative (a halo whose leading
    slots precede the sequence: they are attended by no query and get zero
    gradient). ``col_hi`` clips the attended global columns from above
    (``kv_offset + j < col_hi``, the sequence-parallel partials' exact
    partition): on one contiguous chunk that keeps its first
    ``clamp(col_hi - kv_offset, 0, N_kv)`` slots, so K and V are narrowed
    to those and the cut slots get zero gradient through the narrowing.
    With no slot left the partial is o = 0, lse = -inf, and no kernel
    runs. Differentiable in both outputs: the LSE cotangent of a
    downstream merge folds into the backward's delta.
    """
    q_offset, kv_offset, *rest = (int(x) for x in offsets)
    if len(rest) > 1:
        raise ValueError(f"offsets takes 2 or 3 values, got {len(rest) + 2}")
    if rest:
        keep = min(max(rest[0] - kv_offset, 0), k.shape[2])
        if keep == 0:
            # the sums over the empty slices are 0 and keep q, k and v in
            # the graph: their gradients are zeros, not missing
            zero = q[..., :0].sum() + k[:, :, :0].sum() + v[:, :, :0].sum()
            lse = torch.full(q.shape[:3], float("-inf"), device=q.device)
            return (torch.zeros_like(q) + zero.to(q.dtype),
                    lse + zero.float())
        k, v = k[:, :, :keep], v[:, :, :keep]
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
