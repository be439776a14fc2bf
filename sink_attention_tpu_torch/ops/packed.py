"""Differentiable sink attention over packed (multi-segment) batches, on
hand-written CUDA kernels.

Counterpart of ``sink_attention_tpu/ops/packed.py``. A packed batch row
holds several segments back to back; ``positions`` [B, N] counts up from 0
in each, and with segment starts ``s_i = i - positions_i`` each segment
gets its own sinks and causal window (``ops.reference.packed_rows_mask``).
``s_i`` must not decrease along the pack, as it never does for positions
that count up by 1 and reset to 0: the tables below rely on it, as the JAX
kernels do, and nothing checks it.

Three kernels in ``csrc/packed.cu`` over the packed mask (the wgmma/TMA
forward of ``csrc/hopper.cuh``, dQ of ``csrc/hopper_dq.cuh`` and dK/dV of
``csrc/hopper_bwd.cuh``, the unpacked path's kernels), each beside its
plain PyTorch version:

* ``sink_pfwd`` (replaces the TPU kernel ``_pfwd_kernel``): O and LSE;
  plain version :func:`packed_fwd_plain`;
* ``sink_pdq`` (``_pdq_kernel``) and ``sink_pdkdv`` (``_pdkdv_kernel``):
  dQ, and dK/dV summed over the GQA group; plain version of the pair
  :func:`packed_bwd_plain`.

They take what the unpacked kernels take (``ops.flash``): any head_dim (a
padded copy for D % 8 != 0, counted in ``padded_copies``; past 512 the wide
instance of ``csrc/hopper_wide.cuh``) and
bf16, fp16 or fp32 inputs (fp32 rounded to bf16 on the way in, written
as fp32).

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels
or raises. :class:`_PackedSinkAttention` ties them into one autograd
function (JAX's ``custom_vjp``), its delta preprocess and ``ds_aux``
epilogue plain torch through ``ops.flash.attention_backward``.

The kernels walk per-batch tables (:func:`packed_tables`) built with
vectorised torch ops on the kernels' device: no device-to-host sync. They
are cached per positions tensor, so the layers of one forward and their
backward share one build.

A pack that begins inside a segment (``0 < positions[b, 0] < num_sink``)
keeps the oracle's semantics: its leading columns with positions below
``num_sink`` are sinks of the leading rows, and dK/dV counts every row
that reads them. The JAX kernel's table (``_packed_meta``) gives those
columns no sink pass and drops their gradients beyond the window; this
port does not copy that.
"""

from __future__ import annotations

import functools
import weakref
from typing import List, NamedTuple

import torch

from . import _build
from .flash import (DKDV_BM, DKDV_BNS, DQ_BM, DQ_BN, FWD_BM, FWD_BNS,
                    _WINDOW_CLAMP, _bwd_operands, _cdiv, attention_backward,
                    bwd_plain_chunks, dkdv_piece_cap, dkdv_pieces,
                    dkdv_workspace, fwd_plain_chunks, kernel_out, load_fn,
                    tiles_differ, unpad)
from .reference import packed_rows_mask

__all__ = ["sink_flash_attention_packed", "packed_tables", "PackedTables",
           "packed_fwd_plain", "packed_bwd_plain", "packed_fwd_kernel",
           "packed_dq_kernel", "packed_dkdv_kernel", "pack_lengths",
           "pack_positions", "packed_dkdv_slots"]


def pack_lengths(n: int, lo: int, hi: int, seed: int):
    """Segment lengths drawn uniform in [lo, hi] from
    numpy.random.default_rng(seed) until ``n`` tokens are filled; the last
    one is cut to fit (the length spread of a verl / SFT packed batch)."""
    import numpy as np
    rng, lens = np.random.default_rng(seed), []
    while sum(lens) < n:
        lens.append(min(int(rng.integers(lo, hi + 1)), n - sum(lens)))
    return lens


def pack_positions(lens, first: int = 0):
    """int64 [sum(lens)] segment-local positions (what a loader gives) of
    segments of ``lens`` back to back; ``first`` > 0 starts the pack
    inside its first segment."""
    pos = torch.cat([torch.arange(L) for L in lens])
    pos[:lens[0]] += first
    return pos


class PackedTables(NamedTuple):
    """int32 tables of one packed batch for one (num_sink, window,
    head_dim):

    * ``seg`` [B, N]: the segment start ``s_i`` of every row;
    * ``fwd`` [B, ceil(N/128), 4]: per 128-row q block (the forward, tiles
      ``FWD_BM`` x ``FWD_BNS[head_dim]``), the KV blocks it visits as two
      half-open ranges (sink_b0, sink_b1) and (win_b0, win_b1);
    * ``fwd_order`` [B * ceil(N/128)]: the (batch row, q block) units
      ``b * ceil(N/128) + block`` of ``fwd``, most KV blocks first (ties in
      unit order): the order the forward kernel's persistent CTAs take them
      in;
    * ``dq`` [B, ceil(N/128), 4]: the same per 128-row q block (dQ, tiles
      ``DQ_BM`` x ``DQ_BN[head_dim]``);
    * ``dq_order`` [B * ceil(N/128)]: the (batch row, q block) units
      ``b * ceil(N/128) + block`` of ``dq``, most KV blocks first (ties in
      unit order): the order the dQ kernel's persistent CTAs take them in;
    * ``kv`` [B, ceil(N/bn), 2]: per KV block of bn = ``DKDV_BNS[head_dim]``
      slots (dK/dV, tiles ``DKDV_BM`` x bn), the half-open range of 64-row
      q blocks that read it;
    * ``kv_order`` [B * ceil(N/bn)]: the (batch row, KV block) units
      ``b * ceil(N/bn) + block``, longest range first (ties in unit order);
    * ``kv_pieces`` [1 + B * ceil(N/bn) * m, 8]: ``ops.flash.dkdv_pieces``
      of those units in that order: each range cut into pieces of at most
      ``dkdv_piece_cap`` q blocks, the split units' pieces first, row 0
      their count (m the pieces of the longest possible range): the table
      the dK/dV kernel's persistent CTAs walk;
    * ``reach`` [B, N]: per key j, the end of the rows that see it: key j
      is visible to exactly the rows [j, reach[j]) (dK/dV's per-key mask).
    """
    seg: torch.Tensor
    fwd: torch.Tensor
    fwd_order: torch.Tensor
    dq: torch.Tensor
    dq_order: torch.Tensor
    kv: torch.Tensor
    kv_order: torch.Tensor
    reach: torch.Tensor
    kv_pieces: torch.Tensor


def _cdiv_t(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x + (d - 1), d, rounding_mode="floor")


def _q_table(seg: torch.Tensor, bm: int, bn: int, num_sink: int,
             window: int) -> torch.Tensor:
    """[B, ceil(N/bm), 4]: per q block of ``bm`` rows, the ``bn``-key
    blocks of its sink and window ranges (see :func:`packed_tables`)."""
    N = seg.shape[1]
    r0 = torch.arange(-(-N // bm), device=seg.device) * bm
    r1 = (r0 + bm - 1).clamp(max=N - 1)
    s_first = seg[:, r0]
    lo = s_first.clamp(min=0)
    hi = torch.minimum(s_first + num_sink, r1 + 1)
    has_sink = hi > lo
    zero = torch.zeros_like(lo)
    sink_b0 = torch.where(has_sink, lo // bn, zero)
    sink_b1 = torch.where(has_sink, _cdiv_t(hi, bn), zero)
    win_lo = torch.maximum(s_first, r0 - window + 1).clamp(min=0)
    win_b0 = torch.maximum(win_lo // bn, sink_b1)
    win_b1 = torch.maximum(_cdiv_t(r1 + 1, bn).expand_as(win_b0), win_b0)
    return torch.stack([sink_b0, sink_b1, win_b0, win_b1], dim=-1)


def _longest_first(lengths: torch.Tensor) -> torch.Tensor:
    """The flat indices of ``lengths`` [B, n], longest first (stable)."""
    return torch.argsort(-lengths.flatten(), stable=True)


def _n_blocks(table: torch.Tensor) -> torch.Tensor:
    """[B, n]: the KV blocks each q block of a q table visits."""
    return table[..., 1] - table[..., 0] + table[..., 3] - table[..., 2]


def packed_tables(positions: torch.Tensor, num_sink: int, window: int,
                  head_dim: int) -> PackedTables:
    """The kernels' tables for ``positions`` [B, N] and heads of
    ``head_dim``, on the positions' device.

    Forward (128-row q blocks, KV blocks of
    ``FWD_BNS[kernel_head_dim(head_dim)]`` keys) and dQ (128-row q
    blocks, KV blocks of ``DQ_BN[kernel_head_dim(head_dim)]`` keys): the
    instance's tiles (``_build.kernel_head_dim``), per q block of rows
    [r0, r1]: the sink range covers the first row's segment's sink columns
    [max(s_r0, 0), s_r0 + num_sink), cut at r1; the window range covers
    [max(s_r0, r0 - window + 1, 0), r1] and starts after the sink range, so
    no block is visited twice. A later segment starting inside the block
    starts after r0, so its sinks lie in the window range. The forward and
    dQ take their blocks most KV blocks first: the long items of a pack are
    each segment's last blocks, not the pack's.

    dK/dV, per KV block of ``DKDV_BNS[kernel_head_dim(head_dim)]`` slots,
    columns [c0, c1]: 64-row q blocks from
    c0's on (causal) up to cdiv(max_j reach(j), 64), where reach(j) is the
    end of j's segment for a sink column (positions[j] < num_sink), else
    min(that end, j + window). Tokens before the pack's first reset end at
    that reset. A block holding a segment's sink columns is read up to its
    segment's end, so its range is cut into pieces (``kv_pieces``) no
    longer than any block without sinks can be (``dkdv_piece_cap``), which
    the kernel spreads over the card and merges in the launch; the count,
    the slots and the order are computed here, on the card.

    So a full layer (window >= N) of a pack of segments of lengths L_k
    costs about sum(L_k^2) / 2 pairs, not N^2 / 2.
    """
    pos = positions.long()
    B, N = pos.shape
    dev = pos.device
    idx = torch.arange(N, device=dev)
    seg = idx - pos
    d_i = _build.kernel_head_dim(head_dim)
    kbn = DKDV_BNS[d_i]
    n_q_blocks, n_kv_blocks = -(-N // DKDV_BM), -(-N // kbn)
    fwdtab = _q_table(seg, FWD_BM, FWD_BNS[d_i], num_sink, window)
    dqtab = _q_table(seg, DQ_BM, DQ_BN[d_i], num_sink, window)

    # seg_end(j): the first reset after j, else N
    resets = torch.where(pos == 0, idx, N)
    after = torch.cat([resets[:, 1:], torch.full((B, 1), N, device=dev)],
                      dim=1)
    seg_end = after.flip(1).cummin(dim=1).values.flip(1)
    reach = torch.where(pos < num_sink, seg_end,
                        torch.minimum(seg_end, idx + window))
    block_reach = torch.nn.functional.pad(
        reach, (0, n_kv_blocks * kbn - N)).reshape(
            B, n_kv_blocks, kbn).amax(dim=-1)
    qb0 = (torch.arange(n_kv_blocks, device=dev) * kbn // DKDV_BM
           ).expand(B, -1)
    qb1 = torch.maximum(_cdiv_t(block_reach, DKDV_BM).clamp(max=n_q_blocks),
                        qb0)
    kvtab = torch.stack([qb0, qb1], dim=-1)
    kv_order = _longest_first(qb1 - qb0)
    cap = dkdv_piece_cap(kbn, window)
    pieces = dkdv_pieces(qb0.flatten(), qb1.flatten(), kv_order, cap,
                         max(1, _cdiv(n_q_blocks, cap)))
    return PackedTables(*(t.int().contiguous() for t in (
        seg, fwdtab, _longest_first(_n_blocks(fwdtab)), dqtab,
        _longest_first(_n_blocks(dqtab)), kvtab, kv_order, reach, pieces)))


@functools.lru_cache(maxsize=256)
def packed_dkdv_slots(B: int, N: int, num_sink: int, window: int,
                      head_dim: int) -> int:
    """An upper bound, from the shapes alone, on the partial slots that
    the split key blocks of :func:`packed_tables`' ``kv_pieces`` take
    (the workspace is sized by it: the pieces are counted on the card).

    Only a block holding some segment's sink column can be longer than
    the cap C (q blocks); its range is at most cdiv(L + bn - 1, 64) for
    that segment's in-pack length L, so L >= 64 C - bn + 2 and a row holds
    at most m = N // (64 C - bn + 2) such segments; each segment's sinks
    touch at most cdiv(num_sink - 1, bn) + 1 blocks; and a block of range
    n > C takes ceil(n / C) < 2 n / C slots. Summed over the segments of
    a row: < 2 (cdiv(num_sink - 1, bn) + 1) (N + m (bn + 62)) / (64 C)."""
    bn = DKDV_BNS[_build.kernel_head_dim(head_dim)]
    cap = dkdv_piece_cap(bn, window)
    if num_sink <= 0 or cap >= _cdiv(N, DKDV_BM):
        return 0
    blocks = _cdiv(num_sink - 1, bn) + 1
    m = N // (DKDV_BM * cap - bn + 2)
    return B * (2 * blocks * (N + m * (bn + 62)) // (DKDV_BM * cap) + 1)


# (weakref to the positions tensor, its version, device, num_sink, window,
# tables): the tables of the last few batches.
_TABLES: List[tuple] = []
_TABLES_KEPT = 16


def _tables_for(positions, device, num_sink, window,
                head_dim) -> PackedTables:
    """:func:`packed_tables` of ``positions`` on ``device``, built once per
    positions tensor (and its version) and geometry."""
    head_dim = _build.kernel_head_dim(head_dim)  # 80 and 128 share one
    key = (positions._version, device, num_sink, window, head_dim)
    for ref, *rest, tables in _TABLES:
        if ref() is positions and tuple(rest) == key:
            return tables
    tables = packed_tables(positions.to(device), num_sink, window, head_dim)
    _TABLES.append((weakref.ref(positions), *key, tables))
    del _TABLES[:-_TABLES_KEPT]
    return tables


def packed_fwd_plain(q, k, v, positions, s_aux=None, num_sink: int = 4,
                     window_size: int = 512, matmul_dtype=None):
    """The forward kernel's plain PyTorch version: (out [B,H_q,N,D] in
    q.dtype, lse [B,H_q,N] fp32), the eager oracle over query chunks of
    1024 rows (``matmul_dtype`` as in ``ops.flash.flash_fwd_plain``)."""
    pos = positions.to(q.device)
    return fwd_plain_chunks(q, k, v, s_aux, lambda r0, n: packed_rows_mask(
        pos, r0, n, num_sink, window_size)[:, None], matmul_dtype)


def packed_bwd_plain(q, k, v, do, lse, delta, positions, num_sink: int = 4,
                     window_size: int = 512, matmul_dtype=None):
    """The plain PyTorch version of the packed dQ and dK/dV kernels: (dq,
    dk, dv), ``ops.flash.flash_bwd_plain``'s formulas under the packed
    mask."""
    pos = positions.to(q.device)
    return bwd_plain_chunks(q, k, v, do, lse, delta, lambda r0, n:
                            packed_rows_mask(pos, r0, n, num_sink,
                                             window_size)[:, None],
                            matmul_dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = _build.load("packed")
    if (lib.sink_packed_block_m() != FWD_BM or
            tiles_differ(lib.sink_packed_block_n, FWD_BNS) or
            lib.sink_packed_dq_block_m() != DQ_BM or
            tiles_differ(lib.sink_packed_dq_block_n, DQ_BN) or
            lib.sink_packed_dkdv_block_m() != DKDV_BM or
            tiles_differ(lib.sink_packed_dkdv_block_n, DKDV_BNS)):
        raise RuntimeError("csrc/packed.cu and ops/flash.py disagree on the "
                           "tile sizes")
    return (load_fn("packed", "sink_pfwd", 9, 8),
            load_fn("packed", "sink_pdq", 10, 8),
            load_fn("packed", "sink_pdkdv", 12, 9))


def _geometry(q, k, v, positions, num_sink, window_size):
    """Checks shared by the kernels' wrappers; returns the ints the kernels
    take, (B, H_q, H_kv, N, D, num_sink, window)."""
    B, H_q, N, D = q.shape
    H_kv = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[2] != N
            or H_q % H_kv):
        raise ValueError(f"bad packed shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if tuple(positions.shape) != (B, N):
        raise ValueError(f"positions must be [B, N] = {(B, N)}, got "
                         f"{tuple(positions.shape)}")
    if not q.is_cuda:
        raise ValueError("the CUDA attention kernels take CUDA tensors")
    return (B, H_q, H_kv, N, D, min(int(num_sink), _WINDOW_CLAMP),
            min(int(window_size), _WINDOW_CLAMP))


def packed_fwd_kernel(q, k, v, positions, s_aux=None, num_sink: int = 4,
                      window_size: int = 512):
    """Launch ``sink_pfwd`` of ``csrc/packed.cu`` (the wgmma/TMA kernel of
    ``csrc/hopper.cuh``): (out, lse).

    q [B,H_q,N,D], k/v [B,H_kv,N,D] bf16, fp16 or fp32, any D;
    positions [B, N] (any int dtype, any device); s_aux [H_q] or None; out
    in q's dtype. ``packed_fwd_kernel.launches`` counts the launches. A
    warmed call (the positions' tables already built) synchronises
    nothing.
    """
    _build.check_attention_inputs(q, k, v, s_aux)
    geom = _geometry(q, k, v, positions, num_sink, window_size)
    B, H_q, H_kv, N, D, ns, W = geom
    tables = _tables_for(positions, q.device, ns, W, D)
    (qc, kc, vc), code, d_pad = _build.kernel_operands(q, k, v)
    aux = (s_aux.detach().float().contiguous() if s_aux is not None
           else None)
    out = kernel_out(q, q.shape, d_pad)
    lse = torch.empty((B, H_q, N), dtype=torch.float32, device=q.device)
    ptrs = [_build.ptr(t) for t in (qc, kc, vc, aux, tables.fwd,
                                    tables.fwd_order, tables.seg, out, lse)]
    err = _kernel_fns()[0](*ptrs, B, H_q, H_kv, N, d_pad, ns, W, code,
                           1.0 / (D ** 0.5), _build.stream_ptr(q.device))
    _build.check(err, "sink_pfwd")
    _build.note_launch(packed_fwd_kernel, D, q.dtype, d_pad != D,
                       _build.instance_of("packed", "sink_pfwd_instance",
                                          d_pad))
    return unpad(out, D), lse


_build.counters(packed_fwd_kernel)


def packed_dq_kernel(q, k, v, do, lse, delta, positions, num_sink: int = 4,
                     window_size: int = 512):
    """Launch ``sink_pdq`` of ``csrc/packed.cu`` (the wgmma/TMA kernel of
    ``csrc/hopper_dq.cuh``): dq [B,H_q,N,D] in q's dtype, bitwise
    repeatable. Inputs as :func:`packed_bwd_plain`'s, on the card.
    ``packed_dq_kernel.launches`` counts the launches. A warmed call (the
    positions' tables already built) synchronises nothing."""
    ops, code, d_pad = _bwd_operands(q, k, v, do, lse, delta)
    B, H_q, H_kv, N, D, ns, W = _geometry(q, k, v, positions, num_sink,
                                          window_size)
    tables = _tables_for(positions, q.device, ns, W, D)
    dq = kernel_out(q, q.shape, d_pad)
    ptrs = [_build.ptr(t) for t in (*ops, tables.dq, tables.dq_order,
                                    tables.seg, dq)]
    err = _kernel_fns()[1](*ptrs, B, H_q, H_kv, N, d_pad, ns, W, code,
                           1.0 / (D ** 0.5), _build.stream_ptr(q.device))
    _build.check(err, "sink_pdq")
    _build.note_launch(packed_dq_kernel, D, q.dtype, d_pad != D,
                       _build.instance_of("packed", "sink_pdq_instance",
                                          d_pad))
    return unpad(dq, D)


_build.counters(packed_dq_kernel)


def packed_dkdv_kernel(q, k, v, do, lse, delta, positions,
                       num_sink: int = 4, window_size: int = 512):
    """Launch ``sink_pdkdv`` of ``csrc/packed.cu`` (the wgmma/TMA kernel
    of ``csrc/hopper_bwd.cuh``): (dk, dv) [B,H_kv,N,D] in k's dtype,
    summed over each GQA group inside the kernel, bitwise repeatable.
    Inputs as :func:`packed_dq_kernel`'s. ``packed_dkdv_kernel.launches``
    counts the launches. No call synchronises: the key blocks' pieces are
    counted on the card, and the workspace sized by
    :func:`packed_dkdv_slots`."""
    ops, code, d_pad = _bwd_operands(q, k, v, do, lse, delta)
    B, H_q, H_kv, N, D, ns, W = _geometry(q, k, v, positions, num_sink,
                                          window_size)
    tables = _tables_for(positions, q.device, ns, W, D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, counters = dkdv_workspace(
        q.device, stream, packed_dkdv_slots(B, N, ns, W, d_pad) * H_kv,
        tables.kv.shape[1] * B * H_kv, d_pad)
    dk, dv = kernel_out(k, k.shape, d_pad), kernel_out(v, v.shape, d_pad)
    ptrs = [_build.ptr(t) for t in (*ops, tables.kv_pieces, tables.reach)]
    err = _kernel_fns()[2](*ptrs, part, counters, _build.ptr(dk),
                           _build.ptr(dv), B, H_q, H_kv, N, d_pad,
                           tables.kv_pieces.shape[0] - 1, ns, W, code,
                           1.0 / (D ** 0.5), stream)
    _build.check(err, "sink_pdkdv")
    _build.note_launch(packed_dkdv_kernel, D, q.dtype, d_pad != D,
                       _build.instance_of("packed", "sink_pdkdv_instance",
                                          d_pad))
    return unpad(dk, D), unpad(dv, D)


_build.counters(packed_dkdv_kernel)


def _fwd(q, k, v, positions, s_aux, num_sink, window_size):
    if q.device.type == "cpu":
        return packed_fwd_plain(q, k, v, positions, s_aux, num_sink,
                                window_size)
    if q.is_cuda:
        return packed_fwd_kernel(q, k, v, positions, s_aux, num_sink,
                                 window_size)
    raise ValueError(f"unsupported device {q.device}")


def _dqkv(q, k, v, do, lse, delta, positions, num_sink, window_size):
    """(dq, dk, dv): the plain version on the CPU, the two kernels on the
    card."""
    args = (positions, num_sink, window_size)
    if q.device.type == "cpu":
        return packed_bwd_plain(q, k, v, do, lse, delta, *args)
    if q.is_cuda:
        dq = packed_dq_kernel(q, k, v, do, lse, delta, *args)
        return (dq, *packed_dkdv_kernel(q, k, v, do, lse, delta, *args))
    raise ValueError(f"unsupported device {q.device}")


class _PackedSinkAttention(torch.autograd.Function):
    """Packed sink attention, differentiable in q, k, v and s_aux (the JAX
    package's ``_packed_attn`` custom_vjp). The positions tensor is kept on
    the context as it was given, so the backward's kernels find the tables
    the forward built."""

    @staticmethod
    def forward(ctx, q, k, v, s_aux, positions, num_sink, window_size):
        o, lse = _fwd(q, k, v, positions, s_aux, num_sink, window_size)
        ctx.save_for_backward(q, k, v, s_aux, o, lse)
        ctx.positions = positions
        ctx.geometry = (num_sink, window_size)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, s_aux, o, lse = ctx.saved_tensors
        args = (ctx.positions, *ctx.geometry)
        dq, dk, dv, ds_aux = attention_backward(
            q, k, v, s_aux, o, lse, do,
            dqkv=lambda q, k, v, do, lse, delta, *_: _dqkv(
                q, k, v, do, lse, delta, *args))
        if not ctx.needs_input_grad[3]:
            ds_aux = None
        return dq, dk, dv, ds_aux, None, None, None


def sink_flash_attention_packed(q, k, v, positions, num_sink: int = 4,
                                window_size: int = 512, s_aux=None):
    """Sink flash attention over a packed (multi-segment) batch.

    Each segment attends its own first ``num_sink`` tokens plus its own
    causal sliding window; no attention crosses a segment boundary.
    Differentiable in q, k, v and s_aux.

    Args:
        q: [B, H_q, N, D]; k, v: [B, H_kv, N, D] (the same packed layout).
        positions: [B, N] segment-local token positions (0 at each segment
            start: the position_ids a packed training loop feeds the
            model), any int dtype and device.
        num_sink / window_size / s_aux: as in ``sink_flash_attention``.

    Returns:
        [B, H_q, N, D] in q.dtype. On CUDA the packed forward kernel runs,
        and the packed dQ and dK/dV kernels in the backward; tiles are 128
        x 128 for the forward (128 x 64 at D > 128), 128 queries x 128 keys
        (64 at D = 128, 32 at D > 128) for dQ and 64 queries x 128 keys (64
        at D > 128) for dK/dV.
    """
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"packed attention needs N_q == N_kv: "
                         f"{tuple(q.shape)} {tuple(k.shape)}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, s_aux)):
        return _PackedSinkAttention.apply(q, k, v, s_aux, positions,
                                          num_sink, window_size)
    return _fwd(q, k, v, positions, s_aux, num_sink, window_size)[0]
