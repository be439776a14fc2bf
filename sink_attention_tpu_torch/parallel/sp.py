"""Sequence parallelism for sink attention over ``torch.distributed``.

Counterpart of ``sink_attention_tpu/parallel/sp.py``, with a process group
where JAX takes an ``axis_name`` (``group=None`` is the world group):

* :func:`broadcast_sink_kv`: rank 0's first ``num_sink`` KV positions on
  every rank, as a masked sum over the group (differentiable: its backward
  is the sink-gradient all-reduce onto rank 0).
* :func:`reduce_sink_grads`: the all-reduce (sum) of sink-KV gradients.
* :func:`local_position_offset`: the global position of a shard's first
  token.
* :func:`sp_sink_flash_attention`: exact sequence-parallel sink attention.
  A window-sized halo of K/V comes from the left neighbour, a separate sink
  partial covers the sink columns below it, and the partials merge by
  log-sum-exp, so the result equals single-device attention.

Gradients of replicated inputs: ``s_aux`` is the same on every rank and
each rank's autograd gives only its own rows' share of its gradient; the
caller sums it over the group (JAX's ``shard_map`` with ``P()`` sums that
cotangent over the axis). The sink K/V gradient is complete on rank 0
through the broadcast's backward, as in JAX.
"""

from __future__ import annotations

import torch

from ..ops.flash import merge_partials, sink_flash_attention_chunk
from ._collectives import ppermute, psum, rank_and_size

__all__ = [
    "broadcast_sink_kv",
    "reduce_sink_grads",
    "local_position_offset",
    "sp_sink_flash_attention",
]


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def broadcast_sink_kv(k_local, v_local, num_sink: int, group=None):
    """Rank 0's first ``num_sink`` KV positions on every rank.

    Returns (sink_k, sink_v): [B, H_kv, num_sink, D]. Differentiable: the
    backward sums the sink gradients of every rank onto rank 0 (the
    reference's ``reduce_sink_kv_grads``, for free).
    """
    rank, _ = rank_and_size(group)
    mine = 1.0 if rank == 0 else 0.0
    both = psum(torch.stack([k_local[:, :, :num_sink],
                             v_local[:, :, :num_sink]]) * mine, group)
    return both[0], both[1]


def reduce_sink_grads(dk_sink, dv_sink, group=None):
    """All-reduce (sum) of the sink-KV gradients over the group."""
    both = psum(torch.stack([dk_sink, dv_sink]), group)
    return both[0], both[1]


def local_position_offset(n_local: int, group=None) -> int:
    """Global position of this shard's first token."""
    return rank_and_size(group)[0] * n_local


def sp_sink_flash_attention(q_local, k_local, v_local, num_sink: int = 4,
                            window_size: int = 512, s_aux=None, group=None):
    """Exact sequence-parallel sink attention (differentiable).

    Each rank holds a contiguous [B, H, N_local, D] chunk, rank r the
    positions [r N_local, (r+1) N_local):

      1. halo: the left neighbour's last ``window_size - 1`` K/V positions
         (rounded up to 128, at most one shard) arrive by one ppermute; on
         rank 0 they wrap around from the last rank and sit at a negative
         ``kv_offset``, where the kernel masks them;
      2. the local partial over [halo | local];
      3. the sink partial over rank 0's sink K/V (broadcast), clipped to
         the columns below the local partial's coverage
         (``col_hi = max(kv_offset, 0)``), so nothing counts twice;
      4. the log-sum-exp merge, with ``s_aux`` folded in once.

    Raises ValueError where one halo hop cannot be exact: sinks that do not
    fit in rank 0's shard, or a window longer than a shard (use
    ``ring_sink_flash_attention`` or ``sharded_sink_flash_attention``).
    """
    n_local = k_local.shape[2]
    if num_sink > n_local:
        raise ValueError(
            f"num_sink={num_sink} exceeds shard length {n_local}: the sink "
            "broadcast reads shard 0's first num_sink slots; use "
            "ring_sink_flash_attention (or sharded_sink_flash_attention)")
    if window_size - 1 > n_local:
        raise ValueError(
            f"window_size={window_size} exceeds shard length {n_local}: "
            "halo SP is exact only for window_size - 1 <= n_local; use "
            "ring_sink_flash_attention instead")
    q_off = local_position_offset(n_local, group)
    halo = min(_round_up(max(window_size - 1, 0), 128), n_local)
    k_ext, v_ext = k_local, v_local
    if halo:
        tail = ppermute(torch.stack([k_local[:, :, n_local - halo:],
                                     v_local[:, :, n_local - halo:]]), group)
        k_ext = torch.cat([tail[0], k_local], dim=2)
        v_ext = torch.cat([tail[1], v_local], dim=2)
    kv_off = q_off - halo   # negative on rank 0 (masked in the kernel)

    o_loc, lse_loc = sink_flash_attention_chunk(
        q_local, k_ext, v_ext, (q_off, kv_off), num_sink=num_sink,
        window_size=window_size)
    outs, lses = [o_loc], [lse_loc]
    if num_sink > 0:
        sink_k, sink_v = broadcast_sink_kv(k_local, v_local, num_sink, group)
        o_s, lse_s = sink_flash_attention_chunk(
            q_local, sink_k, sink_v, (q_off, 0, max(kv_off, 0)),
            num_sink=num_sink, window_size=1)
        outs.append(o_s)
        lses.append(lse_s)
    out, _ = merge_partials(outs, lses, s_aux=s_aux)
    return out.to(q_local.dtype)
