"""Ring attention for sink flash attention (context parallelism) over
``torch.distributed``, and the dispatcher between it and halo SP.

Counterpart of ``sink_attention_tpu/parallel/ring.py``, with a process
group where JAX takes an ``axis_name``. Sink + window attention reads
O(num_sink + window) keys per query, so each rank rotates only through the
``ceil((window - 1) / chunk) + 1`` K/V chunks its window can reach
(skip-ahead) instead of all ``n`` of them, and the sinks arrive by one
broadcast. The partials merge by log-sum-exp with ``s_aux`` folded in once.

Gradients of replicated inputs: as in ``parallel.sp``, the caller sums
``s_aux``'s gradient over the group; the sink K/V gradient is complete on
rank 0 through the broadcast's backward.
"""

from __future__ import annotations

import torch

from ..ops.flash import merge_partials, sink_flash_attention_chunk
from ._collectives import ppermute_start, rank_and_size
from .sp import broadcast_sink_kv, sp_sink_flash_attention

__all__ = ["ring_sink_flash_attention", "ring_num_steps",
           "sharded_sink_flash_attention"]


def sharded_sink_flash_attention(q_local, k_local, v_local,
                                 num_sink: int = 4, window_size: int = 512,
                                 s_aux=None, group=None):
    """Sequence-sharded sink attention with the schedule chosen from the
    shard shapes: halo SP (``sp_sink_flash_attention``: one hop of a
    window-sized halo) when ``window_size - 1 <= n_local`` and the sinks
    fit in rank 0's shard, ring skip-ahead otherwise."""
    n_local = k_local.shape[2]
    fn = (sp_sink_flash_attention
          if window_size - 1 <= n_local and num_sink <= n_local
          else ring_sink_flash_attention)
    return fn(q_local, k_local, v_local, num_sink=num_sink,
              window_size=window_size, s_aux=s_aux, group=group)


def ring_num_steps(n_dev: int, n_local: int, window_size: int) -> int:
    """Ring rotations of the skip-ahead schedule: a query at a chunk's
    start reaches back ``window_size - 1`` positions, at most
    ``ceil((window_size - 1) / n_local)`` earlier chunks and its own."""
    k = -(-max(window_size - 1, 0) // n_local) + 1
    return min(n_dev, k)


def ring_sink_flash_attention(q_local, k_local, v_local, num_sink: int = 4,
                              window_size: int = 512, s_aux=None,
                              group=None):
    """Exact ring sink attention (differentiable).

    q_local, k_local, v_local: [B, H, N/n, D] contiguous chunks, rank r the
    positions [r N/n, (r+1) N/n); s_aux the full [H_q] on every rank.
    Returns [B, H_q, N/n, D].

    1. Window phase: ``ring_num_steps`` steps. At step s rank r holds
       chunk ``(r - s) mod n`` and runs the chunk kernel over it with the
       sink + window mask (a chunk that wrapped round from the future is
       causally empty: an lse of -inf). The next hop's send and receive
       are issued before the step's kernel and waited on after it, so the
       transfer runs beside the kernel. With ``num_sink > n_local`` the
       sinks span several chunks and the rotation is full.
    2. Sink phase, when the rotation was cut short: rank 0's first
       ``num_sink`` K/V by broadcast, and a sink partial over the sink
       columns below the window phase's coverage (``col_hi``), so nothing
       counts twice.
    """
    r, n = rank_and_size(group)
    n_local = q_local.shape[2]
    q_off = r * n_local
    steps = ring_num_steps(n, n_local, window_size)
    if num_sink > n_local:
        steps = n

    outs, lses = [], []
    kv = torch.stack([k_local, v_local])
    for step in range(steps):
        kv_off = ((r - step) % n) * n_local
        nxt = ppermute_start(kv, group) if step + 1 < steps else None
        o, lse = sink_flash_attention_chunk(
            q_local, kv[0], kv[1], (q_off, kv_off), num_sink=num_sink,
            window_size=window_size)
        outs.append(o)
        lses.append(lse)
        if nxt is not None:
            kv = nxt.wait()

    if steps < n and num_sink > 0:
        sink_k, sink_v = broadcast_sink_kv(k_local, v_local, num_sink, group)
        # the lowest position the window phase covered on this rank; a
        # rank whose rotation reached chunk 0 clips every sink column
        col_hi = max((r - steps + 1) * n_local, 0)
        o, lse = sink_flash_attention_chunk(
            q_local, sink_k, sink_v, (q_off, 0, col_hi), num_sink=num_sink,
            window_size=1)
        outs.append(o)
        lses.append(lse)
    out, _ = merge_partials(outs, lses, s_aux=s_aux)
    return out.to(q_local.dtype)
