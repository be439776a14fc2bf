"""Ulysses-style sequence parallelism: all-to-all head <-> sequence
resharding over ``torch.distributed``.

Counterpart of ``sink_attention_tpu/parallel/ulysses.py``, with a process
group where JAX takes an ``axis_name``. An all-to-all swaps sequence
sharding for head sharding, the single-device kernel runs over the whole
sequence on the local heads, and the output is swapped back. ``s_aux`` is
sliced to the local heads by rank. It is the same on every rank, and each
rank's autograd gives the gradient of its own heads' slice only: the
caller sums it over the group.
"""

from __future__ import annotations

import torch

from ..ops.flash import sink_flash_attention
from ..ops.packed import sink_flash_attention_packed
from ._collectives import all_to_all, rank_and_size

__all__ = ["ulysses_sink_flash_attention", "scatter_heads", "gather_heads",
           "ulysses_sink_flash_attention_packed", "slice_s_aux_for_rank"]


def slice_s_aux_for_rank(s_aux, h_local: int, group=None):
    """This rank's [h_local] slice of a full [H_total] s_aux: after the
    all-to-all, rank r owns heads [r h_local, (r+1) h_local)."""
    r = rank_and_size(group)[0]
    return s_aux[r * h_local:(r + 1) * h_local]


def scatter_heads(x, group=None):
    """seq-sharded [B, H, N/sp, D] -> head-sharded [B, H/sp, N, D]."""
    return all_to_all(x, 1, 2, group)


def gather_heads(x, group=None):
    """head-sharded [B, H/sp, N, D] -> seq-sharded [B, H, N/sp, D]."""
    return all_to_all(x, 2, 1, group)


def _scatter(q_local, k_local, v_local, s_aux, group):
    sp = rank_and_size(group)[1]
    H_q, H_kv = q_local.shape[1], k_local.shape[1]
    if H_q % sp or H_kv % sp:
        raise ValueError(f"Ulysses needs H_q={H_q} and H_kv={H_kv} to "
                         f"divide by the group size {sp}")
    aux = (None if s_aux is None
           else slice_s_aux_for_rank(s_aux, H_q // sp, group))
    return (scatter_heads(q_local, group), scatter_heads(k_local, group),
            scatter_heads(v_local, group), aux)


def ulysses_sink_flash_attention(q_local, k_local, v_local,
                                 num_sink: int = 4, window_size: int = 512,
                                 s_aux=None, group=None):
    """Exact, differentiable SP sink attention via Ulysses all-to-alls.

    q_local [B, H_q, N/sp, D] and k_local, v_local [B, H_kv, N/sp, D]:
    sequence-sharded, all heads; s_aux the full [H_q] on every rank.
    Returns [B, H_q, N/sp, D]. Needs H_q and H_kv divisible by sp.
    """
    q, k, v, aux = _scatter(q_local, k_local, v_local, s_aux, group)
    out = sink_flash_attention(q, k, v, num_sink=num_sink,
                               window_size=window_size, s_aux=aux)
    return gather_heads(out, group)


def ulysses_sink_flash_attention_packed(q_local, k_local, v_local,
                                        positions: torch.Tensor,
                                        num_sink: int = 4,
                                        window_size: int = 512,
                                        s_aux=None, group=None):
    """Ulysses SP over a packed (multi-segment) batch: the all-to-alls of
    :func:`ulysses_sink_flash_attention` around the packed kernels, so
    each segment keeps its own sinks and window. ``positions``: the full
    [B, N] segment-local positions, the same on every rank."""
    sp = rank_and_size(group)[1]
    B, _, n_local, _ = q_local.shape
    if tuple(positions.shape) != (B, n_local * sp):
        raise ValueError(f"positions must be [B, N] = {(B, n_local * sp)}, "
                         f"got {tuple(positions.shape)}")
    q, k, v, aux = _scatter(q_local, k_local, v_local, s_aux, group)
    out = sink_flash_attention_packed(q, k, v, positions, num_sink,
                                      window_size, s_aux=aux)
    return gather_heads(out, group)
