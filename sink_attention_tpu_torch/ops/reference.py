"""Eager reference ("oracle") for sink attention, in PyTorch.

The single source of truth for the attention semantics that the CUDA
kernels implement. Counterpart of ``sink_attention_tpu/ops/reference.py``,
with fp32 math throughout.

Attention pattern for query at global position i over key at global
position j:

    valid(i, j) = (j <= i) AND (j < num_sink OR j >= i - window_size + 1)

The optional ``s_aux`` (one learnable scalar per query head, the gpt-oss
"attention sink" logit) takes part in the softmax as an extra logit that
absorbs probability mass but contributes no value vector.

A packed batch row holds several segments back to back, ``positions``
counting up from 0 in each. With segment starts ``s_i = i - positions_i``
each segment has its own sinks and window and no attention crosses a
segment boundary:

    valid(i, j) = (j <= i) AND (j >= s_i)
                  AND (j < s_i + num_sink OR j >= i - window_size + 1)
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sink_window_mask", "eager_sink_attention",
           "packed_sink_window_mask", "eager_sink_attention_packed"]


def sink_window_mask(n_q: int, n_kv: int, num_sink: int, window_size: int,
                     q_offset: int = 0, kv_offset: int = 0,
                     device=None) -> torch.Tensor:
    """Boolean [n_q, n_kv] mask: True where query i may attend key j.

    ``q_offset``/``kv_offset`` translate local indices into global
    positions, for rectangular (chunked) use.
    """
    i = torch.arange(n_q, device=device)[:, None] + q_offset
    j = torch.arange(n_kv, device=device)[None, :] + kv_offset
    causal = j <= i
    sink = j < num_sink
    window = j >= i - window_size + 1
    return causal & (sink | window)


def eager_sink_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_sink: int = 4, window_size: int = 512,
                         s_aux: Optional[torch.Tensor] = None,
                         q_offset: int = 0, kv_offset: int = 0,
                         return_lse: bool = False):
    """Eager sink attention with optional per-head s_aux.

    Args:
        q: [B, H_q, N_q, D]; k, v: [B, H_kv, N_kv, D] (H_q % H_kv == 0).
        num_sink: number of always-attended leading tokens.
        window_size: causal sliding-window size (the window includes self).
        s_aux: optional [H_q] sink logit per query head.
        q_offset/kv_offset: global position offsets (chunked attention).
        return_lse: also return the natural-log log-sum-exp [B, H_q, N_q]
            fp32, over valid scores plus s_aux; -inf for rows with no mass.

    Returns:
        out [B, H_q, N_q, D] in q.dtype (and lse if requested).
    """
    mask = sink_window_mask(q.shape[2], k.shape[2], num_sink, window_size,
                            q_offset, kv_offset, device=q.device)
    return _eager_attend(q, k, v, mask[None, None], s_aux, return_lse)


def packed_rows_mask(positions: torch.Tensor, row0: int, n_rows: int,
                     num_sink: int, window_size: int) -> torch.Tensor:
    """Boolean [B, n_rows, N]: rows [row0, row0 + n_rows) of the packed
    mask of ``positions`` [B, N] (segment-local positions)."""
    n = positions.shape[-1]
    pos = positions.long()
    i = torch.arange(row0, row0 + n_rows, device=pos.device)
    j = torch.arange(n, device=pos.device)
    s_i = (i - pos[:, row0:row0 + n_rows])[:, :, None]  # segment starts
    i, j = i[None, :, None], j[None, None, :]
    return (j <= i) & (j >= s_i) & ((j < s_i + num_sink) |
                                    (j >= i - window_size + 1))


def packed_sink_window_mask(positions: torch.Tensor, num_sink: int,
                            window_size: int) -> torch.Tensor:
    """Boolean [B, N, N] mask of a packed batch: True where query i may
    attend key j. ``positions`` [B, N] holds each token's position within
    its segment (0 at every segment start); ``j >= s_i`` with causality
    already puts j in i's segment, so only row-side segment starts are
    needed."""
    return packed_rows_mask(positions, 0, positions.shape[-1], num_sink,
                            window_size)


def eager_sink_attention_packed(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, positions: torch.Tensor,
                                num_sink: int = 4, window_size: int = 512,
                                s_aux: Optional[torch.Tensor] = None,
                                return_lse: bool = False):
    """Eager sink attention over a packed (multi-segment) batch.

    q: [B, H_q, N, D]; k, v: [B, H_kv, N, D]; positions: [B, N]
    segment-local token positions. Each segment gets its own sinks (its
    first ``num_sink`` tokens) and its own causal sliding window; tokens
    never attend across segment boundaries.
    """
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"packed attention needs N_q == N_kv: "
                         f"{tuple(q.shape)} {tuple(k.shape)}")
    mask = packed_sink_window_mask(positions.to(q.device), num_sink,
                                   window_size)
    return _eager_attend(q, k, v, mask[:, None], s_aux, return_lse)


def rounded(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """``x`` in fp32, through ``dtype`` first where given: a product's
    operand at that precision (the fp32 kernels read their operands as
    bf16, as a TPU's matrix unit does at its default precision)."""
    return x.float() if dtype is None else x.to(dtype).float()


def _eager_attend(q, k, v, mask, s_aux, return_lse, matmul_dtype=None):
    """Shared masked-softmax body. mask: [B|1, 1, N_q, N_kv] bool. With
    ``matmul_dtype`` both products read their operands (q, k; the
    probabilities, v) rounded to it, the softmax in fp32."""
    B, H_q, N_q, D = q.shape
    H_kv, N_kv = k.shape[1], k.shape[2]
    if H_q % H_kv:
        raise ValueError(f"H_q={H_q} is not a multiple of H_kv={H_kv}")
    groups = H_q // H_kv

    qf, kf, vf = (rounded(t, matmul_dtype) for t in (q, k, v))
    if groups > 1:
        kf = kf.repeat_interleave(groups, dim=1)
        vf = vf.repeat_interleave(groups, dim=1)

    scale = 1.0 / (D ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf * scale, kf)
    neg_inf = float("-inf")
    scores = scores.masked_fill(~mask, neg_inf)

    if s_aux is not None:
        aux = s_aux.float().reshape(1, H_q, 1, 1).expand(B, H_q, N_q, 1)
        logits = torch.cat([scores, aux], dim=-1)
    else:
        logits = scores

    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m_safe)
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    denom = p.sum(dim=-1, keepdim=True)
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    # drop the s_aux column: no value
    weights = rounded(p[..., :N_kv], matmul_dtype) / denom_safe
    out = torch.einsum("bhqk,bhkd->bhqd", weights, vf).to(q.dtype)

    if return_lse:
        lse = (m_safe + torch.log(denom_safe)).squeeze(-1)
        lse = lse.masked_fill(denom.squeeze(-1) == 0.0, neg_inf)
        return out, lse
    return out
