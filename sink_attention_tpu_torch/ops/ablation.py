"""Per-stage ablation of the prefill (forward) kernel.

Counterpart of the kernel part of ``scripts/mfu_ablation.py``'s
``run_ablation``. That script times stripped copies of the forward kernel,
adding the online softmax back one stage at a time, and candidate variants
of it. Two CUDA kernels of ``csrc/ablation.cu`` run every stage on the
card, beside their plain PyTorch version :func:`ablation_plain`:

* ``sink_ablation_bf16`` (replaces ``_ablation_kernel``): the nine stages
  from ``mxu_floor`` to ``bf16exp``;
* ``sink_mask_stage_bf16`` (replaces ``_mask_stage_kernel``): ``maskadd``
  and ``masksel``, correct attention whose diagonal and window-start tiles
  read a constant mask tile.

Every stage maps q [B, H_q, N, D], k/v [B, H_kv, N, D] (self-attention, zero
offsets, no s_aux) to out [B, H_q, N, D] in q.dtype. The stripped stages
sum over whole visited tiles, masked cells included, so their value
depends on the tile schedule. It is the production forward's: each 128-row
q block visits the 128-key blocks of :func:`flash.fwd_kv_ranges` (the sink
range, then the window range) at ``BM x BN``, which are the blocks
the JAX kernel visits at 128 x 128 tiles; the kernels are the forward of
``csrc/hopper.cuh`` with its softmax cut to the stage.

Per KV block, with ``qs = q * c`` rounded to q.dtype (``c = log2(e) /
sqrt(D)`` itself first rounded to q.dtype), ``s = qs k^T`` in fp32, the
state m = -inf, l = 0, acc = 0, P cast to v.dtype for P V and ``out = acc /
(l or 1)``:

=============  ==========================================================
mxu_floor      p = s
rowmax         + running max m, acc *= alpha; p = s
exp2           p = exp2(s - m); l not kept
sum            + l = l alpha + sum(p)
general        sum, the sink/window/causal mask on every cell, unguarded
               (a row whose first tile is wholly masked becomes NaN)
sum_mxu        l = l alpha + sum(bf16(p)) (the row sum as a matrix product)
nomax          p = exp2(s - 16), l += sum(p): no m, no rescale
nomax_summxu   nomax with l += sum(bf16(p))
bf16exp        p = exp2(bf16(s - m)) (see below); l sums p in fp32
maskadd        correct attention (guarded update on masked tiles)
masksel        the same; the kernels differ in how a mask tile is applied
=============  ==========================================================

The plain version's exp2 is the JAX reference's as it runs on the CPU:
exp(ln2 * x), with ln2 and the product rounded to x's type. For
``bf16exp`` that type is bf16, and XLA keeps the exp's result in fp32 (it
drops the round trip through bf16 before the fp32 consumers), so the plain
p is exp(bf16(bf16(x) * bf16(ln2))) in fp32, rounded to bf16 only as P V's
operand. The kernel computes p = 2^x in bf16 with ``ex2.approx.ftz.bf16x2``
(the stage's intent: the exponent at packed bf16 width); the two differ
within the kernel-vs-plain tolerance.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build
from .flash import (FWD_BM as BM, _WINDOW_CLAMP, _table_on,
                    fwd_kv_ranges, load_fn)

__all__ = ["STAGES", "MASK_STAGES", "ablation_plain", "ablation_kernel",
           "ablation_attention", "visited_blocks"]

STAGES = ("mxu_floor", "rowmax", "exp2", "sum", "general", "sum_mxu",
          "nomax", "nomax_summxu", "bf16exp", "maskadd", "masksel")
MASK_STAGES = ("maskadd", "masksel")
BN = 128  # the stages' keys per KV tile: the forward's at D 64 and 128
LOG2E = 1.4426950408889634
NOMAX_BOUND = 16.0  # the fixed bound of the nomax stages (exp2 domain)


def _check(q, k, v, stage, window_size):
    """The shapes every stage takes; raises on anything else."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages: {STAGES}")
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2] or k.shape[3] != q.shape[3] \
            or q.shape[1] % k.shape[1]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.shape[2] % BM:
        raise ValueError(f"N = {q.shape[2]} must be a multiple of {BM}")


def visited_blocks(n: int, num_sink: int, window_size: int):
    """(blocks, valid), int64 and bool [steps, n / BM]: the KV block that
    each q block visits at each step (sink range, then window range), and
    whether that step exists for it."""
    table = torch.from_numpy(fwd_kv_ranges(n, n, num_sink, window_size, 0,
                                           0, BM, BN).astype("int64"))
    n_sink = (table[:, 1] - table[:, 0]).clamp(min=0)
    n_all = n_sink + (table[:, 3] - table[:, 2]).clamp(min=0)
    t = torch.arange(max(int(n_all.max()), 1))[:, None]
    blocks = torch.where(t < n_sink, table[:, 0] + t,
                         table[:, 2] + t - n_sink)
    valid = t < n_all
    return torch.where(valid, blocks, 0), valid


def _rounded_scale(d: int, dtype) -> float:
    """log2(e) / sqrt(d) rounded to ``dtype``, as JAX rounds the Python
    constant to the type of the bf16 q it multiplies."""
    return float(torch.tensor(LOG2E / math.sqrt(d), dtype=dtype))


def _exp2_jax(x: torch.Tensor) -> torch.Tensor:
    """exp2 as the JAX reference evaluates it on the CPU: exp(ln2 * x),
    with ln2 and the product in x's type, the exp in fp32 (fp32 result)."""
    return torch.exp((x * torch.tensor(math.log(2.0), dtype=x.dtype,
                                       device=x.device)).float())


def ablation_plain(q, k, v, stage: str, num_sink: int = 4,
                   window_size: int = 4096):
    """The stage's plain PyTorch version: the kernel's schedule replayed
    step by step, vectorised over the q blocks, so each row's fp32 update
    order is the kernel's. Never forms an [N, N] score matrix."""
    _check(q, k, v, stage, window_size)
    B, H_q, N, D = q.shape
    H_kv = k.shape[1]
    g, nb = H_q // H_kv, N // BM
    dev = q.device
    blocks, valid = (t.to(dev) for t in visited_blocks(N, num_sink,
                                                       window_size))
    c = torch.tensor(_rounded_scale(D, q.dtype), dtype=q.dtype, device=dev)
    qs = (q * c).float().reshape(B, H_kv, g, nb, BM, D)
    kb = k.reshape(B, H_kv, nb, BN, D)
    vb = v.reshape(B, H_kv, nb, BN, D)
    rows = torch.arange(N, device=dev).reshape(nb, BM, 1)
    m = torch.full((B, H_kv, g, nb, BM), -math.inf, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H_kv, g, nb, BM, D, device=dev)
    masked = stage in ("general",) + MASK_STAGES
    for blk, ok in zip(blocks, valid):
        s = torch.einsum("bhgqid,bhqjd->bhgqij", qs, kb[:, :, blk].float())
        if masked:
            cols = (blk * BN)[:, None, None] + torch.arange(BN, device=dev)
            vis = (cols <= rows) & ((cols < num_sink) |
                                    (cols >= rows - window_size + 1))
            s = torch.where(vis, s, -math.inf)
        alpha = None
        lsum = None
        if stage == "mxu_floor":
            p = s
        elif stage in ("nomax", "nomax_summxu"):
            p = _exp2_jax(s - NOMAX_BOUND)
            lsum = (p.to(torch.bfloat16).float() if stage == "nomax_summxu"
                    else p).sum(-1)
        else:
            row_max = s.amax(-1)
            if stage in MASK_STAGES:  # the guarded update
                m_new = torch.where(row_max > -math.inf,
                                    torch.maximum(m, row_max), m)
                m_use = torch.where(m_new > -math.inf, m_new, 0.0)
                alpha = torch.where(m > -math.inf, _exp2_jax(m - m_use), 0.0)
            else:
                m_new = m_use = torch.maximum(m, row_max)
                alpha = _exp2_jax(m - m_new)
            x = s - m_use[..., None]
            if stage == "rowmax":
                p = s
            elif stage == "bf16exp":
                p = _exp2_jax(x.to(torch.bfloat16))
                lsum = p.sum(-1)
            else:
                p = _exp2_jax(x)
                if stage == "sum_mxu":
                    lsum = p.to(torch.bfloat16).float().sum(-1)
                elif stage != "exp2":
                    lsum = p.sum(-1)
            m = torch.where(ok[:, None], m_new, m)
        pv = torch.einsum("bhgqij,bhqjd->bhgqid", p.to(v.dtype).float(),
                          vb[:, :, blk].float())
        acc_new = acc * alpha[..., None] + pv if alpha is not None \
            else acc + pv
        acc = torch.where(ok[:, None, None], acc_new, acc)
        if lsum is not None:
            l_new = l * alpha + lsum if alpha is not None else l + lsum
            l = torch.where(ok[:, None], l_new, l)
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.reshape(B, H_q, N, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = _build.load("ablation")
    if (lib.sink_ablation_block_m(), lib.sink_ablation_block_n()) != (BM, BN):
        raise RuntimeError("csrc/ablation.cu and ops/flash.py disagree on "
                           "the tile sizes")
    return (load_fn("ablation", "sink_ablation_bf16", 5, 8),
            load_fn("ablation", "sink_mask_stage_bf16", 6, 8))


@functools.lru_cache(maxsize=None)
def mask_tiles(stage: str, device) -> torch.Tensor:
    """The constant mask tiles of a mask stage, on ``device`` (JAX passes
    them as kernel inputs): ``maskadd`` two bf16 {0, -inf} tiles, ii >= jj
    and its complement; ``masksel`` one int8 tile ii >= jj."""
    ii = torch.arange(BM)[:, None]
    jj = torch.arange(BN)[None, :]
    diag = ii >= jj
    if stage == "maskadd":
        zero, ninf = torch.tensor(0.0), torch.tensor(-math.inf)
        tiles = torch.stack([torch.where(diag, zero, ninf),
                             torch.where(diag, ninf, zero)])
        return tiles.to(torch.bfloat16).to(device)
    return diag.to(torch.int8)[None].to(device)


def ablation_kernel(q, k, v, stage: str, num_sink: int = 4,
                    window_size: int = 4096):
    """Launch the stage's kernel of ``csrc/ablation.cu`` on CUDA tensors:
    out [B, H_q, N, D] bf16. q/k/v bf16 with D in (64, 128), N a multiple
    of 128. ``ablation_kernel.launches`` counts ``sink_ablation_bf16``,
    ``ablation_kernel.launches_mask_stage`` ``sink_mask_stage_bf16``."""
    _build.check_attention_inputs(q, k, v, None)
    # a measuring script's headline shapes: bf16 at head_dim 64 or 128
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the ablation kernels take bf16, got {q.dtype}")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"the ablation kernels take head_dim 64 or 128, "
                         f"got {q.shape[-1]}")
    _check(q, k, v, stage, window_size)
    if not q.is_cuda:
        raise ValueError("the CUDA ablation kernels take CUDA tensors")
    B, H_q, N, D = q.shape
    H_kv = k.shape[1]
    ns, w = (min(int(x), _WINDOW_CLAMP) for x in (num_sink, window_size))
    ranges = _table_on(fwd_kv_ranges, q.device, N, N, ns, w, 0, 0, BM, BN)
    qc, kc, vc = (_build.aligned(t) for t in (q, k, v))
    out = torch.empty_like(qc)
    mask_stage = stage in MASK_STAGES
    tensors = [qc, kc, vc, ranges]
    if mask_stage:
        tensors.append(mask_tiles(stage, q.device))
    ptrs = [_build.ptr(t) for t in (*tensors, out)]
    name = "sink_mask_stage_bf16" if mask_stage else "sink_ablation_bf16"
    code = _kernel_fns()[mask_stage](
        *ptrs, B, H_q, H_kv, N, D, ns, w, STAGES.index(stage),
        _rounded_scale(D, torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(code, name)
    if mask_stage:
        ablation_kernel.launches_mask_stage += 1
    else:
        ablation_kernel.launches += 1
    ablation_kernel.coverage.add((D, "bfloat16"))
    return out


ablation_kernel.launches = 0
ablation_kernel.launches_mask_stage = 0
ablation_kernel.coverage = set()  # (head_dim, dtype) pairs run


def ablation_attention(q, k, v, stage: str, num_sink: int = 4,
                       window_size: int = 4096):
    """One ablation stage: the plain version on CPU tensors, the kernel on
    CUDA tensors (or it raises)."""
    if q.device.type == "cpu":
        return ablation_plain(q, k, v, stage, num_sink, window_size)
    if q.is_cuda:
        return ablation_kernel(q, k, v, stage, num_sink, window_size)
    raise ValueError(f"unsupported device {q.device}")
