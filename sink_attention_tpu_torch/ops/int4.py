"""Packed-INT4 weight-only matmul: the nibble format and its decode.

Counterpart of ``sink_attention_tpu/ops/int4.py``. Two int4 values sit in
one int8 byte, decoded to bf16 on the fly and fed to two products against
the two halves of ``x``.

**Packing** (``pack_int4``): the contract dimension K is split in halves,
not interleaved. Packed byte ``p[k, n]`` holds ``w[k, n]`` in its low
nibble and ``w[K/2 + k, n]`` in its high nibble, so decoding is two
sign-extends and two matmuls against the two halves of x, with no
interleave.

In JAX these ops are XLA, which fuses the nibble decode into the dot's
operand read. Here they are plain PyTorch: the decoded bf16 halves are
materialised before the products (a fused dequantising GEMM for the card
is later work). The decode runs in int8 arithmetic, never on an int32 copy
of the weight, and gives the numbers of JAX's int32 decode bit for bit.

Arithmetic, as in JAX: x is cast to bf16; the two half-products go into
one fp32 accumulator (on the card a bf16 GEMM with an fp32 output, on the
CPU an fp32 product of the bf16 values); a per-channel scale multiplies
the fp32 sum, group-wise scales multiply the bf16 halves; the result is
cast to x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["pack_int4", "int4_matmul", "int4_matmul_experts"]


def pack_int4(w: torch.Tensor, contract_axis: int = -2,
              group_size: Optional[int] = None):
    """Quantize + pack a weight to int4 along ``contract_axis``.

    Returns ``(packed int8 [..., K/2, ...], scales fp32)``. With
    ``group_size=None`` the scales have the weight's shape with the
    contract axis reduced to 1 (one scale per output channel); with
    ``group_size=g`` the contract axis becomes ``K/g``, one scale per
    g-row group per output channel. K must be even and g must divide K/2,
    so the lo/hi halves stay group-aligned. bf16 input quantizes in bf16,
    fp32 in fp32; rounding is half to even, as ``jnp.round``'s.
    """
    ca = contract_axis % w.dim()
    K = w.shape[ca]
    if K % 2:
        raise ValueError(f"the contract axis must be even, got K={K}")
    if group_size is not None and (K // 2) % group_size:
        raise ValueError(f"group_size {group_size} must divide K/2 = "
                         f"{K // 2}")
    cdt = torch.float32 if w.element_size() >= 4 else w.dtype
    wf = w.to(cdt)
    if group_size is None:
        amax = wf.abs().amax(dim=ca, keepdim=True).float()
        scale = torch.where(amax == 0.0, 1.0, amax / 7.0)
        q = wf / scale.to(cdt)
    else:
        shp = list(wf.shape)
        shp[ca:ca + 1] = [K // group_size, group_size]
        amax = wf.reshape(shp).abs().amax(dim=ca + 1).float()  # [.., K/g, ..]
        scale = torch.where(amax == 0.0, 1.0, amax / 7.0)
        # each group's scale broadcast over its rows: repeat's values
        q = (wf.reshape(shp) / scale.unsqueeze(ca + 1).to(cdt)).reshape(
            wf.shape)
    q = q.round_().clamp_(-7, 7).to(torch.int8)
    lo, hi = q.chunk(2, dim=ca)
    return (lo & 0x0F) | (hi << 4), scale


def _unpack_bf16(packed: torch.Tensor):
    """Decode nibble-packed bytes to bf16 (lo, hi) halves, in int8
    arithmetic: ``(p << 4) >> 4`` sign-extends the low nibble (the shift
    left wraps in int8), ``p >> 4`` the high one (an arithmetic shift)."""
    lo = ((packed << 4) >> 4).to(torch.bfloat16)
    hi = (packed >> 4).to(torch.bfloat16)
    return lo, hi


def _grouped_halves(lo, hi, scale, K2):
    """Apply per-group scales [..., K/g, N] to the decoded bf16 halves:
    row k's group is k // g, and the hi half holds rows K/2 + k. The
    scales are applied in bf16, as in JAX (int4 rounding dwarfs the bf16
    scale rounding)."""
    G, N = scale.shape[-2:]
    g = 2 * K2 // G
    s = scale.to(torch.bfloat16).unsqueeze(-2)           # [..., G, 1, N]
    lead = lo.shape[:-2]

    def scaled(half, groups):
        return (half.reshape(*lead, G // 2, g, N) * groups).reshape(
            half.shape)

    return (scaled(lo, s[..., :G // 2, :, :]),
            scaled(hi, s[..., G // 2:, :, :]))


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands ([T, K] x [K, N] or batched [E, T, K] x
    [E, K, N]) summed in fp32, with an fp32 result: on the card one bf16
    GEMM with an fp32 output, on the CPU an fp32 product of the same
    bf16 values."""
    if a.is_cuda:
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """``x [T, K] @ unpack(packed [K/2, N]) * scale -> [T, N]``, in x's
    dtype. ``scale``: [1, N] (or [N]) per-output-channel scales, or
    [K/g, N] group-wise scales from ``pack_int4(group_size=g)``."""
    T, K = x.shape
    K2, N = packed.shape
    if K != 2 * K2:
        raise ValueError(f"x has K={K}, the packed weight K/2={K2}")
    lo, hi = _unpack_bf16(packed)
    xb = x.to(torch.bfloat16)
    grouped = scale.dim() == 2 and scale.shape[0] > 1
    if grouped:
        lo, hi = _grouped_halves(lo, hi, scale, K2)
    acc = _dot_f32(xb[:, :K2], lo) + _dot_f32(xb[:, K2:], hi)
    if not grouped:
        acc = acc * scale.reshape(1, N)
    return acc.to(x.dtype)


def int4_matmul_experts(x: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Batched experts against packed ``[E, K/2, N]`` weights with scales
    ``[E, 1, N]`` (per-output-channel) or ``[E, K/g, N]`` (group-wise).
    ``x`` is [T, K] (shared by the experts: the dense MoE's gate_up) or
    [E, T, K] (per-expert activations: its down projection). Returns
    [E, T, N] in x's dtype."""
    E, K2, N = packed.shape
    if x.shape[-1] != 2 * K2:
        raise ValueError(f"x has K={x.shape[-1]}, the packed weight "
                         f"K/2={K2}")
    T = x.shape[-2]
    lo, hi = _unpack_bf16(packed)
    xb = x.to(torch.bfloat16)
    if x.dim() == 2:
        xb = xb.expand(E, T, 2 * K2)
    grouped = scale.dim() == 3 and scale.shape[1] > 1
    if grouped:
        lo, hi = _grouped_halves(lo, hi, scale, K2)
    acc = _dot_f32(xb[..., :K2], lo) + _dot_f32(xb[..., K2:], hi)
    if not grouped:
        acc = acc * scale.reshape(E, 1, N)
    return acc.to(x.dtype)
