"""Weight-only INT8 and packed-INT4 quantization for serving.

Counterpart of ``sink_attention_tpu/models/quant.py``. A quantized weight
is the dict ``{"q": int8, "s": scales}`` (int8, one scale per output
channel) or ``{"q4": packed int8, "s": scales}`` (int4 in the nibble
format of ``ops.int4``, per output channel or per group of rows) in place
of the plain tensor; every forward of ``models.model`` takes either form
(``_mm``, ``_expert_mm``, ``_routed_expert_mm``, ``_embed_lookup``).

Quantized: wq/wk/wv/wo, the MoE's gate_up/down (per expert and output
channel) or the dense MLP's gate/up/down, the lm_head, and the embedding
(per row: its rows are gathered, never contracted; it stays int8 in an
int4 tree). Kept in full precision: biases, norms, the router, sinks. The
scales are stored in the compute dtype, which the embedding lookup hands
on as the activations' dtype.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..ops.int4 import pack_int4
from ..utils.device import resolve_device

__all__ = ["quantize_weight", "quantize_params", "is_quantized",
           "is_quantized4", "quantize_weight_int4",
           "init_quantized_params"]

# experts drawn (and quantized) at a time by init_quantized_params
EXPERT_SLICE = 16


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def is_quantized4(w: Any) -> bool:
    return isinstance(w, dict) and "q4" in w and "s" in w


def quantize_weight(w: torch.Tensor, contract_axis: int = -2,
                    scale_dtype: torch.dtype = torch.float32) -> dict:
    """Symmetric int8 quantization, one scale per non-contracted channel.

    ``contract_axis`` is the axis the matmul sums over: a 2D [in, out]
    weight gets per-output-column scales [1, out], stacked expert weights
    [E, in, out] per-(expert, column) scales [E, 1, out]. bf16 input
    quantizes in bf16, fp32 in fp32; rounding is half to even.
    ``scale_dtype`` is also the compute dtype of the quantized model.
    """
    ca = contract_axis % w.dim()
    cdt = torch.float32 if w.element_size() >= 4 else w.dtype
    wf = w.to(cdt)
    amax = wf.abs().amax(dim=ca, keepdim=True).float()
    scale = torch.where(amax == 0.0, 1.0, amax / 127.0)
    q = (wf / scale.to(cdt)).round_().clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(scale_dtype)}


def _quantize_rowwise(w: torch.Tensor, scale_dtype: torch.dtype) -> dict:
    """Per-row scales (the embedding: rows are gathered, the row axis is
    never contracted)."""
    return quantize_weight(w, contract_axis=-1, scale_dtype=scale_dtype)


def quantize_weight_int4(w: torch.Tensor, contract_axis: int = -2,
                         scale_dtype: torch.dtype = torch.float32,
                         group_size: Optional[int] = None) -> dict:
    """INT4 quantize + pack (``ops.int4.pack_int4``'s nibble format):
    ``{"q4": packed int8 [.., K/2, ..], "s": scales}``, per output
    channel, or per (``group_size`` rows x channel) when set."""
    packed, scale = pack_int4(w, contract_axis, group_size=group_size)
    return {"q4": packed, "s": scale.to(scale_dtype)}


def _mlp_big(mlp: dict):
    """The quantized MLP weights: gate/up/down of a dense (Qwen/Llama)
    layer, gate_up/down of an MoE layer."""
    return ("gate", "up", "down") if "gate" in mlp else ("gate_up", "down")


def quantize_params(params: dict, cfg=None,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    inplace: bool = False) -> dict:
    """Quantize a model parameter tree to int8 for serving.

    Returns a tree with the large weights replaced by ``{"q", "s"}``
    dicts, scales in ``compute_dtype`` (the quantized model's activation
    dtype). ``inplace=True`` replaces the entries of ``params`` one tensor
    at a time, so each source tensor is dropped (when nothing else holds
    it) before the next is quantized: the peak stays near the larger of
    the two trees plus one tensor's transients. The mutated ``params`` is
    the returned tree. ``cfg`` is accepted for JAX's signature and unused.
    """
    def qw(w):
        return quantize_weight(w, scale_dtype=compute_dtype)

    if inplace:
        params["embed"] = _quantize_rowwise(params["embed"], compute_dtype)
        for lp in params["layers"]:
            for name in ("wq", "wk", "wv", "wo"):
                lp["attn"][name] = qw(lp["attn"][name])
            for name in _mlp_big(lp["mlp"]):
                lp["mlp"][name] = qw(lp["mlp"][name])
        params["lm_head"] = qw(params["lm_head"])
        return params
    out = {"embed": _quantize_rowwise(params["embed"], compute_dtype),
           "final_norm": params["final_norm"],
           "lm_head": qw(params["lm_head"]),
           "layers": []}
    for lp in params["layers"]:
        attn = dict(lp["attn"])
        for name in ("wq", "wk", "wv", "wo"):
            attn[name] = qw(attn[name])
        mlp = dict(lp["mlp"])
        for name in _mlp_big(mlp):
            mlp[name] = qw(mlp[name])
        out["layers"].append({"attn": attn, "mlp": mlp, "ln1": lp["ln1"],
                              "ln2": lp["ln2"]})
    return out


def init_quantized_params(cfg, generator: torch.Generator,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          init_dtype: torch.dtype = torch.bfloat16,
                          bits: int = 8,
                          int4_group_size: Optional[int] = None,
                          device="cuda") -> dict:
    """Random-init a model directly in quantized form, one tensor at a
    time, for models whose full-precision weights exceed the card
    (gpt-oss-120b: 233.6 GB in bf16, 58.7 GB in int4).

    The tree of ``init_params`` followed by quantization: weights
    normal(0, 0.02) drawn in ``init_dtype``, biases zero, sinks normal(0,
    1), norms one. ``bits`` 8 quantizes every large weight to int8; ``bits``
    4 packs the layers' weights and the lm_head to int4 (group-wise with
    ``int4_group_size``) and keeps the embedding int8 (it is gathered, and
    the packed halves have no gather). Each weight is drawn, quantized and
    dropped before the next, so the peak stays near the quantized total
    plus one weight's transients.

    The stream: ``generator`` (on ``device``) draws, with one ``normal_``
    call each, the embedding, the lm_head, then per layer wq, wk, wv, wo,
    sinks (if the model has them), then the router and the stacked
    gate_up and down in slices of ``EXPERT_SLICE`` experts in expert
    order (MoE), or gate, up, down (dense). Per-(expert, channel) scales
    make the slices' quantization that of the whole stack. The numbers
    differ from JAX's and from ``quantize_params(init_params(...))``.
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    dev = resolve_device(device)
    H, D = cfg.hidden_size, cfg.head_dim
    HQ, HKV = cfg.num_heads, cfg.num_kv_heads
    I, E = cfg.intermediate_size, cfg.num_experts

    def w(shape, scale=0.02):
        return torch.empty(shape, dtype=init_dtype, device=dev).normal_(
            0.0, scale, generator=generator)

    def quant(full):
        if bits == 4:
            return quantize_weight_int4(full, scale_dtype=compute_dtype,
                                        group_size=int4_group_size)
        return quantize_weight(full, scale_dtype=compute_dtype)

    def qw(shape):
        return quant(w(shape))

    def qw_experts(shape):
        # one slice of experts drawn and quantized at a time
        parts = [quant(w((min(EXPERT_SLICE, shape[0] - e0),) + shape[1:]))
                 for e0 in range(0, shape[0], EXPERT_SLICE)]
        return {k: torch.cat([p[k] for p in parts]) if len(parts) > 1
                else parts[0][k] for k in parts[0]}

    def zeros(shape):
        return torch.zeros(shape, dtype=init_dtype, device=dev)

    def ones(shape):
        return torch.ones(shape, dtype=init_dtype, device=dev)

    # embed and lm_head first: their transients (vocab x H) are the
    # largest, so they come while little is resident
    embed = _quantize_rowwise(w((cfg.vocab_size, H)), compute_dtype)
    lm_head = qw((H, cfg.vocab_size))
    layers = []
    for _ in range(cfg.num_layers):
        attn = {"wq": qw((H, HQ * D)), "bq": zeros((HQ * D,)),
                "wk": qw((H, HKV * D)), "bk": zeros((HKV * D,)),
                "wv": qw((H, HKV * D)), "bv": zeros((HKV * D,)),
                "wo": qw((HQ * D, H)), "bo": zeros((H,))}
        if cfg.use_s_aux:
            attn["sinks"] = w((HQ,), scale=1.0)
        if cfg.mlp_type == "dense":
            mlp = {"gate": qw((H, I)), "up": qw((H, I)), "down": qw((I, H))}
        else:
            mlp = {"router_w": w((H, E)), "router_b": zeros((E,)),
                   "gate_up": qw_experts((E, H, 2 * I)),
                   "gate_up_b": zeros((E, 2 * I)),
                   "down": qw_experts((E, I, H)), "down_b": zeros((E, H))}
        layers.append({"attn": attn, "mlp": mlp, "ln1": ones((H,)),
                       "ln2": ones((H,))})
    return {"embed": embed, "layers": layers, "lm_head": lm_head,
            "final_norm": ones((H,))}
