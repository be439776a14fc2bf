"""gpt-oss-style causal LM on the sink-attention CUDA kernels, in PyTorch.

Counterpart of ``sink_attention_tpu/models/model.py`` (its gpt-oss and
dense paths). Parameters are the same nested dict as the JAX package's,
leaf by leaf, with weights stored [in, out] so the model computes
``x @ w``; ``models.convert.params_from_jax`` carries a JAX tree over.
The large weights may be int8 or packed-int4 dicts (``models.quant``):
every forward dispatches on the leaf's form (``_mm``, ``_expert_mm``,
``_routed_expert_mm``, ``_embed_lookup``, as in JAX); the router, biases,
norms and sinks stay in full precision. Semantics as in the JAX model:

* attention sinks as a learnable per-head extra softmax logit (s_aux);
* alternating sliding/full attention layers;
* MoE with top-k-then-softmax routing and interleaved gate/up experts with
  the gpt-oss clamp activation: glu = gate * sigmoid(1.702 * gate),
  out = (up + 1) * glu, gate clamped to (-inf, 7], up to [-7, 7];
* chunk-convention RoPE with optional YaRN scaling.

With a process group (``group=``, the prefill, decode and training
forwards), the block runs tensor parallel: ``cfg`` is then
``parallel.tp.tp_local_config``'s per-rank view and the parameters this
rank's shard (``parallel.train.param_shardings``), and the block enters
and leaves its head- and expert-split regions through the Megatron
operators of ``parallel._collectives``, as the JAX package's
``tp_decoder_layer``.

Dtype policy (as in JAX): norms and rope in fp32, the MoE combine
accumulated in fp32. Prefill attention runs the CUDA prefill kernel (and,
when training, the dQ and dK/dV kernels in the backward), decode the CUDA
decode kernel over the rolling sink cache (bf16, int8 or fp8 storage), and
the ragged decode of continuous batching the same kernel over a
``RaggedSinkKVCache``. The verify forwards of speculative decoding run T
draft tokens against the caches without advancing them, through the
multi-token ops (plain PyTorch, as in JAX they are XLA).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.utils.checkpoint

from ..cache import RaggedSinkKVCache, SinkKVCache
from ..ops import (sink_decode_attention_cached, sink_decode_attention_ragged,
                   sink_flash_attention)
from ..ops.decode import (_cached_multi_attention,
                          sink_decode_attention_ragged_multi)
from ..ops.int4 import int4_matmul, int4_matmul_experts
from ..parallel._collectives import tp_gather, tp_region_in, tp_region_out
from ..utils.device import resolve_device
from .config import ModelConfig
from .quant import is_quantized, is_quantized4

__all__ = ["init_params", "rms_norm", "rope_cos_sin", "apply_rope", "moe",
           "moe_routing", "moe_experts", "dense_mlp", "mlp_block",
           "decoder_layer", "forward_prefill", "forward_decode",
           "forward_decode_ragged", "forward_verify", "forward_verify_ragged",
           "make_caches", "make_ragged_caches"]

ALPHA = 1.702  # gpt-oss glu activation alpha
LIMIT = 7.0    # gpt-oss activation clamp


# ---------------------------------------------------------------------------
# Matmuls on plain, int8 ({"q", "s"}) or packed-int4 ({"q4", "s"}) weights
# ---------------------------------------------------------------------------


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` for a plain, int8 or packed-int4 weight.
    int8: ``(x @ q.to(x.dtype)) * s.to(x.dtype)``; int4: ``ops.int4``."""
    if is_quantized4(w):
        y = int4_matmul(x.reshape(-1, x.shape[-1]), w["q4"], w["s"])
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w.to(x.dtype)


def _expert_mm(x: torch.Tensor, w) -> torch.Tensor:
    """Stacked experts' product: x [T, K] shared by the experts (the dense
    MoE's gate_up) or [E, T, K] per expert (its down), against w [E, K, N]
    plain, int8 or packed-int4 -> [E, T, N] (the plain and int8 forms
    broadcast through :func:`_mm`)."""
    if is_quantized4(w):
        return int4_matmul_experts(x, w["q4"], w["s"])
    return _mm(x, w)


def _routed_expert_mm(xt: torch.Tensor, w, e: int) -> torch.Tensor:
    """Expert ``e``'s product on xt [T, K], reading only that expert's
    weights (any form: its slice of each leaf through :func:`_mm`)."""
    return _mm(xt, {k: v[e] for k, v in w.items()} if isinstance(w, dict)
               else w[e])


def _embed_lookup(embed, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of ``ids``; an int8 table is dequantized in its
    scales' dtype, the quantized model's compute dtype."""
    if is_quantized(embed):
        ct = embed["s"].dtype
        return embed["q"][ids].to(ct) * embed["s"][ids].to(ct)
    return embed[ids]


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device="cuda",
                shardings=None) -> dict:
    """Random-init parameter tree (normal(0, 0.02), biases zero, sinks
    normal(0, 1)), the same tree and distributions as the JAX package.
    ``generator`` must live on ``device``; the numbers differ from JAX's.

    ``shardings`` (a tree of ``parallel.mesh.NamedSharding``, as
    ``parallel.train.param_shardings`` returns): each leaf is drawn whole,
    in the same order, and only this rank's block of it is kept, so the
    blocks are those of the whole tree bit for bit while the peak is this
    rank's blocks and one whole leaf."""
    dev = resolve_device(device)
    H, D = cfg.hidden_size, cfg.head_dim
    HQ, HKV = cfg.num_heads, cfg.num_kv_heads
    I, E = cfg.intermediate_size, cfg.num_experts

    def keep(t, path):
        """This rank's block of a leaf just drawn whole."""
        if shardings is None:
            return t
        s = shardings
        for key in path:
            s = s[key]
        return s.local_block(t) if any(s.spec) else t

    def w(path, shape, scale=0.02):
        return keep(torch.empty(shape, dtype=dtype, device=dev).normal_(
            0.0, scale, generator=generator), path)

    def zeros(path, shape):
        return keep(torch.zeros(shape, dtype=dtype, device=dev), path)

    def ones(path, shape):
        return keep(torch.ones(shape, dtype=dtype, device=dev), path)

    layers = []
    for li in range(cfg.num_layers):
        a, m = ("layers", li, "attn"), ("layers", li, "mlp")
        attn = {
            "wq": w(a + ("wq",), (H, HQ * D)), "bq": zeros(a + ("bq",),
                                                          (HQ * D,)),
            "wk": w(a + ("wk",), (H, HKV * D)), "bk": zeros(a + ("bk",),
                                                           (HKV * D,)),
            "wv": w(a + ("wv",), (H, HKV * D)), "bv": zeros(a + ("bv",),
                                                           (HKV * D,)),
            "wo": w(a + ("wo",), (HQ * D, H)), "bo": zeros(a + ("bo",),
                                                          (H,)),
        }
        if cfg.use_s_aux:
            attn["sinks"] = w(a + ("sinks",), (HQ,), scale=1.0)
        if cfg.mlp_type == "dense":
            mlp = {"gate": w(m + ("gate",), (H, I)),
                   "up": w(m + ("up",), (H, I)),
                   "down": w(m + ("down",), (I, H))}
        else:
            mlp = {
                "router_w": w(m + ("router_w",), (H, E)),
                "router_b": zeros(m + ("router_b",), (E,)),
                "gate_up": w(m + ("gate_up",), (E, H, 2 * I)),
                "gate_up_b": zeros(m + ("gate_up_b",), (E, 2 * I)),
                "down": w(m + ("down",), (E, I, H)),
                "down_b": zeros(m + ("down_b",), (E, H)),
            }
        layers.append({"attn": attn, "mlp": mlp,
                       "ln1": ones(("layers", li, "ln1"), (H,)),
                       "ln2": ones(("layers", li, "ln2"), (H,))})
    return {
        "embed": w(("embed",), (cfg.vocab_size, H)),
        "layers": layers,
        "final_norm": ones(("final_norm",), (H,)),
        "lm_head": w(("lm_head",), (H, cfg.vocab_size)),
    }


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = weight.float() * (xf * torch.rsqrt(var + eps))
    return y.to(x.dtype)


def _yarn_inv_freq(cfg: ModelConfig) -> Tuple[torch.Tensor, float]:
    """YaRN rope (transformers ROPE_INIT_FUNCTIONS['yarn'])."""
    rs = cfg.rope_scaling
    D = cfg.head_dim
    base = cfg.rope_theta
    factor = rs.get("factor", 1.0)
    orig_max = rs.get("original_max_position_embeddings",
                      cfg.max_position_embeddings)
    beta_fast = rs.get("beta_fast", 32.0)
    beta_slow = rs.get("beta_slow", 1.0)
    mscale = rs.get("attention_factor")
    if mscale is None:
        mscale = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0

    pos_freqs = base ** (torch.arange(0, D, 2, dtype=torch.float32) / D)
    inv_freq_extrapolation = 1.0 / pos_freqs
    inv_freq_interpolation = 1.0 / (factor * pos_freqs)

    def find_dim(num_rotations):
        return (D * math.log(orig_max / (num_rotations * 2 * math.pi))
                ) / (2 * math.log(base))

    low = max(math.floor(find_dim(beta_fast)), 0)
    high = min(math.ceil(find_dim(beta_slow)), D - 1)
    if low == high:
        high += 0.001
    ramp = (torch.arange(D // 2, dtype=torch.float32) - low) / (high - low)
    inv_freq_mask = 1.0 - ramp.clamp(0.0, 1.0)
    inv_freq = (inv_freq_interpolation * (1 - inv_freq_mask) +
                inv_freq_extrapolation * inv_freq_mask)
    return inv_freq, float(mscale)


def rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor):
    """cos/sin [..., D/2] fp32 (chunk convention, HF GptOss parity)."""
    if cfg.rope_scaling and cfg.rope_scaling.get("rope_type") == "yarn":
        inv_freq, scaling = _yarn_inv_freq(cfg)
    else:
        D = cfg.head_dim
        inv_freq = 1.0 / (cfg.rope_theta ** (
            torch.arange(0, D, 2, dtype=torch.float32) / D))
        scaling = 1.0
    freqs = positions.float()[..., None] * inv_freq.to(positions.device)
    return torch.cos(freqs) * scaling, torch.sin(freqs) * scaling


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: [B, H, N, D]; cos/sin: [N, D/2] or [B, N, D/2]."""
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    d2 = x.shape[-1] // 2
    xf1, xf2 = x[..., :d2].float(), x[..., d2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """x: [B, N, H] -> q [B,HQ,N,D], k/v [B,HKV,N,D]."""
    B, N, _ = x.shape
    D = cfg.head_dim

    def proj(w, b, heads):
        y = _mm(x, w)
        if cfg.attention_bias:
            y = y + b.to(y.dtype)
        return y.reshape(B, N, heads, D).transpose(1, 2)

    return (proj(p["wq"], p["bq"], cfg.num_heads),
            proj(p["wk"], p["bk"], cfg.num_kv_heads),
            proj(p["wv"], p["bv"], cfg.num_kv_heads))


def _out_proj(p: dict, cfg: ModelConfig, attn: torch.Tensor,
              group=None) -> torch.Tensor:
    """attn: [B, HQ, N, D] -> [B, N, H]; with ``group``, the partial
    products of this rank's heads summed over it before the bias."""
    B, HQ, N, D = attn.shape
    y = _mm(attn.transpose(1, 2).reshape(B, N, HQ * D), p["wo"])
    if group is not None:
        y = tp_region_out(y, group)
    if cfg.o_bias:
        y = y + p["bo"].to(y.dtype)
    return y


def _s_aux(lp: dict, cfg: ModelConfig) -> Optional[torch.Tensor]:
    """Per-head sink logits (fp32), or None for dense-family models."""
    if not cfg.use_s_aux:
        return None
    return lp["attn"]["sinks"].float()


def _glu_act(gate_up: torch.Tensor) -> torch.Tensor:
    """gpt-oss interleaved gate/up clamp activation."""
    gate = gate_up[..., ::2].clamp(max=LIMIT)
    up = gate_up[..., 1::2].clamp(-LIMIT, LIMIT)
    glu = gate * torch.sigmoid(gate * ALPHA)
    return (up + 1.0) * glu


def _moe_grouped(p: dict, cfg: ModelConfig, xt: torch.Tensor,
                 routing: torch.Tensor) -> torch.Tensor:
    """Grouped-expert MoE: one step per routed expert, all tokens at once,
    reading only the routed experts' weights. The routed expert ids come
    to the host (one device sync per layer). Returns [T, H] fp32."""
    T, H = xt.shape
    active = torch.nonzero(routing.sum(dim=0) > 0.0).flatten().tolist()
    acc = torch.zeros((T, H), dtype=torch.float32, device=xt.device)
    for e in active:
        w_col = routing[:, e]
        pre = _routed_expert_mm(xt, p["gate_up"], e)
        act = _glu_act(pre + p["gate_up_b"][e].to(xt.dtype))
        down = _routed_expert_mm(act, p["down"], e)
        acc = acc + w_col[:, None] * (
            down + p["down_b"][e].to(act.dtype)).float()
    return acc


def dense_mlp(p: dict, x: torch.Tensor, group=None) -> torch.Tensor:
    """Gated-SiLU MLP (Qwen/Llama family): down(silu(gate(x)) * up(x)).
    With ``group``: gate / up hold this rank's columns and down its rows
    (Megatron's split); the partial products are summed over the group."""
    if group is not None:
        x = tp_region_in(x, group)
    g = _mm(x, p["gate"])
    u = _mm(x, p["up"])
    out = _mm(torch.nn.functional.silu(g) * u, p["down"])
    return out if group is None else tp_region_out(out, group)


def mlp_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
              active: Optional[torch.Tensor] = None,
              group=None) -> torch.Tensor:
    """The per-layer MLP: MoE (gpt-oss) or dense gated-SiLU. ``active``
    ([B] bool) marks the rows whose output is kept (see :func:`moe`);
    ``group``: tensor parallel over it."""
    if cfg.mlp_type == "dense":
        return dense_mlp(p, x, group=group)
    return moe(p, cfg, x, active=active, group=group)


def moe(p: dict, cfg: ModelConfig, x: torch.Tensor,
        active: Optional[torch.Tensor] = None, group=None) -> torch.Tensor:
    """gpt-oss MoE block. x: [B, N, H] -> [B, N, H].

    Grouped-by-expert for T = B*N <= moe_grouped_token_limit (decode),
    dense all-experts products otherwise (prefill). ``active`` ([B] bool):
    rows whose output the caller discards (inactive continuous-batching
    slots) get zero routing weights, so the grouped path reads no expert
    weights for them. With ``group`` the experts are split over it (this
    rank holds ``cfg.num_experts`` of them, block ``rank`` of the
    router's columns): the routing enters the region before this rank's
    columns are sliced out of it, so the slice's zero-padded cotangent and
    the region's sum rebuild the whole routing's (slicing first would sum
    cotangents of different columns).
    """
    B, N, H = x.shape
    xt = x.reshape(B * N, H)
    routing = moe_routing(p, cfg, xt)
    if active is not None:
        routing = routing * active.repeat_interleave(N).to(
            routing.dtype)[:, None]
    if group is not None:
        e, r = cfg.num_experts, torch.distributed.get_rank(group)
        routing = tp_region_in(routing, group)[:, r * e:(r + 1) * e]
        xt = tp_region_in(xt, group)
    out = moe_experts(p, cfg, xt, routing)
    if group is not None:
        out = tp_region_out(out, group)
    return out.reshape(B, N, H).to(x.dtype)


def moe_routing(p: dict, cfg: ModelConfig, xt: torch.Tensor) -> torch.Tensor:
    """Router: xt [T, H] -> sparse combine weights [T, E] fp32 (top-k
    first, then softmax over the k)."""
    logits = (xt @ p["router_w"].to(xt.dtype) +
              p["router_b"].to(xt.dtype)).float()
    vals, idx = torch.topk(logits, cfg.experts_per_tok, dim=-1)
    weights = torch.softmax(vals, dim=-1)
    return torch.zeros_like(logits).scatter_(1, idx, weights)


def moe_experts(p: dict, cfg: ModelConfig, xt: torch.Tensor,
                routing: torch.Tensor) -> torch.Tensor:
    """Expert compute + combine: xt [T, H], routing [T, E] -> [T, H] fp32."""
    if xt.shape[0] <= cfg.moe_grouped_token_limit:
        return _moe_grouped(p, cfg, xt, routing)
    gate_up = _expert_mm(xt, p["gate_up"])                     # [E, T, 2I]
    gate_up = gate_up + p["gate_up_b"].to(gate_up.dtype)[:, None, :]
    act = _glu_act(gate_up)
    out = _expert_mm(act, p["down"])                           # [E, T, H]
    out = out + p["down_b"].to(out.dtype)[:, None, :]
    return torch.einsum("eth,te->th", out, routing.to(out.dtype)).float()


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def decoder_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor, cos, sin,
                  window: int, attn_impl, group=None) -> torch.Tensor:
    """One transformer block (attention + MLP) on [B, N, H] activations;
    ``attn_impl(q, k, v, num_sink=, window_size=, s_aux=)``; ``group``:
    tensor parallel over it (``cfg`` and ``lp`` this rank's, see the
    module's docstring)."""
    return _block(lp, cfg, x, cos, sin, lambda q, k, v: attn_impl(
        q, k, v, num_sink=cfg.num_sink_tokens, window_size=window,
        s_aux=_s_aux(lp, cfg)), group=group)


def _block(lp: dict, cfg: ModelConfig, x: torch.Tensor, cos, sin,
           attend, active=None, group=None) -> torch.Tensor:
    """The block around ``attend(q, k, v) -> attn``: norms, QKV, rope,
    residuals, MLP (``active``: see :func:`moe`). With ``group`` the
    normed input enters the head-split region, the heads' partial output
    products are summed over the group before ``bo``, and the MLP is split
    too (:func:`mlp_block`); the attention itself needs no communication."""
    h = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
    if group is not None:
        h = tp_region_in(h, group)
    q, k, v = _qkv(lp["attn"], cfg, h)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    x = x + _out_proj(lp["attn"], cfg, attend(q, k, v), group=group)
    h = rms_norm(x, lp["ln2"], cfg.rms_norm_eps)
    return x + mlp_block(lp["mlp"], cfg, h, active=active, group=group)


def _head(params: dict, cfg: ModelConfig, x: torch.Tensor,
          group=None) -> torch.Tensor:
    """Final norm and lm_head; with ``group`` the lm_head holds this
    rank's vocabulary columns and the logits are gathered over it."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if group is None:
        return _mm(x, params["lm_head"])
    return tp_gather(_mm(tp_region_in(x, group), params["lm_head"]), -1,
                     group)


def _layer_walk(params: dict, cfg: ModelConfig, x: torch.Tensor, cos, sin,
                attn_step, active=None, group=None) -> torch.Tensor:
    """The decoder-layer walk shared by every forward. ``attn_step(li, lp,
    q, k, v) -> attn`` supplies one layer's attention (and any cache
    update). Returns logits [B, T, V]."""
    for li, lp in enumerate(params["layers"]):
        x = _block(lp, cfg, x, cos, sin,
                   lambda q, k, v, li=li, lp=lp: attn_step(li, lp, q, k, v),
                   active=active, group=group)
    return _head(params, cfg, x, group=group)


def forward_prefill(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                    caches: Optional[List[SinkKVCache]] = None,
                    positions: Optional[torch.Tensor] = None,
                    attn_impl=None, remat: bool = False,
                    collect_kv: bool = False, group=None):
    """Full-sequence forward. input_ids: [B, N] -> (logits [B, N, V],
    caches). With ``caches`` (one SinkKVCache per layer), each layer's KV
    is stored in them for decode. With ``collect_kv`` the second value is
    instead each layer's post-RoPE (k, v) [B, H_kv, N, D] (what the
    continuous-batching engine inserts into a ragged cache slot).
    ``positions`` ([N] or [B, N], default
    0..N-1) are the RoPE positions: a packed batch passes its
    segment-local positions here and a packed ``attn_impl``.
    ``attn_impl(q, k, v, num_sink=, window_size=, s_aux=)`` overrides the
    attention (default: the CUDA kernels on the card). ``remat=True`` runs
    each decoder layer under activation checkpointing
    (``torch.utils.checkpoint``, non-reentrant): the backward recomputes
    the layer's activations instead of keeping them, one more forward of
    work for memory O(1) in depth, as ``jax.checkpoint`` does in the JAX
    package. Ignored with ``caches`` or ``collect_kv``. ``group``: tensor
    parallel over it (``cfg``, ``params`` and ``caches`` this rank's; see
    the module's docstring); the logits come whole to every rank."""
    B, N = input_ids.shape
    x = _embed_lookup(params["embed"], input_ids)
    if positions is None:
        positions = torch.arange(N, device=input_ids.device)
    cos, sin = rope_cos_sin(cfg, positions.to(input_ids.device))
    if attn_impl is None:
        attn_impl = sink_flash_attention

    if remat and caches is None and not collect_kv:
        for li, lp in enumerate(params["layers"]):
            x = torch.utils.checkpoint.checkpoint(
                decoder_layer, lp, cfg, x, cos, sin,
                cfg.window_for_layer(li, N), attn_impl, group,
                use_reentrant=False)
        return _head(params, cfg, x, group=group), None

    kvs = []

    def attn_step(li, lp, q, k, v):
        if caches is not None:
            caches[li].prefill(k, v)
        if collect_kv:
            kvs.append((k, v))
        return attn_impl(q, k, v, num_sink=cfg.num_sink_tokens,
                         window_size=cfg.window_for_layer(li, N),
                         s_aux=_s_aux(lp, cfg))

    logits = _layer_walk(params, cfg, x, cos, sin, attn_step, group=group)
    return logits, (kvs if collect_kv else caches)


def forward_decode(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                   caches: List[SinkKVCache], position: int,
                   attn_impl=None, collect_kv: bool = False, group=None):
    """Single-token decode step. input_ids: [B, 1] -> (logits [B, 1, V],
    caches). Appends this token's KV to every layer cache (in place) and
    attends over it with the decode kernel; ``position`` is the token's
    global position, shared by the batch. ``attn_impl(q, cache, s_aux=)``
    overrides the decode attention. ``collect_kv=True`` also returns each
    layer's post-RoPE (k, v) [B, H_kv, 1, D]: the speculative draft loop
    commits those instead of running the draft a second time. ``group``:
    tensor parallel over it, as in :func:`forward_prefill`."""
    x = _embed_lookup(params["embed"], input_ids)
    pos = torch.tensor([int(position)], device=input_ids.device)
    cos, sin = rope_cos_sin(cfg, pos)
    if attn_impl is None:
        attn_impl = sink_decode_attention_cached
    kvs = []

    def attn_step(li, lp, q, k, v):
        kvs.append((k, v))
        cache = caches[li].append(k, v)
        return attn_impl(q, cache, s_aux=_s_aux(lp, cfg))

    logits = _layer_walk(params, cfg, x, cos, sin, attn_step, group=group)
    return (logits, caches, kvs) if collect_kv else (logits, caches)


def forward_decode_ragged(params: dict, cfg: ModelConfig,
                          input_ids: torch.Tensor,
                          caches: List[RaggedSinkKVCache],
                          positions: torch.Tensor, active: torch.Tensor,
                          attn_impl=None, collect_kv: bool = False):
    """Ragged single-token decode, the continuous-batching step: every
    batch slot holds its own sequence at its own length. input_ids [B, 1];
    positions [B] (each slot's token position, for RoPE); active [B] bool
    (inactive slots neither append nor route to experts; their logits are
    junk). Returns (logits [B, 1, V], caches), the caches appended in
    place, and with ``collect_kv`` each layer's (k, v) [B, H_kv, 1, D]
    too. ``attn_impl(q, cache, s_aux=)`` overrides the decode attention
    (default: one ragged launch of the decode kernel per layer)."""
    x = _embed_lookup(params["embed"], input_ids)
    cos, sin = rope_cos_sin(cfg, positions[:, None])  # [B, 1, D/2]
    if attn_impl is None:
        attn_impl = sink_decode_attention_ragged
    kvs = []

    def attn_step(li, lp, q, k, v):
        kvs.append((k, v))
        cache = caches[li].append(k, v, active)
        return attn_impl(q, cache, s_aux=_s_aux(lp, cfg))

    logits = _layer_walk(params, cfg, x, cos, sin, attn_step, active=active)
    return (logits, caches, kvs) if collect_kv else (logits, caches)


def forward_verify(params: dict, cfg: ModelConfig, input_ids: torch.Tensor,
                   caches: List[SinkKVCache], start_pos: int):
    """Multi-token verification forward, speculative decoding's target
    pass: T draft tokens (input_ids [B, T], token t at position
    ``start_pos + t``) against the pre-append caches, which are neither
    advanced nor copied. Returns (logits [B, T, V], each layer's (k, v)
    [B, H_kv, T, D]) for ``SinkKVCache.append_many_counted``."""
    T = input_ids.shape[1]
    x = _embed_lookup(params["embed"], input_ids)
    pos = int(start_pos) + torch.arange(T, device=input_ids.device)
    cos, sin = rope_cos_sin(cfg, pos)
    kvs = []

    def attn_step(li, lp, q, k, v):
        kvs.append((k, v))
        return _cached_multi_attention(q, k, v, caches[li],
                                       s_aux=_s_aux(lp, cfg))

    return _layer_walk(params, cfg, x, cos, sin, attn_step), kvs


def forward_verify_ragged(params: dict, cfg: ModelConfig,
                          input_ids: torch.Tensor,
                          caches: List[RaggedSinkKVCache]):
    """Per-slot multi-token verification forward (the engine's
    speculative decoding): slot b's token t sits at position
    ``caches[0].seen[b] + t`` and attends its own pre-append view. The
    caches are not advanced. Returns (logits [B, T, V], each layer's
    (k, v) [B, H_kv, T, D]) for ``RaggedSinkKVCache.append_many_counted``.
    """
    T = input_ids.shape[1]
    x = _embed_lookup(params["embed"], input_ids)
    pos = caches[0].seen[:, None] + torch.arange(T, device=input_ids.device)
    cos, sin = rope_cos_sin(cfg, pos)                   # [B, T, D/2]
    kvs = []

    def attn_step(li, lp, q, k, v):
        kvs.append((k, v))
        return sink_decode_attention_ragged_multi(q, k, v, caches[li],
                                                  s_aux=_s_aux(lp, cfg))

    return _layer_walk(params, cfg, x, cos, sin, attn_step), kvs


def _layer_windows(cfg: ModelConfig, max_len: int, streaming: bool):
    """(num_sink, window) of each layer's cache: sliding layers roll
    ``sliding_window``; full layers keep up to ``max_len`` tokens, or with
    ``streaming`` roll too (StreamingLLM: at least 4 sinks and a window of
    max(sliding_window, 4096), an approximation on full layers)."""
    for li in range(cfg.num_layers):
        if cfg.layer_types[li] == "sliding_attention":
            yield cfg.num_sink_tokens, cfg.sliding_window
        elif streaming:
            yield max(cfg.num_sink_tokens, 4), max(cfg.sliding_window, 4096)
        else:
            yield cfg.num_sink_tokens, max_len


def make_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16,
                quant: Optional[str] = None, streaming: bool = False,
                device="cuda") -> List[SinkKVCache]:
    """Per-layer caches for serving (window policy: see
    :func:`_layer_windows`), quantized to int8/fp8 if ``quant``."""
    return [SinkKVCache.init(batch, cfg.num_kv_heads, cfg.head_dim,
                             num_sink=ns, window_size=w, dtype=dtype,
                             quant=quant, device=device)
            for ns, w in _layer_windows(cfg, max_len, streaming)]


def make_ragged_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype: torch.dtype = torch.bfloat16,
                       quant: Optional[str] = None, streaming: bool = False,
                       device="cuda") -> List[RaggedSinkKVCache]:
    """Per-layer ``RaggedSinkKVCache`` for continuous batching (the window
    policy of :func:`make_caches`)."""
    return [RaggedSinkKVCache.init(batch, cfg.num_kv_heads, cfg.head_dim,
                                   num_sink=ns, window_size=w, dtype=dtype,
                                   quant=quant, device=device)
            for ns, w in _layer_windows(cfg, max_len, streaming)]
