"""Model configuration for gpt-oss-style sink-attention models.

A copy of ``sink_attention_tpu/models/config.py`` (the port imports nothing
of the JAX package), ``from_hf_config`` included.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """gpt-oss-family configuration (HF GptOssConfig semantics).

    The flagship is gpt-oss-20b: hidden 2880, 24 layers, 64/8 heads,
    head_dim 64, 32 experts top-4, sliding_window 128, alternating
    sliding/full layers, YaRN rope. ``tiny()`` is the test-size variant.
    """

    vocab_size: int = 201088
    hidden_size: int = 2880
    num_layers: int = 24
    num_heads: int = 64
    num_kv_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2880
    num_experts: int = 32
    experts_per_tok: int = 4
    sliding_window: int = 128
    layer_types: Optional[Tuple[str, ...]] = None  # default alternating
    rope_theta: float = 150000.0
    rope_scaling: Optional[dict] = None  # e.g. {"rope_type": "yarn", ...}
    rms_norm_eps: float = 1e-5
    attention_bias: bool = True
    # o_proj bias when it differs from the qkv bias (Qwen2: qkv biases, no
    # o bias); None means "same as attention_bias" (gpt-oss: all four).
    attention_out_bias: Optional[bool] = None
    max_position_embeddings: int = 131072
    # "moe" (gpt-oss expert mixture) or "dense" (gated-SiLU gate/up/down).
    mlp_type: str = "moe"
    # Learnable per-query-head sink logit (the gpt-oss s_aux mechanism).
    use_s_aux: bool = True
    # Cache-eviction sinks (StreamingLLM-style leading tokens); gpt-oss: 0.
    num_sink_tokens: int = 0
    # MoE path selector: the grouped-by-expert loop (one step per distinct
    # routed expert) when tokens <= this, else the dense all-experts
    # product. Decode at small T reads only the routed experts' weights.
    moe_grouped_token_limit: int = 8

    def __post_init__(self):
        if self.layer_types is None:
            object.__setattr__(
                self, "layer_types",
                tuple("sliding_attention" if i % 2 == 0 else "full_attention"
                      for i in range(self.num_layers)))
        if len(self.layer_types) != self.num_layers:
            raise ValueError("layer_types must have num_layers entries")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    def window_for_layer(self, layer_idx: int, n_ctx: int) -> int:
        """Attention window for a layer given the total context length."""
        if self.layer_types[layer_idx] == "sliding_attention":
            return self.sliding_window
        return max(n_ctx, 1)

    @property
    def o_bias(self) -> bool:
        """Effective o_proj bias flag."""
        return (self.attention_bias if self.attention_out_bias is None
                else self.attention_out_bias)

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        defaults = dict(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=32, num_experts=4,
            experts_per_tok=2, sliding_window=16, rope_theta=10000.0,
            rope_scaling=None, max_position_embeddings=2048)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def gpt_oss_20b(cls, **kw) -> "ModelConfig":
        defaults = dict(
            vocab_size=201088, hidden_size=2880, num_layers=24, num_heads=64,
            num_kv_heads=8, head_dim=64, intermediate_size=2880,
            num_experts=32, experts_per_tok=4, sliding_window=128,
            rope_theta=150000.0,
            rope_scaling={"rope_type": "yarn", "factor": 32.0,
                          "beta_fast": 32.0, "beta_slow": 1.0,
                          "original_max_position_embeddings": 4096})
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def gpt_oss_120b(cls, **kw) -> "ModelConfig":
        defaults = dict(
            vocab_size=201088, hidden_size=2880, num_layers=36, num_heads=64,
            num_kv_heads=8, head_dim=64, intermediate_size=2880,
            num_experts=128, experts_per_tok=4, sliding_window=128,
            rope_theta=150000.0,
            rope_scaling={"rope_type": "yarn", "factor": 32.0,
                          "beta_fast": 32.0, "beta_slow": 1.0,
                          "original_max_position_embeddings": 4096})
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def qwen2_tiny(cls, **kw) -> "ModelConfig":
        """Test-size dense-family (Qwen2-style) config."""
        defaults = dict(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=96,
            sliding_window=2048, rope_theta=10000.0, rms_norm_eps=1e-6,
            layer_types=("full_attention",) * 2,
            mlp_type="dense", use_s_aux=False,
            attention_bias=True, attention_out_bias=False,
            max_position_embeddings=2048)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def qwen2_5_7b(cls, **kw) -> "ModelConfig":
        """Qwen2.5-7B-Instruct geometry (dense family flagship)."""
        defaults = dict(
            vocab_size=152064, hidden_size=3584, num_layers=28,
            num_heads=28, num_kv_heads=4, head_dim=128,
            intermediate_size=18944, sliding_window=131072,
            layer_types=("full_attention",) * 28,
            rope_theta=1000000.0, rms_norm_eps=1e-6,
            mlp_type="dense", use_s_aux=False,
            attention_bias=True, attention_out_bias=False,
            max_position_embeddings=131072)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def from_hf_config(cls, hf_cfg: Any) -> "ModelConfig":
        """Build from a transformers config (object or dict).

        Supports GptOssConfig (MoE + s_aux sinks) and the dense
        Qwen2/Llama families (model_type 'qwen2'/'llama'/'mistral':
        gated-SiLU MLP, no s_aux, full attention unless the config opts
        into sliding windows)."""
        get = (hf_cfg.get if isinstance(hf_cfg, dict)
               else lambda k, d=None: getattr(hf_cfg, k, d))
        model_type = get("model_type", "gpt_oss")
        n_layers = get("num_hidden_layers")
        n_heads = get("num_attention_heads")
        head_dim = get("head_dim") or get("hidden_size") // n_heads
        if model_type in ("qwen2", "llama", "mistral"):
            sliding = get("sliding_window")
            max_pos = get("max_position_embeddings")
            qkv_bias = get("attention_bias", model_type == "qwen2")
            # Sliding-window conventions differ per family:
            #  * mistral: sliding_window != None => ALL layers sliding
            #    (modeling_mistral applies it unconditionally; v0.3+
            #    checkpoints set it to null)
            #  * qwen2: only if use_sliding_window, and only for layers
            #    with index >= max_window_layers (the leading layers stay
            #    full attention)
            #  * llama: never
            if model_type == "mistral":
                per_layer = [bool(sliding)] * n_layers
            elif model_type == "qwen2" and bool(
                    get("use_sliding_window", False) and sliding):
                mwl = get("max_window_layers", 0) or 0
                per_layer = [i >= mwl for i in range(n_layers)]
            else:
                per_layer = [False] * n_layers
            use_sliding = any(per_layer)
            return cls(
                vocab_size=get("vocab_size"),
                hidden_size=get("hidden_size"),
                num_layers=n_layers,
                num_heads=n_heads,
                num_kv_heads=get("num_key_value_heads", n_heads),
                head_dim=head_dim,
                intermediate_size=get("intermediate_size"),
                sliding_window=(sliding if use_sliding else max_pos),
                layer_types=tuple(
                    get("layer_types")
                    or ("sliding_attention" if s else "full_attention"
                        for s in per_layer)),
                rope_theta=get("rope_theta", 10000.0),
                rope_scaling=get("rope_scaling"),
                rms_norm_eps=get("rms_norm_eps", 1e-6),
                attention_bias=qkv_bias,
                # Qwen2's modeling hardcodes o_proj bias=False even though
                # its qkv have biases; Llama/Mistral apply attention_bias
                # to ALL four projections (None = follow attention_bias)
                attention_out_bias=(False if model_type == "qwen2"
                                    else None),
                max_position_embeddings=max_pos,
                mlp_type="dense", use_s_aux=False,
            )
        return cls(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            num_layers=n_layers,
            num_heads=n_heads,
            num_kv_heads=get("num_key_value_heads"),
            head_dim=head_dim,
            intermediate_size=get("intermediate_size"),
            num_experts=get("num_local_experts"),
            experts_per_tok=get("num_experts_per_tok"),
            sliding_window=get("sliding_window"),
            layer_types=tuple(get("layer_types")),
            rope_theta=get("rope_theta"),
            rope_scaling=get("rope_scaling"),
            rms_norm_eps=get("rms_norm_eps"),
            attention_bias=get("attention_bias", True),
            max_position_embeddings=get("max_position_embeddings"),
        )
