from .config import ModelConfig
from .convert import params_from_jax
from .model import (apply_rope, decoder_layer, forward_decode,
                    forward_decode_ragged, forward_prefill, forward_verify,
                    forward_verify_ragged, init_params,
                    make_caches, make_ragged_caches, moe, rms_norm,
                    rope_cos_sin)
from .quant import (init_quantized_params, is_quantized, is_quantized4,
                    quantize_params, quantize_weight, quantize_weight_int4)

__all__ = [
    "ModelConfig",
    "init_params",
    "decoder_layer",
    "forward_prefill",
    "forward_decode",
    "forward_decode_ragged",
    "forward_verify",
    "forward_verify_ragged",
    "make_caches",
    "make_ragged_caches",
    "rms_norm",
    "rope_cos_sin",
    "apply_rope",
    "moe",
    "params_from_jax",
    "quantize_params",
    "quantize_weight",
    "is_quantized",
    "init_quantized_params",
    "is_quantized4",
    "quantize_weight_int4",
]
