"""Load HF GptOss (and Qwen2/Llama/Mistral) checkpoints into the
functional parameter tree.

Counterpart of ``sink_attention_tpu/models/hf_loader.py``. Maps the
``GptOssForCausalLM`` parameter names to the model's tree, from an
in-memory state dict (numpy arrays or torch tensors) or from a local
checkpoint directory of safetensors shards, with the MoE expert weights
in either storage format:

* dense ``mlp.experts.gate_up_proj`` ``[E, in, out]`` (what a transformers
  model object holds after dequantization), or
* the released **MXFP4** format: ``..._blocks`` uint8 ``[E, out, in/32,
  16]`` (two OCP e2m1 fp4 values per byte, low nibble first) and
  ``..._scales`` uint8 ``[E, out, in/32]`` (e8m0 block exponents, bias
  127), the on-disk layout of openai/gpt-oss-20b and -120b.

``quant="int8"``/``"int4"`` converts each large weight into the serving
forms of ``models.quant`` as it is read, so the dense model is never held
whole. The checkpoint directory is read through the port's own
safetensors reader (``utils._safetensors``), one tensor at a time from a
memory map, each converted on the target device.
"""

from __future__ import annotations

import json
import math
import os
from contextlib import ExitStack
from typing import Any, Dict, Optional

import torch

from ..utils._safetensors import SafetensorsFile, as_tensor
from ..utils.device import resolve_device
from .config import ModelConfig
from .quant import EXPERT_SLICE, quantize_weight, quantize_weight_int4

__all__ = ["params_from_hf_state_dict", "load_hf_checkpoint",
           "dequantize_mxfp4"]

# OCP MX e2m1 code points (sign x {0, 0.5, 1, 1.5, 2, 3, 4, 6}); the nibble
# indexes this table, codes 8..15 are the negative mirror.
_FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
               -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)
# Each e8m0 code's power of two 2^(s - 127), exact in fp32 (2^-127 is a
# subnormal) up to s = 254; s = 255 (2^128) overflows fp32, so it is
# applied as 2^127 times a second factor of 2, which rounds a product to
# infinity exactly where numpy's fp32 ldexp does.
_POW2 = tuple(math.ldexp(1.0, min(s, 254) - 127) for s in range(256))
_POW2_HI = (1.0,) * 255 + (2.0,)


def dequantize_mxfp4(blocks, scales) -> torch.Tensor:
    """Decode MXFP4 blocks/scales to fp32, on the blocks' device.

    ``blocks``: uint8 ``[..., G, 16]``, two e2m1 values per byte, low
    nibble first, so one 16-byte block holds 32 consecutive values.
    ``scales``: uint8 ``[..., G]``, e8m0 exponents of bias 127 (the shared
    power of two of each 32-value block). Returns fp32 ``[..., G*32]``,
    bit for bit the JAX package's numpy decoder (``np.ldexp`` in fp32):
    every value is exact, or infinite where that overflows.
    """
    blocks, scales = as_tensor(blocks), as_tensor(scales)
    if blocks.dtype != torch.uint8 or blocks.shape[-1] != 16:
        raise ValueError(f"blocks must be uint8 [..., G, 16], got "
                         f"{blocks.dtype} {tuple(blocks.shape)}")
    if scales.shape != blocks.shape[:-1]:
        raise ValueError(f"scales {tuple(scales.shape)} do not match blocks "
                         f"{tuple(blocks.shape)}")
    dev = blocks.device
    fp4 = torch.tensor(_FP4_VALUES, dtype=torch.float32, device=dev)
    # byte b of a block yields values (2j, 2j+1) = (fp4[b & 15], fp4[b >> 4])
    pairs = torch.stack([fp4.repeat(16), fp4.repeat_interleave(16)], dim=1)
    vals = pairs.index_select(0, blocks.reshape(-1).int()).reshape(
        *blocks.shape[:-1], 32)
    codes = scales.to(dev).reshape(-1).int()
    for table in (_POW2, _POW2_HI):
        t = torch.tensor(table, dtype=torch.float32, device=dev)
        vals.mul_(t.index_select(0, codes).reshape(*scales.shape, 1))
    return vals.reshape(*blocks.shape[:-2], -1)


def params_from_hf_state_dict(sd: Dict[str, Any], cfg: ModelConfig,
                              dtype: torch.dtype = torch.float32,
                              quant: Optional[str] = None,
                              device="cuda") -> dict:
    """Convert a GptOssForCausalLM (or dense-family) state dict to the
    model's parameter tree on ``device``.

    CONSUMES ``sd``: each entry is popped as it converts, so the state
    dict frees while the tree builds (the tied embedding is the one entry
    read twice). Values are numpy arrays or torch tensors; each is copied
    to ``device`` in its own dtype and converted there.

    ``quant``: None (dense, in ``dtype``), ``"int8"`` (every large weight
    int8 per channel, the ``models.quant`` forms) or ``"int4"`` (attention
    and MLP weights packed int4; the embedding and the lm_head stay int8).
    With ``quant`` set, ``dtype`` is the scales' and compute dtype, and
    each weight is quantized from its fp32 value.
    """
    if quant not in (None, "int8", "int4"):
        raise ValueError(f"quant must be None, 'int8' or 'int4', got "
                         f"{quant!r}")
    dev = resolve_device(device)
    wide = dtype if quant is None else torch.float32

    def _maybe_q(x: torch.Tensor, contract_axis: int, allow_int4: bool):
        if quant is None:
            return x
        if quant == "int4" and allow_int4:
            return quantize_weight_int4(x, contract_axis=contract_axis,
                                        scale_dtype=dtype)
        return quantize_weight(x, contract_axis=contract_axis,
                               scale_dtype=dtype)

    def take(name):
        # Destructive read: each tensor is consumed once, so the state dict
        # frees as the tree builds. The tied-embedding tensor is the one
        # legal double read.
        if name == "model.embed_tokens.weight":
            return sd[name]
        return sd.pop(name)

    def on_device(name) -> torch.Tensor:
        """One copy to the device in the stored dtype (fp64 rounds to fp32
        first, as the JAX loader's ``astype(np.float32)`` does)."""
        x = as_tensor(take(name))
        if x.dtype == torch.float64:
            x = x.float()
        return torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)

    def convert(x: torch.Tensor, to: torch.dtype, transpose: bool):
        # one pass: the cast (through fp32's values, exactly as the JAX
        # loader's fp32 copy) and the [out, in] -> [in, out] transpose
        src = x.t() if transpose else x
        return torch.empty(src.shape, dtype=to, device=dev).copy_(src)

    def get(name, transpose=False):
        return convert(on_device(name), dtype, transpose)

    def get_big(name, transpose=False, contract_axis=-2, allow_int4=True):
        """A large matmul weight: quantized on the fly when requested."""
        x = convert(on_device(name), wide, transpose)
        return _maybe_q(x, contract_axis, allow_int4)

    def get_experts(name):
        """Stacked expert weights [E, in, out]: dense or MXFP4 stored."""
        if name + "_blocks" not in sd:
            return _maybe_q(convert(on_device(name), wide, False), -2, True)
        blocks = on_device(name + "_blocks")            # [E, out, G, 16]
        scales = on_device(name + "_scales")            # [E, out, G]
        E, n_out, G = scales.shape
        w = torch.empty((E, G * 32, n_out), dtype=wide, device=dev)
        for e0 in range(0, E, EXPERT_SLICE):  # bounds the fp32 transients
            e1 = min(e0 + EXPERT_SLICE, E)
            w[e0:e1].copy_(dequantize_mxfp4(
                blocks[e0:e1], scales[e0:e1]).transpose(1, 2))
        del blocks, scales
        return _maybe_q(w, -2, True)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        attn = {
            # HF Linear stores [out, in]; the model stores [in, out]
            "wq": get_big(pre + "self_attn.q_proj.weight", transpose=True),
            "wk": get_big(pre + "self_attn.k_proj.weight", transpose=True),
            "wv": get_big(pre + "self_attn.v_proj.weight", transpose=True),
            "wo": get_big(pre + "self_attn.o_proj.weight", transpose=True),
        }
        if cfg.attention_bias:
            attn["bq"] = get(pre + "self_attn.q_proj.bias")
            attn["bk"] = get(pre + "self_attn.k_proj.bias")
            attn["bv"] = get(pre + "self_attn.v_proj.bias")
        else:
            attn["bq"] = zeros((cfg.num_heads * cfg.head_dim,))
            attn["bk"] = zeros((cfg.num_kv_heads * cfg.head_dim,))
            attn["bv"] = zeros((cfg.num_kv_heads * cfg.head_dim,))
        attn["bo"] = (get(pre + "self_attn.o_proj.bias") if cfg.o_bias
                      else zeros((cfg.hidden_size,)))
        if cfg.use_s_aux:
            attn["sinks"] = get(pre + "self_attn.sinks")
        if cfg.mlp_type == "dense":
            # Qwen2/Llama gated-SiLU MLP (no biases)
            mlp = {
                "gate": get_big(pre + "mlp.gate_proj.weight", transpose=True),
                "up": get_big(pre + "mlp.up_proj.weight", transpose=True),
                "down": get_big(pre + "mlp.down_proj.weight", transpose=True),
            }
        else:
            mlp = {
                "router_w": get(pre + "mlp.router.weight", transpose=True),
                "router_b": get(pre + "mlp.router.bias"),
                # HF experts store [E, in, out] dense, [E, out, ...] MXFP4
                "gate_up": get_experts(pre + "mlp.experts.gate_up_proj"),
                "gate_up_b": get(pre + "mlp.experts.gate_up_proj_bias"),
                "down": get_experts(pre + "mlp.experts.down_proj"),
                "down_b": get(pre + "mlp.experts.down_proj_bias"),
            }
        layers.append({
            "attn": attn,
            "mlp": mlp,
            "ln1": get(pre + "input_layernorm.weight"),
            "ln2": get(pre + "post_attention_layernorm.weight"),
        })

    lm_head_name = ("lm_head.weight" if "lm_head.weight" in sd
                    else "model.embed_tokens.weight")  # tied embeddings
    return {
        # the embedding is gathered, never contracted: per-row int8 scales,
        # and it stays int8 in an int4 tree
        "embed": get_big("model.embed_tokens.weight", contract_axis=-1,
                         allow_int4=False),
        "layers": layers,
        "final_norm": get("model.norm.weight"),
        "lm_head": get_big(lm_head_name, transpose=True, allow_int4=False),
    }


class _ShardedStateDict:
    """The tensors of a directory's safetensors shards, read on demand:
    the state-dict operations ``params_from_hf_state_dict`` uses (``in``,
    ``[]``, ``pop``). Each read returns a view over its shard's memory map;
    the pages of the tensor read before are released when the next is
    read, so the process holds about one tensor's pages at a time."""

    def __init__(self, files):
        self._where = {name: f for f in files for name in f.keys()}
        self._last = None

    def __contains__(self, name) -> bool:
        return name in self._where

    def __getitem__(self, name) -> torch.Tensor:
        self.release()
        f = self._where[name]
        self._last = (f, name)
        return f.get_tensor(name)

    def pop(self, name) -> torch.Tensor:
        x = self[name]
        del self._where[name]
        return x

    def release(self) -> None:
        if self._last is not None:
            f, name = self._last
            f.release(name)
            self._last = None


def load_hf_checkpoint(path: str, dtype: torch.dtype = torch.bfloat16,
                       quant: Optional[str] = None, device="cuda"):
    """Load (cfg, params) from a local HF checkpoint directory.

    Reads ``config.json`` (``ModelConfig.from_hf_config``) and every
    ``*.safetensors`` shard (the released MXFP4 gpt-oss checkpoints
    included), with no network access. Tensors stream one at a time from
    memory-mapped shards and convert on ``device``: host memory stays near
    one tensor, device memory near the result plus one tensor's fp32 form
    (an expert stack for quantization, or a slice of 16 experts' decode).
    With ``quant="int8"``/``"int4"`` each weight is quantized as it
    arrives (see :func:`params_from_hf_state_dict`).
    """
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = ModelConfig.from_hf_config(json.load(f))
    shards = sorted(f for f in os.listdir(path)
                    if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no safetensors shards under {path}")
    with ExitStack() as stack:
        files = [stack.enter_context(SafetensorsFile(os.path.join(path, s)))
                 for s in shards]
        params = params_from_hf_state_dict(_ShardedStateDict(files), cfg,
                                           dtype, quant=quant, device=dev)
    return cfg, params
