"""Greedy generation: prefill, then a token-by-token decode loop over the
rolling sink KV cache.

Counterpart of ``sink_attention_tpu/serving/generate.py``'s greedy path:
the JAX package's ``lax.scan`` decode becomes a Python loop, one
``forward_decode`` per token (the caches update in place).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.model import forward_decode, forward_prefill, make_caches
from ..utils.device import resolve_device

__all__ = ["greedy_generate", "prefill_and_caches", "decode_loop"]


@torch.inference_mode()
def prefill_and_caches(params, cfg: ModelConfig, input_ids: torch.Tensor,
                       max_new_tokens: int,
                       dtype: torch.dtype = torch.bfloat16,
                       quant: Optional[str] = None):
    """Run prefill; return (next_token [B] int64, caches), on the device of
    ``input_ids``; the caches quantized to int8/fp8 if ``quant``."""
    B, N = input_ids.shape
    caches = make_caches(cfg, B, max_len=N + max_new_tokens, dtype=dtype,
                         quant=quant, device=input_ids.device)
    logits, caches = forward_prefill(params, cfg, input_ids, caches)
    return logits[:, -1].argmax(dim=-1), caches


@torch.inference_mode()
def decode_loop(params, cfg: ModelConfig, first_token: torch.Tensor, caches,
                start_pos: int, steps: int):
    """Greedy decode of ``steps`` tokens after ``first_token`` [B]; returns
    (tokens [B, steps + 1], caches)."""
    toks = [first_token]
    tok = first_token
    for i in range(steps):
        logits, caches = forward_decode(params, cfg, tok[:, None], caches,
                                        start_pos + i)
        tok = logits[:, -1].argmax(dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1), caches


@torch.inference_mode()
def greedy_generate(params, cfg: ModelConfig, input_ids: torch.Tensor,
                    max_new_tokens: int, dtype: torch.dtype = torch.bfloat16,
                    quant: Optional[str] = None, device="cuda"):
    """Greedy generation on ``device`` (the card unless told otherwise),
    over an int8/fp8 KV cache if ``quant``. input_ids [B, N] -> generated
    tokens [B, max_new_tokens] int64."""
    dev = resolve_device(device)
    input_ids = input_ids.to(dev)
    N = input_ids.shape[1]
    first, caches = prefill_and_caches(params, cfg, input_ids,
                                       max_new_tokens, dtype=dtype,
                                       quant=quant)
    if max_new_tokens == 1:
        return first[:, None]
    toks, _ = decode_loop(params, cfg, first, caches, start_pos=N,
                          steps=max_new_tokens - 1)
    return toks
