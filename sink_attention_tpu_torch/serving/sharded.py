"""Tensor-sharded serving: greedy generation with the weights and the KV
caches split over a mesh's ``model`` axis.

Counterpart of ``sink_attention_tpu/serving/sharded.py``. Each rank holds
the TP block of ``parallel.train.param_shardings`` and the caches of its
heads, [B, H_kv/tp, S, D] (``make_caches`` over
``parallel.tp.tp_local_config``'s view). The prefill runs the forward
kernel and each decode step the decode kernel over the rank's heads: GQA
groups stay whole because H_q and H_kv split by the same factor, so
attention needs no communication.
The block's two sums over the group (after the heads' output products and
after the experts) and the gather of the lm_head's vocabulary columns are
the only collectives.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.model import forward_decode, forward_prefill, make_caches
from ..parallel.mesh import Mesh
from ..parallel.tp import tp_local_config
from ..parallel.train import param_shardings
from ..utils.device import resolve_device

__all__ = ["make_sharded_generate"]


def make_sharded_generate(cfg: ModelConfig, mesh: Mesh,
                          model_axis: str = "model",
                          dtype: torch.dtype = torch.bfloat16,
                          quant: Optional[str] = None):
    """Build a TP-sharded greedy generation function over ``mesh``'s
    ``model_axis``, on the mesh's device (the card unless the mesh was
    made on the CPU); ``quant`` ("int8" / "fp8") quantizes the KV caches.

    Returns ``(shardings, generate)``: ``shardings`` is the layout to
    ``parallel.mesh.device_put`` the parameters with, and
    ``generate(params, input_ids, max_new_tokens)`` -> tokens [B,
    max_new_tokens] takes this rank's block of them and ids the same on
    every rank, and returns the same tokens on every rank. Needs
    ``num_heads`` and ``num_kv_heads`` (and the experts or the dense MLP's
    intermediate size) divisible by the axis size.
    """
    dev = resolve_device(mesh.device)
    tp = mesh.shape[model_axis]
    cfg_local = tp_local_config(cfg, tp)
    group = mesh.group(model_axis) if tp > 1 else None
    shardings = param_shardings(cfg, mesh, model_axis)

    @torch.inference_mode()
    def generate(params, input_ids: torch.Tensor, max_new_tokens: int):
        input_ids = input_ids.to(dev)
        B, N = input_ids.shape
        caches = make_caches(cfg_local, B, max_len=N + max_new_tokens,
                             dtype=dtype, quant=quant, device=dev)
        logits, caches = forward_prefill(params, cfg_local, input_ids,
                                         caches, group=group)
        tok = logits[:, -1].argmax(dim=-1)
        toks = [tok]
        for i in range(max_new_tokens - 1):
            logits, caches = forward_decode(params, cfg_local, tok[:, None],
                                            caches, N + i, group=group)
            tok = logits[:, -1].argmax(dim=-1)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    return shardings, generate
