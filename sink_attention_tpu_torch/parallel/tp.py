"""Tensor parallelism over a process group.

Counterpart of ``sink_attention_tpu/parallel/tp.py``, with a process group
where JAX takes an axis name. Heads and experts (or the dense MLP's
intermediate columns) are split over the group; the block's replicated
values enter the split region through :func:`tp_region_in` and its
partial sums leave through :func:`tp_region_out`, Megatron-LM's f and g
operators (defined in ``_collectives`` with the other differentiable
collectives, and re-exported here as the JAX module exports them).

With every replicated value entering through ``tp_region_in`` and no
replicated parameter used inside a region, every gradient is exact with
no fix-up: a sharded parameter's is local, a replicated one's is the same
on every rank. The block itself is ``models.model``'s, which takes the
group: prefill, decode and training share it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..models.model import decoder_layer
from ._collectives import tp_gather, tp_region_in, tp_region_out

__all__ = ["tp_region_in", "tp_region_out", "tp_gather", "tp_local_config",
           "tp_decoder_layer"]


def tp_local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Per-rank config: heads and experts (dense family: the MLP's
    intermediate size) divided by the TP degree."""
    if tp == 1:
        return cfg
    for name in ("num_heads", "num_kv_heads",
                 "intermediate_size" if cfg.mlp_type == "dense"
                 else "num_experts"):
        if getattr(cfg, name) % tp:
            raise ValueError(f"{name}={getattr(cfg, name)} does not split "
                             f"over {tp} ranks")
    if cfg.mlp_type == "dense":
        return dataclasses.replace(
            cfg, num_heads=cfg.num_heads // tp,
            num_kv_heads=cfg.num_kv_heads // tp,
            intermediate_size=cfg.intermediate_size // tp)
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        num_experts=cfg.num_experts // tp)


def tp_decoder_layer(lp: dict, cfg_local: ModelConfig, x: torch.Tensor,
                     cos, sin, window: int, attn_impl, group) -> torch.Tensor:
    """One transformer block with heads and experts split over ``group``.

    ``lp`` holds this rank's shard (``param_shardings``' layout: wq, wk, wv
    and their biases by output (head) columns, wo by input rows, sinks by
    head, experts by expert, the dense MLP's gate / up by columns and down
    by rows; norms, router and bo whole); ``cfg_local`` is
    :func:`tp_local_config`'s view. With ``group=None`` this is exactly
    ``models.model.decoder_layer``.

        h   = rms_norm(x)
        a   = out_proj_nobias(attn(qkv(f(h))))  # head-split region
        x  += g(a) + bo                         # bias once, after the sum
        h2  = rms_norm(x)
        r   = f(moe_routing(h2))[:, local]      # router whole, enter first
        x  += g(moe_experts(f(h2), r))          # expert-split region
    """
    return decoder_layer(lp, cfg_local, x, cos, sin, window, attn_impl,
                         group=group)
