"""Next-token training step on one device.

Counterpart of ``sink_attention_tpu/parallel/train.py`` on a one-device
mesh: the loss, the packed-batch loss (``cross_entropy_loss_packed``, per
segment sink attention on the packed kernels), activation checkpointing
(``remat``) and exact gradient accumulation over equal microbatches. The
attention's gradients come from the dQ and dK/dV kernels on the card. The
parameters are the model's nested dict, updated in place by a
``torch.optim`` optimizer built over :func:`param_leaves`. There is no
mesh: the sharded step (``param_shardings``, ``make_sharded_attn``) is not
ported yet.
"""

from __future__ import annotations

from typing import List

import torch

from ..models.config import ModelConfig
from ..models.model import forward_prefill
from ..ops.packed import sink_flash_attention_packed

__all__ = ["cross_entropy_loss", "cross_entropy_loss_packed",
           "make_train_step", "param_leaves"]


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in the JAX package's leaf order
    (dict keys sorted, lists in order)."""
    if isinstance(params, dict):
        return [t for key in sorted(params) for t in param_leaves(params[key])]
    if isinstance(params, (list, tuple)):
        return [t for item in params for t in param_leaves(item)]
    return [params]


def cross_entropy_loss(params, cfg: ModelConfig, batch: torch.Tensor,
                       attn_impl=None, remat: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy (fp32). batch: int [B, N+1]."""
    inputs, targets = batch[:, :-1], batch[:, 1:]
    logits, _ = forward_prefill(params, cfg, inputs, attn_impl=attn_impl,
                                remat=remat)
    return torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), targets.reshape(-1))


def cross_entropy_loss_packed(params, cfg: ModelConfig, batch: torch.Tensor,
                              positions: torch.Tensor) -> torch.Tensor:
    """Packed-batch next-token cross entropy (fp32): per-segment sink
    attention and RoPE, with cross-segment targets masked out.

    batch: int [B, N] packed token ids; positions: int [B, N]
    segment-local positions (0 at each segment start). Token t's target is
    token t+1 unless t+1 starts a new segment (positions[t+1] == 0): the
    last token of each segment, and of the pack, adds no loss. The mean is
    over the valid targets (at least 1 in the denominator). The attention
    is ``sink_flash_attention_packed``, whose tables are built once for
    all layers from this ``positions`` tensor.
    """
    positions = positions.to(batch.device)

    def attn(q, k, v, *, num_sink, window_size, s_aux):
        return sink_flash_attention_packed(q, k, v, positions, num_sink,
                                           window_size, s_aux=s_aux)

    logits, _ = forward_prefill(params, cfg, batch, positions=positions,
                                attn_impl=attn)
    losses = torch.nn.functional.cross_entropy(
        logits[:, :-1].float().reshape(-1, logits.shape[-1]),
        batch[:, 1:].reshape(-1), reduction="none")
    valid = (positions[:, 1:] > 0).float().reshape(-1)
    return (losses * valid).sum() / valid.sum().clamp(min=1.0)


def make_train_step(cfg: ModelConfig, optimizer: torch.optim.Optimizer,
                    remat: bool = False, accum_steps: int = 1):
    """Build ``step(params, batch) -> loss`` over ``optimizer``, whose
    parameters are the leaves of ``params`` (``param_leaves``); they are
    marked as requiring grad here.

    A step zeroes the gradients, runs forward and backward on each of
    ``accum_steps`` equal microbatches of the batch's leading dim (the
    loss of each scaled by 1 / accum_steps, so the gradient is the mean
    of the microbatches' means, as the JAX step's), then steps the
    optimizer, which updates the parameters in place. ``remat=True``
    checkpoints each decoder layer. It runs where the parameters are: on
    the card unless they were made on the CPU; the batch is moved there.
    Returns the mean loss (a detached fp32 scalar on that device).
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    for group in optimizer.param_groups:
        for p in group["params"]:
            p.requires_grad_(True)

    def step(params, batch: torch.Tensor) -> torch.Tensor:
        B = batch.shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} is not a multiple of accum_steps "
                             f"{accum_steps}")
        batch = batch.to(params["embed"].device)
        optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), dtype=torch.float32, device=batch.device)
        for micro in batch.reshape(accum_steps, B // accum_steps,
                                   *batch.shape[1:]):
            loss = cross_entropy_loss(params, cfg, micro, remat=remat)
            (loss / accum_steps).backward()
            total += loss.detach()
        optimizer.step()
        return total / accum_steps

    return step
