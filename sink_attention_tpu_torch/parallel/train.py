"""Next-token training: the loss, the packed-batch loss, and the step on
one device or over a device mesh.

Counterpart of ``sink_attention_tpu/parallel/train.py``: the loss, the
packed-batch loss (``cross_entropy_loss_packed``, per segment sink
attention on the packed kernels), activation checkpointing (``remat``)
and exact gradient accumulation over equal microbatches. The attention's
gradients come from the dQ and dK/dV kernels on the card. The parameters
are the model's nested dict, updated in place by a ``torch.optim``
optimizer built over :func:`param_leaves`.

Over a mesh (``parallel.mesh``) the step is DP x SP (Ulysses) x TP/EP,
with FSDP on request. PyTorch has no GSPMD to partition one program, so
each rank runs its shard explicitly:

* **DP**: the batch's rows split over ``data``; the gradients summed over
  it.
* **SP**: the sequence split over ``seq``; the attention runs Ulysses
  all-to-alls over it (:func:`make_sharded_attn`), so the kernel sees
  whole sequences of this rank's heads.
* **TP/EP**: heads, experts, the dense MLP's columns and the lm_head's
  vocabulary split over ``model``, through the model's tensor-parallel
  block (``parallel.tp``).
* **FSDP** (``fsdp=True``): the large weights' ``data`` entries of
  :func:`param_shardings` split them over ``data`` too (ZeRO-3). Each is
  all-gathered at its use, and the gather's backward reduce-scatters its
  gradient; the optimizer, built over the local blocks, keeps 1/dp of the
  state. With ``remat`` the gathers rerun in the backward, so no layer's
  whole weights outlive its use.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..models.config import ModelConfig
from ..models.model import (_embed_lookup, _head, decoder_layer,
                            forward_prefill, rope_cos_sin)
from ..ops.flash import sink_flash_attention
from ..ops.packed import sink_flash_attention_packed
from ._collectives import all_gather, all_reduce
from .mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, NamedSharding,
                   PartitionSpec, tree_map)
from .tp import tp_local_config
from .ulysses import _scatter, gather_heads

__all__ = ["param_shardings", "make_sharded_attn", "make_train_step",
           "mesh_token_losses", "data_rows", "cross_entropy_loss",
           "cross_entropy_loss_packed", "param_leaves"]


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


def param_shardings(cfg: ModelConfig, mesh: Mesh, model_axis: str = "model",
                    fsdp_axis: Optional[str] = None):
    """NamedSharding tree of the model's parameters (the JAX package's,
    leaf by leaf).

    TP/EP layout over ``model_axis``: wq, wk, wv (and their biases) by
    output columns, wo by input rows, sinks by head, experts by expert,
    the dense MLP's gate / up by columns and down by rows, the lm_head by
    vocabulary; router, norms, bo and embed whole. With ``fsdp_axis``
    (usually 'data') every large weight's other dimension is split over
    that axis as well, where its size divides (FSDP is a layout, not a
    change of the math)."""
    m, f = model_axis, fsdp_axis
    f_size = mesh.shape[fsdp_axis] if fsdp_axis else 1

    def s(*spec):
        return NamedSharding(mesh, PartitionSpec(*spec))

    def sf(shape, spec):
        return s(*(None if (ax is f and d % f_size) else ax
                   for ax, d in zip(spec, shape)))

    H, HQ, HKV = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads
    D, I, E = cfg.head_dim, cfg.intermediate_size, cfg.num_experts
    attn = {
        "wq": sf((H, HQ * D), (f, m)), "bq": s(m),
        "wk": sf((H, HKV * D), (f, m)), "bk": s(m),
        "wv": sf((H, HKV * D), (f, m)), "bv": s(m),
        "wo": sf((HQ * D, H), (m, f)), "bo": s(),
    }
    if cfg.use_s_aux:
        attn["sinks"] = s(m)
    if cfg.mlp_type == "dense":
        mlp = {"gate": sf((H, I), (f, m)), "up": sf((H, I), (f, m)),
               "down": sf((I, H), (m, f))}
    else:
        mlp = {
            "router_w": s(), "router_b": s(),
            "gate_up": sf((E, H, 2 * I), (m, f, None)),
            "gate_up_b": s(m, None),
            "down": sf((E, I, H), (m, f, None)), "down_b": s(m, None),
        }
    layer = {"attn": attn, "mlp": mlp, "ln1": s(), "ln2": s()}
    return {
        "embed": sf((cfg.vocab_size, H), (f, None)),
        "layers": [layer] * cfg.num_layers,
        "final_norm": s(),
        "lm_head": sf((H, cfg.vocab_size), (f, m)),
    }


def make_sharded_attn(mesh: Mesh, data_axis: str = "data",
                      seq_axis: str = "seq", model_axis: str = "model",
                      attn_impl=None):
    """Attention for a rank's shard of [B, H, N, D]: B split over
    ``data_axis`` and H over ``model_axis`` already (local to the rank: the
    JAX package's shard_map specs name them, here they only have to be
    axes of the mesh), N over ``seq_axis``. Over a ``seq`` of more than one
    rank, Ulysses all-to-alls trade the sequence split for a head split, so
    ``attn_impl`` (default: the kernel, ``sink_flash_attention``) sees
    whole sequences of 1/sp of the local heads, and trade back. Each axis
    must be an axis of the mesh, or one of the standard axes ('data',
    'seq', 'model'), which a mesh may leave out where it is unsplit (size
    1: a pipeline mesh has no 'data'); any other name raises ValueError."""
    known = set(mesh.shape) | {DATA_AXIS, SEQ_AXIS, MODEL_AXIS}
    for name, axis in (("data_axis", data_axis), ("seq_axis", seq_axis),
                       ("model_axis", model_axis)):
        if axis not in known:
            raise ValueError(f"{name} {axis!r} is not an axis of the mesh "
                             f"{tuple(mesh.shape)}")
    impl = attn_impl or sink_flash_attention

    def attn(q, k, v, *, num_sink, window_size, s_aux):
        kw = dict(num_sink=num_sink, window_size=window_size)
        if mesh.shape.get(seq_axis, 1) == 1:
            return impl(q, k, v, s_aux=s_aux, **kw)
        group = mesh.group(seq_axis)
        q, k, v, aux = _scatter(q, k, v, s_aux, group)
        return gather_heads(impl(q, k, v, s_aux=aux, **kw), group)

    return attn


def _size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


def _index(mesh: Mesh, axis: str) -> int:
    return mesh.axis_index(axis) if _size(mesh, axis) > 1 else 0


def data_rows(batch: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a batch split over ``data``, on its device."""
    B, dp = batch.shape[0], _size(mesh, "data")
    if B % dp:
        raise ValueError(f"batch {B} does not split over data={dp}")
    lo = _index(mesh, "data") * (B // dp)
    return batch[lo:lo + B // dp].to(mesh.device)


def mesh_token_losses(params, cfg: ModelConfig, mesh: Mesh, shardings, rows,
                      remat: bool = False, attn_impl=None) -> torch.Tensor:
    """Next-token cross entropy (fp32) of each of this rank's tokens:
    ``rows`` int [b, N+1] (its ``data`` rows) -> [b, N/sp], the slice of
    the sequence at its ``seq`` coordinate. ``params`` is its local tree
    under ``shardings`` (:func:`param_shardings`): every split but the
    ``model`` axis's (the FSDP one) is gathered at the leaf's use, the
    ``model`` split runs the model's tensor-parallel block. ``remat``
    checkpoints each layer, the gathers included."""
    sp, tp = _size(mesh, "seq"), _size(mesh, "model")
    cfg_local = tp_local_config(cfg, tp)
    tp_group = mesh.group("model") if tp > 1 else None
    attn = make_sharded_attn(mesh, attn_impl=attn_impl)

    def use(t, sharding):
        for d, axis in enumerate(sharding.spec):
            if axis is not None and axis != "model":
                t = all_gather(t, d, mesh.group(axis))
        return t

    N = rows.shape[1] - 1
    if N % sp:
        raise ValueError(f"{N} tokens do not split over seq={sp}")
    n = N // sp
    lo = _index(mesh, "seq") * n
    x = _embed_lookup(use(params["embed"], shardings["embed"]),
                      rows[:, lo:lo + n])
    cos, sin = rope_cos_sin(cfg, torch.arange(lo, lo + n,
                                              device=rows.device))
    for li, lp in enumerate(params["layers"]):
        def layer(x, lp=lp, ls=shardings["layers"][li],
                  window=cfg.window_for_layer(li, N)):
            return decoder_layer(tree_map(use, lp, ls), cfg_local, x, cos,
                                 sin, window, attn, group=tp_group)
        x = (torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False)
             if remat else layer(x))
    head = {"final_norm": params["final_norm"],
            "lm_head": use(params["lm_head"], shardings["lm_head"])}
    logits = _head(head, cfg, x, group=tp_group)
    return torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]),
        rows[:, lo + 1:lo + n + 1].reshape(-1),
        reduction="none").reshape(rows.shape[0], n)


def _accumulate(loss_fn, optimizer, batch, accum_steps):
    """Zero the gradients, then forward and backward over ``accum_steps``
    equal microbatches of ``batch``, each loss scaled by 1 / accum_steps;
    returns the mean of their losses."""
    B = batch.shape[0]
    if B % accum_steps:
        raise ValueError(f"batch {B} is not a multiple of accum_steps "
                         f"{accum_steps}")
    optimizer.zero_grad(set_to_none=True)
    total = torch.zeros((), dtype=torch.float32, device=batch.device)
    for micro in batch.reshape(accum_steps, B // accum_steps,
                               *batch.shape[1:]):
        loss = loss_fn(micro)
        (loss / accum_steps).backward()
        total += loss.detach()
    return total / accum_steps


def _prepare(optimizer, accum_steps: int) -> None:
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    for group in optimizer.param_groups:
        for p in group["params"]:
            p.requires_grad_(True)


def _local_train_step(cfg, optimizer, remat, accum_steps, attn_impl):
    _prepare(optimizer, accum_steps)

    def step(params, batch: torch.Tensor) -> torch.Tensor:
        batch = batch.to(params["embed"].device)
        out = _accumulate(lambda micro: cross_entropy_loss(
            params, cfg, micro, attn_impl=attn_impl, remat=remat),
            optimizer, batch, accum_steps)
        optimizer.step()
        return out

    return step


def _mesh_train_step(cfg, mesh, optimizer, fsdp, remat, accum_steps,
                     attn_impl):
    _prepare(optimizer, accum_steps)
    shardings = param_shardings(cfg, mesh, fsdp_axis="data" if fsdp
                                else None)
    dp, sp = _size(mesh, "data"), _size(mesh, "seq")

    def reduce_grads(params):
        """Every gradient summed over ``data`` (an FSDP leaf's gather has
        summed it) and ``seq``, then divided by dp * sp."""
        for leaf, sh in zip(param_leaves(params), param_leaves(shardings)):
            if leaf.grad is None:    # unused here, and so on every rank
                leaf.grad = torch.zeros_like(leaf)
            g = leaf.grad
            if dp > 1 and "data" not in sh.spec:
                g = all_reduce(g, mesh.group("data"))
            if sp > 1:
                g = all_reduce(g, mesh.group("seq"))
            leaf.grad = g / (dp * sp) if dp * sp > 1 else g

    def step(params, batch: torch.Tensor) -> torch.Tensor:
        loss = _accumulate(lambda micro: mesh_token_losses(
            params, cfg, mesh, shardings, micro, remat=remat,
            attn_impl=attn_impl).mean(), optimizer, data_rows(batch, mesh),
            accum_steps)
        reduce_grads(params)
        optimizer.step()
        for axis in ("data", "seq"):
            if _size(mesh, axis) > 1:
                loss = all_reduce(loss, mesh.group(axis)) / _size(mesh, axis)
        return loss

    return step, shardings


def make_train_step(cfg: ModelConfig, mesh, optimizer=None, *,
                    fsdp: bool = False, remat: bool = False,
                    accum_steps: int = 1, attn_impl=None):
    """Build a training step over ``optimizer``, whose parameters are the
    leaves of the parameter tree (``param_leaves``); they are marked as
    requiring grad here. Two forms, told apart by the second argument
    being a :class:`~.mesh.Mesh`:

    ``make_train_step(cfg, optimizer, remat=, accum_steps=)``: one device.
    Returns ``step(params, batch) -> loss``. A step zeroes the gradients,
    runs forward and backward on each of ``accum_steps`` equal
    microbatches of the batch's leading dim (the loss of each scaled by 1
    / accum_steps, so the gradient is the mean of the microbatches'
    means, as the JAX step's), then steps the optimizer, which updates
    the parameters in place. ``remat=True`` checkpoints each decoder
    layer. It runs where the parameters are: on the card unless they were
    made on the CPU; the batch is moved there. Returns the mean loss (a
    detached fp32 scalar on that device).

    ``make_train_step(cfg, mesh, optimizer, fsdp=, remat=,
    accum_steps=)``: over ``mesh`` (axes ``data``, ``seq``, ``model``;
    see the module's docstring), as the JAX package's. Returns ``(step,
    shardings)``: ``shardings`` is :func:`param_shardings` (with
    ``fsdp_axis='data'`` if ``fsdp``), the layout of the local tree
    ``step`` takes (``parallel.mesh.device_put(params, shardings)``),
    over whose leaves ``optimizer`` must be built. ``step(params, batch)
    -> loss``: batch int [B, N+1], the same on every rank; this rank
    takes its ``data`` rows and its ``seq`` slice of the tokens
    (:func:`mesh_token_losses`). The gradients are summed over ``data``
    and ``seq`` and divided by their sizes before the optimizer steps, so
    every rank applies the gradient of the global mean loss, which it
    returns. ``attn_impl``: the single-device attention (default: the
    kernel)."""
    if isinstance(mesh, Mesh):
        return _mesh_train_step(cfg, mesh, optimizer, fsdp, remat,
                                accum_steps, attn_impl)
    if optimizer is not None or fsdp:
        raise TypeError("one device: make_train_step(cfg, optimizer, ...); "
                        "over a mesh: make_train_step(cfg, mesh, optimizer, "
                        "...)")
    return _local_train_step(cfg, mesh, remat, accum_steps, attn_impl)
