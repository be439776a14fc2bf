"""Pipeline parallelism: microbatched stages over a process group, with
the interleaved (virtual-chunk) schedule and tensor parallelism inside.

Counterpart of ``sink_attention_tpu/parallel/pp.py``, with process groups
where JAX takes axis names. Every rank runs the same per-step stage
function and activations hop from stage to stage by a ring ``ppermute``
over the ``pipe`` group.

Schedule. With S stages, M microbatches and V virtual chunks per rank
(``num_virtual``, Megatron-LM's interleaved schedule, arXiv:2104.04473
§2.2), the layers split into C = S*V chunks and rank s holds chunks
``{v*S + s : v < V}``. The loop runs ``T = V*M + S - 1`` steps; at step t
rank s runs work item ``w = t - s``:

    g = w // (V*S);  v = (w % (V*S)) // S;  i = w % S;  m = g*S + i

Each item's input arrives from the previous chunk through the ring (the
S-1 -> 0 wraparound carries chunk v -> v+1). The bubble is (S-1)/(V*M+S-1)
of the steps; V=1 is GPipe. V>1 needs M % S == 0.

PyTorch differentiates only what each rank's loss reaches, where JAX
transposes the whole program on every device: a rank that skipped a dead
step's stage, or chose the first stage's input with a Python ``if``,
would drop a ``ppermute`` (or a tensor-parallel all-reduce) from its
backward that its peers still wait for. So, as in JAX, the stage runs on
every step, dead ones included, every choice by rank, step, ``live`` or
``bank`` is a ``torch.where`` on a tensor condition, and every step's
output reaches the loss on every rank (the last step's ring transfer,
which nothing reads, is skipped on every rank).

Layer parameters are stacked [S, V, L/(S*V), ...], the stage dimension
split over ``pipe``; embed, lm_head and final_norm are whole on every
rank. Constraint: ``layer_types`` must tile, so every chunk has the same
sliding/full pattern.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from ..models.config import ModelConfig
from ..models.model import rms_norm, rope_cos_sin
from ..ops.flash import sink_flash_attention
from ._collectives import all_reduce, ppermute, psum, rank_and_size
from .mesh import Mesh, NamedSharding, PartitionSpec, tree_map
from .tp import tp_decoder_layer, tp_local_config
from .train import data_rows, make_sharded_attn, param_leaves

__all__ = ["stack_pipeline_params", "unstack_pipeline_params",
           "pipeline_forward", "make_pp_train_step",
           "pipeline_param_shardings"]


def _stage_pattern(cfg: ModelConfig, num_chunks: int):
    L = cfg.num_layers
    if L % num_chunks:
        raise ValueError(f"{L} layers do not split into {num_chunks} chunks")
    per = L // num_chunks
    pattern = tuple(cfg.layer_types[:per])
    for c in range(num_chunks):
        got = tuple(cfg.layer_types[c * per:(c + 1) * per])
        if got != pattern:
            raise ValueError(f"pipeline chunks need identical layer_type "
                             f"patterns; chunk {c} has {got}, chunk 0 has "
                             f"{pattern}")
    return per, pattern


def stack_pipeline_params(params: dict, num_stages: int,
                          num_virtual: int = 1) -> dict:
    """[L] list-of-layer params -> stacked {'stages': [S, V, L/(S*V), ...]}.
    Element [s, v] holds chunk ``v*num_stages + s`` (rank s's v-th virtual
    chunk), i.e. layers ``[(v*S+s)*per, (v*S+s+1)*per)``."""
    L = len(params["layers"])
    S, V = num_stages, num_virtual
    if L % (S * V):
        raise ValueError(f"{L} layers do not split into {S} x {V} chunks")
    per = L // (S * V)

    def stack(*leaves):
        x = torch.stack(leaves).reshape((V, S, per) + tuple(leaves[0].shape))
        return x.movedim(1, 0).contiguous()  # [S, V, per, ...]

    return {"embed": params["embed"],
            "stages": tree_map(stack, *params["layers"]),
            "final_norm": params["final_norm"],
            "lm_head": params["lm_head"]}


def unstack_pipeline_params(pp_params: dict, num_layers: int) -> dict:
    """Inverse of :func:`stack_pipeline_params`."""
    stages = pp_params["stages"]
    S, V, per = param_leaves(stages)[0].shape[:3]
    if S * V * per != num_layers:
        raise ValueError(f"{S} x {V} x {per} stacked layers, not "
                         f"{num_layers}")
    layers = [tree_map(lambda x: x[c % S, c // S, j], stages)
              for c in range(S * V) for j in range(per)]
    return {"embed": pp_params["embed"], "layers": layers,
            "final_norm": pp_params["final_norm"],
            "lm_head": pp_params["lm_head"]}


def pipeline_param_shardings(cfg: ModelConfig, mesh: Mesh,
                             pipe_axis: str = "pipe",
                             model_axis: Optional[str] = None):
    """Shardings of the stacked params: the stage dim over ``pipe_axis``;
    with ``model_axis``, heads and experts over it inside each stage
    (``parallel.tp``'s layout: q/k/v by output columns, wo by input rows,
    sinks, experts; router, bo and norms whole)."""
    pp, m = pipe_axis, model_axis

    def leaf(ndim_tail, shard_dim=None):
        # [S, V, per, <tail>]; shard_dim indexes into the tail
        spec = [pp, None, None] + [None] * ndim_tail
        if m is not None and shard_dim is not None:
            spec[3 + shard_dim] = m
        return NamedSharding(mesh, PartitionSpec(*spec))

    attn = {
        "wq": leaf(2, 1), "bq": leaf(1, 0),
        "wk": leaf(2, 1), "bk": leaf(1, 0),
        "wv": leaf(2, 1), "bv": leaf(1, 0),
        "wo": leaf(2, 0), "bo": leaf(1),
    }
    if cfg.use_s_aux:
        attn["sinks"] = leaf(1, 0)
    if cfg.mlp_type == "dense":
        mlp = {"gate": leaf(2, 1), "up": leaf(2, 1), "down": leaf(2, 0)}
    else:
        mlp = {
            "router_w": leaf(2), "router_b": leaf(1),
            "gate_up": leaf(3, 0), "gate_up_b": leaf(2, 0),
            "down": leaf(3, 0), "down_b": leaf(2, 0),
        }
    stages = {"attn": attn, "mlp": mlp, "ln1": leaf(1), "ln2": leaf(1)}
    whole = NamedSharding(mesh, PartitionSpec())
    return {"embed": whole, "stages": stages, "final_norm": whole,
            "lm_head": whole}


def pipeline_forward(pp_params: dict, cfg: ModelConfig,
                     input_ids: torch.Tensor, num_stages: int,
                     num_microbatches: int, group=None, seq_group=None,
                     model_group=None, num_virtual: int = 1,
                     attn_impl=None, remat: bool = False) -> torch.Tensor:
    """Pipelined logits, on every rank of the ``pipe`` group ``group``
    (None: the default group).

    pp_params: the stacked params with the stage dim cut to this rank's
    stage ([1, V, L/(S*V), ...]) and, with ``model_group``, the heads and
    experts to this rank's TP shard. input_ids: [B, N], the same on every
    rank of the pipe, seq and model groups; with ``seq_group`` this rank
    takes its slice of the sequence. attn_impl: attention on [mb,
    H_local, N_local, D] (default: the kernel; pass a Ulysses wrapper
    with ``seq_group``). ``remat=True`` checkpoints each layer of a stage
    (its backward reruns the layer, its collectives included, on every
    rank alike). Returns logits [B, N_local, V], the same on every pipe
    rank.
    """
    S, M, V = num_stages, num_microbatches, num_virtual
    per, _ = _stage_pattern(cfg, S * V)
    if V > 1 and M % S:
        raise ValueError(f"interleaved schedule needs microbatches ({M}) to "
                         f"be a multiple of stages ({S})")
    B, N = input_ids.shape
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    mb = B // M
    tp = 1 if model_group is None else rank_and_size(model_group)[1]
    cfg_local = tp_local_config(cfg, tp)
    attn_impl = attn_impl or sink_flash_attention
    dev = input_ids.device

    n_local, lo = N, 0
    if seq_group is not None:
        seq_rank, sp = rank_and_size(seq_group)
        n_local = N // sp
        lo = seq_rank * n_local
    ids_local = input_ids[:, lo:lo + n_local]
    cos, sin = rope_cos_sin(cfg, torch.arange(lo, lo + n_local, device=dev))

    s_idx = rank_and_size(group)[0]
    chunks = tree_map(lambda x: x[0], pp_params["stages"])   # [V, per, ...]

    def stage_fn(x, v):
        for j in range(per):
            def layer(x, lp=tree_map(lambda a: a[v, j], chunks),
                      window=cfg.window_for_layer(j, N)):
                return tp_decoder_layer(lp, cfg_local, x, cos, sin, window,
                                        attn_impl, model_group)
            x = (torch.utils.checkpoint.checkpoint(layer, x,
                                                   use_reentrant=False)
                 if remat else layer(x))
        return x

    def flag(b: bool) -> torch.Tensor:
        return torch.tensor(b, device=dev)

    embed = pp_params["embed"]
    micro = ids_local.reshape(M, mb, n_local)
    zeros = torch.zeros((mb, n_local, cfg.hidden_size), dtype=embed.dtype,
                        device=dev)
    state, outs = zeros, [zeros] * M
    T = V * M + S - 1
    for t in range(T):
        w = min(max(t - s_idx, 0), V * M - 1)
        live = 0 <= t - s_idx < V * M
        v = (w % (V * S)) // S
        m = (w // (V * S)) * S + w % S
        # Rank 0 starts microbatch m at chunk 0 from a fresh embedding;
        # every other (s, v) takes the ring's state (the S-1 -> 0
        # wraparound carries chunk v-1 -> v when V > 1).
        x_in = torch.where(flag(s_idx == 0 and v == 0),
                           embed[micro[m]], state)
        x_out = stage_fn(x_in, v)
        # The last stage banks microbatch m after its last chunk.
        outs[m] = torch.where(flag(live and s_idx == S - 1 and v == V - 1),
                              x_out, outs[m])
        if t < T - 1:
            state = ppermute(x_out, group)

    x = torch.cat(outs, dim=0)
    x = rms_norm(x, pp_params["final_norm"], cfg.rms_norm_eps)
    logits = x @ pp_params["lm_head"].to(x.dtype)
    # The last stage's logits to every pipe rank, so the loss is the same
    # everywhere; psum's backward sums the S equal cotangents, which the
    # step divides out.
    return psum(torch.where(flag(s_idx == S - 1), logits,
                            torch.zeros_like(logits)), group)


def make_pp_train_step(cfg: ModelConfig, mesh: Mesh, optimizer,
                       num_microbatches: int = 2, num_virtual: int = 1,
                       pipe_axis: str = "pipe", attn_impl=None,
                       remat: bool = False):
    """Pipeline-parallel training step over ``mesh``'s axes ``pipe_axis``
    and any of ``data``, ``seq``, ``model``: DP splits the batch's rows,
    Ulysses SP the sequence (the attention's all-to-alls), TP/EP the heads
    and experts inside the stages; ``num_virtual`` > 1 runs the
    interleaved schedule (needs num_microbatches % stages == 0).

    Returns ``(step, shardings)``: ``shardings`` is
    :func:`pipeline_param_shardings`, the layout of the local stacked tree
    ``step`` takes (``parallel.mesh.device_put(stack_pipeline_params(...),
    shardings)``), over whose leaves ``optimizer`` must be built.
    ``step(pp_params, batch) -> loss``, batch int [B, N+1] the same on
    every rank. The gradient fix-ups are JAX's: every gradient divided by
    S (each pipe rank's loss seeds the logits' psum); the whole leaves
    (embed, lm_head, final_norm) summed over ``pipe`` (the embedding's
    gradient lives on stage 0, the head's on stage S-1); loss and
    gradients averaged over ``seq`` and ``data``. ``attn_impl``: the
    single-device attention (default: the kernel); ``remat``: checkpoint
    each layer (:func:`pipeline_forward`)."""
    S = mesh.shape[pipe_axis]
    groups = {a: mesh.group(a) for a in ("seq", "data", "model")
              if mesh.shape.get(a, 1) > 1}
    shardings = pipeline_param_shardings(
        cfg, mesh, pipe_axis, model_axis="model" if "model" in groups
        else None)
    attn = make_sharded_attn(mesh, attn_impl=attn_impl)
    pipe = mesh.group(pipe_axis)
    for grp in optimizer.param_groups:
        for p in grp["params"]:
            p.requires_grad_(True)

    def step(pp_params, batch: torch.Tensor) -> torch.Tensor:
        batch = data_rows(batch, mesh)
        optimizer.zero_grad(set_to_none=True)
        inputs, targets = batch[:, :-1], batch[:, 1:]
        logits = pipeline_forward(
            pp_params, cfg, inputs, S, num_microbatches, group=pipe,
            seq_group=groups.get("seq"), model_group=groups.get("model"),
            num_virtual=num_virtual, attn_impl=attn, remat=remat)
        n_local = logits.shape[1]
        if "seq" in groups:
            lo = mesh.axis_index("seq") * n_local
            targets = targets[:, lo:lo + n_local]
        loss = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]), targets.reshape(-1))
        loss.backward()
        for leaf, sh in zip(param_leaves(pp_params), param_leaves(shardings)):
            g = (torch.zeros_like(leaf) if leaf.grad is None
                 else leaf.grad) / S
            if not (len(sh.spec) > 0 and sh.spec[0] == pipe_axis):
                g = all_reduce(g, pipe)
            for axis in ("seq", "data"):
                if axis in groups:
                    g = all_reduce(g, groups[axis]) / mesh.shape[axis]
            leaf.grad = g
        loss = loss.detach()
        for axis in ("seq", "data"):
            if axis in groups:
                loss = all_reduce(loss, groups[axis]) / mesh.shape[axis]
        optimizer.step()
        return loss

    return step, shardings
