"""Differentiable collectives over a ``torch.distributed`` process group.

The JAX package runs its sequence parallelism on ``lax`` collectives inside
``shard_map``; these are their counterparts, each an autograd function
whose backward is the transpose JAX gives the collective:

- :func:`psum`: the sum over the group (``lax.psum``); its backward is the
  same all-reduce of the cotangent.
- :func:`ppermute_start` / :meth:`Permute.wait`: each rank's tensor to
  rank ``r + 1 mod n`` (``lax.ppermute`` with that permutation), split in
  two so that a caller can issue the transfer, run a kernel, then wait;
  the backward sends the cotangent to ``r - 1``.
- :func:`all_to_all`: split one dimension into ``n`` chunks, send chunk
  ``j`` to rank ``j`` and concatenate what arrives along another
  (``lax.all_to_all(tiled=True)``), through ``all_to_all_single`` over a
  contiguous layout with the chunks first (gloo lacks the list form on
  some builds); its backward is the inverse all-to-all.
- :func:`all_gather`: every rank's block concatenated along one dimension
  (``lax.all_gather(tiled=True)``), the FSDP gather of a parameter at its
  use; its backward is the reduce-scatter (each rank's block of the sum of
  the cotangents). gloo has neither an all-gather of CUDA tensors nor a
  reduce-scatter, so both go through ``all_to_all_single``: the gather
  sends this rank's block to every rank, the reduce-scatter sends block
  ``j`` of the cotangent to rank ``j`` and sums what arrives.

- :func:`tp_region_in` / :func:`tp_region_out`: the f and g operators of
  Megatron-LM (arXiv:1909.08053 §3) that the JAX package writes for
  tensor parallelism. ``tp_region_in`` is the identity forward and sums
  the cotangent over the group backward: a replicated value entering a
  head- or expert-split region, whose cotangent each rank gives only its
  shard's part of. ``tp_region_out`` sums forward and is the identity
  backward: the partial sums leaving such a region, whose cotangent is
  replicated. :func:`tp_gather` is the concatenating form of
  ``tp_region_out`` for an output split along a dimension (the lm_head's
  vocabulary): all-gather forward, this rank's block of the cotangent
  backward. ``psum`` is neither: it sums in both directions.

``group=None`` is the default (world) group; rank and size come from the
group. Every rank must make the same calls in the same order, forward and
backward.

On a gloo group a CUDA tensor's send and receive (:func:`ppermute`) go
through a host copy, always: gloo takes CUDA tensors in all_reduce and
all_to_all_single, but its send/recv reads them as host memory (torch
2.11 with CUDA 12.8 on an H100: "writev ... Bad address"). That copy is
the transport of those tensors; the attention around them stays on the
card. NCCL takes every collective on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["rank_and_size", "psum", "ppermute", "ppermute_start", "Permute",
           "all_to_all", "all_gather", "all_gather_tensor", "all_reduce",
           "tp_region_in", "tp_region_out", "tp_gather"]


def rank_and_size(group=None):
    """(this process's rank in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def _global(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor; not differentiable)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` on every rank; its backward sums the
    cotangent over the group the same way (JAX ``psum``'s transpose)."""
    return _PSum.apply(x, group)


class _Transfer:
    """One shift of a tensor along the ring of ranks, in flight."""

    def __init__(self, x: torch.Tensor, group, shift: int):
        rank, n = rank_and_size(group)
        self.device, self.works = x.device, []
        send = x.detach().contiguous()
        if n == 1:              # JAX's ppermute over one device: a copy
            self.recv = send.clone()
            return
        if send.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
            send = send.cpu()       # gloo's send/recv takes host memory
        self.send, self.recv = send, torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, _global(group, (rank + shift) % n),
                          group),
               dist.P2POp(dist.irecv, self.recv,
                          _global(group, (rank - shift) % n), group)]
        self.works = dist.batch_isend_irecv(ops)

    def result(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        self.works = []
        return self.recv.to(self.device)


class _Permuted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, transfer, group):
        ctx.group = group
        return transfer.result()

    @staticmethod
    def backward(ctx, g):
        return _Transfer(g, ctx.group, -1).result(), None, None


class Permute:
    """A :func:`ppermute_start` in flight: :meth:`wait` returns the left
    neighbour's tensor, differentiable in the tensor this rank sent."""

    def __init__(self, x: torch.Tensor, group=None):
        self.x, self.group = x, group
        self.transfer = _Transfer(x, group, 1)

    def wait(self) -> torch.Tensor:
        return _Permuted.apply(self.x, self.transfer, self.group)


def ppermute_start(x: torch.Tensor, group=None) -> Permute:
    """Issue the send of ``x`` to rank ``r + 1 mod n`` and the receive from
    ``r - 1``; the result comes from ``.wait()``. Over one rank the result
    is a copy of ``x``."""
    return Permute(x, group)


def ppermute(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` of rank ``r - 1 mod n`` on rank ``r`` (send and wait)."""
    return ppermute_start(x, group).wait()


def _exchange(x: torch.Tensor, split_dim: int, concat_dim: int, group):
    _, n = rank_and_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    inp = torch.stack(x.detach().chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _exchange(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _exchange(g, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group=None) -> torch.Tensor:
    """Chunk ``j`` of ``x`` along ``split_dim`` to rank ``j``; the chunks
    received, in rank order, concatenated along ``concat_dim`` (JAX
    ``all_to_all(split_axis, concat_axis, tiled=True)``). The backward is
    the inverse exchange."""
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def _blocks(inp: torch.Tensor, group) -> torch.Tensor:
    """``inp`` [n, ...]: row ``j`` goes to rank ``j``; returns [n, ...] with
    row ``j`` from rank ``j``."""
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return out


def all_gather_tensor(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``x``, in rank order, concatenated along ``dim`` (not
    differentiable)."""
    _, n = rank_and_size(group)
    x = x.detach().contiguous()
    if n == 1:
        return x.clone()
    rows = _blocks(x.unsqueeze(0).expand(n, *x.shape).contiguous(), group)
    return torch.cat(rows.unbind(0), dim=dim)


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    _, n = rank_and_size(group)
    if n == 1:
        return g.detach().clone()
    if g.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(g.shape)} does not "
                         f"split over {n} ranks")
    rows = _blocks(torch.stack(g.detach().chunk(n, dim=dim)).contiguous(),
                   group)
    return rows.sum(dim=0)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_tensor(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's block ``x`` concatenated along ``dim`` on every rank
    (JAX ``all_gather(axis=dim, tiled=True)``); the backward is the
    reduce-scatter: this rank's block of the cotangents summed over the
    group, as JAX transposes the gather."""
    return _AllGather.apply(x, dim, group)


class _RegionIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _RegionOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_tensor(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        rank, n = rank_and_size(ctx.group)
        return g.chunk(n, dim=ctx.dim)[rank].contiguous(), None, None


def tp_region_in(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward (Megatron's f): apply to a
    replicated value entering a tensor-sharded region."""
    return _RegionIn.apply(x, group)


def tp_region_out(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward, identity backward (Megatron's g): apply to the
    partial sums leaving a tensor-sharded region."""
    return _RegionOut.apply(x, group)


def tp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of an output split along ``dim`` (forward), this
    rank's block of the replicated cotangent (backward)."""
    return _Gather.apply(x, dim, group)
