"""A named device mesh over ``torch.distributed``.

Counterpart of ``sink_attention_tpu/parallel/mesh.py``. The JAX package's
mesh is a ``jax.sharding.Mesh`` whose named axes its collectives take by
name; here each process is one rank of the mesh, and each named axis is a
family of process groups: the ranks that differ in that axis's coordinate
only. A :class:`Mesh` holds, like JAX's, an array of ranks shaped by the
axes (``mesh.ranks``; ``mesh.shape[axis]`` its sizes), and for this rank
its group along each axis (``mesh.group(axis)``, where JAX names the axis)
and its coordinate there (``mesh.axis_index(axis)``, ``lax.axis_index``).

A :class:`NamedSharding` is a mesh and a :class:`PartitionSpec`: per
dimension of a tensor, the mesh axis it is split over or ``None`` (JAX's
layout, so specs compare with JAX's leaf by leaf). :func:`device_put`
keeps this rank's block of every leaf of a tree (``jax.device_put(tree,
shardings)`` as one rank sees it), :func:`gather_tree` rebuilds the whole
leaves from the blocks of every rank.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ._collectives import all_gather_tensor

__all__ = ["DATA_AXIS", "SEQ_AXIS", "MODEL_AXIS", "Mesh", "PartitionSpec",
           "NamedSharding", "make_mesh", "make_multihost_mesh", "replicated",
           "shard", "device_put", "gather_tree", "tree_map"]

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


class Mesh:
    """Named axes over the ranks of the default process group.

    ``ranks`` is an integer array of the world's ranks shaped by the axes'
    sizes (rank ``ranks[i, j, ...]`` sits at coordinates ``(i, j, ...)``),
    ``axis_names`` names its dimensions, ``device`` is where this rank
    computes. Every rank must build the same mesh, in the same order as any
    other group: each axis's groups are made with ``dist.new_group``, which
    every rank calls for every group."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device):
        ranks = np.asarray(ranks)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"{ranks.ndim} dimensions for axes {axis_names}")
        world = dist.get_world_size()
        if sorted(ranks.reshape(-1).tolist()) != list(range(world)):
            raise ValueError(f"the mesh's ranks {ranks.reshape(-1).tolist()} "
                             f"are not the world's {world}")
        self.ranks, self.axis_names = ranks, tuple(axis_names)
        self.device = torch.device(device)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        me = dist.get_rank()
        coords = np.argwhere(ranks == me)[0]
        self._index = {a: int(c) for a, c in zip(self.axis_names, coords)}
        self._groups = {}
        for i, axis in enumerate(self.axis_names):
            rows = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
            for row in rows.tolist():
                group = dist.new_group(row)
                if me in row:
                    self._groups[axis] = group

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self._groups[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self._index[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


class PartitionSpec(tuple):
    """Per tensor dimension, the mesh axis it is split over, or None;
    ``PartitionSpec()`` is replicated (JAX's ``PartitionSpec`` layout)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)}"


class NamedSharding:
    """A tensor's layout over a mesh: ``spec[d]`` names the axis that
    dimension ``d`` is split over (in equal blocks, the block of
    coordinate ``i`` at ``i``), None where it is whole."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.spec})"

    def local_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``: a new tensor on the
        mesh's device (``x`` may be freed, and is never updated through
        it)."""
        x = x.detach()
        for d, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = self.mesh.shape[axis]
            if x.shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(x.shape)} does "
                                 f"not split over {n} ranks of '{axis}'")
            size = x.shape[d] // n
            x = x.narrow(d, self.mesh.axis_index(axis) * size, size)
        return x.to(self.mesh.device, copy=True,
                    memory_format=torch.contiguous_format)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's ``block`` (all-gathers along
        each split dimension over its axis's group)."""
        for d, axis in enumerate(self.spec):
            if axis is not None:
                block = all_gather_tensor(block, d, self.mesh.group(axis))
        return block


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict / list tree (and the
    matching leaves of ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def device_put(tree, shardings):
    """This rank's block of every leaf of ``tree`` (whole tensors, the
    same on every rank) under ``shardings`` (a tree of NamedSharding of
    the same structure, as :func:`parallel.train.param_shardings`
    returns), on the mesh's device."""
    return tree_map(lambda x, s: s.local_block(x), tree, shardings)


def gather_tree(tree, shardings):
    """The inverse of :func:`device_put`: every leaf whole, from the
    blocks of every rank (a collective: every rank calls it)."""
    return tree_map(lambda x, s: s.gather(x), tree, shardings)


def make_mesh(axis_sizes: Optional[Dict[str, int]] = None,
              device="cuda") -> Mesh:
    """A mesh over the default process group, its ranks laid out in
    row-major order of ``axis_sizes`` (default: every rank on ``data``,
    sizes (world, 1, 1) of ('data', 'seq', 'model')). ``device`` is where
    this rank computes: the card unless told otherwise."""
    dev = resolve_device(device)
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: world, SEQ_AXIS: 1, MODEL_AXIS: 1}
    sizes = tuple(axis_sizes.values())
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {axis_sizes} needs {math.prod(sizes)} "
                         f"ranks, the world has {world}")
    return Mesh(np.arange(world).reshape(sizes), tuple(axis_sizes), dev)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec))


def make_multihost_mesh(axis_sizes: Dict[str, int],
                        dcn_axes: Sequence[str] = (DATA_AXIS,),
                        initialize: bool = False, device="cuda") -> Mesh:
    """A mesh over several nodes: the axes named in ``dcn_axes`` split
    across nodes (over the network between them), every other axis stays
    inside a node, where the attention and tensor-parallel collectives
    ride the fast links.

    Nodes hold consecutive ranks, as many each as the
    ``LOCAL_WORLD_SIZE`` that ``torchrun`` sets (unset: the whole world,
    one node). The nodes are spread over the dcn axes in order, each taking
    the largest factor of its size that still divides the nodes left,
    as the JAX package does; coordinate ``i`` of an axis split ``dcn``
    ways over nodes and ``ici`` ways inside one is node block ``i //
    ici``, local block ``i % ici``. On one node this is :func:`make_mesh`.
    ``initialize=True`` first calls ``dist.init_process_group()`` from the
    environment (``env://``)."""
    dev = resolve_device(device)
    if initialize:
        dist.init_process_group()
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"{world} ranks do not split into nodes of {local}")
    n_nodes = world // local
    if n_nodes == 1:
        return make_mesh(axis_sizes, device=dev)
    names, sizes = tuple(axis_sizes), tuple(axis_sizes.values())
    if math.prod(sizes) != world:
        raise ValueError(f"mesh {axis_sizes} needs {math.prod(sizes)} "
                         f"ranks, the world has {world}")
    remaining, dcn = n_nodes, []
    for name, size in axis_sizes.items():
        f = math.gcd(size, remaining) if name in dcn_axes else 1
        dcn.append(f)
        remaining //= f
    if remaining != 1:
        raise ValueError(f"cannot split {n_nodes} nodes over dcn axes "
                         f"{tuple(dcn_axes)} with sizes {axis_sizes}")
    ici = tuple(s // d for s, d in zip(sizes, dcn))
    ranks = np.empty(sizes, dtype=np.int64)
    for rank in range(world):
        node, lr = divmod(rank, local)
        coords = tuple(n * i + l for n, l, i in zip(
            np.unravel_index(node, dcn), np.unravel_index(lr, ici), ici))
        ranks[coords] = rank
    return Mesh(ranks, names, dev)
