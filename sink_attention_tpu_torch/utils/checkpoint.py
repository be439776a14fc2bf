"""Checkpoint and resume with PyTorch's own serialisation.

Counterpart of ``sink_attention_tpu/utils/checkpoint.py`` (orbax there).
Parameter trees, optimizer state and decode caches are nested dicts and
lists of tensors, so ``save``/``restore`` handle them alike: ``torch.save``
of the tree, ``torch.load(weights_only=True)`` back (tensors, Python
numbers, strings and None only; nothing is unpickled that could run
code). Quantized leaves (``{"q", "s"}``, ``{"q4", "s"}``) are dicts like
any other.

An object with a ``state_dict()`` (a ``SinkKVCache`` or
``RaggedSinkKVCache``: every field by name, the buffers, the length state
and the static layout) is saved as that dict, which is what ``restore``
gives back, as orbax gives back a cache's fields in JAX; the cache's
``load_state_dict`` copies it back in place.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from .device import resolve_device

__all__ = ["save", "restore", "save_params", "restore_params"]


def _saveable(tree):
    if callable(getattr(tree, "state_dict", None)):
        return _saveable(tree.state_dict())
    if isinstance(tree, dict):
        return {k: _saveable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_saveable(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def save(path: str, tree: Any) -> None:
    """Save a tree (params, optimizer state, caches) to the file ``path``.
    The file is written beside it and renamed into place, so a reader
    never sees half a checkpoint and a restored tree's memory map stays
    valid."""
    tmp = path + ".tmp"
    torch.save(_saveable(tree), tmp)
    os.replace(tmp, path)


def _place(tree, template, dev):
    """Each tensor of ``tree`` copied to ``dev`` or, with a template, to
    its template leaf's device and dtype; never a view of the file."""
    if isinstance(tree, dict):
        if template is not None and set(tree) != set(template):
            raise ValueError(f"the template's keys {sorted(template)} are "
                             f"not the checkpoint's {sorted(tree)}")
        return {k: _place(v, None if template is None else template[k], dev)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if template is not None and len(template) != len(tree):
            raise ValueError(f"the template has {len(template)} entries "
                             f"where the checkpoint has {len(tree)}")
        return type(tree)(
            _place(v, None if template is None else template[i], dev)
            for i, v in enumerate(tree))
    if not isinstance(tree, torch.Tensor):
        return tree
    if isinstance(template, torch.Tensor):
        return torch.empty(tree.shape, dtype=template.dtype,
                           device=template.device).copy_(tree)
    return torch.empty(tree.shape, dtype=tree.dtype,
                       device=dev or "cpu").copy_(tree)


def restore(path: str, template: Optional[Any] = None,
            device="cuda") -> Any:
    """Restore a tree saved by :func:`save`, each tensor on ``device`` (the
    card unless told otherwise). ``template``, a tree of the same
    structure, sets each tensor leaf's device and dtype instead (under a
    template leaf that is not a tensor, tensors come back on the CPU). A
    saved cache comes back as its dict of fields (its ``state_dict``).
    The file is memory-mapped, so host memory stays near one tensor."""
    dev = None if template is not None else resolve_device(device)
    tree = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)
    return _place(tree, template, dev)


# Convenience aliases
save_params = save
restore_params = restore
