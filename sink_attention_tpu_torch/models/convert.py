"""Carry parameters over from the JAX package.

``params_from_jax`` takes the JAX ``init_params`` tree, or a quantized one
(``models.quant``), with numpy leaves (``jax.tree.map(np.asarray,
params)`` on the JAX side) and returns the same tree with torch tensors,
so both packages compute the same model. Weights
keep their [in, out] layout: both compute ``x @ w``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(tree, device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """Convert a nested dict/list of numpy arrays leaf by leaf to tensors on
    ``device``, floating leaves cast to ``dtype`` when given (else each
    leaf's own dtype). Integer leaves keep theirs: the int8 codes of a
    quantized weight (``{"q", "s"}``, ``{"q4", "s"}``) stay int8."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: go through fp32
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
        cast = dtype if dtype is not None and t.is_floating_point() else None
        return t.to(device=dev, dtype=cast or t.dtype)

    return conv(tree)
