"""Device timing with CUDA events, the card's name and power limit, and the
H100's published peaks.

Timing is for the card only: without CUDA, :func:`time_cuda` raises rather
than measure the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Callable

import numpy as np
import torch

__all__ = ["time_cuda", "card_line", "sink_attention_flops",
           "attention_pairs", "H100_PEAK_BF16", "H100_PEAK_INT8",
           "H100_PEAK_FP32", "H100_HBM_BW"]

H100_PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
H100_PEAK_INT8 = 1979e12  # H100 SXM dense int8 / fp8 tensor-core OP/s
H100_PEAK_FP32 = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
H100_HBM_BW = 3.35e12    # H100 SXM HBM3 bytes/s


def time_cuda(fn: Callable[[], object], iters: int = 20,
              warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current CUDA stream,
    from CUDA events around ``iters`` back-to-back calls after warm-up."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them: every
    time is kept beside it, since a card below its power limit runs
    slower under load."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi: " + out.stderr.strip())


def attention_pairs(n_q: int, n_kv: int, num_sink: int, window: int,
                    q_offset: int = 0, kv_offset: int = 0) -> int:
    """Number of visible (query, key) pairs of one head: key j (global
    kv_offset + col, >= 0) is visible to query i (global q_offset + row)
    iff j <= i and (j < num_sink or j >= i - window + 1)."""
    i = q_offset + np.arange(n_q, dtype=np.int64)
    lo = max(kv_offset, 0)                          # first real column
    hi = np.minimum(i, kv_offset + n_kv - 1)        # last visible column
    sink = np.clip(np.minimum(hi, num_sink - 1) - lo + 1, 0, None)
    win_lo = np.maximum(np.maximum(i - window + 1, num_sink), lo)
    win = np.clip(hi - win_lo + 1, 0, None)
    return int((sink + win).sum())


def sink_attention_flops(B: int, H_q: int, N: int, D: int, num_sink: int,
                         window: int, n_kv: int | None = None) -> int:
    """Useful attention FLOPs: 4 * B * H_q * D * sum_i |attended(i)|."""
    n_kv = N if n_kv is None else n_kv
    return 4 * B * H_q * D * attention_pairs(N, n_kv, num_sink, window)
