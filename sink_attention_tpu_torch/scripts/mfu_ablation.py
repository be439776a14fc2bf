"""Prefill-kernel ablation: where the forward kernel's time goes, stage by
stage, on the card.

    python3 -m sink_attention_tpu_torch.scripts.mfu_ablation [--n 8192]
        [--stages mxu_floor,rowmax,...]

Counterpart of the JAX package's ``scripts/mfu_ablation.py``. At its
headline shape (B=1, GQA 32/8, D=128, 4 sinks, W=4096, bf16) it times the
stripped copies of the forward kernel of ``ops/ablation.py`` (the tensor
core floor, then the running max, exp2, the row sum and the mask added one
at a time, and the candidate variants), each with its effective MFU (the
useful attention FLOPs over its time and the H100's dense bf16 peak) and
its delta against the stage before, then ``full``: the production forward
kernel. Each stage is that kernel (``csrc/hopper.cuh``) with its softmax
cut to the stage, over the same grid and 128 x 128 tiles, as the JAX
script's stages run over its production kernel's grid and tiles; so a
stage's time less ``mxu_floor``'s is what that piece costs in the kernel
prefill launches. The two mask stages compute correct attention and are
held to the production forward (< 2e-2) before they are timed.

The comparison with the production forward (:func:`production_error`)
runs on CPU tensors too; the timing needs the card, and without CUDA the
script exits nonzero and prints no table.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from ..ops import ablation, flash
from ..utils import (H100_PEAK_BF16, card_line, resolve_device,
                     sink_attention_flops, time_cuda)

__all__ = ["run_ablation", "production_error", "make_inputs", "stage_table",
           "main"]

B, HQ, HKV, D, NS, W = 1, 32, 8, 128, 4, 4096
N = 8192
MASK_TOL = 2e-2  # bf16 output against the production forward


def make_inputs(n: int = N, seed: int = 0, device="cuda", batch: int = B,
                h_q: int = HQ, h_kv: int = HKV, d: int = D):
    """bf16 q [batch, h_q, n, d] and k, v [batch, h_kv, n, d], normal, from
    a torch.Generator seeded ``seed`` on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda h: torch.randn(batch, h, n, d, generator=gen,
                               device=dev).to(torch.bfloat16)
    return mk(h_q), mk(h_kv), mk(h_kv)


def run_ablation(q, k, v, stage: str, num_sink: int = NS,
                 window: int = W) -> torch.Tensor:
    """One stage: the kernel on the card, its plain version on the CPU."""
    return ablation.ablation_attention(q, k, v, stage, num_sink, window)


def production_error(q, k, v, stage: str, num_sink: int = NS,
                     window: int = W,
                     ref: Optional[torch.Tensor] = None) -> float:
    """Max abs difference between the stage's output and the production
    forward without s_aux (``ref``, computed if not given); a NaN counts
    as infinitely far."""
    if ref is None:
        ref = flash.sink_flash_attention(q, k, v, num_sink, window)
    out = run_ablation(q, k, v, stage, num_sink, window)
    diff = (out.float() - ref.float()).abs()
    return float(diff.nan_to_num(nan=float("inf")).max())


def stage_table(q, k, v, stages: Sequence[str] = ablation.STAGES,
                num_sink: int = NS, window: int = W) -> list:
    """Rows {stage, ms, mfu, delta_ms[, err]} of each stage, then "full"
    (the production forward kernel), timed on the card, back to back. The
    mask stages are first held to the production forward: a miss raises."""
    timer = lambda fn: time_cuda(fn, iters=10, warmup=2)
    Bx, H_q, n, d = q.shape
    flops = sink_attention_flops(Bx, H_q, n, d, num_sink, window)
    rows, ref, prev = [], None, None
    for stage in stages:
        row = {"stage": stage}
        if stage in ablation.MASK_STAGES:
            if ref is None:
                ref = flash.sink_flash_attention(q, k, v, num_sink, window)
            row["err"] = production_error(q, k, v, stage, num_sink, window,
                                          ref)
            if not row["err"] < MASK_TOL:
                raise RuntimeError(f"stage {stage} is {row['err']:.3e} off "
                                   f"the production forward")
        row["ms"] = timer(lambda: run_ablation(q, k, v, stage, num_sink,
                                               window))
        rows.append(row)
    rows.append({"stage": "full", "ms": timer(lambda: flash.flash_fwd_kernel(
        q, k, v, None, num_sink, window))})
    for row in rows:
        row["mfu"] = flops / (row["ms"] * 1e-3) / H100_PEAK_BF16
        row["delta_ms"] = None if prev is None else row["ms"] - prev
        prev = row["ms"]
    return rows


def format_rows(rows) -> list:
    lines = [f"{'variant':<13} {'ms':>9} {'eff-MFU%':>9} {'delta ms':>9}"]
    for r in rows:
        delta = "" if r["delta_ms"] is None else f"{r['delta_ms']:+9.4f}"
        lines.append(f"{r['stage']:<13} {r['ms']:>9.4f} "
                     f"{r['mfu'] * 100:>9.2f} {delta:>9}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N, help="sequence length")
    ap.add_argument("--stages", default=",".join(ablation.STAGES),
                    help="comma-separated stages, in order")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mfu_ablation: CUDA is not available; nothing was timed",
              file=sys.stderr)
        return 1
    stages = args.stages.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}", flush=True)
    q, k, v = make_inputs(args.n)
    flops = sink_attention_flops(B, HQ, args.n, D, NS, W)
    print(f"B={B} H={HQ}/{HKV} N={args.n} D={D} sink={NS} W={W} bf16; "
          f"analytic 100%-MFU time {flops / H100_PEAK_BF16 * 1e3:.4f} ms; "
          f"useful TFLOP {flops / 1e12:.4f}", flush=True)
    for line in format_rows(stage_table(q, k, v, stages)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
