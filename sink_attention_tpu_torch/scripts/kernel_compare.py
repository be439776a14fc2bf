"""Time the attention kernels (the forward, dQ, dK/dV, unpacked and
packed; the decode) of this checkout against another on one card.

    python3 -m sink_attention_tpu_torch.scripts.kernel_compare OTHER_TREE
        [--kernels flash_fwd_kernel,packed_fwd_kernel,...]
        [--out build/kernel_compare.json]

``OTHER_TREE`` is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive``). ``--kernels``
names the wrappers to time (default: all of KERNELS):
``flash_fwd_kernel`` runs at the forward's main-path shapes of
``chip_smoke.py``'s phase 2 (gpt-oss-20b's W=128 and full prefill layers)
and the headline; ``flash_dq_kernel`` and ``flash_dkdv_kernel`` at its
backward shapes (the training layers at W=128 and W=4096, the headline,
the halo chunk, GQA groups 1 and 16, N_q = 250); ``packed_fwd_kernel``,
``packed_dq_kernel`` and ``packed_dkdv_kernel`` on its packs (the phase-5
mix at both W, the 64-3072 headline pack and the edge cases);
the forward, dQ and dK/dV also at the shapes of their narrow instances
(NARROW_DIMS: H2O-Danube-1.8B's at D = 72-96 in bf16 and fp32, Phi-3-mini's
at D = 96, 72 and 88, a Danube pack at D = 80 and 96 and a Phi-3-mini pack
at D = 96), and at Danube's D = 72 and 88 with the operands zero-padded
by the caller to 80 and 96, the copies in and out included (PADDED);
``decode_kernel`` over phase 2's caches (gpt-oss-20b's sliding ring and
full layer mid-decode in bf16, int8 and fp8, the headline in bf16 and
fp8), up to D = 128 over
4096 live slots of H2O-Danube-1.8B (D = 80, 32/8: bf16, fp32, int8),
Phi-3-mini (D = 96, 32/32) and GQA 8/4 at D = 64 and 128, and at B = 1
over 32768 live slots (D = 64 at 64/8, D = 128 at 32/8), and, past D =
128, over the
Gemma-2-2B geometry's 4096 live slots at D = 256, 512 and 1024 in every
storage (bf16, fp16, fp32, int8, fp8), at D = 640 and 2048 over 1028 live
slots (bf16, int8, fp8) and at B = 1 over a 32768-slot bf16 cache (D =
256); the other kernels also at phase 14's Gemma-2-2B shapes (D = 256:
a sliding W=4096 and a full layer, Gemma 3's local W=1024 with and
without 4 sinks and ``s_aux``, the packs at W=4096 and 1024) and at one
of phase 15's (D = 512); dK/dV also at sink tokens beside a short window,
each row beside its no-sink twin (the library's defaults, 4 sinks at
W=512, at the headline geometry; gpt-oss-20b's W=128 layer with 4 sinks;
D=384 at W=4096 with 4 sinks; a Gemma 3 local pack of 6144 + 2048), each
dK/dV row with its piece count (``pieces``, where the checkout cuts key
blocks into pieces). The decode rows also carry SDPA's time over the same
(dequantized) cache with the live mask (``library_ms``, PyTorch's default
backend) and the least time the card could take (``bound_ms``: the live
K/V bytes at 3.35 TB/s, or the products at the peak rate of their type if
more; the table prints each checkout's share of it, bound over device
time); so do the narrow instances' and the D = 256 Gemma rows (the
forward's, dQ's, dK/dV's and the packs': SDPA's forward or whole backward
over the same mask; 4 D, 6 D or 8 D FLOPs a visible pair). The shapes run
in four passes,
other / this / this / other, each in its own process with that
checkout's package on ``sys.path`` and its kernels built into its own
``build/kernels/``. Each pass times every chosen kernel on seeded inputs:
``ms`` (CUDA events over back-to-back calls) and ``device_ms`` (the
kernel's own time per launch, torch.profiler). It prints one line per
shape and kernel with the mean of each checkout's two passes and their
ratio, and writes every pass to ``--out``. Both checkouts must have the
wrappers' present signatures; the inputs (the packs' positions computed
once, by this checkout's ``ops.packed``) and the device times come from
this file in every pass. It also prints how many kernel instances'
ptxas lines (registers, stack frame, spills) of the other checkout's
fresh build read the same in this one's, and each that does not, and
how many of the instances both build are the same instructions
(``cuobjdump -sass``). Without
CUDA it exits nonzero.

    python3 -m sink_attention_tpu_torch.scripts.kernel_compare OTHER_TREE
        --host [--out build/kernel_compare_host.json]

times only the decode wrapper's ``ms`` per call at the bf16 decode rows
up to D = 128 (gpt-oss-20b's, where a call is bound by its host work), both
checkouts' packages in one process (the other's under another name), in
turns (this, other, other, this, ...; HOST_ROUNDS rounds of HOST_CALLS
back-to-back calls each): the mean, the least and the spread of each.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkdv_kernel",
           "packed_fwd_kernel", "packed_dq_kernel", "packed_dkdv_kernel",
           "decode_kernel")

# The head dims of the narrow instances (80 and 96) of the forward, dQ and
# dK/dV: H2O-Danube-1.8B's prefill (B=2, 32/8, N=8192, W=4096, no sinks)
# and training backward (B=1) at D = 72, 80, 88 and 96 in bf16 and fp32;
# Phi-3-mini's attention (32/32, D=96, N=4096) full and at W=2048 with 4
# sinks; D = 72 and 88 of that shape at N=2048
NARROW_DIMS = (72, 80, 88, 96)
NARROW_LABELS = ("danube", "phi3")
# (head dim, the width the caller pads it to) of the padded Danube rows
PADDED = ((72, 80), (88, 96))


def measured(label: str) -> bool:
    """Rows that get a bound and SDPA's time: the narrow instances' shapes,
    the 256 instance's Gemma shapes, unpacked and packed, and the dK/dV
    sink rows beside their no-sink twins (the "pair" rows)."""
    label = label.removeprefix("packed ")
    return label.startswith(NARROW_LABELS + ("pair",)) or (
        label.startswith("gemma") and "D=256" in label)
# the forward: (label, B, H_q, H_kv, N, D, num_sink, window, dtype)
FORWARD = [
    ("prefill W=128", 4, 64, 8, 1024, 64, 0, 128, "bf16"),
    ("prefill W=1024", 4, 64, 8, 1024, 64, 0, 1024, "bf16"),
    ("headline N=8192 D=128", 1, 32, 8, 8192, 128, 4, 4096, "bf16"),
    ("gemma W=4096 D=256", 2, 8, 4, 8192, 256, 0, 4096, "bf16"),
    ("gemma full D=256", 2, 8, 4, 8192, 256, 0, 8192, "bf16"),
    ("gemma W=1024 D=256", 2, 8, 4, 8192, 256, 0, 1024, "bf16"),
    ("gemma W=1024 4 sinks D=256", 2, 8, 4, 8192, 256, 4, 1024, "bf16"),
    ("gemma W=4096 D=512", 2, 8, 4, 8192, 512, 0, 4096, "bf16"),
    *[(f"danube W=4096 D={d} {dt}", 2, 32, 8, 8192, d, 0, 4096, dt)
      for d in NARROW_DIMS for dt in ("bf16", "fp32")],
    ("phi3 full D=96", 2, 32, 32, 4096, 96, 0, 4096, "bf16"),
    ("phi3 W=2048 4 sinks D=96", 2, 32, 32, 4096, 96, 4, 2048, "bf16"),
    *[(f"phi3 N=2048 W=2048 D={d}", 2, 32, 32, 2048, d, 4, 2048, "bf16")
      for d in (72, 88)],
]
# the backward: (label, B, H_q, H_kv, N, D, num_sink, window, halo, dtype)
UNPACKED = [
    ("W=128", 1, 64, 8, 4096, 64, 0, 128, 0, "bf16"),
    ("W=4096", 1, 64, 8, 4096, 64, 0, 4096, 0, "bf16"),
    ("headline N=8192 D=128", 1, 32, 8, 8192, 128, 4, 4096, 0, "bf16"),
    ("halo chunk", 1, 64, 8, 1024, 64, 4, 256, 256, "bf16"),
    ("group 1", 1, 8, 8, 2048, 64, 4, 2048, 0, "bf16"),
    ("group 16", 1, 64, 4, 2048, 64, 4, 2048, 0, "bf16"),
    ("N_q=250", 1, 64, 8, 250, 64, 4, 128, 0, "bf16"),
    ("gemma W=4096 D=256", 1, 8, 4, 8192, 256, 0, 4096, 0, "bf16"),
    ("gemma full D=256", 1, 8, 4, 8192, 256, 0, 8192, 0, "bf16"),
    ("gemma W=1024 D=256", 1, 8, 4, 8192, 256, 0, 1024, 0, "bf16"),
    ("gemma W=1024 4 sinks s_aux D=256", 1, 8, 4, 8192, 256, 4, 1024, 0,
     "bf16"),
    ("gemma W=4096 D=512", 1, 8, 4, 8192, 512, 0, 4096, 0, "bf16"),
    *[(f"danube W=4096 D={d} {dt}", 1, 32, 8, 8192, d, 0, 4096, 0, dt)
      for d in NARROW_DIMS for dt in ("bf16", "fp32")],
    ("phi3 full D=96", 1, 32, 32, 4096, 96, 0, 4096, 0, "bf16"),
    ("phi3 W=2048 4 sinks D=96", 1, 32, 32, 4096, 96, 4, 2048, 0, "bf16"),
    *[(f"phi3 N=2048 W=2048 D={d}", 1, 32, 32, 2048, d, 4, 2048, 0, "bf16")
      for d in (72, 88)],
    # the pair rows: sink tokens beside a short window (the sink key block
    # cut into pieces), each with its no-sink twin: the library's defaults
    # (4 sinks, W=512) at the headline geometry, gpt-oss-20b's sliding
    # layer with 4 sinks, and the 512 instance's D=384 row with 4 sinks
    *[(f"pair {name}{' 4 sinks' if ns else ''} D={d}", 1, h_q, h_kv, n, d,
       ns, w, 0, "bf16")
      for name, h_q, h_kv, n, d, w in (("defaults W=512", 32, 8, 8192, 128,
                                        512),
                                       ("gpt-oss W=128", 64, 8, 4096, 64,
                                        128),
                                       ("W=4096", 8, 4, 8192, 384, 4096))
      for ns in (4, 0)],
]
# the decode over a SinkKVCache: (label, B, H_q, H_kv, D, num_sink, window,
# prefill length, appends, storage: a dtype's name, or "int8" / "fp8"
# codes beside bf16 q)
DECODE = [
    ("decode W=128", 4, 64, 8, 64, 0, 128, 1024, 16, "bf16"),
    ("decode W=1056", 4, 64, 8, 64, 0, 1056, 1024, 16, "bf16"),
    ("decode headline D=128", 1, 32, 8, 128, 4, 4096, 8192, 1, "bf16"),
    ("decode headline D=128 fp8", 1, 32, 8, 128, 4, 4096, 8192, 1, "fp8"),
    *[(f"decode W={w} {st}", 4, 64, 8, 64, 0, w, 1024, n, st)
      for st in ("int8", "fp8") for w, n in ((128, 16), (1056, 31))],
    *[("decode danube D=80" + ("" if st == "bf16" else f" {st}"), 2, 32, 8,
       80, 0, 4096, 8192, 16, st) for st in ("bf16", "fp32", "int8")],
    ("decode phi3 D=96", 2, 32, 32, 96, 0, 4096, 8192, 16, "bf16"),
    *[(f"decode 8/4 D={d}", 2, 8, 4, d, 0, 4096, 8192, 16, "bf16")
      for d in (64, 128)],
    ("decode B=1 32768 slots D=64", 1, 64, 8, 64, 0, 32768, 32768, 16,
     "bf16"),
    ("decode B=1 32768 slots D=128", 1, 32, 8, 128, 0, 32768, 32768, 16,
     "bf16"),
    *[(f"decode gemma D={d}" + ("" if st == "bf16" else f" {st}"), 2, 8, 4,
       d, 0, 4096, 8192, 16, st)
      for d in (256, 512, 1024)
      for st in ("bf16", "fp16", "fp32", "int8", "fp8")],
    *[(f"decode N=2048 D={d}" + ("" if st == "bf16" else f" {st}"), 2, 8,
       4, d, 4, 1024, 2048, 16, st)
      for d in (640, 2048) for st in ("bf16", "int8", "fp8")],
    ("decode B=1 32768 slots D=256", 1, 8, 4, 256, 0, 32768, 32768, 16,
     "bf16"),
]
# (label, B, H_q, H_kv, D, num_sink, window, lengths, first position);
# lengths ("mix", n, lo, hi, seed): ops.packed.pack_lengths(n, lo, hi,
# seed), the segments of chip_smoke.py's phase-2 packs
PACKED = [
    ("packed phase-5 mix W=128", 1, 64, 8, 64, 0, 128,
     ("mix", 4096, 64, 1536, 0), 0),
    ("packed phase-5 mix W=4096", 1, 64, 8, 64, 0, 4096,
     ("mix", 4096, 64, 1536, 0), 0),
    ("packed lengths 64-3072", 1, 32, 8, 128, 4, 4096,
     ("mix", 8192, 64, 3072, 1), 0),
    ("packed a 2-token segment", 1, 8, 2, 64, 4, 128, [2, 510, 512], 0),
    ("packed 32-token segments", 1, 8, 2, 64, 4, 128, [32] * 32, 0),
    ("packed pack starts at position 2", 1, 8, 2, 64, 4, 128, [300, 724],
     2),
    ("packed N=1000", 1, 8, 2, 64, 4, 128, [333, 2, 665], 0),
    ("packed gemma 2 x 4096 D=256", 1, 8, 4, 256, 0, 4096, [4096, 4096], 0),
    ("packed gemma 2 x 4096 W=1024 D=256", 1, 8, 4, 256, 0, 1024,
     [4096, 4096], 0),
    ("packed gemma 2 x 4096 D=512", 1, 8, 4, 512, 0, 4096, [4096, 4096], 0),
    *[(f"packed danube 2 x 4096 D={d}", 1, 32, 8, d, 0, 4096, [4096, 4096],
       0) for d in (80, 96)],
    # Gemma 3's local layer over a pack of 6144 + 2048 with 4 sinks and
    # without (the packed kernel's pair)
    *[(f"packed gemma 6144 + 2048 W=1024{' 4 sinks' if ns else ''} D=256",
       1, 8, 4, 256, ns, 1024, [6144, 2048], 0) for ns in (4, 0)],
    ("packed phi3 2 x 2048 W=2048 4 sinks D=96", 1, 32, 32, 96, 4, 2048,
     [2048, 2048], 0),
]


def packed_cases():
    """PACKED with each pack's positions: [(label, B, H_q, H_kv, D,
    num_sink, window, positions [N] as a list)], from this checkout."""
    from sink_attention_tpu_torch.ops.packed import (pack_lengths,
                                                     pack_positions)
    cases = []
    for label, B, H_q, H_kv, D, ns, W, lens, first in PACKED:
        if lens[0] == "mix":
            lens = pack_lengths(*lens[1:])
        cases.append((label, B, H_q, H_kv, D, ns, W,
                      pack_positions(lens, first).tolist()))
    return cases


def device_ms(fn, calls: int = 10, tries: int = 5,
              per_call: bool = False) -> float:
    """The device ms per kernel launch of ``fn`` from torch.profiler over
    ``calls`` back-to-back calls (the mean over the device events it kept:
    it has been seen to drop some of those of ctypes launches; a window
    with none is profiled again, twice as long); with ``per_call``, the
    device ms of all of a call's launches (their sum over the calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for t in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls << t):
                fn()
            torch.cuda.synchronize()
        kept = [(ev.self_device_time_total, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0]
        if kept:
            n = (calls << t) if per_call else sum(n for _, n in kept)
            return sum(us for us, _ in kept) / 1e3 / n
    raise RuntimeError("torch.profiler recorded no device event")


def worker(kernels, packs) -> dict:
    """One pass over the shapes of ``kernels`` with the package found on
    sys.path; ``packs`` as :func:`packed_cases` gives them. Returns
    {"times": {shape and kernel: ms, device_ms}, "ptxas": {source: its
    ptxas lines, where this pass built it}}."""
    import torch

    from sink_attention_tpu_torch.cache import SinkKVCache
    from sink_attention_tpu_torch.ops import _build, decode, flash, packed
    from sink_attention_tpu_torch.ops.reference import (
        packed_sink_window_mask, sink_window_mask)
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                H100_PEAK_FP32,
                                                H100_PEAK_INT8,
                                                attention_pairs, time_cuda)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    types = {"bf16": torch.bfloat16, "fp32": torch.float32}
    mk = lambda *s, dt="bf16": torch.randn(
        *s, generator=gen, device=dev).to(types[dt])
    out = {}

    def timed(label, fns, per_call=False):
        for kernel, fn in fns.items():
            if kernel not in kernels:
                continue
            fn()
            torch.cuda.synchronize()
            out[f"{label} {kernel}"] = {
                "ms": time_cuda(fn, iters=20),
                "device_ms": device_ms(fn, per_call=per_call)}

    def yardstick(label, work, pairs, sdpa):
        """A measured row's bounds (``work``: kernel -> (FLOPs a
        visible pair at the bf16 rate, bytes at 3.35 TB/s); the larger
        time) and SDPA's time over the same mask (``library_ms``)."""
        rows = {k: out[f"{label} {k}"] for k in work
                if f"{label} {k}" in out}
        if not rows or not measured(label):
            return
        lib = time_cuda(sdpa, iters=5)
        for k, r in rows.items():
            per_pair, nbytes = work[k]
            r.update(bound_ms=max(per_pair * pairs / H100_PEAK_BF16,
                                  nbytes / H100_HBM_BW) * 1e3,
                     library_ms=lib)

    for label, B, H_q, H_kv, N, D, ns, W, dt in FORWARD:
        if "flash_fwd_kernel" not in kernels:
            break
        q, k, v = (mk(B, H_q, N, D, dt=dt), mk(B, H_kv, N, D, dt=dt),
                   mk(B, H_kv, N, D, dt=dt))
        aux = torch.randn(H_q, generator=gen, device=dev)
        timed(label, {"flash_fwd_kernel": lambda: flash.flash_fwd_kernel(
            q, k, v, aux, ns, W)})
        mask = sink_window_mask(N, N, ns, W, device=dev)
        yardstick(label, {"flash_fwd_kernel": (
                      4 * D, q.element_size() * 2 * (B * H_q + B * H_kv) * N
                      * D + 4 * B * H_q * N)},
                  B * H_q * attention_pairs(N, N, ns, W),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      q, k, v, attn_mask=mask, enable_gqa=True))
    for label, B, H_q, H_kv, N, D, ns, W, halo, dt in UNPACKED:
        if not {"flash_dq_kernel", "flash_dkdv_kernel"} & kernels:
            break
        q, do = mk(B, H_q, N, D, dt=dt), mk(B, H_q, N, D, dt=dt)
        k, v = (mk(B, H_kv, N + halo, D, dt=dt),
                mk(B, H_kv, N + halo, D, dt=dt))
        geom = (ns, W, 0, -halo)
        aux = (torch.randn(H_q, generator=gen, device=dev)
               if "s_aux" in label else None)
        o, lse = flash.flash_fwd_kernel(q, k, v, aux, *geom)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, *geom)
        timed(label, {"flash_dq_kernel": lambda: flash.flash_dq_kernel(*args),
                      "flash_dkdv_kernel": lambda: flash.flash_dkdv_kernel(
                          *args)})
        row = out.get(f"{label} flash_dkdv_kernel")
        if row is not None and hasattr(flash, "dkdv_piece_table"):
            # the key blocks' pieces (a checkout that cuts them)
            bn = flash.DKDV_BNS[_build.kernel_head_dim(D)]
            row["pieces"] = int(flash.dkdv_piece_table(
                N, N + halo, *geom, flash.DKDV_BM, bn)[0, 0])
        if measured(label) and halo == 0:
            # the bounds (dQ 6 D FLOPs a visible pair, dK/dV 8 D; or the
            # bytes each reads and writes once) beside SDPA's whole
            # backward over the same mask
            q_bytes = q.element_size() * B * H_q * N * D
            kv_bytes = q.element_size() * B * H_kv * N * D
            rows_bytes = 8 * B * H_q * N  # lse and delta
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            mask = sink_window_mask(N, N, ns, W, device=dev)
            sd = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask, enable_gqa=True)
            yardstick(label, {
                "flash_dq_kernel": (6 * D, 3 * q_bytes + 2 * kv_bytes
                                    + rows_bytes),
                "flash_dkdv_kernel": (8 * D, 2 * q_bytes + 4 * kv_bytes
                                      + rows_bytes)},
                B * H_q * attention_pairs(N, N, ns, W),
                lambda: torch.autograd.grad(sd, leaves, do,
                                            retain_graph=True))
            del sd, leaves
    for d, dp in PADDED:
        # Danube's rows above at D = d, the operands zero-padded to dp by
        # the caller and the outputs sliced back: every copy in the time
        # (device_ms: all of a call's launches)
        if not {"flash_fwd_kernel", "flash_dq_kernel",
                "flash_dkdv_kernel"} & kernels:
            break
        pad = lambda t: torch.nn.functional.pad(t, (0, dp - d))
        cut = lambda t: t[..., :d].contiguous()
        label = f"padded danube W=4096 D={d} to {dp} bf16"
        q, k, v = mk(2, 32, 8192, d), mk(2, 8, 8192, d), mk(2, 8, 8192, d)
        aux = torch.randn(32, generator=gen, device=dev)
        timed(label, {"flash_fwd_kernel": lambda: [
            cut(t) if t.dim() == 4 else t for t in flash.flash_fwd_kernel(
                pad(q), pad(k), pad(v), aux, 0, 4096)]}, per_call=True)
        q, do = mk(1, 32, 8192, d), mk(1, 32, 8192, d)
        k, v = mk(1, 8, 8192, d), mk(1, 8, 8192, d)
        geom = (0, 4096, 0, 0)
        o, lse = flash.flash_fwd_kernel(q, k, v, None, *geom)
        delta = (do.float() * o.float()).sum(-1)
        timed(label, {
            "flash_dq_kernel": lambda: cut(flash.flash_dq_kernel(
                pad(q), pad(k), pad(v), pad(do), lse, delta, *geom)),
            "flash_dkdv_kernel": lambda: [cut(t) for t in
                                          flash.flash_dkdv_kernel(
                pad(q), pad(k), pad(v), pad(do), lse, delta, *geom)]},
            per_call=True)
    for label, B, H_q, H_kv, D, ns, W, pos in packs:
        if not {"packed_fwd_kernel", "packed_dq_kernel",
                "packed_dkdv_kernel"} & kernels:
            break
        positions = torch.tensor(pos, device=dev)[None].expand(B, -1)
        N = positions.shape[1]
        q, do = mk(B, H_q, N, D), mk(B, H_q, N, D)
        k, v = mk(B, H_kv, N, D), mk(B, H_kv, N, D)
        aux = torch.randn(H_q, generator=gen, device=dev)
        o, lse = packed.packed_fwd_kernel(q, k, v, positions, None, ns, W)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, positions, ns, W)
        timed(label, {
            "packed_fwd_kernel": lambda: packed.packed_fwd_kernel(
                q, k, v, positions, aux, ns, W),
            "packed_dq_kernel": lambda: packed.packed_dq_kernel(*args),
            "packed_dkdv_kernel": lambda: packed.packed_dkdv_kernel(*args)})
        row = out.get(f"{label} packed_dkdv_kernel")
        tables = packed.packed_tables(positions, ns, W, D)
        if row is not None and hasattr(tables, "kv_pieces"):
            row["pieces"] = int(tables.kv_pieces[0, 0])
        if measured(label):
            # the bounds over the pack's own mask (4 D, 6 D, 8 D FLOPs a
            # visible pair; or the bytes) beside SDPA's forward and whole
            # backward over that mask
            mask = packed_sink_window_mask(positions, ns, W)[:, None]
            pairs = H_q * int(mask.sum())
            q_bytes = q.element_size() * B * H_q * N * D
            kv_bytes = q.element_size() * B * H_kv * N * D
            rows_bytes, pos_bytes = 4 * B * H_q * N, 4 * B * N
            yardstick(label, {"packed_fwd_kernel": (
                4 * D, 2 * q_bytes + 2 * kv_bytes + rows_bytes + pos_bytes)},
                pairs, lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True))
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            sd = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask, enable_gqa=True)
            yardstick(label, {
                "packed_dq_kernel": (6 * D, 3 * q_bytes + 2 * kv_bytes
                                     + 2 * rows_bytes + pos_bytes),
                "packed_dkdv_kernel": (8 * D, 2 * q_bytes + 4 * kv_bytes
                                       + 2 * rows_bytes + pos_bytes)},
                pairs, lambda: torch.autograd.grad(sd, leaves, do,
                                                   retain_graph=True))
            del sd, leaves, mask
    for label, B, H_q, H_kv, D, ns, W, n, appends, st in DECODE:
        if "decode_kernel" not in kernels:
            break
        quant = st if st in ("int8", "fp8") else None
        dtype = torch.bfloat16 if quant else getattr(torch, {
            "bf16": "bfloat16", "fp16": "float16", "fp32": "float32"}[st])
        mkd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
        cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                                 dtype=dtype, quant=quant, device=dev)
        cache.prefill(mkd(B, H_kv, n, D), mkd(B, H_kv, n, D))
        for _ in range(appends):
            cache.append(mkd(B, H_kv, 1, D), mkd(B, H_kv, 1, D))
        q = mkd(B, H_q, 1, D)
        aux = torch.randn(H_q, generator=gen, device=dev)
        state, kw = decode.cache_state(cache), decode.cache_args(cache)
        timed(label, {"decode_kernel": lambda: decode.decode_kernel(
            q, cache.k, cache.v, state, aux, **kw)})
        # the yardstick and the bound, as chip_smoke.check_decode has them
        lens = decode._uniform_lens(*state, cache.window_size,
                                    cache.sink_cap, B, dev)
        live = decode.live_slots(lens, cache.s_total, cache.sink_cap,
                                 cache.window_size)
        n_live = int(live.sum())
        kf, vf = (t.to(dtype) for t in cache.dequant_kv())
        mask = live[:, None, None, :]
        row = out[f"{label} decode_kernel"]
        row["library_ms"] = time_cuda(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kf, vf, attn_mask=mask, enable_gqa=True), iters=20)
        del kf, vf
        elem = q.element_size()
        nbytes = (H_kv * n_live * (2 * D + 8 if quant else 2 * elem * D)
                  + 2 * elem * B * H_q * D + 16 * B)
        peak = (H100_PEAK_INT8 if quant else H100_PEAK_FP32
                if dtype == torch.float32 else H100_PEAK_BF16)
        row["bound_ms"] = max(4 * H_q * n_live * D / peak,
                              nbytes / H100_HBM_BW) * 1e3
        del cache
    return {"times": out, "ptxas": {
        name: rep["ptxas"] for name, rep in _build.build_report.items()
        if not rep["cached"]}, "libs": {
        name: str(path) for name, path in _build.build_all().items()}}


HOST_ROUNDS = 24   # timed rounds of each checkout, in turns
HOST_CALLS = 200   # back-to-back calls a round


def host_interleaved(other: Path) -> dict:
    """{label: {"this": [ms per call a round], "other": [...]}} of each
    checkout's ``decode_kernel`` at the bf16 DECODE rows up to D = 128, the
    other checkout's package imported beside this one under another name,
    the two timed in turns on the same inputs."""
    import importlib
    import importlib.util

    import torch

    from sink_attention_tpu_torch.cache import SinkKVCache
    from sink_attention_tpu_torch.utils import time_cuda

    pkg = other / "sink_attention_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_sink_attention_tpu_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    mods = {"this": importlib.import_module(
        "sink_attention_tpu_torch.ops.decode"),
            "other": importlib.import_module(f"{spec.name}.ops.decode")}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for label, B, H_q, H_kv, D, ns, W, n, appends, st in DECODE:
        if D > 128 or st != "bf16":
            continue
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
            torch.bfloat16)
        cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                                 device=dev)
        cache.prefill(mk(B, H_kv, n, D), mk(B, H_kv, n, D))
        for _ in range(appends):
            cache.append(mk(B, H_kv, 1, D), mk(B, H_kv, 1, D))
        q = mk(B, H_q, 1, D)
        aux = torch.randn(H_q, generator=gen, device=dev)
        state = mods["this"].cache_state(cache)
        kw = mods["this"].cache_args(cache)
        fns = {name: (lambda m=m: m.decode_kernel(q, cache.k, cache.v, state,
                                                  aux, **kw))
               for name, m in mods.items()}
        times = {name: [] for name in fns}
        for r in range(HOST_ROUNDS):
            for name in (("this", "other") if r % 2 == 0 else
                         ("other", "this")):
                times[name].append(time_cuda(fns[name], iters=HOST_CALLS))
        out[label] = times
    return out


def host_main(other: Path, out_path: str) -> int:
    from sink_attention_tpu_torch.utils import card_line

    times = host_interleaved(other)
    card = card_line()
    print(f"card: {card}")
    print(f"{'shape (decode_kernel ms per call)':36s} {'other':>8s} "
          f"{'this':>8s} {'ratio':>7s} {'other min':>9s} {'this min':>9s} "
          f"{'spread':>7s}")
    for label, t in times.items():
        mean = {n: sum(v) / len(v) for n, v in t.items()}
        least = {n: min(v) for n, v in t.items()}
        # the larger of the two checkouts' (max - min) / min over rounds
        spread = max((max(v) - min(v)) / min(v) for v in t.values())
        print(f"{label:36s} {mean['other']:8.4f} {mean['this']:8.4f} "
              f"{mean['this'] / mean['other']:7.3f} {least['other']:9.4f} "
              f"{least['this']:9.4f} {spread:7.3f}")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(
        {"card": card, "other": str(other), "rounds": times}, indent=1))
    return 0


def ptxas_entries(lines) -> dict:
    """{kernel entry: its ptxas lines (stack frame and spills, registers)}
    of one source's build; an anonymous namespace's per-build hashes in
    an entry's mangled name are dropped, so two builds' names meet."""
    out, entry = {}, None
    for line in lines:
        if "Compiling entry" in line:
            entry = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}",
                           r"_GLOBAL__N__\1", line.split("'")[1])
            out[entry] = []
        elif entry is not None:
            out[entry].append(line.split("ptxas info    :")[-1].strip())
    return out


def sass_functions(lib: str) -> dict:
    """{kernel entry: its SASS} of a built library (``cuobjdump -sass``),
    the entry names normalised as :func:`ptxas_entries` does and the
    function's own name dropped from its text; {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}",
                      r"_GLOBAL__N__\1", name.strip())
        out[name] = body.replace(name, "")
    return out


def run_pass(tree: Path, kernels, packs: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--worker", "--kernels", ",".join(kernels),
                           "--packs", str(packs)],
                          cwd=tree, env=env,
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"the pass in {tree} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated wrappers to time (default: all)")
    ap.add_argument("--out", default=None,
                    help="the JSON written (default build/"
                         "kernel_compare.json, or _host.json with --host)")
    ap.add_argument("--host", action="store_true",
                    help="only the decode's host time up to D = 128, both "
                         "checkouts in one process")
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--packs", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kernels = [k for k in args.kernels.split(",") if k]
    unknown = set(kernels) - set(KERNELS)
    if unknown or not kernels:
        ap.error(f"--kernels takes names of {', '.join(KERNELS)}, got "
                 f"{args.kernels!r}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_compare: CUDA is not available", file=sys.stderr)
        return 1
    if args.worker:
        packs = json.loads(Path(args.packs).read_text())
        print(json.dumps(worker(set(kernels), packs)), flush=True)
        return 0
    if args.other is None:
        ap.error("give the other checkout's root")
    other = Path(args.other).resolve()
    if args.host:
        return host_main(other, args.out or "build/kernel_compare_host.json")
    args.out = args.out or "build/kernel_compare.json"
    from sink_attention_tpu_torch.utils import card_line
    passes = [("other", other), ("this", ROOT), ("this", ROOT),
              ("other", other)]
    with tempfile.TemporaryDirectory() as tmp:
        packs = Path(tmp) / "packs.json"
        packs.write_text(json.dumps(packed_cases()))
        runs = [(name, run_pass(tree, kernels, packs))
                for name, tree in passes]
    card = card_line()
    print(f"card: {card}")
    builds = [dict(runs[i][1]["ptxas"]) for i in (0, 1)]  # fresh builds
    same, differ = 0, []
    for src, lines in builds[0].items():
        mine = ptxas_entries(builds[1].get(src, []))
        for entry, got in ptxas_entries(lines).items():
            if mine.get(entry) == got:
                same += 1
            else:
                differ.append((src, entry, got, mine.get(entry)))
    print(f"ptxas: {same} of {same + len(differ)} instances of the other "
          f"checkout read the same here")
    # the instances both checkouts build, compared instruction by
    # instruction
    sass = [{src: sass_functions(lib) for src, lib in runs[i][1]["libs"]
             .items()} for i in (0, 1)]
    n_both, sass_differ = 0, []
    for src, funcs in sass[0].items():
        for name, body in funcs.items():
            if name in sass[1].get(src, {}):
                n_both += 1
                if sass[1][src][name] != body:
                    sass_differ.append(f"{src} {name}")
    n_same = n_both - len(sass_differ)
    print(f"sass: {n_same} of {n_both} instances both checkouts build are "
          f"the same instructions")
    for name in sass_differ:
        print(f"sass differs: {name}")
    for src, entry, got, mine in differ:
        print(f"ptxas differs: {src} {entry}: {got} -> {mine}")
    runs = [(name, r["times"]) for name, r in runs]
    print(f"{'shape, kernel':52s} {'other ms':>10s} {'this ms':>10s} "
          f"{'ratio':>7s} {'other dev':>10s} {'this dev':>10s} "
          f"{'dev ratio':>9s} {'spread':>7s} {'library':>8s} {'bound':>8s} "
          f"{'share':>6s} {'share':>6s}")
    table = {}
    for label in runs[0][1]:
        mean = {name: {key: sum(r[label][key] for n, r in runs if n == name)
                       / 2 for key in ("ms", "device_ms")}
                for name in ("other", "this")}
        # the larger of the two checkouts' relative gaps between their own
        # two passes' device times
        spread = max(abs(a - b) / min(a, b) for a, b in (
            [r[label]["device_ms"] for n, r in runs if n == name]
            for name in ("other", "this")))
        mean["spread"] = spread
        extra = ""
        if "library_ms" in runs[1][1][label]:
            for key in ("library_ms", "bound_ms"):
                mean[key] = sum(r[label][key] for _, r in runs) / len(runs)
            # the share of the bound each checkout's device time reaches
            mean["share"] = {name: mean["bound_ms"] / mean[name]["device_ms"]
                             for name in ("other", "this")}
            extra = (f" {mean['library_ms']:8.4f} {mean['bound_ms']:8.4f}"
                     f" {mean['share']['other']:6.3f} "
                     f"{mean['share']['this']:6.3f}")
        if "pieces" in runs[1][1][label]:  # this checkout's dK/dV pieces
            mean["pieces"] = runs[1][1][label]["pieces"]
            extra += f" pieces {mean['pieces']}"
        table[label] = mean
        print(f"{label:52s} {mean['other']['ms']:10.4f} "
              f"{mean['this']['ms']:10.4f} "
              f"{mean['this']['ms'] / mean['other']['ms']:7.3f} "
              f"{mean['other']['device_ms']:10.4f} "
              f"{mean['this']['device_ms']:10.4f} "
              f"{mean['this']['device_ms'] / mean['other']['device_ms']:9.3f}"
              f" {spread:7.3f}" + extra)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": card, "other": str(other), "passes": runs,
         "mean": table, "ptxas": builds, "ptxas_same": same,
         "sass_same": [n_same, n_both], "sass_differ": sass_differ,
         "ptxas_differ": [list(d) for d in differ]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
