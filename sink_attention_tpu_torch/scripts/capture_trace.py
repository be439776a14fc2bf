"""Profiler traces of the port's hot paths at the headline shape.

    python3 -m sink_attention_tpu_torch.scripts.capture_trace [OUTDIR]
        [--device cpu]

Counterpart of the JAX package's ``scripts/capture_trace.py``: a
``torch.profiler`` trace (CPU and CUDA activities) of three sections, each
under ``torch.profiler.record_function`` with the JAX names, at B=1, GQA
32/8, D=128, 4 sinks, W=4096, N=8192, bf16 (:func:`capture` takes the
shapes as arguments):

- ``prefill_fwd``: ``sink_flash_attention`` without ``s_aux``;
- ``train_fwdbwd``: the gradient of ``sum(o.float() ** 2)``, with a
  random ``s_aux``, with respect to q, k and v (forward, dQ, dK/dV);
- ``decode_scan_64``: a bf16 ``SinkKVCache`` prefilled with W + 4 tokens,
  then 64 steps, each appending the query's first H_kv heads as both k
  and v, calling ``sink_decode_attention_cached`` and feeding its output
  back as the next query.

Every section runs once outside the trace first (the kernels' build,
their tables and the workspace are then in place), then ``LEAD_IN``
times in the trace outside the sections, then once in its section. The
Chrome trace
(``trace.json``, for Perfetto or chrome://tracing) goes into OUTDIR
(default ``sink_trace`` in the temporary directory,
``tempfile.gettempdir()``, which follows ``TMPDIR``). For each section the summary gives the
host's wall ms (with the profiler on), the device's busy ms (the device
events launched inside the section), the idle share (1 - busy / wall),
the top device kernels by time with their event counts, the kernel
wrappers' launch counters and the trace's device events of each kernel
(matched by the CUDA function's name in ``ops/csrc``): a reading of the
trace without TensorBoard, not a new measurement. Runs on the card by
default; on the CPU (``--device cpu``) the kernels' plain versions run
and no device time is recorded.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..cache import SinkKVCache
from ..ops import decode, flash
from ..utils import card_line, resolve_device

__all__ = ["capture", "KERNEL_NAMES", "main"]

CPU = torch.autograd.DeviceType.CPU
# runs of the three sections in the session before the annotated ones
LEAD_IN = 2
# each launch counter's kernel: the CUDA function's name in the trace
KERNEL_NAMES = {"flash_fwd": "fwd_wgmma_kernel",
                "flash_dq": "dq_wgmma_kernel",
                "flash_dkdv": "dkdv_wgmma_kernel",
                "decode": "decode_kernel"}


def _launches() -> dict:
    """The launch counters of the section's kernels (the decode's
    unquantized branch: the traced cache is bf16)."""
    return {"flash_fwd": flash.flash_fwd_kernel.launches,
            "flash_dq": flash.flash_dq_kernel.launches,
            "flash_dkdv": flash.flash_dkdv_kernel.launches,
            "decode": decode.decode_kernel.launches}


def _section(events, name: str, names, wall_ms: float,
             launches: dict) -> dict:
    """The summary of section ``name`` from the profiler's events: the
    device events whose launch (the CUDA runtime call on the host, whose
    event carries the device event's correlation id) lies inside the
    section's host range. The device events' own timestamps are not
    compared with the host's: on the card they were seen several ms off
    after ~800 s of a process, putting kernels in the wrong section."""
    span = next(e.time_range for e in events
                if e.name == name and e.device_type == CPU)
    launched = {e.id for e in events if e.device_type == CPU
                and e.name.startswith("cu")
                and span.start <= e.time_range.start <= span.end}
    device = [e for e in events if e.device_type != CPU
              and e.name not in names and e.id in launched]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms,
            "device_ms": busy if device else None,
            "idle_share": max(0.0, 1.0 - busy / wall_ms) if device else None,
            "device_events": len(device),
            "top": [{"name": n[:100], "ms": ms, "count": c}
                    for n, (ms, c) in top],
            "launches": launches,
            "trace_launches": {k: sum(c for n, (_, c) in by_name.items()
                                      if fn in n)
                               for k, fn in KERNEL_NAMES.items()}}


def default_outdir() -> str:
    """``sink_trace`` in the temporary directory (``TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), "sink_trace")


def capture(outdir: Optional[str] = None, device="cuda", *,
            batch: int = 1, heads: int = 32, kv_heads: int = 8,
            head_dim: int = 128, sinks: int = 4, window: int = 4096,
            n: int = 8192, steps: int = 64, seed: int = 0) -> dict:
    """Trace the three sections into ``outdir`` (default:
    :func:`default_outdir`); returns ``{"files":
    [...], "sections": {name: summary}}`` (see the module's docstring).
    Inputs are normal draws from a torch.Generator seeded ``seed`` on the
    device."""
    dev = resolve_device(device)
    outdir = outdir or default_outdir()
    cuda = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    bf16 = torch.bfloat16
    q, k, v = (randn(batch, h, n, head_dim).to(bf16)
               for h in (heads, kv_heads, kv_heads))
    aux = randn(heads)
    q0 = randn(batch, heads, 1, head_dim).to(bf16)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    cache0 = SinkKVCache.init(batch, kv_heads, head_dim, num_sink=sinks,
                              window_size=window, dtype=bf16, device=dev)
    cache0.prefill(k[:, :, :window + sinks], v[:, :, :window + sinks])

    def prefill():
        return flash.sink_flash_attention(q, k, v, sinks, window)

    def train():
        o = flash.sink_flash_attention(*leaves, sinks, window, s_aux=aux)
        return torch.autograd.grad((o.float() ** 2).sum(), leaves)

    def decode_scan(cache):
        qq = q0
        for _ in range(steps):
            cache.append(qq[:, :kv_heads], qq[:, :kv_heads])
            qq = decode.sink_decode_attention_cached(qq, cache, s_aux=aux)
        return qq

    # name: a maker of the section's call, its inputs made before it runs
    sections = {"prefill_fwd": lambda: prefill,
                "train_fwdbwd": lambda: train,
                f"decode_scan_{steps}":
                    lambda: functools.partial(decode_scan, cache0.clone())}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for make in sections.values():  # outside the trace: steady state in it
        make()()
    sync()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    walls, launches = {}, {}
    with profile(activities=activities) as prof:
        # a lead-in, not annotated: in the full chip_smoke run (~800 s into
        # the process) the session's first ~40-46 device events (~10 ms)
        # were missing from the trace, whatever the wall time before them
        # (a 0.2 s sleep did not help; two runs of the sections did)
        for _ in range(LEAD_IN):
            for make in sections.values():
                make()()
        sync()
        for name, make in sections.items():
            fn = make()
            before = _launches()
            t0 = time.perf_counter()
            with record_function(name):
                fn()
                sync()
            walls[name] = (time.perf_counter() - t0) * 1e3
            launches[name] = {key: count - before[key]
                              for key, count in _launches().items()}
    os.makedirs(outdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
    events = prof.events()
    return {"files": [os.path.join(root, f)
                      for root, _, files in os.walk(outdir) for f in files],
            "sections": {name: _section(events, name, sections,
                                        walls[name], launches[name])
                         for name in sections}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?", default=default_outdir())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("device: " + (card_line() if dev.type == "cuda" else "cpu"))
    out = capture(args.outdir, dev)
    print(f"trace written to {args.outdir}")
    for f in out["files"]:
        print(" ", f)
    for name, sec in out["sections"].items():
        dev_ms = ("not measured" if sec["device_ms"] is None
                  else f"{sec['device_ms']:.3f} ms, idle share "
                       f"{sec['idle_share']:.3f}")
        print(f"{name}: wall {sec['wall_ms']:.3f} ms, device {dev_ms}, "
              f"launches {sec['launches']}, in the trace "
              f"{sec['trace_launches']}")
        for t in sec["top"]:
            print(f"  {t['ms']:9.3f} ms {t['count']:5d}x  {t['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
