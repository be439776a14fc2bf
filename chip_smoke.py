#!/usr/bin/env python3
"""Drive the PyTorch port (sink_attention_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py    # build, kernel checks, serving, training,
                             # packed training, continuous batching,
                             # the forward kernel's ablation

Phases:
  1. build: compile every CUDA kernel of the port (nvcc, sm_90a) and print
     the build time and ptxas' register / shared-memory / spill lines;
  2. kernels: run each kernel and its plain PyTorch version on the card at
     the main paths' shapes and at the headline attention shape (the packed
     kernels also at edge cases of the mask; the int8 and fp8 decode also
     over a ragged pool, and against the bf16 kernel on the unquantized
     KV), print the
     max abs error against its tolerance and the times (kernel, plain,
     one PyTorch library call as a yardstick) beside the least time the
     card could take (its bound); the forward and decode rows also their
     kernel's own device time per launch from torch.profiler
     (``device_ms``, beside ``ms``, the back-to-back wall time per call)
     and the device kernels one call issues (``kernels_per_call``: at most
     1 for every decode row); the
     decode also at MQA 32/1 and 64/1 and over a full layer's cache early
     in its life; the backward kernels also run twice on
     the same inputs and must agree bit for bit; then a warmed call each
     of the cached decode, the ragged decode and the forward under
     torch.cuda.set_sync_debug_mode("error") (none may synchronise);
  3. serving: gpt-oss-20b at full width, 24 layers, bf16, random weights
     from a seeded generator: 4 requests of 1024 prompt tokens, 32 new
     tokens each, through greedy_generate, with the kernels' launch counts
     and the prefill and decode times; then every layer's attention
     against the plain version on the live activations, the logits against
     plain-attention prefill and the decode against teacher forcing (see
     ``serve``);
  4. training: gpt-oss-20b at full width with 4 of its 24 layers, bf16,
     random weights: 3 SGD steps of make_train_step(remat=True) on 1 x 4096
     tokens, with the launch counts, per-step loss, time and tokens/s, the
     forward/backward split, peak memory and a profile of one step; then
     every layer's attention gradients, kernels against plain on the live
     activations, and the end-to-end gradients against plain attention
     and a noise control (see ``train``);
  5. packed training: the same model, 3 SGD steps of
     cross_entropy_loss_packed on one pack of 4096 tokens (segments of
     64-1536 tokens), with the same numbers; then every layer's packed
     attention gradients against plain, the per-token losses against plain
     packed attention and a noise control, and each segment's logits
     against its own unpacked forward (see ``train_packed``);
  6. continuous batching: gpt-oss-20b at full width, 24 layers, the same
     weights: 8 seeded requests (prompts of 64-1024 tokens, 16-32 new)
     through ContinuousBatchingEngine with 4 slots and max_len 2048, once
     each over an int8, an fp8 and a bf16 KV cache, with launch counts,
     run time, tokens/s, time to first token, ms per pool step, device idle
     share and memory; then every layer's decode attention on a replay,
     kernel against plain, and the replay's logits against teacher forcing
     and a control (see ``serve_engine``);
  7. ablation: the forward kernel's per-stage ablation (the ablation and
     mask-stage kernels, every stage of scripts/mfu_ablation.py) at the JAX
     script's headline shape and at gpt-oss-20b's two prefill shapes: each
     stage against its plain version (the correct ones also against the
     forward kernel), then the entry point's table of ms, effective MFU
     and deltas, with the plain versions' times, SDPA for the correct
     stages and each stage's bound, and one line of the wgmma/TMA forward
     (``full``) against the old mma.sync skeleton on the same function
     (``maskadd``, ``masksel``) at the three shapes (see
     ``ablation_phase``).
The line before the last is a JSON object of the kernels' numbers; the last
is {"ok": true, "device": {...}}, printed only when every check passed.
Without CUDA, or without the port next to it, the script exits nonzero and
prints no result.
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

FLASH_TOL = 2e-2   # bf16 output: ~2^-8 relative rounding on O(1) values
LSE_TOL = 1e-3     # fp32 LSE from the same bf16 inputs
DECODE_TOL = 2e-2  # bf16 output
# bf16 gradients, of max |plain|: one bf16 rounding is 2^-9 of a value,
# and the kernels round P and dS to bf16 as MMA operands
BWD_TOL = 2e-2
MIN_COS = 0.9999   # kernel against plain, per layer and per kernel check
PACK_MIN, PACK_MAX = 64, 1536  # segment lengths of the packed training pack
RAGGED_LENS = [1000, 77, 0, 610]  # the ragged decode rows' slots (0: empty)


def log(msg: str) -> None:
    print(msg, flush=True)


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, mask):
    """One PyTorch attention call (the yardstick): SDPA with the same
    boolean mask, without s_aux; GQA through enable_gqa."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def check_flash(dev, B, H_q, H_kv, N, D, ns, W, gen, time_n=None):
    """Kernel vs plain at one shape; returns a dict of numbers."""
    from sink_attention_tpu_torch.ops import flash
    from sink_attention_tpu_torch.ops.reference import sink_window_mask
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                sink_attention_flops,
                                                time_cuda)

    def inputs(n):
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
            torch.bfloat16)
        return (mk(B, H_q, n, D), mk(B, H_kv, n, D), mk(B, H_kv, n, D),
                torch.randn(H_q, generator=gen, device=dev))

    q, k, v, aux = inputs(N)
    o_k, l_k = flash.flash_fwd_kernel(q, k, v, aux, ns, W)
    o_p, l_p = flash.flash_fwd_plain(q, k, v, aux, ns, W)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    lerr = float((l_k - l_p).abs().max())
    res = {"shape": f"B={B} H={H_q}/{H_kv} N={N} D={D} sink={ns} W={W}",
           "max_abs_err": err, "lse_err": lerr,
           "ok": err <= FLASH_TOL and lerr <= LSE_TOL
           and bool(torch.isfinite(o_k.float()).all())}
    if time_n is not None and time_n != N:
        q, k, v, aux = inputs(time_n)
        res["timed_N"] = time_n
    n = q.shape[2]
    mask = sink_window_mask(n, n, ns, W, device=dev)
    res["ms"] = time_cuda(lambda: flash.flash_fwd_kernel(q, k, v, aux, ns, W),
                          iters=20)
    res["device_ms"], res["kernels_per_call"] = per_call_device(
        lambda: flash.flash_fwd_kernel(q, k, v, aux, ns, W))
    res["plain_ms"] = time_cuda(
        lambda: flash.flash_fwd_plain(q, k, v, aux, ns, W), iters=3,
        warmup=1)
    res["library_ms"] = time_cuda(lambda: _sdpa(q, k, v, mask), iters=10)
    flops = sink_attention_flops(B, H_q, n, D, ns, W)
    nbytes = 2 * (2 * B * H_q * n * D + 2 * B * H_kv * n * D) + 4 * B * H_q * n
    t_ops, t_bytes = flops / H100_PEAK_BF16 * 1e3, nbytes / H100_HBM_BW * 1e3
    res["bound_ms"] = max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return res


QUANT_BUDGET = {"int8": 0.05, "fp8": 0.12}  # vs unquantized KV (JAX tests)


def _decode_caches(dev, B, H_kv, D, ns, W, lengths, appends, gen, quant):
    """A cache of each storage (bf16, and ``quant`` if given) filled with
    the same seeded KV: a SinkKVCache prefilled with ``lengths`` tokens
    (an int), or, for a list of per-slot lengths, a RaggedSinkKVCache with
    each slot inserted (0 = left empty). Then ``appends`` tokens; in the
    ragged cache slot b skips append i when i % (b + 2) == 0, so the slots
    end at different ring phases, and empty slots stay inactive. Returns
    ({storage: cache}, lens [B, 4])."""
    from sink_attention_tpu_torch.cache import RaggedSinkKVCache, SinkKVCache
    from sink_attention_tpu_torch.ops import decode

    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    ragged = isinstance(lengths, (list, tuple))
    kinds = [None] + ([quant] if quant else [])
    cls = RaggedSinkKVCache if ragged else SinkKVCache
    caches = {kd: cls.init(B, H_kv, D, num_sink=ns, window_size=W,
                           dtype=torch.bfloat16, quant=kd, device=dev)
              for kd in kinds}
    if ragged:
        n_max = max(lengths)
        k, v = mk(B, H_kv, n_max, D), mk(B, H_kv, n_max, D)
        for c in caches.values():
            for b, n in enumerate(lengths):
                if n:
                    c.insert(b, k[b], v[b], n)
    else:
        k, v = mk(B, H_kv, lengths, D), mk(B, H_kv, lengths, D)
        for c in caches.values():
            c.prefill(k, v)
    for i in range(appends):
        k, v = mk(B, H_kv, 1, D), mk(B, H_kv, 1, D)
        active = torch.tensor([bool(lengths[b]) and i % (b + 2) != 0
                               for b in range(B)], device=dev) if ragged \
            else None
        for c in caches.values():
            if ragged:
                c.append(k, v, active)
            else:
                c.append(k, v)
    c = caches[None]
    lens = decode.ragged_lens(c) if ragged else decode._uniform_lens(
        c.sink_len, c.window_len, c.write_pos, c.window_size, c.sink_cap, B,
        dev)
    return caches, lens


def check_decode(dev, B, H_q, H_kv, D, ns, W, lengths, appends, gen,
                 quant=None):
    """The decode kernel of one storage (bf16, or ``quant``) against its
    plain version over a filled cache (see _decode_caches: ``lengths`` a
    list makes it ragged); a quantized kernel also against the bf16 kernel
    over the unquantized KV, within the JAX tests' budget. Returns
    numbers; the library yardstick is SDPA over the (dequantized) bf16
    cache with the live mask."""
    from sink_attention_tpu_torch.ops import decode
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                H100_PEAK_INT8, time_cuda)

    caches, lens = _decode_caches(dev, B, H_kv, D, ns, W, lengths, appends,
                                  gen, quant)
    cache = caches[quant]
    q = torch.randn(B, H_q, 1, D, generator=gen, device=dev).to(
        torch.bfloat16)
    aux = torch.randn(H_q, generator=gen, device=dev)
    kw = decode.cache_args(cache)
    state = decode.cache_state(cache)  # ints, or the ragged [B] tensors
    o_k = decode.decode_kernel(q, cache.k, cache.v, state, aux, **kw)
    o_p = decode.decode_plain(q, cache.k, cache.v, lens, aux, **kw)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    live = decode.live_slots(lens, cache.s_total, cache.sink_cap,
                             cache.window_size)
    n_live = int(live.sum())  # over the batch
    shape = (f"B={B} H={H_q}/{H_kv} D={D} W={W} S_total={cache.s_total} "
             + (f"ragged lengths={list(lengths)} live={live.sum(1).tolist()}"
                if isinstance(lengths, (list, tuple)) else
                f"live={n_live // B}"))
    res = {"shape": shape, "max_abs_err": err,
           "ok": err <= DECODE_TOL and bool(torch.isfinite(o_k.float()).all())}
    if quant:
        ref = caches[None]
        o_b = decode.decode_kernel(q, ref.k, ref.v, decode.cache_state(ref),
                                   aux, **decode.cache_args(ref))
        res["vs_bf16_err"] = float((o_k.float() - o_b.float()).abs().max())
        res["ok"] = res["ok"] and res["vs_bf16_err"] <= QUANT_BUDGET[quant]
    # the call and its yardstick are host-bound at these sizes, and one
    # window of back-to-back calls swings with the host's other load:
    # both take the best of three windows
    best = lambda fn, iters: min(time_cuda(fn, iters=iters)
                                 for _ in range(3))
    res["ms"] = best(lambda: decode.decode_kernel(
        q, cache.k, cache.v, state, aux, **kw), 50)
    res["device_ms"], res["kernels_per_call"] = per_call_device(
        lambda: decode.decode_kernel(q, cache.k, cache.v, state, aux, **kw))
    res["cluster"] = decode.cluster_size(state, cache.s_total,
                                         cache.sink_cap, cache.window_size)
    res["plain_ms"] = time_cuda(lambda: decode.decode_plain(
        q, cache.k, cache.v, lens, aux, **kw), iters=10)
    kf, vf = (t.to(torch.bfloat16) for t in cache.dequant_kv())
    mask = live[:, None, None, :]
    res["library_ms"] = best(lambda: _sdpa(q, kf, vf, mask), 20)
    del kf, vf
    flops = 4 * H_q * n_live * D
    slot_bytes = 2 * D + 8 if quant else 4 * D  # K and V of one live slot
    nbytes = H_kv * n_live * slot_bytes + 2 * 2 * B * H_q * D + 16 * B
    peak = H100_PEAK_INT8 if quant else H100_PEAK_BF16
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_HBM_BW * 1e3
    res["bound_ms"] = max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return res


def check_bwd(dev, B, H_q, H_kv, N, D, ns, W, gen, time_n=None, halo=0,
              use_aux=True):
    """dQ and dK/dV kernels vs flash_bwd_plain at one shape, on the same
    (q, k, v, dO, lse, delta); ``halo`` garbage slots before the KV put the
    chunk at kv_offset = -halo. Returns rows "flash_dq", "flash_dkdv" and
    "flash_bwd" (the two together, against SDPA's backward)."""
    from sink_attention_tpu_torch.ops import flash
    from sink_attention_tpu_torch.ops.reference import sink_window_mask
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                attention_pairs, time_cuda)

    geom = (ns, W, 0, -halo)

    def inputs(n):
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
            torch.bfloat16)
        q, do = mk(B, H_q, n, D), mk(B, H_q, n, D)
        k, v = mk(B, H_kv, n + halo, D), mk(B, H_kv, n + halo, D)
        k[:, :, :halo] = 7.7
        v[:, :, :halo] = 7.7
        aux = (torch.randn(H_q, generator=gen, device=dev) if use_aux
               else None)
        o, lse = flash.flash_fwd_kernel(q, k, v, aux, *geom)
        delta = (do.float() * o.float()).sum(-1)
        return q, k, v, do, lse, delta

    x = inputs(N)
    dq = flash.flash_dq_kernel(*x, *geom)
    dk, dv = flash.flash_dkdv_kernel(*x, *geom)
    ref = flash.flash_bwd_plain(*x, *geom)
    dq2 = flash.flash_dq_kernel(*x, *geom)
    dk2, dv2 = flash.flash_dkdv_kernel(*x, *geom)
    torch.cuda.synchronize()
    shape = (f"B={B} H={H_q}/{H_kv} N={N} D={D} sink={ns} W={W}"
             + (" s_aux" if use_aux else "")
             + (f" kv_offset=-{halo}" if halo else ""))
    rows = {}
    for name, got, refs, again in (
            ("flash_dq", (dq,), ref[:1], (dq2,)),
            ("flash_dkdv", (dk, dv), ref[1:], (dk2, dv2))):
        errs = [float((g.float() - r.float()).abs().max()) for g, r in
                zip(got, refs)]
        rel = max(_grad_compare(g, r)["rel_err"] for g, r in zip(got, refs))
        cos = min(cosine(g, r) for g, r in zip(got, refs))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        halo_zero = not halo or not any(bool(g[:, :, :halo].any())
                                        for g in got if g.shape[2] > N)
        rows[name] = {
            "shape": shape, "max_abs_err": max(errs), "rel_err": rel,
            "cos": cos, "bitwise_repeat": same, "halo_zero": halo_zero,
            "ok": (rel <= BWD_TOL and cos >= MIN_COS and same and halo_zero
                   and all(bool(torch.isfinite(g.float()).all())
                           for g in got))}
    del dq, dk, dv, ref, dq2, dk2, dv2

    if time_n is not None and time_n != N:
        x = inputs(time_n)
        for r in rows.values():
            r["timed_N"] = time_n
    n = x[0].shape[2]
    n_kv = n + halo
    rows["flash_dq"]["ms"] = time_cuda(
        lambda: flash.flash_dq_kernel(*x, *geom), iters=10)
    rows["flash_dkdv"]["ms"] = time_cuda(
        lambda: flash.flash_dkdv_kernel(*x, *geom), iters=10)
    plain_ms = time_cuda(lambda: flash.flash_bwd_plain(*x, *geom), iters=2,
                         warmup=1)
    q, k, v, do = (t.detach().clone().requires_grad_(i < 3)
                   for i, t in enumerate(x[:4]))
    mask = sink_window_mask(n, n_kv, ns, W, 0, -halo, device=dev)
    mask &= torch.arange(n_kv, device=dev) >= halo
    out = _sdpa(q, k, v, mask)
    library_ms = time_cuda(lambda: torch.autograd.grad(
        out, (q, k, v), do, retain_graph=True), iters=5)
    del out, q, k, v, do

    pairs = B * H_q * attention_pairs(n, n_kv, ns, W, 0, -halo)
    q_bytes = 2 * B * H_q * n * D        # one bf16 [B, H_q, n, D] tensor
    kv_bytes = 2 * B * H_kv * n_kv * D   # one bf16 [B, H_kv, n_kv, D]
    row_bytes = 8 * B * H_q * n          # lse and delta, fp32
    work = {  # FLOPs per visible pair (2 D per product), bytes moved
        "flash_dq": (6 * D, 3 * q_bytes + 2 * kv_bytes + row_bytes),
        "flash_dkdv": (8 * D, 2 * q_bytes + 4 * kv_bytes + row_bytes),
        "flash_bwd": (10 * D, 5 * q_bytes + 4 * kv_bytes + row_bytes)}
    rows["flash_bwd"] = {
        "shape": shape, "ms": rows["flash_dq"]["ms"] +
        rows["flash_dkdv"]["ms"], "ok": True,
        "max_abs_err": max(rows[k]["max_abs_err"]
                           for k in ("flash_dq", "flash_dkdv"))}
    for name, (per_pair, nbytes) in work.items():
        r = rows[name]
        if time_n is not None and time_n != N:
            r["timed_N"] = time_n
        t_ops = pairs * per_pair / H100_PEAK_BF16 * 1e3
        t_bytes = nbytes / H100_HBM_BW * 1e3
        r.update(plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
    return rows


def pack_lengths(n: int, lo: int, hi: int, seed: int):
    """Segment lengths drawn uniform in [lo, hi] from
    numpy.random.default_rng(seed) until ``n`` tokens are filled; the last
    one is cut to fit (the length spread of a verl / SFT packed batch)."""
    import numpy as np
    rng, lens = np.random.default_rng(seed), []
    while sum(lens) < n:
        lens.append(min(int(rng.integers(lo, hi + 1)), n - sum(lens)))
    return lens


def pack_positions(lens, first: int = 0):
    """int64 [sum(lens)] segment-local positions (what a loader gives);
    ``first`` > 0 starts the pack inside its first segment."""
    pos = torch.cat([torch.arange(L) for L in lens])
    pos[:lens[0]] += first
    return pos


def packed_pairs(positions, num_sink, window):
    """Visible (query, key) pairs of one head over the packed mask of
    ``positions`` [B, N], summed over the batch."""
    from sink_attention_tpu_torch.ops.reference import packed_rows_mask
    n = positions.shape[-1]
    return sum(int(packed_rows_mask(positions, r0, min(1024, n - r0),
                                    num_sink, window).sum())
               for r0 in range(0, n, 1024))


def check_packed(dev, B, H_q, H_kv, D, ns, W, lens, gen, first=0,
                 use_aux=True, label=""):
    """The packed forward, dQ and dK/dV kernels against their plain
    versions on one pack (the same positions in every batch row), dQ and
    dK/dV also bitwise against a second run. Returns rows "packed_fwd",
    "packed_dq", "packed_dkdv" with errors, times and bounds (FLOPs from
    the visible pairs of the pack's own mask)."""
    from sink_attention_tpu_torch.ops import packed
    from sink_attention_tpu_torch.ops.reference import packed_sink_window_mask
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                time_cuda)

    positions = pack_positions(lens, first)[None].expand(B, -1).to(dev)
    N = positions.shape[1]
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    q, do = mk(B, H_q, N, D), mk(B, H_q, N, D)
    k, v = mk(B, H_kv, N, D), mk(B, H_kv, N, D)
    aux = torch.randn(H_q, generator=gen, device=dev) if use_aux else None
    geom = (ns, W)
    o_k, l_k = packed.packed_fwd_kernel(q, k, v, positions, aux, *geom)
    o_p, l_p = packed.packed_fwd_plain(q, k, v, positions, aux, *geom)
    delta = (do.float() * o_k.float()).sum(-1)
    args = (q, k, v, do, l_k, delta, positions, *geom)
    dq = packed.packed_dq_kernel(*args)
    dk, dv = packed.packed_dkdv_kernel(*args)
    ref = packed.packed_bwd_plain(*args)
    dq2 = packed.packed_dq_kernel(*args)
    dk2, dv2 = packed.packed_dkdv_kernel(*args)
    torch.cuda.synchronize()
    shape = (f"B={B} H={H_q}/{H_kv} N={N} D={D} sink={ns} W={W}"
             + (" s_aux" if use_aux else "") + f" {label}")
    err = float((o_k.float() - o_p.float()).abs().max())
    lerr = float((l_k - l_p).abs().max())
    rows = {"packed_fwd": {
        "shape": shape, "max_abs_err": err, "lse_err": lerr,
        "ok": err <= FLASH_TOL and lerr <= LSE_TOL
        and bool(torch.isfinite(o_k.float()).all())}}
    for name, got, refs, again in (
            ("packed_dq", (dq,), ref[:1], (dq2,)),
            ("packed_dkdv", (dk, dv), ref[1:], (dk2, dv2))):
        rel = max(_grad_compare(g, r)["rel_err"] for g, r in zip(got, refs))
        cos = min(cosine(g, r) for g, r in zip(got, refs))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        rows[name] = {
            "shape": shape, "rel_err": rel, "cos": cos,
            "bitwise_repeat": same,
            "max_abs_err": max(float((g.float() - r.float()).abs().max())
                               for g, r in zip(got, refs)),
            "ok": (rel <= BWD_TOL and cos >= MIN_COS and same
                   and all(bool(torch.isfinite(g.float()).all())
                           for g in got))}
    del o_p, l_p, dq, dk, dv, ref, dq2, dk2, dv2

    rows["packed_fwd"]["ms"] = time_cuda(
        lambda: packed.packed_fwd_kernel(q, k, v, positions, aux, *geom),
        iters=10)
    rows["packed_dq"]["ms"] = time_cuda(
        lambda: packed.packed_dq_kernel(*args), iters=10)
    rows["packed_dkdv"]["ms"] = time_cuda(
        lambda: packed.packed_dkdv_kernel(*args), iters=10)
    rows["packed_fwd"]["plain_ms"] = time_cuda(
        lambda: packed.packed_fwd_plain(q, k, v, positions, aux, *geom),
        iters=2, warmup=1)
    bwd_plain_ms = time_cuda(lambda: packed.packed_bwd_plain(*args),
                             iters=2, warmup=1)
    mask = packed_sink_window_mask(positions, ns, W)[:, None]
    rows["packed_fwd"]["library_ms"] = time_cuda(
        lambda: _sdpa(q, k, v, mask), iters=10)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = _sdpa(*leaves, mask)
    bwd_ms = time_cuda(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), iters=5)
    fwd_bwd_ms = time_cuda(lambda: torch.autograd.grad(
        _sdpa(*leaves, mask), leaves, do), iters=5)
    del out, leaves, mask

    pairs = B * H_q * packed_pairs(positions, ns, W)
    q_bytes = 2 * B * H_q * N * D       # one bf16 [B, H_q, N, D] tensor
    kv_bytes = 2 * B * H_kv * N * D     # one bf16 [B, H_kv, N, D]
    pos_bytes = 4 * B * N               # the int32 segment starts
    work = {  # FLOPs per visible pair (2 D per product), bytes moved
        "packed_fwd": (4 * D, 2 * q_bytes + 2 * kv_bytes + 4 * B * H_q * N),
        "packed_dq": (6 * D, 3 * q_bytes + 2 * kv_bytes + 8 * B * H_q * N),
        "packed_dkdv": (8 * D, 2 * q_bytes + 4 * kv_bytes + 8 * B * H_q * N)}
    for name, (per_pair, nbytes) in work.items():
        r = rows[name]
        t_ops = pairs * per_pair / H100_PEAK_BF16 * 1e3
        t_bytes = (nbytes + pos_bytes) / H100_HBM_BW * 1e3
        r.update(pairs=pairs, bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
        if name != "packed_fwd":
            r.update(plain_ms=bwd_plain_ms, library_ms=bwd_ms,
                     library_fwd_bwd_ms=fwd_bwd_ms)
    return rows


def kernel_phase(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    flash_main = [check_flash(dev, 4, 64, 8, 1024, 64, 0, W, gen)
                  for W in (128, 1024)]
    flash_head = check_flash(dev, 1, 32, 8, 4096, 128, 4, 4096, gen,
                             time_n=8192)
    # main path: the sliding layers' 128-slot ring (full, wrapped) and the
    # full layers' max_len = 1024 + 32 cache, mid-decode
    decode_main = [check_decode(dev, 4, 64, 8, 64, 0, 128, 1024, 16, gen),
                   check_decode(dev, 4, 64, 8, 64, 0, 1056, 1024, 16, gen)]
    decode_head = check_decode(dev, 1, 32, 8, 128, 4, 4096, 8192, 1, gen)
    # any GQA group: MQA 32/1 and 64/1 over the full layer's cache, D=64
    # and D=128; a full layer early in its life (hwm 316 of 2048 slots)
    decode_more = [check_decode(dev, 4, h_q, 1, d, 0, 1056, 1024, 16, gen)
                   for d in (64, 128) for h_q in (32, 64)]
    decode_more.append(check_decode(dev, 4, 64, 8, 64, 0, 2048, 300, 16,
                                    gen))
    # quantized storage: the same two caches (the full layer 1024 + 31
    # appends), and phase 6's ragged pool: 4 slots at different lengths and
    # ring phases, one empty, in a sliding and a full (max_len 2048) layer
    quant_rows = {
        f"decode_{qn}": [
            check_decode(dev, 4, 64, 8, 64, 0, 128, 1024, 16, gen, qn),
            check_decode(dev, 4, 64, 8, 64, 0, 1056, 1024, 31, gen, qn),
            check_decode(dev, 4, 64, 8, 64, 0, 128, RAGGED_LENS, 24, gen,
                         qn),
            check_decode(dev, 4, 64, 8, 64, 0, 2048, RAGGED_LENS, 24, gen,
                         qn)]
        for qn in ("int8", "fp8")}
    # training path: gpt-oss-20b's sliding (W=128) and full layers at 4096
    # tokens; the headline shape; a chunk behind a 256-slot garbage halo
    bwd_main = [check_bwd(dev, 1, 64, 8, 4096, 64, 0, W, gen)
                for W in (128, 4096)]
    bwd_head = check_bwd(dev, 1, 32, 8, 4096, 128, 4, 4096, gen,
                         time_n=8192)
    bwd_chunk = check_bwd(dev, 1, 64, 8, 1024, 64, 4, 256, gen, halo=256,
                          use_aux=False)
    # packed training path: phase 5's pack of 4096 tokens through the
    # sliding (W=128) and full layers; the headline shape over segments of
    # 64-3072 tokens; edge cases at N=1024 with 4 sinks
    mix = pack_lengths(4096, PACK_MIN, PACK_MAX, 0)
    packed_main = [check_packed(dev, 1, 64, 8, 64, 0, W, mix, gen,
                                label="phase-5 mix") for W in (128, 4096)]
    packed_head = [check_packed(dev, 1, 32, 8, 128, 4, 4096,
                                pack_lengths(8192, 64, 3072, 1), gen,
                                label="lengths 64-3072")]
    packed_edge = [
        check_packed(dev, 1, 8, 2, 64, 4, 128, lens, gen, first, label=lab)
        for lens, first, lab in (
            ([2, 510, 512], 0, "a 2-token segment"),
            ([32] * 32, 0, "32-token segments"),
            ([300, 724], 2, "pack starts at position 2"),
            ([333, 2, 665], 0, "N=1000"))]
    res = {"flash_fwd": flash_main, "decode": decode_main,
           "flash_fwd_headline": flash_head, "decode_headline": decode_head,
           "decode_more": decode_more, **quant_rows}
    for name in ("flash_dq", "flash_dkdv", "flash_bwd"):
        res[name] = [r[name] for r in bwd_main]
        res[name + "_headline"] = bwd_head[name]
        res[name + "_chunk"] = bwd_chunk[name]
    for name in ("packed_fwd", "packed_dq", "packed_dkdv"):
        res[name] = [r[name] for r in packed_main]
        res[name + "_headline"] = [r[name] for r in packed_head]
        res[name + "_edge"] = [r[name] for r in packed_edge]
    for key, rows in res.items():
        name = key.replace("_headline", "").replace("_chunk", "").replace(
            "_edge", "").replace("_more", "")
        for r in rows if isinstance(rows, list) else [rows]:
            log(f"kernel {name} [{r['shape']}"
                + (f", timed at N={r['timed_N']}" if "timed_N" in r else "")
                + f"]: max_abs_err={r['max_abs_err']:.3e}"
                + (f" lse_err={r['lse_err']:.3e}" if "lse_err" in r else "")
                + (f" vs_bf16_err={r['vs_bf16_err']:.3e}"
                   if "vs_bf16_err" in r else "")
                + (f" rel_err={r['rel_err']:.3e} cos={r['cos']:.7f} "
                   f"bitwise_repeat={r['bitwise_repeat']}"
                   if "cos" in r else "")
                + f" ok={r['ok']} ms={r['ms']:.4f} plain_ms="
                f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
                + (f"library_fwd_bwd_ms={r['library_fwd_bwd_ms']:.4f} "
                   if "library_fwd_bwd_ms" in r else "")
                + f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})"
                + (f" device_ms={r['device_ms']:.4f} kernels_per_call="
                   f"{r['kernels_per_call']:g}" if "device_ms" in r else "")
                + (f" cluster={r['cluster']}" if "cluster" in r else ""))
    return res


def sync_check(dev):
    """One warmed call each of the cached decode, the ragged decode and
    the forward (gpt-oss-20b's shapes) under
    torch.cuda.set_sync_debug_mode("error"): any synchronising CUDA
    operation raises. Returns the errors."""
    from sink_attention_tpu_torch.cache import RaggedSinkKVCache
    from sink_attention_tpu_torch.ops import decode, flash

    gen = torch.Generator(device=dev).manual_seed(11)
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    caches, _ = _decode_caches(dev, 4, 8, 64, 0, 1056, 1024, 1, gen, None)
    ragged = RaggedSinkKVCache.init(4, 8, 64, num_sink=0, window_size=2048,
                                    quant="int8", device=dev)
    for b, n in enumerate(RAGGED_LENS):
        if n:
            ragged.insert(b, mk(8, n, 64), mk(8, n, 64), n)
    q1, aux = mk(4, 64, 1, 64), torch.randn(64, generator=gen, device=dev)
    q, k, v = mk(4, 64, 1024, 64), mk(4, 8, 1024, 64), mk(4, 8, 1024, 64)
    calls = {
        "sink_decode_attention_cached": lambda: (
            decode.sink_decode_attention_cached(q1, caches[None], aux)),
        "sink_decode_attention_ragged": lambda: (
            decode.sink_decode_attention_ragged(q1, ragged, aux)),
        "sink_flash_attention": lambda: flash.sink_flash_attention(
            q, k, v, 0, 1024, s_aux=aux)}
    errors = []
    for name, fn in calls.items():
        fn()  # warm: the build, the forward's range table on the card
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            errors.append(f"{name} synchronises in a warmed call: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    log("sync check (torch.cuda.set_sync_debug_mode('error'), one warmed "
        f"call each of {', '.join(calls)}): "
        + ("no synchronising operation" if not errors else "FAILED"))
    return errors


# ---------------------------------------------------------------------------
# Phase 3: serving
# ---------------------------------------------------------------------------


def _row_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean over rows of the cosine of logits a, b [..., V], taken a batch
    row at a time to bound the fp32 copies."""
    tot, n = 0.0, 0
    for i in range(a.shape[0]):
        x, y = a[i].float(), b[i].float()
        c = (x * y).sum(-1) / (x.norm(dim=-1) * y.norm(dim=-1))
        tot += float(c.double().sum())
        n += c.numel()
    return tot / n


def _top1(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def _attn_compare(o: torch.Tensor, p: torch.Tensor) -> dict:
    return {"err": float((o.float() - p.float()).abs().max()),
            "scale": max(1.0, float(p.float().abs().max())),
            "cos": cosine(o, p)}


def _grad_compare(g: torch.Tensor, ref: torch.Tensor) -> dict:
    """Max abs error of a gradient, that error relative to the largest
    reference value (gradients have no natural unit), and the cosine."""
    err = float((g.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return {"err": err, "rel_err": err / scale if scale > 0 else err,
            "cos": cosine(g, ref)}


def _noisy(attn_impl, seed: int):
    """attn_impl with its output scaled by (1 + e), e ~ N(0, 2^-9): a
    perturbation the size of one bf16 rounding, the control that says how
    far such noise alone moves this model's logits."""
    state = {"n": 0}

    def attn(*a, **kw):
        o = attn_impl(*a, **kw)
        g = torch.Generator(device=o.device).manual_seed(seed + state["n"])
        state["n"] += 1
        e = torch.randn(o.shape, generator=g, device=o.device) * 2.0 ** -9
        return (o.float() * (1.0 + e)).to(o.dtype)

    return attn


def profile_device(fn, kernels, shapes=False):
    """``fn()`` once under torch.profiler: wall ms, device ms, the device
    idle share, the device ms of each kernel whose name holds one of
    ``kernels``, and the device time by kernel and by the PyTorch op that
    launched it (top 10 each; with ``shapes``, ops apart by input shapes,
    which costs host time); None where no device time shows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes, acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, ops = [], []  # the device's own events; the ops' device time
    for ev in prof.key_averages(group_by_input_shape=shapes):
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us <= 0:
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key[:80], dev_us / 1e3, ev.count))
        elif ev.key.startswith("aten::"):  # not the runtime's own events
            name = ev.key + (f" {ev.input_shapes}" if shapes else "")
            ops.append((name[:160], dev_us / 1e3, ev.count))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    ops.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return {"wall_ms": wall, "device_ms": total,
            "device_events": sum(c for _, _, c in rows),
            "device_idle_share": max(0.0, 1.0 - total / wall),
            "kernel_ms": {k: sum(t for n, t, _ in rows if k in n)
                          for k in kernels},
            "top": [{"name": n, "ms": t, "calls": c}
                    for n, t, c in rows[:10]],
            "top_ops": [{"name": n, "ms": t, "calls": c}
                        for n, t, c in ops[:10]]}


def per_call_device(fn, calls=20, tries=3):
    """(device ms per kernel launch, device kernels per call) of ``fn``
    from torch.profiler over ``calls`` back-to-back calls after a warm-up
    call: the kernel's own time, without the host's launch gaps that
    ``time_cuda`` counts. The profiler has been seen to drop some or all
    of the events of kernels launched through ctypes, so the time is the
    mean over the events it kept (kernels per call then reads below 1),
    and a window with none is profiled again, up to ``tries`` times."""
    fn()
    for _ in range(tries):
        prof = profile_device(lambda: [fn() for _ in range(calls)], [])
        if prof is not None:
            events = prof["device_events"]
            return prof["device_ms"] / events, events / calls
    raise RuntimeError(f"torch.profiler recorded no device event in "
                       f"{tries} windows of {calls} calls")


def serve(cfg, device, *, batch=4, prompt_len=1024, new_tokens=32,
          dtype=torch.bfloat16):
    """Serve ``batch`` seeded requests through greedy_generate and check the
    path, with weights and prompts from a generator seeded 0. Returns
    (report, errors); the launch counts in the report cover the
    greedy_generate call alone.

    Checks (each failure is an error):
    * every layer's attention, prefill and each decode step, kernel against
      its plain version on the live activations: cosine >= 0.9999, max abs
      error <= 2e-2 x max(1, max |plain|);
    * logits over all positions, kernel prefill against plain-attention
      prefill, and decode steps against teacher-forced prefill: the mean
      row cosine's distance from 1 at most twice that of a control whose
      attention output carries bf16-sized noise (random weights make this
      model chaotic in bf16: such noise alone moves its logits; see
      PERF.md).
    """
    from sink_attention_tpu_torch.models import (forward_decode,
                                                 forward_prefill, init_params)
    from sink_attention_tpu_torch.ops import decode, flash
    from sink_attention_tpu_torch.serving import (greedy_generate,
                                                  prefill_and_caches)

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dtype=dtype, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    sync()
    report = {"init_s": time.perf_counter() - t0}
    errors = []
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    flash.flash_fwd_kernel.launches = 0
    decode.decode_kernel.launches = 0
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, prompts, new_tokens, dtype=dtype,
                           device=dev)
    sync()
    report["generate_ms"] = (time.perf_counter() - t0) * 1e3
    report["launches"] = {"flash_fwd": flash.flash_fwd_kernel.launches,
                          "decode": decode.decode_kernel.launches}
    if tuple(toks.shape) != (batch, new_tokens) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        errors.append(f"generated tokens malformed: {tuple(toks.shape)}")

    def plain_prefill_attn(q, k, v, num_sink, window_size, s_aux):
        return flash.flash_fwd_plain(q, k, v, s_aux, num_sink,
                                     window_size)[0]

    def plain_decode_attn(q, cache, s_aux=None):
        lens = decode._uniform_lens(cache.sink_len, cache.window_len,
                                    cache.write_pos, cache.window_size,
                                    cache.sink_cap, q.shape[0], q.device)
        return decode.decode_plain(q, cache.k, cache.v, lens, s_aux,
                                   sink_cap=cache.sink_cap,
                                   window_size=cache.window_size)

    layer_stats = {"prefill": [], "decode": []}

    def checked(kernel_fn, plain_fn, stats):
        def attn(*a, **kw):
            o = kernel_fn(*a, **kw)
            stats.append(_attn_compare(o, plain_fn(*a, **kw)))
            return o
        return attn

    with torch.inference_mode():
        # Prefill and decode timed apart; the decode is fed the generated
        # tokens, so it repeats greedy_generate's steps, and keeps logits.
        t0 = time.perf_counter()
        first, caches = prefill_and_caches(params, cfg, prompts, new_tokens,
                                           dtype=dtype)
        sync()
        report["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        dec_logits = []
        t0 = time.perf_counter()
        for i in range(new_tokens - 1):
            logits, caches = forward_decode(params, cfg, toks[:, i:i + 1],
                                            caches, prompt_len + i)
            dec_logits.append(logits[:, -1])
        sync()
        steps = max(new_tokens - 1, 1)
        report["decode_ms_per_token"] = (
            (time.perf_counter() - t0) * 1e3 / steps)
        report["decode_tokens_per_s"] = batch / (
            report["decode_ms_per_token"] / 1e3)
        replay = torch.stack([first] + [l.argmax(-1) for l in dec_logits], 1)
        report["replay_token_agreement"] = float(
            (replay == toks).float().mean())
        if cuda:
            report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            report["decode_step_profile"] = profile_device(
                lambda: forward_decode(params, cfg, toks[:, -1:], caches,
                                       prompt_len + new_tokens - 1),
                ("decode_kernel",))
        del caches

        # Kernel prefill (checked layer by layer) against plain attention
        # and against the noise control, over all positions.
        lk, _ = forward_prefill(params, cfg, prompts, attn_impl=checked(
            flash.sink_flash_attention, plain_prefill_attn,
            layer_stats["prefill"]))
        lp, _ = forward_prefill(params, cfg, prompts,
                                attn_impl=plain_prefill_attn)
        report["plain_last_cos"] = cosine(lk[:, -1], lp[:, -1])
        report["plain_last_top1"] = _top1(lk[:, -1], lp[:, -1])
        report["plain_all_cos"] = _row_cos(lk, lp)
        report["plain_all_top1"] = _top1(lk, lp)
        del lk
        ln, _ = forward_prefill(params, cfg, prompts,
                                attn_impl=_noisy(plain_prefill_attn, 1))
        report["control_all_cos"] = _row_cos(ln, lp)
        report["control_last_cos"] = cosine(ln[:, -1], lp[:, -1])
        del ln, lp
        if 1.0 - report["plain_all_cos"] > 2.0 * (
                1.0 - report["control_all_cos"]):
            errors.append(
                f"kernel prefill logits vs plain attention: mean cosine "
                f"{report['plain_all_cos']:.6f}, control "
                f"{report['control_all_cos']:.6f}")

        # Decode steps against teacher-forced prefill logits.
        if dec_logits:
            seq = torch.cat([prompts, toks[:, :-1]], dim=1)
            dl = torch.stack(dec_logits, dim=1)
            del dec_logits
            tf, _ = forward_prefill(params, cfg, seq)
            tf = tf[:, prompt_len:]
            report["teacher_all_cos"] = _row_cos(dl, tf)
            report["teacher_top1"] = _top1(dl, tf)
            tn, _ = forward_prefill(params, cfg, seq, attn_impl=_noisy(
                flash.sink_flash_attention, 1000))
            report["teacher_control_cos"] = _row_cos(tn[:, prompt_len:], tf)
            del tf, tn, dl
            if 1.0 - report["teacher_all_cos"] > 2.0 * (
                    1.0 - report["teacher_control_cos"]):
                errors.append(
                    f"decode logits vs teacher forcing: mean cosine "
                    f"{report['teacher_all_cos']:.6f}, control "
                    f"{report['teacher_control_cos']:.6f}")

            # Decode attention checked layer by layer, every step.
            _, caches = prefill_and_caches(params, cfg, prompts, new_tokens,
                                           dtype=dtype)
            attn = checked(decode.sink_decode_attention_cached,
                           plain_decode_attn, layer_stats["decode"])
            for i in range(new_tokens - 1):
                _, caches = forward_decode(params, cfg, toks[:, i:i + 1],
                                           caches, prompt_len + i,
                                           attn_impl=attn)
            del caches

    for phase, stats in layer_stats.items():
        if stats:
            _layer_gate(stats, phase, report, errors)
    return report, errors


# ---------------------------------------------------------------------------
# Phase 4: training
# ---------------------------------------------------------------------------


class _PlainAttention(torch.autograd.Function):
    """Sink attention through the kernels' plain versions, forward and
    backward, on any device: the reference path of the end-to-end check
    (its memory stays bounded at 4096 tokens, unlike autograd through the
    plain forward)."""

    @staticmethod
    def forward(ctx, q, k, v, s_aux, num_sink, window_size):
        from sink_attention_tpu_torch.ops import flash
        o, lse = flash.flash_fwd_plain(q, k, v, s_aux, num_sink, window_size)
        ctx.save_for_backward(q, k, v, s_aux, o, lse)
        ctx.geometry = (num_sink, window_size)
        return o

    @staticmethod
    def backward(ctx, do):
        from sink_attention_tpu_torch.ops import flash
        q, k, v, s_aux, o, lse = ctx.saved_tensors
        grads = flash.attention_backward(
            q, k, v, s_aux, o, lse, do, None, *ctx.geometry,
            dqkv=flash.flash_bwd_plain)
        return (*grads, None, None)


def plain_attn(q, k, v, num_sink, window_size, s_aux):
    return _PlainAttention.apply(q, k, v, s_aux, num_sink, window_size)


def _attn_grads(q, k, v, s_aux, do, num_sink, window_size, plain):
    """(dq, dk, dv, ds_aux) of one layer's attention from its inputs and
    its output's cotangent: forward and backward through the kernels (the
    plain versions on the CPU), or through the plain versions."""
    from sink_attention_tpu_torch.ops import flash
    geom = (num_sink, window_size)
    if plain:
        o, lse = flash.flash_fwd_plain(q, k, v, s_aux, *geom)
        return flash.attention_backward(q, k, v, s_aux, o, lse, do, None,
                                        *geom, dqkv=flash.flash_bwd_plain)
    o, lse = flash.sink_flash_attention_with_lse(q, k, v, *geom, s_aux)
    return flash.attention_backward(q, k, v, s_aux, o, lse, do, None, *geom)


def _elapsed_ms(fn, cuda):
    """(fn(), ms): CUDA events on the card, the host clock on the CPU."""
    if not cuda:
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _run_steps(step, steps, seq_len, kernels, cuda, report, errors):
    """``steps`` calls of ``step()`` (returning the loss), each timed, with
    the launches of ``kernels`` counted from 0 over them."""
    for fn in kernels.values():
        fn.launches = 0
    report["steps"] = []
    for _ in range(steps):
        loss, ms = _elapsed_ms(step, cuda)
        report["steps"].append({"loss": float(loss), "ms": ms,
                                "tokens_per_s": seq_len / (ms / 1e3)})
    report["launches"] = {n: fn.launches for n, fn in kernels.items()}
    report["losses"] = [r["loss"] for r in report["steps"]]
    if not all(math.isfinite(x) for x in report["losses"]):
        errors.append(f"training losses not finite: {report['losses']}")


def _split_step(loss_fn, opt, cuda, report):
    """One more step, timed by part: forward, backward, optimizer."""
    opt.zero_grad(set_to_none=True)
    loss, report["forward_ms"] = _elapsed_ms(loss_fn, cuda)
    _, report["backward_ms"] = _elapsed_ms(loss.backward, cuda)
    _, report["optimizer_ms"] = _elapsed_ms(opt.step, cuda)


def _recording(attend, records):
    """An attn_impl running ``attend(q, k, v, num_sink, window_size,
    s_aux)`` that records each layer's inputs and output cotangent."""
    def attn(q, k, v, num_sink, window_size, s_aux):
        o = attend(q, k, v, num_sink, window_size, s_aux)
        rec = {"x": [t.detach() for t in (q, k, v)], "geom": (
            num_sink, window_size), "aux": None if s_aux is None else
            s_aux.detach()}
        o.register_hook(lambda g: rec.__setitem__("do", g.detach()))
        records.append(rec)
        return o
    return attn


def _check_layer_grads(records, attn_grads, report, errors):
    """Every recorded layer's attention gradients (dq, dk, dv, ds_aux),
    ``attn_grads(q, k, v, s_aux, do, num_sink, window_size, plain=)``
    through the kernels against the plain versions: cosine >= MIN_COS, max
    abs error <= BWD_TOL x max |plain|."""
    stats = []
    for rec in records:
        q, k, v = rec["x"]
        got, ref = (attn_grads(q, k, v, rec["aux"], rec["do"], *rec["geom"],
                               plain=plain) for plain in (False, True))
        for name, a, b in zip(("dq", "dk", "dv", "ds_aux"), got, ref):
            if b is not None:
                stats.append({"name": name, **_grad_compare(a, b)})
    report["layers_checked"] = len(records)
    report["layer_min_cos"] = min(s["cos"] for s in stats)
    report["layer_min_cos_by_grad"] = {
        n: min(s["cos"] for s in stats if s["name"] == n)
        for n in ("dq", "dk", "dv", "ds_aux") if any(
            s["name"] == n for s in stats)}
    worst_rel = max(s["rel_err"] for s in stats)
    report["layer_max_rel_err"] = worst_rel
    if report["layer_min_cos"] < MIN_COS or worst_rel > BWD_TOL:
        errors.append(f"attention gradients, kernels vs plain on the live "
                      f"path: min cosine {report['layer_min_cos']:.7f}, max "
                      f"error {worst_rel:.3e} of the largest value")


def train(cfg, device, *, seq_len=4096, steps=3, lr=1e-2,
          dtype=torch.bfloat16):
    """``steps`` SGD steps of make_train_step(remat=True) on one seeded
    sequence of ``seq_len`` + 1 tokens, with weights from a generator
    seeded 0, then the checks. Returns (report, errors); the launch counts
    in the report cover the ``steps`` steps alone.

    Checks (each failure is an error):
    * every loss finite;
    * every layer's attention gradients (dq, dk, dv, ds_aux) on the live
      activations and output cotangents of one step, kernels against the
      plain versions (forward and backward): cosine >= MIN_COS, max abs
      error <= BWD_TOL x max |plain|;
    * the per-token losses of one step (the scalar loss is their mean) and
      the gradients of lm_head, layers[0].attn.sinks, layers[0].attn.wq
      and layers[1].attn.wk, kernel path against plain attention: distance
      from cosine 1 at most twice that of a control whose attention output
      carries bf16-sized noise (random weights make this model chaotic in
      bf16, see PERF.md; the scalar loss alone is one draw of that chaos,
      too few to judge by).
    """
    from sink_attention_tpu_torch.models import forward_prefill, init_params
    from sink_attention_tpu_torch.ops import flash
    from sink_attention_tpu_torch.parallel import (cross_entropy_loss,
                                                   make_train_step,
                                                   param_leaves)

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kernels = {"flash_fwd": flash.flash_fwd_kernel,
               "flash_dq": flash.flash_dq_kernel,
               "flash_dkdv": flash.flash_dkdv_kernel}
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dtype=dtype, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (1, seq_len + 1),
                          generator=gen, device=dev)
    opt = torch.optim.SGD(param_leaves(params), lr=lr)
    step = make_train_step(cfg, opt, remat=True)
    if cuda:
        torch.cuda.synchronize()
    report = {"init_s": time.perf_counter() - t0,
              "params": sum(t.numel() for t in param_leaves(params))}
    errors = []
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    _run_steps(lambda: step(params, batch), steps, seq_len, kernels, cuda,
               report, errors)
    _split_step(lambda: cross_entropy_loss(params, cfg, batch, remat=True),
                opt, cuda, report)
    if cuda:
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        report["step_profile"] = profile_device(
            lambda: step(params, batch),
            ("fwd_wgmma_kernel", "dq_kernel", "dkdv_kernel"),
            shapes=True)
    opt.zero_grad(set_to_none=True)

    # The kernel path, recording each layer's attention inputs and output
    # cotangent; then plain attention, and plain attention with noise.
    records = []
    recording = _recording(flash.sink_flash_attention, records)
    lp0, lp1 = params["layers"][0]["attn"], params["layers"][1]["attn"]
    names = ("lm_head", "layers[0].attn.sinks", "layers[0].attn.wq",
             "layers[1].attn.wk")
    targets = (params["lm_head"], lp0["sinks"], lp0["wq"], lp1["wk"])

    def grads_of(attn_impl):
        """(per-token losses, the gradients of their mean - the training
        loss - with respect to ``targets``)."""
        logits, _ = forward_prefill(params, cfg, batch[:, :-1],
                                    attn_impl=attn_impl)
        losses = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            batch[:, 1:].reshape(-1), reduction="none")
        del logits
        return losses.detach(), torch.autograd.grad(losses.mean(), targets)

    paths = {"kernel": grads_of(recording), "plain": grads_of(plain_attn),
             "control": grads_of(_noisy(plain_attn, 7))}

    _check_layer_grads(records, _attn_grads, report, errors)
    del records

    losses_p, grads_p = paths["plain"]
    report["end_to_end"] = e2e = {"plain_loss": float(losses_p.mean())}
    for path in ("kernel", "control"):
        losses_x, grads_x = paths[path]
        e2e[path] = {"loss": float(losses_x.mean()),
                     "token_losses": 1.0 - cosine(losses_x, losses_p)}
        e2e[path].update({n: 1.0 - cosine(a, b) for n, a, b in
                          zip(names, grads_x, grads_p)})
    for n in ("token_losses",) + names:
        if e2e["kernel"][n] > 2.0 * e2e["control"][n]:
            errors.append(f"{n}, kernel vs plain attention: 1 - "
                          f"cosine {e2e['kernel'][n]:.3e}, control "
                          f"{e2e['control'][n]:.3e}")
    return report, errors


# ---------------------------------------------------------------------------
# Phase 5: packed training
# ---------------------------------------------------------------------------


class _PlainPackedAttention(torch.autograd.Function):
    """Packed sink attention through the packed kernels' plain versions,
    forward and backward, on any device: the reference path of the
    end-to-end check."""

    @staticmethod
    def forward(ctx, q, k, v, s_aux, positions, num_sink, window_size):
        from sink_attention_tpu_torch.ops import packed
        o, lse = packed.packed_fwd_plain(q, k, v, positions, s_aux, num_sink,
                                         window_size)
        ctx.save_for_backward(q, k, v, s_aux, positions, o, lse)
        ctx.geometry = (num_sink, window_size)
        return o

    @staticmethod
    def backward(ctx, do):
        from sink_attention_tpu_torch.ops import flash, packed
        q, k, v, s_aux, positions, o, lse = ctx.saved_tensors
        grads = flash.attention_backward(
            q, k, v, s_aux, o, lse, do, dqkv=lambda q, k, v, do, lse, delta,
            *_: packed.packed_bwd_plain(q, k, v, do, lse, delta, positions,
                                        *ctx.geometry))
        return (*grads, None, None, None)


def _packed_attn_grads(q, k, v, s_aux, do, positions, num_sink, window_size,
                       plain):
    """(dq, dk, dv, ds_aux) of one layer's packed attention from its inputs
    and its output's cotangent: through the packed kernels (their plain
    versions on the CPU), or through the plain versions."""
    from sink_attention_tpu_torch.ops import flash, packed
    geom = (num_sink, window_size)
    if plain:
        o, lse = packed.packed_fwd_plain(q, k, v, positions, s_aux, *geom)
        dqkv = packed.packed_bwd_plain
    else:
        o, lse = packed._fwd(q, k, v, positions, s_aux, *geom)
        dqkv = packed._dqkv
    return flash.attention_backward(
        q, k, v, s_aux, o, lse, do, dqkv=lambda q, k, v, do, lse, delta, *_:
        dqkv(q, k, v, do, lse, delta, positions, *geom))


def train_packed(cfg, device, *, seq_len=4096, steps=3, lr=1e-2,
                 dtype=torch.bfloat16, min_len=PACK_MIN, max_len=PACK_MAX):
    """``steps`` SGD steps of cross_entropy_loss_packed on one pack of
    ``seq_len`` tokens, segments of pack_lengths(seq_len, min_len, max_len,
    0), weights from a generator seeded 0; then the checks. Returns
    (report, errors); the launch counts cover the ``steps`` steps alone.

    Checks (each failure is an error):
    * every loss finite;
    * every layer's packed attention gradients (dq, dk, dv, ds_aux) on the
      live activations and output cotangents of one step, packed kernels
      against their plain versions: cosine >= MIN_COS, max abs error <=
      BWD_TOL x max |plain|;
    * the per-token losses of the valid targets, kernel path against plain
      packed attention: distance from cosine 1 at most twice that of a
      control whose attention output carries bf16-sized noise;
    * segment isolation: each segment's logits in the pack against that
      segment's own unpacked forward, by mean row cosine, within twice the
      distance of the same control on that forward.
    """
    from sink_attention_tpu_torch.models import forward_prefill, init_params
    from sink_attention_tpu_torch.ops import flash, packed
    from sink_attention_tpu_torch.parallel import (cross_entropy_loss_packed,
                                                   param_leaves)

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kernels = {"packed_fwd": packed.packed_fwd_kernel,
               "packed_dq": packed.packed_dq_kernel,
               "packed_dkdv": packed.packed_dkdv_kernel,
               "flash_fwd": flash.flash_fwd_kernel,
               "flash_dq": flash.flash_dq_kernel,
               "flash_dkdv": flash.flash_dkdv_kernel}
    lens = pack_lengths(seq_len, min_len, max_len, 0)
    positions = pack_positions(lens)[None].to(dev)  # int64, as loaders give
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dtype=dtype, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (1, seq_len), generator=gen,
                          device=dev)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.SGD(leaves, lr=lr)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = cross_entropy_loss_packed(params, cfg, batch, positions)
        loss.backward()
        opt.step()
        return loss.detach()

    if cuda:
        torch.cuda.synchronize()
    report = {"init_s": time.perf_counter() - t0, "segment_lengths": lens,
              "params": sum(t.numel() for t in leaves)}
    errors = []
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    _run_steps(step, steps, seq_len, kernels, cuda, report, errors)
    _split_step(lambda: cross_entropy_loss_packed(params, cfg, batch,
                                                  positions), opt, cuda,
                report)
    if cuda:
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        report["step_profile"] = profile_device(
            step, ("fwd_kernel", "dq_kernel", "dkdv_kernel"))
    opt.zero_grad(set_to_none=True)

    # The kernel path, recording each layer's attention inputs and output
    # cotangent; then plain packed attention, and the same with noise.
    records = []
    recording = _recording(lambda q, k, v, *geom: (
        packed.sink_flash_attention_packed(q, k, v, positions, *geom)),
        records)

    def plain(q, k, v, num_sink, window_size, s_aux):
        return _PlainPackedAttention.apply(q, k, v, s_aux, positions,
                                           num_sink, window_size)

    valid = positions[0, 1:] > 0

    def token_losses(attn_impl, backward=False):
        """The valid targets' losses (and, with ``backward``, a backward
        pass of their mean down to the first layer's wq, through every
        layer's attention output)."""
        with torch.set_grad_enabled(backward):
            logits, _ = forward_prefill(params, cfg, batch,
                                        positions=positions,
                                        attn_impl=attn_impl)
            losses = torch.nn.functional.cross_entropy(
                logits[0, :-1].float(), batch[0, 1:], reduction="none")[valid]
            if backward:
                torch.autograd.grad(losses.mean(),
                                    params["layers"][0]["attn"]["wq"])
        return losses.detach(), logits.detach()

    losses_k, logits_k = token_losses(recording, backward=True)
    losses_p, _ = token_losses(plain)
    losses_c, _ = token_losses(_noisy(plain, 11))

    _check_layer_grads(records, lambda q, k, v, aux, do, *geom, plain:
                       _packed_attn_grads(q, k, v, aux, do, positions, *geom,
                                          plain=plain), report, errors)
    del records

    report["valid_targets"] = int(valid.sum())
    report["token_losses"] = tl = {
        "kernel_loss": float(losses_k.mean()),
        "plain_loss": float(losses_p.mean()),
        "control_loss": float(losses_c.mean()),
        "kernel": 1.0 - cosine(losses_k, losses_p),
        "control": 1.0 - cosine(losses_c, losses_p)}
    if tl["kernel"] > 2.0 * tl["control"]:
        errors.append(f"packed per-token losses, kernel vs plain attention: "
                      f"1 - cosine {tl['kernel']:.3e}, control "
                      f"{tl['control']:.3e}")

    # Segment isolation: each segment in the pack against its own forward.
    report["segments"] = seg_rows = []
    start = 0
    with torch.no_grad():
        for i, L in enumerate(lens):
            ids = batch[:, start:start + L]
            alone, _ = forward_prefill(params, cfg, ids)
            noisy, _ = forward_prefill(params, cfg, ids, attn_impl=_noisy(
                flash.sink_flash_attention, 100 + i))
            seg_rows.append({
                "length": L,
                "packed": 1.0 - _row_cos(logits_k[:, start:start + L], alone),
                "control": 1.0 - _row_cos(noisy, alone)})
            start += L
    for i, r in enumerate(seg_rows):
        if r["packed"] > 2.0 * r["control"]:
            errors.append(f"segment {i} ({r['length']} tokens) in the pack "
                          f"vs its own forward: 1 - mean row cosine "
                          f"{r['packed']:.3e}, control {r['control']:.3e}")
    return report, errors


# ---------------------------------------------------------------------------
# Phase 6: continuous-batching serving
# ---------------------------------------------------------------------------


def engine_requests(n: int, vocab: int, seed: int = 0, prompt=(64, 1024),
                    new=(16, 32)):
    """``n`` requests drawn from numpy.random.default_rng(seed): prompt
    lengths uniform in ``prompt``, max_new_tokens in ``new`` (both
    inclusive), token ids uniform in [0, vocab). [(prompt ids, max new)]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt[0], prompt[1] + 1, n)
    news = rng.integers(new[0], new[1] + 1, n)
    return [(rng.integers(0, vocab, int(L)).tolist(), int(m))
            for L, m in zip(lens, news)]


def _kv_roundtrip(attn_impl, quant):
    """attn_impl reading K and V through quantize -> dequantize: the
    control that says how far the cache's rounding alone moves the
    logits."""
    from sink_attention_tpu_torch.cache import dequantize, quantize

    def rt(x):
        return dequantize(*quantize(x, quant), quant).to(x.dtype)

    def attn(q, k, v, **kw):
        return attn_impl(q, rt(k), rt(v), **kw)
    return attn


def _layer_gate(stats, name, report, errors):
    """Report the worst per-layer attention comparison of ``stats`` and
    fail below cosine MIN_COS or above 2e-2 of scale."""
    worst_cos = min(s["cos"] for s in stats)
    worst_rel = max(s["err"] / s["scale"] for s in stats)
    report[f"{name}_layers_checked"] = len(stats)
    report[f"{name}_layer_min_cos"] = worst_cos
    report[f"{name}_layer_max_err"] = max(s["err"] for s in stats)
    if worst_cos < MIN_COS or worst_rel > 2e-2:
        errors.append(f"{name} attention kernel vs plain on the live path: "
                      f"min cosine {worst_cos:.6f}, max error "
                      f"{worst_rel:.3e} of scale")


def _engine_replay(params, cfg, reqs, tokens, quant, *, device, dtype,
                   max_len, bucket, steps, stop_slot_at):
    """Replay the engine's decode of the first 4 requests through
    forward_decode_ragged with every layer's attention checked, kernel
    against plain: their prompts inserted into a fresh ragged pool, then
    their generated tokens fed back for up to ``steps`` steps (slot 3
    turns inactive after ``stop_slot_at``). Returns (per-layer stats,
    {slot: replay logits [steps_b, V]})."""
    from sink_attention_tpu_torch.models import (forward_decode_ragged,
                                                 forward_prefill,
                                                 make_ragged_caches)
    from sink_attention_tpu_torch.ops import decode

    B = 4
    caches = make_ragged_caches(cfg, B, max_len, dtype=dtype, quant=quant,
                                device=device)
    for b, (prompt, _) in enumerate(reqs[:B]):
        n = len(prompt)
        ids = torch.zeros((1, -(-n // bucket) * bucket), dtype=torch.long)
        ids[0, :n] = torch.tensor(prompt)
        _, kvs = forward_prefill(params, cfg, ids.to(device),
                                 collect_kv=True)
        for c, (k, v) in zip(caches, kvs):
            c.insert(b, k[0], v[0], n)
    n_steps = [min(len(tokens[b]) - 1, steps) for b in range(B)]
    n_steps[3] = min(n_steps[3], stop_slot_at)
    stats, rows = [], {b: [] for b in range(B)}

    def checked(q, cache, s_aux=None):
        o = decode.sink_decode_attention_ragged(q, cache, s_aux)
        p = decode.decode_plain(q, cache.k, cache.v, decode.ragged_lens(cache),
                                s_aux, **decode.cache_args(cache))
        live = (cache.sink_len + cache.window_len) > 0
        stats.append(_attn_compare(o[live], p[live]))
        return o

    for i in range(max(n_steps)):
        act_py = [i < n for n in n_steps]
        toks = torch.tensor([tokens[b][i] if act_py[b] else 0
                             for b in range(B)], device=device)
        logits, _ = forward_decode_ragged(
            params, cfg, toks[:, None], caches, caches[0].seen,
            torch.tensor(act_py, device=device), attn_impl=checked)
        for b in range(B):
            if act_py[b]:
                rows[b].append(logits[b, -1])
    return stats, {b: torch.stack(r) for b, r in rows.items()}


def _teacher_distance(params, cfg, reqs, tokens, rows, attn_impls):
    """1 - mean row cosine of each replay's logits against teacher-forced
    forward_prefill of its slot's own sequence, for each attention of
    ``attn_impls`` ({name: attn_impl or None}); the first is the
    reference the others are measured against."""
    from sink_attention_tpu_torch.models import forward_prefill

    names = list(attn_impls)
    got = {n: [] for n in names[1:] + ["replay"]}
    for b, r in rows.items():
        # replay step i fed generated token i at position len(prompt) + i
        prompt, dev = reqs[b][0], r.device
        seq = torch.tensor(prompt + tokens[b][:r.shape[0]], device=dev)[None]
        tf = {n: forward_prefill(params, cfg, seq, attn_impl=impl)[0][
            0, len(prompt):] for n, impl in attn_impls.items()}
        ref = tf[names[0]]
        got["replay"].append((r, ref))
        for n in names[1:]:
            got[n].append((tf[n], ref))
    return {n: 1.0 - _row_cos(torch.cat([a for a, _ in pairs])[None],
                              torch.cat([b for _, b in pairs])[None])
            for n, pairs in got.items()}


def serve_engine(cfg, device, *, quants=("int8", "fp8", None),
                 n_requests=8, max_batch=4, max_len=2048, bucket=128,
                 prompt=(64, 1024), new=(16, 32), replay_steps=16,
                 dtype=torch.bfloat16):
    """The continuous-batching engine over ``n_requests`` seeded requests
    (engine_requests) in ``max_batch`` slots, once per KV storage of
    ``quants``, weights from a generator seeded 0 (phase 3's). Returns
    (report, errors); each run's launch counts cover its run() alone.

    Per run it reports the wall time of run(), tokens and tokens/s of the
    pool, each request's time to first token (first_token_cb, from the
    start of run()), ms per pool decode step and the device idle share of
    one (profile_device), peak memory and the cache's bytes. Checks (each
    failure is an error):
    * every request returns exactly max_new_tokens tokens in [0, vocab);
      every request was admitted (its first token called back), more
      requests than slots (slots recycled);
    * on the card, launches: the forward kernel once per layer and
      admission, the run's decode branch once per layer and pool step,
      the other two branches not at all;
    * every layer's decode attention on the live activations of a replay
      (see _engine_replay), kernel against plain: cosine >= MIN_COS, error
      <= 2e-2 of scale;
    * the replay's logits against teacher-forced prefill of each slot's
      sequence: the distance from cosine 1 at most twice that of a
      control, bf16-sized noise in the attention output for the bf16
      cache, K and V read through quantize -> dequantize for int8/fp8
      (the noise control is reported for those too).
    """
    from sink_attention_tpu_torch.models import init_params
    from sink_attention_tpu_torch.ops import decode, flash
    from sink_attention_tpu_torch.serving import ContinuousBatchingEngine

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, dtype=dtype, device=dev)
    sync()
    reqs = engine_requests(n_requests, cfg.vocab_size, 0, prompt, new)
    report = {"init_s": time.perf_counter() - t0,
              "prompt_lengths": [len(p) for p, _ in reqs],
              "max_new_tokens": [m for _, m in reqs]}
    errors = []
    counters = {"decode": "launches", "decode_int8": "launches_int8",
                "decode_fp8": "launches_fp8"}
    for quant in quants:
        label = quant or str(dtype).replace("torch.", "")
        rep = report[label] = {}
        ttft = {}
        eng = ContinuousBatchingEngine(
            params, cfg, max_batch=max_batch, max_len=max_len,
            prefill_bucket=bucket, dtype=dtype, quant=quant, device=dev,
            first_token_cb=lambda rid, tok: ttft.setdefault(
                rid, time.perf_counter() - t_run))
        rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        flash.flash_fwd_kernel.launches = 0
        for attr in counters.values():
            setattr(decode.decode_kernel, attr, 0)
        t_run = time.perf_counter()
        out = eng.run()
        sync()
        rep["run_ms"] = (time.perf_counter() - t_run) * 1e3
        rep["launches"] = {"flash_fwd": flash.flash_fwd_kernel.launches,
                           **{n: getattr(decode.decode_kernel, a)
                              for n, a in counters.items()}}
        rep["pool_steps"] = eng.pool_steps
        n_tok = sum(len(t) for t in out.values())
        rep["tokens"] = n_tok
        rep["tokens_per_s"] = n_tok / (rep["run_ms"] / 1e3)
        rep["ttft_ms"] = [ttft.get(r, float("nan")) * 1e3 for r in rids]
        c = eng.caches
        rep["kv_bytes"] = sum(x.k.nbytes + x.v.nbytes for x in c)
        rep["scale_bytes"] = sum(x.k_scale.nbytes + x.v_scale.nbytes
                                 for x in c)
        if cuda:
            rep["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        tokens = [out[r] for r in rids]
        for (_, m), toks in zip(reqs, tokens):
            if len(toks) != m or not all(0 <= t < cfg.vocab_size
                                         for t in toks):
                errors.append(f"{label} engine: a request asked for {m} "
                              f"tokens and got {len(toks)}: {toks[:8]}")
        if sorted(ttft) != sorted(rids) or n_requests <= max_batch:
            errors.append(f"{label} engine: {len(ttft)} of {n_requests} "
                          f"requests admitted into {max_batch} slots")
        if cuda:
            run_branch = f"decode_{quant}" if quant else "decode"
            want = {"flash_fwd": cfg.num_layers * n_requests,
                    **{n: cfg.num_layers * eng.pool_steps
                       if n == run_branch else 0 for n in counters}}
            for name, n in want.items():
                if rep["launches"][name] != n:
                    errors.append(f"{label} engine: {name} launched "
                                  f"{rep['launches'][name]} times, "
                                  f"expected {n}")

        # Pool decode steps timed: the first 4 prompts again, one chunk
        # of 16 steps after their admission, then one profiled step.
        for p, _ in reqs[:max_batch]:
            eng.submit(p, max_new_tokens=2 * replay_steps + 4)
        eng.step_chunk(1)
        sync()
        t0 = time.perf_counter()
        eng.step_chunk(replay_steps)
        sync()
        rep["ms_per_pool_step"] = ((time.perf_counter() - t0) * 1e3
                                   / replay_steps)
        if cuda:
            rep["pool_step_profile"] = profile_device(
                lambda: eng.step_chunk(1), ("decode_kernel",))
        del eng, c

        # Every layer's decode attention checked on a replay, and the
        # replay's logits against teacher forcing.
        with torch.no_grad():
            stats, rows = _engine_replay(
                params, cfg, reqs, tokens, quant, device=dev, dtype=dtype,
                max_len=max_len, bucket=bucket, steps=replay_steps,
                stop_slot_at=replay_steps // 2)
            _layer_gate(stats, "decode", rep, errors)
            impls = {"teacher": flash.sink_flash_attention,
                     "noise_control": _noisy(flash.sink_flash_attention,
                                             2000)}
            if quant:
                impls["roundtrip_control"] = _kv_roundtrip(
                    flash.sink_flash_attention, quant)
            dist = _teacher_distance(params, cfg, reqs, tokens, rows, impls)
        rep["replay_rows"] = sum(r.shape[0] for r in rows.values())
        rep["teacher_distance"] = dist
        control = "roundtrip_control" if quant else "noise_control"
        if dist["replay"] > 2.0 * dist[control]:
            errors.append(f"{label} engine replay vs teacher forcing: 1 - "
                          f"cosine {dist['replay']:.3e}, {control} "
                          f"{dist[control]:.3e}")
        del rows
        if cuda:
            torch.cuda.empty_cache()
    return report, errors


# ---------------------------------------------------------------------------
# Phase 7: the forward kernel's per-stage ablation
# ---------------------------------------------------------------------------

ABLATION_SHAPES = [  # (label, B, H_q, H_kv, N, D, num_sink, window)
    ("headline", 1, 32, 8, 8192, 128, 4, 4096),
    ("gpt-oss-20b sliding", 4, 64, 8, 1024, 64, 0, 128),
    ("gpt-oss-20b full", 4, 64, 8, 1024, 64, 0, 1024)]
ABLATION_CORRECT = ("general", "maskadd", "masksel")


def _ablation_check(q, k, v, stage, ns, W, ref):
    """One stage's kernel against its plain version on the same inputs:
    NaN in the same places, then the finite values (a stripped stage
    within 2e-2 of max |plain|; a correct stage within FLASH_TOL of plain
    and of the forward kernel ``ref``, on its finite rows)."""
    from sink_attention_tpu_torch.ops import ablation
    got = ablation.ablation_kernel(q, k, v, stage, ns, W).float()
    plain = ablation.ablation_plain(q, k, v, stage, ns, W).float()
    torch.cuda.synchronize()
    nan = plain.isnan()
    fin = ~nan
    err = float((got - plain)[fin].abs().max())
    scale = float(plain[fin].abs().max())
    res = {"max_abs_err": err, "max_plain": scale,
           "nan_rows": int(nan.any(-1).sum()),
           "nan_same": bool(torch.equal(got.isnan(), nan))}
    if stage in ABLATION_CORRECT:
        res["tol"] = FLASH_TOL
        res["vs_flash"] = float((got - ref.float())[fin].abs().max())
        res["ok"] = (res["nan_same"] and err <= FLASH_TOL
                     and res["vs_flash"] <= FLASH_TOL)
    else:
        res["tol"] = FLASH_TOL * scale
        res["ok"] = res["nan_same"] and err <= res["tol"]
    return res


def _ablation_bound(stage, B, H_q, H_kv, N, D, ns, W):
    """(bound ms, bound_by) of one stage: a correct stage's FLOPs are
    those of the visible pairs, a stripped stage's those of every cell of
    the visited tiles (it sums over them, masked cells included), 4 D per
    cell (QK^T and PV); bytes: q, k, v read and out written once (and the
    mask tiles)."""
    from sink_attention_tpu_torch.ops import ablation
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                attention_pairs)
    if stage in ABLATION_CORRECT:
        cells = attention_pairs(N, N, ns, W)
    else:
        cells = int(ablation.visited_blocks(N, ns, W)[1].sum()) * 64 * 64
    flops = 4 * D * B * H_q * cells
    nbytes = 2 * (2 * B * H_q * N * D + 2 * B * H_kv * N * D)
    nbytes += {"maskadd": 2 * 64 * 64 * 2, "masksel": 64 * 64}.get(stage, 0)
    t_ops, t_bytes = flops / H100_PEAK_BF16 * 1e3, nbytes / H100_HBM_BW * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def ablation_phase(dev):
    """Phase 7: every ablation stage at the JAX script's headline shape and
    at gpt-oss-20b's two prefill shapes. Each stage's kernel is held to its
    plain version (and the correct stages to the forward kernel); then the
    entry point's table (sink_attention_tpu_torch.scripts.mfu_ablation:
    each stage timed, the mask stages held to the production forward, then
    "full") runs at each shape with the launch counters set to 0 just
    before it and read just after; then the plain versions', SDPA's (the
    correct stages' yardstick) and the bounds. Returns (rows by shape,
    launches, errors)."""
    from sink_attention_tpu_torch.ops import ablation, flash
    from sink_attention_tpu_torch.ops.reference import sink_window_mask
    from sink_attention_tpu_torch.scripts import mfu_ablation
    from sink_attention_tpu_torch.utils import time_cuda

    errors, rows, inputs = [], {}, {}
    for i, (label, B, H_q, H_kv, N, D, ns, W) in enumerate(ABLATION_SHAPES):
        q, k, v = mfu_ablation.make_inputs(N, 7 + i, dev, B, H_q, H_kv, D)
        inputs[label] = (q, k, v)
        ref = flash.flash_fwd_kernel(q, k, v, None, ns, W)[0]
        rows[label] = {st: _ablation_check(q, k, v, st, ns, W, ref)
                       for st in ablation.STAGES}
        del ref

    ablation.ablation_kernel.launches = 0
    ablation.ablation_kernel.launches_mask_stage = 0
    tables = {label: mfu_ablation.stage_table(*inputs[label], ablation.STAGES,
                                              ns, W)
              for label, *_, ns, W in ABLATION_SHAPES}
    launches = {"ablation": ablation.ablation_kernel.launches,
                "mask_stage": ablation.ablation_kernel.launches_mask_stage}

    for label, B, H_q, H_kv, N, D, ns, W in ABLATION_SHAPES:
        q, k, v = inputs[label]
        shape = f"B={B} H={H_q}/{H_kv} N={N} D={D} sink={ns} W={W}"
        mask = sink_window_mask(N, N, ns, W, device=dev)
        library_ms = time_cuda(lambda: _sdpa(q, k, v, mask), iters=10)
        log(f"ablation table [{label}: {shape}]:")
        for line in mfu_ablation.format_rows(tables[label]):
            log("  " + line)
        for t in tables[label]:
            st = t["stage"]
            if st == "full":
                rows[label]["full"] = {"ms": t["ms"], "mfu": t["mfu"],
                                       "library_ms": library_ms}
                continue
            r = rows[label][st]
            r.update(shape=shape, ms=t["ms"], mfu=t["mfu"],
                     delta_ms=t["delta_ms"],
                     library_ms=library_ms if st in ABLATION_CORRECT
                     else None)
            r["plain_ms"] = time_cuda(lambda: ablation.ablation_plain(
                q, k, v, st, ns, W), iters=2, warmup=1)
            r["bound_ms"], r["bound_by"] = _ablation_bound(st, B, H_q, H_kv,
                                                           N, D, ns, W)
            log(f"ablation {st} [{label}: {shape}]: max_abs_err="
                f"{r['max_abs_err']:.3e} (tol {r['tol']:.3e}, max |plain| "
                f"{r['max_plain']:.3e}) nan_rows={r['nan_rows']} "
                f"nan_same={r['nan_same']}"
                + (f" vs_flash={r['vs_flash']:.3e}" if "vs_flash" in r
                   else "")
                + f" ok={r['ok']} ms={r['ms']:.4f} eff_mfu="
                f"{r['mfu'] * 100:.2f}% delta_ms="
                + ("none" if r["delta_ms"] is None else
                   f"{r['delta_ms']:+.4f}")
                + f" plain_ms={r['plain_ms']:.4f} library_ms="
                + ("none" if r["library_ms"] is None else
                   f"{r['library_ms']:.4f}")
                + f" bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
            if not r["ok"]:
                errors.append(f"ablation {st} [{label}] disagrees with its "
                              f"plain version: {r['max_abs_err']:.3e}")
        del mask
    # `full` is the wgmma/TMA forward; `maskadd` and `masksel` compute the
    # same function on the old mma.sync skeleton: before and after, one call
    log("forward, new kernel (full) against the old skeleton on the same "
        "function (maskadd, masksel), ms: " + "; ".join(
            f"{label} {rows[label]['full']['ms']:.4f} vs "
            f"{rows[label]['maskadd']['ms']:.4f}, "
            f"{rows[label]['masksel']['ms']:.4f} (x"
            f"{rows[label]['maskadd']['ms'] / rows[label]['full']['ms']:.2f})"
            for label, *_ in ABLATION_SHAPES))
    for name, n in launches.items():
        if n <= 0:
            errors.append(f"{name} launched {n} times in phase 7")
    return rows, launches, errors


def ablation_entries(rows, launches):
    """The two ablation kernels' entries of the kernels line: launches in
    phase 7's main path, the worst error over its three shapes, and the
    means over each kernel's stages at the headline shape (per-stage ms
    beside them)."""
    from sink_attention_tpu_torch.ops import ablation
    csrc = "sink_attention_tpu_torch/ops/csrc/ablation.cu"
    head = rows["headline"]
    out = []
    for name, line, stages in (
            ("ablation", 80, [s for s in ablation.STAGES
                              if s not in ablation.MASK_STAGES]),
            ("mask_stage", 179, list(ablation.MASK_STAGES))):
        mean = lambda key: sum(head[s][key] for s in stages) / len(stages)
        lib = head[stages[0]]["library_ms"]
        out.append({
            "name": name, "route": "cuda", "source": csrc,
            "replaces": f"scripts/mfu_ablation.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(r[s]["max_abs_err"] for r in rows.values()
                               for s in stages),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": head[stages[0]]["bound_by"],
            "library_ms": lib if name == "mask_stage" else None,
            "stage_ms": {s: head[s]["ms"] for s in stages}})
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    try:
        from sink_attention_tpu_torch.models import ModelConfig
        from sink_attention_tpu_torch.ops import _build
        from sink_attention_tpu_torch.utils import card_line
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"card: {card}")

    # 1. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, rep in _build.build_report.items():
        log(f"build {name}.cu: {rep['seconds']:.1f} s"
            f"{' (cached)' if rep['cached'] else ''}")
        for line in rep["ptxas"]:
            log(f"  {line}")

    # 2. kernels
    errors = []
    kern = kernel_phase(dev)
    for key, rows in kern.items():
        for r in rows if isinstance(rows, list) else [rows]:
            if not r["ok"]:
                errors.append(f"{key} [{r['shape']}] disagrees with its "
                              f"plain version: {r['max_abs_err']:.3e}")
            kpc = r.get("kernels_per_call", 1)
            if key.startswith("decode") and not 0 < kpc <= 1:
                errors.append(f"{key} [{r['shape']}] issues "
                              f"{r['kernels_per_call']:g} device kernels "
                              "per call, not 1")
    dec = [r for key, rows in kern.items() if key.startswith("decode")
           for r in (rows if isinstance(rows, list) else [rows])]
    log(f"decode rows below SDPA's library_ms: "
        f"{sum(r['ms'] < r['library_ms'] for r in dec)} of {len(dec)}; "
        f"device_ms {min(r['device_ms'] for r in dec):.4f}-"
        f"{max(r['device_ms'] for r in dec):.4f}")
    errors += sync_check(dev)
    torch.cuda.empty_cache()

    # 3. serving
    cfg = ModelConfig.gpt_oss_20b()
    report, serr = serve(cfg, dev)
    errors += serr
    log("serving gpt-oss-20b (24 layers, bf16, 4 x 1024 prompt, 32 new): "
        + json.dumps(report))
    launches = report["launches"]
    # one prefill launch per layer; one decode launch per layer and step
    want = {"flash_fwd": cfg.num_layers, "decode": cfg.num_layers * 31}
    for name, n in want.items():
        if launches[name] != n:
            errors.append(f"{name} launched {launches[name]} times in "
                          f"greedy_generate, expected {n}")

    torch.cuda.empty_cache()

    # 4. training
    tcfg = ModelConfig.gpt_oss_20b(num_layers=4)
    treport, terr = train(tcfg, dev)
    errors += terr
    log("training gpt-oss-20b (4 of 24 layers at full width, bf16, 1 x 4096 "
        "tokens, SGD, remat): " + json.dumps(treport))
    # per step with remat: each layer's forward twice (the step and its
    # recompute in the backward), its dQ and dK/dV once
    steps = len(treport["steps"])
    want = {"flash_fwd": steps * 2 * tcfg.num_layers,
            "flash_dq": steps * tcfg.num_layers,
            "flash_dkdv": steps * tcfg.num_layers}
    for name, n in want.items():
        if treport["launches"][name] != n:
            errors.append(f"{name} launched {treport['launches'][name]} "
                          f"times in {steps} training steps, expected {n}")

    torch.cuda.empty_cache()

    # 5. packed training
    preport, perr = train_packed(tcfg, dev)
    errors += perr
    log("packed training gpt-oss-20b (4 of 24 layers at full width, bf16, "
        "1 pack of 4096 tokens, SGD): " + json.dumps(preport))
    # per step, no remat: each layer's packed forward, dQ and dK/dV once;
    # the unpacked kernels not at all
    steps = len(preport["steps"])
    want = {name: steps * tcfg.num_layers if name.startswith("packed") else 0
            for name in preport["launches"]}
    for name, n in want.items():
        if preport["launches"][name] != n:
            errors.append(f"{name} launched {preport['launches'][name]} "
                          f"times in {steps} packed training steps, "
                          f"expected {n}")

    torch.cuda.empty_cache()

    # 6. continuous-batching serving, int8, fp8 and bf16 KV caches
    ereport, eerr = serve_engine(cfg, dev)
    errors += eerr
    log("continuous batching gpt-oss-20b (24 layers, bf16 weights, 8 "
        "requests in 4 slots, prompts 64-1024, 16-32 new tokens, max_len "
        "2048; int8, fp8, bf16 KV): " + json.dumps(ereport))

    csrc = "sink_attention_tpu_torch/ops/csrc/"
    sources = {  # name: (source, TPU kernel it replaces, main-path launches)
        "flash_fwd": (csrc + "flash_fwd.cu",
                      "sink_attention_tpu/ops/flash.py:280",
                      launches["flash_fwd"]),
        "decode": (csrc + "decode.cu", "sink_attention_tpu/ops/decode.py:89",
                   launches["decode"]),
        "decode_int8": (csrc + "decode.cu",
                        "sink_attention_tpu/ops/decode.py:89",
                        ereport["int8"]["launches"]["decode_int8"]),
        "decode_fp8": (csrc + "decode.cu",
                       "sink_attention_tpu/ops/decode.py:89",
                       ereport["fp8"]["launches"]["decode_fp8"]),
        "flash_dq": (csrc + "flash_bwd.cu",
                     "sink_attention_tpu/ops/flash.py:451",
                     treport["launches"]["flash_dq"]),
        "flash_dkdv": (csrc + "flash_bwd.cu",
                       "sink_attention_tpu/ops/flash.py:576",
                       treport["launches"]["flash_dkdv"]),
        "packed_fwd": (csrc + "packed.cu",
                       "sink_attention_tpu/ops/packed.py:190",
                       preport["launches"]["packed_fwd"]),
        "packed_dq": (csrc + "packed.cu",
                      "sink_attention_tpu/ops/packed.py:265",
                      preport["launches"]["packed_dq"]),
        "packed_dkdv": (csrc + "packed.cu",
                        "sink_attention_tpu/ops/packed.py:314",
                        preport["launches"]["packed_dkdv"])}
    kernels = []
    for name, (src, repl, n_launch) in sources.items():
        rows = kern[name]  # the main path's shapes, one launch each
        mean = lambda key: sum(r[key] for r in rows) / len(rows)
        bound_by = {r["bound_by"] for r in rows}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": n_launch,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": bound_by.pop() if len(bound_by) == 1 else
            max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": mean("library_ms")})
        if "device_ms" in rows[0]:  # the redesigned kernels' own time
            kernels[-1].update(device_ms=mean("device_ms"),
                               kernels_per_call=mean("kernels_per_call"))
    # the forward kernel also runs on the training and engine paths, the
    # bf16 decode on the engine path
    kernels[0]["launches_training"] = treport["launches"]["flash_fwd"]
    kernels[0]["launches_engine"] = sum(
        ereport[k]["launches"]["flash_fwd"] for k in ("int8", "fp8",
                                                      "bfloat16"))
    kernels[1]["launches_engine"] = ereport["bfloat16"]["launches"]["decode"]

    torch.cuda.empty_cache()

    # 7. the forward kernel's per-stage ablation
    t0 = time.perf_counter()
    arows, alaunch, aerr = ablation_phase(dev)
    errors += aerr
    log(f"ablation phase: {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps(alaunch)}")
    kernels += ablation_entries(arows, alaunch)

    if errors:
        for e in errors:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
