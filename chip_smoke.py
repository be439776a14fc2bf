#!/usr/bin/env python3
"""Drive the PyTorch port (sink_attention_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py    # build, kernel checks, serving, training,
                             # packed training, continuous batching,
                             # the forward kernel's ablation, beam search
                             # and speculative decoding, quantized weights,
                             # serving from a checkpoint, sequence-parallel
                             # attention, tensor, pipeline and FSDP
                             # parallelism, head dims 80, 256, 512 and
                             # 1024, the accuracy tables, the traces and
                             # the examples

Phases:
  1. build: compile every CUDA kernel of the port (nvcc, sm_90a) and print
     the build time and ptxas' register / shared-memory / spill lines (no
     instance of a wgmma kernel, the forward, dQ, dK/dV or an ablation
     stage of the forward, may spill, nor a decode instance past its
     recorded allowance, DECODE_SPILL_ALLOWANCE);
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
     decode also at MQA 32/1 and 64/1, over a full layer's cache early
     in its life and at B = 1 over a 32768-slot cache (D = 64 and 128,
     D = 128 also in int8, D = 256 and 1024), each row with the plan it
     launched (``decode_plan``: the short rows' instance or the deep one,
     n_split and split_slots); the backward kernels also run twice on
     the same inputs and must agree bit for bit; the dQ and dK/dV rows,
     unpacked and packed, and the packed forward's also carry
     ``device_ms`` and their effective MFU; dQ and dK/dV also run at GQA
     group 1 and 16 and at N_q = 250; then a warmed call each of the
     cached decode, the ragged decode, the forward, the dQ and the dK/dV
     kernel (unpacked, packed) under
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
     mask-stage kernels: every stage of scripts/mfu_ablation.py as a
     softmax policy of the wgmma/TMA forward, at its 128 x 128 tiles) at
     the JAX script's headline shape and at gpt-oss-20b's two prefill
     shapes: each stage against its plain version (the correct ones also
     against the forward kernel), then the entry point's table of ms,
     effective MFU and deltas, with each stage's device time per call
     without the host's gaps (``queued_ms``) and its cost over
     ``mxu_floor``, the plain versions' times, SDPA for the correct
     stages and each stage's bound, and one line of the forward (``full``)
     against its mask stages (``maskadd``, ``masksel``: the same function
     with the JAX script's constant-tile masks) at the three shapes (see
     ``ablation_phase``).
  8. beam search and speculative decoding: gpt-oss-20b at full width, 24
     layers, the same weights and one 1024-token prompt: beam_generate
     (4 beams, 32 tokens) against greedy and a re-scoring; then, with
     layers 1-23 scaled by 0.1 and layer 0 as the draft,
     speculative_generate (4 drafts, 64 tokens) against greedy, the
     multi-token op against the decode kernel, and the speculative
     ContinuousBatchingEngine over bf16 and int8 KV beside the plain
     engine (see ``serve_spec``).
  9. quantized weights: the model's int8 and packed-int4 matmuls at their
     real shapes (the lm_head, gate_up and down at 32 and 128 experts)
     against an fp32 dequantised reference (see ``quant_op_gates``);
     then gpt-oss-20b at full width, 6 of its 24 layers, in bf16, in int8
     (quantize_params in place) and in int4 (init_quantized_params), and
     gpt-oss-120b at full width, 36 layers, 128 experts, in int4 (the
     only form that fits the card): each tree's bytes and peak memory,
     and ContinuousBatchingEngine at 1 and 8 slots (scripts/bench_suite.py's
     int4serve_table): ms a token, tokens/s, a profiled chunk's device
     time and idle share, launch counts; before each engine row, at its
     shapes, every layer's attention kernel against plain and three
     layers against their weights dequantised to bf16 (see
     ``serve_quant``).
  10. serving from a checkpoint: a random gpt-oss-20b checkpoint (12 of
     its 24 layers) written in the released layout (bf16 dense tensors, MXFP4
     experts, one safetensors shard per layer) to a temporary directory;
     load_hf_checkpoint in bf16, every dense leaf and three layers'
     experts held bit for bit to what was written; the loaded tree served
     by ContinuousBatchingEngine (phase 6's requests) with every layer's
     decode attention against plain on a replay; an engine snapshot
     (save_state) resumed in a fresh engine (load_state) to exactly the
     uninterrupted run's tokens, a sampled request among them; the golden
     protocol (scripts/golden_gpt_oss.py: the kernel stack strictly closer
     to plain eager attention than the full-causal ablation); the int4
     streaming load against post-hoc quantization, its device peak below
     the bf16 tree's, and one int4 engine row (see ``serve_checkpoint``).
  11. sequence-parallel attention over torch.distributed: at
     gpt-oss-20b's attention width (B=1, H 64/8, D=64, bf16, random s_aux,
     N=65536), sharded_sink_flash_attention (halo SP at W=128, the ring's
     full rotation at W=N), ring_sink_flash_attention (skip-ahead with the
     sink partial), sp_sink_flash_attention (the sink broadcast) and
     ulysses_sink_flash_attention (plain and packed), forward and backward,
     in worlds of 1 (NCCL), 2 and 4 (gloo) ranks, one spawned process per
     rank, all on the one card: each rank's output and gradient slices and
     d s_aux summed over the ranks against the single-process kernel over
     the whole sequence, each rank's forward and backward ms and launches
     (see ``sp_phase``).
  12. tensor, pipeline and FSDP parallelism over a device mesh: gpt-oss-20b
     at full width, one spawned process per rank over gloo, all on the
     one card, weights drawn sharded from phases 3 and 4's seed: 12a
     make_sharded_generate at TP 4 and 2 (24 layers, phase 3's 4 x 1024
     prompt, 16 new tokens; bf16 KV, and int8 at TP 2); 12b the mesh
     make_train_step (4 layers, 2 x 2048 tokens, one SGD step, remat) over
     (data, seq, model) = (2, 1, 2) with FSDP and (1, 2, 2); 12c
     make_pp_train_step over (pipe, model) = (2, 2), S=2, M=2. Per rank:
     ms per prefill, decode step or train step, peak memory, parameter
     bytes, launches; each rank's attention kernel against plain, the
     logits, tokens, losses and gradients against the unsharded model's
     (see ``mesh_phase``).
  13. every head_dim up to 128 and fp32: an H2O-Danube-1.8B-shaped model
     (head_dim 80) at full width and depth, served in bf16, fp32 and over
     int8 KV, trained in fp32 unpacked and packed (see ``danube_phase``).
  14. head_dim 256 and StreamingLLM sinks: a Gemma-2-2B-shaped model
     (head_dim 256, alternating sliding and full layers) at full width and
     depth, served in bf16, over int8 KV and with 4 sinks pinned in every
     sliding layer's cache, trained in bf16 unpacked and packed (see
     ``gemma_phase``); phase 2 also holds rows 1-7 at its shapes.
  15. head_dim 512: the same model widened to head_dim 512 (not a released
     model), 12 of its 26 layers, served in bf16 and over int8 KV, trained
     in bf16 unpacked and packed (see ``wide_phase``); phase 2 also holds
     rows 1-7 at its shapes at D = 512 and 384, the decode in every storage
     (15a).
  16. head_dim 1024 (every D > 512 runs in the wide instance): the same
     model widened to head_dim 1024 (not a released model), 12 of its 26
     layers, served in bf16 and over int8 KV, trained in bf16 unpacked and
     packed (see ``xwide_phase``); phase 2 also holds rows 1-7 at its
     shapes and at D = 640 and 2048, the decode in every storage (16a).
  17. the JAX round's last modules: the six accuracy tables of
     scripts/numerical_accuracy.py (every kernel of rows 1-7 at every
     instance against the fp32 oracle, beside its plain version reading
     its operands as the kernel does; each row within its gate), the
     profiler trace of scripts/capture_trace.py at the headline (1 / 1 +
     1 + 1 / 64 launches in its three sections, each section's device ms
     and idle share) and the examples kernels.py, serve.py (gpt-oss-20b,
     4 layers, 8 tokens) and train.py (a world of 1) (see
     ``accuracy_phase``).
The line before the last is a JSON object of the kernels' numbers; the last
is {"ok": true, "device": {...}}, printed only when every check passed.
Without CUDA, or without the port next to it, the script exits nonzero and
prints no result.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import re
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
# by input dtype (kernel against plain): bf16 as above; fp16 JAX's fp16
# tolerance (tests/test_flash_prefill.py); fp32, which the kernels read as
# bf16, JAX's TPU fp32 tolerance, and the fp32 decode, which computes in
# fp32, JAX's CPU fp32 tolerance (tests/test_decode.py)
FWD_TOL = {torch.bfloat16: FLASH_TOL, torch.float16: 4e-3,
           torch.float32: 6e-3}
LSE_TOLS = {torch.bfloat16: LSE_TOL, torch.float16: LSE_TOL,
            torch.float32: 1e-2}  # fp32: a row of one key sees S's rounding
DECODE_TOLS = {torch.bfloat16: DECODE_TOL, torch.float16: 4e-3,
               torch.float32: 1e-5}
# the precision of the products of the kernels' plain version for an
# input dtype: fp32 is read as bf16 by the attention kernels (the TPU's
# default for fp32), so their fp32 rows are held, as JAX's TPU tests hold
# their kernels, to an oracle at that precision (the exact one's distance
# is reported beside it; the backward's P and dS stay fp32 in both, the
# kernels carrying them as two bf16 terms)
MATMUL_DTYPE = {torch.float32: torch.bfloat16}
PACK_MIN, PACK_MAX = 64, 1536  # segment lengths of the packed training pack
RAGGED_LENS = [1000, 77, 0, 610]  # the ragged decode rows' slots (0: empty)
# the kernels rebuilt for Hopper after their first port, and how
_HOPPER = "wgmma/TMA, warp-specialised, persistent"
_DECODE = ("one launch: the live range split over the card, boxes of whole "
           "rows up to head_dim 128 (one range: no merge), 512-byte row "
           "chunks past it and in fp32; S once a tile, K read once, the "
           "partials merged in the launch")
# the header that holds each wgmma/TMA kernel's template (the source
# instantiates it over its mask policy)
TEMPLATE = {"flash_fwd": "hopper.cuh", "packed_fwd": "hopper.cuh",
            "flash_dq": "hopper_dq.cuh", "packed_dq": "hopper_dq.cuh",
            "flash_dkdv": "hopper_bwd.cuh", "packed_dkdv": "hopper_bwd.cuh",
            "ablation": "hopper.cuh", "mask_stage": "hopper.cuh"}
REDESIGNED = {"flash_fwd": _HOPPER, "flash_dq": _HOPPER, "flash_dkdv": _HOPPER,
              "packed_fwd": _HOPPER, "packed_dq": _HOPPER,
              "packed_dkdv": _HOPPER,
              "ablation": _HOPPER + ", the forward's softmax policy",
              "mask_stage": _HOPPER + ", the forward's softmax policy",
              "decode": _DECODE, "decode_int8": _DECODE,
              "decode_fp8": _DECODE}


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


def check_flash(dev, B, H_q, H_kv, N, D, ns, W, gen, time_n=None,
                dtype=torch.bfloat16):
    """Kernel vs plain at one shape, inputs in ``dtype``; returns a dict of
    numbers. The bound counts the inputs' bytes in their dtype and the
    products at the bf16 tensor-core rate (fp32 is read as bf16)."""
    from sink_attention_tpu_torch.ops import flash
    from sink_attention_tpu_torch.ops.reference import sink_window_mask
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                sink_attention_flops,
                                                time_cuda)

    def inputs(n):
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
        return (mk(B, H_q, n, D), mk(B, H_kv, n, D), mk(B, H_kv, n, D),
                torch.randn(H_q, generator=gen, device=dev))

    q, k, v, aux = inputs(N)
    mm = MATMUL_DTYPE.get(dtype)
    o_k, l_k = flash.flash_fwd_kernel(q, k, v, aux, ns, W)
    o_p, l_p = flash.flash_fwd_plain(q, k, v, aux, ns, W, matmul_dtype=mm)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    lerr = float((l_k - l_p).abs().max())
    res = {"shape": f"B={B} H={H_q}/{H_kv} N={N} D={D} sink={ns} W={W}"
           + _dtype_label(dtype), "max_abs_err": err, "lse_err": lerr,
           "ok": err <= FWD_TOL[dtype] and lerr <= LSE_TOLS[dtype]
           and bool(torch.isfinite(o_k.float()).all())}
    if mm is not None:  # against the exact plain version, for the record
        res["exact_err"] = float((o_k.float() - flash.flash_fwd_plain(
            q, k, v, aux, ns, W)[0].float()).abs().max())
    if time_n is not None and time_n != N:
        q, k, v, aux = inputs(time_n)
        res["timed_N"] = time_n
    n = q.shape[2]
    mask = sink_window_mask(n, n, ns, W, device=dev)
    res["ms"] = time_cuda(lambda: flash.flash_fwd_kernel(q, k, v, aux, ns, W),
                          iters=20)
    res["device_ms"], res["kernels_per_call"] = _device_per_call(
        lambda: flash.flash_fwd_kernel(q, k, v, aux, ns, W), dtype)
    res["plain_ms"] = time_cuda(
        lambda: flash.flash_fwd_plain(q, k, v, aux, ns, W, matmul_dtype=mm),
        iters=3, warmup=1)
    res["library_ms"] = time_cuda(lambda: _sdpa(q, k, v, mask), iters=10)
    flops = sink_attention_flops(B, H_q, n, D, ns, W)
    elem = q.element_size()
    nbytes = elem * (2 * B * H_q * n * D + 2 * B * H_kv * n * D) + (
        4 * B * H_q * n)
    t_ops, t_bytes = flops / H100_PEAK_BF16 * 1e3, nbytes / H100_HBM_BW * 1e3
    res["bound_ms"] = max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return res


QUANT_BUDGET = {"int8": 0.05, "fp8": 0.12}  # vs unquantized KV (JAX tests)


def _device_per_call(fn, dtype, calls=20):
    """(device ms, kernels a call) of a kernel wrapper: per launch
    (``per_call_device``), but for fp32 inputs per call, the kernel and
    the casts that round its inputs to bf16 together."""
    ms, per_call = per_call_device(fn, calls=calls)
    return (ms * per_call if dtype == torch.float32 else ms), per_call


def _dtype_label(dtype):
    """A shape label's dtype suffix: none for bf16, the kernels' main type."""
    return "" if dtype == torch.bfloat16 else " " + str(dtype).replace(
        "torch.", "")


def _decode_caches(dev, B, H_kv, D, ns, W, lengths, appends, gen, quant,
                   dtype=torch.bfloat16):
    """A cache of each storage (bf16, and ``quant`` if given) filled with
    the same seeded KV: a SinkKVCache prefilled with ``lengths`` tokens
    (an int), or, for a list of per-slot lengths, a RaggedSinkKVCache with
    each slot inserted (0 = left empty). Then ``appends`` tokens; in the
    ragged cache slot b skips append i when i % (b + 2) == 0, so the slots
    end at different ring phases, and empty slots stay inactive. The
    unquantized cache holds ``dtype``. Returns ({storage: cache}, lens [B,
    4])."""
    from sink_attention_tpu_torch.cache import RaggedSinkKVCache, SinkKVCache
    from sink_attention_tpu_torch.ops import decode

    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    ragged = isinstance(lengths, (list, tuple))
    kinds = [None] + ([quant] if quant else [])
    cls = RaggedSinkKVCache if ragged else SinkKVCache
    caches = {kd: cls.init(B, H_kv, D, num_sink=ns, window_size=W,
                           dtype=dtype, quant=kd, device=dev)
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


def _plan_label(plan):
    """A decode plan (decode.decode_plan) in a log line: its design (the
    short rows' instance width, or deep), ranges a unit and their slots."""
    return (f"{plan['design']}"
            + (f" D_i={plan['instance']}" if plan["instance"] else "")
            + f" n_split={plan['n_split']} split_slots={plan['split_slots']}")


def check_decode(dev, B, H_q, H_kv, D, ns, W, lengths, appends, gen,
                 quant=None, dtype=torch.bfloat16):
    """The decode kernel of one storage (``dtype``, or ``quant`` beside
    bf16) against its plain version over a filled cache (see
    _decode_caches: ``lengths`` a list makes it ragged); a quantized kernel
    also against the bf16 kernel over the unquantized KV, within the JAX
    tests' budget. Returns numbers; the library yardstick is SDPA over the
    (dequantized) cache in q's dtype with the live mask; the bound counts
    fp32's products at the card's fp32 rate (the fp32 decode runs on the
    CUDA cores)."""
    from sink_attention_tpu_torch.ops import decode
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                H100_PEAK_FP32,
                                                H100_PEAK_INT8, time_cuda)

    caches, lens = _decode_caches(dev, B, H_kv, D, ns, W, lengths, appends,
                                  gen, quant, dtype)
    cache = caches[quant]
    q = torch.randn(B, H_q, 1, D, generator=gen, device=dev).to(dtype)
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
                f"live={n_live // B}") + _dtype_label(dtype))
    res = {"shape": shape, "max_abs_err": err,
           "ok": err <= DECODE_TOLS[dtype]
           and bool(torch.isfinite(o_k.float()).all())}
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
    res["plan"] = decode.decode_plan(q, cache.k, state,
                                     sink_cap=cache.sink_cap,
                                     window_size=cache.window_size)
    res["plain_ms"] = time_cuda(lambda: decode.decode_plain(
        q, cache.k, cache.v, lens, aux, **kw), iters=10)
    kf, vf = (t.to(q.dtype) for t in cache.dequant_kv())
    mask = live[:, None, None, :]
    res["library_ms"] = best(lambda: _sdpa(q, kf, vf, mask), 20)
    del kf, vf
    flops = 4 * H_q * n_live * D
    elem = q.element_size()
    # K and V of one live slot
    slot_bytes = 2 * D + 8 if quant else 2 * elem * D
    nbytes = H_kv * n_live * slot_bytes + 2 * elem * B * H_q * D + 16 * B
    peak = (H100_PEAK_INT8 if quant else H100_PEAK_FP32
            if dtype == torch.float32 else H100_PEAK_BF16)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_HBM_BW * 1e3
    res["bound_ms"] = max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return res


def check_bwd(dev, B, H_q, H_kv, N, D, ns, W, gen, time_n=None, halo=0,
              use_aux=True, dtype=torch.bfloat16):
    """dQ and dK/dV kernels vs flash_bwd_plain at one shape, on the same
    (q, k, v, dO, lse, delta) in ``dtype``; ``halo`` garbage slots before
    the KV put the chunk at kv_offset = -halo. Returns rows "flash_dq",
    "flash_dkdv" and "flash_bwd" (the two together, against SDPA's
    backward); the dQ and dK/dV rows also have the kernel's own device
    time per launch and its effective MFU over the visible pairs. The
    bound counts the inputs' bytes in their dtype, the products at the
    bf16 rate."""
    from sink_attention_tpu_torch.ops import flash
    from sink_attention_tpu_torch.ops.reference import sink_window_mask
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                attention_pairs, time_cuda)

    geom = (ns, W, 0, -halo)

    def inputs(n):
        mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
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
    mm = MATMUL_DTYPE.get(dtype)
    dq = flash.flash_dq_kernel(*x, *geom)
    dk, dv = flash.flash_dkdv_kernel(*x, *geom)
    ref = flash.flash_bwd_plain(*x, *geom, matmul_dtype=mm)
    exact = (flash.flash_bwd_plain(*x, *geom) if mm is not None
             else None)
    dq2 = flash.flash_dq_kernel(*x, *geom)
    dk2, dv2 = flash.flash_dkdv_kernel(*x, *geom)
    torch.cuda.synchronize()
    shape = (f"B={B} H={H_q}/{H_kv} N={N} D={D} sink={ns} W={W}"
             + (" s_aux" if use_aux else "")
             + (f" kv_offset=-{halo}" if halo else "") + _dtype_label(dtype))
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
        if exact is not None:  # against the exact plain version
            refs_x = exact[:1] if name == "flash_dq" else exact[1:]
            rows[name]["exact_rel_err"] = max(
                _grad_compare(g, r)["rel_err"] for g, r in zip(got, refs_x))
    del dq, dk, dv, ref, dq2, dk2, dv2, exact

    if time_n is not None and time_n != N:
        x = inputs(time_n)
        for r in rows.values():
            r["timed_N"] = time_n
    n = x[0].shape[2]
    n_kv = n + halo
    rows["flash_dkdv"]["pieces"] = dkdv_pieces(flash, n, n_kv, geom, D)
    rows["flash_dq"]["ms"] = time_cuda(
        lambda: flash.flash_dq_kernel(*x, *geom), iters=10)
    rows["flash_dkdv"]["ms"] = time_cuda(
        lambda: flash.flash_dkdv_kernel(*x, *geom), iters=10)
    for name, fn in (("flash_dq", flash.flash_dq_kernel),
                     ("flash_dkdv", flash.flash_dkdv_kernel)):
        rows[name]["device_ms"], rows[name]["kernels_per_call"] = \
            _device_per_call(lambda: fn(*x, *geom), dtype, calls=10)
    plain_ms = time_cuda(lambda: flash.flash_bwd_plain(
        *x, *geom, matmul_dtype=mm), iters=2, warmup=1)
    q, k, v, do = (t.detach().clone().requires_grad_(i < 3)
                   for i, t in enumerate(x[:4]))
    mask = sink_window_mask(n, n_kv, ns, W, 0, -halo, device=dev)
    mask &= torch.arange(n_kv, device=dev) >= halo
    out = _sdpa(q, k, v, mask)
    library_ms = time_cuda(lambda: torch.autograd.grad(
        out, (q, k, v), do, retain_graph=True), iters=5)
    del out, q, k, v, do

    pairs = B * H_q * attention_pairs(n, n_kv, ns, W, 0, -halo)
    elem = x[0].element_size()
    q_bytes = elem * B * H_q * n * D        # one [B, H_q, n, D] tensor
    kv_bytes = elem * B * H_kv * n_kv * D   # one [B, H_kv, n_kv, D]
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
    for name in ("flash_dq", "flash_dkdv"):
        r = rows[name]
        r["mfu"] = pairs * work[name][0] / H100_PEAK_BF16 * 1e3 / r[
            "device_ms"]
    return rows


def dkdv_pieces(flash, n_q, n_kv, geom, D):
    """The pieces of the dK/dV kernel's work at a shape (its piece table's
    count; a split key block counts each of its pieces)."""
    from sink_attention_tpu_torch.ops import _build
    bn = flash.DKDV_BNS[_build.kernel_head_dim(_build.padded_head_dim(D))]
    return int(flash.dkdv_piece_table(n_q, n_kv, *geom, flash.DKDV_BM,
                                      bn)[0, 0])


def packed_pairs(positions, num_sink, window):
    """Visible (query, key) pairs of one head over the packed mask of
    ``positions`` [B, N], summed over the batch."""
    from sink_attention_tpu_torch.ops.reference import packed_rows_mask
    n = positions.shape[-1]
    return sum(int(packed_rows_mask(positions, r0, min(1024, n - r0),
                                    num_sink, window).sum())
               for r0 in range(0, n, 1024))


def check_packed(dev, B, H_q, H_kv, D, ns, W, lens, gen, first=0,
                 use_aux=True, label="", dtype=torch.bfloat16):
    """The packed forward, dQ and dK/dV kernels against their plain
    versions on one pack (the same positions in every batch row), inputs
    in ``dtype`` (the plain versions' products at the kernels' precision,
    as check_flash's), dQ and dK/dV also bitwise against a second run.
    Returns rows "packed_fwd", "packed_dq", "packed_dkdv" with errors,
    times and bounds (FLOPs from the visible pairs of the pack's own mask,
    the inputs' bytes in their dtype), each also with the kernel's own
    device time per launch (per call with its casts, for fp32) and its
    effective MFU."""
    from sink_attention_tpu_torch.ops.packed import pack_positions
    from sink_attention_tpu_torch.ops import packed
    from sink_attention_tpu_torch.ops.reference import packed_sink_window_mask
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                time_cuda)

    positions = pack_positions(lens, first)[None].expand(B, -1).to(dev)
    N = positions.shape[1]
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)
    q, do = mk(B, H_q, N, D), mk(B, H_q, N, D)
    k, v = mk(B, H_kv, N, D), mk(B, H_kv, N, D)
    aux = torch.randn(H_q, generator=gen, device=dev) if use_aux else None
    geom = (ns, W)
    mm = MATMUL_DTYPE.get(dtype)
    o_k, l_k = packed.packed_fwd_kernel(q, k, v, positions, aux, *geom)
    o_p, l_p = packed.packed_fwd_plain(q, k, v, positions, aux, *geom,
                                       matmul_dtype=mm)
    delta = (do.float() * o_k.float()).sum(-1)
    args = (q, k, v, do, l_k, delta, positions, *geom)
    dq = packed.packed_dq_kernel(*args)
    dk, dv = packed.packed_dkdv_kernel(*args)
    ref = packed.packed_bwd_plain(*args, matmul_dtype=mm)
    dq2 = packed.packed_dq_kernel(*args)
    dk2, dv2 = packed.packed_dkdv_kernel(*args)
    torch.cuda.synchronize()
    shape = (f"B={B} H={H_q}/{H_kv} N={N} D={D} sink={ns} W={W}"
             + (" s_aux" if use_aux else "") + f" {label}"
             + _dtype_label(dtype))
    err = float((o_k.float() - o_p.float()).abs().max())
    lerr = float((l_k - l_p).abs().max())
    rows = {"packed_fwd": {
        "shape": shape, "max_abs_err": err, "lse_err": lerr,
        "ok": err <= FWD_TOL[dtype] and lerr <= LSE_TOLS[dtype]
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

    rows["packed_dkdv"]["pieces"] = int(packed.packed_tables(
        positions, ns, W, D).kv_pieces[0, 0])
    rows["packed_fwd"]["ms"] = time_cuda(
        lambda: packed.packed_fwd_kernel(q, k, v, positions, aux, *geom),
        iters=10)
    rows["packed_dq"]["ms"] = time_cuda(
        lambda: packed.packed_dq_kernel(*args), iters=10)
    rows["packed_dkdv"]["ms"] = time_cuda(
        lambda: packed.packed_dkdv_kernel(*args), iters=10)
    for name, fn in (
            ("packed_fwd", lambda: packed.packed_fwd_kernel(
                q, k, v, positions, aux, *geom)),
            ("packed_dq", lambda: packed.packed_dq_kernel(*args)),
            ("packed_dkdv", lambda: packed.packed_dkdv_kernel(*args))):
        rows[name]["device_ms"], rows[name]["kernels_per_call"] = \
            _device_per_call(fn, dtype, calls=10)
    rows["packed_fwd"]["plain_ms"] = time_cuda(
        lambda: packed.packed_fwd_plain(q, k, v, positions, aux, *geom,
                                        matmul_dtype=mm),
        iters=2, warmup=1)
    bwd_plain_ms = time_cuda(lambda: packed.packed_bwd_plain(
        *args, matmul_dtype=mm), iters=2, warmup=1)
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
    elem = q.element_size()
    q_bytes = elem * B * H_q * N * D    # one [B, H_q, N, D] tensor
    kv_bytes = elem * B * H_kv * N * D  # one [B, H_kv, N, D]
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
    for name, r in rows.items():
        r["mfu"] = pairs * work[name][0] / H100_PEAK_BF16 * 1e3 / r[
            "device_ms"]
    return rows


def kernel_phase(dev):
    from sink_attention_tpu_torch.ops.packed import pack_lengths
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
    # the dQ and dK/dV kernels at GQA group 1 and 16, and at N_q = 250
    # (not a multiple of 4 or 64)
    bwd_more = [check_bwd(dev, 1, h_q, h_kv, n, 64, 4, w, gen)
                for h_q, h_kv, n, w in ((8, 8, 2048, 2048),
                                        (64, 4, 2048, 2048),
                                        (64, 8, 250, 128))]
    # packed training path: phase 5's pack of 4096 tokens through the
    # sliding (W=128) and full layers; the headline shape over segments of
    # 64-3072 tokens; edge cases at N=1024 with 4 sinks, and edge cases of
    # the forward's 128-row items and 64-row consumer halves at both head
    # dims, with and without s_aux
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
    packed_edge += [
        check_packed(dev, 1, 8, 2, d, 4, w, lens, gen, use_aux=aux,
                     label=lab)
        for d in (64, 128) for aux in (True, False)
        for lens, w, lab in (
            ([200, 824], 128, "a start inside a 64-row half"),
            ([256, 768], 1024, "a start at a 128-row item boundary"),
            ([500, 1, 523], 128, "a 1-token segment"))]
    # phase 13's H2O-Danube-1.8B shapes: head_dim 80 in the forward's,
    # dQ's and dK/dV's narrow 80 instance, bf16 and fp32 (read as bf16):
    # the serving prefill (2 x 8192 tokens,
    # W = 4096, no sinks), the training step's backward (1 x 8192), the
    # decode over a wrapped 4096-slot window in bf16, fp32 and int8
    dan = (torch.bfloat16, torch.float32)
    flash_danube = [check_flash(dev, 2, 32, 8, 8192, 80, 0, 4096, gen,
                                dtype=dt) for dt in dan]
    bwd_danube = [check_bwd(dev, 1, 32, 8, 8192, 80, 0, 4096, gen,
                            use_aux=False, dtype=dt) for dt in dan]
    decode_danube = [check_decode(dev, 2, 32, 8, 80, 0, 4096, 8192, 16, gen,
                                  dtype=dt) for dt in dan]
    # the narrow instances at Phi-3-mini's attention (32/32 heads, head_dim
    # 96 in the 96 instance): the prefill (2 x 4096) full and at W = 2048
    # with 4 sinks, the training backward (1 x 4096), a pack of 2 x 2048,
    # the sink row also in fp32; D = 72 (the 80 instance) and 88 (the 96
    # instance), their columns past D zero-filled, at N = 2048 (fp32 at
    # these head dims: the Danube rows above and the card tests)
    bf, f32 = torch.bfloat16, torch.float32
    narrow = [(96, 4096, 0, 4096, bf), (96, 4096, 4, 2048, bf),
              (96, 4096, 4, 2048, f32), (72, 2048, 4, 2048, bf),
              (88, 2048, 4, 2048, bf)]
    flash_narrow = [check_flash(dev, 2, 32, 32, n, d, ns, w, gen, dtype=dt)
                    for d, n, ns, w, dt in narrow]
    bwd_narrow = [check_bwd(dev, 1, 32, 32, n, d, ns, w, gen, dtype=dt)
                  for d, n, ns, w, dt in narrow]
    packed_narrow = [check_packed(dev, 1, 32, 32, d, ns, w, [n // 2] * 2,
                                  gen, label=f"2 x {n // 2}", dtype=dt)
                     for d, n, ns, w, dt in narrow]
    # phase 14's Gemma-2-2B shapes: head_dim 256 in the 256 instance, bf16:
    # the serving prefill (2 x 8192 tokens, GQA 8/4) on a sliding (W = 4096)
    # and a full layer, and with 4 StreamingLLM sinks; the training step's
    # backward (1 x 8192); the decode over 4096 live slots in bf16 and int8,
    # and with 4 sinks; the packed step's pack of 2 x 4096. The backward
    # rows also at Gemma 3's local window (W = 1024), with no sinks and with
    # 4 sinks and s_aux (the sink item walks every q block)
    flash_gemma = [check_flash(dev, 2, 8, 4, 8192, 256, ns, w, gen)
                   for ns, w in ((0, 4096), (0, 8192), (4, 4096))]
    gemma_bwd = ((0, 4096), (0, 8192), (0, 1024), (4, 1024))
    bwd_gemma = [check_bwd(dev, 1, 8, 4, 8192, 256, ns, w, gen,
                           use_aux=ns > 0) for ns, w in gemma_bwd]
    decode_gemma = [check_decode(dev, 2, 8, 4, 256, ns, 4096, 8192, 16, gen)
                    for ns in (0, 4)]
    packed_gemma = [check_packed(dev, 1, 8, 4, 256, ns, w, [4096, 4096], gen,
                                 use_aux=ns > 0, label="2 x 4096")
                    for ns, w in gemma_bwd]
    # phase 15a, the widened Gemma-2-2B shapes: head_dim 512 in the 512
    # instance, and 384 (its columns past 384 zero-filled), bf16: the
    # prefill (2 x 8192, GQA 8/4) on a sliding (W = 4096) and a full layer
    # and with 4 StreamingLLM sinks; the training step's backward (1 x
    # 8192); the packed step's pack of 2 x 4096; the decode over 4096 live
    # slots in every storage (bf16 also with 4 sinks); D = 384 the
    # sliding layer with 4 sinks in each
    wide = (512, 384)
    flash_wide = [check_flash(dev, 2, 8, 4, 8192, 512, ns, w, gen)
                  for ns, w in ((0, 4096), (0, 8192), (4, 4096))]
    flash_wide.append(check_flash(dev, 2, 8, 4, 8192, 384, 4, 4096, gen))
    bwd_wide = [check_bwd(dev, 1, 8, 4, 8192, d, ns, w, gen, use_aux=False)
                for d, ns, w in ((512, 0, 4096), (512, 0, 8192),
                                 (384, 4, 4096))]
    packed_wide = [check_packed(dev, 1, 8, 4, d, 0, 4096, [4096, 4096], gen,
                                use_aux=False, label="2 x 4096")
                   for d in wide]
    decode_wide = [check_decode(dev, 2, 8, 4, d, ns, 4096, 8192, 16, gen,
                                dtype=dt)
                   for d, ns, dt in ((512, 0, torch.bfloat16),
                                     (512, 4, torch.bfloat16),
                                     (512, 0, torch.float16),
                                     (512, 0, torch.float32),
                                     (384, 4, torch.bfloat16))]
    # phase 16a, head_dim 1024 in the wide instance, bf16: the prefill (2 x
    # 8192, GQA 8/4) on a sliding (W = 4096) and a full layer and with 4
    # StreamingLLM sinks; the training step's backward (1 x 8192); the
    # packed step's pack of 2 x 4096; the decode over 4096 live slots in
    # bf16, fp32, int8 and fp8; and D = 640 (a part slice) and 2048 (four
    # slices) at N = 2048 with 4 sinks, W = 1024, in each row
    xd = (640, 2048)
    flash_xwide = [check_flash(dev, 2, 8, 4, 8192, 1024, ns, w, gen)
                   for ns, w in ((0, 4096), (0, 8192), (4, 4096))]
    flash_xwide += [check_flash(dev, 2, 8, 4, 2048, d, 4, 1024, gen)
                    for d in xd]
    bwd_xwide = [check_bwd(dev, 1, 8, 4, n, d, ns, w, gen, use_aux=False)
                 for n, d, ns, w in ((8192, 1024, 0, 4096),
                                     (8192, 1024, 0, 8192),
                                     (2048, 640, 4, 1024),
                                     (2048, 2048, 4, 1024))]
    packed_xwide = [check_packed(dev, 1, 8, 4, d, 0, w, lens, gen,
                                 use_aux=False, label=lab)
                    for d, w, lens, lab in (
                        (1024, 4096, [4096, 4096], "2 x 4096"),
                        (640, 1024, [1024, 1024], "2 x 1024"),
                        (2048, 1024, [1024, 1024], "2 x 1024"))]
    decode_xwide = [check_decode(dev, 2, 8, 4, 1024, 0, 4096, 8192, 16, gen,
                                 dtype=dt)
                    for dt in (torch.bfloat16, torch.float32)]
    # dK/dV's sink key blocks cut into pieces over the card, where sink
    # tokens sit beside a short window: the library's defaults (4 sinks, W
    # = 512) at the headline geometry (timed at N = 8192), gpt-oss-20b's
    # sliding layer with 4 sinks, and Gemma 3's local layer (W = 1024) on
    # a pack of 6144 + 2048 with 4 sinks and s_aux
    bwd_split = [check_bwd(dev, 1, 32, 8, 4096, 128, 4, 512, gen,
                           time_n=8192),
                 check_bwd(dev, 1, 64, 8, 4096, 64, 4, 128, gen)]
    packed_split = [check_packed(dev, 1, 8, 4, 256, 4, 1024, [6144, 2048],
                                 gen, label="6144 + 2048")]
    decode_xwide += [check_decode(dev, 2, 8, 4, d, 4, 1024, 2048, 16, gen)
                     for d in xd]
    # the split decode at B = 1 over a long context: the Gemma-2-2B
    # geometry's 4 KV heads over a wrapped 32768-slot window (134 MB of bf16
    # K/V at D = 256), at D = 256 and 1024; a Llama-style D = 128 layer
    # (32/8, 134 MB) and gpt-oss-20b's full layer (64/8, D = 64, 67 MB)
    # over the same window, in the short rows' 128 and 64 instances, and the
    # D = 128 layer's cache in int8
    decode_long = [check_decode(dev, 1, h_q, h_kv, d, 0, 32768, 32768, 16,
                                gen)
                   for h_q, h_kv, d in ((8, 4, 256), (8, 4, 1024),
                                        (32, 8, 128), (64, 8, 64))]
    res = {"flash_fwd": flash_main, "decode": decode_main,
           "flash_fwd_headline": flash_head, "decode_headline": decode_head,
           "decode_more": decode_more, **quant_rows,
           "flash_fwd_danube": flash_danube, "decode_danube": decode_danube,
           "decode_int8_danube": [check_decode(
               dev, 2, 32, 8, 80, 0, 4096, 8192, 16, gen, "int8")],
           "flash_fwd_gemma": flash_gemma, "decode_gemma": decode_gemma,
           "decode_int8_gemma": [check_decode(
               dev, 2, 8, 4, 256, 0, 4096, 8192, 16, gen, "int8")],
           "flash_fwd_wide": flash_wide, "decode_wide": decode_wide,
           **{f"decode_{qn}_wide": [check_decode(
               dev, 2, 8, 4, d, 0, 4096, 8192, 16, gen, qn) for d in wide]
              for qn in ("int8", "fp8")},
           "flash_fwd_xwide": flash_xwide, "decode_xwide": decode_xwide,
           "decode_long": decode_long,
           "decode_int8_long": [check_decode(dev, 1, 32, 8, 128, 0, 32768,
                                             32768, 16, gen, "int8")],
           **{f"decode_{qn}_xwide": [check_decode(
               dev, 2, 8, 4, d, ns, w, n, 16, gen, qn)
               for d, ns, w, n in ((1024, 0, 4096, 8192),
                                   (640, 4, 1024, 2048),
                                   (2048, 4, 1024, 2048))]
              for qn in ("int8", "fp8")}}
    for name in ("flash_dq", "flash_dkdv", "flash_bwd"):
        res[name] = [r[name] for r in bwd_main]
        res[name + "_headline"] = bwd_head[name]
        res[name + "_chunk"] = bwd_chunk[name]
    for name in ("flash_dq", "flash_dkdv"):
        res[name + "_more"] = [r[name] for r in bwd_more]
        res[name + "_split"] = [r[name] for r in bwd_split]
    for name in ("packed_dq", "packed_dkdv"):
        res[name + "_split"] = [r[name] for r in packed_split]
    res["flash_fwd_narrow"] = flash_narrow
    for name in ("flash_dq", "flash_dkdv", "flash_bwd"):
        res[name + "_narrow"] = [r[name] for r in bwd_narrow]
    for name in ("packed_fwd", "packed_dq", "packed_dkdv"):
        res[name + "_narrow"] = [r[name] for r in packed_narrow]
    for name in ("flash_dq", "flash_dkdv", "flash_bwd"):
        res[name + "_danube"] = [r[name] for r in bwd_danube]
        res[name + "_gemma"] = [r[name] for r in bwd_gemma]
        res[name + "_wide"] = [r[name] for r in bwd_wide]
        res[name + "_xwide"] = [r[name] for r in bwd_xwide]
    for name in ("packed_fwd", "packed_dq", "packed_dkdv"):
        res[name + "_gemma"] = [r[name] for r in packed_gemma]
        res[name + "_wide"] = [r[name] for r in packed_wide]
        res[name + "_xwide"] = [r[name] for r in packed_xwide]
        res[name] = [r[name] for r in packed_main]
        res[name + "_headline"] = [r[name] for r in packed_head]
        res[name + "_edge"] = [r[name] for r in packed_edge]
    for key, rows in res.items():
        name = key
        for suffix in ("_headline", "_chunk", "_edge", "_more", "_danube",
                       "_narrow", "_gemma", "_xwide", "_wide", "_long",
                       "_split"):
            name = name.replace(suffix, "")
        for r in rows if isinstance(rows, list) else [rows]:
            log(f"kernel {name} [{r['shape']}"
                + (f", timed at N={r['timed_N']}" if "timed_N" in r else "")
                + f"]: max_abs_err={r['max_abs_err']:.3e}"
                + (f" lse_err={r['lse_err']:.3e}" if "lse_err" in r else "")
                + (f" vs_bf16_err={r['vs_bf16_err']:.3e}"
                   if "vs_bf16_err" in r else "")
                + (f" exact_err={r['exact_err']:.3e}"
                   if "exact_err" in r else "")
                + (f" exact_rel_err={r['exact_rel_err']:.3e}"
                   if "exact_rel_err" in r else "")
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
                + (f" mfu={r['mfu']:.4f}" if "mfu" in r else "")
                + (f" pieces={r['pieces']}" if "pieces" in r else "")
                + (f" plan={_plan_label(r['plan'])}" if "plan" in r else ""))
    return res


def sync_check(dev):
    """One warmed call each of the cached decode, the ragged decode, the
    forward and the dQ and dK/dV kernels, unpacked and packed (gpt-oss-20b's
    shapes) under
    torch.cuda.set_sync_debug_mode("error"): any synchronising CUDA
    operation raises. Returns the errors."""
    from sink_attention_tpu_torch.ops.packed import pack_positions
    from sink_attention_tpu_torch.cache import RaggedSinkKVCache
    from sink_attention_tpu_torch.ops import decode, flash, packed

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
    do = mk(4, 64, 1024, 64)
    o, lse = flash.flash_fwd_kernel(q, k, v, aux, 0, 128)
    delta = (do.float() * o.float()).sum(-1)
    positions = pack_positions([300, 500, 224])[None].expand(4, -1).to(dev)
    bwd = (q, k, v, do, lse, delta)
    # D = 1024: the split decode (its scratch and counters) and the wide
    # forward
    wcaches, _ = _decode_caches(dev, 1, 2, 1024, 0, 512, 300, 1, gen, None)
    wq1 = mk(1, 4, 1, 1024)
    wq, wk, wv = mk(1, 4, 256, 1024), mk(1, 2, 256, 1024), mk(1, 2, 256, 1024)
    calls = {
        "sink_decode_attention_cached": lambda: (
            decode.sink_decode_attention_cached(q1, caches[None], aux)),
        "sink_decode_attention_ragged": lambda: (
            decode.sink_decode_attention_ragged(q1, ragged, aux)),
        "sink_flash_attention": lambda: flash.sink_flash_attention(
            q, k, v, 0, 1024, s_aux=aux),
        "flash_dq_kernel": lambda: flash.flash_dq_kernel(*bwd, 0, 128),
        "flash_dkdv_kernel": lambda: flash.flash_dkdv_kernel(*bwd, 0, 128),
        "packed_fwd_kernel": lambda: packed.packed_fwd_kernel(
            q, k, v, positions, aux, 0, 128),
        "packed_dq_kernel": lambda: packed.packed_dq_kernel(
            *bwd, positions, 0, 128),
        "packed_dkdv_kernel": lambda: packed.packed_dkdv_kernel(
            *bwd, positions, 0, 128),
        # 4 sinks: the sink key blocks cut into pieces (unpacked: a warmed
        # call; packed: fresh positions, so each call builds its tables)
        "flash_dkdv_kernel (4 sinks, split)": lambda: (
            flash.flash_dkdv_kernel(*bwd, 4, 128)),
        "packed_dkdv_kernel (4 sinks, split, fresh positions)": lambda: (
            packed.packed_dkdv_kernel(*bwd, positions.clone(), 4, 128)),
        "sink_decode_attention_cached (D=1024)": lambda: (
            decode.sink_decode_attention_cached(wq1, wcaches[None])),
        "sink_flash_attention (D=1024)": lambda: flash.sink_flash_attention(
            wq, wk, wv, 4, 128)}
    errors = []
    for name, fn in calls.items():
        fn()  # warm: the build, the kernels' tables on the card
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


def _row_cos(a: torch.Tensor, b: torch.Tensor, rows: int = 1024) -> float:
    """Mean over rows of the cosine of logits a, b [..., V], taken
    ``rows`` rows of a batch row at a time to bound the fp32 copies (one
    fp32 copy of 8192 rows of a 256000-token vocabulary is 8.4 GB)."""
    tot, n = 0.0, 0
    for i in range(a.shape[0]):
        ai = a[i].reshape(-1, a.shape[-1])
        bi = b[i].reshape(-1, b.shape[-1])
        for r0 in range(0, ai.shape[0], rows):
            x, y = ai[r0:r0 + rows].float(), bi[r0:r0 + rows].float()
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


def per_call_device(fn, calls=20, tries=5):
    """(device ms per kernel launch, device kernels per call) of ``fn``
    from torch.profiler over ``calls`` back-to-back calls after a warm-up
    call: the kernel's own time, without the host's launch gaps that
    ``time_cuda`` counts. The profiler has been seen to drop some or all
    of the events of kernels launched through ctypes, so the time is the
    mean over the events it kept (kernels per call then reads below 1),
    and a window with none is profiled again, twice as long, up to
    ``tries`` windows."""
    fn()
    for t in range(tries):
        n = calls << t
        prof = profile_device(lambda: [fn() for _ in range(n)], [])
        if prof is not None:
            events = prof["device_events"]
            return prof["device_ms"] / events, events / n
    raise RuntimeError(f"torch.profiler recorded no device event in "
                       f"{tries} windows of {calls}-{calls << (tries - 1)} "
                       "calls")


def queued_ms(fn, calls=20, windows=3, tries=4):
    """Device ms per call of ``fn`` without the host's launch gaps and
    without the profiler: CUDA events around ``calls`` calls queued behind
    a spin kernel (one thread, ~10 ms), so that every call waits on the
    card before the first starts and then they run back to back. A window
    counts only if the spin was still running when its last call had been
    queued (its start event not yet reached); a window that does not count
    is made again with the spin doubled, up to ``tries`` times. The median
    of ``windows`` windows that count; None if one never counted."""
    fn()
    torch.cuda.synchronize()
    cycles, times, missed = 20_000_000, [], 0
    while len(times) < windows:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            times.append(start.elapsed_time(end) / calls)
            continue
        missed += 1
        if missed > tries:
            return None
        cycles *= 2
    return sorted(times)[len(times) // 2]


def serve(cfg, device, *, batch=4, prompt_len=1024, new_tokens=32,
          dtype=torch.bfloat16, quant=None, control=None, profile=True):
    """Serve ``batch`` seeded requests through greedy_generate and check the
    path, with weights and prompts from a generator seeded 0, over an
    int8/fp8 KV cache if ``quant``. Returns (report, errors); the launch
    counts in the report cover the greedy_generate call alone.

    Checks (each failure is an error):
    * every layer's attention, prefill and each decode step, kernel against
      its plain version on the live activations: cosine >= 0.9999, max abs
      error <= 2e-2 x max(1, max |plain|);
    * logits over all positions, kernel prefill against plain-attention
      prefill, and decode steps against teacher-forced prefill: the mean
      row cosine's distance from 1 at most twice that of a control whose
      attention output carries bf16-sized noise (random weights make this
      model chaotic in bf16: such noise alone moves its logits; see
      PERF.md). ``control(attn_impl, seed)`` makes the control's attention
      (default: that noise; for fp32, :func:`bf16_operands`, the one bf16
      rounding the kernels make). In fp32 the teacher is plain attention
      (the prefill kernel reads fp32 as bf16; the decode kernel computes
      in fp32); over a quantized cache the teacher's control is the K/V
      round trip (``serving.divergence.kv_roundtrip``).
    """
    from sink_attention_tpu_torch.serving.divergence import (
        kv_roundtrip, noisy)
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

    ctl = control or noisy
    flash.flash_fwd_kernel.launches = 0
    for attr in ("launches", "launches_int8", "launches_fp8"):
        setattr(decode.decode_kernel, attr, 0)
    t0 = time.perf_counter()
    toks = greedy_generate(params, cfg, prompts, new_tokens, dtype=dtype,
                           quant=quant, device=dev)
    sync()
    report["generate_ms"] = (time.perf_counter() - t0) * 1e3
    report["generate_tokens_per_s"] = batch * (prompt_len + new_tokens) / (
        report["generate_ms"] / 1e3)
    report["launches"] = {"flash_fwd": flash.flash_fwd_kernel.launches,
                          "decode": decode.decode_kernel.launches}
    if quant:  # the quantized branch's, beside the unquantized (none)
        report["launches"][f"decode_{quant}"] = getattr(
            decode.decode_kernel, f"launches_{quant}")
    if tuple(toks.shape) != (batch, new_tokens) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        errors.append(f"generated tokens malformed: {tuple(toks.shape)}")

    def plain_prefill_attn(q, k, v, num_sink, window_size, s_aux):
        return flash.flash_fwd_plain(q, k, v, s_aux, num_sink,
                                     window_size)[0]

    def plain_decode_attn(q, cache, s_aux=None):
        return decode.decode_plain(q, cache.k, cache.v,
                                   decode.cache_state(cache), s_aux,
                                   **decode.cache_args(cache))

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
                                           dtype=dtype, quant=quant)
        sync()
        report["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        report["prefill_tokens_per_s"] = batch * prompt_len / (
            report["prefill_ms"] / 1e3)
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
        if cuda and profile:
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
                                attn_impl=ctl(plain_prefill_attn, 1))
        report["control_all_cos"] = _row_cos(ln, lp)
        report["control_last_cos"] = cosine(ln[:, -1], lp[:, -1])
        del ln, lp
        if not 1.0 - report["plain_all_cos"] <= 2.0 * (
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
            teacher = (plain_prefill_attn if dtype == torch.float32
                       else flash.sink_flash_attention)
            tf, _ = forward_prefill(params, cfg, seq, attn_impl=teacher)
            tf = tf[:, prompt_len:]
            report["teacher_all_cos"] = _row_cos(dl, tf)
            report["teacher_top1"] = _top1(dl, tf)
            tn, _ = forward_prefill(params, cfg, seq, attn_impl=(
                kv_roundtrip(teacher, quant) if quant else ctl(teacher,
                                                               1000)))
            report["teacher_control_cos"] = _row_cos(tn[:, prompt_len:], tf)
            del tf, tn, dl
            if not 1.0 - report["teacher_all_cos"] <= 2.0 * (
                    1.0 - report["teacher_control_cos"]):
                errors.append(
                    f"decode logits vs teacher forcing: mean cosine "
                    f"{report['teacher_all_cos']:.6f}, control "
                    f"{report['teacher_control_cos']:.6f}")

            # Decode attention checked layer by layer, every step.
            _, caches = prefill_and_caches(params, cfg, prompts, new_tokens,
                                           dtype=dtype, quant=quant)
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


def bf16_operands(attn_impl, seed=None):
    """attn_impl reading q, k and v rounded to bf16 once: the control of
    the fp32 runs (the kernels read fp32 so, as the TPU's matrix unit does
    at its default precision). ``seed`` is unused: the signature of
    ``serving.divergence.noisy``, the bf16 runs' control."""
    def attn(q, k, v, *a, **kw):
        q, k, v = (t.to(torch.bfloat16).to(t.dtype) for t in (q, k, v))
        return attn_impl(q, k, v, *a, **kw)
    return attn


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
    if not (report["layer_min_cos"] >= MIN_COS and worst_rel <= BWD_TOL):
        errors.append(f"attention gradients, kernels vs plain on the live "
                      f"path: min cosine {report['layer_min_cos']:.7f}, max "
                      f"error {worst_rel:.3e} of the largest value")


def train(cfg, device, *, seq_len=4096, steps=3, lr=1e-2,
          dtype=torch.bfloat16, control=None, profile=True, split=True):
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
      too few to judge by); ``control(attn_impl, seed)`` makes the
      control's attention (for fp32: :func:`bf16_operands`). A model
      without s_aux has no sinks gradient to check.
    """
    from sink_attention_tpu_torch.serving.divergence import noisy as _noisy
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
    if split:
        _split_step(lambda: cross_entropy_loss(params, cfg, batch,
                                               remat=True), opt, cuda, report)
    if cuda:
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if cuda and profile:
        report["step_profile"] = profile_device(
            lambda: step(params, batch),
            ("fwd_wgmma_kernel", "dq_wgmma_kernel", "dkdv_wgmma_kernel"),
            shapes=True)
    opt.zero_grad(set_to_none=True)

    # The kernel path, recording each layer's attention inputs and output
    # cotangent; then plain attention, and plain attention with noise.
    records = []
    recording = _recording(flash.sink_flash_attention, records)
    lp0, lp1 = params["layers"][0]["attn"], params["layers"][1]["attn"]
    named = [("lm_head", params["lm_head"]),
             ("layers[0].attn.sinks", lp0.get("sinks")),
             ("layers[0].attn.wq", lp0["wq"]),
             ("layers[1].attn.wk", lp1["wk"])]
    names, targets = zip(*[(n, t) for n, t in named if t is not None])

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
             "control": grads_of((control or _noisy)(plain_attn, 7))}

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
        if not e2e["kernel"][n] <= 2.0 * e2e["control"][n]:
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
                 dtype=torch.bfloat16, min_len=PACK_MIN, max_len=PACK_MAX,
                 lens=None, control=None, profile=True, split=True):
    """``steps`` SGD steps of cross_entropy_loss_packed on one pack of
    ``seq_len`` tokens, segments of ``lens`` (default pack_lengths(seq_len,
    min_len, max_len, 0)), weights from a generator seeded 0; then the
    checks. Returns (report, errors); the launch counts cover the
    ``steps`` steps alone. ``control(attn_impl, seed)`` makes the
    controls' attention (default: bf16-sized noise; for fp32
    :func:`bf16_operands`).

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
    from sink_attention_tpu_torch.ops.packed import (pack_lengths,
                                                     pack_positions)
    from sink_attention_tpu_torch.serving.divergence import noisy as _noisy
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
    lens = list(lens or pack_lengths(seq_len, min_len, max_len, 0))
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
    if split:
        _split_step(lambda: cross_entropy_loss_packed(params, cfg, batch,
                                                      positions), opt, cuda,
                    report)
    if cuda:
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if cuda and profile:
        report["step_profile"] = profile_device(
            step, ("fwd_wgmma_kernel", "dq_wgmma_kernel",
                   "dkdv_wgmma_kernel"))
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
    ctl = control or _noisy
    losses_c, _ = token_losses(ctl(plain, 11))

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
    if not tl["kernel"] <= 2.0 * tl["control"]:
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
            noisy, _ = forward_prefill(params, cfg, ids, attn_impl=(
                _noisy(flash.sink_flash_attention, 100 + i) if control is None
                else control(plain_attn, 100 + i)))
            seg_rows.append({
                "length": L,
                "packed": 1.0 - _row_cos(logits_k[:, start:start + L], alone),
                "control": 1.0 - _row_cos(noisy, alone)})
            start += L
    for i, r in enumerate(seg_rows):
        if not r["packed"] <= 2.0 * r["control"]:
            errors.append(f"segment {i} ({r['length']} tokens) in the pack "
                          f"vs its own forward: 1 - mean row cosine "
                          f"{r['packed']:.3e}, control {r['control']:.3e}")
    return report, errors


# ---------------------------------------------------------------------------
# Phase 6: continuous-batching serving
# ---------------------------------------------------------------------------


def _checked_forward(stats):
    """A forward_prefill ``attn_impl``: the forward kernel
    (``sink_flash_attention``), each call's output held against
    ``flash_fwd_plain`` on the same inputs (:func:`_attn_compare`,
    appended to ``stats``)."""
    from sink_attention_tpu_torch.ops import flash

    def attn(q, k, v, num_sink, window_size, s_aux=None):
        o = flash.sink_flash_attention(q, k, v, num_sink=num_sink,
                                       window_size=window_size, s_aux=s_aux)
        p = flash.flash_fwd_plain(q, k, v, s_aux, num_sink, window_size)[0]
        stats.append(_attn_compare(o, p))
        return o
    return attn


def _layer_gate(stats, name, report, errors):
    """Report the worst per-layer attention comparison of ``stats`` and
    fail below cosine MIN_COS or above 2e-2 of scale."""
    worst_cos = min(s["cos"] for s in stats)
    worst_rel = max(s["err"] / s["scale"] for s in stats)
    report[f"{name}_layers_checked"] = len(stats)
    report[f"{name}_layer_min_cos"] = worst_cos
    report[f"{name}_layer_max_err"] = max(s["err"] for s in stats)
    if not (worst_cos >= MIN_COS and worst_rel <= 2e-2):
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
    from sink_attention_tpu_torch.serving.divergence import (
        engine_requests, kv_roundtrip as _kv_roundtrip, noisy as _noisy)
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
        if not dist["replay"] <= 2.0 * dist[control]:
            errors.append(f"{label} engine replay vs teacher forcing: 1 - "
                          f"cosine {dist['replay']:.3e}, {control} "
                          f"{dist[control]:.3e}")
        del rows
        if cuda:
            torch.cuda.empty_cache()
    return report, errors


# ---------------------------------------------------------------------------
# Phase 8: beam search and speculative decoding
# ---------------------------------------------------------------------------


def _launch_counts():
    """The forward and decode kernels' launch counters."""
    from sink_attention_tpu_torch.ops import decode, flash
    k = decode.decode_kernel
    return {"flash_fwd": flash.flash_fwd_kernel.launches,
            "decode": k.launches, "decode_int8": k.launches_int8,
            "decode_fp8": k.launches_fp8}


def _reset_launches():
    from sink_attention_tpu_torch.ops import decode, flash
    flash.flash_fwd_kernel.launches = 0
    for attr in ("launches", "launches_int8", "launches_fp8"):
        setattr(decode.decode_kernel, attr, 0)


def _check_launches(got, want, label, errors):
    for name, n in want.items():
        if got[name] != n:
            errors.append(f"{label}: {name} launched {got[name]} times, "
                          f"expected {n}")


def _multi_op_check(cfg, device, dtype, max_len, prompt_len, T, seed):
    """sink_decode_attention_cached_multi against T sequential append +
    decode-kernel calls on a copy of the cache, at the model's two cache
    shapes (sliding, and full at ``max_len``), over a bf16 (the model
    dtype) and an int8 cache, from seeded q/k/v. [{shape, cos, err,
    scale}]."""
    from sink_attention_tpu_torch.cache import SinkKVCache
    from sink_attention_tpu_torch.ops import (
        sink_decode_attention_cached, sink_decode_attention_cached_multi)

    gen = torch.Generator(device=device).manual_seed(seed)
    H_q, H_kv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    rows = []
    for W in (cfg.sliding_window, max_len):
        for quant in (None, "int8"):
            cache = SinkKVCache.init(1, H_kv, D, cfg.num_sink_tokens, W,
                                     dtype=dtype, quant=quant, device=device)
            cache.prefill(rand(1, H_kv, prompt_len, D),
                          rand(1, H_kv, prompt_len, D))
            q, k, v = rand(1, H_q, T, D), rand(1, H_kv, T, D), rand(
                1, H_kv, T, D)
            aux = torch.randn(H_q, generator=gen, device=device)
            out, _ = sink_decode_attention_cached_multi(q, k, v, cache, aux)
            seq, ref = cache.clone(), []
            for t in range(T):
                seq.append(k[:, :, t:t + 1], v[:, :, t:t + 1])
                ref.append(sink_decode_attention_cached(q[:, :, t:t + 1],
                                                        seq, aux))
            store = quant or str(dtype).replace("torch.", "")
            rows.append({"shape": f"W={W} {store}",
                         **_attn_compare(out, torch.cat(ref, dim=2))})
    return rows


def serve_spec(cfg, device, *, prompt_len=1024, beam_tokens=32,
               num_beams=4, spec_tokens=64, num_draft=4, scale=0.1,
               n_requests=8, max_batch=4, max_len=2048, bucket=128,
               prompt=(64, 1024), new=(16, 32), dtype=torch.bfloat16):
    """Beam search, speculative decoding and the speculative engine on
    ``cfg``, weights and one prompt of ``prompt_len`` tokens from a
    generator seeded 0 (phase 3's). Returns (report, errors); each launch
    count covers its own call.

    8a. beam_generate(num_beams) of ``beam_tokens``: wall ms, ms per step
    after a prefill timed apart, reorders done and skipped, launches (the
    forward once per layer, the decode once per layer and step over every
    beam's row). Gates: num_beams=1 gives greedy_generate's tokens, unless
    they first part where the two tokens' logits are equal; the best
    beam's score, re-scored by one forward_prefill over prompt + beam, is
    off by at most twice the mean distance of three re-scorings under
    bf16-sized noise (``_noisy``).

    8b. The pair of :func:`draft_pair` (layers 1.. scaled by ``scale``,
    the draft layer 0). speculative_generate(num_draft) of
    ``spec_tokens`` against greedy_generate on the same model: ms,
    acceptance rate, target passes,
    launches (the forward per layer of both prefills, the decode per
    draft layer and draft step). Gates: the tokens equal greedy's, or
    where they first part each run's token is explained
    (``_first_divergence``, ``_divergence_gate``: the teacher-forced
    choice within twice the noise control, as it is or with the run's own
    near-tie expert choices, recorded in the run, imposed); the
    multi-token op against sequential
    decode-kernel calls at the model's two cache shapes over a bf16 and
    an int8 cache: cosine >= MIN_COS, error <= 2e-2 of scale.

    8c. ContinuousBatchingEngine with the draft over ``n_requests`` seeded
    requests (engine_requests) in ``max_batch`` slots, bf16 and int8 KV,
    each beside the plain engine on the same model: run ms, tokens/s,
    rounds, tokens committed per slot and round, launches (the forward
    per layer of both prefills and request, the run's decode branch per
    draft layer and draft step). Gate: every request's tokens equal the
    plain engine's, or where they first part both engines' tokens are
    explained as in 8b (for the int8 cache the teacher reads K and V
    through the cache's round trip, and the control also counts how far
    that moves the row). Beside it the logit gate
    (``serving.divergence.logit_gate``): at every generated position
    before the two engines part, the speculative engine's verify logits
    against the plain engine's decode logits at the same tokens, the
    median over positions of their largest difference over a bf16-noise
    control at most 2 (the token gate cannot see a fault that moves every
    logit a little: a K/V scale 1% off, ``scripts/spec_divergence.py
    --kv-scale-factor 1.01``). The run times include the recording of the
    target's expert choices and logits
    (``serving.divergence.record_engine``).
    """
    from sink_attention_tpu_torch.models import forward_prefill, init_params
    from sink_attention_tpu_torch.ops import flash
    from sink_attention_tpu_torch.serving import (ContinuousBatchingEngine,
                                                  beam_generate,
                                                  greedy_generate,
                                                  speculative_generate)
    from sink_attention_tpu_torch.serving.divergence import (
        divergence_gate as _divergence_gate, draft_pair, engine_requests,
        first_divergence as _first_divergence, logit_gate,
        noisy as _noisy, record_engine, record_generate,
        request_routes as _request_routes)

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dtype=dtype, device=dev)
    ids = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen,
                        device=dev)
    prompt_py = ids[0].tolist()
    L = cfg.num_layers
    report, errors = {}, []
    kw = dict(dtype=dtype, device=dev)

    # 8a. beam search
    stats = {}
    _reset_launches()
    (toks, score), ms = timed(lambda: beam_generate(
        params, cfg, ids, beam_tokens, num_beams=num_beams, stats=stats,
        **kw))
    launches = _launch_counts()
    with torch.inference_mode():
        _, prefill_ms = timed(lambda: forward_prefill(params, cfg, ids))
    rep = report["beam"] = {
        "num_beams": num_beams, "new_tokens": beam_tokens, "ms": ms,
        "prefill_ms": prefill_ms,
        "ms_per_step": (ms - prefill_ms) / max(stats["steps"], 1),
        **stats, "launches": launches, "score": float(score[0])}
    if cuda:
        _check_launches(rep["launches"], {
            "flash_fwd": L, "decode": L * (beam_tokens - 1),
            "decode_int8": 0, "decode_fp8": 0}, "beam", errors)
    greedy = greedy_generate(params, cfg, ids, beam_tokens, **kw)[0]
    one, _ = beam_generate(params, cfg, ids, beam_tokens, num_beams=1, **kw)
    greedy, one, toks = greedy.tolist(), one[0].tolist(), toks[0].tolist()
    at = next((i for i, (a, b) in enumerate(zip(greedy, one)) if a != b),
              None)
    rep["beam1_vs_greedy_diverged_at"] = at
    if at is not None:
        seq = torch.tensor([prompt_py + greedy[:at]], device=dev)
        with torch.inference_mode():
            row = forward_prefill(params, cfg, seq)[0][0, -1]
        if row[greedy[at]] != row[one[at]]:
            errors.append(f"num_beams=1 leaves greedy at token {at}, where "
                          f"the logits differ")

    def rescore(attn_impl=None):
        seq = torch.tensor([prompt_py + toks], device=dev)
        with torch.inference_mode():
            logits = forward_prefill(params, cfg, seq, attn_impl=attn_impl)[
                0][0, prompt_len - 1:-1].float()
        logp = torch.log_softmax(logits, dim=-1)
        return float(logp.gather(1, torch.tensor(toks, device=dev)[:, None])
                     .sum())

    total = rep["score"] * beam_tokens  # length_penalty 1, no EOS
    rep["rescore_distance"] = abs(total - rescore())
    rep["rescore_control"] = sum(
        abs(total - rescore(_noisy(flash.sink_flash_attention, 3000 + s)))
        for s in range(3)) / 3
    if not rep["rescore_distance"] <= 2.0 * rep["rescore_control"]:
        errors.append(f"beam score vs re-scoring: {rep['rescore_distance']:.4f}"
                      f", control {rep['rescore_control']:.4f}")

    # 8b. speculative decoding of one sequence
    dparams, dcfg = draft_pair(params, cfg, scale)
    (plain, plain_routes), plain_ms = timed(lambda: record_generate(
        params, lambda: greedy_generate(params, cfg, ids, spec_tokens,
                                        **kw)))
    stats = {}
    _reset_launches()
    ((spec, rate), spec_routes), ms = timed(lambda: record_generate(
        params, lambda: speculative_generate(
            params, dparams, cfg, dcfg, ids, spec_tokens,
            num_draft_tokens=num_draft, stats=stats, **kw)))
    rep = report["spec"] = {
        "num_draft_tokens": num_draft, "new_tokens": spec_tokens,
        "layer_scale": scale, "ms": ms, "greedy_ms": plain_ms,
        "acceptance_rate": rate, **stats,
        "target_passes_per_token": (stats["rounds"] + 1) / spec_tokens,
        "launches": _launch_counts()}
    if cuda:
        _check_launches(rep["launches"], {
            "flash_fwd": L + 1, "decode": stats["rounds"] * num_draft,
            "decode_int8": 0, "decode_fp8": 0}, "speculative", errors)
    rep["vs_greedy"] = _first_divergence(
        params, cfg, prompt_py, plain[0].tolist(), spec[0].tolist(), 4000,
        routes={"plain": _request_routes(plain_routes, 0),
                "spec": _request_routes(spec_routes, 0)})
    _divergence_gate(rep["vs_greedy"], "speculative_generate", errors)
    with torch.inference_mode():
        rep["multi_op"] = _multi_op_check(cfg, dev, dtype, max_len,
                                          prompt_len, num_draft, 5)
    for r in rep["multi_op"]:
        if not (r["cos"] >= MIN_COS and r["err"] <= 2e-2 * r["scale"]):
            errors.append(f"multi-token op vs sequential decode [{r['shape']}]"
                          f": cosine {r['cos']:.6f}, error {r['err']:.3e}")

    # 8c. the speculative engine beside the plain engine
    reqs = engine_requests(n_requests, cfg.vocab_size, 0, prompt, new)
    report["engine"] = {}
    for quant in (None, "int8"):
        label = quant or str(dtype).replace("torch.", "")
        rep = report["engine"][label] = {}
        runs, routes, rows = {}, {}, {}
        for name, extra in (("plain", {}), ("spec", dict(
                draft_params=dparams, draft_cfg=dcfg,
                num_draft_tokens=num_draft))):
            eng = ContinuousBatchingEngine(
                params, cfg, max_batch=max_batch, max_len=max_len,
                prefill_bucket=bucket, quant=quant, **kw, **extra)
            rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
            _reset_launches()
            logits = {}
            (out, recorded), run_ms = timed(lambda: record_engine(
                eng, eng.run, logits=logits))
            n_tok = sum(len(t) for t in out.values())
            runs[name] = [out[r] for r in rids]
            routes[name] = [_request_routes(recorded, r) for r in rids]
            rows[name] = [{p: row for (rid, p), row in logits.items()
                           if rid == r} for r in rids]
            del logits
            rep[name] = {"run_ms": run_ms, "tokens": n_tok,
                         "tokens_per_s": n_tok / (run_ms / 1e3),
                         "launches": _launch_counts()}
            if name == "plain":
                rep[name]["pool_steps"] = eng.pool_steps
                continue
            rep[name].update(
                rounds=eng.spec_rounds, slot_rounds=eng.spec_slot_rounds,
                tokens_per_slot_round=eng.spec_tokens
                / max(eng.spec_slot_rounds, 1))
            if cuda:
                branch = f"decode_{quant}" if quant else "decode"
                _check_launches(rep[name]["launches"], {
                    "flash_fwd": (L + 1) * n_requests,
                    **{b: eng.spec_rounds * num_draft if b == branch else 0
                       for b in ("decode", "decode_int8", "decode_fp8")}},
                    f"{label} speculative engine", errors)
            del eng
        rep["vs_plain"] = []
        for i, ((p, m), a, b) in enumerate(zip(reqs, runs["plain"],
                                               runs["spec"])):
            if len(a) != m or len(b) != m:
                errors.append(f"{label} engines: a request asked for {m} "
                              f"tokens and got {len(a)} / {len(b)}")
            div = _first_divergence(
                params, cfg, p, a, b, 5000, quant,
                routes={n: routes[n][i] for n in ("plain", "spec")})
            _divergence_gate(div, f"{label} speculative engine", errors)
            rep["vs_plain"].append(div)
        rep["logits_vs_plain"] = [
            logit_gate(params, cfg, p, a, b, ra, rb, 6000 + i, quant)
            for i, ((p, _), a, b, ra, rb) in enumerate(zip(
                reqs, runs["plain"], runs["spec"], rows["plain"],
                rows["spec"]))]
        for i, g in enumerate(rep["logits_vs_plain"]):
            if not g["ok"]:
                errors.append(
                    f"{label} speculative engine, request {i}: its logits "
                    f"at the plain engine's tokens lie {g['ratio']:.3f} "
                    f"times the noise control away (median of "
                    f"{g['compared']} positions), above 2")
        del rows
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


def _less(a, b):
    """a - b, or None where either was not measured."""
    return None if a is None or b is None else a - b


def _fmt(x, spec):
    return "null" if x is None else format(x, spec)


def _ablation_bound(stage, B, H_q, H_kv, N, D, ns, W):
    """(bound ms, bound_by) of one stage: a correct stage's FLOPs are
    those of the visible pairs, a stripped stage's those of every cell of
    the visited tiles (it sums over them, masked cells included), 4 D per
    cell (QK^T and PV); bytes: q, k, v read and out written once (and the
    mask tiles: maskadd two bf16 tiles, masksel one int8 tile)."""
    from sink_attention_tpu_torch.ops import ablation
    from sink_attention_tpu_torch.utils import (H100_HBM_BW, H100_PEAK_BF16,
                                                attention_pairs)
    tile = ablation.BM * ablation.BN  # cells of one visited tile
    if stage in ABLATION_CORRECT:
        cells = attention_pairs(N, N, ns, W)
    else:
        cells = int(ablation.visited_blocks(N, ns, W)[1].sum()) * tile
    flops = 4 * D * B * H_q * cells
    nbytes = 2 * (2 * B * H_q * N * D + 2 * B * H_kv * N * D)
    nbytes += {"maskadd": 2 * tile * 2, "masksel": tile}.get(stage, 0)
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
    before it and read just after; then each stage's device time per
    call with the host's gaps taken out (``queued_ms``) and its cost over
    mxu_floor's, the plain versions', SDPA's (the correct stages'
    yardstick) and the bounds.
    Returns (rows by shape, launches, errors)."""
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
        floor = None
        for t in tables[label]:
            st = t["stage"]
            if st == "full":
                rows[label]["full"] = {
                    "ms": t["ms"], "mfu": t["mfu"], "library_ms": library_ms,
                    "queued_ms": queued_ms(lambda: flash.flash_fwd_kernel(
                        q, k, v, None, ns, W))}
                continue
            r = rows[label][st]
            r.update(shape=shape, ms=t["ms"], mfu=t["mfu"],
                     delta_ms=t["delta_ms"],
                     library_ms=library_ms if st in ABLATION_CORRECT
                     else None)
            r["queued_ms"] = queued_ms(
                lambda: ablation.ablation_attention(q, k, v, st, ns, W))
            if st == "mxu_floor":
                floor = r
            if floor is not None:
                r["minus_floor_ms"] = r["ms"] - floor["ms"]
                r["minus_floor_queued_ms"] = _less(r["queued_ms"],
                                                   floor["queued_ms"])
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
                + f" ok={r['ok']} ms={r['ms']:.4f} queued_ms="
                f"{_fmt(r['queued_ms'], '.4f')} eff_mfu="
                f"{r['mfu'] * 100:.2f}% delta_ms="
                + ("none" if r["delta_ms"] is None else
                   f"{r['delta_ms']:+.4f}")
                + (f" minus_floor_ms={r['minus_floor_ms']:+.4f} "
                   f"minus_floor_queued_ms="
                   f"{_fmt(r['minus_floor_queued_ms'], '+.4f')}"
                   if "minus_floor_ms" in r else "")
                + f" plain_ms={r['plain_ms']:.4f} library_ms="
                + ("none" if r["library_ms"] is None else
                   f"{r['library_ms']:.4f}")
                + f" bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
            if not r["ok"]:
                errors.append(f"ablation {st} [{label}] disagrees with its "
                              f"plain version: {r['max_abs_err']:.3e}")
        del mask
    # `full` is the forward; `maskadd` and `masksel` compute the same
    # function on the same kernel with the JAX script's constant-tile masks
    def versus(label):
        full, add, sel = (rows[label][s]["queued_ms"]
                          for s in ("full", "maskadd", "masksel"))
        ratio = None if None in (full, add) else add / full
        return (f"{label} {_fmt(full, '.4f')} vs {_fmt(add, '.4f')}, "
                f"{_fmt(sel, '.4f')} (x{_fmt(ratio, '.2f')})")
    log("forward (full) against its mask stages on the same function "
        "(maskadd, masksel), queued ms: "
        + "; ".join(versus(label) for label, *_ in ABLATION_SHAPES))
    for name, n in launches.items():
        if n <= 0:
            errors.append(f"{name} launched {n} times in phase 7")
    return rows, launches, errors


def ablation_entries(rows, launches):
    """The two ablation kernels' entries of the kernels line: launches in
    phase 7's main path, the worst error over its three shapes, and the
    means over each kernel's stages at the headline shape (per-stage ms and
    queued ms beside them; a mean is null where a stage's is). The stripped stages have no library
    counterpart but ``general``, masked attention (with NaN rows), whose
    yardstick is SDPA over the same mask (``library_for``)."""
    from sink_attention_tpu_torch.ops import ablation
    csrc = "sink_attention_tpu_torch/ops/csrc/"
    head = rows["headline"]
    out = []
    for name, line, stages in (
            ("ablation", 80, [s for s in ablation.STAGES
                              if s not in ablation.MASK_STAGES]),
            ("mask_stage", 179, list(ablation.MASK_STAGES))):
        def mean(key):
            xs = [head[s][key] for s in stages]
            return None if None in xs else sum(xs) / len(xs)
        lib = head["general" if name == "ablation" else stages[0]][
            "library_ms"]
        out.append({
            "name": name, "route": "cuda", "source": csrc + "ablation.cu",
            "replaces": f"scripts/mfu_ablation.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(r[s]["max_abs_err"] for r in rows.values()
                               for s in stages),
            "ms": mean("ms"), "queued_ms": mean("queued_ms"),
            "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": head[stages[0]]["bound_by"],
            "library_ms": lib,
            "library_for": ("general" if name == "ablation"
                            else "maskadd, masksel"),
            "stage_ms": {s: head[s]["ms"] for s in stages},
            "stage_queued_ms": {s: head[s]["queued_ms"] for s in stages},
            "redesigned": REDESIGNED[name],
            "template": csrc + TEMPLATE[name]})
    return out


# ---------------------------------------------------------------------------
# Phase 9: serving with quantized weights
# ---------------------------------------------------------------------------

# a quantized matmul against its fp32 dequantised reference, of max |ref|:
# x and the products in bf16 (JAX tests/test_int4.py:50,69)
QUANT_OP_REL = 2e-2
# a quantized layer's contribution against the same layer with its weights
# dequantised to bf16 (JAX's int4 model bound, tests/test_int4.py:101)
QUANT_LAYER_COS = 0.999
QUANT_MODES = {"int8": (8, None), "int4": (4, None), "int4_g32": (4, 32)}


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.nbytes


def dequantize(w, dtype=torch.float32):
    """The plain weight of an int8 ({"q", "s"}) or packed-int4 ({"q4",
    "s"}) leaf: the codes (the int4 nibbles sign-extended, lo half then hi
    half along the contract axis) times their per-channel or group scales,
    in fp32 one matrix (expert) at a time, cast to ``dtype``. A plain
    tensor comes back as it is."""
    from sink_attention_tpu_torch.models import is_quantized, is_quantized4

    int4 = is_quantized4(w)
    if not (int4 or is_quantized(w)):
        return w
    q, s = (w["q4"] if int4 else w["q"]), w["s"]
    rows = q.shape[-2] * (2 if int4 else 1)
    out = torch.empty(q.shape[:-2] + (rows, q.shape[-1]), dtype=dtype,
                      device=q.device)
    q3, s3 = q.reshape(-1, *q.shape[-2:]), s.reshape(-1, *s.shape[-2:])
    o3 = out.view(-1, rows, q.shape[-1])
    for e in range(q3.shape[0]):
        codes = (torch.cat([(q3[e] << 4) >> 4, q3[e] >> 4]) if int4
                 else q3[e]).float()
        se = s3[e].float()
        if int4 and se.shape[0] > 1:   # group scales over their rows
            se = se.repeat_interleave(rows // se.shape[0], dim=0)
        o3[e] = (codes * se).to(dtype)
    return out


def dequantize_tree(tree, dtype=torch.bfloat16):
    """``tree`` with every quantized leaf replaced by its plain weight in
    ``dtype`` (see :func:`dequantize`)."""
    from sink_attention_tpu_torch.models import is_quantized, is_quantized4

    if is_quantized(tree) or is_quantized4(tree):
        return dequantize(tree, dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dequantize_tree(v, dtype) for v in tree]
    return tree


def quant_op_gates(device, *, lm_head=(2880, 201088), lm_tokens=(1, 8),
                   experts=(32, 128), hidden=2880, inter=2880,
                   expert_tokens=64, seed=0):
    """Phase 9a: the model's quantized matmuls (``_mm`` on the lm_head,
    ``_expert_mm`` on stacked gate_up [E, hidden, 2 inter] and down [E,
    inter, hidden] with x 2-D [T, K] and 3-D [E, T, K]) in int8, int4 per
    channel and int4 with group 32, against an fp32 product with the
    weight dequantised to fp32. bf16 weights normal(0, 0.02) and x
    normal(0, 1) from a generator seeded ``seed``. Returns (rows, errors):
    each row's error of max |reference| (QUANT_OP_REL), and on the card
    the op's ms beside the bf16 matmul's on the unquantized weight (CUDA
    events)."""
    from sink_attention_tpu_torch.models import (quantize_weight,
                                                 quantize_weight_int4)
    from sink_attention_tpu_torch.models.model import _expert_mm, _mm
    from sink_attention_tpu_torch.utils import time_cuda

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    K, V = lm_head
    cases = [("lm_head", (K, V), [(T, K) for T in lm_tokens])]
    for E in experts:
        T = expert_tokens
        cases += [(f"gate_up E={E}", (E, hidden, 2 * inter),
                   [(T, hidden), (E, T, hidden)]),
                  (f"down E={E}", (E, inter, hidden),
                   [(T, inter), (E, T, inter)])]
    rows, errors = [], []
    for name, wshape, xshapes in cases:
        w = randn(wshape, 0.02)
        xs = [randn(s) for s in xshapes]
        mm = _mm if len(wshape) == 2 else _expert_mm
        bf16_ms = [time_cuda(lambda x=x: torch.matmul(x, w), iters=10)
                   if dev.type == "cuda" else None for x in xs]
        for mode, (bits, group) in QUANT_MODES.items():
            qw = (quantize_weight(w, scale_dtype=torch.bfloat16) if bits == 8
                  else quantize_weight_int4(w, scale_dtype=torch.bfloat16,
                                            group_size=group))
            ref_w = dequantize(qw)
            for x, b_ms in zip(xs, bf16_ms):
                out = mm(x, qw)
                ref = torch.matmul(x.float(), ref_w)
                rel = float((out.float() - ref).abs().max()
                            / ref.abs().max())
                row = {"op": name, "mode": mode, "x": list(x.shape),
                       "rel_err": rel, "finite": bool(out.isfinite().all())}
                if dev.type == "cuda":
                    row.update(ms=time_cuda(lambda: mm(x, qw), iters=10),
                               bf16_ms=b_ms)
                rows.append(row)
                if not (rel < QUANT_OP_REL and row["finite"]):
                    errors.append(f"quantized matmul {name} {mode} x "
                                  f"{list(x.shape)}: error {rel:.3e} of "
                                  f"max |ref| (bound {QUANT_OP_REL})")
                del out, ref
            del qw, ref_w
        del w, xs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows, errors


def _quant_checks(params, cfg, device, quantized, *, slots, prompt_len,
                  bucket, max_len, seed=1):
    """The gates of one tree on live activations, at the shapes of an
    engine row with ``slots`` slots (:func:`_quant_engine`): ``slots``
    seeded prompts of ``prompt_len`` tokens, each prefilled alone padded
    to ``bucket`` (the engine's admission, B=1) with every layer's forward
    attention checked (kernel against plain), inserted into a ragged pool
    of ``slots`` slots and ``max_len``, then one decode step of the pool
    walked layer by layer (``model._block``, as forward_decode_ragged runs
    it) with every layer's decode attention checked. With ``quantized``,
    the first sliding, the first full and the last layer are each run
    again from the same input with their weights dequantised to bf16 (on
    a clone of their cache), and again with bf16-sized noise in the
    attention output (``_noisy``, the control), both with the quantized
    run's expert choice (:func:`_fixed_routing`; the tokens whose own
    choice differed are counted): the cosine of the layer's contribution
    (output less its input) against the dequantised one's. Returns a
    report; the caller gates it."""
    from sink_attention_tpu_torch.serving.divergence import noisy as _noisy
    from sink_attention_tpu_torch.models import (forward_prefill,
                                                 make_ragged_caches,
                                                 rope_cos_sin)
    from sink_attention_tpu_torch.models import model as tmodel
    from sink_attention_tpu_torch.ops import decode

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.zeros((slots, -(-prompt_len // bucket) * bucket),
                      dtype=torch.long, device=dev)
    ids[:, :prompt_len] = torch.randint(0, cfg.vocab_size,
                                        (slots, prompt_len), generator=gen,
                                        device=dev)
    stats = {"prefill": [], "decode": []}
    checked_prefill = _checked_forward(stats["prefill"])

    rep = {}
    with torch.inference_mode():
        caches = make_ragged_caches(cfg, slots, max_len, device=dev)
        toks, finite = [], True
        for b in range(slots):
            logits, kvs = forward_prefill(params, cfg, ids[b:b + 1],
                                          collect_kv=True,
                                          attn_impl=checked_prefill)
            finite &= bool(logits.isfinite().all())
            for c, (k, v) in zip(caches, kvs):
                c.insert(b, k[0], v[0], prompt_len)
            toks.append(logits[0, prompt_len - 1].argmax())
            del logits, kvs
        rep["prefill_finite"] = finite
        toks = torch.stack(toks)
        active = torch.ones(slots, dtype=torch.bool, device=dev)
        cos, sin = rope_cos_sin(cfg, caches[0].seen[:, None])
        x = tmodel._embed_lookup(params["embed"], toks[:, None])
        gate = sorted({cfg.layer_types.index(t) for t in
                       ("sliding_attention", "full_attention")
                       if t in cfg.layer_types} | {cfg.num_layers - 1}
                      ) if quantized else []

        def attend(cache, s_aux, check):
            def attn(q, k, v):
                c = cache.append(k, v, active)
                o = decode.sink_decode_attention_ragged(q, c, s_aux)
                if check:
                    p = decode.decode_plain(q, c.k, c.v, decode.ragged_lens(c),
                                            s_aux, **decode.cache_args(c))
                    stats["decode"].append(_attn_compare(o, p))
                return o
            return attn

        layers = []
        for li, lp in enumerate(params["layers"]):
            s_aux = tmodel._s_aux(lp, cfg)
            routes = []
            forks = ([caches[li].clone(), caches[li].clone()]
                     if li in gate else None)
            out, _ = _fixed_routing(lambda: tmodel._block(
                lp, cfg, x, cos, sin, attend(caches[li], s_aux, True),
                active=active), routes)
            if forks:
                deq = dequantize_tree(lp)
                ref, flips = _fixed_routing(lambda: tmodel._block(
                    deq, cfg, x, cos, sin, attend(forks[0], s_aux, False),
                    active=active), routes)
                ctrl, ctrl_flips = _fixed_routing(lambda: tmodel._block(
                    deq, cfg, x, cos, sin,
                    _noisy(attend(forks[1], s_aux, False), 3000 + li),
                    active=active), routes)
                layers.append({"layer": li, "type": cfg.layer_types[li],
                               "cos": cosine(out - x, ref - x),
                               "control_cos": cosine(ctrl - x, ref - x),
                               "router_flips": flips,
                               "control_router_flips": ctrl_flips,
                               "finite": bool(out.isfinite().all())})
                del deq, ref, ctrl, forks
            x = out
        logits = tmodel._head(params, cfg, x)
        rep["decode_finite"] = bool(logits.isfinite().all())
    rep["quant_layers"] = layers
    for name, st in stats.items():
        rep[f"{name}_stats"] = st
    return rep


def _fixed_routing(run, routes):
    """``run()`` with the model's ``moe_routing`` recording its expert
    choice into ``routes`` when that is empty, else replaying it: the runs
    compared with a quantized layer take its expert choice, so a router
    near-tie that tips the other way (a discrete flip of a token's
    experts) is not read as the matmuls' error. Returns (``run()``'s
    result, the tokens whose own choice differed from the replayed
    one)."""
    from sink_attention_tpu_torch.models import model as tmodel

    orig, replay, flips = tmodel.moe_routing, bool(routes), []

    def routing(p, cfg, xt):
        own = orig(p, cfg, xt)
        if not replay:
            routes.append(own)
            return own
        fixed = routes[len(flips)]
        flips.append(int(((own > 0) != (fixed > 0)).any(-1).sum()))
        return fixed

    tmodel.moe_routing = routing
    try:
        return run(), sum(flips)
    finally:
        tmodel.moe_routing = orig


def _gate_checks(rep, label, errors):
    """Fail the checks of :func:`_quant_checks`: every layer's attention
    (MIN_COS, 2e-2 of scale), each checked quantized layer
    (QUANT_LAYER_COS, and its router flips no more than its control's, or
    one), no NaN."""
    for name in ("prefill", "decode"):
        _layer_gate(rep.pop(f"{name}_stats"), name, rep, errors)
    for row in rep["quant_layers"]:
        if not (row["cos"] >= QUANT_LAYER_COS and row["finite"]):
            errors.append(f"{label}: quantized layer {row['layer']} vs its "
                          f"dequantised weights: cosine {row['cos']:.6f} "
                          f"(control {row['control_cos']:.6f})")
        if row["router_flips"] > max(1, row["control_router_flips"]):
            errors.append(f"{label}: quantized layer {row['layer']}: "
                          f"{row['router_flips']} tokens routed otherwise "
                          f"by its dequantised weights (control "
                          f"{row['control_router_flips']})")
    if not (rep["prefill_finite"] and rep["decode_finite"]):
        errors.append(f"{label}: non-finite logits")


def _quant_engine(params, cfg, device, max_batch, *, prompt_len, max_len,
                  bucket, chunk, warm, timed, profile_steps):
    """One row of ``scripts/bench_suite.py``'s ``int4serve_table`` and
    ``_run_engine``: ``max_batch`` requests of the prompt 1..prompt_len
    with no budget to reach, ``warm`` chunks of ``chunk`` steps, then
    ``timed`` chunks timed on the host clock, then ``profile_steps`` steps
    in one profiled chunk. Returns (row, engine)."""
    from sink_attention_tpu_torch.serving import ContinuousBatchingEngine

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    eng = ContinuousBatchingEngine(params, cfg, max_batch=max_batch,
                                   max_len=max_len, prefill_bucket=bucket,
                                   dtype=torch.bfloat16, device=dev)
    for _ in range(max_batch):
        eng.submit(list(range(1, prompt_len + 1)), max_new_tokens=1 << 30)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    for _ in range(warm):
        eng.step_chunk(chunk)
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        out = eng.step_chunk(chunk)
    if cuda:
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (timed * chunk)
    row = {"max_batch": max_batch, "ms_per_token": dt * 1e3,
           "tokens_per_s": max_batch / dt,
           "tokens_ok": all(len(t) == chunk and all(
               0 <= i < cfg.vocab_size for i in t) for t in out.values())
           and len(out) == max_batch}
    if cuda:
        t0 = time.perf_counter()
        row["profile"] = profile_device(lambda: eng.step_chunk(profile_steps),
                                        ("decode_kernel",))
        row["profile_s"] = time.perf_counter() - t0
    else:
        eng.step_chunk(profile_steps)
    row["profile_steps"] = profile_steps
    row["pool_steps"] = eng.pool_steps
    row["launches"] = _launch_counts()
    if cuda:
        row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return row, eng


def serve_quant(cfg, device, forms=("bfloat16", "int8", "int4"), *,
                batches=(1, 8), prompt_len=64, max_len=4096, bucket=64,
                chunk=32, warm=1, timed=2, profile_steps=2):
    """Phase 9b/9c: ``cfg`` served by ContinuousBatchingEngine with its
    weights in each of ``forms`` in turn, weights from a generator seeded
    0 (phase 3's): "bfloat16" (``init_params``), "int8" (the bf16 tree
    quantized by ``quantize_params(inplace=True)``), "int4"
    (``init_quantized_params(bits=4)``: int4 layers and lm_head, int8
    embedding). Each tree is dropped before the next is built, except
    that int8 is made from the bf16 tree in place. Returns (report,
    errors).

    Per tree: the build's seconds, weight bytes (before and after, for
    the in-place quantization) and peak memory; then per ``batches``
    entry the checks of :func:`_quant_checks` at that row's slots,
    gated, and one engine row (:func:`_quant_engine`: ms a token,
    tokens/s, the profiled chunk's device ms and idle share, peak
    memory), gated on its launches on the card (the forward once per
    layer and admission, the bf16 decode once per layer and pool step,
    the quantized decode branches never) and on its tokens.
    """
    import gc

    from sink_attention_tpu_torch.models import (init_params,
                                                 init_quantized_params,
                                                 quantize_params)

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def reset():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    report, errors, params, prev = {}, [], None, None
    for form in forms:
        rep = report[form] = {}
        if form == "bfloat16" or (form == "int8" and prev != "bfloat16"):
            params = None
            reset()
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(0)
            params = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
            sync()
            rep["init_s"] = time.perf_counter() - t0
            rep["init_peak_gb"] = peak()
        if form == "int8":
            rep["bytes_before"] = tree_bytes(params)
            reset()
            t0 = time.perf_counter()
            params = quantize_params(params, inplace=True)
            sync()
            rep["quantize_s"] = time.perf_counter() - t0
            rep["quantize_peak_gb"] = peak()
        elif form == "int4":
            params = None
            reset()
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(0)
            params = init_quantized_params(cfg, gen, bits=4, device=dev)
            sync()
            rep["init_s"] = time.perf_counter() - t0
            rep["init_peak_gb"] = peak()
        rep["weight_bytes"] = tree_bytes(params)
        reset()
        rep["engine"] = []
        for mb in batches:
            label = f"{form} engine max_batch {mb}"
            t0 = time.perf_counter()
            checks = _quant_checks(params, cfg, dev, form != "bfloat16",
                                   slots=mb, prompt_len=prompt_len,
                                   bucket=bucket, max_len=max_len)
            _gate_checks(checks, label, errors)
            checks["checks_s"] = time.perf_counter() - t0
            reset()
            row, eng = _quant_engine(params, cfg, dev, mb,
                                     prompt_len=prompt_len, max_len=max_len,
                                     bucket=bucket, chunk=chunk, warm=warm,
                                     timed=timed, profile_steps=profile_steps)
            row["checks"] = checks
            rep["engine"].append(row)
            if not row["tokens_ok"]:
                errors.append(f"{label}: malformed tokens")
            if cuda:
                _check_launches(row["launches"], {
                    "flash_fwd": cfg.num_layers * mb,
                    "decode": cfg.num_layers * eng.pool_steps,
                    "decode_int8": 0, "decode_fp8": 0}, label, errors)
            del eng
            reset()
        prev = form
    del params
    reset()
    return report, errors


# ---------------------------------------------------------------------------
# Phase 10: serving from a checkpoint in the released layout
# ---------------------------------------------------------------------------

# e8m0 codes of the written MXFP4 blocks, inclusive: 2^-8..2^-6 times the
# e2m1 values (RMS 2.93 over the 16 codes) give decoded weights of RMS
# 2.93 * sqrt((2^-16 + 2^-14 + 2^-12) / 3) = 0.030, near phase 3's 0.02
# (a span like 121-132 makes a 24-layer model diverge)
MXFP4_SCALE_CODES = (119, 121)
# OCP e2m1 code points, low nibble first (the JAX package's decoder,
# copied: this script imports nothing of it)
_FP4 = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
        -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0)


def mxfp4_decode_numpy(blocks, scales):
    """numpy decode of MXFP4 blocks [..., G, 16] and e8m0 scales [..., G]
    to fp32 [..., G*32], as the JAX package's ``dequantize_mxfp4``."""
    import numpy as np
    fp4 = np.array(_FP4, dtype=np.float32)
    vals = np.stack([fp4[blocks & 0x0F], fp4[blocks >> 4]], axis=-1)
    vals = vals.reshape(*blocks.shape[:-1], 32)
    exp = (scales.astype(np.int32) - 127)[..., None]
    with np.errstate(over="ignore"):
        return np.ldexp(vals, exp).reshape(*blocks.shape[:-2], -1)


def hf_config_of(cfg) -> dict:
    """The config.json (the port's exporter's ``hf_config``) of a
    GptOssForCausalLM whose from_hf_config is ``cfg``."""
    from sink_attention_tpu_torch.scripts.export_random_hf_checkpoint import \
        hf_config
    return hf_config({
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_size,
        "num_local_experts": cfg.num_experts,
        "num_experts_per_tok": cfg.experts_per_tok,
        "sliding_window": cfg.sliding_window,
        "layer_types": list(cfg.layer_types), "rope_theta": cfg.rope_theta,
        "rope_scaling": cfg.rope_scaling, "rms_norm_eps": cfg.rms_norm_eps,
        "attention_bias": cfg.attention_bias,
        "max_position_embeddings": cfg.max_position_embeddings})


def _layer_tensors(cfg):
    """The exporter's ``layer_tensors`` of ``cfg`` in the released layout:
    each dense expert stack [E, in, out] as MXFP4, uint8 "blocks"
    [E, out, in/32, 16] and e8m0 "scales" [E, out, in/32]."""
    from sink_attention_tpu_torch.scripts.export_random_hf_checkpoint import \
        layer_tensors

    out = []
    for name, shape, kind in layer_tensors(hf_config_of(cfg)):
        if name.startswith("mlp.experts.") and name.endswith("_proj"):
            E, K, N = shape
            out += [(name + "_blocks", (E, N, K // 32, 16), "blocks"),
                    (name + "_scales", (E, N, K // 32), "scales")]
        else:
            out.append((name, shape, kind))
    return out


def checkpoint_bytes(cfg) -> int:
    """Bytes of the tensors :func:`write_mxfp4_checkpoint` writes."""
    per = sum(math.prod(s) * (1 if k in ("blocks", "scales") else 2)
              for _, s, k in _layer_tensors(cfg))
    return cfg.num_layers * per + (2 * cfg.vocab_size + 1) * \
        cfg.hidden_size * 2


def write_mxfp4_checkpoint(out_dir, cfg, device, *, seed=0, keep=()):
    """A random gpt-oss checkpoint in the released layout: config.json,
    one safetensors shard per layer (bf16 dense tensors in HF's [out, in]
    Linear layout, MXFP4 experts: uint8 ``_blocks`` [E, out, in/32, 16]
    of uniform bytes and ``_scales`` [E, out, in/32] uniform over
    MXFP4_SCALE_CODES) and one for embed/norm/head (untied), with
    model.safetensors.index.json, written through the port's exporter's
    shard and index writers. Dense tensors are drawn N(0, 0.02), biases
    too, norms are ones and the sinks N(0, 1).
    Drawn on ``device`` from a generator seeded ``seed``. Returns
    (report, {name: dense tensor written, on the CPU}, {layer: (gate_up
    blocks, scales, down blocks, scales) as numpy} for the layers of
    ``keep``)."""
    import os

    from sink_attention_tpu_torch.scripts.export_random_hf_checkpoint import (
        new_index, write_index, write_shard)

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = MXFP4_SCALE_CODES

    def draw(shape, kind):
        if kind == "blocks":
            return torch.randint(0, 256, shape, dtype=torch.uint8,
                                 device=dev, generator=gen)
        if kind == "scales":
            return torch.randint(lo, hi + 1, shape, dtype=torch.uint8,
                                 device=dev, generator=gen)
        if kind == "one":
            return torch.ones(shape, dtype=torch.bfloat16, device=dev)
        return torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(
            0.0, 1.0 if kind == "sink" else 0.02, generator=gen)

    t0 = time.perf_counter()
    index = new_index()
    dense, kept = {}, {}

    for li in range(cfg.num_layers):
        pre = f"model.layers.{li}."
        tensors = {pre + n: draw(s, k).cpu()
                   for n, s, k in _layer_tensors(cfg)}
        dense.update({n: t for n, t in tensors.items()
                      if t.dtype == torch.bfloat16})
        if li in keep:
            kept[li] = tuple(tensors[pre + f"mlp.experts.{m}_proj_{p}"]
                             .numpy() for m in ("gate_up", "down")
                             for p in ("blocks", "scales"))
        write_shard(out_dir, index, f"model-layer-{li:05d}.safetensors",
                    tensors)
    V, H = cfg.vocab_size, cfg.hidden_size
    head = {"model.embed_tokens.weight": draw((V, H), "w").cpu(),
            "model.norm.weight": draw((H,), "one").cpu(),
            "lm_head.weight": draw((V, H), "w").cpu()}
    dense.update(head)
    write_shard(out_dir, index, "model-embed.safetensors", head)
    write_index(out_dir, index, hf_config_of(cfg))
    files = os.listdir(out_dir)
    rep = {"bytes": sum(os.path.getsize(os.path.join(out_dir, f))
                        for f in files),
           "tensor_bytes": index["metadata"]["total_size"],
           "files": len(files), "seconds": time.perf_counter() - t0,
           "scale_codes": list(MXFP4_SCALE_CODES)}
    return rep, dense, kept


class _RssPeak:
    """The process's resident set, sampled every 5 ms from
    /proc/self/statm on a thread while the block runs: ``peak_gb`` and
    ``start_gb``."""

    def __enter__(self):
        import os
        import threading

        page = os.sysconf("SC_PAGE_SIZE")

        def rss():
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * page / 1e9

        self._rss, self.start_gb = rss, rss()
        self.peak_gb = self.start_gb
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak_gb = max(self.peak_gb, rss())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        self.peak_gb = max(self.peak_gb, self._rss())


def _load_gates(params, cfg, dense, kept, errors):
    """10b's gates: every dense leaf equals the tensor written (transposed
    where HF stores [out, in]) and the kept layers' experts a numpy decode
    of the bytes written, bit for bit. Returns the count of leaves held."""
    import numpy as np

    def same(got, want, name):
        want = want.to(got.device)
        if got.dtype != want.dtype or got.shape != want.shape or not bool(
                (got.view(torch.int16) == want.view(torch.int16)).all()):
            errors.append(f"checkpoint load: {name} differs from the "
                          "tensor written")

    n = 0
    for li, lp in enumerate(params["layers"]):
        pre = f"model.layers.{li}."
        a, m = lp["attn"], lp["mlp"]
        pairs = [(a[k], f"self_attn.{p}_proj.weight", True)
                 for k, p in (("wq", "q"), ("wk", "k"), ("wv", "v"),
                              ("wo", "o"))]
        pairs += [(a[k], f"self_attn.{p}_proj.bias", False)
                  for k, p in (("bq", "q"), ("bk", "k"), ("bv", "v"),
                               ("bo", "o"))]
        pairs += [(a["sinks"], "self_attn.sinks", False),
                  (m["router_w"], "mlp.router.weight", True),
                  (m["router_b"], "mlp.router.bias", False),
                  (m["gate_up_b"], "mlp.experts.gate_up_proj_bias", False),
                  (m["down_b"], "mlp.experts.down_proj_bias", False),
                  (lp["ln1"], "input_layernorm.weight", False),
                  (lp["ln2"], "post_attention_layernorm.weight", False)]
        for got, name, transpose in pairs:
            want = dense[pre + name]
            same(got, want.t() if transpose else want, pre + name)
            n += 1
        if li in kept:
            gu_b, gu_s, dn_b, dn_s = kept[li]
            for got, b, s, name in ((m["gate_up"], gu_b, gu_s, "gate_up"),
                                    (m["down"], dn_b, dn_s, "down")):
                for e in range(b.shape[0]):   # one expert at a time
                    want = np.ascontiguousarray(
                        mxfp4_decode_numpy(b[e], s[e]).T)
                    if not np.array_equal(
                            got[e].float().cpu().numpy().view(np.int32),
                            want.view(np.int32)):
                        errors.append(f"checkpoint load: layer {li} "
                                      f"{name} expert {e} differs from "
                                      "its numpy decode")
                        break
                n += 1
    same(params["embed"], dense["model.embed_tokens.weight"], "embed")
    same(params["lm_head"], dense["lm_head.weight"].t(), "lm_head")
    same(params["final_norm"], dense["model.norm.weight"], "final_norm")
    return n + 3


def _resume_check(params, cfg, device, reqs, sampled, *, max_batch,
                  max_len, bucket, chunks, chunk, snap, errors):
    """10d: two engines over ``reqs`` plus ``sampled`` (prompt, max new,
    SamplingParams): the first runs ``chunks`` chunks of ``chunk`` pool
    steps and then to the end; the second the same chunks, then
    ``save_state(snap)``, ``load_state`` into a fresh engine, which runs
    to the end. Every request's tokens must be the uninterrupted run's,
    exactly. Returns a report, with the three engines' pool steps."""
    import os

    from sink_attention_tpu_torch.serving import ContinuousBatchingEngine

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def engine():
        eng = ContinuousBatchingEngine(params, cfg, max_batch=max_batch,
                                       max_len=max_len,
                                       prefill_bucket=bucket,
                                       dtype=torch.bfloat16, device=dev)
        for p, m in reqs:
            eng.submit(p, max_new_tokens=m)
        eng.submit(sampled[0], max_new_tokens=sampled[1],
                   sampling=sampled[2])
        for _ in range(chunks):
            eng.step_chunk(chunk)
        return eng

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rep = {}
    first = engine()
    want = first.run()
    eng = engine()
    sync()
    t0 = time.perf_counter()
    eng.save_state(snap)
    sync()
    rep["save_s"] = time.perf_counter() - t0
    rep["snapshot_bytes"] = (os.path.getsize(snap)
                             + os.path.getsize(snap + ".meta.json"))
    rep["in_flight"] = {"slots": eng.active_count, "queued": len(eng._queue)}
    if not eng.active_count:
        errors.append("resume check: no request was mid-generation at the "
                      "snapshot")
    steps = [first.pool_steps, eng.pool_steps]
    del first, eng
    fresh = ContinuousBatchingEngine(params, cfg, max_batch=max_batch,
                                     max_len=max_len, prefill_bucket=bucket,
                                     dtype=torch.bfloat16, device=dev)
    sync()
    t0 = time.perf_counter()
    fresh.load_state(snap)
    sync()
    rep["load_s"] = time.perf_counter() - t0
    got = fresh.run()
    rep["pool_steps"] = steps + [fresh.pool_steps]
    rep["requests"] = len(want)
    rep["tokens"] = sum(len(t) for t in want.values())
    rep["mismatched"] = [rid for rid in want if got.get(rid) != want[rid]]
    if sorted(got) != sorted(want) or rep["mismatched"]:
        errors.append(f"resumed engine: requests {rep['mismatched']} (of "
                      f"{len(want)}) differ from the uninterrupted run")
    return rep


def _admission_checks(params, cfg, prompts, bucket, device):
    """Each prompt prefilled alone, padded to ``bucket`` (the engine's
    admission: B=1), with every layer's forward attention checked, kernel
    against plain (:func:`_checked_forward`). Returns the per-layer
    stats."""
    from sink_attention_tpu_torch.models import forward_prefill

    stats = []
    with torch.inference_mode():
        for prompt in prompts:
            n = len(prompt)
            ids = torch.zeros((1, -(-n // bucket) * bucket), dtype=torch.long,
                              device=device)
            ids[0, :n] = torch.tensor(prompt, device=device)
            forward_prefill(params, cfg, ids,
                            attn_impl=_checked_forward(stats))
    return stats


def _int4_gates(params4, ref, errors):
    """10e's gate: the int4 load's codes and scales equal
    quantize_weight_int4 (int8 quantize_weight for the lm_head) of the
    bf16-loaded tensors in ``ref`` ({path: tensor}), bit for bit."""
    from sink_attention_tpu_torch.models import (quantize_weight,
                                                 quantize_weight_int4)

    for path, w in ref.items():
        node = params4
        for key in path:
            node = node[key]
        want = (quantize_weight(w.float(), contract_axis=-2,
                                scale_dtype=torch.bfloat16)
                if path == ("lm_head",) else
                quantize_weight_int4(w.float(), contract_axis=-2,
                                     scale_dtype=torch.bfloat16))
        for k, t in want.items():
            if not torch.equal(node[k], t):
                errors.append(f"int4 checkpoint load: "
                              f"{'/'.join(map(str, path))} [{k}] differs "
                              "from post-hoc quantization")


def serve_checkpoint(cfg, device, *, n_requests=8, max_batch=4,
                     max_len=2048, bucket=128, prompt=(64, 1024),
                     new=(16, 32), replay_steps=16, resume=(2, 8),
                     golden=(2, 512), int4_row=None, workdir=None):
    """Phase 10: gpt-oss ``cfg`` served from a checkpoint on disk. Returns
    (report, errors).

    a. :func:`write_mxfp4_checkpoint` into a new directory under
       ``workdir`` (default the temporary directory), after a check that
       the disk holds it; the directory is removed at the end.
    b. ``load_hf_checkpoint(path)`` in bf16: seconds, the host's resident
       peak during the load, the device peak, the tree's bytes; gated on
       ``from_hf_config`` giving ``cfg`` and on :func:`_load_gates` (the
       first, middle and last layers' experts).
    c. ContinuousBatchingEngine over the loaded tree: phase 6's requests
       (engine_requests), ``max_batch`` slots, ``max_len``, bf16 KV;
       launches, tokens/s, the device peak; every request's admission
       prefill again with every layer's forward attention, kernel against
       plain (:func:`_admission_checks`), and a replay with every layer's
       decode attention, kernel against plain (_engine_replay), each
       gated by _layer_gate.
    d. :func:`_resume_check` on the same requests plus one sampled at
       temperature 1.0, top_k 4: ``resume`` = (chunks, steps per chunk)
       before the snapshot; the snapshot's bytes and the save and load
       seconds; launches over its three engines (every request admitted
       once by the uninterrupted engine and once by the interrupted pair).
    f. the golden protocol (``scripts/golden_gpt_oss.run``, skip_hf: eager
       is the plain-attention stack) on the bf16 tree, ``golden`` =
       (prompts, tokens), with the forward of its kernel stack and of its
       ablation (num_sink 0, window N, no s_aux) held at every layer
       against plain on the same inputs (:func:`_checked_forward`, gated
       by _layer_gate); gated on its verdict.
    e. the bf16 tree dropped but for the first and last layers' wq,
       gate_up, down and the lm_head; ``load_hf_checkpoint(path,
       quant="int4")``: seconds, device peak (gated below the bf16
       tree's bytes), :func:`_int4_gates`; one engine row
       (:func:`_quant_engine`, ``int4_row``: its keyword arguments,
       default phase 9's row at 8 slots, one warm and one timed chunk)
       with its launches.
    On the card the forward kernel must launch once per layer and
    admission (per prompt and stack in f), the bf16 decode once per layer
    and pool step.
    """
    from sink_attention_tpu_torch.serving.divergence import engine_requests
    import gc
    import os
    import resource
    import shutil
    import tempfile

    from sink_attention_tpu_torch.models import load_hf_checkpoint
    from sink_attention_tpu_torch.scripts import golden_gpt_oss
    from sink_attention_tpu_torch.serving import (ContinuousBatchingEngine,
                                                  SamplingParams)

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    L = cfg.num_layers
    int4_row = int4_row or dict(max_batch=8, prompt_len=64, max_len=4096,
                                bucket=64, chunk=32, warm=1, timed=1,
                                profile_steps=2)
    report, errors = {}, []

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def reset():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    def launches(label, want):
        got = _launch_counts()
        if cuda:
            _check_launches(got, want, label, errors)
        return got

    base = workdir or tempfile.gettempdir()
    need = checkpoint_bytes(cfg)
    free = shutil.disk_usage(base).free
    report["disk"] = {"dir": base, "free_bytes": free, "need_bytes": need}
    if free < need * 1.05 + (1 << 30):
        errors.append(f"checkpoint phase: {base} has {free / 1e9:.2f} GB "
                      f"free, the checkpoint needs {need / 1e9:.2f} GB")
        return report, errors
    path = tempfile.mkdtemp(prefix="sink_ckpt_", dir=base)
    try:
        # a. write
        keep = sorted({0, L // 2 - 1 if L > 1 else 0, L - 1})
        rep_w, dense, kept = write_mxfp4_checkpoint(path, cfg, dev,
                                                    keep=keep)
        report["write"] = rep_w
        log(f"checkpoint written: {rep_w['bytes']} bytes in "
            f"{rep_w['seconds']:.1f} s ({path})")

        # b. load in bf16
        reset()
        with _RssPeak() as rss:
            t0 = time.perf_counter()
            cfg_l, params = load_hf_checkpoint(path, dtype=torch.bfloat16,
                                               device=dev)
            sync()
            load_s = time.perf_counter() - t0
        report["load"] = {
            "seconds": load_s, "tree_bytes": tree_bytes(params),
            "device_peak_gb": peak(),
            "host_rss_start_gb": rss.start_gb,
            "host_rss_peak_gb": rss.peak_gb,
            "host_ru_maxrss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
            "bytes_per_s": rep_w["bytes"] / load_s}
        if cfg_l != cfg:
            errors.append("checkpoint load: from_hf_config gave another "
                          "configuration than the one written")
        report["load"]["leaves_held"] = _load_gates(params, cfg, dense,
                                                    kept, errors)
        report["load"]["expert_layers_held"] = keep
        del dense, kept
        log("checkpoint load (bf16): " + json.dumps(report["load"]))

        # c. serve the loaded tree
        reset()
        reqs = engine_requests(n_requests, cfg.vocab_size, 0, prompt, new)
        eng = ContinuousBatchingEngine(params, cfg, max_batch=max_batch,
                                       max_len=max_len,
                                       prefill_bucket=bucket,
                                       dtype=torch.bfloat16, device=dev)
        rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        _reset_launches()
        sync()
        t0 = time.perf_counter()
        out = eng.run()
        sync()
        rep = report["engine"] = {"run_ms": (time.perf_counter() - t0) * 1e3}
        rep["pool_steps"] = eng.pool_steps
        rep["launches"] = launches("checkpoint engine", {
            "flash_fwd": L * n_requests, "decode": L * eng.pool_steps,
            "decode_int8": 0, "decode_fp8": 0})
        tokens = [out[r] for r in rids]
        rep["tokens"] = sum(len(t) for t in tokens)
        rep["tokens_per_s"] = rep["tokens"] / (rep["run_ms"] / 1e3)
        rep["peak_memory_gb"] = peak()
        for (_, m), toks in zip(reqs, tokens):
            if len(toks) != m or not all(0 <= t < cfg.vocab_size
                                         for t in toks):
                errors.append(f"checkpoint engine: a request asked for {m} "
                              f"tokens and got {len(toks)}")
        del eng
        with torch.no_grad():
            stats, _ = _engine_replay(
                params, cfg, reqs, tokens, None, device=dev,
                dtype=torch.bfloat16, max_len=max_len, bucket=bucket,
                steps=replay_steps, stop_slot_at=replay_steps // 2)
        _layer_gate(stats, "decode", rep, errors)
        _layer_gate(_admission_checks(params, cfg, [p for p, _ in reqs],
                                      bucket, dev), "prefill", rep, errors)
        log("checkpoint engine: " + json.dumps(rep))

        # d. resume
        reset()
        _reset_launches()
        sampled = (reqs[1][0], new[1], SamplingParams(temperature=1.0,
                                                      top_k=4))
        report["resume"] = _resume_check(
            params, cfg, dev, reqs, sampled, max_batch=max_batch,
            max_len=max_len, bucket=bucket, chunks=resume[0],
            chunk=resume[1], snap=os.path.join(path, "engine.snapshot"),
            errors=errors)
        report["resume"]["launches"] = launches("checkpoint resume", {
            "flash_fwd": 2 * L * (n_requests + 1),
            "decode": L * sum(report["resume"]["pool_steps"]),
            "decode_int8": 0, "decode_fp8": 0})
        log("checkpoint resume: " + json.dumps(report["resume"]))

        # f. the golden protocol on the bf16 tree
        reset()
        _reset_launches()
        t0 = time.perf_counter()
        gstats = {"kernel": [], "ablation": []}
        checks = {k: _checked_forward(st) for k, st in gstats.items()}

        def golden_attn(q, k, v, num_sink, window_size, s_aux=None):
            # the ablation is the stack that calls without s_aux
            return checks["ablation" if s_aux is None else "kernel"](
                q, k, v, num_sink, window_size, s_aux)

        g = golden_gpt_oss.run(path, golden[0], golden[1], None, True, None,
                               device=dev, loaded=(cfg, params),
                               attn=golden_attn)
        rep = report["golden"] = {k: g[k] for k in (
            "kernel", "ablation", "top1_kernel", "top1_ablation", "ratio",
            "verdict", "eager")}
        rep["seconds"] = time.perf_counter() - t0
        # per prompt: the kernel stack and the ablation's, through the
        # forward kernel; the plain stack's, not
        rep["launches"] = launches("golden", {
            "flash_fwd": 2 * L * golden[0], "decode": 0})
        for name, st in gstats.items():
            if len(st) != L * golden[0]:
                errors.append(f"golden: {len(st)} {name} forwards checked, "
                              f"expected {L * golden[0]}")
            _layer_gate(st, f"golden_{name}", rep, errors)
        if not g["verdict"]:
            errors.append("golden: the kernel stack is not strictly closer "
                          "to eager than the full-causal ablation")

        # e. int4 streaming load
        li = (0, L - 1)
        ref = {("lm_head",): params["lm_head"].clone()}
        for i in li:
            ref[("layers", i, "attn", "wq")] = params["layers"][i]["attn"][
                "wq"].clone()
            for k in ("gate_up", "down"):
                ref[("layers", i, "mlp", k)] = params["layers"][i]["mlp"][
                    k].clone()
        bf16_bytes = report["load"]["tree_bytes"]
        del params
        reset()
        t0 = time.perf_counter()
        _, params4 = load_hf_checkpoint(path, quant="int4", device=dev)
        sync()
        rep = report["int4_load"] = {
            "seconds": time.perf_counter() - t0, "device_peak_gb": peak(),
            "tree_bytes": tree_bytes(params4),
            "ref_bytes": tree_bytes(list(ref.values()))}
        if cuda and not rep["device_peak_gb"] * 1e9 < bf16_bytes:
            errors.append(f"int4 checkpoint load peaked at "
                          f"{rep['device_peak_gb']:.2f} GB, not below the "
                          f"bf16 tree's {bf16_bytes / 1e9:.2f} GB")
        _int4_gates(params4, ref, errors)
        del ref
        reset()
        row, eng = _quant_engine(params4, cfg, dev, **int4_row)
        rep["engine"] = row
        if not row["tokens_ok"]:
            errors.append("int4 checkpoint engine: malformed tokens")
        if cuda:
            _check_launches(row["launches"], {
                "flash_fwd": L * int4_row["max_batch"],
                "decode": L * eng.pool_steps, "decode_int8": 0,
                "decode_fp8": 0}, "int4 checkpoint engine", errors)
        del eng, params4
        log("checkpoint int4 load and engine: " + json.dumps(rep))
    finally:
        shutil.rmtree(path)
    reset()
    parts = (report["engine"], report["resume"], report["golden"],
             report["int4_load"]["engine"])
    report["launches"] = {name: sum(p["launches"][name] for p in parts)
                          for name in ("flash_fwd", "decode")}
    return report, errors


# ---------------------------------------------------------------------------
# Phase 11: sequence-parallel attention over torch.distributed
# ---------------------------------------------------------------------------

SP_N = 65536
# (entry point, num_sink, window, worlds): the window as a number or as a
# fraction of N ("N", "3N/8", "N/16"), so a CPU rehearsal at a small N
# keeps each case's regime (halo, full rotation, skip-ahead)
SP_CASES = [
    ("sharded", 0, 128, (1, 2, 4)),        # a sliding layer: halo SP
    ("sharded", 0, "N", (2, 4)),           # a full layer: full rotation
    ("ring", 4, "3N/8", (4,)),             # skip-ahead, 3 steps < 4
    ("sp", 4, "N/16", (1, 4)),             # the sink broadcast
    ("ulysses", 0, 128, (1, 2, 4)),        # the head/sequence all-to-all
    ("ulysses_packed", 0, 128, (4,)),      # phase 5's pack lengths
]
SP_KERNELS = ("flash_fwd", "flash_dq", "flash_dkdv", "packed_fwd",
              "packed_dq", "packed_dkdv")


def _sp_window(w, n):
    return {"N": n, "3N/8": 3 * n // 8, "N/16": n // 16}.get(w, w)


def _sp_counters():
    from sink_attention_tpu_torch.ops import flash, packed
    return {"flash_fwd": flash.flash_fwd_kernel,
            "flash_dq": flash.flash_dq_kernel,
            "flash_dkdv": flash.flash_dkdv_kernel,
            "packed_fwd": packed.packed_fwd_kernel,
            "packed_dq": packed.packed_dq_kernel,
            "packed_dkdv": packed.packed_dkdv_kernel}


def sp_expected_launches(entry, num_sink, window, rank, world, n_local):
    """Each kernel's launches on ``rank`` for one forward and backward of
    ``entry``: one chunk kernel per partial, none for a partial whose
    ``col_hi`` clips every column (the sink partial of halo SP on rank 0,
    of the ring on a rank whose rotation reached chunk 0)."""
    from sink_attention_tpu_torch.parallel import ring_num_steps
    if entry == "ulysses_packed":
        return {k: int(k.startswith("packed")) for k in SP_KERNELS}
    if entry == "ulysses":
        n = 1
    elif entry == "sp" or (entry == "sharded" and window - 1 <= n_local
                           and num_sink <= n_local):
        halo = min(-(-max(window - 1, 0) // 128) * 128, n_local)
        n = 1 + (num_sink > 0 and rank * n_local - halo > 0)
    else:
        steps = ring_num_steps(world, n_local, window)
        if num_sink > n_local:
            steps = world
        sink = steps < world and num_sink > 0 and rank - steps + 1 > 0
        n = steps + sink
    return {k: 0 if k.startswith("packed") else n for k in SP_KERNELS}


def _sp_case(entry, num_sink, window, n, rank, world, device, seed):
    """One case on this rank: the entry point's forward and backward
    (a warm call, then one timed by CUDA events on this rank's stream)
    with the launches of the timed call, then the single-process kernel
    over the whole sequence as the reference (its output, dQ, dK, dV
    slices and d s_aux summed over the group)."""
    from sink_attention_tpu_torch.ops.packed import (pack_lengths,
                                                     pack_positions)
    from sink_attention_tpu_torch import parallel
    from sink_attention_tpu_torch.ops import (sink_flash_attention,
                                              sink_flash_attention_packed)
    from sink_attention_tpu_torch.parallel._collectives import psum

    from sink_attention_tpu_torch.models import ModelConfig

    cuda = device.type == "cuda"
    cfg = ModelConfig.gpt_oss_20b()       # its attention widths, 64/8, D=64
    H_q, H_kv, D = ((cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) if cuda
                    else (8, 4, 64))
    dt = torch.bfloat16 if cuda else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*s):
        return torch.randn(*s, generator=gen, device=device).to(dt)

    q, k, v, do = (rand(1, H_q, n, D), rand(1, H_kv, n, D),
                   rand(1, H_kv, n, D), rand(1, H_q, n, D))
    aux = torch.randn(H_q, generator=gen, device=device)
    positions = None
    if entry == "ulysses_packed":
        positions = pack_positions(pack_lengths(n, PACK_MIN, PACK_MAX, 0))[
            None].to(device)
    n_local = n // world
    rows = slice(rank * n_local, (rank + 1) * n_local)
    fn = {"sp": parallel.sp_sink_flash_attention,
          "ulysses": parallel.ulysses_sink_flash_attention,
          "ring": parallel.ring_sink_flash_attention,
          "sharded": parallel.sharded_sink_flash_attention}.get(entry)

    events = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
              if cuda else [])

    def mark(i):
        if cuda:
            events[i].record()

    def run():
        leaves = [t[:, :, rows].clone().requires_grad_(True)
                  for t in (q, k, v)] + [aux.clone().requires_grad_(True)]
        kw = dict(num_sink=num_sink, window_size=window, s_aux=leaves[3])
        mark(0)
        if positions is not None:
            out = parallel.ulysses_sink_flash_attention_packed(
                *leaves[:3], positions, **kw)
        else:
            out = fn(*leaves[:3], **kw)
        mark(1)
        out.backward(do[:, :, rows])
        mark(2)
        return out, leaves

    counters = _sp_counters()
    run()                                           # warm
    for c in counters.values():
        c.launches = 0
    out, leaves = run()
    launches = {name: c.launches for name, c in counters.items()}
    rep = {"rank": rank, "launches": launches}
    if cuda:
        torch.cuda.synchronize()
        rep.update(fwd_ms=events[0].elapsed_time(events[1]),
                   bwd_ms=events[1].elapsed_time(events[2]))
    want = sp_expected_launches(entry, num_sink, window, rank, world,
                                n_local)
    if not cuda:
        want = {k: 0 for k in SP_KERNELS}
    rep["launches_expected"] = want
    daux = psum(leaves[3].grad)

    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v, aux)]
    if positions is not None:
        ref = sink_flash_attention_packed(*ref_leaves[:3], positions,
                                          num_sink, window,
                                          s_aux=ref_leaves[3])
    else:
        ref = sink_flash_attention(*ref_leaves[:3], num_sink, window,
                                   s_aux=ref_leaves[3])
    ref.backward(do)
    rep["out"] = _attn_compare(out.detach(), ref.detach()[:, :, rows])
    for name, got, r in zip(("dq", "dk", "dv"), leaves, ref_leaves):
        rep[name] = _grad_compare(got.grad, r.grad[:, :, rows])
    rep["ds_aux"] = _grad_compare(daux, ref_leaves[3].grad)
    rep["finite"] = bool(torch.isfinite(out.float()).all()) and all(
        bool(torch.isfinite(t.grad.float()).all()) for t in leaves)
    if cuda:
        rep["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rep


def _sp_rank(rank, world, backend, init, n, device, cases, out_dir):
    """One rank of a phase-11 world: every case of ``cases`` in turn;
    writes its rows to ``out_dir/rank<r>.json``."""
    import os
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:                  # the ranks share the host's cores
        torch.set_num_threads(2)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    try:
        rows = []
        for i, (entry, ns, w, _) in enumerate(cases):
            rows.append(_sp_case(entry, ns, _sp_window(w, n), n, rank, world,
                                 dev, 100 + i))
            if dev.type == "cuda":   # the ranks share one card
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sp_phase(device, *, n=SP_N, worlds=(1, 2, 4), cases=SP_CASES):
    """Phase 11: each case of ``cases`` in each of its worlds, one process
    per rank (spawned, all on ``device``): a world of 1 over NCCL on the
    card (gloo on the CPU), larger worlds over gloo. Returns (report,
    launches summed over every rank and case, errors). Gates per rank:
    the output against the single-process kernel's slice as phase 2's
    forward rows (cosine >= MIN_COS, error <= FLASH_TOL x scale), dQ, dK,
    dV and d s_aux summed over the ranks as its gradient rows (cosine >=
    MIN_COS, error <= BWD_TOL of the largest value), every value finite,
    and on the card each kernel's launches as the schedule predicts."""
    import tempfile
    import torch.multiprocessing as mp

    dev = torch.device(device)
    if dev.type == "cuda":   # the ranks share the card with this process
        torch.cuda.empty_cache()
    report, errors = [], []
    total = {k: 0 for k in SP_KERNELS}
    for world in worlds:
        mine = [c for c in cases if world in c[3]]
        if not mine:
            continue
        backend = "nccl" if world == 1 and dev.type == "cuda" else "gloo"
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="sp_phase_") as tmp:
            init = f"tcp://localhost:{_free_port()}"
            mp.start_processes(_sp_rank, args=(world, backend, init, n,
                                               str(dev), mine, tmp),
                               nprocs=world, join=True,
                               start_method="spawn")
            ranks = []
            for r in range(world):
                with open(f"{tmp}/rank{r}.json") as f:
                    ranks.append(json.load(f))
        seconds = time.perf_counter() - t0
        for i, (entry, ns, w, _) in enumerate(mine):
            rows = [ranks[r][i] for r in range(world)]
            label = (f"{entry} sink={ns} W={_sp_window(w, n)} world={world} "
                     f"({backend})")
            report.append({"case": label, "seconds_world": seconds,
                           "ranks": rows})
            for row in rows:
                r = row["rank"]
                out = row["out"]
                if not (out["cos"] >= MIN_COS
                        and out["err"] <= FLASH_TOL * out["scale"]):
                    errors.append(f"SP {label} rank {r}: output vs the "
                                  f"kernel: cosine {out['cos']:.6f}, error "
                                  f"{out['err']:.3e}")
                for g in ("dq", "dk", "dv", "ds_aux"):
                    s = row[g]
                    if not (s["cos"] >= MIN_COS and s["rel_err"] <= BWD_TOL):
                        errors.append(f"SP {label} rank {r}: {g} vs the "
                                      f"kernel: cosine {s['cos']:.6f}, "
                                      f"error {s['rel_err']:.3e}")
                if not row["finite"]:
                    errors.append(f"SP {label} rank {r}: non-finite values")
                if row["launches"] != row["launches_expected"]:
                    errors.append(f"SP {label} rank {r}: launches "
                                  f"{row['launches']}, expected "
                                  f"{row['launches_expected']}")
                for k in SP_KERNELS:
                    total[k] += row["launches"][k]
    return report, total, errors


# ---------------------------------------------------------------------------
# Phase 12: tensor, pipeline and FSDP parallelism over a device mesh
# ---------------------------------------------------------------------------

# 12b's meshes: (label, mesh, fsdp); 12c's pipeline (S=2, M=2, V=1)
MESH_TRAIN = [("fsdp dp2 x tp2", {"data": 2, "seq": 1, "model": 2}, True),
              ("sp2 x tp2", {"data": 1, "seq": 2, "model": 2}, False)]
MESH_PIPE = {"pipe": 2, "model": 2}
# 12a and phase 9's 20b trees cut to 6 of 24 after a full run on one H100
# took 1145 s of its 1200 s limit (host-bound phases, which swing 30-60%
# between runs); phase 10 keeps 12: at 6 its int4 load's fixed costs put
# the load's peak above the bf16 tree's, which its gate forbids
MESH_SERVE_LAYERS = 6  # 12a's depth in the full script (of 24)
CHECKPOINT_LAYERS = 12  # phase 10's depth in the full script (of 24)
QUANT_LAYERS = 6  # phase 9's gpt-oss-20b depth in the full script (of 24)
PIPE_MICRO = 2
MESH_SERVE = {4: [(4, None)], 2: [(2, None), (2, "int8")]}  # world: (tp, KV)
NAMED = ("lm_head", "layers[0].attn.sinks", "layers[0].attn.wq",
         "layers[1].attn.wk")
MESH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkdv", "decode",
                "decode_int8")


def _named(tree):
    """Phase 4's named leaves of a parameter (or gradient) tree."""
    a0, a1 = tree["layers"][0]["attn"], tree["layers"][1]["attn"]
    return tree["lm_head"], a0["sinks"], a0["wq"], a1["wk"]


def _vs_big(a: torch.Tensor, b: torch.Tensor, rows: int = 256):
    """(1 - cosine, ||a - b|| / ||b||) of two large tensors, in fp32 chunks
    of ``rows`` rows (fp64 sums): the lm_head's gradient whole in fp64
    would take 9 GB. The cosine cannot see a scale; the relative error
    does."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    dot = na = nb = nd = 0.0
    for i in range(0, a.shape[0], rows):
        x, y = a[i:i + rows].float(), b[i:i + rows].float()
        dot += float((x * y).sum(dtype=torch.float64))
        na += float((x * x).sum(dtype=torch.float64))
        nb += float((y * y).sum(dtype=torch.float64))
        nd += float(((x - y) ** 2).sum(dtype=torch.float64))
    return 1.0 - dot / math.sqrt(na * nb), math.sqrt(nd / nb)


def _mesh_counters():
    from sink_attention_tpu_torch.ops import decode, flash
    return {"flash_fwd": (flash.flash_fwd_kernel, "launches"),
            "flash_dq": (flash.flash_dq_kernel, "launches"),
            "flash_dkdv": (flash.flash_dkdv_kernel, "launches"),
            "decode": (decode.decode_kernel, "launches"),
            "decode_int8": (decode.decode_kernel, "launches_int8")}


def _read_launches(counters, reset=False):
    """{name: launches} of ``counters`` (name -> (wrapper, attribute)),
    each set to 0 after it is read where ``reset``."""
    out = {}
    for name, (fn, attr) in counters.items():
        out[name] = getattr(fn, attr)
        if reset:
            setattr(fn, attr, 0)
    return out


def _mesh_launches(reset=False):
    return _read_launches(_mesh_counters(), reset)


def _serve_reference(cfg, dev, batch, prompt_len, new_tokens, dtype, tmp):
    """12a's unsharded reference on phase 3's weights and prompts: greedy
    tokens over a bf16 and an int8 KV cache, and the prefill logits
    (saved to ``tmp`` for the ranks) with a ``_noisy`` control's mean row
    cosine to them."""
    from sink_attention_tpu_torch.serving.divergence import noisy as _noisy
    from sink_attention_tpu_torch.models import forward_prefill, init_params
    from sink_attention_tpu_torch.ops import flash
    from sink_attention_tpu_torch.serving import greedy_generate

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dtype=dtype, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    ref = {"tokens": {q: greedy_generate(params, cfg, prompts, new_tokens,
                                         dtype=dtype, quant=q,
                                         device=dev).tolist()
                      for q in (None, "int8")}}
    with torch.inference_mode():
        logits = forward_prefill(params, cfg, prompts)[0]
        noisy = forward_prefill(params, cfg, prompts, attn_impl=_noisy(
            flash.sink_flash_attention, 1))[0]
        ref["control_all_cos"] = _row_cos(noisy, logits)
        del noisy
        torch.save(logits.cpu(), f"{tmp}/serve_logits.pt")
    ref["prompts"] = prompts.tolist()
    del params, logits
    return ref


def _train_reference(cfg, dev, rows, seq_len, dtype, tmp):
    """12b/12c's single-process reference on phase 4's weights: the
    per-token losses and the named leaves' gradients of the mean loss,
    with the kernels (saved to ``tmp`` for the ranks), and a control
    with bf16-sized noise in every attention output: 1 - cosine
    (``control``) and the relative error (``control_rel``) of each to the
    reference."""
    from sink_attention_tpu_torch.serving.divergence import noisy as _noisy
    from sink_attention_tpu_torch.models import forward_prefill, init_params
    from sink_attention_tpu_torch.ops import flash

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dtype=dtype, device=dev)
    batch = torch.randint(0, cfg.vocab_size, (rows, seq_len + 1),
                          generator=gen, device=dev)
    targets = _named(params)

    def grads_of(attn_impl):
        logits, _ = forward_prefill(params, cfg, batch[:, :-1],
                                    attn_impl=attn_impl)
        losses = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            batch[:, 1:].reshape(-1), reduction="none")
        del logits
        return losses.detach(), torch.autograd.grad(losses.mean(), targets)

    for t in targets:
        t.requires_grad_(True)
    losses, grads = grads_of(flash.sink_flash_attention)
    torch.save({"losses": losses.cpu(), "grads": [g.cpu() for g in grads]},
               f"{tmp}/train_ref.pt")
    c_losses, c_grads = grads_of(_noisy(flash.sink_flash_attention, 7))
    vs = {n: _vs_big(a, b) for n, a, b in zip(
        ("token_losses",) + NAMED, (c_losses,) + c_grads, (losses,) + grads)}
    del params, grads, c_grads
    return {"loss": float(losses.mean()),
            "control": {n: d for n, (d, _) in vs.items()},
            "control_rel": {n: r for n, (_, r) in vs.items()}}


def _rank_common(params, report, cuda):
    report["param_bytes"] = tree_bytes(params)
    if cuda:
        report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9


def _decode_plain_cached(q, cache, s_aux=None):
    """The decode kernel's plain version over a ``SinkKVCache`` as it
    stands (bf16, int8 or fp8 storage)."""
    from sink_attention_tpu_torch.ops import decode
    return decode.decode_plain(q, cache.k, cache.v, decode.cache_state(cache),
                               s_aux, **decode.cache_args(cache))


def _mesh_serve(cfg, dev, tmp, sizes, tp, quant):
    """12a on this rank: make_sharded_generate at ``tp`` over ``quant``
    KV, weights drawn sharded (init_params(shardings=)). After a short
    warm-up call, the run timed whole and its launches counted. Then the
    same run replayed part by part, as ``generate`` runs it: its prefill
    into fresh caches, then its tokens fed back one decode step at a
    time, each part timed with CUDA events between barriers and every
    layer's attention recorded; after each part's timing, each recorded
    call is held kernel against plain (the prefill's forward; each decode
    step's decode over its cache, which no later call of that step
    changes). Rank 0 holds the prefill logits to the unsharded model's."""
    import torch.distributed as dist

    from sink_attention_tpu_torch.models import (forward_decode,
                                                 forward_prefill, init_params,
                                                 make_caches)
    from sink_attention_tpu_torch.ops import decode, flash
    from sink_attention_tpu_torch.parallel import make_mesh, tp_local_config
    from sink_attention_tpu_torch.serving import make_sharded_generate

    cuda = dev.type == "cuda"
    dtype, batch, prompt_len, new_tokens = sizes["serve"]
    mesh = make_mesh({"model": tp}, device=dev)
    cfg_local = tp_local_config(cfg, tp)
    group = mesh.group("model") if tp > 1 else None
    shardings, generate = make_sharded_generate(cfg, mesh, dtype=dtype,
                                                quant=quant)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dtype=dtype, device=dev,
                         shardings=shardings)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=gen, device=dev)
    rep = {"task": f"12a serve tp{tp}{' int8 KV' if quant else ''}",
           "rank": dist.get_rank()}
    errors = rep.setdefault("errors", [])
    generate(params, prompts[:1, :64], 2)
    dist.barrier()
    _mesh_launches(reset=True)
    toks, rep["generate_ms"] = _elapsed_ms(
        lambda: generate(params, prompts, new_tokens), cuda)
    rep["launches"] = _mesh_launches()
    rep["tokens"] = toks.tolist()
    rep["finite"] = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    L = cfg.num_layers
    kv = "decode_int8" if quant == "int8" else "decode"
    rep["launches_expected"] = {k: 0 for k in MESH_KERNELS}
    if cuda:
        rep["launches_expected"].update(flash_fwd=L, **{kv: L * (
            new_tokens - 1)})

    calls = []

    def prefill_attn(q, k, v, num_sink, window_size, s_aux):
        o = flash.sink_flash_attention(q, k, v, num_sink, window_size,
                                       s_aux=s_aux)
        calls.append((o, (q, k, v, num_sink, window_size, s_aux)))
        return o

    def decode_attn(q, cache, s_aux=None):
        o = decode.sink_decode_attention_cached(q, cache, s_aux)
        calls.append((o, (q, cache, s_aux)))
        return o

    stats = {"prefill": [], "decode": []}
    with torch.inference_mode():
        caches = make_caches(cfg_local, batch, prompt_len + new_tokens,
                             dtype=dtype, quant=quant, device=dev)
        dist.barrier()
        (logits, caches), rep["prefill_ms"] = _elapsed_ms(
            lambda: forward_prefill(params, cfg_local, prompts, caches,
                                    attn_impl=prefill_attn, group=group),
            cuda)
        rep["finite"] &= bool(torch.isfinite(logits).all())
        if dist.get_rank() == 0:
            ref = torch.load(f"{tmp}/serve_logits.pt").to(dev)
            rep["all_cos"] = _row_cos(logits, ref)
            del ref
        del logits
        for o, (q, k, v, ns, w, aux) in calls:
            stats["prefill"].append(_attn_compare(o, flash.flash_fwd_plain(
                q, k, v, aux, ns, w)[0]))
        step_ms = []
        for i in range(new_tokens - 1):
            calls.clear()
            dist.barrier()   # no rank's checks in another's timed step
            (logits, caches), ms = _elapsed_ms(lambda: forward_decode(
                params, cfg_local, toks[:, i:i + 1], caches, prompt_len + i,
                attn_impl=decode_attn, group=group), cuda)
            step_ms.append(ms)
            rep["finite"] &= bool(torch.isfinite(logits).all())
            for o, (q, cache, aux) in calls:
                stats["decode"].append(_attn_compare(
                    o, _decode_plain_cached(q, cache, aux)))
        del calls, caches
    rep["decode_ms_per_step"] = sum(step_ms) / max(len(step_ms), 1)
    rep["decode_ms_steps"] = step_ms
    for name, n in (("prefill", L), ("decode", L * (new_tokens - 1))):
        _layer_gate(stats[name], name, rep, errors)
        if len(stats[name]) != n:
            errors.append(f"{len(stats[name])} {name} attention calls "
                          f"checked, not {n}")
    _rank_common(params, rep, cuda)
    return rep


def _grad_gate(grads, tmp, rep):
    """Rank 0: 1 - cosine (``vs_single``) and the relative error
    (``rel_vs_single``) of the whole named gradients, and of the gathered
    per-token losses (``rep["token_losses"]``), to the single-process
    reference's."""
    ref = torch.load(f"{tmp}/train_ref.pt")
    losses = rep.pop("token_losses")
    vs = {"token_losses": _vs_big(losses.cpu(),
                                  ref["losses"].reshape(losses.shape))}
    vs.update({n: _vs_big(g, r.to(g.device)) for n, g, r
               in zip(NAMED, grads, ref["grads"])})
    rep["vs_single"] = {n: d for n, (d, _) in vs.items()}
    rep["rel_vs_single"] = {n: r for n, (_, r) in vs.items()}


def _live_records(records):
    """The recorded attention calls whose output reached the loss with a
    cotangent: a pipeline's dead steps get none (their ``do`` is 0), and
    a checkpointed layer's recompute registers hooks that never fire."""
    return [r for r in records if "do" in r and bool(r["do"].any())]


def _layer_checks(records, rep):
    """Phase 4's layer checks on the live records: the forward, kernel
    against plain, and the gradients (``_check_layer_grads``)."""
    from sink_attention_tpu_torch.ops import flash
    stats = []
    for rec in records:
        q, k, v = rec["x"]
        ns, w = rec["geom"]
        o = flash.sink_flash_attention(q, k, v, ns, w, s_aux=rec["aux"])
        stats.append(_attn_compare(o, flash.flash_fwd_plain(
            q, k, v, rec["aux"], ns, w)[0]))
    errors = rep.setdefault("errors", [])
    _layer_gate(stats, "forward", rep, errors)
    _check_layer_grads(records, _attn_grads, rep, errors)


def _assemble(piece, mesh):
    """Every rank's [b, n] piece of the per-token losses, placed by its
    data and seq coordinates (the model ranks' pieces are equal)."""
    from sink_attention_tpu_torch.parallel._collectives import (
        all_gather_tensor)
    world = all_gather_tensor(piece[None], 0)
    b, n = piece.shape
    dp, sp = (mesh.shape.get(a, 1) for a in ("data", "seq"))
    out = torch.empty((dp * b, sp * n), dtype=piece.dtype,
                      device=piece.device)
    for rank in range(world.shape[0]):
        coords = dict(zip(mesh.axis_names, (int(c[0]) for c in (
            mesh.ranks == rank).nonzero())))
        d, s = coords.get("data", 0), coords.get("seq", 0)
        out[d * b:(d + 1) * b, s * n:(s + 1) * n] = world[rank]
    return out


def _mesh_train(cfg, dev, tmp, sizes, label, mesh_sizes, fsdp):
    """12b on this rank: one SGD step (momentum 0.9: its first update is
    plain SGD's, and its state shows the optimizer's bytes) of the mesh
    make_train_step(remat=True), weights drawn sharded, each layer's
    attention recorded on the live path; the per-token losses of the
    step's weights (a forward before it) and the named gradients it
    applied, gathered, against the single-process reference."""
    import torch.distributed as dist

    from sink_attention_tpu_torch.models import init_params
    from sink_attention_tpu_torch.ops import flash
    from sink_attention_tpu_torch.parallel import (make_mesh, make_train_step,
                                                   param_leaves,
                                                   param_shardings)
    from sink_attention_tpu_torch.parallel.train import (data_rows,
                                                         mesh_token_losses)

    cuda = dev.type == "cuda"
    dtype, rows, seq_len, lr = sizes["train"]
    mesh = make_mesh(mesh_sizes, device=dev)
    shardings = param_shardings(cfg, mesh, fsdp_axis="data" if fsdp
                                else None)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dtype=dtype, device=dev,
                         shardings=shardings)
    batch = torch.randint(0, cfg.vocab_size, (rows, seq_len + 1),
                          generator=gen, device=dev)
    rep = {"task": f"12b train {label}", "rank": dist.get_rank()}
    with torch.no_grad():
        losses = _assemble(mesh_token_losses(
            params, cfg, mesh, shardings, data_rows(batch, mesh)), mesh)
    records = []
    opt = torch.optim.SGD(param_leaves(params), lr=lr, momentum=0.9)
    step, _ = make_train_step(cfg, mesh, opt, fsdp=fsdp, remat=True,
                              attn_impl=_recording(
                                  flash.sink_flash_attention, records))
    _mesh_launches(reset=True)
    loss, rep["step_ms"] = _elapsed_ms(lambda: step(params, batch), cuda)
    rep["launches"] = _mesh_launches()
    rep["loss"] = float(loss)
    L = cfg.num_layers
    rep["launches_expected"] = {k: 0 for k in MESH_KERNELS}
    if cuda:   # remat: each layer's forward twice, its backward once
        rep["launches_expected"].update(flash_fwd=2 * L, flash_dq=L,
                                        flash_dkdv=L)
    leaves = param_leaves(params)
    rep["finite"] = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(t.grad).all()) for t in leaves)
    grads = [s.gather(t.grad) for s, t in zip(_named(shardings),
                                              _named(params))]
    _rank_common(params, rep, cuda)
    rep["opt_state_bytes"] = sum(t.nbytes for st in opt.state.values()
                                 for t in st.values()
                                 if torch.is_tensor(t))
    rep["leaf_bytes"] = [t.nbytes for t in leaves]
    rep["data_split"] = ["data" in s.spec for s in param_leaves(shardings)]
    if dist.get_rank() == 0:
        rep["token_losses"] = losses
        _grad_gate(grads, tmp, rep)
    del grads
    _layer_checks(_live_records(records), rep)
    return rep


def _mesh_pipe(cfg, dev, tmp, sizes):
    """12c on this rank: make_pp_train_step(remat=True) over MESH_PIPE
    (S=2, M=2, V=1; without remat the T=3 steps' activations of 4 ranks
    outgrow the card), weights drawn with this rank's TP blocks of every layer
    (init_params(shardings=)) and stacked to its stage; the logits'
    per-token losses before the step, one SGD step (momentum 0.9) with
    every attention call recorded, the named gradients gathered and
    unstacked, against the single-process reference."""
    import torch.distributed as dist

    from sink_attention_tpu_torch.models import init_params
    from sink_attention_tpu_torch.ops import flash
    from sink_attention_tpu_torch.parallel import (make_mesh, param_leaves,
                                                   param_shardings, pp,
                                                   replicated)
    from sink_attention_tpu_torch.parallel.mesh import tree_map

    cuda = dev.type == "cuda"
    dtype, rows, seq_len, lr = sizes["train"]
    mesh = make_mesh(MESH_PIPE, device=dev)
    S, s_idx = mesh.shape["pipe"], mesh.axis_index("pipe")
    layer_sh = param_shardings(cfg, mesh)
    layer_sh["lm_head"] = replicated(mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = init_params(cfg, gen, dtype=dtype, device=dev,
                       shardings=layer_sh)
    batch = torch.randint(0, cfg.vocab_size, (rows, seq_len + 1),
                          generator=gen, device=dev)
    stacked = pp.stack_pipeline_params(tree, S)
    del tree
    params = dict(stacked, stages=tree_map(
        lambda x: x[s_idx:s_idx + 1].clone(), stacked["stages"]))
    del stacked
    shardings = pp.pipeline_param_shardings(cfg, mesh, model_axis="model")
    rep = {"task": "12c pipeline pipe2 x tp2", "rank": dist.get_rank()}
    with torch.no_grad():
        logits = pp.pipeline_forward(params, cfg, batch[:, :-1], S,
                                     PIPE_MICRO, group=mesh.group("pipe"),
                                     model_group=mesh.group("model"))
        losses = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, logits.shape[-1]),
            batch[:, 1:].reshape(-1), reduction="none").reshape(rows, -1)
        del logits
    records = []
    opt = torch.optim.SGD(param_leaves(params), lr=lr, momentum=0.9)
    step, _ = pp.make_pp_train_step(cfg, mesh, opt,
                                    num_microbatches=PIPE_MICRO, remat=True,
                                    attn_impl=_recording(
                                        flash.sink_flash_attention, records))
    _mesh_launches(reset=True)
    loss, rep["step_ms"] = _elapsed_ms(lambda: step(params, batch), cuda)
    rep["launches"] = _mesh_launches()
    rep["loss"] = float(loss)
    T = PIPE_MICRO + S - 1
    per = cfg.num_layers // S
    rep["launches_expected"] = {k: 0 for k in MESH_KERNELS}
    if cuda:   # the stage on every one of the T steps, dead ones
        # included; remat: each layer's forward twice, its backward once
        rep["launches_expected"].update(flash_fwd=2 * T * per,
                                        flash_dq=T * per, flash_dkdv=T * per)
    leaves = param_leaves(params)
    rep["finite"] = bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(t.grad).all()) for t in leaves)
    st, sh = params["stages"]["attn"], shardings["stages"]["attn"]
    whole = {k: sh[k].gather(st[k].grad) for k in ("sinks", "wq", "wk")}
    # layer c*per + j of chunk c = v*S + s: layers 0 and 1 are stage 0's
    grads = (params["lm_head"].grad, whole["sinks"][0, 0, 0],
             whole["wq"][0, 0, 0], whole["wk"][0, 0, 1])
    _rank_common(params, rep, cuda)
    if dist.get_rank() == 0:
        rep["token_losses"] = losses
        _grad_gate(grads, tmp, rep)
    del grads, whole
    live = _live_records(records)
    rep["live_attention_calls"] = len(live)
    _layer_checks(live, rep)
    if len(live) != PIPE_MICRO * per:
        rep["errors"].append(f"{len(live)} attention calls reached the loss"
                             f", not {PIPE_MICRO * per}")
    return rep


def _mesh_rank(rank, world, init, device, serve_cfg, train_cfg, tasks,
               sizes, tmp):
    """One rank of a phase-12 world: its tasks in turn; writes its rows to
    ``tmp/mesh_rank<r>.json``."""
    import os
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        # the ranks share one card: less of it lost to fragments
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:                  # the ranks share the host's cores
        torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        rows = []
        for task in tasks:
            t0 = time.perf_counter()
            if dev.type == "cuda":   # the ranks share one card
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            if task[0] == "serve":
                rows.append(_mesh_serve(serve_cfg, dev, tmp, sizes,
                                        *task[1:]))
            elif task[0] == "train":
                rows.append(_mesh_train(train_cfg, dev, tmp, sizes,
                                        *task[1:]))
            else:
                rows.append(_mesh_pipe(train_cfg, dev, tmp, sizes))
            log(f"phase 12 rank {rank}: {rows[-1]['task']} "
                f"{time.perf_counter() - t0:.1f} s, peak "
                f"{rows[-1].get('peak_gb', 0):.2f} GB")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(rows, f)


def _mesh_gates(row, ref, tref, errors):
    """The gates of one rank's row (see ``mesh_phase``)."""
    label = f"{row['task']} rank {row['rank']}"
    errors += [f"{label}: {e}" for e in row.pop("errors", [])]
    if row["launches"] != row["launches_expected"]:
        errors.append(f"{label}: launches {row['launches']}, expected "
                      f"{row['launches_expected']}")
    if not row["finite"]:
        errors.append(f"{label}: non-finite values")
    if "all_cos" in row and not 1.0 - row["all_cos"] <= 2.0 * (
            1.0 - ref["control_all_cos"]):
        errors.append(f"{label}: prefill logits vs the unsharded model's: "
                      f"mean cosine {row['all_cos']:.6f}, control "
                      f"{ref['control_all_cos']:.6f}")
    for name, d in row.get("vs_single", {}).items():
        if not d <= 2.0 * tref["control"][name]:
            errors.append(f"{label}: {name} vs the single-process step: 1 - "
                          f"cosine {d:.3e}, control "
                          f"{tref['control'][name]:.3e}")
    for name, r in row.get("rel_vs_single", {}).items():
        if not r <= 2.0 * tref["control_rel"][name]:
            errors.append(f"{label}: {name} vs the single-process step: "
                          f"relative error {r:.3e}, control "
                          f"{tref['control_rel'][name]:.3e}")
    if "loss" in row:   # the step's mean loss: a scale the cosines miss
        row["loss_rel_vs_single"] = abs(row["loss"] - tref["loss"]) / abs(
            tref["loss"])
        limit = 2.0 * tref["control_rel"]["token_losses"]
        if not row["loss_rel_vs_single"] <= limit:
            errors.append(f"{label}: mean loss {row['loss']:.6f} vs the "
                          f"single-process {tref['loss']:.6f}: relative "
                          f"error {row['loss_rel_vs_single']:.3e}, limit "
                          f"{limit:.3e}")
    if "opt_state_bytes" in row and row["opt_state_bytes"] != row[
            "param_bytes"]:
        errors.append(f"{label}: optimizer state {row['opt_state_bytes']} "
                      f"bytes, its parameters {row['param_bytes']}")


def _fsdp_gate(rows, errors):
    """12b with FSDP against the same rank without it (the same TP
    blocks): each leaf split over data holds 1/dp of its bytes there, the
    others as many; the FSDP rank's parameters (and so its optimizer
    state) come to about 1/dp of the TP blocks'."""
    (fl, fmesh, _), (nl, _, _) = MESH_TRAIN
    dp = fmesh["data"]
    for rank in sorted({r["rank"] for r in rows}):
        f = next(r for r in rows if r["task"] == f"12b train {fl}"
                 and r["rank"] == rank)
        n = next(r for r in rows if r["task"] == f"12b train {nl}"
                 and r["rank"] == rank)
        bad = [i for i, (a, b, split) in enumerate(zip(
            f["leaf_bytes"], n["leaf_bytes"], f["data_split"]))
            if a * (dp if split else 1) != b]
        f["param_bytes_vs_tp_blocks"] = f["param_bytes"] / n["param_bytes"]
        f["data_split_share"] = sum(a for a, s in zip(
            f["leaf_bytes"], f["data_split"]) if s) / f["param_bytes"]
        if bad or len(f["leaf_bytes"]) != len(n["leaf_bytes"]):
            errors.append(f"12b FSDP rank {rank}: leaves {bad} do not hold "
                          f"1/{dp} (split) or all (whole) of their TP "
                          f"blocks")
        for r in (f, n):
            del r["leaf_bytes"], r["data_split"]


def mesh_phase(device, *, serve_cfg=None, train_cfg=None, batch=4,
               prompt_len=1024, new_tokens=16, train_rows=2, seq_len=2048,
               dtype=torch.bfloat16, lr=1e-2):
    """Phase 12: TP serving (12a), the sharded training step (12b) and the
    pipeline (12c) at gpt-oss-20b's full width (serving 24 layers,
    training 4 of 24), one spawned process per rank, all on ``device``,
    over gloo: worlds of 4 (12a at TP 4, 12b's meshes, 12c) and 2 (12a at
    TP 2 over bf16 and int8 KV). Each rank draws the weights from the
    seed of phases 3 and 4 leaf by leaf, keeping its blocks
    (init_params(shardings=)). The parent first computes the unsharded
    references and empties its CUDA cache. Returns (report, launches
    summed over every rank, errors).

    Gates (each failure an error): every rank's launches as the schedule
    predicts (12c: the stage on all T steps); every layer's attention on
    every rank, kernel against plain on the live activations (cosine >=
    MIN_COS; 12b and 12c its gradients too, phase 4's
    ``_check_layer_grads``; 12a every decode step's decode too, over
    the cache as it stands, bf16 or int8, the count checked); 12a's
    prefill logits against the unsharded model's, 1 - mean row cosine at
    most twice a ``_noisy`` control's, and its tokens: equal to the
    unsharded greedy run's, or, from where they part, every token of
    both runs the teacher-forced choice within twice the control (phase
    8's ``_first_divergence``); 12b and 12c's per-token losses and phase
    4's named gradients (the sinks' reassembled from the head shards)
    against the single-process step, 1 - cosine and the relative error
    each at most twice a noise control's, and the step's mean loss
    within twice the control's relative error of the per-token losses
    (the relative errors see a dropped or doubled scale in the gradient
    fix-ups, which the cosines cannot); 12b with FSDP: the parameter and
    optimizer-state bytes about 1/dp of the TP blocks'; every value
    finite."""
    from sink_attention_tpu_torch.serving.divergence import (
        divergence_gate as _divergence_gate,
        first_divergence as _first_divergence)
    import tempfile
    import torch.multiprocessing as mp

    from sink_attention_tpu_torch.models import ModelConfig, init_params

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    serve_cfg = serve_cfg or ModelConfig.gpt_oss_20b()
    train_cfg = train_cfg or ModelConfig.gpt_oss_20b(num_layers=4)
    sizes = {"serve": (dtype, batch, prompt_len, new_tokens),
             "train": (dtype, train_rows, seq_len, lr)}
    worlds = {4: [("serve", *t) for t in MESH_SERVE[4]]
              + [("train", *t) for t in MESH_TRAIN] + [("pipe",)],
              2: [("serve", *t) for t in MESH_SERVE[2]]}
    report, errors = {"worlds": []}, []
    with tempfile.TemporaryDirectory(prefix="mesh_phase_") as tmp:
        t0 = time.perf_counter()
        ref = _serve_reference(serve_cfg, dev, batch, prompt_len,
                               new_tokens, dtype, tmp)
        tref = _train_reference(train_cfg, dev, train_rows, seq_len, dtype,
                                tmp)
        report["reference_s"] = time.perf_counter() - t0
        report["reference"] = {"control_all_cos": ref["control_all_cos"],
                               "train_loss": tref["loss"],
                               "train_control": tref["control"],
                               "train_control_rel": tref["control_rel"]}
        if cuda:   # the ranks share the card with this process
            torch.cuda.empty_cache()
        for world, tasks in worlds.items():
            t0 = time.perf_counter()
            mp.start_processes(
                _mesh_rank, args=(world, f"tcp://localhost:{_free_port()}",
                                  str(dev), serve_cfg, train_cfg, tasks,
                                  sizes, tmp),
                nprocs=world, join=True, start_method="spawn")
            ranks = []
            for r in range(world):
                with open(f"{tmp}/mesh_rank{r}.json") as f:
                    ranks.append(json.load(f))
            report["worlds"].append({"world": world, "seconds":
                                     time.perf_counter() - t0,
                                     "ranks": ranks})
    rows = [row for w in report["worlds"] for rank in w["ranks"]
            for row in rank]
    launches = {k: sum(r["launches"][k] for r in rows) for k in MESH_KERNELS}
    for row in rows:
        _mesh_gates(row, ref, tref, errors)
    _fsdp_gate([r for r in rows if r["task"].startswith("12b")], errors)
    # 12a's tokens: the same on every rank, and the unsharded run's or
    # explained by the teacher from where they part
    params = None
    for row in rows:
        if "tokens" not in row:
            continue
        quant = "int8" if "int8" in row["task"] else None
        plain = ref["tokens"][quant]
        row["tokens_equal"] = row["tokens"] == plain
        if row["tokens_equal"] or row["rank"] != 0:
            continue
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            params = init_params(serve_cfg, gen, dtype=dtype, device=dev)
        row["divergence"] = []
        for b, (p_toks, g_toks) in enumerate(zip(plain, row["tokens"])):
            div = _first_divergence(params, serve_cfg, ref["prompts"][b],
                                    p_toks, g_toks, 5000 + b, quant=quant)
            row["divergence"].append(div)
            _divergence_gate(div, f"{row['task']} request {b}", errors)
    by_task = {}
    for row in rows:
        if "tokens" in row:
            by_task.setdefault(row["task"], set()).add(str(row["tokens"]))
            del row["tokens"]
    for task, seen in by_task.items():
        if len(seen) != 1:
            errors.append(f"{task}: the ranks' tokens differ")
    del params
    return report, launches, errors


# ---------------------------------------------------------------------------
# Phase 13: every head_dim up to 128 and fp32 inputs, on H2O-Danube-1.8B
# ---------------------------------------------------------------------------

# H2O-Danube-1.8B's published widths (the H2O-Danube-1.8B Technical Report,
# arXiv:2401.16818, Table 1; the h2oai/h2o-danube-1.8b-base config):
# Mistral family, so every layer slides over a window of 4096; head_dim
# 2560 / 32 = 80.
DANUBE_1_8B = dict(
    model_type="mistral", hidden_size=2560, num_hidden_layers=24,
    num_attention_heads=32, num_key_value_heads=8, intermediate_size=6912,
    vocab_size=32000, sliding_window=4096, max_position_embeddings=16384,
    rope_theta=10000.0, rms_norm_eps=1e-5)
DANUBE_RUNS = (("bfloat16", torch.bfloat16, None),
               ("float32", torch.float32, None),
               ("bfloat16 int8 KV", torch.bfloat16, "int8"))


def danube_phase(device, *, hf=DANUBE_1_8B, batch=2, prompt_len=8192,
                 new_tokens=16, train_len=8192, segments=(4096, 4096)):
    """Phase 13: the model of ``hf`` (``ModelConfig.from_hf_config``) at
    its full width and depth, random weights from a generator seeded 0.

    13a. serve (phase 3's ``serve``): ``batch`` prompts of ``prompt_len``
    tokens (twice the window: the gap is really skipped), ``new_tokens``
    greedy tokens through ``serving.greedy_generate``, in bf16, in fp32
    and in bf16 over an int8 KV cache; launches 1 forward per layer and 1
    decode of the run's branch per layer and step; every layer's prefill
    and decode attention kernel against plain; the logits against plain
    attention and teacher forcing beside a control (bf16-sized noise; in
    fp32 one bf16 rounding of the operands, :func:`bf16_operands`; over
    int8 the K/V round trip).

    13b. train in fp32, JAX's default dtype (phase 4's ``train``, phase
    5's ``train_packed``): one SGD step with remat over ``train_len``
    tokens (launches 2 forward, 1 dQ, 1 dK/dV per layer) and one on a pack
    of ``segments`` (1 packed forward, dQ, dK/dV per layer, no unpacked
    launch); every layer's attention gradients kernel against plain; the
    per-token losses and named gradients against plain attention beside
    the fp32 control. Returns (report, errors); no step is profiled or
    split into its parts (phases 3-5 do that).
    """
    from sink_attention_tpu_torch.models import ModelConfig

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = ModelConfig.from_hf_config(hf)
    L = cfg.num_layers
    report = {"config": {k: getattr(cfg, k) for k in (
        "hidden_size", "num_layers", "num_heads", "num_kv_heads", "head_dim",
        "intermediate_size", "vocab_size", "sliding_window")}}
    errors = []

    def run(label, fn, want):
        t0 = time.perf_counter()
        rep, err = fn()
        rep["seconds"] = time.perf_counter() - t0
        errors.extend(f"phase 13 {label}: {e}" for e in err)
        if cuda:
            _check_launches(rep["launches"], want, f"phase 13 {label}",
                            errors)
        report[label] = rep
        log(f"phase 13 {label}: {rep['seconds']:.1f} s: " + json.dumps(rep))
        if cuda:
            torch.cuda.empty_cache()

    for label, dtype, quant in DANUBE_RUNS:
        want = {"flash_fwd": L, "decode": 0 if quant else L * (
            new_tokens - 1)}
        if quant:
            want[f"decode_{quant}"] = L * (new_tokens - 1)
        run(f"serve {label}", lambda: serve(
            cfg, dev, batch=batch, prompt_len=prompt_len,
            new_tokens=new_tokens, dtype=dtype, quant=quant, profile=False,
            control=bf16_operands if dtype == torch.float32 else None), want)
    fp32 = dict(dtype=torch.float32, control=bf16_operands, profile=False,
                split=False)
    run("train float32", lambda: train(cfg, dev, seq_len=train_len, steps=1,
                                       **fp32),
        {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkdv": L})
    run("train packed float32", lambda: train_packed(
        cfg, dev, seq_len=sum(segments), steps=1, lens=segments, **fp32),
        {"packed_fwd": L, "packed_dq": L, "packed_dkdv": L, "flash_fwd": 0,
         "flash_dq": 0, "flash_dkdv": 0})
    return report, errors


# ---------------------------------------------------------------------------
# Phase 14: head_dim 256 and StreamingLLM sinks, on Gemma-2-2B
# ---------------------------------------------------------------------------

# Gemma-2-2B's published geometry (the Gemma 2 report, arXiv:2408.00118,
# Table 1; the google/gemma-2-2b config): layers alternate a sliding window
# of 4096 (the even ones, as HF's Gemma2 has it) and full attention, GQA
# 8/4, head_dim 256; its query scale query_pre_attn_scalar ** -0.5 is
# 256 ** -0.5, the kernels' default. What the model of both packages lacks
# stays out, so the model is Gemma-2-2B-shaped: the dense MLP is gated SiLU
# (not GeGLU), no attention or final logit soft-capping, no post-norms, no
# embedding scaling, untied embeddings. Built by ModelConfig(**GEMMA2_2B)
# (from_hf_config takes no model_type "gemma2").
GEMMA2_2B = dict(
    hidden_size=2304, num_layers=26, num_heads=8, num_kv_heads=4,
    head_dim=256, intermediate_size=9216, vocab_size=256000,
    sliding_window=4096,
    layer_types=("sliding_attention", "full_attention") * 13,
    rope_theta=10000.0, rms_norm_eps=1e-6, attention_bias=False,
    max_position_embeddings=8192, mlp_type="dense", use_s_aux=False)
# (label, KV storage, StreamingLLM sinks: num_sink_tokens)
GEMMA_RUNS = (("bfloat16", None, 0), ("bfloat16 int8 KV", "int8", 0),
              ("bfloat16 4 sinks", None, 4))


def gemma_phase(device, *, config=GEMMA2_2B, batch=2, prompt_len=8176,
                new_tokens=16, train_len=8192, segments=(4096, 4096),
                runs=GEMMA_RUNS, phase=14):
    """Phase 14 (and 15 on a widened config): the model of ``config``
    (``ModelConfig(**config)``) at its full width and depth, random bf16
    weights from a generator seeded 0.

    14a. serve (phase 3's ``serve``) each of ``runs``: ``batch`` prompts
    of ``prompt_len`` tokens (twice the window, inside
    max_position_embeddings with the new tokens), ``new_tokens`` greedy
    tokens through ``serving.greedy_generate``, in bf16, over an int8 KV
    cache, and with ``num_sink_tokens = 4`` (GEMMA_RUNS; phase 15 the first
    two) (StreamingLLM: every sliding layer's cache pins
    4 sinks while its window rolls, and the kernels run their sink range);
    launches 1 forward per layer and 1 decode of the run's branch per layer
    and step; every layer's prefill and decode attention kernel against
    plain; the logits against plain attention and teacher forcing beside a
    bf16-noise control (over int8 the K/V round trip).

    14b. train in bf16 (phase 4's ``train``, phase 5's ``train_packed``):
    one SGD step with remat over ``train_len`` tokens (launches 2 forward,
    1 dQ, 1 dK/dV per layer) and one on a pack of ``segments`` (1 packed
    forward, dQ, dK/dV per layer, no unpacked launch); every layer's
    attention gradients kernel against plain; the per-token losses and
    named gradients against plain attention beside a bf16-noise control.

    Each run's report holds ``peak_gb``, the card's peak allocation from
    the run's own reset (its weights already made) to its end, checks
    included. Returns (report, errors).
    """
    import dataclasses

    from sink_attention_tpu_torch.models import ModelConfig

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = ModelConfig(**config)
    L = cfg.num_layers
    report = {"config": {k: getattr(cfg, k) for k in (
        "hidden_size", "num_layers", "num_heads", "num_kv_heads", "head_dim",
        "intermediate_size", "vocab_size", "sliding_window")}}
    errors = []

    def run(label, fn, want):
        t0 = time.perf_counter()
        rep, err = fn()
        rep["seconds"] = time.perf_counter() - t0
        errors.extend(f"phase {phase} {label}: {e}" for e in err)
        if cuda:
            rep["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            _check_launches(rep["launches"], want, f"phase {phase} {label}",
                            errors)
        report[label] = rep
        log(f"phase {phase} {label}: {rep['seconds']:.1f} s: "
            + json.dumps(rep))
        if cuda:
            torch.cuda.empty_cache()

    for label, quant, sinks in runs:
        want = {"flash_fwd": L, "decode": 0 if quant else L * (
            new_tokens - 1)}
        if quant:
            want[f"decode_{quant}"] = L * (new_tokens - 1)
        run(f"serve {label}", lambda: serve(
            dataclasses.replace(cfg, num_sink_tokens=sinks), dev,
            batch=batch, prompt_len=prompt_len, new_tokens=new_tokens,
            quant=quant, profile=False), want)
    once = dict(steps=1, profile=False, split=False)
    run("train bfloat16", lambda: train(cfg, dev, seq_len=train_len,
                                        **once),
        {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkdv": L})
    run("train packed bfloat16", lambda: train_packed(
        cfg, dev, seq_len=sum(segments), lens=segments, **once),
        {"packed_fwd": L, "packed_dq": L, "packed_dkdv": L,
         "flash_fwd": 0, "flash_dq": 0, "flash_dkdv": 0})
    return report, errors


# ---------------------------------------------------------------------------
# Phase 15: head_dim 512, on a widened Gemma-2-2B geometry
# ---------------------------------------------------------------------------

# Not a released model: phase 14's Gemma-2-2B geometry with head_dim 512
# and its 8/4 heads kept, so q is 4096 wide against a hidden size of 2304
# (ModelConfig takes head_dim apart from hidden / heads in both packages,
# as Gemma's own 8 x 256 != 2304 shows). No public model I know of uses a
# head wider than 256; this config drives the kernels' 512 instance
# through the model's entry points at a full model's width and depth.
GEMMA2_2B_WIDE = dict(GEMMA2_2B, head_dim=512)
WIDE_RUNS = GEMMA_RUNS[:2]  # bf16, and over int8 KV
# phase 15's depth in the full script: 4 of the 26 layers (two sliding,
# two full), serving and training (cut to keep the script inside its
# limit: 12 once phase 16 came, 4 once phase 2 held the narrow instances;
# the 512 instance stays held at the full model's shapes by the 15a rows)
WIDE_LAYERS = 4


def wide_phase(device, **kw):
    """Phase 15: ``gemma_phase`` on GEMMA2_2B_WIDE: serving 2 x 8176 + 16
    tokens in bf16 and over int8 KV, one bf16 SGD step with remat at 1 x
    8192 and one on a pack of 2 x 4096, every gate of phase 14. Returns
    (report, errors)."""
    kw = {"config": GEMMA2_2B_WIDE, "runs": WIDE_RUNS, "phase": 15, **kw}
    return gemma_phase(device, **kw)


# ---------------------------------------------------------------------------
# Phase 16: head_dim 1024, the wide instance, on the Gemma-2-2B geometry
# ---------------------------------------------------------------------------

# Not a released model either: phase 14's geometry with head_dim 1024 (q
# 8192 wide against hidden 2304, the 8/4 heads kept; ~4.3 B parameters,
# 8.6 GB in bf16). It drives the kernels' wide instance (every D > 512,
# runtime depth and 512-column slices) through the model's entry points.
GEMMA2_2B_XWIDE = dict(GEMMA2_2B, head_dim=1024)
# phase 16's depth in the full script: 4 of the 26 layers (alternation
# kept), serving and training: so that the step and its checks stay under
# the card's 80 GB (phase 15's full depth at D = 512 peaked at 76.23 GB),
# and the script inside its limit (12 until phase 2 held the narrow
# instances; the 16a rows hold the wide instance at the full model's
# shapes)
XWIDE_LAYERS = 4


def xwide_phase(device, **kw):
    """Phase 16: ``gemma_phase`` on GEMMA2_2B_XWIDE: serving 2 x 8176 +
    16 tokens in bf16 and over int8 KV, one bf16 SGD step with remat at 1
    x 8192 and one on a pack of 2 x 4096, every gate of phase 14. Returns
    (report, errors)."""
    kw = {"config": GEMMA2_2B_XWIDE, "runs": WIDE_RUNS, "phase": 16, **kw}
    return gemma_phase(device, **kw)


# ---------------------------------------------------------------------------
# Phase 17: the accuracy tables, the profiler traces, the usage examples
# ---------------------------------------------------------------------------

# each trace section's launches of the kernels capture_trace counts
TRACE_LAUNCHES = {"prefill_fwd": {"flash_fwd": 1},
                  "train_fwdbwd": {"flash_fwd": 1, "flash_dq": 1,
                                   "flash_dkdv": 1},
                  "decode_scan_64": {"decode": 64}}


def _all_counters():
    """Every launch counter of rows 1-7: name -> (wrapper, attribute)."""
    from sink_attention_tpu_torch.ops import decode
    counters = {name: (fn, "launches") for name, fn in _sp_counters().items()}
    counters.update(decode=(decode.decode_kernel, "launches"),
                    decode_int8=(decode.decode_kernel, "launches_int8"),
                    decode_fp8=(decode.decode_kernel, "launches_fp8"))
    return counters


def accuracy_phase(dev):
    """Phase 17: the JAX round's last modules on the card.

    17a. ``scripts/numerical_accuracy.all_tables``: the six tables, every
    row within its gate (each largest error at most 2 x its control's, or
    else every element within the floor from the JAX tests' bound named
    in the row, applied element by element as those tests apply it; the
    decode rows ran the design they name); at least two gradient rows and
    one packed row whose sink key blocks split into pieces. 17b.
    ``scripts/capture_trace.capture`` at the headline into a temporary
    directory: the three sections present, their launches (the wrappers'
    counters) 1 / 1 + 1 + 1 / 64 (TRACE_LAUNCHES) and none of the other
    counted kernels, each kernel's device events in the trace equal to its
    launches (a trace that dropped events fails), device time recorded.
    17c. the examples: ``kernels`` (the prefill within FLASH_TOL of the
    oracle), ``serve --tokens 8``
    (gpt-oss-20b, 4 layers at full width: 4 requests of 8 tokens) and
    ``train`` as a world of 1 (5 finite losses, the last below the
    first). Returns (report, launches of rows 1-7 in the phase, errors)."""
    import tempfile

    from sink_attention_tpu_torch.examples import kernels as ex_kernels
    from sink_attention_tpu_torch.examples import serve as ex_serve
    from sink_attention_tpu_torch.examples import train as ex_train
    from sink_attention_tpu_torch.scripts import capture_trace
    from sink_attention_tpu_torch.scripts import numerical_accuracy as acc

    errors, report = [], {}
    _read_launches(_all_counters(), reset=True)
    t0 = time.perf_counter()
    rows = acc.all_tables(dev)
    report["tables_s"] = time.perf_counter() - t0
    for r in rows:
        if not r["ok"]:
            errors.append(f"phase 17 {r['table']} {r['config']} "
                          f"{r['dtype']}: {r['err']} beyond its gate "
                          f"{r['gate']} and its floor (x{r['floor_ratio']})"
                          + (f" or ran {r['design']}, not "
                             f"{r['design_expected']}" if "design" in r
                             else ""))
    for table, least in (("grad", 2), ("packed", 1)):
        split = [r["config"] for r in rows
                 if r["table"] == table and r["split"] > 1]
        report[f"{table}_split_rows"] = split
        if len(split) < least:
            errors.append(f"phase 17: {len(split)} {table} rows whose sink "
                          f"key blocks split, not {least} or more")
    report["rows"] = len(rows)
    report["missed"] = sum(not r["ok"] for r in rows)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sink_trace_") as tmp:
        trace = capture_trace.capture(tmp, dev)
        report["trace_files"] = [os.path.relpath(f, tmp)
                                 for f in trace["files"]]
    report["trace_s"] = time.perf_counter() - t0
    for name, want in TRACE_LAUNCHES.items():
        sec = trace["sections"].get(name)
        if sec is None:
            errors.append(f"phase 17: the trace has no section {name}")
            continue
        report[name] = {k: sec[k] for k in (
            "wall_ms", "device_ms", "idle_share", "launches",
            "trace_launches", "top")}
        if sec["device_ms"] is None:
            errors.append(f"phase 17: {name} recorded no device time")
        for kernel, n in sec["launches"].items():
            events = sec["trace_launches"][kernel]
            if n != want.get(kernel, 0) or events != n:
                errors.append(f"phase 17: {name} launched {kernel} {n} "
                              f"times ({events} in the trace), expected "
                              f"{want.get(kernel, 0)}")

    t0 = time.perf_counter()
    where = ["--device", str(dev)]
    out = ex_kernels.main(where)
    report["kernels_example"] = out
    if not out["prefill_err"] <= FLASH_TOL:
        errors.append(f"phase 17: examples/kernels.py's prefill is "
                      f"{out['prefill_err']:.3e} from the oracle")
    served = ex_serve.main(["--tokens", "8", *where])
    report["serve_example"] = {rid: len(t) for rid, t in served.items()}
    if sorted(map(len, served.values())) != [8] * 4:
        errors.append(f"phase 17: examples/serve.py served "
                      f"{report['serve_example']}, not 4 requests of 8")
    del served
    torch.cuda.empty_cache()
    losses = ex_train.main(where)
    report["train_example"] = losses
    if not (len(losses) == 5 and all(map(math.isfinite, losses))
            and losses[-1] < losses[0]):
        errors.append(f"phase 17: examples/train.py's losses {losses}")
    report["examples_s"] = time.perf_counter() - t0
    return report, _read_launches(_all_counters()), errors


# ---------------------------------------------------------------------------


# the wgmma kernel instances each source must hold: one per instance head
# dim (64, 128, 256, 512, and the wide instance of every D > 512) and
# element types (bf16, fp16, fp32 read as bf16)
# 3 dtypes x (D 64, 80, 96, 128, 256, 512, wide): the narrow 80 and 96
# in every kernel but the ablation's
WGMMA_INSTANCES = {"flash_fwd": {"fwd": 21},
                   "flash_bwd": {"dq": 21, "dkdv": 21},
                   "packed": {"fwd": 21, "dq": 21, "dkdv": 21},
                   # 11 stages x D 64 and 128 of the forward's template
                   "ablation": {"fwd": 22}}
# decode.cu's instances (storage, instance head dim): the short rows' 5
# storages (bf16, fp16, fp32, int8, fp8) x D_i 64, 80, 96, 128, and the 5
# storages' deep instance past 128 (keyed (storage, 0) below)
DECODE_INSTANCES = 25
# the bytes of spill stores each decode instance may show: none
DECODE_SPILL_ALLOWANCE = {}


def coverage_pairs(name):
    """The (head dim, dtype) pairs that the kernels line's row ``name``
    launched in this process, from its wrapper's ``coverage``."""
    from sink_attention_tpu_torch.ops import ablation, decode, flash, packed
    dec = decode.decode_kernel.coverage
    cover = {
        "flash_fwd": flash.flash_fwd_kernel.coverage,
        "flash_dq": flash.flash_dq_kernel.coverage,
        "flash_dkdv": flash.flash_dkdv_kernel.coverage,
        "packed_fwd": packed.packed_fwd_kernel.coverage,
        "packed_dq": packed.packed_dq_kernel.coverage,
        "packed_dkdv": packed.packed_dkdv_kernel.coverage,
        "decode": {c for c in dec if c[1] not in ("int8", "fp8")},
        "decode_int8": {c for c in dec if c[1] == "int8"},
        "decode_fp8": {c for c in dec if c[1] == "fp8"},
        "ablation": ablation.ablation_kernel.coverage,
        "mask_stage": ablation.ablation_kernel.coverage}[name]
    return cover


def kernel_instances(name):
    """The instance head dims (as the libraries report them: 80 and 96 the
    narrow instances, 513 the wide one) that the kernels line's row
    ``name`` launched in this process; [] for a row whose wrapper records
    none (the decode, the ablation)."""
    from sink_attention_tpu_torch.ops import flash, packed
    wrapper = {
        "flash_fwd": flash.flash_fwd_kernel,
        "flash_dq": flash.flash_dq_kernel,
        "flash_dkdv": flash.flash_dkdv_kernel,
        "packed_fwd": packed.packed_fwd_kernel,
        "packed_dq": packed.packed_dq_kernel,
        "packed_dkdv": packed.packed_dkdv_kernel}.get(name)
    return sorted({i for _, i in wrapper.instances}) if wrapper else []


def kernel_coverage(name):
    """(head dims, dtypes) that the kernels line's row ``name`` launched in
    this process (``coverage_pairs``)."""
    cover = coverage_pairs(name)
    return sorted({d for d, _ in cover}), sorted({t for _, t in cover})


def spill_errors(report):
    """ptxas' spill line of every instance of a wgmma kernel (the forward,
    dQ, dK/dV, the ablation's stages of the forward) and of the decode in
    the build ``report``: one error per wgmma instance that spills, per
    decode instance that spills more than DECODE_SPILL_ALLOWANCE gives it,
    or per freshly built source whose ptxas lines lack one of the instances
    of WGMMA_INSTANCES or DECODE_INSTANCES."""
    errors = []
    for name, rep in report.items():
        entry, seen = None, {}
        for line in rep["ptxas"]:
            if "Compiling entry" in line:
                entry = line
            elif "spill" in line and entry and "decode_kernel" in entry:
                seen["decode"] = seen.get("decode", 0) + 1
                inst = re.search(r"short_decode_kernelINS_\d+(\w+?)ELi(\d+)E",
                                 entry)
                deep = re.search(r"deep_decode_kernelINS_\d+(\w+?)EE", entry)
                spills = re.search(r"(\d+) bytes spill stores", line)
                key = ((deep[1], 0) if deep else
                       inst and (inst[1], int(inst[2])))
                if spills is None or key is None or int(spills[1]) > \
                        DECODE_SPILL_ALLOWANCE.get(key, 0):
                    errors.append(f"{name}.cu spills past its allowance "
                                  f"({key}): {line}")
            elif "spill" in line and entry and "wgmma_kernel" in entry:
                kind = next((k for k in ("fwd", "dq", "dkdv")
                             if f"{k}_wgmma_kernel" in entry), "other")
                seen[kind] = seen.get(kind, 0) + 1
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                   r"spill loads", line)
                if spills is None or spills.groups() != ("0", "0"):
                    errors.append(f"{name}.cu spills: {entry}: {line}")
        want = dict(WGMMA_INSTANCES.get(name, {}))
        if name == "decode":
            want["decode"] = DECODE_INSTANCES
        for kind, n in want.items():
            if not rep["cached"] and seen.get(kind, 0) != n:
                errors.append(f"{name}.cu: ptxas printed the spill lines of "
                              f"{seen.get(kind, 0)} {kind} kernel "
                              f"instances, not {n}")
    log("spill check (every wgmma and decode kernel instance): "
        + ("wgmma 0 spill, decode within its allowance" if not errors
           else "FAILED"))
    return errors


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
    t_start = time.perf_counter()
    # a run still going near its 1200 s limit prints every thread's Python
    # stack to stderr (where a hang waits), and goes on
    faulthandler.dump_traceback_later(1100, file=sys.stderr)
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
    errors = spill_errors(_build.build_report)

    # 2. kernels
    t0 = time.perf_counter()
    kern = kernel_phase(dev)
    log(f"phase 2 (every kernel against its plain version): "
        f"{time.perf_counter() - t0:.1f} s")
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
        if "plan" in rows[0]:  # the decode's design of each row
            kernels[-1]["designs"] = [
                {"shape": r["shape"], **{k: r["plan"][k] for k in (
                    "design", "instance", "n_split", "split_slots")}}
                for r in rows]
        if name in REDESIGNED:
            kernels[-1]["redesigned"] = REDESIGNED[name]
        if name in TEMPLATE:
            kernels[-1]["template"] = csrc + TEMPLATE[name]
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

    torch.cuda.empty_cache()

    # 8. beam search and speculative decoding
    t0 = time.perf_counter()
    sreport, serr = serve_spec(cfg, dev)
    errors += serr
    log(f"beam and speculative serving gpt-oss-20b (24 layers, bf16, 1 x "
        f"1024 prompt; beam 4 x 32 tokens; layers 1-23 x 0.1, draft layer "
        f"0, 4 drafts, 64 tokens; engine 8 requests in 4 slots, bf16 and "
        f"int8 KV), {time.perf_counter() - t0:.1f} s: "
        + json.dumps(sreport))
    spec_engine = sreport["engine"]
    for row, name in ((kernels[0], "flash_fwd"), (kernels[1], "decode")):
        row.update(launches_beam=sreport["beam"]["launches"][name],
                   launches_spec=sreport["spec"]["launches"][name],
                   launches_spec_engine=spec_engine["bfloat16"]["spec"][
                       "launches"][name])
    kernels[0]["launches_spec_engine"] += spec_engine["int8"]["spec"][
        "launches"]["flash_fwd"]
    kernels[2]["launches_spec_engine"] = spec_engine["int8"]["spec"][
        "launches"]["decode_int8"]

    torch.cuda.empty_cache()

    # 9. serving with quantized weights: the matmuls at their real shapes,
    # gpt-oss-20b in bf16, int8 and int4 at QUANT_LAYERS of its 24 layers
    # (cut to keep the script inside its limit once phase 16 came),
    # gpt-oss-120b in int4 at all 36
    t0 = time.perf_counter()
    oprows, operr = quant_op_gates(dev)
    errors += operr
    log(f"quantized matmuls (int8, int4, int4 group 32; lm_head, gate_up, "
        f"down at E=32 and 128), {time.perf_counter() - t0:.1f} s: "
        + json.dumps(oprows))
    t0 = time.perf_counter()
    qreport, qerr = serve_quant(
        ModelConfig.gpt_oss_20b(num_layers=QUANT_LAYERS), dev)
    errors += qerr
    log(f"quantized serving gpt-oss-20b ({QUANT_LAYERS} of 24 layers; bf16, "
        f"int8 in place, "
        f"int4 weights; engine max_batch 1 and 8, prompt 1..64, max_len "
        f"4096, chunks of 32), {time.perf_counter() - t0:.1f} s: "
        + json.dumps(qreport))
    t0 = time.perf_counter()
    big = ModelConfig.gpt_oss_120b()
    breport, berr = serve_quant(big, dev, forms=("int4",))
    errors += berr
    log(f"quantized serving gpt-oss-120b (36 layers, 128 experts, int4 "
        f"weights; the same engine rows), {time.perf_counter() - t0:.1f} "
        "s: " + json.dumps(breport))
    engine_rows = [row for rep in (qreport, breport) for tree in rep.values()
                   for row in tree["engine"]]
    for row, name in ((kernels[0], "flash_fwd"), (kernels[1], "decode")):
        row["launches_quant"] = sum(r["launches"][name] for r in engine_rows)

    torch.cuda.empty_cache()

    # 10. serving from a checkpoint in the released layout (MXFP4 experts),
    # at 12 of gpt-oss-20b's 24 layers (its depth cut to keep the script
    # inside its limit once phase 16 came)
    t0 = time.perf_counter()
    creport, cerr = serve_checkpoint(
        ModelConfig.gpt_oss_20b(num_layers=CHECKPOINT_LAYERS), dev)
    errors += cerr
    log(f"checkpoint serving gpt-oss-20b ({CHECKPOINT_LAYERS} of 24 layers; "
        f"a random checkpoint "
        f"in the released layout written, loaded in bf16 and int4, served, "
        f"resumed, the golden protocol), {time.perf_counter() - t0:.1f} s: "
        + json.dumps(creport))
    for row, name in ((kernels[0], "flash_fwd"), (kernels[1], "decode")):
        row["launches_checkpoint"] = creport.get("launches", {}).get(name, 0)

    torch.cuda.empty_cache()

    # 11. sequence-parallel attention over torch.distributed, worlds of 1
    # (NCCL), 2 and 4 (gloo) ranks on the one card
    t0 = time.perf_counter()
    sp_report, sp_launches, sp_err = sp_phase(dev)
    errors += sp_err
    log(f"sequence-parallel attention (B=1, H 64/8, D=64, bf16, N={SP_N}, "
        f"random s_aux; worlds 1 (nccl), 2 and 4 (gloo) on one card; "
        f"forward and backward), {time.perf_counter() - t0:.1f} s: "
        + json.dumps(sp_report))
    for row in kernels:
        if row["name"] in sp_launches:
            row["launches_sp"] = sp_launches[row["name"]]
    for name, n in sp_launches.items():
        if n == 0:
            errors.append(f"{name} launched no time in phase 11")

    torch.cuda.empty_cache()

    # 12. tensor, pipeline and FSDP parallelism over a device mesh, worlds
    # of 4 and 2 gloo ranks on the one card; 12a's TP serving at 6 of
    # gpt-oss-20b's 24 layers (its depth cut to keep the script inside its
    # limit once phase 13 came)
    t0 = time.perf_counter()
    mesh_report, mesh_launches, mesh_err = mesh_phase(
        dev, serve_cfg=ModelConfig.gpt_oss_20b(num_layers=MESH_SERVE_LAYERS))
    errors += mesh_err
    log(f"mesh parallelism gpt-oss-20b (12a TP 4 and 2 serving, "
        f"{MESH_SERVE_LAYERS} layers, "
        f"4 x 1024 prompt, 16 new, bf16 and int8 KV; 12b the mesh step, 4 "
        f"layers, 2 x 2048 tokens, FSDP dp2 x tp2 and sp2 x tp2; 12c the "
        f"pipeline pipe2 x tp2, S=2 M=2; gloo ranks on one card), "
        f"{time.perf_counter() - t0:.1f} s: " + json.dumps(mesh_report))
    for row in kernels:
        if row["name"] in mesh_launches:
            row["launches_mesh"] = mesh_launches[row["name"]]
    for name, n in mesh_launches.items():
        if n == 0:
            errors.append(f"{name} launched no time in phase 12")

    torch.cuda.empty_cache()

    # 13. every head_dim up to 128 and fp32 inputs: H2O-Danube-1.8B (D=80)
    # at full width, served in bf16, fp32 and over int8 KV, trained in fp32
    t0 = time.perf_counter()
    dreport, derr = danube_phase(dev)
    errors += derr
    log(f"phase 13 (H2O-Danube-1.8B, 24 layers, hidden 2560, 32/8 heads, "
        f"head_dim 80, W=4096; serving 2 x 8192 + 16 new in bf16, fp32 and "
        f"int8 KV; training 1 x 8192 and a pack of 2 x 4096 in fp32): "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 14. head_dim 256 and StreamingLLM sinks: Gemma-2-2B-shaped (D=256) at
    # full width, served in bf16, over int8 KV and with 4 sinks, trained in
    # bf16
    t0 = time.perf_counter()
    greport, gerr = gemma_phase(dev)
    errors += gerr
    log(f"phase 14 (Gemma-2-2B-shaped, 26 layers, hidden 2304, 8/4 heads, "
        f"head_dim 256, W=4096 on alternate layers; serving 2 x 8176 + 16 "
        f"new in bf16, over int8 KV and with 4 StreamingLLM sinks; training "
        f"1 x 8192 and a pack of 2 x 4096 in bf16): "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 15. head_dim 512: the widened Gemma-2-2B geometry (D=512, not a
    # released model) at full width, WIDE_LAYERS of its 26 layers, served
    # in bf16 and over int8 KV, trained in bf16; phase 2 held rows 1-7 at
    # its shapes (15a)
    t0 = time.perf_counter()
    wreport, werr = wide_phase(dev, config=dict(
        GEMMA2_2B_WIDE, num_layers=WIDE_LAYERS,
        layer_types=GEMMA2_2B_WIDE["layer_types"][:WIDE_LAYERS]))
    errors += werr
    log(f"phase 15 (widened Gemma-2-2B geometry, not a released model: "
        f"{WIDE_LAYERS} of 26 layers, hidden 2304, 8/4 heads, head_dim 512, "
        f"W=4096 on alternate "
        f"layers; serving 2 x 8176 + 16 new in bf16 and over int8 KV; "
        f"training 1 x 8192 and a pack of 2 x 4096 in bf16): "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 16. head_dim 1024 (every D > 512: the wide instance): the Gemma-2-2B
    # geometry widened again (not a released model) at full width,
    # XWIDE_LAYERS of its 26 layers, served in bf16 and over int8 KV,
    # trained in bf16; phase 2 held rows 1-7 at its shapes and at D = 640
    # and 2048 (16a)
    t0 = time.perf_counter()
    xreport, xerr = xwide_phase(dev, config=dict(
        GEMMA2_2B_XWIDE, num_layers=XWIDE_LAYERS,
        layer_types=GEMMA2_2B_XWIDE["layer_types"][:XWIDE_LAYERS]))
    errors += xerr
    log(f"phase 16 (widened Gemma-2-2B geometry, not a released model: "
        f"{XWIDE_LAYERS} of 26 layers, hidden 2304, 8/4 heads, head_dim "
        f"1024, W=4096 on alternate layers; serving 2 x 8176 + 16 new in "
        f"bf16 and over int8 KV; training 1 x 8192 and a pack of 2 x 4096 "
        f"in bf16): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 17. the JAX round's last modules: the accuracy tables against the
    # fp32 oracle, the profiler traces at the headline, the usage examples
    t0 = time.perf_counter()
    accreport, acclaunch, accerr = accuracy_phase(dev)
    errors += accerr
    log(f"phase 17 (the six accuracy tables against the fp32 oracle, the "
        f"traces of prefill_fwd, train_fwdbwd and decode_scan_64 at B=1 "
        f"32/8 D=128 N=8192 W=4096, examples/kernels.py, serve.py and "
        f"train.py): {time.perf_counter() - t0:.1f} s: "
        + json.dumps(accreport))
    for name, n in acclaunch.items():
        if n == 0:
            errors.append(f"{name} launched no time in phase 17")
    for row in kernels:
        if row["name"] in acclaunch:
            row["launches_phase17"] = acclaunch[row["name"]]
        for phase, rep, num in (("danube", dreport, 13),
                                ("gemma", greport, 14),
                                ("wide", wreport, 15),
                                ("xwide", xreport, 16)):
            n = sum(r["launches"].get(row["name"], 0)
                    for r in rep.values() if "launches" in r)
            if row["name"] in ("flash_fwd", "flash_dq", "flash_dkdv",
                               "decode", "decode_int8", "packed_fwd",
                               "packed_dq", "packed_dkdv"):
                row[f"launches_{phase}"] = n
                if n == 0:
                    errors.append(f"{row['name']} launched no time in phase "
                                  f"{num}")
            rows = kern.get(f"{row['name']}_{phase}")
            if rows:
                row[phase] = [{k: r[k] for k in (
                    "shape", "max_abs_err", "exact_err", "exact_rel_err",
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms") if k in r} for r in rows]
    for row in kernels:
        if row["name"] in ("flash_dkdv", "packed_dkdv"):
            # every phase-2 row's pieces (a split sink key block counts
            # each of its pieces)
            row["pieces"] = [
                {"shape": r["shape"], "pieces": r["pieces"]}
                for key, v in kern.items()
                if key == row["name"] or key.startswith(row["name"] + "_")
                for r in (v if isinstance(v, list) else [v])
                if "pieces" in r]
        rows = kern.get(f"{row['name']}_narrow")
        if rows:  # phase 2's rows of the narrow instances (Phi-3-mini's)
            row["narrow"] = [{k: r[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "device_ms") if k in r}
                for r in rows]
        row["head_dims"], row["dtypes"] = kernel_coverage(row["name"])
        row["instances"] = kernel_instances(row["name"])
        row["pairs_above_256"] = sorted(
            [d, t] for d, t in coverage_pairs(row["name"]) if d > 256)
        row["pairs_above_512"] = sorted(
            [d, t] for d, t in coverage_pairs(row["name"]) if d > 512)

    faulthandler.cancel_dump_traceback_later()
    if errors:
        for e in errors:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the "
        f"build to here")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
