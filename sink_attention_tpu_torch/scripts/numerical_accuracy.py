"""Numerical accuracy tables: each kernel of the port against the fp32 eager
oracle, beside a control.

    python3 -m sink_attention_tpu_torch.scripts.numerical_accuracy
        [--device cpu]

Counterpart of the JAX package's ``scripts/numerical_accuracy.py`` (the
source of its README's accuracy figures), with its six tables and their
rows: the forward over a grid of shapes, sinks, windows and dtypes
(:func:`fwd_table`), the gradients with ``s_aux`` (:func:`grad_table`),
``ds_aux`` against central finite differences under the reference's
protocol (:func:`ds_aux_fd_table`), the single-token decode over the
rolling cache with eviction (:func:`decode_table`), the packed forward and
gradients (:func:`packed_table`) and the multi-token decode of speculative
verification (:func:`multi_decode_table`). Beside JAX's rows stand those of
what the port has and JAX's grid misses: the 96, 256, 512 and wide
instances and fp16 in the forward; D = 96 and 256 and dK/dV sink key blocks
cut into pieces in the gradients (each such row prints its piece count);
the bf16 and fp16 decode storages and the decode's deep design past
head_dim 128; a packed row whose sink blocks split.

The oracle is ``ops.reference.eager_sink_attention`` (and its packed form)
in fp32 on the same device, with TF32 off (:func:`main` turns it off, the
counterpart of JAX's ``default_matmul_precision("highest")``). A bf16 or
fp16 row's oracle reads the row's rounded inputs; a decode row's the fp32
draws, as JAX's tables do. Inputs are normal draws from
``numpy.random.default_rng(seed)``, a generator anew for each row as JAX's
script takes one key per table: the port keeps no copy of JAX's PRNG, so
its inputs are its own draws, not JAX's. Gradients go through
``torch.autograd``, on the port's autograd functions and on the oracle.

The kernels read fp32 operands as bf16 (fp16 as fp16); JAX's figures are
a TPU's at ``highest`` precision and do not describe the port. So beside
each forward and gradient row stands a control: the kernels' plain version
(``flash_fwd_plain`` / ``flash_bwd_plain``, the packed ones) with its
operands rounded as the kernel reads them (``matmul_dtype``), against the
same oracle: the reading's share of the error; ``own``, the kernel's
largest distance from its control, is the kernel's own share. A decode
row's control is ``decode_plain`` over the same cache (the storage's
share). The gate of a
row: every compared tensor's largest error at most 2 x its control's, or
else every element of it within the floor, the JAX tests' bound for the
same path applied element by element as they apply it (``FLOORS``, each
named with its source); a row without a control (the multi-token decode,
plain torch in the port as XLA in JAX) is held to its floor alone.

Each table prints its rows and returns them as dicts (``table``,
``config``, ``dtype``, ``err``, ``control``, ``gate`` (2 x the
control's), ``floor_ratio`` (the largest element's error over its floor:
at most 1 where every element is within it), ``source``, ``ok`` and the
table's own keys), so that tests and
``chip_smoke.py`` gate on them. On the CPU the kernels' plain versions run
where the card runs the kernels. Every row keeps N <= 1024: the oracle
builds the whole [B, H, N, N] score matrix.
"""

from __future__ import annotations

import argparse
import functools
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..cache import SinkKVCache
from ..ops import _build
from ..ops.decode import (cache_args, cache_state, decode_plain,
                          decode_plan, sink_decode_attention_cached,
                          sink_decode_attention_cached_multi)
from ..ops.flash import (DKDV_BM, DKDV_BNS, attention_backward,
                         dkdv_piece_table, flash_bwd_plain, flash_fwd_plain,
                         sink_flash_attention)
from ..ops.packed import (pack_positions, packed_bwd_plain, packed_fwd_plain,
                          packed_tables, sink_flash_attention_packed)
from ..ops.reference import eager_sink_attention, eager_sink_attention_packed
from ..utils import card_line, resolve_device

__all__ = ["fwd_table", "grad_table", "ds_aux_fd_table", "decode_table",
           "packed_table", "multi_decode_table", "all_tables", "fwd_case",
           "grad_case", "decode_case", "packed_case", "multi_case",
           "inputs", "gated", "floors", "floor_ratio", "FLOORS", "main"]

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
DTYPES = {"float32": F32, "bfloat16": BF16, "float16": F16}

# (B, H_q, H_kv, N, D, num_sink, window, dtype)
FWD_CONFIGS = [
    # JAX's grid
    (1, 8, 8, 256, 64, 4, 128, F32),
    (1, 8, 8, 1024, 64, 4, 256, F32),
    (1, 8, 2, 512, 128, 4, 128, F32),
    (1, 8, 8, 512, 64, 0, 128, F32),      # pure window
    (1, 8, 8, 512, 64, 16, 128, F32),     # 16 sinks
    (1, 8, 8, 512, 64, 4, 1, F32),        # window = 1
    (1, 8, 8, 512, 64, 4, 128, BF16),
    (1, 8, 2, 512, 128, 4, 4096, BF16),   # full causal
    (1, 8, 2, 512, 80, 4, 128, BF16),     # head_dim 80, the 80 instance
    (2, 8, 1, 384, 64, 4, 96, BF16),      # MQA, batch
    # the port's instances and types beyond it
    (1, 32, 32, 1024, 96, 4, 512, BF16),  # Phi-3-mini's 32/32, the 96 instance
    (1, 8, 2, 512, 96, 4, 128, F32),
    (1, 8, 4, 1024, 256, 4, 512, BF16),   # Gemma-2's 8/4, the 256 instance
    (1, 8, 4, 512, 256, 4, 128, F32),
    (1, 8, 4, 512, 384, 4, 128, BF16),    # the 512 instance at 384 columns
    (1, 8, 4, 512, 512, 4, 128, BF16),
    (1, 8, 4, 512, 1024, 4, 128, BF16),   # the wide instance
    (1, 8, 2, 512, 64, 4, 128, F16),
    (1, 8, 2, 512, 128, 4, 4096, F16),
]
# (B, H_q, H_kv, N, D, num_sink, window), fp32 as JAX's
GRAD_CONFIGS = [
    (1, 4, 4, 256, 64, 4, 128),
    (1, 8, 2, 256, 64, 4, 64),
    (1, 4, 4, 256, 64, 0, 128),
    (1, 4, 2, 192, 80, 4, 96),
    (1, 4, 4, 256, 96, 4, 128),           # the 96 instance
    (1, 8, 4, 512, 256, 4, 128),          # the 256 instance, sink block in 2
    (1, 8, 2, 1024, 64, 4, 128),          # sink key block in 4 pieces
    (1, 8, 4, 1024, 256, 4, 256),         # the 256 instance, in 3 pieces
]
# the reference's protocol (test_s_aux.py:196-239): fp32, no sinks, W = N
FD_SHAPE = (1, 2, 2, 32, 16)              # B, H_q, H_kv, N, D
FD_EPS = 1e-3
# (storage, D, H_q, H_kv, num_sink, window, prefill, steps, design); B = 1.
# Quantized caches take bf16 inputs, as JAX's table does.
DECODE_CONFIGS = [
    ("float32", 64, 8, 2, 4, 64, 80, 40, "short"),
    ("bfloat16", 64, 8, 2, 4, 64, 80, 40, "short"),
    ("float16", 64, 8, 2, 4, 64, 80, 40, "short"),
    ("int8", 64, 8, 2, 4, 64, 80, 40, "short"),
    ("fp8", 64, 8, 2, 4, 64, 80, 40, "short"),
    ("bfloat16", 256, 8, 4, 4, 256, 300, 16, "deep"),
]
# (segment lengths, D) at B = 1, H 4/2, 4 sinks, W = 64, fp32
PACK_GEOMETRY = (1, 4, 2, 4, 64)          # B, H_q, H_kv, num_sink, window
PACKS = [([128, 128], 64), ([100, 30, 70, 56], 64), ([200, 56], 64),
         ([8] * 32, 64),
         ([640, 384], 256)]               # both sink blocks in pieces
# (prefill P, drafts T) at B = 1, H 4/2, D = 64, 4 sinks, W = 64, fp32
MULTI_GEOMETRY = (1, 4, 2, 64, 4, 64)     # B, H_q, H_kv, D, num_sink, window
MULTI_CONFIGS = [(100, 4), (40, 8), (200, 16)]

# The floors of the gates, from the JAX tests' bound for the same path:
# (atol, rtol, source); each element of a tensor a row compares is within
# its floor where |error| <= atol + rtol x |its oracle|, as assert_allclose
# applies the bound in those tests.
# The fp32 rows take JAX's bounds on a TPU, whose matrix unit reads fp32 as
# bf16 at default precision, as the port's kernels do; the packed JAX
# tests (tests/test_packed.py:63, :118) hold a kernel that computes fp32 in
# fp32 on the CPU, so the packed rows take the unpacked path's TPU bounds
# (the same kernel templates). The fp32 decode computes in fp32: JAX's CPU
# bound; the quantized decode's is the port's against the JAX kernels.
FLOORS = {
    ("fwd", "float32"): (6e-3, 1e-3, "tests/test_flash_prefill.py:30-32,61"),
    ("fwd", "bfloat16"): (2e-2, 1e-3, "tests/test_flash_prefill.py:35,61"),
    ("fwd", "float16"): (4e-3, 1e-3, "tests/test_flash_prefill.py:36,61"),
    ("grad", "float32"): (2e-3, 1e-2, "tests/test_flash_backward.py:59-62"),
    ("decode", "float32"): (1e-5, 0.0, "tests/test_decode.py:23-24,115"),
    ("decode", "bfloat16"): (2e-2, 1e-3, "tests/test_flash_prefill.py:35,61"),
    ("decode", "float16"): (4e-3, 1e-3, "tests/test_flash_prefill.py:36,61"),
    ("decode", "int8"): (3e-2, 0.0, "tests/test_torch_quant_cache.py:119"),
    ("decode", "fp8"): (1e-2, 0.0, "tests/test_torch_quant_cache.py:119"),
    ("multi_decode", "float32"): (1e-5, 0.0, "tests/test_decode.py:182"),
}
# the finite-difference row's: 5e-2 x max(1, |analytic ds_aux|) each head
FD_FLOOR = (5e-2, "tests/test_flash_backward.py:84")
GRADS = ("dq", "dk", "dv", "ds_aux")


def _name(B, H_q, H_kv, N, D, ns, W) -> str:
    return f"B{B} H{H_q}/{H_kv} N{N} D{D} sink{ns} W{W}"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def inputs(seed: int, B: int, H_q: int, H_kv: int, N: int, D: int):
    """numpy fp32 (q [B,H_q,N,D], k, v [B,H_kv,N,D], s_aux [H_q]): normal
    draws from a ``numpy.random.default_rng(seed)`` made anew."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in (
        (B, H_q, N, D), (B, H_kv, N, D), (B, H_kv, N, D), (H_q,))]


def _on(arrays, device):
    return [torch.from_numpy(a).to(device) for a in arrays]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| in fp32 (NaN where either holds one)."""
    return float((a.float() - b.float()).abs().max())


def cos_sim(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def gated(table: str, config: str, dtype: str, err: dict,
          control: Optional[dict], ratio: dict, source: str,
          **extra) -> dict:
    """A row: each error of ``err`` (a largest |error|) within 2 x the
    control's, or else within its floor (``ratio``: the largest element's
    error over its floor, at most 1 where every element is within it); a
    row without a control is held to its floor alone. ``ok`` is false
    where an error is within neither or is not a number."""
    gate = {k: 2 * control[k] if control else None for k in err}

    def within(k):
        return (gate[k] is not None and err[k] <= gate[k]) or ratio[k] <= 1

    return {"table": table, "config": config, "dtype": dtype, "err": err,
            "control": control, "gate": gate, "floor_ratio": ratio,
            "source": source, "ok": all(within(k) for k in err), **extra}


def floor_ratio(got: torch.Tensor, ref: torch.Tensor, atol: float,
                rtol: float) -> float:
    """max_i |got_i - ref_i| / (atol + rtol x |ref_i|): at most 1 where
    every element is within the bound as ``assert_allclose`` applies it;
    NaN where either tensor holds one."""
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def floors(kind: str, dtype: str, pairs: dict):
    """({name: floor_ratio(got, oracle)}, source) of ``FLOORS[(kind,
    dtype)]`` for ``pairs`` {name: (got, oracle)}."""
    atol, rtol, source = FLOORS[(kind, dtype)]
    return {k: floor_ratio(got, ref, atol, rtol)
            for k, (got, ref) in pairs.items()}, source


def _mark(row) -> str:
    return "ok" if row["ok"] else "MISSED"


def _grads_of(attn, tensors):
    """(out, grads of sum(out ** 2) in fp32 w.r.t. ``tensors``) through
    autograd."""
    leaves = [t.detach().clone().requires_grad_() for t in tensors]
    out = attn(*leaves)
    (out.float() ** 2).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def _read_as(dtype: torch.dtype) -> torch.dtype:
    """The type the kernels read an input type's operands in."""
    return BF16 if dtype == F32 else dtype


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def fwd_case(config, device, seed: int = 0):
    """(out, oracle, control) of one forward row: the kernel (on the CPU
    its plain version), the fp32 oracle on the row's inputs, and the plain
    version reading its operands as the kernel does."""
    B, H_q, H_kv, N, D, ns, W, dtype = config
    q, k, v, aux = _on(inputs(seed, B, H_q, H_kv, N, D), device)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    out = sink_flash_attention(q, k, v, ns, W, s_aux=aux)
    ref = eager_sink_attention(q.float(), k.float(), v.float(), ns, W,
                               s_aux=aux)
    ctl = flash_fwd_plain(q, k, v, aux, ns, W,
                          matmul_dtype=_read_as(dtype))[0]
    return out, ref, ctl


def fwd_table(device="cuda", seed: int = 0,
              configs: Sequence = FWD_CONFIGS) -> list:
    dev = resolve_device(device)
    print("\n=== Forward accuracy (kernel vs fp32 eager) ===")
    print(f"{'config':<46} {'dtype':<9} {'max_err':>10} {'cos_sim':>9} "
          f"{'control':>10} {'gate':>10} {'/floor':>8} {'own':>10}")
    rows = []
    for config in configs:
        out, ref, ctl = fwd_case(config, dev, seed)
        dtype = _dtype_name(config[-1])
        row = gated("fwd", _name(*config[:7]), dtype,
                    {"out": max_err(out, ref)}, {"out": max_err(ctl, ref)},
                    *floors("fwd", dtype, {"out": (out, ref)}),
                    cos=cos_sim(out, ref), own={"out": max_err(out, ctl)})
        rows.append(row)
        print(f"{row['config']:<46} {dtype:<9} {row['err']['out']:>10.2e} "
              f"{row['cos']:>9.5f} {row['control']['out']:>10.2e} "
              f"{row['gate']['out']:>10.2e} "
              f"{row['floor_ratio']['out']:>8.2f} {row['own']['out']:>10.2e} "
              f"{_mark(row)}")
    return rows


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def _control(tensors, ns, W, fwd_plain, bwd_plain, mm):
    """(o, [dq, dk, dv, ds_aux] of sum(o ** 2)) through the plain
    versions reading their operands in ``mm``."""
    q, k, v, aux = tensors
    o, lse = fwd_plain(q, k, v, aux, ns, W, matmul_dtype=mm)
    return o, list(attention_backward(
        q, k, v, aux, o, lse, 2 * o, None, ns, W,
        dqkv=functools.partial(bwd_plain, matmul_dtype=mm)))


def dkdv_split(N: int, ns: int, W: int, D: int):
    """(pieces, the most pieces of one key block) of the dK/dV kernel's
    piece table (``ops.flash.dkdv_piece_table``) at a self-attention
    shape: a key block cut into pieces shows as a second number above 1."""
    bn = DKDV_BNS[_build.kernel_head_dim(_build.padded_head_dim(D))]
    table = dkdv_piece_table(N, N, ns, W, 0, 0, DKDV_BM, bn)
    return int(table[0, 0]), int(table[1:, 3].max())


def grad_case(config, device, seed: int = 1):
    """(kernel grads, oracle grads, control grads) of one gradient row:
    each [dq, dk, dv, ds_aux] of sum(o ** 2), fp32 inputs."""
    B, H_q, H_kv, N, D, ns, W = config
    tensors = _on(inputs(seed, B, H_q, H_kv, N, D), device)
    _, kern = _grads_of(lambda q, k, v, a: sink_flash_attention(
        q, k, v, ns, W, s_aux=a), tensors)
    _, ref = _grads_of(lambda q, k, v, a: eager_sink_attention(
        q, k, v, ns, W, s_aux=a), tensors)
    ctl = _control(tensors, ns, W, flash_fwd_plain, flash_bwd_plain, BF16)
    return kern, ref, ctl[1]


def _errs_line(name, width, row):
    """A row's errors, its control's, the kernel's distance from the
    control, the largest error over its floor, its dK/dV pieces (the most
    of one key block) and its mark."""
    cols = [" ".join(f"{row[key][g]:>9.2e}" for g in row["err"])
            for key in ("err", "control", "own")]
    return (f"{name:<{width}} {' | '.join(cols)} | "
            f"{max(row['floor_ratio'].values()):.2f} | {row['pieces']} "
            f"({row['split']}) {_mark(row)}")


def grad_table(device="cuda", seed: int = 1,
               configs: Sequence = GRAD_CONFIGS) -> list:
    dev = resolve_device(device)
    print("\n=== Gradient accuracy (kernel vs fp32 eager autodiff) ===")
    print(f"{'config':<40} {'dq':>9} {'dk':>9} {'dv':>9} {'ds_aux':>9} | "
          f"control: the same | own: kernel - control | /floor | dK/dV "
          f"pieces (the most of a key block)")
    rows = []
    for config in configs:
        kern, ref, ctl = grad_case(config, dev, seed)
        B, H_q, H_kv, N, D, ns, W = config
        pieces, split = dkdv_split(N, ns, W, D)
        row = gated("grad", _name(*config), "float32",
                    {g: max_err(a, b) for g, a, b in zip(GRADS, kern, ref)},
                    {g: max_err(a, b) for g, a, b in zip(GRADS, ctl, ref)},
                    *floors("grad", "float32",
                            dict(zip(GRADS, zip(kern, ref)))),
                    pieces=pieces, split=split,
                    own={g: max_err(a, b) for g, a, b in zip(GRADS, kern,
                                                              ctl)})
        rows.append(row)
        print(_errs_line(row["config"], 40, row))
    return rows


def ds_aux_fd_table(device="cuda", seed: int = 42) -> list:
    """ds_aux, analytical against central finite differences, under the
    reference's protocol (test_s_aux.py:196-239: fp32, B=1 H=2 N=32 D=16,
    no sinks, W = N, loss = out.sum(), eps = 1e-3), each loss summed in
    fp64 on the host. The kernels read the fp32 operands as bf16 and round
    P once, so the difference quotient sees that rounding where a step of
    s_aux moves the rows' maximum; the control (the plain version at the
    kernels' reading) sees the same."""
    dev = resolve_device(device)
    B, H_q, H_kv, N, D = FD_SHAPE
    q, k, v, aux = _on(inputs(seed, B, H_q, H_kv, N, D), dev)
    print("\n=== ds_aux analytic vs finite differences (reference protocol, "
          "test_s_aux.py:196-239) ===")

    def kernel(a):
        return sink_flash_attention(q, k, v, 0, N, s_aux=a)

    def control(a):
        return flash_fwd_plain(q, k, v, a, 0, N, matmul_dtype=BF16)[0]

    def numeric(fwd):
        out = np.zeros(H_q)
        for h in range(H_q):
            e = torch.zeros_like(aux)
            e[h] = FD_EPS
            plus, minus = (float(fwd(aux + s * e).detach().cpu().double()
                                 .sum()) for s in (1, -1))
            out[h] = (plus - minus) / (2 * FD_EPS)
        return out

    a = aux.clone().requires_grad_()
    kernel(a).float().sum().backward()
    analytic = a.grad.double().cpu().numpy()
    o, lse = flash_fwd_plain(q, k, v, aux, 0, N, matmul_dtype=BF16)
    ctl_analytic = attention_backward(
        q, k, v, aux, o, lse, torch.ones_like(o), None, 0, N,
        dqkv=functools.partial(flash_bwd_plain, matmul_dtype=BF16)
    )[3].double().cpu().numpy()
    num, ctl_num = numeric(kernel), numeric(control)
    floor, source = FD_FLOOR
    ratio = np.abs(analytic - num) / (floor * np.maximum(1.0,
                                                          np.abs(analytic)))
    row = gated("ds_aux_fd", _name(B, H_q, H_kv, N, D, 0, N), "float32",
                {"ds_aux": float(np.abs(analytic - num).max())},
                {"ds_aux": float(np.abs(ctl_analytic - ctl_num).max())},
                {"ds_aux": float(ratio.max())}, source,
                analytic=analytic.tolist(), numeric=num.tolist(),
                own={"ds_aux": float(np.abs(analytic - ctl_analytic).max())})
    print(f"analytic {np.array2string(analytic, precision=6)}  numeric "
          f"{np.array2string(num, precision=6)}")
    print(f"max diff {row['err']['ds_aux']:.2e}, control "
          f"{row['control']['ds_aux']:.2e}, gate {row['gate']['ds_aux']:.2e}, "
          f"over its floor {row['floor_ratio']['ds_aux']:.2f}, analytic vs "
          f"the control's {row['own']['ds_aux']:.2e} "
          f"{_mark(row)} (the reference measured 1.19e-3 on an H200 with a "
          f"device-side fp32 loss reduction)")
    return [row]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_case(config, device, seed: int = 2):
    """(kernel out, oracle, control, plan) of one decode row over its
    steps, each [B, H_q, steps, D]: every step appends a token to the
    cache and decodes it; the oracle is the fp32 eager attention of the
    step's row over every token so far, the control ``decode_plain`` over
    the same cache, ``plan`` what the last step launched
    (``ops.decode.decode_plan``; None on the CPU)."""
    storage, D, H_q, H_kv, ns, W, prefill, steps, _ = config
    B, total = 1, prefill + steps
    q_all, k_all, v_all, aux = _on(inputs(seed, B, H_q, H_kv, total, D),
                                   device)
    quant = storage if storage in ("int8", "fp8") else None
    dtype = BF16 if quant else DTYPES[storage]
    cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                             dtype=dtype, quant=quant, device=device)
    cache.prefill(k_all[:, :, :prefill].to(dtype),
                  v_all[:, :, :prefill].to(dtype))
    outs, refs, ctls = [], [], []
    for t in range(prefill, total):
        cache.append(k_all[:, :, t:t + 1].to(dtype),
                     v_all[:, :, t:t + 1].to(dtype))
        qt = q_all[:, :, t:t + 1].to(dtype)
        outs.append(sink_decode_attention_cached(qt, cache, s_aux=aux))
        ctls.append(decode_plain(qt, cache.k, cache.v, cache_state(cache),
                                 aux, **cache_args(cache)))
        refs.append(eager_sink_attention(
            q_all[:, :, t:t + 1], k_all[:, :, :t + 1], v_all[:, :, :t + 1],
            ns, W, s_aux=aux, q_offset=t))
    plan = (decode_plan(qt, cache.k, cache_state(cache),
                        sink_cap=cache.sink_cap, window_size=W)
            if qt.is_cuda else None)
    return (torch.cat(outs, 2), torch.cat(refs, 2), torch.cat(ctls, 2),
            plan)


def decode_table(device="cuda", seed: int = 2,
                 configs: Sequence = DECODE_CONFIGS) -> list:
    dev = resolve_device(device)
    print("\n=== Decode accuracy over the rolling cache (multi-step, with "
          "eviction) ===")
    print(f"{'kv storage':<10} {'config':<44} {'worst max_err':>14} "
          f"{'control':>10} {'gate':>10} {'/floor':>8} {'own':>10} design")
    rows = []
    for config in configs:
        storage, D, H_q, H_kv, ns, W, prefill, steps, design = config
        out, ref, ctl, plan = decode_case(config, dev, seed)
        ran = plan["design"] if plan else "plain"
        row = gated("decode", f"{_name(1, H_q, H_kv, prefill, D, ns, W)} "
                    f"+{steps}", storage, {"out": max_err(out, ref)},
                    {"out": max_err(ctl, ref)},
                    *floors("decode", storage, {"out": (out, ref)}),
                    design=ran,
                    design_expected=design, plan=plan,
                    own={"out": max_err(out, ctl)})
        if plan and ran != design:
            row["ok"] = False
        rows.append(row)
        print(f"{storage:<10} {row['config']:<44} {row['err']['out']:>14.2e} "
              f"{row['control']['out']:>10.2e} {row['gate']['out']:>10.2e} "
              f"{row['floor_ratio']['out']:>8.2f} {row['own']['out']:>10.2e} "
              f"{ran} {_mark(row)}")
    return rows


# ---------------------------------------------------------------------------
# packed
# ---------------------------------------------------------------------------


def _positions(segs, device) -> torch.Tensor:
    return pack_positions(segs)[None].to(device, torch.int32)


def packed_case(config, device, seed: int = 3):
    """((out, grads), (oracle out, grads), (control out, grads)) of one
    packed row, grads [dq, dk, dv, ds_aux] of sum(o ** 2), fp32 inputs."""
    segs, D = config
    B, H_q, H_kv, ns, W = PACK_GEOMETRY
    pos = _positions(segs, device)
    tensors = _on(inputs(seed, B, H_q, H_kv, sum(segs), D), device)
    kern = _grads_of(lambda q, k, v, a: sink_flash_attention_packed(
        q, k, v, pos, ns, W, s_aux=a), tensors)
    ref = _grads_of(lambda q, k, v, a: eager_sink_attention_packed(
        q, k, v, pos, ns, W, s_aux=a), tensors)

    def fwd(q, k, v, aux, ns, W, matmul_dtype):
        return packed_fwd_plain(q, k, v, pos, aux, ns, W, matmul_dtype)

    def bwd(q, k, v, do, lse, delta, *_, matmul_dtype):
        return packed_bwd_plain(q, k, v, do, lse, delta, pos, ns, W,
                                matmul_dtype)

    return kern, ref, _control(tensors, ns, W, fwd, bwd, BF16)


def packed_table(device="cuda", seed: int = 3,
                 configs: Sequence = PACKS) -> list:
    dev = resolve_device(device)
    _, _, _, ns, W = PACK_GEOMETRY
    print("\n=== Packed (varlen) accuracy (kernel vs fp32 packed eager) ===")
    print(f"{'segments':<28} {'fwd':>9} {'dq':>9} {'dk':>9} {'dv':>9} "
          f"{'ds_aux':>9} | control: the same | own: kernel - control | "
          f"/floor | dK/dV pieces (the most of a key block)")
    rows = []
    for segs, D in configs:
        kern, ref, ctl = packed_case((segs, D), dev, seed)
        pieces = packed_tables(_positions(segs, dev), ns, W,
                               D).kv_pieces.cpu()
        n = int(pieces[0, 0])
        name = ("x".join(str(L) for L in segs[:4])
                + ("..." if len(segs) > 4 else "") + f" D{D}")
        errs = [{key: max_err(a, b) for key, a, b in zip(
            ("out",) + GRADS, [x[0], *x[1]], [y[0], *y[1]])}
            for x, y in ((kern, ref), (ctl, ref), (kern, ctl))]
        fwd_floor, fwd_src = floors("fwd", "float32",
                                    {"out": (kern[0], ref[0])})
        grad_floor, grad_src = floors("grad", "float32",
                                      dict(zip(GRADS, zip(kern[1], ref[1]))))
        row = gated("packed", name, "float32", *errs[:2],
                    {**fwd_floor, **grad_floor}, f"{fwd_src}; {grad_src}",
                    pieces=n,
                    split=int(pieces[1:n + 1, 3].max()),
                    segments=list(segs), head_dim=D, own=errs[2])
        rows.append(row)
        print(_errs_line(name, 28, row))
    return rows


# ---------------------------------------------------------------------------
# multi-token decode
# ---------------------------------------------------------------------------


def multi_case(config, device, seed: int = 4):
    """(out, oracle) of one multi-token decode row: T draft tokens over a
    cache prefilled with P, against the drafts' rows of the fp32 eager
    attention over all P + T tokens."""
    P, T = config
    B, H_q, H_kv, D, ns, W = MULTI_GEOMETRY
    q, k, v, aux = _on(inputs(seed, B, H_q, H_kv, P + T, D), device)
    cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                             dtype=F32, device=device)
    cache.prefill(k[:, :, :P], v[:, :, :P])
    out, _ = sink_decode_attention_cached_multi(
        q[:, :, P:], k[:, :, P:], v[:, :, P:], cache, s_aux=aux)
    return out, eager_sink_attention(q, k, v, ns, W, s_aux=aux)[:, :, P:]


def multi_decode_table(device="cuda", seed: int = 4,
                       configs: Sequence = MULTI_CONFIGS) -> list:
    dev = resolve_device(device)
    print("\n=== Multi-token (speculative) decode accuracy ===")
    print(f"{'prefill/T':<14} {'max_err':>10} {'/floor':>8}")
    rows = []
    for P, T in configs:
        out, ref = multi_case((P, T), dev, seed)
        row = gated("multi_decode", f"{P}/{T}", "float32",
                    {"out": max_err(out, ref)}, None,
                    *floors("multi_decode", "float32", {"out": (out, ref)}))
        rows.append(row)
        print(f"{row['config']:<14} {row['err']['out']:>10.2e} "
              f"{row['floor_ratio']['out']:>8.2f} {_mark(row)}")
    return rows


def all_tables(device="cuda") -> list:
    """Every table's rows, in the JAX script's order, at its seeds."""
    return (fwd_table(device) + grad_table(device) + ds_aux_fd_table(device)
            + decode_table(device) + packed_table(device)
            + multi_decode_table(device))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the tables run (default: the card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # fp32 products in fp32: the oracle's and the plain versions'
    torch.backends.cuda.matmul.allow_tf32 = False
    print("device: " + (card_line() if dev.type == "cuda" else "cpu"))
    rows = all_tables(dev)
    missed = [r for r in rows if not r["ok"]]
    print(f"\n{len(rows) - len(missed)} of {len(rows)} rows within their "
          "gates" + "".join(f"\nMISSED: {r['table']} {r['config']} "
                            f"{r['dtype']}" for r in missed))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
