"""Direct kernel usage: prefill, packed, decode over the rolling cache.

    python3 -m sink_attention_tpu_torch.examples.kernels [--device cpu]

On an H100 each call below launches one of the port's CUDA kernels (the
forward, the packed forward, the decode); on the CPU their plain versions
run. Returns what it prints: the prefill's largest error against the eager
oracle and the packed and decode outputs' shapes.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ..cache import SinkKVCache
from ..ops import (eager_sink_attention, sink_decode_attention_cached,
                   sink_flash_attention, sink_flash_attention_packed)
from ..utils import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="prefill, packed and decode "
                                             "attention")
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    B, Hq, Hkv, N, D = 1, 8, 2, 512, 64
    ns, W = 4, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(B, h, N, D, generator=gen, device=dev).to(
        torch.bfloat16) for h in (Hq, Hkv, Hkv))
    aux = torch.randn(Hq, generator=gen, device=dev)

    # prefill / training attention (differentiable, s_aux included)
    out = sink_flash_attention(q, k, v, num_sink=ns, window_size=W,
                               s_aux=aux)
    ref = eager_sink_attention(q, k, v, ns, W, s_aux=aux)
    err = float((out.float() - ref.float()).abs().max())
    print("prefill max err vs oracle:", err)

    # packed batch: two segments of N / 2 tokens, per-segment sinks/windows
    pos = torch.cat([torch.arange(N // 2), torch.arange(N // 2)])[None]
    out_p = sink_flash_attention_packed(q, k, v, pos.to(dev, torch.int32),
                                        ns, W, s_aux=aux)
    print("packed out:", tuple(out_p.shape))

    # rolling cache + decode kernel
    cache = SinkKVCache.init(B, Hkv, D, num_sink=ns, window_size=W,
                             dtype=torch.bfloat16, device=dev)
    cache.prefill(k, v)
    q1 = torch.randn(B, Hq, 1, D, generator=gen, device=dev).to(
        torch.bfloat16)
    k1 = q1[:, :Hkv]
    cache.append(k1, k1)
    o1 = sink_decode_attention_cached(q1, cache, s_aux=aux)
    print("decode out:", tuple(o1.shape))
    return {"prefill_err": err, "packed_shape": tuple(out_p.shape),
            "decode_shape": tuple(o1.shape)}


if __name__ == "__main__":
    main()
