"""Serve a gpt-oss-style model with continuous batching on one H100.

    python3 -m sink_attention_tpu_torch.examples.serve           # 4 layers
    python3 -m sink_attention_tpu_torch.examples.serve --bits 8  # int8
    python3 -m sink_attention_tpu_torch.examples.serve --bits 4 --layers 24

gpt-oss-20b's geometry at full width, random weights from a generator
seeded 0: bf16 (``--bits 16``), int8 quantized in place (``--bits 8``) or
drawn in int4 (``--bits 4``: all 24 layers fit one 80 GB card). ``--slots``
requests of 39-60 prompt tokens, ``--tokens`` new tokens each, through
``ContinuousBatchingEngine``. ``--tiny`` takes ``ModelConfig.tiny()``
instead, for a run on the CPU (``--device cpu``).

With real weights: load an HF checkpoint through
``sink_attention_tpu_torch.models.load_hf_checkpoint`` and, optionally,
``quantize_params(params, inplace=True)`` before building the engine.
Returns {request id: generated tokens}.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ..models import (ModelConfig, init_params, init_quantized_params,
                      quantize_params)
from ..serving import ContinuousBatchingEngine
from ..utils import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="continuous batching")
    ap.add_argument("--bits", type=int, default=16, choices=(16, 8, 4))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="ModelConfig.tiny() in place of gpt-oss-20b")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = (ModelConfig.tiny(num_layers=args.layers) if args.tiny
           else ModelConfig.gpt_oss_20b(num_layers=args.layers))
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.bits == 4:
        params = init_quantized_params(cfg, gen, bits=4, device=dev)
    else:
        params = init_params(cfg, gen, torch.bfloat16, device=dev)
        if args.bits == 8:
            params = quantize_params(params, inplace=True)

    eng = ContinuousBatchingEngine(params, cfg, max_batch=args.slots,
                                   max_len=4096, prefill_bucket=64,
                                   device=dev)
    rids = [eng.submit(list(range(1, 40 + 7 * i)),
                       max_new_tokens=args.tokens)
            for i in range(args.slots)]
    out = eng.run(chunk=16)
    for rid in rids:
        print(f"request {rid}: {out[rid]}")
    return {rid: out[rid] for rid in rids}


if __name__ == "__main__":
    main()
