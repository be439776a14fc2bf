"""Which backend of PyTorch's scaled_dot_product_attention runs the
yardstick (``library_ms``) of chip_smoke.py's forward rows, by head dim.

    python3 -m sink_attention_tpu_torch.scripts.sdpa_backends
        [--dims 64,128,256,384,512] [--n 8192] [--window 4096]

For each D it builds bf16 q [2, 8, N, D], k and v [2, 4, N, D] and the
sink + window mask as a boolean ``attn_mask`` (as ``chip_smoke._sdpa``
calls it, GQA through ``enable_gqa``), then times the call with each
backend alone (``torch.nn.attention.sdpa_kernel``: flash, efficient,
cuDNN, math) and with the default choice, and prints one JSON line per D:
each backend's ms, or why it refused, and the default's ms. The default
is the backend whose time it matches. The yardstick is timed here only;
the port never calls SDPA. Without CUDA it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dims", default="64,128,256,384,512")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--window", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sdpa_backends: CUDA is not available", file=sys.stderr)
        return 1
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from sink_attention_tpu_torch.ops.reference import sink_window_mask
    from sink_attention_tpu_torch.utils import card_line, time_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = args.n
    mask = sink_window_mask(n, n, 0, args.window, device=dev)
    backends = {"flash": SDPBackend.FLASH_ATTENTION,
                "efficient": SDPBackend.EFFICIENT_ATTENTION,
                "cudnn": SDPBackend.CUDNN_ATTENTION,
                "math": SDPBackend.MATH}
    print(f"sdpa_backends: card {card_line()}; torch {torch.__version__}")
    for d in (int(x) for x in args.dims.split(",")):
        q, k, v = (torch.randn(2, h, n, d, generator=gen, device=dev).to(
            torch.bfloat16) for h in (8, 4, 4))

        def call():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)

        row = {"D": d, "N": n, "window": args.window}
        for name, backend in backends.items():
            try:
                with sdpa_kernel([backend]):
                    call()
                    row[name] = time_cuda(call, iters=5, warmup=1)
            except RuntimeError as e:
                row[name] = f"refused: {str(e).splitlines()[0][:80]}"
            torch.cuda.empty_cache()
        row["default"] = time_cuda(call, iters=5, warmup=1)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
