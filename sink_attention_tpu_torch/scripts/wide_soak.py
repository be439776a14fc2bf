"""Launch the attention kernels of the wide instance (head_dim past 512)
many times, each launch waited for, and hold every launch's output bitwise
to the first's: a soak for hangs and races in their pipelines (a race
shows as a hang, a failed launch or an output that differs).

    python3 -m sink_attention_tpu_torch.scripts.wide_soak
        [--forward N] [--decode N] [--backward N] [--small] [--stall S]

By default at ``chip_smoke.py``'s phase-16 shapes (head_dim 1024, bf16,
GQA 8/4): the forward over B=2, N=8176 (the serving prefill) on a sliding
(W=4096) and a full layer; the decode over bf16 and int8 caches of a
sliding and a full layer filled with 8176 + 15 tokens, B=2; dQ and dK/dV
over 1 x 8192 at W=4096. Each shape runs ``N`` + 1 launches of its
kernel. ``--small`` runs the forward alone at B=1, 2/1 heads, N=1024,
D=1024, W=256 with 4 sinks and s_aux (every 64-row item meets a tile that
none of its rows sees), and holds its first launch to the plain version
too. A thread that sees no launch end for ``--stall`` seconds prints the
launch it waits on and ends the process (exit 3); a failed launch exits
2, an output that differs 1. Prints one JSON line: by shape, launches,
mismatches and seconds (and the plain version's error), and the card's
name and power limit. Without CUDA it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", type=int, default=500)
    ap.add_argument("--decode", type=int, default=10000)
    ap.add_argument("--backward", type=int, default=50)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--stall", type=float, default=60.0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("wide_soak: CUDA is not available", file=sys.stderr)
        return 1
    from sink_attention_tpu_torch.cache import SinkKVCache
    from sink_attention_tpu_torch.ops import _build, decode, flash
    from sink_attention_tpu_torch.utils import card_line

    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    waiting = {"on": None, "since": time.monotonic()}

    def watchdog():
        while True:
            time.sleep(1.0)
            on, since = waiting["on"], waiting["since"]
            if on is not None and time.monotonic() - since > args.stall:
                print(json.dumps({"stalled": on, "seconds":
                                  time.monotonic() - since}), flush=True)
                os._exit(3)

    threading.Thread(target=watchdog, daemon=True).start()
    report = {"card": card_line()}

    def soak(label, fn, n, plain=None):
        first = None
        bad = 0
        t0 = time.perf_counter()
        for i in range(n + 1):
            waiting["since"] = time.monotonic()
            waiting["on"] = f"{label}, launch {i}"
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            torch.cuda.synchronize()
            if first is None:
                first = tuple(t.clone() for t in out)
            else:
                bad += not all(torch.equal(a, b) for a, b in zip(out, first))
        waiting["on"] = None
        rep = {"launches": n + 1, "mismatches": bad,
               "seconds": time.perf_counter() - t0}
        if plain is not None:
            rep["max_abs_err_vs_plain"] = float(
                (first[0].float() - plain().float()).abs().max())
        report[label] = rep
        return bad

    bad = 0
    try:
        if args.small:
            q, k, v = mk(1, 2, 1024, 1024), mk(1, 1, 1024, 1024), mk(
                1, 1, 1024, 1024)
            aux = torch.randn(2, generator=gen, device=dev)
            bad += soak("forward B=1 H=2/1 N=1024 D=1024 W=256 4 sinks",
                        lambda: flash.flash_fwd_kernel(q, k, v, aux, 4, 256),
                        args.forward, lambda: flash.flash_fwd_plain(
                            q, k, v, aux, 4, 256)[0])
        else:
            q, k, v = mk(2, 8, 8176, 1024), mk(2, 4, 8176, 1024), mk(
                2, 4, 8176, 1024)
            for w in (4096, 8192):
                bad += soak(f"forward B=2 H=8/4 N=8176 D=1024 W={w}",
                            lambda: flash.flash_fwd_kernel(q, k, v, None, 0,
                                                           w), args.forward)
            del q, k, v
            for w in (4096, 8192):
                for quant in (None, "int8"):
                    cache = SinkKVCache.init(2, 4, 1024, num_sink=0,
                                             window_size=w, quant=quant,
                                             device=dev)
                    cache.prefill(mk(2, 4, 8176, 1024), mk(2, 4, 8176, 1024))
                    for _ in range(15):
                        cache.append(mk(2, 4, 1, 1024), mk(2, 4, 1, 1024))
                    qd = mk(2, 8, 1, 1024)
                    bad += soak(
                        f"decode {quant or 'bf16'} B=2 H=8/4 D=1024 W={w} "
                        "after 8176 + 15 tokens",
                        lambda: decode.sink_decode_attention_cached(qd, cache),
                        args.decode)
            q, do = mk(1, 8, 8192, 1024), mk(1, 8, 8192, 1024)
            k, v = mk(1, 4, 8192, 1024), mk(1, 4, 8192, 1024)
            o, lse = flash.flash_fwd_kernel(q, k, v, None, 0, 4096)
            delta = (do.float() * o.float()).sum(-1)
            a = (q, k, v, do, lse, delta, 0, 4096)
            bad += soak("dq B=1 H=8/4 N=8192 D=1024 W=4096",
                        lambda: flash.flash_dq_kernel(*a), args.backward)
            bad += soak("dkdv B=1 H=8/4 N=8192 D=1024 W=4096",
                        lambda: flash.flash_dkdv_kernel(*a), args.backward)
    except RuntimeError as e:  # a failed launch (a trapped wait among them)
        report["failed"] = {"at": waiting["on"], "error": str(e)}
        print(json.dumps(report), flush=True)
        os._exit(2)  # the context is lost: no clean teardown
    print(json.dumps(report), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
