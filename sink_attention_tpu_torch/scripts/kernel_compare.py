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
``decode_kernel`` over phase 2's bf16 caches (gpt-oss-20b's sliding ring
and full layer mid-decode, the headline); each kernel also at one of
phase 14's Gemma-2-2B shapes (D = 256, the 256 instance) and of phase
15's (D = 512, the 512 instance). The shapes run
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
fresh build read the same in this one's, and each that does not. Without
CUDA it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkdv_kernel",
           "packed_fwd_kernel", "packed_dq_kernel", "packed_dkdv_kernel",
           "decode_kernel")

# the forward: (label, B, H_q, H_kv, N, D, num_sink, window)
FORWARD = [
    ("prefill W=128", 4, 64, 8, 1024, 64, 0, 128),
    ("prefill W=1024", 4, 64, 8, 1024, 64, 0, 1024),
    ("headline N=8192 D=128", 1, 32, 8, 8192, 128, 4, 4096),
    ("gemma W=4096 D=256", 2, 8, 4, 8192, 256, 0, 4096),
    ("gemma W=4096 D=512", 2, 8, 4, 8192, 512, 0, 4096),
]
# the backward: (label, B, H_q, H_kv, N, D, num_sink, window, halo)
UNPACKED = [
    ("W=128", 1, 64, 8, 4096, 64, 0, 128, 0),
    ("W=4096", 1, 64, 8, 4096, 64, 0, 4096, 0),
    ("headline N=8192 D=128", 1, 32, 8, 8192, 128, 4, 4096, 0),
    ("halo chunk", 1, 64, 8, 1024, 64, 4, 256, 256),
    ("group 1", 1, 8, 8, 2048, 64, 4, 2048, 0),
    ("group 16", 1, 64, 4, 2048, 64, 4, 2048, 0),
    ("N_q=250", 1, 64, 8, 250, 64, 4, 128, 0),
    ("gemma W=4096 D=256", 1, 8, 4, 8192, 256, 0, 4096, 0),
    ("gemma W=4096 D=512", 1, 8, 4, 8192, 512, 0, 4096, 0),
]
# the decode over a bf16 SinkKVCache: (label, B, H_q, H_kv, D, num_sink,
# window, prefill length, appends)
DECODE = [
    ("decode W=128", 4, 64, 8, 64, 0, 128, 1024, 16),
    ("decode W=1056", 4, 64, 8, 64, 0, 1056, 1024, 16),
    ("decode headline D=128", 1, 32, 8, 128, 4, 4096, 8192, 1),
    ("decode gemma D=256", 2, 8, 4, 256, 0, 4096, 8192, 16),
    ("decode gemma D=512", 2, 8, 4, 512, 0, 4096, 8192, 16),
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
    ("packed gemma 2 x 4096 D=512", 1, 8, 4, 512, 0, 4096, [4096, 4096], 0),
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


def device_ms(fn, calls: int = 10, tries: int = 5) -> float:
    """The device ms per kernel launch of ``fn`` from torch.profiler over
    ``calls`` back-to-back calls (the mean over the device events it kept:
    it has been seen to drop some of those of ctypes launches; a window
    with none is profiled again, twice as long)."""
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
            return sum(us for us, _ in kept) / 1e3 / sum(n for _, n in kept)
    raise RuntimeError("torch.profiler recorded no device event")


def worker(kernels, packs) -> dict:
    """One pass over the shapes of ``kernels`` with the package found on
    sys.path; ``packs`` as :func:`packed_cases` gives them. Returns
    {"times": {shape and kernel: ms, device_ms}, "ptxas": {source: its
    ptxas lines, where this pass built it}}."""
    import torch

    from sink_attention_tpu_torch.cache import SinkKVCache
    from sink_attention_tpu_torch.ops import _build, decode, flash, packed
    from sink_attention_tpu_torch.utils import time_cuda

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev).to(
        torch.bfloat16)
    out = {}

    def timed(label, fns):
        for kernel, fn in fns.items():
            if kernel not in kernels:
                continue
            fn()
            torch.cuda.synchronize()
            out[f"{label} {kernel}"] = {"ms": time_cuda(fn, iters=20),
                                        "device_ms": device_ms(fn)}

    for label, B, H_q, H_kv, N, D, ns, W in FORWARD:
        if "flash_fwd_kernel" not in kernels:
            break
        q, k, v = mk(B, H_q, N, D), mk(B, H_kv, N, D), mk(B, H_kv, N, D)
        aux = torch.randn(H_q, generator=gen, device=dev)
        timed(label, {"flash_fwd_kernel": lambda: flash.flash_fwd_kernel(
            q, k, v, aux, ns, W)})
    for label, B, H_q, H_kv, N, D, ns, W, halo in UNPACKED:
        if not {"flash_dq_kernel", "flash_dkdv_kernel"} & kernels:
            break
        q, do = mk(B, H_q, N, D), mk(B, H_q, N, D)
        k, v = mk(B, H_kv, N + halo, D), mk(B, H_kv, N + halo, D)
        geom = (ns, W, 0, -halo)
        o, lse = flash.flash_fwd_kernel(q, k, v, None, *geom)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, *geom)
        timed(label, {"flash_dq_kernel": lambda: flash.flash_dq_kernel(*args),
                      "flash_dkdv_kernel": lambda: flash.flash_dkdv_kernel(
                          *args)})
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
    for label, B, H_q, H_kv, D, ns, W, n, appends in DECODE:
        if "decode_kernel" not in kernels:
            break
        cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                                 dtype=torch.bfloat16, device=dev)
        cache.prefill(mk(B, H_kv, n, D), mk(B, H_kv, n, D))
        for _ in range(appends):
            cache.append(mk(B, H_kv, 1, D), mk(B, H_kv, 1, D))
        q = mk(B, H_q, 1, D)
        aux = torch.randn(H_q, generator=gen, device=dev)
        state, kw = decode.cache_state(cache), decode.cache_args(cache)
        timed(label, {"decode_kernel": lambda: decode.decode_kernel(
            q, cache.k, cache.v, state, aux, **kw)})
    return {"times": out, "ptxas": {
        name: rep["ptxas"] for name, rep in _build.build_report.items()
        if not rep["cached"]}}


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
    ap.add_argument("--out", default="build/kernel_compare.json")
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
    from sink_attention_tpu_torch.utils import card_line
    other = Path(args.other).resolve()
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
    for src, entry, got, mine in differ:
        print(f"ptxas differs: {src} {entry}: {got} -> {mine}")
    runs = [(name, r["times"]) for name, r in runs]
    print(f"{'shape, kernel':52s} {'other ms':>10s} {'this ms':>10s} "
          f"{'ratio':>7s} {'other dev':>10s} {'this dev':>10s}")
    table = {}
    for label in runs[0][1]:
        mean = {name: {key: sum(r[label][key] for n, r in runs if n == name)
                       / 2 for key in ("ms", "device_ms")}
                for name in ("other", "this")}
        table[label] = mean
        print(f"{label:52s} {mean['other']['ms']:10.4f} "
              f"{mean['this']['ms']:10.4f} "
              f"{mean['this']['ms'] / mean['other']['ms']:7.3f} "
              f"{mean['other']['device_ms']:10.4f} "
              f"{mean['this']['device_ms']:10.4f}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"card": card, "other": str(other), "passes": runs,
         "mean": table, "ptxas": builds, "ptxas_same": same,
         "ptxas_differ": [list(d) for d in differ]}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
