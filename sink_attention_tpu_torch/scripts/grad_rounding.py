"""How far the fp32 attention kernels lie from their plain version, and
whether one bf16 rounding step of P or dS explains the worst element.

    python3 sink_attention_tpu_torch/scripts/grad_rounding.py
        [--tree DIR] [--dims 64,128,256,512] [--seed 12]

Runs the forward, dQ and dK/dV kernels, unpacked (``flash_fwd_kernel``,
``flash_dq_kernel``, ``flash_dkdv_kernel``) and packed, on the inputs of
``tests/test_torch_gpu.py``'s packed case: B=1, 8 query and 2 KV heads,
N=256 as a pack of 100 + 30 + 126 tokens, 4 sinks, W=64, scale-1 normal
fp32 from a CUDA generator seeded ``--seed``. For each D in ``--dims`` and
each gradient it prints the largest |kernel - plain| (plain: the plain
version at the kernels' precision, ``matmul_dtype=torch.bfloat16``), the
elements past JAX's fp32 tolerance (2e-3 + 1e-2 |plain|), and the largest
|kernel - exact| (the plain version in fp32). For dV and dK it also fits
the worst element's error row (all D columns of that key) to one term of
its sum: c dO_i (dV) or scale c Q_i (dK) over the rows i of the key's
GQA group, and prints the residual of the best fit, c in units of the
bf16 step of P_ij (dV) or dS_ij (dK) there, and that value's distance
from its nearest bf16 rounding midpoint in steps. One rounding of P or dS
made apart by the kernel and the plain version shows as a residual near
0, c = +-1 step and a distance near 0. The forward's O is held the same
way: its elements past JAX's fp32 forward tolerance (6e-3 + 1e-3
|plain|), and its worst element's row fitted to one term c V_j over the
keys j of the row's KV head, c in bf16 steps of the unnormalised P_ij
(the value the plain version rounds) over the row's divisor. The fp32
forward rounds P to bf16 once (relative to its running maximum, the plain
version relative to the row's), so it differs from the plain version by
up to one such step per key even away from a midpoint.

``--tree`` imports the package from another checkout's root (default:
this one), so that two checkouts are measured by the same script. Run it
as a file, not with ``-m``. Without CUDA it exits nonzero.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def _segments(total, lengths):
    return [p for n in lengths for p in range(n)][:total]


def _step(x: float) -> float:
    """The bf16 step (one unit in the last place) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def explain(err, rows, values, scale):
    """Fit the worst element's error row of ``err`` [B,H_kv,N,D] to
    scale * c * rows[h, i] over the rows of the key's group; ``values``
    [H_q, N_q, N_kv] holds the rounded quantity (P or dS). Returns
    (residual, c / step, distance of the value from a rounding midpoint
    in steps)."""
    i = int(err.abs().argmax())
    _, hk, j, _ = [int(x) for x in
                   torch.unravel_index(torch.tensor(i), err.shape)]
    e = err[0, hk, j].double()
    group = rows.shape[0] // err.shape[1]
    best = None
    for h in range(hk * group, (hk + 1) * group):
        r_all = rows[h].double() * scale
        c = (r_all @ e) / (r_all * r_all).sum(-1).clamp_min(1e-30)
        res = (e[None] - c[:, None] * r_all).norm(dim=-1) / e.norm()
        r = int(res.argmin())
        if best is None or float(res[r]) < best[0]:
            best = (float(res[r]), h, r, float(c[r]))
    res, h, r, c = best
    x = float(values[h, r, j])
    step = _step(x)
    if step == 0.0:
        return res, float("inf"), float("nan")
    frac = abs(x) / step - math.floor(abs(x) / step)
    return res, c / step, abs(frac - 0.5)


def explain_forward(err, vals, p, denom):
    """Fit the worst element's error row of ``err`` [B,H_q,N,D] (O) to
    c * vals[h, j] over the keys j of its head (``vals`` [H_q, N_kv, D]:
    V as the head reads it); ``p`` [H_q, N_q, N_kv] is the unnormalised
    probability the plain version rounds and ``denom`` [H_q, N_q] its
    divisor. Returns (residual, c in bf16 steps of p / denom, distance of
    p from a rounding midpoint in steps)."""
    i = int(err.abs().argmax())
    _, h, r, _ = [int(x) for x in
                  torch.unravel_index(torch.tensor(i), err.shape)]
    e = err[0, h, r].double()
    rows = vals[h].double()
    c = (rows @ e) / (rows * rows).sum(-1).clamp_min(1e-30)
    res = (e[None] - c[:, None] * rows).norm(dim=-1) / e.norm()
    j = int(res.argmin())
    x = float(p[h, r, j])
    step = _step(x)
    if step == 0.0:
        return float(res[j]), float("inf"), float("nan")
    frac = abs(x) / step - math.floor(abs(x) / step)
    return float(res[j]), float(c[j]) * float(denom[h, r]) / step, abs(
        frac - 0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--dims", default="64,128,256,512")
    ap.add_argument("--seed", type=int, default=12)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    if not torch.cuda.is_available():
        print("grad_rounding: CUDA is not available", file=sys.stderr)
        return 1
    from sink_attention_tpu_torch.ops import flash, packed
    from sink_attention_tpu_torch.utils import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mm = torch.bfloat16
    print(f"grad_rounding: package from {flash.__file__}; card {card_line()}")
    for d in (int(x) for x in args.dims.split(",")):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        B, H_q, H_kv, N = 1, 8, 2, 256
        positions = torch.tensor([_segments(N, (100, 30, 126))], device=dev)
        q, k, v, do = (torch.randn(*s, generator=gen, device=dev)
                       for s in ((B, H_q, N, d), (B, H_kv, N, d),
                                 (B, H_kv, N, d), (B, H_q, N, d)))
        aux = torch.randn(H_q, generator=gen, device=dev)
        scale = d ** -0.5
        routes = {
            "unpacked": (
                lambda m: flash.flash_fwd_plain(q, k, v, aux, 4, 64,
                                                matmul_dtype=m),
                lambda: flash.flash_fwd_kernel(q, k, v, aux, 4, 64)[0],
                lambda lse, dl, m: flash.flash_bwd_plain(
                    q, k, v, do, lse, dl, 4, 64, matmul_dtype=m),
                lambda lse, dl: (
                    flash.flash_dq_kernel(q, k, v, do, lse, dl, 4, 64),
                    *flash.flash_dkdv_kernel(q, k, v, do, lse, dl, 4, 64)),
                lambda: flash._visible(N, N, 4, 64, 0, 0, dev)),
            "packed": (
                lambda m: packed.packed_fwd_plain(q, k, v, positions, aux,
                                                  4, 64, matmul_dtype=m),
                lambda: packed.packed_fwd_kernel(q, k, v, positions, aux, 4,
                                                 64)[0],
                lambda lse, dl, m: packed.packed_bwd_plain(
                    q, k, v, do, lse, dl, positions, 4, 64, matmul_dtype=m),
                lambda lse, dl: (
                    packed.packed_dq_kernel(q, k, v, do, lse, dl, positions,
                                            4, 64),
                    *packed.packed_dkdv_kernel(q, k, v, do, lse, dl,
                                               positions, 4, 64)),
                lambda: packed.packed_rows_mask(positions, 0, N, 4, 64)[0]),
        }
        for route, (fwd, fwd_kern, bwd, kern, vis) in routes.items():
            o, lse = fwd(mm)
            o_k = fwd_kern()
            o_x = fwd(None)[0]
            delta = (do * o).sum(-1)
            plain = bwd(lse, delta, mm)
            exact = bwd(lse, delta, None)
            got = kern(lse, delta)
            torch.cuda.synchronize()
            # P and dS as the plain version computes them, for the fits
            qb, kb, vb, dob = (t.to(mm).float() for t in (q, k, v, do))
            g = H_q // H_kv
            kf, vf = kb.repeat_interleave(g, 1), vb.repeat_interleave(g, 1)
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kf) * scale
            p = torch.where(vis(), torch.exp(s - lse[..., None]), 0.0)
            # the forward: the unnormalised P the plain version rounds
            # (exp(s - m), m the row's largest logit with s_aux) and its
            # divisor
            sm = torch.where(vis(), s, -math.inf)
            m = torch.maximum(sm.amax(-1), aux[None, :, None])
            pu = torch.where(vis(), torch.exp(s - m[..., None]), 0.0)
            den = pu.sum(-1) + torch.exp(aux[None, :, None] - m)
            err = o_k - o
            bad = int((err.abs() > 6e-3 + 1e-3 * o.abs()).sum())
            res, c, mid = explain_forward(err, vf[0], pu[0], den[0])
            print(f"{route} D={d} o: max |kernel - plain| "
                  f"{float(err.abs().max()):.3e}, past JAX's fp32 forward "
                  f"tolerance {bad} of {err.numel()}, max |kernel - exact| "
                  f"{float((o_k - o_x).abs().max()):.3e}; worst row as one "
                  f"term: residual {res:.3f}, c {c:+.4f} steps, midpoint "
                  f"distance {mid:.4f} steps", flush=True)
            ds = p * (torch.einsum("bhqd,bhkd->bhqk", dob, vf)
                      - delta[..., None])
            for name, gk, gp, gx in zip(("dq", "dk", "dv"), got, plain,
                                        exact):
                err = gk - gp
                bad = int((err.abs() > 2e-3 + 1e-2 * gp.abs()).sum())
                line = (f"{route} D={d} {name}: max |kernel - plain| "
                        f"{float(err.abs().max()):.3e}, past JAX's fp32 "
                        f"tolerance {bad} of {err.numel()}, max |kernel - "
                        f"exact| {float((gk - gx).abs().max()):.3e}")
                if name != "dq":
                    rows, vals, sc = ((dob[0], p[0], 1.0) if name == "dv"
                                      else (qb[0], ds[0], scale))
                    res, c, mid = explain(err, rows, vals, sc)
                    line += (f"; worst row as one term: residual {res:.3f},"
                             f" c {c:+.4f} steps, midpoint distance "
                             f"{mid:.4f} steps")
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
