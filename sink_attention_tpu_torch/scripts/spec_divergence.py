"""Where the speculative engine's tokens leave the plain engine's, and why.

    python3 -m sink_attention_tpu_torch.scripts.spec_divergence \\
        [--exact-kv-scale]

A diagnostic of ``chip_smoke.py``'s phase 8, whose helpers it imports from
this checkout's ``chip_smoke.py``: gpt-oss-20b's widths and 24 layers,
weights from a generator seeded 0, the speculative pair of
``chip_smoke.draft_pair`` (layers 1.. scaled by 0.1, the draft layer 0),
the plain and the speculative ContinuousBatchingEngine over phase 8's 8
seeded requests in 4 slots with an int8 KV cache (the cache whose
quantizer ``ROADMAP.md`` §C holds open). For each request where the two
engines' greedy tokens first part, the sequence up to there is teacher
forced through ``forward_prefill`` (K and V read through the cache's
quantize round trip), and it reports:

- the two tokens' logits there, and which one the teacher prefers;
- the router margins at every layer of every generated position: the
  lowest chosen expert's logit less the best unchosen one's (0 is a tie;
  the router's logits are bf16), also in bf16 ulps of the chosen one;
- the expert choices each engine made at those positions (recorded in
  its run, :func:`record_engine`): how many differ from the teacher's,
  the teacher's margins there, and the last row teacher forced with that
  engine's choices imposed, all of them or only those that differ within
  ``NEAR_TIE_ULPS`` of a tie (the rest left to the teacher's router);
- for the ``TRIES`` smallest margins, the last row's logits with that
  one expert choice taken the other way: the first flip that makes the
  teacher prefer the other engine's token.

``--exact-kv-scale`` runs the caches with a quantize whose scale divides
by a tensor, the repair held open there (on the card
PyTorch divides a tensor by a Python number as a product with its
reciprocal). Prints one JSON line per divergence, then a summary line.
Without CUDA it exits nonzero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

ROOT = Path(__file__).resolve().parents[2]
# a choice this close to a tie (in bf16 ulps of the router logit) may go
# either way between two computations of equal math
NEAR_TIE_ULPS = 2.0
# single flips tried, smallest margin first
TRIES = 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def exact_quantize(x: torch.Tensor, quant: str):
    """``cache.quantize`` with its scale divided by a tensor (a true
    quotient on every device)."""
    from ..cache import sink_cache

    qmax = sink_cache.QUANT_MAX[quant]
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / amax.new_full((), qmax)
    inv = torch.where(scale > 0, 1.0 / scale.clamp(min=1e-30),
                      torch.zeros_like(scale))
    scaled = (xf * inv[..., None]).clamp(-qmax, qmax)
    if quant == "int8":
        return torch.round(scaled).to(torch.int8), scale
    codes = scaled.to(torch.float8_e4m3fn).view(torch.int8)
    codes = torch.where((codes & 0x7F) >= 8, codes, torch.zeros_like(codes))
    return codes, scale


class Router:
    """The model's ``moe_routing``, recording each layer's router logits
    and expert choice (one forward at a time: the caller resets
    ``logits`` and ``chosen``). ``flip`` = (layer, row) swaps that token's
    lowest chosen expert for the best unchosen one; ``forced`` =
    {(layer, row): bool [E]} imposes a choice. A changed row's weights
    are the softmax of its chosen logits, as the router's."""

    def __init__(self, orig):
        self.orig, self.logits, self.chosen = orig, [], []
        self.flip, self.forced = None, {}

    def __call__(self, p, cfg, xt):
        layer = len(self.logits)
        logits = (xt @ p["router_w"].to(xt.dtype)
                  + p["router_b"].to(xt.dtype)).float()
        routing = self.orig(p, cfg, xt)
        self.logits.append(logits)
        self.chosen.append(routing > 0)
        rows = {row: c.to(logits.device) for (la, row), c in
                self.forced.items() if la == layer}
        if self.flip is not None and self.flip[0] == layer:
            row = self.flip[1]
            chosen = routing[row] > 0
            lo = torch.where(chosen, logits[row], math.inf).argmin()
            hi = torch.where(chosen, -math.inf, logits[row]).argmax()
            chosen[lo], chosen[hi] = False, True
            rows[row] = chosen
        if not rows:
            return routing
        routing = routing.clone()
        for row, chosen in rows.items():
            routing[row] = 0.0
            routing[row, chosen] = torch.softmax(logits[row, chosen], dim=-1)
        return routing


def record_engine(eng, run):
    """``run()`` (an engine's run) with the target model's expert choices
    recorded: returns (its result, {(rid, layer, position): bool [E] on
    the CPU}). The engine's target forwards (decode steps, verify rounds)
    are wrapped so that each routed row's request and position are known;
    a position keeps its last write, the forward its K and V were
    committed from (a rejected draft's position is computed again in the
    next round; a finished slot's rows lie past its tokens)."""
    from ..models import model as tmodel
    from ..serving import engine as emod

    calls, ctx = [], {}
    orig = tmodel.moe_routing

    def route(p, cfg, xt):
        routing = orig(p, cfg, xt)
        if ctx:
            calls.append((ctx["rids"], ctx["seen"], ctx["T"], ctx["layer"],
                          routing > 0))
            ctx["layer"] += 1
        return routing

    def wrap(fn):
        def call(params, cfg, input_ids, caches, *a, **kw):
            if params is not eng.params:        # the draft's forwards
                return fn(params, cfg, input_ids, caches, *a, **kw)
            ctx.update(rids=[r.rid if r is not None else None
                             for r in eng._slots],
                       seen=caches[0].seen.tolist(), T=input_ids.shape[1],
                       layer=0)
            try:
                return fn(params, cfg, input_ids, caches, *a, **kw)
            finally:
                ctx.clear()
        return call

    saved = (emod.forward_decode_ragged, emod.forward_verify_ragged)
    emod.forward_decode_ragged, emod.forward_verify_ragged = map(wrap, saved)
    tmodel.moe_routing = route
    try:
        out = run()
    finally:
        emod.forward_decode_ragged, emod.forward_verify_ragged = saved
        tmodel.moe_routing = orig
    routes = {}
    for rids, seen, T, layer, chosen in calls:
        chosen = chosen.cpu()
        for b, rid in enumerate(rids):
            if rid is not None:
                for t in range(T):
                    routes[(rid, layer, seen[b] + t)] = chosen[b * T + t]
    return out, routes


def _margins(logits, k, start):
    """(margin, ulps, layer, row) at every layer for the rows from
    ``start``: the k-th largest router logit less the (k+1)-th."""
    out = []
    for layer, lg in enumerate(logits):
        top = torch.topk(lg[start:], k + 1, dim=-1).values
        m = (top[:, k - 1] - top[:, k]).tolist()
        ulp = torch.exp2(torch.floor(torch.log2(top[:, k - 1].abs()
                                                .clamp(min=1e-30))) - 7)
        for r, (mr, u) in enumerate(zip(m, ulp.tolist())):
            out.append((mr, mr / u, layer, start + r))
    return sorted(out)


def diagnose(params, cfg, prompt, plain, spec, at, quant, tries,
             routes=None):
    """The report of one divergence at token ``at`` (see the module
    docstring). ``routes`` = {"plain": ..., "spec": ...}, each engine's
    {(layer, position): bool [E]} for this request (:func:`record_engine`),
    adds where each engine's choices at the generated positions differ
    from the teacher's (and the teacher's margin there) and the last row
    teacher forced with each engine's choices imposed at those
    positions."""
    from ..cache import sink_cache
    from ..models import forward_prefill
    from ..models import model as tmodel
    from ..ops import sink_flash_attention

    def attn(q, k, v, **kw):
        if quant:
            k, v = (sink_cache.dequantize(*sink_cache.quantize(x, quant),
                                          quant).to(x.dtype) for x in (k, v))
        return sink_flash_attention(q, k, v, **kw)

    seq = torch.tensor([list(prompt) + list(plain[:at])],
                       device=params["embed"].device)
    router = Router(tmodel.moe_routing)
    a, b = plain[at], spec[at]

    def last_row():
        router.logits, router.chosen = [], []
        with torch.inference_mode():
            return forward_prefill(params, cfg, seq, attn_impl=attn)[0][
                0, -1].float()

    def below(row):
        return {"plain_below_best": float(row.max() - row[a]),
                "spec_below_best": float(row.max() - row[b])}

    tmodel.moe_routing = router
    try:
        row = last_row()
        best = int(row.argmax())
        target = b if best == a else a
        margins = _margins(router.logits, cfg.experts_per_tok, len(prompt))
        rep = {"at": at, "plain": a, "spec": b, "teacher_best": best,
               **below(row), "target": "spec" if target == b else "plain",
               "smallest_margins": [
                   {"margin": m, "ulps": u, "layer": la, "pos": r}
                   for m, u, la, r in margins[:5]],
               "ties": sum(m == 0.0 for m, *_ in margins),
               "positions_x_layers": len(margins)}
        if routes is not None:
            ulps = {(la, r): u for _, u, la, r in margins}
            teacher = [c.cpu() for c in router.chosen]
            for name, got in routes.items():
                keys = [k for k in ulps if k in got]
                diff = [(la, r) for la, r in keys
                        if not torch.equal(got[la, r], teacher[la][r])]
                router.forced = {k: got[k] for k in keys}
                replayed = below(last_row())
                router.forced = {k: got[k] for k in diff
                                 if ulps[k] <= NEAR_TIE_ULPS}
                rep[f"{name}_routes"] = {
                    "recorded": len(keys), "differ": len(diff),
                    "teacher_ulps_where_differ": sorted(
                        ulps[k] for k in diff),
                    "replayed": replayed,
                    "replayed_near_ties": below(last_row())}
            router.forced = {}
        rep.update(flip=None, tried=0)
        for m, u, layer, pos in margins[:tries]:
            router.flip = (layer, pos)
            flipped = last_row()
            rep["tried"] += 1
            if int(flipped.argmax()) == target:
                rep["flip"] = {"layer": layer, "pos": pos, "margin": m,
                               "ulps": u, "target_above_other": float(
                                   flipped[target] - flipped[
                                       a if target == b else b])}
                break
        router.flip = None
        return rep
    finally:
        tmodel.moe_routing = router.orig


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--exact-kv-scale", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spec_divergence: CUDA is not available", file=sys.stderr)
        return 1

    from ..cache import sink_cache
    from ..models import ModelConfig, init_params
    from ..serving import ContinuousBatchingEngine
    from ..utils import card_line

    cs = _chip_smoke()
    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.exact_kv_scale:
        sink_cache.quantize = exact_quantize
    quant = "int8"
    dev = torch.device("cuda")
    cfg = ModelConfig.gpt_oss_20b()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    dparams, dcfg = cs.draft_pair(params, cfg, 0.1)
    reqs = cs.engine_requests(8, cfg.vocab_size, 0)
    runs, routes = {}, {}
    for name, extra in (("plain", {}), ("spec", dict(
            draft_params=dparams, draft_cfg=dcfg, num_draft_tokens=4))):
        eng = ContinuousBatchingEngine(
            params, cfg, max_batch=4, max_len=2048, prefill_bucket=128,
            quant=quant, dtype=torch.bfloat16, device=dev, **extra)
        rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
        out, routes[name] = record_engine(eng, eng.run)
        runs[name] = [(r, out[r]) for r in rids]
        del eng
    found = 0
    for i, ((prompt, _), (ra, a), (rb, b)) in enumerate(zip(
            reqs, runs["plain"], runs["spec"])):
        at = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if at is None:
            continue
        mine = {name: {k[1:]: c for k, c in routes[name].items()
                       if k[0] == rid}
                for name, rid in (("plain", ra), ("spec", rb))}
        rep = diagnose(params, cfg, prompt, a, b, at, quant, TRIES, mine)
        found += rep["flip"] is not None
        print(json.dumps({"request": i, **rep}), flush=True)
    parted = sum(a != b for (_, a), (_, b) in zip(runs["plain"],
                                                  runs["spec"]))
    print(json.dumps({"quant": quant,
                      "exact_kv_scale": args.exact_kv_scale,
                      "requests": len(reqs), "parted": parted,
                      "explained_by_one_flip": found}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
