"""Where the speculative engine's tokens leave the plain engine's, and why.

    python3 -m sink_attention_tpu_torch.scripts.spec_divergence \\
        [--kv-scale-factor F]

A diagnostic of ``chip_smoke.py``'s phase 8, with its helpers and gates
(``serving.divergence``): gpt-oss-20b's widths and 24 layers, weights from
a generator seeded 0, the speculative pair of ``draft_pair`` (layers 1..
scaled by 0.1, the draft layer 0), the plain and the speculative
ContinuousBatchingEngine over phase 8's 8 seeded requests
(``engine_requests``) in 4 slots with an int8 KV cache, each run's expert
choices and logits recorded (``record_engine``). For every request it
prints phase 8's logit gate (``logit_gate``: the two engines' logits at
the same tokens against a bf16-noise control); for each request where the
two engines' greedy tokens first part, phase 8's token verdict
(``first_divergence`` and ``divergence_gate``: each engine's token against
the teacher, as it is and with its near-tie expert choices imposed), and
the sequence up to there teacher forced through ``forward_prefill`` (K and
V read through the cache's quantize round trip) with:

- the two tokens' logits there, and which one the teacher prefers;
- the router margins at every layer of every generated position: the
  lowest chosen expert's logit less the best unchosen one's (0 is a tie;
  the router's logits are bf16), also in bf16 ulps of the chosen one;
- where each engine's choices at those positions differ from the
  teacher's, and the last row teacher forced with that engine's choices
  imposed, all of them or only those within 2 bf16 ulps of a tie
  (``serving.divergence.NEAR_TIE_ULPS``);
- for the ``TRIES`` smallest margins, the last row's logits with that
  one expert choice taken the other way: the first flip that makes the
  teacher prefer the other engine's token.

``--kv-scale-factor F`` breaks the speculative engine on purpose: its
cache stores every K/V scale F times the true one (the codes as computed),
so it reads K and V F times too large; phase 8's gates must refuse it
(their negative control: the token gate refuses F = 1.1 and not 1.01, the
logit gate 1.01 too). Prints one JSON line per request that the logit
gate refuses or whose tokens part, then a summary line. Without CUDA it
exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from ..serving.divergence import (Router, divergence_gate, draft_pair,
                                  engine_requests, first_divergence,
                                  logit_gate, near_tie_replay, record_engine,
                                  request_routes, router_margins)

# single flips tried, smallest margin first
TRIES = 16


def scaled_quantize(factor: float):
    """``cache.quantize`` with its scale multiplied by ``factor`` and the
    codes as computed: a cache written through it dequantizes ``factor``
    times too large."""
    from ..cache import sink_cache
    quantize = sink_cache.quantize

    def broken(x: torch.Tensor, quant: str):
        codes, scale = quantize(x, quant)
        return codes, scale * factor
    return broken


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
        margins = router_margins(router.logits, cfg.experts_per_tok,
                                 len(prompt))
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
                router.forced = {}
                tmodel.moe_routing = router.orig
                _, near, _ = near_tie_replay(params, cfg, prompt, plain[:at],
                                             got, attn)
                near = near[-1]
                tmodel.moe_routing = router
                rep[f"{name}_routes"] = {
                    "recorded": len(keys), "differ": len(diff),
                    "teacher_ulps_where_differ": sorted(
                        ulps[k] for k in diff),
                    "replayed": replayed,
                    "replayed_near_ties": below(near)}
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
    ap.add_argument("--kv-scale-factor", type=float, default=1.0,
                    help="the speculative engine's K/V scales times this "
                         "(a broken engine: the gate's negative control)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spec_divergence: CUDA is not available", file=sys.stderr)
        return 1

    from ..cache import sink_cache
    from ..models import ModelConfig, init_params
    from ..serving import ContinuousBatchingEngine
    from ..utils import card_line

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    quant = "int8"
    dev = torch.device("cuda")
    cfg = ModelConfig.gpt_oss_20b()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    dparams, dcfg = draft_pair(params, cfg, 0.1)
    reqs = engine_requests(8, cfg.vocab_size, 0)
    runs, routes, rows = {}, {}, {}
    shipped = sink_cache.quantize
    for name, extra in (("plain", {}), ("spec", dict(
            draft_params=dparams, draft_cfg=dcfg, num_draft_tokens=4))):
        if name == "spec" and args.kv_scale_factor != 1.0:
            sink_cache.quantize = scaled_quantize(args.kv_scale_factor)
        try:
            eng = ContinuousBatchingEngine(
                params, cfg, max_batch=4, max_len=2048, prefill_bucket=128,
                quant=quant, dtype=torch.bfloat16, device=dev, **extra)
            rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
            logits = {}
            out, routes[name] = record_engine(eng, eng.run, logits=logits)
        finally:
            sink_cache.quantize = shipped
        runs[name] = [(r, out[r]) for r in rids]
        rows[name] = [{p: row for (rid, p), row in logits.items()
                       if rid == r} for r in rids]
        del eng, logits
    found, refused, logit_refused = 0, [], 0
    for i, ((prompt, _), (ra, a), (rb, b)) in enumerate(zip(
            reqs, runs["plain"], runs["spec"])):
        lg = logit_gate(params, cfg, prompt, a, b, rows["plain"][i],
                        rows["spec"][i], 6000 + i, quant)
        logit_refused += not lg["ok"]
        at = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if at is None:
            if not lg["ok"]:
                print(json.dumps({"request": i, "logit_gate": lg}),
                      flush=True)
            continue
        mine = {name: request_routes(routes[name], rid)
                for name, rid in (("plain", ra), ("spec", rb))}
        div = first_divergence(params, cfg, prompt, a, b, 5000, quant,
                               routes=mine)
        errors = []
        divergence_gate(div, f"request {i}", errors)
        refused += errors
        rep = diagnose(params, cfg, prompt, a, b, at, quant, TRIES, mine)
        found += rep["flip"] is not None
        print(json.dumps({"request": i, "logit_gate": lg, "gate": div,
                          "gate_errors": errors, **rep}), flush=True)
    parted = sum(a != b for (_, a), (_, b) in zip(runs["plain"],
                                                  runs["spec"]))
    print(json.dumps({"quant": quant,
                      "kv_scale_factor": args.kv_scale_factor,
                      "requests": len(reqs), "parted": parted,
                      "gate_refused": len(refused),
                      "logit_gate_refused": logit_refused,
                      "explained_by_one_flip": found}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
