"""Where two greedy decodings part, whether a router near-tie explains it.

Two runs of equal math on the card (the speculative engine and the plain
one, the decode kernel and its plain version) can part at a token: a
rounding difference tips a near-tied choice upstream, most often an MoE
router's top-k, and the runs then follow different but equally valid
greedy paths. This module holds what tells such a cascade from a fault:

- :func:`record_engine` and :func:`record_generate` run a continuous
  batching engine, or ``greedy_generate`` / ``speculative_generate``, with
  the target model's expert choice recorded at every generated position
  and layer (``moe_routing`` wrapped);
- :class:`Router`, a ``moe_routing`` that records each layer's router
  logits and choices in a teacher-forced forward, and can impose given
  choices;
- :func:`near_tie_replay`: the teacher-forced rows of a run's generated
  tokens, and the same rows with the run's own recorded choices imposed
  where they differ from the teacher's within :data:`NEAR_TIE_ULPS` of a
  router tie.

A token is explained when it is the teacher's choice within a margin,
either as it is or with the run's near-tie choices imposed; a token that
leaves the teacher where no near-tie choice of its run explains it is
not.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

__all__ = ["NEAR_TIE_ULPS", "Router", "record_engine", "record_generate",
           "router_margins", "near_tie_replay"]

# a choice this close to a tie (in bf16 ulps of the router logit) may go
# either way between two computations of equal math
NEAR_TIE_ULPS = 2.0


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


def _recorded(run, wraps, ctx):
    """``run()`` with ``wraps`` = [(module, name, wrapper factory)]
    installed and the model's ``moe_routing`` recording, while ``ctx`` is
    set, (keys, layer, chosen) per call; returns (result, calls)."""
    from ..models import model as tmodel

    calls, orig = [], tmodel.moe_routing

    def route(p, cfg, xt):
        routing = orig(p, cfg, xt)
        if ctx:
            calls.append((ctx["keys"], ctx["layer"], routing > 0))
            ctx["layer"] += 1
        return routing

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wraps]
    for mod, name, make in wraps:
        setattr(mod, name, make(getattr(mod, name)))
    tmodel.moe_routing = route
    try:
        out = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        tmodel.moe_routing = orig
    return out, calls


def _routes(calls) -> Dict[Tuple[int, int, int], torch.Tensor]:
    """{(key, layer, position): bool [E] on the CPU}; a position keeps its
    last write (the forward its K and V were committed from: a rejected
    draft's position is computed again in the next round)."""
    routes = {}
    for keys, layer, chosen in calls:
        chosen = chosen.cpu()
        for row, key in enumerate(keys):
            if key is not None:
                routes[(key[0], layer, key[1])] = chosen[row]
    return routes


def record_engine(eng, run):
    """``run()`` (a ContinuousBatchingEngine's run) with the target
    model's expert choices recorded: (its result, {(rid, layer, position):
    bool [E]}). The engine's target forwards (decode steps, verify rounds)
    are wrapped so that each routed row's request and position are known;
    a finished slot's rows lie past its tokens."""
    from . import engine as emod

    ctx = {}

    def wrap(fn):
        def call(params, cfg, input_ids, caches, *a, **kw):
            if params is not eng.params:        # the draft's forwards
                return fn(params, cfg, input_ids, caches, *a, **kw)
            T = input_ids.shape[1]
            seen = caches[0].seen.tolist()
            ctx.update(keys=[(r.rid, seen[b] + t) if r is not None else None
                             for b, r in enumerate(eng._slots)
                             for t in range(T)], layer=0)
            try:
                return fn(params, cfg, input_ids, caches, *a, **kw)
            finally:
                ctx.clear()
        return call

    out, calls = _recorded(run, [(emod, "forward_decode_ragged", wrap),
                                 (emod, "forward_verify_ragged", wrap)], ctx)
    return out, _routes(calls)


def record_generate(params, run):
    """``run()`` (``greedy_generate`` or ``speculative_generate`` over the
    target ``params``) with the target's expert choices at the generated
    positions recorded: (its result, {(batch row, layer, position): bool
    [E]}). The decode steps and verify passes are wrapped; the prefill
    (the prompt's positions) and the draft's forwards are not."""
    from . import generate as gmod

    ctx = {}

    def wrap(fn):
        def call(p, cfg, input_ids, caches, position, *a, **kw):
            if p is not params:
                return fn(p, cfg, input_ids, caches, position, *a, **kw)
            B, T = input_ids.shape
            ctx.update(keys=[(b, int(position) + t) for b in range(B)
                             for t in range(T)], layer=0)
            try:
                return fn(p, cfg, input_ids, caches, position, *a, **kw)
            finally:
                ctx.clear()
        return call

    out, calls = _recorded(run, [(gmod, "forward_decode", wrap),
                                 (gmod, "forward_verify", wrap)], ctx)
    return out, _routes(calls)


def router_margins(logits, k: int, start: int):
    """(margin, ulps, layer, row) at every layer for the rows from
    ``start``, smallest first: the k-th largest router logit less the
    (k+1)-th (0 is a tie), also in bf16 ulps of the k-th."""
    out = []
    for layer, lg in enumerate(logits):
        top = torch.topk(lg[start:], k + 1, dim=-1).values
        m = (top[:, k - 1] - top[:, k]).tolist()
        ulp = torch.exp2(torch.floor(torch.log2(top[:, k - 1].abs()
                                                .clamp(min=1e-30))) - 7)
        for r, (mr, u) in enumerate(zip(m, ulp.tolist())):
            out.append((mr, mr / u, layer, start + r))
    return sorted(out)


def near_tie_replay(params, cfg, prompt, tokens, routes, attn_impl=None):
    """Teacher-force ``prompt + tokens`` (B = 1) through
    ``forward_prefill`` and return (the logits fp32 of the rows from the
    prompt's last on: row t predicts the token after ``tokens[:t]``, the
    same rows with the run's near-tie choices imposed, a summary).

    ``routes`` = {(layer, position): bool [E]}: the run's own expert
    choices. At the generated positions (from ``len(prompt)``), those
    that differ from the teacher's own choice within
    :data:`NEAR_TIE_ULPS` of a router tie are imposed; the rest are left
    to the teacher's router. ``attn_impl`` is the prefill attention (the
    cache's view of K and V)."""
    from ..models import forward_prefill
    from ..models import model as tmodel

    seq = torch.tensor([list(prompt) + list(tokens)],
                       device=params["embed"].device)
    router = Router(tmodel.moe_routing)

    def rows():
        router.logits, router.chosen = [], []
        with torch.inference_mode():
            return forward_prefill(params, cfg, seq, attn_impl=attn_impl)[0][
                0, len(prompt) - 1:].float()

    tmodel.moe_routing = router
    try:
        teacher_rows = rows()
        ulps = {(la, r): u for _, u, la, r in router_margins(
            router.logits, cfg.experts_per_tok, len(prompt))}
        teacher = [c.cpu() for c in router.chosen]
        keys = [k for k in ulps if k in routes]
        differ = [(la, r) for la, r in keys
                  if not torch.equal(routes[la, r], teacher[la][r])]
        router.forced = {k: routes[k] for k in differ
                         if ulps[k] <= NEAR_TIE_ULPS}
        replayed = rows() if router.forced else teacher_rows
        summary = {"recorded": len(keys), "differ": len(differ),
                   "imposed": len(router.forced)}
        return teacher_rows, replayed, summary
    finally:
        tmodel.moe_routing = router.orig
