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
  router tie;
- the token gate (:func:`first_divergence`, :func:`divergence_gate`)
  built on them, and the logit gate (:func:`logit_gate`) beside it: a
  fault that moves every logit a little (a K/V scale 1% off) leaves the
  greedy tokens where they were, so the token gate cannot see it, while
  the two engines' logits at the same tokens then differ by more than a
  bf16 rounding's worth;
- the speculative pair and the requests of ``chip_smoke.py``'s phases 6
  and 8 (:func:`draft_pair`, :func:`engine_requests`).

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
           "router_margins", "near_tie_replay", "noisy", "kv_roundtrip",
           "check_run", "first_divergence", "divergence_gate",
           "request_routes", "logit_gate", "draft_pair", "engine_requests"]

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


def record_engine(eng, run, logits=None):
    """``run()`` (a ContinuousBatchingEngine's run) with the target
    model's expert choices recorded: (its result, {(rid, layer, position):
    bool [E]}). The engine's target forwards (decode steps, verify rounds)
    are wrapped so that each routed row's request and position are known;
    a finished slot's rows lie past its tokens. With ``logits`` (a dict)
    the target's logits row of every (rid, position) is kept there too,
    the last written (a rejected draft's position is computed again), as
    (input token, row) on the device."""
    from . import engine as emod

    ctx = {}

    def wrap(fn):
        def call(params, cfg, input_ids, caches, *a, **kw):
            if params is not eng.params:        # the draft's forwards
                return fn(params, cfg, input_ids, caches, *a, **kw)
            T = input_ids.shape[1]
            seen = caches[0].seen.tolist()
            keys = [(r.rid, seen[b] + t) if r is not None else None
                    for b, r in enumerate(eng._slots) for t in range(T)]
            ctx.update(keys=keys, layer=0)
            try:
                out = fn(params, cfg, input_ids, caches, *a, **kw)
            finally:
                ctx.clear()
            if logits is not None:
                rows = out[0].reshape(len(keys), -1)
                ids = input_ids.reshape(-1)
                for i, key in enumerate(keys):
                    if key is not None:
                        logits[key] = (ids[i], rows[i].clone())
            return out
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


# ---------------------------------------------------------------------------
# The gates of chip_smoke.py's phase 8 (and 12a), and their inputs
# ---------------------------------------------------------------------------


def engine_requests(n: int, vocab: int, seed: int = 0, prompt=(64, 1024),
                    new=(16, 32)):
    """``n`` requests drawn from numpy.random.default_rng(seed): prompt
    lengths uniform in ``prompt``, max_new_tokens in ``new`` (both
    inclusive), token ids uniform in [0, vocab). [(prompt ids, max new)]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt[0], prompt[1] + 1, n)
    news = rng.integers(new[0], new[1] + 1, n)
    return [(rng.integers(0, vocab, int(L)).tolist(), int(m))
            for L, m in zip(lens, news)]


def draft_pair(params, cfg, scale):
    """A speculative pair from one model: the target's layers 1.. scaled
    by ``scale`` in place (the pair of scripts/bench_suite.py's
    spec_table: one copy of the weights), the draft its layer 0 with its
    embed, final norm and lm_head (the same tensors). Returns (draft
    params, draft cfg)."""
    import dataclasses

    with torch.no_grad():
        for lp in params["layers"][1:]:
            for part in lp.values():
                for t in (part.values() if isinstance(part, dict)
                          else [part]):
                    t.mul_(scale)
    dcfg = dataclasses.replace(cfg, num_layers=1,
                               layer_types=cfg.layer_types[:1])
    dparams = {"embed": params["embed"], "final_norm": params["final_norm"],
               "lm_head": params["lm_head"], "layers": params["layers"][:1]}
    return dparams, dcfg


def noisy(attn_impl, seed: int):
    """attn_impl with its output scaled by (1 + e), e ~ N(0, 2^-9): a
    perturbation the size of one bf16 rounding, the control that says how
    far such noise alone moves this model's logits."""
    state = {"n": 0}

    def attn(*a, **kw):
        o = attn_impl(*a, **kw)
        g = torch.Generator(device=o.device).manual_seed(seed + state["n"])
        state["n"] += 1
        e = torch.randn(o.shape, generator=g, device=o.device) * 2.0 ** -9
        return (o.float() * (1.0 + e)).to(o.dtype)

    return attn


def kv_roundtrip(attn_impl, quant):
    """attn_impl reading K and V through quantize -> dequantize: the
    control that says how far the cache's rounding alone moves the
    logits."""
    from ..cache import dequantize, quantize

    def rt(x):
        return dequantize(*quantize(x, quant), quant).to(x.dtype)

    def attn(q, k, v, **kw):
        return attn_impl(q, rt(k), rt(v), **kw)
    return attn


def check_run(params, cfg, prompt, toks, seed, quant, routes):
    """Every token of one greedy run (``toks`` after ``prompt``) against
    the teacher: the run's own sequence teacher forced through
    forward_prefill, K and V read as its cache holds them (through the
    quantize -> dequantize round trip, :func:`kv_roundtrip`, for a
    quantized cache). Per token: how far it lies below the teacher's best,
    the control (how far the row's logits move at most under bf16-sized
    noise in the attention output, :func:`noisy`, and for a quantized
    cache under the round trip) and, where the token lies more than twice
    the control below, how far with the run's own expert choices imposed
    where they differ from the teacher's within 2 bf16 ulps of a router
    tie (``routes`` = {(layer, position): bool [E]} recorded in the run;
    :func:`near_tie_replay`). Returns per-token lists."""
    from ..models import forward_prefill
    from ..ops import flash

    seq = torch.tensor([list(prompt) + list(toks[:-1])],
                       device=params["embed"].device)
    impls = {"noise": noisy(flash.sink_flash_attention, seed)}
    if quant:
        impls["roundtrip"] = kv_roundtrip(flash.sink_flash_attention, quant)
    teacher = impls.get("roundtrip")      # the cache's view of K and V
    start = len(prompt) - 1
    with torch.inference_mode():
        base = forward_prefill(params, cfg, seq)[0][0, start:].float()
        rows = {name: forward_prefill(params, cfg, seq, attn_impl=impl)[0][
            0, start:].float() for name, impl in impls.items()}
    moved = {name: (r - base).abs().amax(-1) for name, r in rows.items()}
    control = torch.stack(list(moved.values())).amax(0)
    idx = torch.tensor(toks, device=base.device)[:, None]

    def below(r):
        return r.amax(-1) - r.gather(1, idx)[:, 0]

    out = {"below": below(rows["roundtrip"] if quant else base),
           "control": control,
           **{name: m for name, m in moved.items()}}
    out["replayed"] = out["below"]
    if routes is not None and bool((out["below"] > 2 * control).any()):
        _, replayed, out["summary"] = near_tie_replay(
            params, cfg, prompt, toks[:-1], routes, teacher)
        out["replayed"] = below(replayed)
    return {k: (v.tolist() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def first_divergence(params, cfg, prompt, plain, got, seed, quant=None,
                     routes=None):
    """Where ``got`` first leaves ``plain`` (two greedy runs' tokens after
    ``prompt``) and whether each run's tokens are explained. {"at": None}
    when the two agree.

    Each run's whole sequence is checked (:func:`check_run`, with
    ``routes[name]``, name "plain" or "spec"): the tokens it lies more
    than twice the control below the teacher's best with its near-tie
    expert choices imposed too (``off``). At the first divergence the
    report has the gap between the two tokens, the control there and each
    run's token, how far below the teacher's best and how far with its
    near-tie choices imposed."""
    at = next((i for i, (a, b) in enumerate(zip(plain, got)) if a != b),
              None)
    if at is None:
        return {"at": None}
    div = {"at": at}
    for name, toks in (("plain", plain), ("spec", got)):
        run = check_run(params, cfg, prompt, toks, seed, quant,
                        None if routes is None else routes[name])
        div[name] = {
            "token": toks[at], "below_best": run["below"][at],
            "replayed_below": run["replayed"][at],
            **run.get("summary", {}), "checked": len(toks),
            "off": [{"token": t, "below": b, "replayed": r, "control": c}
                    for t, (b, r, c) in enumerate(zip(
                        run["below"], run["replayed"], run["control"]))
                    if min(b, r) > 2.0 * c]}
        if name == "plain":
            div.update({k: run[k][at] for k in ("noise", "roundtrip")
                        if k in run}, control=run["control"][at])
    div["gap"] = abs(div["plain"]["below_best"] - div["spec"]["below_best"])
    return div


def divergence_gate(div, label, errors):
    """The same rule for both runs: every token must be the
    teacher-forced choice within twice the control, as it is or with the
    run's own near-tie expert choices imposed (a discrete choice upstream,
    most often a router's top-k, tipped by a rounding: both greedy paths
    are then valid). A token off the teacher's choice that no near-tie
    choice of its run explains fails."""
    if div["at"] is None:
        return
    for name in ("plain", "spec"):
        for o in div[name]["off"]:
            errors.append(
                f"{label} (the runs part at token {div['at']}): the {name} "
                f"run's token {o['token']} lies {o['below']:.4f} below the "
                f"teacher's best, {o['replayed']:.4f} with its "
                f"{div[name].get('imposed', 0)} near-tie expert choices "
                f"imposed, above twice the control {o['control']:.4f}")


def request_routes(routes, key):
    """{(layer, position): choice} of one request (or batch row) ``key``
    of a recording's {(key, layer, position): choice}."""
    return {k[1:]: c for k, c in routes.items() if k[0] == key}


def logit_gate(params, cfg, prompt, plain, got, plain_rows, got_rows, seed,
               quant=None):
    """Two engines' logits at the same tokens, against a noise control.

    ``plain`` and ``got`` are two engines' tokens after ``prompt``;
    ``plain_rows`` and ``got_rows`` their recordings' {position: (input
    token, logits row)} of this request (:func:`record_engine` with
    ``logits``). The compared positions are the generated ones whose
    inputs both engines share: ``len(prompt) + j`` for ``j`` before the
    first token where they part (each row there predicts the token after
    the same sequence). Per position, the distance is the largest
    |difference| of the two rows, and the control how far the teacher's
    row (``forward_prefill`` of the shared sequence, K and V through the
    cache's round trip for a quantized cache) moves at most under
    bf16-sized noise in the attention output (:func:`noisy`; not the
    round trip's own movement: both engines hold the same codes). The
    report's ``ratio`` is the median over positions of distance /
    control (a router near-tie that one engine takes the other way moves
    a few rows far; a fault moves every row), and ``ok`` says whether it
    is at most 2."""
    from ..models import forward_prefill
    from ..ops import flash

    n = next((j for j, (a, b) in enumerate(zip(plain, got)) if a != b),
             min(len(plain), len(got)))
    P = len(prompt)
    pos = [P + j for j in range(n) if P + j in plain_rows
           and P + j in got_rows]
    if not pos:
        return {"compared": 0, "ratio": 0.0, "ok": True}
    seq = torch.tensor([list(prompt) + list(plain[:n])],
                       device=params["embed"].device)
    for p in pos:
        for rows in (plain_rows, got_rows):
            if int(rows[p][0]) != int(seq[0, p]):
                raise ValueError(f"position {p}: a recorded input token is "
                                 f"not the request's")
    base_impl = flash.sink_flash_attention
    if quant:
        base_impl = kv_roundtrip(base_impl, quant)
    idx = torch.tensor(pos, device=seq.device)
    with torch.inference_mode():
        base = forward_prefill(params, cfg, seq, attn_impl=base_impl)[0][
            0, idx].float()
        moved = forward_prefill(params, cfg, seq, attn_impl=noisy(
            base_impl, seed))[0][0, idx].float()
    control = (moved - base).abs().amax(-1)
    dist = torch.stack([(got_rows[p][1].float() - plain_rows[p][1].float())
                        .abs().amax() for p in pos])
    ratio = dist / control.clamp(min=1e-30)
    med = float(ratio.median())
    return {"compared": len(pos), "distance_median": float(dist.median()),
            "control_median": float(control.median()),
            "ratio": med, "ratio_max": float(ratio.max()), "ok": med <= 2.0}
