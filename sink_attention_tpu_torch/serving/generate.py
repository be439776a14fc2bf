"""Generation over the rolling sink KV cache: greedy, beam search and
speculative decoding.

Counterpart of ``sink_attention_tpu/serving/generate.py``: the JAX
package's ``lax.scan`` and ``lax.while_loop`` become Python loops, one
``forward_decode`` per token (the caches update in place). Where the JAX
loop decides on the device (skip a beam reorder, stop early, how far a
speculative round advances), the loop here reads the deciding values to
the host once per step or round.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.model import (forward_decode, forward_prefill, forward_verify,
                            make_caches)
from ..utils.device import resolve_device

__all__ = ["greedy_generate", "beam_generate", "speculative_generate",
           "prefill_and_caches", "decode_loop"]


@torch.inference_mode()
def prefill_and_caches(params, cfg: ModelConfig, input_ids: torch.Tensor,
                       max_new_tokens: int,
                       dtype: torch.dtype = torch.bfloat16,
                       quant: Optional[str] = None):
    """Run prefill; return (next_token [B] int64, caches), on the device of
    ``input_ids``; the caches quantized to int8/fp8 if ``quant``."""
    B, N = input_ids.shape
    caches = make_caches(cfg, B, max_len=N + max_new_tokens, dtype=dtype,
                         quant=quant, device=input_ids.device)
    logits, caches = forward_prefill(params, cfg, input_ids, caches)
    return logits[:, -1].argmax(dim=-1), caches


@torch.inference_mode()
def decode_loop(params, cfg: ModelConfig, first_token: torch.Tensor, caches,
                start_pos: int, steps: int, attn_impl=None):
    """Greedy decode of ``steps`` tokens after ``first_token`` [B]; returns
    (tokens [B, steps + 1], caches). ``attn_impl(q, cache, s_aux=)``
    overrides the decode attention (``forward_decode``'s)."""
    toks = [first_token]
    tok = first_token
    for i in range(steps):
        logits, caches = forward_decode(params, cfg, tok[:, None], caches,
                                        start_pos + i, attn_impl=attn_impl)
        tok = logits[:, -1].argmax(dim=-1)
        toks.append(tok)
    return torch.stack(toks, dim=1), caches


@torch.inference_mode()
def greedy_generate(params, cfg: ModelConfig, input_ids: torch.Tensor,
                    max_new_tokens: int, dtype: torch.dtype = torch.bfloat16,
                    quant: Optional[str] = None, device="cuda"):
    """Greedy generation on ``device`` (the card unless told otherwise),
    over an int8/fp8 KV cache if ``quant``. input_ids [B, N] -> generated
    tokens [B, max_new_tokens] int64."""
    dev = resolve_device(device)
    input_ids = input_ids.to(dev)
    N = input_ids.shape[1]
    first, caches = prefill_and_caches(params, cfg, input_ids,
                                       max_new_tokens, dtype=dtype,
                                       quant=quant)
    if max_new_tokens == 1:
        return first[:, None]
    toks, _ = decode_loop(params, cfg, first, caches, start_pos=N,
                          steps=max_new_tokens - 1)
    return toks


def topk_lowest_index(x: torch.Tensor, k: int):
    """``torch.topk(x, k, dim=-1)`` with equal values ordered by the lower
    index first, as ``lax.top_k`` orders them (``torch.topk`` promises no
    order among equal values). Each fp32 value is mapped to an int32 of
    the same order and joined with its negated index into one int64 key,
    so every key is distinct. Returns (values, indices int64)."""
    bits = x.float().contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    _, top = torch.topk(ordered * 2 ** 32 + (n - 1 - idx), k, dim=-1)
    return x.gather(-1, top), top


def _tile_beams(cache, K: int):
    """Each batch row of ``cache`` repeated K times (beam-major within a
    row): [B, ...] -> [B * K, ...], in place of the buffers."""
    for name in ("k", "v", "k_scale", "v_scale"):
        setattr(cache, name,
                getattr(cache, name).repeat_interleave(K, dim=0))
    return cache


@torch.inference_mode()
def beam_generate(params, cfg: ModelConfig, input_ids: torch.Tensor,
                  max_new_tokens: int, num_beams: int = 4,
                  length_penalty: float = 1.0, eos_id: Optional[int] = None,
                  pad_id: int = 0, dtype: torch.dtype = torch.bfloat16,
                  quant: Optional[str] = None, device="cuda", stats=None):
    """Beam search over the rolling sink cache. input_ids [B, N] ->
    (tokens [B, max_new_tokens] int64, scores [B] fp32) of each row's best
    beam (greedy's tokens at ``num_beams=1``).

    Each row is prefilled once and its caches tiled over the K beams
    (B * K cache rows, one decode launch per layer and step for all of
    them). A step takes the log-softmax in fp32 and the top K of the K * V
    candidates (ties to the lower index, as in JAX), then reorders every
    layer's cache by the beams' origins, unless that permutation is the
    identity. With ``eos_id``, a beam that emits EOS freezes: its score
    stops, it extends only with ``pad_id``, and its length is pinned for
    the final ``score / len ** length_penalty``; finished beams compete in
    their slots, as in the JAX package. The search stops once every beam
    is frozen. The two tests (identity, all frozen) are read to the host in
    one read per step. ``stats`` (a dict, optional) receives the counts
    of reorders done and skipped and of steps run.
    """
    dev = resolve_device(device)
    input_ids = input_ids.to(dev)
    B, N = input_ids.shape
    V, K = cfg.vocab_size, num_beams
    caches = make_caches(cfg, B, max_len=N + max_new_tokens, dtype=dtype,
                         quant=quant, device=dev)
    logits, caches = forward_prefill(params, cfg, input_ids, caches)
    logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)      # [B, V]
    scores, tok = topk_lowest_index(logp0, K)                      # [B, K]
    fin = (tok == eos_id) if eos_id is not None else torch.zeros_like(
        tok, dtype=torch.bool)
    for c in caches:
        _tile_beams(c, K)
    frozen_logp = torch.full((V,), float("-inf"), device=dev)
    frozen_logp[pad_id] = 0.0
    seqs = torch.full((B, K, max_new_tokens), pad_id, dtype=torch.long,
                      device=dev)
    seqs[:, :, 0] = tok
    glen = torch.ones((B, K), dtype=torch.long, device=dev)
    row_base = (torch.arange(B, device=dev) * K)[:, None]
    beam_ids = torch.arange(K, device=dev)[None]
    stats = {} if stats is None else stats
    stats.update(reorders=0, reorders_skipped=0, steps=0)
    t, done = 1, bool(fin.all())
    while t < max_new_tokens and not done:
        logits, caches = forward_decode(params, cfg, tok.reshape(-1, 1),
                                        caches, N + t - 1)
        logp = torch.log_softmax(logits[:, -1].float(), -1).reshape(B, K, V)
        if eos_id is not None:
            logp = torch.where(fin[..., None], frozen_logp, logp)
        cand = (scores[..., None] + logp).reshape(B, K * V)
        scores, flat = topk_lowest_index(cand, K)
        src = flat // V                                            # [B, K]
        tok = flat % V
        was_fin = fin.gather(1, src)
        if eos_id is not None:
            fin = was_fin | (tok == eos_id)
            tok = torch.where(was_fin, torch.full_like(tok, pad_id), tok)
        glen = glen.gather(1, src) + (~was_fin).long()
        seqs = seqs.gather(1, src[..., None].expand(-1, -1, max_new_tokens))
        seqs[:, :, t] = tok
        t += 1
        stats["steps"] += 1
        identity, done = torch.stack([(src == beam_ids).all(),
                                      fin.all()]).tolist()  # one host read
        if identity:
            stats["reorders_skipped"] += 1
        else:
            gather = (row_base + src).reshape(-1)
            for c in caches:
                c.reorder(gather)
            stats["reorders"] += 1
    final = scores / glen.float() ** length_penalty
    best = final.argmax(dim=1)                                     # [B]
    rows = torch.arange(B, device=dev)
    return seqs[rows, best], final[rows, best]


@torch.inference_mode()
def speculative_generate(params_target, params_draft, cfg_target: ModelConfig,
                         cfg_draft: ModelConfig, input_ids: torch.Tensor,
                         max_new_tokens: int, num_draft_tokens: int = 4,
                         dtype: torch.dtype = torch.bfloat16,
                         quant: Optional[str] = None, device="cuda",
                         stats=None):
    """Greedy speculative decoding of one sequence (B = 1). Returns
    (tokens [1, max_new_tokens] int64, acceptance rate: tokens emitted per
    target pass).

    Each round: the draft proposes K tokens with ``forward_decode
    (collect_kv=True)`` on a copy of its caches; the target verifies
    ``[tok, draft[:-1]]`` in one ``forward_verify`` against its
    pre-append caches; the accepted prefix ``n_acc`` is the cumprod of the
    matches, and ``count = n_acc + 1`` tokens are committed to the target
    caches from the verify pass's KVs and to the draft caches from the
    proposal's own KVs (``append_many_counted``), so the draft never runs
    twice. The output is the target's greedy output; in bf16 a near-tie
    argmax can flip between the multi-token verify and the single-token
    decode, either being a greedy continuation. The JAX loop runs on the
    device with no host sync; this one reads ``count`` to the host once
    per round (its ``while`` needs it, and the caches' state is host
    ints). ``stats`` (a dict, optional) receives the rounds and the tokens
    emitted.
    """
    dev = resolve_device(device)
    input_ids = input_ids.to(dev)
    B, N = input_ids.shape
    if B != 1:
        raise ValueError("speculative_generate decodes one sequence (B=1)")
    K = min(num_draft_tokens, max_new_tokens)
    max_len = N + max_new_tokens + K  # a round may overshoot
    tcaches = make_caches(cfg_target, B, max_len, dtype=dtype, quant=quant,
                          device=dev)
    dcaches = make_caches(cfg_draft, B, max_len, dtype=dtype, quant=quant,
                          device=dev)
    tlogits, _ = forward_prefill(params_target, cfg_target, input_ids,
                                 tcaches)
    forward_prefill(params_draft, cfg_draft, input_ids, dcaches)
    tok = tlogits[:, -1].argmax(dim=-1)                            # [1]
    out, pos, emitted, rounds = [tok], N, 0, 0
    while emitted < max_new_tokens - 1:
        # 1. K draft tokens on a copy of the draft caches
        fork = [c.clone() for c in dcaches]
        cur, drafts, dkvs = tok, [], []
        for i in range(K):
            dl, _, kvs = forward_decode(params_draft, cfg_draft, cur[:, None],
                                        fork, pos + i, collect_kv=True)
            cur = dl[:, -1].argmax(dim=-1)
            drafts.append(cur)
            dkvs.append(kvs)
        draft = torch.cat(drafts)                                  # [K]
        # 2. one target pass over [tok, draft[:-1]]
        inputs = torch.cat([tok, draft[:K - 1]])[None]
        vlogits, tkvs = forward_verify(params_target, cfg_target, inputs,
                                       tcaches, pos)
        greedy = vlogits[0].argmax(dim=-1)                         # [K]
        # 3. the accepted prefix and one token of the target's own
        n_acc = torch.cumprod((greedy[:K - 1] == draft[:K - 1]).long(),
                              dim=0).sum()
        count = int(n_acc) + 1                   # the round's host read
        accepted = torch.cat([draft[:count - 1], greedy[count - 1:count]])
        for c, (k, v) in zip(tcaches, tkvs):
            c.append_many_counted(k, v, count)
        # 4. the draft commits its proposal's own KVs
        for li, c in enumerate(dcaches):
            c.append_many_counted(torch.cat([kv[li][0] for kv in dkvs], 2),
                                  torch.cat([kv[li][1] for kv in dkvs], 2),
                                  count)
        out.append(accepted)
        tok = accepted[-1:]
        pos += count
        emitted += count
        rounds += 1
    if stats is not None:
        stats.update(rounds=rounds, emitted=emitted)
    toks = torch.cat(out)[:max_new_tokens][None]
    return toks, emitted / rounds if rounds else 1.0
