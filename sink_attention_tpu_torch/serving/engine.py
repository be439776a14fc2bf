"""Continuous batching engine over the ragged sink KV cache.

Counterpart of ``sink_attention_tpu/serving/engine.py``:

* a fixed pool of ``max_batch`` cache slots, each holding one request at
  its own length and ring phase (``RaggedSinkKVCache``, bf16 or int8/fp8);
* a queued request is prefilled (prompt padded to ``prefill_bucket``) into
  a free slot while the others keep their state; its first token is
  sampled on the device and read at the next host sync;
* one decode step advances every active slot at once: per-slot RoPE
  positions, per-slot cache append, one ragged decode launch per layer;
* ``step_chunk(n)`` runs n steps with one host read at the end: a slot that
  samples its EOS or spends its budget turns inactive on the device, so
  later steps of the chunk neither append to its cache nor advance it;
* finished slots are recycled at once;
* with a draft model (``draft_params``, ``draft_cfg``), speculative
  decoding per slot: each round drafts ``num_draft_tokens`` greedily for
  every active slot (ragged draft caches), verifies them in one ragged
  multi-token target pass and commits each slot's accepted prefix with
  per-slot counts (``RaggedSinkKVCache.append_many_counted``), EOS and
  budgets cutting the counts on the device; ``step_spec_chunk(n)`` runs n
  rounds with one host read at the end. Greedy requests only;
* ``save_state``/``load_state`` snapshot the serving state mid-run (caches,
  pending tokens, sampling parameters, the generator's state, request
  bookkeeping) so a fresh engine resumes with exactly the tokens of the
  uninterrupted run.

Sampling is greedy by default; temperature, top-k and top-p per engine or
per request (``SamplingParams``), all slots sampled together from per-slot
parameter tensors with an explicit ``torch.Generator`` seeded from
``seed``. JAX's ``jit`` and ``lax.scan`` become eager calls and a Python
loop; the grouped MoE's per-layer host sync stays where it is.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from ..models.config import ModelConfig
from ..models.model import (forward_decode_ragged, forward_prefill,
                            forward_verify_ragged, make_ragged_caches)
from ..utils import checkpoint
from ..utils.device import resolve_device

__all__ = ["SamplingParams", "Request", "ContinuousBatchingEngine"]

MAX_CHUNK = 32  # the largest decode chunk run() takes


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _sample_batch(logits: torch.Tensor, generator: torch.Generator,
                  temps: torch.Tensor, topks: torch.Tensor,
                  topps: torch.Tensor, candidate_k: int) -> torch.Tensor:
    """Per-slot sampling over [B, V] logits -> [B] int64.

    Slots with ``temps <= 0`` take the argmax; the rest draw from a
    temperature-scaled categorical filtered per slot by top-k and/or top-p.
    The thresholds come from the top ``candidate_k`` logits: top-k is exact
    for k <= candidate_k (checked at submit), top-p whenever the nucleus
    fits in the candidates, else it is cut to the top candidate_k tokens.
    """
    greedy_tok = logits.argmax(dim=-1)
    greedy = temps <= 0.0
    scaled = logits.float() / torch.where(
        greedy, torch.ones_like(temps), temps)[:, None]
    K = min(candidate_k, scaled.shape[-1])
    vals, _ = torch.topk(scaled, K, dim=-1)            # [B, K], descending
    neg_inf = torch.full_like(vals[:, :1], float("-inf"))
    k_eff = torch.where(topks > 0, topks.clamp(max=K),
                        torch.full_like(topks, K))
    kth = vals.gather(1, (k_eff - 1)[:, None].long())
    thresh = torch.where((topks > 0)[:, None], kth, neg_inf)
    # the nucleus from full-vocabulary probabilities of the candidates
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    cand_p = torch.exp(vals - lse)
    cum = torch.cumsum(cand_p, dim=-1)
    keep = (cum - cand_p) < topps[:, None]         # the first always kept
    n_keep = keep.sum(dim=-1, keepdim=True)
    pth = vals.gather(1, n_keep - 1)
    contained = cum[:, -1:] >= topps[:, None]
    pth_eff = torch.where(contained, pth, vals[:, -1:])
    thresh = torch.maximum(
        thresh, torch.where(topps[:, None] < 1.0, pth_eff, neg_inf))
    masked = torch.where(scaled >= thresh, scaled, float("-inf"))
    sampled = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                                generator=generator)[:, 0]
    return torch.where(greedy, greedy_tok, sampled)


@dataclass
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0            # 0 => no top-k filtering
    top_p: float = 1.0        # 1 => no nucleus filtering


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None  # None => engine default
    tokens: List[int] = field(default_factory=list)  # generated
    done: bool = False


class ContinuousBatchingEngine:
    """Multi-request serving with slot-level continuous batching.

    Usage::

        eng = ContinuousBatchingEngine(params, cfg, max_batch=4,
                                       quant="int8")
        eng.submit([1, 2, 3], max_new_tokens=32)
        eng.submit([4, 5], max_new_tokens=16)
        results = eng.run()   # {rid: [generated tokens]}

    ``first_token_cb(rid, token)`` is called when a request's first token
    reaches the host. ``pool_steps`` counts the decode steps of the whole
    pool (each one ragged decode launch per layer).

    With ``draft_params`` and ``draft_cfg`` the engine decodes
    speculatively (``step_spec_chunk``; ``run`` dispatches to it and
    ``step``/``step_chunk`` refuse): ``num_draft_tokens`` drafts per slot
    and round, output equal to greedy decoding per slot (the bf16
    near-tie caveat of ``speculative_generate``). ``spec_rounds`` counts
    the pool's rounds, ``spec_slot_rounds`` the (round, slot) pairs that
    committed tokens and ``spec_tokens`` the tokens committed.
    """

    def __init__(self, params: dict, cfg: ModelConfig, max_batch: int = 4,
                 max_len: int = 4096, prefill_bucket: int = 128,
                 dtype: torch.dtype = torch.bfloat16,
                 quant: Optional[str] = None, eos_id: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None, seed: int = 0,
                 streaming: bool = False, candidate_k: int = 64,
                 first_token_cb: Optional[Callable[[int, int], None]] = None,
                 device="cuda", draft_params: Optional[dict] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 num_draft_tokens: int = 8):
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.prefill_bucket = prefill_bucket
        self.eos_id = eos_id
        self.sampling = sampling or SamplingParams()
        self.candidate_k = candidate_k
        self.first_token_cb = first_token_cb
        if self.sampling.top_k > candidate_k:
            raise ValueError(
                f"engine default top_k={self.sampling.top_k} exceeds "
                f"candidate_k={candidate_k}; raise candidate_k")
        self.device = dev = resolve_device(device)
        sp = self.sampling
        # per-slot sampling parameters; a request's own SamplingParams
        # replace the engine default at admission
        self._temps = torch.full((max_batch,), sp.temperature,
                                 dtype=torch.float32, device=dev)
        self._topks = torch.full((max_batch,), sp.top_k, dtype=torch.int64,
                                 device=dev)
        self._topps = torch.full((max_batch,), sp.top_p,
                                 dtype=torch.float32, device=dev)
        self.caches = make_ragged_caches(cfg, max_batch, max_len,
                                         dtype=dtype, quant=quant,
                                         streaming=streaming, device=dev)
        self.toks = torch.zeros((max_batch,), dtype=torch.int64, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.pool_steps = 0

        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.num_draft_tokens = num_draft_tokens
        self.draft_caches = None
        self.spec_rounds = self.spec_slot_rounds = self.spec_tokens = 0
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            if self.sampling.temperature > 0.0:
                raise ValueError(
                    "speculative decoding requires greedy sampling "
                    "(engine default temperature must be 0)")
            self.draft_caches = make_ragged_caches(
                draft_cfg, max_batch, max_len, dtype=dtype, quant=quant,
                streaming=streaming, device=dev)

        self._slots: List[Optional[Request]] = [None] * max_batch
        self._queue: List[Request] = []
        self._next_rid = 0
        # slot -> first token sampled on the device at admission, not yet
        # read to the host (read at the next host sync, _flush_pending)
        self._pending_first: Dict[int, torch.Tensor] = {}

    # -- sampling -----------------------------------------------------------

    def _req_sampling(self, req: Request) -> SamplingParams:
        return req.sampling if req.sampling is not None else self.sampling

    def _use_sampling(self) -> bool:
        """True if any slotted request samples (an all-greedy pool skips
        the top-k pass)."""
        return any(self._req_sampling(r).temperature > 0.0
                   for r in self._slots if r is not None)

    def _sample(self, logits: torch.Tensor, use_sampling: bool):
        if not use_sampling:
            return logits.argmax(dim=-1)
        return _sample_batch(logits, self.generator, self._temps,
                             self._topks, self._topps, self.candidate_k)

    # -- public API -----------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 64,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> int:
        if sampling is not None and sampling.top_k > self.candidate_k:
            raise ValueError(
                f"top_k={sampling.top_k} exceeds the engine's candidate_k="
                f"{self.candidate_k}; raise candidate_k at construction")
        if (self.draft_params is not None and sampling is not None
                and sampling.temperature > 0.0):
            raise ValueError("the speculative engine serves greedy requests "
                             "only")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, list(prompt), max_new_tokens,
                                   eos_id if eos_id is not None
                                   else self.eos_id, sampling=sampling))
        return rid

    @property
    def active_count(self) -> int:
        return sum(r is not None for r in self._slots)

    @torch.no_grad()
    def _admit(self) -> None:
        """Prefill queued requests into free slots, with no host sync: the
        first token is sampled on the device and stays pending."""
        for slot in range(self.max_batch):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.pop(0)
            n = len(req.prompt)
            n_pad = _round_up(max(n, 1), self.prefill_bucket)
            ids = torch.zeros((1, n_pad), dtype=torch.int64)
            ids[0, :n] = torch.tensor(req.prompt, dtype=torch.int64)
            logits, kvs = forward_prefill(self.params, self.cfg,
                                          ids.to(self.device),
                                          collect_kv=True)
            for cache, (k, v) in zip(self.caches, kvs):
                cache.insert(slot, k[0], v[0], n)
            if self.draft_params is not None:
                _, dkvs = forward_prefill(self.draft_params, self.draft_cfg,
                                          ids.to(self.device),
                                          collect_kv=True)
                for cache, (k, v) in zip(self.draft_caches, dkvs):
                    cache.insert(slot, k[0], v[0], n)
            sp = self._req_sampling(req)
            self._temps[slot] = sp.temperature
            self._topks[slot] = sp.top_k
            self._topps[slot] = sp.top_p
            last = logits[0, n - 1:n]
            if sp.temperature > 0.0:
                rows = slice(slot, slot + 1)
                first = _sample_batch(last, self.generator,
                                      self._temps[rows], self._topks[rows],
                                      self._topps[rows], self.candidate_k)[0]
            else:
                first = last[0].argmax()
            self.toks[slot] = first
            self._pending_first[slot] = first
            self._slots[slot] = req

    def _flush_pending(self) -> Dict[int, int]:
        """Read the pending first tokens (one host sync), append them to
        their requests and finish those that are done. Returns {rid:
        first token}."""
        if not self._pending_first:
            return {}
        slots = list(self._pending_first)
        firsts = torch.stack([self._pending_first.pop(s)
                              for s in slots]).tolist()
        out = {}
        for slot, tok in zip(slots, firsts):
            req = self._slots[slot]
            req.tokens.append(tok)
            out[req.rid] = tok
            if self.first_token_cb is not None:
                self.first_token_cb(req.rid, tok)
            self._finish_if_done(slot, tok)
        return out

    def _finish_if_done(self, slot: int, tok: int) -> bool:
        req = self._slots[slot]
        if ((req.eos_id is not None and tok == req.eos_id) or
                len(req.tokens) >= req.max_new_tokens):
            req.done = True
            self._slots[slot] = None
            for cache in self.caches + (self.draft_caches or []):
                cache.clear(slot)
        return req.done

    def _check_not_speculative(self, name: str) -> None:
        """Plain steps advance only the target caches: on a speculative
        engine the draft caches would fall behind their slots for good."""
        if self.draft_params is not None:
            raise RuntimeError(
                f"{name}() is not supported on a speculative engine (it "
                "would desync the draft caches); use step_spec_chunk() or "
                "run()")

    def _pool_limits(self):
        """(active [B] bool, EOS ids [B] (-1: none), budgets [B]) of the
        slotted requests on the device, and the host's list of active
        slots."""
        active_py = [r is not None for r in self._slots]
        dev = self.device
        eos_ids = torch.tensor(
            [(r.eos_id if r is not None and r.eos_id is not None else -1)
             for r in self._slots], device=dev)
        budgets = torch.tensor(
            [r.max_new_tokens - len(r.tokens) if r is not None else 0
             for r in self._slots], device=dev)
        return (torch.tensor(active_py, device=dev), eos_ids, budgets,
                active_py)

    def step(self) -> Dict[int, int]:
        """Admit, then one decode step for every active slot. Returns
        {rid: latest token}: for a request admitted in this call that is
        the decoded one (its first token lands in its list too)."""
        self._check_not_speculative("step")
        return {rid: toks[-1] for rid, toks in self.step_chunk(1).items()}

    @torch.no_grad()
    def step_chunk(self, n: int) -> Dict[int, List[int]]:
        """Admit, then ``n`` decode steps of the pool with one host read at
        the end. EOS and budgets are checked on the device: a slot that
        finishes mid-chunk is masked off for the chunk's remaining steps
        (the steps still run, and its queued successor waits for the next
        chunk). Returns {rid: [tokens kept this call]}."""
        self._check_not_speculative("step_chunk")
        self._admit()
        out: Dict[int, List[int]] = {
            rid: [tok] for rid, tok in self._flush_pending().items()}
        act, eos_ids, budgets, active_py = self._pool_limits()
        if not any(active_py):
            return out
        use_sampling = self._use_sampling()
        emitted = torch.zeros_like(budgets)
        toks, seq = self.toks, []
        for _ in range(n):
            positions = self.caches[0].seen     # each slot's next position
            logits, _ = forward_decode_ragged(self.params, self.cfg,
                                              toks[:, None], self.caches,
                                              positions, act)
            nxt = torch.where(act, self._sample(logits[:, -1],
                                                use_sampling), toks)
            emitted = emitted + act.to(emitted.dtype)
            hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
            act = act & ~hit_eos & (emitted < budgets)
            toks = nxt
            seq.append(nxt)
        self.toks = toks
        self.pool_steps += n
        seq_host = torch.stack(seq, dim=1).tolist()   # the chunk's one read
        self._keep(out, active_py, seq_host)
        return out

    def _keep(self, out: Dict[int, List[int]], active_py: List[bool],
              seq_host: List[List[int]]) -> None:
        """Append each active slot's tokens of a chunk to its request (and
        to ``out``), up to the one that finishes it."""
        for slot, was_active in enumerate(active_py):
            req = self._slots[slot]
            if not was_active:
                continue
            kept = out.setdefault(req.rid, [])
            for tok in seq_host[slot]:
                req.tokens.append(tok)
                kept.append(tok)
                if self._finish_if_done(slot, tok):
                    break

    @torch.no_grad()
    def step_spec_chunk(self, rounds: int) -> Dict[int, List[int]]:
        """Admit, then ``rounds`` speculative rounds of the pool with one
        host read at the end (a draft model is required).

        A round: ``num_draft_tokens`` (K) draft steps of every active slot
        on a copy of the draft caches, keeping each step's KVs; one
        ``forward_verify_ragged`` of ``[tok, draft[:-1]]`` against the
        target caches; per slot the accepted prefix ``n_acc`` (cumprod of
        the matches) and ``count = n_acc + 1``, cut on the device at the
        first EOS (inclusive) and at the slot's remaining budget, 0 for an
        inactive slot; the counted commit to both cache sets (the draft's
        from its proposal's KVs, so the draft runs once). A slot that
        finishes turns inactive for the chunk's remaining rounds. Returns
        {rid: [tokens kept this call]}.
        """
        if self.draft_params is None:
            raise RuntimeError("step_spec_chunk needs a draft model")
        self._admit()
        out: Dict[int, List[int]] = {
            rid: [tok] for rid, tok in self._flush_pending().items()}
        act, eos_ids, budgets, active_py = self._pool_limits()
        if not any(active_py):
            return out
        K = self.num_draft_tokens
        idx = torch.arange(K, device=self.device)[None]
        toks, emitted, per_round = self.toks, torch.zeros_like(budgets), []
        for _ in range(rounds):
            fork = [c.clone() for c in self.draft_caches]
            cur, drafts, dkvs = toks, [], []
            for _ in range(K):
                dl, _, kvs = forward_decode_ragged(
                    self.draft_params, self.draft_cfg, cur[:, None], fork,
                    fork[0].seen, act, collect_kv=True)
                cur = torch.where(act, dl[:, -1].argmax(dim=-1), cur)
                drafts.append(cur)
                dkvs.append(kvs)
            draft = torch.stack(drafts, dim=1)                 # [B, K]
            inputs = torch.cat([toks[:, None], draft[:, :K - 1]], dim=1)
            vlogits, tkvs = forward_verify_ragged(
                self.params, self.cfg, inputs, self.caches)
            greedy = vlogits.argmax(dim=-1)                    # [B, K]
            n_acc = torch.cumprod(
                (greedy[:, :K - 1] == draft[:, :K - 1]).long(), dim=1
            ).sum(dim=1)
            count = n_acc + 1
            bonus = greedy.gather(1, n_acc.clamp(max=K - 1)[:, None])
            accepted = torch.where(idx < n_acc[:, None], draft, bonus)
            # cut at the first emitted EOS (inclusive) and at the budget;
            # an inactive slot commits nothing
            is_eos = ((eos_ids[:, None] >= 0)
                      & (accepted == eos_ids[:, None])
                      & (idx < count[:, None]))
            has_eos = is_eos.any(dim=1)
            eos_pos = is_eos.long().argmax(dim=1)
            count = torch.where(has_eos, eos_pos + 1, count)
            count = torch.minimum(count, (budgets - emitted).clamp(min=0))
            count = torch.where(act, count, torch.zeros_like(count))
            for c, (k, v) in zip(self.caches, tkvs):
                c.append_many_counted(k, v, count)
            for li, c in enumerate(self.draft_caches):
                c.append_many_counted(
                    torch.cat([kv[li][0] for kv in dkvs], dim=2),
                    torch.cat([kv[li][1] for kv in dkvs], dim=2), count)
            emitted = emitted + count
            last = accepted.gather(1, (count - 1).clamp(min=0)[:, None])
            toks = torch.where(count > 0, last[:, 0], toks)
            act = act & ~(has_eos & (eos_pos < count)) & (emitted < budgets)
            per_round.append(torch.cat([accepted, count[:, None]], dim=1))
        self.toks = toks
        self.spec_rounds += rounds
        host = torch.stack(per_round, dim=1).tolist()  # the chunk's one read
        seq_host = []
        for slot_rounds in host:              # per round: K tokens, count
            seq_host.append([t for r in slot_rounds for t in r[:r[K]]])
            self.spec_slot_rounds += sum(r[K] > 0 for r in slot_rounds)
            self.spec_tokens += sum(r[K] for r in slot_rounds)
        self._keep(out, active_py, seq_host)
        return out

    def run(self, chunk: Optional[int] = None) -> Dict[int, List[int]]:
        """Serve the queue and every active slot to the end; returns
        {rid: generated tokens} of every request seen.

        By default each round decodes a chunk of the next power of two
        above the largest remaining budget, at most 32 steps; pass
        ``chunk`` to fix it (``chunk=1``: one host read per token).
        Queued requests are admitted between chunks.
        """
        reqs = list(self._queue) + [r for r in self._slots if r]
        while self._queue or self.active_count:
            self._admit()
            self._flush_pending()
            if not self.active_count:
                continue
            if chunk is None:
                need = max(r.max_new_tokens - len(r.tokens)
                           for r in self._slots if r is not None)
                n = 1
                while n < min(need, MAX_CHUNK):
                    n *= 2
            else:
                n = chunk
            if self.draft_params is not None:
                # a round emits at least one token per active slot
                self.step_spec_chunk(max(1, n // 2))
            else:
                self.step_chunk(n)
        return {r.rid: r.tokens for r in reqs}

    # -- checkpoint / resume --------------------------------------------------

    def save_state(self, path: str) -> None:
        """Snapshot the full mid-serving state: the caches (the draft
        caches too on a speculative engine), pending tokens, per-slot
        sampling parameters and the generator's state to ``path``
        (``utils.checkpoint``), request bookkeeping to ``path +
        ".meta.json"``. A fresh engine built with the same (params, cfg,
        max_batch, max_len, ...) resumes with :meth:`load_state` and
        produces exactly the tokens the uninterrupted run would have (the
        generator's state is part of the snapshot, so sampled requests
        resume deterministically too)."""
        # materialise any in-flight first tokens so the JSON bookkeeping
        # agrees with the tensors being saved
        self._flush_pending()
        state = {"caches": self.caches, "toks": self.toks,
                 "generator": self.generator.get_state(),
                 "temps": self._temps, "topks": self._topks,
                 "topps": self._topps}
        if self.draft_params is not None:
            # a speculative engine resumed without its draft caches would
            # stay greedy-correct (verification is against the target) but
            # would draft from garbage, collapsing its acceptance
            state["draft_caches"] = self.draft_caches
        checkpoint.save(path, state)
        meta = {
            "next_rid": self._next_rid,
            "slots": [dataclasses.asdict(r) if r is not None else None
                      for r in self._slots],
            "queue": [dataclasses.asdict(r) for r in self._queue],
        }
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)

    def load_state(self, path: str) -> None:
        """Restore a :meth:`save_state` snapshot into this engine. The
        saved tensors are copied into the engine's own (``copy_``), so its
        caches keep their storage."""
        state = checkpoint.restore(path, device=self.device)
        if self.draft_params is not None and "draft_caches" not in state:
            raise ValueError(
                "snapshot has no draft-cache state but this engine is "
                "speculative: it was saved by a non-speculative engine; "
                "restore into an engine built with the same draft_params")
        for cache, fields in zip(self.caches, state["caches"], strict=True):
            cache.load_state_dict(fields)
        if self.draft_params is not None:
            for cache, fields in zip(self.draft_caches,
                                     state["draft_caches"], strict=True):
                cache.load_state_dict(fields)
        for mine, name in ((self.toks, "toks"), (self._temps, "temps"),
                           (self._topks, "topks"), (self._topps, "topps")):
            mine.copy_(state[name])
        self.generator.set_state(state["generator"].cpu())
        with open(path + ".meta.json") as f:
            meta = json.load(f)

        def req(d):
            if d is None:
                return None
            if d.get("sampling") is not None:
                d = dict(d, sampling=SamplingParams(**d["sampling"]))
            return Request(**d)

        self._next_rid = meta["next_rid"]
        self._slots = [req(d) for d in meta["slots"]]
        self._queue = [req(d) for d in meta["queue"]]
        self._pending_first = {}
