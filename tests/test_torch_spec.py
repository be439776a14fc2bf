"""The port's beam search and speculative decoding: the verify forwards
against the JAX package's (tiny config, fp32, parameters carried over by
params_from_jax), beam_generate against JAX's, speculative_generate and the
speculative ContinuousBatchingEngine against the port's own greedy decoding
(as the JAX tests hold JAX's), and chip_smoke's phase 8 rehearsed on the
CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.models as jm
from sink_attention_tpu.models import model as jmodel
from sink_attention_tpu.serving import beam_generate as j_beam
from sink_attention_tpu.serving import speculative_generate as j_spec
from sink_attention_tpu_torch.models import ModelConfig, init_params
from sink_attention_tpu_torch.models import model as tmodel
from sink_attention_tpu_torch.models import params_from_jax
from sink_attention_tpu_torch.serving import (ContinuousBatchingEngine,
                                              SamplingParams, beam_generate,
                                              greedy_generate,
                                              speculative_generate)

# the JAX speculative engine tests' model: 4/2 heads, window 16, vocab 64
SMALL = dict(num_heads=4, num_kv_heads=2, head_dim=16, hidden_size=32,
             num_experts=2, sliding_window=16, vocab_size=64)
PROMPTS = [[5, 9, 2], [7, 1, 30, 11, 8, 4, 22], [3] * 20]
F32 = dict(dtype=torch.float32, device="cpu")


def _jax_pair(seed, **kw):
    jcfg, tcfg = jm.ModelConfig.tiny(**kw), ModelConfig.tiny(**kw)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _damped(params, factor):
    """Layers 1.. of ``params`` scaled by ``factor`` (the JAX tests'
    imperfect target), and the draft: layer 0 with the shared embed,
    final norm and lm_head."""
    params = dict(params)
    params["layers"] = [params["layers"][0]] + [
        {k: ({n: t * factor for n, t in part.items()}
             if isinstance(part, dict) else part * factor)
         for k, part in lp.items()} for lp in params["layers"][1:]]
    draft = {k: v for k, v in params.items() if k != "layers"}
    draft["layers"] = params["layers"][:1]
    return params, draft


def _greedy(params, cfg, prompt, n, **kw):
    return greedy_generate(params, cfg, torch.tensor([prompt]), n, **F32,
                           **kw)[0].tolist()


# -- the verify forwards against JAX ----------------------------------------


@functools.lru_cache(maxsize=None)
def _verify_setup():
    """One model pair and the port's collected prefill KVs of 3 prompts
    (lengths 40, 19, 5 in a 48-token pad): both packages' caches are built
    from the same KVs, so no JAX prefill (interpret mode) is run."""
    jcfg, tcfg, jp, tp = _jax_pair(1, num_layers=2)
    rs = np.random.RandomState(2)
    ids = rs.randint(0, tcfg.vocab_size, (3, 48))
    _, kvs = tmodel.forward_prefill(tp, tcfg, torch.from_numpy(ids),
                                    collect_kv=True)
    return jcfg, tcfg, jp, tp, rs, kvs


def _assert_kvs(kt, kj):
    assert len(kt) == len(kj)
    for (k_t, v_t), (k_j, v_j) in zip(kt, kj):
        np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), atol=1e-5)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)


def test_forward_verify_matches_jax():
    """T=4 drafts after a 40-token prompt (the sliding ring wrapped): the
    logits and per-layer KVs match; the caches are not advanced."""
    jcfg, tcfg, jp, tp, rs, kvs = _verify_setup()
    P, T = 40, 4
    jc = jm.make_caches(jcfg, 1, 64, dtype=jnp.float32)
    tc = tmodel.make_caches(tcfg, 1, 64, **F32)
    for li, (k, v) in enumerate(kvs):
        jc[li] = jc[li].prefill(jnp.asarray(k[:1, :, :P].numpy()),
                                jnp.asarray(v[:1, :, :P].numpy()))
        tc[li].prefill(k[:1, :, :P], v[:1, :, :P])
    ids = rs.randint(0, tcfg.vocab_size, (1, T))
    lj, kj = jmodel.forward_verify(jp, jcfg, jnp.asarray(ids), jc, P)
    lt, kt = tmodel.forward_verify(tp, tcfg, torch.from_numpy(ids), tc, P)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    _assert_kvs(kt, kj)
    assert [c.seen for c in tc] == [P] * tcfg.num_layers


def test_forward_verify_ragged_matches_jax():
    """Three slots at lengths 40, 19 and 5 verify T=4 drafts each."""
    jcfg, tcfg, jp, tp, rs, kvs = _verify_setup()
    lens, T = [40, 19, 5], 4
    jc = jm.make_ragged_caches(jcfg, 3, 64, dtype=jnp.float32)
    tc = tmodel.make_ragged_caches(tcfg, 3, 64, **F32)
    for b, n in enumerate(lens):
        for li, (k, v) in enumerate(kvs):
            jc[li] = jc[li].insert(b, jnp.asarray(k[b].numpy()),
                                   jnp.asarray(v[b].numpy()), n)
            tc[li].insert(b, k[b], v[b], n)
    ids = rs.randint(0, tcfg.vocab_size, (3, T))
    lj, kj = jmodel.forward_verify_ragged(jp, jcfg, jnp.asarray(ids),
                                         jc)
    lt, kt = tmodel.forward_verify_ragged(tp, tcfg, torch.from_numpy(ids),
                                          tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    _assert_kvs(kt, kj)
    assert tc[0].seen.tolist() == lens


# -- beam search --------------------------------------------------------------


def test_beam_generate_matches_jax():
    """K=3, T=6 with an EOS that freezes the best beam (the JAX beam test's
    model): tokens equal, scores within 1e-4; K=1 is the port's greedy."""
    jcfg, tcfg, jp, tp = _jax_pair(3, num_layers=1, hidden_size=32,
                                   vocab_size=32)
    ids = np.array(jax.random.randint(jax.random.PRNGKey(4), (1, 6), 0, 32))
    tj, sj = j_beam(jp, jcfg, jnp.asarray(ids), max_new_tokens=6,
                    num_beams=3, eos_id=5, dtype=jnp.float32)
    stats = {}
    tt, st = beam_generate(tp, tcfg, torch.from_numpy(ids), 6, num_beams=3,
                           eos_id=5, stats=stats, **F32)
    assert tt.tolist() == np.asarray(tj).tolist()
    assert 5 in tt[0].tolist()           # the best beam froze at EOS
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-4)
    assert stats["steps"] == 5
    assert stats["reorders"] + stats["reorders_skipped"] == 5
    one, _ = beam_generate(tp, tcfg, torch.from_numpy(ids), 6, num_beams=1,
                           **F32)
    assert one[0].tolist() == _greedy(tp, tcfg, ids[0].tolist(), 6)


def test_beam_ties_go_to_the_lower_index():
    from sink_attention_tpu_torch.serving.generate import topk_lowest_index
    x = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, -2.0, 0.0, -0.0]])
    vals, idx = topk_lowest_index(x, 6)
    assert idx.tolist() == [[1, 2, 4, 0, 6, 7]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0, 0.0, -0.0]]
    y = torch.randn(4, 1000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(topk_lowest_index(y, 9)[1], torch.topk(y, 9)[1])


# -- speculative decoding -----------------------------------------------------


def _spec_pair(window=16, draft_seed=5):
    g = torch.Generator().manual_seed(0)
    cfg = ModelConfig.tiny(num_layers=2, vocab_size=64,
                           sliding_window=window)
    dcfg = ModelConfig.tiny(num_layers=1, vocab_size=64,
                            sliding_window=window)
    params = init_params(cfg, g, device="cpu")
    dparams = init_params(dcfg, torch.Generator().manual_seed(draft_seed),
                          device="cpu")
    ids = torch.randint(0, 64, (1, 8), generator=g)
    return cfg, dcfg, params, dparams, ids


@pytest.mark.parametrize("case", ["perfect", "unrelated", "past_window"])
def test_speculative_generate_equals_greedy(case):
    """A perfect draft (the target itself: several tokens a pass), an
    unrelated one, and 24 tokens past a window of 8 with rejections every
    round (the full ring keeps its oldest live tokens)."""
    window, T = (8, 24) if case == "past_window" else (16, 8)
    cfg, dcfg, params, dparams, ids = _spec_pair(window)
    if case == "perfect":
        dcfg, dparams = cfg, params
    ref = greedy_generate(params, cfg, ids, T, **F32)
    stats = {}
    toks, rate = speculative_generate(params, dparams, cfg, dcfg, ids, T,
                                      num_draft_tokens=4, stats=stats, **F32)
    assert torch.equal(toks, ref)
    assert rate == stats["emitted"] / stats["rounds"]
    if case == "perfect":
        assert rate > 1.5
    else:
        assert rate < 4.0


def test_speculative_acceptance_rate_matches_jax():
    """A pair with partial acceptance (the draft is the target's layer 0
    with its embed and head), T=8: the tokens and the acceptance rate
    equal JAX's."""
    jcfg, tcfg, jp, tp = _jax_pair(0, num_layers=3, **SMALL)
    jd = {k: v for k, v in jp.items() if k != "layers"}
    jd["layers"] = [jp["layers"][0]]
    jdcfg = jm.ModelConfig.tiny(num_layers=1, **SMALL)
    tp, td = _damped(tp, 1.0)
    ids = np.array([[7, 1, 30, 11, 8, 4, 22]])
    tj, rj = j_spec(jp, jd, jcfg, jdcfg, jnp.asarray(ids), 8,
                    num_draft_tokens=4, dtype=jnp.float32)
    tt, rt = speculative_generate(tp, td, tcfg,
                                  ModelConfig.tiny(num_layers=1, **SMALL),
                                  torch.from_numpy(ids), 8,
                                  num_draft_tokens=4, **F32)
    assert tt.tolist() == np.asarray(tj).tolist()
    assert 1.0 < rt < 4.0 and rt == pytest.approx(float(rj), abs=1e-6)


# -- the speculative engine ----------------------------------------------------


def _engine_pair(num_layers, factor, window=16):
    cfg = ModelConfig.tiny(num_layers=num_layers,
                           **{**SMALL, "sliding_window": window})
    dcfg = ModelConfig.tiny(num_layers=1,
                            **{**SMALL, "sliding_window": window})
    params, draft = _damped(init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), factor)
    return cfg, dcfg, params, draft


def _spec_engine(params, cfg, draft, dcfg, **kw):
    kw = {"max_batch": 2, "max_len": 64, "prefill_bucket": 16,
          "num_draft_tokens": 4, **F32, **kw}
    return ContinuousBatchingEngine(params, cfg, draft_params=draft,
                                    draft_cfg=dcfg, **kw)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_spec_engine_equals_greedy(quant):
    """Three prompts in 2 slots (slot reuse), 24 tokens each past the
    window of 16 (ring wrap, the park branch of the counted commit), the
    target damped so rounds accept part of their drafts."""
    cfg, dcfg, params, draft = _engine_pair(3, 0.3)
    expected = [_greedy(params, cfg, p, 24, quant=quant) for p in PROMPTS]
    eng = _spec_engine(params, cfg, draft, dcfg, quant=quant)
    rids = [eng.submit(p, max_new_tokens=24) for p in PROMPTS]
    out = eng.run()
    assert [out[r] for r in rids] == expected
    assert eng.spec_tokens == 3 * 23          # the first tokens: prefill
    assert 1.0 < eng.spec_tokens / eng.spec_slot_rounds < 4.0
    assert eng.active_count == 0 and not eng.draft_caches[0].seen.any()


def test_spec_engine_full_ring_select_branch():
    """Window 128 and max_len 256: every cache's window_cap equals its
    window, so rejected tokens take the read-back select of the ragged
    commit; prompts of 140 and 131 tokens wrap the sliding ring."""
    cfg, dcfg, params, draft = _engine_pair(2, 0.3, window=128)
    prompts = [list(range(1, 61)) * 2 + [5] * 20, [9] * 131, [4, 2]]
    expected = [_greedy(params, cfg, p, 12) for p in prompts]
    eng = _spec_engine(params, cfg, draft, dcfg, max_len=256,
                       prefill_bucket=64)
    assert all(c.window_cap == c.window_size
               for c in eng.caches + eng.draft_caches)
    rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
    out = eng.run()
    assert [out[r] for r in rids] == expected


def test_spec_engine_eos_truncates_the_commit():
    """An EOS accepted mid-round ends the request there (JAX
    tests/test_continuous_batching.py:488)."""
    cfg, dcfg, params, draft = _engine_pair(2, 1.0)
    prompt = [5, 9, 2, 17]
    ref = _greedy(params, cfg, prompt, 16)
    eng = _spec_engine(params, cfg, draft, dcfg)
    rid = eng.submit(prompt, max_new_tokens=16, eos_id=ref[3])
    assert eng.run()[rid] == ref[:ref.index(ref[3]) + 1]


def test_spec_engine_refuses_plain_steps_and_sampling():
    cfg, dcfg, params, draft = _engine_pair(2, 1.0)
    eng = _spec_engine(params, cfg, draft, dcfg, max_batch=1)
    eng.submit([5, 9, 2], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="speculative"):
        eng.step()
    with pytest.raises(RuntimeError, match="speculative"):
        eng.step_chunk(2)
    assert all(len(t) == 4 for t in eng.run().values())
    with pytest.raises(ValueError, match="greedy"):
        eng.submit([1, 2], sampling=SamplingParams(temperature=0.5))
    with pytest.raises(ValueError, match="greedy"):
        _spec_engine(params, cfg, draft, dcfg,
                     sampling=SamplingParams(temperature=1.0))
    with pytest.raises(ValueError, match="draft_cfg"):
        ContinuousBatchingEngine(params, cfg, draft_params=draft, **F32)


def test_chip_smoke_spec_phase_on_cpu():
    """chip_smoke's phase 8 rehearsed on the CPU with the tiny config in
    fp32: its gates pass and no kernel was launched."""
    import chip_smoke
    rep, errors = chip_smoke.serve_spec(
        ModelConfig.tiny(), "cpu", prompt_len=40, beam_tokens=6,
        num_beams=3, spec_tokens=12, n_requests=3, max_batch=2, max_len=64,
        bucket=16, prompt=(8, 40), new=(4, 8), dtype=torch.float32)
    assert errors == []
    runs = [rep["beam"], rep["spec"]] + [
        r[name] for r in rep["engine"].values() for name in ("plain", "spec")]
    assert all(set(r["launches"].values()) == {0} for r in runs)
    assert rep["beam"]["steps"] == 5
    assert rep["spec"]["emitted"] >= 11 and len(rep["spec"]["multi_op"]) == 4
    for r in rep["engine"].values():
        assert r["spec"]["tokens"] == r["plain"]["tokens"]
        assert all(d["at"] is None for d in r["vs_plain"])


def test_spec_divergence_router_is_transparent_and_flips():
    """scripts/spec_divergence.py on a tiny MoE model: its Router leaves
    forward_prefill's logits as they are (no flip) and records every
    layer's router logits; a flip changes the routing of its token only,
    swapping one expert; ``record_engine`` records an engine's choice at
    every decoded position and layer; ``diagnose`` reports every generated
    position at every layer, margins sorted, the engines' choices against
    the teacher's, and the flips it tried. Its broken quantize (the
    gate's negative control) keeps the cache's codes and scales the
    scale; without CUDA ``main`` exits nonzero."""
    from sink_attention_tpu_torch.cache import quantize
    from sink_attention_tpu_torch.models import forward_prefill
    from sink_attention_tpu_torch.scripts import spec_divergence as sd

    cfg = ModelConfig.tiny(num_layers=2, vocab_size=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), **F32)
    prompt, gen = list(range(5, 25)), [7, 8, 9, 10]
    seq = torch.tensor([prompt + gen[:3]])
    orig = tmodel.moe_routing
    router = sd.Router(orig)
    tmodel.moe_routing = router
    try:
        with torch.inference_mode():
            got = forward_prefill(params, cfg, seq)[0]
    finally:
        tmodel.moe_routing = orig
    with torch.inference_mode():
        assert torch.equal(got, forward_prefill(params, cfg, seq)[0])
    assert len(router.logits) == cfg.num_layers
    margins = sd.router_margins(router.logits, cfg.experts_per_tok,
                                len(prompt))
    assert [m for m, *_ in margins] == sorted(m for m, *_ in margins)
    assert len(margins) == cfg.num_layers * 3
    mlp = params["layers"][0]["mlp"]
    xt = torch.randn(6, cfg.hidden_size,
                     generator=torch.Generator().manual_seed(1))
    router.logits, router.flip = [], (0, 4)
    flipped, plain = router(mlp, cfg, xt), orig(mlp, cfg, xt)
    assert (flipped != plain).any(-1).nonzero().flatten().tolist() == [4]
    assert int(((flipped[4] > 0) != (plain[4] > 0)).sum()) == 2
    assert torch.allclose(flipped.sum(-1), torch.ones(6))
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, max_len=64,
                                   prefill_bucket=16, **F32)
    rid = eng.submit(prompt, max_new_tokens=4)
    eng.submit([3, 4, 5], max_new_tokens=6)
    out, routes = sd.record_engine(eng, eng.run)
    gen = out[rid]
    mine = {k[1:]: c for k, c in routes.items() if k[0] == rid}
    for layer in range(cfg.num_layers):   # every decoded position
        assert all((layer, 20 + t) in mine for t in range(3))
    rep = sd.diagnose(params, cfg, prompt, gen, gen[:3] + [gen[3] + 1], 3,
                      "int8", 4, {"plain": mine, "spec": mine})
    assert rep["positions_x_layers"] == cfg.num_layers * 3
    assert rep["tried"] == 4 or rep["flip"] is not None
    assert rep["plain_below_best"] >= 0 and rep["spec_below_best"] >= 0
    for name in ("plain", "spec"):   # fp32 on the CPU: the same choices
        assert rep[f"{name}_routes"]["recorded"] == cfg.num_layers * 3
        assert rep[f"{name}_routes"]["differ"] == 0
        assert rep[f"{name}_routes"]["replayed_near_ties"] == {
            k: rep[k] for k in ("plain_below_best", "spec_below_best")}
    x = torch.randn(3, 2, 40, 16, generator=torch.Generator().manual_seed(2))
    for q in ("int8", "fp8"):
        (bc, bs), (c, sc) = sd.scaled_quantize(1.01)(x, q), quantize(x, q)
        assert torch.equal(bc, c) and torch.equal(bs, sc * 1.01)
    assert sd.main([]) == 1


def _gate_setup(n_new=6):
    cfg = ModelConfig.tiny(num_layers=2, vocab_size=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), **F32)
    prompt = list(range(5, 25))
    from sink_attention_tpu_torch.serving.divergence import record_generate
    toks, routes = record_generate(params, lambda: greedy_generate(
        params, cfg, torch.tensor([prompt]), n_new, **F32))
    mine = {k[1:]: c for k, c in routes.items() if k[0] == 0}
    return cfg, params, prompt, toks[0].tolist(), mine


def test_divergence_gate_refuses_a_token_off_the_teacher():
    """Phase 8's gate (serving.divergence.first_divergence,
    divergence_gate) on
    ModelConfig.tiny: a trajectory with one token forced off the teacher's
    choice, at a position with no near tie (fp32 on the CPU: the run's
    recorded expert choices are the teacher's up to there, and none of
    them lies at a near tie, so the replay imposes none), fails; the run
    that kept the teacher's tokens passes every token, and a trajectory
    equal to greedy passes."""
    from sink_attention_tpu_torch.models import forward_prefill
    from sink_attention_tpu_torch.serving.divergence import (
        divergence_gate, first_divergence)
    cfg, params, prompt, plain, routes = _gate_setup()
    at = 3
    with torch.inference_mode():
        row = forward_prefill(params, cfg, torch.tensor(
            [prompt + plain[:at]]))[0][0, -1]
    got = plain[:at] + [int(row.argmin())] + plain[at + 1:]
    div = first_divergence(params, cfg, prompt, plain, got, 7,
                           routes={"plain": routes, "spec": routes})
    assert div["at"] == at and div["control"] > 0
    assert div["plain"]["below_best"] == 0.0 and div["plain"]["off"] == []
    assert div["plain"]["checked"] == len(plain)
    # the forced token's run carries the plain run's recorded choices:
    # they differ after the forced token, and none lies at a near tie
    assert div["spec"]["imposed"] == 0
    assert div["spec"]["replayed_below"] == div["spec"]["below_best"] > (
        2 * div["control"])
    assert at in [o["token"] for o in div["spec"]["off"]]
    errors = []
    divergence_gate(div, "forced", errors)
    assert errors and all("spec run's token" in e for e in errors)
    assert any(f"token {at} lies" in e for e in errors)
    same = first_divergence(params, cfg, prompt, plain, plain, 7)
    errors = []
    divergence_gate(same, "same", errors)
    assert same == {"at": None} and errors == []


def test_near_tie_replay_imposes_only_near_ties(monkeypatch):
    """near_tie_replay imposes a run's recorded expert choice where it
    differs from the teacher's and lies within NEAR_TIE_ULPS of a router
    tie, and nowhere else: a choice flipped at a generated position is
    imposed once the threshold admits its margin, and moves the row."""
    from sink_attention_tpu_torch.serving import divergence
    cfg, params, prompt, plain, routes = _gate_setup(4)
    flipped = dict(routes)
    key = (0, len(prompt) + 1)   # layer 0: later layers attend to it
    flipped[key] = ~routes[key]
    rows, same, summ = divergence.near_tie_replay(params, cfg, prompt,
                                                  plain[:3], flipped)
    assert rows.shape == (4, cfg.vocab_size)
    assert summ["differ"] == 1 and summ["imposed"] == 0
    assert torch.equal(rows, same)
    monkeypatch.setattr(divergence, "NEAR_TIE_ULPS", float("inf"))
    rows2, moved, summ = divergence.near_tie_replay(params, cfg, prompt,
                                                    plain[:3], flipped)
    assert summ == {"recorded": cfg.num_layers * 3, "differ": 1,
                    "imposed": 1}
    assert torch.equal(rows, rows2)
    # rows up to the flipped position keep the teacher's logits
    assert torch.equal(rows[:2], moved[:2]) and not torch.equal(rows[2:],
                                                                moved[2:])


@pytest.mark.parametrize("factor", [1.0, 1.01])
def test_logit_gate_refuses_a_kv_scale_fault(factor):
    """Phase 8's logit gate (serving.divergence.logit_gate) on
    ModelConfig.tiny with an int8 KV cache: the plain engine against a
    speculative engine whose cache stores every K/V scale ``factor`` times
    the true one (scripts/spec_divergence.py's broken quantize). An honest
    engine (factor 1) passes every request at a ratio below 2; at 1.01
    (which leaves the greedy tokens where they were, so the token gate
    cannot see it) every request with compared positions is refused."""
    from sink_attention_tpu_torch.cache import sink_cache
    from sink_attention_tpu_torch.scripts import spec_divergence as sd
    from sink_attention_tpu_torch.serving.divergence import (
        draft_pair, engine_requests, logit_gate, record_engine)

    cfg = ModelConfig.tiny(num_layers=2, vocab_size=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), **F32)
    dparams, dcfg = draft_pair(params, cfg, 0.5)
    reqs = engine_requests(3, cfg.vocab_size, 0, prompt=(8, 20),
                           new=(6, 10))
    runs, rows = {}, {}
    shipped = sink_cache.quantize
    for name, extra in (("plain", {}), ("spec", dict(
            draft_params=dparams, draft_cfg=dcfg, num_draft_tokens=3))):
        if name == "spec":
            sink_cache.quantize = sd.scaled_quantize(factor)
        try:
            eng = ContinuousBatchingEngine(params, cfg, max_batch=2,
                                           max_len=64, prefill_bucket=16,
                                           quant="int8", **F32, **extra)
            rids = [eng.submit(p, max_new_tokens=m) for p, m in reqs]
            logits = {}
            out, _ = record_engine(eng, eng.run, logits=logits)
        finally:
            sink_cache.quantize = shipped
        runs[name] = [out[r] for r in rids]
        rows[name] = [{p: row for (rid, p), row in logits.items()
                       if rid == r} for r in rids]
    gates = [logit_gate(params, cfg, p, a, b, ra, rb, 6000 + i, "int8")
             for i, ((p, _), a, b, ra, rb) in enumerate(zip(
                 reqs, runs["plain"], runs["spec"], rows["plain"],
                 rows["spec"]))]
    assert all(g["compared"] > 0 for g in gates), gates
    if factor == 1.0:
        assert all(g["ok"] and g["ratio"] < 2.0 for g in gates), gates
    else:
        assert not any(g["ok"] for g in gates), gates
