"""The port's continuous-batching path against the JAX package's, on the
tiny config in fp32 with parameters carried over by params_from_jax:
forward_prefill(collect_kv=True), moe(active=), forward_decode_ragged over
fp32, int8 and fp8 ragged caches, and ContinuousBatchingEngine
(tokens, chunking, EOS, sampling, callbacks, the dense family)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.models as jm
import sink_attention_tpu.ops as jops
from sink_attention_tpu.models import model as jmodel
from sink_attention_tpu.serving import ContinuousBatchingEngine as JEngine
from sink_attention_tpu_torch.models import ModelConfig, params_from_jax
from sink_attention_tpu_torch.models import model as tmodel
from sink_attention_tpu_torch.serving import (ContinuousBatchingEngine,
                                              SamplingParams, greedy_generate)

# the JAX engine tests' model: 2 layers, sliding window 16, vocab 64
SMALL = dict(num_heads=4, num_kv_heads=2, head_dim=16, hidden_size=32,
             num_experts=2, sliding_window=16, vocab_size=64, num_layers=2)
PROMPTS = [[5, 9, 2], [7, 1, 30, 11, 8, 4, 22], [3] * 20]


def _pair(seed=0, family="tiny", **kw):
    jcfg = getattr(jm.ModelConfig, family)(**kw)
    tcfg = getattr(ModelConfig, family)(**kw)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engine(tp, tcfg, **kw):
    kw = {"max_batch": 2, "max_len": 64, "prefill_bucket": 16,
          "dtype": torch.float32, "device": "cpu", **kw}
    return ContinuousBatchingEngine(tp, tcfg, **kw)


def _serve(eng, prompts, **submit):
    rids = [eng.submit(p, **submit) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


LENS = [5, 19, 11]   # the ragged slots' prompt lengths


@functools.lru_cache(maxsize=None)
def _prefilled():
    """One JAX prefill (interpret mode is slow) shared by the tests below:
    3 right-padded prompts of LENS tokens, collect_kv=True."""
    jcfg, tcfg, jp, tp = _pair(1)
    seqs = np.random.RandomState(2).randint(0, tcfg.vocab_size, (3, 24))
    ids = np.zeros((3, 32), np.int64)
    for b, n in enumerate(LENS):
        ids[b, :n] = seqs[b, :n]
    lj, kj = jm.forward_prefill(jp, jcfg, jnp.asarray(ids), collect_kv=True)
    return jcfg, tcfg, jp, tp, seqs, ids, lj, kj


def test_collect_kv_and_moe_active_match_jax():
    jcfg, tcfg, jp, tp, _, ids, lj, kj = _prefilled()
    lt, kt = tmodel.forward_prefill(tp, tcfg, torch.from_numpy(ids),
                                    collect_kv=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    assert len(kt) == tcfg.num_layers
    for (k_t, v_t), (k_j, v_j) in zip(kt, kj):
        np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), atol=1e-5)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
    x = np.random.RandomState(1).randn(3, 1, tcfg.hidden_size).astype(
        np.float32)
    active = np.array([True, False, True])
    mlp_j, mlp_t = jp["layers"][0]["mlp"], tp["layers"][0]["mlp"]
    oj = jmodel.moe(mlp_j, jcfg, jnp.asarray(x), active=jnp.asarray(active))
    ot = tmodel.moe(mlp_t, tcfg, torch.from_numpy(x),
                    active=torch.from_numpy(active))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
    assert not ot[1].any()   # an inactive row routes to no expert


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_forward_decode_ragged_matches_jax(quant, monkeypatch):
    """Ragged decode logits against JAX's over 3 slots at different
    lengths, one going inactive. When quantized, the JAX decode attention
    runs over its cache's own dequant_kv(): its int8/fp8 kernel branches
    round q and p, the port computes attention over the dequantized cache
    (tests/test_torch_quant_cache.py holds the two to the JAX kernel's
    gap)."""
    jcfg, tcfg, jp, tp, seqs, ids, _, kj = _prefilled()
    B = len(LENS)
    jc = jm.make_ragged_caches(jcfg, B, 40, dtype=jnp.float32, quant=quant)
    tc = tmodel.make_ragged_caches(tcfg, B, 40, dtype=torch.float32,
                                   quant=quant, device="cpu")
    _, kt = tmodel.forward_prefill(tp, tcfg, torch.from_numpy(ids),
                                   collect_kv=True)
    for b, n in enumerate(LENS):
        jc = [c.insert(b, k[b], v[b], n) for c, (k, v) in zip(jc, kj)]
        for c, (k, v) in zip(tc, kt):
            c.insert(b, k[b], v[b], n)

    orig = jops.sink_decode_attention_ragged

    def over_dequantized(q, cache, s_aux=None, **kw):
        if cache.quant:
            kf, vf = cache.dequant_kv()
            cache = cache.replace(k=kf, v=vf, quant=None)
        return orig(q, cache, s_aux=s_aux, **kw)

    monkeypatch.setattr(jops, "sink_decode_attention_ragged",
                        over_dequantized)
    for t in range(2):
        act = np.array([True, t < 1, True])
        pos = np.array([n + t for n in LENS])
        toks = seqs[np.arange(B), pos][:, None]
        lt, tc = tmodel.forward_decode_ragged(
            tp, tcfg, torch.from_numpy(toks), tc,
            tc[0].seen.clone(), torch.from_numpy(act))
        lj, jc = jm.forward_decode_ragged(jp, jcfg, jnp.asarray(toks), jc,
                                          jc[0].seen, jnp.asarray(act))
        np.testing.assert_allclose(lt.numpy()[act], np.asarray(lj)[act],
                                   atol=1e-4, err_msg=f"step {t}")
        assert tc[0].seen.tolist() == np.asarray(jc[0].seen).tolist()
        assert (tc[0].seen.numpy() - pos)[act].tolist() == [1] * act.sum()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_engine_tokens_equal_greedy_generate(quant):
    """Engine tokens per request equal the port's greedy_generate, with
    fewer slots than requests (slot reuse) and a prompt longer than the
    window; unquantized, equal to the JAX engine's too."""
    jcfg, tcfg, jp, tp = _pair(0, **SMALL)
    prompts = PROMPTS + [list(range(1, 40))]
    expected = [greedy_generate(tp, tcfg, torch.tensor([p]), 8,
                                dtype=torch.float32, quant=quant,
                                device="cpu")[0].tolist() for p in prompts]
    got = _serve(_engine(tp, tcfg, quant=quant), prompts, max_new_tokens=8)
    assert got == expected
    if quant is None:
        eng = JEngine(jp, jcfg, max_batch=2, max_len=64, prefill_bucket=16,
                      dtype=jnp.float32)
        rids = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
        out = eng.run()
        assert [out[r] for r in rids] == got[:len(PROMPTS)]


def test_step_chunk_matches_step():
    _, tcfg, _, tp = _pair(0, **SMALL)

    def serve(chunk):
        eng = _engine(tp, tcfg, quant="fp8")
        rids = [eng.submit(p, max_new_tokens=9) for p in PROMPTS]
        out = eng.run(chunk=chunk)
        return [out[r] for r in rids], eng.pool_steps

    (one, steps_1), (four, steps_4) = serve(1), serve(4)
    assert one == four and all(len(t) == 9 for t in one)
    assert steps_1 == 2 * 8 and steps_4 == 2 * 8   # 3 requests, 2 slots
    eng = _engine(tp, tcfg)
    eng.submit(PROMPTS[0], max_new_tokens=5)
    first = eng.step()          # admits, then one decode step
    assert len(first) == 1 and eng.active_count == 1


def test_engine_eos_frees_slot():
    """EOS on a later token and EOS on the first token both end the
    request there and free its slot for the queue."""
    _, tcfg, _, tp = _pair(0, **SMALL)
    free = _serve(_engine(tp, tcfg, max_batch=1), PROMPTS[:2],
                  max_new_tokens=8)
    for chunk in (None, 1):
        eng = _engine(tp, tcfg, max_batch=1)
        r0 = eng.submit(PROMPTS[0], max_new_tokens=8, eos_id=free[0][3])
        r1 = eng.submit(PROMPTS[1], max_new_tokens=8, eos_id=free[1][0])
        out = eng.run(chunk=chunk)
        stop = free[0].index(free[0][3]) + 1
        assert out[r0] == free[0][:stop], chunk
        assert out[r1] == [free[1][0]], chunk
        assert eng.active_count == 0 and not eng._queue
        assert not eng.caches[0].seen.any()   # slots cleared


def test_engine_sampling_per_request():
    """A mixed pool: greedy slots keep their greedy tokens, top_k=1 equals
    greedy at any temperature, top_p sampling gives valid tokens; with
    top_k=2 every token is among the two highest logits of its step."""
    _, tcfg, _, tp = _pair(0, **SMALL)
    greedy = _serve(_engine(tp, tcfg, max_batch=3), PROMPTS,
                    max_new_tokens=8)
    eng = _engine(tp, tcfg, max_batch=3, seed=3)
    r0 = eng.submit(PROMPTS[0], max_new_tokens=8)
    r1 = eng.submit(PROMPTS[1], max_new_tokens=8,
                    sampling=SamplingParams(temperature=5.0, top_k=1))
    r2 = eng.submit(PROMPTS[2], max_new_tokens=8,
                    sampling=SamplingParams(temperature=1.0, top_p=0.9))
    out = eng.run()
    assert out[r0] == greedy[0] and out[r1] == greedy[1]
    assert len(out[r2]) == 8 and all(0 <= t < 64 for t in out[r2])

    eng = _engine(tp, tcfg, max_batch=1, seed=7)
    rid = eng.submit([4, 9, 11], max_new_tokens=12,
                     sampling=SamplingParams(temperature=1.0, top_k=2))
    toks = eng.run()[rid]
    seq = [4, 9, 11] + toks
    logits, _ = tmodel.forward_prefill(tp, tcfg, torch.tensor([seq]))
    for t, tok in enumerate(toks):
        top2 = logits[0, 2 + t].topk(2).indices.tolist()
        assert tok in top2, (t, tok, top2)
    assert len(set(toks)) > 1
    with pytest.raises(ValueError, match="candidate_k"):
        eng.submit([1], sampling=SamplingParams(top_k=65))


def test_engine_first_token_callback():
    _, tcfg, _, tp = _pair(0, **SMALL)
    for chunk in (None, 1):
        seen = {}
        eng = _engine(tp, tcfg, first_token_cb=lambda rid, tok:
                      seen.setdefault(rid, []).append(tok))
        rids = [eng.submit(p, max_new_tokens=5) for p in PROMPTS]
        out = eng.run(chunk=chunk)
        assert sorted(seen) == sorted(rids)
        assert all(seen[r] == [out[r][0]] for r in rids)


def test_engine_dense_family():
    jcfg, tcfg, jp, tp = _pair(5, family="qwen2_tiny")
    prompts = [[3, 7, 11], [9, 1, 4, 2, 8]]
    expected = [greedy_generate(tp, tcfg, torch.tensor([p]), 6,
                                dtype=torch.float32, device="cpu")[0].tolist()
                for p in prompts]
    assert _serve(_engine(tp, tcfg, quant="int8"), prompts,
                  max_new_tokens=6) == [
        greedy_generate(tp, tcfg, torch.tensor([p]), 6, dtype=torch.float32,
                        quant="int8", device="cpu")[0].tolist()
        for p in prompts]
    assert _serve(_engine(tp, tcfg), prompts, max_new_tokens=6) == expected


def test_chip_smoke_engine_phase_on_cpu():
    """chip_smoke's phase 6 rehearsed on the CPU with the tiny config: its
    checks pass and no kernel was launched."""
    import chip_smoke
    rep, errors = chip_smoke.serve_engine(
        ModelConfig.tiny(), "cpu", max_len=64, bucket=16, prompt=(8, 40),
        new=(4, 8), replay_steps=4, dtype=torch.float32)
    assert errors == []
    for label in ("int8", "fp8", "float32"):
        r = rep[label]
        assert set(r["launches"].values()) == {0}
        assert r["tokens"] == sum(rep["max_new_tokens"])
        assert r["decode_layers_checked"] == 2 * 4
        assert r["decode_layer_min_cos"] > 0.9999
    assert rep["int8"]["kv_bytes"] * 4 == rep["float32"]["kv_bytes"]
