"""The port's reference API (compat.py, serving/subprocess_eval.py) against
the JAX package's, on the CPU: tests/test_compat.py's scenarios on the same
numpy inputs (the mutable caches, the multi-layer flow through the
prefill and decode attention), SinkAttentionSPWrapper in a gloo world of 2
against JAX's halo SP in shard_map, and subprocess_generate on
ModelConfig.tiny's geometry: its tokens equal the port's in-process greedy
and JAX's on the same checkpoint, it falls back along the schedule it is
given, and by default it runs on the card alone (here: [])."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import _torch_sp_cases as cases
import sink_attention_tpu.compat as jc
from sink_attention_tpu.models import load_hf_checkpoint as jax_load
from sink_attention_tpu.serving import greedy_generate as jax_greedy
from sink_attention_tpu_torch import compat
from sink_attention_tpu_torch.models import (ModelConfig, init_params,
                                             load_hf_checkpoint)
from sink_attention_tpu_torch.scripts import export_random_hf_checkpoint
from sink_attention_tpu_torch.serving import greedy_generate

ATOL, RTOL = 1e-4, 1e-3


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def _token_kv(B, H, n, D, start=0):
    vals = np.arange(start, start + n, dtype=np.float32).reshape(1, 1, n, 1)
    k = np.broadcast_to(vals, (B, H, n, D)).copy()
    return k, k + 0.5


def test_compat_exports_the_reference_names():
    """All nine names of JAX compat.__all__, each defined."""
    assert compat.__all__ == jc.__all__
    assert all(hasattr(compat, n) for n in jc.__all__)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_cache_layer_matches_jax(quant):
    """SinkCacheLayer through a prefill, a decode step, a multi-token
    decode and a beam reorder, against JAX's on the same tokens: the K/V
    each update returns, the lengths, the seen count."""
    D = 8
    layers = (jc.SinkCacheLayer(2, 4, quant=quant),
              compat.SinkCacheLayer(2, 4, quant=quant))
    k, v = _token_kv(2, 2, 6, D)
    steps = [(k, v), _token_kv(2, 2, 1, D, start=6),
             _token_kv(2, 2, 2, D, start=7)]
    for kk, vv in steps:
        (jk, jv), (tk, tv) = (layer.update(*_both(kk)[i:i + 1],
                                           *_both(vv)[i:i + 1])
                              for i, layer in enumerate(layers))
        np.testing.assert_allclose(tk.float().numpy(), np.asarray(jk),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv),
                                   atol=ATOL, rtol=RTOL)
        for attr in ("get_seq_length", "get_mask_sizes",
                     "get_max_cache_shape"):
            assert getattr(layers[1], attr)() == getattr(layers[0], attr)()
        assert layers[1].seen_tokens == layers[0].seen_tokens
    for layer in layers:
        layer.reorder_cache([1, 1])
    (jk, _), (tk, _) = layers[0].get_kv(), layers[1].get_kv()
    np.testing.assert_allclose(tk.float().numpy(), np.asarray(jk),
                               atol=ATOL, rtol=RTOL)
    assert layers[1].functional.seen == 9 and layers[1].is_initialized


def test_multilayer_cache_and_generate_flow_matches_jax():
    """test_compat.py's flow: prefill through the multi-layer cache, the
    prefill attention over the K/V it returns, a decode step over the
    evicted cache; the port's outputs against JAX's."""
    rng = np.random.default_rng(0)
    B, H_q, H_kv, D = 1, 4, 2, 32
    k, v = (rng.standard_normal((B, H_kv, 12, D)).astype(np.float32)
            for _ in range(2))
    q = rng.standard_normal((B, H_q, 12, D)).astype(np.float32)
    s_aux = rng.standard_normal(H_q).astype(np.float32)
    k1, v1, q1 = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H_kv, 1, D), (B, H_kv, 1, D), (B, H_q, 1, D)))
    outs = []
    for mod, conv in ((jc, lambda x: _both(x)[0]), (compat,
                                                    lambda x: _both(x)[1])):
        cache = mod.SinkAttentionCache(num_sink=2, window_size=8)
        kf, vf = cache.update(conv(k), conv(v), layer_idx=0)
        cache.update(conv(k), conv(v), layer_idx=1)
        out = mod.sink_flash_attention(conv(q), kf, vf, num_sink=2,
                                       window_size=8, s_aux=conv(s_aux))
        kd, vd = cache.update(conv(k1), conv(v1), layer_idx=0)
        out1 = mod.sink_decode_attention(conv(q1), kd, vd, s_aux=conv(s_aux))
        outs.append((out, out1, len(cache), cache.seen_tokens,
                     cache.get_seq_length(1), cache.get_max_cache_length()))
    (jo, jo1, *jrest), (to, to1, *trest) = outs
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(to1.numpy(), np.asarray(jo1), atol=ATOL,
                               rtol=RTOL)
    assert trest == jrest == [2, 13, 10, 10]


def test_sp_wrapper_matches_jax_in_a_gloo_world(tmp_path):
    """SinkAttentionSPWrapper in a gloo world of 2 (forward and gradients,
    d s_aux summed over the ranks) against JAX's SinkAttentionSPWrapper
    call, halo SP in shard_map over 2 devices."""
    c = cases.case("wrapper", "wrapper", (1, 4, 2, 256, 64), 4, 64, 2,
                   grads=True, worlds=[2], atol=2e-4)
    arrs = cases.inputs(c, 7)
    started = cases.worker.start_worlds(
        [c], {f"wrapper/{k}": a for k, a in arrs.items()}, [2], str(tmp_path))
    jax_c = dict(c, fn="sp")
    assert jc.SinkAttentionSPWrapper(4, 64).axis_name == "seq"
    jax_out = {"wrapper": cases.jax_run(jax_c, arrs)}
    port = cases.worker.collect_worlds(started)
    cases.check_forward(port, jax_out, "wrapper", 2)
    cases.check_grads(port, jax_out, c, 2)


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_ckpt"))
    export_random_hf_checkpoint.export(
        path, export_random_hf_checkpoint.GEOMETRIES["tiny"], seed=3)
    return path


PROMPTS = [[1, 2, 3, 4], [7, 8]]


def test_subprocess_generate_matches_in_process_and_jax(tiny_checkpoint):
    """devices=("cpu",): the worker's tokens equal the port's in-process
    greedy over the same checkpoint, and JAX's greedy_generate over its
    own load of it (bf16 weights and caches on both sides)."""
    got = compat.subprocess_generate(PROMPTS, checkpoint=tiny_checkpoint,
                                     max_new_tokens=4, devices=("cpu",),
                                     verbose=False, timeout=300)
    cfg, params = load_hf_checkpoint(tiny_checkpoint, device="cpu")
    jcfg, jparams = jax_load(tiny_checkpoint, dtype=jnp.bfloat16)
    assert len(got) == len(PROMPTS)
    for prompt, toks in zip(PROMPTS, got):
        mine = greedy_generate(params, cfg, torch.tensor([prompt]), 4,
                               device="cpu")[0].tolist()
        ref = np.asarray(jax_greedy(jparams, jcfg,
                                    jnp.asarray([prompt], jnp.int32),
                                    max_new_tokens=4))[0].tolist()
        assert toks == mine == ref, (toks, mine, ref)


def test_subprocess_generate_follows_the_schedule_given():
    """("bogus", "cpu"): the first worker fails on its device, the second
    gives the CPU result, which equals the in-process greedy over the
    same seeded init (ModelConfig.tiny's widths)."""
    kw = dict(num_layers=1, vocab_size=64, sliding_window=8)
    cfg = ModelConfig.tiny(**kw)
    model_config = {f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "num_kv_heads", "head_dim", "intermediate_size", "num_experts",
        "experts_per_tok", "sliding_window", "rope_theta",
        "max_position_embeddings")}
    got = compat.subprocess_generate([[5, 6, 7]], model_config=model_config,
                                     max_new_tokens=3, seed=0,
                                     devices=("bogus", "cpu"), verbose=False,
                                     timeout=300)
    cfg = ModelConfig(**model_config)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device="cpu")
    mine = greedy_generate(params, cfg, torch.tensor([[5, 6, 7]]), 3,
                           device="cpu")[0].tolist()
    assert got == [mine]


def test_subprocess_generate_defaults_to_the_card():
    """The default schedule is the card alone: without CUDA every worker
    fails and the result is [] (the reference's total-failure contract),
    not a quiet run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default schedule runs")
    assert compat.subprocess_generate([[1]], model_config={"vocab_size": 64},
                                      max_new_tokens=2, verbose=False,
                                      timeout=300) == []
