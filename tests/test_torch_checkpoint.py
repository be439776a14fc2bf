"""The port's checkpointing (utils/checkpoint.py) and the engine's
save_state/load_state, on the CPU: parameter trees (fp32, bf16, int8,
int4) round trip bit for bit, a template sets dtype and device; a rolling
cache saved mid-generation comes back as its fields and resumes; an engine
snapshot taken mid-serving resumes in a fresh engine to exactly the tokens
of the uninterrupted run, greedy (also JAX's engine's) and sampled, plain
and speculative (the JAX tests test_checkpoint.py and
test_continuous_batching.py's resume tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sink_attention_tpu.models as jm
from sink_attention_tpu.cache import SinkKVCache as JCache
from sink_attention_tpu.serving import ContinuousBatchingEngine as JEngine
from sink_attention_tpu_torch.cache import SinkKVCache
from sink_attention_tpu_torch.models import (ModelConfig, init_params,
                                             init_quantized_params,
                                             params_from_jax,
                                             quantize_params)
from sink_attention_tpu_torch.serving import (ContinuousBatchingEngine,
                                              SamplingParams)
from sink_attention_tpu_torch.utils import checkpoint as ckpt

CPU = dict(device="cpu")
# the JAX engine tests' model
ENGINE_CFG = dict(num_heads=4, num_kv_heads=2, head_dim=16, hidden_size=32,
                  num_experts=2, sliding_window=16, vocab_size=64,
                  num_layers=2)
ENGINE_KW = dict(max_batch=2, max_len=64, prefill_bucket=16,
                 dtype=torch.float32, device="cpu")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_same(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for path, x in la.items():
        y = lb[path]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, path
            assert torch.equal(x, y), path
        else:
            assert x == y, path


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("form", ["float32", "bfloat16", "int8", "int4"])
def test_params_roundtrip(tmp_path, form):
    cfg = ModelConfig.tiny()
    dtype = torch.bfloat16 if form == "bfloat16" else torch.float32
    gen = torch.Generator().manual_seed(0)
    if form == "int4":
        params = init_quantized_params(cfg, gen, bits=4, **CPU)
    else:
        params = init_params(cfg, gen, dtype=dtype, **CPU)
    if form == "int8":
        params = quantize_params(params)
    path = str(tmp_path / "params.pt")
    ckpt.save_params(path, params)
    restored = ckpt.restore_params(path, **CPU)
    _assert_same(restored, params)
    # a restored tree owns its memory: it survives the file's overwrite
    ckpt.save(path, {"other": torch.zeros(3)})
    _assert_same(restored, params)


def test_restore_template_sets_dtype_and_device(tmp_path):
    cfg = ModelConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(1), **CPU)
    path = str(tmp_path / "params.pt")
    ckpt.save(path, params)
    template = _map(lambda t: torch.empty(0, dtype=torch.bfloat16), params)
    restored = ckpt.restore(path, template)
    want = _map(lambda t: t.to(torch.bfloat16), params)
    _assert_same(restored, want)
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore(path, {"embed": template["embed"]})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ckpt.restore(path)


def test_cache_roundtrip_mid_generation(tmp_path):
    """A SinkKVCache saved after a prefill past its window and an append
    comes back as its fields by name; copied into a fresh cache it appends
    on as the original does. Its state equals the JAX cache's."""
    k = np.random.default_rng(0).standard_normal((1, 2, 12, 16)).astype(
        np.float32)
    cache = SinkKVCache.init(1, 2, 16, num_sink=2, window_size=8,
                             dtype=torch.float32, **CPU)
    tk = torch.from_numpy(k)
    cache.prefill(tk, tk + 1).append(tk[:, :, :1], tk[:, :, :1])
    path = str(tmp_path / "cache.pt")
    ckpt.save(path, cache)
    fields = ckpt.restore(path, **CPU)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(fields[name], getattr(cache, name)), name
    jc = JCache.init(1, 2, 16, num_sink=2, window_size=8, dtype=jnp.float32)
    jc = jc.prefill(jnp.asarray(k), jnp.asarray(k) + 1)
    jc = jc.append(jnp.asarray(k[:, :, :1]), jnp.asarray(k[:, :, :1]))
    for name in ("sink_len", "window_len", "write_pos", "seen"):
        assert fields[name] == getattr(cache, name) == int(getattr(jc, name))
    fresh = SinkKVCache.init(1, 2, 16, num_sink=2, window_size=8,
                             dtype=torch.float32, **CPU)
    fresh.load_state_dict(fields)
    nxt = tk[:, :, 5:6]
    cache.append(nxt, nxt)
    fresh.append(nxt, nxt)
    assert set(fields) == set(vars(fresh))
    for name, a in vars(cache).items():
        b = getattr(fresh, name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    other = SinkKVCache.init(1, 2, 16, num_sink=2, window_size=16,
                             dtype=torch.float32, **CPU)
    with pytest.raises(ValueError, match="window_size"):
        other.load_state_dict(fields)
    with pytest.raises(ValueError, match="fields"):
        fresh.load_state_dict({k: v for k, v in fields.items()
                               if k != "seen"})


def _engine_params():
    jcfg = jm.ModelConfig.tiny(**ENGINE_CFG)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), **CPU)
    return jcfg, jparams, ModelConfig.tiny(**ENGINE_CFG), params


def _submit_all(eng):
    r0 = eng.submit([5, 9, 2], max_new_tokens=10)
    r1 = eng.submit([7, 1, 3], max_new_tokens=10,
                    sampling=SamplingParams(temperature=1.0, top_k=4))
    return r0, r1


def test_engine_checkpoint_resume(tmp_path):
    """Snapshot after 4 steps, resume into a FRESH engine: exactly the
    tokens of the uninterrupted run, greedy and sampled (the generator's
    state is in the snapshot); the greedy request's are JAX's engine's
    too."""
    jcfg, jparams, cfg, params = _engine_params()
    eng_a = ContinuousBatchingEngine(params, cfg, seed=3, **ENGINE_KW)
    ra = _submit_all(eng_a)
    for _ in range(4):
        eng_a.step()
    rest_a = eng_a.run(chunk=1)

    eng_b = ContinuousBatchingEngine(params, cfg, seed=3, **ENGINE_KW)
    rb = _submit_all(eng_b)
    for _ in range(4):
        eng_b.step()
    snap = str(tmp_path / "snap")
    eng_b.save_state(snap)
    eng_c = ContinuousBatchingEngine(params, cfg, seed=3, **ENGINE_KW)
    caches = [(c.k, c.seen) for c in eng_c.caches]
    eng_c.load_state(snap)
    # the fresh engine's own tensors, written in place
    assert all(c.k is k and c.seen is s
               for c, (k, s) in zip(eng_c.caches, caches))
    rest_c = eng_c.run(chunk=1)
    assert rest_a[ra[0]] == rest_c[rb[0]] and len(rest_c[rb[0]]) == 10
    assert rest_a[ra[1]] == rest_c[rb[1]] and len(rest_c[rb[1]]) == 10

    jeng = JEngine(jparams, jcfg, max_batch=2, max_len=64,
                   prefill_bucket=16, dtype=jnp.float32)
    jr = jeng.submit([5, 9, 2], max_new_tokens=10)
    assert jeng.run()[jr] == rest_c[rb[0]]


def _spec_setup():
    cfg = ModelConfig.tiny(**ENGINE_CFG)
    cfg_d = ModelConfig.tiny(**dict(ENGINE_CFG, num_layers=1))
    params = init_params(cfg, torch.Generator().manual_seed(0), **CPU)
    dparams = {k: v for k, v in params.items() if k != "layers"}
    dparams["layers"] = [params["layers"][0]]
    kw = dict(ENGINE_KW, draft_params=dparams, draft_cfg=cfg_d,
              num_draft_tokens=4)
    return cfg, params, kw


def test_engine_speculative_checkpoint_resume(tmp_path):
    """A speculative engine's snapshot holds its draft caches: restored into
    a fresh speculative engine they equal the interrupted engine's, and
    the run ends with the uninterrupted run's tokens."""
    cfg, params, kw = _spec_setup()
    prompts = [[5, 9, 2], [7, 1, 30, 11]]
    eng_a = ContinuousBatchingEngine(params, cfg, **kw)
    ra = [eng_a.submit(p, max_new_tokens=12) for p in prompts]
    eng_a.step_spec_chunk(2)
    rest_a = eng_a.run()

    eng_b = ContinuousBatchingEngine(params, cfg, **kw)
    rb = [eng_b.submit(p, max_new_tokens=12) for p in prompts]
    eng_b.step_spec_chunk(2)
    snap = str(tmp_path / "spec_snap")
    eng_b.save_state(snap)
    eng_c = ContinuousBatchingEngine(params, cfg, **kw)
    eng_c.load_state(snap)
    for want, got in zip(eng_b.draft_caches, eng_c.draft_caches):
        for name, a in vars(want).items():
            b = getattr(got, name)
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), name
    rest_c = eng_c.run()
    for a, b in zip(ra, rb):
        assert rest_a[a] == rest_c[b] and len(rest_c[b]) == 12


def test_speculative_engine_refuses_a_plain_snapshot(tmp_path):
    """A snapshot without draft caches does not load into a speculative
    engine (JAX's ValueError)."""
    cfg, params, kw = _spec_setup()
    plain = ContinuousBatchingEngine(params, cfg, **ENGINE_KW)
    plain.submit([5, 9, 2], max_new_tokens=4)
    plain.step()
    snap = str(tmp_path / "plain_snap")
    plain.save_state(snap)
    spec = ContinuousBatchingEngine(params, cfg, **kw)
    with pytest.raises(ValueError, match="draft-cache"):
        spec.load_state(snap)
