"""The port's gpt-oss model and greedy serving against the JAX package's,
on the tiny config in fp32 with parameters carried over by params_from_jax.
On the CPU the port's attention runs the kernels' plain versions; the JAX
side runs its Pallas kernels in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.models as jm
from sink_attention_tpu.models import model as jmodel
from sink_attention_tpu.serving import greedy_generate as j_greedy
from sink_attention_tpu_torch.models import ModelConfig, params_from_jax
from sink_attention_tpu_torch.models import model as tmodel
from sink_attention_tpu_torch.serving import greedy_generate as t_greedy


def _pair(seed=0, **kw):
    jcfg = jm.ModelConfig.tiny(**kw)
    tcfg = ModelConfig.tiny(**kw)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _ids(seed, B, N, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, N))


def test_prefill_logits_match_jax():
    jcfg, tcfg, jp, tp = _pair()
    ids = _ids(0, 2, 40, tcfg.vocab_size)  # N > sliding_window
    lj, _ = jm.forward_prefill(jp, jcfg, jnp.asarray(ids))
    lt, _ = tmodel.forward_prefill(tp, tcfg, torch.from_numpy(ids))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


def test_decode_logits_match_jax_past_window():
    jcfg, tcfg, jp, tp = _pair(1)
    B, N, steps = 2, 12, 8          # positions 12..19 pass sliding_window=16
    ids = _ids(1, B, N + steps, tcfg.vocab_size)
    jc = jm.make_caches(jcfg, B, max_len=N + steps, dtype=jnp.float32)
    _, jc = jm.forward_prefill(jp, jcfg, jnp.asarray(ids[:, :N]), jc)
    tc = tmodel.make_caches(tcfg, B, max_len=N + steps, dtype=torch.float32,
                            device="cpu")
    _, tc = tmodel.forward_prefill(tp, tcfg, torch.from_numpy(ids[:, :N]), tc)
    for t in range(N, N + steps):
        lj, jc = jm.forward_decode(jp, jcfg, jnp.asarray(ids[:, t:t + 1]),
                                   jc, position=t)
        lt, tc = tmodel.forward_decode(tp, tcfg,
                                       torch.from_numpy(ids[:, t:t + 1]), tc,
                                       position=t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   err_msg=f"position {t}")
    assert tc[0].window_len == tcfg.sliding_window  # the ring did wrap


def test_greedy_generate_tokens_equal_jax():
    jcfg, tcfg, jp, tp = _pair(2)
    ids = _ids(2, 2, 24, tcfg.vocab_size)
    tj = np.asarray(j_greedy(jp, jcfg, jnp.asarray(ids), max_new_tokens=8,
                             dtype=jnp.float32))
    tt = t_greedy(tp, tcfg, torch.from_numpy(ids), max_new_tokens=8,
                  dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), tj)


def test_yarn_rope_matches_jax():
    jcfg = jm.ModelConfig.gpt_oss_20b()
    tcfg = ModelConfig.gpt_oss_20b()
    # The serving path's positions (a 1024-token prompt + 32 new tokens).
    # The fp32 angle reaches ~1056 rad there, where one ulp is 1.2e-4 rad:
    # XLA's and PyTorch's cos/sin differ by ~1e-5 (times mscale 1.35).
    pos = np.arange(0, 1056)
    cj, sj = jmodel.rope_cos_sin(jcfg, jnp.asarray(pos))
    ct, st = tmodel.rope_cos_sin(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-5)
    fj, mj = jmodel._yarn_inv_freq(jcfg)
    ft, mt = tmodel._yarn_inv_freq(tcfg)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6)
    assert mt == mj


@pytest.mark.parametrize("T", [1, 3, 8, 12])
def test_moe_matches_jax(T):
    """Both MoE formulations (grouped for T <= 8, dense beyond) against
    JAX, and the grouped one against the dense one."""
    jcfg, tcfg, jp, tp = _pair(3, num_experts=8, experts_per_tok=2,
                               hidden_size=32, num_layers=1)
    x = np.random.RandomState(T).randn(1, T, 32).astype(np.float32)
    oj = jmodel.moe(jp["layers"][0]["mlp"], jcfg, jnp.asarray(x))
    mlp = tp["layers"][0]["mlp"]
    ot = tmodel.moe(mlp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
    other = dataclasses.replace(
        tcfg, moe_grouped_token_limit=0 if T <= 8 else 16)
    np.testing.assert_allclose(
        tmodel.moe(mlp, other, torch.from_numpy(x)).numpy(), ot.numpy(),
        atol=1e-5)


def test_dense_family_prefill_matches_jax():
    jcfg = jm.ModelConfig.qwen2_tiny()
    tcfg = ModelConfig.qwen2_tiny()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ids = _ids(4, 1, 20, tcfg.vocab_size)
    lj, _ = jm.forward_prefill(jp, jcfg, jnp.asarray(ids))
    lt, _ = tmodel.forward_prefill(tp, tcfg, torch.from_numpy(ids))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


def test_chip_smoke_serving_phase_on_cpu():
    """chip_smoke's serving phase, rehearsed on the CPU with the tiny
    config: its checks pass and no kernel was launched."""
    import chip_smoke
    rep, errors = chip_smoke.serve(ModelConfig.tiny(), "cpu", batch=2,
                                      prompt_len=24, new_tokens=8,
                                      dtype=torch.float32)
    assert errors == []
    assert rep["launches"] == {"flash_fwd": 0, "decode": 0}
    assert rep["replay_token_agreement"] == 1.0
    assert rep["plain_all_cos"] > 0.9999
    assert rep["teacher_all_cos"] > 0.9999
    assert rep["prefill_layers_checked"] == 2
    assert rep["decode_layers_checked"] == 2 * 7
