"""The port's packed-batch model forward and training loss against the JAX
package's, on tiny configs in fp32 with parameters carried over by
params_from_jax. On the CPU the port's packed attention runs the packed
kernels' plain versions; the JAX side runs its Pallas packed kernels in
interpret mode, jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.models as jm
from sink_attention_tpu.ops.packed import (
    sink_flash_attention_packed as j_packed)
from sink_attention_tpu.parallel import train as jtrain
from sink_attention_tpu_torch.models import (ModelConfig, forward_prefill,
                                             params_from_jax)
from sink_attention_tpu_torch.ops import sink_flash_attention_packed
from sink_attention_tpu_torch.parallel import (cross_entropy_loss_packed,
                                               param_leaves)

FAMILIES = {"gpt_oss": "tiny", "qwen2": "qwen2_tiny"}
SEGMENTS = ([24, 40], [10, 30, 24])  # per batch row, N = 64 (> window 16)


def _pair(family, seed=0):
    jcfg = getattr(jm.ModelConfig, FAMILIES[family])()
    tcfg = getattr(ModelConfig, FAMILIES[family])()
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _positions(rows):
    return np.array([[p for L in segs for p in range(L)] for segs in rows],
                    np.int32)


def _ids(seed, B, N, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, N))


def _j_attn(pos):
    def attn(q, k, v, *, num_sink, window_size, s_aux):
        return j_packed(q, k, v, pos, num_sink, window_size, s_aux=s_aux,
                        block_q=32, block_kv=32)
    return attn


def _t_attn(pos):
    def attn(q, k, v, *, num_sink, window_size, s_aux):
        return sink_flash_attention_packed(q, k, v, pos, num_sink,
                                           window_size, s_aux=s_aux)
    return attn


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("per_row", [False, True], ids=["pos[N]", "pos[B,N]"])
def test_packed_prefill_matches_jax(family, per_row):
    """forward_prefill(positions=) with a packed attention: RoPE from [N]
    positions (one pack layout for every row) or [B, N] (one per row), with
    and without remat, against the JAX forward."""
    jcfg, tcfg, jp, tp = _pair(family)
    pos = _positions(SEGMENTS if per_row else SEGMENTS[:1] * 2)
    rope_pos = pos if per_row else pos[0]
    ids = _ids(1, 2, pos.shape[1], tcfg.vocab_size)
    ref = jax.jit(lambda p, i: jm.forward_prefill(
        p, jcfg, i, positions=jnp.asarray(rope_pos),
        attn_impl=_j_attn(jnp.asarray(pos)))[0])(jp, jnp.asarray(ids))
    for remat in (False, True):
        out, _ = forward_prefill(tp, tcfg, torch.from_numpy(ids),
                                 positions=torch.from_numpy(rope_pos),
                                 attn_impl=_t_attn(torch.from_numpy(pos)),
                                 remat=remat)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   atol=1e-4, err_msg=f"remat={remat}")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_packed_loss_and_grad_tree_match_jax(family):
    jcfg, tcfg, jp, tp = _pair(family, 1)
    pos = _positions(SEGMENTS)
    ids = _ids(2, 2, pos.shape[1], tcfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.cross_entropy_loss_packed(
            p, jcfg, b, jnp.asarray(pos))))(jp, jnp.asarray(ids))
    leaves = param_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss = cross_entropy_loss_packed(tp, tcfg, torch.from_numpy(ids),
                                      torch.from_numpy(pos))
    grads = torch.autograd.grad(tloss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, jleaves)):  # the tolerances of
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=1e-4, err_msg=f"leaf {i}")  # train


def test_packed_forward_equals_separate_forwards():
    """The packed forward (packed attention + segment-local RoPE) equals a
    forward of each segment alone (tests/test_packed.py's model-level
    check and tolerance)."""
    cfg = ModelConfig.tiny(num_layers=2, vocab_size=64, sliding_window=16)
    params = jm.init_params(jm.ModelConfig.tiny(
        num_layers=2, vocab_size=64, sliding_window=16),
        jax.random.PRNGKey(7), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    segs = SEGMENTS[0]
    pos = torch.from_numpy(_positions([segs]))
    ids = torch.from_numpy(_ids(8, 1, pos.shape[1], 64))
    packed, _ = forward_prefill(params, cfg, ids, positions=pos[0],
                                attn_impl=_t_attn(pos))
    off = 0
    for L in segs:
        alone, _ = forward_prefill(params, cfg, ids[:, off:off + L])
        torch.testing.assert_close(packed[:, off:off + L], alone, atol=2e-4,
                                   rtol=1e-3)
        off += L


def test_chip_smoke_packed_training_phase_on_cpu():
    """chip_smoke's packed training phase, rehearsed on the CPU with the
    tiny config: its checks pass, the loss falls, no kernel was launched."""
    import chip_smoke
    cfg = ModelConfig.tiny()
    rep, errors = chip_smoke.train_packed(cfg, "cpu", seq_len=96, steps=3,
                                          dtype=torch.float32, min_len=8,
                                          max_len=40)
    assert errors == []
    assert set(rep["launches"].values()) == {0}
    assert sum(rep["segment_lengths"]) == 96
    assert len(rep["segments"]) == len(rep["segment_lengths"])
    assert rep["valid_targets"] == 96 - len(rep["segment_lengths"])
    assert rep["losses"][-1] < rep["losses"][0]
    assert rep["layers_checked"] == cfg.num_layers
    assert rep["layer_min_cos"] > 0.9999
