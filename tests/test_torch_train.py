"""The port's training step against the JAX package's, on tiny configs in
fp32 with parameters carried over by params_from_jax. On the CPU the
port's attention runs the kernels' plain versions (forward and backward);
the JAX side runs its Pallas kernels in interpret mode, jitted."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.models as jm
from sink_attention_tpu.parallel import train as jtrain
from sink_attention_tpu_torch.models import ModelConfig, params_from_jax
from sink_attention_tpu_torch.ops import flash
from sink_attention_tpu_torch.parallel import (cross_entropy_loss,
                                               make_train_step, param_leaves)

FAMILIES = {"gpt_oss": "tiny", "qwen2": "qwen2_tiny"}


def _pair(family, seed=0):
    jcfg = getattr(jm.ModelConfig, FAMILIES[family])()
    tcfg = getattr(ModelConfig, FAMILIES[family])()
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(seed, B, N, vocab):
    """B sequences of N + 1 tokens (N > the sliding window of 16; B * N
    above the MoE's grouped-token limit, so the dense expert path runs)."""
    return np.random.RandomState(seed).randint(0, vocab, (B, N + 1))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_grad_tree_match_jax(family):
    jcfg, tcfg, jp, tp = _pair(family)
    batch = _batch(0, 2, 32, tcfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.cross_entropy_loss(p, jcfg, b)))(
            jp, jnp.asarray(batch))
    leaves = param_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss = cross_entropy_loss(tp, tcfg, torch.from_numpy(batch))
    # unused leaves (qwen2's o_proj bias) get zeros, as in JAX
    grads = torch.autograd.grad(tloss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, jleaves)):  # fp32, O(0.1) grads
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=1e-4, err_msg=f"leaf {i}")


def test_sgd_step_matches_jax():
    """One SGD(1e-2) step against the JAX step on a 1x1x1 mesh."""
    jcfg, tcfg, jp, tp = _pair("gpt_oss", 1)
    batch = _batch(1, 2, 32, tcfg.vocab_size)
    opt = optax.sgd(1e-2)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("data", "seq", "model"))
    jstep, shardings = jtrain.make_train_step(jcfg, mesh, opt)
    with mesh:
        p = jax.device_put(jp, shardings)
        new_jp, _, jloss = jstep(p, opt.init(p), jnp.asarray(batch))
    step = make_train_step(tcfg, torch.optim.SGD(param_leaves(tp), lr=1e-2))
    tloss = step(tp, torch.from_numpy(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for t, r in zip(param_leaves(tp), jax.tree_util.tree_leaves(new_jp)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(r),
                                   atol=1e-5)


def test_remat_and_accum_match_plain_step():
    """Checkpointed layers and 4-microbatch accumulation reproduce the
    plain step's loss and updated parameters (remat changes scheduling,
    not math; the mean of equal microbatches' means is the batch mean).
    Tolerances are the JAX suite's."""
    _, tcfg, _, params = _pair("gpt_oss", 2)
    batch = torch.from_numpy(_batch(2, 8, 16, tcfg.vocab_size))

    def run(**kw):
        p = copy.deepcopy(params)
        step = make_train_step(tcfg, torch.optim.SGD(param_leaves(p),
                                                     lr=1e-2), **kw)
        return float(step(p, batch)), param_leaves(p)

    loss0, p0 = run()
    loss_r, p_r = run(remat=True)
    loss_a, p_a = run(accum_steps=4)
    np.testing.assert_allclose(loss_r, loss0, rtol=1e-6)
    np.testing.assert_allclose(loss_a, loss0, rtol=1e-5)
    for got, tol in ((p_r, 1e-6), (p_a, 1e-5)):
        for a, b in zip(p0, got):
            np.testing.assert_allclose(b.detach().numpy(),
                                       a.detach().numpy(), atol=tol,
                                       rtol=tol)


def test_remat_recomputes_attention_once_per_layer():
    """Under remat the backward reruns each layer's forward: the attention
    forward runs twice per layer and its backward once, and the
    gradients equal those without remat."""
    _, tcfg, _, params = _pair("gpt_oss", 3)
    batch = torch.from_numpy(_batch(3, 2, 24, tcfg.vocab_size))
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    calls = {"fwd": 0, "bwd": 0}

    def counted(q, k, v, **kw):
        calls["fwd"] += 1
        out = flash.sink_flash_attention(q, k, v, **kw)
        out.register_hook(lambda g: calls.__setitem__("bwd",
                                                      calls["bwd"] + 1))
        return out

    grads = {}
    for remat in (False, True):
        loss = cross_entropy_loss(params, tcfg, batch, attn_impl=counted,
                                  remat=remat)
        assert calls["fwd"] == tcfg.num_layers
        grads[remat] = torch.autograd.grad(loss, leaves)
        assert calls == {"fwd": tcfg.num_layers * (2 if remat else 1),
                         "bwd": tcfg.num_layers}
        calls.update(fwd=0, bwd=0)
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_chip_smoke_training_phase_on_cpu():
    """chip_smoke's training phase, rehearsed on the CPU with the tiny
    config: its checks pass, the loss falls, no kernel was launched."""
    import chip_smoke
    rep, errors = chip_smoke.train(ModelConfig.tiny(), "cpu", seq_len=48,
                                   steps=3, dtype=torch.float32)
    assert errors == []
    assert rep["launches"] == {"flash_fwd": 0, "flash_dq": 0,
                               "flash_dkdv": 0}
    assert rep["losses"][-1] < rep["losses"][0]
    assert rep["layers_checked"] == ModelConfig.tiny().num_layers
    assert rep["layer_min_cos"] > 0.9999
