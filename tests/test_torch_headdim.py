"""Head dims other than 64 and 128: the port against the JAX package.

The CUDA kernels run any head_dim up to 512 in their 64-, 128-, 256- and
512-wide instances (``ops._build.kernel_head_dim``, the host tables' key;
the forward and dK/dV compute D 65-96 in narrow 80- and 96-wide instances
on the 128 instance's tiles) and pad a head_dim whose rows are not whole 16
bytes (``padded_head_dim``): that rule is pure Python and is checked here. On the CPU the port runs the kernels' plain versions; they
are held to the JAX kernels (interpret mode) at D in (16, 32, 80, 96, 100) in
the forward, the backward, the packed path and the decode, at the JAX
tests' CPU tolerances, and a narrow H2O-Danube-shaped model (Mistral
family, head_dim 80, GQA 4:1, every layer sliding) built by
``from_hf_config`` is held to JAX's: the logits, 8 decode steps, and one
training step's loss and gradients, unpacked and packed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.models as jm
from sink_attention_tpu.cache import SinkKVCache as JCache
from sink_attention_tpu.ops import flash as jflash
from sink_attention_tpu.ops import sink_decode_attention_cached as j_decode
from sink_attention_tpu.ops.packed import (
    sink_flash_attention_packed as j_packed)
from sink_attention_tpu.parallel import train as jtrain
from sink_attention_tpu_torch.cache import SinkKVCache as TCache
from sink_attention_tpu_torch.models import (ModelConfig, forward_decode,
                                             forward_prefill, make_caches,
                                             params_from_jax)
from sink_attention_tpu_torch.ops import _build, flash, packed
from sink_attention_tpu_torch.ops import decode as tdec
from sink_attention_tpu_torch.parallel import (cross_entropy_loss,
                                               cross_entropy_loss_packed,
                                               param_leaves)

DIMS = (16, 32, 80, 96, 100)


def test_kernel_head_dim_rule():
    """D -> D_i: the smallest instance (64, 128, 256, 512) that holds D;
    every D above 512 (513, 520, 768 among them) the one wide instance;
    only D <= 0 raises (the message names the rule)."""
    for d in range(1, 513):
        assert _build.kernel_head_dim(d) == (64 if d <= 64 else
                                             128 if d <= 128 else
                                             256 if d <= 256 else 512)
    for d in (513, 520, 768, 4096):
        assert _build.kernel_head_dim(d) == _build.WIDE_INSTANCE
    for d in (0, -1):
        with pytest.raises(ValueError, match="head_dim >= 1"):
            _build.kernel_head_dim(d)


def test_padded_copy_rule():
    """Whole 16-byte rows: 8 bf16/fp16 elements, 16 int8 codes, 4 fp32;
    ``kernel_operands`` pads (zeros) and rounds fp32 to bf16 with the
    dtype code, and copies nothing for a D that needs no pad."""
    assert [_build.padded_head_dim(d) for d in (16, 32, 80, 100, 126)] == [
        16, 32, 80, 104, 128]
    assert [_build.padded_head_dim(d, 1) for d in (32, 80, 100)] == [
        32, 80, 112]
    assert [_build.padded_head_dim(d, 4) for d in (80, 98, 100)] == [
        80, 100, 100]
    x = torch.randn(1, 2, 8, 100)
    (op,), code, d_pad = _build.kernel_operands(x)
    assert (code, d_pad, op.dtype, op.shape[-1]) == (2, 104, torch.bfloat16,
                                                     104)
    assert torch.equal(op[..., :100], x.to(torch.bfloat16))
    assert not op[..., 100:].any()
    for dtype, want in ((torch.bfloat16, 0), (torch.float16, 1)):
        y = torch.randn(1, 2, 8, 80).to(dtype)
        (op,), code, d_pad = _build.kernel_operands(y)
        assert (code, d_pad) == (want, 80) and op.data_ptr() == y.data_ptr()


def test_tables_key_on_the_instance():
    """Host tables that depend on a head dim key on its instance: D = 80
    walks D = 128's dQ tiles (packed tables too), D = 16 D = 64's."""
    pos = torch.tensor([[p for L in (100, 156) for p in range(L)]])
    for d, inst in ((80, 128), (100, 128), (16, 64), (32, 64)):
        a = packed.packed_tables(pos, 4, 64, d)
        b = packed.packed_tables(pos, 4, 64, inst)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert flash.DQ_BN[_build.kernel_head_dim(d)] == flash.DQ_BN[inst]


def _qkv(seed, B, H_q, H_kv, N, D):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in
            ((B, H_q, N, D), (B, H_kv, N, D), (B, H_kv, N, D), (H_q,))]


def _grads_close(got, ref, what):
    """JAX's CPU gradient tolerance (tests/test_flash_backward.py)."""
    for nm, g, r in zip(("dq", "dk", "dv", "ds_aux"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=1e-2, err_msg=f"{what} {nm}")


@pytest.mark.parametrize("d", DIMS)
def test_attention_and_grads_match_jax(d):
    """The forward and its gradients (dq, dk, dv, ds_aux) at head_dim d:
    GQA 2:1, sinks, a window shorter than N, s_aux; JAX's CPU tolerances
    (2e-5 forward, 1e-4 / 1e-2 gradients)."""
    x = _qkv(d, 1, 4, 2, 96, d)
    do = np.random.RandomState(d + 1).randn(1, 4, 96, d).astype(np.float32)
    # one JAX forward for the output and the pullback of do
    j_out, vjp = jax.vjp(
        lambda q, k, v, a: jflash.sink_flash_attention(q, k, v, 4, 40,
                                                       s_aux=a),
        *map(jnp.asarray, x))
    j_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in x]
    out = flash.sink_flash_attention(*leaves[:3], 4, 40, s_aux=leaves[3])
    (out * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=2e-5, rtol=1e-3)
    _grads_close([t.grad for t in leaves], j_grads, f"D={d}")


@pytest.mark.parametrize("d", DIMS)
def test_packed_attention_and_grads_match_jax(d):
    """The packed forward and its gradients at head_dim d on a pack of
    three segments (tests/test_packed.py's tolerances: 5e-5 forward, abs
    2e-3 or rel 1e-3 gradients)."""
    x = _qkv(100 + d, 1, 4, 2, 128, d)
    pos = np.array([[p for L in (50, 8, 70) for p in range(L)]], np.int32)

    def j_fn(q, k, v, a):
        return j_packed(q, k, v, jnp.asarray(pos), 4, 40, s_aux=a,
                        block_q=64, block_kv=64)

    # one JAX forward for the output and the pullback of d(out^2) = 2 out
    j_out, vjp = jax.vjp(j_fn, *map(jnp.asarray, x))
    j_grads = vjp(2.0 * j_out)
    leaves = [torch.from_numpy(a).requires_grad_() for a in x]
    out = packed.sink_flash_attention_packed(*leaves[:3],
                                             torch.from_numpy(pos), 4, 40,
                                             s_aux=leaves[3])
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=5e-5)
    for nm, g, r in zip(("dq", "dk", "dv", "ds_aux"),
                        [t.grad for t in leaves], j_grads):
        err = np.abs(g.numpy() - np.asarray(r))
        assert err.max() < 2e-3 or (err / (np.abs(r) + 1e-3)).max() < 1e-3, (
            d, nm, err.max())


@pytest.mark.parametrize("d", DIMS)
def test_cached_decode_matches_jax(d):
    """One decode step over a wrapped sink cache at head_dim d, GQA 4:1
    (tests/test_decode.py's fp32 CPU tolerance, 1e-5)."""
    rs = np.random.RandomState(200 + d)
    B, H_q, H_kv, n = 1, 8, 2, 45
    q = rs.randn(B, H_q, 1, d).astype(np.float32)
    k, v = (rs.randn(B, H_kv, n, d).astype(np.float32) for _ in range(2))
    aux = rs.randn(H_q).astype(np.float32)
    jc = JCache.init(B, H_kv, d, num_sink=4, window_size=32,
                     dtype=jnp.float32)
    jc = jc.prefill(jnp.asarray(k), jnp.asarray(v))
    tc = TCache.init(B, H_kv, d, num_sink=4, window_size=32,
                     dtype=torch.float32, device="cpu")
    tc.prefill(torch.from_numpy(k), torch.from_numpy(v))
    o_j = j_decode(jnp.asarray(q), jc, s_aux=jnp.asarray(aux))
    o_t = tdec.sink_decode_attention_cached(torch.from_numpy(q), tc,
                                            s_aux=torch.from_numpy(aux))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


# An H2O-Danube-1.8B-shaped config (Mistral family: every layer sliding,
# no s_aux, no sinks) cut to a narrow test size: head_dim 80 kept, GQA 4:1,
# 2 layers, a window of 24 below the 40-token prompt.
DANUBE_NARROW = dict(
    model_type="mistral", hidden_size=128, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=1, head_dim=80,
    intermediate_size=96, vocab_size=256, sliding_window=24,
    max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-5)


@functools.lru_cache(maxsize=None)
def _danube():
    jcfg = jm.ModelConfig.from_hf_config(DANUBE_NARROW)
    tcfg = ModelConfig.from_hf_config(DANUBE_NARROW)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(16), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_danube_config_from_hf():
    """from_hf_config gives the same config in both packages: head_dim 80,
    every layer sliding at 24, the dense family without s_aux."""
    jcfg, tcfg, _, _ = _danube()
    assert tcfg.head_dim == 80 and tcfg.num_heads // tcfg.num_kv_heads == 4
    assert set(tcfg.layer_types) == {"sliding_attention"}
    assert (tcfg.sliding_window, tcfg.mlp_type, tcfg.use_s_aux) == (
        24, "dense", False)
    for f in ("head_dim", "num_heads", "num_kv_heads", "sliding_window",
              "layer_types", "intermediate_size", "hidden_size"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def test_danube_logits_and_decode_match_jax():
    """Prefill logits of a 40-token prompt (past the window) and 8 decode
    steps with the caches, at test_torch_model.py's tolerance (1e-4)."""
    jcfg, tcfg, jp, tp = _danube()
    B, N, steps = 2, 40, 8
    ids = np.random.RandomState(17).randint(0, 256, (B, N + steps))
    jc = jm.make_caches(jcfg, B, max_len=N + steps, dtype=jnp.float32)
    lj, jc = jm.forward_prefill(jp, jcfg, jnp.asarray(ids[:, :N]), jc)
    tc = make_caches(tcfg, B, max_len=N + steps, dtype=torch.float32,
                     device="cpu")
    lt, tc = forward_prefill(tp, tcfg, torch.from_numpy(ids[:, :N]), tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    for t in range(N, N + steps):
        lj, jc = jm.forward_decode(jp, jcfg, jnp.asarray(ids[:, t:t + 1]),
                                   jc, position=t)
        lt, tc = forward_decode(tp, tcfg, torch.from_numpy(ids[:, t:t + 1]),
                                tc, position=t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   err_msg=f"position {t}")


def _loss_and_grads(tp, loss):
    leaves = param_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    value = loss()
    grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                materialize_grads=True)
    for t in leaves:
        t.requires_grad_(False)
    return value, grads


def _tree_close(tloss, grads, jloss, jgrads):
    """test_torch_train.py's tolerances: loss rtol 1e-5, every gradient
    leaf atol 1e-6 / rtol 1e-4."""
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, jleaves)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=1e-4, err_msg=f"leaf {i}")


@pytest.mark.parametrize("packed_batch", [False, True],
                         ids=["unpacked", "packed"])
def test_danube_training_step_matches_jax(packed_batch):
    """One training step's next-token loss and its gradient tree, over 2
    sequences of 40 tokens, or over a pack of segments of 16 and 24 per
    row (``cross_entropy_loss_packed``)."""
    jcfg, tcfg, jp, tp = _danube()
    batch = np.random.RandomState(18).randint(0, 256, (2, 41))
    if packed_batch:  # the packed loss takes the pack's own N tokens
        batch = batch[:, :40]
        pos = np.array([[p for L in (16, 24) for p in range(L)]] * 2,
                       np.int32)
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jtrain.cross_entropy_loss_packed(
                p, jcfg, b, jnp.asarray(pos))))(jp, jnp.asarray(batch))
        tloss, grads = _loss_and_grads(tp, lambda: cross_entropy_loss_packed(
            tp, tcfg, torch.from_numpy(batch), torch.from_numpy(pos)))
    else:
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jtrain.cross_entropy_loss(p, jcfg, b)))(
                jp, jnp.asarray(batch))
        tloss, grads = _loss_and_grads(tp, lambda: cross_entropy_loss(
            tp, tcfg, torch.from_numpy(batch)))
    _tree_close(tloss, grads, jloss, jgrads)


def test_chip_smoke_danube_phase_on_cpu():
    """chip_smoke's phase 13 rehearsed on the CPU on the narrow Danube
    config: serving in bf16, fp32 and over int8 KV, the fp32 training
    steps unpacked and packed; every check passes and nothing launches."""
    import chip_smoke
    report, errors = chip_smoke.danube_phase(
        "cpu", hf=DANUBE_NARROW, batch=2, prompt_len=48, new_tokens=4,
        train_len=40, segments=(16, 24))
    assert errors == []
    assert report["config"]["head_dim"] == 80
    runs = [k for k in report if k != "config"]
    assert len(runs) == 5
    for k in runs:
        assert set(report[k]["launches"].values()) == {0}, k
