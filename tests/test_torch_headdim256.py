"""Head dims above 128: the port against the JAX package at D = 160 and 256.

The CUDA kernels run any head_dim from 129 to 256 in their 256-wide
instance (``ops._build.kernel_head_dim``), with its own tiles: 64-key
forward tiles, 32-key dQ tiles and 64-key dK/dV items, keyed on the
instance in every host table. On the CPU the port runs the kernels' plain
versions, which take any head_dim; they are held here to the JAX package
(Pallas in interpret mode, as its own tests run it) on the same seeded
numpy inputs: the forward with s_aux, 4 sinks and a window shorter than N,
its gradients through autograd, the packed forward and gradients, and the
decode over bf16, int8 and fp8 caches. A 2-layer Gemma-shaped model
(``chip_smoke.GEMMA2_2B`` cut to hidden 128, 2/1 heads, head_dim 256 kept,
one sliding and one full layer, 4 StreamingLLM sinks) is held to JAX's:
prefill logits, 4 greedy tokens, and one SGD step. Each JAX function runs
once per head dim (cached), so the file keeps under a minute.

Tolerances are the JAX tests' CPU ones: forward 2e-5 (rtol 1e-3) and
gradients 1e-4 (rtol 1e-2) (tests/test_flash_backward.py); packed 5e-5
forward, abs 2e-3 or rel 1e-3 gradients (tests/test_packed.py); fp32
decode 1e-5 (tests/test_decode.py), a bf16 cache JAX's bf16 forward
tolerance 2e-2 (tests/test_flash_prefill.py's tol()); logits 1e-4
(tests/test_torch_model.py); training loss rtol 1e-5 and gradient leaves
atol 1e-6 / rtol 1e-4 (tests/test_torch_train.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import chip_smoke
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
from sink_attention_tpu_torch.parallel import cross_entropy_loss, param_leaves

DIMS = (160, 256)
NS, W = 4, 24  # sinks and a window shorter than every N below


def _inputs(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def test_tables_key_on_the_256_instance():
    """Every head dim from 129 to 256 walks the 256 instance's tiles:
    64-key forward tiles and dK/dV items, 32-key dQ tiles; the packed
    tables of D = 160 and 256 are one, and differ from D = 128's."""
    assert {_build.kernel_head_dim(d) for d in range(129, 257)} == {256}
    assert (flash.FWD_BNS[256], flash.DQ_BN[256], flash.DKDV_BNS[256]) == (
        64, 32, 64)
    pos = torch.tensor([[p for L in (100, 156) for p in range(L)]])
    t160, t256, t128 = (packed.packed_tables(pos, 4, 64, d)
                        for d in (160, 256, 128))
    assert all(torch.equal(a, b) for a, b in zip(t160, t256))
    assert t256.fwd.shape == t128.fwd.shape  # 128-row q blocks both
    assert t256.kv.shape[1] == 2 * t128.kv.shape[1]  # 64- vs 128-slot items


@functools.lru_cache(maxsize=None)
def _flash_case(d):
    """(inputs, JAX out, JAX grads, port out, port grads) at head dim d:
    GQA 2:1, N = 80, s_aux, 4 sinks, window 24."""
    q, k, v, do = _inputs(d, (1, 4, 80, d), (1, 2, 80, d), (1, 2, 80, d),
                          (1, 4, 80, d))
    (aux,) = _inputs(d + 1, (4,))
    x = [q, k, v, aux]
    j_out, vjp = jax.vjp(
        lambda q, k, v, a: jflash.sink_flash_attention(q, k, v, NS, W,
                                                       s_aux=a),
        *map(jnp.asarray, x))
    j_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in x]
    out = flash.sink_flash_attention(*leaves[:3], NS, W, s_aux=leaves[3])
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves], j_out, \
        j_grads


@pytest.mark.parametrize("d", DIMS)
def test_forward_matches_jax(d):
    out, _, j_out, _ = _flash_case(d)
    np.testing.assert_allclose(out, np.asarray(j_out), atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize("d", DIMS)
def test_gradients_match_jax(d):
    """dq, dk, dv and ds_aux through autograd (the plain dQ and dK/dV)."""
    _, grads, _, j_grads = _flash_case(d)
    for nm, g, r in zip(("dq", "dk", "dv", "ds_aux"), grads, j_grads):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-4, rtol=1e-2,
                                   err_msg=f"D={d} {nm}")


@functools.lru_cache(maxsize=None)
def _packed_case(d):
    """The packed forward and the gradients of sum(out ** 2), on a pack
    of segments of 50, 8 and 70 tokens, in both packages."""
    x = _inputs(100 + d, (1, 4, 128, d), (1, 2, 128, d), (1, 2, 128, d),
                (4,))
    pos = np.array([[p for L in (50, 8, 70) for p in range(L)]], np.int32)

    def j_fn(q, k, v, a):
        return j_packed(q, k, v, jnp.asarray(pos), NS, W, s_aux=a,
                        block_q=64, block_kv=64)

    jx = list(map(jnp.asarray, x))
    j_out, vjp = jax.vjp(j_fn, *jx)
    j_grads = vjp(2.0 * j_out)
    leaves = [torch.from_numpy(a).requires_grad_() for a in x]
    out = packed.sink_flash_attention_packed(*leaves[:3],
                                             torch.from_numpy(pos), NS, W,
                                             s_aux=leaves[3])
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves], j_out, \
        j_grads


@pytest.mark.parametrize("d", DIMS)
def test_packed_forward_matches_jax(d):
    out, _, j_out, _ = _packed_case(d)
    np.testing.assert_allclose(out, np.asarray(j_out), atol=5e-5)


@pytest.mark.parametrize("d", DIMS)
def test_packed_gradients_match_jax(d):
    _, grads, _, j_grads = _packed_case(d)
    for nm, g, r in zip(("dq", "dk", "dv", "ds_aux"), grads, j_grads):
        err = np.abs(g - np.asarray(r))
        assert err.max() < 2e-3 or (err / (np.abs(r) + 1e-3)).max() < 1e-3, (
            d, nm, err.max())


def _dequantized(jc):
    """The JAX cache with its storage replaced by its own dequant_kv()."""
    kf, vf = jc.dequant_kv()
    return jc.replace(k=kf, v=vf, quant=None)


@pytest.mark.parametrize("kind", ["bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("d", DIMS)
def test_cached_decode_matches_jax(d, kind):
    """One decode step over a wrapped sink cache (45 tokens, 4 sinks, a
    window of 32), GQA 4:1. A bf16 cache against JAX's bf16 decode (2e-2);
    an int8 / fp8 cache against JAX's decode over its dequantized cache
    (1e-5: the quantized kernels' contract is attention over the
    dequantized cache), with the codes and scales equal (JAX's buffers
    are padded to whole 128 columns)."""
    B, H_q, H_kv, n = 1, 8, 2, 45
    q, k, v = _inputs(200 + d, (B, H_q, 1, d), (B, H_kv, n, d),
                      (B, H_kv, n, d))
    (aux,) = _inputs(300 + d, (H_q,))
    quant = None if kind == "bfloat16" else kind
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if quant is None else
                (jnp.float32, torch.float32))
    if quant is None:  # both caches hold the same bf16 values
        q, k, v = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                              .astype(jnp.float32)) for a in (q, k, v))
    jc = JCache.init(B, H_kv, d, num_sink=NS, window_size=32, dtype=jdt,
                     quant=quant)
    jc = jc.prefill(jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt))
    tc = TCache.init(B, H_kv, d, num_sink=NS, window_size=32, dtype=tdt,
                     quant=quant, device="cpu")
    tc.prefill(torch.tensor(k).to(tdt), torch.tensor(v).to(tdt))
    o_t = tdec.sink_decode_attention_cached(torch.tensor(q).to(tdt), tc,
                                            s_aux=torch.from_numpy(aux))
    o_j = j_decode(jnp.asarray(q).astype(jdt),
                   jc if quant is None else _dequantized(jc),
                   s_aux=jnp.asarray(aux))
    if quant is None:
        np.testing.assert_allclose(o_t.float().numpy(),
                                   np.asarray(o_j.astype(jnp.float32)),
                                   atol=2e-2, rtol=1e-3)
    else:
        np.testing.assert_array_equal(tc.k.numpy(),
                                      np.asarray(jc.k)[..., :d])
        np.testing.assert_array_equal(tc.k_scale.numpy(),
                                      np.asarray(jc.k_scale))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


# chip_smoke's Gemma-2-2B-shaped config cut to a narrow test size: head_dim
# 256 kept, GQA 2:1, one sliding layer (a window of 16 under the 40-token
# prompt) and one full layer, 4 StreamingLLM sinks.
GEMMA_NARROW = dict(
    chip_smoke.GEMMA2_2B, hidden_size=128, num_layers=2, num_heads=2,
    num_kv_heads=1, intermediate_size=96, vocab_size=256, sliding_window=16,
    layer_types=("sliding_attention", "full_attention"),
    max_position_embeddings=256, num_sink_tokens=4)


@functools.lru_cache(maxsize=None)
def _gemma():
    jcfg = jm.ModelConfig(**GEMMA_NARROW)
    tcfg = ModelConfig(**GEMMA_NARROW)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(17), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_gemma_config_in_both_packages():
    """ModelConfig(**GEMMA2_2B) builds one config in both packages: head
    dim 256 (past the 128 instance), alternating sliding and full layers,
    the dense family without s_aux; the narrow one keeps its shape."""
    full = [cls(**chip_smoke.GEMMA2_2B) for cls in (jm.ModelConfig,
                                                    ModelConfig)]
    narrow = _gemma()[:2]
    for jcfg, tcfg in (full, narrow):
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    cfg = full[1]
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers,
            cfg.sliding_window, cfg.mlp_type, cfg.use_s_aux) == (
        256, 8, 4, 26, 4096, "dense", False)
    assert cfg.layer_types[:2] == ("sliding_attention", "full_attention")
    assert _build.kernel_head_dim(cfg.head_dim) == 256
    assert narrow[1].num_sink_tokens == 4


def test_gemma_logits_and_greedy_tokens_match_jax():
    """Prefill logits of a 40-token prompt (past the window, 4 sinks
    pinned) and 4 greedy tokens decoded over the caches: the same tokens,
    the logits at each step within 1e-4."""
    jcfg, tcfg, jp, tp = _gemma()
    B, N, steps = 2, 40, 4
    ids = np.random.RandomState(19).randint(0, 256, (B, N))
    jc = jm.make_caches(jcfg, B, max_len=N + steps, dtype=jnp.float32)
    lj, jc = jax.jit(lambda p, x, c: jm.forward_prefill(p, jcfg, x, c))(
        jp, jnp.asarray(ids), jc)
    j_step = jax.jit(lambda p, x, c, t: jm.forward_decode(p, jcfg, x, c,
                                                          position=t))
    tc = make_caches(tcfg, B, max_len=N + steps, dtype=torch.float32,
                     device="cpu")
    lt, tc = forward_prefill(tp, tcfg, torch.from_numpy(ids), tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    for t in range(N, N + steps):
        tok = lt[:, -1].argmax(-1)
        np.testing.assert_array_equal(tok.numpy(),
                                      np.asarray(lj[:, -1].argmax(-1)))
        lj, jc = j_step(jp, jnp.asarray(tok[:, None]), jc, t)
        lt, tc = forward_decode(tp, tcfg, tok[:, None], tc, position=t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   err_msg=f"position {t}")


def test_gemma_sgd_step_matches_jax():
    """One SGD step on 2 sequences of 40 tokens: the loss and every
    gradient leaf, then the loss after the update (lr 0.1)."""
    jcfg, tcfg, jp, tp = _gemma()
    batch = np.random.RandomState(20).randint(0, 256, (2, 41))
    j_loss = jax.jit(lambda p: jtrain.cross_entropy_loss(
        p, jcfg, jnp.asarray(batch)))
    jloss, jgrads = jax.jit(jax.value_and_grad(j_loss))(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    leaves = param_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    tloss = cross_entropy_loss(tp, tcfg, torch.from_numpy(batch))
    grads = torch.autograd.grad(tloss, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for i, (g, r) in enumerate(zip(grads, jleaves)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=1e-4, err_msg=f"leaf {i}")
    jp2 = jax.tree.map(lambda p, g: p - 0.1 * g, jp, jgrads)
    with torch.no_grad():
        for t, g in zip(leaves, grads):
            t.sub_(0.1 * g)
    jloss2 = j_loss(jp2)
    with torch.no_grad():
        tloss2 = cross_entropy_loss(tp, tcfg, torch.from_numpy(batch))
    np.testing.assert_allclose(tloss2.item(), float(jloss2), rtol=1e-5)


def test_chip_smoke_gemma_phase_on_cpu():
    """chip_smoke's phase 14 rehearsed on the CPU on the narrow config:
    serving in bf16, over int8 KV and with 4 StreamingLLM sinks, the bf16
    training steps unpacked and packed; every check passes and nothing
    launches."""
    config = dict(GEMMA_NARROW, num_sink_tokens=0)
    report, errors = chip_smoke.gemma_phase(
        "cpu", config=config, batch=2, prompt_len=36, new_tokens=4,
        train_len=40, segments=(16, 24))
    assert errors == []
    assert report["config"]["head_dim"] == 256
    runs = [k for k in report if k != "config"]
    assert len(runs) == 5
    for k in runs:
        assert set(report[k]["launches"].values()) == {0}, k


def _decode_ptxas(spills):
    """ptxas lines of decode.cu's 25 instances (the short rows' of a
    storage keyed (storage, D_i), its deep one (storage, 0)), ``spills``
    {key: bytes of spill stores} and 0 for the others."""
    names = {"Bf16": 4, "Fp16": 4, "Fp32": 4, "Int8": 4, "Fp8": 3}
    lines = []
    for st, n in names.items():
        for d in (64, 80, 96, 128):
            b = spills.get((st, d), 0)
            lines += [f"Compiling entry function '_ZN_short_decode_kernelINS_"
                      f"{n}{st}ELi{d}EEEvPKv' for 'sm_90a'",
                      f"{b} bytes stack frame, {b} bytes spill stores, "
                      f"{b} bytes spill loads"]
        b = spills.get((st, 0), 0)
        lines += [f"Compiling entry function '_ZN_deep_decode_kernelINS_{n}"
                  f"{st}EEEvPKv' for 'sm_90a'",
                  f"{b} bytes stack frame, {b} bytes spill stores, "
                  f"{b} bytes spill loads"]
    return {"decode": {"ptxas": lines, "cached": False}}


def test_spill_check_holds_decode_to_its_allowance(monkeypatch):
    """chip_smoke's spill check takes the decode instances' recorded
    spills (none recorded), and refuses a spill past one, a spill in an
    instance with no allowance (a short-row instance, the deep one), and a
    build that lacks an instance."""
    allowed = dict(chip_smoke.DECODE_SPILL_ALLOWANCE)
    assert chip_smoke.spill_errors(_decode_ptxas(allowed)) == []
    monkeypatch.setitem(chip_smoke.DECODE_SPILL_ALLOWANCE, ("Int8", 128), 4)
    assert chip_smoke.spill_errors(_decode_ptxas({("Int8", 128): 4})) == []
    worse = {("Int8", 128): 8}
    assert len(chip_smoke.spill_errors(_decode_ptxas(worse))) == 1
    new = {("Int8", 128): 4, ("Bf16", 80): 4}
    assert len(chip_smoke.spill_errors(_decode_ptxas(new))) == 1
    deep = {("Int8", 128): 4, ("Fp32", 0): 4}  # the deep decode: none
    assert len(chip_smoke.spill_errors(_decode_ptxas(deep))) == 1
    short = _decode_ptxas(allowed)
    short["decode"]["ptxas"] = short["decode"]["ptxas"][:-2]
    assert len(chip_smoke.spill_errors(short)) == 1
