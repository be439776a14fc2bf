"""Head dims past 512: the port against the JAX package at D = 520, 640
and 1024.

The CUDA kernels run every head_dim past 512 in one wide instance
(``ops._build.kernel_head_dim`` gives ``WIDE_INSTANCE``): its depth (the
64-column boxes that S = Q K^T walks) and its output's 512-column slices
are counted at run time, so D = 520, 640, 1024 and 2048 share one table
set (64-key forward tiles over 64-row items, 32-key dQ tiles, 64-key dK/dV
items). On the CPU the port runs the kernels' plain versions, which take
any head_dim; they are held here to the JAX package (Pallas in interpret
mode, as its own tests run it; JAX pads D to whole 128 lanes) on the same
seeded numpy inputs: the forward with s_aux, 4 sinks and a window shorter
than N and its gradients, the packed forward and gradients, and the
decode over bf16, int8 and fp8 caches. A 2-layer model of chip_smoke's
Gemma-2-2B geometry at head_dim 1024 (``chip_smoke.GEMMA2_2B_XWIDE``, not
a released model, cut to hidden 128, 2/1 heads, head_dim 1024 kept, one
sliding and one full layer, 4 StreamingLLM sinks) is held to JAX's:
prefill logits, 4 greedy tokens, and one SGD step. Each JAX function runs
once per case (cached).

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

DIMS = (640, 1024)
DECODE_DIMS = (520, 1024)
NS, W = 4, 24  # sinks and a window shorter than every N below


def _inputs(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("d", [520, 640, 1024, 2048])
def test_tables_key_on_the_wide_instance(d):
    """Every head dim past 512 keys on the one wide instance: 64-key
    forward tiles, 32-key dQ tiles, 64-key dK/dV items; the packed tables
    of D = 520, 640, 1024 and 2048 are one set, and differ from D = 512's
    (its forward walks 32-key tiles); the range tables of the unpacked
    kernels are the wide instance's."""
    assert _build.kernel_head_dim(d) == _build.WIDE_INSTANCE
    wide = _build.WIDE_INSTANCE
    assert (flash.FWD_BNS[wide], flash.DQ_BN[wide],
            flash.DKDV_BNS[wide]) == (64, 32, 64)
    assert wide == 513 and _build.kernel_head_dim(wide) == wide
    pos = torch.tensor([[p for L in (100, 156) for p in range(L)]])
    got = packed.packed_tables(pos, 4, 64, d)
    want = packed.packed_tables(pos, 4, 64, 1024)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    t512 = packed.packed_tables(pos, 4, 64, 512)
    assert not torch.equal(got.fwd, t512.fwd)
    assert torch.equal(got.dq, t512.dq)  # 32-key dQ tiles both
    assert torch.equal(got.kv, t512.kv)  # 64-slot dK/dV items both
    np.testing.assert_array_equal(
        flash.fwd_kv_ranges(300, 300, 4, 64, 0, 0, bm=flash.FWD_BM,
                            bn=flash.FWD_BNS[_build.kernel_head_dim(d)]),
        flash.fwd_kv_ranges(300, 300, 4, 64, 0, 0, bm=128, bn=64))


@functools.lru_cache(maxsize=None)
def _flash_case(d):
    """(port out, port grads, JAX out, JAX grads) at head dim d: GQA 2:1,
    N = 80, s_aux, 4 sinks, window 24."""
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
@pytest.mark.parametrize("d", DECODE_DIMS)
def test_cached_decode_matches_jax(d, kind):
    """One decode step over a wrapped sink cache (45 tokens, 4 sinks, a
    window of 32), GQA 4:1. A bf16 cache against JAX's bf16 decode (2e-2);
    an int8 / fp8 cache against JAX's decode over its dequantized cache
    (1e-5: the quantized kernels' contract is attention over the
    dequantized cache), with the codes and scales equal (JAX's buffers
    are padded to whole 128 columns). D = 520's codes reach the kernel
    through a copy padded to whole 16 bytes (528)."""
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


# chip_smoke's Gemma-2-2B geometry at head_dim 1024 cut to a narrow test
# size: head_dim 1024 kept (q 2048 wide against hidden 128), GQA 2:1, one
# sliding layer (a window of 16 under the 40-token prompt) and one full
# layer, 4 StreamingLLM sinks.
XWIDE_NARROW = dict(
    chip_smoke.GEMMA2_2B_XWIDE, hidden_size=128, num_layers=2, num_heads=2,
    num_kv_heads=1, intermediate_size=96, vocab_size=256, sliding_window=16,
    layer_types=("sliding_attention", "full_attention"),
    max_position_embeddings=256, num_sink_tokens=4)


@functools.lru_cache(maxsize=None)
def _xwide():
    jcfg = jm.ModelConfig(**XWIDE_NARROW)
    tcfg = ModelConfig(**XWIDE_NARROW)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(19), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_xwide_config_in_both_packages():
    """ModelConfig(**GEMMA2_2B_XWIDE) builds one config in both packages:
    head dim 1024 (in the wide instance) with Gemma-2-2B's 8/4 heads and
    hidden 2304, alternating sliding and full layers; the narrow one keeps
    its shape; phase 16 serves and trains 12 of the 26 layers."""
    full = [cls(**chip_smoke.GEMMA2_2B_XWIDE) for cls in (jm.ModelConfig,
                                                          ModelConfig)]
    narrow = _xwide()[:2]
    for jcfg, tcfg in (full, narrow):
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    cfg = full[1]
    assert (cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.hidden_size,
            cfg.num_layers, cfg.sliding_window) == (1024, 8, 4, 2304, 26,
                                                    4096)
    assert _build.kernel_head_dim(cfg.head_dim) == _build.WIDE_INSTANCE
    assert narrow[1].num_sink_tokens == 4
    assert chip_smoke.XWIDE_LAYERS == 4


def test_xwide_logits_and_greedy_tokens_match_jax():
    """Prefill logits of a 40-token prompt (past the window, 4 sinks
    pinned) and 4 greedy tokens decoded over the caches: the same tokens,
    the logits at each step within 1e-4."""
    jcfg, tcfg, jp, tp = _xwide()
    B, N, steps = 2, 40, 4
    ids = np.random.RandomState(23).randint(0, 256, (B, N))
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


def test_xwide_sgd_step_matches_jax():
    """One SGD step on 2 sequences of 40 tokens: the loss and every
    gradient leaf, then the loss after the update (lr 0.1)."""
    jcfg, tcfg, jp, tp = _xwide()
    batch = np.random.RandomState(24).randint(0, 256, (2, 41))
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


def test_chip_smoke_xwide_phase_on_cpu():
    """chip_smoke's phase 16 rehearsed on the CPU on the narrow config
    (one sliding and one full layer): serving in bf16 and over int8 KV,
    the bf16 training steps unpacked and packed; every check passes and
    nothing launches."""
    config = dict(XWIDE_NARROW, num_sink_tokens=0)
    report, errors = chip_smoke.xwide_phase(
        "cpu", config=config, batch=1, prompt_len=24, new_tokens=3,
        train_len=24, segments=(8, 16))
    assert errors == []
    assert (report["config"]["head_dim"], report["config"]["num_layers"]) \
        == (1024, 2)
    runs = [k for k in report if k != "config"]
    assert len(runs) == 4
    for k in runs:
        assert set(report[k]["launches"].values()) == {0}, k
