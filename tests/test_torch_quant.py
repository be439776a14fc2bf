"""The port's weight quantization (models/quant.py) and its quantized model
against the JAX package's, on the tiny configs with trees carried over by
params_from_jax: int8 codes bit for bit and scales equal, the trees of
init_quantized_params, every forward's logits on int8, int4 and int4
group-32 trees in fp32 compute, greedy and engine tokens; the JAX tests'
dequantised-equals property; chip_smoke's phase 9 rehearsed on the CPU.

One JAX run per tree is shared by the tests (its Pallas kernels run in
interpret mode, the slow part)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.models as jm
from sink_attention_tpu.models import model as jmodel
from sink_attention_tpu.ops import eager_sink_attention as j_eager
from sink_attention_tpu.serving import ContinuousBatchingEngine as JEngine
from sink_attention_tpu.serving import greedy_generate as j_greedy
from sink_attention_tpu_torch.models import (ModelConfig,
                                             init_quantized_params,
                                             is_quantized, params_from_jax,
                                             quantize_params,
                                             quantize_weight)
from sink_attention_tpu_torch.models import model as tmodel
from sink_attention_tpu_torch.serving import (ContinuousBatchingEngine,
                                              greedy_generate)

import chip_smoke

# fp32 logits of the same model: the JAX model tests' bound. The int4
# matmuls cast x to bf16: an activation at a bf16 rounding boundary may
# round apart after sums taken in another order (seen: 2e-5).
LOGIT_TOL = 1e-4
# widths that group 32 divides in halves (intermediate 64, not tiny's 32)
TINY = dict(num_layers=2, intermediate_size=64, vocab_size=128)
TREES = {"int8": (8, None), "int4": (4, None), "int4_g32": (4, 32)}
F32 = dict(dtype=torch.float32, device="cpu")


def _np(x):
    return np.asarray(x, np.float32) if x.dtype != np.int8 else np.asarray(x)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_trees_equal(tt, jt):
    """Same paths, shapes and dtypes; every leaf equal (int8 codes bit for
    bit, scales and the unquantized leaves as numbers)."""
    t_leaves, j_leaves = dict(_leaves(tt)), dict(_leaves(jt))
    assert sorted(t_leaves) == sorted(j_leaves)
    for path, j in j_leaves.items():
        t = t_leaves[path]
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
        a = t.float().numpy() if t.is_floating_point() else t.numpy()
        np.testing.assert_array_equal(a, _np(j), err_msg=path)


# -- quantize_weight, quantize_params ----------------------------------------


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, axis", [((48, 40), -2), ((3, 32, 24), -2),
                                         ((50, 16), -1)])
def test_quantize_weight_bit_for_bit_jax(shape, axis, w_dtype, scale_dtype):
    w = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32) * 0.05
    w[..., 1] = 0.0                       # zero columns (rows at axis -1)
    jw = jnp.asarray(w).astype(getattr(jnp, w_dtype))
    tw = torch.from_numpy(w).to(getattr(torch, w_dtype))
    jq = jm.quantize_weight(jw, axis, scale_dtype=getattr(jnp, scale_dtype))
    tq = quantize_weight(tw, axis, scale_dtype=getattr(torch, scale_dtype))
    _assert_trees_equal(tq, jax.tree.map(np.asarray, jq))


def _jax_params(family, dtype, seed=0):
    jcfg = getattr(jm.ModelConfig, family)()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(seed), dtype)
    return jcfg, getattr(ModelConfig, family)(), jp


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["tiny", "qwen2_tiny"])
def test_quantize_params_matches_jax(family, dtype, inplace):
    """The MoE and dense families, fp32 and bf16 sources, scales in the
    source's dtype: every leaf of the port's tree equals JAX's."""
    jcfg, tcfg, jp = _jax_params(family, getattr(jnp, dtype))
    jq = jm.quantize_params(jp, jcfg, compute_dtype=getattr(jnp, dtype))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                         dtype=getattr(torch, dtype))
    layer0 = tp["layers"][0]
    tq = quantize_params(tp, tcfg, compute_dtype=getattr(torch, dtype),
                         inplace=inplace)
    assert (tq is tp) == inplace
    assert is_quantized(layer0["attn"]["wq"]) == inplace
    _assert_trees_equal(tq, jax.tree.map(np.asarray, jq))


def test_params_from_jax_casts_floating_leaves_only():
    """With dtype= the int8 codes stay int8 (bit for bit) and the scales
    and plain leaves take the dtype."""
    jcfg, _, jp = _jax_params("tiny", jnp.float32)
    jq = jax.tree.map(np.asarray, jm.quantize_params(jp, jcfg))
    tq = params_from_jax(jq, device="cpu", dtype=torch.bfloat16)
    for path, t in _leaves(tq):
        assert t.dtype == (torch.int8 if path.endswith("/q")
                           else torch.bfloat16), path
    np.testing.assert_array_equal(tq["layers"][1]["mlp"]["down"]["q"].numpy(),
                                  jq["layers"][1]["mlp"]["down"]["q"])


@pytest.mark.parametrize("tree", list(TREES))
def test_init_quantized_params_tree_matches_jax(tree):
    """Keys, shapes and dtypes of the tree at bits 8, 4 and 4 with group
    32 (default bf16 init and compute), the embedding int8 at bits 4."""
    bits, group = TREES[tree]
    jcfg, tcfg = jm.ModelConfig.tiny(**TINY), ModelConfig.tiny(**TINY)
    jt = jax.eval_shape(lambda k: jm.init_quantized_params(
        jcfg, k, bits=bits, int4_group_size=group), jax.random.PRNGKey(0))
    tt = init_quantized_params(tcfg, torch.Generator().manual_seed(0),
                               bits=bits, int4_group_size=group,
                               device="cpu")
    t_leaves, j_leaves = dict(_leaves(tt)), dict(_leaves(jt))
    assert sorted(t_leaves) == sorted(j_leaves)
    for path, j in j_leaves.items():
        t = t_leaves[path]
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == (
            tuple(j.shape), str(j.dtype)), path
    assert "q" in tt["embed"] and ("q4" in tt["lm_head"]) == (bits == 4)


def test_init_quantized_params_draws_experts_in_slices(monkeypatch):
    """A stack drawn a slice of experts at a time is quantized per
    (expert, channel): the slices' scales are the whole stack's."""
    from sink_attention_tpu_torch.models import quant

    cfg = ModelConfig.tiny(num_layers=1, num_experts=5)
    monkeypatch.setattr(quant, "EXPERT_SLICE", 2)
    tt = init_quantized_params(cfg, torch.Generator().manual_seed(3),
                               compute_dtype=torch.float32,
                               init_dtype=torch.float32, device="cpu")
    gu = tt["layers"][0]["mlp"]["gate_up"]
    assert gu["q"].shape == (5, 64, 64) and gu["s"].shape == (5, 1, 64)
    # each column's largest code is +-127: its own max-abs scale
    assert bool((gu["q"].abs().amax(dim=1) == 127).all())


def test_init_quantized_params_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_quantized_params(ModelConfig.tiny(), torch.Generator())
    with pytest.raises(ValueError, match="bits"):
        init_quantized_params(ModelConfig.tiny(), torch.Generator(), bits=2,
                              device="cpu")


# -- the quantized model against JAX -----------------------------------------


@functools.lru_cache(maxsize=None)
def _tree(name):
    bits, group = TREES[name]
    jcfg, tcfg = jm.ModelConfig.tiny(**TINY), ModelConfig.tiny(**TINY)
    jq = jm.init_quantized_params(jcfg, jax.random.PRNGKey(1),
                                  compute_dtype=jnp.float32,
                                  init_dtype=jnp.float32, bits=bits,
                                  int4_group_size=group)
    return jcfg, tcfg, jq, params_from_jax(jax.tree.map(np.asarray, jq),
                                           device="cpu")


B, N, T_VERIFY = 2, 20, 3       # N > sliding_window (16): the ring wraps
LENS = [20, 7]                  # the ragged slots' prompt lengths


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """The JAX side for one tree, run once: prefill of B prompts with
    caches (its attention through the JAX plain reference, the interpret
    mode's slow part spared: the tests are of the matmuls), one decode
    step, a verify of T_VERIFY tokens on the stepped caches, one ragged
    decode step over slots built from the port's collected prefill KVs
    (no second JAX prefill), greedy tokens."""
    jcfg, tcfg, jq, tq = _tree(name)
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"],
                                            (B, N + 1 + T_VERIFY))
    jc = jm.make_caches(jcfg, B, 32, dtype=jnp.float32)
    lp, jc = jm.forward_prefill(jq, jcfg, jnp.asarray(ids[:, :N]), jc,
                                attn_impl=j_eager)
    ld, jc = jm.forward_decode(jq, jcfg, jnp.asarray(ids[:, N:N + 1]), jc,
                               position=N)
    lv, _ = jmodel.forward_verify(jq, jcfg, jnp.asarray(ids[:, N + 1:]), jc,
                                  N + 1)
    _, kvs = tmodel.forward_prefill(tq, tcfg, torch.from_numpy(ids[:, :N]),
                                    collect_kv=True)
    jr = jm.make_ragged_caches(jcfg, B, 32, dtype=jnp.float32)
    for b, n in enumerate(LENS):
        for li, (k, v) in enumerate(kvs):
            jr[li] = jr[li].insert(b, jnp.asarray(k[b].numpy()),
                                   jnp.asarray(v[b].numpy()), n)
    toks = ids[np.arange(B), LENS][:, None]
    lr, _ = jm.forward_decode_ragged(jq, jcfg, jnp.asarray(toks), jr,
                                     jnp.asarray(LENS), jnp.ones(B, bool))
    greedy = j_greedy(jq, jcfg, jnp.asarray(ids[:1, :8]), max_new_tokens=3,
                      dtype=jnp.float32)
    return ids, kvs, {"prefill": lp, "decode": ld, "verify": lv,
                      "ragged": lr, "greedy": greedy}


@pytest.mark.parametrize("name", list(TREES))
def test_quantized_forwards_match_jax(name):
    """forward_prefill, forward_decode (one step), forward_verify (after
    it) and forward_decode_ragged logits against JAX's, fp32 compute."""
    _, tcfg, _, tq = _tree(name)
    ids, kvs, ref = _jax_run(name)
    tc = tmodel.make_caches(tcfg, B, 32, **F32)
    got = {}
    got["prefill"], tc = tmodel.forward_prefill(
        tq, tcfg, torch.from_numpy(ids[:, :N]), tc)
    got["decode"], tc = tmodel.forward_decode(
        tq, tcfg, torch.from_numpy(ids[:, N:N + 1]), tc, N)
    got["verify"], _ = tmodel.forward_verify(
        tq, tcfg, torch.from_numpy(ids[:, N + 1:]), tc, N + 1)
    tr = tmodel.make_ragged_caches(tcfg, B, 32, **F32)
    for b, n in enumerate(LENS):
        for c, (k, v) in zip(tr, kvs):
            c.insert(b, k[b], v[b], n)
    toks = torch.from_numpy(ids[np.arange(B), LENS][:, None])
    got["ragged"], _ = tmodel.forward_decode_ragged(
        tq, tcfg, toks, tr, torch.tensor(LENS), torch.ones(B, dtype=bool))
    for key, lt in got.items():
        np.testing.assert_allclose(lt.numpy(), np.asarray(ref[key]),
                                   atol=LOGIT_TOL, err_msg=key)


@pytest.mark.parametrize("name", list(TREES))
def test_quantized_greedy_tokens_equal_jax(name):
    _, tcfg, _, tq = _tree(name)
    ids, _, ref = _jax_run(name)
    toks = greedy_generate(tq, tcfg, torch.from_numpy(ids[:1, :8]), 3,
                           **F32)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref["greedy"]))


def test_int8_engine_tokens_equal_jax():
    """ContinuousBatchingEngine over the int8 tree: 3 requests in 2 slots
    (one slot recycled), tokens equal to the JAX engine's."""
    jcfg, tcfg, jq, tq = _tree("int8")
    prompts = [[5, 9, 2], [7, 1, 30, 11, 8, 4, 22], [3] * 12]
    kw = dict(max_batch=2, max_len=48, prefill_bucket=16)
    je = JEngine(jq, jcfg, dtype=jnp.float32, **kw)
    te = ContinuousBatchingEngine(tq, tcfg, **kw, **F32)
    jr = [je.submit(p, max_new_tokens=3) for p in prompts]
    tr = [te.submit(p, max_new_tokens=3) for p in prompts]
    jo, to = je.run(), te.run()
    assert [to[r] for r in tr] == [list(map(int, jo[r])) for r in jr]


def test_int8_greedy_equals_dequantized_greedy():
    """JAX's property (tests/test_quant.py:93) on the port: greedy tokens
    of an int8 tree with fp32 scales equal those of the same tree with
    every weight dequantised."""
    jcfg, tcfg, jp = _jax_params("tiny", jnp.float32, seed=2)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tq = quantize_params(tp, compute_dtype=torch.float32)
    dp = chip_smoke.dequantize_tree(tq, torch.float32)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (1, 8)))
    np.testing.assert_array_equal(
        greedy_generate(tq, tcfg, ids, 4, **F32).numpy(),
        greedy_generate(dp, tcfg, ids, 4, **F32).numpy())


def test_quantized_dense_family_prefill_matches_jax():
    """The dense family's gate/up/down through _mm: int8 prefill logits
    against JAX's."""
    jcfg, tcfg, jp = _jax_params("qwen2_tiny", jnp.float32, seed=4)
    jq = jm.quantize_params(jp, jcfg, compute_dtype=jnp.float32)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    ids = np.random.default_rng(4).integers(0, tcfg.vocab_size, (1, 12))
    lj, _ = jm.forward_prefill(jq, jcfg, jnp.asarray(ids), attn_impl=j_eager)
    lt, _ = tmodel.forward_prefill(tq, tcfg, torch.from_numpy(ids))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_TOL)


@pytest.mark.parametrize("T", [3, 12])
@pytest.mark.parametrize("name", ["int8", "int4_g32"])
def test_quantized_moe_matches_jax(name, T):
    """Both MoE formulations on quantized experts: grouped (T <= 8,
    _routed_expert_mm) and dense (_expert_mm)."""
    jcfg, tcfg, jq, tq = _tree(name)
    x = np.random.default_rng(T).standard_normal(
        (1, T, tcfg.hidden_size)).astype(np.float32)
    oj = jmodel.moe(jq["layers"][0]["mlp"], jcfg, jnp.asarray(x))
    ot = tmodel.moe(tq["layers"][0]["mlp"], tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)


# -- chip_smoke's phase 9 rehearsed ---------------------------------------------


def test_chip_smoke_quant_phase_on_cpu():
    """Phase 9 at tiny size on the CPU: the op gates, then the bf16, int8
    (in place) and int4 trees through the engine rows, each row's checks
    at its own slots; no error, the quantized layers checked, the int8
    tree half the bf16 tree's bytes or less."""
    rows, errors = chip_smoke.quant_op_gates(
        "cpu", lm_head=(64, 256), experts=(4,), hidden=64, inter=64,
        expert_tokens=8)
    assert errors == [] and len(rows) == 3 * (2 + 2 * 2 * 1)
    rep, errors = chip_smoke.serve_quant(
        ModelConfig.tiny(**TINY), "cpu", batches=(1, 2), prompt_len=16,
        max_len=64, bucket=16, chunk=4, warm=1, timed=1, profile_steps=2)
    assert errors == []
    assert rep["int8"]["weight_bytes"] < 0.6 * rep["int8"]["bytes_before"]
    assert rep["int4"]["weight_bytes"] < rep["int8"]["weight_bytes"]
    for form in ("int8", "int4"):
        rows = rep[form]["engine"]
        assert [r["pool_steps"] for r in rows] == [10, 10]
        for row, slots in zip(rows, (1, 2)):
            # every layer's attention checked: one admission per slot,
            # then one decode step of the pool
            checks = row["checks"]
            assert checks["prefill_layers_checked"] == 2 * slots
            assert checks["decode_layers_checked"] == 2
            layers = checks["quant_layers"]
            assert [r["layer"] for r in layers] == [0, 1]
            assert min(r["cos"] for r in layers) > 0.999
