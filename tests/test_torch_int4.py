"""The port's packed-INT4 ops (ops/int4.py) against the JAX package's, on
numpy inputs: the nibble format bit for bit, the matmuls within fp32
summation order (bf16 outputs within one bf16 rounding), the slicing of
an expert stack, and the JAX tests' own properties (the error bound of a
round trip, the matmuls against their dequantised weights, an int4 model
against its dequantised weights)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
from sink_attention_tpu.ops import int4 as jint4
from sink_attention_tpu_torch.ops import int4 as tint4

import chip_smoke

# fp32 results of the same bf16 products summed in another order
F32_TOL = 1e-5
# bf16 results: one bf16 rounding of a value (2^-8 relative) apart
BF16_TOL = 2.0 ** -8


def _weights(seed, shape, dtype):
    w = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.1
    w[..., 0, 1] = 0.0        # a column of one zero row
    if len(shape) == 2:
        w[:, 2] = 0.0         # an all-zero column: scale 1
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if dtype == "bf16":
        jw, tw = jw.astype(jnp.bfloat16), tw.to(torch.bfloat16)
    return jw, tw


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("shape, axis", [((128, 48), -2), ((3, 128, 40), 1),
                                         ((4, 6, 128), -1)])
def test_pack_int4_bit_for_bit_jax(shape, axis, group, dtype):
    jw, tw = _weights(sum(shape), shape, dtype)
    jp, js = jint4.pack_int4(jw, axis, group_size=group)
    tp, ts = tint4.pack_int4(tw, axis, group_size=group)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_unpack_in_int8_equals_jax_int32_decode():
    """The int8-arithmetic decode against JAX's int32 shifts on all 256
    byte values."""
    b = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    lo_j, hi_j = jint4._unpack_bf16(jnp.asarray(b))
    lo_t, hi_t = tint4._unpack_bf16(torch.from_numpy(b))
    np.testing.assert_array_equal(_np(lo_t), np.asarray(lo_j, np.float32))
    np.testing.assert_array_equal(_np(hi_t), np.asarray(hi_j, np.float32))


def _tol(x_dtype):
    return F32_TOL if x_dtype == "fp32" else BF16_TOL


def _x(seed, shape, x_dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if x_dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return jx, tx


def _assert_close(out_t, out_j, tol):
    ref = np.asarray(out_j, np.float32)
    err = np.abs(_np(out_t) - ref).max() / np.abs(ref).max()
    assert err <= tol, err


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("T", [1, 5])
def test_int4_matmul_matches_jax(T, group, x_dtype):
    jw, tw = _weights(7, (128, 72), "fp32")
    jp, js = jint4.pack_int4(jw, group_size=group)
    tp, ts = tint4.pack_int4(tw, group_size=group)
    jx, tx = _x(T, (T, 128), x_dtype)
    out_t = tint4.int4_matmul(tx, tp, ts)
    assert out_t.dtype == tx.dtype and out_t.shape == (T, 72)
    _assert_close(out_t, jint4.int4_matmul(jx, jp, js), _tol(x_dtype))


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("batched_x", [False, True])
def test_int4_matmul_experts_matches_jax(batched_x, group, x_dtype):
    E, T, K, N = 3, 6, 128, 40
    jw, tw = _weights(11, (E, K, N), "fp32")
    jp, js = jint4.pack_int4(jw, 1, group_size=group)
    tp, ts = tint4.pack_int4(tw, 1, group_size=group)
    jx, tx = _x(12, (E, T, K) if batched_x else (T, K), x_dtype)
    out_t = tint4.int4_matmul_experts(tx, tp, ts)
    assert out_t.dtype == tx.dtype and out_t.shape == (E, T, N)
    _assert_close(out_t, jint4.int4_matmul_experts(jx, jp, js),
                  _tol(x_dtype))


@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("batched_x", [False, True])
def test_int4_matmul_experts_is_int4_matmul_per_expert(batched_x, group):
    """The stack decoded and multiplied in one pass gives, for each
    expert, what int4_matmul gives on that expert alone (fp32 x, so the
    only difference is the fp32 summation order of a batched product)."""
    E, T, K, N = 5, 4, 128, 24
    _, tw = _weights(13, (E, K, N), "bf16")
    tp, ts = tint4.pack_int4(tw, 1, group_size=group)
    _, tx = _x(14, (E, T, K) if batched_x else (T, K), "fp32")
    out = tint4.int4_matmul_experts(tx, tp, ts)
    for e in range(E):
        ref = tint4.int4_matmul(tx[e] if batched_x else tx, tp[e], ts[e])
        _assert_close(out[e], ref.numpy(), F32_TOL)


def test_pack_roundtrip_error_bound():
    """JAX's round-trip property: per-column max-abs int4, error at most
    half a step."""
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 32)).astype(np.float32))
    packed, scale = tint4.pack_int4(w)
    deq = chip_smoke.dequantize({"q4": packed, "s": scale})
    err = (deq - w).abs().amax(dim=0)
    assert bool((err <= scale[0] / 2 + 1e-8).all())


@pytest.mark.parametrize("shape", [(1, 64, 128), (8, 2880, 512),
                                   (100, 288, 640), (5, 62, 130)])
def test_int4_matmul_matches_dequant(shape):
    """JAX's dequantised-reference property (its tests' shapes): bf16 x
    against the fp32 product with the weight dequantised, rel < 2e-2."""
    T, K, N = shape
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    packed, scale = tint4.pack_int4(w * 0.1)
    ref = x.float() @ chip_smoke.dequantize({"q4": packed, "s": scale})
    out = tint4.int4_matmul(x, packed, scale)
    rel = float((out.float() - ref).abs().max() / ref.abs().max())
    assert rel < 2e-2, rel


@pytest.mark.parametrize("group", [None, 16])
def test_int4_model_matches_dequantized(group):
    """JAX's model property on the port: an int4 tree's logits against
    the same tree with every weight dequantised, cosine > 0.999."""
    from sink_attention_tpu_torch.models import (ModelConfig,
                                                 forward_prefill,
                                                 init_quantized_params,
                                                 is_quantized4)

    cfg = ModelConfig.tiny(num_layers=2, vocab_size=128)
    qp = init_quantized_params(cfg, torch.Generator().manual_seed(0),
                               compute_dtype=torch.float32,
                               init_dtype=torch.float32, bits=4,
                               int4_group_size=group, device="cpu")
    assert is_quantized4(qp["layers"][0]["attn"]["wq"])
    assert is_quantized4(qp["layers"][0]["mlp"]["gate_up"])
    dp = chip_smoke.dequantize_tree(qp, torch.float32)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (1, 16)))
    lq, _ = forward_prefill(qp, cfg, ids)
    ld, _ = forward_prefill(dp, cfg, ids)
    assert chip_smoke.cosine(lq, ld) > 0.999


def test_int4_rejects_what_it_cannot_pack():
    with pytest.raises(ValueError, match="even"):
        tint4.pack_int4(torch.zeros(7, 4))
    with pytest.raises(ValueError, match="group_size"):
        tint4.pack_int4(torch.zeros(64, 4), group_size=24)
    packed, scale = tint4.pack_int4(torch.ones(64, 4))
    with pytest.raises(ValueError, match="K="):
        tint4.int4_matmul(torch.ones(2, 32), packed, scale)
