"""The port's int8/fp8 KV storage against the JAX package's: the quantizer
bit for bit, the quantized SinkKVCache's codes, scales and state after
every call, and decode attention over the quantized cache."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.ops as jops
from sink_attention_tpu.cache import SinkKVCache as JCache
from sink_attention_tpu.cache import sink_cache as jsc
from sink_attention_tpu_torch.cache import SinkKVCache as TCache
from sink_attention_tpu_torch.cache import dequantize, quantize
from sink_attention_tpu_torch.ops import decode as tdec

QUANTS = ["int8", "fp8"]


def _special_rows(D=64):
    """Rows [8, D] fp32 covering the quantizer's edges: random, all zero,
    -0 entries, values far below the row max (fp8 subnormals, flushed),
    the row max at +-448 of the scale (saturation), bf16-rounded values."""
    rs = np.random.RandomState(0)
    rows = rs.randn(8, D).astype(np.float32)
    rows[1] = 0.0
    rows[2, ::2] = -0.0
    rows[2, 1::2] = rs.randn(D // 2)
    rows[3] = rs.randn(D) * 1e-5
    rows[3, 0] = 1.0               # the rest sit below 2^-6 of the scale
    rows[4] = rs.randn(D)
    rows[4, 3], rows[4, 7] = 5.0, -5.0   # +-qmax exactly
    rows[5] = np.linspace(-448.0, 448.0, D)
    rows[6] = rs.randn(D) * 1e3
    rows[7] = np.asarray(jnp.asarray(rs.randn(D)).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    return np.concatenate([rows, rs.randn(2, 3, D).reshape(6, D)
                           .astype(np.float32)])


@pytest.mark.parametrize("quant", QUANTS)
def test_quantize_bitwise_equal_jax(quant):
    x = _special_rows()
    cj, sj = jsc.quantize(jnp.asarray(x), quant)
    ct, st = quantize(torch.from_numpy(x), quant)
    assert ct.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    assert not ct[1].any() and float(st[1]) == 0.0        # all-zero row
    if quant == "fp8":
        mag = ct.numpy() & 0x7F
        assert ((mag == 0) | (mag >= 8)).all()            # no subnormals
        assert (ct[3, 1:] == 0).any()                     # flushed
        assert int(ct[4, 3]) == 0x7E and int(ct[4, 7]) == -2  # +-448
    else:
        assert int(ct[4, 3]) == 127 and int(ct[4, 7]) == -127
    dj = jsc.dequantize(cj, sj, quant)
    dt = dequantize(ct, st, quant)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def _assert_same(tc, jc, D):
    for name in ("sink_len", "window_len", "write_pos", "seen"):
        assert getattr(tc, name) == int(getattr(jc, name)), name
    assert tc.quant == jc.quant
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k)[..., :D])
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v)[..., :D])
    np.testing.assert_array_equal(tc.k_scale.numpy(), np.asarray(jc.k_scale))
    np.testing.assert_array_equal(tc.v_scale.numpy(), np.asarray(jc.v_scale))
    lk_t, lv_t = tc.linearized_kv()
    lk_j, lv_j = jc.linearized_kv(head_dim=D)
    np.testing.assert_array_equal(lk_t.numpy(), np.asarray(lk_j))
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("case", [
    # (num_sink, window, prefill_len, appends)
    (4, 32, 50, 40),   # prefill evicts, appends wrap again
    (6, 8, 3, 12),     # prompt shorter than num_sink: sink promotion
])
def test_quantized_cache_matches_jax(quant, case):
    ns, W, n, steps = case
    B, H, D = 2, 2, 16
    rs = np.random.RandomState(1)
    k = rs.randn(B, H, n + steps, D).astype(np.float32)
    v = rs.randn(B, H, n + steps, D).astype(np.float32)
    jc = JCache.init(B, H, D, num_sink=ns, window_size=W, dtype=jnp.float32,
                     quant=quant)
    tc = TCache.init(B, H, D, num_sink=ns, window_size=W,
                     dtype=torch.float32, quant=quant, device="cpu")
    assert tc.k.dtype == torch.int8
    _assert_same(tc, jc, D)
    jc = jc.prefill(jnp.asarray(k[:, :, :n]), jnp.asarray(v[:, :, :n]))
    tc.prefill(torch.from_numpy(k[:, :, :n]), torch.from_numpy(v[:, :, :n]))
    _assert_same(tc, jc, D)
    for t in range(n, n + steps):
        jc = jc.append(jnp.asarray(k[:, :, t:t + 1]),
                       jnp.asarray(v[:, :, t:t + 1]))
        tc.append(torch.from_numpy(k[:, :, t:t + 1]),
                  torch.from_numpy(v[:, :, t:t + 1]))
        if (t - n) % 4 == 3 or t == n + steps - 1:
            _assert_same(tc, jc, D)


def _dequantized(jc):
    """The JAX cache with its storage replaced by its own dequant_kv(): the
    JAX decode over it is attention over the dequantized cache in fp32."""
    kf, vf = jc.dequant_kv()
    return jc.replace(k=kf, v=vf, quant=None)


# The JAX int8 branch rounds q and p to 8 bits (one scale per row and KV
# block) for the TPU's s8 x s8 matrix unit, and its fp8 branch rounds q and
# p to bf16: its gap to attention over the dequantized cache (measured at
# these shapes: 0.0228 int8, 0.0051 fp8).
JAX_KERNEL_GAP = {"int8": 3e-2, "fp8": 1e-2}


@pytest.mark.parametrize("quant", QUANTS)
def test_quantized_cached_decode_matches_jax(quant):
    B, H_q, H_kv, D, ns, W, n, steps = 2, 8, 2, 64, 4, 32, 40, 12
    total = n + steps
    rs = np.random.RandomState(3)
    q = rs.randn(B, H_q, total, D).astype(np.float32)
    k = rs.randn(B, H_kv, total, D).astype(np.float32)
    v = rs.randn(B, H_kv, total, D).astype(np.float32)
    aux = rs.randn(H_q).astype(np.float32)
    jc = JCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                     dtype=jnp.float32, quant=quant)
    jc = jc.prefill(jnp.asarray(k[:, :, :n]), jnp.asarray(v[:, :, :n]))
    tc = TCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                     dtype=torch.float32, quant=quant, device="cpu")
    tc.prefill(torch.from_numpy(k[:, :, :n]), torch.from_numpy(v[:, :, :n]))
    worst = 0.0
    for t in range(n, total):
        sl = slice(t, t + 1)
        jc = jc.append(jnp.asarray(k[:, :, sl]), jnp.asarray(v[:, :, sl]))
        tc.append(torch.from_numpy(k[:, :, sl]), torch.from_numpy(v[:, :, sl]))
        if (t - n) % 3 != 2:   # every third step (the JAX kernels are slow)
            continue
        qj = jnp.asarray(q[:, :, sl])
        o_t = tdec.sink_decode_attention_cached(torch.from_numpy(q[:, :, sl]),
                                                tc, s_aux=torch.from_numpy(aux))
        o_ref = jops.sink_decode_attention_cached(qj, _dequantized(jc),
                                                  s_aux=jnp.asarray(aux))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_ref), atol=1e-5,
                                   err_msg=f"step {t}")
        o_j = jops.sink_decode_attention_cached(qj, jc, s_aux=jnp.asarray(aux))
        worst = max(worst, float(np.abs(o_t.numpy() - np.asarray(o_j)).max()))
    assert worst <= JAX_KERNEL_GAP[quant], worst


def test_quantized_plain_decode_is_attention_over_dequantized():
    """decode_plain over codes and scales equals decode_plain over the
    dequantized fp32 buffers (the quantized kernels' contract)."""
    rs = np.random.RandomState(5)
    tc = TCache.init(2, 2, 64, num_sink=4, window_size=32, quant="fp8",
                     device="cpu")
    tc.prefill(torch.from_numpy(rs.randn(2, 2, 45, 64).astype(np.float32)),
               torch.from_numpy(rs.randn(2, 2, 45, 64).astype(np.float32)))
    q = torch.from_numpy(rs.randn(2, 8, 1, 64).astype(np.float32))
    lens = tdec._uniform_lens(tc.sink_len, tc.window_len, tc.write_pos,
                              tc.window_size, tc.sink_cap, 2, "cpu")
    kf, vf = tc.dequant_kv()
    got = tdec.decode_plain(q, tc.k, tc.v, lens, None,
                            **tdec.cache_args(tc))
    ref = tdec.decode_plain(q, kf, vf, lens, None, sink_cap=tc.sink_cap,
                            window_size=tc.window_size)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
