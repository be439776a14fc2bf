"""The port's SinkKVCache against the JAX package's: state and buffers
(``[..., :D]``; the port stores D unpadded) after every call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sink_attention_tpu.cache import SinkKVCache as JCache
from sink_attention_tpu_torch.cache import SinkKVCache as TCache

B, H, D = 2, 2, 16


def _assert_same(tc, jc):
    for name in ("sink_len", "window_len", "write_pos", "seen"):
        assert getattr(tc, name) == int(getattr(jc, name)), name
    assert (tc.sink_cap, tc.window_cap, tc.s_total) == (
        jc.sink_cap, jc.window_cap, jc.s_total)
    assert tc.get_seq_length() == int(jc.get_seq_length())
    assert tc.get_max_cache_shape() == jc.get_max_cache_shape()
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k)[..., :D])
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v)[..., :D])
    lk_t, lv_t = tc.linearized_kv()
    lk_j, lv_j = jc.linearized_kv(head_dim=D)  # JAX pads D to 128
    np.testing.assert_array_equal(lk_t.numpy(), np.asarray(lk_j))
    np.testing.assert_array_equal(lv_t.numpy(), np.asarray(lv_j))


@pytest.mark.parametrize("case", [
    # (num_sink, window, prefill_len, appends)
    (4, 32, 20, 30),   # N < W, then appends across the wrap
    (4, 32, 50, 40),   # N > W: prefill evicts, appends wrap again
    (0, 16, 40, 20),   # no sinks
    (6, 8, 3, 12),     # prompt shorter than num_sink: sink promotion
])
def test_cache_matches_jax(case):
    ns, W, n, steps = case
    rs = np.random.RandomState(0)
    k = rs.randn(B, H, n + steps, D).astype(np.float32)
    v = rs.randn(B, H, n + steps, D).astype(np.float32)
    jc = JCache.init(B, H, D, num_sink=ns, window_size=W, dtype=jnp.float32)
    tc = TCache.init(B, H, D, num_sink=ns, window_size=W,
                     dtype=torch.float32, device="cpu")
    _assert_same(tc, jc)
    jc = jc.prefill(jnp.asarray(k[:, :, :n]), jnp.asarray(v[:, :, :n]))
    assert tc.prefill(torch.from_numpy(k[:, :, :n]),
                      torch.from_numpy(v[:, :, :n])) is tc
    _assert_same(tc, jc)
    for t in range(n, n + steps):
        jc = jc.append(jnp.asarray(k[:, :, t:t + 1]),
                       jnp.asarray(v[:, :, t:t + 1]))
        tc.append(torch.from_numpy(k[:, :, t:t + 1]),
                  torch.from_numpy(v[:, :, t:t + 1]))
        _assert_same(tc, jc)


def test_quantized_cache_not_ported():
    """int8 and fp8 storage are ported (tests/test_torch_quant_cache.py);
    any other quant, as in the JAX package, is refused."""
    with pytest.raises(ValueError, match="quant"):
        TCache.init(1, 1, 16, quant="int4", device="cpu")
    assert TCache.init(1, 1, 16, quant="fp8", device="cpu").k.dtype == \
        torch.int8
