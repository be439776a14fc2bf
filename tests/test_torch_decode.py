"""The port's decode attention against the JAX package's, step by step
over the rolling cache past the ring's wrap, with GQA and s_aux."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.ops as jops
from sink_attention_tpu.cache import SinkKVCache as JCache
from sink_attention_tpu_torch.cache import SinkKVCache as TCache
from sink_attention_tpu_torch.ops import decode as tdec


@pytest.mark.parametrize("case", [
    # (B, H_q, H_kv, D, num_sink, window, prefill_len, steps, use_aux)
    (2, 8, 2, 32, 4, 32, 40, 30, True),    # GQA 4:1, sinks, wraps
    (1, 4, 4, 16, 0, 16, 10, 24, True),    # no sinks, pre-wrap then wrap
    (1, 4, 2, 16, 6, 8, 3, 12, False),     # sink promotion, no s_aux
])
def test_cached_decode_matches_jax(case):
    B, H_q, H_kv, D, ns, W, n, steps, use_aux = case
    total = n + steps
    rs = np.random.RandomState(3)
    q = rs.randn(B, H_q, total, D).astype(np.float32)
    k = rs.randn(B, H_kv, total, D).astype(np.float32)
    v = rs.randn(B, H_kv, total, D).astype(np.float32)
    aux = rs.randn(H_q).astype(np.float32) if use_aux else None
    jaux = None if aux is None else jnp.asarray(aux)
    taux = None if aux is None else torch.from_numpy(aux)

    jc = JCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                     dtype=jnp.float32)
    jc = jc.prefill(jnp.asarray(k[:, :, :n]), jnp.asarray(v[:, :, :n]))
    tc = TCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                     dtype=torch.float32, device="cpu")
    tc.prefill(torch.from_numpy(k[:, :, :n]), torch.from_numpy(v[:, :, :n]))
    for t in range(n, total):
        sl = slice(t, t + 1)
        jc = jc.append(jnp.asarray(k[:, :, sl]), jnp.asarray(v[:, :, sl]))
        tc.append(torch.from_numpy(k[:, :, sl]), torch.from_numpy(v[:, :, sl]))
        o_j = jops.sink_decode_attention_cached(jnp.asarray(q[:, :, sl]), jc,
                                                s_aux=jaux)
        o_t = tdec.sink_decode_attention_cached(torch.from_numpy(q[:, :, sl]),
                                                tc, s_aux=taux)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("use_aux", [False, True])
def test_plain_kv_decode_matches_jax(use_aux):
    rs = np.random.RandomState(4)
    q = rs.randn(2, 8, 1, 32).astype(np.float32)
    k = rs.randn(2, 2, 150, 32).astype(np.float32)
    v = rs.randn(2, 2, 150, 32).astype(np.float32)
    aux = rs.randn(8).astype(np.float32) if use_aux else None
    o_j = jops.sink_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        s_aux=None if aux is None else jnp.asarray(aux))
    o_t = tdec.sink_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        s_aux=None if aux is None else torch.from_numpy(aux))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


def test_live_slots_of_wrapped_ring():
    """After a wrap every window slot is live; before it, the prefix only."""
    lens = torch.tensor([[2, 8, 3, 136], [2, 5, 5, 133]], dtype=torch.int32)
    live = tdec.live_slots(lens, 256, 128, 8)
    assert live[0].tolist() == ([True] * 2 + [False] * 126 + [True] * 8 +
                                [False] * 120)
    assert live[1].tolist() == ([True] * 2 + [False] * 126 + [True] * 5 +
                                [False] * 123)
