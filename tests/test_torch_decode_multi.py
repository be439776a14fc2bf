"""The port's multi-token decode ops (speculative verification) against the
JAX package's: ``sink_decode_attention_cached_multi`` over the cases of the
JAX tests (wrapping rings, one token, a draft as long as the window, a
prompt shorter than num_sink, an int8 cache), the cache it returns against
sequential appends, its argument left as it was; and
``sink_decode_attention_ragged_multi`` over slots at different lengths."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
from sink_attention_tpu.cache import RaggedSinkKVCache as JRagged
from sink_attention_tpu.cache import SinkKVCache as JCache
from sink_attention_tpu.ops.decode import (
    sink_decode_attention_cached_multi as j_cached_multi)
from sink_attention_tpu.ops.decode import (
    sink_decode_attention_ragged_multi as j_ragged_multi)
from sink_attention_tpu_torch.cache import RaggedSinkKVCache as TRagged
from sink_attention_tpu_torch.cache import SinkKVCache as TCache
from sink_attention_tpu_torch.ops import sink_decode_attention_cached_multi
from sink_attention_tpu_torch.ops.decode import (
    sink_decode_attention_ragged_multi)

B, HQ, HKV, D, NS, W = 1, 4, 2, 32, 4, 64
BUFFERS = ("k", "v", "k_scale", "v_scale")
STATE = ("sink_len", "window_len", "write_pos", "seen")


def _snapshot(c):
    return ([getattr(c, n).clone() for n in BUFFERS],
            [getattr(c, n) for n in STATE])


def _assert_same_cache(a, b):
    for n in BUFFERS:
        assert torch.equal(getattr(a, n), getattr(b, n)), n
    for n in STATE:
        assert getattr(a, n) == getattr(b, n), n


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("P,T", [(100, 4), (60, 1), (5, 3), (40, 64),
                                 (2, 3)])   # the last: P < num_sink
def test_cached_multi_matches_jax(P, T, quant):
    rs = np.random.RandomState(P + T)
    q = rs.randn(B, HQ, P + T, D).astype(np.float32)
    k = rs.randn(B, HKV, P + T, D).astype(np.float32)
    v = rs.randn(B, HKV, P + T, D).astype(np.float32)
    aux = rs.randn(HQ).astype(np.float32)
    jc = JCache.init(B, HKV, D, num_sink=NS, window_size=W,
                     dtype=jnp.float32, quant=quant).prefill(
        jnp.asarray(k[:, :, :P]), jnp.asarray(v[:, :, :P]))
    tc = TCache.init(B, HKV, D, num_sink=NS, window_size=W,
                     dtype=torch.float32, quant=quant, device="cpu")
    tc.prefill(torch.from_numpy(k[:, :, :P]), torch.from_numpy(v[:, :, :P]))
    before = _snapshot(tc)

    o_j, jc2 = j_cached_multi(jnp.asarray(q[:, :, P:]),
                              jnp.asarray(k[:, :, P:]),
                              jnp.asarray(v[:, :, P:]), jc,
                              s_aux=jnp.asarray(aux))
    tk, tv = torch.from_numpy(k[:, :, P:]), torch.from_numpy(v[:, :, P:])
    o_t, tc2 = sink_decode_attention_cached_multi(
        torch.from_numpy(q[:, :, P:]), tk, tv, tc,
        s_aux=torch.from_numpy(aux))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    # the returned cache: the drafts appended, as JAX's and as T appends
    assert tc2 is not tc and tc2.seen == P + T == int(jc2.seen)
    for n in BUFFERS:
        np.testing.assert_array_equal(
            getattr(tc2, n).numpy(),
            np.asarray(getattr(jc2, n))[..., :getattr(tc2, n).shape[-1]])
    seq = tc.clone()
    for t in range(T):
        seq.append(tk[:, :, t:t + 1], tv[:, :, t:t + 1])
    _assert_same_cache(tc2, seq)
    # the argument is left as it was
    bufs, state = before
    assert all(torch.equal(b, getattr(tc, n)) for b, n in zip(bufs, BUFFERS))
    assert state == [getattr(tc, n) for n in STATE]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_ragged_multi_matches_jax(quant):
    """Four slots: a wrapped ring, a ring not yet full, a prompt inside
    the sinks and an empty slot, each verifying T=4 drafts against its
    own view; the cache is not advanced."""
    rs = np.random.RandomState(3)
    lens, T, n = [150, 30, 2, 0], 4, 4
    jc = JRagged.init(n, HKV, D, num_sink=NS, window_size=W,
                      dtype=jnp.float32, quant=quant)
    tc = TRagged.init(n, HKV, D, num_sink=NS, window_size=W,
                      dtype=torch.float32, quant=quant, device="cpu")
    for b, length in enumerate(lens):
        if length:
            ks = rs.randn(HKV, 160, D).astype(np.float32)
            vs = rs.randn(HKV, 160, D).astype(np.float32)
            jc = jc.insert(b, jnp.asarray(ks), jnp.asarray(vs), length)
            tc.insert(b, torch.from_numpy(ks), torch.from_numpy(vs), length)
    q = rs.randn(n, HQ, T, D).astype(np.float32)
    k = rs.randn(n, HKV, T, D).astype(np.float32)
    v = rs.randn(n, HKV, T, D).astype(np.float32)
    aux = rs.randn(HQ).astype(np.float32)
    seen = tc.seen.clone()
    o_j = j_ragged_multi(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
                         s_aux=jnp.asarray(aux))
    o_t = sink_decode_attention_ragged_multi(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tc,
        s_aux=torch.from_numpy(aux))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    assert torch.equal(tc.seen, seen)


def test_multi_refuses_a_draft_longer_than_the_window():
    tc = TCache.init(1, HKV, D, num_sink=NS, window_size=8,
                     dtype=torch.float32, device="cpu")
    x = torch.zeros(1, HKV, 9, D)
    with pytest.raises(ValueError, match="window"):
        sink_decode_attention_cached_multi(torch.zeros(1, HQ, 9, D), x, x,
                                           tc)
