"""The port's SinkKVCache against the JAX package's: state and buffers
(``[..., :D]``; the port stores D unpadded) after every call, for the
decode path and for the speculative and beam methods (``append(keep=)``,
``append_many``, ``append_many_counted``, ``update``, ``reorder``; the
ragged cache's ``append_many_counted``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
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


# -- the speculative and beam methods, bit for bit --------------------------

STATE = ("sink_len", "window_len", "write_pos", "seen")


def _assert_bits(tc, jc):
    """Every state field and every buffer (codes and scales) equal."""
    for name in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(tc, name)),
                                      np.asarray(getattr(jc, name)), name)
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            getattr(tc, name).numpy(),
            np.asarray(getattr(jc, name))[..., :getattr(tc, name).shape[-1]],
            name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)


def _full_ring(quant, ns=2, W=4, n=9):
    """A cache with a full ring (n > ns + W tokens seen), in both
    packages, and the seeded generator that made it."""
    rs = np.random.RandomState(11)
    k = rs.randn(B, H, n, D).astype(np.float32)
    v = rs.randn(B, H, n, D).astype(np.float32)
    jc = JCache.init(B, H, D, num_sink=ns, window_size=W, dtype=jnp.float32,
                     quant=quant).prefill(jnp.asarray(k), jnp.asarray(v))
    tc = TCache.init(B, H, D, num_sink=ns, window_size=W, dtype=torch.float32,
                     quant=quant, device="cpu")
    tc.prefill(torch.from_numpy(k), torch.from_numpy(v))
    assert tc.window_len == W
    return jc, tc, rs


@pytest.mark.parametrize("quant", [None, "int8"])
def test_append_keep_and_counted_commit_match_jax(quant):
    """append(keep=False) is a no-op; append_many_counted on a full ring
    keeps exactly its first ``count`` tokens (the oldest live tokens
    survive the rejected ones, JAX tests/test_cache.py:208) and equals
    append_many of them; append_many equals T appends."""
    jc, tc, rs = _full_ring(quant)
    kd = rs.randn(B, H, 4, D).astype(np.float32)
    vd = rs.randn(B, H, 4, D).astype(np.float32)
    jk, jv = jnp.asarray(kd), jnp.asarray(vd)
    tk, tv = torch.from_numpy(kd), torch.from_numpy(vd)

    jn = jc.append(jk[:, :, :1], jv[:, :, :1], keep=jnp.asarray(False))
    t1 = tc.clone()
    assert t1.append(tk[:, :, :1], tv[:, :, :1], keep=False) is t1
    _assert_bits(t1, jn)
    _assert_bits(tc, jc)
    for count in (0, 2, 4):
        jg = jc.append_many_counted(jk, jv, jnp.int32(count))
        tg = tc.clone().append_many_counted(tk, tv, torch.tensor(count))
        _assert_bits(tg, jg)
        want = tc.clone().append_many(tk[:, :, :count], tv[:, :, :count])
        _assert_bits(want, jg)
        assert tg.seen == 9 + count
    _assert_bits(tc, jc)   # the clones left the original as it was
    _assert_bits(tc.append_many(tk, tv), jc.append_many(jk, jv))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_update_and_reorder_match_jax(quant):
    """update: N > 1 tokens prefill an empty cache, one token appends;
    reorder gathers batch rows (a swap, then a repeated row)."""
    rs = np.random.RandomState(12)
    k = rs.randn(B, H, 7, D).astype(np.float32)
    v = rs.randn(B, H, 7, D).astype(np.float32)
    jc = JCache.init(B, H, D, num_sink=2, window_size=4, dtype=jnp.float32,
                     quant=quant)
    tc = TCache.init(B, H, D, num_sink=2, window_size=4, dtype=torch.float32,
                     quant=quant, device="cpu")
    for lo, hi in ((0, 6), (6, 7)):
        jc = jc.update(jnp.asarray(k[:, :, lo:hi]), jnp.asarray(v[:, :, lo:hi]))
        assert tc.update(torch.from_numpy(k[:, :, lo:hi]),
                         torch.from_numpy(v[:, :, lo:hi])) is tc
        _assert_bits(tc, jc)
    for idx in ([1, 0], [1, 1]):
        jc = jc.reorder(jnp.asarray(idx, jnp.int32))
        assert tc.reorder(torch.tensor(idx)) is tc
        _assert_bits(tc, jc)


def _ragged_pair(W, quant, lens, n_pad):
    """A ragged pool in both packages: slot b holds ``lens[b]`` seeded
    tokens (0: empty); the port's buffers and state are then set to the
    JAX cache's, so every buffer row starts equal."""
    from sink_attention_tpu.cache import RaggedSinkKVCache as JRagged
    from sink_attention_tpu_torch.cache import RaggedSinkKVCache as TRagged
    rs = np.random.RandomState(W)
    n = len(lens)
    jc = JRagged.init(n, H, D, num_sink=2, window_size=W, dtype=jnp.float32,
                      quant=quant)
    for b, length in enumerate(lens):
        if length:
            ks = rs.randn(H, n_pad, D).astype(np.float32)
            vs = rs.randn(H, n_pad, D).astype(np.float32)
            jc = jc.insert(b, jnp.asarray(ks), jnp.asarray(vs), length)
    tc = TRagged.init(n, H, D, num_sink=2, window_size=W, dtype=torch.float32,
                      quant=quant, device="cpu")
    for name in ("k", "v", "k_scale", "v_scale") + STATE:
        arr = np.array(getattr(jc, name))
        if name in ("k", "v"):
            arr = arr[..., :D]
        setattr(tc, name, torch.from_numpy(np.ascontiguousarray(arr)))
    return jc, tc, rs


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("W", [16, 128])  # park slot; read-back select
def test_ragged_append_many_counted_matches_jax(W, quant):
    """Per-slot counted commits of 4 tokens over three rounds, slots at
    different lengths (a full ring, a short prompt inside the sinks, an
    empty slot): every buffer and state field equal to JAX's."""
    lens = [W + 20, W + 3, 1, 0]
    jc, tc, rs = _ragged_pair(W, quant, lens, n_pad=W + 32)
    assert (tc.window_cap > W) == (W == 16)
    _assert_bits(tc, jc)
    for counts in ([2, 0, 4, 0], [4, 1, 0, 0], [0, 3, 2, 0]):
        kd = rs.randn(len(lens), H, 4, D).astype(np.float32)
        vd = rs.randn(len(lens), H, 4, D).astype(np.float32)
        jc = jc.append_many_counted(jnp.asarray(kd), jnp.asarray(vd),
                                    jnp.asarray(counts, jnp.int32))
        assert tc.append_many_counted(
            torch.from_numpy(kd), torch.from_numpy(vd),
            torch.tensor(counts, dtype=torch.int32)) is tc
        _assert_bits(tc, jc)
    assert tc.seen.tolist() == [W + 26, W + 7, 7, 0]
