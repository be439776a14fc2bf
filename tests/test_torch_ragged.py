"""The port's RaggedSinkKVCache and ragged decode attention against the JAX
package's: per-slot state, live buffer rows and linearized KV after every
insert, clear and masked append (both append branches), for fp32
storage and int8/fp8 codes; then the ragged decode per slot."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.ops as jops
from sink_attention_tpu.cache import RaggedSinkKVCache as JRagged
from sink_attention_tpu_torch.cache import RaggedSinkKVCache as TRagged
from sink_attention_tpu_torch.ops import decode as tdec

B, H_Q, H_KV, D, NS = 4, 4, 2, 16, 2
STATE = ("sink_len", "window_len", "write_pos", "seen")


def _assert_same(tc, jc):
    """State equal; live buffer rows (codes and scales) and every slot's
    linearized KV equal. Junk rows (never attended) are not compared."""
    for name in STATE:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    live = tdec.live_slots(tdec.ragged_lens(tc), tc.s_total, tc.sink_cap,
                           tc.window_size).numpy()          # [B, S]
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(
            t.numpy().transpose(0, 2, 1, 3)[live],
            np.asarray(j)[..., :D].transpose(0, 2, 1, 3)[live])
    for t, j in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
        np.testing.assert_array_equal(t.numpy().transpose(0, 2, 1)[live],
                                      np.asarray(j).transpose(0, 2, 1)[live])
    for b in range(B):
        for t, j in zip(tc.linearized_kv_slot(b),
                        jc.linearized_kv_slot(b, head_dim=D)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _decode_same(tc, jc, rs, quant):
    """Ragged decode of one seeded query, the port (its plain version)
    against the JAX kernel over the same cache: dequantized first when
    quantized (the JAX int8/fp8 branches round q and p; the port computes
    attention over the dequantized cache). An empty slot gives zeros."""
    q = rs.randn(B, H_Q, 1, D).astype(np.float32)
    aux = rs.randn(H_Q).astype(np.float32)
    if quant:
        kf, vf = jc.dequant_kv()
        jc = jc.replace(k=kf, v=vf, quant=None)
    o_j = jops.sink_decode_attention_ragged(jnp.asarray(q), jc,
                                            s_aux=jnp.asarray(aux))
    o_t = tdec.sink_decode_attention_ragged(torch.from_numpy(q), tc,
                                            s_aux=torch.from_numpy(aux))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    empty = (tc.sink_len + tc.window_len == 0).numpy()
    assert empty.any() and not o_t.numpy()[empty].any()


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("W", [100, 128])  # park slot; read-modify-write
def test_ragged_cache_matches_jax(quant, W):
    rs = np.random.RandomState(W)
    jc = JRagged.init(B, H_KV, D, num_sink=NS, window_size=W,
                      dtype=jnp.float32, quant=quant)
    tc = TRagged.init(B, H_KV, D, num_sink=NS, window_size=W,
                      dtype=torch.float32, quant=quant, device="cpu")
    assert (tc.window_cap > W) == (W == 100)

    def insert(slot, n, n_pad):
        nonlocal jc
        k = rs.randn(H_KV, n_pad, D).astype(np.float32)
        v = rs.randn(H_KV, n_pad, D).astype(np.float32)
        jc = jc.insert(slot, jnp.asarray(k), jnp.asarray(v), n)
        tc.insert(slot, torch.from_numpy(k), torch.from_numpy(v), n)
        _assert_same(tc, jc)

    def append(active, check=True):
        nonlocal jc
        k = rs.randn(B, H_KV, 1, D).astype(np.float32)
        v = rs.randn(B, H_KV, 1, D).astype(np.float32)
        jc = jc.append(jnp.asarray(k), jnp.asarray(v), jnp.asarray(active))
        tc.append(torch.from_numpy(k), torch.from_numpy(v),
                  torch.tensor(active))
        if check:
            _assert_same(tc, jc)

    insert(0, 1, 16)      # shorter than num_sink: promotion on append
    insert(1, 150, 160)   # longer than sinks + window: the middle evicted
    insert(3, W - 3, W + 12)  # slot 2 stays empty
    lk, _ = tc.linearized_kv_slot(1)
    assert lk.shape[1] == NS + W
    for i in range(8):    # slots at different ring phases; slot 3 fills
        append([True, i % 3 != 0, False, i % 2 == 0], check=i % 4 == 3)
    _decode_same(tc, jc, rs, quant)
    jc = jc.clear(1)
    tc.clear(1)
    _assert_same(tc, jc)
    assert int(tc.seen[1]) == 0 and int(tc.get_seq_length()[1]) == 0
    for i in range(3):    # slot 3 wraps its ring
        append([False, False, False, True], check=i == 2)
    insert(1, 20, 32)     # the slot is reused
    append([True, True, False, True])
    assert int(tc.window_len[3]) == W and int(tc.write_pos[3]) > 0
    _decode_same(tc, jc, rs, quant)


def test_ragged_append_inactive_slot_keeps_full_ring():
    """A full ring (window_cap == window_size) with an inactive slot: its
    next write slot holds its oldest live token, which the append keeps."""
    tc = TRagged.init(2, 1, D, num_sink=0, window_size=128,
                      dtype=torch.float32, device="cpu")
    k = torch.randn(1, 200, D)
    for b in range(2):
        tc.insert(b, k, k, 200)
    before = tc.k.clone()
    tc.append(torch.randn(2, 1, 1, D), torch.randn(2, 1, 1, D),
              torch.tensor([True, False]))
    assert torch.equal(tc.k[1], before[1])
    assert not torch.equal(tc.k[0], before[0])
    assert tc.seen.tolist() == [201, 200]
    assert tc.write_pos.tolist() == [1, 0]
