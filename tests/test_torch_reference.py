"""The port's eager oracle against the JAX package's, on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
from sink_attention_tpu.ops import reference as jref
from sink_attention_tpu_torch.ops import reference as tref


@pytest.mark.parametrize("use_aux", [False, True])
@pytest.mark.parametrize("cfg", [
    # (B, H_q, H_kv, N_q, N_kv, D, num_sink, window, q_offset, kv_offset)
    (2, 4, 2, 48, 48, 16, 4, 16, 0, 0),
    (1, 4, 1, 24, 64, 32, 2, 8, 40, 0),      # rectangular, MQA
    (1, 2, 2, 16, 32, 8, 0, 4, 0, 20),       # kv ahead of q: empty rows
])
def test_oracle_parity(cfg, use_aux):
    B, H_q, H_kv, N_q, N_kv, D, ns, W, qo, ko = cfg
    rs = np.random.RandomState(0)
    q = rs.randn(B, H_q, N_q, D).astype(np.float32)
    k = rs.randn(B, H_kv, N_kv, D).astype(np.float32)
    v = rs.randn(B, H_kv, N_kv, D).astype(np.float32)
    aux = rs.randn(H_q).astype(np.float32) if use_aux else None

    o_j, lse_j = jref.eager_sink_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), ns, W,
        None if aux is None else jnp.asarray(aux), qo, ko, return_lse=True)
    o_t, lse_t = tref.eager_sink_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), ns, W,
        None if aux is None else torch.from_numpy(aux), qo, ko,
        return_lse=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_array_equal(np.isinf(lse_t.numpy()),
                                  np.isinf(np.asarray(lse_j)))
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5)


def test_mask_parity():
    for args in [(7, 9, 2, 3, 0, 0), (5, 12, 4, 100, 6, 1),
                 (8, 8, 0, 1, 3, 2)]:
        np.testing.assert_array_equal(
            tref.sink_window_mask(*args).numpy(),
            np.asarray(jref.sink_window_mask(*args)))
