"""The port's prefill attention against the JAX package's.

On the CPU the port's wrapper runs the kernel's plain version; the JAX side
runs its Pallas kernel in interpret mode, as its own tests do. The host-side
KV-range table that the CUDA kernel walks is checked here against the mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.ops as jops
from sink_attention_tpu_torch.ops import flash as tflash
from sink_attention_tpu_torch.ops.reference import sink_window_mask

CONFIGS = [
    # (B, H_q, H_kv, N, D, num_sink, window, use_aux, q_offset)
    (2, 4, 2, 256, 64, 4, 128, False, 0),    # GQA 2:1, batch
    (1, 8, 2, 192, 80, 4, 96, True, 0),      # GQA 4:1, head_dim 80
    (1, 2, 2, 300, 128, 16, 128, False, 0),  # multi-sink, non-aligned N
    (1, 2, 1, 256, 64, 0, 128, True, 0),     # num_sink=0 with s_aux
    (1, 4, 2, 128, 64, 4, 64, True, 128),    # chunk at a nonzero q_offset
]


def _inputs(seed, B, H_q, H_kv, N_q, N_kv, D, use_aux):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H_q, N_q, D).astype(np.float32)
    k = rs.randn(B, H_kv, N_kv, D).astype(np.float32)
    v = rs.randn(B, H_kv, N_kv, D).astype(np.float32)
    aux = (rs.randn(H_q) * 2.0).astype(np.float32) if use_aux else None
    return q, k, v, aux


@pytest.mark.parametrize("cfg", CONFIGS)
def test_forward_with_lse_matches_jax(cfg):
    B, H_q, H_kv, N, D, ns, W, use_aux, qo = cfg
    n_kv = N + qo  # a q chunk at qo attends the KV prefix up to it
    q, k, v, aux = _inputs(0, B, H_q, H_kv, N, n_kv, D, use_aux)
    o_j, lse_j = jops.sink_flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_sink=ns,
        window_size=W, s_aux=None if aux is None else jnp.asarray(aux),
        q_offset=qo)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    aux_t = None if aux is None else torch.from_numpy(aux)
    o_t, lse_t = tflash.sink_flash_attention_with_lse(
        *t, num_sink=ns, window_size=W, s_aux=aux_t, q_offset=qo)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5,
                               rtol=1e-3)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4,
                               rtol=1e-4)
    o_only = tflash.sink_flash_attention(*t, num_sink=ns, window_size=W,
                                         s_aux=aux_t, q_offset=qo)
    np.testing.assert_array_equal(o_only.numpy(), o_t.numpy())


def test_merge_partials_matches_jax():
    rs = np.random.RandomState(1)
    B, H, N, D = 2, 3, 5, 8
    outs = [rs.randn(B, H, N, D).astype(np.float32) for _ in range(3)]
    lses = [rs.randn(B, H, N).astype(np.float32) for _ in range(3)]
    lses[1][0, 0, :] = -np.inf  # a zero-mass partial
    aux = rs.randn(H).astype(np.float32)
    for a in (None, aux):
        o_j, l_j = jops.merge_partials(
            [jnp.asarray(o) for o in outs], [jnp.asarray(l) for l in lses],
            None if a is None else jnp.asarray(a))
        o_t, l_t = tflash.merge_partials(
            [torch.from_numpy(o) for o in outs],
            [torch.from_numpy(l) for l in lses],
            None if a is None else torch.from_numpy(a))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
        np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-5)


def test_split_kv_merge_equals_full():
    """Two KV chunks merged by LSE equal attention over the whole KV."""
    q, k, v, aux = _inputs(2, 1, 4, 2, 64, 64, 16, True)
    q, k, v, aux = (torch.from_numpy(x) for x in (q, k, v, aux))
    full = tflash.sink_flash_attention(q, k, v, 4, 24, s_aux=aux)
    parts = [tflash.sink_flash_attention_with_lse(
        q, k[:, :, s], v[:, :, s], 4, 24, kv_offset=s.start)
        for s in (slice(0, 40), slice(40, 64))]
    merged, _ = tflash.merge_partials([p[0] for p in parts],
                                      [p[1] for p in parts], aux)
    np.testing.assert_allclose(merged.numpy(), full.numpy(), atol=1e-5)


@pytest.mark.parametrize("geom", [
    # (n_q, n_kv, num_sink, window, q_offset, kv_offset)
    (256, 256, 4, 128, 0, 0),
    (300, 300, 16, 128, 0, 0),
    (256, 256, 0, 1, 0, 0),
    (128, 384, 4, 96, 256, 0),
    (192, 256, 4, 96, 192, 64),
    (200, 150, 70, 33, 64, -10),
    (1024, 1024, 0, 1024, 0, 0),
])
@pytest.mark.parametrize("tiles", [(64, 64), (128, 128), (128, 64)])
def test_kv_range_table_covers_mask_once(geom, tiles):
    """The range table at 64 x 64 tiles, the forward kernel's 128 x 128
    (also the ablation's) and the dQ kernel's 128 x 64."""
    n_q, n_kv, ns, W, qo, ko = geom
    bm, bn = tiles
    table = tflash.fwd_kv_ranges(n_q, n_kv, ns, W, qo, ko, bm=bm, bn=bn)
    mask = sink_window_mask(n_q, n_kv, ns, W, qo, ko).numpy()
    mask &= (np.arange(n_kv) + ko >= 0)[None, :]
    n_kv_blocks = -(-n_kv // bn)
    assert table.shape == (-(-n_q // bm), 4)
    for qi, (s0, s1, w0, w1) in enumerate(table):
        visited = list(range(s0, s1)) + list(range(w0, w1))
        assert len(visited) == len(set(visited)), (qi, table[qi])
        assert all(0 <= b < n_kv_blocks for b in visited)
        needed = np.nonzero(mask[qi * bm:(qi + 1) * bm].any(axis=0))[0]
        assert set(needed // bn) <= set(visited), (qi, table[qi])
