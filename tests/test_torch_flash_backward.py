"""The port's attention gradients against the JAX package's.

On the CPU the port's autograd function runs the backward kernels' plain
version; the JAX side runs its Pallas backward kernels in interpret mode,
as its own tests do (jitted, once per case). The host tables that the
dK/dV kernel walks are checked against the mask and against the JAX
package's own schedule here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.ops as jops
from sink_attention_tpu.ops.flash import _dkdv_q_step as j_dkdv_q_step
from sink_attention_tpu.ops.flash import sink_flash_attention_chunk as j_chunk
from sink_attention_tpu_torch.ops import flash as tflash
from sink_attention_tpu_torch.ops.reference import sink_window_mask

CONFIGS = [
    # (B, H_q, H_kv, N, D, num_sink, window, use_aux): four of the cases of
    # tests/test_flash_backward.py
    (1, 4, 2, 256, 64, 4, 128, True),    # GQA + s_aux
    (1, 2, 2, 256, 64, 0, 64, False),    # pure window
    (2, 4, 1, 128, 64, 16, 32, True),    # MQA, multi-sink
    (1, 2, 2, 192, 80, 4, 96, True),     # head_dim 80
]


def _randn(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(i):
    """Inputs and the JAX gradients of sum(out * do) for CONFIGS[i]."""
    B, H_q, H_kv, N, D, ns, W, use_aux = CONFIGS[i]
    rs = np.random.RandomState(i)
    x = [_randn(rs, B, H_q, N, D), _randn(rs, B, H_kv, N, D),
         _randn(rs, B, H_kv, N, D)]
    if use_aux:
        x.append(_randn(rs, H_q))
    do = _randn(rs, B, H_q, N, D)

    def loss(q, k, v, aux=None):
        out = jops.sink_flash_attention(q, k, v, num_sink=ns, window_size=W,
                                        s_aux=aux)
        return jnp.sum(out * do)

    grads = jax.jit(jax.grad(loss, tuple(range(len(x)))))(
        *map(jnp.asarray, x))
    return x, do, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_grads_match_jax(i):
    _, _, _, _, _, ns, W, use_aux = CONFIGS[i]
    x, do, ref = _case(i)
    leaves = [torch.from_numpy(a).requires_grad_() for a in x]
    out = tflash.sink_flash_attention(*leaves[:3], ns, W,
                                      s_aux=leaves[3] if use_aux else None)
    out.backward(torch.from_numpy(do))
    for name, t, r in zip(("dq", "dk", "dv", "ds_aux"), leaves, ref):
        np.testing.assert_allclose(t.grad.numpy(), r, atol=1e-4, rtol=1e-2,
                                   err_msg=f"{name}, config {CONFIGS[i]}")


def test_ds_aux_finite_differences():
    """ds_aux against central differences of the port's own forward (the
    JAX suite's check; rel tolerance: the fp32 rounding of the large loss
    dominates the difference quotient)."""
    B, H_q, H_kv, N, D, ns, W = 1, 4, 2, 128, 32, 4, 32
    rs = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(_randn(rs, B, h, N, D))
               for h in (H_q, H_kv, H_kv))
    aux = torch.from_numpy(_randn(rs, H_q))

    def loss(a):
        return (tflash.sink_flash_attention(q, k, v, ns, W, s_aux=a) ** 2
                ).sum()

    a = aux.clone().requires_grad_()
    loss(a).backward()
    eps = 1e-3
    numeric = np.zeros(H_q, np.float32)
    with torch.no_grad():
        for h in range(H_q):
            e = torch.zeros(H_q)
            e[h] = eps
            numeric[h] = (float(loss(aux + e)) - float(loss(aux - e))) / (
                2 * eps)
    np.testing.assert_allclose(a.grad.numpy(), numeric, atol=5e-2,
                               rtol=5e-2)


def test_chunk_grads_match_jax_with_garbage_halo():
    """A halo of garbage before the sequence (kv_offset < 0): the chunk's
    gradients through both outputs (out and lse) equal the JAX chunk's,
    and the halo slots get exactly zero gradient."""
    B, H, D, n_q, halo, ns, W = 1, 2, 32, 256, 256, 4, 256
    rs = np.random.RandomState(40)
    q = _randn(rs, B, H, n_q, D)
    k = np.concatenate([np.full((B, H, halo, D), 7.7, np.float32),
                        _randn(rs, B, H, n_q, D)], axis=2)
    v = np.concatenate([np.full((B, H, halo, D), 7.7, np.float32),
                        _randn(rs, B, H, n_q, D)], axis=2)
    do, dl = _randn(rs, B, H, n_q, D), _randn(rs, B, H, n_q)
    offsets = (0, -halo)

    def loss(q, k, v):
        out, lse = j_chunk(q, k, v, jnp.array(offsets, jnp.int32), ns, W,
                           block_q=64, block_kv=128)
        return jnp.sum(out * do) + jnp.sum(lse * dl), (out, lse)

    grads, (o_j, l_j) = jax.jit(jax.grad(loss, (0, 1, 2), has_aux=True))(
        q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o_t, l_t = tflash.sink_flash_attention_chunk(*leaves, offsets, ns, W)
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(l_t.detach().numpy(), np.asarray(l_j),
                               atol=1e-4, rtol=1e-4)
    ((o_t * torch.from_numpy(do)).sum() +
     (l_t * torch.from_numpy(dl)).sum()).backward()
    for name, t, g in zip(("dq", "dk", "dv"), leaves, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-4,
                                   err_msg=name)
    assert not leaves[1].grad[:, :, :halo].any()
    assert not leaves[2].grad[:, :, :halo].any()


DKDV_GEOMS = [
    # (n_q, n_kv, num_sink, window, q_offset, kv_offset): the forward
    # table's geometries in tests/test_torch_flash.py, and a halo
    (256, 256, 4, 128, 0, 0),
    (300, 300, 16, 128, 0, 0),
    (256, 256, 0, 1, 0, 0),
    (128, 384, 4, 96, 256, 0),
    (192, 256, 4, 96, 192, 64),
    (200, 150, 70, 33, 64, -10),
    (1024, 1024, 0, 1024, 0, 0),
    (256, 512, 4, 256, 0, -256),
    (250, 300, 0, 64, 40, -30),
]
# (bm, bn): 64 x 64 tiles, the dK/dV kernel's 64 x 128 (the defaults), and
# 128 x 128
DKDV_TILES = [(64, 64), (64, 128), (128, 128)]


def _visible_mask(n_q, n_kv, ns, W, qo, ko):
    mask = sink_window_mask(n_q, n_kv, ns, W, qo, ko).numpy()
    return mask & (np.arange(n_kv) + ko >= 0)[None, :]


@pytest.mark.parametrize("tiles", DKDV_TILES)
@pytest.mark.parametrize("geom", DKDV_GEOMS)
def test_dkdv_q_range_table_covers_mask(geom, tiles):
    """Each KV block's query-block range holds every query block with a
    masked-in (q, k) pair in it, at every tile size; a range cannot name a
    block twice; the block order lists every block once, longest range
    first."""
    n_q, n_kv, ns, W, qo, ko = geom
    bm, bn = tiles
    table = tflash.dkdv_q_ranges(n_q, n_kv, ns, W, qo, ko, bm=bm, bn=bn)
    mask = _visible_mask(n_q, n_kv, ns, W, qo, ko)
    n_q_blocks = -(-n_q // bm)
    assert table.shape == (-(-n_kv // bn), 2)
    for ni, (b0, b1) in enumerate(table):
        assert 0 <= b0 <= b1 <= n_q_blocks, (ni, table[ni])
        rows = np.nonzero(mask[:, ni * bn:(ni + 1) * bn].any(axis=1))[0]
        assert set(rows // bm) <= set(range(b0, b1)), (ni, table[ni])
    order = tflash.dkdv_block_order(n_q, n_kv, ns, W, qo, ko, bm=bm, bn=bn)
    assert sorted(order.tolist()) == list(range(table.shape[0]))
    lengths = (table[:, 1] - table[:, 0])[order]
    assert (np.diff(lengths) <= 0).all(), lengths


@pytest.mark.parametrize("head_dim", sorted(tflash.DQ_BN))
@pytest.mark.parametrize("geom", DKDV_GEOMS)
def test_dq_block_order_longest_first(geom, head_dim):
    """The dQ kernel's order lists every 128-row q block of its range table
    (``fwd_kv_ranges`` at its tiles for the head dim) once, most KV blocks
    first, ties in block order; every masked-in pair lies in a block the
    table visits."""
    n_q, n_kv, ns, W, qo, ko = geom
    bm, bn = tflash.DQ_BM, tflash.DQ_BN[head_dim]
    table = tflash.fwd_kv_ranges(n_q, n_kv, ns, W, qo, ko, bm=bm, bn=bn)
    order = tflash.dq_block_order(n_q, n_kv, ns, W, qo, ko, bm, bn)
    assert sorted(order.tolist()) == list(range(-(-n_q // bm)))
    lengths = (table[:, 1] - table[:, 0] + table[:, 3] - table[:, 2])[order]
    assert (np.diff(lengths) <= 0).all(), lengths
    ties = np.diff(lengths) == 0
    assert (np.diff(order)[ties] > 0).all(), order
    mask = _visible_mask(n_q, n_kv, ns, W, qo, ko)
    for qi, (s0, s1, w0, w1) in enumerate(table):
        cols = np.nonzero(mask[qi * bm:(qi + 1) * bm].any(axis=0))[0]
        assert set(cols // bn) <= set(range(s0, s1)) | set(range(w0, w1))


@pytest.mark.parametrize("tiles", DKDV_TILES)
@pytest.mark.parametrize("geom", DKDV_GEOMS)
def test_dkdv_q_range_table_within_jax_schedule(geom, tiles):
    """Each KV block's range lies inside the q blocks that the JAX
    package's ``_dkdv_q_step`` (per-block sink decision) marks valid for
    that block at the same tiles: the port visits no block the JAX kernel
    skips (it is tighter at the N_kv end and before the sequence start)."""
    n_q, n_kv, ns, W, qo, ko = geom
    bm, bn = tiles
    n_q_blocks = -(-n_q // bm)
    table = tflash.dkdv_q_ranges(n_q, n_kv, ns, W, qo, ko, bm=bm, bn=bn)
    steps = np.arange(n_q_blocks)
    for ni, (b0, b1) in enumerate(table):
        q_block, valid = j_dkdv_q_step(
            ni, steps, qo, ko, bm=bm, bn=bn, num_sink=ns, window=W,
            n_kv=n_kv, n_q_blocks=n_q_blocks, sink_pass=None)
        jax_blocks = set(np.asarray(q_block)[np.asarray(valid)].tolist())
        assert set(range(b0, b1)) <= jax_blocks, (ni, table[ni],
                                                  sorted(jax_blocks))


def check_pieces(table, ranges, order, cap):
    """The invariants of a dK/dV piece table (``ops.flash.dkdv_pieces``)
    over the units' q-block ranges [U, 2] and their order: each unit's
    pieces are consecutive, disjoint and cover exactly its range; no piece
    is longer than ``cap``, and a unit is split (into ceil(n / cap)
    pieces) only if its range is longer; the rows list every piece once,
    the split units' pieces first, each group longest first, ties in
    ``order`` and then piece index; the split units' pieces take the
    partial slots 0 .. slots - 1 once each. Returns the piece rows."""
    table, ranges = np.asarray(table), np.asarray(ranges)
    count, n_slots = table[0, :2]
    rows = table[1:1 + count]
    lengths = rows[:, 2] - rows[:, 1]
    assert (lengths <= cap).all(), (lengths.max(), cap)
    rank = {u: i for i, u in enumerate(np.asarray(order).tolist())}
    keys = [(-int(n > 1), -l, rank[u], p) for l, u, n, p in zip(
        lengths, rows[:, 0], rows[:, 3], rows[:, 4])]
    assert keys == sorted(keys)
    slots = []
    for u, (b0, b1) in enumerate(ranges.tolist()):
        mine = rows[rows[:, 0] == u]
        mine = mine[np.argsort(mine[:, 4])]
        n_p = 1 if b1 - b0 <= cap else -(-(b1 - b0) // cap)
        assert len(mine) == n_p and (mine[:, 3] == n_p).all(), (u, mine)
        assert mine[:, 4].tolist() == list(range(n_p))
        assert mine[0, 1] == b0 and mine[-1, 2] == b1, (u, mine)
        assert (mine[1:, 1] == mine[:-1, 2]).all(), (u, mine)
        if n_p > 1:
            assert (mine[:, 5] == mine[0, 5]).all()
            slots += range(mine[0, 5], mine[0, 5] + n_p)
    assert sorted(slots) == list(range(n_slots))
    return rows


# geometries whose sink block is longer than the cap (4-8 q blocks of 64
# rows at these windows): the model rows' shapes cut down, a chunk
# at a q offset, a halo before the sequence, 70 sinks over two key blocks
DKDV_SPLIT_GEOMS = [
    (1024, 1024, 4, 128, 0, 0),
    (1500, 1300, 16, 96, 200, 0),
    (1200, 1456, 4, 128, 0, -256),
    (2048, 2048, 70, 1, 0, 0),
]


@pytest.mark.parametrize("tiles", DKDV_TILES)
@pytest.mark.parametrize("geom", DKDV_GEOMS + DKDV_SPLIT_GEOMS)
def test_dkdv_piece_table_cuts_each_range(geom, tiles):
    """The piece table the dK/dV kernel walks cuts each key block's
    ``dkdv_q_ranges`` range into consecutive pieces of at most the cap
    (only the blocks longer than it), lists every piece once, longest
    first, and every piece's q blocks lie inside the set that the JAX
    package's ``_dkdv_q_step`` marks valid for its block."""
    n_q, n_kv, ns, W, qo, ko = geom
    bm, bn = tiles
    key = (n_q, n_kv, ns, W, qo, ko, bm, bn)
    cap = tflash.dkdv_piece_cap(bn, W, bm)
    ranges = tflash.dkdv_q_ranges(*key)
    rows = check_pieces(tflash.dkdv_piece_table(*key), ranges,
                        tflash.dkdv_block_order(*key), cap)
    n_q_blocks = -(-n_q // bm)
    steps = np.arange(n_q_blocks)
    for u, q0, q1 in rows[:, :3].tolist():
        q_block, valid = j_dkdv_q_step(
            u, steps, qo, ko, bm=bm, bn=bn, num_sink=ns, window=W,
            n_kv=n_kv, n_q_blocks=n_q_blocks, sink_pass=None)
        jax_blocks = set(np.asarray(q_block)[np.asarray(valid)].tolist())
        assert set(range(q0, q1)) <= jax_blocks, (u, q0, q1)
    if ns == 0:  # no sink column: no block is longer than the cap
        assert (rows[:, 3] == 1).all()


@pytest.mark.parametrize("row", [
    # (n, window, head dim, pieces, pieces of block 0), by hand from
    # dkdv_piece_cap = max(4, ceil((bn + W - 1) / 64) + 1), 4 sinks:
    # Gemma 3's local layer (D = 256: 64-key blocks), cap ceil(1087 / 64)
    # + 1 = 18: block 0's 128 q blocks in ceil(128 / 18) = 8 pieces of 16,
    # the other 127 blocks whole: 135
    (8192, 1024, 256, 135, 8),
    # the library's defaults at the headline (D = 128: 128-key blocks), cap
    # ceil(639 / 64) + 1 = 11: 128 q blocks in 12 pieces (8 of 11, 4 of
    # 10), 63 others: 75
    (8192, 512, 128, 75, 12),
    # gpt-oss's sliding layer (D = 64), cap ceil(255 / 64) + 1 = 5: 64 q
    # blocks in 13 pieces (12 of 5, 1 of 4), 31 others: 44
    (4096, 128, 64, 44, 13),
    # the headline's W = 4096, cap ceil(4223 / 64) + 1 = 67: 128 q blocks in
    # 2 pieces of 64, 63 others: 65
    (8192, 4096, 128, 65, 2),
])
def test_dkdv_piece_counts_of_the_model_rows(row):
    n, W, d, count, first = row
    bn = tflash.DKDV_BNS[d]
    table = tflash.dkdv_piece_table(n, n, 4, W, 0, 0, tflash.DKDV_BM, bn)
    rows = table[1:]
    assert table[0, 0] == count == len(rows)
    assert (rows[:, 0] == 0).sum() == first == table[0, 1]
    assert (rows[rows[:, 0] != 0, 3] == 1).all()
