"""The port's packed (multi-segment) attention against the JAX package's.

On the CPU the port runs the packed kernels' plain versions; the JAX side
runs its Pallas packed kernels in interpret mode, jitted, on the
configurations of tests/test_packed.py, with that file's tolerances. The
host tables that the CUDA kernels walk are checked against a brute force of
the mask here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
from sink_attention_tpu.ops.packed import (
    sink_flash_attention_packed as j_packed)
from sink_attention_tpu.ops.reference import (
    eager_sink_attention_packed as j_eager_packed)
from sink_attention_tpu_torch.ops import flash as tflash
from sink_attention_tpu_torch.ops import packed as tpacked
from sink_attention_tpu_torch.ops.reference import packed_sink_window_mask


def _positions(seglens, B=1, first=0):
    """[B, N] positions of back-to-back segments; ``first`` > 0 starts the
    pack inside the first segment, at that position."""
    pos = [p for L in seglens for p in range(L)]
    pos = list(range(first, first + seglens[0])) + pos[seglens[0]:]
    return np.tile(np.array(pos, np.int32)[None], (B, 1))


def _inputs(seed, B, H_q, H_kv, N, D, with_aux):
    rs = np.random.RandomState(seed)
    x = [rs.randn(B, H_q, N, D), rs.randn(B, H_kv, N, D),
         rs.randn(B, H_kv, N, D)]
    if with_aux:
        x.append(rs.randn(H_q))
    return [a.astype(np.float32) for a in x]


FWD_CONFIGS = [
    # name, B, Hq, Hkv, N, D, seglens, num_sink, window, s_aux: those of
    # tests/test_packed.py
    ("two-equal", 1, 2, 1, 256, 64, [128, 128], 4, 64, False),
    ("ragged", 2, 4, 2, 256, 64, [100, 30, 70, 56], 4, 64, False),
    ("long-seg-beyond-window", 1, 2, 2, 512, 64, [400, 112], 4, 64, True),
    ("tiny-segs", 1, 2, 2, 256, 64, [8] * 32, 4, 64, False),
    ("no-sink", 1, 2, 2, 256, 64, [100, 156], 0, 64, False),
    ("s_aux-gqa", 1, 4, 2, 256, 64, [100, 156], 4, 64, True),
    ("unaligned", 1, 2, 2, 250, 48, [90, 160], 4, 60, False),
    ("seg-shorter-than-sink", 1, 2, 2, 128, 32, [2, 126], 4, 32, False),
]


def _port(x, pos, ns, W, dtype=torch.float32, grad=False):
    leaves = [torch.from_numpy(a).to(dtype) for a in x]
    if grad:
        leaves = [t.requires_grad_() for t in leaves]
    aux = leaves[3] if len(leaves) > 3 else None
    out = tpacked.sink_flash_attention_packed(
        *leaves[:3], torch.from_numpy(pos), ns, W, s_aux=aux)
    return out, leaves


@pytest.mark.parametrize("cfg", FWD_CONFIGS, ids=[c[0] for c in FWD_CONFIGS])
def test_forward_matches_jax(cfg):
    name, B, Hq, Hkv, N, D, segs, ns, W, with_aux = cfg
    x = _inputs(len(name) + N, B, Hq, Hkv, N, D, with_aux)
    pos = _positions(segs, B)
    fn = jax.jit(functools.partial(j_packed, num_sink=ns, window_size=W,
                                   block_q=64, block_kv=64))
    ref = fn(*map(jnp.asarray, x[:3]), jnp.asarray(pos),
             s_aux=jnp.asarray(x[3]) if with_aux else None)
    out, _ = _port(x, pos, ns, W)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5)


def test_forward_bf16_matches_jax():
    """bf16 inputs, against the fp32 oracle (tests/test_packed.py's bf16
    case and tolerance)."""
    x = _inputs(5, 1, 4, 2, 256, 64, True)
    pos = _positions([100, 156])
    ref = j_eager_packed(*map(jnp.asarray, x[:3]), jnp.asarray(pos), 4, 64,
                         s_aux=jnp.asarray(x[3]))
    out = tpacked.sink_flash_attention_packed(
        *(torch.from_numpy(a).bfloat16() for a in x[:3]),
        torch.from_numpy(pos), 4, 64, s_aux=torch.from_numpy(x[3]))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref),
                               atol=3e-2)


GRAD_CONFIGS = [
    # those of tests/test_packed.py's gradient test
    ("ragged", 1, 4, 2, 256, 64, [100, 30, 70, 56], 4, 64, True),
    ("long-seg", 1, 2, 2, 512, 64, [400, 112], 4, 64, True),
    ("tiny-segs", 1, 2, 1, 256, 32, [8] * 32, 4, 64, False),
    ("unaligned", 1, 2, 2, 250, 48, [90, 160], 4, 60, False),
]


def _assert_grads_close(got, ref, what):
    """tests/test_packed.py's gradient tolerance: abs 2e-3 or rel 1e-3."""
    for nm, g, r in zip(("dq", "dk", "dv", "ds_aux"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        abs_err = np.max(np.abs(g - r))
        rel_err = np.max(np.abs(g - r) / (np.abs(r) + 1e-3))
        assert abs_err < 2e-3 or rel_err < 1e-3, (what, nm, abs_err, rel_err)


@pytest.mark.parametrize("cfg", GRAD_CONFIGS, ids=[c[0] for c in GRAD_CONFIGS])
def test_grads_match_jax(cfg):
    name, B, Hq, Hkv, N, D, segs, ns, W, with_aux = cfg
    x = _inputs(100 + len(name) + N, B, Hq, Hkv, N, D, with_aux)
    pos = jnp.asarray(_positions(segs, B))

    def loss(*args):
        aux = args[3] if with_aux else None
        return (j_packed(*args[:3], pos, ns, W, s_aux=aux, block_q=64,
                         block_kv=64) ** 2).sum()

    ref = jax.jit(jax.grad(loss, tuple(range(len(x)))))(*map(jnp.asarray, x))
    out, leaves = _port(x, np.array(pos), ns, W, grad=True)
    (out ** 2).sum().backward()
    _assert_grads_close([t.grad for t in leaves], ref, name)


def test_leading_partial_segment_grads_match_jax_oracle():
    """A pack that begins inside a segment, at position 2 with 4 sinks: its
    columns 0 and 1 are sinks of every later row of that segment. The JAX
    kernel's table (``_packed_meta``) gives those leading columns no sink
    pass, so its dK/dV drop the rows beyond the window; the port follows
    the eager oracle, and so does this test."""
    ns, W = 4, 32
    x = _inputs(21, 1, 2, 2, 256, 64, True)
    pos = _positions([200, 56], first=2)
    assert 0 < pos[0, 0] < ns

    def loss(*args):
        return (j_eager_packed(*args[:3], jnp.asarray(pos), ns, W,
                               s_aux=args[3]) ** 2).sum()

    ref = jax.jit(jax.grad(loss, (0, 1, 2, 3)))(*map(jnp.asarray, x))
    out, leaves = _port(x, pos, ns, W, grad=True)
    (out ** 2).sum().backward()
    _assert_grads_close([t.grad for t in leaves], ref, "leading partial")


def test_single_segment_equals_unpacked():
    """One segment of the whole pack is sink_flash_attention, forward and
    gradients."""
    x = _inputs(7, 1, 4, 2, 256, 64, True)
    pos = np.arange(256, dtype=np.int32)[None]
    out, leaves = _port(x, pos, 4, 64, grad=True)
    (out ** 2).sum().backward()
    ref_leaves = [torch.from_numpy(a).requires_grad_() for a in x]
    ref = tflash.sink_flash_attention(*ref_leaves[:3], 4, 64,
                                      s_aux=ref_leaves[3])
    (ref ** 2).sum().backward()
    torch.testing.assert_close(out, ref, atol=5e-5, rtol=0)
    for a, b in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


def test_no_cross_segment_leakage():
    """Changing segment 1's K/V leaves segment 2's outputs as they were."""
    x = _inputs(8, 1, 2, 2, 256, 64, False)
    pos = _positions([128, 128])
    out1, _ = _port(x, pos, 4, 64)
    x[1][:, :, :128] *= -3.0
    x[2][:, :, :128] += 7.0
    out2, _ = _port(x, pos, 4, 64)
    torch.testing.assert_close(out1[:, :, 128:], out2[:, :, 128:], atol=1e-6,
                               rtol=0)
    assert not torch.allclose(out1[:, :, :128], out2[:, :, :128], atol=1e-2)


TABLE_CASES = [
    # (seglens, first position, N, num_sink, window)
    ([2, 126, 128], 0, 256, 4, 32),          # a segment shorter than sink
    ([200, 56], 2, 256, 4, 32),              # leading partial segment
    ([100, 30, 70, 56], 0, 256, 4, 1 << 30),  # W >= N (full layer)
    ([90, 160], 0, 250, 4, 60),              # unaligned N
    ([8] * 40, 0, 320, 4, 64),               # tiny segments
    ([300, 212], 0, 512, 0, 128),            # no sink
    ([130, 70, 500, 324], 5, 1024, 16, 1 << 30),
    ([333, 2, 665], 2, 1000, 4, 128),        # N not a multiple of 128
]


@pytest.mark.parametrize("case", TABLE_CASES)
def test_tables_cover_the_mask(case):
    """Every visible (row, column) pair lies in a tile that the forward
    table (128 x 128), the dQ table (128 rows x 128 keys at head dim 64, x
    64 keys at 128) and the dK/dV table (64 x 128) visit; the forward and
    dQ tables visit no block twice and stay inside the pack; the segment
    vector is i - positions; each key j is visible to exactly the rows [j,
    reach[j]); the forward, dQ and dK/dV orders list every (row, block)
    unit once, longest first."""
    seglens, first, N, ns, W = case
    pos = torch.from_numpy(_positions(seglens, first=first)[:, :N])
    tabs = tpacked.packed_tables(pos, ns, W, 64)
    tabs128 = tpacked.packed_tables(pos, ns, W, 128)
    mask = packed_sink_window_mask(pos, ns, W)[0].numpy()
    seg = np.arange(N) - pos[0].numpy()
    n_qb, n_kb = -(-N // tflash.DKDV_BM), -(-N // tflash.DKDV_BNS[64])
    n_fwdb, n_dqb = -(-N // tflash.FWD_BM), -(-N // tflash.DQ_BM)
    assert tabs.fwd.shape == (1, n_fwdb, 4) and tabs.kv.shape == (1, n_kb, 2)
    assert tabs.dq.shape == tabs128.dq.shape == (1, n_dqb, 4)
    assert torch.equal(tabs.fwd, tabs128.fwd)
    assert torch.equal(tabs.fwd_order, tabs128.fwd_order)
    np.testing.assert_array_equal(tabs.seg[0].numpy(), seg)
    for table, (bm, bn) in ((tabs.fwd, (tflash.FWD_BM, tflash.FWD_BNS[64])),
                            (tabs.dq, (tflash.DQ_BM, tflash.DQ_BN[64])),
                            (tabs128.dq, (tflash.DQ_BM, tflash.DQ_BN[128]))):
        for qi, (s0, s1, w0, w1) in enumerate(table[0].tolist()):
            visited = list(range(s0, s1)) + list(range(w0, w1))
            assert len(set(visited)) == len(visited), (qi, table[0, qi])
            assert all(0 <= blk < -(-N // bn) for blk in visited), (
                qi, table[0, qi])
            cols = np.nonzero(mask[qi * bm:(qi + 1) * bm].any(axis=0))[0]
            assert set(cols // bn) <= set(visited), (qi, table[0, qi])
    for table, units in ((tabs.fwd, tabs.fwd_order), (tabs.dq, tabs.dq_order),
                         (tabs128.dq, tabs128.dq_order)):
        lengths = (table[0, :, 1] - table[0, :, 0] + table[0, :, 3]
                   - table[0, :, 2]).numpy()
        units = units.numpy()
        assert sorted(units.tolist()) == list(range(table.shape[1]))
        assert (np.diff(lengths[units]) <= 0).all(), lengths[units]
    kbm, kbn = tflash.DKDV_BM, tflash.DKDV_BNS[64]
    for ki, (b0, b1) in enumerate(tabs.kv[0].tolist()):
        assert 0 <= b0 <= b1 <= n_qb, (ki, tabs.kv[0, ki])
        rows = np.nonzero(mask[:, ki * kbn:(ki + 1) * kbn].any(axis=1))[0]
        assert set(rows // kbm) <= set(range(b0, b1)), (ki, tabs.kv[0, ki])
    rows = np.arange(N)[:, None]
    reach = tabs.reach[0].numpy()[None, :]
    np.testing.assert_array_equal(
        mask, (rows >= np.arange(N)[None, :]) & (rows < reach))
    lengths = (tabs.kv[0, :, 1] - tabs.kv[0, :, 0]).numpy()
    order = tabs.kv_order.numpy()
    assert sorted(order.tolist()) == list(range(n_kb))
    assert (np.diff(lengths[order]) <= 0).all(), lengths[order]


def test_full_layer_tables_skip_other_segments():
    """At W >= N the tables visit only tiles that touch a segment's own
    causal triangle: about sum(L^2) / 2 pairs, far below N^2 / 2. The
    forward's 128 x 128 tiles: the triangle's 4 * 5 / 2 tiles a segment;
    the dQ kernel's 128-row q blocks (head dim 64): 1 + 2 + 3 + 4 blocks of
    128 keys; the dK/dV kernel's 128-key blocks: 8 + 6 + 4 + 2 q blocks of
    64 rows. The forward and dQ orders take each segment's last q block
    first."""
    seglens, N = [512] * 8, 4096
    pos = torch.from_numpy(_positions(seglens))
    tabs = tpacked.packed_tables(pos, 0, 1 << 30, 64)
    fwd_tiles = int((tabs.fwd[0, :, 3] - tabs.fwd[0, :, 2]).sum())
    dq_tiles = int((tabs.dq[0, :, 3] - tabs.dq[0, :, 2]).sum())
    dkdv_tiles = int((tabs.kv[0, :, 1] - tabs.kv[0, :, 0]).sum())
    fwd_blocks = 512 // tflash.FWD_BM
    per_segment = 8 * fwd_blocks * (fwd_blocks + 1) // 2
    dq_blocks = 512 // tflash.DQ_BM
    per_segment_dq = 8 * sum((qb + 1) * tflash.DQ_BM // tflash.DQ_BN[64]
                             for qb in range(dq_blocks))
    kv_blocks, q_blocks = 512 // tflash.DKDV_BNS[64], 512 // tflash.DKDV_BM
    per_segment_dkdv = 8 * sum(q_blocks - kb * (q_blocks // kv_blocks)
                               for kb in range(kv_blocks))
    assert fwd_tiles == per_segment and dkdv_tiles == per_segment_dkdv
    assert dq_tiles == per_segment_dq
    assert tabs.dq_order[:8].tolist() == list(range(3, 32, 4))
    assert tabs.fwd_order[:8].tolist() == list(range(3, 32, 4))


# (seglens, num_sink, window, head dim, pieces, pieces of each split block
# {unit: pieces}), by hand from dkdv_piece_cap = max(4, ceil((bn + W - 1) /
# 64) + 1); None where the count is not asserted
PIECE_CASES = [
    # Gemma 3's local layer over a pack of 6144 + 2048 (64-key blocks), cap
    # ceil(1087 / 64) + 1 = 18: segment 1's sink block 0 reads 96 q blocks
    # (6 pieces of 16), segment 2's block 96 reads 32 (2 of 16), the other
    # 126 blocks whole: 134
    ([6144, 2048], 4, 1024, 256, 134, {0: 6, 96: 2}),
    # a 2-token segment, then 510 and 512 (128-key blocks), cap ceil(255 /
    # 64) + 1 = 5: block 0 holds segments 1 and 2's sinks and reads q
    # blocks 0-8 (to token 512), block 4 segment 3's and reads 8-16: 2
    # pieces each, 6 other blocks whole: 10
    ([2, 510, 512], 4, 128, 64, 10, {0: 2, 4: 2}),
    # 32-token segments: every block's range ends within its segments (2 q
    # blocks): nothing splits
    ([32] * 32, 4, 128, 64, 8, {}),
    # segments of 64-3072 (the headline pack), W = 128, D = 128
    ("mix", 4, 128, 128, None, None),
]


@pytest.mark.parametrize("case", PIECE_CASES)
def test_packed_piece_table_cuts_each_range(case):
    """The dK/dV piece table built on the tensors' device from positions
    (here the CPU): each key block's range of ``kv`` cut into pieces of at
    most the cap, longest first (``check_pieces``); the split blocks'
    slots within ``packed_dkdv_slots``, the bound the workspace takes."""
    from test_torch_flash_backward import check_pieces
    seglens, ns, W, d, count, split = case
    if seglens == "mix":
        seglens = tpacked.pack_lengths(8192, 64, 3072, 1)
    pos = torch.from_numpy(_positions(seglens))
    N = pos.shape[1]
    tabs = tpacked.packed_tables(pos, ns, W, d)
    bn = tflash.DKDV_BNS[d]
    cap = tflash.dkdv_piece_cap(bn, W)
    rows = check_pieces(tabs.kv_pieces.numpy(), tabs.kv[0].numpy(),
                        tabs.kv_order.numpy(), cap)
    assert tabs.kv_pieces.shape[0] == 1 + tabs.kv.shape[1] * max(
        1, -(-(-(-N // tflash.DKDV_BM)) // cap))
    assert int(tabs.kv_pieces[0, 1]) <= tpacked.packed_dkdv_slots(
        1, N, ns, W, d)
    if count is not None:
        assert len(rows) == count
        got = {u: int(n) for u, n in zip(rows[:, 0], rows[:, 3]) if n > 1}
        assert got == split


@pytest.mark.parametrize("seed", range(4))
def test_packed_dkdv_slots_bound_the_split_blocks(seed):
    """``packed_dkdv_slots`` bounds the partial slots the device-built
    piece table takes, over random packs (segments of 8-2048 tokens,
    a pack that starts inside a segment) at W = 64-1024, 1-70 sinks and
    the 64-, 128- and 256-column instances' key blocks."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        N = int(rng.integers(512, 6000))
        lens = tpacked.pack_lengths(N, 8, int(rng.integers(64, 2048)),
                                    int(rng.integers(1 << 16)))
        first = int(rng.integers(0, 3))
        pos = torch.from_numpy(_positions(lens, first=first))
        ns, W = int(rng.integers(1, 71)), int(rng.choice([64, 128, 1024]))
        for d in (64, 128, 256):
            tabs = tpacked.packed_tables(pos, ns, W, d)
            assert int(tabs.kv_pieces[0, 1]) <= tpacked.packed_dkdv_slots(
                1, N, ns, W, d), (lens, first, ns, W, d)
