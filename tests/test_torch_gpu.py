"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: where there is no CUDA device the tests skip (decided in
the fixture, so every worker collects the same tests). On the card:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import pytest
import torch

from sink_attention_tpu_torch.cache import RaggedSinkKVCache, SinkKVCache
from sink_attention_tpu_torch.ops import decode, flash

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device).to(
        torch.bfloat16)


@pytest.mark.parametrize("cfg", [
    # (B, H_q, H_kv, N, D, num_sink, window, use_aux, q_offset)
    (2, 8, 2, 256, 64, 4, 128, True, 0),
    (1, 4, 4, 300, 128, 16, 128, False, 0),
    (1, 8, 1, 200, 64, 0, 64, True, 0),
    (1, 4, 2, 128, 64, 4, 96, True, 192),
    (4, 64, 8, 1024, 64, 0, 128, True, 0),
])
def test_flash_kernel_matches_plain(cuda, cfg):
    B, H_q, H_kv, N, D, ns, W, use_aux, qo = cfg
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, B, H_q, N, D)
    k = _randn(gen, B, H_kv, N + qo, D)
    v = _randn(gen, B, H_kv, N + qo, D)
    aux = torch.randn(H_q, generator=gen, device=cuda) if use_aux else None
    before = flash.flash_fwd_kernel.launches
    o_k, l_k = flash.sink_flash_attention_with_lse(q, k, v, ns, W, aux,
                                                   q_offset=qo)
    o_p, l_p = flash.flash_fwd_plain(q, k, v, aux, ns, W, q_offset=qo)
    torch.cuda.synchronize()
    assert flash.flash_fwd_kernel.launches == before + 1
    assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2
    assert float((l_k - l_p).abs().max()) <= 1e-3


@pytest.mark.parametrize("case", [
    # (B, H_q, H_kv, D, num_sink, window, prefill_len, appends, use_aux)
    (4, 64, 8, 64, 0, 128, 1024, 16, True),
    (4, 64, 8, 64, 0, 1056, 1024, 16, True),
    (1, 32, 8, 128, 4, 4096, 300, 5, False),
    (2, 8, 2, 64, 4, 32, 3, 40, True),
])
def test_decode_kernel_matches_plain(cuda, case):
    B, H_q, H_kv, D, ns, W, n, steps, use_aux = case
    gen = torch.Generator(device=cuda).manual_seed(1)
    cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                             device=cuda)
    cache.prefill(_randn(gen, B, H_kv, n, D), _randn(gen, B, H_kv, n, D))
    aux = torch.randn(H_q, generator=gen, device=cuda) if use_aux else None
    for _ in range(steps):
        cache.append(_randn(gen, B, H_kv, 1, D), _randn(gen, B, H_kv, 1, D))
        q = _randn(gen, B, H_q, 1, D)
        o_k = decode.sink_decode_attention_cached(q, cache, aux)
        lens = decode._uniform_lens(cache.sink_len, cache.window_len,
                                    cache.write_pos, cache.window_size,
                                    cache.sink_cap, B, cuda)
        o_p = decode.decode_plain(q, cache.k, cache.v, lens, aux,
                                  sink_cap=cache.sink_cap,
                                  window_size=cache.window_size)
        torch.cuda.synchronize()
        assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2


QUANT_CASES = [
    # (quant, B, H_q, H_kv, D, num_sink, window, lengths, appends): an int
    # length prefills a SinkKVCache; a list inserts each slot of a
    # RaggedSinkKVCache (0: left empty)
    ("int8", 4, 64, 8, 64, 0, 128, 1024, 16),
    ("fp8", 4, 64, 8, 64, 0, 1056, 1024, 31),
    ("int8", 1, 32, 8, 128, 4, 4096, 300, 5),
    ("fp8", 2, 8, 2, 128, 4, 32, 3, 40),        # sink promotion
    ("int8", 4, 64, 8, 64, 0, 128, [1000, 77, 0, 610], 24),
    ("fp8", 4, 64, 8, 64, 0, 2048, [1000, 77, 0, 610], 24),
    ("fp8", 4, 8, 2, 128, 4, 100, [3, 150, 0, 40], 12),   # park slot
    # the split decode (D > 128): B = 1 over a long wrapped cache (65
    # ranges), MQA 8/1 ragged with an empty slot, G = 64 (four 16-row
    # pieces), a padded copy (D = 264 codes -> 272)
    ("int8", 1, 8, 4, 256, 4, 8192, 9000, 2),
    ("fp8", 1, 8, 4, 1024, 4, 8192, 9000, 2),
    ("fp8", 3, 8, 1, 256, 4, 1024, [1500, 0, 700], 6),
    ("int8", 3, 8, 1, 1024, 0, 512, [0, 900, 300], 5),
    ("int8", 1, 64, 1, 512, 0, 1024, 1500, 2),
    ("fp8", 2, 8, 4, 264, 0, 256, 300, 1),
    # G = 17 / 18: a last piece of 1 / 2 rows; a cache past 512 x 512
    ("int8", 1, 17, 1, 640, 4, 1024, 1100, 1),
    ("fp8", 2, 36, 2, 640, 0, 512, [600, 0], 2),
    ("fp8", 1, 17, 1, 1024, 0, 2048, 1500, 2),
    ("int8", 2, 36, 2, 1024, 4, 1024, [1100, 300], 1),
    ("int8", 1, 4, 1, 256, 4, 270000, 270100, 3),
    # the short-row instances over a wrapped 4096-slot window: Danube's D =
    # 80 (256-slot boxes of 80-byte code rows) and D = 128 (128 x 128 B)
    ("int8", 2, 32, 8, 80, 0, 4096, 8192, 16),
    ("fp8", 2, 32, 8, 80, 0, 4096, 8192, 16),
    ("int8", 1, 32, 8, 128, 4, 4096, 8192, 4),
    ("fp8", 1, 32, 8, 128, 4, 4096, 8192, 4),
]
QUANT_BUDGET = {"int8": 0.05, "fp8": 0.12}  # vs unquantized KV (JAX tests)


@pytest.mark.parametrize("case", QUANT_CASES)
def test_quantized_decode_kernels_match_plain(cuda, case):
    """The int8 / fp8 decode kernel against its plain version (2e-2 on the
    bf16 output) and against the bf16 kernel over the unquantized KV
    (within the JAX tests' budget), one launch of its own branch, zeros
    for an empty ragged slot."""
    quant, B, H_q, H_kv, D, ns, W, lengths, appends = case
    gen = torch.Generator(device=cuda).manual_seed(4)
    ragged = isinstance(lengths, list)
    cls = RaggedSinkKVCache if ragged else SinkKVCache
    caches = [cls.init(B, H_kv, D, num_sink=ns, window_size=W, quant=qn,
                       device=cuda) for qn in (quant, None)]
    if ragged:
        k = _randn(gen, B, H_kv, max(lengths), D)
        v = _randn(gen, B, H_kv, max(lengths), D)
        for c in caches:
            for b, n in enumerate(lengths):
                if n:
                    c.insert(b, k[b], v[b], n)
    else:
        k, v = _randn(gen, B, H_kv, lengths, D), _randn(gen, B, H_kv, lengths, D)
        for c in caches:
            c.prefill(k, v)
    for i in range(appends):
        k, v = _randn(gen, B, H_kv, 1, D), _randn(gen, B, H_kv, 1, D)
        active = torch.tensor([bool(n) and i % (b + 2) != 0 for b, n in
                               enumerate(lengths)], device=cuda) \
            if ragged else None
        for c in caches:
            if ragged:
                c.append(k, v, active)
            else:
                c.append(k, v)
    qc, ref = caches
    q = _randn(gen, B, H_q, 1, D)
    aux = torch.randn(H_q, generator=gen, device=cuda)
    lens = decode.ragged_lens(qc) if ragged else decode._uniform_lens(
        qc.sink_len, qc.window_len, qc.write_pos, qc.window_size,
        qc.sink_cap, B, cuda)
    counts = [getattr(decode.decode_kernel, a) for a in
              ("launches", "launches_int8", "launches_fp8")]
    o_k = (decode.sink_decode_attention_ragged(q, qc, aux) if ragged else
           decode.sink_decode_attention_cached(q, qc, aux))
    after = [getattr(decode.decode_kernel, a) for a in
             ("launches", "launches_int8", "launches_fp8")]
    branch = 1 if quant == "int8" else 2
    assert after == [c + (i == branch) for i, c in enumerate(counts)]
    o_p = decode.decode_plain(q, qc.k, qc.v, lens, aux,
                              **decode.cache_args(qc))
    o_b = decode.decode_kernel(q, ref.k, ref.v, lens, aux,
                               **decode.cache_args(ref))
    torch.cuda.synchronize()
    assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2
    assert float((o_k.float() - o_b.float()).abs().max()) <= \
        QUANT_BUDGET[quant]
    if ragged:
        empty = [b for b, n in enumerate(lengths) if not n]
        assert not o_k[empty].any()


BWD_CASES = [
    # (B, H_q, H_kv, N_q, N_kv, D, num_sink, window, use_aux, q_off, kv_off)
    (2, 8, 2, 256, 256, 64, 4, 128, True, 0, 0),
    (1, 4, 4, 300, 300, 128, 16, 128, False, 0, 0),
    (1, 8, 1, 200, 200, 64, 0, 64, True, 0, 0),
    (1, 4, 2, 128, 320, 64, 4, 96, True, 192, 0),      # chunk at q_offset
    (1, 4, 2, 256, 512, 64, 4, 128, False, 0, -256),   # garbage halo
    (1, 64, 8, 1024, 1024, 64, 0, 1024, True, 0, 0),   # gpt-oss full layer
    # the wgmma/TMA dK/dV kernel's edges: 128-key items cut at N_kv, N_q
    # not a multiple of 4 or 64, GQA groups 1-16, window 1 with 70 sinks, a
    # long sink item
    (1, 16, 1, 1000, 1000, 128, 4, 256, True, 0, 0),   # group 16, D=128
    (1, 4, 2, 250, 250, 64, 70, 1, False, 0, 0),       # N_q = 250, W = 1
    (1, 8, 2, 250, 300, 128, 4, 128, True, 50, 0),     # N_q = 250 chunk
    (1, 8, 1, 2048, 2048, 64, 4, 128, True, 0, 0),     # long sink item
    (1, 4, 4, 300, 556, 64, 0, 128, True, 0, -256),    # halo, group 1
    # the 256 instance: 64-key dK/dV items whose tile products the two
    # consumers split (P^T handed over in shared memory); a window of 32
    # makes every diagonal tile partial; D = 200 zero-fills columns 200-255
    (1, 16, 1, 1000, 1000, 256, 4, 256, True, 0, 0),   # group 16, D=256
    (1, 8, 2, 250, 300, 256, 4, 128, True, 50, 0),     # N_q = 250 chunk
    (1, 4, 4, 300, 556, 256, 0, 128, True, 0, -256),   # halo, group 1
    (1, 8, 1, 2048, 2048, 256, 4, 128, True, 0, 0),    # long sink item
    (1, 4, 2, 512, 512, 256, 0, 32, True, 0, 0),       # window 32
    (1, 8, 2, 500, 500, 200, 4, 128, True, 0, 0),      # D = 200
    # the narrow 80 instance (dQ's and dK/dV's): group 16, a chunk at a q
    # offset, N_q = 250
    (1, 16, 1, 250, 300, 80, 4, 128, True, 50, 0),
    # the 512 instance: 64-row dQ items, two passes of 32-row dK/dV tiles
    (1, 16, 1, 1000, 1000, 512, 4, 256, True, 0, 0),   # group 16, D=512
    (1, 8, 2, 250, 300, 512, 4, 128, True, 50, 0),     # N_q = 250 chunk
    (1, 4, 4, 300, 556, 512, 0, 128, True, 0, -256),   # halo, group 1
    # the wide instance: runtime depth, 512-column slices
    (1, 16, 1, 1000, 1000, 640, 4, 256, True, 0, 0),   # group 16, D=640
    (1, 8, 2, 250, 300, 1024, 4, 128, True, 50, 0),    # N_q = 250 chunk
    (1, 4, 4, 300, 556, 1024, 0, 128, True, 0, -256),  # halo, group 1
    # the sink key block cut into pieces (dkdv_piece_table: at most 4-5 q
    # blocks a piece at W <= 128), merged in the launch in piece order, at
    # every instance; an optional last field is the inputs' dtype
    (1, 8, 8, 1024, 1024, 64, 4, 128, True, 0, 0),     # group 1: 4 pieces
    (1, 16, 1, 1536, 1536, 80, 4, 128, True, 0, 0),    # group 16: 5 pieces
    (2, 8, 2, 2048, 2048, 128, 4, 64, True, 0, 0),     # B = 2: 8 pieces
    (1, 8, 2, 1024, 1280, 64, 4, 128, False, 0, -256),  # halo: 4 pieces
    (1, 4, 2, 1024, 1024, 96, 4, 128, True, 0, 0,
     torch.float32),                                   # fp32: 4 pieces
    (1, 16, 1, 1024, 1024, 256, 4, 128, True, 0, 0),   # group 16: 4 pieces
    (1, 8, 2, 1024, 1024, 256, 4, 128, True, 0, 0,
     torch.float32),                                   # fp32: 4 pieces
    (1, 8, 2, 1536, 1536, 512, 4, 128, True, 0, 0),    # 6 pieces
    (1, 4, 4, 1024, 1024, 512, 4, 128, True, 0, 0,
     torch.float32),                                   # fp32: 4 pieces
    (1, 8, 2, 1024, 1024, 640, 4, 128, True, 0, 0),    # 4 pieces, 2 slices
    (1, 4, 4, 1024, 1024, 1024, 4, 128, True, 0, 0,
     torch.float32),                                   # fp32: 4 pieces
]


@pytest.mark.parametrize("cfg", BWD_CASES)
def test_backward_kernels_match_plain(cuda, cfg):
    """dQ and dK/dV kernels against flash_bwd_plain on the same inputs
    (bf16 outputs: 2e-2 of the largest plain value), bitwise equal on a
    second run (no atomics), and autograd through sink_flash_attention
    launching the forward and both backward kernels once each."""
    B, H_q, H_kv, N_q, N_kv, D, ns, W, use_aux, qo, ko, *dt = cfg
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (_randn(gen, *s).to(*dt) for s in (
        (B, H_q, N_q, D), (B, H_kv, N_kv, D), (B, H_kv, N_kv, D),
        (B, H_q, N_q, D)))
    aux = torch.randn(H_q, generator=gen, device=cuda) if use_aux else None
    geom = (ns, W, qo, ko)
    o, lse = flash.flash_fwd_plain(q, k, v, aux, *geom)
    delta = (do.float() * o.float()).sum(-1)
    plain = flash.flash_bwd_plain(q, k, v, do, lse, delta, *geom)
    dq = flash.flash_dq_kernel(q, k, v, do, lse, delta, *geom)
    dk, dv = flash.flash_dkdv_kernel(q, k, v, do, lse, delta, *geom)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        scale = max(1.0, float(ref.float().abs().max()))
        err = float((got.float() - ref.float()).abs().max())
        assert err <= 2e-2 * scale, (name, err, scale)
    assert torch.equal(dq, flash.flash_dq_kernel(q, k, v, do, lse, delta,
                                                 *geom))
    dk2, dv2 = flash.flash_dkdv_kernel(q, k, v, do, lse, delta, *geom)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if ko < 0:  # the halo before the sequence start gets no gradient
        assert not dk[:, :, :-ko].any() and not dv[:, :, :-ko].any()

    counts = [f.launches for f in (flash.flash_fwd_kernel,
                                   flash.flash_dq_kernel,
                                   flash.flash_dkdv_kernel)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    a = aux.clone().requires_grad_() if use_aux else None
    out = flash.sink_flash_attention(*leaves, ns, W, s_aux=a, q_offset=qo,
                                     kv_offset=ko)
    out.backward(do)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash.flash_fwd_kernel,
                                 flash.flash_dq_kernel,
                                 flash.flash_dkdv_kernel)] == [
        c + 1 for c in counts]
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in leaves)
    if use_aux:
        assert bool(torch.isfinite(a.grad).all())


def _segments(total, lengths):
    """Positions [total] of segments of the given lengths, repeated."""
    pos, i = [], 0
    while len(pos) < total:
        pos += list(range(lengths[i % len(lengths)]))
        i += 1
    return pos[:total]


PACKED_CASES = [
    # (B, H_q, H_kv, N, D, num_sink, window, use_aux, first position,
    #  segment lengths)
    (2, 8, 2, 256, 64, 4, 64, True, 0, (100, 30, 70, 56)),
    (1, 4, 4, 300, 128, 4, 128, False, 0, (2, 126, 172)),   # shorter than sink
    (1, 8, 1, 256, 64, 4, 32, True, 2, (200, 56)),          # leading partial
    (1, 4, 2, 1000, 64, 4, 1000, True, 0, (32,)),           # unaligned, W = N
    (1, 64, 8, 1024, 64, 0, 1024, True, 0, (700, 324)),     # gpt-oss full layer
    (1, 8, 1, 1000, 128, 4, 128, True, 0, (2, 30, 32, 500, 436)),  # group 8
    (1, 16, 1, 250, 64, 70, 1, True, 0, (2, 32, 216)),      # group 16, W = 1
    # the 256 instance (see BWD_CASES): group 16 at W = 1, a window of 32,
    # a long sink item, D = 200
    (1, 16, 1, 250, 256, 70, 1, True, 0, (2, 32, 216)),
    (1, 4, 2, 512, 256, 0, 32, True, 0, (300, 212)),
    (1, 8, 1, 2048, 256, 4, 128, True, 0, (1800, 248)),
    (1, 8, 2, 1000, 200, 4, 128, True, 0, (2, 30, 32, 500, 436)),
    # the narrow 80 instance: group 16, a pack that starts at position 2
    (1, 16, 1, 1000, 80, 4, 128, True, 2, (300, 30, 32, 500, 138)),
    # a split sink block (at most 4-5 q blocks a piece at W <= 128) in the
    # second segment, at every instance; in the leading partial segment;
    # fp32 (the optional last field)
    (1, 8, 2, 1536, 64, 4, 128, True, 0, (300, 1236)),     # 4 pieces
    (1, 16, 1, 1024, 80, 4, 128, True, 0, (100, 924)),     # 4 pieces
    (1, 8, 2, 1024, 128, 4, 64, True, 2, (1022, 2)),       # leading: 4
    (1, 4, 2, 1024, 128, 4, 128, True, 0, (200, 824),
     torch.float32),                                       # 3 pieces
    (1, 16, 1, 1024, 256, 4, 128, True, 0, (200, 824)),    # 4 pieces
    (1, 4, 2, 1024, 512, 4, 128, True, 0, (200, 824)),     # 4 pieces
    (1, 4, 2, 1024, 640, 4, 128, True, 0, (200, 824)),     # 4 pieces
] + [
    # the forward's 128-row items and 64-row consumer halves: a segment
    # start inside a half, one at an item boundary, a 1-token segment; the
    # 64, 128, 256 and 512 instances (the last's items are the 64-row
    # halves), with and without s_aux
    (1, 8, 2, 1024, d, 4, w, aux, 0, lengths)
    for d in (64, 128, 256, 512) for aux in (True, False)
    for lengths, w in (((200, 824), 128), ((256, 768), 1024),
                       ((500, 1, 523), 128))
]


@pytest.mark.parametrize("cfg", PACKED_CASES)
def test_packed_kernels_match_plain(cuda, cfg):
    """The packed forward, dQ and dK/dV kernels against their plain
    versions (bf16 outputs: 2e-2 of the largest plain value), dQ and dK/dV
    bitwise equal on a second run, and autograd through
    sink_flash_attention_packed launching each packed kernel once."""
    from sink_attention_tpu_torch.ops import packed
    B, H_q, H_kv, N, D, ns, W, use_aux, first, lengths, *dt = cfg
    gen = torch.Generator(device=cuda).manual_seed(3)
    pos = _segments(N + first, lengths)[first:]
    positions = torch.tensor([pos] * B, device=cuda)
    q, do = (_randn(gen, B, H_q, N, D).to(*dt) for _ in range(2))
    k, v = (_randn(gen, B, H_kv, N, D).to(*dt) for _ in range(2))
    aux = torch.randn(H_q, generator=gen, device=cuda) if use_aux else None
    geom = (ns, W)
    o_k, l_k = packed.packed_fwd_kernel(q, k, v, positions, aux, *geom)
    o_p, l_p = packed.packed_fwd_plain(q, k, v, positions, aux, *geom)
    torch.cuda.synchronize()
    assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2
    assert float((l_k - l_p).abs().max()) <= 1e-3
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, l_p, delta, positions, *geom)
    plain = packed.packed_bwd_plain(*args)
    dq = packed.packed_dq_kernel(*args)
    dk, dv = packed.packed_dkdv_kernel(*args)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        scale = max(1.0, float(ref.float().abs().max()))
        err = float((got.float() - ref.float()).abs().max())
        assert err <= 2e-2 * scale, (name, err, scale)
    assert torch.equal(dq, packed.packed_dq_kernel(*args))
    dk2, dv2 = packed.packed_dkdv_kernel(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)

    kernels = (packed.packed_fwd_kernel, packed.packed_dq_kernel,
               packed.packed_dkdv_kernel)
    counts = [f.launches for f in kernels]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    a = aux.clone().requires_grad_() if use_aux else None
    out = packed.sink_flash_attention_packed(*leaves, positions, *geom,
                                             s_aux=a)
    out.backward(do)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [c + 1 for c in counts]
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in leaves)


ABLATION_CASES = [
    # (B, H_q, H_kv, N, D, num_sink, window)
    (1, 4, 2, 256, 64, 4, 128),
    (1, 4, 2, 256, 64, 0, 128),      # general's NaN rows
    (2, 8, 2, 512, 128, 4, 192),
    (4, 64, 8, 1024, 64, 0, 1024),   # gpt-oss full layer
    (2, 8, 2, 384, 64, 0, 256),      # 3 q blocks of 128: window-start tiles
]


@pytest.mark.parametrize("case", ABLATION_CASES)
def test_ablation_kernels_match_plain(cuda, case):
    """Every ablation stage's kernel against its plain version (bf16
    output: 2e-2 of the largest plain value, NaN in the same places), one
    launch of the stage's kernel each; the correct stages also within 2e-2
    of the forward kernel on their finite rows."""
    from sink_attention_tpu_torch.ops import ablation
    B, H_q, H_kv, N, D, ns, W = case
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, B, H_q, N, D)
    k, v = _randn(gen, B, H_kv, N, D), _randn(gen, B, H_kv, N, D)
    ref, _ = flash.flash_fwd_kernel(q, k, v, None, ns, W)
    for stage in ablation.STAGES:
        before = (ablation.ablation_kernel.launches,
                  ablation.ablation_kernel.launches_mask_stage)
        got = ablation.ablation_attention(q, k, v, stage, ns, W).float()
        plain = ablation.ablation_plain(q, k, v, stage, ns, W).float()
        torch.cuda.synchronize()
        mask_stage = stage in ablation.MASK_STAGES
        assert (ablation.ablation_kernel.launches,
                ablation.ablation_kernel.launches_mask_stage) == (
            before[0] + (not mask_stage), before[1] + mask_stage)
        nan = plain.isnan()
        assert torch.equal(got.isnan(), nan), stage
        scale = float(plain[~nan].abs().max())
        err = float((got - plain)[~nan].abs().max())
        assert err <= 2e-2 * max(scale, 1.0), (stage, err, scale)
        if stage in ("general",) + ablation.MASK_STAGES:
            assert err <= 2e-2, (stage, err)
            assert float((got - ref.float())[~nan].abs().max()) <= 2e-2


def test_ablation_instances_do_not_spill(cuda, tmp_path, monkeypatch):
    """ptxas' lines of a fresh build of ``csrc/ablation.cu``: each of its
    22 instances of the forward's wgmma template (11 stages x D 64 and 128)
    with 0 bytes of spill stores and loads."""
    from sink_attention_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "SOURCES", ("ablation",))
    _build.build_all()
    entry, spills = None, {}
    for line in _build.build_report["ablation"]["ptxas"]:
        if "Compiling entry" in line:
            entry = line
        elif "spill" in line and entry and "fwd_wgmma_kernel" in entry:
            spills[entry] = line
    assert len(spills) == 22, list(spills)
    for entry, line in spills.items():
        assert "0 bytes spill stores, 0 bytes spill loads" in line, entry


FWD_CASES = [
    # (B, H_q, H_kv, N_q, N_kv, D, num_sink, window, use_aux, q_off, kv_off)
    (1, 4, 2, 1000, 1000, 64, 4, 128, True, 0, 0),      # N not a tile multiple
    (1, 4, 2, 200, 200, 128, 70, 1, False, 0, 0),       # window 1, 70 sinks
    (2, 8, 2, 1000, 1000, 128, 0, 1024, True, 0, 0),    # window >= N
    (1, 8, 1, 200, 200, 64, 0, 128, False, 0, 0),       # no sinks, no s_aux
    (1, 4, 2, 200, 456, 64, 4, 128, True, 256, 0),      # chunk at q_offset
    (1, 4, 2, 256, 512, 128, 4, 128, False, 0, -256),   # garbage halo
    (1, 4, 4, 1000, 1000, 128, 70, 300, True, 0, 0),
    (4, 64, 8, 1024, 1024, 64, 0, 1024, True, 0, 0),    # gpt-oss full layer
    # the 512 instance's 64-row items (halves of the 128-row q blocks)
    (1, 4, 2, 1000, 1000, 512, 4, 128, True, 0, 0),     # N not a tile multiple
    (1, 4, 2, 200, 456, 512, 4, 128, True, 256, 0),     # chunk at q_offset
    (1, 4, 2, 256, 512, 512, 4, 128, False, 0, -256),   # garbage halo
    # the wide instance's 64-row items in 512-column slices
    (1, 4, 2, 1000, 1000, 640, 4, 128, True, 0, 0),     # N not a tile multiple
    (1, 4, 2, 200, 456, 1024, 4, 128, True, 256, 0),    # chunk at q_offset
    (1, 4, 2, 256, 512, 2048, 4, 128, False, 0, -256),  # garbage halo
]


@pytest.mark.parametrize("cfg", FWD_CASES)
def test_forward_kernel_matches_plain_with_backward(cuda, cfg):
    """The wgmma/TMA forward against flash_fwd_plain (O within 2e-2, the
    LSE within 1e-3), one launch; then autograd through
    sink_flash_attention, whose backward kernels read the new forward's
    LSE, against flash_bwd_plain (2e-2 of the largest plain value)."""
    B, H_q, H_kv, N_q, N_kv, D, ns, W, use_aux, qo, ko = cfg
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, do = _randn(gen, B, H_q, N_q, D), _randn(gen, B, H_q, N_q, D)
    k, v = _randn(gen, B, H_kv, N_kv, D), _randn(gen, B, H_kv, N_kv, D)
    aux = torch.randn(H_q, generator=gen, device=cuda) if use_aux else None
    geom = (ns, W, qo, ko)
    before = flash.flash_fwd_kernel.launches
    o_k, l_k = flash.flash_fwd_kernel(q, k, v, aux, *geom)
    o_p, l_p = flash.flash_fwd_plain(q, k, v, aux, *geom)
    torch.cuda.synchronize()
    assert flash.flash_fwd_kernel.launches == before + 1
    assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2
    fin = torch.isfinite(l_p)
    assert torch.equal(torch.isfinite(l_k), fin)
    assert float((l_k - l_p)[fin].abs().max()) <= 1e-3

    delta = (do.float() * o_p.float()).sum(-1)
    plain = flash.flash_bwd_plain(q, k, v, do, l_p, delta, *geom)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    a = aux.clone().requires_grad_() if use_aux else None
    out = flash.sink_flash_attention(*leaves, ns, W, s_aux=a, q_offset=qo,
                                     kv_offset=ko)
    out.backward(do)
    torch.cuda.synchronize()
    for name, leaf, ref in zip(("dq", "dk", "dv"), leaves, plain):
        scale = max(1.0, float(ref.float().abs().max()))
        err = float((leaf.grad.float() - ref.float()).abs().max())
        assert err <= 2e-2 * scale, (name, err, scale)


DECODE_CASES = [
    # (B, H_q, H_kv, D, num_sink, window, prefill_len, appends[, dtype]):
    # every row runs the split decode (decode.decode_plan). Up to D = 128 the
    # short-row instances (D_i = 64, 80, 96, 128; whole-row boxes of 64-128
    # slots in bf16, 32-64 in fp32); one range writes its rows without a
    # merge, 2-8 merge in a cluster, more through the workspace
    (2, 8, 8, 64, 0, 1024, 100, 1),      # G = 1, one range of 128 slots
    (2, 64, 8, 128, 0, 1024, 200, 2),    # G = 8, 64-slot tiles
    (2, 64, 8, 128, 4, 1024, 250, 2),    # sinks, a range past hwm
    (2, 32, 2, 64, 4, 1024, 300, 3),     # G = 16
    (2, 32, 1, 128, 0, 1024, 1000, 2),   # G = 32 (MQA): two 16-row pieces
    (1, 64, 1, 64, 0, 2048, 1900, 1),    # G = 64 (MQA): four pieces
    (1, 64, 1, 128, 4, 128, 300, 0),     # G = 64, wrapped ring
    (2, 128, 1, 64, 0, 256, 200, 1),     # G = 128: eight pieces
    (4, 64, 8, 64, 0, 128, 1024, 16),    # gpt-oss-20b's ring: one range
    (4, 64, 8, 64, 0, 1056, 1024, 16),   # its full layer: a cluster of 5
    (64, 8, 8, 64, 0, 2048, 2100, 1),    # 512 units: one range, 4 passes
    # H2O-Danube-1.8B (D = 80, 32/8) and D = 96 over a wrapped 4096-slot
    # window: the 80 and 96 instances (16 ranges of 256 / 128 slots), in
    # bf16 and in fp32 (64- / 32-slot boxes of 320 / 384-byte rows)
    (2, 32, 8, 80, 0, 4096, 8192, 16),
    (2, 32, 8, 80, 0, 4096, 8192, 16, torch.float32),
    (2, 32, 8, 96, 0, 4096, 8192, 3),
    (2, 32, 8, 96, 0, 4096, 8192, 3, torch.float32),
    # B = 1 over a wrapped 32768-slot window: 64 and 128 instances, ranges
    # of one pass of 512 slots
    (1, 64, 8, 64, 0, 32768, 32768, 16),
    (1, 32, 8, 128, 0, 32768, 32768, 16),
    # past D = 128, the deep instance (16-row pieces, ranges of 32-slot
    # tiles, the partials merged by each unit's last CTA)
    (2, 32, 2, 512, 4, 1024, 300, 3),    # G = 16: one piece
    (1, 40, 2, 512, 0, 2048, 1900, 1),   # G = 20: two pieces
    (2, 32, 2, 1024, 4, 1024, 300, 3),   # G = 16, two column chunks
    (1, 40, 2, 640, 0, 2048, 1900, 1),   # G = 20, a part column chunk
    # B = 1 over a wrapped 8320-slot cache (52 ranges of 160 slots per (b,
    # kv head)), MQA 8/1 (Gemma-1-2B's group), G = 64 (four 16-row
    # pieces), a short cache (one range), D = 2048
    (1, 8, 4, 256, 4, 8192, 9000, 2),
    (1, 8, 4, 1024, 4, 8192, 9000, 2),
    (2, 8, 1, 256, 0, 2048, 3000, 1),
    (1, 64, 1, 512, 4, 1024, 1500, 2),
    (2, 8, 4, 256, 0, 64, 20, 1),
    (1, 8, 2, 2048, 4, 1024, 1100, 1),
    # G = 17 / 18: a last piece of 1 / 2 rows beside 16-row pieces
    (1, 17, 1, 640, 4, 1024, 1100, 1),
    (2, 36, 2, 640, 0, 512, 600, 2),
    (2, 34, 2, 1024, 4, 1024, 1100, 1),
    (1, 18, 1, 1024, 0, 2048, 1500, 2),
    # past 512 ranges of 512 slots: ranges walked in passes of 512
    (1, 2, 1, 256, 4, 270000, 270100, 3),
    (1, 2, 1, 64, 4, 270000, 270100, 3),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_any_group_and_cluster(cuda, case):
    """The one-launch decode against decode_plain for GQA groups 1-128,
    bf16 (2e-2) and fp32 (DECODE_TOL): the short-row instances up to D =
    128 (one range, a cluster, a long B = 1 cache, MQA, row pieces), the
    deep instance past it, one launch per call."""
    B, H_q, H_kv, D, ns, W, n, steps = case[:8]
    dtype = case[8] if len(case) > 8 else torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(7)
    mk = lambda *s: _randn(gen, *s).to(dtype)
    cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                             dtype=dtype, device=cuda)
    cache.prefill(mk(B, H_kv, n, D), mk(B, H_kv, n, D))
    for _ in range(steps):
        cache.append(mk(B, H_kv, 1, D), mk(B, H_kv, 1, D))
    aux = torch.randn(H_q, generator=gen, device=cuda)
    q = mk(B, H_q, 1, D)
    before = decode.decode_kernel.launches
    o_k = decode.sink_decode_attention_cached(q, cache, aux)
    o_p = decode.decode_plain(q, cache.k, cache.v, decode.cache_state(cache),
                              aux, **decode.cache_args(cache))
    torch.cuda.synchronize()
    assert decode.decode_kernel.launches == before + 1
    plan = decode.decode_plan(q, cache.k, decode.cache_state(cache),
                              sink_cap=cache.sink_cap,
                              window_size=cache.window_size)
    assert plan["design"] == ("short" if D <= 128 else "deep")
    if dtype == torch.bfloat16:
        assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2
    else:
        torch.testing.assert_close(o_k, o_p, atol=DECODE_TOL[dtype],
                                   rtol=1e-3)


# (bytes an element, head dim) -> (tile slots, instance): the short rows'
# boxes hold the most whole rows of 64 or 128 (fp32: 32 too) that fit 23552
# bytes at their padded strides; past 128 the deep instance's 32-slot tiles
_GEOMETRY = {(2, 64): (128, 64), (2, 72): (128, 80), (2, 80): (128, 80),
             (2, 96): (64, 96), (2, 128): (64, 128), (2, 256): (32, 0),
             (1, 64): (128, 64), (1, 80): (128, 80), (1, 96): (128, 96),
             (1, 128): (128, 128), (1, 1024): (32, 0), (4, 64): (64, 64),
             (4, 80): (64, 80), (4, 96): (32, 96), (4, 128): (32, 128),
             (4, 256): (32, 0)}


def test_decode_library_geometry(cuda):
    """The library's tiles and instances per (storage, head dim), which
    the host's plan reads (decode._geometry); the rows a CTA takes: up to
    16, all 16 for every storage at D <= 128."""
    from sink_attention_tpu_torch.ops import _build
    lib = _build.load("decode")
    for (nb, d), (tile, inst) in _GEOMETRY.items():
        assert lib.sink_decode_tile(nb, d) == tile, (nb, d)
        assert lib.sink_decode_instance(nb, d) == inst, (nb, d)
        if d <= 128:
            assert lib.sink_decode_rows(nb, 64, d) == 16, (nb, d)
    assert lib.sink_decode_rows(4, 17, 2048) == 8
    assert lib.sink_decode_tile(3, 64) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_decode_kernel_one_range(cuda, D, dtype):
    """A sliding ring of one tile (gpt-oss-20b's: B = 4, 64/8, W = 128 at
    D = 64; the library's 64-slot tile at D = 128), wrapped: one range a
    unit (n_split = 1), whose CTA writes its rows with no partial or merge;
    with and without s_aux, and a ring with nothing live but s_aux
    (zeros)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, H_q, H_kv = 4, 64, 8
    W = decode._geometry(2, H_q // H_kv, D)[1]  # one tile
    tol = 2e-2 if dtype == torch.bfloat16 else DECODE_TOL[dtype]
    cache = SinkKVCache.init(B, H_kv, D, num_sink=0, window_size=W,
                             dtype=dtype, device=cuda)
    q = _randn(gen, B, H_q, 1, D).to(dtype)
    kw = decode.cache_args(cache)
    empty = decode.sink_decode_attention_cached(
        q, cache, torch.randn(H_q, generator=gen, device=cuda))
    torch.cuda.synchronize()
    assert not empty.any()
    cache.prefill(_randn(gen, B, H_kv, 1000, D).to(dtype),
                  _randn(gen, B, H_kv, 1000, D).to(dtype))
    plan = decode.decode_plan(q, cache.k, decode.cache_state(cache),
                              sink_cap=cache.sink_cap, window_size=W)
    assert (plan["design"], plan["n_split"]) == ("short", 1)
    for aux in (None, torch.randn(H_q, generator=gen, device=cuda)):
        o_k = decode.sink_decode_attention_cached(q, cache, aux)
        o_p = decode.decode_plain(q, cache.k, cache.v,
                                  decode.cache_state(cache), aux, **kw)
        torch.cuda.synchronize()
        assert float((o_k.float() - o_p.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("D", [2048, 128])
def test_decode_kernel_last_piece_of_one_row(cuda, dtype, D):
    """G = 17: at D = 2048 fp32 takes 8-row pieces (16 would not fit a
    CTA's shared memory), fp16 16-row ones, merged in windows of 2048
    columns; at D = 128 both take 16-row pieces in the short 128 instance.
    Either way the last piece is one row. With and without s_aux, against
    decode_plain at DECODE_TOL."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    B, H_q, H_kv, ns, W = 1, 17, 1, 4, 1024
    cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                             dtype=dtype, device=cuda)
    cache.prefill(_randn(gen, B, H_kv, 1100, D).to(dtype),
                  _randn(gen, B, H_kv, 1100, D).to(dtype))
    q = _randn(gen, B, H_q, 1, D).to(dtype)
    for aux in (None, torch.randn(H_q, generator=gen, device=cuda)):
        before = decode.decode_kernel.launches
        o_k = decode.sink_decode_attention_cached(q, cache, aux)
        o_p = decode.decode_plain(q, cache.k, cache.v,
                                  decode.cache_state(cache), aux,
                                  **decode.cache_args(cache))
        torch.cuda.synchronize()
        assert decode.decode_kernel.launches == before + 1
        torch.testing.assert_close(o_k, o_p, atol=DECODE_TOL[dtype],
                                   rtol=1e-3)


@pytest.mark.parametrize("D", [64, 256, 1024])
def test_decode_kernel_wrapped_ring_at_write_pos_zero(cuda, D):
    """A ring filled exactly (write_pos = 0): the circular-age test wraps
    there; with and without s_aux, in bf16 and fp32 (D > 128: the split
    decode)."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    B, H_q, H_kv, ns, W = 2, 16, 2, 4, 256
    for dtype in (torch.bfloat16, torch.float32):
        cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                                 dtype=dtype, device=cuda)
        n = ns + 3 * W
        cache.prefill(_randn(gen, B, H_kv, n, D).to(dtype),
                      _randn(gen, B, H_kv, n, D).to(dtype))
        assert (cache.write_pos, cache.window_len) == (0, W)
        q = _randn(gen, B, H_q, 1, D).to(dtype)
        for aux in (None, torch.randn(H_q, generator=gen, device=cuda)):
            o_k = decode.sink_decode_attention_cached(q, cache, aux)
            o_p = decode.decode_plain(q, cache.k, cache.v,
                                      decode.cache_state(cache), aux,
                                      **decode.cache_args(cache))
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:
                assert float((o_k.float() - o_p.float()).abs().max()) <= \
                    2e-2
            else:
                torch.testing.assert_close(o_k, o_p, atol=DECODE_TOL[dtype],
                                           rtol=1e-3)


@pytest.mark.parametrize("D", [64, 128, 256, 1024])
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_ragged_decode_mqa_empty_slot(cuda, quant, D):
    """The ragged decode reads the cache's [B] state tensors on the card:
    MQA 32/1, slots at different ring phases, one empty slot (zeros), with
    and without s_aux (the split decode, its ranges planned over the whole
    buffer, most past a short slot's hwm; D <= 128 the short-row
    instances)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    B, H_q, H_kv, ns, W = 4, 32, 1, 4, 512
    lengths = [700, 0, 90, 515]
    caches = [RaggedSinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                                     quant=qn, device=cuda)
              for qn in (quant, None)]
    k = _randn(gen, B, H_kv, max(lengths), D)
    v = _randn(gen, B, H_kv, max(lengths), D)
    for c in caches:
        for b, n in enumerate(lengths):
            if n:
                c.insert(b, k[b], v[b], n)
    for i in range(5):
        kn, vn = _randn(gen, B, H_kv, 1, D), _randn(gen, B, H_kv, 1, D)
        active = torch.tensor([bool(n) and i % (b + 2) != 0
                               for b, n in enumerate(lengths)], device=cuda)
        for c in caches:
            c.append(kn, vn, active)
    qc, ref = caches
    q = _randn(gen, B, H_q, 1, D)
    for aux in (None, torch.randn(H_q, generator=gen, device=cuda)):
        o_k = decode.sink_decode_attention_ragged(q, qc, aux)
        o_p = decode.decode_plain(q, qc.k, qc.v, decode.ragged_lens(qc), aux,
                                  **decode.cache_args(qc))
        o_b = decode.sink_decode_attention_ragged(q, ref, aux)
        torch.cuda.synchronize()
        assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2
        if quant:
            assert float((o_k.float() - o_b.float()).abs().max()) <= \
                QUANT_BUDGET[quant]
        assert not o_k[1].any()


def test_warmed_backward_calls_do_not_synchronise(cuda):
    """A warmed call of the dQ and dK/dV kernels, unpacked and packed,
    issues no synchronising CUDA operation (their tables are on the card
    after the first call)."""
    from sink_attention_tpu_torch.ops import packed
    gen = torch.Generator(device=cuda).manual_seed(12)
    B, H_q, H_kv, N, D = 1, 8, 2, 300, 64
    q, do = _randn(gen, B, H_q, N, D), _randn(gen, B, H_q, N, D)
    k, v = _randn(gen, B, H_kv, N, D), _randn(gen, B, H_kv, N, D)
    o, lse = flash.flash_fwd_kernel(q, k, v, None, 4, 128)
    delta = (do.float() * o.float()).sum(-1)
    positions = torch.tensor([_segments(N, (100, 200))], device=cuda)
    bwd = (q, k, v, do, lse, delta)
    calls = (lambda: flash.flash_dq_kernel(*bwd, 4, 128),
             lambda: flash.flash_dkdv_kernel(*bwd, 4, 128),
             lambda: packed.packed_dq_kernel(*bwd, positions, 4, 128),
             lambda: packed.packed_dkdv_kernel(*bwd, positions, 4, 128))
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("D", [64, 256, 1024])
def test_warmed_calls_do_not_synchronise(cuda, D):
    """A warmed call of the cached decode, the ragged decode and the
    forward issues no synchronising CUDA operation (D > 128: the split
    decode's scratch and counters too)."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    B, H_q, H_kv = 2, 16, 2
    cache = SinkKVCache.init(B, H_kv, D, num_sink=4, window_size=256,
                             device=cuda)
    cache.prefill(_randn(gen, B, H_kv, 300, D), _randn(gen, B, H_kv, 300, D))
    ragged = RaggedSinkKVCache.init(B, H_kv, D, num_sink=4, window_size=256,
                                    quant="int8", device=cuda)
    ragged.insert(0, _randn(gen, H_kv, 300, D), _randn(gen, H_kv, 300, D),
                  300)
    q1 = _randn(gen, B, H_q, 1, D)
    q, k, v = (_randn(gen, B, h, 256, D) for h in (H_q, H_kv, H_kv))
    aux = torch.randn(H_q, generator=gen, device=cuda)
    calls = (lambda: decode.sink_decode_attention_cached(q1, cache, aux),
             lambda: decode.sink_decode_attention_ragged(q1, ragged, aux),
             lambda: flash.sink_flash_attention(q, k, v, 4, 128, s_aux=aux))
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _plain_attention(monkeypatch):
    """The model's prefill and decode attention swapped for the kernels'
    plain versions (the same calls, no kernel)."""
    from sink_attention_tpu_torch.models import model

    def prefill(q, k, v, num_sink, window_size, s_aux=None):
        return flash.flash_fwd_plain(q, k, v, s_aux, num_sink,
                                     window_size)[0]

    def cached(q, cache, s_aux=None):
        return decode.decode_plain(q, cache.k, cache.v,
                                   decode.cache_state(cache), s_aux,
                                   **decode.cache_args(cache))

    monkeypatch.setattr(model, "sink_flash_attention", prefill)
    monkeypatch.setattr(model, "sink_decode_attention_cached", cached)


def test_beam_and_speculative_kernels_match_plain(cuda, monkeypatch):
    """beam_generate (2 beams) and speculative_generate (the target's
    layer 0 as the draft) on a small model with head_dim 64 and a 200-token
    prompt past its window of 128, through the kernels, against the same
    calls with the plain attention: equal tokens, scores within 2e-2."""
    import dataclasses

    from sink_attention_tpu_torch.models import ModelConfig, init_params
    from sink_attention_tpu_torch.serving import (beam_generate,
                                                  speculative_generate)
    cfg = ModelConfig.tiny(num_layers=2, hidden_size=256, num_heads=8,
                           num_kv_heads=2, head_dim=64, vocab_size=512,
                           sliding_window=128, intermediate_size=128)
    dcfg = dataclasses.replace(cfg, num_layers=1,
                               layer_types=cfg.layer_types[:1])
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=cuda)
    draft = {**params, "layers": params["layers"][:1]}
    ids = torch.randint(0, cfg.vocab_size, (1, 200), generator=gen,
                        device=cuda)

    def run():
        beam = beam_generate(params, cfg, ids, 6, num_beams=2, device=cuda)
        spec = speculative_generate(params, draft, cfg, dcfg, ids, 12,
                                    num_draft_tokens=4, device=cuda)
        return beam, spec

    f0, d0 = flash.flash_fwd_kernel.launches, decode.decode_kernel.launches
    (bt, bs), (st, rate) = run()
    torch.cuda.synchronize()
    # beam: 2 prefill layers, 2 x 5 decode steps; speculative: 2 + 1
    # prefill layers and one draft layer per draft step
    assert flash.flash_fwd_kernel.launches - f0 == 2 + 3
    assert decode.decode_kernel.launches - d0 >= 2 * 5 + 4
    _plain_attention(monkeypatch)
    f0, d0 = flash.flash_fwd_kernel.launches, decode.decode_kernel.launches
    (pbt, pbs), (pst, prate) = run()
    assert (flash.flash_fwd_kernel.launches, decode.decode_kernel.launches
            ) == (f0, d0)
    assert bt.tolist() == pbt.tolist() and st.tolist() == pst.tolist()
    assert float((bs - pbs).abs().max()) <= 2e-2 * max(1.0, float(
        pbs.abs().max()))
    assert rate == prate


def test_quantized_matmuls_match_dequantized_on_the_card(cuda):
    """chip_smoke's phase-9 op gates at small shapes: int8, int4 and int4
    group 32 against the fp32 product with the dequantised weight."""
    import chip_smoke

    rows, errors = chip_smoke.quant_op_gates(
        cuda, lm_head=(256, 1024), experts=(4,), hidden=256, inter=128,
        expert_tokens=16)
    assert errors == [] and len(rows) == 3 * (2 + 2 * 2)


@pytest.mark.parametrize("bits, group", [(8, None), (4, None), (4, 32)])
def test_quantized_model_on_the_card_matches_cpu(cuda, bits, group):
    """A small quantized model (head_dim 64, bf16) on the card, through
    the kernels and the bf16 GEMMs with fp32 outputs, against the same
    tree on the CPU: logits at cosine >= 0.999 (JAX's int4 model bound),
    prefill and one decode step."""
    import chip_smoke
    from sink_attention_tpu_torch.models import (ModelConfig, forward_decode,
                                                 forward_prefill,
                                                 init_quantized_params,
                                                 make_caches)

    cfg = ModelConfig.tiny(num_layers=2, hidden_size=256, num_heads=8,
                           num_kv_heads=2, head_dim=64, vocab_size=512,
                           sliding_window=128, intermediate_size=128)
    cpu = torch.device("cpu")
    params = init_quantized_params(cfg, torch.Generator().manual_seed(0),
                                   bits=bits, int4_group_size=group,
                                   device=cpu)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    ids = torch.randint(0, cfg.vocab_size, (2, 200),
                        generator=torch.Generator().manual_seed(1))
    out = []
    for dev, p in ((cpu, params), (cuda, to(params, cuda))):
        caches = make_caches(cfg, 2, 256, device=dev)
        lp, caches = forward_prefill(p, cfg, ids.to(dev), caches)
        ld, _ = forward_decode(p, cfg, ids[:, :1].to(dev), caches, 200)
        out.append((lp.float().cpu(), ld.float().cpu()))
    for ref, got in zip(*out):
        assert bool(got.isfinite().all())
        assert chip_smoke.cosine(got, ref) >= 0.999


SMALL_CFG = dict(num_layers=2, hidden_size=256, num_heads=8, num_kv_heads=2,
                 head_dim=64, vocab_size=512, sliding_window=128,
                 intermediate_size=128)


def _tree_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def test_checkpoint_loads_onto_the_card(cuda, tmp_path):
    """A small checkpoint in the released layout (chip_smoke's writer:
    MXFP4 experts, bf16 dense tensors) loaded on the card, in bf16 and in
    int4, equals its load on the CPU bit for bit."""
    import chip_smoke
    from sink_attention_tpu_torch.models import (ModelConfig,
                                                 load_hf_checkpoint)

    cfg = ModelConfig.tiny(**SMALL_CFG)
    chip_smoke.write_mxfp4_checkpoint(str(tmp_path), cfg, cuda)
    for quant in (None, "int4"):
        got_cfg, on_card = load_hf_checkpoint(str(tmp_path), quant=quant,
                                              device=cuda)
        _, on_cpu = load_hf_checkpoint(str(tmp_path), quant=quant,
                                       device="cpu")
        assert got_cfg == cfg
        card, host = dict(_tree_leaves(on_card)), dict(_tree_leaves(on_cpu))
        assert sorted(card) == sorted(host)
        for path, t in card.items():
            assert t.device.type == "cuda", path
            assert torch.equal(t.cpu(), host[path]), (quant, path)


def test_engine_resume_on_the_card(cuda, tmp_path):
    """An engine snapshot on the card (a greedy and a sampled request, 200-
    token prompts past the window) resumes in a fresh engine to exactly the
    uninterrupted run's tokens, through the kernels."""
    from sink_attention_tpu_torch.models import ModelConfig, init_params
    from sink_attention_tpu_torch.serving import (ContinuousBatchingEngine,
                                                  SamplingParams)

    cfg = ModelConfig.tiny(**SMALL_CFG)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device=cuda)
    prompts = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen,
                            device=cuda).tolist()
    kw = dict(max_batch=2, max_len=512, prefill_bucket=64, seed=3,
              device=cuda)

    def engine():
        eng = ContinuousBatchingEngine(params, cfg, **kw)
        eng.submit(prompts[0], max_new_tokens=12)
        eng.submit(prompts[1], max_new_tokens=12,
                   sampling=SamplingParams(temperature=1.0, top_k=4))
        for _ in range(4):
            eng.step()
        return eng

    d0 = decode.decode_kernel.launches
    want = engine().run(chunk=1)
    assert decode.decode_kernel.launches > d0
    snap = str(tmp_path / "snap")
    engine().save_state(snap)
    fresh = ContinuousBatchingEngine(params, cfg, **kw)
    fresh.load_state(snap)
    got = fresh.run(chunk=1)
    assert got == want and all(len(t) == 12 for t in got.values())


def test_weight_quantizers_on_the_card_equal_the_cpu(cuda):
    """quantize_weight and quantize_weight_int4 (per channel, group 32)
    give on the card the CPU's codes and scales bit for bit (the CPU's are
    JAX's): their scales divide by a tensor, since PyTorch divides a CUDA
    tensor by a Python number as a product with its reciprocal, one bit
    off."""
    from sink_attention_tpu_torch.models import (quantize_weight,
                                                 quantize_weight_int4)

    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        w = torch.randn(512, 384, generator=gen).to(dtype)
        for fn, kw in ((quantize_weight, {}), (quantize_weight_int4, {}),
                       (quantize_weight_int4, {"group_size": 32})):
            host, card = fn(w, **kw), fn(w.to(cuda), **kw)
            for k in host:
                assert torch.equal(card[k].cpu(), host[k]), (fn, kw, k)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_kv_quantize_on_the_card_against_the_cpu(cuda, quant):
    """The KV cache's ``quantize`` on the card equals the CPU's (the CPU's
    are JAX's) bit for bit, scales and codes, on fp32 and bf16 K rows: its
    scale divides by a tensor, as ``ops/int4._div`` does, so no division
    by a Python number becomes a product with a reciprocal on the card."""
    from sink_attention_tpu_torch.cache import quantize

    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(4, 8, 512, 64, generator=gen)
             * torch.rand(4, 8, 512, 1, generator=gen) * 4).to(dtype)
        x[0, 0, :3] = 0.0                      # zero rows: scale 0
        (hc, hs), (cc, cs) = quantize(x, quant), quantize(x.to(cuda), quant)
        assert torch.equal(cs.cpu(), hs), (dtype, quant)
        assert torch.equal(cc.cpu(), hc), (dtype, quant)


def test_sp_world_of_one_on_nccl_matches_the_kernel(cuda, tmp_path):
    """The SP entry points over an NCCL group of one rank (the halo wraps
    round to the rank itself, the sink broadcast and the all-to-all run
    through NCCL) against the single-process kernel: the output and the
    gradients within the forward's and the backward's bf16 tolerances."""
    import torch.distributed as dist
    from sink_attention_tpu_torch import parallel

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        gen = torch.Generator(device=cuda).manual_seed(3)
        q, do = _randn(gen, 1, 8, 2048, 64), _randn(gen, 1, 8, 2048, 64)
        k, v = _randn(gen, 1, 2, 2048, 64), _randn(gen, 1, 2, 2048, 64)
        aux = torch.randn(8, generator=gen, device=cuda)
        for fn, ns, w in ((parallel.sharded_sink_flash_attention, 0, 128),
                          (parallel.sp_sink_flash_attention, 4, 512),
                          (parallel.ring_sink_flash_attention, 4, 2048),
                          (parallel.ulysses_sink_flash_attention, 0, 128)):
            runs = []
            for entry in (fn, flash.sink_flash_attention):
                leaves = [t.clone().requires_grad_(True)
                          for t in (q, k, v, aux)]
                out = entry(*leaves[:3], ns, w, s_aux=leaves[3])
                out.backward(do)
                runs.append([out.detach()] + [t.grad for t in leaves])
            (o, *grads), (ro, *rgrads) = runs
            assert float((o.float() - ro.float()).abs().max()) <= 2e-2
            for g, r in zip(grads, rgrads):
                err = float((g.float() - r.float()).abs().max())
                assert err <= 2e-2 * float(r.float().abs().max()), fn
    finally:
        dist.destroy_process_group()


_GLOO_RANK = r"""
import sys, torch, torch.distributed as dist
from sink_attention_tpu_torch.parallel import _collectives as c
rank, store = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=2)
x = torch.full((2, 4, 6, 8), float(rank + 1), device="cuda",
               requires_grad=True)
s = c.psum(x)
p = c.ppermute(x)
a = c.all_to_all(x, 1, 2)
assert s.is_cuda and p.is_cuda and a.is_cuda
assert bool((s == 3).all()) and bool((p == 2 - rank).all())
assert a.shape == (2, 2, 12, 8) and float(a[0, 0, 0, 0]) == 1.0
assert float(a[0, 0, 6, 0]) == 2.0
(s.sum() + (p * (rank + 1)).sum() + a.sum()).backward()
# d psum: both ranks' ones summed; d ppermute: the right neighbour's
# factor; d all_to_all: one
assert bool((x.grad == 2 + (2 - rank) + 1).all()), x.grad.flatten()[:4]
dist.destroy_process_group()
print("ok", rank)
"""


def test_collectives_on_gloo_with_cuda_tensors(cuda, tmp_path):
    """parallel/_collectives over a gloo group of 2 ranks on the card:
    psum and all_to_all take CUDA tensors as they are, ppermute through
    its host copy; values and the backward of each."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_RANK, str(r),
                               str(tmp_path / "store")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs


_MESH_RANK = r"""
import sys, torch, torch.distributed as dist
from sink_attention_tpu_torch.models import (ModelConfig, decoder_layer,
                                             init_params, rope_cos_sin)
from sink_attention_tpu_torch.ops import eager_sink_attention, flash
from sink_attention_tpu_torch.parallel import (make_mesh, param_leaves,
                                               param_shardings,
                                               tp_decoder_layer,
                                               tp_local_config)
from sink_attention_tpu_torch.parallel.mesh import device_put, tree_map
rank, store = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=2)
cfg = ModelConfig.gpt_oss_20b(num_layers=2)
mesh = make_mesh({"data": 1, "seq": 1, "model": 2})
sh = param_shardings(cfg, mesh)
got = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                  torch.bfloat16, shardings=sh)
whole = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                    torch.bfloat16)
for a, b in zip(param_leaves(got), param_leaves(device_put(whole, sh))):
    assert a.shape == b.shape and torch.equal(a, b)

def cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))

gen = torch.Generator("cuda").manual_seed(1)
x = torch.randn(1, 1024, cfg.hidden_size, generator=gen,
                device="cuda").to(torch.bfloat16)
g = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
cos_t, sin_t = rope_cos_sin(cfg, torch.arange(1024, device="cuda"))

def run(lp, layer, x, attn):
    leaves = param_leaves(lp)
    xi = x.clone().requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    out = layer(lp, xi, attn)
    grads = torch.autograd.grad((out.float() * g.float()).sum(),
                                [xi] + leaves, allow_unused=True,
                                materialize_grads=True)
    return [out.detach()] + list(grads)

def single(lp, xi, attn, cfg=cfg):
    return decoder_layer(lp, cfg, xi, cos_t, sin_t, 1024, attn)

def split(lp, xi, attn):
    return tp_decoder_layer(lp, tp_local_config(cfg, 2), xi, cos_t, sin_t,
                            1024, attn, mesh.group("model"))

kernel = flash.sink_flash_attention
base = flash.flash_fwd_kernel.launches, flash.flash_dq_kernel.launches
one = run(whole["layers"][1], single, x, kernel)
tp = run(got["layers"][1], split, x, kernel)
assert (flash.flash_fwd_kernel.launches, flash.flash_dq_kernel.launches
        ) == (base[0] + 2, base[1] + 2)
ref = run(tree_map(lambda t: t.detach().float(), whole["layers"][1]),
          single, x.float(), eager_sink_attention)
# each value's distance from fp32 (1 - cosine), this rank's block of the
# parameter gradients: the split layer's at most twice the whole one's
shardings = [None, None] + param_leaves(sh["layers"][1])
names = ["out", "dx"] + [str(s.spec) for s in shardings[2:]]
for i, (a, b, r, s) in enumerate(zip(tp, one, ref, shardings)):
    if s is not None:
        b, r = s.local_block(b), s.local_block(r)
    if not bool(r.any()):
        continue
    e_tp, e_one = 1 - cos(a, r), 1 - cos(b, r)
    assert e_tp <= 2 * e_one, (i, names[i], e_tp, e_one)
dist.destroy_process_group()
print("ok", rank)
"""


def test_tp_layer_and_sharded_init_on_gloo_on_the_card(cuda, tmp_path):
    """A world of 2 gloo ranks on the card over gpt-oss-20b at full width
    (2 layers): init_params(shardings=) gives each rank the blocks of the
    whole tree bit for bit; one tp_decoder_layer (the full layer, 1 x
    1024 tokens, the forward and dQ kernels launched once a rank) against
    the single-process decoder_layer on the same bf16 weights, both held
    to the layer in fp32 (plain eager attention): the output's, the input
    gradient's and this rank's block of every parameter gradient's 1 -
    cosine to fp32 at most twice the single-process layer's (the split
    sums round apart in bf16)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_RANK, str(r),
                               str(tmp_path / "store")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs


# ---------------------------------------------------------------------------
# Coverage: every head_dim and bf16 / fp16 / fp32 inputs in the
# seven attention kernels (rows 1-7 of PERF.md's kernel table), at the JAX
# tests' shapes (tests/test_flash_prefill.py, test_flash_backward.py,
# test_decode.py), kernel against plain on the same inputs.
# ---------------------------------------------------------------------------

# 160 and 256 run in the 256 instance as they are, 250 through a padded
# copy (its rows are not whole 16 bytes); 264, 384 and 512 in the 512
# instance as they are, 500 through a padded copy; 520 (a last depth box
# of 8 columns, a second slice of 8), 640, 1024 and 2048 (four slices) in
# the wide instance
COVER_DIMS = (16, 32, 80, 100, 128, 160, 250, 256, 264, 384, 500, 512, 520,
              640, 1024, 2048)
COVER_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
COVER = [(d, dt) for d in COVER_DIMS for dt in COVER_DTYPES]
# The forward's tolerance (atol, rtol 1e-3): JAX's tol() in
# tests/test_flash_prefill.py; fp32 at its TPU value. The kernels read fp32
# operands as bf16, as the TPU's matrix unit does at its default precision,
# so an fp32 kernel is held, as JAX's TPU test holds its kernel to an
# oracle at that same precision, to the plain version whose products read
# bf16 operands (MM); against the exact plain version it keeps the bf16
# kernels' bound.
FWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 6e-3}
MM = {torch.float32: torch.bfloat16}


def _cover_inputs(gen, dtype, *shapes):
    """Scale-1 normal inputs drawn in fp32 and cast, as the JAX tests'."""
    return [torch.randn(*s, generator=gen, device=gen.device).to(dtype)
            for s in shapes]


def _bwd_close(name, got, ref, dtype):
    """Backward outputs: fp32 within JAX's TPU tolerance (atol 2e-3, rtol
    1e-2: tests/test_flash_backward.py) of the plain version at the
    kernels' precision (MM), 16-bit within the forward's tolerance of that
    type relative to the largest plain value."""
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        bad = (got - ref).abs() > 2e-3 + 1e-2 * ref.abs()
        assert not bool(bad.any()), (name, float((got - ref).abs().max()))
    else:
        scale = max(1.0, float(ref.abs().max()))
        err = float((got - ref).abs().max())
        assert err <= FWD_TOL[dtype] * scale, (name, err, scale)


@pytest.mark.parametrize("d, dtype", COVER)
def test_forward_kernel_any_head_dim_and_dtype(cuda, d, dtype):
    """Row 1 at D in COVER_DIMS x (bf16, fp16, fp32): the
    kernel's O (in the input dtype) and LSE against the plain version, one
    launch, a padded copy only for D % 8 != 0."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    B, H_q, H_kv, N = 1, 8, 2, 192
    q, k, v = _cover_inputs(gen, dtype, (B, H_q, N, d), (B, H_kv, N, d),
                            (B, H_kv, N, d))
    aux = torch.randn(H_q, generator=gen, device=cuda)
    fn = flash.flash_fwd_kernel
    before = (fn.launches, fn.padded_copies)
    o_k, l_k = fn(q, k, v, aux, 4, 96)
    o_p, l_p = flash.flash_fwd_plain(q, k, v, aux, 4, 96,
                                     matmul_dtype=MM.get(dtype))
    o_x, _ = flash.flash_fwd_plain(q, k, v, aux, 4, 96)
    torch.cuda.synchronize()
    assert (fn.launches, fn.padded_copies) == (
        before[0] + 1, before[1] + (d % 8 != 0))
    assert o_k.dtype == dtype and tuple(o_k.shape) == (B, H_q, N, d)
    torch.testing.assert_close(o_k.float(), o_p.float(), atol=FWD_TOL[dtype],
                               rtol=1e-3)
    assert float((l_k - l_p).abs().max()) <= 1e-2
    assert float((o_k.float() - o_x.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("d, dtype", COVER)
def test_backward_kernels_any_head_dim_and_dtype(cuda, d, dtype):
    """Rows 2-3 at every covered (D, dtype): dQ and dK/dV (GQA 4:1, so the
    group's sum crosses the cut columns) against flash_bwd_plain, in the
    input dtype, and the autograd path launching each kernel once."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, H_q, H_kv, N = 1, 8, 2, 192
    q, k, v, do = _cover_inputs(gen, dtype, (B, H_q, N, d), (B, H_kv, N, d),
                                (B, H_kv, N, d), (B, H_q, N, d))
    aux = torch.randn(H_q, generator=gen, device=cuda)
    geom = (4, 96, 0, 0)
    mm = MM.get(dtype)
    o, lse = flash.flash_fwd_plain(q, k, v, aux, *geom, matmul_dtype=mm)
    delta = (do.float() * o.float()).sum(-1)
    plain = flash.flash_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                  lse, delta, *geom, matmul_dtype=mm)
    dq = flash.flash_dq_kernel(q, k, v, do, lse, delta, *geom)
    dk, dv = flash.flash_dkdv_kernel(q, k, v, do, lse, delta, *geom)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        assert got.dtype == dtype and got.shape == ref.shape
        _bwd_close(name, got, ref, dtype)
    counts = [f.launches for f in (flash.flash_fwd_kernel,
                                   flash.flash_dq_kernel,
                                   flash.flash_dkdv_kernel)]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    flash.sink_flash_attention(*leaves, 4, 96, s_aux=aux).backward(do)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash.flash_fwd_kernel,
                                 flash.flash_dq_kernel,
                                 flash.flash_dkdv_kernel)] == [
        c + 1 for c in counts]
    assert all(t.grad.dtype == dtype and bool(torch.isfinite(t.grad).all())
               for t in leaves)


@pytest.mark.parametrize("d, dtype", COVER)
def test_packed_kernels_any_head_dim_and_dtype(cuda, d, dtype):
    """Rows 5-7 at every covered (D, dtype): the packed forward, dQ and
    dK/dV against their plain versions on a pack of three segments."""
    from sink_attention_tpu_torch.ops import packed
    gen = torch.Generator(device=cuda).manual_seed(12)
    B, H_q, H_kv, N = 1, 8, 2, 256
    positions = torch.tensor([_segments(N, (100, 30, 126))], device=cuda)
    q, k, v, do = _cover_inputs(gen, dtype, (B, H_q, N, d), (B, H_kv, N, d),
                                (B, H_kv, N, d), (B, H_q, N, d))
    aux = torch.randn(H_q, generator=gen, device=cuda)
    geom = (4, 64)
    mm = MM.get(dtype)
    o_k, l_k = packed.packed_fwd_kernel(q, k, v, positions, aux, *geom)
    o_p, l_p = packed.packed_fwd_plain(q, k, v, positions, aux, *geom,
                                       matmul_dtype=mm)
    torch.cuda.synchronize()
    assert o_k.dtype == dtype
    torch.testing.assert_close(o_k.float(), o_p.float(), atol=FWD_TOL[dtype],
                               rtol=1e-3)
    assert float((l_k - l_p).abs().max()) <= 1e-2
    delta = (do.float() * o_p.float()).sum(-1)
    plain = packed.packed_bwd_plain(q.float(), k.float(), v.float(),
                                    do.float(), l_p, delta, positions, *geom,
                                    matmul_dtype=mm)
    args = (q, k, v, do, l_p, delta, positions, *geom)
    dq = packed.packed_dq_kernel(*args)
    dk, dv = packed.packed_dkdv_kernel(*args)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        assert got.dtype == dtype
        _bwd_close(name, got, ref, dtype)


@pytest.mark.parametrize("route", ["unpacked", "packed"])
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256, 512, 1024])
def test_fp32_gradients_carry_p_and_ds_at_16_bits(cuda, d, route):
    """The fp32 dQ and dK/dV kernels, unpacked and packed, on the packed
    case's inputs (seed 12), where one bf16 rounding of a P or dS value
    near a rounding midpoint, made apart by the kernel and the plain
    version, once put dK 3.8e-3 and dV 4.9e-3 off at D = 256 (2^-8 |P|
    |dO| a step): within JAX's fp32 tolerance of the plain version at the
    kernels' precision, and within 2e-4 + 1e-3 |ref| of it, far inside one
    such step, since the kernels carry P and dS as two bf16 terms."""
    from sink_attention_tpu_torch.ops import packed
    gen = torch.Generator(device=cuda).manual_seed(12)
    B, H_q, H_kv, N = 1, 8, 2, 256
    positions = torch.tensor([_segments(N, (100, 30, 126))], device=cuda)
    q, k, v, do = _cover_inputs(gen, torch.float32, (B, H_q, N, d),
                                (B, H_kv, N, d), (B, H_kv, N, d),
                                (B, H_q, N, d))
    aux = torch.randn(H_q, generator=gen, device=cuda)
    mm = torch.bfloat16
    if route == "packed":
        o, lse = packed.packed_fwd_plain(q, k, v, positions, aux, 4, 64,
                                         matmul_dtype=mm)
        delta = (do * o).sum(-1)
        args = (q, k, v, do, lse, delta, positions, 4, 64)
        plain = packed.packed_bwd_plain(*args, matmul_dtype=mm)
        got = (packed.packed_dq_kernel(*args),
               *packed.packed_dkdv_kernel(*args))
    else:
        o, lse = flash.flash_fwd_plain(q, k, v, aux, 4, 64, matmul_dtype=mm)
        delta = (do * o).sum(-1)
        args = (q, k, v, do, lse, delta, 4, 64)
        plain = flash.flash_bwd_plain(*args, matmul_dtype=mm)
        got = (flash.flash_dq_kernel(*args), *flash.flash_dkdv_kernel(*args))
    torch.cuda.synchronize()
    for name, g, ref in zip(("dq", "dk", "dv"), got, plain):
        _bwd_close(name, g, ref, torch.float32)
        err = (g - ref).abs()
        assert not bool((err > 2e-4 + 1e-3 * ref.abs()).any()), (
            name, float(err.max()))


# The narrow instances of the forward, dQ and dK/dV (80 and 96 columns on
# the 128 instance's tiles): D 72 and 88 with zero-filled columns, 80 and
# 96 whole.
NARROW_DIMS = (72, 80, 88, 96)
NARROW_GEOMS = (  # (num_sink, window, s_aux)
    (4, 96, True),
    (0, 96, False),
    # a window of 32: the second consumer's 64 rows of a 128-row q block
    # see no key of the block before (forward, dQ), and the first consumer's 64
    # keys of a 128-key item no query of its third q tile (dK/dV)
    (0, 32, True),
)


def _narrow_case(cuda, d, dtype, route, ns, W, use_aux):
    """(kernel outputs, plain outputs) of the forward and the backward at
    (d, dtype) on one route, and the backward kernels' second runs."""
    from sink_attention_tpu_torch.ops import packed
    gen = torch.Generator(device=cuda).manual_seed(13)
    B, H_q, H_kv, N = 1, 8, 2, 320
    q, k, v, do = _cover_inputs(gen, dtype, (B, H_q, N, d), (B, H_kv, N, d),
                                (B, H_kv, N, d), (B, H_q, N, d))
    aux = torch.randn(H_q, generator=gen, device=cuda) if use_aux else None
    mm = MM.get(dtype)
    if route == "packed":
        positions = torch.tensor([_segments(N, (100, 30, 190))], device=cuda)
        ext = (positions, ns, W)
        fwd_k = lambda: packed.packed_fwd_kernel(q, k, v, positions, aux, ns,
                                                 W)
        o, lse = packed.packed_fwd_plain(q, k, v, positions, aux, ns, W,
                                         matmul_dtype=mm)
        bwd_plain, dq_k, dkdv_k = (packed.packed_bwd_plain,
                                   packed.packed_dq_kernel,
                                   packed.packed_dkdv_kernel)
    else:
        ext = (ns, W, 0, 0)
        fwd_k = lambda: flash.flash_fwd_kernel(q, k, v, aux, ns, W)
        o, lse = flash.flash_fwd_plain(q, k, v, aux, ns, W, matmul_dtype=mm)
        bwd_plain, dq_k, dkdv_k = (flash.flash_bwd_plain,
                                   flash.flash_dq_kernel,
                                   flash.flash_dkdv_kernel)
    delta = (do.float() * o.float()).sum(-1)
    plain = bwd_plain(q.float(), k.float(), v.float(), do.float(), lse,
                      delta, *ext, matmul_dtype=mm)
    args = (q, k, v, do, lse, delta, *ext)
    got = (fwd_k(), dq_k(*args), *dkdv_k(*args))
    again = (dq_k(*args), *dkdv_k(*args))
    torch.cuda.synchronize()
    return got, (o, lse, *plain), again


@pytest.mark.parametrize("route", ["unpacked", "packed"])
@pytest.mark.parametrize("dtype", COVER_DTYPES)
@pytest.mark.parametrize("d", NARROW_DIMS)
def test_narrow_instances_match_plain(cuda, d, dtype, route):
    """Rows 1-3 and 5-7 in the narrow instances at D 72-96, bf16 / fp16 /
    fp32, unpacked and packed (a pack of three segments), with and
    without sinks and s_aux and at a window that leaves tiles dead for one
    consumer: O and LSE, dQ, dK and dV against the plain versions at the
    kernels' precision, dQ and dK/dV bitwise equal on a second run; the
    wrappers record the instance the library reports."""
    from sink_attention_tpu_torch.ops import packed
    for ns, W, use_aux in NARROW_GEOMS:
        (o_l, dq, dk, dv), (o, lse, *plain), again = _narrow_case(
            cuda, d, dtype, route, ns, W, use_aux)
        what = (ns, W, use_aux)
        assert o_l[0].dtype == dtype, what
        torch.testing.assert_close(o_l[0].float(), o.float(),
                                   atol=FWD_TOL[dtype], rtol=1e-3,
                                   msg=lambda m: f"{what} O: {m}")
        assert float((o_l[1] - lse).abs().max()) <= 1e-2, what
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
            assert got.dtype == dtype and got.shape == ref.shape, what
            _bwd_close(f"{name} {what}", got, ref, dtype)
        assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)), \
            what
    want = 80 if d <= 80 else 96
    fns = ((packed.packed_fwd_kernel, packed.packed_dq_kernel,
            packed.packed_dkdv_kernel) if route == "packed" else
           (flash.flash_fwd_kernel, flash.flash_dq_kernel,
            flash.flash_dkdv_kernel))
    assert [(d, want) in f.instances for f in fns] == [True] * 3


def test_libraries_report_each_kernels_instance(cuda):
    """Each library's instance entries: the forward, dQ and dK/dV
    (unpacked and packed) run D <= 64 in the 64 instance, 65-80 in the 80
    one, 81-96 in the 96 one, 97-128 in 128, 129-256 in 256, 257-512 in
    512, past 512 in the wide instance (513); a D that is not a multiple
    of 8 in none (0: the host pads it)."""
    from sink_attention_tpu_torch.ops import _build

    def rule(d):
        if d % 8:
            return 0
        return next((i for i in (64, 80, 96, 128, 256, 512) if d <= i), 513)
    entries = (("flash_fwd", "sink_fwd_instance"),
               ("flash_bwd", "sink_dq_instance"),
               ("flash_bwd", "sink_dkdv_instance"),
               ("packed", "sink_pfwd_instance"),
               ("packed", "sink_pdq_instance"),
               ("packed", "sink_pdkdv_instance"))
    for source, entry in entries:
        got = [_build.instance_of(source, entry, d) for d in range(1, 1100)]
        assert got == [rule(d) for d in range(1, 1100)], entry


# Decode: fp32 storage computes in fp32 (JAX's CPU fp32 tolerance, 1e-5 with
# rtol 1e-3: tests/test_decode.py); bf16 2e-2 as above; fp16 4e-3.
DECODE_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
              torch.float32: 1e-5}


@pytest.mark.parametrize("d, dtype", COVER)
def test_decode_kernel_any_head_dim_and_dtype(cuda, d, dtype):
    """Row 4a at every covered (D, dtype) over a rolling cache of that
    dtype (sinks, a wrapped window; GQA 4:1 as JAX's D=80 case), against
    decode_plain; a padded copy only where the rows are not whole 16
    bytes."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    B, H_q, H_kv, W = 1, 8, 2, 256
    cache = SinkKVCache.init(B, H_kv, d, num_sink=4, window_size=W,
                             dtype=dtype, device=cuda)
    cache.prefill(*_cover_inputs(gen, dtype, (B, H_kv, 448, d),
                                 (B, H_kv, 448, d)))
    aux = torch.randn(H_q, generator=gen, device=cuda)
    fn = decode.decode_kernel
    for _ in range(3):
        cache.append(*_cover_inputs(gen, dtype, (B, H_kv, 1, d),
                                    (B, H_kv, 1, d)))
        (q,) = _cover_inputs(gen, dtype, (B, H_q, 1, d))
        before = (fn.launches, fn.padded_copies)
        o_k = decode.sink_decode_attention_cached(q, cache, aux)
        o_p = decode.decode_plain(q, cache.k, cache.v,
                                  decode.cache_state(cache), aux,
                                  **decode.cache_args(cache))
        torch.cuda.synchronize()
        pad = d * q.element_size() % 16 != 0 or d % 4 != 0
        assert (fn.launches, fn.padded_copies) == (before[0] + 1,
                                                   before[1] + pad)
        assert o_k.dtype == dtype and o_k.shape == q.shape
        torch.testing.assert_close(o_k.float(), o_p.float(),
                                   atol=DECODE_TOL[dtype], rtol=1e-3)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
@pytest.mark.parametrize("d", [32, 80, 256, 512, 520, 1024])
def test_quantized_decode_any_head_dim(cuda, quant, d):
    """Rows 4b-4c at D = 32, 80, 256, 512, 520 (a padded copy to 528) and
    1024: the int8 / fp8 kernel
    against its plain version (2e-2 on the bf16 output) and against the
    bf16 kernel over the unquantized KV (the JAX tests' budget), one launch
    of its branch."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    B, H_q, H_kv, W = 2, 8, 2, 256
    caches = [SinkKVCache.init(B, H_kv, d, num_sink=4, window_size=W,
                               quant=qn, device=cuda) for qn in (quant, None)]
    k, v = _randn(gen, B, H_kv, 448, d), _randn(gen, B, H_kv, 448, d)
    for c in caches:
        c.prefill(k, v)
    qc, ref = caches
    q = _randn(gen, B, H_q, 1, d)
    aux = torch.randn(H_q, generator=gen, device=cuda)
    attr = f"launches_{quant}"
    before = getattr(decode.decode_kernel, attr)
    o_k = decode.sink_decode_attention_cached(q, qc, aux)
    assert getattr(decode.decode_kernel, attr) == before + 1
    o_p = decode.decode_plain(q, qc.k, qc.v, decode.cache_state(qc), aux,
                              **decode.cache_args(qc))
    o_b = decode.sink_decode_attention_cached(q, ref, aux)
    torch.cuda.synchronize()
    assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2
    assert float((o_k.float() - o_b.float()).abs().max()) <= \
        QUANT_BUDGET[quant]


def test_head_dim_above_128_raises_on_cuda(cuda):
    """D = 520, past the widest fixed instance (512), once raised here: it
    now runs in the wide instance. Every wrapper launches its kernel once
    on CUDA tensors at D = 520 (no plain fallback), and holds against its
    plain version; a non-positive head dim still raises."""
    from sink_attention_tpu_torch.ops import _build, packed
    gen = torch.Generator(device=cuda).manual_seed(15)
    d = 520
    q, do = _randn(gen, 1, 4, 128, d), _randn(gen, 1, 4, 128, d)
    k, v = _randn(gen, 1, 2, 128, d), _randn(gen, 1, 2, 128, d)
    aux = torch.randn(4, generator=gen, device=cuda)
    pos = torch.tensor([_segments(128, (50, 78))], device=cuda)
    wrappers = (flash.flash_fwd_kernel, flash.flash_dq_kernel,
                flash.flash_dkdv_kernel, packed.packed_fwd_kernel,
                packed.packed_dq_kernel, packed.packed_dkdv_kernel,
                decode.decode_kernel)
    counts = [f.launches for f in wrappers]
    o, lse = flash.flash_fwd_plain(q, k, v, aux, 4, 64)
    delta = (do.float() * o.float()).sum(-1)
    po, plse = packed.packed_fwd_plain(q, k, v, pos, aux, 4, 64)
    pdelta = (do.float() * po.float()).sum(-1)
    pairs = [
        (flash.flash_fwd_kernel(q, k, v, aux, 4, 64)[0], o),
        (flash.flash_dq_kernel(q, k, v, do, lse, delta, 4, 64),
         flash.flash_bwd_plain(q, k, v, do, lse, delta, 4, 64)[0]),
        (torch.cat(flash.flash_dkdv_kernel(q, k, v, do, lse, delta, 4, 64)),
         torch.cat(flash.flash_bwd_plain(q, k, v, do, lse, delta, 4, 64)[1:])),
        (packed.packed_fwd_kernel(q, k, v, pos, aux, 4, 64)[0], po),
        (packed.packed_dq_kernel(q, k, v, do, plse, pdelta, pos, 4, 64),
         packed.packed_bwd_plain(q, k, v, do, plse, pdelta, pos, 4, 64)[0]),
        (torch.cat(packed.packed_dkdv_kernel(q, k, v, do, plse, pdelta, pos,
                                             4, 64)),
         torch.cat(packed.packed_bwd_plain(q, k, v, do, plse, pdelta, pos, 4,
                                           64)[1:])),
        (decode.decode_kernel(q[:, :, :1], k, v, (0, 100, 100), aux,
                              sink_cap=0, window_size=128),
         decode.decode_plain(q[:, :, :1], k, v, (0, 100, 100), aux,
                             sink_cap=0, window_size=128))]
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [c + 1 for c in counts]
    for i, (got, ref) in enumerate(pairs):
        scale = max(1.0, float(ref.float().abs().max()))
        err = float((got.float() - ref.float()).abs().max())
        assert err <= 2e-2 * scale, (wrappers[i].__name__, err, scale)
    for bad in (0, -8):
        with pytest.raises(ValueError, match="head_dim"):
            _build.kernel_head_dim(bad)


def test_chunk_op_with_three_offsets_at_head_dim_1024(cuda):
    """The sequence-parallel chunk op (q_offset, kv_offset, col_hi) at D =
    1024, in the wide instance: its (out, lse) partial and the gradients
    of a loss over both against the same op on the CPU (the kernels' plain
    versions), in fp32 there; the forward, dQ and dK/dV kernels launch
    once each."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    d, offsets = 1024, (192, 64, 300)
    q, do = _randn(gen, 1, 4, 128, d), _randn(gen, 1, 4, 128, d)
    k, v = _randn(gen, 1, 2, 320, d), _randn(gen, 1, 2, 320, d)
    dl = torch.randn(1, 4, 128, generator=gen, device=cuda)
    fns = (flash.flash_fwd_kernel, flash.flash_dq_kernel,
           flash.flash_dkdv_kernel)
    counts = [f.launches for f in fns]
    results = []
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.float32)):
        leaves = [t.detach().to(dev, dtype).clone().requires_grad_()
                  for t in (q, k, v)]
        out, lse = flash.sink_flash_attention_chunk(*leaves, offsets, 4, 96)
        ((out.float() * do.to(dev).float()).sum()
         + (torch.nan_to_num(lse, neginf=0.0) * dl.to(dev)).sum()).backward()
        results.append([t.detach().float().cpu() for t in (
            out, lse, *(x.grad for x in leaves))])
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    for name, got, ref in zip(("out", "lse", "dq", "dk", "dv"), *results):
        assert torch.equal(torch.isfinite(got), torch.isfinite(ref)), name
        fin = torch.isfinite(ref)
        scale = max(1.0, float(ref[fin].abs().max()))
        err = float((got[fin] - ref[fin]).abs().max())
        assert err <= 2e-2 * scale, (name, err, scale)
