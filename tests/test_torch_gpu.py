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
]


@pytest.mark.parametrize("cfg", BWD_CASES)
def test_backward_kernels_match_plain(cuda, cfg):
    """dQ and dK/dV kernels against flash_bwd_plain on the same inputs
    (bf16 outputs: 2e-2 of the largest plain value), bitwise equal on a
    second run (no atomics), and autograd through sink_flash_attention
    launching the forward and both backward kernels once each."""
    B, H_q, H_kv, N_q, N_kv, D, ns, W, use_aux, qo, ko = cfg
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, B, H_q, N_q, D)
    k = _randn(gen, B, H_kv, N_kv, D)
    v = _randn(gen, B, H_kv, N_kv, D)
    do = _randn(gen, B, H_q, N_q, D)
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
] + [
    # the forward's 128-row items and 64-row consumer halves: a segment
    # start inside a half, one at an item boundary, a 1-token segment; both
    # head dims, with and without s_aux
    (1, 8, 2, 1024, d, 4, w, aux, 0, lengths)
    for d in (64, 128) for aux in (True, False)
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
    B, H_q, H_kv, N, D, ns, W, use_aux, first, lengths = cfg
    gen = torch.Generator(device=cuda).manual_seed(3)
    pos = _segments(N + first, lengths)[first:]
    positions = torch.tensor([pos] * B, device=cuda)
    q, do = _randn(gen, B, H_q, N, D), _randn(gen, B, H_q, N, D)
    k, v = _randn(gen, B, H_kv, N, D), _randn(gen, B, H_kv, N, D)
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
    # (B, H_q, H_kv, D, num_sink, window, prefill_len, appends): the live
    # range sets the cluster size (decode._cluster_size of its tiles)
    (2, 8, 8, 64, 0, 1024, 100, 1),      # G = 1, 1 tile: cluster 1
    (2, 64, 8, 128, 0, 1024, 200, 2),    # G = 8, 2 tiles: cluster 2
    (2, 64, 8, 128, 4, 1024, 250, 2),    # 3 tiles: cluster 4, a rank idle
    (2, 32, 2, 64, 4, 1024, 300, 3),     # G = 16, 4 tiles: cluster 4
    (2, 32, 1, 128, 0, 1024, 1000, 2),   # G = 32 (MQA), 8 tiles: cluster 8
    (1, 64, 1, 64, 0, 2048, 1900, 1),    # G = 64 (MQA), 15 tiles on 8
    (1, 64, 1, 128, 4, 128, 300, 0),     # G = 64, wrapped ring
    (2, 128, 1, 64, 0, 256, 200, 1),     # G = 128: two 64-row pieces
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_any_group_and_cluster(cuda, case):
    """The one-launch cluster decode against decode_plain for GQA groups
    1-128 and cluster sizes 1-8, one launch per call."""
    B, H_q, H_kv, D, ns, W, n, steps = case
    gen = torch.Generator(device=cuda).manual_seed(7)
    cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                             device=cuda)
    cache.prefill(_randn(gen, B, H_kv, n, D), _randn(gen, B, H_kv, n, D))
    for _ in range(steps):
        cache.append(_randn(gen, B, H_kv, 1, D), _randn(gen, B, H_kv, 1, D))
    aux = torch.randn(H_q, generator=gen, device=cuda)
    q = _randn(gen, B, H_q, 1, D)
    before = decode.decode_kernel.launches
    o_k = decode.sink_decode_attention_cached(q, cache, aux)
    o_p = decode.decode_plain(q, cache.k, cache.v, decode.cache_state(cache),
                              aux, **decode.cache_args(cache))
    torch.cuda.synchronize()
    assert decode.decode_kernel.launches == before + 1
    assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2


def test_decode_kernel_wrapped_ring_at_write_pos_zero(cuda):
    """A ring filled exactly (write_pos = 0): the circular-age test wraps
    there; with and without s_aux."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    B, H_q, H_kv, D, ns, W = 2, 16, 2, 64, 4, 256
    cache = SinkKVCache.init(B, H_kv, D, num_sink=ns, window_size=W,
                             device=cuda)
    n = ns + 3 * W
    cache.prefill(_randn(gen, B, H_kv, n, D), _randn(gen, B, H_kv, n, D))
    assert (cache.write_pos, cache.window_len) == (0, W)
    q = _randn(gen, B, H_q, 1, D)
    for aux in (None, torch.randn(H_q, generator=gen, device=cuda)):
        o_k = decode.sink_decode_attention_cached(q, cache, aux)
        o_p = decode.decode_plain(q, cache.k, cache.v,
                                  decode.cache_state(cache), aux,
                                  **decode.cache_args(cache))
        torch.cuda.synchronize()
        assert float((o_k.float() - o_p.float()).abs().max()) <= 2e-2


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_ragged_decode_mqa_empty_slot(cuda, quant):
    """The ragged decode reads the cache's [B] state tensors on the card:
    MQA 32/1, slots at different ring phases, one empty slot (zeros)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    B, H_q, H_kv, D, ns, W = 4, 32, 1, 128, 4, 512
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
    aux = torch.randn(H_q, generator=gen, device=cuda)
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


def test_warmed_calls_do_not_synchronise(cuda):
    """A warmed call of the cached decode, the ragged decode and the
    forward issues no synchronising CUDA operation."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    B, H_q, H_kv, D = 2, 16, 2, 64
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
    """The KV cache's ``quantize`` on the card against the CPU's (the
    CPU's are JAX's), on fp32 and bf16 K rows. An open fault (ROADMAP
    §C): its scale divides by a Python number, which PyTorch's CUDA
    kernel does as a product with the reciprocal, so a scale may be one
    ulp off the CPU's and a code one step off. This holds the card to
    that and no further: every scale within one ulp, every int8 code
    within one, every fp8 value within one e4m3 step (or the flush of the
    subnormals, 2^-6 of the row's scale). Bit-for-bit equality is the
    repair's test."""
    from sink_attention_tpu_torch.cache import dequantize, quantize

    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(4, 8, 512, 64, generator=gen)
             * torch.rand(4, 8, 512, 1, generator=gen) * 4).to(dtype)
        (hc, hs), (cc, cs) = quantize(x, quant), quantize(x.to(cuda), quant)
        cc, cs = cc.cpu(), cs.cpu()
        ulps = (cs.view(torch.int32) - hs.view(torch.int32)).abs()
        assert int(ulps.max()) <= 1, (dtype, quant)
        if quant == "int8":
            assert int((cc.int() - hc.int()).abs().max()) <= 1, dtype
            continue
        hv, cv = dequantize(hc, hs, quant), dequantize(cc, cs, quant)
        step = 2.0 ** -3 * torch.maximum(hv.abs(), cv.abs()) \
            + 2.0 ** -6 * hs[..., None]
        assert bool(((cv - hv).abs() <= step).all()), dtype
