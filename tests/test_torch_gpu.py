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
