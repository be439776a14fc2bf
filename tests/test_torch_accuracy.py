"""The port's accuracy tables (``sink_attention_tpu_torch.scripts
.numerical_accuracy``): one row of each table against the JAX package's
function on the same numpy inputs, at the JAX tests' tolerances (the
forward, the gradients with s_aux, the packed forward and gradients, the
cached decode over fp32, int8 and fp8 storage, the multi-token decode), the
rows' structure on the CPU, the gate arithmetic and the dK/dV piece counts
of the split rows. The JAX side runs as its own tests run it on the CPU
(Pallas in interpret mode); the port's wrappers take their plain versions
on CPU tensors."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
from sink_attention_tpu.cache import SinkKVCache as JCache
from sink_attention_tpu.ops import eager_sink_attention as j_eager
from sink_attention_tpu.ops import sink_decode_attention_cached as j_decode
from sink_attention_tpu.ops import sink_flash_attention as j_flash
from sink_attention_tpu.ops import sink_flash_attention_packed as j_packed
from sink_attention_tpu.ops.decode import (
    sink_decode_attention_cached_multi as j_multi)
from sink_attention_tpu_torch.ops.packed import pack_positions
from sink_attention_tpu_torch.scripts import numerical_accuracy as na

CPU = torch.device("cpu")
GRADS = ("dq", "dk", "dv", "ds_aux")


def _np(t):
    return t.detach().float().numpy()


def test_forward_row_matches_jax():
    """The table's first row (fp32, 8/8, N=256, 4 sinks, W=128): the
    port's output and its oracle against the JAX kernel and oracle
    (tests/test_flash_prefill.py's fp32 CPU bound, 2e-5 + 1e-3)."""
    config = na.FWD_CONFIGS[0]
    B, Hq, Hkv, N, D, ns, W, dtype = config
    q, k, v, aux = (jnp.asarray(a) for a in na.inputs(0, B, Hq, Hkv, N, D))
    out, ref, _ = na.fwd_case(config, CPU)
    np.testing.assert_allclose(_np(out), np.asarray(j_flash(
        q, k, v, ns, W, s_aux=aux)), atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(_np(ref), np.asarray(j_eager(
        q, k, v, ns, W, s_aux=aux)), atol=2e-5, rtol=1e-3)


def test_gradient_row_matches_jax():
    """The table's GQA row (8/2, N=256, W=64): dq, dk, dv and ds_aux of
    sum(o ** 2), the port's against jax.grad through the JAX kernel
    (tests/test_flash_backward.py's CPU bound, 1e-4 + 1e-2)."""
    config = na.GRAD_CONFIGS[1]
    B, Hq, Hkv, N, D, ns, W = config
    args = [jnp.asarray(a) for a in na.inputs(1, B, Hq, Hkv, N, D)]
    want = jax.grad(lambda q, k, v, a: jnp.sum(
        j_flash(q, k, v, ns, W, s_aux=a) ** 2), (0, 1, 2, 3))(*args)
    kern, ref, _ = na.grad_case(config, CPU)
    for name, got, oracle, w in zip(GRADS, kern, ref, want):
        np.testing.assert_allclose(_np(got), np.asarray(w), atol=1e-4,
                                   rtol=1e-2, err_msg=name)
        np.testing.assert_allclose(_np(oracle), np.asarray(w), atol=1e-4,
                                   rtol=1e-2, err_msg=name)


def test_packed_row_matches_jax():
    """The table's four-segment pack: output and gradients against the
    JAX packed kernel (tests/test_packed.py's bounds: 5e-5; abs < 2e-3 or
    rel < 1e-3)."""
    segs, D = na.PACKS[1]
    B, Hq, Hkv, ns, W = na.PACK_GEOMETRY
    args = [jnp.asarray(a) for a in na.inputs(3, B, Hq, Hkv, sum(segs), D)]
    pos = jnp.asarray(pack_positions(segs)[None].numpy(), jnp.int32)

    def attn(q, k, v, a):
        return j_packed(q, k, v, pos, ns, W, s_aux=a, block_q=64,
                        block_kv=64)

    want = jax.grad(lambda *x: jnp.sum(attn(*x) ** 2), (0, 1, 2, 3))(*args)
    (out, grads), _, _ = na.packed_case((segs, D), CPU)
    np.testing.assert_allclose(_np(out), np.asarray(attn(*args)), atol=5e-5)
    for name, got, w in zip(GRADS, grads, want):
        err = np.abs(_np(got) - np.asarray(w))
        assert (err.max() < 2e-3
                or (err / (np.abs(np.asarray(w)) + 1e-3)).max() < 1e-3), name


@pytest.mark.parametrize("storage", ["float32", "int8", "fp8"])
def test_decode_row_matches_jax(storage):
    """A decode row cut to 2 steps after its 80-token prefill (the ring
    wrapped): each step's output against the JAX cached decode kernel on
    the same cache, fp32 at tests/test_decode.py's CPU bound (1e-5), int8
    and fp8 within the JAX kernels' gap to attention over the dequantized
    cache (tests/test_torch_quant_cache.py:119)."""
    config = next(c for c in na.DECODE_CONFIGS if c[0] == storage)
    config = config[:7] + (2,) + config[8:]
    _, D, Hq, Hkv, ns, W, P, steps, _ = config
    q, k, v, aux = na.inputs(2, 1, Hq, Hkv, P + steps, D)
    quant = storage if storage != "float32" else None
    dtype = jnp.float32 if quant is None else jnp.bfloat16
    cache = JCache.init(1, Hkv, D, num_sink=ns, window_size=W, dtype=dtype,
                        quant=quant)
    cache = cache.prefill(jnp.asarray(k[:, :, :P]).astype(dtype),
                          jnp.asarray(v[:, :, :P]).astype(dtype))
    want = []
    for t in range(P, P + steps):
        cache = cache.append(jnp.asarray(k[:, :, t:t + 1]).astype(dtype),
                             jnp.asarray(v[:, :, t:t + 1]).astype(dtype))
        want.append(np.asarray(j_decode(
            jnp.asarray(q[:, :, t:t + 1]).astype(dtype), cache,
            s_aux=jnp.asarray(aux)).astype(jnp.float32)))
    out, ref, ctl, plan = na.decode_case(config, CPU)
    assert plan is None and out.shape == (1, Hq, steps, D)
    tol = {"float32": 1e-5, "int8": 3e-2, "fp8": 1e-2}[storage]
    np.testing.assert_allclose(_np(out), np.concatenate(want, 2), atol=tol)
    # on the CPU the kernel's column is its plain version, the control
    assert torch.equal(out, ctl)


def test_multi_decode_row_matches_jax():
    """The table's first multi-token row (P=100, T=4) against the JAX
    op (tests/test_decode.py:182's bound, 1e-5)."""
    P, T = na.MULTI_CONFIGS[0]
    B, Hq, Hkv, D, ns, W = na.MULTI_GEOMETRY
    q, k, v, aux = (jnp.asarray(a) for a in na.inputs(4, B, Hq, Hkv, P + T,
                                                       D))
    cache = JCache.init(B, Hkv, D, num_sink=ns, window_size=W,
                        dtype=jnp.float32).prefill(k[:, :, :P], v[:, :, :P])
    want, _ = j_multi(q[:, :, P:], k[:, :, P:], v[:, :, P:], cache,
                      s_aux=aux)
    out, ref = na.multi_case((P, T), CPU)
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(_np(ref), np.asarray(want), atol=1e-5)


def test_gate_arithmetic():
    # "a" within 2 x its control, "b" past it but within its floor
    row = na.gated("t", "c", "float32", {"a": 1.0, "b": 0.3},
                   {"a": 0.6, "b": 0.1}, {"a": 5.0, "b": 1.0}, "src",
                   extra=1)
    assert row["gate"] == {"a": 1.2, "b": 0.2} and row["ok"]
    assert row["floor_ratio"] == {"a": 5.0, "b": 1.0}
    assert row["extra"] == 1 and row["source"] == "src"
    assert not na.gated("t", "c", "float32", {"a": 1.3}, {"a": 0.6},
                        {"a": 1.01}, "src")["ok"]
    # no control: the floor alone; a NaN error misses any gate
    row = na.gated("t", "c", "f", {"a": 0.2}, None, {"a": 0.9}, "s")
    assert row["gate"] == {"a": None} and row["ok"]
    assert not na.gated("t", "c", "f", {"a": 0.2}, None, {"a": 1.1},
                        "s")["ok"]
    assert not na.gated("t", "c", "f", {"a": math.nan}, {"a": 1.0},
                        {"a": math.nan}, "s")["ok"]
    # the floor element by element, as assert_allclose applies it: 2e-3 +
    # 1e-2 |ref_i|; an error of 0.01 beside a 0 passes a bound taken from
    # max |ref| (0.032) but not this one
    ref = torch.tensor([-3.0, 1.0, 0.0])
    ratio, source = na.floors("grad", "float32", {
        "dq": (ref + torch.tensor([0.03, -0.006, 0.0]), ref),
        "dk": (ref + torch.tensor([0.0, 0.0, 0.01]), ref)})
    assert ratio == {"dq": pytest.approx(0.03 / 0.032),
                     "dk": pytest.approx(0.01 / 2e-3)}
    assert source == na.FLOORS[("grad", "float32")][2]
    assert math.isnan(na.floor_ratio(torch.tensor([math.nan]), ref[:1],
                                     1e-3, 0.0))


def test_split_rows_piece_counts():
    """The gradient rows that cut the sink key block into pieces (at
    DKDV_BNS 128 and W=128 the cap is 5 q blocks: 16 of N=1024 in 4; at
    D=256, W=256 the cap is 6: in 3), and the packed row whose two
    segments' sink blocks split."""
    assert na.dkdv_split(1024, 4, 128, 64) == (11, 4)
    assert na.dkdv_split(1024, 4, 256, 256) == (18, 3)
    assert na.dkdv_split(256, 4, 128, 64)[1] == 1
    rows = na.packed_table(CPU, configs=[na.PACKS[-1]])
    assert rows[0]["split"] == 3 and rows[0]["pieces"] == 19


def test_table_rows_on_the_cpu():
    """One small row of each table, run by the table functions on the
    CPU: the keys the gates read, every row within its gate, and the
    reference's finite-difference protocol."""
    rows = (na.fwd_table(CPU, configs=[(1, 4, 2, 128, 64, 4, 32,
                                        torch.bfloat16)])
            + na.grad_table(CPU, configs=[(1, 4, 2, 128, 64, 4, 32)])
            + na.ds_aux_fd_table(CPU)
            + na.decode_table(CPU, configs=[("int8", 64, 4, 2, 4, 32, 40,
                                             3, "short")])
            + na.packed_table(CPU, configs=[([64, 64], 64)])
            + na.multi_decode_table(CPU, configs=[(40, 4)]))
    assert [r["table"] for r in rows] == [
        "fwd", "grad", "ds_aux_fd", "decode", "packed", "multi_decode"]
    for r in rows:
        assert r["ok"], r
        assert set(r["gate"]) == set(r["err"]) == set(r["floor_ratio"])
        assert r["control"] is None or set(r["control"]) == set(r["err"])
    assert set(rows[1]["err"]) == set(GRADS) and rows[1]["split"] == 1
    assert set(rows[4]["err"]) == {"out", *GRADS}
    assert rows[3]["design"] == "plain"
    fd = rows[2]
    assert len(fd["analytic"]) == 2 and fd["control"]["ds_aux"] < 1e-2
    # the floor: 5e-2 x max(1, |analytic|), head by head
    assert fd["floor_ratio"]["ds_aux"] == pytest.approx(max(
        abs(a - n) / (5e-2 * max(1.0, abs(a)))
        for a, n in zip(fd["analytic"], fd["numeric"])))
