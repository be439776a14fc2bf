"""The port's halo sequence parallelism (parallel/sp.py), Ulysses
(parallel/ulysses.py) and the dispatcher (parallel/ring.py
``sharded_sink_flash_attention``) against the JAX package's, on the CPU.

The cases are tests/test_parallel.py's: its sizes, its (num_sink, window)
parametrisations, forward and gradients, and the dispatcher's three
regimes (the ring's own cases are in test_torch_ring.py). The same numpy
inputs go to both sides. The JAX side runs in shard_map over the
conftest's virtual CPU devices with its Pallas kernels in interpret mode,
once per case at test_parallel.py's mesh size. The port side runs every
case in gloo worlds of 2 and 4 ranks (4 where the heads split), one
process per rank (``_torch_sp_worker.py``, which imports no JAX), started
once for the module and running beside the JAX side. Gradients come from
the cotangent ``g``; the port's ``s_aux`` gradient is summed over the
ranks, as JAX's shard_map sums the cotangent of a replicated input.
Tolerance: JAX's own in fp32 (atol 1e-4, rtol 1e-3; 2e-4 where
test_parallel.py uses it).

Also here: the chunk op's third offset (``col_hi``) against JAX's chunk,
forward and gradients with an LSE cotangent, and the halo SP's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_cores  # noqa: F401 (shares the cores among workers)
import _torch_sp_cases as cases
from sink_attention_tpu import parallel as jpar
from sink_attention_tpu.ops.flash import (
    sink_flash_attention_chunk as jax_chunk)
from sink_attention_tpu_torch import parallel
from sink_attention_tpu_torch.ops.flash import sink_flash_attention_chunk

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4, reason="needs 4 devices (virtual CPU mesh)")

case, S1024, WORLDS = cases.case, cases.S1024, cases.WORLDS
CASES = [
    # test_sp_matches_single_device
    *(case(f"sp-{ns}-{w}", "sp", S1024, ns, w, 4)
      for ns, w in [(4, 128), (0, 128), (16, 192)]),
    # test_sp_gradients
    case("sp-grads", "sp", (1, 4, 2, 512, 64), 4, 64, 4, grads=True,
         atol=2e-4),
    # test_ulysses_matches_single_device, test_ulysses_gradients (H_kv=2:
    # world 2 only); the same at H 8/4 in a world of 4 too
    case("ulysses", "ulysses", (1, 4, 2, 512, 64), 4, 128, 2, worlds=[2]),
    case("ulysses-grads", "ulysses", (1, 4, 2, 256, 64), 4, 64, 2,
         grads=True, worlds=[2]),
    case("ulysses-grads-h8", "ulysses", (1, 8, 4, 256, 64), 4, 64, 4,
         grads=True),
    # test_ulysses_packed_matches_single_device, and at H 8/4
    case("ulysses-packed", "ulysses_packed", (1, 4, 2, 256, 32), 4, 64, 2,
         worlds=[2], segs=[100, 30, 70, 56]),
    case("ulysses-packed-h8", "ulysses_packed", (1, 8, 4, 256, 32), 4, 64,
         4, grads=True, segs=[100, 30, 70, 56]),
    # test_sharded_dispatcher_matches_single_device
    *(case(f"sharded-{ns}-{w}", "sharded", S1024, ns, w, 4)
      for ns, w in [(4, 128), (4, 640), (300, 128)]),
]
BY_NAME = {c["name"]: c for c in CASES}
BCAST_K = np.arange(2 * 256 * 8, dtype=np.float32).reshape(1, 2, 256, 8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cases.run_both(
        CASES, str(tmp_path_factory.mktemp("sp_worlds")),
        extra_cases=[dict(name="broadcast", fn="broadcast", num_sink=4,
                          worlds=list(WORLDS))],
        extra_inputs={"broadcast/k": BCAST_K})


@pytest.mark.parametrize("name,world", cases.params(CASES))
def test_sp_forward_matches_jax(runs, name, world):
    _, port, jax_out = runs
    cases.check_forward(port, jax_out, name, world)


@pytest.mark.parametrize("name,world", cases.params(CASES, grads=True))
def test_sp_gradients_match_jax(runs, name, world):
    _, port, jax_out = runs
    cases.check_grads(port, jax_out, BY_NAME[name], world)


@pytest.mark.parametrize("world", WORLDS)
def test_broadcast_reduce_and_offset_match_jax(runs, world):
    """broadcast_sink_kv gives every rank rank 0's first num_sink K/V;
    reduce_sink_grads sums over the group; local_position_offset is
    rank * n_local (and the compat aliases equal them, checked in the
    worker): each against its JAX counterpart in shard_map over the same
    number of devices."""
    _, port, _ = runs
    arrays, records = port[world]
    mesh = jpar.make_mesh({"seq": world}, devices=jax.devices()[:world])
    seq, rows = P(None, None, "seq", None), P("seq")

    def island(k):
        r = jax.lax.axis_index("seq")
        sk, sv = jpar.broadcast_sink_kv(k, k + 0.5, 4, "seq")
        dk, dv = jpar.reduce_sink_grads(sk * (r + 1), sv - r, "seq")
        off = jpar.local_position_offset(k.shape[2], "seq")
        return (sk[None], sv[None], dk[None], dv[None],
                jnp.reshape(off, (1,)))

    got = jax.jit(jax.shard_map(island, mesh=mesh, in_specs=(seq,),
                                out_specs=(rows,) * 5, check_vma=False))(
        jnp.asarray(BCAST_K))
    for r in range(world):
        for i, key in enumerate(("sink_k", "sink_v", "dk", "dv")):
            np.testing.assert_array_equal(arrays[r][f"broadcast/{key}"],
                                          np.asarray(got[i][r]), err_msg=key)
        assert records[r]["broadcast"]["offset"] == int(got[4][r])


def test_sp_refuses_what_one_halo_cannot_hold():
    """The two ValueErrors of halo SP (JAX sp.py:99-108), raised before
    any collective, so no process group is needed."""
    q = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match="num_sink=300"):
        parallel.sp_sink_flash_attention(q, q, q, num_sink=300,
                                         window_size=128)
    with pytest.raises(ValueError, match="window_size=640"):
        parallel.sp_sink_flash_attention(q, q, q, num_sink=4,
                                         window_size=640)


COL_HI = [0, 2, 4, 130, 1000]   # none, some sinks, the sinks, mid, past


def test_chunk_third_offset_matches_jax():
    """sink_flash_attention_chunk(offsets=(q_offset, kv_offset, col_hi))
    against JAX's chunk at col_hi in {0, 2, num_sink, mid-chunk, past the
    chunk}: out and lse, and the q/k/v gradients of an out cotangent and
    an LSE cotangent (the JAX chunk tests' tolerances)."""
    rng = np.random.default_rng(40)
    B, H_q, H_kv, D, n_q, n_kv, ns, W = 1, 4, 2, 64, 128, 256, 4, 192
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, H_q, n_q, D), (B, H_kv, n_kv, D), (B, H_kv, n_kv, D),
        (B, H_q, n_q, D)))
    glse = rng.standard_normal((B, H_q, n_q)).astype(np.float32)

    @jax.jit
    def jax_side(offsets, q, k, v):
        (out, lse), vjp = jax.vjp(
            lambda q, k, v: jax_chunk(q, k, v, offsets, ns, W), q, k, v)
        return out, lse, vjp((jnp.asarray(g), jnp.asarray(glse)))

    for col_hi in COL_HI:
        offsets = (256, 0, col_hi)
        jo, jl, jg = jax_side(jnp.asarray(offsets, jnp.int32),
                              *map(jnp.asarray, (q, k, v)))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        out, lse = sink_flash_attention_chunk(tq, tk, tv, offsets, ns, W)
        torch.autograd.backward([out, lse], [torch.from_numpy(g),
                                             torch.from_numpy(glse)])
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                                   atol=1e-4, rtol=1e-3, err_msg=col_hi)
        np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-3, err_msg=col_hi)
        for name, t, ref in zip("qkv", (tq, tk, tv), jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                       atol=2e-4, rtol=1e-3,
                                       err_msg=f"d{name} col_hi={col_hi}")
        if col_hi == 0:
            assert bool(torch.isneginf(lse).all())
            assert not any(bool(t.grad.any()) for t in (tq, tk, tv))
