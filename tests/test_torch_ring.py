"""The port's ring attention (parallel/ring.py) against the JAX package's,
on the CPU: tests/test_parallel.py's ring cases (its sizes and (num_sink,
window) parametrisations, forward and gradients, the skip-ahead step
counts and the order of transfer and kernel), run as in
test_torch_sp.py: JAX in shard_map over the virtual CPU devices (Pallas in
interpret mode) at test_parallel.py's mesh size, the port in gloo worlds
of 2 and 4 ranks, one process per rank. Tolerance: JAX's own in fp32
(atol 1e-4, rtol 1e-3; 2e-4 where test_parallel.py uses it).
"""

import jax
import pytest

import _torch_cores  # noqa: F401 (shares the cores among workers)
import _torch_sp_cases as cases
from sink_attention_tpu.parallel.ring import ring_num_steps as jax_num_steps
from sink_attention_tpu_torch import parallel

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 devices (virtual CPU mesh)")

case, S1024, WORLDS = cases.case, cases.S1024, cases.WORLDS
CASES = [
    # test_ring_matches_single_device
    *(case(f"ring-{ns}-{w}", "ring", S1024, ns, w, 4)
      for ns, w in [(4, 96), (4, 4096), (0, 256)]),
    # test_ring_window_spans_many_shards
    case("ring-many-shards", "ring", (1, 2, 2, 1024, 64), 4, 512, 8,
         aux=False),
    # test_ring_gradients
    case("ring-grads", "ring", (1, 4, 2, 256, 64), 4, 96, 2, grads=True,
         atol=2e-4),
    # test_ring_skip_ahead_step_count and test_ring_permute_precedes_kernel
    case("ring-skip", "ring", (1, 2, 2, 1024, 64), 4, 256, 8, aux=False,
         record=True),
    # test_ring_skip_ahead_gradients
    case("ring-skip-grads", "ring", (1, 2, 2, 512, 64), 4, 64, 4,
         grads=True, atol=2e-4),
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cases.run_both(CASES, str(tmp_path_factory.mktemp("ring_worlds")))


@pytest.mark.parametrize("name,world", cases.params(CASES))
def test_ring_forward_matches_jax(runs, name, world):
    _, port, jax_out = runs
    cases.check_forward(port, jax_out, name, world)


@pytest.mark.parametrize("name,world", cases.params(CASES, grads=True))
def test_ring_gradients_match_jax(runs, name, world):
    _, port, jax_out = runs
    cases.check_grads(port, jax_out, BY_NAME[name], world)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_skip_ahead_step_count(runs, world):
    """ring_num_steps equals JAX's; the ring issues one transfer (K and V
    together) per hop, steps - 1 of them, and runs one chunk kernel per
    step, plus the sink partial where the rotation was cut short."""
    for n_dev, n_local, w in [(32, 4096, 4096), (8, 128, 512),
                              (8, 128, 4096), (4, 256, 1), (4, 256, 257),
                              (2, 512, 65536)]:
        assert parallel.ring_num_steps(n_dev, n_local, w) == jax_num_steps(
            n_dev, n_local, w)
    _, port, _ = runs
    _, records = port[world]
    steps = parallel.ring_num_steps(world, 1024 // world, 256)
    for rec in records:
        events = rec["ring-skip"]["events"]
        assert events.count("start") == steps - 1, events
        assert events.count("kernel") == steps + (steps < world), events


@pytest.mark.parametrize("world", WORLDS)
def test_ring_transfer_precedes_kernel(runs, world):
    """The double-buffered schedule (JAX's test_ring_permute_precedes_
    kernel): at each step but the last, the next hop's transfer is issued
    before the step's chunk kernel and waited on after it, before the next
    step's kernel."""
    _, port, _ = runs
    _, records = port[world]
    steps = parallel.ring_num_steps(world, 1024 // world, 256)
    assert steps >= 2
    for rec in records:
        ev = rec["ring-skip"]["events"]
        starts = [i for i, e in enumerate(ev) if e == "start"]
        kernels = [i for i, e in enumerate(ev) if e == "kernel"]
        waits = [i for i, e in enumerate(ev) if e == "wait"]
        assert len(starts) == len(waits) == steps - 1, ev
        for s in range(steps - 1):
            assert starts[s] < kernels[s] < waits[s] < kernels[s + 1], ev
