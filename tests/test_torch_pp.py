"""The port's pipeline parallelism (parallel/pp.py) against the JAX
package's, on the CPU: tests/test_pp.py's cases, configs and inputs.

The stacking is held bit for bit to JAX's (and its round trip to the
tree). ``pipeline_forward``'s logits at (S, M) = (2, 2), (4, 2) and (2,
4) are held to JAX's ``pipeline_forward`` in shard_map over the
conftest's virtual CPU devices (Pallas in interpret mode), and the PP x
TP step to JAX's ``make_pp_train_step``. The other steps (GPipe, the
interleaved schedule at (S, M, V) = (2, 2, 2) and (2, 4, 2), PP with DP
and with SP, PP x TP with each layer checkpointed) are held to the JAX
single-device loss and gradients
(``jax.value_and_grad(cross_entropy_loss)``), which test_pp.py holds
JAX's own pipeline to; JAX's pipeline step costs 25-40 s a case in
interpret mode. The port runs in gloo worlds of 2 and 4 ranks and one of
8 (the (data, pipe, model) = (2, 2, 2) composition), one process per
rank (``_torch_mesh_worker.py``, no JAX), started once for the module.
The JAX cases on 8 devices run as worlds of 4 with one axis at 1.
Gradients come from one SGD step at lr 1 (the update is the gradient),
gathered over the mesh and unstacked. Tolerances: test_pp.py's (logits
5e-4, loss 5e-5, gradients atol 2e-4 / rtol 1e-3).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_cores  # noqa: F401 (shares the cores among workers)
import _torch_mesh_worker as worker
import sink_attention_tpu.models as jm
from sink_attention_tpu.parallel import make_mesh
from sink_attention_tpu.parallel import pp as jpp
from sink_attention_tpu.parallel.train import cross_entropy_loss
from sink_attention_tpu_torch.models import ModelConfig, params_from_jax
from sink_attention_tpu_torch.parallel import param_leaves
from sink_attention_tpu_torch.parallel import pp

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4, reason="needs 4 devices (virtual CPU mesh)")

SLIDING = ("sliding_attention",)


def _cfg(num_layers=4, **kw):
    """test_pp.py's ``_cfg``, as (constructor, kwargs)."""
    base = dict(num_heads=4, num_kv_heads=2, head_dim=16, hidden_size=32,
                num_experts=2, sliding_window=16, vocab_size=64,
                num_layers=num_layers)
    base.update(kw)
    return ("tiny", base)


def jcfg(cfg):
    return jm.ModelConfig.tiny(**cfg[1])


def _params(cfg, seed):
    return jax.tree.map(np.asarray, jm.init_params(
        jcfg(cfg), jax.random.PRNGKey(seed), jnp.float32))


def _ids(seed, shape, vocab):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                         vocab))


def _logit_case(stages, micro):
    cfg = _cfg(4, layer_types=SLIDING * 4) if stages == 4 else _cfg(4)
    return dict(name=f"logits-{stages}-{micro}", kind="pp_logits",
                worlds=[stages], cfg=cfg, micro=micro,
                params=_params(cfg, 1), ids=_ids(2, (micro * 2, 32), 64))


def _step_case(name, cfg, mesh, micro, batch, seed, virtual=1, ref="single",
               remat=False):
    return dict(name=name, kind="pp_step", worlds=[int(np.prod(list(
        mesh.values())))], cfg=cfg, mesh=mesh, micro=micro, virtual=virtual,
        lr=1.0, params=_params(cfg, seed), batch=batch, ref=ref, remat=remat)


TP_CFG = _cfg(2, num_experts=4, layer_types=SLIDING * 2)
LOGIT_CASES = [_logit_case(s, m) for s, m in [(2, 2), (4, 2), (2, 4)]]
STEP_CASES = [
    # test_pp_train_step_matches_reference_loss / _grads_match_single_device
    _step_case("gpipe", _cfg(4), {"pipe": 2}, 2, _ids(4, (4, 33), 64), 3),
    *(_step_case(f"interleaved-{s}-{m}-{v}", _cfg(s * v,
                 layer_types=SLIDING * (s * v)), {"pipe": s}, m,
                 _ids(14, (m * 2, 17), 64), 13, virtual=v)
      for s, m, v in [(2, 2, 2), (2, 4, 2)]),
    # test_pp_with_tp_matches_reference, against JAX's pipeline step
    _step_case("pp-tp", TP_CFG, {"pipe": 2, "model": 2}, 2,
               _ids(10, (4, 17), 64), 9, ref="pipeline"),
    # the same with each layer checkpointed (chip_smoke's phase 12c)
    _step_case("pp-tp-remat", TP_CFG, {"pipe": 2, "model": 2}, 2,
               _ids(10, (4, 17), 64), 9, remat=True),
    # test_pp_with_dp_and_sp on 8 devices: worlds of 4, one axis at 1
    *(_step_case(f"pp-{name}", _cfg(2, layer_types=SLIDING * 2), mesh, 2,
                 _ids(6, (8, 33), 64), 5)
      for name, mesh in (("dp", {"data": 2, "pipe": 2, "seq": 1}),
                         ("sp", {"data": 1, "pipe": 2, "seq": 2}))),
    # test_pp_tp_dp_composition: the file's world of 8
    _step_case("pp-tp-dp", TP_CFG, {"data": 2, "pipe": 2, "model": 2}, 2,
               _ids(12, (4, 17), 64), 11),
]
CASES = LOGIT_CASES + STEP_CASES


def jax_logits(case):
    cfg, S = jcfg(case["cfg"]), case["worlds"][0]
    mesh = make_mesh({"pipe": S}, devices=jax.devices()[:S])
    shardings = jpp.pipeline_param_shardings(cfg, mesh)
    stacked = jax.device_put(jpp.stack_pipeline_params(
        jax.tree.map(jnp.asarray, case["params"]), S), shardings)
    specs = jax.tree.map(lambda s: s.spec, shardings)
    fwd = jax.jit(jax.shard_map(
        lambda p, ids: jpp.pipeline_forward(
            p, cfg, ids, num_stages=S, num_microbatches=case["micro"],
            axis_name="pipe"),
        mesh=mesh, in_specs=(specs, P(None, None)),
        out_specs=P(None, None, None), check_vma=False))
    return np.asarray(fwd(stacked, jnp.asarray(case["ids"])))


def jax_step(case):
    """(loss, gradient tree in layers) of the JAX reference: its
    single-device value_and_grad, or (``ref="pipeline"``) its
    make_pp_train_step with SGD at lr 1, unstacked."""
    cfg = jcfg(case["cfg"])
    params = jax.tree.map(jnp.asarray, case["params"])
    batch = jnp.asarray(case["batch"])
    if case["ref"] == "single":
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: cross_entropy_loss(p, cfg, b)))(params, batch)
        return float(loss), grads
    sizes = case["mesh"]
    mesh = make_mesh(sizes, devices=jax.devices()[:case["worlds"][0]])
    opt = optax.sgd(1.0)
    step, shardings = jpp.make_pp_train_step(
        cfg, mesh, opt, num_microbatches=case["micro"])
    p0 = jax.device_put(jpp.stack_pipeline_params(params, sizes["pipe"]),
                        shardings)
    p1, _, loss = step(p0, opt.init(p0), batch)
    grads = jax.tree.map(lambda a, b: a - b, jax.device_get(p0),
                         jax.device_get(p1))
    return float(loss), jpp.unstack_pipeline_params(grads, cfg.num_layers)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started = worker.start_worlds(CASES, str(tmp_path_factory.mktemp(
        "pp_worlds")))
    # the JAX cases compile in parallel threads (XLA releases the GIL)
    with ThreadPoolExecutor(4) as pool:
        ref = dict(zip([c["name"] for c in CASES], pool.map(
            lambda c: (jax_logits if c["kind"] == "pp_logits"
                       else jax_step)(c), CASES)))
    return worker.collect_worlds(started), ref


@pytest.mark.parametrize("virtual", [1, 2])
def test_stack_roundtrip_matches_jax_bit_for_bit(virtual):
    """stack_pipeline_params equals JAX's stacking leaf by leaf, and
    unstack_pipeline_params gives back the tree, bit for bit."""
    cfg = _cfg(4, layer_types=SLIDING * 4)
    params = _params(cfg, 0)
    jstacked = jax.tree.map(np.asarray, jpp.stack_pipeline_params(
        jax.tree.map(jnp.asarray, params), 2, num_virtual=virtual))
    tree = params_from_jax(params, device="cpu")
    stacked = pp.stack_pipeline_params(tree, 2, num_virtual=virtual)
    got, want = param_leaves(stacked), jax.tree_util.tree_leaves(jstacked)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    back = pp.unstack_pipeline_params(stacked, 4)
    for a, b in zip(param_leaves(back), param_leaves(tree)):
        assert torch.equal(a, b)


def test_stage_pattern_refuses_chunks_that_differ():
    """gpt-oss's alternating sliding/full layers do not tile one layer a
    chunk: the pipeline refuses, as JAX's ``_stage_pattern`` does; two
    layers a chunk tile."""
    cfg = ModelConfig.tiny(**_cfg(4)[1])
    with pytest.raises(ValueError, match="identical layer_type"):
        pp._stage_pattern(cfg, 4)
    assert pp._stage_pattern(cfg, 2)[0] == 2


@pytest.mark.parametrize("name", [c["name"] for c in LOGIT_CASES])
def test_pipeline_logits_match_jax(runs, name):
    """pipeline_forward's logits on every rank against JAX's
    pipeline_forward in shard_map over as many devices."""
    port, ref = runs
    case = next(c for c in CASES if c["name"] == name)
    for r, res in enumerate(port[case["worlds"][0]]):
        err = float(np.abs(res[name]["logits"] - ref[name]).max())
        assert err < 5e-4, (name, r, err)


@pytest.mark.parametrize("name", [c["name"] for c in STEP_CASES])
def test_pp_step_loss_and_grads_match_jax(runs, name):
    """make_pp_train_step's loss on every rank and its gradient tree
    (gathered over the mesh, unstacked) against the JAX reference."""
    port, ref = runs
    case = next(c for c in CASES if c["name"] == name)
    jloss, jgrads = ref[name]
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jgrads)]
    for r, res in enumerate(port[case["worlds"][0]]):
        got = res[name]
        assert abs(got["loss"] - jloss) < 5e-5, (name, r, got["loss"], jloss)
        leaves = jax.tree_util.tree_leaves(got["grads"])
        assert len(leaves) == len(want)
        for i, (g, w) in enumerate(zip(leaves, want)):
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3,
                                       err_msg=f"{name} rank {r} leaf {i}")
