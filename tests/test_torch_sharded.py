"""The port's tensor-sharded serving (serving/sharded.py), its mesh
training step (parallel/train.py with a mesh: DP x SP x TP, FSDP),
``make_multihost_mesh`` and the sharded draw of ``init_params`` against
the JAX package, on the CPU.

The JAX side runs its own entry points over the conftest's virtual CPU
devices (Pallas in interpret mode): ``make_sharded_generate`` at TP 2 and
4, with an int8 KV cache, and for the dense family
(tests/test_sharded_serving.py's configs), and ``make_train_step`` on the
FSDP test's (data, seq, model) = (2, 2, 2) mesh and the remat test's
(2, 1, 2) mesh (tests/test_parallel.py:463-545), with SGD. The port runs
in gloo worlds of 2 and 4 ranks (``_torch_mesh_worker.py``, no JAX),
started once for the module: the 8-device mesh as worlds of 4 with one
axis at 1 ((2, 1, 2) with FSDP and an AdamW state, (1, 2, 2), (2, 2, 1)
with FSDP) and of 2; the remat mesh with remat and 4 accumulation steps.
Tolerances: JAX's own (tokens equal in fp32; loss rtol 1e-4; gradients,
the SGD update over lr, atol 2e-4 / rtol 1e-3).

``make_multihost_mesh`` runs as 2 nodes of 2 ranks (the JAX test's
2 processes x 2 devices): the model axis stays inside a node whatever the
axis order, and one sharded step over it gives JAX's loss. The sharded
draw of ``init_params`` (chip_smoke's phase 12 draws gpt-oss-20b so) is
held bit for bit to slicing the whole tree.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import _torch_cores  # noqa: F401 (shares the cores among workers)
import _torch_mesh_worker as worker
import sink_attention_tpu.models as jm
from sink_attention_tpu.parallel import make_mesh
from sink_attention_tpu.parallel import train as jtrain
from sink_attention_tpu.serving import make_sharded_generate

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 devices (virtual CPU mesh)")

SERVE = ("tiny", dict(num_heads=8, num_kv_heads=4, num_layers=2,
                      vocab_size=128))
DENSE = ("qwen2_tiny", dict(num_heads=8, num_kv_heads=4))
FSDP = ("tiny", dict(num_heads=8, num_kv_heads=4, head_dim=16,
                     hidden_size=64, num_experts=2, sliding_window=16,
                     vocab_size=128, num_layers=2))
REMAT = ("tiny", dict(num_heads=4, num_kv_heads=2, head_dim=16,
                      hidden_size=32, num_experts=2, sliding_window=16,
                      vocab_size=64, num_layers=2))
HOST = ("tiny", dict(num_layers=2, vocab_size=64))


def jcfg(cfg):
    ctor, kw = cfg
    return getattr(jm.ModelConfig, ctor)(**kw)


def _params(cfg, seed):
    return jax.tree.map(np.asarray, jm.init_params(
        jcfg(cfg), jax.random.PRNGKey(seed), jnp.float32))


def _ids(seed, shape, vocab):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                         vocab))


def _gen(name, cfg, tp, seed, steps=6, quant=None):
    return dict(name=name, kind="generate", worlds=[tp], cfg=cfg,
                params=_params(cfg, seed), ids=_ids(seed + 1, (2, 8), 128
                                                    if cfg is SERVE else 256),
                steps=steps, quant=quant, repeat=2 if quant else 1)


def _step(name, cfg, mesh, ref, **kw):
    world = int(np.prod(list(mesh.values())))
    return dict(name=name, kind="train_step", worlds=[world], cfg=cfg,
                mesh=mesh, ref=ref, lr=1e-2, **kw)


GEN_CASES = [_gen("tp2", SERVE, 2, 0), _gen("tp4", SERVE, 4, 0),
             _gen("int8-tp2", SERVE, 2, 0, steps=4, quant="int8"),
             _gen("dense-tp4", DENSE, 4, 3)]
STEP_REFS = {
    "fsdp": dict(cfg=FSDP, params=_params(FSDP, 0),
                 batch=_ids(1, (4, 33), 128),
                 mesh={"data": 2, "seq": 2, "model": 2}, fsdp=True),
    "remat": dict(cfg=REMAT, params=_params(REMAT, 0),
                  batch=_ids(1, (8, 17), 64),
                  mesh={"data": 2, "seq": 1, "model": 2}, fsdp=False)}


def _ref_inputs(ref):
    r = STEP_REFS[ref]
    return dict(params=r["params"], batch=r["batch"])


STEP_CASES = [
    _step("fsdp-dp2-tp2", FSDP, {"data": 2, "seq": 1, "model": 2}, "fsdp",
          fsdp=True, adamw=True, **_ref_inputs("fsdp")),
    _step("sp2-tp2", FSDP, {"data": 1, "seq": 2, "model": 2}, "fsdp",
          fsdp=False, **_ref_inputs("fsdp")),
    _step("fsdp-dp2-sp2", FSDP, {"data": 2, "seq": 2, "model": 1}, "fsdp",
          fsdp=True, adamw=True, **_ref_inputs("fsdp")),
    _step("fsdp-dp2", FSDP, {"data": 2, "seq": 1, "model": 1}, "fsdp",
          fsdp=True, **_ref_inputs("fsdp")),
    _step("remat-accum-dp2-tp2", REMAT, {"data": 2, "seq": 1, "model": 2},
          "remat", fsdp=False, remat=True, accum=4, **_ref_inputs("remat")),
    _step("remat-tp2", REMAT, {"data": 1, "seq": 1, "model": 2}, "remat",
          fsdp=False, remat=True, **_ref_inputs("remat")),
]
HOST_BATCH = np.tile(np.arange(32) % 64, (4, 1))
HOST_CASES = [dict(name=f"multihost-{order}", kind="multihost", worlds=[4],
                   cfg=HOST, mesh=mesh, per_node=2, params=_params(HOST, 0),
                   batch=HOST_BATCH)
              for order, mesh in (
                  ("data-first", {"data": 2, "seq": 1, "model": 2}),
                  ("model-first", {"model": 2, "seq": 1, "data": 2}))]
INIT_CASES = [dict(name=f"init-{n}", kind="init", worlds=[w], cfg=cfg,
                   mesh=mesh, fsdp_axis=f, seed=5)
              for n, w, cfg, mesh, f in (
                  ("tp2", 2, SERVE, {"model": 2}, None),
                  ("fsdp-dp2-tp2", 4, FSDP,
                   {"data": 2, "seq": 1, "model": 2}, "data"),
                  ("dense-tp4", 4, DENSE, {"model": 4}, None))]
CASES = GEN_CASES + STEP_CASES + HOST_CASES + INIT_CASES


def jax_generate(case):
    cfg, tp = jcfg(case["cfg"]), case["worlds"][0]
    mesh = make_mesh({"model": tp}, devices=jax.devices()[:tp])
    p_sh, gen = make_sharded_generate(cfg, mesh, dtype=jnp.float32,
                                      quant=case["quant"])
    params = jax.device_put(jax.tree.map(jnp.asarray, case["params"]), p_sh)
    return np.asarray(gen(params, jnp.asarray(case["ids"]), case["steps"]))


def jax_step(ref):
    """(loss, gradient tree) of JAX's make_train_step with SGD(1e-2) on
    the reference's mesh: the gradient is the update over lr."""
    r = STEP_REFS[ref]
    cfg = jcfg(r["cfg"])
    sizes = tuple(r["mesh"].values())
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes),
                tuple(r["mesh"]))
    opt = optax.sgd(1e-2)
    step, p_sh = jtrain.make_train_step(cfg, mesh, opt, fsdp=r["fsdp"])
    with mesh:
        p0 = jax.device_put(jax.tree.map(jnp.asarray, r["params"]), p_sh)
        p1, _, loss = step(p0, opt.init(p0), jnp.asarray(r["batch"]))
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / 1e-2,
                         jax.device_get(p0), jax.device_get(p1))
    return float(loss), grads


def jax_host_loss():
    cfg = jcfg(HOST)
    return float(jtrain.cross_entropy_loss(
        jax.tree.map(jnp.asarray, _params(HOST, 0)), cfg,
        jnp.asarray(HOST_BATCH)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started = worker.start_worlds(CASES, str(tmp_path_factory.mktemp(
        "sharded_worlds")))
    jobs = {c["name"]: (jax_generate, c) for c in GEN_CASES}
    jobs.update({ref: (jax_step, ref) for ref in STEP_REFS})
    jobs["host"] = (lambda _: jax_host_loss(), None)
    # the JAX cases compile in parallel threads (XLA releases the GIL)
    with ThreadPoolExecutor(4) as pool:
        ref = dict(zip(jobs, pool.map(lambda j: j[0](j[1]), jobs.values())))
    return worker.collect_worlds(started), ref


@pytest.mark.parametrize("name", [c["name"] for c in GEN_CASES])
def test_sharded_generate_matches_jax(runs, name):
    """Every rank's tokens equal JAX's make_sharded_generate's (fp32), at
    TP 2 and 4, with an int8 KV cache (twice: the same tokens), and for
    the dense family."""
    port, ref = runs
    case = next(c for c in GEN_CASES if c["name"] == name)
    for r, res in enumerate(port[case["worlds"][0]]):
        for toks in res[name]["tokens"]:
            np.testing.assert_array_equal(toks, ref[name],
                                          err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("name", [c["name"] for c in STEP_CASES])
def test_mesh_train_step_matches_jax(runs, name):
    """make_train_step over a mesh: every rank's loss and the gradient
    tree it applied (the SGD update over lr, gathered over the mesh)
    against JAX's sharded step."""
    port, ref = runs
    case = next(c for c in STEP_CASES if c["name"] == name)
    jloss, jgrads = ref[case["ref"]]
    want = jax.tree_util.tree_leaves(jgrads)
    for r, res in enumerate(port[case["worlds"][0]]):
        got = res[name]
        np.testing.assert_allclose(got["loss"], jloss, rtol=1e-4,
                                   err_msg=f"{name} rank {r}")
        leaves = jax.tree_util.tree_leaves(got["grads"])
        assert len(leaves) == len(want)
        for i, (g, w) in enumerate(zip(leaves, want)):
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3,
                                       err_msg=f"{name} rank {r} leaf {i}")


@pytest.mark.parametrize("name", ["fsdp-dp2-tp2", "fsdp-dp2-sp2"])
def test_fsdp_optimizer_state_is_sharded(runs, name):
    """An AdamW built over the local blocks holds each leaf's block: its
    state is the whole tree's two moments divided, leaf by leaf, by the
    sizes of the axes the leaf is split over (1/dp for the FSDP leaves);
    wq's moment is [H/dp, H_q D/tp] (JAX's test: mu inherits the FSDP
    layout)."""
    port, _ = runs
    case = next(c for c in STEP_CASES if c["name"] == name)
    cfg = jcfg(case["cfg"])
    shapes = [a.shape for a in jax.tree_util.tree_leaves(case["params"])]
    sizes = case["mesh"]
    for res in port[4]:
        got = res[name]
        specs = jax.tree_util.tree_leaves(
            got["specs"], is_leaf=lambda s: isinstance(s, tuple))
        want = 2 * sum(int(np.prod(s)) // int(np.prod(
            [sizes[a] for a in spec if a is not None] or [1]))
            for s, spec in zip(shapes, specs))
        assert got["adam_state"] == want
        H = cfg.hidden_size
        assert got["adam_wq"] == (H // sizes["data"], cfg.num_heads *
                                  cfg.head_dim // sizes["model"])


@pytest.mark.parametrize("name", [c["name"] for c in HOST_CASES])
def test_multihost_mesh_keeps_model_inside_a_node(runs, name):
    """make_multihost_mesh over 2 nodes of 2 ranks: 'data' across the
    nodes, 'model' inside one whatever the axis order; a sum over every
    axis reaches every rank (0+1+2+3); one sharded SGD step's loss is
    JAX's on the same weights and batch."""
    port, ref = runs
    for r, res in enumerate(port[4]):
        got = res[name]
        assert len({g // 2 for g in got["model_group"]}) == 1, got
        assert len({g // 2 for g in got["data_group"]}) == 2, got
        assert r in got["model_group"] and r in got["data_group"]
        assert got["sum"] == pytest.approx(6.0)
        np.testing.assert_allclose(got["loss"], ref["host"], rtol=1e-5)
    ranks = port[4][0][name]["ranks"]
    assert sorted(ranks.reshape(-1).tolist()) == [0, 1, 2, 3]


@pytest.mark.parametrize("name", [c["name"] for c in INIT_CASES])
def test_sharded_init_is_the_whole_trees_blocks(runs, name):
    """init_params(shardings=) keeps, leaf by leaf and bit for bit, this
    rank's block of the tree init_params draws whole from the same
    seed."""
    port, _ = runs
    case = next(c for c in INIT_CASES if c["name"] == name)
    for res in port[case["worlds"][0]]:
        assert res[name]["equal"] and res[name]["leaves"] > 10


def test_chip_smoke_mesh_phase_on_cpu():
    """chip_smoke's phase 12 rehearsed on the CPU at tiny widths (8/4
    heads; serving 2 layers, 2 x 32 prompt tokens, 4 new; training 4
    layers, 2 x 64 tokens; fp32), through the kernels' plain versions: its
    gates pass, no kernel is launched, every task runs on every rank, and
    the sharded runs equal the unsharded ones (tokens; logits, per-token
    losses, the mean loss and the named gradients within fp32 rounding,
    by cosine and by relative error), and 12a checks every layer's
    prefill and every decode step's decode, kernel against plain."""
    import torch

    import chip_smoke
    from sink_attention_tpu_torch.models import ModelConfig

    report, launches, errors = chip_smoke.mesh_phase(
        "cpu", serve_cfg=ModelConfig.tiny(num_heads=8, num_kv_heads=4),
        train_cfg=ModelConfig.tiny(num_heads=8, num_kv_heads=4,
                                   num_layers=4),
        batch=2, prompt_len=32, new_tokens=4, train_rows=2, seq_len=64,
        dtype=torch.float32)
    assert errors == []
    assert set(launches.values()) == {0}
    rows = [row for w in report["worlds"] for rank in w["ranks"]
            for row in rank]
    tasks = {}
    for row in rows:
        tasks.setdefault(row["task"], set()).add(row["rank"])
        assert row["finite"]
        if "tokens_equal" in row:
            assert row["tokens_equal"], row["task"]
        if "all_cos" in row:
            assert row["all_cos"] > 1 - 1e-6
        for name, d in row.get("vs_single", {}).items():
            assert abs(d) < 1e-6, (row["task"], name, d)
        for name, r in row.get("rel_vs_single", {}).items():
            assert r < 1e-4, (row["task"], name, r)
        if "loss" in row:
            assert row["loss_rel_vs_single"] < 1e-5, row["task"]
        if row["task"].startswith("12a"):
            assert (row["prefill_layers_checked"],
                    row["decode_layers_checked"]) == (2, 2 * 3)
            assert len(row["decode_ms_steps"]) == 3
    assert tasks == {
        "12a serve tp4": {0, 1, 2, 3},
        "12a serve tp2": {0, 1}, "12a serve tp2 int8 KV": {0, 1},
        "12b train fsdp dp2 x tp2": {0, 1, 2, 3},
        "12b train sp2 x tp2": {0, 1, 2, 3},
        "12c pipeline pipe2 x tp2": {0, 1, 2, 3}}
    fsdp = [r for r in rows if r["task"] == "12b train fsdp dp2 x tp2"]
    assert all(0.5 < r["param_bytes_vs_tp_blocks"] < 0.52 for r in fsdp)
