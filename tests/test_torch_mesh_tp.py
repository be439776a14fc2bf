"""The port's mesh layouts (parallel/mesh.py, param_shardings,
pipeline_param_shardings) and tensor parallelism (parallel/tp.py) against
the JAX package's, on the CPU.

The spec trees are compared leaf by leaf with JAX's ``.spec`` for the same
mesh sizes: ``param_shardings`` with and without ``fsdp_axis`` (and its
fallback where a dimension does not divide), ``pipeline_param_shardings``
with and without ``model_axis``, for the MoE and the dense family. The
Megatron operators ``tp_region_in`` / ``tp_region_out`` and one
``tp_decoder_layer`` (MoE, its grouped expert path, dense) are held to
JAX's in shard_map over the conftest's virtual CPU devices (Pallas in
interpret mode), forward and gradients: the port runs in gloo worlds of 2
and 4 ranks (``_torch_mesh_worker.py``, no JAX), started once for the
module and running beside the JAX side. A sharded gradient is assembled
from the ranks' blocks; a replicated one must be JAX's on every rank.
Tolerance: JAX's own in fp32 (atol 1e-4 forward, 2e-4 / rtol 1e-3 for
gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import _torch_cores  # noqa: F401 (shares the cores among workers)
import _torch_mesh_worker as worker
import sink_attention_tpu.models as jm
from sink_attention_tpu.models import model as jmodel
from sink_attention_tpu.ops import sink_flash_attention as jax_attention
from sink_attention_tpu.parallel import make_mesh
from sink_attention_tpu.parallel import pp as jpp
from sink_attention_tpu.parallel import tp as jtp
from sink_attention_tpu.parallel import train as jtrain


pytestmark = pytest.mark.skipif(
    jax.device_count() < 4, reason="needs 4 devices (virtual CPU mesh)")

# test_parallel.py's FSDP config with 4 experts; qwen2_tiny with heads that
# split 4 ways
MOE = ("tiny", dict(num_heads=8, num_kv_heads=4, head_dim=16, hidden_size=64,
                    num_experts=4, sliding_window=16, vocab_size=128,
                    num_layers=2))
DENSE = ("qwen2_tiny", dict(num_heads=8, num_kv_heads=4))
ODD_VOCAB = ("tiny", dict(vocab_size=130))
MESH = {"data": 2, "seq": 1, "model": 2}


def jcfg(cfg):
    ctor, kw = cfg
    return getattr(jm.ModelConfig, ctor)(**kw)


SPEC_CASES = [
    *(dict(name=f"specs-{fam}-{f}", kind="specs", worlds=[4], cfg=cfg,
           mesh=MESH, pipe=False, fsdp_axis=f)
      for fam, cfg in (("moe", MOE), ("dense", DENSE))
      for f in (None, "data")),
    dict(name="specs-fallback", kind="specs", worlds=[4], cfg=ODD_VOCAB,
         mesh={"data": 4, "seq": 1, "model": 1}, pipe=False,
         fsdp_axis="data"),
    dict(name="specs-tp2", kind="specs", worlds=[2], cfg=MOE,
         mesh={"data": 1, "seq": 1, "model": 2}, pipe=False,
         fsdp_axis="data"),
    *(dict(name=f"pipe-specs-{fam}-{m}", kind="specs", worlds=[4], cfg=cfg,
           mesh={"pipe": 2, "model": 2}, pipe=True, model_axis=m)
      for fam, cfg in (("moe", MOE), ("dense", DENSE))
      for m in (None, "model")),
]


def _inputs():
    rng = np.random.default_rng(15)
    regions = {w: dict(x=rng.standard_normal((4, 8)).astype(np.float32),
                       w=rng.standard_normal((w, 4, 8)).astype(np.float32),
                       xr=rng.standard_normal((w, 4, 8)).astype(np.float32))
               for w in (2, 4)}
    layers = {}
    for name, cfg, B, N, li, seed in (
            ("moe", MOE, 2, 24, 0, 1), ("moe-full", MOE, 2, 24, 1, 2),
            ("moe-grouped", MOE, 1, 4, 0, 3), ("dense", DENSE, 2, 24, 0, 4)):
        c = jcfg(cfg)
        params = jm.init_params(c, jax.random.PRNGKey(seed), jnp.float32)
        layers[name] = dict(
            cfg=cfg, layer_idx=li,
            layer=jax.tree.map(np.asarray, params["layers"][li]),
            x=rng.standard_normal((B, N, c.hidden_size)).astype(np.float32),
            g=rng.standard_normal((B, N, c.hidden_size)).astype(np.float32))
    return regions, layers

REGIONS, LAYERS = _inputs()
LAYER_WORLDS = {"moe": [2, 4], "moe-full": [4], "moe-grouped": [4],
                "dense": [2, 4]}
CASES = SPEC_CASES + [
    *(dict(name=f"regions-{w}", kind="regions", worlds=[w], **REGIONS[w])
      for w in (2, 4)),
    *(dict(name=f"layer-{n}-{w}", kind="tp_layer", worlds=[w], **LAYERS[n])
      for n, ws in LAYER_WORLDS.items() for w in ws),
]


def jax_specs(case):
    cfg = jcfg(case["cfg"])
    sizes = case["mesh"]
    mesh = make_mesh(sizes, devices=jax.devices()[:int(np.prod(
        list(sizes.values())))])
    if case["pipe"]:
        sh = jpp.pipeline_param_shardings(cfg, mesh,
                                          model_axis=case["model_axis"])
    else:
        sh = jtrain.param_shardings(cfg, mesh, fsdp_axis=case["fsdp_axis"])
    return jax.tree.map(lambda s: tuple(s.spec), sh)


def jax_regions(case, world):
    mesh = make_mesh({"model": world}, devices=jax.devices()[:world])

    def island(x, w, xr):
        def f(x, xr):
            return ((jtp.tp_region_in(x, "model") * w[0]).sum()
                    + (jtp.tp_region_out(xr[0], "model") * w[0]).sum())
        gx, gxr = jax.grad(f, argnums=(0, 1))(x, xr)
        return (jtp.tp_region_in(x, "model")[None], gx[None],
                jtp.tp_region_out(xr[0], "model")[None], gxr)

    out = jax.jit(jax.shard_map(
        island, mesh=mesh, in_specs=(P(), P("model"), P("model")),
        out_specs=(P("model"),) * 4, check_vma=False))(
        case["x"], case["w"], case["xr"])
    return [np.asarray(o) for o in out]


def jax_layer(case, world):
    """(out, d layer (assembled), dx) of tp_decoder_layer in shard_map,
    the gradients taken inside the island."""
    cfg = jcfg(case["cfg"])
    mesh = make_mesh({"model": world}, devices=jax.devices()[:world])
    specs = jax.tree.map(lambda s: s.spec,
                         jtrain.param_shardings(cfg, mesh)["layers"][0])
    N = case["x"].shape[1]
    cos, sin = jmodel.rope_cos_sin(cfg, jnp.arange(N))
    local = jtp.tp_local_config(cfg, world)
    window = cfg.window_for_layer(case["layer_idx"], N)

    def island(lp, x, g):
        out, vjp = jax.vjp(lambda lp, x: jtp.tp_decoder_layer(
            lp, local, x, cos, sin, window, jax_attention, "model"), lp, x)
        dlp, dx = vjp(g)
        return out, dlp, dx

    out, dlp, dx = jax.jit(jax.shard_map(
        island, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), specs, P()), check_vma=False))(
        jax.tree.map(jnp.asarray, case["layer"]), case["x"], case["g"])
    return (np.asarray(out), jax.tree.map(np.asarray, dlp), np.asarray(dx),
            specs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started = worker.start_worlds(CASES, str(tmp_path_factory.mktemp(
        "mesh_tp_worlds")))
    ref = {}
    for c in CASES:
        w = c["worlds"][0]
        if c["kind"] == "specs":
            ref[c["name"]] = jax_specs(c)
        elif c["kind"] == "regions":
            ref[c["name"]] = jax_regions(c, w)
        else:
            ref[c["name"]] = jax_layer(c, w)
    return worker.collect_worlds(started), ref


@pytest.mark.parametrize("name", [c["name"] for c in SPEC_CASES])
def test_spec_trees_match_jax(runs, name):
    """Every rank's spec tree equals JAX's ``.spec`` tree, leaf by leaf
    (the layers list and every key included)."""
    port, ref = runs
    case = next(c for c in CASES if c["name"] == name)
    for rank, res in enumerate(port[case["worlds"][0]]):
        assert res[name] == ref[name], (name, rank)


def test_fsdp_specs_shard_the_large_weights_over_data(runs):
    """The JAX FSDP test's own assertions on the port's tree: wq is
    ('data', 'model'), embed ('data', None); where the vocabulary does not
    split, embed stays whole while the lm_head keeps its entries."""
    port, _ = runs
    moe = port[4][0]["specs-moe-data"]
    assert moe["layers"][0]["attn"]["wq"] == ("data", "model")
    assert moe["embed"] == ("data", None)
    odd = port[4][0]["specs-fallback"]
    assert odd["embed"] == (None, None)
    assert odd["lm_head"] == ("data", "model")


@pytest.mark.parametrize("world", [2, 4])
def test_tp_regions_match_jax(runs, world):
    """tp_region_in: identity forward, its gradient the sum of every
    rank's cotangent; tp_region_out: the sum forward, the identity
    backward; per rank, against JAX's custom_vjp pair in shard_map."""
    port, ref = runs
    name = f"regions-{world}"
    j_in, j_gin, j_out, j_gout = ref[name]
    for r, res in enumerate(port[world]):
        got = res[name]
        np.testing.assert_array_equal(got["in"], j_in[r])
        np.testing.assert_allclose(got["in_grad"], j_gin[r], atol=1e-5)
        np.testing.assert_allclose(got["out"], j_out[r], atol=1e-5)
        np.testing.assert_array_equal(got["out_grad"], j_gout[r])


def _assembled(ranks, spec):
    """A gradient leaf whole from the ranks' blocks along its 'model'
    dimension (every rank's, where it is whole)."""
    dims = [d for d, a in enumerate(spec) if a == "model"]
    if not dims:
        return ranks
    return [np.concatenate(ranks, axis=dims[0])]


@pytest.mark.parametrize("name,world", [(n, w) for n, ws in
                                        LAYER_WORLDS.items() for w in ws])
def test_tp_decoder_layer_matches_jax(runs, name, world):
    """tp_decoder_layer's output, the input's gradient and every layer
    parameter's gradient (this rank's shard) against JAX's tp_decoder_layer
    in shard_map: the MoE at a sliding and a full layer, the grouped
    expert path (4 tokens), and the dense family's column/row split."""
    port, ref = runs
    key = f"layer-{name}-{world}"
    j_out, j_grads, j_dx, specs = ref[key]
    ranks = [res[key] for res in port[world]]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["out"], j_out, atol=1e-4, rtol=1e-3,
                                   err_msg=f"out rank {r}")
        np.testing.assert_allclose(got["dx"], j_dx, atol=2e-4, rtol=1e-3,
                                   err_msg=f"dx rank {r}")
    flat_spec = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, P))
    flat_ref = jax.tree_util.tree_leaves(j_grads)
    flat_got = [jax.tree_util.tree_leaves(got["grads"]) for got in ranks]
    assert len(flat_ref) == len(flat_spec) == len(flat_got[0])
    for i, (spec, want) in enumerate(zip(flat_spec, flat_ref)):
        for g in _assembled([f[i] for f in flat_got], tuple(spec)):
            np.testing.assert_allclose(g, want, atol=2e-4, rtol=1e-3,
                                       err_msg=f"leaf {i} spec {spec}")
