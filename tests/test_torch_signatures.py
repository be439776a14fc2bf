"""The three public signatures that were narrower than the JAX package's,
each held to JAX on the CPU: ``cache.quantize(axis=)``,
``serving.decode_loop(attn_impl=)`` and ``parallel.make_sharded_attn(
data_axis=, model_axis=)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh as JMesh

import _torch_cores  # noqa: F401 (shares the cores among workers)
import sink_attention_tpu.models as jm
from sink_attention_tpu.cache import quantize as j_quantize
from sink_attention_tpu.parallel.train import (
    make_sharded_attn as j_sharded_attn)
from sink_attention_tpu.serving import decode_loop as j_decode_loop
from sink_attention_tpu_torch.cache import quantize as t_quantize
from sink_attention_tpu_torch.models import ModelConfig, params_from_jax
from sink_attention_tpu_torch.models import model as tmodel
from sink_attention_tpu_torch.parallel import make_mesh
from sink_attention_tpu_torch.parallel import make_sharded_attn
from sink_attention_tpu_torch.serving import decode_loop as t_decode_loop


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantize_axis_matches_jax(quant):
    """``axis`` as JAX takes it: the last axis by -1 or by its index give
    JAX's codes and scales bit for bit; so does -2 on a square last pair,
    where JAX's broadcast of the scale is well formed."""
    x = np.random.RandomState(0).randn(2, 3, 16, 16).astype(np.float32)
    for axis in (-1, 3, -2):
        jc, js = j_quantize(jnp.asarray(x), quant, axis=axis)
        tc, ts = t_quantize(torch.from_numpy(x), quant, axis=axis)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_decode_loop_attn_impl_matches_jax():
    """``decode_loop(attn_impl=)`` reaches every layer's decode attention
    as in JAX: with the same stand-in attention (the query itself) both
    loops give the same tokens, and the port's calls it once per layer and
    step."""
    jcfg = jm.ModelConfig.tiny()
    tcfg = ModelConfig.tiny()
    jp = jm.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    B, steps, start = 2, 5, 0
    first = np.array([7, 11])
    jc = jm.make_caches(jcfg, B, max_len=steps + 1, dtype=jnp.float32)
    tc = tmodel.make_caches(tcfg, B, max_len=steps + 1,
                            dtype=torch.float32, device="cpu")
    calls = []

    def t_attn(q, cache, s_aux=None):
        calls.append(q.shape)
        return q

    jt, _ = j_decode_loop(jp, jcfg, jnp.asarray(first, jnp.int32), jc,
                          start, steps,
                          attn_impl=lambda q, cache, s_aux=None: q)
    tt, _ = t_decode_loop(tp, tcfg, torch.from_numpy(first), tc, start,
                          steps, attn_impl=t_attn)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert len(calls) == steps * tcfg.num_layers


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_make_sharded_attn_axes_match_jax(world_of_one):
    """``make_sharded_attn(mesh, data_axis, seq_axis, model_axis)`` over a
    one-rank mesh of the three axes against JAX's over a one-device mesh
    (its Pallas kernel in interpret mode) at 1e-5; an axis name the mesh
    does not know raises."""
    rs = np.random.RandomState(4)
    q = rs.randn(1, 4, 128, 16).astype(np.float32)
    k, v = (rs.randn(1, 2, 128, 16).astype(np.float32) for _ in range(2))
    aux = rs.randn(4).astype(np.float32)
    axes = ("dp", "sp", "tp")
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), axes)
    jattn = j_sharded_attn(jmesh, *axes, interpret=True)
    want = jattn(*(jnp.asarray(t) for t in (q, k, v)), num_sink=4,
                 window_size=32, s_aux=jnp.asarray(aux))
    mesh = make_mesh(dict(zip(axes, (1, 1, 1))), device="cpu")
    attn = make_sharded_attn(mesh, *axes)
    got = attn(*(torch.from_numpy(t) for t in (q, k, v)), num_sink=4,
               window_size=32, s_aux=torch.from_numpy(aux))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for kw in ({"data_axis": "batch"}, {"model_axis": "heads"},
               {"seq_axis": "sequence"}):
        with pytest.raises(ValueError, match="not an axis of the mesh"):
            make_sharded_attn(mesh, **kw)
