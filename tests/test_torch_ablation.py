"""The port's prefill ablation against the JAX script's.

``scripts/mfu_ablation.py`` is loaded as it stands, with its module globals
(tile sizes, sinks, window) set by monkeypatch: at the production
forward's 128 x 128 tiles (the port's ``FWD_BM x ablation.BN``, at which its
stages run) its Pallas kernels, run in interpret mode on the CPU, visit the
KV blocks that the port's range table lists, so the stripped stages (which
sum over whole visited tiles) compare like with like.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
from sink_attention_tpu.ops import flash as jflash
from sink_attention_tpu.ops import sink_flash_attention as j_sink_flash
from sink_attention_tpu_torch.ops import ablation, flash
from sink_attention_tpu_torch.scripts import mfu_ablation

ROOT = Path(__file__).resolve().parents[1]
B, H_Q, H_KV, N, D = 1, 4, 2, 256, 64
GEOMS = [(4, 128), (0, 128)]   # (num_sink, window)
CORRECT = ("general", "maskadd", "masksel")
TILE = flash.FWD_BM  # the stages' tiles, FWD_BM = ablation.BN


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_mfu_ablation", ROOT / "scripts" / "mfu_ablation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, exact=False):
    """q, k, v [B, H, N, D] fp32. With ``exact`` each key row has one
    nonzero entry, +-1 or +-2, so every score is exact in fp32 whatever the
    order of the dot product's sum: ``bf16exp`` rounds s - m to bf16, which
    turns a last-bit difference of two summation orders into a whole bf16
    step of its exponent."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H_Q, N, D).astype(np.float32)
    k = rs.randn(B, H_KV, N, D).astype(np.float32)
    v = rs.randn(B, H_KV, N, D).astype(np.float32)
    if exact:
        q *= 4.0
        k = np.zeros_like(k)
        hot = rs.randint(0, D, size=(B, H_KV, N))
        np.put_along_axis(k, hot[..., None],
                          rs.choice([-2.0, -1.0, 1.0, 2.0],
                                    size=(B, H_KV, N, 1)), axis=-1)
    return q, k, v


@pytest.fixture(scope="module")
def jax_runs(jax_script):
    """One JAX run per (dtype, geometry, stage), shared by the tests;
    ``get(dtype, ns, w, stage, stages)`` runs every stage of ``stages``
    (all by default) at the (dtype, geometry) on first use, in one
    ``jax.jit`` (one compile instead of eleven)."""
    cache = {}

    def get(dtype, ns, w, stage, stages=ablation.STAGES):
        key = (dtype, ns, w, stages)
        if key not in cache:
            q, k, v = (jnp.asarray(x).astype(dtype)
                       for x in _inputs(0, dtype == jnp.float32))
            with pytest.MonkeyPatch.context() as mp:
                for name, val in (("BM", TILE), ("BN", TILE), ("NS", ns),
                                  ("W", w)):
                    mp.setattr(jax_script, name, val)
                fns = []
                for st in stages:
                    fn, ops = jax_script.run_ablation(q, k, v, st)
                    fns.append(fn)
                outs = jax.jit(lambda *a: [fn(*a) for fn in fns])(*ops)
            cache[key] = {
                st: np.asarray(out.astype(jnp.float32)).reshape(
                    B, H_Q, -1, out.shape[-1])[:, :, :N, :D]
                for st, out in zip(stages, outs)}
        return cache[key][stage]

    return get


def _port(dtype, ns, w, stage, exact=None):
    exact = dtype == torch.float32 if exact is None else exact
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _inputs(0, exact))
    return ablation.ablation_attention(q, k, v, stage, ns, w).float().numpy()


def _assert_close(got, ref, rel):
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    scale = max(1.0, float(np.abs(ref[~nan]).max()))
    err = float(np.abs(got[~nan] - ref[~nan]).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("stage", ablation.STAGES)
def test_stage_matches_jax_fp32(jax_runs, stage, geom):
    ns, w = geom
    ref = jax_runs(jnp.float32, ns, w, stage)
    _assert_close(_port(torch.float32, ns, w, stage), ref, 1e-5)
    if stage == "general" and ns == 0:
        # a row whose first visited tile is wholly masked: exp2(-inf - -inf);
        # at 128-key tiles row 255 of each of the 4 heads (its window,
        # keys 128-255, misses block 0)
        assert np.isnan(ref).any(axis=-1).sum() == 4


@pytest.mark.parametrize("stage", ablation.STAGES)
def test_stage_matches_jax_bf16(jax_runs, stage):
    """bf16 inputs: catches the scale constant's rounding to bf16."""
    ref = jax_runs(jnp.bfloat16, 4, 128, stage)
    got = _port(torch.bfloat16, 4, 128, stage)
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    err = float(np.abs(got[~nan] - ref[~nan]).max())
    assert err <= 2e-2 * float(np.abs(ref[~nan]).max())


@pytest.mark.parametrize("geom", [
    # (n, num_sink, window): the test shapes, the headline, gpt-oss-20b
    (256, 4, 128), (256, 0, 128), (8192, 4, 4096), (1024, 0, 128),
    (1024, 0, 1024)])
def test_visited_blocks_match_jax_schedule(geom):
    """Per (q block, step), the blocks the JAX kernel marks valid at 128 x
    128 tiles, in order, are those of the port's range table."""
    n, ns, w = geom
    nb = n // TILE
    nsb, steps = jflash._step_counts(ns, w, TILE, TILE, nb, False)
    step_fn = jax.jit(functools.partial(
        jflash._fwd_kv_step, q_off=0, kv_off=0, bm=TILE, bn=TILE, nsb=nsb,
        num_sink=ns, window=w, n_q=n, n_kv_blocks=nb))
    block, valid = (np.asarray(x) for x in step_fn(
        jnp.arange(nb)[:, None], jnp.arange(steps)[None, :]))
    blocks, ok = ablation.visited_blocks(n, ns, w)
    assert blocks.shape[1] == nb
    for i in range(nb):
        assert list(block[i][valid[i]]) == blocks[:, i][ok[:, i]].tolist()


@pytest.fixture(scope="module")
def jax_attention():
    """JAX sink_flash_attention without s_aux, per geometry."""
    cache = {}

    def get(ns, w):
        if (ns, w) not in cache:
            q, k, v = (jnp.asarray(x) for x in _inputs(0))
            fn = functools.partial(j_sink_flash, num_sink=ns, window_size=w)
            cache[ns, w] = np.asarray(jax.jit(fn)(q, k, v))
        return cache[ns, w]

    return get


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("stage", CORRECT)
def test_correct_stages_match_jax_attention(jax_attention, stage, geom):
    """The three correct stages against JAX sink_flash_attention without
    s_aux (general on its finite rows)."""
    ns, w = geom
    ref = jax_attention(ns, w)
    got = _port(torch.float32, ns, w, stage, exact=False)
    fin = ~np.isnan(got)
    assert fin.any(axis=-1).all() if stage != "general" else fin.any()
    np.testing.assert_allclose(got[fin], ref[fin], atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize("stage", ablation.MASK_STAGES)
def test_mask_stages_at_a_window_off_the_tile(jax_runs, jax_attention, stage):
    """W = 192, not a multiple of the 128-key tile: no tile is a
    window-start tile, those tiles fall to the general mask (in the JAX
    kernel and in the port alike); the mask stages match the JAX script's
    and JAX sink_flash_attention."""
    ref = jax_runs(jnp.float32, 4, 192, stage, ablation.MASK_STAGES)
    _assert_close(_port(torch.float32, 4, 192, stage), ref, 1e-5)
    got = _port(torch.float32, 4, 192, stage, exact=False)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, jax_attention(4, 192), atol=2e-5,
                               rtol=1e-3)


def test_entry_point_comparison_on_cpu():
    """The entry point's comparison with the production forward, on CPU
    tensors: the mask stages pass, a stripped stage is far off."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(1))
    for stage in ablation.MASK_STAGES:
        assert mfu_ablation.production_error(q, k, v, stage, 4, 128) < \
            mfu_ablation.MASK_TOL
    assert mfu_ablation.production_error(q, k, v, "sum", 4, 128) > \
        mfu_ablation.MASK_TOL
    ref = flash.sink_flash_attention(q, k, v, 4, 128)
    out = mfu_ablation.run_ablation(q, k, v, "masksel", 4, 128)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
