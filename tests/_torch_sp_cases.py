"""Shared by test_torch_sp.py and test_torch_ring.py (not collected by
pytest): the sequence-parallel cases, their seeded numpy inputs, the JAX
side of each case in shard_map, and the module fixture's run of both
sides (the port's gloo worlds started first, running while JAX computes).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

import _torch_sp_worker as worker
from sink_attention_tpu import parallel as jpar

WORLDS = (2, 4)
S1024 = (1, 4, 2, 1024, 64)


def case(name, fn, sizes, num_sink, window, jax_world, grads=False,
         aux=True, worlds=WORLDS, atol=1e-4, segs=None, record=False):
    """One case: ``fn`` of the port in gloo worlds ``worlds`` against the
    JAX function in shard_map over ``jax_world`` devices, on inputs of
    ``sizes`` = (B, H_q, H_kv, N, D); ``grads`` adds the gradients of the
    cotangent ``g`` (held at ``atol``), ``segs`` the packed segment
    lengths, ``record`` the ring's call order."""
    return dict(name=name, fn=fn, sizes=list(sizes), num_sink=num_sink,
                window=window, jax_world=jax_world, grads=grads, aux=aux,
                worlds=list(worlds), atol=atol, segs=segs, record=record)


def inputs(c, seed):
    B, H_q, H_kv, N, D = c["sizes"]
    rng = np.random.default_rng(seed)
    arrs = {"q": rng.standard_normal((B, H_q, N, D)),
            "k": rng.standard_normal((B, H_kv, N, D)),
            "v": rng.standard_normal((B, H_kv, N, D)),
            "g": rng.standard_normal((B, H_q, N, D))}
    if c["aux"]:
        arrs["aux"] = rng.standard_normal((H_q,))
    arrs = {k: a.astype(np.float32) for k, a in arrs.items()}
    if c["segs"]:
        arrs["positions"] = np.concatenate(
            [np.arange(n) for n in c["segs"]])[None].astype(np.int64)
    return arrs


JAX_FNS = {"sp": jpar.sp_sink_flash_attention,
           "ulysses": jpar.ulysses_sink_flash_attention,
           "ring": jpar.ring_sink_flash_attention,
           "sharded": jpar.sharded_sink_flash_attention}


def jax_run(c, arrs):
    """(out, [dq, dk, dv, d s_aux or None] or None) of the JAX function in
    shard_map over ``jax_world`` devices (Pallas in interpret mode)."""
    world = c["jax_world"]
    mesh = jpar.make_mesh({"seq": world}, devices=jax.devices()[:world])
    seq = P(None, None, "seq", None)
    kw = dict(num_sink=c["num_sink"], window_size=c["window"],
              axis_name="seq")
    if c["fn"] == "ulysses_packed":
        pos = jnp.asarray(arrs["positions"], jnp.int32)

        def call(q, k, v, aux):
            return jpar.ulysses_sink_flash_attention_packed(
                q, k, v, pos, s_aux=aux, **kw)
    else:
        fn = JAX_FNS[c["fn"]]

        def call(q, k, v, aux):
            return fn(q, k, v, s_aux=aux, **kw)

    args = [jnp.asarray(arrs[x]) for x in "qkv"]
    specs = (seq,) * 3
    if c["aux"]:
        args.append(jnp.asarray(arrs["aux"]))
        specs += (P(),)
        island = call
    else:
        def island(q, k, v):
            return call(q, k, v, None)
    f = jax.shard_map(island, mesh=mesh, in_specs=specs, out_specs=seq,
                      check_vma=False)
    if not c["grads"]:
        return np.asarray(jax.jit(f)(*args)), None

    def both(g, *a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(g)

    out, grads = jax.jit(both)(jnp.asarray(arrs["g"]), *args)
    grads = [np.asarray(x) for x in grads] + [None] * (4 - len(grads))
    return np.asarray(out), grads


def run_both(cases, tmp, extra_cases=(), extra_inputs=None):
    """(inputs by case, the port's {world: (arrays, records)}, JAX's
    {name: (out, grads)}) for ``cases``; ``extra_cases`` run on the port
    side only, over ``extra_inputs``."""
    arrs = {c["name"]: inputs(c, i) for i, c in enumerate(cases)}
    flat = {f"{n}/{k}": a for n, d in arrs.items() for k, a in d.items()}
    flat.update(extra_inputs or {})
    started = worker.start_worlds([*cases, *extra_cases], flat, WORLDS, tmp)
    jax_out = {c["name"]: jax_run(c, arrs[c["name"]]) for c in cases}
    return arrs, worker.collect_worlds(started), jax_out


def params(cases, grads=False):
    """(name, world) of every case (with gradients, if ``grads``) and
    every world it runs in."""
    return [(c["name"], w) for c in cases if c["grads"] or not grads
            for w in c["worlds"]]


def assembled(arrays, key):
    """A rank-local tensor of every rank, concatenated along the
    sequence."""
    return np.concatenate([a[key] for a in arrays], axis=2)


def check_forward(port, jax_out, name, world):
    arrays, _ = port[world]
    np.testing.assert_allclose(assembled(arrays, f"{name}/out"),
                               jax_out[name][0], atol=1e-4, rtol=1e-3)


def check_grads(port, jax_out, c, world):
    """dQ, dK, dV assembled over the ranks, and d s_aux summed over them,
    against jax.vjp of the shard_map'd function."""
    arrays, _ = port[world]
    name = c["name"]
    jq, jk, jv, jaux = jax_out[name][1]
    for key, ref in (("dq", jq), ("dk", jk), ("dv", jv)):
        np.testing.assert_allclose(assembled(arrays, f"{name}/{key}"), ref,
                                   atol=c["atol"], rtol=1e-3, err_msg=key)
    if jaux is not None:
        np.testing.assert_allclose(
            sum(a[f"{name}/daux"] for a in arrays), jaux, atol=c["atol"],
            rtol=1e-3, err_msg="s_aux")
