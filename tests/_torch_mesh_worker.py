"""One rank of a gloo world running the port's mesh, tensor-parallel,
pipeline, sharded-step and sharded-serving cases on the CPU (driven by
test_torch_mesh_tp.py, test_torch_pp.py and test_torch_sharded.py, not
collected by pytest). Imports torch and the port only: no JAX.

    python tests/_torch_mesh_worker.py RANK WORLD STORE CASES OUT

STORE is the file of the group's ``file://`` rendezvous; CASES a pickle
of a list of cases, each a dict with "name", "kind", "worlds" and its
inputs (numpy arrays, parameter trees as nested dicts and lists of
them); OUT the directory where this rank writes ``rank<RANK>.pkl``,
{case name: what its kind returns, as numpy}.
"""

import os
import pickle
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sink_attention_tpu_torch import parallel  # noqa: E402
from sink_attention_tpu_torch.models import (ModelConfig,  # noqa: E402
                                             init_params, params_from_jax,
                                             rope_cos_sin)
from sink_attention_tpu_torch.ops import sink_flash_attention  # noqa: E402
from sink_attention_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from sink_attention_tpu_torch.parallel import pp, tp  # noqa: E402
from sink_attention_tpu_torch.serving import (  # noqa: E402
    make_sharded_generate)


def config(case):
    """The case's ModelConfig: ``case["cfg"]`` = (constructor, kwargs)."""
    ctor, kw = case["cfg"]
    return getattr(ModelConfig, ctor)(**kw)


def numpy_tree(tree):
    return pmesh.tree_map(
        lambda t: None if t is None else t.detach().numpy(), tree)


def specs(shardings):
    return pmesh.tree_map(lambda s: tuple(s.spec), shardings)


def _updates(params, before, lr):
    """(p_before - p_after) / lr of every leaf: SGD's gradient."""
    return pmesh.tree_map(lambda a, b: (b - a.detach()) / lr, params, before)


def _copy(tree):
    return pmesh.tree_map(lambda t: t.detach().clone(), tree)


def run_specs(case, rank, world):
    """The spec trees of param_shardings (with and without fsdp_axis) and
    pipeline_param_shardings (with and without model_axis)."""
    cfg = config(case)
    mesh = pmesh.make_mesh(case["mesh"], device="cpu")
    if case["pipe"]:
        return specs(pp.pipeline_param_shardings(
            cfg, mesh, model_axis=case["model_axis"]))
    return specs(parallel.param_shardings(cfg, mesh,
                                          fsdp_axis=case["fsdp_axis"]))


def run_regions(case, rank, world):
    """tp_region_in and tp_region_out over the world, forward and the
    gradient of sum(y * w[rank])."""
    group = dist.group.WORLD
    w = torch.from_numpy(case["w"][rank])
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y_in = tp.tp_region_in(x, group)
    (y_in * w).sum().backward()
    xr = torch.from_numpy(case["xr"][rank]).requires_grad_(True)
    y_out = tp.tp_region_out(xr, group)
    (y_out * w).sum().backward()
    return {"in": y_in.detach().numpy(), "in_grad": x.grad.numpy(),
            "out": y_out.detach().numpy(), "out_grad": xr.grad.numpy()}


def run_tp_layer(case, rank, world):
    """tp_decoder_layer over a world-wide ``model`` axis: its output, and
    the gradients of sum(out * g) for this rank's layer shard and x."""
    cfg = config(case)
    mesh = pmesh.make_mesh({"model": world}, device="cpu")
    layer_sh = parallel.param_shardings(cfg, mesh)["layers"][0]
    lp = pmesh.device_put(params_from_jax(case["layer"], device="cpu"),
                          layer_sh)
    leaves = parallel.param_leaves(lp)
    for t in leaves:
        t.requires_grad_(True)
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    N = x.shape[1]
    cos, sin = rope_cos_sin(cfg, torch.arange(N))
    out = tp.tp_decoder_layer(lp, tp.tp_local_config(cfg, world), x, cos,
                              sin, cfg.window_for_layer(case["layer_idx"], N),
                              sink_flash_attention, mesh.group("model"))
    grads = torch.autograd.grad((out * torch.from_numpy(case["g"])).sum(),
                                [x] + leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads[1:])
    return {"out": out.detach().numpy(), "dx": grads[0].numpy(),
            "grads": pmesh.tree_map(lambda _: next(it).numpy(),
                                    _sorted(lp))}


def _sorted(tree):
    """``tree`` with dict keys in sorted order (param_leaves' order)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(t) for t in tree]
    return tree


def run_pp_logits(case, rank, world):
    """pipeline_forward over a world-wide ``pipe`` axis."""
    cfg = config(case)
    S = world
    mesh = pmesh.make_mesh({"pipe": S}, device="cpu")
    sh = pp.pipeline_param_shardings(cfg, mesh)
    local = pmesh.device_put(pp.stack_pipeline_params(
        params_from_jax(case["params"], device="cpu"), S), sh)
    with torch.no_grad():
        logits = pp.pipeline_forward(local, cfg, torch.from_numpy(
            case["ids"]).long(), S, case["micro"], group=mesh.group("pipe"))
    return {"logits": logits.numpy()}


def run_pp_step(case, rank, world):
    """One make_pp_train_step with SGD(lr): the loss, and the whole
    gradient tree (gathered over the mesh, unstacked to layers)."""
    cfg = config(case)
    mesh = pmesh.make_mesh(case["mesh"], device="cpu")
    S, V, lr = case["mesh"]["pipe"], case.get("virtual", 1), case["lr"]
    sh = pp.pipeline_param_shardings(
        cfg, mesh, model_axis="model" if case["mesh"].get("model", 1) > 1
        else None)
    local = pmesh.device_put(pp.stack_pipeline_params(
        params_from_jax(case["params"], device="cpu"), S, num_virtual=V), sh)
    before = _copy(local)
    opt = torch.optim.SGD(parallel.param_leaves(local), lr=lr)
    step, _ = pp.make_pp_train_step(cfg, mesh, opt,
                                    num_microbatches=case["micro"],
                                    num_virtual=V,
                                    remat=case.get("remat", False))
    loss = step(local, torch.from_numpy(case["batch"]).long())
    grads = pmesh.gather_tree(_updates(local, before, lr), sh)
    return {"loss": float(loss),
            "grads": numpy_tree(pp.unstack_pipeline_params(
                grads, cfg.num_layers))}


def run_train_step(case, rank, world):
    """One mesh make_train_step with SGD(lr): the loss and the whole
    gradient tree (gathered); with "adamw", the bytes of an AdamW state
    built over the local blocks after one step, against the whole tree's."""
    cfg = config(case)
    mesh = pmesh.make_mesh(case["mesh"], device="cpu")
    sh = parallel.param_shardings(cfg, mesh, fsdp_axis="data"
                                  if case["fsdp"] else None)
    whole = params_from_jax(case["params"], device="cpu")
    local = pmesh.device_put(whole, sh)
    before, lr = _copy(local), case["lr"]
    opt = torch.optim.SGD(parallel.param_leaves(local), lr=lr)
    step, _ = parallel.make_train_step(
        cfg, mesh, opt, fsdp=case["fsdp"], remat=case.get("remat", False),
        accum_steps=case.get("accum", 1))
    batch = torch.from_numpy(case["batch"]).long()
    loss = step(local, batch)
    out = {"loss": float(loss),
           "grads": numpy_tree(pmesh.gather_tree(
               _updates(local, before, lr), sh)),
           "specs": specs(sh)}
    if case.get("adamw"):
        adam = torch.optim.AdamW(parallel.param_leaves(local), lr=1e-3)
        adam_step, _ = parallel.make_train_step(cfg, mesh, adam,
                                                fsdp=case["fsdp"])
        adam_step(local, batch)
        state = sum(t.numel() for s in adam.state.values()
                    for t in s.values() if t.dim() > 0)
        wq = adam.state[local["layers"][0]["attn"]["wq"]]["exp_avg"]
        out.update(adam_state=state, adam_wq=tuple(wq.shape),
                   whole=2 * sum(t.numel() for t in
                                 parallel.param_leaves(whole)))
    return out


def run_generate(case, rank, world):
    """make_sharded_generate over a world-wide ``model`` axis, fp32."""
    cfg = config(case)
    mesh = pmesh.make_mesh({"model": world}, device="cpu")
    sh, gen = make_sharded_generate(cfg, mesh, dtype=torch.float32,
                                    quant=case.get("quant"))
    local = pmesh.device_put(params_from_jax(case["params"], device="cpu"),
                             sh)
    ids = torch.from_numpy(case["ids"]).long()
    return {"tokens": [gen(local, ids, case["steps"]).numpy()
                       for _ in range(case.get("repeat", 1))]}


def run_multihost(case, rank, world):
    """make_multihost_mesh as nodes of ``per_node`` ranks: its rank
    array, this rank's model and data groups, a sum over every axis, and
    one sharded SGD step's loss."""
    cfg = config(case)
    os.environ["LOCAL_WORLD_SIZE"] = str(case["per_node"])  # as torchrun
    mesh = pmesh.make_multihost_mesh(case["mesh"], dcn_axes=("data",),
                                     device="cpu")
    x = torch.tensor([float(rank)])
    for axis in mesh.axis_names:
        x = parallel._collectives.all_reduce(x, mesh.group(axis))
    sh = parallel.param_shardings(cfg, mesh)
    local = pmesh.device_put(params_from_jax(case["params"], device="cpu"),
                             sh)
    step, _ = parallel.make_train_step(
        cfg, mesh, torch.optim.SGD(parallel.param_leaves(local), lr=1e-2))
    loss = step(local, torch.from_numpy(case["batch"]).long())
    return {"ranks": mesh.ranks, "sum": float(x),
            "model_group": dist.get_process_group_ranks(mesh.group("model")),
            "data_group": dist.get_process_group_ranks(mesh.group("data")),
            "loss": float(loss)}


def run_init(case, rank, world):
    """init_params(shardings=) against device_put of the whole tree drawn
    from the same seed: bit for bit, leaf by leaf."""
    cfg = config(case)
    mesh = pmesh.make_mesh(case["mesh"], device="cpu")
    sh = parallel.param_shardings(cfg, mesh, fsdp_axis=case["fsdp_axis"])
    got = init_params(cfg, torch.Generator().manual_seed(case["seed"]),
                      device="cpu", shardings=sh)
    want = pmesh.device_put(init_params(
        cfg, torch.Generator().manual_seed(case["seed"]), device="cpu"), sh)
    a, b = parallel.param_leaves(got), parallel.param_leaves(want)
    return {"equal": len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b)),
        "leaves": len(a)}


KINDS = {"specs": run_specs, "regions": run_regions,
         "tp_layer": run_tp_layer, "pp_logits": run_pp_logits,
         "pp_step": run_pp_step, "train_step": run_train_step,
         "generate": run_generate, "multihost": run_multihost,
         "init": run_init}


def start_worlds(cases, tmp):
    """Start every case in one gloo world of each size its ``worlds``
    name, all worlds at once, each rank a process of its own; the result
    comes from :func:`collect_worlds`."""
    cases_path = os.path.join(tmp, "cases.pkl")
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = {}
    for world in sorted({w for c in cases for w in c["worlds"]}):
        out_dir = os.path.join(tmp, f"world{world}")
        os.makedirs(out_dir, exist_ok=True)
        store = os.path.join(out_dir, "store")
        procs[world] = (out_dir, [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             store, cases_path, out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)])
    return procs


def collect_worlds(procs, timeout=600):
    """Wait for :func:`start_worlds`' ranks; returns {world: [each rank's
    {case name: result}]}. Raises with the logs of any rank that failed."""
    failed = []
    for world, (_, ps) in procs.items():
        for r, proc in enumerate(ps):
            try:
                log, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"world {world} rank {r} (rc "
                              f"{proc.returncode}):\n{log[-3000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    results = {}
    for world, (out_dir, _) in procs.items():
        results[world] = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results[world].append(pickle.load(f))
    return results


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, cases_path, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    results = {}
    for case in cases:
        if world in case["worlds"]:
            results[case["name"]] = KINDS[case["kind"]](case, rank, world)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
