"""One rank of a gloo world running the port's sequence-parallel attention
on the CPU (driven by test_torch_sp.py and test_torch_compat.py, not
collected by pytest). Imports torch, numpy and the port only: no JAX.

    python tests/_torch_sp_worker.py RANK WORLD STORE CASES OUT

STORE is the file of the group's ``file://`` rendezvous; CASES a JSON list
of cases, each naming its inputs in ``<CASES>.npz``; OUT the directory
where this rank writes ``rank<RANK>.npz`` (every case's local output and
gradients) and ``rank<RANK>.json`` (what a case records besides tensors).
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sink_attention_tpu_torch import compat, parallel  # noqa: E402
from sink_attention_tpu_torch.parallel import ring  # noqa: E402

FNS = {
    "sp": parallel.sp_sink_flash_attention,
    "ulysses": parallel.ulysses_sink_flash_attention,
    "ring": parallel.ring_sink_flash_attention,
    "sharded": parallel.sharded_sink_flash_attention,
}


def _local(x, rank, world, dim=2):
    return x.chunk(world, dim=dim)[rank].contiguous()


def _recording(events):
    """Wrap the ring module's ppermute_start and chunk op so that each call,
    and each wait of a transfer, appends to ``events``."""
    start, chunk = ring.ppermute_start, ring.sink_flash_attention_chunk

    def rec_start(x, group=None):
        handle = start(x, group)
        events.append("start")
        wait = handle.wait

        def rec_wait():
            out = wait()
            events.append("wait")
            return out
        handle.wait = rec_wait
        return handle

    def rec_chunk(*a, **kw):
        events.append("kernel")
        return chunk(*a, **kw)

    ring.ppermute_start, ring.sink_flash_attention_chunk = rec_start, rec_chunk
    return lambda: (setattr(ring, "ppermute_start", start),
                    setattr(ring, "sink_flash_attention_chunk", chunk))


def run_case(case, inputs, rank, world):
    """(tensors {key: array}, record {key: value}) of one case."""
    name, fn = case["name"], case["fn"]
    get = lambda key: torch.from_numpy(inputs[f"{name}/{key}"])  # noqa: E731
    if fn == "broadcast":
        k = _local(get("k"), rank, world)
        sk, sv = parallel.broadcast_sink_kv(k, k + 0.5, case["num_sink"])
        dk, dv = parallel.reduce_sink_grads(sk * (rank + 1), sv - rank)
        aliases = compat.prepare_sink_kv_for_sp(k, k + 0.5, case["num_sink"])
        assert all(torch.equal(a, b) for a, b in zip(aliases, (sk, sv)))
        assert all(torch.equal(a, b) for a, b in zip(
            compat.reduce_sink_kv_grads(sk * (rank + 1), sv - rank),
            (dk, dv)))
        off = parallel.local_position_offset(k.shape[2])
        assert off == compat.get_local_position_offset(k.shape[2])
        return ({"sink_k": sk, "sink_v": sv, "dk": dk, "dv": dv},
                {"offset": off})
    q, k, v = (_local(get(x), rank, world) for x in "qkv")
    leaves = [q, k, v]
    aux = get("aux") if f"{name}/aux" in inputs else None
    if aux is not None:
        leaves.append(aux)
    for t in leaves:
        t.requires_grad_(True)
    kw = dict(num_sink=case["num_sink"], window_size=case["window"],
              s_aux=aux)
    events, restore = [], None
    if case.get("record"):
        restore = _recording(events)
    try:
        if fn == "ulysses_packed":
            out = parallel.ulysses_sink_flash_attention_packed(
                q, k, v, get("positions"), **kw)
        elif fn == "wrapper":
            out = compat.SinkAttentionSPWrapper(
                case["num_sink"], case["window"])(q, k, v, s_aux=aux)
        else:
            out = FNS[fn](q, k, v, **kw)
        out.backward(_local(get("g"), rank, world))
    finally:
        if restore is not None:
            restore()
    tensors = {"out": out, "dq": q.grad, "dk": k.grad, "dv": v.grad}
    if aux is not None:
        tensors["daux"] = aux.grad
    return tensors, ({"events": events} if events else {})


def start_worlds(cases, inputs, worlds, tmp):
    """Start ``cases`` (dicts with "name", "fn", "worlds", ...) on
    ``inputs`` ({"<name>/<key>": array}) in one gloo world of each size in
    ``worlds``, all at once, each rank a process of its own; the result
    comes from :func:`collect_worlds`."""
    cases_path = os.path.join(tmp, "cases.json")
    with open(cases_path, "w") as f:
        json.dump(cases, f)
    np.savez(os.path.join(tmp, "cases.npz"), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = {}
    for world in worlds:
        out_dir = os.path.join(tmp, f"world{world}")
        os.makedirs(out_dir, exist_ok=True)
        store = os.path.join(out_dir, "store")
        procs[world] = (out_dir, [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             store, cases_path, out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)])
    return procs


def collect_worlds(procs, timeout=300):
    """Wait for :func:`start_worlds`' ranks; returns {world: (per-rank
    {key: array}, per-rank records)}. Raises with the logs of any rank
    that failed."""
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
        arrays, records = [], []
        for r in range(world):
            arrays.append(dict(np.load(os.path.join(out_dir,
                                                    f"rank{r}.npz"))))
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                records.append(json.load(f))
        results[world] = (arrays, records)
    return results


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, cases_path, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    with open(cases_path) as f:
        cases = json.load(f)
    inputs = dict(np.load(cases_path[:-len(".json")] + ".npz"))
    arrays, records = {}, {}
    for case in cases:
        if world not in case["worlds"]:
            continue
        tensors, record = run_case(case, inputs, rank, world)
        for key, t in tensors.items():
            arrays[f"{case['name']}/{key}"] = t.detach().numpy()
        if record:
            records[case["name"]] = record
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(records, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
