"""The sharded training step (DP x Ulysses-SP x TP/EP) on a device mesh.

    python3 -m sink_attention_tpu_torch.examples.train    # a world of 1
    torchrun --nproc_per_node 4 -m sink_attention_tpu_torch.examples.train

One process per rank over ``torch.distributed``: under ``torchrun`` the
world comes from its environment, else this process is a world of 1. The
mesh is ('data', 'seq', 'model') = (world / tp, 1, tp), tp 2 for an even
world; ``ModelConfig.tiny`` with its heads and experts scaled by tp, 5
AdamW steps of ``make_train_step(fsdp=dp > 1, remat=True,
accum_steps=2)``, the loss printed each step. Each rank computes on
``cuda:<LOCAL_RANK % cards>`` (``--device cpu``: on the CPU); the backend
is NCCL where every rank has a card of its own, else gloo (NCCL refuses
two ranks on one card).

Packed (multi-segment) batches: swap the loss for
``parallel.train.cross_entropy_loss_packed`` and feed position_ids.
Memory levers for big models / long sequences (all composable):
``make_train_step(fsdp=True)`` (ZeRO-3 weight and optimizer sharding over
'data'), ``remat=True`` (recompute layer activations in backward),
``accum_steps=k`` (microbatch gradient accumulation). Returns the losses.
"""

from __future__ import annotations

import argparse
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..models import ModelConfig, init_params
from ..parallel import make_mesh, make_train_step, param_leaves
from ..parallel.train import param_shardings
from ..utils import resolve_device

STEPS = 5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description="the mesh training step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    backend = ("nccl" if dev.type == "cuda"
               and world <= torch.cuda.device_count() else "gloo")
    started = not dist.is_initialized()
    if started and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    elif started:
        dist.init_process_group(backend, world_size=1, rank=0,
                                init_method=f"tcp://localhost:{_free_port()}")
    try:
        return _train(dev)
    finally:
        if started:
            dist.destroy_process_group()


def _train(dev):
    n = dist.get_world_size()
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh({"data": dp, "seq": 1, "model": tp}, device=dev)
    cfg = ModelConfig.tiny(num_heads=4 * tp, num_kv_heads=2 * tp,
                           num_experts=2 * tp, vocab_size=512, num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev, shardings=param_shardings(
        cfg, mesh, fsdp_axis="data" if dp > 1 else None))
    opt = torch.optim.AdamW(param_leaves(params), lr=1e-3)
    step, _ = make_train_step(cfg, mesh, opt, fsdp=dp > 1, remat=True,
                              accum_steps=2)
    batch = torch.randint(0, cfg.vocab_size, (2 * dp, 129), generator=gen,
                          device=dev)
    losses = []
    for i in range(STEPS):
        losses.append(float(step(params, batch)))
        if dist.get_rank() == 0:
            print(f"step {i}: loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
