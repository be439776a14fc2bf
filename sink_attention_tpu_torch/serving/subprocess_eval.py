"""Generation in a fresh process.

Counterpart of ``sink_attention_tpu/serving/subprocess_eval.py``: after a
training run (or a crashed one) the parent's CUDA context may be wedged or
hold memory, so generation runs in a new Python process with a context of
its own. The configuration and the results travel through JSON files in a
temporary directory. The worker imports only this package.

The devices are a schedule: each is tried in turn until a worker returns
results. The default is the card alone, ``("cuda",)``: a failure there
returns ``[]`` rather than a quiet run on the CPU. A caller who wants a CPU
fallback names it (``devices=("cuda", "cpu")``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

__all__ = ["subprocess_generate"]

ROOT = Path(__file__).resolve().parents[2]

_WORKER = r"""
import json, sys

import torch

cfg_path, out_path, device = sys.argv[1], sys.argv[2], sys.argv[3]
with open(cfg_path) as f:
    cfg = json.load(f)

from sink_attention_tpu_torch.models import (ModelConfig, init_params,
                                             load_hf_checkpoint)
from sink_attention_tpu_torch.serving import greedy_generate
from sink_attention_tpu_torch.utils import resolve_device

dev = resolve_device(device)
if cfg["checkpoint"]:
    model_cfg, params = load_hf_checkpoint(cfg["checkpoint"],
                                           dtype=torch.bfloat16, device=dev)
else:
    model_cfg = ModelConfig(**cfg["model_config"])
    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])
    params = init_params(model_cfg, gen, dtype=torch.bfloat16, device=dev)

results = []
for ids in cfg["input_ids"]:
    toks = greedy_generate(params, model_cfg,
                           torch.tensor([ids], dtype=torch.long, device=dev),
                           max_new_tokens=cfg["max_new_tokens"],
                           quant=cfg["quant"], device=dev)
    results.append([int(t) for t in toks[0]])

with open(out_path, "w") as f:
    json.dump({"generated_ids": results}, f)
"""


def subprocess_generate(
    input_ids: Sequence[Sequence[int]],
    checkpoint: Optional[str] = None,
    model_config: Optional[dict] = None,
    max_new_tokens: int = 32,
    quant: Optional[str] = None,
    seed: int = 0,
    timeout: float = 1800.0,
    devices: Sequence[str] = ("cuda",),
    verbose: bool = True,
) -> List[List[int]]:
    """Greedy generation in a fresh process.

    Args:
        input_ids: the prompts (lists of token ids).
        checkpoint: a local HF checkpoint directory (safetensors), or None
            for ``model_config`` (``ModelConfig`` keyword arguments) with
            bf16 weights from ``init_params`` seeded ``seed``.
        quant: the KV cache's storage (None, "int8" or "fp8").
        devices: the schedule: one worker per device in turn until one
            returns results (default: the card alone).

    Returns:
        the generated ids of each prompt, or [] when every worker failed
        (the reference's contract).
    """
    cfg = {
        "input_ids": [list(map(int, ids)) for ids in input_ids],
        "checkpoint": checkpoint,
        "model_config": model_config or {},
        "max_new_tokens": max_new_tokens,
        "quant": quant,
        "seed": seed,
    }
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="sink_eval_") as tmp:
        cfg_path = os.path.join(tmp, "config.json")
        out_path = os.path.join(tmp, "results.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        for device in devices:
            if os.path.exists(out_path):
                os.remove(out_path)  # a failed worker's stale result
            if verbose:
                print(f"[subprocess_eval] launching worker (device={device})",
                      file=sys.stderr)
            try:
                proc = subprocess.run(
                    [sys.executable, "-c", _WORKER, cfg_path, out_path,
                     str(device)],
                    env=env, timeout=timeout, capture_output=True, text=True)
            except subprocess.TimeoutExpired:
                if verbose:
                    print("[subprocess_eval] worker timed out",
                          file=sys.stderr)
                continue
            if proc.returncode == 0 and os.path.exists(out_path):
                with open(out_path) as f:
                    return json.load(f)["generated_ids"]
            if verbose:
                print(f"[subprocess_eval] worker failed "
                      f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}",
                      file=sys.stderr)
    return []
