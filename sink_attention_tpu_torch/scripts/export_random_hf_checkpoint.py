"""Export a RANDOM-INIT gpt-oss checkpoint in the HF layout (safetensors).

    python3 -m sink_attention_tpu_torch.scripts.export_random_hf_checkpoint \\
        --out DIR [--tiny] [--layers N] [--seed S]

Counterpart of the JAX package's ``scripts/export_random_hf_checkpoint.py``,
written through the port's own safetensors writer (``utils._safetensors``)
so it needs neither ``safetensors`` nor ``ml_dtypes``. The golden
criterion (``golden_gpt_oss.py``) needs a checkpoint on disk; with no
released weights at hand this writes a random one at the same geometry,
so the whole protocol (the HF-layout load, eager against the kernel stack
against the full-causal ablation) runs end to end, and the released
weights drop in with the same command line.

Weights are bf16 in the dense layout (experts ``[E, in, out]``), one
safetensors file per layer plus one for embed/norm/head, with a
``model.safetensors.index.json``, so the export holds one layer at a time.
Init, drawn from ``numpy.random.default_rng(seed)`` in the JAX script's
order (the same files): N(0, 0.02) matmul weights and router, zero biases,
unit norms, N(0, 1) attention sinks.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils._safetensors import save_file

__all__ = ["GEOMETRIES", "hf_config", "layer_tensors", "new_index",
           "write_shard", "write_index", "export", "main"]

GEOMETRIES = {
    # the gpt-oss-20b geometry
    "20b": dict(vocab_size=201088, hidden_size=2880, num_hidden_layers=24,
                num_attention_heads=64, num_key_value_heads=8, head_dim=64,
                intermediate_size=2880, num_local_experts=32,
                num_experts_per_tok=4, sliding_window=128),
    # the test-size variant
    "tiny": dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                 intermediate_size=32, num_local_experts=4,
                 num_experts_per_tok=2, sliding_window=16),
}


def hf_config(g: dict) -> dict:
    """The ``config.json`` of a GptOssForCausalLM at geometry ``g``."""
    n = g["num_hidden_layers"]
    return {
        "architectures": ["GptOssForCausalLM"],
        "model_type": "gpt_oss",
        "attention_bias": True,
        "attention_dropout": 0.0,
        "eos_token_id": 200002,
        "pad_token_id": 199999,
        "hidden_act": "silu",
        "initializer_range": 0.02,
        "layer_types": ["sliding_attention" if i % 2 == 0
                        else "full_attention" for i in range(n)],
        "max_position_embeddings": 131072,
        "rms_norm_eps": 1e-5,
        "rope_theta": 150000.0,
        "rope_scaling": {
            "rope_type": "yarn", "factor": 32.0,
            "beta_fast": 32.0, "beta_slow": 1.0, "truncate": False,
            "original_max_position_embeddings": 4096,
        },
        "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
        "transformers_version": "4.55.0",
        "router_aux_loss_coef": 0.9,
        "output_router_logits": False,
        "swiglu_limit": 7.0,
        **g,
    }


def layer_tensors(g: dict) -> list:
    """(name suffix, shape, kind) of one layer's tensors at geometry ``g``
    in the HF layout, in the order written: kind "w" a matmul weight or
    the router (HF Linear stores [out, in]; the experts' dense format is
    [E, in, out]), "b" a bias, "one" a norm weight, "sink" the attention
    sinks."""
    H, D = g["hidden_size"], g["head_dim"]
    HQ, HKV = g["num_attention_heads"], g["num_key_value_heads"]
    I, E = g["intermediate_size"], g["num_local_experts"]
    return [
        ("self_attn.q_proj.weight", (HQ * D, H), "w"),
        ("self_attn.q_proj.bias", (HQ * D,), "b"),
        ("self_attn.k_proj.weight", (HKV * D, H), "w"),
        ("self_attn.k_proj.bias", (HKV * D,), "b"),
        ("self_attn.v_proj.weight", (HKV * D, H), "w"),
        ("self_attn.v_proj.bias", (HKV * D,), "b"),
        ("self_attn.o_proj.weight", (H, HQ * D), "w"),
        ("self_attn.o_proj.bias", (H,), "b"),
        ("self_attn.sinks", (HQ,), "sink"),
        ("mlp.router.weight", (E, H), "w"),
        ("mlp.router.bias", (E,), "b"),
        ("mlp.experts.gate_up_proj", (E, H, 2 * I), "w"),
        ("mlp.experts.gate_up_proj_bias", (E, 2 * I), "b"),
        ("mlp.experts.down_proj", (E, I, H), "w"),
        ("mlp.experts.down_proj_bias", (E, H), "b"),
        ("input_layernorm.weight", (H,), "one"),
        ("post_attention_layernorm.weight", (H,), "one"),
    ]


def new_index() -> dict:
    """An empty ``model.safetensors.index.json``."""
    return {"metadata": {"total_size": 0}, "weight_map": {}}


def write_shard(out_dir: str, index: dict, fname: str,
                tensors: dict) -> None:
    """Write ``tensors`` ({name: CPU tensor}) to the shard ``fname`` and
    enter them in ``index``."""
    save_file(tensors, os.path.join(out_dir, fname),
              metadata={"format": "pt"})
    for name, t in tensors.items():
        index["weight_map"][name] = fname
        index["metadata"]["total_size"] += t.numel() * t.element_size()


def write_index(out_dir: str, index: dict, config: dict) -> None:
    """Write ``model.safetensors.index.json`` and ``config.json``."""
    with open(os.path.join(out_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump(index, f)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


def export(out_dir: str, g: dict, seed: int = 0) -> dict:
    """Write the checkpoint of geometry ``g`` to ``out_dir``; returns its
    index (``weight_map``, ``metadata.total_size`` in bytes)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    V, H, L = g["vocab_size"], g["hidden_size"], g["num_hidden_layers"]

    def draw(shape, kind):
        if kind == "b":
            return torch.zeros(shape, dtype=torch.bfloat16)
        if kind == "one":
            return torch.ones(shape, dtype=torch.bfloat16)
        scale = 1.0 if kind == "sink" else 0.02
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32) * scale).to(torch.bfloat16)

    index = new_index()
    for i in range(L):
        pre = f"model.layers.{i}."
        write_shard(out_dir, index, f"model-layer-{i:05d}.safetensors",
                    {pre + n: draw(s, k) for n, s, k in layer_tensors(g)})
        print(f"[export] layer {i + 1}/{L}", flush=True)

    write_shard(out_dir, index, "model-embed.safetensors", {
        "model.embed_tokens.weight": draw((V, H), "w"),
        "model.norm.weight": draw((H,), "one"),
        "lm_head.weight": draw((V, H), "w"),
    })
    write_index(out_dir, index, hf_config(g))
    gb = index["metadata"]["total_size"] / 1e9
    print(f"[export] wrote {out_dir} ({gb:.1f} GB, {L} layers)")
    return index


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="override layer count (geometry otherwise real)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    g = dict(GEOMETRIES["tiny" if args.tiny else "20b"])
    if args.layers:
        g["num_hidden_layers"] = args.layers
    export(args.out, g, seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
