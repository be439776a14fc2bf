"""The gpt-oss golden logits criterion, on the port.

    python3 -m sink_attention_tpu_torch.scripts.golden_gpt_oss \\
        [--model-path DIR] [--num-prompts 5] [--seq-len 512] \\
        [--quant int4|int8|none] [--dtype bf16|f32] [--skip-hf] \\
        [--device cuda|cpu] [--out GOLDEN.md]

Counterpart of the JAX package's ``scripts/golden_gpt_oss.py``: load a
checkpoint in the HF layout (``models.hf_loader``), run random-token
prompts through three stacks on the same weights,

  (a) eager attention, the ground truth: HF transformers' eager model
      (honours ``s_aux`` and the per-layer windows, materialised softmax)
      or, with ``--skip-hf``, the port's plain-attention stack
      (``ops/reference.py``, materialised softmax; what the JAX package's
      own tiny golden test uses as eager),
  (b) the port's kernel stack (the CUDA forward on the card),
  (c) the full-causal, no-sink ablation of that stack (``num_sink=0``,
      ``window=N``, ``s_aux`` dropped, through the same forward kernel):
      the stand-in for an attention that ignores both,

and report the mean and max absolute logit difference, cosine similarity
and top-1 agreement of (b) and (c) against (a). Verdict: the kernel stack
is strictly closer to eager than the ablation.

Unlike the JAX script, a missing eager baseline is an error: without
transformers (and without ``--skip-hf``) the script exits nonzero, rather
than reporting a different comparison. With no checkpoint found it skips
(exit 0), as the JAX script does.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["find_checkpoint", "run", "main"]


def find_checkpoint(explicit: Optional[str]) -> Optional[str]:
    """``explicit`` if it is a directory, else ``$SINK_GPT_OSS_PATH``, else
    a cached HF snapshot of openai/gpt-oss-20b holding safetensors."""
    if explicit:
        return explicit if os.path.isdir(explicit) else None
    env = os.environ.get("SINK_GPT_OSS_PATH")
    if env and os.path.isdir(env):
        return env
    pat = os.path.expanduser(
        "~/.cache/huggingface/hub/models--openai--gpt-oss-20b/snapshots/*")
    for cand in sorted(glob.glob(pat)):
        if glob.glob(os.path.join(cand, "*.safetensors")):
            return cand
    return None


def _metrics(ours, theirs):
    a = np.asarray(ours, np.float32).reshape(-1)
    b = np.asarray(theirs, np.float32).reshape(-1)
    diff = np.abs(a - b)
    cos = float((a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))
    return dict(mean_abs=float(diff.mean()), max_abs=float(diff.max()),
                cos=cos)


def _top1(xs, ys) -> float:
    return float(np.mean([(x.argmax(-1) == y.argmax(-1)).mean()
                          for x, y in zip(xs, ys)]))


def _hf_eager(model_path, prompts, dtype):
    """Logits of HF transformers' eager GptOss model, on the CPU."""
    from transformers import AutoModelForCausalLM
    hf = AutoModelForCausalLM.from_pretrained(
        model_path, torch_dtype=dtype, attn_implementation="eager",
        local_files_only=True, low_cpu_mem_usage=True).eval()
    with torch.no_grad():
        return [hf(torch.from_numpy(p)[None]).logits[0].float().numpy()
                for p in prompts]


def _need_transformers() -> None:
    try:
        import transformers  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "HF eager is the baseline but transformers is not importable "
            f"({e}); pass skip_hf (--skip-hf) to hold the kernel stack to "
            "the port's plain-attention stack") from e


def run(model_path: str, num_prompts: int, seq_len: int,
        quant: Optional[str], skip_hf: bool, out_path: Optional[str],
        dtype: str = "bf16", device="cuda", loaded=None,
        attn=None) -> dict:
    """The criterion on the checkpoint at ``model_path`` (``loaded``, a
    ``(cfg, params)`` pair already loaded from it, skips the load).
    ``attn(q, k, v, num_sink=, window_size=, s_aux=)`` is the forward the
    kernel stack and the ablation call (default ``sink_flash_attention``);
    a caller may pass one that checks the kernel on the way.
    Returns {"kernel", "ablation": metrics against eager, "top1_kernel",
    "top1_ablation", "ratio", "verdict": bool, "eager": "hf" or "plain",
    "report": the markdown text}. Raises RuntimeError when HF eager is
    asked for (no ``skip_hf``) and transformers is not importable."""
    from ..models import forward_prefill, load_hf_checkpoint
    from ..ops import eager_sink_attention, sink_flash_attention
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if not skip_hf:
        _need_transformers()
    tdtype = torch.float32 if dtype == "f32" else torch.bfloat16
    if loaded is None:
        print(f"[golden] loading {model_path} (quant={quant}, dtype={dtype})"
              " ...", flush=True)
        loaded = load_hf_checkpoint(model_path, dtype=tdtype, quant=quant,
                                    device=dev)
    cfg, params = loaded
    print(f"[golden] cfg: layers={cfg.num_layers} H={cfg.num_heads}/"
          f"{cfg.num_kv_heads} d={cfg.head_dim} vocab={cfg.vocab_size} "
          f"window={cfg.sliding_window}", flush=True)

    rng = np.random.default_rng(42)
    prompts = rng.integers(0, min(cfg.vocab_size, 50000),
                           size=(num_prompts, seq_len), dtype=np.int64)

    attn = attn or sink_flash_attention

    def fa2_standin(q, k, v, num_sink, window_size, s_aux=None, **kw):
        # full causal, no sinks, no s_aux: same weights, same forward kernel
        return attn(q, k, v, num_sink=0, window_size=q.shape[2], s_aux=None)

    stacks = {"kernel": attn, "ablation": fa2_standin}
    if skip_hf:
        stacks["eager"] = eager_sink_attention
    logits = {name: [] for name in stacks}
    with torch.no_grad():
        for i, p in enumerate(prompts):
            ids = torch.from_numpy(p)[None].to(dev)
            for name, impl in stacks.items():
                out = forward_prefill(params, cfg, ids, attn_impl=impl)[0]
                logits[name].append(out[0].float().cpu().numpy())
            print(f"[golden] prompt {i + 1}/{num_prompts}: "
                  f"{', '.join(stacks)} done", flush=True)
    if not skip_hf:
        logits["eager"] = _hf_eager(model_path, prompts, tdtype)

    ours, ablation, eager = (logits["kernel"], logits["ablation"],
                             logits["eager"])
    mk = _metrics(np.stack(ours), np.stack(eager))
    ma = _metrics(np.stack(ablation), np.stack(eager))
    result = {"kernel": mk, "ablation": ma,
              "top1_kernel": _top1(ours, eager),
              "top1_ablation": _top1(ablation, eager),
              "ratio": ma["mean_abs"] / max(mk["mean_abs"], 1e-12),
              "verdict": mk["mean_abs"] < ma["mean_abs"],
              "eager": "plain" if skip_hf else "hf"}
    eager_name = ("the port's plain-attention stack (ops/reference.py)"
                  if skip_hf else "HF transformers eager")
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    lines = [
        "# GOLDEN: gpt-oss logits criterion (the PyTorch port)",
        "",
        f"Checkpoint: `{model_path}`  quant={quant}  dtype={dtype}  "
        f"prompts={num_prompts} seq_len={seq_len}  device={card}",
        "",
        f"Eager: {eager_name}. Kernel: the port's CUDA stack. Ablation: "
        "full causal, no sinks, no s_aux, through the same kernel.",
        "",
        "| run | mean abs diff | max abs diff | cos sim | top-1 agree |",
        "|---|---|---|---|---|",
        f"| kernel vs eager | {mk['mean_abs']:.4g} | {mk['max_abs']:.4g}"
        f" | {mk['cos']:.6f} | {result['top1_kernel']:.3f} |",
        f"| ablation vs eager | {ma['mean_abs']:.4g} | {ma['max_abs']:.4g}"
        f" | {ma['cos']:.6f} | {result['top1_ablation']:.3f} |",
        "",
        f"**Kernel is {result['ratio']:.1f}x closer to eager than the "
        "ablation.**",
        "",
        f"Verdict: {'PASS' if result['verdict'] else 'FAIL'}: kernel "
        f"{'is' if result['verdict'] else 'is NOT'} strictly closer to "
        "eager than full-causal.",
    ]
    result["report"] = "\n".join(lines) + "\n"
    print(result["report"])
    if out_path:
        with open(out_path, "w") as f:
            f.write(result["report"])
        print(f"[golden] wrote {out_path}")
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--num-prompts", type=int, default=5)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--quant", default="none",
                    choices=["int4", "int8", "none"],
                    help="weight form (one H100 holds the 20b bf16 tree)")
    ap.add_argument("--skip-hf", action="store_true",
                    help="eager is the port's plain-attention stack, not "
                         "HF transformers")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                    help="compute dtype of every stack; f32 separates the "
                         "attention pattern's error from bf16 rounding "
                         "(on the CPU: the kernels take bf16)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    path = find_checkpoint(args.model_path)
    if path is None:
        print("[golden] SKIP: no gpt-oss-20b checkpoint found (looked at "
              "--model-path, $SINK_GPT_OSS_PATH, ~/.cache/huggingface); "
              "place a checkpoint locally to run the criterion.")
        return 0
    if not args.skip_hf:
        try:
            _need_transformers()
        except RuntimeError as e:
            print(f"[golden] {e}")
            return 2
    quant = None if args.quant == "none" else args.quant
    result = run(path, args.num_prompts, args.seq_len, quant, args.skip_hf,
                 args.out, dtype=args.dtype, device=args.device)
    return 0 if result["verdict"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
