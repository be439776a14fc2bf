"""Guards of the port: it imports nothing of JAX or of the JAX package, and
its entry points run on the card unless told otherwise."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, imports with JAX made
    unimportable, and loads no module of sink_attention_tpu."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import sink_attention_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        leaked = sorted(m for m, mod in sys.modules.items()
                        if mod is not None and m.split(".")[0] in (
                            "sink_attention_tpu", "jax", "flax"))
        print(len(names), leaked)
        assert not leaked, leaked
        assert len(names) >= 15, names
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from sink_attention_tpu_torch.cache import SinkKVCache
    from sink_attention_tpu_torch.models import (ModelConfig, init_params,
                                                 make_caches)
    from sink_attention_tpu_torch.serving import greedy_generate
    from sink_attention_tpu_torch.utils import time_cuda
    cfg = ModelConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SinkKVCache.init(1, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_caches(cfg, 1, 32)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        greedy_generate(params, cfg, torch.zeros((1, 4), dtype=torch.long),
                        2)
    with pytest.raises(RuntimeError):
        time_cuda(lambda: None)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card chip_smoke exits nonzero and prints no result; alone
    in a directory (without the port) it does the same."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    src = (ROOT / "chip_smoke.py").read_text()
    (tmp_path / "chip_smoke.py").write_text(src)
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernels' input checks run before any launch, so they hold on
    the CPU too: no fp32, no head_dim outside (64, 128), no CPU tensors."""
    from sink_attention_tpu_torch.ops import decode, flash

    def bwd_args(t):
        rows = torch.zeros(t.shape[:3])
        return t, t, t, t, rows, rows

    backward = (flash.flash_dq_kernel, flash.flash_dkdv_kernel)
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(TypeError):
        flash.flash_fwd_kernel(q, q, q)
    for fn in backward:
        with pytest.raises(TypeError):
            fn(*bwd_args(q))
    qb = torch.zeros(1, 2, 8, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash.flash_fwd_kernel(qb, qb, qb)
    for fn in backward:
        with pytest.raises(ValueError, match="head_dim"):
            fn(*bwd_args(qb))
    qb = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash.flash_fwd_kernel(qb, qb, qb)
    for fn in backward:
        with pytest.raises(ValueError, match="CUDA"):
            fn(*bwd_args(qb))
    lens = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode.decode_kernel(qb[:, :, :1], qb, qb, lens, sink_cap=0,
                             window_size=8)
    assert flash.flash_fwd_kernel.launches == 0
    assert flash.flash_dq_kernel.launches == 0
    assert flash.flash_dkdv_kernel.launches == 0
    assert decode.decode_kernel.launches == 0


def test_packed_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The packed kernels' wrappers check before any launch: no fp32, no
    head_dim outside (64, 128), positions of shape [B, N] only, no CPU
    tensors."""
    from sink_attention_tpu_torch.ops import packed

    def calls(t, positions):
        rows = torch.zeros(t.shape[:3])
        bwd = (t, t, t, t, rows, rows, positions)
        return ((packed.packed_fwd_kernel, (t, t, t, positions)),
                (packed.packed_dq_kernel, bwd),
                (packed.packed_dkdv_kernel, bwd))

    pos = torch.zeros(1, 8, dtype=torch.int32)
    for fn, args in calls(torch.zeros(1, 2, 8, 64), pos):
        with pytest.raises(TypeError):
            fn(*args)
    for fn, args in calls(torch.zeros(1, 2, 8, 80, dtype=torch.bfloat16),
                          pos):
        with pytest.raises(ValueError, match="head_dim"):
            fn(*args)
    qb = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    for bad in (torch.zeros(8, dtype=torch.int32),
                torch.zeros(1, 7, dtype=torch.int32)):
        for fn, args in calls(qb, bad):
            with pytest.raises(ValueError, match="positions"):
                fn(*args)
    for fn, args in calls(qb, pos):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    assert packed.packed_fwd_kernel.launches == 0
    assert packed.packed_dq_kernel.launches == 0
    assert packed.packed_dkdv_kernel.launches == 0


def test_quantized_decode_wrapper_refuses_what_the_kernels_do_not_take():
    """The int8/fp8 decode branches check before any launch: int8 codes,
    fp32 scales of shape [B, H_kv, S_total], bf16 q, one device, CUDA."""
    from sink_attention_tpu_torch.ops import decode

    q = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    codes = torch.zeros(1, 2, 128, 64, dtype=torch.int8)
    scale = torch.ones(1, 2, 128)
    lens = torch.zeros(1, 4, dtype=torch.int32)

    def call(q=q, k=codes, v=codes, ks=scale, vs=scale, quant="int8"):
        decode.decode_kernel(q, k, v, lens, sink_cap=0, window_size=128,
                             k_scale=ks, v_scale=vs, quant=quant)

    with pytest.raises(TypeError, match="int8 codes"):
        call(k=codes.to(torch.bfloat16))
    with pytest.raises(TypeError, match="fp32 scales"):
        call(ks=scale.to(torch.bfloat16))
    with pytest.raises(TypeError, match="fp32 scales"):
        call(vs=None, quant="fp8")
    with pytest.raises(ValueError, match="S_total"):
        call(ks=scale[:, :, :64])
    with pytest.raises(TypeError, match="bf16 q"):
        call(q=q.float())
    with pytest.raises(ValueError, match="head_dim"):
        call(q=q[..., :32], k=codes[..., :32], v=codes[..., :32])
    with pytest.raises(ValueError, match="different devices"):
        call(ks=torch.ones(1, 2, 128, device="meta"))
    with pytest.raises(ValueError, match="quant"):
        call(quant="int4")
    with pytest.raises(ValueError, match="CUDA"):
        call()
    with pytest.raises(TypeError):   # int8 codes given as bf16 storage
        call(quant=None)
    assert (decode.decode_kernel.launches, decode.decode_kernel.launches_int8,
            decode.decode_kernel.launches_fp8) == (0, 0, 0)


def test_engine_defaults_to_the_card():
    """The ragged cache, its factory and the engine raise without CUDA
    unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from sink_attention_tpu_torch.cache import RaggedSinkKVCache
    from sink_attention_tpu_torch.models import (ModelConfig, init_params,
                                                 make_ragged_caches)
    from sink_attention_tpu_torch.serving import ContinuousBatchingEngine
    cfg = ModelConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RaggedSinkKVCache.init(2, 2, 16, quant="int8")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_ragged_caches(cfg, 2, 32, quant="fp8")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(params, cfg, max_batch=2, max_len=32)
    eng = ContinuousBatchingEngine(params, cfg, max_batch=2, max_len=32,
                                   prefill_bucket=16, device="cpu")
    rid = eng.submit([1, 2, 3], max_new_tokens=2)
    assert len(eng.run()[rid]) == 2


def test_ablation_kernel_refuses_what_the_kernels_do_not_take():
    """The ablation kernels' wrapper checks before any launch: bf16 only,
    head_dim 64 or 128, N a multiple of 64, a known stage, a mask stage's
    window a multiple of 64, CUDA tensors."""
    from sink_attention_tpu_torch.ops import ablation

    def call(stage="sum", n=128, d=64, dtype=torch.bfloat16, window=128):
        q = torch.zeros(1, 4, n, d, dtype=dtype)
        kv = torch.zeros(1, 2, n, d, dtype=dtype)
        ablation.ablation_kernel(q, kv, kv, stage, 4, window)

    with pytest.raises(TypeError, match="bf16"):
        call(dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        call(d=80)
    with pytest.raises(ValueError, match="multiple of 64"):
        call(n=100)
    with pytest.raises(ValueError, match="unknown stage"):
        call(stage="softmax")
    with pytest.raises(ValueError, match="window_size"):
        call(stage="maskadd", window=100)
    for stage, window in (("sum", 100), ("masksel", 128)):
        # a stripped stage takes any window; nothing runs off the card
        with pytest.raises(ValueError, match="CUDA"):
            call(stage=stage, window=window)
    assert (ablation.ablation_kernel.launches,
            ablation.ablation_kernel.launches_mask_stage) == (0, 0)


def test_ablation_entry_point_needs_the_card():
    """Without CUDA the ablation script exits nonzero and prints no table,
    and its inputs default to the card."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    from sink_attention_tpu_torch.scripts import mfu_ablation
    out = subprocess.run(
        [sys.executable, "-m", "sink_attention_tpu_torch.scripts.mfu_ablation",
         "--n", "256"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "mxu_floor" not in out.stdout
    assert mfu_ablation.main(["--n", "256"]) != 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mfu_ablation.make_inputs(256)
    q, k, v = mfu_ablation.make_inputs(128, device="cpu", h_q=2, h_kv=1,
                                       d=64)
    assert q.device.type == "cpu" and q.dtype == torch.bfloat16


def test_decode_wrapper_takes_any_group():
    """The one-launch decode takes GQA groups above 16 (MQA 32/1, 64/1):
    on the CPU the wrapper gets as far as the device check; it still
    refuses fp32 q, head_dim 80 and inputs on two devices."""
    from sink_attention_tpu_torch.ops import decode

    def call(h_q, d=64, dtype=torch.bfloat16, kv_device="cpu"):
        q = torch.zeros(1, h_q, 1, d, dtype=dtype)
        kv = torch.zeros(1, 1, 128, d, dtype=torch.bfloat16,
                         device=kv_device)
        decode.decode_kernel(q, kv, kv, (0, 4, 4), sink_cap=0,
                             window_size=128)

    for h_q in (32, 64):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call(h_q)
    with pytest.raises(TypeError, match="bf16"):
        call(32, dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        call(32, d=80)
    with pytest.raises(ValueError, match="different devices"):
        call(64, kv_device="meta")
    assert decode.decode_kernel.launches == 0
    assert [decode.cluster_size((0, n, n), 2048, 0, 2048)
            for n in (1, 128, 129, 300, 1000, 1100, 2048)] == [
        1, 1, 2, 4, 8, 8, 8]


def test_top_level_exports_the_ported_api():
    """Every name of the JAX package's top-level ``__all__`` that the port
    has (in its ops or cache) is exported by the port's top level. The JAX
    list is read from the source with ast, so nothing of JAX is imported."""
    import sink_attention_tpu_torch as port
    from sink_attention_tpu_torch import cache, ops

    tree = ast.parse((ROOT / "sink_attention_tpu" / "__init__.py").read_text())
    jax_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "__all__"
                           for t in node.targets))
    ported = [n for n in jax_all
              if n == "__version__" or n in ops.__all__ or n in cache.__all__]
    assert {"packed_sink_window_mask", "sink_decode_attention_ragged",
            "RaggedSinkKVCache"} <= set(ported)
    missing = [n for n in ported
               if n not in port.__all__ or not hasattr(port, n)]
    assert not missing, missing
