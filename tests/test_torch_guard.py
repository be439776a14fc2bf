"""Guards of the port: it imports nothing of JAX or of the JAX package, and
its entry points run on the card unless told otherwise."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _jax_all(path):
    """The ``__all__`` list of a JAX package module, read with ast."""
    tree = ast.parse((ROOT / path).read_text())
    return next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets))


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
    import inspect
    from sink_attention_tpu_torch.serving import subprocess_eval
    devices = inspect.signature(
        subprocess_eval.subprocess_generate).parameters["devices"].default
    assert tuple(devices) == ("cuda",)


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
    the CPU too: only bf16, fp16 or fp32, one type for q/k/v, no head_dim
    below 1, no CPU tensors (head_dim 80, 100, 520 and 1024, and fp32,
    pass the checks and stop at the device: every head_dim past 512 runs
    in the wide instance)."""
    from sink_attention_tpu_torch.ops import decode, flash

    def bwd_args(t, kv=None):
        rows = torch.zeros(t.shape[:3])
        kv = t if kv is None else kv
        return t, kv, kv, t, rows, rows

    backward = (flash.flash_dq_kernel, flash.flash_dkdv_kernel)
    q = torch.zeros(1, 2, 8, 64, dtype=torch.float64)
    half = torch.zeros(1, 2, 8, 64, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash.flash_fwd_kernel(q, q, q)
    with pytest.raises(TypeError):
        flash.flash_fwd_kernel(half.bfloat16(), half, half)
    for fn in backward:
        with pytest.raises(TypeError):
            fn(*bwd_args(q))
        with pytest.raises(TypeError):
            fn(*bwd_args(half.bfloat16(), half))
    qb = torch.zeros(1, 2, 8, 0, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 0"):
        flash.flash_fwd_kernel(qb, qb, qb)
    for fn in backward:
        with pytest.raises(ValueError, match="head_dim 0"):
            fn(*bwd_args(qb))
    for d, dtype in ((64, torch.bfloat16), (80, torch.float32),
                     (100, torch.float16), (520, torch.bfloat16),
                     (1024, torch.float32)):
        qb = torch.zeros(1, 2, 8, d, dtype=dtype)
        with pytest.raises(ValueError, match="CUDA"):
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
    """The packed kernels' wrappers check before any launch: only bf16,
    fp16 or fp32, no head_dim below 1 (520 stops at the device),
    positions of shape [B, N] only, no CPU tensors."""
    from sink_attention_tpu_torch.ops import packed

    def calls(t, positions):
        rows = torch.zeros(t.shape[:3])
        bwd = (t, t, t, t, rows, rows, positions)
        return ((packed.packed_fwd_kernel, (t, t, t, positions)),
                (packed.packed_dq_kernel, bwd),
                (packed.packed_dkdv_kernel, bwd))

    pos = torch.zeros(1, 8, dtype=torch.int32)
    for fn, args in calls(torch.zeros(1, 2, 8, 64, dtype=torch.float64),
                          pos):
        with pytest.raises(TypeError):
            fn(*args)
    for fn, args in calls(torch.zeros(1, 2, 8, 0, dtype=torch.bfloat16),
                          pos):
        with pytest.raises(ValueError, match="head_dim 0"):
            fn(*args)
    for d in (80, 520):
        for fn, args in calls(torch.zeros(1, 2, 8, d), pos):
            with pytest.raises(ValueError, match="CUDA"):
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
    fp32 scales of shape [B, H_kv, S_total], bf16 q, head_dim >= 1 (520
    stops at the device), one device, CUDA."""
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
    empty = torch.zeros(1, 2, 128, 0, dtype=torch.int8)
    with pytest.raises(ValueError, match="head_dim 0"):
        call(q=torch.zeros(1, 8, 1, 0, dtype=torch.bfloat16), k=empty,
             v=empty)
    wide = torch.zeros(1, 2, 128, 520, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        call(q=torch.zeros(1, 8, 1, 520, dtype=torch.bfloat16), k=wide,
             v=wide)
    with pytest.raises(ValueError, match="CUDA"):
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
    head_dim 64 or 128, N a multiple of the forward's 128-row tile (64 is
    not enough), a known stage, CUDA tensors; any window, for the mask
    stages too."""
    from sink_attention_tpu_torch.ops import ablation

    def call(stage="sum", n=128, d=64, dtype=torch.bfloat16, window=128):
        q = torch.zeros(1, 4, n, d, dtype=dtype)
        kv = torch.zeros(1, 2, n, d, dtype=dtype)
        ablation.ablation_kernel(q, kv, kv, stage, 4, window)

    with pytest.raises(TypeError, match="bf16"):
        call(dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        call(d=80)
    for n in (100, 192):
        with pytest.raises(ValueError, match="multiple of 128"):
            call(n=n)
    with pytest.raises(ValueError, match="unknown stage"):
        call(stage="softmax")
    for stage, window in (("sum", 100), ("maskadd", 100), ("masksel", 128)):
        # every stage takes any window; nothing runs off the card
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
    on the CPU the wrapper gets as far as the device check, as it does at
    head_dim 520 (the wide instance); it still refuses fp32 q over a bf16
    cache, head_dim 0 and inputs on two devices."""
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
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(32, d=520)
    with pytest.raises(ValueError, match="head_dim 0"):
        call(32, d=0)
    with pytest.raises(ValueError, match="different devices"):
        call(64, kv_device="meta")
    assert decode.decode_kernel.launches == 0
    assert [decode.cluster_size((0, n, n), 2048, 0, 2048)
            for n in (1, 128, 129, 300, 1000, 1100, 2048)] == [
        1, 1, 2, 4, 8, 8, 8]


def test_split_plan_covers_the_range_and_fills_the_card():
    """The split decode's host plan (head_dim > 128): whole 32-slot tiles,
    ranges covering the live range, about two CTAs per SM of the card at
    small batch, fewer ranges where the unit's merge would outweigh one
    range's K/V bytes; at most 512 ranges, each one pass of at most 512
    slots unless 512 of those do not cover the range. Pure host
    arithmetic: no card."""
    from sink_attention_tpu_torch.ops import decode

    plan = decode.split_plan
    # (units, rows, element bytes, live end, SMs) -> (n_split, split_slots)
    expected = {
        # Gemma-2-2B at B = 2 (8 (b, kv head) units of G = 2), 4096 slots
        (8, 2, 2, 4096, 132): (32, 128),
        # B = 1 over 32768 slots; MQA 8/1 over 8192 (the merge caps it)
        (4, 2, 2, 32768, 132): (64, 512),
        (1, 8, 2, 8192, 132): (32, 256),
        # fp32 at D = 2048, G = 17: three 8-row pieces a kv head
        (3, 8, 4, 1024, 132): (16, 64),
        (8, 2, 2, 20, 132): (1, 32),
        (16, 16, 2, 4096, 132): (16, 256),
        # 512 x 512 slots: 512 one-pass ranges; one slot more: longer
        # ranges, walked in passes
        (1, 1, 2, 512 * 512, 132): (512, 512),
        (1, 1, 2, 512 * 512 + 1, 132): (482, 544),
        (1, 16, 2, 10 ** 6, 132): (505, 1984),
    }
    for args, want in expected.items():
        assert plan(*args) == want, args
    for args in [(8, r, e, n, 132) for r in (1, 2, 16) for e in (1, 2, 4)
                 for n in (1, 300, 4100, 65536, 3 * 10 ** 6)] + [
                     (64, 16, 2, 2048, 8)]:
        n_split, slots = plan(*args)
        assert slots % 32 == 0 and 32 <= slots, args
        assert 1 <= n_split <= 512, args
        assert slots <= 512 or args[3] > 512 * 512, args
        assert n_split * slots >= args[3] > (n_split - 1) * slots, args


def test_top_level_exports_the_ported_api():
    """Every name of the JAX package's top-level ``__all__`` that the port
    has (in its ops, cache, parallel or compat) is exported by the port's
    top level, and that is all of them: the six SP names and the seven
    compat names too. The JAX list is read from the source with ast, so
    nothing of JAX is imported."""
    import sink_attention_tpu_torch as port
    from sink_attention_tpu_torch import cache, compat, ops, parallel

    jax_all = _jax_all("sink_attention_tpu/__init__.py")
    ported = [n for n in jax_all
              if n == "__version__" or any(n in m.__all__ for m in (
                  ops, cache, parallel, compat))]
    assert {"packed_sink_window_mask", "sink_decode_attention_ragged",
            "RaggedSinkKVCache", "broadcast_sink_kv", "reduce_sink_grads",
            "local_position_offset", "sp_sink_flash_attention",
            "ulysses_sink_flash_attention", "ring_sink_flash_attention",
            "SinkCacheLayer", "SinkAttentionCache", "SinkAttentionSPWrapper",
            "prepare_sink_kv_for_sp", "reduce_sink_kv_grads",
            "get_local_position_offset", "subprocess_generate"} <= set(ported)
    assert ported == jax_all
    missing = [n for n in ported
               if n not in port.__all__ or not hasattr(port, n)]
    assert not missing, missing
    from sink_attention_tpu_torch import serving
    assert {"beam_generate", "speculative_generate"} <= set(serving.__all__)
    assert "sink_decode_attention_cached_multi" in ported


def test_models_exports_the_ported_api():
    """Every name of the JAX ``models/__init__.py`` ``__all__`` that one of
    the port's models modules defines is exported by the port's models
    package; the seven quantization names among them (read with ast, so
    nothing of JAX is imported)."""
    from sink_attention_tpu_torch import models
    from sink_attention_tpu_torch.models import config, convert, model, quant

    jax_all = _jax_all("sink_attention_tpu/models/__init__.py")
    ported = [n for n in jax_all
              if any(hasattr(m, n) for m in (config, convert, model, quant))]
    assert {"quantize_params", "quantize_weight", "is_quantized",
            "is_quantized4", "quantize_weight_int4",
            "init_quantized_params", "forward_decode_ragged"} <= set(ported)
    missing = [n for n in ported
               if n not in models.__all__ or not hasattr(models, n)]
    assert not missing, missing


@pytest.mark.parametrize("path", ["sink_attention_tpu_torch/ops/int4.py",
                                  "sink_attention_tpu_torch/models/quant.py"])
def test_quantization_modules_import_no_jax(path):
    """The int4 ops and the quantization module import torch (and the
    port), nothing of JAX, flax or the JAX package."""
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and not node.level]
    assert "torch" in names
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "flax", "sink_attention_tpu")], names


@pytest.mark.parametrize("path", [
    "sink_attention_tpu_torch/parallel/_collectives.py",
    "sink_attention_tpu_torch/parallel/sp.py",
    "sink_attention_tpu_torch/parallel/ulysses.py",
    "sink_attention_tpu_torch/parallel/ring.py",
    "sink_attention_tpu_torch/compat.py",
    "sink_attention_tpu_torch/serving/subprocess_eval.py",
    "sink_attention_tpu_torch/serving/divergence.py",
    "tests/_torch_sp_worker.py"])
def test_sp_and_compat_modules_import_no_jax(path):
    """The sequence-parallel modules, the compat layer, the subprocess
    harness (its worker's source too), the divergence replay and the gloo
    ranks' worker import torch (and the port), nothing of JAX, flax or the
    JAX package."""
    src = (ROOT / path).read_text()
    trees = [ast.parse(src)]
    if path.endswith("subprocess_eval.py"):
        from sink_attention_tpu_torch.serving import subprocess_eval
        trees.append(ast.parse(subprocess_eval._WORKER))
    names = []
    for tree in trees:
        names += [a.name for node in ast.walk(tree)
                  if isinstance(node, ast.Import) for a in node.names]
        names += [node.module or "" for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and not node.level]
    assert "torch" in names or any(n.startswith("torch") for n in names)
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "flax", "sink_attention_tpu")], names


def test_build_writes_each_library_atomically(tmp_path, monkeypatch):
    """ops/_build.py compiles each source to a temporary file of its own
    process and moves it into place with os.replace, so ranks that start
    together never load a half-written library (nvcc faked here: it
    writes its -o file)."""
    from sink_attention_tpu_torch.ops import _build

    outs = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            outs.append(out)
            assert out.endswith(".tmp") and not os.path.exists(
                out[:-len(".tmp")].rsplit(".", 1)[0] + ".so")
            with open(out, "wb") as f:
                f.write(b"lib")
            self.returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    paths = _build.build_all()
    assert len(outs) == len(_build.SOURCES)
    assert sorted(os.listdir(tmp_path)) == sorted(p.name
                                                  for p in paths.values())
    assert all(p.read_bytes() == b"lib" for p in paths.values())


@pytest.mark.parametrize("path", [
    "sink_attention_tpu_torch/parallel/mesh.py",
    "sink_attention_tpu_torch/parallel/tp.py",
    "sink_attention_tpu_torch/parallel/pp.py",
    "sink_attention_tpu_torch/parallel/train.py",
    "sink_attention_tpu_torch/serving/sharded.py",
    "tests/_torch_mesh_worker.py"])
def test_mesh_modules_import_no_jax(path):
    """The mesh, tensor- and pipeline-parallel modules, the sharded step
    and sharded serving, and the gloo ranks' worker of their tests import
    torch (and the port), nothing of JAX, flax or the JAX package."""
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and not node.level]
    assert "torch" in names or any(n.startswith("torch") for n in names)
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "flax", "sink_attention_tpu")], names


@pytest.mark.parametrize("package", ["parallel", "serving"])
def test_parallel_and_serving_export_every_jax_name(package):
    """The port's ``parallel`` and ``serving`` packages export every name
    of their JAX counterparts' ``__all__`` (read with ast), the mesh, the
    pipeline and sharded generation among them."""
    import importlib
    port = importlib.import_module(f"sink_attention_tpu_torch.{package}")
    jax_all = _jax_all(f"sink_attention_tpu/{package}/__init__.py")
    missing = [n for n in jax_all
               if n not in port.__all__ or not hasattr(port, n)]
    assert not missing, missing
    if package == "parallel":
        from sink_attention_tpu_torch.parallel import train
        assert {"param_shardings", "make_sharded_attn"} <= set(train.__all__)
        import inspect
        params = inspect.signature(train.make_train_step).parameters
        assert {"mesh", "fsdp", "remat", "accum_steps"} <= set(params)


def test_mesh_and_sharded_serving_default_to_the_card():
    """make_mesh and make_multihost_mesh take the card unless told
    otherwise and raise without CUDA; make_sharded_generate runs on its
    mesh's device and raises for a mesh on the card; over a mesh on the
    CPU (a gloo world of one) it generates greedy_generate's tokens."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    import numpy as np
    import torch.distributed as dist
    from sink_attention_tpu_torch.models import ModelConfig, init_params
    from sink_attention_tpu_torch.parallel import (Mesh, make_mesh,
                                                   make_multihost_mesh)
    from sink_attention_tpu_torch.serving import (greedy_generate,
                                                  make_sharded_generate)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh({"model": 1})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_multihost_mesh({"data": 1})
    cfg = ModelConfig.tiny()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_sharded_generate(cfg, Mesh(np.zeros(1, dtype=int),
                                            ("model",), "cuda"))
        mesh = make_mesh({"model": 1}, device="cpu")
        _, gen = make_sharded_generate(cfg, mesh, dtype=torch.float32)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        ids = torch.arange(8)[None] % cfg.vocab_size
        assert torch.equal(gen(params, ids, 3), greedy_generate(
            params, cfg, ids, 3, dtype=torch.float32, device="cpu"))
    finally:
        dist.destroy_process_group()


# JAX argument names the port renames, each with its reason: a shard_map
# axis name is a torch.distributed group (pipeline_forward's seq and model
# axes likewise); a jax.random key is a torch.Generator; the subprocess
# schedule names torch devices, not JAX platforms.
ARG_RENAMES = {"axis_name": "group", "seq_axis": "seq_group",
               "model_axis": "model_group", "key": "generator",
               "platforms": "devices"}


def _dropped_arg(name):
    """JAX arguments with no port counterpart: ``interpret`` (Pallas'
    interpret mode; the port's kernels run on the card, their plain
    versions on CPU tensors) and ``block_*`` (Pallas block sizes; the CUDA
    tiles are compile-time)."""
    return name == "interpret" or name.startswith("block_")


def _jax_signatures(path):
    """{name: argument names} of the functions and classes (``__init__``
    less self) in a JAX module's ``__all__``, read with ast."""
    tree = ast.parse((ROOT / path).read_text())
    names = next((ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign)
                  and any(getattr(t, "id", None) == "__all__"
                          for t in node.targets)), [])
    out = {}
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or (
                node.name not in names):
            continue
        fn, skip = node, 0
        if isinstance(node, ast.ClassDef):
            fn = next((b for b in node.body if isinstance(b, ast.FunctionDef)
                       and b.name == "__init__"), None)
            skip = 1
        if fn is None:
            continue
        a = fn.args
        out[node.name] = [x.arg for x in
                          a.posonlyargs + a.args + a.kwonlyargs][skip:]
    return out


def test_public_signatures_take_every_jax_argument():
    """Every function (and class) of a JAX ``__all__`` list that the port
    has takes each of the JAX function's argument names, by that name or
    by its rename in ARG_RENAMES, but for the Pallas-only arguments of
    _dropped_arg. The defaults are not compared:
    ``init_params`` defaults to fp32 in both."""
    import importlib
    import inspect
    checked, narrower = 0, []
    for path in sorted((ROOT / "sink_attention_tpu").rglob("*.py")):
        signatures = _jax_signatures(path.relative_to(ROOT))
        if not signatures:
            continue
        rel = path.relative_to(ROOT / "sink_attention_tpu").with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        module = importlib.import_module(
            ".".join(["sink_attention_tpu_torch", *parts]))
        for name, jax_args in signatures.items():
            obj = getattr(module, name, None)
            if obj is None:  # a name the port lacks: the export guards' job
                continue
            port = set(inspect.signature(obj).parameters)
            checked += 1
            for arg in jax_args:
                if _dropped_arg(arg):
                    continue
                if arg not in port and ARG_RENAMES.get(arg) not in port:
                    narrower.append(f"{module.__name__}.{name}: {arg}")
    assert checked >= 60, checked
    assert not narrower, narrower
