"""The port's golden protocol (scripts/golden_gpt_oss.py), its exporter
(scripts/export_random_hf_checkpoint.py) and chip_smoke's phase 10, on the
CPU: the tiny golden protocol at the JAX test's thresholds; the golden run
on an exported checkpoint with the plain-attention stack and with HF
eager as the baseline, and its refusal without transformers; the exporter
against the JAX exporter file by file, round-tripping through both
loaders; phase 10 rehearsed at tiny size; the new modules import no JAX and
no safetensors package, and ``models`` exports the loader's names."""

import ast
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sink_attention_tpu.models as jm
from sink_attention_tpu.models import hf_loader as jhf
from sink_attention_tpu_torch.models import (ModelConfig, forward_prefill,
                                             load_hf_checkpoint,
                                             params_from_jax)
from sink_attention_tpu_torch.ops import (eager_sink_attention,
                                          sink_flash_attention)
from sink_attention_tpu_torch.scripts import export_random_hf_checkpoint
from sink_attention_tpu_torch.scripts import golden_gpt_oss as golden
from sink_attention_tpu_torch.utils._safetensors import SafetensorsFile

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")


def _fa2_standin(q, k, v, num_sink, window_size, s_aux=None, **kw):
    return sink_flash_attention(q, k, v, num_sink=0,
                                window_size=q.shape[2], s_aux=None)


def test_golden_protocol_on_tiny_model():
    """tests/test_golden_gpt_oss.py's protocol on the port: the JAX
    model's fp32 weights, eager attention as ground truth, the kernel path
    close to it and the full-causal ablation far (the JAX thresholds)."""
    jcfg = jm.ModelConfig.tiny(sliding_window=32, num_sink_tokens=4)
    cfg = ModelConfig.tiny(sliding_window=32, num_sink_tokens=4)
    params = params_from_jax(jax.tree.map(np.asarray, jm.init_params(
        jcfg, jax.random.PRNGKey(0))), **CPU)
    ids = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 96)))
    eager = forward_prefill(params, cfg, ids,
                            attn_impl=eager_sink_attention)[0]
    ours = forward_prefill(params, cfg, ids)[0]
    ablation = forward_prefill(params, cfg, ids, attn_impl=_fa2_standin)[0]
    mk = golden._metrics(ours, eager)
    ma = golden._metrics(ablation, eager)
    assert mk["mean_abs"] < 1e-6, mk
    assert ma["mean_abs"] > 1e4 * mk["mean_abs"], (mk, ma)
    assert ma["mean_abs"] > 5e-3, ma
    assert mk["cos"] > ma["cos"]


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny_ckpt"))
    assert export_random_hf_checkpoint.main(["--out", path, "--tiny"]) == 0
    return path


def test_golden_run_plain_eager(tiny_ckpt, tmp_path):
    out = str(tmp_path / "GOLDEN.md")
    res = golden.run(tiny_ckpt, 2, 64, None, True, out, dtype="f32", **CPU)
    assert res["verdict"] and res["eager"] == "plain"
    assert res["kernel"]["mean_abs"] < 1e-6 < res["ablation"]["mean_abs"]
    assert "Verdict: PASS" in Path(out).read_text()


def test_golden_run_hf_eager(tiny_ckpt, tmp_path):
    """HF transformers' eager GptOss model reads the port's files and is the
    baseline: the kernel stack at fp32 agrees with it. (The exporter's
    config keeps the 20b's pad and EOS ids, outside the tiny vocabulary,
    which HF's embedding refuses: the copy here sets them inside.)"""
    pytest.importorskip("transformers")
    path = tmp_path / "ckpt"
    shutil.copytree(tiny_ckpt, path)
    cfg = json.loads((path / "config.json").read_text())
    cfg.update(pad_token_id=0, eos_token_id=1)
    (path / "config.json").write_text(json.dumps(cfg))
    res = golden.run(str(path), 1, 64, None, False, None, dtype="f32", **CPU)
    assert res["verdict"] and res["eager"] == "hf"
    assert res["kernel"]["max_abs"] < 5e-3 and res["kernel"]["cos"] > 0.9999


def test_golden_refuses_without_its_baseline(tiny_ckpt, monkeypatch):
    """Without transformers and without --skip-hf, no quiet change of what
    is measured: run raises and the script exits nonzero."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="skip_hf"):
        golden.run(tiny_ckpt, 1, 32, None, False, None, dtype="f32", **CPU)
    assert golden.main(["--model-path", tiny_ckpt, "--device", "cpu"]) == 2
    assert golden.main(["--model-path", tiny_ckpt + "-missing"]) == 0


def _jax_exporter():
    spec = importlib.util.spec_from_file_location(
        "jax_export_random_hf_checkpoint",
        ROOT / "scripts" / "export_random_hf_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exporter_matches_jax_and_round_trips(tiny_ckpt, tmp_path):
    """The port's --tiny export holds the JAX exporter's tensors bit for bit
    (same names, dtypes, shapes and seed), the same index and config, and
    loads through the port's loader to the JAX loader's tree of the JAX
    export."""
    pytest.importorskip("safetensors")
    pytest.importorskip("ml_dtypes")
    jexp = _jax_exporter()
    jdir = str(tmp_path / "jax")
    jexp.export(jdir, dict(jexp.GEOMETRIES["tiny"]), seed=0)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tiny_ckpt))
    for name in ("config.json", "model.safetensors.index.json"):
        with open(os.path.join(jdir, name)) as a, \
                open(os.path.join(tiny_ckpt, name)) as b:
            assert json.load(a) == json.load(b), name
    for shard in (f for f in os.listdir(jdir) if f.endswith(".safetensors")):
        with SafetensorsFile(os.path.join(jdir, shard)) as a, \
                SafetensorsFile(os.path.join(tiny_ckpt, shard)) as b:
            assert sorted(a.keys()) == sorted(b.keys())
            for key in a.keys():
                x, y = a.get_tensor(key), b.get_tensor(key)
                assert x.dtype == y.dtype == torch.bfloat16, key
                assert torch.equal(x.view(torch.int16),
                                   y.view(torch.int16)), key
                del x, y
    cfg, params = load_hf_checkpoint(tiny_ckpt, dtype=torch.float32, **CPU)
    _, jparams = jhf.load_hf_checkpoint(jdir, dtype=jnp.float32)
    assert cfg.num_layers == 2 and cfg.rope_scaling["rope_type"] == "yarn"
    leaves = jax.tree_util.tree_leaves_with_path(jparams)
    for path, j in leaves:
        node = params
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(j),
                                      err_msg=str(path))


def test_chip_smoke_checkpoint_phase_on_cpu():
    """Phase 10 at tiny size on the CPU: write, load (every dense leaf and
    the first, middle and last layers' experts held), serve with every
    admission's forward and the replay's decode checked per layer, resume
    exactly with requests in flight, the golden verdict with its kernel
    and ablation forwards checked per layer, the int4 load against
    post-hoc quantization and its engine row; no error."""
    cfg = ModelConfig.tiny(num_layers=3, intermediate_size=64,
                           vocab_size=128)
    rep, errors = chip_smoke.serve_checkpoint(
        cfg, "cpu", n_requests=5, max_batch=2, max_len=64, bucket=16,
        prompt=(4, 20), new=(3, 6), replay_steps=4, resume=(1, 1),
        golden=(2, 32), int4_row=dict(max_batch=2, prompt_len=8, max_len=64,
                                      bucket=16, chunk=4, warm=1, timed=1,
                                      profile_steps=2))
    assert errors == []
    assert rep["write"]["tensor_bytes"] == chip_smoke.checkpoint_bytes(cfg)
    assert rep["load"]["expert_layers_held"] == [0, 2]
    # 15 leaves a layer, gate_up and down of 2 layers, embed/head/norm
    assert rep["load"]["leaves_held"] == 3 * 15 + 2 * 2 + 3
    assert rep["engine"]["decode_layers_checked"] > 0
    assert rep["engine"]["prefill_layers_checked"] == 3 * 5
    assert rep["resume"]["in_flight"]["slots"] > 0
    assert rep["resume"]["mismatched"] == []
    assert len(rep["resume"]["pool_steps"]) == 3
    assert rep["golden"]["verdict"]
    for name in ("kernel", "ablation"):
        assert rep["golden"][f"golden_{name}_layers_checked"] == 3 * 2
    assert rep["int4_load"]["engine"]["tokens_ok"]


def test_mxfp4_decoders_of_chip_smoke_and_port_agree():
    """chip_smoke's own numpy decoder (its gate's reference) is the JAX
    decoder's copy: equal on random blocks under every scale code."""
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (256, 3, 16), dtype=np.uint8)
    scales = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    with np.errstate(over="ignore"):
        want = jhf.dequantize_mxfp4(blocks, scales)
    got = chip_smoke.mxfp4_decode_numpy(blocks, scales)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- guards ---------------------------------------------------------------

NEW_MODULES = ["sink_attention_tpu_torch/models/hf_loader.py",
               "sink_attention_tpu_torch/utils/_safetensors.py",
               "sink_attention_tpu_torch/utils/checkpoint.py",
               "sink_attention_tpu_torch/serving/engine.py",
               "sink_attention_tpu_torch/scripts/golden_gpt_oss.py",
               "sink_attention_tpu_torch/scripts/"
               "export_random_hf_checkpoint.py",
               "sink_attention_tpu_torch/scripts/spec_divergence.py",
               "chip_smoke.py"]


def _imports(path):
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and not node.level]
    return names


@pytest.mark.parametrize("path", NEW_MODULES)
def test_new_modules_import_no_jax_and_no_safetensors_package(path):
    """The loader, checkpointing, the engine, the two scripts and
    chip_smoke import nothing of JAX, flax or the JAX package, and not
    the safetensors, transformers-free paths' ml_dtypes or orbax (the
    card has none of them); transformers only inside the golden script's
    HF baseline."""
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & {"jax", "flax", "sink_attention_tpu", "safetensors",
                       "ml_dtypes", "orbax"}, (path, tops)
    if "transformers" in tops:
        assert path.endswith("golden_gpt_oss.py"), path


def test_models_exports_the_loader():
    """The JAX hf_loader's ``__all__`` names are the port's hf_loader's,
    and ``models`` exports the two the JAX ``models`` does."""
    from sink_attention_tpu_torch import models
    from sink_attention_tpu_torch.models import hf_loader

    tree = ast.parse((ROOT / "sink_attention_tpu/models/hf_loader.py")
                     .read_text())
    jax_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "__all__"
                           for t in node.targets))
    assert sorted(hf_loader.__all__) == sorted(jax_all)
    for name in ("params_from_hf_state_dict", "load_hf_checkpoint"):
        assert name in models.__all__ and getattr(models, name) is getattr(
            hf_loader, name)
