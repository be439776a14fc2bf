"""The port's HF checkpoint loader (models/hf_loader.py), from_hf_config and
safetensors reader/writer against the JAX package's, on the CPU: the MXFP4
decoder bit for bit over every byte and scale code, from_hf_config field by
field for the four families, params_from_hf_state_dict leaf by leaf (fp32,
int8, int4) on the JAX MXFP4 test's state dict, a dense qwen2 and a tied
one, the streaming quantized load against post-hoc quantization, the
safetensors package reading and writing the port's files both ways, the
loaded tree's logits against JAX's, and HF eager parity.

One JAX load and one JAX prefill are shared by the tests that need them
(the JAX prefill runs its Pallas kernels in interpret mode)."""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sink_attention_tpu.models as jm
from sink_attention_tpu.models import hf_loader as jhf
from sink_attention_tpu_torch.models import (ModelConfig, forward_prefill,
                                             load_hf_checkpoint,
                                             params_from_hf_state_dict,
                                             quantize_weight,
                                             quantize_weight_int4)
from sink_attention_tpu_torch.models.hf_loader import dequantize_mxfp4
from sink_attention_tpu_torch.utils import _safetensors

CPU = dict(device="cpu")
LOGIT_TOL = 1e-4  # fp32 logits of the same model (the JAX model tests')


def _rand_mxfp4(rng, prefix_shape, in_features, scale_span=(121, 132)):
    """Random blocks/scales in the released layout (tests/test_hf_mxfp4)."""
    g = in_features // 32
    blocks = rng.randint(0, 256, size=(*prefix_shape, g, 16)).astype(
        np.uint8)
    scales = rng.randint(*scale_span, size=(*prefix_shape, g)).astype(
        np.uint8)
    return blocks, scales


def _mxfp4_state_dict(seed=0, tied=False):
    """tests/test_hf_mxfp4.py's tiny GptOss state dict (MXFP4 experts), and
    its dequantized twin; ``tied`` drops the lm_head."""
    cfg = ModelConfig.tiny()
    rng = np.random.RandomState(seed)
    H, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    HQ, HKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    V = cfg.vocab_size

    def w(*shape, scale=0.15):
        return (rng.randn(*shape) * scale).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, H),
          "model.norm.weight": np.ones(H, np.float32),
          "lm_head.weight": w(V, H)}
    dense = {}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd[pre + "self_attn.q_proj.weight"] = w(HQ * D, H)
        sd[pre + "self_attn.q_proj.bias"] = w(HQ * D)
        sd[pre + "self_attn.k_proj.weight"] = w(HKV * D, H)
        sd[pre + "self_attn.k_proj.bias"] = w(HKV * D)
        sd[pre + "self_attn.v_proj.weight"] = w(HKV * D, H)
        sd[pre + "self_attn.v_proj.bias"] = w(HKV * D)
        sd[pre + "self_attn.o_proj.weight"] = w(H, HQ * D)
        sd[pre + "self_attn.o_proj.bias"] = w(H)
        sd[pre + "self_attn.sinks"] = w(HQ, scale=1.0)
        sd[pre + "mlp.router.weight"] = w(E, H)
        sd[pre + "mlp.router.bias"] = w(E)
        gu_b, gu_s = _rand_mxfp4(rng, (E, 2 * I), H)
        dn_b, dn_s = _rand_mxfp4(rng, (E, H), I)
        sd[pre + "mlp.experts.gate_up_proj_blocks"] = gu_b
        sd[pre + "mlp.experts.gate_up_proj_scales"] = gu_s
        sd[pre + "mlp.experts.down_proj_blocks"] = dn_b
        sd[pre + "mlp.experts.down_proj_scales"] = dn_s
        sd[pre + "mlp.experts.gate_up_proj_bias"] = w(E, 2 * I)
        sd[pre + "mlp.experts.down_proj_bias"] = w(E, H)
        sd[pre + "input_layernorm.weight"] = np.ones(H, np.float32)
        sd[pre + "post_attention_layernorm.weight"] = np.ones(H, np.float32)
        dense[pre + "mlp.experts.gate_up_proj"] = np.swapaxes(
            jhf.dequantize_mxfp4(gu_b, gu_s), 1, 2)
        dense[pre + "mlp.experts.down_proj"] = np.swapaxes(
            jhf.dequantize_mxfp4(dn_b, dn_s), 1, 2)
    if tied:
        del sd["lm_head.weight"]
    sd_dense = {k: v for k, v in sd.items()
                if not (k.endswith("_blocks") or k.endswith("_scales"))}
    sd_dense.update(dense)
    return cfg, sd, sd_dense


def _qwen2_state_dict(seed=1):
    """A tiny dense-family (Qwen2) state dict: qkv biases, no o bias."""
    cfg = ModelConfig.qwen2_tiny()
    rng = np.random.RandomState(seed)
    H, I = cfg.hidden_size, cfg.intermediate_size
    HQ, HKV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(*shape):
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, H),
          "model.norm.weight": 1.0 + w(H),
          "lm_head.weight": w(cfg.vocab_size, H)}
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        sd.update({
            pre + "self_attn.q_proj.weight": w(HQ * D, H),
            pre + "self_attn.q_proj.bias": w(HQ * D),
            pre + "self_attn.k_proj.weight": w(HKV * D, H),
            pre + "self_attn.k_proj.bias": w(HKV * D),
            pre + "self_attn.v_proj.weight": w(HKV * D, H),
            pre + "self_attn.v_proj.bias": w(HKV * D),
            pre + "self_attn.o_proj.weight": w(H, HQ * D),
            pre + "mlp.gate_proj.weight": w(I, H),
            pre + "mlp.up_proj.weight": w(I, H),
            pre + "mlp.down_proj.weight": w(H, I),
            pre + "input_layernorm.weight": 1.0 + w(H),
            pre + "post_attention_layernorm.weight": 1.0 + w(H),
        })
    return cfg, sd


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _bits(x):
    """The bit pattern of a leaf: a port tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_trees_bitwise(tt, jt):
    """Same paths, dtypes and shapes; every leaf equal bit for bit."""
    t_leaves, j_leaves = dict(_leaves(tt)), dict(_leaves(jt))
    assert sorted(t_leaves) == sorted(j_leaves)
    for path, j in j_leaves.items():
        t = t_leaves[path]
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
        a, b = _bits(t), _bits(j)
        assert a.dtype.itemsize == b.dtype.itemsize, path
        np.testing.assert_array_equal(a.view(b.dtype), b, err_msg=path)


def _hf_config(cfg):
    """A GptOss config.json of ``cfg`` (tests/test_hf_mxfp4.py's)."""
    return {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim,
            "intermediate_size": cfg.intermediate_size,
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.experts_per_tok,
            "sliding_window": cfg.sliding_window,
            "layer_types": list(cfg.layer_types),
            "rope_theta": cfg.rope_theta, "rope_scaling": cfg.rope_scaling,
            "rms_norm_eps": cfg.rms_norm_eps,
            "attention_bias": cfg.attention_bias,
            "max_position_embeddings": cfg.max_position_embeddings}


def _write_dir(path, cfg, sd, save_file, n_shards=2):
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(_hf_config(cfg), f)
    names = sorted(sd)
    per = -(-len(names) // n_shards)
    for s in range(n_shards):
        save_file({k: sd[k] for k in names[s * per:(s + 1) * per]},
                  os.path.join(path, f"model-{s:05d}-of-"
                               f"{n_shards:05d}.safetensors"))


# -- dequantize_mxfp4 --------------------------------------------------------


def test_dequantize_every_byte_under_every_scale_code_bit_for_bit():
    """All 256 bytes under each of the 256 e8m0 codes, the subnormal
    (code 0) and overflowing (codes 254, 255) ends included."""
    blocks = np.tile(np.arange(256, dtype=np.uint8).reshape(1, 16, 16),
                     (256, 1, 1))
    scales = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 16, axis=1)
    with np.errstate(over="ignore"):
        want = jhf.dequantize_mxfp4(blocks, scales)
    got = dequantize_mxfp4(torch.from_numpy(blocks), torch.from_numpy(scales))
    assert got.dtype == torch.float32 and got.shape == (256, 512)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert np.isinf(want).any() and (want[0] != 0).any()


def test_dequantize_random_expert_stack_bit_for_bit():
    blocks, scales = _rand_mxfp4(np.random.RandomState(0), (3, 8), 128)
    want = jhf.dequantize_mxfp4(blocks, scales)
    got = dequantize_mxfp4(blocks, scales)   # numpy in, as JAX's takes
    assert got.shape == (3, 8, 128)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    with pytest.raises(ValueError):
        dequantize_mxfp4(blocks.astype(np.int8), scales)
    with pytest.raises(ValueError):
        dequantize_mxfp4(blocks, scales[..., :1])


# -- from_hf_config -----------------------------------------------------------


_HF_CONFIGS = {
    "gpt_oss": dict(model_type="gpt_oss", **_hf_config(ModelConfig.tiny(
        rope_scaling={"rope_type": "yarn", "factor": 32.0}))),
    "qwen2": dict(model_type="qwen2", vocab_size=256, hidden_size=64,
                  num_hidden_layers=4, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=96,
                  sliding_window=32, max_position_embeddings=2048,
                  rope_theta=1e6, rms_norm_eps=1e-6),
    "qwen2_sliding": dict(model_type="qwen2", vocab_size=256,
                          hidden_size=64, num_hidden_layers=4,
                          num_attention_heads=4, num_key_value_heads=2,
                          intermediate_size=96, sliding_window=32,
                          use_sliding_window=True, max_window_layers=2,
                          max_position_embeddings=2048),
    "llama": dict(model_type="llama", vocab_size=256, hidden_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=4, intermediate_size=96,
                  attention_bias=True, max_position_embeddings=4096,
                  rope_scaling={"rope_type": "llama3", "factor": 8.0}),
    "mistral": dict(model_type="mistral", vocab_size=256, hidden_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, intermediate_size=96,
                    sliding_window=None, max_position_embeddings=4096),
    "mistral_sliding": dict(model_type="mistral", vocab_size=256,
                            hidden_size=64, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            head_dim=32, intermediate_size=96,
                            sliding_window=64,
                            max_position_embeddings=4096),
}


@pytest.mark.parametrize("as_object", [False, True])
@pytest.mark.parametrize("family", sorted(_HF_CONFIGS))
def test_from_hf_config_matches_jax_field_by_field(family, as_object):
    hf = _HF_CONFIGS[family]
    src = types.SimpleNamespace(**hf) if as_object else dict(hf)
    got = dataclasses.asdict(ModelConfig.from_hf_config(src))
    want = dataclasses.asdict(jm.ModelConfig.from_hf_config(
        types.SimpleNamespace(**hf) if as_object else dict(hf)))
    assert got == want
    if family.endswith("sliding"):
        assert "sliding_attention" in got["layer_types"]


# -- params_from_hf_state_dict ------------------------------------------------


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_state_dict_mxfp4_matches_jax_bit_for_bit(quant):
    cfg, sd, _ = _mxfp4_state_dict()
    jcfg = jm.ModelConfig.tiny()
    want = jm.params_from_hf_state_dict(dict(sd), jcfg, dtype=jnp.float32,
                                        quant=quant)
    got = params_from_hf_state_dict(dict(sd), cfg, dtype=torch.float32,
                                    quant=quant, **CPU)
    _assert_trees_bitwise(got, want)


def test_state_dict_consumed_and_twin_equal():
    """The state dict is consumed (the tied embedding aside), torch tensors
    are taken as numpy arrays are, and the MXFP4 load equals its
    dequantized twin's."""
    cfg, sd, sd_dense = _mxfp4_state_dict(seed=2)
    sd_t = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = params_from_hf_state_dict(sd_t, cfg, **CPU)
    assert list(sd_t) == ["model.embed_tokens.weight"]
    twin = dict(_leaves(params_from_hf_state_dict(dict(sd_dense), cfg,
                                                  **CPU)))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(twin)
    for path, t in twin.items():
        assert torch.equal(got[path], t), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_dense_family_and_tied_match_jax(dtype):
    """A dense qwen2 state dict (qkv biases, no o bias, gated-SiLU MLP)
    and a tied-embedding GptOss one, in fp32 and bf16."""
    for cfg, jcfg, sd in (
            (*(c.qwen2_tiny() for c in (ModelConfig, jm.ModelConfig)),
             _qwen2_state_dict()[1]),
            (ModelConfig.tiny(), jm.ModelConfig.tiny(),
             _mxfp4_state_dict(tied=True)[1])):
        want = jm.params_from_hf_state_dict(dict(sd), jcfg,
                                            dtype=getattr(jnp, dtype))
        got = params_from_hf_state_dict(dict(sd), cfg,
                                        dtype=getattr(torch, dtype), **CPU)
        _assert_trees_bitwise(got, want)


def test_entry_points_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    cfg, sd, _ = _mxfp4_state_dict()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_hf_state_dict(dict(sd), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_hf_checkpoint("/nonexistent")
    with pytest.raises(ValueError, match="quant"):
        params_from_hf_state_dict(dict(sd), cfg, quant="int2", **CPU)


# -- checkpoint directories ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A two-shard MXFP4 checkpoint written by ``safetensors.numpy``, its
    JAX fp32 load and that tree's prefill logits (shared: the JAX prefill
    is the slow part)."""
    st = pytest.importorskip("safetensors.numpy")
    path = str(tmp_path_factory.mktemp("mxfp4"))
    cfg, sd, _ = _mxfp4_state_dict()
    _write_dir(path, cfg, sd, st.save_file)
    jcfg, jparams = jhf.load_hf_checkpoint(path, dtype=jnp.float32)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 24))
    jlogits = np.asarray(jm.forward_prefill(jparams, jcfg,
                                            jnp.asarray(ids))[0])
    return path, cfg, jparams, ids, jlogits


def test_load_dir_written_by_safetensors_matches_jax(jax_dir):
    path, cfg0, jparams, ids, jlogits = jax_dir
    cfg, params = load_hf_checkpoint(path, dtype=torch.float32, **CPU)
    assert cfg == cfg0
    _assert_trees_bitwise(params, jparams)
    logits, _ = forward_prefill(params, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=LOGIT_TOL,
                               rtol=0)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_streaming_quantized_load_equals_post_hoc(jax_dir, quant):
    """The counterpart of test_load_checkpoint_dir_quantized: every weight
    quantized as it streams equals quantization of the dense load, and the
    embedding and lm_head stay int8 under int4."""
    path = jax_dir[0]
    _, qp = load_hf_checkpoint(path, dtype=torch.float32, quant=quant,
                               **CPU)
    _, dp = load_hf_checkpoint(path, dtype=torch.float32, **CPU)
    requant = quantize_weight_int4 if quant == "int4" else quantize_weight
    for li in range(2):
        for got, dense in ((qp["layers"][li]["attn"]["wq"],
                            dp["layers"][li]["attn"]["wq"]),
                           (qp["layers"][li]["mlp"]["gate_up"],
                            dp["layers"][li]["mlp"]["gate_up"]),
                           (qp["layers"][li]["mlp"]["down"],
                            dp["layers"][li]["mlp"]["down"])):
            want = requant(dense, contract_axis=-2)
            assert sorted(got) == sorted(want)
            for k in got:
                assert torch.equal(got[k], want[k]), (li, k)
    for name, axis in (("lm_head", -2), ("embed", -1)):
        want = quantize_weight(dp[name], contract_axis=axis)
        assert sorted(qp[name]) == ["q", "s"]
        assert torch.equal(qp[name]["q"], want["q"])
        assert torch.equal(qp[name]["s"], want["s"])


def test_port_writer_read_by_safetensors_and_back(tmp_path):
    """The port's writer, read by ``safetensors.safe_open`` unchanged, and
    the package's file read by the port's reader unchanged: bf16, f16,
    f32, u8, i8, i32, i64, a scalar and an empty tensor."""
    safetensors = pytest.importorskip("safetensors")
    from safetensors.torch import save_file as st_save
    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "b.f16": torch.randn(7, generator=g).half(),
        "c.f32": torch.randn(2, 3, 4, generator=g),
        "d.u8": torch.randint(0, 256, (4, 16), generator=g,
                              dtype=torch.uint8),
        "e.i8": torch.randint(-128, 128, (9,), generator=g,
                              dtype=torch.int8),
        "f.i32": torch.randint(-2**31, 2**31 - 1, (3,), generator=g,
                               dtype=torch.int32),
        "g.i64": torch.tensor([2**40, -5]),
        "h.scalar": torch.tensor(1.5),
        "i.empty": torch.zeros(0, 3),
    }
    mine = str(tmp_path / "mine.safetensors")
    _safetensors.save_file(tensors, mine, metadata={"format": "pt"})
    with safetensors.safe_open(mine, framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors)
        assert f.metadata() == {"format": "pt"}
        for name, t in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype and got.shape == t.shape, name
            assert torch.equal(got, t), name
    theirs = str(tmp_path / "theirs.safetensors")
    st_save(tensors, theirs, metadata={"format": "pt"})
    with _safetensors.SafetensorsFile(theirs) as f:
        assert sorted(f.keys()) == sorted(tensors)
        assert f.metadata == {"format": "pt"}
        for name, t in tensors.items():
            got = f.get_tensor(name)
            assert got.dtype == t.dtype and got.shape == t.shape, name
            assert torch.equal(got, t), name
            del got
            f.release(name)
    header, meta, start = _safetensors.read_header(theirs)
    assert start % 8 == 0 and meta == {"format": "pt"}
    assert sorted(header) == sorted(tensors)


def test_hf_eager_logits_parity_with_mxfp4_weights():
    """An HF GptOss model holding the exact dequantization of MXFP4 data
    gives the logits of the port's tree loaded from the packed form (the
    JAX test's bounds)."""
    transformers = pytest.importorskip("transformers")
    cfg, sd_mx, sd_dense = _mxfp4_state_dict(seed=3)
    hf_cfg = transformers.GptOssConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        intermediate_size=cfg.intermediate_size,
        num_local_experts=cfg.num_experts,
        num_experts_per_tok=cfg.experts_per_tok,
        sliding_window=cfg.sliding_window, layer_types=list(cfg.layer_types),
        rope_theta=cfg.rope_theta, rope_scaling=cfg.rope_scaling,
        attention_bias=cfg.attention_bias,
        max_position_embeddings=cfg.max_position_embeddings,
        tie_word_embeddings=False, attn_implementation="eager")
    hf_model = transformers.GptOssForCausalLM(hf_cfg).eval()
    hf_model.load_state_dict({k: torch.tensor(v)
                              for k, v in sd_dense.items()})
    params = params_from_hf_state_dict(sd_mx, cfg, **CPU)
    ids = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 48))
    with torch.no_grad():
        hf_logits = hf_model(torch.tensor(ids)).logits.numpy()
        logits = forward_prefill(params, cfg, torch.from_numpy(ids))[0]
    logits = logits.numpy()
    diff = np.abs(logits - hf_logits).max()
    cos = (logits.ravel() @ hf_logits.ravel()
           / (np.linalg.norm(logits) * np.linalg.norm(hf_logits) + 1e-9))
    assert diff < 5e-3 and cos > 0.9999, (diff, cos)


def test_reader_holds_about_one_tensor(tmp_path):
    """The sharded reader unmaps each tensor once the next is read: reading
    eight 32 MB tensors in turn raises the resident set by about one of
    them, not by the file."""
    path = str(tmp_path / "big.safetensors")
    n = 32 << 20
    _safetensors.save_file({f"t{i}": torch.full((n,), i, dtype=torch.uint8)
                            for i in range(8)}, path)

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    from sink_attention_tpu_torch.models.hf_loader import _ShardedStateDict
    with _safetensors.SafetensorsFile(path) as f:
        sd = _ShardedStateDict([f])
        start, peak = rss(), 0
        for i in range(8):
            x = sd.pop(f"t{i}")
            assert int(x[-1]) == i     # touches every page of the view
            assert int(x.sum()) == i * n
            del x
            peak = max(peak, rss() - start)
        sd.release()
    assert peak < 3 * n, peak
