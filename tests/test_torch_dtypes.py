"""fp32, bf16 and fp16 inputs: the port's attention against the JAX
package's, as the JAX tests run them (tests/test_flash_prefill.py's
``test_s_aux_and_dtypes`` shape and tolerance: its ``tol()``, fp32 2e-5,
bf16 2e-2, fp16 4e-3, with rtol 1e-2; the decode at tests/test_decode.py's
rtol 1e-3).

On the CPU the port runs the kernels' plain versions, which compute in
fp32 and return the input's dtype; the JAX kernels run in interpret mode
and compute in the input's dtype with fp32 accumulation. The same inputs
(drawn in fp32 with numpy and cast) go to both, in the forward with its
gradients, the packed path and the cached decode. The forward is held to
JAX's oracle (``eager_sink_attention``, what the JAX tests hold their
kernel to) at that tolerance, and to the JAX kernel at twice it: the JAX
kernel may itself lie the tolerance from the oracle (in bf16 it does, by
0.029 at one element of these inputs, where the port lies 0.001 from the
oracle). (On the card the kernels take the same three dtypes:
tests/test_torch_gpu.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cores  # noqa: F401 (shares the cores among workers)
from sink_attention_tpu.cache import SinkKVCache as JCache
from sink_attention_tpu.ops import flash as jflash
from sink_attention_tpu.ops import sink_decode_attention_cached as j_decode
from sink_attention_tpu.ops.packed import (
    sink_flash_attention_packed as j_packed)
from sink_attention_tpu.ops.reference import (
    eager_sink_attention as j_oracle)
from sink_attention_tpu_torch.cache import SinkKVCache as TCache
from sink_attention_tpu_torch.ops import decode as tdec
from sink_attention_tpu_torch.ops import flash, packed

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2),
          "float16": (jnp.float16, torch.float16, 4e-3)}
# gradients: JAX's CPU fp32 tolerance (tests/test_flash_backward.py); the
# 16-bit types round P and dS in the JAX kernels, so their forward
# tolerance relative to the gradient's largest value
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 4e-3}


def _inputs(seed, shapes, name):
    rs = np.random.RandomState(seed)
    jdt, tdt, _ = DTYPES[name]
    x = [rs.randn(*s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in x],
            [torch.from_numpy(a).to(tdt) for a in x])


def _close(got, ref, tol, what, rtol=1e-2):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=tol,
                               rtol=rtol, err_msg=what)


def _grad_close(got, ref, name, what):
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if name == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-2,
                                   err_msg=what)
        return
    err = np.abs(got - ref).max()
    assert err <= GRAD_TOL[name] * max(1.0, np.abs(ref).max()), (what, err)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_attention_and_grads_in_each_dtype(name):
    """The forward (s_aux x 2 as JAX's test) and the q, k, v gradients of
    sum(out * dO), each in the input dtype."""
    B, H_q, H_kv, N, D = 1, 4, 2, 256, 64
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        1, [(B, H_q, N, D), (B, H_kv, N, D), (B, H_kv, N, D),
            (B, H_q, N, D)], name)
    aux = np.random.RandomState(2).randn(H_q).astype(np.float32) * 2.0
    tol = DTYPES[name][2]

    def j_loss(q, k, v):
        out = jflash.sink_flash_attention(q, k, v, 4, 128,
                                          s_aux=jnp.asarray(aux))
        return (out.astype(jnp.float32) * jdo.astype(jnp.float32)).sum()

    j_out = jflash.sink_flash_attention(jq, jk, jv, 4, 128,
                                        s_aux=jnp.asarray(aux))
    j_ref = j_oracle(jq, jk, jv, 4, 128, s_aux=jnp.asarray(aux))
    j_grads = jax.grad(j_loss, (0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = flash.sink_flash_attention(*leaves, 4, 128,
                                     s_aux=torch.from_numpy(aux))
    assert out.dtype == DTYPES[name][1]
    (out.float() * tdo.float()).sum().backward()
    _close(out.detach(), j_ref, tol, f"{name} forward vs JAX's oracle")
    _close(out.detach(), j_out, 2 * tol, f"{name} forward vs JAX's kernel",
           rtol=2e-2)
    for nm, t, r in zip(("dq", "dk", "dv"), leaves, j_grads):
        assert t.grad.dtype == DTYPES[name][1]
        _grad_close(t.grad, r, name, f"{name} {nm}")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_packed_attention_in_each_dtype(name):
    """The packed forward and its q, k, v gradients on a pack of three
    segments, each in the input dtype."""
    B, H_q, H_kv, N, D = 1, 4, 2, 256, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, [(B, H_q, N, D), (B, H_kv, N, D), (B, H_kv, N, D)], name)
    pos = np.array([[p for L in (100, 30, 126) for p in range(L)]],
                   np.int32)
    tol = DTYPES[name][2]

    def j_fn(q, k, v):
        return j_packed(q, k, v, jnp.asarray(pos), 4, 64, block_q=64,
                        block_kv=64)

    j_out = jax.jit(j_fn)(jq, jk, jv)
    j_grads = jax.jit(jax.grad(
        lambda *a: (j_fn(*a).astype(jnp.float32) ** 2).sum(),
        (0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = packed.sink_flash_attention_packed(*leaves, torch.from_numpy(pos),
                                             4, 64)
    assert out.dtype == DTYPES[name][1]
    (out.float() ** 2).sum().backward()
    _close(out.detach(), j_out, tol, f"{name} packed forward")
    for nm, t, r in zip(("dq", "dk", "dv"), leaves, j_grads):
        _grad_close(t.grad, r, name, f"{name} packed {nm}")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_cached_decode_in_each_dtype(name):
    """One decode step over a wrapped sink cache stored in the dtype, GQA
    4:1 with s_aux (tests/test_decode.py's fp32 CPU tolerance, 1e-5, for
    fp32; the forward's for the 16-bit types)."""
    B, H_q, H_kv, n, D = 1, 8, 2, 150, 64
    (jq, jk, jv, jaux), (tq, tk, tv, taux) = _inputs(
        5, [(B, H_q, 1, D), (B, H_kv, n, D), (B, H_kv, n, D), (H_q,)], name)
    jdt, tdt, tol = DTYPES[name]
    jc = JCache.init(B, H_kv, D, num_sink=4, window_size=128, dtype=jdt)
    jc = jc.prefill(jk, jv)
    tc = TCache.init(B, H_kv, D, num_sink=4, window_size=128, dtype=tdt,
                     device="cpu")
    tc.prefill(tk, tv)
    o_j = j_decode(jq, jc, s_aux=jaux.astype(jnp.float32))
    o_t = tdec.sink_decode_attention_cached(tq, tc, s_aux=taux.float())
    assert o_t.dtype == tdt
    _close(o_t, o_j, 1e-5 if name == "float32" else tol, f"{name} decode",
           rtol=1e-3)
