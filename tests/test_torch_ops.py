"""Parity of the PyTorch port's ops with the JAX package on the CPU.

Inputs are drawn with numpy from a seed and fed to both sides. The JAX
packed attention runs its Pallas kernel in interpret mode, as the JAX
package's own tests run it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gava_clip_tpu.ops import activations as jact
from gava_clip_tpu.ops import attention as jattn
from gava_clip_tpu.ops import flash_attention as jflash
from gava_clip_tpu.ops import norm as jnorm
from gava_clip_tpu.ops.linear import linear as jlinear
from gava_clip_tpu.ops.linear import mlp_block as jmlp_block
from gava_clip_tpu_torch.ops import _cuda
from gava_clip_tpu_torch.ops import activations as tact
from gava_clip_tpu_torch.ops import attention as tattn
from gava_clip_tpu_torch.ops import flash_attention as tflash
from gava_clip_tpu_torch.ops import linear as tlin
from gava_clip_tpu_torch.ops import norm as tnorm
from tests.test_torch_bounds import module_deadline  # noqa: F401

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DTYPE[dtype])
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _linear_params(rs, din, dout):
    k, b = rs.randn(din, dout) * din ** -0.5, rs.randn(dout) * 0.1
    jp = {"kernel": jnp.asarray(k, jnp.float32),
          "bias": jnp.asarray(b, jnp.float32)}
    tp = {"kernel": torch.tensor(k, dtype=torch.float32),
          "bias": torch.tensor(b, dtype=torch.float32)}
    return jp, tp


def _attn_params(rs, d):
    pairs = {n: _linear_params(rs, d, d) for n in ("q", "k", "v", "out")}
    return ({n: p[0] for n, p in pairs.items()},
            {n: p[1] for n, p in pairs.items()})


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def test_quick_gelu():
    x = np.random.RandomState(0).randn(4, 33) * 3
    j, t = _both(x)
    np.testing.assert_allclose(_np(tact.quick_gelu(t)),
                               _np(jact.quick_gelu(j)), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    # the fp32 island: bf16 inputs normalise in fp32 and round once, so the
    # two sides are at most one bf16 ulp apart (fp32 noise at a tie)
    rs = np.random.RandomState(1)
    x, s, b = rs.randn(3, 5, 48) * 2 + 1, rs.randn(48), rs.randn(48)
    jx, tx = _both(x, dtype)
    out_t = tnorm.layer_norm(tx, torch.tensor(s), torch.tensor(b))
    out_j = jnorm.layer_norm(jx, jnp.asarray(s), jnp.asarray(b))
    assert out_t.dtype == TORCH_DTYPE[dtype]
    a, b = _np(out_t), _np(out_j)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=1e-5)
    else:
        assert np.all(np.abs(a - b) <= _bf16_ulp(np.maximum(abs(a), abs(b))))


def test_linear_and_mlp_block():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 7, 24)
    j1, t1 = _linear_params(rs, 24, 48)
    j2, t2 = _linear_params(rs, 48, 24)
    jx, tx = _both(x)
    np.testing.assert_allclose(_np(tlin.linear(t1, tx)),
                               _np(jlinear(j1, jx)), atol=1e-5)
    ln = rs.randn(24), rs.randn(24)
    jn = {"scale": jnp.asarray(ln[0]), "bias": jnp.asarray(ln[1])}
    tn = {"scale": torch.tensor(ln[0]), "bias": torch.tensor(ln[1])}
    out_j = jmlp_block({"fc1": j1, "fc2": j2}, jn, jx, jact.quick_gelu,
                       residual=jx)
    out_t = tlin.mlp_block({"fc1": t1, "fc2": t2}, tn, tx, tact.quick_gelu,
                           residual=tx)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=1e-5)


def test_linear_rejects_quantized_leaf():
    """w8a8 'qa', weight-only 'q' and frozen-training 'qt' leaves are
    ported, and an unknown leaf is refused. A 'qt' leaf is the w8a8 linear
    of its plain math: per-row scale xs = absmax / 127, codes rint(x / xs),
    exact integer products rescaled by xs and the channel scales, + bias;
    its dx is g @ (values * scales)^T (bit for bit: fp32 products of the
    same values), and the frozen leaf gets no gradient."""
    rs = np.random.RandomState(3)
    q = torch.from_numpy(rs.randint(-127, 128, (24, 16)).astype(np.int8))
    scale = torch.from_numpy(rs.rand(1, 16).astype(np.float32)) * 1e-2
    bias = torch.from_numpy(rs.randn(16).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rs.randn(3, 5, 24).astype(np.float32))
    x.requires_grad_()
    out = tlin.linear({"kernel": {"qt": q, "scale": scale}, "bias": bias}, x)
    xs = x.detach().abs().amax(-1, keepdim=True) * np.float32(1 / 127)
    codes = torch.round(x.detach() * torch.reciprocal(xs))
    want = (codes.double() @ q.double()).float() * xs * scale[0] + bias
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    g = torch.from_numpy(rs.randn(3, 5, 16).astype(np.float32))
    out.backward(g)
    assert torch.equal(x.grad, g @ (q.float() * scale).t())
    assert bias.grad is None
    with pytest.raises(TypeError, match="unknown kernel leaf"):
        tlin.linear({"kernel": {"w4": torch.zeros(4, 4)}}, torch.zeros(2, 4))
    for kind in ("qa", "q", "qt"):
        q = {"kernel": {kind: torch.ones(4, 4, dtype=torch.int8),
                        "scale": torch.ones(1, 4)}}
        out = tlin.linear(q, torch.ones(2, 4))
        assert out.shape == (2, 4)
        torch.testing.assert_close(out, torch.full((2, 4), 4.0))


def _qkv(seed, B=3, Lq=13, Lk=21, D=32, q_gain=1.0):
    rs = np.random.RandomState(seed)
    return rs.randn(B, Lq, D) * q_gain, rs.randn(B, Lk, D), rs.randn(B, Lk, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_attention_plain_matches_jax_kernel(dtype):
    # ragged: Lq != Lk, neither a multiple of 8 (the JAX kernel pads to 8)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in _qkv(3))
    out_t = tflash.packed_attention_plain(tq, tk, tv, 2)
    out_j = jflash.flash_attention(jq, jk, jv, 2)
    assert out_t.dtype == TORCH_DTYPE[dtype] and out_t.shape == (3, 13, 32)
    a, b = _np(out_t), _np(out_j)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=1e-5)
    else:
        # both round e to bf16 before the sums and round the output once:
        # at most one bf16 ulp apart (fp32 summation order)
        assert np.all(np.abs(a - b) <= _bf16_ulp(np.maximum(abs(a), abs(b))))


def test_packed_attention_clamp_regime():
    """Scaled scores far above 110: both sides saturate at the clamp, and
    so differ from a standard softmax — the port keeps the clamp."""
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in _qkv(4, q_gain=30.0))
    c = 16 ** -0.5 * 1.4426950408889634
    s = np.einsum("bqhd,bkhd->bhqk", _np(tq).reshape(3, 13, 2, 16),
                  _np(tk).reshape(3, 21, 2, 16))
    assert (s * c).max() > 110.0
    out_t = tflash.packed_attention_plain(tq, tk, tv, 2)
    np.testing.assert_allclose(_np(out_t),
                               _np(jflash.flash_attention(jq, jk, jv, 2)),
                               atol=1e-4)
    ref = tflash._reference_attention(tq, tk, tv, 2)
    assert np.abs(_np(out_t) - _np(ref)).max() > 1e-3
    assert np.isfinite(_np(out_t)).all()


def test_reference_attention_matches_jax():
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in _qkv(5))
    np.testing.assert_allclose(
        _np(tflash._reference_attention(tq, tk, tv, 2)),
        _np(jflash._reference_attention(jq, jk, jv, 2)), atol=1e-5)
    # below the clamp the one-pass form equals the standard softmax
    np.testing.assert_allclose(
        _np(tflash.packed_attention_plain(tq, tk, tv, 2)),
        _np(tflash._reference_attention(tq, tk, tv, 2)), atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2 ** -7)])
def test_multi_head_attention(impl, dtype, tol):
    # bf16: every product rounds to bf16 at the same places on both sides,
    # but fp32 accumulation order differs, which can flip a rounding: the
    # bound is one bf16 ulp at the output's magnitude (|out| < 2)
    rs = np.random.RandomState(6)
    jp, tp = _attn_params(rs, 32)
    xq, xkv = rs.randn(2, 11, 32), rs.randn(2, 19, 32)
    (jq, tq), (jkv, tkv) = _both(xq, dtype), _both(xkv, dtype)
    out_j = jattn.multi_head_attention(jp, jq, jkv, jkv, 2, impl=impl)
    out_t = tattn.multi_head_attention(tp, tq, tkv, tkv, 2, impl=impl)
    assert out_t.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=tol)


def test_causal_plain_attention():
    (jq, tq), (jk, tk), (jv, tv) = (_both(a) for a in _qkv(7, Lk=13))
    np.testing.assert_allclose(
        _np(tattn.attention_core(tq, tk, tv, 2, causal=True)),
        _np(jattn.attention_core(jq, jk, jv, 2, causal=True)), atol=1e-5)
    np.testing.assert_allclose(
        _np(tflash._reference_attention(tq, tk, tv, 2, causal=True)),
        _np(jflash._reference_attention(jq, jk, jv, 2, causal=True)),
        atol=1e-5)


def test_flash_attention_dispatch():
    q = torch.zeros(1, 5, 32)
    tflash.reset_launch_counts()
    tflash.flash_attention(q, q, q, 2)            # CPU: plain version
    assert tflash.launch_counts["packed_attention"] == 0
    # causal or more than 640 keys: the streaming path (its plain version
    # here), no longer a NotImplementedError
    causal = tflash.flash_attention(q, q, q, 2, causal=True)
    assert causal.shape == q.shape and torch.isfinite(causal).all()
    long_k = torch.zeros(1, 641, 32)
    assert tflash.flash_attention(q, long_k, long_k, 2).shape == q.shape
    assert set(tflash.launch_counts.values()) == {0}
    # the kernel wrapper never falls back to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        tflash.packed_attention_cuda(q, q, q, 2)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.load_library("packed_attention")
