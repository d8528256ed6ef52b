"""The port's fused w8a8 serving ops at the full width of ViT-B/16 (K = N =
768, 12 heads), held against the JAX package's Pallas kernels run in
interpret mode on the CPU, for two frame rows: the LN + q/k/v kernel with
its extras rows (csrc/w8a8_qkv.cu, TPU `_w8a8_kernel3_cat`; the JAX kernel
takes rows in multiples of 8, so 200 + 16), the one-source form on the 197
+ 17 rows of the serving path (TPU `_w8a8_kernel3`), and the fused
attention + int8 out-projection (csrc/attention_out_int8.cu, TPU
`_attention_out_kernel`) at lq 197 over 214 keys, in both score forms.

The tolerance is the one of tests/test_torch_w8a8.py: both sides compute
the same int8 codes and fp32 epilogue, except where a LayerNorm or
attention sum taken in another order moves a value across a rounding tie of
its code; such a flip moves an output by at most xs * s * 127 (one "flip
unit"). Every output lies within 2 bf16 ulp + one flip unit of the JAX
kernel's, and almost all within 2 bf16 ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gava_clip_tpu.ops import flash_attention as jflash
from gava_clip_tpu.ops import int8_matmul as jim
from gava_clip_tpu.ops.quant import quantize_weight as jquantize_weight
from gava_clip_tpu_torch.ops import flash_attention as tflash
from gava_clip_tpu_torch.ops import int8_matmul as tim

_D, _HEADS = 768, 12


@pytest.fixture
def forced_kernels():
    """The JAX Pallas kernels in interpret mode; the flag is process-global
    (xdist runs other files in the same worker), so it is reset here."""
    jim.force_tpu_kernels(True)
    assert jim.kernels_active()
    yield
    jim.force_tpu_kernels(False)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _qweight(rs, K, N):
    """Both sides' view of one int8 weight (heavy-tailed input rows, as in
    real CLIP weights)."""
    w = rs.randn(K, N) * K ** -0.5
    w[rs.choice(K, max(1, K // 50), replace=False)] *= 16
    q, s = jquantize_weight(w)
    return (jnp.asarray(q), jnp.asarray(s)), (torch.from_numpy(q),
                                              torch.from_numpy(s))


def _assert_close(out_t, out_j, unit, far_share=0.05):
    a, b = _np(out_t), _np(out_j)
    assert a.shape == b.shape and np.isfinite(a).all()
    err = np.abs(a - b)
    two_ulp = 2 * _bf16_ulp(np.maximum(abs(a), abs(b)))
    assert np.all(err <= two_ulp + unit), (err - two_ulp - unit).max()
    assert (err > two_ulp).mean() <= far_share


def _unit(xs, scale):
    return _np(xs) * np.asarray(scale, np.float32).reshape(-1) * 127.0


def _qkv_inputs(rs, B, Lx, Le):
    x, e = rs.randn(B, Lx, _D), rs.randn(B, Le, _D)
    ws = [_qweight(rs, _D, _D) for _ in range(3)]
    bs = [rs.randn(_D) * 0.02 for _ in range(3)]
    # LayerNorm gain with 4% outlier channels, as the serving checks use
    g = np.ones(_D)
    g[rs.choice(_D, _D // 25, replace=False)] = 8.0
    return x, e, ws, bs, (g, rs.randn(_D) * 0.02)


def _qkv_port(x, e, ws, bs, ln):
    return tim.w8a8_matmul3_cat(
        _t(x, torch.bfloat16), _t(e, torch.bfloat16),
        [{"qa": w[1][0], "scale": w[1][1]} for w in ws], [_t(v) for v in bs],
        (_t(ln[0]), _t(ln[1])))


def _kv_scales(x, e, ln):
    kv = np.concatenate([x, e], axis=1)
    return tim.quant_rows(tim.ln_f32(_t(kv, torch.bfloat16).float(),
                                     _t(ln[0]), _t(ln[1])))[1]


def test_w8a8_matmul3_cat_full_width_matches_jax_kernel(forced_kernels):
    """(B 2, Lx 200, Le 16, K = N = 768): patch rows and extras rows
    stitched per clip, LN1, one shared quant, the three products."""
    rs = np.random.RandomState(20)
    x, e, ws, bs, ln = _qkv_inputs(rs, 2, 200, 16)
    outs_j = jim.w8a8_matmul3_cat(
        _j(x, jnp.bfloat16), _j(e, jnp.bfloat16), [w[0][0] for w in ws],
        [w[0][1] for w in ws], bias3=[_j(v) for v in bs],
        ln=(_j(ln[0]), _j(ln[1])), clips_per_block=2)
    outs_t = _qkv_port(x, e, ws, bs, ln)
    xs = _kv_scales(x, e, ln)
    for o_t, o_j, w in zip(outs_t, outs_j, ws):
        assert o_t.shape == (2, 216, _D) and o_t.dtype == torch.bfloat16
        _assert_close(o_t, o_j, _unit(xs, w[1][1]))


def test_w8a8_matmul3_serving_rows_match_jax_kernel3(forced_kernels):
    """The serving path's 197 patch rows + 17 extras rows per clip against
    the one-source JAX kernel `_w8a8_kernel3` on the concatenated rows."""
    rs = np.random.RandomState(21)
    x, e, ws, bs, ln = _qkv_inputs(rs, 2, 197, 17)
    kv = np.concatenate([x, e], axis=1)
    outs_j = jim.w8a8_matmul3(
        _j(kv, jnp.bfloat16).reshape(-1, _D), [w[0][0] for w in ws],
        [w[0][1] for w in ws], bias3=[_j(v) for v in bs],
        ln=(_j(ln[0]), _j(ln[1])))
    outs_t = _qkv_port(x, e, ws, bs, ln)
    xs = _kv_scales(x, e, ln).reshape(-1, 1)
    for o_t, o_j, w in zip(outs_t, outs_j, ws):
        _assert_close(o_t.reshape(-1, _D), o_j, _unit(xs, w[1][1]))


@pytest.mark.parametrize("int8_qk", [False, True])
def test_attention_out_int8_full_width_matches_jax_kernel(forced_kernels,
                                                          int8_qk):
    """(B 2, lq 197, Lk 214, 12 heads of 64): q carries all 214 kv rows,
    the first 197 are the queries; the fp32 attention row is quantized over
    its 768 values. With int8_qk both sides take the int8 score product."""
    rs = np.random.RandomState(22 + int8_qk)
    B, lq, Lk = 2, 197, 214
    q, k, v = (rs.randn(B, Lk, _D) for _ in range(3))
    (qj, sj), (qt, st) = _qweight(rs, _D, _D)
    bias, res = rs.randn(_D) * 0.02, rs.randn(B, lq, _D)
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    jflash.set_int8_qk(int8_qk)
    tflash.set_int8_qk(int8_qk)
    try:
        out_j = jflash.flash_attention_out_int8(
            _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
            _HEADS, {"kernel": {"qa": qj, "scale": sj}, "bias": _j(bias)},
            _j(res, jnp.bfloat16), lq=lq)
        out_t = tflash.flash_attention_out_int8(
            tq, tk, tv, _HEADS, {"kernel": {"qa": qt, "scale": st},
                                 "bias": _t(bias)},
            _t(res, torch.bfloat16), lq=lq)
    finally:
        jflash.set_int8_qk(False)
        tflash.set_int8_qk(False)
    assert out_t.shape == (B, lq, _D) and out_t.dtype == torch.bfloat16
    a32 = tflash._onepass_attention_den_f32(tq[:, :lq], tk, tv, _HEADS,
                                            int8_qk=int8_qk)[0]
    _assert_close(out_t, out_j, _unit(tim.quant_rows(a32)[1], st))
