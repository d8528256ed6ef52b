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

The `_f32` cases feed both sides fp32 rows (the kernels then emit fp32, as
the TPU kernels emit their input's dtype): B2 at the patch embed and the
text fc2, B3 / B3a, B4 (fp32 scores) and B5 / B5a. Their tolerance is the
fp32 one of tests/test_torch_int8_train.py `_check_fwd`: 2 "ulp" of 2^-21
of the output's largest value (sums in another order, ~1e-7 relative)
plus one flip unit, at most 5% of outputs beyond the 2 ulp.
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
    two_ulp = 2 * (2.0 ** -21 * np.abs(b).max()
                   if out_t.dtype == torch.float32
                   else _bf16_ulp(np.maximum(abs(a), abs(b))))
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


def _qkv_port(x, e, ws, bs, ln, dtype=torch.bfloat16):
    return tim.w8a8_matmul3_cat(
        _t(x, dtype), _t(e, dtype),
        [{"qa": w[1][0], "scale": w[1][1]} for w in ws], [_t(v) for v in bs],
        (_t(ln[0]), _t(ln[1])))


def _kv_scales(x, e, ln, dtype=torch.bfloat16):
    kv = np.concatenate([x, e], axis=1)
    return tim.quant_rows(tim.ln_f32(_t(kv, dtype).float(),
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


def _mlp_inputs(rs, M):
    """Rows (M, 768), the two MLP weights (768 -> 3072 -> 768), biases and
    LayerNorm params as tests/test_torch_w8a8.py draws them."""
    x = rs.randn(M, _D)
    w1, w2 = _qweight(rs, _D, 4 * _D), _qweight(rs, 4 * _D, _D)
    b1, b2 = rs.randn(4 * _D) * 0.02, rs.randn(_D) * 0.02
    return x, w1, w2, b1, b2, (1 + rs.rand(_D) * 4, rs.randn(_D) * 0.1)


def _mlp_leaves(w1, w2, b1, b2):
    """(JAX fc1, fc2), (port fc1, fc2)."""
    return tuple(
        tuple({"kernel": {"qa": w[side][0], "scale": w[side][1]},
               "bias": conv(b)} for w, b in ((w1, b1), (w2, b2)))
        for side, conv in ((0, _j), (1, _t)))


def _hidden_unit(xt, fc1, fc2, ln):
    """Two flip units of the second stage (the hidden's codes): a code flip
    in the first quant moves the hidden and may flip hidden codes."""
    x32 = xt.float() if ln is None else tim.ln_f32(xt.float(), *ln)
    codes, xs = tim.quant_rows(x32)
    k1 = fc1["kernel"]
    h = tim.quick_gelu_f32(tim.rescale(tim.int_matmul(codes, k1["qa"]), xs,
                                       k1["scale"], fc1["bias"]))
    return 2 * _unit(tim.quant_rows(h)[1], fc2["kernel"]["scale"])


def test_w8a8_mlp_res_full_width_matches_jax_kernel(forced_kernels):
    """B5 at two frame rows (the JAX kernel takes rows in multiples of 8:
    200 + 16), K 768 -> 3072 -> 768 with LN2: a row's requant runs over all
    3,072 hidden values."""
    rs = np.random.RandomState(24)
    x, w1, w2, b1, b2, ln = _mlp_inputs(rs, 216)
    (j1, j2), (t1, t2) = _mlp_leaves(w1, w2, b1, b2)
    xj, xt = _j(x, jnp.bfloat16), _t(x, torch.bfloat16)
    out_j = jim.w8a8_mlp_res(xj, j1, j2, (_j(ln[0]), _j(ln[1])), xj)
    lnt = (_t(ln[0]), _t(ln[1]))
    out_t = tim.w8a8_mlp_res(xt, t1, t2, lnt, xt)
    assert out_t.shape == (216, _D) and out_t.dtype == torch.bfloat16
    _assert_close(out_t, out_j, _hidden_unit(xt, t1, t2, lnt))


@pytest.mark.parametrize("with_ln", [True, False])
def test_w8a8_mlp_full_width_matches_jax_kernel(forced_kernels, with_ln):
    """B5a, the residual-free form, at the same widths, with the LayerNorm
    and without it (the input rows are then quantized as they are)."""
    rs = np.random.RandomState(25)
    x, w1, w2, b1, b2, ln = _mlp_inputs(rs, 216)
    (j1, j2), (t1, t2) = _mlp_leaves(w1, w2, b1, b2)
    out_j = jim.w8a8_mlp(_j(x, jnp.bfloat16), j1, j2,
                         ln=(_j(ln[0]), _j(ln[1])) if with_ln else None)
    xt = _t(x, torch.bfloat16)
    lnt = (_t(ln[0]), _t(ln[1])) if with_ln else None
    out_t = tim.w8a8_mlp(xt, t1, t2, lnt)
    assert out_t.shape == (216, _D) and out_t.dtype == torch.bfloat16
    _assert_close(out_t, out_j, _hidden_unit(xt, t1, t2, lnt))


def test_w8a8_matmul_patch_embed_width_matches_jax_kernel(forced_kernels):
    """B2 at the patch embed's K = N = 768 over two frame rows of 196
    patches of raw pixels: no LayerNorm, so the codes are equal and only
    the fp32 epilogue's rounding order may differ: within one bf16 ulp."""
    rs = np.random.RandomState(26)
    x = rs.randint(0, 256, (2 * 196, _D))
    (qj, sj), (qt, st) = _qweight(rs, _D, _D)
    b = rs.randn(_D) * 0.1
    out_j = jim.w8a8_matmul(_j(x, jnp.bfloat16), qj, sj, bias=_j(b))
    out_t = tim.w8a8_matmul(_t(x, torch.bfloat16), {"qa": qt, "scale": st},
                            _t(b))
    assert out_t.shape == (2 * 196, _D) and out_t.dtype == torch.bfloat16
    a, r = _np(out_t), _np(out_j)
    assert np.all(np.abs(a - r) <= _bf16_ulp(np.maximum(abs(a), abs(r))))


def test_w8a8_matmul_text_tower_shape_matches_jax_kernel(forced_kernels):
    """B2 at the w8a8 text tower's fc2 (one prompt of 77 tokens, K = 2,048,
    N = 512): normal activations in rows longer than the 1,024 values a
    warp holds in registers. No LayerNorm, so the codes are equal and only
    the fp32 epilogue's rounding order may differ: within one bf16 ulp."""
    rs = np.random.RandomState(27)
    x = rs.randn(77, 2048)
    (qj, sj), (qt, st) = _qweight(rs, 2048, 512)
    b = rs.randn(512) * 0.1
    out_j = jim.w8a8_matmul(_j(x, jnp.bfloat16), qj, sj, bias=_j(b))
    out_t = tim.w8a8_matmul(_t(x, torch.bfloat16), {"qa": qt, "scale": st},
                            _t(b))
    assert out_t.shape == (77, 512) and out_t.dtype == torch.bfloat16
    a, r = _np(out_t), _np(out_j)
    assert np.all(np.abs(a - r) <= _bf16_ulp(np.maximum(abs(a), abs(r))))


@pytest.mark.parametrize("int8_qk", [False, True])
def test_attention_out_int8_2src_full_width_matches_jax_kernel(
        forced_kernels, int8_qk):
    """B12 at 12 heads: lq 197 queries over 197 + 17 keys from two sources,
    in both score forms; equal to the one-source plain version on [k1; k2]
    bit for bit."""
    rs = np.random.RandomState(27 + int8_qk)
    B, L1, L2 = 2, 197, 17
    q, k1, v1, res = (rs.randn(B, L1, _D) for _ in range(4))
    k2, v2 = rs.randn(B, L2, _D), rs.randn(B, L2, _D)
    (qj, sj), (qt, st) = _qweight(rs, _D, _D)
    bias = rs.randn(_D) * 0.02
    bf = jnp.bfloat16
    tq, tk1, tv1, tk2, tv2, tres = (_t(a, torch.bfloat16)
                                    for a in (q, k1, v1, k2, v2, res))
    top = {"kernel": {"qa": qt, "scale": st}, "bias": _t(bias)}
    jflash.set_int8_qk(int8_qk)
    tflash.set_int8_qk(int8_qk)
    try:
        out_j = jflash.flash_attention_out_int8_2src(
            _j(q, bf), _j(k1, bf), _j(v1, bf), _j(k2, bf), _j(v2, bf),
            _HEADS, {"kernel": {"qa": qj, "scale": sj}, "bias": _j(bias)},
            _j(res, bf))
        out_t = tflash.flash_attention_out_int8_2src(
            tq, tk1, tv1, tk2, tv2, _HEADS, top, tres)
    finally:
        jflash.set_int8_qk(False)
        tflash.set_int8_qk(False)
    assert out_t.shape == (B, L1, _D) and out_t.dtype == torch.bfloat16
    kc, vc = torch.cat([tk1, tk2], dim=1), torch.cat([tv1, tv2], dim=1)
    torch.testing.assert_close(
        tflash.attention_out_int8_plain(tq, kc, vc, _HEADS, top, tres,
                                        None, int8_qk),
        out_t, rtol=0, atol=0)
    a32 = tflash._onepass_attention_den_f32(tq, kc, vc, _HEADS,
                                            int8_qk=int8_qk)[0]
    _assert_close(out_t, out_j, _unit(tim.quant_rows(a32)[1], st))


# ---------------------------------------------------------------------------
# the fp32 forms: fp32 rows in, fp32 out, on both sides
# ---------------------------------------------------------------------------

def test_w8a8_matmul3_cat_full_width_matches_jax_kernel_f32(forced_kernels):
    """B3 in fp32: (B 2, Lx 200, Le 16, K = N = 768), LN1, one shared quant,
    three fp32 outputs."""
    rs = np.random.RandomState(30)
    x, e, ws, bs, ln = _qkv_inputs(rs, 2, 200, 16)
    outs_j = jim.w8a8_matmul3_cat(
        _j(x), _j(e), [w[0][0] for w in ws], [w[0][1] for w in ws],
        bias3=[_j(v) for v in bs], ln=(_j(ln[0]), _j(ln[1])),
        clips_per_block=2)
    outs_t = _qkv_port(x, e, ws, bs, ln, torch.float32)
    xs = _kv_scales(x, e, ln, torch.float32)
    for o_t, o_j, w in zip(outs_t, outs_j, ws):
        assert o_t.shape == (2, 216, _D) and o_t.dtype == torch.float32
        assert o_j.dtype == jnp.float32
        _assert_close(o_t, o_j, _unit(xs, w[1][1]))


def test_w8a8_matmul3_serving_rows_match_jax_kernel3_f32(forced_kernels):
    """B3a in fp32: the 197 + 17 rows of a frame row, twice, against the
    one-source JAX kernel with LN1 (the q/k/v of an fp32 `--int8_frozen`
    step)."""
    rs = np.random.RandomState(31)
    x, e, ws, bs, ln = _qkv_inputs(rs, 2, 197, 17)
    kv = np.concatenate([x, e], axis=1).reshape(-1, _D)
    outs_j = jim.w8a8_matmul3(
        _j(kv), [w[0][0] for w in ws], [w[0][1] for w in ws],
        bias3=[_j(v) for v in bs], ln=(_j(ln[0]), _j(ln[1])))
    outs_t = tim.w8a8_matmul3(
        _t(kv), [{"qa": w[1][0], "scale": w[1][1]} for w in ws],
        [_t(v) for v in bs], (_t(ln[0]), _t(ln[1])))
    xs = _kv_scales(x, e, ln, torch.float32).reshape(-1, 1)
    for o_t, o_j, w in zip(outs_t, outs_j, ws):
        assert o_t.dtype == torch.float32
        _assert_close(o_t, o_j, _unit(xs, w[1][1]))


def test_attention_out_int8_full_width_matches_jax_kernel_f32(
        forced_kernels):
    """B4 in fp32 (fp32 scores, the form that has an fp32 kernel): lq 197
    over 214 keys at 12 heads, fp32 q/k/v and residual, fp32 out."""
    rs = np.random.RandomState(32)
    B, lq, Lk = 2, 197, 214
    q, k, v = (rs.randn(B, Lk, _D) for _ in range(3))
    (qj, sj), (qt, st) = _qweight(rs, _D, _D)
    bias, res = rs.randn(_D) * 0.02, rs.randn(B, lq, _D)
    tq, tk, tv = (_t(a) for a in (q, k, v))
    out_j = jflash.flash_attention_out_int8(
        _j(q), _j(k), _j(v), _HEADS,
        {"kernel": {"qa": qj, "scale": sj}, "bias": _j(bias)}, _j(res),
        lq=lq)
    out_t = tflash.flash_attention_out_int8(
        tq, tk, tv, _HEADS, {"kernel": {"qa": qt, "scale": st},
                             "bias": _t(bias)}, _t(res), lq=lq)
    assert out_t.shape == (B, lq, _D) and out_t.dtype == torch.float32
    assert out_j.dtype == jnp.float32
    a32 = tflash._onepass_attention_den_f32(tq[:, :lq], tk, tv, _HEADS)[0]
    _assert_close(out_t, out_j, _unit(tim.quant_rows(a32)[1], st))


def test_w8a8_mlp_res_full_width_matches_jax_kernel_f32(forced_kernels):
    """B5 in fp32: 216 rows, 768 -> 3072 -> 768 with LN2 and the fp32
    residual added to the fp32 value (nothing rounded to bf16)."""
    rs = np.random.RandomState(33)
    x, w1, w2, b1, b2, ln = _mlp_inputs(rs, 216)
    (j1, j2), (t1, t2) = _mlp_leaves(w1, w2, b1, b2)
    r = rs.randn(216, _D)
    out_j = jim.w8a8_mlp_res(_j(x), j1, j2, (_j(ln[0]), _j(ln[1])), _j(r))
    lnt = (_t(ln[0]), _t(ln[1]))
    xt = _t(x)
    out_t = tim.w8a8_mlp_res(xt, t1, t2, lnt, _t(r))
    assert out_t.shape == (216, _D) and out_t.dtype == torch.float32
    assert out_j.dtype == jnp.float32
    _assert_close(out_t, out_j, _hidden_unit(xt, t1, t2, lnt))


@pytest.mark.parametrize("with_ln", [True, False])
def test_w8a8_mlp_full_width_matches_jax_kernel_f32(forced_kernels,
                                                    with_ln):
    """B5a in fp32, with the LayerNorm and without it."""
    rs = np.random.RandomState(34)
    x, w1, w2, b1, b2, ln = _mlp_inputs(rs, 216)
    (j1, j2), (t1, t2) = _mlp_leaves(w1, w2, b1, b2)
    out_j = jim.w8a8_mlp(_j(x), j1, j2,
                         ln=(_j(ln[0]), _j(ln[1])) if with_ln else None)
    xt = _t(x)
    lnt = (_t(ln[0]), _t(ln[1])) if with_ln else None
    out_t = tim.w8a8_mlp(xt, t1, t2, lnt)
    assert out_t.shape == (216, _D) and out_t.dtype == torch.float32
    _assert_close(out_t, out_j, _hidden_unit(xt, t1, t2, lnt))


@pytest.mark.parametrize("M,K,N,pixels", [(2 * 196, _D, _D, True),
                                          (77, 2048, 512, False)],
                         ids=["patch_embed", "text_fc2"])
def test_w8a8_matmul_matches_jax_kernel_f32(forced_kernels, M, K, N, pixels):
    """B2 in fp32 at the patch embed (raw pixels, 768 x 768) and the text
    tower's fc2 (K 2,048 > 1,024): no LayerNorm, so the codes are equal and
    only the order of the epilogue's roundings may differ."""
    rs = np.random.RandomState(35 + pixels)
    x = rs.randint(0, 256, (M, K)) if pixels else rs.randn(M, K)
    (qj, sj), (qt, st) = _qweight(rs, K, N)
    b = rs.randn(N) * 0.1
    out_j = jim.w8a8_matmul(_j(x), qj, sj, bias=_j(b))
    out_t = tim.w8a8_matmul(_t(x), {"qa": qt, "scale": st}, _t(b))
    assert out_t.shape == (M, N) and out_t.dtype == torch.float32
    assert out_j.dtype == jnp.float32
    _assert_close(out_t, out_j, 0.0, far_share=0.0)
