"""Parity of the port's w8a8 ops with the JAX package's Pallas kernels on the
CPU: the row quant, the weight quantization, and the plain versions of the
fused serving kernels (w8a8_matmul, w8a8_matmul3[_cat],
flash_attention_out_int8 with fp32 and with int8 QK^T scores, w8a8_mlp_res,
w8a8_mlp) against the JAX kernels run in interpret mode through
`force_tpu_kernels(True)`.

Tolerance of the fused ops: both sides compute the same int8 codes and the
same fp32 epilogue, except that a LayerNorm or attention row sum taken in
another order can move a value by an fp32 ulp and flip a code that sits on
a rounding tie; a flip moves an output by at most xs * s * 127 (one "flip
unit"). So every output must lie within 2 bf16 ulp + one flip unit of the
JAX kernel's, and almost all within 2 bf16 ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gava_clip_tpu.ops import flash_attention as jflash
from gava_clip_tpu.ops import int8_matmul as jim
from gava_clip_tpu.ops.activations import quick_gelu as jquick_gelu
from gava_clip_tpu.ops.linear import linear as jlinear
from gava_clip_tpu.ops.linear import mlp_block as jmlp_block
from gava_clip_tpu.ops.quant import quantize_weight as jquantize_weight
from gava_clip_tpu_torch.ops import flash_attention as tflash
from gava_clip_tpu_torch.ops import int8_matmul as tim
from gava_clip_tpu_torch.ops import linear as tlin
from gava_clip_tpu_torch.ops import quant as tquant
from gava_clip_tpu_torch.ops.activations import quick_gelu


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
    """Both sides' view of one int8 weight (heavy-tailed input rows)."""
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


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,gain", [(0, 1.0), (1, 1e-3), (2, 300.0)])
def test_quant_rows_codes_equal_jax(seed, gain):
    """The same fp32 rows give the same codes and scales bit for bit
    (multiply by the IEEE reciprocal, round half to even, no clip)."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(17, 77) * gain).astype(np.float32)
    x[3] = np.round(x[3] * 4) / 4          # values on rounding ties
    x[5] = 0.0                             # an all-zero row: xs = 1e-6/127
    codes_t, xs_t = tim.quant_rows(torch.from_numpy(x))
    codes_j, xs_j = jim._quant_rows(jnp.asarray(x))
    np.testing.assert_array_equal(codes_t.numpy().astype(np.int8),
                                  np.asarray(codes_j))
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))
    assert np.abs(codes_t.numpy()).max() <= 127


def test_quantize_weight_bit_equal_jax():
    rs = np.random.RandomState(3)
    w = rs.randn(48, 20).astype(np.float32)
    w[:, 4] = 0.0                          # a zero column: scale 1
    q_j, s_j = jquantize_weight(w)
    q_t, s_t = tquant.quantize_weight(torch.from_numpy(w))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), q_j)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    assert s_t[0, 4] == 1.0


def test_dequantize_tree():
    rs = np.random.RandomState(4)
    w = torch.from_numpy(rs.randn(16, 8).astype(np.float32))
    q, s = tquant.quantize_weight(w)
    tree = {"visual": {"patch_embed": {"kernel": w,
                                       "kernel_q8": {"qa": q, "scale": s}},
                       "blocks": [{"mlp": {"kernel": {"qa": q, "scale": s}}}]}}
    out = tquant.dequantize_tree(tree, torch.float32)
    assert set(out["visual"]["patch_embed"]) == {"kernel"}
    deq = out["visual"]["blocks"][0]["mlp"]["kernel"]
    torch.testing.assert_close(deq, q.float() * s)
    assert (deq - w).abs().max() <= s.max() / 2 + 1e-7


# ---------------------------------------------------------------------------
# the four fused ops: plain version vs JAX kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,pixels", [(37, 96, 77, True),
                                          (19, 64, 40, False)])
def test_w8a8_matmul_plain_matches_jax_kernel(forced_kernels, M, K, N,
                                              pixels):
    """No LayerNorm: the codes are equal, so only the fp32 epilogue's
    rounding order may differ (XLA may fuse an FMA): within one bf16 ulp."""
    rs = np.random.RandomState(5)
    x = rs.randint(0, 256, (M, K)) if pixels else rs.randn(M, K) * 3
    (qj, sj), (qt, st) = _qweight(rs, K, N)
    b = rs.randn(N) * 0.1
    out_j = jim.w8a8_matmul(_j(x, jnp.bfloat16), qj, sj, bias=_j(b))
    out_t = tim.w8a8_matmul(_t(x, torch.bfloat16), {"qa": qt, "scale": st},
                            _t(b))
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (M, N)
    a, r = _np(out_t), _np(out_j)
    assert np.all(np.abs(a - r) <= _bf16_ulp(np.maximum(abs(a), abs(r))))


@pytest.mark.parametrize("B,Lx,Le,K,N", [(2, 16, 8, 64, 40),
                                         (4, 8, 16, 32, 24)])
def test_w8a8_matmul3_cat_plain_matches_jax_kernel(forced_kernels, B, Lx,
                                                   Le, K, N):
    """Extras rows stitched per clip (the JAX kernel needs 8-row multiples
    and an even clip count; the port takes any, see the next test)."""
    rs = np.random.RandomState(6)
    x, e = rs.randn(B, Lx, K), rs.randn(B, Le, K)
    ws = [_qweight(rs, K, N) for _ in range(3)]
    bs = [rs.randn(N) * 0.02 for _ in range(3)]
    g, beta = 1 + rs.rand(K) * 4, rs.randn(K) * 0.1
    outs_j = jim.w8a8_matmul3_cat(
        _j(x, jnp.bfloat16), _j(e, jnp.bfloat16), [w[0][0] for w in ws],
        [w[0][1] for w in ws], bias3=[_j(v) for v in bs],
        ln=(_j(g), _j(beta)), clips_per_block=2)
    outs_t = tim.w8a8_matmul3_cat(
        _t(x, torch.bfloat16), _t(e, torch.bfloat16),
        [{"qa": w[1][0], "scale": w[1][1]} for w in ws], [_t(v) for v in bs],
        (_t(g), _t(beta)))
    kv = np.concatenate([x, e], axis=1)
    xs = tim.quant_rows(tim.ln_f32(_t(kv, torch.bfloat16).float(),
                                   _t(g), _t(beta)))[1]
    for o_t, o_j, w in zip(outs_t, outs_j, ws):
        assert o_t.shape == (B, Lx + Le, N)
        _assert_close(o_t, o_j, _unit(xs, w[1][1]))


@pytest.mark.parametrize("Le", [0, 5])
def test_w8a8_matmul3_ragged_matches_jax_kernel3(forced_kernels, Le):
    """Ragged rows (Lx = 13) against the one-source JAX kernel
    `_w8a8_kernel3` on the concatenated kv rows; Le = 0 is that kernel's
    own case (the promptless tower)."""
    rs = np.random.RandomState(7)
    B, Lx, K, N = 3, 13, 64, 24
    x = rs.randn(B, Lx, K)
    e = rs.randn(B, Le, K) if Le else None
    kv = x if e is None else np.concatenate([x, e], axis=1)
    ws = [_qweight(rs, K, N) for _ in range(3)]
    bs = [rs.randn(N) * 0.02 for _ in range(3)]
    g, beta = 1 + rs.rand(K) * 4, rs.randn(K) * 0.1
    outs_j = jim.w8a8_matmul3(
        _j(kv, jnp.bfloat16).reshape(-1, K), [w[0][0] for w in ws],
        [w[0][1] for w in ws], bias3=[_j(v) for v in bs],
        ln=(_j(g), _j(beta)))
    outs_t = tim.w8a8_matmul3_cat(
        _t(x, torch.bfloat16), None if e is None else _t(e, torch.bfloat16),
        [{"qa": w[1][0], "scale": w[1][1]} for w in ws], [_t(v) for v in bs],
        (_t(g), _t(beta)))
    xs = tim.quant_rows(tim.ln_f32(_t(kv, torch.bfloat16).float(),
                                   _t(g), _t(beta)))[1].reshape(-1, 1)
    for o_t, o_j, w in zip(outs_t, outs_j, ws):
        _assert_close(o_t.reshape(-1, N), o_j, _unit(xs, w[1][1]))


@pytest.mark.parametrize("B,lq,Lk,H,Dh", [(3, 13, 21, 2, 16),
                                          (2, 9, 14, 2, 64)])
def test_attention_out_int8_plain_matches_jax_kernel(forced_kernels, B, lq,
                                                     Lk, H, Dh):
    """q carries Lk rows (the full kv projection); the first lq are the
    queries. The attention output stays fp32 up to its row quant."""
    rs = np.random.RandomState(8)
    D = H * Dh
    q, k, v = (rs.randn(B, Lk, D) for _ in range(3))
    (qj, sj), (qt, st) = _qweight(rs, D, D)
    bias, res = rs.randn(D) * 0.02, rs.randn(B, lq, D)
    out_j = jflash.flash_attention_out_int8(
        _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16), H,
        {"kernel": {"qa": qj, "scale": sj}, "bias": _j(bias)},
        _j(res, jnp.bfloat16), lq=lq)
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    out_t = tflash.flash_attention_out_int8(
        tq, tk, tv, H, {"kernel": {"qa": qt, "scale": st},
                        "bias": _t(bias)}, _t(res, torch.bfloat16), lq=lq)
    assert out_t.shape == (B, lq, D) and out_t.dtype == torch.bfloat16
    xs = tim.quant_rows(tflash._onepass_attention_f32(tq[:, :lq], tk, tv,
                                                       H))[1]
    _assert_close(out_t, out_j, _unit(xs, st))


@pytest.mark.parametrize("M,K,Hd", [(37, 32, 64), (16, 48, 200)])
def test_w8a8_mlp_res_plain_matches_jax_kernel(forced_kernels, M, K, Hd):
    """The hidden stays fp32 through QuickGELU and its whole-row requant;
    a code flip in the first quant moves the hidden and may flip hidden
    codes, so the bound is two flip units of the second stage."""
    rs = np.random.RandomState(9)
    x = rs.randn(M, K)
    (q1j, s1j), (q1t, s1t) = _qweight(rs, K, Hd)
    (q2j, s2j), (q2t, s2t) = _qweight(rs, Hd, K)
    b1, b2 = rs.randn(Hd) * 0.02, rs.randn(K) * 0.02
    g, beta = 1 + rs.rand(K) * 4, rs.randn(K) * 0.1
    xj, xt = _j(x, jnp.bfloat16), _t(x, torch.bfloat16)
    out_j = jim.w8a8_mlp_res(
        xj, {"kernel": {"qa": q1j, "scale": s1j}, "bias": _j(b1)},
        {"kernel": {"qa": q2j, "scale": s2j}, "bias": _j(b2)},
        (_j(g), _j(beta)), xj)
    fc1 = {"kernel": {"qa": q1t, "scale": s1t}, "bias": _t(b1)}
    fc2 = {"kernel": {"qa": q2t, "scale": s2t}, "bias": _t(b2)}
    out_t = tim.w8a8_mlp_res(xt, fc1, fc2, (_t(g), _t(beta)), xt)
    codes, xs = tim.quant_rows(tim.ln_f32(xt.float(), _t(g), _t(beta)))
    h = tim.quick_gelu_f32(tim.rescale(tim.int_matmul(codes, q1t), xs, s1t,
                                       fc1["bias"]))
    _assert_close(out_t, out_j, 2 * _unit(tim.quant_rows(h)[1], s2t))


@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("M,K,Hd", [(37, 32, 64), (16, 48, 200)])
def test_w8a8_mlp_plain_matches_jax_kernel(forced_kernels, M, K, Hd,
                                           with_ln):
    """The residual-free form, with the LayerNorm and without it (the input
    rows are then quantized as they are: the first-stage codes are equal,
    only hidden codes on a tie can flip)."""
    rs = np.random.RandomState(12)
    x = rs.randn(M, K)
    (q1j, s1j), (q1t, s1t) = _qweight(rs, K, Hd)
    (q2j, s2j), (q2t, s2t) = _qweight(rs, Hd, K)
    b1, b2 = rs.randn(Hd) * 0.02, rs.randn(K) * 0.02
    g, beta = 1 + rs.rand(K) * 4, rs.randn(K) * 0.1
    xj, xt = _j(x, jnp.bfloat16), _t(x, torch.bfloat16)
    out_j = jim.w8a8_mlp(
        xj, {"kernel": {"qa": q1j, "scale": s1j}, "bias": _j(b1)},
        {"kernel": {"qa": q2j, "scale": s2j}, "bias": _j(b2)},
        ln=(_j(g), _j(beta)) if with_ln else None)
    fc1 = {"kernel": {"qa": q1t, "scale": s1t}, "bias": _t(b1)}
    fc2 = {"kernel": {"qa": q2t, "scale": s2t}, "bias": _t(b2)}
    ln = (_t(g), _t(beta)) if with_ln else None
    out_t = tim.w8a8_mlp(xt, fc1, fc2, ln)
    assert out_t.shape == (M, K) and out_t.dtype == torch.bfloat16
    x32 = tim.ln_f32(xt.float(), *ln) if with_ln else xt.float()
    codes, xs = tim.quant_rows(x32)
    if not with_ln:
        np.testing.assert_array_equal(
            codes.numpy().astype(np.int8),
            np.asarray(jim._quant_rows(xj.astype(jnp.float32))[0]))
    h = tim.quick_gelu_f32(tim.rescale(tim.int_matmul(codes, q1t), xs, s1t,
                                       fc1["bias"]))
    _assert_close(out_t, out_j, 2 * _unit(tim.quant_rows(h)[1], s2t))
    # the residual form is this plus the residual, rounded once
    res = tim.w8a8_mlp_res(xt, fc1, fc2, ln, xt) if with_ln else None
    if res is not None:
        y32 = tim._w8a8_mlp_f32(xt, fc1, fc2, ln)
        torch.testing.assert_close(res, (y32 + xt.float()).bfloat16(),
                                   rtol=0, atol=0)
        torch.testing.assert_close(out_t, y32.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("B,lq,Lk,H,Dh", [(3, 13, 21, 2, 16),
                                          (2, 9, 14, 2, 64)])
def test_attention_out_int8_qk_plain_matches_jax_kernel(forced_kernels, B,
                                                        lq, Lk, H, Dh):
    """The int8 QK^T form on both sides (`set_int8_qk`): per-row codes of
    each head's q / k slice, the integer score product (exact) and the
    rescale in the JAX kernel's order of multiplication give the same exp2
    argument up to exp2 itself; after that the path is the fp32-score one."""
    rs = np.random.RandomState(13)
    D = H * Dh
    q, k, v = (rs.randn(B, Lk, D) for _ in range(3))
    (qj, sj), (qt, st) = _qweight(rs, D, D)
    bias, res = rs.randn(D) * 0.02, rs.randn(B, lq, D)
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    top = {"kernel": {"qa": qt, "scale": st}, "bias": _t(bias)}
    tres = _t(res, torch.bfloat16)
    off_t = tflash.flash_attention_out_int8(tq, tk, tv, H, top, tres, lq=lq)
    jflash.set_int8_qk(True)
    tflash.set_int8_qk(True)
    try:
        assert tflash._INT8_QK
        out_j = jflash.flash_attention_out_int8(
            _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16), H,
            {"kernel": {"qa": qj, "scale": sj}, "bias": _j(bias)},
            _j(res, jnp.bfloat16), lq=lq)
        out_t = tflash.flash_attention_out_int8(tq, tk, tv, H, top, tres,
                                                lq=lq)
    finally:
        jflash.set_int8_qk(False)
        tflash.set_int8_qk(False)
    assert out_t.shape == (B, lq, D) and out_t.dtype == torch.bfloat16
    a32 = tflash._onepass_attention_den_f32(tq[:, :lq], tk, tv, H,
                                            int8_qk=True)[0]
    _assert_close(out_t, out_j, _unit(tim.quant_rows(a32)[1], st))
    # the switch changes the result, and is off again
    assert (out_t != off_t).any()
    torch.testing.assert_close(
        tflash.flash_attention_out_int8(tq, tk, tv, H, top, tres, lq=lq),
        off_t, rtol=0, atol=0)
    torch.testing.assert_close(
        tflash.attention_out_int8_plain(tq, tk, tv, H, top, tres, lq, True),
        out_t, rtol=0, atol=0)


def test_int8_qk_exp2_argument_bit_equal_jax():
    """The codes and the folded rescale, bit for bit: the same fp32 head
    slices through the JAX formula (ops/flash_attention.py, the int8_qk
    branch) and the port's."""
    rs = np.random.RandomState(14)
    qh = (rs.randn(2, 3, 9, 16) * 3).astype(np.float32)
    kh = (rs.randn(2, 3, 11, 16) * 0.02).astype(np.float32)
    kh[0, 0, 4] = 0.0                       # an all-zero key row: ks = 1e-6
    c = 16 ** -0.5 * 1.4426950408889634
    jq, jk = jnp.asarray(qh), jnp.asarray(kh)
    qs = jnp.maximum(jnp.max(jnp.abs(jq), axis=-1, keepdims=True), 1e-6)
    ks = jnp.maximum(jnp.max(jnp.abs(jk), axis=-1, keepdims=True), 1e-6)
    qq = jnp.round(jq * (127.0 / qs)).astype(jnp.int8)
    kq = jnp.round(jk * (127.0 / ks)).astype(jnp.int8)
    s32 = jnp.einsum("bhqd,bhkd->bhqk", qq.astype(jnp.int32),
                     kq.astype(jnp.int32))
    want = s32.astype(jnp.float32) * (qs * (c / (127.0 * 127.0))) \
        * jnp.swapaxes(ks, -1, -2)
    got = tflash._int8_qk_exp2_arg(torch.from_numpy(qh),
                                   torch.from_numpy(kh), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# dispatch through ops.linear
# ---------------------------------------------------------------------------

def test_linear_and_mlp_block_dispatch_w8a8(forced_kernels):
    rs = np.random.RandomState(10)
    K, Hd = 32, 64
    x = rs.randn(2, 7, K)
    (q1j, s1j), (q1t, s1t) = _qweight(rs, K, Hd)
    (q2j, s2j), (q2t, s2t) = _qweight(rs, Hd, K)
    b1, b2 = rs.randn(Hd) * 0.02, rs.randn(K) * 0.02
    jp = {"fc1": {"kernel": {"qa": q1j, "scale": s1j}, "bias": _j(b1)},
          "fc2": {"kernel": {"qa": q2j, "scale": s2j}, "bias": _j(b2)}}
    tp = {"fc1": {"kernel": {"qa": q1t, "scale": s1t}, "bias": _t(b1)},
          "fc2": {"kernel": {"qa": q2t, "scale": s2t}, "bias": _t(b2)}}
    xj, xt = _j(x, jnp.bfloat16), _t(x, torch.bfloat16)
    lin_t = tlin.linear(tp["fc1"], xt)
    lin_j = jlinear(jp["fc1"], xj)
    assert lin_t.shape == (2, 7, Hd)
    a, r = _np(lin_t), _np(lin_j)
    assert np.all(np.abs(a - r) <= _bf16_ulp(np.maximum(abs(a), abs(r))))
    ln = rs.rand(K) + 0.5, rs.randn(K) * 0.1
    out_t = tlin.mlp_block(tp, {"scale": _t(ln[0]), "bias": _t(ln[1])}, xt,
                           quick_gelu, residual=xt)
    out_j = jmlp_block(jp, {"scale": _j(ln[0]), "bias": _j(ln[1])}, xj,
                       jquick_gelu, residual=xj)
    assert out_t.shape == (2, 7, K)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=0.05)
    # the plain versions are the CPU path: impl='plain' is the same call
    torch.testing.assert_close(
        tlin.mlp_block(tp, {"scale": _t(ln[0]), "bias": _t(ln[1])}, xt,
                       quick_gelu, residual=xt, int8_impl="plain"), out_t,
        rtol=0, atol=0)
    # without a residual: the fused w8a8_mlp on both sides
    nores_t = tlin.mlp_block(tp, {"scale": _t(ln[0]), "bias": _t(ln[1])}, xt,
                             quick_gelu)
    nores_j = jmlp_block(jp, {"scale": _j(ln[0]), "bias": _j(ln[1])}, xj,
                         jquick_gelu)
    assert nores_t.shape == (2, 7, K) and nores_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(nores_t), _np(nores_j), atol=0.05)
    torch.testing.assert_close(
        nores_t, tim.w8a8_mlp(xt.reshape(-1, K), tp["fc1"], tp["fc2"],
                              (_t(ln[0]), _t(ln[1]))).reshape(2, 7, K),
        rtol=0, atol=0)


def test_cpu_runs_plain_versions_and_wrappers_need_cuda():
    rs = np.random.RandomState(11)
    _, (q, s) = _qweight(rs, 16, 8)
    kern = tim.with_kernel_layout({"qa": q, "scale": s})
    x = _t(rs.randn(4, 16), torch.bfloat16)
    tim.reset_launch_counts()
    tflash.reset_launch_counts()
    tim.w8a8_matmul(x, kern)
    assert set(tim.launch_counts.values()) == {0}
    with pytest.raises(ValueError, match="CUDA"):
        tim.w8a8_matmul_cuda(x, kern)
    with pytest.raises(ValueError, match="impl"):
        tim.w8a8_matmul(x.to("meta"), kern, impl="fast")
    op = {"kernel": {"qa": torch.zeros(128, 128, dtype=torch.int8),
                     "scale": torch.ones(1, 128)}, "bias": torch.zeros(128)}
    qkv = torch.zeros(1, 5, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.attention_out_int8_cuda(qkv, qkv, qkv, 2, op, qkv)
    fc = {"kernel": kern, "bias": torch.zeros(8)}
    with pytest.raises(ValueError, match="CUDA"):
        tim.w8a8_mlp_res_cuda(x, fc, fc, (torch.ones(16), torch.zeros(16)),
                              x)
    with pytest.raises(ValueError, match="CUDA"):
        tim.w8a8_mlp_cuda(x, fc, fc)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.attention_out_int8_cuda(qkv, qkv, qkv, 2, op, qkv,
                                       int8_qk=True)
    assert tflash.launch_counts["attention_out_int8"] == 0
    assert tflash.launch_counts["attention_out_int8_qk8"] == 0


def test_kernel_layout_is_cached_transpose():
    """The W^T the CUDA kernels read is made once per weight, where the
    tree is placed, and travels in the leaf as 'qa_t'; a leaf without it
    is refused by the wrappers' weight check."""
    w = torch.randint(-127, 128, (24, 40), dtype=torch.int8)
    wt = tim.kernel_layout(w)
    assert wt.shape == (40, 24) and wt.is_contiguous()
    assert torch.equal(wt, w.t())
    s = torch.ones(1, 40)
    tree = {"mlp": [{"kernel": {"qa": w, "scale": s}, "bias": s[0]}],
            "proj": s}
    out = tim.with_kernel_layout(tree)
    leaf = out["mlp"][0]["kernel"]
    assert set(leaf) == {"qa", "scale", "qa_t"} and leaf["qa"] is w
    assert torch.equal(leaf["qa_t"], w.t()) and leaf["qa_t"].is_contiguous()
    assert out["proj"] is s and "qa_t" not in tree["mlp"][0]["kernel"]
    assert tim._kernel_weight("t", leaf, 24, 40) is leaf["qa_t"]
    with pytest.raises(ValueError, match="qa_t"):
        tim._kernel_weight("t", {"qa": w, "scale": s}, 24)
    with pytest.raises(ValueError, match="W\\^T"):
        tim._kernel_weight("t", leaf, 40)


@pytest.mark.parametrize("kind,roadmap", [("q", "B9"), ("qt", "A9"),
                                          ("qa", "B5a")])
def test_unported_quantized_leaves_raise(kind, roadmap):
    """Only frozen-training 'qt' leaves (A9) still raise. Weight-only 'q'
    leaves (B9) run the w8 GEMM, and 'qa' leaves in an MLP block without a
    residual the fused w8a8_mlp (B5a): no NotImplementedError names them."""
    leaf = {"kernel": {kind: torch.zeros(4, 4, dtype=torch.int8),
                       "scale": torch.ones(1, 4)}, "bias": torch.zeros(4)}
    norm = {"scale": torch.ones(4), "bias": torch.zeros(4)}
    block = {"fc1": leaf, "fc2": leaf}
    x = torch.zeros(2, 4)
    if kind == "qt":
        with pytest.raises(NotImplementedError, match=roadmap):
            tlin.linear(leaf, x)
        with pytest.raises(NotImplementedError, match=roadmap):
            tlin.mlp_block(block, norm, x, quick_gelu, residual=x)
        return
    assert tlin.linear(leaf, x).shape == (2, 4)
    for residual in (None, x):
        out = tlin.mlp_block(block, norm, x, quick_gelu, residual=residual)
        assert out.shape == (2, 4) and torch.isfinite(out).all()


@pytest.mark.parametrize("int8_qk", [False, True])
@pytest.mark.parametrize("B,L1,L2,H,Dh", [(2, 29, 13, 4, 16),
                                          (3, 13, 5, 2, 64),
                                          (2, 16, 1, 2, 16)])
def test_attention_out_int8_2src_plain_matches_jax_kernel(forced_kernels, B,
                                                          L1, L2, H, Dh,
                                                          int8_qk):
    """The two-source form (JAX `flash_attention_out_int8_2src`, interpret
    mode) in both score forms: keys [k1; k2] from two arrays. Tolerance as
    for the single-source op (2 bf16 ulp + one flip unit). The port's plain
    version equals its single-source plain version on the concatenation bit
    for bit."""
    rs = np.random.RandomState(17)
    D = H * Dh
    q, k1, v1, res = (rs.randn(B, L1, D) for _ in range(4))
    k2, v2 = rs.randn(B, L2, D), rs.randn(B, L2, D)
    (qj, sj), (qt, st) = _qweight(rs, D, D)
    bias = rs.randn(D) * 0.02
    bf = jnp.bfloat16
    tq, tk1, tv1, tk2, tv2, tres = (_t(a, torch.bfloat16)
                                    for a in (q, k1, v1, k2, v2, res))
    top = {"kernel": {"qa": qt, "scale": st}, "bias": _t(bias)}
    jflash.set_int8_qk(int8_qk)
    tflash.set_int8_qk(int8_qk)
    try:
        out_j = jflash.flash_attention_out_int8_2src(
            _j(q, bf), _j(k1, bf), _j(v1, bf), _j(k2, bf), _j(v2, bf), H,
            {"kernel": {"qa": qj, "scale": sj}, "bias": _j(bias)},
            _j(res, bf))
        out_t = tflash.flash_attention_out_int8_2src(tq, tk1, tv1, tk2, tv2,
                                                     H, top, tres)
        one_t = tflash.flash_attention_out_int8(
            tq, torch.cat([tk1, tk2], dim=1), torch.cat([tv1, tv2], dim=1),
            H, top, tres)
    finally:
        jflash.set_int8_qk(False)
        tflash.set_int8_qk(False)
    assert out_t.shape == (B, L1, D) and out_t.dtype == torch.bfloat16
    assert torch.equal(out_t, one_t)
    a32 = tflash._onepass_attention_den_f32(
        tq, torch.cat([tk1, tk2], dim=1), torch.cat([tv1, tv2], dim=1), H,
        int8_qk=int8_qk)[0]
    _assert_close(out_t, out_j, _unit(tim.quant_rows(a32)[1], st))
    torch.testing.assert_close(
        tflash.attention_out_int8_2src_plain(tq, tk1, tv1, tk2, tv2, H, top,
                                             tres, int8_qk),
        out_t, rtol=0, atol=0)


def test_attention_out_int8_2src_wrapper_needs_cuda_and_640_keys():
    rs = np.random.RandomState(3)
    t = _t(rs.randn(1, 8, 128), torch.bfloat16)
    (_, _), (qt, st) = _qweight(rs, 128, 128)
    top = {"kernel": {"qa": qt, "scale": st}, "bias": _t(rs.randn(128))}
    with pytest.raises(ValueError, match="CUDA"):
        tflash.attention_out_int8_2src_cuda(t, t, t, t, t, 2, top, t)
    long = _t(rs.randn(1, 640, 128), torch.bfloat16)
    with pytest.raises(NotImplementedError, match="640"):
        tflash.flash_attention_out_int8_2src(t, t, t, long, long, 2, top, t)
    with pytest.raises(ValueError, match="impl"):
        tflash.flash_attention_out_int8_2src(
            t.to("meta"), t, t, t, t, 2, top, t, impl="fast")
