"""The training attention of the PyTorch port on the CPU: the plain
versions of the denominator-emitting forward, the saved-residual backward
and the streaming forward / backward against the JAX Pallas kernels
(interpret mode, as tests/test_flash_attention.py runs them), and the
autograd Functions against jax.grad.

Inputs are drawn with numpy from a seed and fed to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from gava_clip_tpu.ops import flash_attention as jflash
from gava_clip_tpu_torch.ops import attention as tattn
from gava_clip_tpu_torch.ops import flash_attention as tflash
from tests.test_torch_bounds import module_deadline  # noqa: F401

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# what one flipped bf16 rounding may move: both sides round e, ds and
# do * inv_d to bf16 at the same points, and differ in the order of their
# fp32 sums and in exp2 (XLA's vs PyTorch's, ~1e-7 relative): an element
# next to a rounding boundary flips by one ulp (2^-8 relative)
BF16_FLIP = 2.0 ** -7


def _both(a, dtype="float32"):
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TORCH_DTYPE[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))      # a writable copy


def _qkvdo(seed, B, Lq, Lk, H, Dh, dtype, gain=1.0):
    rs = np.random.RandomState(seed)
    shapes = ((B, Lq), (B, Lk), (B, Lk), (B, Lq))
    pairs = [_both(gain * rs.randn(b, l, H * Dh), dtype) for b, l in shapes]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _close(got, want, dtype, what, fp32_atol=2e-5):
    """fp32: the algorithm (sum order and exp2 only). bf16: the same plus
    flipped roundings, each worth 2^-8 of a term; gradients sum up to a few
    hundred terms, so the bound scales with the tensor's largest value."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=fp32_atol, rtol=1e-4,
                                   err_msg=what)
    else:
        tol = BF16_FLIP * max(np.abs(want).max(), 1e-3)
        assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(),
                                                 tol)
        # and most elements agree to the bit
        assert (got != want).mean() < 0.05, (what, (got != want).mean())


PACKED_CASES = [  # (B, Lq, Lk, H, Dh): Lq = Lk, Lq < Lk, ragged, Lq > Lk,
    # and the kernels' head width (the fp32 and bf16 CUDA forms take Dh 64)
    (2, 16, 16, 2, 16), (2, 13, 21, 2, 32), (1, 37, 50, 3, 16),
    (2, 24, 9, 2, 16), (1, 19, 30, 2, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_den_plain_matches_pallas(case, dtype):
    B, Lq, Lk, H, Dh = case
    (jq, jk, jv, _), (tq, tk, tv, _) = _qkvdo(0, *case, dtype)
    o_j, den_j = jflash._packed_forward(jq, jk, jv, H, want_denom=True)
    o_t, den_t = tflash.packed_attention_den_plain(tq, tk, tv, H)
    assert o_t.dtype == TORCH_DTYPE[dtype] and den_t.dtype == torch.float32
    assert den_t.shape == (B, Lq, H)
    _close(o_t, o_j, dtype, "out")
    # den is a sum of e in v's dtype: fp32 sum order (and, in bf16, a flip
    # of one e among Lk) only
    np.testing.assert_allclose(_np(den_t), _np(den_j), rtol=2e-3
                               if dtype == "bfloat16" else 1e-5)
    # the forward that writes no denominators is the same function
    assert torch.equal(o_t, tflash.packed_attention_plain(tq, tk, tv, H))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_bwd_plain_matches_pallas(case, dtype):
    """The explicit backward formula against `_packed_backward`, both fed
    the JAX forward's residuals."""
    B, Lq, Lk, H, Dh = case
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qkvdo(1, *case, dtype)
    o_j, den_j = jflash._packed_forward(jq, jk, jv, H, want_denom=True)
    g_j = jflash._packed_backward(jq, jk, jv, jdo, o_j, den_j, H)
    o_t = torch.from_numpy(_np(o_j)).to(TORCH_DTYPE[dtype])
    den_t = torch.from_numpy(_np(den_j))
    g_t = tflash.packed_attention_bwd_plain(tq, tk, tv, tdo, o_t, den_t, H)
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        assert a.dtype == TORCH_DTYPE[dtype]
        _close(a, b, dtype, name)


@pytest.mark.parametrize("case", [(2, 13, 21, 2, 32), (1, 20, 20, 2, 16)])
def test_packed_autograd_matches_jax_grad(case):
    """torch.autograd through `flash_attention` against jax.grad of the
    JAX `flash_attention` (its custom VJP, interpret mode), fp32."""
    B, Lq, Lk, H, Dh = case
    (jq, jk, jv, _), (tq, tk, tv, _) = _qkvdo(2, *case, "float32")
    g_j = jax.grad(lambda a, b, c: (jflash.flash_attention(a, b, c, H)
                                    ** 2).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    (tflash.flash_attention(*ts, H) ** 2).sum().backward()
    for name, t, g in zip("qkv", ts, g_j):
        np.testing.assert_allclose(_np(t.grad), _np(g), atol=2e-5, rtol=1e-4,
                                   err_msg=name)


def test_packed_autograd_saves_denominators():
    """With a gradient wanted the forward is the denominator-emitting one
    and the backward consumes its residuals; without, the plain forward.
    Extras rows (keys only) receive their gradient through dk / dv."""
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 9, 32).astype(np.float32))
    extras = torch.from_numpy(rs.randn(1, 3, 32).astype(np.float32)) \
        .requires_grad_()
    kv = torch.cat([x, extras.expand(2, 3, 32)], dim=1)
    out = tflash.flash_attention(x, kv, kv, 2)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "_PackedAttentionBackward"
    q, k, v, o, den = out.grad_fn.saved_tensors
    assert den.shape == (2, 9, 2) and den.dtype == torch.float32
    out.square().sum().backward()
    # the broadcast extras accumulate their gradient over the batch
    ref_extras = extras.detach().clone().requires_grad_()
    kv2 = torch.cat([x, ref_extras.expand(2, 3, 32)], dim=1)
    tflash._reference_attention(x, kv2, kv2, 2).square().sum().backward()
    np.testing.assert_allclose(extras.grad.numpy(), ref_extras.grad.numpy(),
                               atol=2e-5)
    with torch.no_grad():
        assert tflash.flash_attention(x, kv, kv, 2).grad_fn is None
    assert tflash.flash_attention(x, kv.detach(), kv.detach(), 2).grad_fn \
        is None


def test_clamp_regime_forward_and_backward():
    """Scaled scores far beyond the clamp (the JAX test
    test_large_scores_saturate_without_overflow): the one-pass softmax
    saturates to finite outputs, the same on both sides, forward and
    backward."""
    rs = np.random.RandomState(2)
    qh = 300.0 * np.abs(rs.randn(1, 16, 64))
    v = rs.randn(1, 16, 64)
    do = rs.randn(1, 16, 64)
    (jq, jv, jdo), (tq, tv, tdo) = zip(*(_both(a) for a in (qh, v, do)))
    o_j, den_j = jflash._packed_forward(jq, jq, jv, 4, want_denom=True)
    o_t, den_t = tflash.packed_attention_den_plain(tq, tq, tv, 4)
    assert torch.isfinite(o_t).all() and torch.isfinite(den_t).all()
    assert o_t.abs().max() <= tv.abs().max() + 1e-3
    np.testing.assert_allclose(_np(o_t), _np(o_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(den_t), _np(den_j), rtol=1e-5)
    g_j = jflash._packed_backward(jq, jq, jv, jdo, o_j, den_j, 4)
    g_t = tflash.packed_attention_bwd_plain(tq, tq, tv, tdo, o_t, den_t, 4)
    for a, b in zip(g_t, g_j):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-3,
                                   atol=1e-4 * max(np.abs(_np(b)).max(), 1))
    # and the standard softmax differs there: the clamp is the semantics
    ref = tflash._reference_attention(tq, tq, tv, 4)
    assert (o_t - ref).abs().max() > 1e-2


STREAM_CASES = [  # (B, Lq, Lk, H, Dh, causal)
    (3, 77, 77, 4, 16, True),        # the text tower's shape
    (2, 77, 77, 2, 32, True),
    (1, 700, 700, 2, 32, False),     # long and unaligned: beyond 640 keys
    (2, 40, 150, 2, 16, False)]      # cross shape, forced through streaming


@pytest.mark.parametrize("case", STREAM_CASES)
def test_streaming_plain_matches_jax(case):
    """`streaming_attention_plain` against the JAX streaming path (the
    stock Pallas TPU flash kernel in interpret mode) and against
    `_reference_attention`, fp32."""
    B, Lq, Lk, H, Dh, causal = case
    (jq, jk, jv, _), (tq, tk, tv, _) = _qkvdo(4, B, Lq, Lk, H, Dh, "float32")
    o_t, lse = tflash.streaming_attention_plain(tq, tk, tv, H, causal)
    assert lse.shape == (B, H, Lq) and lse.dtype == torch.float32
    want = jflash._streaming_flash(jq, jk, jv, H, causal)
    np.testing.assert_allclose(_np(o_t), _np(want), atol=2e-4)
    ref = jflash._reference_attention(jq, jk, jv, H, causal=causal)
    np.testing.assert_allclose(_np(o_t), _np(ref), atol=1e-4)
    # lse is the log of the softmax denominator of the scaled scores
    qh = tq.reshape(B, Lq, H, Dh).transpose(1, 2)
    kh = tk.reshape(B, Lk, H, Dh).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * Dh ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(Lq, Lk, dtype=torch.bool).tril(),
                          float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("case", [(2, 77, 77, 2, 32, True),
                                  (1, 200, 200, 2, 32, False)])
def test_streaming_grads_match_jax_grad(case):
    """autograd through the streaming Function (plain backward formula)
    against jax.grad of the JAX streaming path and of the reference. The
    tolerance against the stock kernel is the JAX package's own
    (tests/test_flash_attention.py: atol 2e-3)."""
    B, Lq, Lk, H, Dh, causal = case
    (jq, jk, jv, _), (tq, tk, tv, _) = _qkvdo(5, B, Lq, Lk, H, Dh, "float32")
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tflash._StreamingAttention.apply(*ts, H, causal)
    (out ** 2).sum().backward()
    with pltpu.force_tpu_interpret_mode():
        g_j = jax.grad(lambda a, b, c: (jflash._streaming_flash(
            a, b, c, H, causal) ** 2).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    g_r = jax.grad(lambda a, b, c: (jflash._reference_attention(
        a, b, c, H, causal=causal) ** 2).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    for name, t, gj, gr in zip("qkv", ts, g_j, g_r):
        np.testing.assert_allclose(_np(t.grad), _np(gj), atol=2e-3,
                                   err_msg=name)
        np.testing.assert_allclose(_np(t.grad), _np(gr), atol=1e-4,
                                   err_msg=name)


def test_streaming_grads_match_jax_grad_at_text_width():
    """The text tower's width, where the CUDA backward takes its one-launch
    form: B 1, L 77, 8 heads of 64, causal. The gradients of
    `_StreamingAttention` (its backward on the CPU is
    `streaming_attention_bwd_plain`, the kernel's reference on the card)
    against jax.vjp of the JAX streaming path (the stock Pallas TPU kernels
    in interpret mode) and of the reference, for the same upstream gradient
    do; the tolerance against the stock kernel is the JAX package's own
    (tests/test_flash_attention.py: atol 2e-3)."""
    B, L, H, Dh = 1, 77, 8, 64
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qkvdo(12, B, L, L, H, Dh,
                                                  "float32")
    ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tflash._StreamingAttention.apply(*ts, H, True)
    g_t = torch.autograd.grad(out, ts, tdo)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jflash._streaming_flash(
            a, b, c, H, True), jq, jk, jv)
        g_j = vjp(jdo)
    _, vjp_r = jax.vjp(lambda a, b, c: jflash._reference_attention(
        a, b, c, H, causal=True), jq, jk, jv)
    g_r = vjp_r(jdo)
    for name, gt, gj, gr in zip("qkv", g_t, g_j, g_r):
        np.testing.assert_allclose(_np(gt), _np(gj), atol=2e-3, err_msg=name)
        np.testing.assert_allclose(_np(gt), _np(gr), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_bwd_plain_rounding_points(dtype):
    """The explicit streaming backward: p and ds are cast to v's dtype
    before their products. In fp32 it equals autograd through the
    reference; in bf16 it stays within flipped roundings of the fp32
    result."""
    B, Lq, Lk, H, Dh, causal = 2, 77, 77, 2, 16, True
    _, (tq, tk, tv, tdo) = _qkvdo(6, B, Lq, Lk, H, Dh, dtype)
    o, lse = tflash.streaming_attention_plain(tq, tk, tv, H, causal)
    g = tflash.streaming_attention_bwd_plain(tq, tk, tv, tdo, o, lse, H,
                                             causal)
    ts = [t.float().requires_grad_() for t in (tq, tk, tv)]
    ref = tflash._reference_attention(*ts, H, causal)
    g_ref = torch.autograd.grad(ref, ts, tdo.float())
    for a, b in zip(g, g_ref):
        assert a.dtype == TORCH_DTYPE[dtype]
        tol = 2e-5 if dtype == "float32" else 2.0 ** -6 * b.abs().max().item()
        assert (a.float() - b).abs().max().item() <= tol


def test_flash_attention_dispatch_and_counts():
    """Causal and long keys go to the streaming path, everything else to
    the packed one; on the CPU no kernel is launched; attention_core
    reaches the streaming path with impl='flash', causal=True."""
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(2, 12, 32).astype(np.float32))
    tflash.reset_launch_counts()
    causal = tflash.flash_attention(x, x, x, 2, causal=True)
    np.testing.assert_allclose(
        causal.numpy(), tflash._reference_attention(x, x, x, 2, True).numpy(),
        atol=1e-5)
    np.testing.assert_allclose(
        tattn.attention_core(x, x, x, 2, impl="flash", causal=True).numpy(),
        tattn.attention_core(x, x, x, 2, impl="xla", causal=True).numpy(),
        atol=1e-5)
    long_k = torch.from_numpy(rs.randn(1, 641, 32).astype(np.float32))
    q1 = x[:1].clone().requires_grad_()
    out = tflash.flash_attention(q1, long_k, long_k, 2)
    assert type(out.grad_fn).__name__ == "_StreamingAttentionBackward"
    assert set(tflash.launch_counts.values()) == {0}
    # the kernel wrappers never fall back to the plain versions
    for fn, args in ((tflash.packed_attention_den_cuda, (x, x, x, 2)),
                     (tflash.streaming_attention_cuda, (x, x, x, 2, True)),
                     (tflash.packed_attention_bwd_cuda,
                      (x, x, x, x, x, torch.zeros(2, 12, 2), 2)),
                     (tflash.streaming_attention_bwd_cuda,
                      (x, x, x, x, x, torch.zeros(2, 2, 12), 2, True))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    # plain_versions() is what a card run uses to hold a step through the
    # kernels against the same step without them
    with tflash.plain_versions():
        assert tflash._force_plain
        assert torch.equal(tflash.flash_attention(x, x, x, 2, causal=True),
                           causal)
    assert not tflash._force_plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_bwd_recompute_plain_matches_pallas(case, dtype):
    """The backward from q, k, v, do alone against
    `_packed_backward_recompute` (interpret mode). Tolerance as for the
    saved-residual backward: sum order and exp2 in fp32, flipped bf16
    roundings in bf16."""
    B, Lq, Lk, H, Dh = case
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _qkvdo(4, *case, dtype)
    g_j = jflash._packed_backward_recompute(jq, jk, jv, jdo, H)
    g_t = tflash.packed_attention_bwd_recompute_plain(tq, tk, tv, tdo, H)
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        assert a.dtype == TORCH_DTYPE[dtype]
        _close(a, b, dtype, name)


def test_packed_bwd_recompute_rounding_point():
    """The one rounding point in which the two backward modes differ: the
    recompute form takes delta from the fp32 output, the saved form from
    the output rounded to its dtype. In fp32 they agree to summation
    noise; in bf16 the recompute form equals the saved form fed an
    UNROUNDED output, and differs from it fed the bf16 output."""
    case = (2, 13, 21, 2, 32)
    _, (q, k, v, do) = _qkvdo(5, *case, "float32")
    o, den = tflash.packed_attention_den_plain(q, k, v, 2)
    for a, b in zip(tflash.packed_attention_bwd_recompute_plain(q, k, v, do,
                                                                2),
                    tflash.packed_attention_bwd_plain(q, k, v, do, o, den,
                                                      2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)
    _, (q, k, v, do) = _qkvdo(5, *case, "bfloat16")
    o32, den = tflash._onepass_attention_den_f32(q, k, v, 2)
    rec = tflash.packed_attention_bwd_recompute_plain(q, k, v, do, 2)
    # `num * (1 / den)` against `num / den`: an fp32 ulp, which flips few
    # bf16 roundings of ds
    unrounded = tflash.packed_attention_bwd_plain(q, k, v, do, o32, den, 2)
    rounded = tflash.packed_attention_bwd_plain(q, k, v, do,
                                                o32.to(torch.bfloat16), den,
                                                2)
    for a, b, c in zip(rec[:2], unrounded[:2], rounded[:2]):
        assert (a != b).float().mean() < 0.01
        assert (a != c).float().mean() > 0.02


@pytest.mark.parametrize("case", [(2, 13, 21, 2, 32), (1, 20, 20, 2, 16)])
def test_recompute_mode_matches_jax_grad(case):
    """`set_flash_bwd_mode("recompute")` on both sides: torch.autograd
    through `flash_attention` against jax.grad of the JAX function (its
    `_packed_flash_recompute` VJP, interpret mode), fp32; the forward saves
    q, k, v only. Both switches are reset."""
    B, Lq, Lk, H, Dh = case
    (jq, jk, jv, _), (tq, tk, tv, _) = _qkvdo(6, *case, "float32")
    jflash.set_flash_bwd_mode("recompute")
    tflash.set_flash_bwd_mode("recompute")
    try:
        g_j = jax.grad(lambda a, b, c: (jflash.flash_attention(a, b, c, H)
                                        ** 2).sum(),
                       argnums=(0, 1, 2))(jq, jk, jv)
        ts = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = tflash.flash_attention(*ts, H)
        assert type(out.grad_fn).__name__ == \
            "_PackedAttentionRecomputeBackward"
        assert len(out.grad_fn.saved_tensors) == 3
        (out ** 2).sum().backward()
    finally:
        jflash.set_flash_bwd_mode("saved")
        tflash.set_flash_bwd_mode("saved")
    for name, t, g in zip("qkv", ts, g_j):
        np.testing.assert_allclose(_np(t.grad), _np(g), atol=2e-5, rtol=1e-4,
                                   err_msg=name)
    out = tflash.flash_attention(*[t.detach().requires_grad_() for t in ts],
                                 H)
    assert type(out.grad_fn).__name__ == "_PackedAttentionBackward"
    with pytest.raises(ValueError, match="saved"):
        tflash.set_flash_bwd_mode("both")


def test_clamp_monitor_detects_drift():
    """The opt-in drift monitor, as the JAX package's test of it: it
    records the exact largest exp2 argument (equal to JAX's) and flags
    scores past the clamp at 110; only the positive maximum counts; off, it
    records nothing."""
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, 16, 32).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jflash.enable_clamp_monitor(True)
    tflash.enable_clamp_monitor(True)
    try:
        jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               num_heads=2).block_until_ready()
        tflash.flash_attention(tq, tk, tv, num_heads=2)
        stats = tflash.read_clamp_stats()
        assert stats["calls"] == 1 and not stats["clipped"]
        assert 0 < stats["max_exp2_arg"] < tflash._CLAMP
        np.testing.assert_allclose(stats["max_exp2_arg"],
                                   jflash.clamp_stats["max_exp2_arg"],
                                   rtol=1e-5)
        # the running maximum holds over calls
        tflash.flash_attention(tq * 0.1, tk, tv, num_heads=2)
        assert tflash.read_clamp_stats()["max_exp2_arg"] == \
            stats["max_exp2_arg"]
        assert tflash.clamp_stats["calls"] == 2

        tflash.enable_clamp_monitor(True)            # resets the statistics
        assert tflash.clamp_stats["calls"] == 0
        tflash.flash_attention(tq * 40.0, tk * 40.0, tv, num_heads=2)
        stats = tflash.read_clamp_stats()
        assert stats["clipped"] and stats["max_exp2_arg"] >= tflash._CLAMP

        tflash.enable_clamp_monitor(True)
        tflash.flash_attention(tq, -tq, tv, num_heads=2)   # negative scores
        assert tflash.read_clamp_stats()["max_exp2_arg"] < 40.0
    finally:
        jflash.enable_clamp_monitor(False)
        tflash.enable_clamp_monitor(False)
    tflash.flash_attention(tq, tk, tv, num_heads=2)
    assert tflash.read_clamp_stats()["calls"] == 0


# the launch plan of the packed backward kernel (csrc/packed_attention_bwd.cuh):
# one block per (batch row, head), the fp32 dq accumulator and the row
# statistics in shared memory while they fit, else in global scratch
_MAX_DYNAMIC_SMEM = 232448        # what one block may use on an H100
_MAX_GRID_X = 2 ** 31 - 1
_H100_SMS = 132                   # SMs of an H100 SXM


@pytest.mark.parametrize("H", [1, 3, 12, 16])
def test_packed_bwd_plan_fits_every_admitted_shape(H):
    """Lq 1..2048 in ragged steps, 1-16 heads (the keys, at most 640,
    stream through fixed tiles and do not enter the plan): the rows round
    up to 16, the shared memory stays within a block's limit, the grid is
    one-dimensional within CUDA's limit, and the scratch (when there is
    one) holds one accumulator region per block."""
    lqs = list(range(1, 70)) + list(range(70, 2049, 37)) + [240, 241, 2048]
    for Lq in lqs:
        for B in (1, 280):
            p = tflash.packed_bwd_plan(B, Lq, H, _H100_SMS)
            assert p["lq_pad"] % 16 == 0
            assert Lq <= p["lq_pad"] < Lq + 16
            assert p["smem_bytes"] <= _MAX_DYNAMIC_SMEM
            assert 1 <= p["grid"] <= min(B * H, _MAX_GRID_X)
            acc_bytes = 4 * p["lq_pad"] * tflash._BWD_ACC_FLOATS_PER_ROW
            if p["acc_in_smem"]:
                assert p["grid"] == B * H and p["scratch_floats"] == 0
                assert p["smem_bytes"] == tflash._BWD_FIXED_SMEM + acc_bytes
            else:
                assert p["smem_bytes"] == tflash._BWD_FIXED_SMEM
                assert p["scratch_floats"] * 4 == p["grid"] * acc_bytes


@pytest.mark.parametrize("Lq,in_smem", [(1, True), (197, True), (240, True),
                                        (241, False), (640, False),
                                        (1030, False), (2048, False)])
def test_packed_bwd_plan_selects_global_scratch_past_shared_memory(Lq,
                                                                   in_smem):
    """The training shapes (Lq = 197) keep the accumulator in shared
    memory; past 240 query rows it moves to global scratch, and the grid
    then walks the (row, head) pairs with at most one block per SM."""
    p = tflash.packed_bwd_plan(280, Lq, 12, _H100_SMS)
    assert p["acc_in_smem"] is in_smem
    if not in_smem:
        assert p["grid"] == _H100_SMS
        assert tflash._BWD_FIXED_SMEM + 4 * p["lq_pad"] * \
            tflash._BWD_ACC_FLOATS_PER_ROW > _MAX_DYNAMIC_SMEM
