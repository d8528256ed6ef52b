"""The fused q/k/v projection of a w8a8 self-attention in the PyTorch port:
`ops.int8_matmul.w8a8_matmul3` (B3a, csrc/w8a8_qkv.cu with no extras rows)
against the JAX `w8a8_matmul3` Pallas kernel in interpret mode, and the
dispatch of `ops.attention.multi_head_attention` to it when q is k is v and
the leaves are 'qa', as the JAX function does when its kernels are active.

On the CPU the port's kernel dispatch (`_use_kernel`) runs the plain
versions, so the dispatch tests stand a counting stand-in for the CUDA
wrappers in, which calls the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gava_clip_tpu.ops import int8_matmul as jim
from gava_clip_tpu.ops.quant import quantize_weight as jquantize_weight
from gava_clip_tpu_torch.ops import attention as tattn
from gava_clip_tpu_torch.ops import int8_matmul as tim
from tests.test_torch_bounds import module_deadline  # noqa: F401


@pytest.fixture
def forced_kernels():
    """The JAX Pallas kernels in interpret mode; the flag is process-global
    (xdist runs other files in the same worker), so it is reset here."""
    jim.force_tpu_kernels(True)
    assert jim.kernels_active()
    yield
    jim.force_tpu_kernels(False)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _leaf(rs, K, N):
    """One int8 kernel leaf for both packages (heavy-tailed input rows)."""
    w = rs.randn(K, N) * K ** -0.5
    w[rs.choice(K, max(1, K // 50), replace=False)] *= 16
    q, s = jquantize_weight(w)
    return (jnp.asarray(q), jnp.asarray(s)), {"qa": torch.from_numpy(q),
                                              "scale": torch.from_numpy(s)}


@pytest.mark.parametrize("with_ln", [False, True])
def test_w8a8_matmul3_plain_matches_jax_kernel(forced_kernels, with_ln):
    """Ragged rows (M = 29). Without the LayerNorm both quantize the same
    bf16 rows to the same codes, so only the fp32 epilogue may round
    differently: within one bf16 ulp. With it the fp32 LayerNorms may
    differ in the last bit, which can move a code by one (ROADMAP C, the
    +-1 LSB note): within 2 ulp + one dequantized LSB, and in at most 5% of
    the outputs beyond 2 ulp."""
    rs = np.random.RandomState(11)
    M, K, N = 29, 64, 40
    x = rs.randn(M, K) * 2
    leaves = [_leaf(rs, K, N) for _ in range(3)]
    bs = [rs.randn(N) * 0.02 for _ in range(3)]
    g, beta = 1 + rs.rand(K) * 4, rs.randn(K) * 0.1
    xj = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    ln_j = (jnp.asarray(g, jnp.float32), jnp.asarray(beta, jnp.float32)) \
        if with_ln else None
    ln_t = (torch.from_numpy(g.astype(np.float32)),
            torch.from_numpy(beta.astype(np.float32))) if with_ln else None
    outs_j = jim.w8a8_matmul3(
        xj, [lj[0] for lj, _ in leaves], [lj[1] for lj, _ in leaves],
        bias3=[jnp.asarray(b, jnp.float32) for b in bs], ln=ln_j)
    outs_t = tim.w8a8_matmul3(
        xt, [lt for _, lt in leaves],
        [torch.from_numpy(b.astype(np.float32)) for b in bs], ln=ln_t)
    rows = xt.float() if ln_t is None else tim.ln_f32(xt.float(), *ln_t)
    xs = tim.quant_rows(rows)[1].numpy()
    for o_t, o_j, (_, lt) in zip(outs_t, outs_j, leaves):
        assert o_t.dtype == torch.bfloat16 and o_t.shape == (M, N)
        a, b = _np(o_t), _np(o_j)
        assert np.isfinite(a).all()
        err = np.abs(a - b)
        if not with_ln:
            assert np.all(err <= _bf16_ulp(np.maximum(abs(a), abs(b))))
            continue
        unit = xs * lt["scale"].numpy().reshape(-1) * 127.0
        two_ulp = 2 * _bf16_ulp(np.maximum(abs(a), abs(b)))
        assert np.all(err <= two_ulp + unit)
        assert (err > two_ulp).mean() <= 0.05


def _attn_params(rs, D):
    return {n: {"kernel": _leaf(rs, D, D)[1],
                "bias": torch.from_numpy((rs.randn(D) * 0.02)
                                         .astype(np.float32))}
            for n in ("q", "k", "v", "out")}


@pytest.fixture
def counted(monkeypatch):
    """The kernel path taken on the CPU: `_use_kernel` says yes for
    impl='kernel', and the two CUDA wrappers that the projections reach are
    counting stand-ins that run the plain versions."""
    calls = {"w8a8_matmul": 0, "w8a8_matmul3": 0}

    def count(name, plain):
        def fn(*args, **kwargs):
            calls[name] += 1
            return plain(*args, **kwargs)
        return fn

    monkeypatch.setattr(tim, "_use_kernel",
                        lambda x, impl: impl == "kernel")
    monkeypatch.setattr(tim, "w8a8_matmul_cuda",
                        count("w8a8_matmul", tim.w8a8_matmul_plain))
    monkeypatch.setattr(tim, "w8a8_matmul3_cuda",
                        count("w8a8_matmul3", tim.w8a8_matmul3_plain))
    return calls


def test_self_attention_takes_the_fused_qkv_call(counted):
    """q is k is v with 'qa' leaves: one w8a8_matmul3 (and the out
    projection), and the result of three separate projections. The three
    quantize the same rows to the same codes, so the two agree within the
    dequantized tolerance of ROADMAP C's +-1 LSB note (here: exactly)."""
    rs = np.random.RandomState(12)
    B, L, H = 2, 9, 2
    D = H * 16
    params = _attn_params(rs, D)
    x = torch.from_numpy(rs.randn(B, L, D).astype(np.float32)).to(
        torch.bfloat16)
    fused = tattn.multi_head_attention(params, x, x, x, H)
    assert counted == {"w8a8_matmul": 1, "w8a8_matmul3": 1}
    separate = tattn.multi_head_attention(params, x, x.view_as(x),
                                          x.view_as(x), H)
    assert counted == {"w8a8_matmul": 5, "w8a8_matmul3": 1}
    assert fused.shape == (B, L, D) and fused.dtype == torch.bfloat16
    # one int8 LSB of the q/k/v outputs, carried through softmax and the
    # out projection, is far below a bf16 ulp of the result
    a, b = _np(fused), _np(separate)
    assert np.all(np.abs(a - b) <= _bf16_ulp(np.maximum(abs(a), abs(b))))


@pytest.mark.parametrize("which", ["cross", "plain_impl", "float_leaves"])
def test_other_attentions_keep_three_projections(counted, which):
    """q is not k (the vision tower's cross attention over [x; extras]),
    int8_impl='plain', or float kernels: no fused call."""
    rs = np.random.RandomState(13)
    B, L, H = 2, 7, 2
    D = H * 16
    params = _attn_params(rs, D)
    x = torch.from_numpy(rs.randn(B, L, D).astype(np.float32)).to(
        torch.bfloat16)
    if which == "cross":
        kv = torch.cat([x, x[:, :3]], dim=1)
        tattn.multi_head_attention(params, x, kv, kv, H)
        assert counted == {"w8a8_matmul": 4, "w8a8_matmul3": 0}
    elif which == "plain_impl":
        tattn.multi_head_attention(params, x, x, x, H, int8_impl="plain")
        assert counted == {"w8a8_matmul": 0, "w8a8_matmul3": 0}
    else:
        fparams = {n: {"kernel": p["kernel"]["qa"].float() * p["kernel"]
                       ["scale"], "bias": p["bias"]}
                   for n, p in params.items()}
        out = tattn.multi_head_attention(fparams, x, x, x, H)
        assert counted == {"w8a8_matmul": 0, "w8a8_matmul3": 0}
        assert torch.isfinite(out.float()).all()


def test_w8a8_matmul3_wrapper_needs_cuda():
    """On a CPU tensor the CUDA wrapper refuses; the dispatcher runs the
    plain version there."""
    rs = np.random.RandomState(14)
    K = N = 32
    leaves = [_leaf(rs, K, N)[1] for _ in range(3)]
    bias = [torch.zeros(N) for _ in range(3)]
    x = torch.randn(5, K).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tim.w8a8_matmul3_cuda(x, leaves, bias)
    outs = tim.w8a8_matmul3(x, leaves, bias)
    for o, lf in zip(outs, leaves):
        torch.testing.assert_close(o, tim.w8a8_matmul_plain(x, lf),
                                   rtol=0, atol=0)
