"""The port's int8-forward training (`--int8_frozen`) against the JAX
package on the CPU: `quantize_frozen_for_train`, the generic w8a8 helpers
(`quantize_act`, `int8_apply`, `int8_dynamic_linear`), the three
straight-through ops (`int8_linear_st`, `int8_qkv3_st`, `int8_mlp_st`),
the 'qt' vision block under every remat policy, the loss and its gradients,
a train trajectory and the bridge. Seeded numpy inputs; the tiny model of
tests/test_torch_train_step.py.

The JAX side runs as its own tests run it: through its XLA composition,
and with `force_tpu_kernels` (its Pallas kernels in interpret mode, the flag
reset in teardown). Its `int8_qkv3_st` and `int8_mlp_st` always run their
Pallas kernels. The port's CPU path is the plain versions, which follow the
kernels' semantics (codes rint(x * (1 / xs)), no clip), while the JAX XLA
composition divides by xs and clips (`quantize_act`): the two may differ by
one int8 code at a rounding tie, and a LayerNorm or attention sum taken in
another order can move a value onto the other side of a tie. Each
tolerance below is stated where it is used.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gava_clip_tpu.models import vision as jvision
from gava_clip_tpu.models import vita_clip as jvc
from gava_clip_tpu.ops import int8_matmul as jim
from gava_clip_tpu.ops import quant as jquant
from gava_clip_tpu.train import state as jstate
from gava_clip_tpu.train import step as jstep
from gava_clip_tpu_torch.models import vision as tvision
from gava_clip_tpu_torch.models import vita_clip as tvc
from gava_clip_tpu_torch.ops import int8_matmul as tim
from gava_clip_tpu_torch.ops import quant as tquant
from gava_clip_tpu_torch.train import state as tstate
from gava_clip_tpu_torch.train import step as tstep
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_torch_train_step import (_batch, _jb, _leaves_with_path,
                                         _tb, models)  # noqa: F401
from tests.test_torch_w8a8 import _bf16_ulp, _j, _np, _qweight, _t

DTYPES = ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16))


@pytest.fixture(params=[False, True], ids=["xla", "pallas"])
def jax_kernels(request):
    """The JAX side through its XLA composition or its Pallas kernels in
    interpret mode; the flag is process-global, so it is reset here."""
    jim.force_tpu_kernels(request.param)
    yield request.param
    jim.force_tpu_kernels(False)


def _frozen_leaf(w):
    """One kernel quantized by both packages' quantize_frozen_for_train."""
    jl = jquant.quantize_frozen_for_train(
        {"m": {"attn": {"kernel": jnp.asarray(w)}}})["m"]["attn"]["kernel"]
    tl = tquant.quantize_frozen_for_train(
        {"m": {"attn": {"kernel": torch.from_numpy(w)}}})["m"]["attn"][
            "kernel"]
    assert np.array_equal(np.asarray(jl["qt"]), tl["qt"].numpy())
    assert np.array_equal(np.asarray(jl["scale"]), tl["scale"].numpy())
    return jl, tl


def _weights(rs, K, N):
    w = (rs.randn(K, N) * K ** -0.5).astype(np.float32)
    w[rs.choice(K, max(1, K // 16), replace=False)] *= 8
    return _frozen_leaf(w)


def _frozen_grads_none(*tensors):
    return all(t.grad is None for t in tensors)


def _jax_vjp(fn, args, cot):
    """fn's value at args and its vjp with cotangent cot, in one jit (one
    compile costs less than the interpret-mode kernels run op by op)."""
    @jax.jit
    def run(args, cot):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(cot)
    return run(args, cot)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def test_quantize_frozen_for_train_bit_equal_jax(models):
    """The frozen half of the tiny model's state, with one all-zero column
    (scale 1, codes 0) and one half-integer ratio per column (a tie, rounded
    to even): codes and scales bit for bit, leaf by leaf in the JAX
    layout; only kernels under attn / mlp become 'qt' leaves."""
    jmodel, model = models
    mask = tvc.trainable_mask(model.params, model.cfg)
    frozen = tstate.partition_params(model.params, mask)[1]
    fc1 = frozen["visual"]["blocks"][1]["mlp"]["fc1"]
    w = fc1["kernel"].clone()
    w[:, 3] = 0.0
    w[0, 5], w[1, 5] = 127.0, 2.5            # scale 1: 2.5 rounds to 2
    frozen["visual"]["blocks"][1]["mlp"]["fc1"] = dict(fc1, kernel=w)
    jparams = jax_bridge.params_to_jax(tstate.combine_params(
        tstate.partition_params(model.params, mask)[0], frozen))
    jfrozen = jstate.partition_params(
        jparams, jvc.trainable_mask(jmodel.params, jmodel.cfg))[1]

    got = tquant.quantize_frozen_for_train(frozen)
    want = jquant.quantize_frozen_for_train(
        jax.tree_util.tree_map(jnp.asarray, jfrozen))
    leaf = got["visual"]["blocks"][1]["mlp"]["fc1"]["kernel"]
    assert leaf["scale"][0, 3] == 1.0 and not leaf["qt"][:, 3].any()
    assert leaf["qt"][1, 5] == 2
    flat_w = dict(_leaves_with_path(want))
    flat_g = dict(_leaves_with_path(jax_bridge.params_to_jax(got)))
    assert sorted(flat_g) == sorted(flat_w)
    n_qt = 0
    for path, a in flat_w.items():
        b = flat_g[path]
        assert (a is None) == (b is None), path
        if a is not None:
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), path
            n_qt += path.endswith("['qt']")
    # 6 projections a block, 2 vision + 2 text blocks (stacked per tower)
    assert n_qt == 12
    # the dequantized tree and the error diagnostic take 'qt' leaves
    deq = tquant.dequantize_tree(got, torch.float32)
    assert torch.equal(deq["textual"]["blocks"][0]["attn"]["q"]["kernel"],
                       tquant.dequantize_weight(
                           got["textual"]["blocks"][0]["attn"]["q"][
                               "kernel"]["qt"],
                           got["textual"]["blocks"][0]["attn"]["q"][
                               "kernel"]["scale"], torch.float32))
    # the port takes the largest error of a layer, JAX of a stacked leaf,
    # whose pooled ratio cannot exceed its layers' largest
    err = tquant.quantization_error(frozen, got)
    assert 0 < err < 2e-2
    assert err >= jquant.quantization_error(jfrozen, want) * (1 - 1e-6)


@pytest.mark.parametrize("seed,gain", [(0, 1.0), (1, 1e-3), (2, 300.0)])
def test_quantize_act_and_int8_apply_match_jax(seed, gain):
    """quantize_act: the same fp32 division on both sides, so xs bit for
    bit and the codes equal (a code may differ by one only at an exact
    tie). int8_apply: exact integer products, the same fp32 rescale."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(37, 64) * gain).astype(np.float32)
    x[3] = 0.0                                # absmax floor 1e-6
    qj, xsj = jim.quantize_act(jnp.asarray(x))
    qt, xst = tim.quantize_act(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and xst.shape == (37, 1)
    assert np.array_equal(np.asarray(xsj), xst.numpy())
    diff = np.abs(np.asarray(qj, np.int32) - qt.numpy().astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    (wj, sj), (wt, st) = _qweight(rs, 64, 24)
    b = (rs.randn(24) * 0.1).astype(np.float32)
    for bias, dtype in ((None, None), (b, jnp.bfloat16)):
        yj = jim.int8_apply({"qa": wj, "scale": sj}, qj, xsj,
                            bias=None if bias is None else jnp.asarray(bias),
                            out_dtype=dtype)
        yt = tim.int8_apply({"qa": wt, "scale": st}, qt, xst,
                            bias=None if bias is None else _t(bias),
                            out_dtype=None if dtype is None
                            else torch.bfloat16)
        a, r = _np(yt), _np(yj)
        assert a.shape == r.shape == (37, 24)
        np.testing.assert_allclose(a, r, rtol=0, atol=(
            2e-6 * np.abs(r).max() if dtype is None
            else _bf16_ulp(np.abs(r)).max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_int8_dynamic_linear_matches_jax(jax_kernels, dtype):
    """The port's CPU path is the JAX XLA composition (quantize_act +
    int8_apply, the bias added in the output dtype): equal to it within
    one rounding of the output dtype; the JAX kernel multiplies by 1 / xs
    and fuses the bias, which moves a code at a tie by one (one flip unit
    xs * s * 127) and the epilogue by a rounding."""
    tdt, jdt = dtype
    rs = np.random.RandomState(3)
    x = rs.randn(2, 19, 48).astype(np.float32)
    (wj, sj), (wt, st) = _qweight(rs, 48, 40)
    b = (rs.randn(40) * 0.1).astype(np.float32)
    yj = jax.jit(jim.int8_dynamic_linear)(
        {"kernel": {"qa": wj, "scale": sj}, "bias": jnp.asarray(b)},
        _j(x, jdt))
    yt = tim.int8_dynamic_linear({"kernel": {"qa": wt, "scale": st},
                                  "bias": _t(b)}, _t(x, tdt))
    assert yt.dtype == tdt and yt.shape == (2, 19, 40)
    a, r = _np(yt), _np(yj)
    ulp = _bf16_ulp(np.maximum(abs(a), abs(r))) if tdt == torch.bfloat16 \
        else 2.0 ** -22 * np.abs(r).max()
    unit = _np(tim.quantize_act(_t(x).reshape(-1, 48))[1]).reshape(
        2, 19, 1) * st.numpy().reshape(-1) * 127.0
    assert np.all(np.abs(a - r) <= 2 * ulp + (unit if jax_kernels else 0))


# ---------------------------------------------------------------------------
# the three straight-through ops: forward and dx against jax.vjp
# ---------------------------------------------------------------------------

def _check_fwd(a, r, unit, dtype):
    """Within 2 ulp of the output dtype plus `unit` (a code flip at a tie)
    for every output; at most 5% of outputs beyond 2 ulp."""
    a, r = _np(a), _np(r)
    assert a.shape == r.shape and np.isfinite(a).all()
    ulp = _bf16_ulp(np.maximum(abs(a), abs(r))) \
        if dtype == torch.bfloat16 else 2.0 ** -21 * np.abs(r).max()
    err = np.abs(a - r)
    assert np.all(err <= 2 * ulp + unit), (err - 2 * ulp - unit).max()
    assert (err > 2 * ulp).mean() <= 0.05


def _check_dx(a, r, dtype):
    """dx: the same formula on both sides, products of the same dequantized
    weight. fp32: sums in another order, 1e-5 of the largest |dx|. bf16:
    each product and the straight-through sums round to bf16 (2^-8 of a
    value), and the LayerNorm-input formula subtracts two means of such
    values: 2e-2 of the largest |dx|, and the mean error within 2e-3 of
    it."""
    a, r = _np(a), _np(r)
    assert a.shape == r.shape and np.isfinite(a).all()
    scale = np.abs(r).max()
    err = np.abs(a - r)
    tol = (1e-5, 1e-6) if dtype == torch.float32 else (2e-2, 2e-3)
    assert err.max() <= tol[0] * scale, err.max() / scale
    assert err.mean() <= tol[1] * scale, err.mean() / scale


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_int8_linear_st_matches_jax_vjp(jax_kernels, dtype):
    tdt, jdt = dtype
    rs = np.random.RandomState(11)
    x = rs.randn(3, 13, 64).astype(np.float32)
    g = rs.randn(3, 13, 40).astype(np.float32)
    jl, tl = _weights(rs, 64, 40)
    b = (rs.randn(40) * 0.1).astype(np.float32)
    y_j, (dx_j,) = _jax_vjp(lambda a: jim.int8_linear_st(
        a, jl["qt"], jl["scale"], jnp.asarray(b)), (_j(x, jdt),), _j(g, jdt))
    xt = _t(x, tdt).requires_grad_()
    scale, bias = tl["scale"].requires_grad_(), _t(b).requires_grad_()
    y_t = tim.int8_linear_st(xt, dict(tl, scale=scale), bias)
    y_t.backward(_t(g, tdt))
    assert y_t.dtype == xt.grad.dtype == tdt
    unit = _np(tim.quant_rows(xt.detach().float())[1]) * \
        tl["scale"].detach().numpy().reshape(-1) * 127.0
    _check_fwd(y_t.detach(), y_j, unit, tdt)
    _check_dx(xt.grad, dx_j, tdt)
    assert _frozen_grads_none(scale, bias)
    # the backward reads no output: the plain and the kernel route (on the
    # CPU both the plain version) give dx bit for bit
    xp = _t(x, tdt).requires_grad_()
    tim.int8_linear_st(xp, tl, _t(b), impl="plain").backward(_t(g, tdt))
    assert torch.equal(xp.grad, xt.grad)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_int8_qkv3_st_matches_jax_vjp(dtype):
    """Forward: LN1 and one shared quant on both sides (the JAX side its
    Pallas kernel): a code flip where the LayerNorm sums' order moves a
    value onto a tie, one flip unit. dx: three products summed, then the
    LayerNorm-input formula."""
    tdt, jdt = dtype
    rs = np.random.RandomState(12)
    M, K, N = 48, 64, 32
    x = rs.randn(M, K).astype(np.float32)
    gs = [rs.randn(M, N).astype(np.float32) for _ in range(3)]
    leaves = [_weights(rs, K, N) for _ in range(3)]
    bs = [(rs.randn(N) * 0.1).astype(np.float32) for _ in range(3)]
    ln = (1 + rs.rand(K).astype(np.float32), 0.1 * rs.randn(K).astype(
        np.float32))

    def jfn(a):
        return jim.int8_qkv3_st(a, *(l[0]["qt"] for l in leaves),
                                *(l[0]["scale"] for l in leaves),
                                *(jnp.asarray(b) for b in bs),
                                *(jnp.asarray(p) for p in ln))

    outs_j, (dx_j,) = _jax_vjp(jfn, (_j(x, jdt),),
                               tuple(_j(g, jdt) for g in gs))
    xt = _t(x, tdt).requires_grad_()
    frozen = [_t(p).requires_grad_() for p in (*bs, *ln)]
    outs_t = tim.int8_qkv3_st(xt, [l[1] for l in leaves], frozen[:3],
                              frozen[3:])
    torch.autograd.backward(outs_t, [_t(g, tdt) for g in gs])
    xs = tim.quant_rows(tim.ln_f32(xt.detach().float(), *map(_t, ln)))[1]
    for o_t, o_j, (_, tl) in zip(outs_t, outs_j, leaves):
        assert o_t.dtype == tdt
        _check_fwd(o_t.detach(), o_j, _np(xs) * tl["scale"].numpy().reshape(
            -1) * 127.0, tdt)
    _check_dx(xt.grad, dx_j, tdt)
    assert _frozen_grads_none(*frozen)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_int8_mlp_st_matches_jax_vjp(dtype):
    """Forward: residual + the fused MLP (the JAX side its Pallas kernel):
    a first-stage flip moves the fp32 hidden and may flip hidden codes, two
    flip units of the second stage. dx: LN2 and fc1 recomputed in the
    cotangent's dtype, QuickGELU's derivative, fc1's transpose; the
    residual's cotangent is g itself."""
    tdt, jdt = dtype
    rs = np.random.RandomState(13)
    M, K, Hd = 40, 32, 96
    x = rs.randn(M, K).astype(np.float32)
    r = rs.randn(M, K).astype(np.float32)
    g = rs.randn(M, K).astype(np.float32)
    (j1, t1), (j2, t2) = _weights(rs, K, Hd), _weights(rs, Hd, K)
    b1, b2 = ((rs.randn(n) * 0.02).astype(np.float32) for n in (Hd, K))
    ln = (1 + rs.rand(K).astype(np.float32), 0.1 * rs.randn(K).astype(
        np.float32))
    y_j, (dx_j, dr_j) = _jax_vjp(lambda a, res: jim.int8_mlp_st(
        a, j1["qt"], j1["scale"], jnp.asarray(b1), j2["qt"], j2["scale"],
        jnp.asarray(b2), *(jnp.asarray(p) for p in ln), res),
        (_j(x, jdt), _j(r, jdt)), _j(g, jdt))
    xt, rt = (_t(a, tdt).requires_grad_() for a in (x, r))
    frozen = [_t(p).requires_grad_() for p in (b1, b2, *ln)]
    fc1 = {"kernel": t1, "bias": frozen[0]}
    fc2 = {"kernel": t2, "bias": frozen[1]}
    y_t = tim.int8_mlp_st(xt, fc1, fc2, frozen[2:], rt)
    y_t.backward(_t(g, tdt))
    codes, xs = tim.quant_rows(tim.ln_f32(xt.detach().float(),
                                          *map(_t, ln)))
    h = tim.quick_gelu_f32(tim.rescale(tim.int_matmul(codes, t1["qt"]), xs,
                                       t1["scale"], _t(b1)))
    unit = 2 * _np(tim.quant_rows(h)[1]) * t2["scale"].numpy().reshape(-1) \
        * 127.0
    assert y_t.dtype == tdt
    _check_fwd(y_t.detach(), y_j, unit, tdt)
    _check_dx(xt.grad, dx_j, tdt)
    assert torch.equal(rt.grad, _t(g, tdt)) and np.array_equal(
        _np(rt.grad), _np(dr_j))
    assert _frozen_grads_none(*frozen)


def test_straight_through_ops_raise_on_fp32_card_rows(monkeypatch):
    """On the kernel path the w8a8 kernels take rows all bf16 or all fp32
    (the residual too) and pick their entry by that dtype: fp32 and bf16
    rows pass the dtype rule and reach the wrapper's CUDA check (no quiet
    cast, no CPU fallback), while fp16 rows and a residual of another dtype
    raise TypeError first. The card's dispatch is stood in for by routing
    every tensor to the kernels. On the CPU the plain versions take both
    dtypes."""
    rs = np.random.RandomState(0)
    _, tl = _weights(rs, 16, 16)
    for dt in (torch.float32, torch.bfloat16):
        assert tim.int8_linear_st(torch.ones(4, 16, dtype=dt),
                                  tl).dtype == dt
    monkeypatch.setattr(tim, "_use_kernel", lambda x, impl: True)
    ln = (torch.ones(16), torch.zeros(16))
    fc = {"kernel": tl, "bias": torch.zeros(16)}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.zeros(4, 16, dtype=dt)
        with pytest.raises(ValueError, match="CUDA"):
            tim.int8_linear_st(x, tl)
        with pytest.raises(ValueError, match="CUDA"):
            tim.int8_qkv3_st(x, [tl] * 3, [torch.zeros(16)] * 3, ln)
        with pytest.raises(ValueError, match="CUDA"):
            tim.int8_mlp_st(x, fc, fc, ln, x)
    half = torch.zeros(4, 16, dtype=torch.float16)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tim.int8_linear_st(half, tl)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tim.int8_qkv3_st(half, [tl] * 3, [torch.zeros(16)] * 3, ln)
    x = torch.zeros(4, 16)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tim.int8_mlp_st(x, fc, fc, ln, x.to(torch.bfloat16))
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tim.w8a8_matmul3_cat_cuda(x[None], x[None].to(torch.bfloat16),
                                  [tl] * 3, [torch.zeros(16)] * 3, ln)
    assert not any(tim.launch_counts.values())


# ---------------------------------------------------------------------------
# the 'qt' vision block, the remat policies, the loss, the train step
# ---------------------------------------------------------------------------

def _qt_block(jmodel, model, layer=1):
    """Layer `layer` of the tiny vision tower with its projections as 'qt'
    leaves, in both trees (quantized under a 'blocks' key, as in a tower)."""
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[layer],
                                jmodel.params["visual"]["blocks"])
    jp = jquant.quantize_frozen_for_train({"blocks": jp})["blocks"]
    tp = tquant.quantize_frozen_for_train(
        {"blocks": model.params["visual"]["blocks"][layer]})["blocks"]
    g = jnp.asarray(jmodel.params["visual"]["global_prompts"])[layer]
    return jp, tp, g


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_qt_vision_block_matches_jax(models, attn_impl):
    """The block's output, summary and dx (to its input rows and to the
    global prompts) at fp32 against the JAX block's on the same 'qt'
    leaves. The forward passes through three int8 quants whose ties may
    flip where the sums run in another order (the JAX LayerNorm and
    attention against the port's): 2e-3 of the largest |output|; dx is the
    straight-through formula on both sides: 1e-3 of the largest |dx|."""
    jmodel, model = models
    jp, tp, g = _qt_block(jmodel, model)
    cfg = model.cfg.vision
    rs = np.random.RandomState(21)
    x = rs.randn(8, 5, cfg.feature_dim).astype(np.float32)
    gy = rs.randn(8, 5, cfg.feature_dim).astype(np.float32)

    def jfn(a, gp):
        return jvision._block(jp, gp, a, jmodel.cfg.vision, attn_impl)

    @jax.jit
    def jvjp(a, gp, cot):
        (y, s), vjp = jax.vjp(jfn, a, gp)
        return (y, s) + vjp((cot, jnp.zeros_like(s)))

    y_j, s_j, dx_j, dg_j = jvjp(jnp.asarray(x), g, jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(np.array(g)).requires_grad_()
    y_t, s_t = tvision._block(tp, gt, xt, cfg, attn_impl)
    y_t.backward(torch.from_numpy(gy))
    for a, r, tol in ((y_t, y_j, 2e-3), (s_t, s_j, 1e-5),
                      (xt.grad, dx_j, 1e-3), (gt.grad, dg_j, 1e-3)):
        a, r = _np(a.detach()), np.asarray(r)
        assert a.shape == r.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, r, rtol=0, atol=tol * np.abs(r).max())


def _int8_grads(model, remat="none", attn_impl="xla", **loss_kw):
    mask = tvc.trainable_mask(model.params, model.cfg)
    st = tstate.create_train_state(model.params, mask,
                                   tstate.make_optimizer(1e-2, 10, 0.0),
                                   device="cpu")
    loss_fn = tstep.make_loss_fn(model, tstep.LossConfig(**loss_kw),
                                 attn_impl=attn_impl, remat=remat,
                                 frozen_int8=True)
    total, metrics = loss_fn(st.trainable, st.frozen, _tb(_batch()))
    total.backward()
    return st, metrics


LOSS_KW = dict(num_classes=3, focal_ordinal=True, fo_beta=0.2,
               use_support_memory=True, add_nte=True)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_qt_remat_policies_equal_none(models, attn_impl):
    """Every remat policy on 'qt' blocks: the loss and every gradient equal
    those of remat 'none' bit for bit (the same ops run again on the same
    values); the frozen leaves carry no gradient."""
    _, model = models
    st0, m0 = _int8_grads(model, "none", attn_impl, **LOSS_KW)
    g0 = [p.grad for p in tstate.tree_leaves(st0.trainable) if p is not None]
    for policy in ("full", "save_attn", "save_attn_qkv", "save_attn_mlp",
                   "dots"):
        st, m = _int8_grads(model, policy, attn_impl, **LOSS_KW)
        assert m["total"].item() == m0["total"].item(), policy
        g = [p.grad for p in tstate.tree_leaves(st.trainable)
             if p is not None]
        assert all(torch.equal(a, b) for a, b in zip(g, g0)), policy
        assert all(p.grad is None for p in tstate.tree_leaves(st.frozen)
                   if p is not None)


def test_qt_remat_reruns_the_straight_through_ops(models, monkeypatch):
    """What each policy runs again on 'qt' blocks, counted as calls of the
    plain versions (the kernels' launches on the card): one loss + backward
    of the 2-block tiny model runs B3a, B2 and B5 once a vision block (and
    six B2 a text block); every policy runs the three vision ops once more,
    since no JAX policy names their outputs on this path."""
    _, model = models
    names = ("w8a8_matmul3_plain", "w8a8_matmul_plain", "w8a8_mlp_res_plain")
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _real=getattr(tim, name), _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(tim, name, counted)
    for policy in ("none", "full", "save_attn", "save_attn_qkv",
                   "save_attn_mlp", "dots"):
        calls.update(dict.fromkeys(names, 0))
        _int8_grads(model, policy, "flash", **LOSS_KW)
        again = 0 if policy == "none" else 1
        assert calls == {"w8a8_matmul3_plain": 2 * (1 + again),
                         "w8a8_matmul_plain": 2 * (1 + again) + 2 * 6,
                         "w8a8_mlp_res_plain": 2 * (1 + again)}, policy


TRAJ_SEEDS = (1, 2, 3, 4)         # _batch()'s seed first


@pytest.fixture(scope="module")
def jax_int8(models):
    """The JAX int8 loss under jax.grad, compiled once for the tests below:
    its gradients and metrics at `_batch()`, and the losses of its train
    step spelled out (jax.grad, then the optimizer's update, as its
    make_train_step does at batch_split 1) over TRAJ_SEEDS' batches."""
    jmodel, _ = models
    opt = jstate.make_optimizer(1e-3, 10, weight_decay=0.2)
    jst = jstate.create_train_state(
        jmodel.params, jvc.trainable_mask(jmodel.params, jmodel.cfg), opt)
    grad_fn = jax.jit(jax.grad(jstep.make_loss_fn(
        jmodel, jstep.LossConfig(**LOSS_KW), frozen_int8=True),
        has_aux=True))

    @jax.jit
    def update(trainable, opt_state, grads):
        updates, opt_state = opt.update(grads, opt_state, trainable)
        return jax.tree_util.tree_map(jnp.add, trainable, updates), opt_state

    trainable, opt_state, runs = jst.trainable, jst.opt_state, []
    for seed in TRAJ_SEEDS:
        grads, metrics = grad_fn(trainable, jst.frozen,
                                 _jb(_batch(seed=seed)))
        runs.append((grads, metrics))
        trainable, opt_state = update(trainable, opt_state, grads)
    return runs


def test_int8_loss_and_gradients_match_jax(models, jax_int8):
    """make_loss_fn(frozen_int8=True): the loss and every trainable
    gradient leaf against jax.grad of the JAX loss with frozen_int8, fp32
    (its text projections through the XLA composition, its fused ops through
    their Pallas kernels; the ops' tests above take both routes). Two towers
    of int8 quants whose ties may flip where the port's sums run in another
    order: on this batch one code of one pooled text row flips, which moves
    the cross-entropy by 0.45% and a prompt's gradient by 1.3% of its
    largest value (0.18% in the median leaf). The metrics within 1e-2, each
    leaf within 3e-2 of its largest gradient."""
    _, model = models
    g_j, m_j = jax_int8[0]
    st, m_t = _int8_grads(model, **LOSS_KW)
    for k in m_j:
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-2,
                                   atol=1e-5, err_msg=k)
    got = dict(_leaves_with_path(jax_bridge.grads_to_jax(st.trainable)))
    want = dict(_leaves_with_path(g_j))
    assert sorted(got) == sorted(want)
    n = 0
    for path, w in want.items():
        if w is None:
            assert got[path] is None, path
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(got[path], w,
                                   atol=1e-6 + 3e-2 * np.abs(w).max(),
                                   err_msg=path)
        n += 1
    assert n > 20


def _trajectory(step, state, batches):
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["total"]))
    return state, losses


def test_frozen_int8_trains_close_to_bf16(models):
    """The port's copy of the JAX package's gate
    (tests/test_train_step.py::test_frozen_int8_trains_close_to_bf16), on
    its batches and at its tolerances: 8 steps with and without frozen_int8
    give losses within rtol 0.06 / atol 0.05 and time_embed within 5e-3,
    and the frozen leaves stay bit-unchanged."""
    _, model = models
    rs = np.random.RandomState(5)
    batches = [{"video": rs.rand(2, 2, 32, 32, 3).astype(np.float32),
                "labels": np.asarray([i % 3, (i + 1) % 3])}
               for i in range(8)]
    cfg = dict(num_classes=3)
    mask = tvc.trainable_mask(model.params, model.cfg)
    trajs, finals = {}, {}
    for name, fi in (("fp", False), ("int8", True)):
        opt = tstate.make_optimizer(1e-3, 10, weight_decay=0.2)
        st = tstate.create_train_state(model.params, mask, opt,
                                       device="cpu")
        frozen = [p.clone() for p in tstate.tree_leaves(st.frozen)
                  if p is not None]
        step = tstep.make_train_step(model, tstep.LossConfig(**cfg), opt,
                                     frozen_int8=fi)
        st, trajs[name] = _trajectory(step, st, map(_tb, batches))
        finals[name] = st.trainable["visual"]["time_embed"].detach().numpy()
        assert all(torch.equal(a, b) for a, b in zip(frozen, [
            p for p in tstate.tree_leaves(st.frozen) if p is not None]))
    np.testing.assert_allclose(trajs["int8"], trajs["fp"], rtol=0.06,
                               atol=0.05)
    np.testing.assert_allclose(finals["int8"], finals["fp"], atol=5e-3)


def test_int8_trajectory_matches_jax(models, jax_int8):
    """The port's int8 train step against the JAX one over the same
    batches: two int8 implementations whose codes may differ at ties (a
    flip moves a first loss by up to 0.45%, see above), and AdamW turns a
    gradient's difference into a step of up to lr where the gradient is
    small, so the first loss within 1e-2 and every loss within the gate's
    own tolerance (rtol 0.06 / atol 0.05)."""
    _, model = models
    opt = tstate.make_optimizer(1e-3, 10, weight_decay=0.2)
    st = tstate.create_train_state(
        model.params, tvc.trainable_mask(model.params, model.cfg), opt,
        device="cpu")
    step = tstep.make_train_step(model, tstep.LossConfig(**LOSS_KW), opt,
                                 frozen_int8=True)
    _, traj = _trajectory(step, st, (_tb(_batch(seed=s))
                                     for s in TRAJ_SEEDS))
    traj_j = [float(m["total"]) for _, m in jax_int8]
    np.testing.assert_allclose(traj[0], traj_j[0], rtol=1e-2)
    np.testing.assert_allclose(traj, traj_j, rtol=0.06, atol=0.05)


def test_quantized_once_and_again_after_a_write(models):
    """make_loss_fn(frozen_int8=True), and so make_train_step, quantizes
    the frozen tree once; a frozen leaf written in place (as a checkpoint
    load writes it) is quantized again. Every step's loss equals that of a
    new loss function, which quantizes the tree anew as the JAX step does
    at every step."""
    _, model = models
    calls = []
    real = tstep.quantize_frozen

    def counted(frozen):
        calls.append(1)
        return real(frozen)

    tstep.quantize_frozen = counted
    try:
        mask = tvc.trainable_mask(model.params, model.cfg)
        opt = tstate.make_optimizer(1e-3, 10, 0.0)
        st = tstate.create_train_state(model.params, mask, opt,
                                       device="cpu")
        step = tstep.make_train_step(model, tstep.LossConfig(**LOSS_KW),
                                     opt, frozen_int8=True)
        batch = _tb(_batch())
        for i in range(3):
            loss_fn = tstep.make_loss_fn(
                model, tstep.LossConfig(**LOSS_KW), frozen_int8=True)
            with torch.no_grad():
                want = loss_fn(st.trainable, st.frozen, batch)[0].item()
            n = len(calls)
            st, m = step(st, batch)
            assert len(calls) == n + (i == 0)
            assert m["total"].item() == want
        w = st.frozen["visual"]["blocks"][0]["attn"]["q"]["kernel"]
        with torch.no_grad():
            w.mul_(0.5)
        n = len(calls)
        st, _ = step(st, batch)
        assert len(calls) == n + 1
    finally:
        tstep.quantize_frozen = real


def test_bridge_round_trip_of_qt_leaves(models):
    """'qt' leaves cross the bridge both ways, int8 staying int8 and the
    scales fp32, per layer in the port and stacked in the JAX layout."""
    jmodel, model = models
    jq = jquant.quantize_frozen_for_train(
        jax.tree_util.tree_map(np.asarray, jmodel.params))
    jq = jax.tree_util.tree_map(np.asarray, jq)
    tp = jax_bridge.params_from_jax(jq, model.cfg)
    leaf = tp["visual"]["blocks"][1]["mlp"]["fc2"]["kernel"]
    assert set(leaf) == {"qt", "scale"} and leaf["qt"].dtype == torch.int8
    assert leaf["scale"].dtype == torch.float32
    assert np.array_equal(
        leaf["qt"].numpy(), jq["visual"]["blocks"]["mlp"]["fc2"]["kernel"][
            "qt"][1])
    back = dict(_leaves_with_path(jax_bridge.params_to_jax(tp)))
    want = dict(_leaves_with_path(jq))
    assert sorted(back) == sorted(want)
    for path, w in want.items():
        assert back[path].dtype == w.dtype and np.array_equal(
            back[path], w), path
