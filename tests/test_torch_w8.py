"""The port's weight-only int8 (w8) serving mode on the CPU: the dequant GEMM
(`int8_matmul`, `quantized_linear`) against the JAX Pallas body in interpret
mode and against the JAX XLA fallback, the 'q' dispatch of `linear` /
`mlp` / `mlp_block`, `prepare_inference_params` and `quantization_error`
against the JAX functions, the bridge for 'q' leaves, the tiny classifier in
"w8" mode against the JAX classifier, and the server's `--quantize w8`.

The w8 GEMM dequantizes each weight with ONE rounding (fp32 product cast to
the activation dtype), as the Pallas body does; the JAX XLA fallback rounds
the scale first. So the port's plain version is held to the Pallas body
within fp32 summation noise (one bf16 ulp at bf16, 1e-5 at fp32) and to the
fallback only within the weight's own rounding.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gava_clip_tpu.models.vision import VisionConfig as JVisionConfig
from gava_clip_tpu.models.vita_clip import VitaClip as JVitaClip
from gava_clip_tpu.models.vita_clip import VitaClipConfig as JVitaClipConfig
from gava_clip_tpu.ops import int8_matmul as jim
from gava_clip_tpu.ops import quant as jquant
from gava_clip_tpu.ops.activations import quick_gelu as jquick_gelu
from gava_clip_tpu.ops.linear import linear as jlinear
from gava_clip_tpu.ops.linear import mlp_block as jmlp_block
from gava_clip_tpu.serve import VideoClassifier as JVideoClassifier
from gava_clip_tpu_torch import server as tserver
from gava_clip_tpu_torch.models.vision import VisionConfig
from gava_clip_tpu_torch.models.vita_clip import VitaClip, VitaClipConfig
from gava_clip_tpu_torch.ops import flash_attention as tflash
from gava_clip_tpu_torch.ops import int8_matmul as tim
from gava_clip_tpu_torch.ops import linear as tlin
from gava_clip_tpu_torch.ops import quant as tquant
from gava_clip_tpu_torch.ops.activations import quick_gelu
from gava_clip_tpu_torch.serve import VideoClassifier
from gava_clip_tpu_torch.utils import flagship as tflagship
from gava_clip_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax
from tests.test_torch_bounds import module_deadline, stop_server  # noqa: F401

NAMES = ["normal", "slight", "moderate"]
TINY = dict(input_size=(32, 32), num_frames=2, feature_dim=32,
            patch_size=(16, 16), heads=2, layers=2, mlp_factor=2.0,
            embed_dim=16, use_summary_token=True, use_local_prompts=True,
            use_global_prompts=True, num_global_prompts=2)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def forced_kernels():
    """The JAX Pallas kernels in interpret mode; the flag is process-global
    (xdist runs other files in the same worker), so it is reset here."""
    jim.force_tpu_kernels(True)
    assert jim.kernels_active()
    yield
    jim.force_tpu_kernels(False)


@pytest.fixture(scope="module")
def models():
    tf = np.random.RandomState(0).randn(3, 16).astype(np.float32)
    jmodel = JVitaClip(JVitaClipConfig(vision=JVisionConfig(**TINY),
                                       num_classes=3,
                                       zeroshot_evaluation=True),
                       zeroshot_text_features=tf)
    cfg = VitaClipConfig(vision=VisionConfig(**TINY), num_classes=3)
    model = VitaClip(cfg, params_from_jax(jmodel.params, cfg),
                     torch.from_numpy(tf))
    return jmodel, model


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _both(a, dtype):
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def _qweight(rs, K, N):
    w = rs.randn(K, N) * K ** -0.5
    w[rs.choice(K, max(1, K // 50), replace=False)] *= 16
    q, s = jquant.quantize_weight(w)
    return (jnp.asarray(q), jnp.asarray(s)), (torch.from_numpy(q),
                                              torch.from_numpy(s))


def _assert_gemm_close(out_t, out_j, dtype):
    a, b = _np(out_t), _np(out_j)
    assert a.shape == b.shape and np.isfinite(a).all()
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    else:
        assert np.all(np.abs(a - b) <= _bf16_ulp(np.maximum(abs(a), abs(b))))


def _clips(seed, n):
    return np.random.RandomState(seed).randint(0, 255, (n, 2, 32, 32, 3),
                                               np.uint8)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# the GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(37, 96, 77), (300, 64, 40)])
def test_int8_matmul_plain_matches_jax_kernel(M, K, N, dtype):
    """The Pallas body (`int8_matmul` is interpret mode off the TPU): the
    same dequantized weights bit for bit, sums in another order."""
    rs = np.random.RandomState(0)
    xj, xt = _both(rs.randn(M, K), dtype)
    (qj, sj), (qt, st) = _qweight(rs, K, N)
    out_j = jim.int8_matmul(xj, qj, sj)
    out_t = tim.int8_matmul(xt, {"q": qt, "scale": st})
    assert out_t.dtype == TDT[dtype] and out_t.shape == (M, N)
    _assert_gemm_close(out_t, out_j, dtype)
    w_j = (qj.astype(jnp.float32) * sj).astype(JDT[dtype])
    np.testing.assert_array_equal(
        _np(tim.dequant_weight(qt, st, TDT[dtype])), _np(w_j))


def test_dequant_follows_the_kernel_not_the_fallback():
    """One rounding per weight (fp32 product, then the cast), not the JAX
    XLA fallback's bf16(q) * bf16(scale): the two differ in some weights."""
    rs = np.random.RandomState(1)
    _, (q, s) = _qweight(rs, 64, 48)
    w = tim.dequant_weight(q, s, torch.bfloat16)
    torch.testing.assert_close(w, (q.float() * s).to(torch.bfloat16),
                               rtol=0, atol=0)
    fallback = q.to(torch.bfloat16) * s.to(torch.bfloat16)
    assert (w != fallback).float().mean() > 0.05
    # and never by more than the weight's own rounding
    assert ((w.float() - fallback.float()).abs()
            <= 2 * torch.from_numpy(_bf16_ulp(w.float().numpy()))).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_linear_matches_jax_kernel_and_fallback(forced_kernels,
                                                          dtype):
    """Batch dims and the bias added after the GEMM in the output dtype.
    Against the forced Pallas path: summation noise only. Against the XLA
    fallback (kernels not forced): also the fallback's other dequant
    rounding, a few bf16 ulp of the output's scale."""
    rs = np.random.RandomState(2)
    K, N = 64, 40
    xj, xt = _both(rs.randn(2, 7, K), dtype)
    (qj, sj), (qt, st) = _qweight(rs, K, N)
    b = rs.randn(N).astype(np.float32) * 0.1
    jp = {"kernel": {"q": qj, "scale": sj}, "bias": jnp.asarray(b)}
    tp = {"kernel": {"q": qt, "scale": st}, "bias": torch.from_numpy(b)}
    out_t = tim.quantized_linear(tp, xt)
    assert out_t.shape == (2, 7, N) and out_t.dtype == TDT[dtype]
    _assert_gemm_close(out_t, jim.quantized_linear(jp, xj), dtype)
    np.testing.assert_array_equal(_np(tlin.linear(tp, xt)), _np(out_t))
    _assert_gemm_close(tlin.linear(tp, xt), jlinear(jp, xj), dtype)
    jim.force_tpu_kernels(False)
    fallback = _np(jim.quantized_linear(jp, xj))
    tol = 1e-5 if dtype == "float32" else \
        4 * 2.0 ** -8 * np.abs(fallback).max()
    np.testing.assert_allclose(_np(out_t), fallback, atol=tol)
    # no bias
    out_nb = tim.quantized_linear({"kernel": tp["kernel"]}, xt)
    _assert_gemm_close(out_nb, jim.int8_matmul(xj.reshape(-1, K), qj, sj)
                       .reshape(2, 7, N), dtype)


@pytest.mark.parametrize("residual", [True, False])
def test_mlp_block_on_w8_leaves_matches_jax(forced_kernels, residual):
    """'q' leaves take the plain branch of `mlp_block`: LayerNorm, then each
    linear through the w8 GEMM, as in the JAX package (its fused MLP is for
    'qa' leaves only). bf16: both sides round the hidden and the output to
    bf16; LayerNorm and GEMM sums differ in order."""
    rs = np.random.RandomState(3)
    K, Hd = 32, 64
    xj, xt = _both(rs.randn(2, 7, K), "bfloat16")
    (q1j, s1j), (q1t, s1t) = _qweight(rs, K, Hd)
    (q2j, s2j), (q2t, s2t) = _qweight(rs, Hd, K)
    b1, b2 = (rs.randn(n).astype(np.float32) * 0.02 for n in (Hd, K))
    ln = (rs.rand(K) + 0.5).astype(np.float32), \
        (rs.randn(K) * 0.1).astype(np.float32)
    jp = {"fc1": {"kernel": {"q": q1j, "scale": s1j}, "bias": jnp.asarray(b1)},
          "fc2": {"kernel": {"q": q2j, "scale": s2j}, "bias": jnp.asarray(b2)}}
    tp = {"fc1": {"kernel": {"q": q1t, "scale": s1t},
                  "bias": torch.from_numpy(b1)},
          "fc2": {"kernel": {"q": q2t, "scale": s2t},
                  "bias": torch.from_numpy(b2)}}
    out_j = jmlp_block(jp, {"scale": jnp.asarray(ln[0]),
                            "bias": jnp.asarray(ln[1])}, xj, jquick_gelu,
                       residual=xj if residual else None)
    out_t = tlin.mlp_block(tp, {"scale": torch.from_numpy(ln[0]),
                                "bias": torch.from_numpy(ln[1])}, xt,
                           quick_gelu, residual=xt if residual else None)
    assert out_t.shape == (2, 7, K) and out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=0.05)
    assert np.mean(np.abs(_np(out_t) - _np(out_j)) > 0.02) < 0.02
    np.testing.assert_array_equal(
        _np(tlin.mlp(tp, xt, quick_gelu)),
        _np(tlin.linear(tp["fc2"], quick_gelu(tlin.linear(tp["fc1"], xt)))))


def test_w8_wrappers_need_cuda_and_kernel_layout():
    rs = np.random.RandomState(4)
    _, (q, s) = _qweight(rs, 16, 8)
    leaf = tim.with_kernel_layout({"q": q, "scale": s})
    assert set(leaf) == {"q", "scale", "q_t"}
    assert leaf["q_t"].is_contiguous() and leaf["q_t"].shape == (1, 1, 8192)
    assert torch.equal(tim.w8_layout_inverse(leaf["q_t"], 16, 8), q)
    x = torch.from_numpy(rs.randn(4, 16).astype(np.float32)).bfloat16()
    tim.reset_launch_counts()
    assert tim.int8_matmul(x, leaf).shape == (4, 8)      # CPU: plain version
    assert tim.launch_counts["int8_matmul"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tim.int8_matmul_cuda(x, leaf)
    with pytest.raises(ValueError, match="impl"):
        tim.int8_matmul(x.to("meta"), leaf, impl="fast")
    assert tim._kernel_weight("t", leaf, 16, 8, key="q_t") is leaf["q_t"]
    with pytest.raises(ValueError, match="q_t"):
        tim._kernel_weight("t", {"q": q, "scale": s}, 16, 8, key="q_t")
    with pytest.raises(ValueError, match="w8 kernel layout"):
        tim._kernel_weight("t", {"q_t": q.t().contiguous()}, 16, 8,
                           key="q_t")
    # a LayerNorm's {'scale', 'bias'} is no quantized leaf
    ln = {"scale": torch.ones(4), "bias": torch.zeros(4)}
    assert set(tim.with_kernel_layout({"norm": ln})["norm"]) == {"scale",
                                                                 "bias"}


@pytest.mark.parametrize("K,N", [(768, 3072), (3072, 768), (100, 33),
                                 (776, 130), (64, 128), (1, 1)])
def test_w8_kernel_layout_inverts(K, N):
    """The w8 kernel's weight tiles hold W exactly: ceil(N / 128) x
    ceil(K / 64) tiles of 8,192 bytes, and the inverse gives W back."""
    w = torch.randint(-127, 128, (K, N), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(K * N))
    tiles = tim.w8_kernel_layout(w)
    assert tiles.shape == (-(-N // 128), -(-K // 64), 8192)
    assert tiles.is_contiguous() and tiles.dtype == torch.int8
    assert torch.equal(tim.w8_layout_inverse(tiles, K, N), w)
    # the padding is zeros: only the real weights are non-zero
    assert int((tiles != 0).sum()) == int((w != 0).sum())


def test_w8_kernel_layout_fragment_order():
    """Inside a tile, lane (g, t) of the warp of slab s finds at byte
    ((s * 2 + h) * 32 + lane) * 16 the A fragments of k16 steps 2h and
    2h + 1: for each, W^T rows g, g + 8 at k 2t, 2t + 1, then at k + 8, in
    the order the kernel's dequantization unpacks them
    (csrc/w8_matmul.cu load_a)."""
    w = torch.randint(-127, 128, (64, 128), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(1))
    tile, wt = tim.w8_kernel_layout(w)[0, 0], w.t()
    for s, h, lane in ((0, 0, 0), (3, 1, 13), (7, 1, 31), (5, 0, 22)):
        g, t = lane >> 2, lane & 3
        base = ((s * 2 + h) * 32 + lane) * 16
        for jj in range(2):
            k = 16 * (2 * h + jj) + 2 * t
            want = [wt[s * 16 + g + 8 * r8, k + 8 * kh + e]
                    for kh in range(2) for r8 in range(2) for e in range(2)]
            got = tile[base + 8 * jj: base + 8 * jj + 8]
            assert got.tolist() == [int(x) for x in want]


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", ["", "w8", "w8a8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", None])
def test_prepare_inference_params_matches_jax(models, quantize, dtype):
    """Bit-equal codes and scales, and the dtype of every leaf: float leaves
    go to the compute dtype, int8 stays int8, the scales of quantized leaves
    stay fp32, LayerNorm scales are cast like any float leaf."""
    jmodel, model = models
    jd, td = (None, None) if dtype is None else (JDT[dtype], TDT[dtype])
    ref = _flatten(jquant.prepare_inference_params(
        jmodel.params, quantize=quantize, compute_dtype=jd))
    ours_t = tquant.prepare_inference_params(
        model.param_tree(), quantize=quantize, compute_dtype=td)
    ours = _flatten(params_to_jax(ours_t))
    assert ours.keys() == ref.keys()
    key = {"": None, "w8": "q", "w8a8": "qa"}[quantize]
    assert (f"visual.blocks.attn.q.kernel.{key}" in ours) == bool(quantize)
    cast = dtype == "bfloat16"
    for k, r in ref.items():
        r = np.asarray(jnp.asarray(r, jnp.float32)) if \
            r.dtype == jnp.bfloat16 else np.asarray(r)
        assert ours[k].dtype == r.dtype, k          # bf16 crosses as fp32
        np.testing.assert_array_equal(ours[k], r, err_msg=k)
    flat_t = {n: v.dtype for n, v in _named(ours_t)}
    want_float = torch.bfloat16 if cast else torch.float32
    for n, d in flat_t.items():
        if n.endswith((".q", ".qa")):
            assert d == torch.int8, n
        elif n.endswith("kernel.scale") or n.endswith("kernel_q8.scale"):
            assert d == torch.float32, n
        else:
            assert d == want_float, n
    assert flat_t["visual.blocks.0.norm1.scale"] == want_float
    with pytest.raises(ValueError, match="quantize"):
        tquant.prepare_inference_params(model.param_tree(), quantize="w4")


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _named(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("act_quant", [False, True])
def test_quantization_error_matches_jax(models, act_quant):
    """The port's tree holds one kernel per layer where the JAX tree stacks
    them, so the port's maximum runs over layers too: it equals the JAX
    function applied layer by layer, and is no smaller than the JAX value
    over the stacked leaves."""
    jmodel, model = models
    jq = jquant.quantize_tower_params(jmodel.params, act_quant=act_quant)
    pooled = jquant.quantization_error(jmodel.params, jq)
    per_layer = max(
        jquant.quantization_error(
            {"blocks": _layer(jmodel.params["visual"]["blocks"], i)},
            {"blocks": _layer(jq["visual"]["blocks"], i)})
        for i in range(TINY["layers"]))
    tree = model.param_tree()
    ours = tquant.quantization_error(
        tree, tquant.quantize_tower_params(tree, act_quant=act_quant))
    assert 0 < pooled <= ours < 0.05
    np.testing.assert_allclose(ours, per_layer, rtol=1e-5)
    # a tree with no quantized leaf must not read as a perfect 0.0
    with pytest.raises(ValueError, match="no quantized leaves"):
        tquant.quantization_error(tree, tree)


@pytest.mark.parametrize("quantize", ["w8", "w8a8"])
def test_quant_helpers_accept_kernel_layout(models, quantize):
    """A tree that already carries the W^T copies of its int8 weights is
    still a quantized tree: its scales stay fp32 under the cast, its error
    is the one of the tree without the copies, and it dequantizes to the
    same float kernels."""
    tree = models[1].param_tree()
    q = tquant.prepare_inference_params(tree, quantize=quantize)
    laid = tim.with_kernel_layout(q)
    cast = tquant.prepare_inference_params(laid,
                                           compute_dtype=torch.bfloat16)
    leaf = cast["visual"]["blocks"][0]["attn"]["q"]["kernel"]
    key = "q" if quantize == "w8" else "qa"
    assert set(leaf) == {key, "scale", key + "_t"}
    assert leaf["scale"].dtype == torch.float32
    assert leaf[key + "_t"].dtype == torch.int8
    assert cast["visual"]["blocks"][0]["norm1"]["scale"].dtype == \
        torch.bfloat16
    assert tquant.quantization_error(tree, laid) == \
        tquant.quantization_error(tree, q)
    a = tquant.dequantize_tree(laid, torch.float32)
    b = tquant.dequantize_tree(q, torch.float32)
    for (na, va), (nb, vb) in zip(_named(a), _named(b)):
        assert na == nb and torch.equal(va, vb), na


def test_bridge_round_trip_w8_tree(models):
    """JAX w8 tree -> port (per-layer {'q', 'scale'}, int8 / fp32, no
    patch-embed sidecar) -> JAX layout: exactly the tree it came from."""
    jmodel, model = models
    jq = jquant.quantize_tower_params(jmodel.params, act_quant=False)
    params = params_from_jax(jq, model.cfg)
    leaf = params["visual"]["blocks"][1]["mlp"]["fc2"]["kernel"]
    assert set(leaf) == {"q", "scale"}
    assert leaf["q"].dtype == torch.int8 and leaf["q"].shape == (64, 32)
    assert leaf["scale"].dtype == torch.float32 and \
        leaf["scale"].shape == (1, 32)
    assert "kernel_q8" not in params["visual"]["patch_embed"]
    back, ref = _flatten(params_to_jax(params)), _flatten(jq)
    assert back.keys() == ref.keys()
    for k in ref:
        assert back[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(back[k], np.asarray(ref[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the classifier and the server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize,patch_major,attn_impl",
                         [("w8", False, "flash"), (True, True, "flash"),
                          ("w8", False, "xla")])
def test_w8_classifier_matches_jax(models, forced_kernels, quantize,
                                   patch_major, attn_impl):
    """6 clips at batch 4 (a full and a padded bucket) through both
    classifiers, the JAX one with its Pallas GEMM forced (interpret mode).
    The dequantized weights are equal bit for bit; the two frameworks round
    the bf16 activations between ops at other places. Limits as for the
    w8a8 classifier: 2e-3 on the probabilities, 0.15 on their logs."""
    jmodel, model = models
    clips = _clips(1, 6)
    p_j = JVideoClassifier.from_model(
        jmodel, NAMES, batch_size=4, quantize=quantize, attn_impl=attn_impl,
        patch_major=patch_major).classify_clips(clips)
    tim.reset_launch_counts()
    tflash.reset_launch_counts()
    clf = VideoClassifier.from_model(
        model, NAMES, batch_size=4, quantize=quantize, attn_impl=attn_impl,
        patch_major=patch_major, device="cpu")
    p_t = clf.classify_clips(clips)
    assert clf.quantize == "w8"
    assert set(tim.launch_counts.values()) == {0}       # CPU: plain versions
    assert set(tflash.launch_counts.values()) == {0}
    assert p_t.shape == (6, 3) and p_t.dtype == np.float32
    np.testing.assert_allclose(p_t.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(p_t, p_j, atol=2e-3)
    np.testing.assert_allclose(np.log(p_t), np.log(p_j), atol=0.15)


@pytest.mark.parametrize("patch_major", [False, True])
def test_w8_classifier_matches_jax_f32(models, forced_kernels, patch_major):
    """The w8 classifier in fp32 (compute_dtype float32, the dtype of an
    fp32 run's `cli.evaluate --quantize_eval w8`): the JAX one with its
    Pallas GEMM forced in fp32 against the port's, which on the card runs
    csrc/w8_matmul_f32.cu (its plain version here). The same dequantized
    weights and fp32 sums in other orders, ~1e-7 of a value, which the
    logit scale (100) carries into the logs of the probabilities (4e-6
    measured): 1e-6 on the probabilities, 5e-5 on their logs."""
    jmodel, model = models
    clips = _clips(2, 6)
    p_j = JVideoClassifier.from_model(
        jmodel, NAMES, batch_size=4, quantize="w8", patch_major=patch_major,
        compute_dtype=jnp.float32).classify_clips(clips)
    tim.reset_launch_counts()
    clf = VideoClassifier.from_model(
        model, NAMES, batch_size=4, quantize="w8", patch_major=patch_major,
        compute_dtype=torch.float32, device="cpu")
    p_t = clf.classify_clips(clips)
    assert set(tim.launch_counts.values()) == {0}       # CPU: plain versions
    assert p_t.shape == (6, 3) and p_t.dtype == np.float32
    np.testing.assert_allclose(p_t, p_j, atol=1e-6)
    np.testing.assert_allclose(np.log(p_t), np.log(p_j), atol=5e-5)


def test_w8_classifier_weights(models):
    """In w8 mode nothing is cast to bf16: int8 kernels under attn / mlp
    with the tiles their CUDA kernel reads, fp32 scales and every other leaf
    fp32; no patch-embed sidecar even with patch_major (the embed stays the
    float GEMM on the folded kernel)."""
    clf = VideoClassifier.from_model(models[1], NAMES, batch_size=2,
                                     quantize="w8", patch_major=True,
                                     device="cpu")
    params = dict(clf.net.visual.named_parameters())
    dtypes = {n: p.dtype for n, p in params.items()}
    assert dtypes["blocks.0.attn.q.kernel.q"] == torch.int8
    assert dtypes["blocks.0.attn.q.kernel.scale"] == torch.float32
    assert dtypes["blocks.0.summary_attn.q.kernel"] == torch.float32
    assert dtypes["patch_embed.kernel"] == torch.float32
    assert torch.bfloat16 not in dtypes.values()
    assert not any("kernel_q8" in n or n.endswith(".qa") for n in dtypes)
    q = [n for n in dtypes if n.endswith(".q")]
    assert len(q) == 6 * len(clf.net.visual.blocks)
    for n in q:
        wt, (K, N) = params[n + "_t"], params[n].shape
        assert wt.is_contiguous() and torch.equal(
            tim.w8_layout_inverse(wt, K, N), params[n]), n
    with pytest.raises(ValueError, match="quantize"):
        VideoClassifier.from_model(models[1], NAMES, quantize="w4",
                                   device="cpu")


def test_server_quantize_w8(models, monkeypatch, tmp_path):
    """`server --quantize w8` builds a w8 classifier and serves it."""
    classes = tmp_path / "classes.txt"
    classes.write_text("\n".join(NAMES) + "\n")
    monkeypatch.setattr(tflagship, "build_zero_shot",
                        lambda num_frames, num_classes, text_features=None,
                        device=None: models[1])
    httpd = tserver.make_server(
        ["--host", "127.0.0.1", "--port", "0", "--classes", str(classes),
         "--num_frames", "2", "--batch_size", "2", "--quantize", "w8",
         "--device", "cpu"])
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        clf = httpd.batcher.clf
        assert clf.quantize == "w8" and not clf.patch_major
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        clip = _clips(4, 1)[0]
        req = urllib.request.Request(base + "/v1/classify_clip_raw",
                                     data=clip.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert len(body["probs"]) == 3 and body["label"] in NAMES
        ref = VideoClassifier.from_model(
            models[1], NAMES, batch_size=2, quantize="w8",
            device="cpu").classify_clips(clip[None])[0]
        np.testing.assert_allclose(body["probs"], ref, atol=1e-6)
    finally:
        stop_server(httpd, th)
    with pytest.raises(SystemExit):
        tserver.make_server(["--quantize", "w4", "--device", "cpu"])
