"""Parity of the PyTorch port's vision tower, zero-shot VitaClip, model
constructors and parameter bridge with the JAX package, on the CPU at a tiny
size."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gava_clip_tpu.models import vision as jvision
from gava_clip_tpu.models.vision import VisionConfig as JVisionConfig
from gava_clip_tpu.models.vita_clip import VitaClip as JVitaClip
from gava_clip_tpu.models.vita_clip import VitaClipConfig as JVitaClipConfig
from gava_clip_tpu.utils import flagship as jflagship
from gava_clip_tpu_torch.data.device_preprocess import (CLIP_MEAN, CLIP_STD,
                                                        normalize_frames)
from gava_clip_tpu_torch.models import vision as tvision
from gava_clip_tpu_torch.models.vision import VisionConfig
from gava_clip_tpu_torch.models.vita_clip import (VitaClip, VitaClipConfig,
                                                  init_vita_clip_params)
from gava_clip_tpu_torch.utils import flagship as tflagship
from gava_clip_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax
from tests.test_torch_bounds import module_deadline  # noqa: F401

TINY = dict(input_size=(32, 32), num_frames=2, feature_dim=32,
            patch_size=(16, 16), heads=2, layers=2, mlp_factor=2.0,
            embed_dim=16, use_summary_token=True, use_local_prompts=True,
            use_global_prompts=True, num_global_prompts=2)


@pytest.fixture(scope="module")
def pair():
    """A JAX zero-shot model and the port's config and params for it."""
    tf = np.random.RandomState(0).randn(3, 16).astype(np.float32)
    jcfg = JVitaClipConfig(vision=JVisionConfig(**TINY), num_classes=3,
                           zeroshot_evaluation=True)
    jmodel = JVitaClip(jcfg, zeroshot_text_features=tf)
    cfg = VitaClipConfig(vision=VisionConfig(**TINY), num_classes=3)
    return jmodel, cfg, params_from_jax(jmodel.params, cfg), tf


def _clips(seed, n=3, T=2, S=32):
    return np.random.RandomState(seed).randint(0, 256, (n, T, S, S, 3),
                                               dtype=np.uint8)


def _frames(u8):
    """Normalized float frames, made once in numpy for both sides."""
    mean, std = np.asarray(CLIP_MEAN, np.float32), np.asarray(CLIP_STD,
                                                              np.float32)
    return ((u8.astype(np.float32) / 255.0 - mean) / std).astype(np.float32)


def _tree_np(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_np(v, dtype) for k, v in tree.items()}
    return np.asarray(tree) if dtype is None else np.asarray(tree).astype(
        dtype)


def _jax_params(params, dtype):
    return {k: (_jax_params(v, dtype) if isinstance(v, dict)
                else jnp.asarray(v, jnp.float32).astype(dtype))
            for k, v in params.items()}


def _torch_params(tree, dtype):
    if isinstance(tree, dict):
        return {k: _torch_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_params(v, dtype) for v in tree]
    return tree.to(dtype)


# bf16: both sides run every product in bf16 with fp32 accumulation, but
# they round at other points (XLA fuses elementwise chains in fp32 before
# rounding where eager torch rounds each op), so after 2 blocks features
# and summaries differ by a few bf16 ulps at their largest magnitude (one
# ulp is 2**-7 of it, ~8e-3); compared relative to that magnitude
BF16_FEATURE_ATOL = 2e-2


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_encoder_matches_jax(pair, attn_impl, dtype):
    jmodel, cfg, params, _ = pair
    x = _frames(_clips(1))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jf, js = jvision.vision_encoder(_jax_params(jmodel.params["visual"], jd),
                                    jnp.asarray(x), jmodel.cfg.vision,
                                    compute_dtype=jd, attn_impl=attn_impl)
    tf_, ts = tvision.vision_encoder(_torch_params(params["visual"], td),
                                     torch.from_numpy(x), cfg.vision,
                                     compute_dtype=td, attn_impl=attn_impl)
    assert tf_.dtype == td and tf_.shape == (3, 16) and ts.shape == (3, 32)
    atol = 1e-4 if dtype == "float32" else BF16_FEATURE_ATOL
    for t, j in ((tf_, jf), (ts, js)):
        j = np.asarray(j, np.float32)
        scale = np.abs(j).max()
        np.testing.assert_allclose(t.float().numpy() / scale, j / scale,
                                   atol=atol)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_zero_shot_logits_match_jax(pair, attn_impl):
    jmodel, cfg, params, tf = pair
    x = _frames(_clips(2))
    out_j = jmodel.apply(jmodel.params, jmodel.buffers, jnp.asarray(x),
                         attn_impl=attn_impl)
    model = VitaClip(cfg, params, torch.from_numpy(tf))
    out_t = model(torch.from_numpy(x), attn_impl=attn_impl)
    np.testing.assert_allclose(out_t["logits"].numpy(),
                               np.asarray(out_j["logits"]), atol=1e-4)
    np.testing.assert_allclose(out_t["text_features"].numpy(),
                               np.asarray(out_j["text_features"]), atol=1e-6)
    np.testing.assert_allclose(out_t["summary"].numpy(),
                               np.asarray(out_j["summary"]), atol=1e-4)


def test_patches_input_with_folded_normalization(pair):
    jmodel, cfg, params, _ = pair
    u8 = _clips(3)
    pe_j = jvision.fold_normalize_into_patch_embed(
        jmodel.params["visual"]["patch_embed"], CLIP_MEAN, CLIP_STD)
    pe_t = tvision.fold_normalize_into_patch_embed(
        params["visual"]["patch_embed"], CLIP_MEAN, CLIP_STD)
    np.testing.assert_allclose(pe_t["kernel"].numpy(), pe_j["kernel"],
                               rtol=1e-6)
    np.testing.assert_allclose(pe_t["bias"].numpy(), pe_j["bias"],
                               atol=1e-5)
    jp = dict(jmodel.params["visual"], patch_embed=pe_j)
    tp = dict(params["visual"], patch_embed=pe_t)
    rows = jvision.patchify(u8, (16, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tvision.patchify(torch.from_numpy(u8), (16, 16)).numpy(),
        jvision.patchify(u8, (16, 16)))
    jf, _ = jvision.vision_encoder(_jax_params(jp, jnp.float32),
                                   jnp.asarray(rows), jmodel.cfg.vision,
                                   input_format="patches")
    tf_, _ = tvision.vision_encoder(tp, torch.from_numpy(rows), cfg.vision,
                                    input_format="patches")
    np.testing.assert_allclose(tf_.numpy(), np.asarray(jf), atol=1e-4)
    # the fold is exact: the same features as normalising the frames
    ff, _ = tvision.vision_encoder(
        params["visual"], normalize_frames(torch.from_numpy(u8), CLIP_MEAN,
                                           CLIP_STD), cfg.vision)
    np.testing.assert_allclose(tf_.numpy(), ff.numpy(), atol=1e-4)


def test_patch_embed_and_time_embed(pair):
    jmodel, cfg, params, _ = pair
    x = _frames(_clips(4, n=2)).reshape(4, 32, 32, 3)
    pe = jmodel.params["visual"]["patch_embed"]
    np.testing.assert_allclose(
        tvision.patch_embed(params["visual"]["patch_embed"],
                            torch.from_numpy(x), cfg.vision).numpy(),
        np.asarray(jvision.patch_embed(_jax_params(pe, jnp.float32),
                                       jnp.asarray(x), jmodel.cfg.vision)),
        atol=1e-5)
    te = np.random.RandomState(5).randn(8, 4).astype(np.float32)
    for T in (3, 8, 16):
        np.testing.assert_array_equal(
            tvision.resize_time_embed(torch.from_numpy(te), T).numpy(),
            np.asarray(jvision.resize_time_embed(jnp.asarray(te), T)))


def test_normalize_frames_matches_jax():
    from gava_clip_tpu.data.device_preprocess import \
        normalize_frames as jnormalize
    u8 = _clips(6)
    np.testing.assert_allclose(
        normalize_frames(torch.from_numpy(u8), CLIP_MEAN, CLIP_STD).numpy(),
        np.asarray(jnormalize(jnp.asarray(u8), CLIP_MEAN, CLIP_STD)),
        atol=1e-6)


def test_inject_clip_pathologies_bit_equal(pair):
    jmodel, cfg, params, _ = pair
    j = jflagship.inject_clip_pathologies(jmodel.params, seed=3)
    t = tflagship.inject_clip_pathologies(params, seed=3)
    jt, tt = _tree_np(j), params_to_jax(t)
    flat_j = _flatten(jt)
    flat_t = _flatten(tt)
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k], err_msg=k)
    # the input is not mutated
    np.testing.assert_array_equal(
        params["visual"]["blocks"][0]["norm1"]["scale"].numpy(),
        np.asarray(jmodel.params["visual"]["blocks"]["norm1"]["scale"][0]))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_bridge_round_trip_and_names(pair):
    jmodel, cfg, params, tf = pair
    back = _flatten(params_to_jax(params))
    ref = _flatten(_tree_np(jmodel.params))
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    model = VitaClip(cfg, params, torch.from_numpy(tf))
    names = dict(model.named_parameters())
    assert "visual.blocks.1.attn.q.kernel" in names
    assert names["visual.blocks.1.attn.q.kernel"].shape == (32, 32)
    assert not any(p.requires_grad for p in model.parameters())


def test_bridge_rejects_bad_trees(pair):
    jmodel, cfg, _, _ = pair
    p = _tree_np(jmodel.params)
    missing = dict(p, visual={k: v for k, v in p["visual"].items()
                              if k != "proj"})
    with pytest.raises(KeyError, match="missing leaves.*proj"):
        params_from_jax(missing, cfg)
    extra = dict(p, logit_bias=np.zeros(()))
    with pytest.raises(KeyError, match="unused leaves.*logit_bias"):
        params_from_jax(extra, cfg)
    bad = dict(p, visual=dict(p["visual"], proj=np.zeros((32, 17))))
    with pytest.raises(ValueError, match="proj"):
        params_from_jax(bad, cfg)
    blocks = dict(p["visual"]["blocks"], norm1={
        "scale": np.ones((3, 32)), "bias": np.zeros((3, 32))})
    with pytest.raises(ValueError, match="layer axis"):
        params_from_jax(dict(p, visual=dict(p["visual"], blocks=blocks)),
                        cfg)
    # w8a8 and weight-only leaves go across (tests/test_torch_serve_w8a8.py,
    # tests/test_torch_w8.py), and so does a frozen-training 'qt' leaf
    # (tests/test_torch_int8_train.py); a malformed one is refused
    for kind, scale, err, match in (
            ("q", (32,), ValueError, "int8"),
            ("qt", (1, 32), None, None),
            ("qa", (32,), ValueError, "int8")):
        quant = dict(p["visual"]["patch_embed"],
                     kernel={kind: np.zeros((768, 32), np.int8),
                             "scale": np.ones(scale, np.float32)})
        tree = dict(p, visual=dict(p["visual"], patch_embed=quant))
        if err is None:
            leaf = params_from_jax(tree, cfg)["visual"]["patch_embed"][
                "kernel"]
            assert set(leaf) == {"qt", "scale"}
            assert leaf["qt"].dtype == torch.int8
            assert leaf["scale"].dtype == torch.float32
            back = params_to_jax({"k": leaf})["k"]
            assert back["qt"].dtype == np.int8 and back["qt"].shape == (
                768, 32)
            continue
        with pytest.raises(err, match=match):
            params_from_jax(tree, cfg)


def test_init_matches_jax_shapes_and_limits(pair):
    jmodel, cfg, _, _ = pair
    gen = torch.Generator().manual_seed(0)
    params = init_vita_clip_params(gen, cfg)
    ours = _flatten(params_to_jax(params))
    ref = _flatten(_tree_np(jmodel.params))
    assert {k: v.shape for k, v in ours.items()} == \
        {k: v.shape for k, v in ref.items()}
    D = 32
    q = params["visual"]["blocks"][0]["attn"]["q"]["kernel"]
    assert q.abs().max() <= (6.0 / (D + D)) ** 0.5       # xavier
    cp = params["visual"]["blocks"][0]["cls_proj"]
    assert cp["kernel"].abs().max() <= D ** -0.5 and \
        cp["bias"].abs().max() <= D ** -0.5               # torch Linear
    lim = (6.0 / (3 * 16 * 16 + D)) ** 0.5                # VPT prompts
    assert params["visual"]["global_prompts"].abs().max() <= lim
    assert float(params["logit_scale"]) == float(jmodel.params["logit_scale"])
    # the same seed gives the same weights
    again = init_vita_clip_params(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(again["visual"]["proj"], params["visual"]["proj"])


def test_build_zero_shot_config():
    model = tflagship.build_zero_shot(num_frames=2, num_classes=5,
                                      input_size=32, device="cpu")
    v = model.cfg.vision
    ref = dataclasses.asdict(JVisionConfig(
        input_size=(32, 32), num_frames=2, feature_dim=768,
        patch_size=(16, 16), heads=12, layers=12, mlp_factor=4.0,
        embed_dim=512, use_summary_token=True, use_local_prompts=True,
        use_global_prompts=True, num_global_prompts=8))
    assert dataclasses.asdict(v) == ref
    # the same seeded text features as the JAX build_zero_shot draws
    tf = np.random.RandomState(0).randn(5, 512).astype(np.float32)
    np.testing.assert_array_equal(model.text_features.numpy(), tf)
