"""The port's w8a8 serving slice on the CPU: VideoClassifier(quantize="w8a8")
against the JAX classifier with its Pallas kernels forced (interpret mode),
also with the fused-extras and the int8 QK^T switches set on both sides, the
quantized weights and the bridge bit for bit, and the server's
`--quantize w8a8`."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from gava_clip_tpu.models.vision import VisionConfig as JVisionConfig
from gava_clip_tpu.models.vision import \
    fold_normalize_into_patch_embed as jfold
from gava_clip_tpu.models.vita_clip import VitaClip as JVitaClip
from gava_clip_tpu.models.vita_clip import VitaClipConfig as JVitaClipConfig
from gava_clip_tpu.ops.extras_kernel import set_fused_extras as jset_fused
from gava_clip_tpu.ops.flash_attention import set_int8_qk as jset_int8_qk
from gava_clip_tpu.ops.int8_matmul import force_tpu_kernels, kernels_active
from gava_clip_tpu.ops.quant import quantize_tower_params as jquantize
from gava_clip_tpu.serve import VideoClassifier as JVideoClassifier
from gava_clip_tpu_torch import server as tserver
from gava_clip_tpu_torch.data.device_preprocess import CLIP_MEAN, CLIP_STD
from gava_clip_tpu_torch.models.vision import VisionConfig
from gava_clip_tpu_torch.models.vision import fold_normalize_into_patch_embed
from gava_clip_tpu_torch.models.vita_clip import VitaClip, VitaClipConfig
from gava_clip_tpu_torch.ops import extras_kernel as tek
from gava_clip_tpu_torch.ops import flash_attention as tflash
from gava_clip_tpu_torch.ops import int8_matmul as tim
from gava_clip_tpu_torch.ops.quant import quantize_tower_params
from gava_clip_tpu_torch.serve import VideoClassifier
from gava_clip_tpu_torch.utils import flagship as tflagship
from gava_clip_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax
from tests.test_torch_bounds import module_deadline, stop_server  # noqa: F401

NAMES = ["normal", "slight", "moderate"]
TINY = dict(input_size=(32, 32), num_frames=2, feature_dim=32,
            patch_size=(16, 16), heads=2, layers=2, mlp_factor=2.0,
            embed_dim=16, use_summary_token=True, use_local_prompts=True,
            use_global_prompts=True, num_global_prompts=2)


@pytest.fixture
def forced_kernels():
    force_tpu_kernels(True)
    assert kernels_active()
    yield
    force_tpu_kernels(False)


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


@pytest.fixture(scope="module")
def clf(models):
    return VideoClassifier.from_model(models[1], NAMES, batch_size=4,
                                      quantize="w8a8", patch_major=True,
                                      attn_impl="flash",
                                      device="cpu").warmup()


def _clips(seed, n):
    return np.random.RandomState(seed).randint(0, 255, (n, 2, 32, 32, 3),
                                               np.uint8)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("patch_major", [True, False])
def test_w8a8_classifier_matches_jax(models, forced_kernels, patch_major):
    """6 clips at batch 4 (a full and a padded bucket). Both sides run the
    same int8 codes through the same fp32 epilogues; they differ where the
    two frameworks round the bf16 activations between the fused ops (the
    prompt extras, the embeddings, LayerNorm sums): measured ~1e-5 on the
    probabilities and <= 0.08 on the log-probabilities (logits span ~11).
    Limits: 2e-3 on the probabilities (the JAX package's own forced-vs-
    fallback bound), 0.15 on the log-probabilities."""
    jmodel, model = models
    clips = _clips(1, 6)
    p_j = JVideoClassifier.from_model(
        jmodel, NAMES, batch_size=4, quantize="w8a8", attn_impl="flash",
        patch_major=patch_major).classify_clips(clips)
    tim.reset_launch_counts()
    p_t = VideoClassifier.from_model(
        model, NAMES, batch_size=4, quantize="w8a8", attn_impl="flash",
        patch_major=patch_major, device="cpu").classify_clips(clips)
    assert set(tim.launch_counts.values()) == {0}   # CPU: plain versions
    assert p_t.shape == (6, 3) and p_t.dtype == np.float32
    np.testing.assert_allclose(p_t.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(p_t, p_j, atol=2e-3)
    np.testing.assert_allclose(np.log(p_t), np.log(p_j), atol=0.15)


def test_w8a8_classifier_past_640_keys_matches_jax(forced_kernels):
    """Frames of 416^2: 676 patch tokens + the class token + 2 global, 1
    summary and 2 local prompt rows, 682 keys a frame row, past the packed
    path's 640 (the port raised there until the fused attention took any
    key length). 3 clips at batch 2, patch-major. Limits: 0.15 on the
    log-probabilities, as test_w8a8_classifier_matches_jax, and 1e-2 on
    the probabilities: with 676 tokens a frame the two frameworks' bf16
    roundings between the fused ops move the probabilities more than at
    32^2, measured 4.4e-3 here and 6.3e-3 at 384^2, whose 582 keys never
    leave the packed path (the key length is not what moves them)."""
    size = dict(TINY, input_size=(416, 416))
    tf = np.random.RandomState(4).randn(3, 16).astype(np.float32)
    jmodel = JVitaClip(JVitaClipConfig(vision=JVisionConfig(**size),
                                       num_classes=3,
                                       zeroshot_evaluation=True),
                       zeroshot_text_features=tf)
    cfg = VitaClipConfig(vision=VisionConfig(**size), num_classes=3)
    model = VitaClip(cfg, params_from_jax(jmodel.params, cfg),
                     torch.from_numpy(tf))
    clips = np.random.RandomState(5).randint(0, 255, (3, 2, 416, 416, 3),
                                             np.uint8)
    p_j = JVideoClassifier.from_model(
        jmodel, NAMES, batch_size=2, quantize="w8a8", attn_impl="flash",
        patch_major=True).classify_clips(clips)
    p_t = VideoClassifier.from_model(
        model, NAMES, batch_size=2, quantize="w8a8", attn_impl="flash",
        patch_major=True, device="cpu").classify_clips(clips)
    assert p_t.shape == (3, 3) and np.isfinite(p_t).all()
    np.testing.assert_allclose(p_t, p_j, atol=1e-2)
    np.testing.assert_allclose(np.log(p_t), np.log(p_j), atol=0.15)


@pytest.mark.parametrize("fused,int8_qk", [(True, False), (False, True),
                                           (True, True)])
def test_w8a8_classifier_switches_match_jax(models, forced_kernels, fused,
                                            int8_qk):
    """The two kernel switches of the w8a8 block, set on both sides: the
    fused prompt extras (fp32 arithmetic in place of bf16 stock ops) and the
    int8 QK^T scores. Same limits as the unswitched classifier; and each
    switch really changes the port's result, and is off again afterwards."""
    jmodel, model = models
    clips = _clips(1, 6)
    kw = dict(batch_size=4, quantize="w8a8", attn_impl="flash",
              patch_major=True)
    clf = VideoClassifier.from_model(model, NAMES, device="cpu", **kw)
    p_off = clf.classify_clips(clips)
    jset_fused(fused)
    jset_int8_qk(int8_qk)
    tek.set_fused_extras(fused)
    tflash.set_int8_qk(int8_qk)
    try:
        p_j = JVideoClassifier.from_model(jmodel, NAMES,
                                          **kw).classify_clips(clips)
        tek.reset_launch_counts()
        p_t = clf.classify_clips(clips)         # the flags are read per call
    finally:
        jset_fused(False)
        jset_int8_qk(False)
        tek.set_fused_extras(False)
        tflash.set_int8_qk(False)
    assert tek.launch_counts["fused_extras"] == 0       # CPU: plain version
    np.testing.assert_allclose(p_t.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(p_t, p_j, atol=2e-3)
    np.testing.assert_allclose(np.log(p_t), np.log(p_j), atol=0.15)
    assert np.abs(p_t - p_off).max() > 0
    np.testing.assert_allclose(p_t, p_off, atol=5e-3)
    np.testing.assert_array_equal(clf.classify_clips(clips), p_off)


def test_w8a8_unfused_attention_matches_fused(models):
    """attn_impl='xla' keeps the fused qkv and MLP ops but runs plain
    attention and the w8a8 out-projection as a separate linear (the JAX
    path with kernels and a non-flash attention): the same model up to the
    bf16 rounding of the attention output."""
    clips = _clips(5, 2)
    kw = dict(batch_size=2, quantize="w8a8", patch_major=True, device="cpu")
    p_f = VideoClassifier.from_model(models[1], NAMES, attn_impl="flash",
                                     **kw).classify_clips(clips)
    p_x = VideoClassifier.from_model(models[1], NAMES, attn_impl="xla",
                                     **kw).classify_clips(clips)
    np.testing.assert_allclose(p_x, p_f, atol=2e-3)


@pytest.mark.parametrize("act_quant", [True, False])
def test_quantize_tower_params_bit_equal_jax(models, act_quant):
    """int8 values, fp32 scales and (w8a8) the patch-embed sidecar of the
    FOLDED kernel, leaf for leaf and bit for bit, from the same folded
    tree; and the sidecar from the port's own fold equals JAX's (the folded
    kernel is an elementwise division on both sides; only the folded bias
    sums in another order)."""
    jmodel, model = models
    jp = dict(jmodel.params)
    jp["visual"] = dict(jp["visual"], patch_embed=jfold(
        jp["visual"]["patch_embed"], CLIP_MEAN, CLIP_STD, (16, 16)))
    tp = params_from_jax(jp, model.cfg)
    ours = _flatten(params_to_jax(quantize_tower_params(tp, act_quant)))
    ref = _flatten(jquantize(jp, act_quant=act_quant))
    assert ours.keys() == ref.keys()
    key = "qa" if act_quant else "q"
    assert f"visual.blocks.attn.q.kernel.{key}" in ours
    assert ("visual.patch_embed.kernel_q8.qa" in ours) == act_quant
    assert "visual.blocks.summary_attn.q.kernel" in ours    # stays float
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    own = model.param_tree()
    own["visual"]["patch_embed"] = fold_normalize_into_patch_embed(
        own["visual"]["patch_embed"], CLIP_MEAN, CLIP_STD, (16, 16))
    own = _flatten(params_to_jax(quantize_tower_params(own, act_quant)))
    for k in ("visual.patch_embed.kernel_q8.qa",
              "visual.patch_embed.kernel_q8.scale"):
        if act_quant:
            np.testing.assert_array_equal(own[k], ref[k], err_msg=k)


def test_bridge_round_trip_quantized_tree(models):
    """JAX w8a8 tree -> port (per-layer {'qa', 'scale'}, int8 / fp32) ->
    JAX layout: exactly the tree it came from."""
    jmodel, model = models
    jq = _flatten(jquantize(jmodel.params, act_quant=True))
    params = params_from_jax(jquantize(jmodel.params, act_quant=True),
                             model.cfg)
    leaf = params["visual"]["blocks"][1]["mlp"]["fc2"]["kernel"]
    assert leaf["qa"].dtype == torch.int8 and leaf["qa"].shape == (64, 32)
    assert leaf["scale"].dtype == torch.float32 and \
        leaf["scale"].shape == (1, 32)
    assert params["visual"]["patch_embed"]["kernel_q8"]["qa"].dtype == \
        torch.int8
    back = _flatten(params_to_jax(params))
    assert back.keys() == jq.keys()
    for k in jq:
        assert back[k].dtype == jq[k].dtype, k
        np.testing.assert_array_equal(back[k], jq[k], err_msg=k)


def test_w8a8_classifier_weights_and_impls(clf, models):
    """In w8a8 mode nothing is cast to bf16: int8 kernels, fp32 scales,
    LayerNorms, biases and embeddings; the sidecar quantizes the folded
    kernel; every int8 weight carries the W^T its CUDA kernel reads."""
    dtypes = {n: p.dtype for n, p in clf.net.visual.named_parameters()}
    assert dtypes["blocks.0.attn.q.kernel.qa"] == torch.int8
    assert dtypes["blocks.0.attn.q.kernel.scale"] == torch.float32
    assert dtypes["blocks.0.norm1.scale"] == torch.float32
    assert dtypes["patch_embed.kernel_q8.qa"] == torch.int8
    assert torch.bfloat16 not in dtypes.values()
    folded = fold_normalize_into_patch_embed(
        models[1].param_tree()["visual"]["patch_embed"], CLIP_MEAN,
        CLIP_STD, (16, 16))
    q8 = clf.net.visual.patch_embed.kernel_q8
    np.testing.assert_array_equal(
        q8.qa.numpy(), quantize_tower_params(
            {"visual": {"patch_embed": folded}},
            act_quant=True)["visual"]["patch_embed"]["kernel_q8"]["qa"])
    qa = [n for n in dtypes if n.endswith(".qa")]
    assert len(qa) == 1 + 6 * len(clf.net.visual.blocks)
    params = dict(clf.net.visual.named_parameters())
    for n in qa:
        wt = params[n + "_t"]
        assert wt.is_contiguous() and torch.equal(wt, params[n].t()), n


def test_w8a8_padding_and_counts(clf):
    clips = _clips(3, 6)
    tim.reset_launch_counts()
    tflash.reset_launch_counts()
    probs = clf.classify_clips(clips)
    np.testing.assert_array_equal(probs[:4], clf.classify_clips(clips[:4]))
    np.testing.assert_array_equal(probs[4:], clf.classify_clips(clips[4:]))
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert set(tim.launch_counts.values()) == {0}
    assert set(tflash.launch_counts.values()) == {0}


def test_server_quantize_w8a8(models, monkeypatch, tmp_path):
    """`server --quantize w8a8` builds a w8a8 classifier and serves it."""
    classes = tmp_path / "classes.txt"
    classes.write_text("\n".join(NAMES) + "\n")
    seen = {}

    def tiny_zero_shot(num_frames, num_classes, text_features=None,
                       backbone_path=None, device=None):
        seen["args"] = (num_frames, num_classes)
        return models[1]

    monkeypatch.setattr(tflagship, "build_zero_shot", tiny_zero_shot)
    httpd = tserver.make_server(
        ["--host", "127.0.0.1", "--port", "0", "--classes", str(classes),
         "--num_frames", "2", "--batch_size", "2", "--quantize", "w8a8",
         "--patch_major", "--device", "cpu"])
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        clf = httpd.batcher.clf
        assert clf.quantize == "w8a8" and clf.patch_major
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        clip = _clips(4, 1)[0]
        req = urllib.request.Request(base + "/v1/classify_clip_raw",
                                     data=clip.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert seen["args"] == (2, 3)
        assert len(body["probs"]) == 3 and body["label"] in NAMES
        ref = VideoClassifier.from_model(
            models[1], NAMES, batch_size=2, quantize="w8a8",
            patch_major=True, device="cpu").classify_clips(clip[None])[0]
        np.testing.assert_allclose(body["probs"], ref, atol=1e-6)
    finally:
        stop_server(httpd, th)


@pytest.mark.parametrize("flag,want", [("backbone.pt", "backbone.pt"),
                                       ("", None)])
def test_server_backbone_path_reaches_build_zero_shot(models, monkeypatch,
                                                      tmp_path, flag, want):
    """`server --backbone_path P` hands P to build_zero_shot, as the JAX
    server does; the default "" arrives as None (random weights)."""
    classes = tmp_path / "classes.txt"
    classes.write_text("\n".join(NAMES) + "\n")
    seen = {}

    def tiny_zero_shot(num_frames, num_classes, text_features=None,
                       backbone_path=None, device=None):
        seen["backbone_path"] = backbone_path
        return models[1]

    monkeypatch.setattr(tflagship, "build_zero_shot", tiny_zero_shot)
    argv = ["--host", "127.0.0.1", "--port", "0", "--classes", str(classes),
            "--num_frames", "2", "--batch_size", "2", "--device", "cpu"]
    if flag:
        argv += ["--backbone_path", str(tmp_path / flag)]
    httpd = tserver.make_server(argv)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        assert seen["backbone_path"] == (
            None if want is None else str(tmp_path / want))
    finally:
        stop_server(httpd, th)
