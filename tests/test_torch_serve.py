"""The PyTorch port's serving path on the CPU: VideoClassifier against the
JAX classifier, the HTTP server around it, and a JAX-free import."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gava_clip_tpu.models.vision import VisionConfig as JVisionConfig
from gava_clip_tpu.models.vita_clip import VitaClip as JVitaClip
from gava_clip_tpu.models.vita_clip import VitaClipConfig as JVitaClipConfig
from gava_clip_tpu.serve import VideoClassifier as JVideoClassifier
from gava_clip_tpu_torch.models.vision import VisionConfig
from gava_clip_tpu_torch.models.vita_clip import VitaClip, VitaClipConfig
from gava_clip_tpu_torch.serve import VideoClassifier
from gava_clip_tpu_torch.server import MicroBatcher, serve
from gava_clip_tpu_torch.utils.jax_bridge import params_from_jax
from tests.test_torch_bounds import module_deadline, stop_server  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["normal", "slight", "moderate"]
TINY = dict(input_size=(32, 32), num_frames=2, feature_dim=32,
            patch_size=(16, 16), heads=2, layers=2, mlp_factor=2.0,
            embed_dim=16, use_summary_token=True, use_local_prompts=True,
            use_global_prompts=True, num_global_prompts=2)


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
                                      device="cpu").warmup()


def _clips(seed, n):
    return np.random.RandomState(seed).randint(0, 255, (n, 2, 32, 32, 3),
                                               np.uint8)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_classify_clips_matches_jax(models, attn_impl):
    """6 clips at batch 4: a full batch and a bucket-of-2 partial batch.
    Both classifiers hold bf16 weights and run bf16 activations; their
    frameworks round intermediate results at other points; through the
    tiny model's 2 blocks that moves the probabilities by ~1e-5."""
    jmodel, model = models
    clips = _clips(1, 6)
    p_j = JVideoClassifier.from_model(jmodel, NAMES, batch_size=4,
                                      attn_impl=attn_impl).classify_clips(
                                          clips)
    p_t = VideoClassifier.from_model(model, NAMES, batch_size=4,
                                     attn_impl=attn_impl,
                                     device="cpu").classify_clips(clips)
    assert p_t.shape == (6, 3) and p_t.dtype == np.float32
    np.testing.assert_allclose(p_t.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(p_t, p_j, atol=1e-4)


def test_padding_and_buckets(clf, models):
    clips = _clips(2, 6)
    probs = clf.classify_clips(clips)
    # padding repeats the last clip and never changes a clip's result
    np.testing.assert_array_equal(probs[:4], clf.classify_clips(clips[:4]))
    np.testing.assert_array_equal(probs[4:], clf.classify_clips(clips[4:]))
    assert clf._buckets() == [1, 2, 4]
    assert [clf._bucket(k) for k in (1, 2, 3, 4)] == [1, 2, 4, 4]
    nb = VideoClassifier.from_model(models[1], NAMES, batch_size=6,
                                    pad_buckets=False, device="cpu")
    assert nb._buckets() == [6] and nb._bucket(1) == 6
    assert clf.attn_impl == "xla" and clf.device == torch.device("cpu")
    assert (clf.num_frames, clf.spatial_size, clf.batch_size) == (2, 32, 4)
    assert all(p.dtype == torch.bfloat16 for p in clf.net.visual.parameters())
    assert clf.net.text_features.dtype == torch.float32


def test_patch_major_matches_frames(models):
    """The folded normalisation is an exact affine identity: only fp
    rounding differs (fp32 activations; the weights are bf16 either way)."""
    model = models[1]
    clips = _clips(3, 2)
    kw = dict(batch_size=2, compute_dtype=torch.float32, device="cpu")
    p = VideoClassifier.from_model(model, NAMES, **kw).classify_clips(clips)
    p_pm = VideoClassifier.from_model(model, NAMES, patch_major=True,
                                      **kw).warmup().classify_clips(clips)
    np.testing.assert_allclose(p_pm, p, atol=2e-4)


def test_quantized_serving_not_ported(models):
    """Every quantized mode is ported now (tests/test_torch_serve_w8a8.py,
    tests/test_torch_w8.py): 'w8', and True as in the JAX classifier, build
    a weight-only int8 classifier; only an unknown mode is refused."""
    for quantize in ("w8", True):
        clf = VideoClassifier.from_model(models[1], NAMES, quantize=quantize,
                                         batch_size=2, device="cpu")
        assert clf.quantize == "w8"
        p = clf.classify_clips(_clips(6, 1))
        assert p.shape == (1, 3) and np.isfinite(p).all()
    with pytest.raises(ValueError, match="quantize"):
        VideoClassifier.from_model(models[1], NAMES, quantize="int4",
                                   device="cpu")


def test_classify_video(clf, tmp_path):
    cv2 = pytest.importorskip("cv2")
    p = tmp_path / "v.mp4"
    w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 40))
    rs = np.random.RandomState(2)
    for _ in range(10):
        w.write(rs.randint(0, 255, (40, 48, 3), np.uint8))
    w.release()
    label, probs = clf.classify_video(str(p))
    assert label in NAMES and probs.shape == (3,)


def test_server_endpoints(clf):
    httpd = serve(clf, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(base + "/v1/model", timeout=30) as r:
            meta = json.loads(r.read())
        assert meta == {"classes": NAMES, "num_frames": 2,
                        "spatial_size": 32, "batch_size": 4}
        clip = _clips(4, 1)[0]
        req = urllib.request.Request(base + "/v1/classify_clip_raw",
                                     data=clip.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        np.testing.assert_allclose(body["probs"],
                                   clf.classify_clips(clip[None])[0],
                                   atol=1e-6)
        assert body["label"] == NAMES[int(np.argmax(body["probs"]))]
        bad = urllib.request.Request(base + "/v1/classify_clip_raw",
                                     data=b"123", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
        # the front end and the micro-batcher are the port's own copies
        with urllib.request.urlopen(base + "/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"] >= 1 and stats["posts"] >= 1
        assert isinstance(httpd.batcher, MicroBatcher)
    finally:
        stop_server(httpd, th)


def test_port_imports_without_jax():
    """Every module of the port, its server entry and chip_smoke.py import
    with jax and the JAX package blocked: the port runs where neither is
    installed."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gava_clip_tpu'] = None\n"
        "import gava_clip_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['gava_clip_tpu'] is None\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 17      # incl. ops.quant, ops.int8_matmul
