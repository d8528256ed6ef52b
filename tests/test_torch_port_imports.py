"""The PyTorch port stands alone: it imports neither JAX nor any module of
the JAX package, keeps its own copies of what it needs from there, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gava_clip_tpu.data import video as jvideo
from gava_clip_tpu_torch import server as tserver
from gava_clip_tpu_torch.data import video as tvideo
from gava_clip_tpu_torch.serve import VideoClassifier
from gava_clip_tpu_torch.utils import flagship as tflagship
from gava_clip_tpu_torch.utils.device import resolve_device
from tests.test_torch_bounds import module_deadline  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "gava_clip_tpu_torch")


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    """Top-level names of every import in a source file, wherever it
    stands (module level or inside a function)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "optax", "flax",
                           "gava_clip_tpu"), f"{path} imports {mod}"


def test_training_entry_points_import_without_jax():
    """The training slice's modules load with jax and the JAX package
    blocked, and a step of a tiny model runs (tokenizer table, prompts,
    both towers, AdamW) with nothing of either in sys.modules."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['gava_clip_tpu'] = None\n"
        "import torch\n"
        "from gava_clip_tpu_torch.models.vita_clip import trainable_mask\n"
        "from gava_clip_tpu_torch.train.state import create_train_state, "
        "make_optimizer\n"
        "from gava_clip_tpu_torch.train.step import LossConfig, "
        "make_train_step\n"
        "from gava_clip_tpu_torch.models.prompts import PromptConfig\n"
        "from gava_clip_tpu_torch.models.text import TextConfig\n"
        "from gava_clip_tpu_torch.models.vision import VisionConfig\n"
        "from gava_clip_tpu_torch.models.vita_clip import VitaClipConfig, "
        "VitaClipModel\n"
        "from gava_clip_tpu_torch.utils.flagship import "
        "make_synthetic_knowledge_dir\n"
        "cfg = VitaClipConfig(vision=VisionConfig(input_size=(32, 32), "
        "num_frames=2, feature_dim=32, heads=2, layers=2, embed_dim=32, "
        "use_summary_token=True, use_local_prompts=True, "
        "use_global_prompts=True, num_global_prompts=2), "
        "text=TextConfig(embed_dim=32, width=32, heads=2, layers=2), "
        "num_classes=3, use_text_prompt_learning=True, "
        "prompt=PromptConfig(n_cls=3, n_ctx=4, ctx_dim=32, emb_dim=8, "
        "init='cntn_split_uni_disc', csc=True, knowledge_versions=('v1',), "
        "knowledge_dir=make_synthetic_knowledge_dir(3, ('v1',))), "
        "zeroshot_evaluation=False)\n"
        "m = VitaClipModel(cfg, classnames=['normal', 'slight', "
        "'moderate'], device='cpu')\n"
        "opt = make_optimizer(1e-3, 10)\n"
        "st = create_train_state(m.params, trainable_mask(m.params, m.cfg), "
        "opt, device='cpu')\n"
        "step = make_train_step(m, LossConfig(num_classes=3), opt, "
        "attn_impl='flash')\n"
        "b = {'video': torch.zeros(2, 2, 32, 32, 3), "
        "'labels': torch.tensor([0, 2])}\n"
        "st, met = step(st, b)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'gava_clip_tpu') and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print(st.step, float(met['total']))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    step, total = res.stdout.split()
    assert step == "1" and np.isfinite(float(total))


def test_own_copy_of_video_helpers_matches_the_jax_package(tmp_path):
    classes = tmp_path / "c.txt"
    classes.write_text("a thing\n*thing\nanother\n*other\n\n")
    assert tvideo.parse_classes_file(str(classes)) == \
        jvideo.parse_classes_file(str(classes))
    k400 = os.path.join(ROOT, "classes", "k400_classes.txt")
    assert tvideo.parse_classes_file(k400) == jvideo.parse_classes_file(k400)
    for args in ((100, 8, 4, 1), (10, 8, 4, 3), (300, 16, 2, 2)):
        assert tvideo.temporal_crop_indices(*args) == \
            jvideo.temporal_crop_indices(*args)
    frames = np.random.RandomState(0).randint(0, 255, (3, 40, 48, 3), np.uint8)
    np.testing.assert_array_equal(tvideo.center_crop(frames, 32),
                                  jvideo.center_crop(frames, 32))
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(tvideo.keep_aspect_resize(frames, 32),
                                  jvideo.keep_aspect_resize(frames, 32))
    path = str(tmp_path / "v.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 40))
    for f in np.random.RandomState(1).randint(0, 255, (12, 40, 48, 3),
                                              np.uint8):
        w.write(f)
    w.release()
    assert tvideo.video_num_frames(path) == jvideo.video_num_frames(path)
    np.testing.assert_array_equal(
        tvideo.decode_frames(path, indices=[0, 3, 3, 11]),
        jvideo.decode_frames(path, indices=[0, 3, 3, 11]))


def test_video_module_needs_no_decoder_to_import():
    """cv2 is looked up when a function needs it, not with the module."""
    code = ("import sys\nsys.modules['cv2'] = None\n"
            "from gava_clip_tpu_torch.data import video\n"
            "import gava_clip_tpu_torch.serve, gava_clip_tpu_torch.server\n"
            "assert video.center_crop is not None\n"
            "try:\n    video.video_num_frames('x.mp4')\n"
            "except RuntimeError as e:\n    print('raised', e)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "raised" in res.stdout and "cv2" in res.stdout


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """device=None means the card everywhere, and without a card that
    raises: nothing serves or trains on the CPU without being asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tflagship.build_zero_shot(num_frames=2, num_classes=3, input_size=32)
    model = tflagship.build_zero_shot(num_frames=2, num_classes=3,
                                      input_size=32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoClassifier.from_model(model, ["a", "b", "c"])
    clf = VideoClassifier.from_model(model, ["a", "b", "c"], device="cpu")
    assert clf.device == torch.device("cpu")
    classes = tmp_path / "classes.txt"
    classes.write_text("a\nb\nc\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserver.make_server(["--port", "0", "--classes", str(classes),
                             "--num_frames", "2"])
    # with a card present the default resolves to it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
