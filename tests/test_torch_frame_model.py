"""Frame sharding with tensor parallelism in the port (a 'frame' and a
'model' axis of gava_clip_tpu_torch/parallel/mesh.py together) against the
JAX package's GSPMD-composed mesh on the CPU.

JAX composes the two by placement alone: the parameters placed by
`shard_params_tensor_parallel` on a ('frame', 'model') 2 x 2 mesh and the
video at `P(None, "frame")`. The port runs four processes on a ('data',
'frame', 'model') = (1, 2, 2) mesh, each passing its frames of every clip
through its Megatron shards, with the collectives explicit. One launch of
`python -m torch.distributed.run --standalone --nproc_per_node 4 -m
gava_clip_tpu_torch.parallel.selfcheck` (gloo, one intra-op thread per
rank) runs, on the tiny model of tests/test_torch_train_step.py with 4
training frames (heads 2 in both towers, all three prompt kinds, NTE and
the support memory) at a batch of 2 clips of 4 frames:

  * the forward (logits, summary, the NTE and memory heads) and an eval
    clip of 8 frames against JAX's within the 1e-4 of
    tests/test_frame_sharding.py;
  * two train steps under remat 'none' and 'full': the first step's
    gradients, gathered over 'model', against `jax.grad` of JAX's loss, both
    steps' metrics and leaves against JAX's step, within the tolerances of
    tests/test_torch_train_step.py; every rank ends with the same leaves;
  * a mutant that the same check rejects: the frame-partial gradients
    summed over all four ranks instead of the 'frame' group;
  * the zero-shot classifier's bf16 weights (ViT-B/16 widths cut to 2
    layers and 32^2 frames) through `vita_clip.apply` on the same mesh
    against one process.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_bounds import module_deadline  # noqa: F401
from tests.test_torch_frame_sharding import FRAMES, _close, _jax_frame_refs
from tests.test_torch_parallel import (LR, STEPS, _finish, _launch,
                                       _mismatches)
from tests.test_torch_train_step import LOSS_KW, _batch, tiny_models

SCENARIOS = ("fm", "fm_remat", "fm:grads_over_world", "fm_eval", "fm_serve")
# the classifier over ('frame', 'model') against one process, both in bf16:
# the row-parallel products sum bf16 partials over 'model', another
# rounding order than one GEMM's. One process's bf16 forward sits
# `f32_diff` (its largest |logit| difference) from the fp32 forward on the
# same weights; the sharded forward, the same arithmetic rounded in
# another order, is taken to sit as far, so by the triangle inequality
# the two differ by at most twice that
SERVE_MAX_F32_DIFFS = 2


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The tiny model pair, one four-rank launch of `parallel.selfcheck`
    over every frame x model scenario, and JAX's references on its
    ('frame', 'model') mesh computed while the ranks run."""
    jmodel, model = tiny_models(tmp_path_factory.mktemp("ke_updrs"),
                                num_frames=FRAMES)
    d = tmp_path_factory.mktemp("frame_model")
    batch = _batch(B=2, T=FRAMES)
    eval_video = np.random.RandomState(3).randn(
        2, 2 * FRAMES, 32, 32, 3).astype(np.float32)
    np.savez(d / "batch.npz", eval_video=eval_video, **batch)
    torch.save({"cfg": model.cfg, "params": model.params,
                "buffers": model.buffers}, d / "model.pt")
    child = _launch(["-m", "gava_clip_tpu_torch.parallel.selfcheck",
                     "--model", str(d / "model.pt"),
                     "--batch", str(d / "batch.npz"),
                     "--out", str(d / "results.pt"), "--device", "cpu",
                     "--backend", "gloo", "--scenarios", ",".join(SCENARIOS),
                     "--steps", str(STEPS), "--lr", str(LR),
                     "--loss", json.dumps(dict(LOSS_KW))], cwd=d, nproc=4)
    try:
        refs = _jax_frame_refs(jmodel, batch, eval_video, model=2)
    finally:
        log = _finish(child)
    results = torch.load(d / "results.pt", weights_only=False)
    return {"results": results, "refs": refs, "log": log}


def test_frame_model_forward_matches_jax(four_ranks):
    """Each rank's 2 of the 4 frames through its half of the heads and MLP
    columns: the whole clips' logits, summary and heads, equal on all four
    ranks, those of JAX's forward on its ('frame', 'model') mesh; the eval
    clip of 8 frames too (2 pseudo-videos, one summary each)."""
    res = four_ranks["results"]["fm_eval"]
    refs = four_ranks["refs"]
    assert sorted(res["train"]) == sorted(refs["train"])
    _close(res["train"], refs["train"], ("logits", "summary", "logits_vm",
                                         "logits_mt", "text_features"))
    assert res["eval"]["summary"].shape == (4, 32)
    _close(res["eval"], refs["eval"], ("logits", "summary"))
    assert res["train_rank_spread"] == 0.0
    assert res["eval_rank_spread"] == 0.0


@pytest.mark.parametrize("scenario", ["fm", "fm_remat"])
def test_frame_model_steps_match_jax(four_ranks, scenario):
    """remat 'none' and 'full': the first step's gradient of every
    trainable leaf (shards gathered over 'model'), the metrics and the
    leaves after two steps are JAX's on its ('frame', 'model') mesh, and
    the four ranks hold the same gathered leaves."""
    refs = four_ranks["refs"]
    res = four_ranks["results"][scenario]
    assert _mismatches(res, refs["metrics"], refs["trainable"],
                       refs["grads"]) == []
    assert res["rank_spread"] == 0.0
    assert res["launches"] == {}        # the plain versions on the CPU


def test_grads_over_world_fails_the_check(four_ranks):
    """Summing the frame-partial gradients over every rank adds the other
    'model' rank's shard to each sharded leaf and counts each replicated
    vision leaf twice: the loss is JAX's, the first step's gradients are
    not."""
    refs = four_ranks["refs"]
    res = four_ranks["results"]["fm:grads_over_world"]
    bad = _mismatches(res, refs["metrics"], refs["trainable"],
                      refs["grads"])
    assert any("first step's gradient" in b for b in bad), bad
    assert not any("step 0" in b for b in bad), bad


def test_frame_model_classifier_matches_one_process(four_ranks):
    """The zero-shot classifier's bf16 forward (8 frames, 2 clips, 400
    classes) over ('frame', 'model'): within twice the bf16 forward's own
    distance from fp32 of one process's logits, equal on all four ranks;
    on the CPU no kernel is launched."""
    res = four_ranks["results"]["fm_serve"]["bf16"]
    assert res["finite"] and res["shape"] == (2, 400)
    assert 0.0 < res["f32_diff"] < 8 * res["logit_ulp"], res
    assert res["max_abs_diff"] <= SERVE_MAX_F32_DIFFS * res["f32_diff"], res
    assert res["rank_spread"] == 0.0
    assert res["launches"] == [{}, {}, {}, {}]

