"""Frame sharding in the port (the 'frame' axis of
gava_clip_tpu_torch/parallel/mesh.py) against the JAX package's
frame-sharded model on the CPU.

JAX shards the frame axis by placement alone: the video at
`P(None, "frame")` on `create_mesh(axis_names=("frame",))`, GSPMD inserting
the collectives (tests/test_frame_sharding.py). The port runs one process
per rank, each passing its frames of every clip, with the collectives
explicit. One launch of `python -m torch.distributed.run --standalone
--nproc_per_node 2 -m gava_clip_tpu_torch.parallel.selfcheck` (gloo, one
intra-op thread per rank) runs, on the tiny model of
tests/test_torch_train_step.py with 4 training frames (all three prompt
kinds, NTE and the support memory) at a batch of 2 clips of 4 frames:

  * the frame-sharded forward (logits, summary, the NTE and memory heads)
    and an eval clip of 8 frames (2 pseudo-videos) against JAX's
    frame-sharded forward within the 1e-4 of tests/test_frame_sharding.py;
  * two train steps under remat 'none' and 'full': the first step's
    gradients against `jax.grad` of JAX's loss on the frame-sharded video,
    both steps' metrics and leaves against JAX's step, within the
    tolerances of tests/test_torch_train_step.py; every rank ends with
    the same leaves;
  * three mutants that the same check rejects: the gathered cls rows
    keeping only the rank's own gradient, the temporal means divided by
    the local frame count, every rank's frames embedded as frames 0, 1;
  * the zero-shot classifier (ViT-B/16 widths cut to 2 layers and 32^2
    frames) frame-sharded against one process, in bf16 and in w8a8 +
    patch-major with the fused prompt extras;
  * the same classifier frame-sharded with its blocks in 2 pipeline stages
    and 2 micro-batches (4 clips): in fp32 against JAX's
    `apply(pp=(mesh, 2))` on a ('frame', 'pipe') 2 x 2 mesh with the video
    at P(None, 'frame'), in bf16 against one process; stages that pass no
    FrameShard (each rank's summary attention on its own frames) fail
    both.

In one process: the shapes that do not split, tensor parallelism over
quantized leaves on a frame x model mesh and the pipeline with remat
raise, and the three frame operators without a group are the identity.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gava_clip_tpu.models import vision as jvision
from gava_clip_tpu.models import vita_clip as jvc
from gava_clip_tpu.parallel import mesh as jmesh
from gava_clip_tpu.train import state as jstate
from gava_clip_tpu.train import step as jstep
from gava_clip_tpu_torch.data.device_preprocess import (CLIP_MEAN, CLIP_STD,
                                                        normalize_frames)
from gava_clip_tpu_torch.models import vita_clip as tvc
from gava_clip_tpu_torch.models.vision import _pipelined_blocks, \
    vision_encoder
from gava_clip_tpu_torch.parallel import mesh as tmesh
from gava_clip_tpu_torch.parallel import selfcheck
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_torch_bounds import module_deadline  # noqa: F401
from tests.test_torch_parallel import (LR, STEPS, _finish, _launch,
                                       _mismatches)
from tests.test_torch_train_step import LOSS_KW, _batch, tiny_models

FRAMES = 4
SCENARIOS = ("fp", "fp_remat", "fp:local_grad_frames", "fp:local_T_mean",
             "fp:local_time_embed", "fp_eval", "fp_serve",
             "fp_serve:local_time_embed", "fpp_serve", "fpp:no_gather")
# the JAX test's limit for the frame-sharded forward
FORWARD_TOL = 1e-4
# the classifier frame-sharded against one process, in bf16 ulps of its
# largest |logit|: the row-local ops see the same rows and the cross-frame
# extras the same gathered rows, so only the temporal mean's fp32
# summation order may differ, and with it at most the rounding of a
# feature or a logit to bf16
SERVE_MAX_LOGIT_ULPS = 2
# the same in fp32, where that order moves a logit by fp32 roundings
# alone: 2^-14 of the largest |logit|, the fp32 kernels' limit on the card
SERVE_F32_REL = 2.0 ** -14


def _jax_frame_refs(jmodel, batch, eval_video, model=1):
    """JAX on its 2-device 'frame' mesh (model=2: a ('frame', 'model') 2 x 2
    mesh whose parameters `shard_params_tensor_parallel` places), the
    videos at P(None, 'frame') and everything else replicated: the forward
    of the batch and of the eval clips, the first step's gradients, and
    STEPS steps."""
    if model == 1:
        mesh = jmesh.create_mesh(n_devices=2, axis_names=("frame",))
    else:
        mesh = jmesh.create_mesh(n_devices=2 * model,
                                 axis_names=("frame", "model"),
                                 mesh_shape=(2, model))
    rep = NamedSharding(mesh, P())

    def place(tree):
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(jnp.asarray(a), rep), tree)

    def place_params(tree):
        return place(tree) if model == 1 else \
            jmesh.shard_params_tensor_parallel(tree, mesh)

    def frames(v):
        return jax.device_put(jnp.asarray(v), NamedSharding(mesh,
                                                            P(None, "frame")))

    jb = dict(place({k: v for k, v in batch.items() if k != "video"}),
              video=frames(batch["video"]))
    params = place_params(jmodel.params)
    forward = jax.jit(lambda p, b: jmodel.apply(
        p, jmodel.buffers, b["video"], memory=b["memory"],
        video_nte=b["nte"]))
    forward_eval = jax.jit(lambda p, v: jmodel.apply(p, jmodel.buffers, v))
    out = {"train": forward(params, jb),
           "eval": forward_eval(params, frames(eval_video))}
    opt = jstate.make_optimizer(LR, 50, 0.1)
    st = jstate.create_train_state(
        jmodel.params, jvc.trainable_mask(jmodel.params, jmodel.cfg), opt)
    trainable = place_params(st.trainable)
    st = jstate.TrainState(step=place(st.step), trainable=trainable,
                           frozen=place_params(st.frozen),
                           opt_state=opt.init(trainable))
    loss_cfg = jstep.LossConfig(**LOSS_KW)
    out["grads"] = jax.jit(jax.grad(jstep.make_loss_fn(jmodel, loss_cfg),
                                    has_aux=True))(st.trainable, st.frozen,
                                                   jb)[0]
    step = jstep.make_train_step(jmodel, loss_cfg, opt, donate=False)
    metrics = []
    for _ in range(STEPS):
        st, m = step(st, jb)
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"], out["trainable"] = metrics, st.trainable
    return out


def _jax_pipelined_logits():
    """fpp_serve's classifier (its seeded weights over the bridge, in fp32)
    as JAX's zero-shot model: `apply(pp=(mesh, PP_SERVE_MICRO))` on a
    ('frame', 'pipe') 2 x PP_SERVE_STAGES mesh, the clips at
    P(None, 'frame')."""
    S, B, L = selfcheck.PP_SERVE_SIZES["cpu"]
    model = selfcheck._serve_model(torch.device("cpu"), S, L)
    jcfg = jvc.VitaClipConfig(
        vision=jvision.VisionConfig(**dataclasses.asdict(model.cfg.vision)),
        num_classes=model.cfg.num_classes, zeroshot_evaluation=True)
    jmodel = jvc.VitaClip(jcfg,
                          zeroshot_text_features=model.text_features.numpy())
    jmodel.params = jax_bridge.params_to_jax(model.param_tree())
    x = normalize_frames(torch.from_numpy(selfcheck._serve_clips(S, B)),
                         CLIP_MEAN, CLIP_STD).numpy()
    mesh = jmesh.create_mesh(n_devices=2 * selfcheck.PP_SERVE_STAGES,
                             axis_names=("frame", "pipe"),
                             mesh_shape=(2, selfcheck.PP_SERVE_STAGES))
    video = jax.device_put(jnp.asarray(x), NamedSharding(mesh,
                                                         P(None, "frame")))
    params = jax.device_put(jmodel.params, NamedSharding(mesh, P()))
    return np.asarray(jax.jit(lambda p, v: jmodel.apply(
        p, jmodel.buffers, v,
        pp=(mesh, selfcheck.PP_SERVE_MICRO))["logits"])(params, video))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The tiny JAX model with FRAMES training frames and the port's model
    around the same parameters."""
    return tiny_models(tmp_path_factory.mktemp("ke_updrs"),
                       num_frames=FRAMES)


@pytest.fixture(scope="module")
def frame_ranks(pair, tmp_path_factory):
    """One launch of `parallel.selfcheck` over every frame scenario, and
    JAX's frame-sharded references computed while the ranks run."""
    d = tmp_path_factory.mktemp("frames")
    jmodel, model = pair
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
                     "--loss", json.dumps(dict(LOSS_KW))], cwd=d)
    try:
        refs = _jax_frame_refs(jmodel, batch, eval_video)
        refs["pipelined"] = _jax_pipelined_logits()
    finally:
        log = _finish(child)
    results = torch.load(d / "results.pt", weights_only=False)
    return {"results": results, "refs": refs, "log": log}


def _close(got, want, names):
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=FORWARD_TOL, atol=FORWARD_TOL,
                                   err_msg=k)


def test_frame_sharded_forward_matches_jax(frame_ranks):
    """Each rank's 2 of the 4 frames: the whole clips' logits, summary and
    heads, equal on both ranks, those of JAX's frame-sharded forward."""
    res = frame_ranks["results"]["fp_eval"]
    want = frame_ranks["refs"]["train"]
    assert sorted(res["train"]) == sorted(want)
    assert res["train"]["summary"].shape == (2, 32)
    _close(res["train"], want, ("logits", "summary", "logits_vm",
                                "logits_mt", "text_features"))
    assert res["train_rank_spread"] == 0.0


def test_frame_sharded_long_clip_matches_jax(frame_ranks):
    """An eval clip of 8 frames is 2 pseudo-videos of the 4 training
    frames: rank 0 holds the first, rank 1 the second of each clip; the
    summary is one per pseudo-video, as in JAX."""
    res = frame_ranks["results"]["fp_eval"]
    want = frame_ranks["refs"]["eval"]
    assert res["eval"]["summary"].shape == (4, 32)
    _close(res["eval"], want, ("logits", "summary"))
    assert res["eval_rank_spread"] == 0.0


@pytest.mark.parametrize("scenario", ["fp", "fp_remat"])
def test_frame_sharded_steps_match_jax(frame_ranks, scenario):
    """remat 'none' and 'full' (the gather recomputed in the backward):
    the first step's gradient of every trainable leaf, the metrics and the
    leaves after two steps are JAX's on the frame-sharded video, and the
    two ranks hold the same leaves."""
    refs = frame_ranks["refs"]
    res = frame_ranks["results"][scenario]
    assert _mismatches(res, refs["metrics"], refs["trainable"],
                       refs["grads"]) == []
    assert res["rank_spread"] == 0.0
    assert res["launches"] == {}        # the plain versions on the CPU


@pytest.mark.parametrize("mutant,fails_on", [
    ("local_grad_frames", "first step's gradient"),
    ("local_T_mean", "['sum_proj']['kernel']: first step's gradient"),
    ("local_time_embed", "['time_embed']")])
def test_frame_mutants_fail_the_check(frame_ranks, mutant, fails_on):
    """A gather whose other frames carry no gradient gives JAX's loss but
    not its gradients; means over the local frame count scale the features
    and the summary by W, which the features' l2 norm hides but the NTE
    head's sum_proj (a bias after the summary) does not; frames embedded
    from index 0 on every rank show in the time_embed leaf."""
    refs = frame_ranks["refs"]
    res = frame_ranks["results"][f"fp:{mutant}"]
    bad = _mismatches(res, refs["metrics"], refs["trainable"], refs["grads"])
    assert any(fails_on in b for b in bad), bad


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_frame_sharded_classifier_matches_one_process(frame_ranks, mode):
    """The zero-shot classifier's forward (8 frames, 2 clips, 400 classes)
    over two frame ranks: the logits of the forward in one process, equal
    on both ranks; on the CPU every op runs its plain version, so no
    kernel is launched."""
    res = frame_ranks["results"]["fp_serve"][mode]
    assert res["finite"] and res["shape"] == (2, 400)
    assert res["max_abs_diff"] <= SERVE_MAX_LOGIT_ULPS * res["logit_ulp"], \
        res
    assert res["rank_spread"] == 0.0
    assert res["launches"] == [{}, {}]


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_frame_serve_check_rejects_local_time_embed(frame_ranks, mode):
    """The classifier's check is tight enough to see a wrong temporal
    embedding: with rank 1's frames embedded as frames 0..3 the logits
    leave the limit."""
    res = frame_ranks["results"]["fp_serve:local_time_embed"][mode]
    assert res["max_abs_diff"] > SERVE_MAX_LOGIT_ULPS * res["logit_ulp"], \
        res


def _serve_limit(r, mode):
    return SERVE_MAX_LOGIT_ULPS * r["logit_ulp"] if mode == "bf16" \
        else SERVE_F32_REL * r["max_abs_logit"]


def test_frame_pipelined_classifier_matches_jax(frame_ranks):
    """The classifier (8 frames, 4 clips, 400 classes) over two frame ranks
    with its blocks in 2 stages and 2 micro-batches of whole clips: in
    fp32 JAX's pipelined forward on its frame-sharded video; in both
    dtypes one process's forward without the pipeline (bf16 within 2 bf16
    ulps, fp32 within 2^-14 of the largest |logit|); equal on both ranks;
    no kernel launched on the CPU."""
    res = frame_ranks["results"]["fpp_serve"]
    np.testing.assert_allclose(res["fp32_logits"].numpy(),
                               frame_ranks["refs"]["pipelined"],
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)
    for mode in ("bf16", "fp32"):
        r = res[mode]
        assert r["finite"] and r["shape"] == (4, 400)
        assert r["max_abs_diff"] <= _serve_limit(r, mode), r
        assert r["rank_spread"] == 0.0
        assert r["launches"] == [{}, {}]


@pytest.mark.parametrize("mode", ["bf16", "fp32"])
def test_frame_pipelined_check_rejects_no_gather(frame_ranks, mode):
    """Stages that pass no FrameShard attend each rank's summary over its
    own frames alone: the logits leave one process's limit in both dtypes
    and, in fp32, JAX's."""
    res = frame_ranks["results"]["fpp:no_gather"]
    r = res[mode]
    assert r["max_abs_diff"] > _serve_limit(r, mode), r
    if mode == "fp32":
        assert not np.allclose(res["fp32_logits"].numpy(),
                               frame_ranks["refs"]["pipelined"],
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)


# ----- one process ----------------------------------------------------------

def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    else:
        yield path, tree


def test_frame_partial_mask_marks_the_vision_tower(pair):
    """The leaves whose gradients are summed over 'frame' are the vision
    tower's: of the trainable ones the summary, local and global prompts
    and time_embed; none behind the temporal mean (text prompts, heads,
    logit scales)."""
    _, model = pair
    trainable = dict(_flat(tvc.trainable_mask(model.params, model.cfg)))
    partial = dict(_flat(tmesh.frame_partial_mask(model.params)))
    assert partial.keys() == trainable.keys()
    assert all(partial[k] == k.startswith("visual/") for k in partial)
    both = {k.split("/")[-1] if "blocks" not in k else k.split("/")[3]
            for k in partial if partial[k] and trainable[k]}
    assert both == {"time_embed", "global_prompts", "local_prompts",
                    "summary_ln", "summary_attn"}
    assert any(trainable[k] and not partial[k] for k in trainable)


def test_uneven_frames_and_other_axes_raise(pair):
    """T not divisible by the frame ranks raises, naming the shape; on a
    frame x model mesh the frame group is the mesh's, and tensor
    parallelism over quantized leaves still raises there; the pipeline
    raises with remat, and under frame sharding with micro-batches that
    do not hold whole clips."""
    with pytest.raises(ValueError, match=r"a clip of 6 frames \(a leaf of "
                                         r"shape \(2, 6, 3\)\) does not "
                                         r"split over 4 frame ranks"):
        tmesh.local_frames(np.zeros((2, 6, 3)), 0, 4)
    fake = tmesh.Mesh(("data", "frame"), {"data": 1, "frame": 4},
                      {"data": 0, "frame": 1})
    with pytest.raises(ValueError, match="does not split over 4"):
        tmesh.shard_batch({"video": np.zeros((2, 6, 3)),
                           "labels": np.zeros(2)}, fake)
    got = tmesh.shard_batch({"video": np.arange(16).reshape(2, 8),
                             "labels": np.zeros(2)}, fake)
    np.testing.assert_array_equal(got["video"], [[2, 3], [10, 11]])
    assert got["labels"].shape == (2,)
    group = object()
    both = tmesh.Mesh(("data", "frame", "model"),
                      {"data": 1, "frame": 2, "model": 2},
                      {"data": 0, "frame": 0, "model": 0},
                      {"frame": group, "model": object()})
    assert tmesh.frame_group(both) is group
    assert tmesh.frame_group(tmesh.Mesh(("data", "model"),
                                        {"data": 1, "model": 2},
                                        {"data": 0, "model": 0})) is None
    _, model = pair
    q = {"qa": torch.zeros(32, 32, dtype=torch.int8),
         "scale": torch.ones(1, 32)}
    with pytest.raises(NotImplementedError, match="float towers only"):
        tmesh.shard_params_tensor_parallel(
            {"visual": {"blocks": [{"attn": {"q": {"kernel": q}}}]}}, both,
            model.cfg)
    video = torch.zeros(2, FRAMES, 32, 32, 3)
    with pytest.raises(ValueError, match="without remat"):
        vision_encoder(model.params["visual"], video, model.cfg.vision,
                       pp=(["cpu", "cpu"], 2), remat="full")
    # 2 clips of 2 frames a rank cannot make 3 micro-batches of whole clips
    fs = tmesh.FrameShard(group, 0, 2, 2)
    with pytest.raises(ValueError, match="2 clips do not split into 3 "
                                         "micro-batches"):
        _pipelined_blocks(model.params["visual"], None,
                          torch.zeros(4, 5, 32), model.cfg.vision, "xla",
                          "kernel", None, (["cpu"], 3), fs=fs)


def test_frame_operators_without_a_group_are_the_identity():
    """On one process (no group) `local_frames` of one rank,
    `gather_frames` and `frame_mean` change nothing: the mean is the
    plain one, bit for bit, per pseudo-video too."""
    x = torch.randn(3, 8, 5, generator=torch.Generator().manual_seed(0))
    assert tmesh.local_frames(x, 0, 1) is x
    assert tmesh.gather_frames(x, None) is x
    assert tmesh.frame_shard(None, 8) is None
    assert tmesh.frame_group(None) is None
    assert torch.equal(tmesh.frame_mean(x, None, 8), x.mean(dim=1))
    assert torch.equal(tmesh.frame_mean(x, None, 8, 4),
                       x.reshape(6, 4, 5).mean(dim=1))
    xb = x.bfloat16()
    assert torch.equal(tmesh.frame_mean(xb, None, 8), xb.mean(dim=1))
