"""The port's parallel layer (gava_clip_tpu_torch/parallel/) against the JAX
package's on the CPU.

  * distributed: the settings' order (explicit arguments, then the
    launcher's environment, then no group), `local_batch_slice`, with
    `torch.distributed.init_process_group` replaced by a recorder (after
    tests/test_distributed.py);
  * tensor parallelism: `tensor_parallel_spec` equals the JAX rule on every
    leaf of the tiny model's bridged tree; `create_mesh` raises on a shape
    that the world does not fill; a quantized tree under 'model' raises;
  * the pipeline: `pipeline_scan` against the sequential loop, forward and
    gradients, with and without remat; `vision_encoder(pp=...)` against
    JAX's `vision_encoder(pp=...)` on its 2-device 'pipe' mesh;
  * two processes (`python -m torch.distributed.run --standalone
    --nproc_per_node 2`, gloo, one intra-op thread each) run
    `parallel.selfcheck`: the data-parallel step (2, 1) and the
    tensor-parallel step (1, 2) at a global batch of 4 with NTE, the support
    memory and focal-ordinal, two steps each, against JAX's
    `make_train_step` on the global batch within the tolerances of
    tests/test_torch_train_step.py::test_three_train_steps_match_jax (and
    the first step's gradients within test_loss_gradients_match_jax_grad's);
    batch_split 2 over the ranks' interleaved rows against JAX's
    batch_split 2; two mutants of the NTE gather (the head over a rank's
    rows alone; the gathered inputs keeping only the rank's own gradient)
    that must fail that check; the sharded evaluation (2, 1) and (1, 2),
    whose confusion matrix equals the one-process evaluation's;
  * `cli.train` in two processes on tests/test_torch_cli.py's tiny fold
    at batch 4: the losses of the one-process run, one results.txt;
  * `VideoClassifier(devices=["cpu", "cpu"])` against the one-device
    classifier.

  * SIGTERM to one rank of `cli.train`: both ranks stop at one step and
    rank 0 writes one resumable checkpoint.

The three launches are the file's only child processes.
"""

import dataclasses
import itertools
import json
import os
import os.path as osp
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from gava_clip_tpu.models import vision as jvision
from gava_clip_tpu.models import vita_clip as jvc
from gava_clip_tpu.parallel import mesh as jmesh
from gava_clip_tpu.train import state as jstate
from gava_clip_tpu.train import step as jstep
from gava_clip_tpu_torch.cli import train as ttrain
from gava_clip_tpu_torch.data.sampler import step_sampler
from gava_clip_tpu_torch.models import vita_clip as tvc
from gava_clip_tpu_torch.models.vision import VisionConfig, vision_encoder
from gava_clip_tpu_torch.parallel import distributed as tdist
from gava_clip_tpu_torch.parallel import mesh as tmesh
from gava_clip_tpu_torch.parallel.pipeline import (pipeline_scan, restage,
                                                   stage_params)
from gava_clip_tpu_torch.serve import VideoClassifier
from gava_clip_tpu_torch.train import checkpoint as tckpt
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_cli_train import _make_assets, _make_dataset
from tests.test_torch_bounds import ChildOutput, module_deadline  # noqa: F401
from tests.test_torch_cli import NAMES, _train_argv
from tests.test_torch_train_step import (LOSS_KW, _batch, _jb,
                                         _leaves_with_path, models)  # noqa

LR = 1e-3
STEPS = 2
LAUNCH_S = 240
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CHILD_ENV = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                 PYTHONPATH=os.pathsep.join(
                     [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))


_LAUNCHES = itertools.count()


def _launch(args, cwd, nproc: int = 2) -> ChildOutput:
    """`python -m torch.distributed.run --standalone --nproc_per_node
    <nproc> <args>` started in `cwd` (the caller works on while it runs).
    Its processes carry a marker in their environment for
    `_kill_launch`."""
    tag = f"{os.getpid()}-{next(_LAUNCHES)}"
    child = ChildOutput(subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), *args], cwd=cwd,
        env=dict(CHILD_ENV, GAVA_TEST_LAUNCH=tag), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    child.tag = tag
    return child


def _kill_launch(child: ChildOutput) -> None:
    """Kill whatever is left of a launch. The launcher starts each rank in
    a session of its own, so a kill of the launcher alone would leave the
    ranks running: they are found by the marker in their environment."""
    marker = f"GAVA_TEST_LAUNCH={child.tag}".encode()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if marker in f.read().split(b"\0"):
                    os.kill(int(pid), signal.SIGKILL)
        except OSError:         # gone, or not ours to read
            pass


def _finish(child: ChildOutput, seconds=LAUNCH_S) -> str:
    """The launch's output once it ended, or a failed test; nothing of it
    left running either way."""
    try:
        out = child.finish(seconds)
        if child.proc.returncode != 0:
            child.abandon(f"the multi-process run exited "
                          f"{child.proc.returncode}")
        return out
    finally:
        _kill_launch(child)


# ----- distributed ----------------------------------------------------------

@pytest.fixture
def fake_group(monkeypatch):
    """torch.distributed's start-up replaced by a recorder."""
    calls = []
    state = {"on": False, "rank": 0, "world": 1}

    def init(backend, init_method=None, world_size=None, rank=None, **kw):
        calls.append(dict(backend=backend, init_method=init_method,
                          world_size=world_size, rank=rank))
        state.update(on=True, rank=rank, world=world_size)

    d = torch.distributed
    monkeypatch.setattr(d, "init_process_group", init)
    monkeypatch.setattr(d, "is_initialized", lambda: state["on"])
    monkeypatch.setattr(d, "get_rank", lambda group=None: state["rank"])
    monkeypatch.setattr(d, "get_world_size",
                        lambda group=None: state["world"])
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return calls


def test_no_coordinator_starts_no_group(fake_group):
    assert tdist.init_distributed(device="cpu") == (0, 1)
    assert fake_group == []
    assert tdist.local_batch_slice(8) == 8


def test_launcher_environment(fake_group, monkeypatch):
    for k, v in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234"),
                 ("WORLD_SIZE", "4"), ("RANK", "3"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(k, v)
    assert tdist.init_distributed(device="cpu") == (3, 4)
    assert fake_group == [dict(backend="gloo",
                               init_method="tcp://10.0.0.1:1234",
                               world_size=4, rank=3)]
    assert tdist.local_batch_slice(8) == 2
    with pytest.raises(AssertionError):
        tdist.local_batch_slice(6)


def test_explicit_arguments_beat_the_environment(fake_group, monkeypatch):
    for k, v in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234"),
                 ("WORLD_SIZE", "4"), ("RANK", "3")):
        monkeypatch.setenv(k, v)
    assert tdist.init_distributed("host:99", num_processes=2, process_id=1,
                                  backend="gloo", device="cpu") == (1, 2)
    assert fake_group == [dict(backend="gloo", init_method="tcp://host:99",
                               world_size=2, rank=1)]


def test_card_backends_raise_without_a_card(fake_group, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ("host:1", 2, 0)
    with pytest.raises(RuntimeError, match="NCCL"):
        tdist.init_distributed(*args, backend="nccl", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.init_distributed(*args, backend="gloo")   # the card, by default
    assert fake_group == []


def test_sampler_rows_gather_to_the_global_micro_batches():
    """Rank r's loader rows under batch_split S, gathered micro-batch by
    micro-batch over the ranks, are the one-process grid's; S = 1 keeps
    the contiguous blocks."""
    grid = step_sampler(23, 5, 8)
    for split in (1, 2, 4):
        parts = [step_sampler(23, 5, 8, rank=r, world_size=2,
                              batch_split=split) for r in range(2)]
        got = np.concatenate([np.concatenate(
            [p.reshape(5, split, -1)[:, i] for p in parts], axis=1)
            for i in range(split)], axis=1)
        np.testing.assert_array_equal(got, grid)
        # the rows `shard_batch` cuts from a global batch are the loader's
        np.testing.assert_array_equal(
            tmesh.local_rows(grid.T, 1, 2, split).T, parts[1])
    np.testing.assert_array_equal(
        step_sampler(23, 5, 8, rank=1, world_size=2), grid[:, 4:])


def test_batch_sizes_the_world_does_not_divide_raise():
    args = ttrain.add_dist_args(ttrain.build_train_parser()).parse_args(
        ["--batch_size", "6", "--mem_batch_size", "8"])
    ttrain.check_batch_sizes(args, 2)
    with pytest.raises(ValueError, match="--batch_size 6 does not split "
                                         "over 4 ranks"):
        ttrain.check_batch_sizes(args, 4)
    args.batch_split = 2
    with pytest.raises(ValueError, match="multiple of 4"):
        ttrain.check_batch_sizes(args, 2)


# ----- tensor parallelism ---------------------------------------------------

def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    else:
        yield path, tree


def test_tensor_parallel_spec_equals_jax_leaf_for_leaf(models):
    """Every leaf of the tiny model (both towers, the summary attention,
    the prompt tree, the memory and NTE heads): the port's spec is JAX's
    PartitionSpec without the stacked layer axis of the blocks."""
    jmodel, model = models
    mesh = jmesh.create_mesh(axis_names=("data", "model"), mesh_shape=(2, 4))
    jleaves = dict(jax.tree_util.tree_flatten_with_path(jmodel.params)[0])
    jspecs = {tuple(str(getattr(k, "key", k)) for k in path):
              tuple(jmesh.tensor_parallel_spec(path, leaf, mesh))
              for path, leaf in jleaves.items()}
    n_sharded = 0
    seen = set()
    for path, leaf in _port_leaves(model.params):
        in_blocks = "blocks" in path
        jpath = tuple(str(p) for p in path if not isinstance(p, int))
        want = jspecs[jpath]
        if in_blocks and want:
            want = want[1:]             # the JAX layer axis
        got = tmesh.tensor_parallel_spec(path, tuple(leaf.shape))
        assert got == want, (path, got, want)
        n_sharded += "model" in got
        seen.add(jpath)
    assert seen == set(jspecs)
    # q/k/v/out/fc1/fc2 kernels and 4 column biases of 2 x 2 tower blocks,
    # 2 summary attentions, tf_project
    assert n_sharded == 2 * 2 * 10 + 2 * 7 + 3


def test_create_mesh_and_quantized_trees_raise(models):
    with pytest.raises(ValueError, match=r"mesh_shape \(2, 1\) needs 2 "
                                         r"processes, have 1"):
        tmesh.create_mesh(("data", "model"), (2, 1))
    mesh = tmesh.create_mesh(("data", "model"))
    assert (mesh.shape, mesh.coords, mesh.groups) == (
        {"data": 1, "model": 1}, {"data": 0, "model": 0}, {})
    _, model = models
    fake = tmesh.Mesh(("data", "model"), {"data": 1, "model": 2},
                      {"data": 0, "model": 0})
    shards = tmesh.shard_params_tensor_parallel(model.params, fake,
                                                model.cfg)
    blk = shards["visual"]["blocks"][0]
    assert blk["attn"]["q"]["kernel"].shape == (32, 16)
    assert blk["attn"]["out"]["kernel"].shape == (16, 32)
    assert blk["mlp"]["fc2"]["bias"].shape == (32,)
    q = {"qa": torch.zeros(32, 32, dtype=torch.int8),
         "scale": torch.ones(1, 32)}
    with pytest.raises(NotImplementedError, match="float towers only"):
        tmesh.shard_params_tensor_parallel(
            {"visual": {"blocks": [{"attn": {"q": {"kernel": q}}}]}}, fake,
            model.cfg)


@pytest.mark.parametrize("tp", [1, 2, 3])
def test_tower_groups_name_the_parts_that_take_shards(models, tp):
    """The towers learn whether they hold shards from `tower_groups` alone:
    a part gets the 'model' group exactly where
    `shard_params_tensor_parallel` cut its leaves."""
    _, model = models
    assert set(tmesh.tower_groups(None, model.cfg).values()) == {None}
    group = object()
    fake = tmesh.Mesh(("data", "model"), {"data": 1, "model": tp},
                      {"data": 0, "model": 0}, {"model": group})
    groups = tmesh.tower_groups(fake, model.cfg)
    shards = tmesh.shard_params_tensor_parallel(model.params, fake,
                                                model.cfg)
    full = dict(_port_leaves(model.params))
    cut = {path[0] for path, leaf in _port_leaves(shards)
           if leaf is not None and leaf.shape != full[path].shape}
    assert set(groups) == {"visual", "textual", "tf_project"}
    assert {u for u, g in groups.items() if g is not None} == cut
    assert all(g is None or g is group for g in groups.values())
    assert (cut == set()) == (tp in (1, 3))


# ----- the pipeline ---------------------------------------------------------

def _toy(L=4, D=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [{"w": (0.2 * torch.randn(D, D, generator=g)).requires_grad_(),
             "b": (0.1 * torch.randn(D, generator=g)).requires_grad_()}
            for _ in range(L)]


def _toy_block(h, p):
    return torch.tanh(h @ p["w"] + p["b"])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("stages,microbatches", [(2, 1), (2, 2), (4, 2)])
def test_pipeline_matches_the_sequential_loop(stages, microbatches, remat):
    layers = _toy()
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    want = x
    for p in layers:
        want = _toy_block(want, p)
    gw = torch.autograd.grad(want.square().sum(),
                             [t for p in layers for t in p.values()])
    got = pipeline_scan(_toy_block, stage_params(layers, ["cpu"] * stages),
                        x, ["cpu"] * stages, microbatches=microbatches,
                        remat=remat)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    gg = torch.autograd.grad(got.square().sum(),
                             [t for p in layers for t in p.values()])
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_uneven_stages_and_micro_batches_raise():
    with pytest.raises(ValueError, match="layer count 3 not divisible by 2"):
        restage(_toy(L=3), 2)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        pipeline_scan(_toy_block, stage_params(_toy(), ["cpu"] * 2),
                      torch.zeros(8, 16), ["cpu"] * 2, microbatches=3)


def test_vision_encoder_pipelined_matches_jax():
    """The tower of tests/test_pipeline.py (summary token, local and global
    prompts, 4 layers) over 2 stages and 2 micro-batches: the port against
    JAX's `vision_encoder(pp=(mesh, 2))`, features and summary."""
    jcfg = jvision.VisionConfig(
        input_size=(32, 32), num_frames=2, feature_dim=32, patch_size=(16, 16),
        heads=2, layers=4, mlp_factor=2.0, embed_dim=16,
        use_summary_token=True, use_local_prompts=True,
        use_global_prompts=True, num_global_prompts=2)
    jmodel = jvc.VitaClip(jvc.VitaClipConfig(vision=jcfg, num_classes=3,
                                             zeroshot_evaluation=True),
                          zeroshot_text_features=np.random.RandomState(0)
                          .randn(3, 16).astype(np.float32))
    video = np.random.RandomState(4).rand(4, 2, 32, 32, 3).astype(np.float32)
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("pipe",))
    jf, js = jvision.vision_encoder(jmodel.params["visual"],
                                    jnp.asarray(video), jcfg, pp=(mesh, 2))
    cfg = VisionConfig(**dataclasses.asdict(jcfg))
    params = jax_bridge.params_from_jax(
        jmodel.params, tvc.VitaClipConfig(vision=cfg, num_classes=3))
    tf, ts = vision_encoder(params["visual"], torch.from_numpy(video), cfg,
                            pp=(["cpu", "cpu"], 2))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="without remat"):
        vision_encoder(params["visual"], torch.from_numpy(video), cfg,
                       pp=(["cpu", "cpu"], 2), remat="full")


# ----- two processes: the steps and the evaluation --------------------------

SCENARIOS = ("dp", "tp", "dp_split2", "dp:local_nte", "dp:local_grad_nte",
             "eval_dp", "eval_tp")


def _jax_run(jmodel, batch, batch_split=1):
    """Two JAX steps on the global batch: (metrics per step, trainable)."""
    opt = jstate.make_optimizer(LR, 50, 0.1)
    st = jstate.create_train_state(
        jmodel.params, jvc.trainable_mask(jmodel.params, jmodel.cfg), opt)
    step = jstep.make_train_step(jmodel, jstep.LossConfig(**LOSS_KW), opt,
                                 batch_split=batch_split, donate=False)
    metrics = []
    for _ in range(STEPS):
        st, m = step(st, _jb(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, st.trainable


def _jax_grads(jmodel, batch):
    mask = jvc.trainable_mask(jmodel.params, jmodel.cfg)
    st = jstate.create_train_state(jmodel.params, mask,
                                   jstate.make_optimizer(LR, 50, 0.1))
    loss_fn = jstep.make_loss_fn(jmodel, jstep.LossConfig(**LOSS_KW))
    return jax.jit(jax.grad(loss_fn, has_aux=True))(
        st.trainable, st.frozen, _jb(batch))[0]


def _eval_set():
    rs = np.random.RandomState(3)
    return (rs.randn(7, 2, 32, 32, 3).astype(np.float32),
            rs.randint(0, 3, size=7))


@pytest.fixture(scope="module")
def two_ranks(models, tmp_path_factory):
    """One launch of `parallel.selfcheck` over every scenario, and JAX's
    references on the global batch."""
    jmodel, model = models
    d = tmp_path_factory.mktemp("selfcheck")
    batch = _batch(Bm=8)
    ev, el = _eval_set()
    np.savez(d / "batch.npz", eval_video=ev, eval_labels=el, **batch)
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
        # JAX's references while the two ranks run
        refs = {1: _jax_run(jmodel, batch), 2: _jax_run(jmodel, batch, 2)}
        grads = _jax_grads(jmodel, batch)
    finally:
        out = _finish(child)
    results = torch.load(d / "results.pt", weights_only=False)
    return {"results": results, "refs": refs, "log": out, "grads": grads,
            "eval": (ev, el)}


def _mismatches(res, metrics, trainable, grads=None):
    """What `test_three_train_steps_match_jax` (and, given `grads`,
    `test_loss_gradients_match_jax_grad`) would reject: a list of
    messages, empty where the run matches."""
    bad = []
    for i, (tm, jm) in enumerate(zip(res["metrics"], metrics)):
        if sorted(tm) != sorted(jm):
            bad.append(f"step {i} metric names {sorted(tm)}")
        for k in jm:
            if not np.isclose(tm[k], jm[k], rtol=2e-3, atol=2e-4):
                bad.append(f"step {i} {k}: {tm[k]} vs {jm[k]}")
    got = dict(_leaves_with_path(jax_bridge.params_to_jax(res["trainable"])))
    for path, w in _leaves_with_path(trainable):
        if (w is None) != (got[path] is None):
            bad.append(f"{path}: trainable in one run only")
        elif w is not None and not np.allclose(got[path], np.asarray(w),
                                               rtol=0, atol=3.5 * LR):
            bad.append(f"{path}: leaf after {STEPS} steps")
    if grads is not None:
        got = dict(_leaves_with_path(jax_bridge.params_to_jax(res["grads"])))
        for path, w in _leaves_with_path(grads):
            if w is None:
                continue
            w = np.asarray(w)
            if not np.allclose(got[path], w, rtol=0,
                               atol=1e-6 + 2e-4 * np.abs(w).max()):
                bad.append(f"{path}: first step's gradient")
    return bad


@pytest.mark.parametrize("scenario", ["dp", "tp"])
def test_two_rank_steps_match_jax_global_batch(two_ranks, scenario):
    """(2, 1): each rank's 2 rows, the NTE head over the gathered 4; (1, 2):
    every row on both ranks, the towers' heads and MLP halves split. Both
    give JAX's steps on the global batch."""
    metrics, trainable = two_ranks["refs"][1]
    res = two_ranks["results"][scenario]
    assert _mismatches(res, metrics, trainable, two_ranks["grads"]) == []


def test_two_rank_batch_split_matches_jax(two_ranks):
    """batch_split 2 over 2 ranks: rank r holds rows [2i + r] of the global
    rows, so the gathered micro-batch i is JAX's micro-batch i."""
    metrics, trainable = two_ranks["refs"][2]
    res = two_ranks["results"]["dp_split2"]
    assert _mismatches(res, metrics, trainable) == []
    # and it is not the step without micro-batches
    assert _mismatches(res, *two_ranks["refs"][1])


@pytest.mark.parametrize("mutant,fails_on", [
    ("local_nte", "loss_vm"), ("local_grad_nte", "first step's gradient")])
def test_nte_gather_mutants_fail_the_check(two_ranks, mutant, fails_on):
    """The NTE head over the rank's own rows changes the loss; a gather
    whose other slices carry no gradient gives the loss of the global batch
    but 1/W of the NTE gradient: the check tells both apart from the real
    gather."""
    metrics, trainable = two_ranks["refs"][1]
    res = two_ranks["results"][f"dp:{mutant}"]
    bad = _mismatches(res, metrics, trainable, two_ranks["grads"])
    assert any(fails_on in b for b in bad), bad


def test_sharded_evaluation_gives_the_one_process_confusion(two_ranks,
                                                            models):
    """The evaluation over the ranks' clips (ragged: 4 and 3) and under
    tensor parallelism: the one-process port evaluation's confusion matrix,
    exactly."""
    _, model = models
    ev, el = two_ranks["eval"]
    loader = [{"video": ev[i:i + 2], "labels": el[i:i + 2]}
              for i in range(0, len(ev), 2)]
    acc, conf = ttrain.evaluate(model, model.params, loader, 3, None, None,
                                torch.float32, 2, device="cpu")
    assert conf.sum() == len(ev)
    for name in ("eval_dp", "eval_tp"):
        res = two_ranks["results"][name]
        np.testing.assert_array_equal(res["conf"], conf)
        assert res["acc"] == acc


# ----- two processes: cli.train ---------------------------------------------

def test_train_program_in_two_processes(tmp_path):
    """cli.train under torch.distributed.run at a global batch of 4: the
    per-step losses of the one-process run on the same flags within 1e-5,
    the same confusion matrix, and one results.txt (rank 0 alone
    writes)."""
    _make_dataset(tmp_path)
    classes = _make_assets(tmp_path)
    argv = _train_argv(tmp_path, classes)
    argv[argv.index("--batch_size") + 1] = "4"
    argv[argv.index("--num_workers") + 1] = "1"
    argv += ["--device", "cpu"]
    (tmp_path / "one").mkdir()
    (tmp_path / "two").mkdir()
    child = _launch(["-m", "gava_clip_tpu_torch.cli.train", *argv,
                     "--dist_backend", "gloo"], cwd=tmp_path / "two")
    cwd = os.getcwd()
    os.chdir(tmp_path / "one")
    try:
        ttrain.main(argv)               # the one-process run meanwhile
    finally:
        os.chdir(cwd)
        out = _finish(child)
    assert "data-parallel over 2 ranks (gloo)" in out

    def run(which):
        logs = tmp_path / which / "logs"
        (run_dir,) = os.listdir(logs)
        return logs / run_dir

    one, two = run("one"), run("two")
    results = [f for f in os.listdir(two) if f == "results.txt"]
    assert results == ["results.txt"]

    def losses(d):
        with open(d / "fold_0" / "metrics.jsonl") as f:
            return [(r["step"], r["loss"], r["loss_mt"], r["loss_vm"])
                    for r in map(json.loads, f) if "loss" in r]

    a, b = losses(one), losses(two)
    assert [r[0] for r in a] == [r[0] for r in b] == [0, 1, 2, 3]
    np.testing.assert_allclose(np.array(b)[:, 1:], np.array(a)[:, 1:],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        np.loadtxt(two / "confusion_matrix_fold-0.txt"),
        np.loadtxt(one / "confusion_matrix_fold-0.txt"))
    assert osp.isfile(two / "fold_0" / "fold-0-best.ckpt")


def _rank_pid(agent_pid: int, rank: int) -> int:
    """The pid of a rank among the launcher's children (from /proc)."""
    children = []
    for task in os.listdir(f"/proc/{agent_pid}/task"):
        with open(f"/proc/{agent_pid}/task/{task}/children") as f:
            children += [int(c) for c in f.read().split()]
    for pid in children:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = f.read().split(b"\0")
        if f"RANK={rank}".encode() in env:
            return pid
    raise AssertionError(f"no rank {rank} among {children}")


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path):
    """SIGTERM to rank 1 alone: both ranks agree on the stop at the same
    step (a max over the ranks every step), rank 0 writes one resumable
    checkpoint, and the run exits 0 instead of leaving rank 0 in the
    gradient all-reduce."""
    _make_dataset(tmp_path)
    classes = _make_assets(tmp_path)
    argv = _train_argv(tmp_path, classes)
    for flag, value in (("--batch_size", "4"), ("--num_steps", "5000"),
                        ("--eval_freq", "10000"), ("--save_freq", "10000"),
                        ("--num_workers", "1")):
        argv[argv.index(flag) + 1] = value
    child = _launch(["-m", "gava_clip_tpu_torch.cli.train", *argv,
                     "--device", "cpu", "--dist_backend", "gloo"],
                    cwd=tmp_path)
    try:
        if not child.until("step 2 ", LAUNCH_S):
            child.abandon("never reached step 2")
        os.kill(_rank_pid(child.proc.pid, 1), signal.SIGTERM)
    finally:
        out = _finish(child, 120)
    assert "[preempt]" in out, out[-2000:]
    (logdir,) = (tmp_path / "logs").iterdir()
    (ckpt,) = (logdir / "fold_0").glob("checkpoint-*.ckpt")
    ck = tckpt.load_checkpoint(str(ckpt))
    assert ck["next_step"] >= 2 and "opt_state" in ck
    assert ck["text_features"].shape == (3, 32)


# ----- data-parallel serving ------------------------------------------------

def test_classifier_over_two_devices_matches_one():
    cfg = tvc.VitaClipConfig(
        vision=VisionConfig(input_size=(32, 32), num_frames=2,
                            feature_dim=32, patch_size=(16, 16), heads=2,
                            layers=2, mlp_factor=2.0, embed_dim=16,
                            use_summary_token=True, use_local_prompts=True,
                            use_global_prompts=True, num_global_prompts=2),
        num_classes=3)
    params = tvc.init_vita_clip_params(torch.Generator().manual_seed(0), cfg)
    tf = torch.randn(3, 16, generator=torch.Generator().manual_seed(1))
    model = tvc.VitaClip(cfg, params, tf)
    clips = np.random.RandomState(2).randint(0, 255, (5, 2, 32, 32, 3),
                                             dtype=np.uint8)
    kw = dict(batch_size=4, compute_dtype=torch.float32)
    one = VideoClassifier.from_model(model, NAMES, device="cpu", **kw)
    two = VideoClassifier.from_model(model, NAMES, devices=["cpu", "cpu"],
                                     **kw)
    assert len(two.nets) == 2 and not two.pad_buckets
    np.testing.assert_allclose(two.classify_clips(clips),
                               one.classify_clips(clips), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="divisible by the number of "
                                         "devices \\(3\\)"):
        VideoClassifier.from_model(model, NAMES, devices=["cpu"] * 3, **kw)
