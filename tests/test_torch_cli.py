"""The port's programs (cli.train, cli.evaluate, cli.zero_shot) against the
JAX package's on the CPU, on the synthetic data of tests/test_cli_train.py
at its tiny sizes.

The two packages draw their initial weights from different generators, so
both runs start from ONE set of weights: the JAX model's initial
parameters, written once as a reference-format backbone `.pth` (the prompt
buffers derive from its token embedding when a model is built) and as a
`.ckpt` that both programs take as `--pretrain`; `--no_mirror` removes the
only random draw of the step. Then the per-step losses agree to 1e-4
(fp32; sums in another order through two towers over 4 steps), the files
are the same and the confusion matrices are equal. Either package's
evaluation program reads the other's run directory.
"""

import json
import os
import os.path as osp
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gava_clip_tpu.cli import analysis as janalysis
from gava_clip_tpu.cli import evaluate as jeval
from gava_clip_tpu.cli import iwa as jiwa
from gava_clip_tpu.cli import train as jtrain
from gava_clip_tpu.cli import visualize as jvis
from gava_clip_tpu.cli import zero_shot as jzs
from gava_clip_tpu.models import factory as jfactory
from gava_clip_tpu.models import vita_clip as jvc
from gava_clip_tpu.train import checkpoint as jckpt
from gava_clip_tpu.train import state as jstate
from gava_clip_tpu.utils import aggregation as jagg
from gava_clip_tpu.utils import config as jconfig
from gava_clip_tpu_torch.cli import analysis as tanalysis
from gava_clip_tpu_torch.cli import evaluate as teval
from gava_clip_tpu_torch.cli import iwa as tiwa
from gava_clip_tpu_torch.cli import train as ttrain
from gava_clip_tpu_torch.cli import visualize as tvis
from gava_clip_tpu_torch.cli import zero_shot as tzs
from gava_clip_tpu_torch.models import factory as tfactory
from gava_clip_tpu_torch.train import checkpoint as tckpt
from gava_clip_tpu_torch.utils import config as tconfig
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_cli_train import _make_assets, _make_dataset
from tests.test_torch_bounds import ChildOutput, module_deadline  # noqa: F401

CPU = ["--device", "cpu"]
NAMES = ["normal", "slight difficulty", "moderate difficulty"]


def _train_argv(root, classes):
    """The arguments of tests/test_cli_train.py, with 8 global prompts
    instead of 2: the zero-shot program builds its model with 8, and reads
    this run's weights."""
    return [
        "--nfold", "1", "--type", "updrs",
        "--data_root", str(root),
        "--text_prompt_classes_path", str(classes),
        "--num_steps", "4", "--eval_freq", "4", "--save_freq", "100",
        "--print_freq", "1", "--batch_size", "2", "--num_frames", "2",
        "--spatial_size", "32", "--patch_size", "16",
        "--num_layers", "2", "--num_heads", "2", "--feature_dim", "32",
        "--embed_dim", "32", "--mlp_factor", "2.0",
        "--text_transformer_width", "32", "--text_transformer_heads", "2",
        "--text_transformer_layers", "2", "--text_num_prompts", "2",
        "--use_text_prompt_learning", "--use_text_prompt_CSC",
        "--use_summary_token", "--use_local_prompts", "--use_global_prompts",
        "--num_global_prompts", "8",
        "--text_prompt_init", "cntn_split_uni_disc",
        "--knowledge_version", "v1",
        "--knowledge_dir", str(root / "ke_updrs"),
        "--use_support_memory", "--memory_data_path", str(root / "mem.pkl"),
        "--mem_batch_size", "4", "--clLoss_nte_video",
        "--use_focal_ordinal_loss", "--lr", "1e-3", "--num_workers", "2",
        "--no_mirror",
    ]


def _run_in(directory, fn, argv):
    cwd = os.getcwd()
    os.makedirs(directory, exist_ok=True)
    os.chdir(directory)
    try:
        out = fn(argv)
        logs = osp.join(str(directory), "logs")
        logdir = osp.join(logs, os.listdir(logs)[0]) if osp.isdir(logs) \
            else None
    finally:
        os.chdir(cwd)
    return out, logdir


def _records(logdir):
    with open(osp.join(logdir, "fold_0", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One training run of each package from the same weights."""
    root = tmp_path_factory.mktemp("cli")
    _make_dataset(root)
    classes = _make_assets(root)
    argv = _train_argv(root, classes)
    # the JAX model's initial parameters, as a backbone .pth and a .ckpt
    jargs = jconfig.build_train_parser().parse_args(argv)
    jmodel = jfactory.build_model_from_args(jargs, 3, classnames=NAMES)
    jst = jstate.create_train_state(
        jmodel.params, jvc.trainable_mask(jmodel.params, jmodel.cfg),
        jstate.make_optimizer(1e-3, 4, 0.2))
    init = jckpt.save_checkpoint(str(root / "init"), jst, 0)
    targs = tconfig.build_train_parser().parse_args(argv)
    port_params = jax_bridge.params_from_jax(
        jmodel.params, tfactory.model_config_from_args(targs, 3))
    sd = chip_smoke._reference_state_dict(port_params)
    backbone = str(root / "clip_backbone.pth")
    torch.save(sd, backbone)
    vlm = {f"module.{k}": v for k, v in sd.items() if k.startswith("visual.")}
    vlm["module.logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    torch.save({"model": vlm}, str(root / "vlm.pth"))
    argv += ["--pretrain", init, "--backbone_path", backbone]
    _, jdir = _run_in(root / "jax_run", jtrain.main, argv)
    _, tdir = _run_in(root / "torch_run", ttrain.main, argv + CPU)
    return {"root": root, "classes": classes, "argv": argv, "jax": jdir,
            "torch": tdir, "backbone": backbone, "vlm": str(root / "vlm.pth")}


def test_train_programs_write_the_same_files(runs):
    def files(logdir):
        top = {f for f in os.listdir(logdir) if not f.endswith(".png")}
        fold = {f for f in os.listdir(osp.join(logdir, "fold_0"))
                if not f.startswith("events.out")}
        return top, fold

    assert files(runs["torch"]) == files(runs["jax"])
    top, fold = files(runs["torch"])
    assert {"config.yaml", "results.txt", "confusion_matrix_fold-0.txt",
            "confusion_matrix_total.txt", "fold_0"} <= top
    assert {"metrics.jsonl", "fold-0-best.ckpt"} <= fold
    with open(osp.join(runs["torch"], "results.txt")) as f:
        txt = f.read()
    assert "Average F1-score" in txt and "Min-Max difference" in txt


def test_train_programs_losses_and_confusion_agree(runs):
    jr, tr = _records(runs["jax"]), _records(runs["torch"])
    assert [sorted(r) for r in tr] == [sorted(r) for r in jr]
    steps = [r for r in tr if "loss" in r]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    for a, b in zip(tr, jr):
        for k in ("loss", "loss_mt", "loss_vm", "acc1", "eval_acc",
                  "eval_macro_f1"):
            if k in a:
                np.testing.assert_allclose(a[k], b[k], atol=1e-4,
                                           err_msg=f"step {a['step']} {k}")
    for name in ("confusion_matrix_fold-0.txt", "confusion_matrix_total.txt"):
        np.testing.assert_array_equal(
            np.loadtxt(osp.join(runs["torch"], name)),
            np.loadtxt(osp.join(runs["jax"], name)))
    with open(osp.join(runs["torch"], "results.txt")) as f, \
            open(osp.join(runs["jax"], "results.txt")) as g:
        assert f.read() == g.read()


def test_best_checkpoints_agree(runs):
    """next_step, text_features (1e-4) and every parameter of the two best
    checkpoints; each package loads the other's file. Parameters: 1e-4 of
    the leaf's largest entry plus 1e-4 absolute after 4 updates at rate
    1e-3: Adam divides a gradient by its own size, so a leaf whose true
    gradient is zero (the key bias of an attention, which a softmax cannot
    see) moves by a fraction of the rate in the direction of fp32 noise."""
    best = osp.join("fold_0", "fold-0-best.ckpt")
    a = tckpt.load_checkpoint(osp.join(runs["torch"], best))
    b = jckpt.load_checkpoint(osp.join(runs["jax"], best))
    cross = jckpt.load_checkpoint(osp.join(runs["torch"], best))
    assert a["next_step"] == b["next_step"] == cross["next_step"] == 4
    assert a["text_features"].shape == (3, 32)
    np.testing.assert_allclose(a["text_features"], b["text_features"],
                               atol=1e-4)
    assert "params" in a and "opt_state" in a

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{path}/{k}").items()}
        return {path: np.asarray(tree)}

    fa, fb = flat(a["params"]), flat(b["params"])
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_allclose(
            fa[k], fb[k], atol=1e-4 + 1e-4 * np.abs(fb[k]).max(), err_msg=k)


def _eval_argv(runs, logdir):
    return ["--checkpoint_dir", logdir, "--data_root", str(runs["root"]),
            "--val_list_path", str(runs["root"] / "val_updrs.csv"),
            "--text_prompt_classes_path", str(runs["classes"]),
            "--batch_size", "2"]


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_evaluate_programs_agree_on_either_run(runs, which):
    """cli.evaluate of both packages on the same run directory, the
    port's own and the JAX package's: the same confusion matrix, which is
    also the training run's."""
    logdir = runs[which]
    (tperf, tconf), _ = _run_in(runs["root"] / f"e_t_{which}", teval.main,
                                _eval_argv(runs, logdir) + CPU)
    (jperf, jconf), _ = _run_in(runs["root"] / f"e_j_{which}", jeval.main,
                                _eval_argv(runs, logdir))
    assert len(tperf) == 1 and 0.0 <= tperf[0] <= 1.0
    assert tconf.sum() == 4
    np.testing.assert_array_equal(tconf, jconf)
    assert tperf == jperf
    np.testing.assert_array_equal(
        tconf, np.loadtxt(osp.join(logdir, "confusion_matrix_fold-0.txt")))
    assert [f for f in os.listdir(logdir) if f.startswith("eval_")]


def test_evaluate_program_quantized(runs):
    """--quantize_eval runs the int8 inference path (the plain versions on
    the CPU), keeps the tiny model's predictions, and is not switched off
    by the training run's saved (empty) option."""
    argv = _eval_argv(runs, runs["torch"]) + CPU
    (_, conf_fp), _ = _run_in(runs["root"] / "q0", teval.main, argv)
    seen = {}
    real = teval.prepare_inference_params

    def spy(params, quantize, dtype):
        seen["quantize"] = quantize
        return real(params, quantize, dtype)

    teval.prepare_inference_params = spy
    try:
        for mode in ("w8a8", "w8"):
            (perf, conf), _ = _run_in(runs["root"] / f"q_{mode}", teval.main,
                                      argv + ["--quantize_eval", mode])
            assert seen["quantize"] == mode
            assert len(perf) == 1 and conf.sum() == 4
            assert (conf == conf_fp).all()
    finally:
        teval.prepare_inference_params = real


def test_train_program_eval_only(runs):
    argv = [a for a in runs["argv"]]
    (perf, conf), _ = _run_in(
        runs["root"] / "eval_only", ttrain.main,
        argv + CPU + ["--eval_only", "--checkpoint_dir",
                      osp.join(runs["torch"], "fold_0"),
                      "--val_list_path",
                      str(runs["root"] / "val_updrs.csv")])
    assert len(perf) == 1 and 0.0 <= perf[0] <= 100.0
    assert conf.sum() == 4
    np.testing.assert_array_equal(
        conf, np.loadtxt(osp.join(runs["torch"],
                                  "confusion_matrix_fold-0.txt")))
    assert osp.isfile(runs["root"] / "eval_only" / "eval_output"
                      / "updrs_eval.txt")


def test_train_program_auto_augment_resumes(runs):
    """`--auto_augment` with the mirror (RandAugment, mirror, normalize on
    the device): finite losses, and a run resumed from its step-2
    checkpoint repeats the uninterrupted run's losses, since each step's
    draws depend on the step alone."""
    argv = [a for a in runs["argv"] if a != "--no_mirror"] + CPU + [
        "--auto_augment", "rand-m7-n4-mstd0.5-inc1", "--save_freq", "2"]
    _, full = _run_in(runs["root"] / "aug_full", ttrain.main, argv)
    loss = {r["step"]: r["loss"] for r in _records(full) if "loss" in r}
    assert sorted(loss) == [0, 1, 2, 3] and np.isfinite(list(loss.values()))\
        .all()
    resume = runs["root"] / "aug_resume_from"
    os.makedirs(resume)
    shutil.copy(osp.join(full, "fold_0", "checkpoint-2.ckpt"), resume)
    _, cont = _run_in(runs["root"] / "aug_resumed", ttrain.main,
                      argv + ["--auto_resume", "--checkpoint_dir",
                              str(resume)])
    again = {r["step"]: r["loss"] for r in _records(cont) if "loss" in r}
    assert again == {k: v for k, v in loss.items() if k >= 2}


@pytest.mark.parametrize("frames", ["2", "4"])
def test_zero_shot_programs_agree(runs, frames):
    """cli.zero_shot of both packages on the same backbone / checkpoint
    files: the text-feature file (1e-4), the confusion matrix and the
    report. 4 frames from the 2-frame checkpoint tiles its local prompts
    (adapt_frame_params)."""
    argv = ["--type", "updrs", "--eval_data_root", str(runs["root"]),
            "--eval_list_path", str(runs["root"] / "val_updrs.csv"),
            "--text_prompt_classes_path", str(runs["classes"]),
            "--backbone_path", runs["backbone"],
            "--pretrained_vlm", runs["vlm"],
            "--batch_size", "2", "--num_frames", frames,
            "--spatial_size", "32", "--num_layers", "2", "--num_heads", "2",
            "--feature_dim", "32", "--embed_dim", "32", "--mlp_factor", "2.0",
            "--text_transformer_width", "32",
            "--text_transformer_heads", "2",
            "--text_transformer_layers", "2", "--num_temporal_views", "1",
            "--num_workers", "2"]
    tdir, jdir = (runs["root"] / f"zs_{p}_{frames}" for p in "tj")
    (tperf, tconf), _ = _run_in(
        tdir, tzs.main, argv + CPU + ["--info_dir", str(tdir / "data")])
    (jperf, jconf), _ = _run_in(
        jdir, jzs.main, argv + ["--info_dir", str(jdir / "data")])
    assert 0.0 <= tperf <= 1.0 and tconf.shape == (3, 3) and tconf.sum() == 4
    tf_t, tf_j = (np.load(d / "data" / "ke_updrs" / "text_features_v0.npy")
                  for d in (tdir, jdir))
    np.testing.assert_allclose(tf_t, tf_j, atol=1e-4)
    np.testing.assert_array_equal(tconf, jconf)
    assert tperf == jperf
    with open(tdir / "eval_output" / "class_name.txt") as f, \
            open(jdir / "eval_output" / "class_name.txt") as g:
        assert f.read() == g.read()


def test_programs_need_a_card_by_default(runs, monkeypatch):
    """Without `--device cpu` an entry point asks for the card and raises
    where there is none. `--int8_frozen` trains on the CPU: the losses are
    finite, track the float run's within the JAX package's int8 gate
    (rtol 0.06, atol 0.05; tests/test_train_step.py) and fall."""
    _, logdir = _run_in(runs["root"] / "int8", ttrain.main,
                        runs["argv"] + CPU + ["--int8_frozen"])
    losses = [r["loss"] for r in _records(logdir) if "loss" in r]
    want = [r["loss"] for r in _records(runs["torch"]) if "loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, want, rtol=0.06, atol=0.05)
    assert losses[-1] < losses[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((ttrain.main, runs["argv"]),
                       (teval.main, _eval_argv(runs, runs["torch"]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _run_in(runs["root"] / "nocard", main, list(argv))


_RUNNER = """
import sys
from gava_clip_tpu_torch.cli.train import main
main(sys.argv[1:])
"""


def test_sigterm_checkpoints_and_exits_cleanly(tmp_path):
    """As tests/test_preemption.py: SIGTERM to the running program gives a
    resumable checkpoint and exit code 0; a second run with --auto_resume
    continues from it."""
    _make_dataset(tmp_path)
    classes = _make_assets(tmp_path)
    argv = [a for a in _train_argv(tmp_path, classes)]
    for flag, value in (("--num_steps", "5000"), ("--eval_freq", "10000"),
                        ("--save_freq", "10000")):
        argv[argv.index(flag) + 1] = value
    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", _RUNNER] + argv + CPU,
                            cwd=str(tmp_path), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    child = ChildOutput(proc)
    if not child.until("step 2 ", 300):
        child.abandon("never reached step 2 within 300 s")
    proc.send_signal(signal.SIGTERM)
    out = child.finish(120)
    assert proc.returncode == 0, out[-2000:]
    assert "[preempt]" in out, out[-2000:]
    logdir = next((tmp_path / "logs").iterdir())
    ckpts = list((logdir / "fold_0").glob("checkpoint-*.ckpt"))
    assert len(ckpts) == 1, f"no preemption checkpoint under {logdir}"
    ck = tckpt.load_checkpoint(str(ckpts[0]))
    assert ck["next_step"] >= 2 and "params" in ck and "opt_state" in ck
    assert ck["text_features"].shape == (3, 32)
    # the resumed run starts at the saved step
    short = [a for a in argv]
    short[short.index("--num_steps") + 1] = str(ck["next_step"] + 2)
    _, logdir2 = _run_in(
        tmp_path / "resumed", ttrain.main,
        short + CPU + ["--auto_resume", "--checkpoint_dir",
                       str(logdir / "fold_0")])
    steps = [r["step"] for r in _records(logdir2) if "loss" in r]
    assert steps == [ck["next_step"], ck["next_step"] + 1]


def test_profile_dir_and_nan_recovery(runs, capsys):
    """`--profile_dir` writes a torch.profiler trace of steps 2-4; with
    `--nan_recovery` a non-finite loss (forced here by an absurd rate) is
    reported and the weights are rolled back to the last checkpoint, and
    the run goes on to its end."""
    argv = [a for a in runs["argv"]]
    for flag, value in (("--num_steps", "6"), ("--eval_freq", "100"),
                        ("--save_freq", "1"), ("--lr", "1e30")):
        argv[argv.index(flag) + 1] = value
    prof = runs["root"] / "prof_run" / "trace"
    _, logdir = _run_in(runs["root"] / "prof_run", ttrain.main,
                        argv + CPU + ["--nan_recovery", "--profile_dir",
                                      str(prof)])
    out = capsys.readouterr().out
    assert osp.isfile(prof / "trace_fold_0.json")
    assert "profiler trace written" in out
    assert "[anomaly] non-finite loss at step" in out
    assert "[anomaly] rolled back weights to" in out
    steps = [r["step"] for r in _records(logdir) if "loss" in r]
    assert steps == list(range(6))


# --- the evaluation and analysis programs on the two runs --------------------

def _data_argv(runs):
    """Batches of 3 over the 4 clips: the last one is padded."""
    return ["--data_root", str(runs["root"]),
            "--val_list_path", str(runs["root"] / "val_updrs.csv"),
            "--batch_size", "3"]


def test_iwa_programs_agree(runs, monkeypatch):
    """cli.iwa of both packages over the same two run directories (the
    port's and the JAX package's): equal accuracies and confusion
    matrices, the weights to rtol 1e-4 (fp32 logits through two towers
    into a 2 x 2 Gram matrix). The two runs are close, so the Gram
    matrix's second singular value lies far below the cutoff 0.1 s_max
    and the pseudo-inverse keeps one. `--use_text_features` scores the
    same logits, as the JAX program does."""
    seen = []

    def weights(g, f, rcond=1e-1, num_singular_values=-1):
        s = np.linalg.svd(jagg.model_gram(g), compute_uv=False)
        assert np.all(np.abs(s / (rcond * s.max()) - 1) > 0.05), s
        seen.append(jagg.aggregation_weights(g, f, rcond,
                                             num_singular_values))
        return seen[-1]

    monkeypatch.setattr(jiwa, "aggregation_weights", weights)
    argv = ["--model_dirs", runs["torch"], runs["jax"],
            "--text_prompt_classes_path", str(runs["classes"]),
            "--type", "updrs"] + _data_argv(runs)
    (jperf, jconf), _ = _run_in(runs["root"] / "iwa_j", jiwa.main, argv)
    (tperf, tconf), _ = _run_in(runs["root"] / "iwa_t", tiwa.main,
                                argv + CPU)
    assert len(tperf) == 1 and tconf.sum() == 4
    assert tperf == jperf
    np.testing.assert_array_equal(tconf, jconf)
    assert len(seen) == len(tiwa.last_run["weights"]) == 1
    np.testing.assert_allclose(tiwa.last_run["weights"][0], seen[0],
                               rtol=1e-4)
    # 2 models x (2 train + 2 val batches)
    assert tiwa.last_run["forwards"] == 8
    (fperf, fconf), _ = _run_in(runs["root"] / "iwa_tf", tiwa.main,
                                argv + CPU + ["--use_text_features"])
    assert fperf == jperf
    np.testing.assert_array_equal(fconf, jconf)


def test_analysis_programs_write_the_same_report(runs):
    """cli.analysis of both packages on the port's run: the same
    per-descriptor precisions and the same report, every precision in
    [0, 1] and every class with its descriptor rows."""
    argv = ["--model_dir", runs["torch"]] + _data_argv(runs)
    out = {p: runs["root"] / f"an_{p}" for p in "tj"}
    tres, _ = _run_in(out["t"], tanalysis.main,
                      argv + CPU + ["--output_dir", str(out["t"] / "o")])
    jres, _ = _run_in(out["j"], janalysis.main,
                      argv + ["--output_dir", str(out["j"] / "o")])
    assert tres == jres and set(tres) == {0, 1, 2}
    assert all(len(d) >= 1 and all(0.0 <= v <= 1.0 for vals in d.values()
                                   for v in vals) for d in tres.values())
    name = "updrs_per_descriptor_precision.txt"
    with open(out["t"] / "o" / name) as f, open(out["j"] / "o" / name) as g:
        assert f.read() == g.read()
    assert tanalysis.last_run["forwards"] == 2


def _spy(monkeypatch, mod, name, seen):
    real = getattr(mod, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append((a, out))
        return out

    monkeypatch.setattr(mod, name, spy)


def test_visualize_project_vlm_agrees(runs, monkeypatch):
    """--project_vlm on the runs' memory bank through the port's run's
    memory heads: the projected rows to 1e-5 (numpy fp32, per-class
    products against the JAX program's einsum) and their PCA points to
    1e-4, sign included; the .npz holds the points and labels."""
    seen = {"t": [], "j": []}
    _spy(monkeypatch, tvis, "project", seen["t"])
    _spy(monkeypatch, jvis, "project", seen["j"])
    ckpt = osp.join(runs["torch"], "fold_0", "fold-0-best.ckpt")
    argv = ["--embeddings", str(runs["root"] / "mem.pkl"),
            "--project_vlm", ckpt]
    tout, _ = _run_in(runs["root"] / "vis_t", tvis.main, argv + CPU + [
        "--output_dir", str(runs["root"] / "vis_t")])
    _run_in(runs["root"] / "vis_j", jvis.main, argv + [
        "--output_dir", str(runs["root"] / "vis_j")])
    (targs, tpts), (jargs, jpts) = seen["t"][0], seen["j"][0]
    assert targs[0].shape == (12, 4)
    np.testing.assert_allclose(targs[0], jargs[0], atol=1e-5)
    np.testing.assert_allclose(tpts, jpts, atol=1e-4)
    npz = np.load(tout["npz"])
    np.testing.assert_array_equal(npz["points"], tpts)
    np.testing.assert_array_equal(npz["labels"], [0, 1, 2] * 4)


@pytest.mark.parametrize("study", ["number", "pe"])
def test_visualize_studies_agree(runs, monkeypatch, study):
    """The number-word and PE studies through the runs' tiny text tower
    (fp32, sums in another order through 2 blocks): every similarity
    matrix to 1e-5 of the JAX program's, every distance matrix through its
    square (2 - 2 cos) to 2e-5: the square root turns a rounding of 1e-7
    on the diagonal, where the distance is 0, into 3e-4."""
    seen = []
    _spy(monkeypatch, jvis, "_save_matrix", seen)
    argv = ["--study", study, "--study_n", "12",
            "--backbone_path", runs["backbone"], "--embed_dim", "32",
            "--text_width", "32", "--text_heads", "2", "--text_layers", "2"]
    tdir, jdir = (runs["root"] / f"study_{p}_{study}" for p in "tj")
    tout, _ = _run_in(tdir, tvis.main,
                      argv + CPU + ["--output_dir", str(tdir)])
    _run_in(jdir, jvis.main, argv + ["--output_dir", str(jdir)])
    got = np.load(tout["npz"])
    assert len(got.files) == len(seen) == (10 if study == "number" else 2)
    for (mat, title, png, _), _ in seen:
        key = osp.basename(png)[len("number_"):-len(".png")]
        key = key[:-len("_pe")] if study == "pe" else key
        assert osp.isfile(tout[key])
        if key.endswith("distance"):
            np.testing.assert_allclose(got[key] ** 2, mat ** 2, atol=2e-5,
                                       err_msg=title)
        else:
            np.testing.assert_allclose(got[key], mat, atol=1e-5,
                                       err_msg=title)


def test_visualize_cones_and_pairwise_without_matplotlib(runs, monkeypatch,
                                                         tmp_path):
    """--cones and --pairwise on two files: the points (1e-4) and the
    similarity means of the JAX program; without matplotlib (the card's
    machine) the port still writes its .npz files and draws nothing."""
    rs = np.random.RandomState(5)
    other = str(tmp_path / "text.npy")
    np.save(other, rs.randn(9, 32).astype(np.float32))
    bank = str(runs["root"] / "mem.pkl")
    cones = ["--cones", f"bank={bank}", f"text={other}"]
    pair = ["--pairwise", f"text={other}", "--base", bank]
    jc = jvis.main(cones + ["--output_dir", str(tmp_path / "j")])
    jp = jvis.main(pair + ["--output_dir", str(tmp_path / "j")])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "t")
    tc = tvis.main(cones + CPU + ["--output_dir", out])
    tp = tvis.main(pair + CPU + ["--output_dir", out])
    assert tc["labels"] == jc["labels"] and "cones" not in tc
    np.testing.assert_allclose(tc["points"], jc["points"], atol=1e-4)
    np.testing.assert_allclose(np.load(tc["npz"])["points"], jc["points"],
                               atol=1e-4)
    for k in ("mean_base", "mean_sub"):
        assert tp["text"][k] == pytest.approx(jp["text"][k], abs=1e-6)
    assert "png" not in tp["text"] and osp.isfile(tp["text"]["npz"])
    assert not [f for f in os.listdir(out) if f.endswith(".png")]


@pytest.mark.parametrize("program", ["iwa", "analysis", "visualize"])
def test_evaluation_tools_need_a_card_by_default(runs, monkeypatch, program):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = {
        "iwa": (tiwa.main, ["--model_dirs", runs["torch"],
                            "--text_prompt_classes_path",
                            str(runs["classes"])] + _data_argv(runs)),
        "analysis": (tanalysis.main,
                     ["--model_dir", runs["torch"]] + _data_argv(runs)),
        "visualize": (tvis.main,
                      ["--embeddings", str(runs["root"] / "mem.pkl")]),
    }[program]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run_in(runs["root"] / "nocard_tools", main, argv)
