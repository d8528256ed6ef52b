"""Checkpoints and the weight converter of the PyTorch port against the JAX
package's on the CPU: save / async write / auto-resume, either package
reading the other's `params`, `next_step` and `text_features`, a resumed
run bit-equal to an uninterrupted one, and the reference state-dict
converter leaf by leaf. Weights cross as numpy arrays; every comparison of
stored values is exact unless a tolerance is stated.
"""

import argparse
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from gava_clip_tpu.models import factory as jfactory
from gava_clip_tpu.models import vita_clip as jvc
from gava_clip_tpu.train import checkpoint as jckpt
from gava_clip_tpu.train import state as jstate
from gava_clip_tpu.utils import config as jconfig
from gava_clip_tpu.utils import torch_convert as jconvert
from gava_clip_tpu_torch.models import factory as tfactory
from gava_clip_tpu_torch.models import vita_clip as tvc
from gava_clip_tpu_torch.train import checkpoint as tckpt
from gava_clip_tpu_torch.train import state as tstate
from gava_clip_tpu_torch.train import step as tstep
from gava_clip_tpu_torch.utils import config as tconfig
from gava_clip_tpu_torch.utils import jax_bridge
from gava_clip_tpu_torch.utils import torch_convert as tconvert
from tests.test_cli_train import _make_assets

NAMES = ["normal", "slight difficulty", "moderate difficulty"]
TINY = [
    "--type", "updrs", "--num_steps", "10", "--num_frames", "2",
    "--spatial_size", "32", "--patch_size", "16", "--num_layers", "2",
    "--num_heads", "2", "--feature_dim", "32", "--embed_dim", "32",
    "--mlp_factor", "2.0", "--text_transformer_width", "32",
    "--text_transformer_heads", "2", "--text_transformer_layers", "2",
    "--text_num_prompts", "2", "--use_text_prompt_learning",
    "--use_text_prompt_CSC", "--use_summary_token", "--use_local_prompts",
    "--use_global_prompts", "--num_global_prompts", "2",
    "--text_prompt_init", "cntn_split_uni_disc", "--knowledge_version", "v1",
    "--use_support_memory", "--clLoss_nte_video"]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_assets")
    _make_assets(root)
    return root


def _args(mod, assets, extra=()):
    return mod.build_train_parser().parse_args(
        TINY + ["--knowledge_dir", str(assets / "ke_updrs")] + list(extra))


def _port_state(assets, seed=0, lr=1e-2):
    model = tfactory.build_model_from_args(
        _args(tconfig, assets), 3, classnames=NAMES, rng_seed=seed,
        device="cpu")
    opt = tstate.make_optimizer(lr, 10, 0.2)
    state = tstate.create_train_state(
        model.params, tvc.trainable_mask(model.params, model.cfg), opt,
        device="cpu")
    return model, opt, state


def _jax_state(assets, seed=0):
    model = jfactory.build_model_from_args(
        _args(jconfig, assets), 3, classnames=NAMES, rng_seed=seed)
    mask = jvc.trainable_mask(model.params, model.cfg)
    state = jstate.create_train_state(
        model.params, mask, jstate.make_optimizer(1e-2, 10, 0.2))
    return model, mask, state


def _flat(tree, path=""):
    """{path: array} of a JAX-layout tree (numpy or jax arrays)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {} if tree is None else {path: np.asarray(tree)}


def _assert_same_params(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _batches(n, seed=1):
    rs = np.random.RandomState(seed)
    return [{"video": torch.from_numpy(
                 rs.rand(2, 2, 32, 32, 3).astype(np.float32)),
             "labels": torch.from_numpy(rs.randint(0, 3, 2)),
             "nte": torch.from_numpy(rs.randn(2, 70, 32).astype(np.float32)),
             "memory": torch.from_numpy(
                 rs.randn(4, 3, 32).astype(np.float32)),
             "mt_labels": torch.from_numpy(rs.randint(0, 3, 4))}
            for _ in range(n)]


LOSS = tstep.LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                        use_support_memory=True, add_nte=True)


def _plain(x) -> bool:
    """numpy arrays, Python scalars and plain containers only."""
    if isinstance(x, dict):
        return all(isinstance(k, str) and _plain(v) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return all(_plain(v) for v in x)
    return x is None or isinstance(x, (np.ndarray, np.generic, int, float,
                                       str, bool))


def test_save_async_and_autoresume(assets, tmp_path):
    model, opt, state = _port_state(assets)
    step = tstep.make_train_step(model, LOSS, opt)
    state, _ = step(state, _batches(1)[0])
    tf = np.arange(96, dtype=np.float32).reshape(3, 32)
    assert tckpt.save_checkpoint("", state, 1) == ""
    p1 = tckpt.save_checkpoint(str(tmp_path), state, 1, text_features=tf)
    p7 = tckpt.save_checkpoint(str(tmp_path), state, 7, async_write=True)
    pb = tckpt.save_checkpoint(str(tmp_path), state, 7, is_best=True,
                               name="fold-0", async_write=True)
    tckpt.wait_for_saves()
    assert [os.path.basename(p) for p in (p1, p7, pb)] == \
        ["checkpoint-1.ckpt", "checkpoint-7.ckpt", "fold-0-best.ckpt"]
    assert all(os.path.isfile(p) for p in (p1, p7, pb))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert tckpt.find_autoresume_path(str(tmp_path)) == p7
    assert tckpt.find_autoresume_path(str(tmp_path / "none")) is None
    with open(p1, "rb") as f:
        raw = pickle.load(f)
    assert set(raw) == {"params", "opt_state", "next_step", "text_features"}
    assert _plain(raw), "a checkpoint holds numpy and plain containers only"
    np.testing.assert_array_equal(raw["text_features"], tf)
    assert raw["next_step"] == 1 and raw["opt_state"]["step"] == 1
    # params in the JAX layout: blocks stacked on a leading layer axis
    assert raw["params"]["visual"]["blocks"]["attn"]["q"]["kernel"].shape \
        == (2, 32, 32)
    _assert_same_params(raw["params"], jax_bridge.params_to_jax(state.params))
    # a failed write surfaces at wait_for_saves, once
    tckpt.save_checkpoint(str(tmp_path / "f"), state, 2, async_write=True)
    tckpt._PENDING.append(tckpt._writer().submit(
        tckpt._write_payload, {}, str(tmp_path / "no_dir" / "x.ckpt")))
    with pytest.raises(OSError):
        tckpt.wait_for_saves()
    tckpt.wait_for_saves()
    for fn in (tckpt.save_checkpoint_orbax, tckpt.load_checkpoint_orbax):
        with pytest.raises(NotImplementedError, match="A10"):
            fn(str(tmp_path), state, 1)
    with pytest.raises(NotImplementedError, match="A10"):
        tckpt.load_checkpoint(str(tmp_path / "x.orbax"))


def test_port_reads_jax_checkpoint(assets, tmp_path):
    """JAX `save_checkpoint` -> the port's `load_checkpoint` and
    `--pretrain`: every parameter, next_step and text_features arrive; a
    resume from it (another optimizer state) raises."""
    jmodel, mask, jst = _jax_state(assets, seed=3)
    tf = np.random.RandomState(0).randn(3, 32).astype(np.float32)
    path = jckpt.save_checkpoint(str(tmp_path), jst, 5, text_features=tf)
    ck = tckpt.load_checkpoint(path)
    assert ck["next_step"] == 5
    np.testing.assert_array_equal(ck["text_features"], tf)
    model, opt, state = _port_state(assets, seed=0)
    ns = argparse.Namespace(pretrain=path, resume_path=None,
                            auto_resume=False, checkpoint_dir=None)
    state, step0, tf0 = tckpt.resume_from_checkpoint(state, None, ns)
    assert step0 == 0 and tf0 is None and state.step == 0
    _assert_same_params(jax_bridge.params_to_jax(state.params),
                        jax.tree_util.tree_map(np.asarray, jmodel.params))
    assert all(p.requires_grad for p in tstate.tree_leaves(state.trainable)
               if p is not None)
    ns.pretrain, ns.resume_path = None, path
    with pytest.raises(ValueError, match="opt_state is not this package's"):
        tckpt.resume_from_checkpoint(state, None, ns)


def test_port_reads_jax_checkpoint_without_optax(assets, tmp_path,
                                                 monkeypatch):
    """Where the JAX package's optimizer library cannot be imported its
    objects load as placeholders and the weights are still read."""
    _, _, jst = _jax_state(assets, seed=3)
    path = jckpt.save_checkpoint(str(tmp_path), jst, 5)
    real = tckpt._Unpickler._import

    def missing(self, module, name):
        if module.split(".")[0] in ("optax", "jax", "jaxlib"):
            raise ModuleNotFoundError(module)
        return real(self, module, name)

    monkeypatch.setattr(tckpt._Unpickler, "_import", missing)
    ck = tckpt.load_checkpoint(path)
    assert ck["next_step"] == 5
    assert "_Opaque" in repr(jax.tree_util.tree_leaves(
        ck["opt_state"], is_leaf=lambda x: isinstance(x, tckpt._Opaque)))
    _assert_same_params(ck["params"], jckpt.load_checkpoint(path)["params"])


def test_jax_reads_port_checkpoint(assets, tmp_path):
    """The port's `save_checkpoint` -> the JAX package's `load_checkpoint`
    and `--pretrain`."""
    model, opt, state = _port_state(assets, seed=4)
    tf = np.random.RandomState(1).randn(3, 32).astype(np.float32)
    path = tckpt.save_checkpoint(str(tmp_path), state, 9, text_features=tf)
    ck = jckpt.load_checkpoint(path)
    assert ck["next_step"] == 9
    np.testing.assert_array_equal(ck["text_features"], tf)
    jmodel, mask, jst = _jax_state(assets, seed=0)
    ns = argparse.Namespace(pretrain=path, resume_path=None,
                            auto_resume=False, checkpoint_dir=None)
    jst, step0, _ = jckpt.resume_from_checkpoint(jst, mask, ns)
    assert step0 == 0
    _assert_same_params(
        jax.tree_util.tree_map(np.asarray, jst.params),
        jax_bridge.params_to_jax(state.params))


@pytest.mark.parametrize("how", ["auto_resume", "resume_path"])
def test_resumed_run_is_bit_equal(assets, tmp_path, how):
    """2 steps + save + resume in a fresh state + 2 steps = 4 straight
    steps: every loss, parameter, AdamW moment and the rate."""
    batches = _batches(4)

    def run(n_first):
        model, opt, state = _port_state(assets)
        step = tstep.make_train_step(model, LOSS, opt)
        losses = []
        for b in batches[:n_first]:
            state, m = step(state, b)
            losses.append(m["total"].item())
        return model, opt, state, step, losses

    _, _, straight, _, want = run(4)
    _, _, state, _, losses = run(2)
    path = tckpt.save_checkpoint(str(tmp_path), state, 2, async_write=True,
                                 text_features=np.ones((3, 32), np.float32))
    tckpt.wait_for_saves()
    # the same model (its prompt buffers derive from the token embedding at
    # construction), every weight moved away before the load
    model, opt, fresh = _port_state(assets)
    with torch.no_grad():
        for p in tstate.tree_leaves(fresh.params):
            p.add_(0.5)
    ns = argparse.Namespace(
        pretrain=None, checkpoint_dir=str(tmp_path),
        auto_resume=how == "auto_resume",
        resume_path=path if how == "resume_path" else None)
    fresh, step0, tf = tckpt.resume_from_checkpoint(fresh, None, ns)
    assert step0 == 2 and fresh.step == 2 and tf.shape == (3, 32)
    step = tstep.make_train_step(model, LOSS, opt)
    for b in batches[2:]:
        fresh, m = step(fresh, b)
        losses.append(m["total"].item())
    assert losses == want
    for a, b in zip(tstate.tree_leaves(fresh.params),
                    tstate.tree_leaves(straight.params)):
        assert torch.equal(a, b)
    sa, sb = (jax_bridge.train_state_to_jax(s) for s in (fresh, straight))
    for key in ("mu", "nu"):
        _assert_same_params(sa[key], sb[key])
    assert fresh.scheduler.get_last_lr() == straight.scheduler.get_last_lr()
    assert fresh.optimizer.param_groups[0]["lr"] == \
        straight.optimizer.param_groups[0]["lr"]


def test_no_checkpoint_leaves_state_alone(assets, tmp_path):
    model, opt, state = _port_state(assets)
    before = [p.clone() for p in tstate.tree_leaves(state.params)]
    ns = argparse.Namespace(pretrain=None, resume_path=None, auto_resume=True,
                            checkpoint_dir=str(tmp_path))
    state, step0, tf = tckpt.resume_from_checkpoint(state, None, ns)
    assert step0 == 0 and tf is None
    assert all(torch.equal(a, b) for a, b in
               zip(before, tstate.tree_leaves(state.params)))


# ----- the reference state-dict converter -----------------------------------

def _reference_state_dict(seed=0, L=2, D=32, T=2, G=2, W=32, E=32, n_cls=3,
                          vocab=50, ctx=77):
    """A synthetic state dict under the reference model's names."""
    rs = np.random.RandomState(seed)
    sd = {}

    def t(*shape):
        return rs.randn(*shape).astype(np.float32)

    def lin(name, i, o, bias=True):
        sd[f"{name}.weight"] = t(o, i)
        if bias:
            sd[f"{name}.bias"] = t(o)

    def ln(name, d):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = t(d), t(d)

    sd["visual.patch_embed.proj.weight"] = t(D, 3, 16, 16)
    sd["visual.patch_embed.proj.bias"] = t(D)
    sd["visual.cls_token"], sd["visual.pos_embed"] = t(D), t(5, D)
    sd["visual.time_embed"], sd["visual.proj"] = t(T, D), t(D, E)
    sd["visual.global_prompts"] = t(L, G, D)
    ln("visual.ln_pre", D)
    ln("visual.ln_post", D)
    for i in range(L):
        b = f"visual.blocks.{i}"
        for n in ("q", "k", "v", "out"):
            lin(f"{b}.attn.{n}_proj", D, D)
            lin(f"{b}.summary_attn_layer.{n}_proj", D, D)
        ln(f"{b}.norm1", D)
        ln(f"{b}.norm2", D)
        ln(f"{b}.summary_ln", D)
        lin(f"{b}.mlp.fc1", D, 2 * D)
        lin(f"{b}.mlp.fc2", 2 * D, D)
        lin(f"{b}.cls_proj", D, D)
        sd[f"{b}.local_prompts"] = t(1, T, D)
    sd["textual.token_embedding.weight"] = t(vocab, W)
    sd["textual.positional_embedding"] = t(ctx, W)
    sd["textual.text_projection"] = t(W, E)
    ln("textual.ln_final", W)
    for i in range(L):
        b = f"textual.transformer.resblocks.{i}"
        sd[f"{b}.attn.in_proj_weight"] = t(3 * W, W)
        sd[f"{b}.attn.in_proj_bias"] = t(3 * W)
        lin(f"{b}.attn.out_proj", W, W)
        ln(f"{b}.ln_1", W)
        ln(f"{b}.ln_2", W)
        lin(f"{b}.mlp.c_fc", W, 4 * W)
        lin(f"{b}.mlp.c_proj", 4 * W, W)
    sd["prompt_learner.ctx"] = t(n_cls, 4, W)
    pfx = "prompt_learner.context_prompt_learner.projector"
    for c in range(n_cls):
        sd[f"{pfx}.{c}.0.weight"], sd[f"{pfx}.{c}.2.weight"] = t(8, 768), \
            t(W, 8)
        for j, (i, o) in ((0, (E, E // 4)), (2, (E // 4, E // 8))):
            sd[f"memory_project.{c}.{j}.weight"] = t(o, i)
            sd[f"memory_project.{c}.{j}.bias"] = t(o)
    for j, (i, o) in ((0, (E, E // 4)), (2, (E // 4, E // 8))):
        sd[f"tf_project.{j}.weight"], sd[f"tf_project.{j}.bias"] = t(o, i), \
            t(o)
    lin("sum_proj", D, E)
    for name in ("logit_scale", "logit_scale_vm", "logit_scale_mt"):
        sd[name] = np.float32(rs.randn())
    return sd


def _stacked(tree):
    """The port's converter output (per-layer lists) in the JAX layout."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        layers = [_stacked(v) for v in tree]
        return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *layers)
    return tree


@pytest.mark.parametrize("variant", [None, "class_uni"])
def test_convert_vita_clip_equals_jax_leaf_by_leaf(variant):
    sd = _reference_state_dict()
    kw = dict(vision_layers=2, text_layers=2, num_classes=3,
              prompt_variant=variant)
    want = jconvert.convert_vita_clip(sd, **kw)
    got = tconvert.convert_vita_clip(sd, **kw)
    assert isinstance(got["visual"]["blocks"], list) and \
        len(got["textual"]["blocks"]) == 2
    _assert_same_params(_stacked(got), want)
    assert ("projector" in got["prompt"]) == (variant is not None)
    # the towers alone, and the prefix helper
    vis = tconvert.strip_prefix(sd, "visual.")
    assert set(vis) == set(jconvert.strip_prefix(sd, "visual."))
    _assert_same_params(_stacked(tconvert.convert_vision_tower(vis, 2)),
                        jconvert.convert_vision_tower(vis, 2))


def test_plain_uni_projector_and_missing_bias():
    sd = _reference_state_dict()
    pfx = "prompt_learner.context_prompt_learner.projector"
    rs = np.random.RandomState(1)
    sd.update({f"{pfx}.0.weight": rs.randn(8, 768).astype(np.float32),
               f"{pfx}.0.bias": rs.randn(8).astype(np.float32),
               f"{pfx}.2.weight": rs.randn(32, 8).astype(np.float32),
               f"{pfx}.2.bias": rs.randn(32).astype(np.float32)})
    del sd["visual.patch_embed.proj.bias"]
    kw = dict(vision_layers=2, text_layers=2, num_classes=3,
              prompt_variant="plain_uni")
    got = tconvert.convert_vita_clip(sd, **kw)
    _assert_same_params(_stacked(got), jconvert.convert_vita_clip(sd, **kw))
    assert not got["visual"]["patch_embed"]["bias"].any()


def test_load_state_dict_merge_and_adapt(tmp_path):
    sd = _reference_state_dict()
    path = tmp_path / "ckpt.pth"
    torch.save({"model": {f"module.{k}": torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()},
                "next_step": 3,
                "text_features": torch.ones(3, 32)}, path)
    flat = tconvert.load_torch_state_dict(str(path))
    assert set(flat) == {f"module.{k}" for k in sd}
    ck = tckpt.load_checkpoint(str(path))
    assert ck["next_step"] == 3 and ck["text_features"].shape == (3, 32)
    assert set(ck["torch_state_dict"]) == set(sd)
    np.testing.assert_array_equal(ck["torch_state_dict"]["visual.proj"],
                                  sd["visual.proj"])
    # merge: per-layer lists and the JAX layout give the same tensors
    conv = tconvert.convert_vita_clip(sd, vision_layers=2, text_layers=2,
                                      num_classes=3)
    base = {"visual": {"blocks": [{"norm1": {"scale": torch.zeros(32),
                                             "bias": torch.zeros(32)},
                                   "keep": torch.ones(2)}
                                  for _ in range(2)],
                       "proj": torch.zeros(32, 32)},
            "other": torch.ones(1)}
    part = {"visual": {"blocks": [{"norm1": b["norm1"]}
                                  for b in conv["visual"]["blocks"]],
                       "proj": conv["visual"]["proj"]}}
    a = tconvert.merge_pytrees(base, part)
    b = tconvert.merge_pytrees(base, _stacked(part))
    for m in (a, b):
        assert torch.equal(m["other"], base["other"])
        assert torch.equal(m["visual"]["blocks"][1]["keep"], torch.ones(2))
        np.testing.assert_array_equal(
            m["visual"]["blocks"][1]["norm1"]["scale"].numpy(),
            sd["visual.blocks.1.norm1.weight"])
        np.testing.assert_array_equal(m["visual"]["proj"].numpy(),
                                      sd["visual.proj"])
    with pytest.raises(ValueError, match="layers"):
        tconvert.merge_pytrees(base, {"visual": {"blocks": [{}]}})
    # frame adaptation of local_prompts: tile when divisible, else nearest;
    # equal to the JAX function on the stacked tree
    for T in (4, 3, 2):
        got = tconvert.adapt_frame_params(conv["visual"], T)
        want = jconvert.adapt_frame_params(_stacked(conv["visual"]), T)
        assert got["blocks"][0]["local_prompts"].shape == (1, T, 32)
        _assert_same_params(_stacked(got), want)
