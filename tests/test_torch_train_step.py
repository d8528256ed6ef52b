"""The PyTorch port's training slice against the JAX package on the CPU:
losses, optimizer, trainable mask, the whole `apply`, the loss gradients
leaf by leaf, three train steps, micro-batching, rematerialization and the
eval step. The tiny model and batch are those of tests/test_train_step.py;
the JAX parameters cross through utils/jax_bridge.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from gava_clip_tpu.models import prompts as jprompts
from gava_clip_tpu.models import text as jtext
from gava_clip_tpu.models import vision as jvision
from gava_clip_tpu.models import vita_clip as jvc
from gava_clip_tpu.train import losses as jlosses
from gava_clip_tpu.train import state as jstate
from gava_clip_tpu.train import step as jstep
from gava_clip_tpu_torch.models import vita_clip as tvc
from gava_clip_tpu_torch.models.prompts import PromptConfig
from gava_clip_tpu_torch.models.text import TextConfig
from gava_clip_tpu_torch.models.vision import VisionConfig, vision_encoder
from gava_clip_tpu_torch.train import losses as tlosses
from gava_clip_tpu_torch.train import state as tstate
from gava_clip_tpu_torch.train import step as tstep
from gava_clip_tpu_torch.utils import flagship as tflagship
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_torch_bounds import module_deadline  # noqa: F401

N_CLS = 3
LOSS_KW = dict(num_classes=3, focal_ordinal=True, fo_beta=0.2,
               use_support_memory=True, add_nte=True)


def _port_cfg(jcfg) -> tvc.VitaClipConfig:
    kw = dataclasses.asdict(jcfg)
    kw["vision"] = VisionConfig(**kw["vision"])
    kw["text"] = TextConfig(**kw["text"])
    kw["prompt"] = PromptConfig(**kw["prompt"]) if kw["prompt"] else None
    return tvc.VitaClipConfig(**kw)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX tiny model of tests/test_train_step.py and the port's model
    around the same parameters and buffers."""
    return tiny_models(tmp_path_factory.mktemp("ke_updrs"))


def tiny_models(ke, num_frames: int = 2):
    """The tiny model pair of `models` with `num_frames` training frames,
    its knowledge files written into the directory `ke`."""
    rs = np.random.RandomState(0)
    for kv in ("v1", "v2"):
        np.save(ke / f"EntityEmb_{kv}.npy",
                rs.randn(N_CLS, 768).astype(np.float32))
        with open(ke / f"simQdesc_{kv}.txt", "w") as f:
            for c in range(N_CLS):
                f.write(f"desc {kv} class {c}\n")
    jcfg = jvc.VitaClipConfig(
        vision=jvision.VisionConfig(
            input_size=(32, 32), num_frames=num_frames, feature_dim=32,
            patch_size=(16, 16), heads=2, layers=2, mlp_factor=2.0,
            embed_dim=32, use_summary_token=True, use_local_prompts=True,
            use_global_prompts=True, num_global_prompts=2),
        text=jtext.TextConfig(embed_dim=32, width=32, heads=2, layers=2),
        num_classes=N_CLS, use_text_prompt_learning=True,
        prompt=jprompts.PromptConfig(
            n_cls=N_CLS, n_ctx=4, ctx_dim=32, emb_dim=8,
            init="cntn_split_uni_disc", csc=True,
            knowledge_versions=("v1", "v2"), knowledge_dir=str(ke)),
        use_support_memory=True, add_nte=True)
    names = ["normal", "slight difficulty", "moderate difficulty"]
    jmodel = jvc.VitaClip(jcfg, classnames=names)
    # the zero-initialised prompt context and projector would hide their
    # own arithmetic: give them (and so every leaf) a value
    rs = np.random.RandomState(7)
    prompt = jax.tree_util.tree_map(
        lambda a: (0.05 * rs.randn(*a.shape)).astype(np.float32),
        jmodel.params["prompt"])
    jmodel.params = dict(jmodel.params, prompt=prompt)
    cfg = _port_cfg(jcfg)
    model = tvc.VitaClipModel(
        cfg, params=jax_bridge.params_from_jax(jmodel.params, cfg),
        buffers=jax_bridge.buffers_from_jax(jmodel.buffers), device="cpu")
    return jmodel, model


def _batch(B=4, T=2, E=32, Bm=6, seed=1):
    rs = np.random.RandomState(seed)
    return {"video": rs.randn(B, T, 32, 32, 3).astype(np.float32),
            "labels": rs.randint(0, 3, size=B),
            "nte": rs.randn(B, 70, E).astype(np.float32),
            "memory": rs.randn(Bm, 4, E).astype(np.float32),
            "mt_labels": rs.randint(0, 3, size=Bm)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves_with_path(tree):
    """(path, leaf) of a JAX-layout tree, None placeholders kept."""
    return [(jax.tree_util.keystr(k), v) for k, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: x is None)[0]]


# ----- losses ---------------------------------------------------------------

def test_losses_match_jax():
    rs = np.random.RandomState(0)
    logits = (3 * rs.randn(7, 4)).astype(np.float32)
    labels = rs.randint(0, 4, 7)
    multi = (rs.rand(7, 4) > 0.5).astype(np.float32)
    sim = rs.randn(5, 5).astype(np.float32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    jy, ty = jnp.asarray(labels), torch.from_numpy(labels)
    cases = [
        (jlosses.cross_entropy(jl, jy), tlosses.cross_entropy(tl, ty)),
        (jlosses.focal_ordinal_weight(jl, jy, beta=0.2, scale=1.5),
         tlosses.focal_ordinal_weight(tl, ty, beta=0.2, scale=1.5)),
        (jlosses.focal_ordinal_weight(jl, jy),
         tlosses.focal_ordinal_weight(tl, ty)),
        (jlosses.sigmoid_focal_loss(jl, jy, scale=0.1),
         tlosses.sigmoid_focal_loss(tl, ty, scale=0.1)),
        (jlosses.sigmoid_focal_loss(jl, jnp.asarray(multi), use_focal=True),
         tlosses.sigmoid_focal_loss(tl, torch.from_numpy(multi),
                                    use_focal=True)),
        (jlosses.cosine_similarity_nce(jnp.asarray(sim), weight=0.5),
         tlosses.cosine_similarity_nce(torch.from_numpy(sim), weight=0.5)),
        (jlosses.info_nce(jl, jy, 4), tlosses.info_nce(tl, ty, 4)),
        (jlosses.info_nce(jl, jy, 4, focal=True, weight=2.0),
         tlosses.info_nce(tl, ty, 4, focal=True, weight=2.0)),
    ]
    for want, got in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-6)


def test_compute_losses_matches_jax():
    rs = np.random.RandomState(1)
    out = {"logits": rs.randn(4, 3).astype(np.float32),
           "logits_mt": rs.randn(6, 3).astype(np.float32),
           "logits_vm": rs.randn(4, 4).astype(np.float32)}
    b = _batch()
    for kw in (LOSS_KW, dict(num_classes=3),
               dict(num_classes=3, sigmoid_loss=True, use_support_memory=True,
                    add_nte=True, memory_loss_weight=0.3)):
        jt, jm = jstep.compute_losses(
            {k: jnp.asarray(v) for k, v in out.items()},
            jnp.asarray(b["labels"]), jnp.asarray(b["mt_labels"]),
            jstep.LossConfig(**kw))
        tt, tm = tstep.compute_losses(
            {k: torch.from_numpy(v) for k, v in out.items()},
            torch.from_numpy(b["labels"]), torch.from_numpy(b["mt_labels"]),
            tstep.LossConfig(**kw))
        assert sorted(tm) == sorted(jm)
        np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-5)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5)


# ----- optimizer ------------------------------------------------------------

def test_optimizer_matches_optax():
    """Three AdamW updates with the cosine schedule against optax, on a
    matrix, a vector and a scalar (weight decay reaches scalars too), with
    fixed numpy gradients. fp32 arithmetic in another order: 1e-6."""
    rs = np.random.RandomState(0)
    shapes = {"w": (5, 3), "b": (3,), "s": ()}
    p0 = {k: np.asarray(rs.randn(*s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(rs.randn(*s), np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    lr, steps, wd = 3e-2, 5, 0.2
    opt = jstate.make_optimizer(lr, steps, wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    ost = opt.init(jp)
    cfg = tstate.make_optimizer(lr, steps, wd)
    tp = {k: torch.tensor(v).requires_grad_() for k, v in p0.items()}
    topt, sched = cfg.build(list(tp.values()))
    for i, g in enumerate(grads):
        upd, ost = opt.update({k: jnp.asarray(v) for k, v in g.items()}, ost,
                              jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.tensor(g[k])
        assert sched.get_last_lr()[0] == pytest.approx(
            float(jstate.cosine_lr(lr, steps)(i)), rel=1e-6)
        topt.step()
        sched.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6)
    sched_fn = tstate.cosine_lr(lr, steps)
    for t in (0, 1, 4, 5, 9):
        assert sched_fn(t) == pytest.approx(
            float(jstate.cosine_lr(lr, steps)(t)), rel=1e-6)   # optax: fp32


# ----- mask and state -------------------------------------------------------

def test_trainable_mask_equal_leaf_for_leaf(models):
    jmodel, model = models
    want = jvc.trainable_mask(jmodel.params, jmodel.cfg)
    got = tvc.trainable_mask(model.params, model.cfg)
    # the port's mask in the JAX layout: a stacked leaf is trainable iff
    # each of its layers is
    stacked = jax_bridge.params_to_jax(jax.tree_util.tree_map(
        lambda m: torch.tensor(m), got))
    flat_w = dict(_leaves_with_path(want))
    flat_g = dict(_leaves_with_path(stacked))
    assert sorted(flat_g) == sorted(flat_w)
    for path, w in flat_w.items():
        assert bool(np.all(flat_g[path] == w)), path
    n_train = sum(bool(m) for m in jax.tree_util.tree_leaves(got))
    assert 0 < n_train < len(jax.tree_util.tree_leaves(got))
    assert not any(jax.tree_util.tree_leaves(got["textual"]))


def test_create_train_state_partitions(models):
    _, model = models
    mask = tvc.trainable_mask(model.params, model.cfg)
    st = tstate.create_train_state(model.params, mask,
                                   tstate.make_optimizer(1e-3, 10),
                                   device="cpu")
    t_leaves = tstate.tree_leaves(st.trainable)
    f_leaves = tstate.tree_leaves(st.frozen)
    m_leaves = tstate.tree_leaves(mask)
    assert len(t_leaves) == len(f_leaves) == len(m_leaves)
    for t, f, m in zip(t_leaves, f_leaves, m_leaves):
        assert (t is not None) == m and (f is None) == m
        if m:
            assert t.requires_grad and t.dtype == torch.float32
        else:
            assert not f.requires_grad
    # the model's own tensors were not touched
    assert not any(p.requires_grad for p in
                   tstate.tree_leaves(model.params))
    groups = st.optimizer.param_groups
    assert sum(len(g["params"]) for g in groups) == sum(m_leaves)
    combined = tstate.tree_leaves(st.params)
    assert all(c is not None for c in combined)
    tr, fr = tstate.partition_params(model.params, mask)
    back = tstate.combine_params(tr, fr)
    assert all(a is b for a, b in zip(tstate.tree_leaves(back),
                                      tstate.tree_leaves(model.params)))
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.create_train_state(model.params, mask,
                                  tstate.make_optimizer(1e-3, 10))


# ----- the slice as a whole -------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_apply_matches_jax(models, attn_impl):
    """Every output of `apply` at fp32, for both attention paths (flash:
    the Pallas kernels in interpret mode against the plain versions)."""
    jmodel, model = models
    b = _batch()
    want = jmodel.apply(jmodel.params, jmodel.buffers, jnp.asarray(b["video"]),
                        memory=jnp.asarray(b["memory"]),
                        video_nte=jnp.asarray(b["nte"]), desc_wise=True,
                        attn_impl=attn_impl)
    got = model.apply(model.params, model.buffers,
                      torch.from_numpy(b["video"]),
                      memory=torch.from_numpy(b["memory"]),
                      video_nte=torch.from_numpy(b["nte"]), desc_wise=True,
                      attn_impl=attn_impl)
    assert sorted(got) == sorted(want) == sorted(
        ["logits", "text_features", "logits_mt", "logits_vm", "summary",
         "desc_logits"])
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-4, err_msg=k)
    tf = model.text_features_only(model.params, model.buffers)
    np.testing.assert_allclose(
        tf.numpy(), np.asarray(jmodel.text_features_only(
            jmodel.params, jmodel.buffers)), atol=1e-5)
    np.testing.assert_allclose(tf.numpy(),
                               got["text_features"].detach().numpy(),
                               atol=1e-6)


def test_apply_nte_rows_missing_and_options(models):
    """An all-zero NTE row (a missing file) is masked and stays finite, as
    in the JAX package; without memory / nte the heads are skipped."""
    jmodel, model = models
    b = _batch()
    b["nte"][1] = 0.0
    want = jmodel.apply(jmodel.params, jmodel.buffers, jnp.asarray(b["video"]),
                        video_nte=jnp.asarray(b["nte"]))
    got = model.apply(model.params, model.buffers,
                      torch.from_numpy(b["video"]),
                      video_nte=torch.from_numpy(b["nte"]))
    assert "logits_mt" not in got and "desc_logits" not in got
    assert torch.isfinite(got["logits_vm"]).all()
    np.testing.assert_allclose(got["logits_vm"].detach().numpy(),
                               np.asarray(want["logits_vm"]), atol=1e-4)
    with pytest.raises(ValueError, match="summary"):
        tvc.VitaClipModel(dataclasses.replace(
            model.cfg, vision=dataclasses.replace(
                model.cfg.vision, use_summary_token=False)), device="cpu")


def _jax_grads(jmodel, batch, attn_impl="xla", **loss_kw):
    mask = jvc.trainable_mask(jmodel.params, jmodel.cfg)
    st = jstate.create_train_state(jmodel.params, mask,
                                   jstate.make_optimizer(1e-2, 10, 0.0))
    loss_fn = jstep.make_loss_fn(jmodel, jstep.LossConfig(**loss_kw),
                                 attn_impl=attn_impl)
    # the stock streaming kernel's backward traces only inside the
    # interpret context on the CPU (tests/test_flash_attention.py)
    with pltpu.force_tpu_interpret_mode():
        return jax.grad(loss_fn, has_aux=True)(st.trainable, st.frozen,
                                               _jb(batch))


def _port_grads(model, batch, attn_impl="xla", remat="none",
                compute_dtype=torch.float32, **loss_kw):
    mask = tvc.trainable_mask(model.params, model.cfg)
    st = tstate.create_train_state(model.params, mask,
                                   tstate.make_optimizer(1e-2, 10, 0.0),
                                   device="cpu")
    loss_fn = tstep.make_loss_fn(model, tstep.LossConfig(**loss_kw),
                                 attn_impl=attn_impl, remat=remat,
                                 compute_dtype=compute_dtype)
    total, metrics = loss_fn(st.trainable, st.frozen, _tb(batch))
    total.backward()
    return st, metrics


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_gradients_match_jax_grad(models, attn_impl):
    """fp32 gradients of the whole loss against jax.grad, leaf by leaf in
    the JAX layout; the leaves with a gradient are exactly the mask's.
    Tolerance: fp32 sums in another order through both towers (relative to
    each leaf's largest gradient, with a floor for leaves that vanish)."""
    jmodel, model = models
    batch = _batch()
    g_j, m_j = _jax_grads(jmodel, batch, attn_impl, **LOSS_KW)
    st, m_t = _port_grads(model, batch, attn_impl, **LOSS_KW)
    for k in m_j:
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got = dict(_leaves_with_path(jax_bridge.grads_to_jax(st.trainable)))
    want = dict(_leaves_with_path(g_j))
    assert sorted(got) == sorted(want)
    n = 0
    for path, w in want.items():
        if w is None:
            assert got[path] is None, path
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(
            got[path], w, atol=1e-6 + 2e-4 * np.abs(w).max(), err_msg=path)
        n += 1
    assert n > 20
    # nothing frozen carries a gradient
    assert all(p.grad is None for p in tstate.tree_leaves(st.frozen)
               if p is not None)


def test_three_train_steps_match_jax(models):
    """Three steps of the two train steps side by side at fp32: losses,
    metrics, every trainable leaf; frozen leaves bit-unchanged. AdamW's
    g / (sqrt(v) + eps) turns a gradient's last-bit noise into up to lr per
    update where the gradient is near zero, so the leaves are held to a few
    lr (lr 1e-3), the metrics tightly."""
    jmodel, model = models
    batch = _batch()
    lr = 1e-3
    jopt = jstate.make_optimizer(lr, 50, 0.1)
    jst = jstate.create_train_state(
        jmodel.params, jvc.trainable_mask(jmodel.params, jmodel.cfg), jopt)
    jstep_fn = jstep.make_train_step(jmodel, jstep.LossConfig(**LOSS_KW),
                                     jopt, donate=False)
    topt = tstate.make_optimizer(lr, 50, 0.1)
    tst = tstate.create_train_state(
        model.params, tvc.trainable_mask(model.params, model.cfg), topt,
        device="cpu")
    frozen_before = [p.clone() for p in tstate.tree_leaves(tst.frozen)
                     if p is not None]
    tstep_fn = tstep.make_train_step(model, tstep.LossConfig(**LOSS_KW), topt)
    for i in range(3):
        jst, jm = jstep_fn(jst, _jb(batch))
        tst, tm = tstep_fn(tst, _tb(batch))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=2e-3,
                                       atol=2e-4, err_msg=f"step {i} {k}")
    assert tst.step == int(jst.step) == 3
    js = jax_bridge.train_state_to_jax(tst)
    want = dict(_leaves_with_path(jst.trainable))
    got = dict(_leaves_with_path(js["trainable"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        if w is None:
            assert got[path] is None
        else:
            np.testing.assert_allclose(got[path], np.asarray(w),
                                       atol=3.5 * lr, err_msg=path)
    # the moments sit beside the trainable leaves, nowhere else
    mu = dict(_leaves_with_path(js["mu"]))
    assert all((mu[p] is None) == (want[p] is None) for p in want)
    assert all(torch.equal(a, b) for a, b in zip(
        frozen_before, [p for p in tstate.tree_leaves(tst.frozen)
                        if p is not None]))
    assert len(tst.optimizer.state) == sum(
        p is not None for p in tstate.tree_leaves(tst.trainable))


def test_train_step_decreases_loss_in_place(models):
    _, model = models
    opt = tstate.make_optimizer(1e-2, 50, 0.0)
    st = tstate.create_train_state(
        model.params, tvc.trainable_mask(model.params, model.cfg), opt,
        device="cpu")
    step = tstep.make_train_step(model, tstep.LossConfig(**LOSS_KW), opt)
    batch = _tb(_batch())
    same, first = step(st, batch)
    assert same is st                      # updated in place, no donate flag
    for _ in range(8):
        st, metrics = step(st, batch)
    assert metrics["total"].item() < first["total"].item()
    assert {"loss_mt", "loss_vm", "acc1", "hit1"} <= set(metrics)


def test_batch_split_matches_full_batch(models):
    """batch_split=2 averages the micro-batch gradients and sums hit1. The
    plain CE loss is a mean over samples, so balanced micro-batches give
    the full batch's gradients (fp32 noise)."""
    _, model = models
    b = _batch()
    batch = _tb({"video": b["video"], "labels": b["labels"]})
    mask = tvc.trainable_mask(model.params, model.cfg)
    grads, metrics = [], []
    for split in (1, 2):
        opt = tstate.make_optimizer(1e-3, 10, 0.0)
        st = tstate.create_train_state(model.params, mask, opt, device="cpu")
        step = tstep.make_train_step(model, tstep.LossConfig(num_classes=3),
                                     opt, batch_split=split)
        st, m = step(st, batch)
        grads.append([p.grad for p in tstate.tree_leaves(st.trainable)
                      if p is not None])
        metrics.append(m)
    for k in ("loss", "total", "hit1", "acc1"):
        np.testing.assert_allclose(metrics[1][k].item(), metrics[0][k].item(),
                                   rtol=1e-5)
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(b_.numpy(), a.numpy(),
                                   atol=1e-7 + 1e-4 * a.abs().max().item())


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_remat_full_matches_none(models, attn_impl):
    """Rematerialization is a pure memory / compute trade: the same loss
    and the same gradients to the bit (the same ops run again)."""
    _, model = models
    batch = _batch()
    st0, m0 = _port_grads(model, batch, attn_impl, remat="none", **LOSS_KW)
    st1, m1 = _port_grads(model, batch, attn_impl, remat="full", **LOSS_KW)
    assert m1["total"].item() == m0["total"].item()
    for a, b in zip(tstate.tree_leaves(st0.trainable),
                    tstate.tree_leaves(st1.trainable)):
        if a is not None:
            assert torch.equal(a.grad, b.grad)


def test_remat_policies_that_are_not_ported_raise(models):
    _, model = models
    x = torch.zeros(1, 2, 32, 32, 3)
    # the named policies are ported now: they run and change no value
    # (tests/test_torch_remat.py holds their gradients)
    want = vision_encoder(model.params["visual"], x, model.cfg.vision)[0]
    for policy in ("save_attn", "save_attn_qkv", "save_attn_mlp", "dots"):
        got = vision_encoder(model.params["visual"], x, model.cfg.vision,
                             remat=policy)[0]
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown remat"):
        vision_encoder(model.params["visual"], x, model.cfg.vision,
                       remat="everything")
    # frozen_int8 is ported too (tests/test_torch_int8_train.py): one step
    # runs, moves the trainable leaves and leaves the frozen ones alone
    opt = tstate.make_optimizer(1e-3, 10, 0.0)
    st = tstate.create_train_state(
        model.params, tvc.trainable_mask(model.params, model.cfg), opt,
        device="cpu")
    before = st.trainable["visual"]["time_embed"].detach().clone()
    frozen = [p.clone() for p in tstate.tree_leaves(st.frozen)
              if p is not None]
    step = tstep.make_train_step(model, tstep.LossConfig(num_classes=3),
                                 opt, frozen_int8=True)
    st, metrics = step(st, _tb({k: v for k, v in _batch().items()
                                if k in ("video", "labels")}))
    assert st.step == 1 and np.isfinite(metrics["total"].item())
    assert not torch.equal(st.trainable["visual"]["time_embed"], before)
    assert all(torch.equal(a, b) for a, b in zip(
        frozen, [p for p in tstate.tree_leaves(st.frozen) if p is not None]))


def test_full_step_bf16(models):
    """The full step at bf16 (attn_impl='flash') against the JAX step at
    bf16. The two frameworks cast at the same points in the forward, but
    the eager backward rounds every intermediate gradient to bf16 where XLA
    keeps some in fp32 inside a fusion: the loss agrees to a bf16 ulp of
    the logits (1e-2), a gradient leaf to 10% of its largest entry."""
    jmodel, model = models
    batch = _batch()
    mask = jvc.trainable_mask(jmodel.params, jmodel.cfg)
    jst = jstate.create_train_state(jmodel.params, mask,
                                    jstate.make_optimizer(1e-2, 10, 0.0))
    loss_fn = jstep.make_loss_fn(jmodel, jstep.LossConfig(**LOSS_KW),
                                 compute_dtype=jnp.bfloat16,
                                 attn_impl="flash")
    with pltpu.force_tpu_interpret_mode():
        g_j, m_j = jax.grad(loss_fn, has_aux=True)(jst.trainable, jst.frozen,
                                                   _jb(batch))
    st, m_t = _port_grads(model, batch, "flash",
                          compute_dtype=torch.bfloat16, **LOSS_KW)
    np.testing.assert_allclose(m_t["total"].item(), float(m_j["total"]),
                               atol=1e-2)
    got = dict(_leaves_with_path(jax_bridge.grads_to_jax(st.trainable)))
    for path, w in _leaves_with_path(g_j):
        if w is not None:
            w = np.asarray(w, np.float32)
            assert got[path].dtype == np.float32        # fp32 master grads
            np.testing.assert_allclose(
                got[path], w, atol=1e-5 + 0.1 * np.abs(w).max(), err_msg=path)


def test_eval_step_matches_jax(models):
    jmodel, model = models
    b = _batch(B=6)
    valid = np.array([1, 1, 0, 1, 1, 0], bool)
    jev = jstep.make_eval_step(jmodel, num_classes=3)
    tev = tstep.make_eval_step(model, num_classes=3)
    for v in (None, valid):
        hit_j, conf_j = jev(jmodel.params, jnp.asarray(b["video"]),
                            jnp.asarray(b["labels"]),
                            None if v is None else jnp.asarray(v))
        hit_t, conf_t = tev(model.params, torch.from_numpy(b["video"]),
                            torch.from_numpy(b["labels"]),
                            None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(conf_t.numpy(), np.asarray(conf_j))
        assert hit_t.item() == float(hit_j) == np.trace(conf_t.numpy())
        assert conf_t.sum().item() == (6 if v is None else valid.sum())
    # uint8 input normalised in the step, two views averaged
    u8 = np.random.RandomState(3).randint(0, 255, (6, 2, 32, 32, 3), np.uint8)
    mean, std = (0.45,) * 3, (0.225,) * 3
    jev2 = jstep.make_eval_step(jmodel, 3, mean=mean, std=std, num_views=2)
    tev2 = tstep.make_eval_step(model, 3, mean=mean, std=std, num_views=2)
    labels = b["labels"][:3]
    hit_j, conf_j = jev2(jmodel.params, jnp.asarray(u8), jnp.asarray(labels))
    hit_t, conf_t = tev2(model.params, torch.from_numpy(u8),
                         torch.from_numpy(labels))
    np.testing.assert_array_equal(conf_t.numpy(), np.asarray(conf_j))
    assert hit_t.item() == float(hit_j)


def test_bridge_raises_on_missing_or_unused_leaf(models):
    jmodel, model = models
    params = dict(jmodel.params)
    params.pop("sum_proj")
    with pytest.raises(KeyError, match="missing"):
        jax_bridge.params_from_jax(params, model.cfg)
    with pytest.raises(KeyError, match="unused"):
        jax_bridge.params_from_jax(dict(jmodel.params, extra=np.zeros(1)),
                                   model.cfg)
    with pytest.raises(KeyError, match="unused"):
        jax_bridge.buffers_from_jax({"mystery": np.zeros(1)})
    # the whole tree goes there and back unchanged
    back = jax_bridge.params_to_jax(model.params)
    for (pa, a), (pb, b) in zip(_leaves_with_path(back),
                                _leaves_with_path(jmodel.params)):
        assert pa == pb
        np.testing.assert_array_equal(a, np.asarray(b))


def test_build_flagship_config_and_devices():
    """`build_flagship`: the JAX package's config (at a small input
    size so that the test stays light), on the CPU only when asked."""
    from gava_clip_tpu.utils import flagship as jflagship
    model = tflagship.build_flagship(num_frames=2, input_size=32,
                                     knowledge_versions=("v1", "v2"),
                                     device="cpu")
    jmodel = jflagship.build_flagship(num_frames=2, input_size=32,
                                      knowledge_versions=("v1", "v2"))
    a, b = dataclasses.asdict(model.cfg), dataclasses.asdict(jmodel.cfg)
    for cfg in (a, b):
        cfg["prompt"].pop("knowledge_dir")        # two temp directories
    assert a == b
    shapes_t = {p: v.shape for p, v in
                _leaves_with_path(jax_bridge.params_to_jax(model.params))}
    shapes_j = {p: v.shape for p, v in _leaves_with_path(jmodel.params)}
    assert shapes_t == shapes_j
    for k, v in jmodel.buffers.items():
        # the token embedding differs (other generators): shapes only there
        assert tuple(model.buffers[k].shape) == v.shape, k
    for k in ("kv_mask", "pool_idx", "cntn_embeds"):
        np.testing.assert_array_equal(model.buffers[k].numpy(),
                                      jmodel.buffers[k])
    for build in (tflagship.build_flagship, tflagship.build_zero_shot):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(num_frames=2, input_size=32)
