"""The named rematerialization policies of the port's vision tower on the
CPU (models/vision.py `_block_remat`), on the tiny model of
tests/test_torch_train_step.py whose parameters come from the JAX package.

What each policy must mean: the loss and every gradient equal those of
remat='none' bit for bit (the same ops run again on the same values), and
against jax.grad under the JAX package's policy of the same name to fp32
summation tolerance; under save_attn / save_attn_qkv / save_attn_mlp the
attention forward is not run again in the backward (the JAX package pins
this by counting pallas calls in the jaxpr, tests/test_train_step.py; here
the plain versions' calls are counted); save_attn_qkv recomputes nothing
in front of the attention backward; save_attn_mlp also keeps the fc1
pre-activation; dots keeps the GEMM outputs.
"""

import numpy as np
import pytest
import torch

import jax

from gava_clip_tpu.models import vita_clip as jvc
from gava_clip_tpu.train import state as jstate
from gava_clip_tpu.train import step as jstep
from gava_clip_tpu_torch.models import vision as tvision
from gava_clip_tpu_torch.ops import flash_attention as tflash
from gava_clip_tpu_torch.ops import linear as tlinear
from gava_clip_tpu_torch.train import state as tstate
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_torch_train_step import (LOSS_KW, _batch, _jb,
                                         _leaves_with_path, _port_grads,
                                         models)  # noqa: F401
from tests.test_torch_bounds import module_deadline  # noqa: F401

POLICIES = ("full", "save_attn", "save_attn_qkv", "save_attn_mlp", "dots")
LAYERS = 2
# attention forwards per loss + backward at LAYERS blocks
FORWARDS = {"none": LAYERS, "full": 2 * LAYERS, "save_attn": LAYERS,
            "save_attn_qkv": LAYERS, "save_attn_mlp": LAYERS,
            "dots": 2 * LAYERS}


class _Counter:
    """Counts calls of functions of a module while a test runs."""

    def __init__(self, monkeypatch):
        self.n = {}
        self.mp = monkeypatch

    def watch(self, module, name, key=None):
        key = key or name
        self.n[key] = 0
        real = getattr(module, name)

        def counted(*a, **kw):
            self.n[key] += 1
            return real(*a, **kw)

        self.mp.setattr(module, name, counted)


@pytest.fixture(scope="module")
def baseline(models):
    _, model = models
    out = {}
    for impl in ("xla", "flash"):
        st, m = _port_grads(model, _batch(), impl, remat="none", **LOSS_KW)
        out[impl] = (m["total"].item(),
                     [None if p is None else p.grad.clone()
                      for p in tstate.tree_leaves(st.trainable)])
    return out


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_equal_none(models, baseline, policy, attn_impl):
    _, model = models
    st, m = _port_grads(model, _batch(), attn_impl, remat=policy, **LOSS_KW)
    total, grads = baseline[attn_impl]
    assert m["total"].item() == total
    leaves = tstate.tree_leaves(st.trainable)
    assert len(leaves) == len(grads)
    for p, g in zip(leaves, grads):
        if p is not None:
            assert torch.equal(p.grad, g)


@pytest.mark.parametrize("mode", ["saved", "recompute"])
@pytest.mark.parametrize("policy", ("none",) + POLICIES)
def test_attention_forward_calls_per_policy(models, monkeypatch, policy,
                                            mode):
    """How often the attention forward (and backward) runs in one loss +
    backward: once per block under none and save_attn*, twice under full
    and dots; the backward always once per block. In the recompute mode the
    forward is the one that writes no denominators."""
    _, model = models
    c = _Counter(monkeypatch)
    c.watch(tflash, "packed_attention_den_plain", "fwd_den")
    c.watch(tflash, "packed_attention_plain", "fwd")
    c.watch(tflash, "packed_attention_bwd_plain", "bwd")
    c.watch(tflash, "packed_attention_bwd_recompute_plain", "bwd_recompute")
    tflash.set_flash_bwd_mode(mode)
    try:
        _port_grads(model, _batch(), "flash", remat=policy, **LOSS_KW)
    finally:
        tflash.set_flash_bwd_mode("saved")
    if mode == "saved":
        assert c.n == {"fwd_den": FORWARDS[policy], "fwd": 0, "bwd": LAYERS,
                       "bwd_recompute": 0}
    else:
        assert c.n == {"fwd_den": 0, "fwd": FORWARDS[policy], "bwd": 0,
                       "bwd_recompute": LAYERS}


def test_recompute_mode_gradients_under_every_policy(models):
    """The backward that saves no forward output, under every policy: at
    fp32 its gradients equal the saved mode's to summation noise (1e-5 of
    each leaf's largest entry) and each policy equals 'none' bit for
    bit."""
    _, model = models
    tflash.set_flash_bwd_mode("recompute")
    try:
        runs = {p: _port_grads(model, _batch(), "flash", remat=p,
                               **LOSS_KW)[0]
                for p in ("none",) + POLICIES}
    finally:
        tflash.set_flash_bwd_mode("saved")
    saved = _port_grads(model, _batch(), "flash", remat="none", **LOSS_KW)[0]
    ref = tstate.tree_leaves(runs["none"].trainable)
    for a, b in zip(ref, tstate.tree_leaves(saved.trainable)):
        if a is not None:
            np.testing.assert_allclose(
                a.grad.numpy(), b.grad.numpy(),
                atol=1e-7 + 1e-5 * b.grad.abs().max().item())
    for p in POLICIES:
        for a, b in zip(ref, tstate.tree_leaves(runs[p].trainable)):
            if a is not None:
                assert torch.equal(a.grad, b.grad), p


def test_what_runs_before_the_attention_backward(models, monkeypatch):
    """The order of events in one loss + backward of the vision tower:
    under save_attn_qkv the attention backward of a block runs BEFORE
    anything in front of the attention is recomputed (q, k, v were kept);
    under save_attn the block's prompt extras, LN1 and projections are
    rebuilt first (q, k, v were dropped), without a forward launch."""
    _, model = models
    x = torch.from_numpy(_batch()["video"])
    params = model.params["visual"]
    orders = {}
    for policy in ("save_attn", "save_attn_qkv", "save_attn_mlp"):
        events = []
        for module, name, tag in (
                (tvision, "_pre_attention", "pre"),
                (tflash, "packed_attention_den_plain", "fwd"),
                (tflash, "packed_attention_bwd_plain", "bwd")):
            real = getattr(module, name)

            def logged(*a, _real=real, _tag=tag, **kw):
                events.append(_tag)
                return _real(*a, **kw)

            monkeypatch.setattr(module, name, logged)
        leaf = params["global_prompts"].detach().clone().requires_grad_()
        f, s = tvision.vision_encoder(dict(params, global_prompts=leaf), x,
                                      model.cfg.vision, attn_impl="flash",
                                      remat=policy)
        (f.sum() + s.sum()).backward()
        monkeypatch.undo()
        orders[policy] = events
    forward = ["pre", "fwd"] * LAYERS
    assert orders["save_attn"] == forward + ["pre", "bwd"] * LAYERS
    assert orders["save_attn_qkv"] == forward + ["bwd", "pre"] * LAYERS
    assert orders["save_attn_mlp"] == orders["save_attn_qkv"]


def _kept_bytes(model, policy):
    """Bytes that autograd holds between forward and backward of the vision
    tower (saved tensors packed while the forward runs, counted once per
    storage), for one policy."""
    x = torch.from_numpy(_batch(B=4)["video"])
    params = model.params["visual"]
    leaf = params["global_prompts"].detach().clone().requires_grad_()
    held = {}

    def pack(t):
        held[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        f, s = tvision.vision_encoder(dict(params, global_prompts=leaf), x,
                                      model.cfg.vision, attn_impl="flash",
                                      remat=policy)
    (f.sum() + s.sum()).backward()
    return sum(held.values())


def test_policies_order_by_kept_memory(models):
    """none keeps the most; each save_attn* policy keeps more than the one
    before it (output and denominators; + q, k, v; + the fc1
    pre-activation); full keeps the least."""
    _, model = models
    kept = {p: _kept_bytes(model, p) for p in ("none",) + POLICIES}
    assert kept["full"] < kept["save_attn"] < kept["save_attn_qkv"] \
        < kept["save_attn_mlp"] < kept["none"], kept


def test_dots_keeps_the_gemm_outputs(models):
    """remat='dots' runs no projection product a second time (their outputs
    are kept inside the selective checkpoint), while 'full' runs each
    again; the elementwise work is recomputed under both. Counted as
    dispatches of the matrix products without a batch dimension."""
    from torch.utils._python_dispatch import TorchDispatchMode
    _, model = models
    x = torch.from_numpy(_batch()["video"])
    params = model.params["visual"]

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"gemm": 0, "sigmoid": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in tvision._GEMM_OPS:
                self.n["gemm"] += 1
            if func is torch.ops.aten.sigmoid.default:
                self.n["sigmoid"] += 1       # QuickGELU, once per block
            return func(*args, **(kwargs or {}))

    seen = {}
    for policy in ("none", "full", "dots"):
        leaf = params["global_prompts"].detach().clone().requires_grad_()
        with Count() as c:
            f, s = tvision.vision_encoder(
                dict(params, global_prompts=leaf), x, model.cfg.vision,
                attn_impl="flash", remat=policy)
            (f.sum() + s.sum()).backward()
        seen[policy] = c.n
    assert seen["dots"]["gemm"] == seen["none"]["gemm"] \
        < seen["full"]["gemm"], seen
    assert seen["dots"]["sigmoid"] == seen["full"]["sigmoid"] \
        == seen["none"]["sigmoid"] + LAYERS, seen


@pytest.mark.parametrize("policy", ["save_attn_qkv", "dots"])
def test_policy_gradients_match_jax_policy(models, policy):
    """The same policy name through both packages, fp32, attn_impl='xla':
    every gradient leaf against jax.grad (tolerance: fp32 sums in another
    order, 1e-4 of the leaf's largest entry)."""
    jmodel, model = models
    batch = _batch()
    jst = jstate.create_train_state(
        jmodel.params, jvc.trainable_mask(jmodel.params, jmodel.cfg),
        jstate.make_optimizer(1e-2, 10, 0.0))
    g_j, _ = jax.grad(
        jstep.make_loss_fn(jmodel, jstep.LossConfig(**LOSS_KW),
                           attn_impl="xla", remat=policy),
        has_aux=True)(jst.trainable, jst.frozen, _jb(batch))
    st, _ = _port_grads(model, batch, "xla", remat=policy, **LOSS_KW)
    g_t = jax_bridge.grads_to_jax(st.trainable)
    for (path, a), (_, b) in zip(_leaves_with_path(g_t),
                                 _leaves_with_path(g_j)):
        assert (a is None) == (b is None), path
        if a is not None:
            b = np.asarray(b)
            np.testing.assert_allclose(
                a, b, atol=1e-6 + 1e-4 * np.abs(b).max(), err_msg=path)


def test_policy_names_and_int8_blocks():
    assert tvision._remat_policy(False) is None
    assert tvision._remat_policy("none") is None
    assert tvision._remat_policy(True) == "full"
    for p in POLICIES:
        assert tvision._remat_policy(p) == p
    with pytest.raises(ValueError, match="unknown remat"):
        tvision._remat_policy("everything")
    q = {"attn": {"q": {"kernel": {"qa": torch.zeros(2, 2, dtype=torch.int8),
                                   "scale": torch.ones(1, 2)}}}}
    with pytest.raises(NotImplementedError, match="inference"):
        tvision._block_remat("save_attn", q, None, torch.zeros(1, 1, 2),
                             None, "flash", "kernel")
    assert tlinear.quant_kind(q["attn"]["q"]["kernel"]) == "qa"
