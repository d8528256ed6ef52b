"""The fp32 training step past 640 keys against the JAX package on the CPU.

At a 400^2 frame (626 query rows and 643 keys a frame row) or larger, the
vision blocks' non-causal attention leaves the packed path (640 keys) for
the streaming one in both packages, forward and backward, and on the card
the port's fp32 step then runs B7's fp32 backward past 128 rows in every
vision block. Here a narrow model at 416^2 (676 patches + the cls token
+ its prompts), 64-wide with one head of 64, 2 layers, 1 clip x 2 frames,
takes the loss and its gradients through `attn_impl="flash"` in both
packages: the port's flash path runs the plain streaming versions on the
CPU, JAX's the stock Pallas kernels in interpret mode. The JAX parameters
cross through utils/jax_bridge; the tolerances are the step tests'
(tests/test_torch_train_step.py::test_loss_gradients_match_jax_grad).
"""

import numpy as np

import jax

from gava_clip_tpu.models import prompts as jprompts
from gava_clip_tpu.models import text as jtext
from gava_clip_tpu.models import vision as jvision
from gava_clip_tpu.models import vita_clip as jvc
from gava_clip_tpu_torch.models import vita_clip as tvc
from gava_clip_tpu_torch.ops import flash_attention as tfa
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_torch_bounds import module_deadline  # noqa: F401
from tests.test_torch_train_step import (LOSS_KW, N_CLS, _jax_grads,
                                         _leaves_with_path, _port_cfg,
                                         _port_grads)

SIZE = 416      # 26 x 26 patches of 16: 677 tokens a frame row
WIDTH = 64      # one head of the kernels' 64
NT = 2          # frames of the one clip


def _models(ke):
    rs = np.random.RandomState(0)
    for kv in ("v1", "v2"):
        np.save(ke / f"EntityEmb_{kv}.npy",
                rs.randn(N_CLS, 768).astype(np.float32))
        with open(ke / f"simQdesc_{kv}.txt", "w") as f:
            for c in range(N_CLS):
                f.write(f"desc {kv} class {c}\n")
    jcfg = jvc.VitaClipConfig(
        vision=jvision.VisionConfig(
            input_size=(SIZE, SIZE), num_frames=NT, feature_dim=WIDTH,
            patch_size=(16, 16), heads=1, layers=2, mlp_factor=2.0,
            embed_dim=32, use_summary_token=True, use_local_prompts=True,
            use_global_prompts=True, num_global_prompts=2),
        text=jtext.TextConfig(embed_dim=32, width=32, heads=2, layers=2),
        num_classes=N_CLS, use_text_prompt_learning=True,
        prompt=jprompts.PromptConfig(
            n_cls=N_CLS, n_ctx=4, ctx_dim=32, emb_dim=8,
            init="cntn_split_uni_disc", csc=True,
            knowledge_versions=("v1", "v2"), knowledge_dir=str(ke)),
        use_support_memory=True, add_nte=True)
    jmodel = jvc.VitaClip(jcfg, classnames=["normal", "slight difficulty",
                                            "moderate difficulty"])
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


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    return {"video": rs.randn(1, NT, SIZE, SIZE, 3).astype(np.float32),
            "labels": rs.randint(0, 3, size=1),
            "nte": rs.randn(1, 70, 32).astype(np.float32),
            "memory": rs.randn(6, 4, 32).astype(np.float32),
            "mt_labels": rs.randint(0, 3, size=6)}


def test_f32_step_past_640_keys_matches_jax_grad(tmp_path, monkeypatch):
    """The fp32 loss and every gradient leaf of the port's flash step at a
    frame row past the packed path's 640 keys against jax.grad of JAX's,
    on the same weights; the port's vision blocks went through the
    streaming path (its plain versions, forward and backward, at the
    frame rows' key length), as its text blocks always do."""
    jmodel, model = _models(tmp_path)
    batch = _batch()
    calls = []

    def counted(fn, what):
        def call(q, k, *args):
            calls.append((what, k.shape[1], args[-1]))   # keys, causal
            return fn(q, k, *args)
        return call
    monkeypatch.setattr(tfa, "streaming_attention_plain", counted(
        tfa.streaming_attention_plain, "fwd"))
    monkeypatch.setattr(tfa, "streaming_attention_bwd_plain", counted(
        tfa.streaming_attention_bwd_plain, "bwd"))
    st, m_t = _port_grads(model, batch, "flash", **LOSS_KW)
    vision = [c for c in calls if not c[2]]
    assert sorted({c[0] for c in vision}) == ["bwd", "fwd"]
    assert len(vision) == 4 and all(c[1] > tfa._PACKED_MAX_LK
                                    for c in vision), vision
    g_j, m_j = _jax_grads(jmodel, batch, "flash", **LOSS_KW)
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
