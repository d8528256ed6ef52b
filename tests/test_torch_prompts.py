"""The PyTorch port's prompt learning (models/prompts.py) against the JAX
package: the host-side asset arrays bit for bit, the assembly for every
projector variant."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gava_clip_tpu.models import prompts as jprompts
from gava_clip_tpu.utils import flagship as jflagship
from gava_clip_tpu_torch.models import prompts as tprompts
from gava_clip_tpu_torch.utils import flagship as tflagship
from tests.test_torch_bounds import module_deadline  # noqa: F401

NAMES = ["normal", "slight difficulty", "moderate_difficulty"]
VERSIONS = ("v1", "v2", "v3")


@pytest.fixture(scope="module")
def kdir():
    d = jflagship.make_synthetic_knowledge_dir(3, VERSIONS)
    rs = np.random.RandomState(5)
    for c in range(3):                       # descriptor-mode files, ragged
        n = 2 + c
        with open(os.path.join(d, f"descriptor_{c}.txt"), "w") as f:
            for i in range(n):
                f.write(f"descriptor {i} of class {c}\n")
        np.save(os.path.join(d, f"descriptor_{c}.npy"),
                rs.randn(n, 768).astype(np.float32))
    return d


def _cfgs(kdir, **kw):
    base = dict(n_cls=3, n_ctx=4, ctx_dim=16, emb_dim=8, cls_type="updrs",
                knowledge_versions=VERSIONS, knowledge_dir=kdir)
    base.update(kw)
    return jprompts.PromptConfig(**base), tprompts.PromptConfig(**base)


def test_synthetic_knowledge_dir_is_the_jax_one(kdir):
    mine = tflagship.make_synthetic_knowledge_dir(3, VERSIONS)
    for name in ("EntityEmb_v0.npy", "all.npy", "EntityEmb_v2.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(mine, name)),
                                      np.load(os.path.join(kdir, name)))
    for kv in VERSIONS:
        with open(os.path.join(mine, f"simQdesc_{kv}.txt")) as a, \
                open(os.path.join(kdir, f"simQdesc_{kv}.txt")) as b:
            assert a.read() == b.read()
    assert tflagship.UPDRS_3CLS_CLASSNAMES == jflagship.UPDRS_3CLS_CLASSNAMES
    assert tflagship.UPDRS_3CLS_LABELS == jflagship.UPDRS_3CLS_LABELS


@pytest.mark.parametrize("kw", [
    dict(init="cntn_split_uni_disc", csc=True),
    dict(init="cntn_uni_disc"),                  # EntityEmb_v0 for every kv
    dict(init="split_uni"),                      # no cntn, empty descriptions
    dict(init="cntn_split_disc", use_descriptor=True),
    dict(init="cntn_disc", use_descriptor=True),
    dict(init=""), dict(init="", csc=True, context_length=32),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_build_prompt_assets_bit_equal(kdir, kw):
    jcfg, tcfg = _cfgs(kdir, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for prop in ("knowledge_aware", "use_cntn", "cntn_split", "uni_mlp",
                 "use_disc"):
        assert getattr(jcfg, prop) == getattr(tcfg, prop)
    emb = np.random.RandomState(1).randn(49408, 16).astype(np.float32)
    want = jprompts.build_prompt_assets(NAMES, jcfg, emb)
    got = tprompts.build_prompt_assets(NAMES, tcfg, emb)
    assert got.prompt_texts == want.prompt_texts
    for f in ("tokenized", "kv_mask", "pool_idx", "token_prefix",
              "token_suffix", "cntn_embeds"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    if jcfg.knowledge_aware:
        c_j, d_j = jprompts.load_knowledge(jcfg)
        c_t, d_t = tprompts.load_knowledge(tcfg)
        assert d_t == d_j
        for a, b in zip(c_t, c_j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(init="cntn_split_uni_disc", csc=True),      # class-wise single MLP
    dict(init="cntn_split_disc"),                    # class-wise per token
    dict(init="cntn_split_uni_disc", token_wise_mlp=True),
    dict(init="split_uni_disc"),                     # knowledge, no cntn
    dict(init=""), dict(init="", csc=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_assemble_prompts_matches_jax(kdir, kw):
    jcfg, tcfg = _cfgs(kdir, **kw)
    rs = np.random.RandomState(2)
    emb = rs.randn(49408, 16).astype(np.float32)
    assets = tprompts.build_prompt_assets(NAMES, tcfg, emb)
    jp = jax.tree_util.tree_map(
        np.asarray, jprompts.init_prompt_params(jax.random.PRNGKey(0), jcfg))
    tp0 = tprompts.init_prompt_params(torch.Generator().manual_seed(0), tcfg)
    # the same tree, the same shapes; zero-init where the JAX init is zero
    assert jax.tree_util.tree_map(lambda a: a.shape, jp) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), tp0)
    if tcfg.knowledge_aware:
        assert not any(bool(t.any()) for t in
                       jax.tree_util.tree_leaves(tp0))
    # random values instead of the zero init, so that every weight counts
    jp = jax.tree_util.tree_map(
        lambda a: (0.1 * rs.randn(*a.shape)).astype(np.float32), jp)
    tp = jax.tree_util.tree_map(torch.from_numpy, jp)
    names = ["token_prefix", "token_suffix"] + \
        (["cntn_embeds"] if assets.cntn_embeds is not None else [])
    jbuf = {n: jnp.asarray(getattr(assets, n)) for n in names}
    tbuf = {n: torch.from_numpy(getattr(assets, n)) for n in names}
    want = jprompts.assemble_prompts(jp, jbuf, jcfg)
    got = tprompts.assemble_prompts(tp, tbuf, tcfg)
    assert got.shape == want.shape == (3, assets.kv_mask.shape[1], 77, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if tcfg.knowledge_aware and tcfg.use_cntn:
        proj = tprompts._project_knowledge(tp["projector"],
                                           tbuf["cntn_embeds"], tcfg)
        want_p = jprompts._project_knowledge(jp["projector"],
                                             jbuf["cntn_embeds"], jcfg)
        np.testing.assert_allclose(proj.numpy(), np.asarray(want_p),
                                   atol=1e-5)
