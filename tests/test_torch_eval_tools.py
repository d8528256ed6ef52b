"""The port's evaluation and analysis tools against the JAX package on the
CPU: the IWA aggregation math, the memory prompt through a tiny text tower
(width 32, 2 layers) and the embedding-space views. Inputs are made with
numpy from seeds; the JAX parameters cross through utils/jax_bridge. The
programs (cli.iwa, cli.analysis, cli.visualize) are held in
tests/test_torch_cli.py, on its training runs."""

import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gava_clip_tpu.cli import visualize as jvis
from gava_clip_tpu.models import memory_prompt as jmp
from gava_clip_tpu.models import text as jtext
from gava_clip_tpu.utils import aggregation as jagg
from gava_clip_tpu_torch.cli import visualize as tvis
from gava_clip_tpu_torch.models import memory_prompt as tmp
from gava_clip_tpu_torch.models.text import TextConfig
from gava_clip_tpu_torch.utils import aggregation as tagg
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_torch_bounds import module_deadline  # noqa: F401

JCFG = jtext.TextConfig(embed_dim=32, width=32, heads=2, layers=2)
CFG = TextConfig(embed_dim=32, width=32, heads=2, layers=2)


# --- aggregation: the same numpy code on both sides ---------------------------

def _stats(M=3, N=40, C=4, seed=0):
    rs = np.random.RandomState(seed)
    g = [(2 * rs.randn(N, C)).astype(np.float32) for _ in range(M)]
    labels = rs.randint(0, C, N)
    tf = [rs.randn(C, 8).astype(np.float32) for _ in range(M)]
    return g, labels, tf


@pytest.mark.parametrize("num_singular_values", [-1, 2])
def test_aggregation_equals_jax(num_singular_values):
    """Every function of the module, bit for bit. The draw keeps each
    singular value of the Gram matrix more than 5% away from the cutoff
    rcond * s_max, where the truncated pseudo-inverse jumps."""
    g, labels, tf = _stats()
    gram = tagg.model_gram(g)
    s = np.linalg.svd(gram, compute_uv=False)
    assert np.all(np.abs(s / (0.1 * s.max()) - 1) > 0.05), s
    np.testing.assert_array_equal(gram, jagg.model_gram(g))
    np.testing.assert_array_equal(tagg.softmax(g[0]), jagg.softmax(g[0]))
    np.testing.assert_array_equal(tagg.onehot(labels, 4),
                                  jagg.onehot(labels, 4))
    np.testing.assert_array_equal(
        tagg.truncated_pinv(gram, num_singular_values, hermitian=True),
        jagg.truncated_pinv(gram, num_singular_values, hermitian=True))
    fs_t = [tagg.source_fit_stats(x, labels, 4) for x in g]
    fs_j = [jagg.source_fit_stats(x, labels, 4) for x in g]
    for (mt, st), (mj, sj) in zip(fs_t, fs_j):
        np.testing.assert_array_equal(mt, mj)
        assert st == sj
    f = [s for _, s in fs_t]
    w = tagg.aggregation_weights(g, f, 0.1, num_singular_values)
    np.testing.assert_array_equal(
        w, jagg.aggregation_weights(g, f, 0.1, num_singular_values))
    np.testing.assert_array_equal(tagg.aggregate_text_features(w, tf),
                                  jagg.aggregate_text_features(w, tf))
    np.testing.assert_array_equal(tagg.aggregate_logits(w, g),
                                  jagg.aggregate_logits(w, g))


# --- the memory prompt -------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_text():
    jp = jax.tree_util.tree_map(
        np.asarray, jtext.init_text_params(jax.random.PRNGKey(0), JCFG))
    return jp, jax_bridge.text_params_from_jax(jp, CFG, device="cpu")


def test_template_slots_equal_jax(tiny_text):
    jp, tp = tiny_text
    want = jmp.template_slots(jp)
    got = tmp.template_slots(tp)
    assert len(got) == 4
    for a, b in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[0][:5].tolist() == [49406, got[0][1], got[0][2], got[0][1],
                                   49407]


@pytest.mark.parametrize("split_mlp", [True, False])
def test_memory_prompt_features_match_jax(tiny_text, split_mlp):
    """fp32 both sides on the same weights (the JAX init carried over):
    the tower's sums in another order through 2 blocks, 1e-5."""
    jp, tp = tiny_text
    jparams = jax.tree_util.tree_map(np.asarray, jmp.init_memory_prompt_params(
        jax.random.PRNGKey(1), 3, inp_dim=48, out_dim=32,
        split_mlp=split_mlp))
    tparams = jax_bridge.memory_prompt_params_from_jax(jparams, device="cpu")
    rs = np.random.RandomState(3)
    m = rs.randn(2, 4, 48).astype(np.float32)
    v = rs.randn(2, 4, 32).astype(np.float32)
    want = np.asarray(jmp.memory_prompt_features(
        jparams, jp, jnp.asarray(m), jnp.asarray(v), JCFG,
        split_mlp=split_mlp))
    got = tmp.memory_prompt_features(tparams, tp, torch.from_numpy(m),
                                     torch.from_numpy(v), CFG,
                                     split_mlp=split_mlp)
    assert got.dtype == torch.float32
    assert got.shape == ((3, 2, 32) if split_mlp else (2, 32))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("split_mlp", [True, False])
def test_memory_prompt_init_and_bridge(split_mlp):
    """The port's init draws the JAX init's shapes and bounds from a
    torch.Generator (the same seed, the same weights); the bridge checks
    the four leaves."""
    want = jmp.init_memory_prompt_params(jax.random.PRNGKey(0), 3, 48, 32,
                                         split_mlp)
    got = tmp.init_memory_prompt_params(torch.Generator().manual_seed(0), 3,
                                        48, 32, split_mlp)
    again = tmp.init_memory_prompt_params(torch.Generator().manual_seed(0), 3,
                                          48, 32, split_mlp)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert torch.equal(got[k], again[k])
    for k, fan_in in (("w1", 48), ("w2", 16)):
        assert got[k].abs().max() <= 1 / np.sqrt(fan_in)
        assert got[k].std() > 0.3 / np.sqrt(fan_in)
    assert not got["b1"].any() and not got["b2"].any()
    jnp_tree = jax.tree_util.tree_map(np.asarray, want)
    back = jax_bridge.memory_prompt_params_from_jax(jnp_tree, device="cpu")
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), jnp_tree[k])
    with pytest.raises(KeyError, match="missing"):
        jax_bridge.memory_prompt_params_from_jax(
            {k: v for k, v in jnp_tree.items() if k != "b2"}, device="cpu")
    with pytest.raises(KeyError, match="unused"):
        jax_bridge.memory_prompt_params_from_jax(
            dict(jnp_tree, b3=jnp_tree["b2"]), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        jax_bridge.memory_prompt_params_from_jax(
            dict(jnp_tree, b1=jnp_tree["b2"]), device="cpu")


# --- the embedding-space views -----------------------------------------------

def _feats(n=60, d=16, seed=0):
    """Rows whose principal directions are well apart (each one's scale
    0.6 of the one before), so that PCA is well posed."""
    rs = np.random.RandomState(seed)
    scale = 4.0 * 0.6 ** np.arange(d)
    basis = np.linalg.qr(rs.randn(d, d))[0]
    return ((rs.randn(n, d) * scale) @ basis + 1.5).astype(np.float32)


def test_embeddings_similarities_equal_jax(tmp_path):
    rs = np.random.RandomState(1)
    npy = str(tmp_path / "f.npy")
    np.save(npy, rs.randn(5, 8).astype(np.float64))
    bank = str(tmp_path / "bank.pkl")
    with open(bank, "wb") as f:
        pickle.dump({"embeds": rs.randn(6, 4, 8).astype(np.float32),
                     "updrs": np.array([[0], [1], [2], [-1], [1], [0]])}, f)
    for path, key in ((npy, "updrs"), (bank, "updrs"), (bank, "diag")):
        (ft, lt), (fj, lj) = (tvis.load_embeddings(path, key),
                              jvis.load_embeddings(path, key))
        np.testing.assert_array_equal(ft, fj)
        assert ft.dtype == fj.dtype == np.float32
        assert (lt is None) == (lj is None)
        if lj is not None:
            np.testing.assert_array_equal(lt, lj)
    x = _feats(12, 8)
    np.testing.assert_array_equal(tvis.cosine_similarity_matrix(x),
                                  jvis.cosine_similarity_matrix(x))
    for a, b in zip(tvis.pairwise_similarity_split(x[:7], x[7:]),
                    jvis.pairwise_similarity_split(x[:7], x[7:])):
        np.testing.assert_array_equal(a, b)
    assert tvis._parse_named(["a=x/b.npy", "x/c.pkl"]) == \
        jvis._parse_named(["a=x/b.npy", "x/c.pkl"])


@pytest.mark.parametrize("n", [60, 40])
def test_pca_and_cones_match_sklearn(n):
    """The port's PCA in torch against the JAX module's scikit-learn PCA:
    the same points, sign included, atol 1e-4 (fp32 SVDs by two
    libraries on rows of norm ~10)."""
    x = _feats(n)
    np.testing.assert_allclose(tvis.project(x, "pca", device="cpu"),
                               jvis.project(x, "pca"), atol=1e-4)
    named = [("text", x[:n // 2]), ("video", x[n // 2:] - 3.0)]
    pts_t, lab_t = tvis.cone_projection(named, "pca", device="cpu")
    pts_j, lab_j = jvis.cone_projection(named, "pca")
    assert lab_t == lab_j and pts_t.shape == (n, 3)
    np.testing.assert_allclose(pts_t, pts_j, atol=1e-4)


def test_tsne_and_umap_name_a_missing_library(monkeypatch):
    x = _feats(20, 8)
    monkeypatch.setitem(sys.modules, "umap", None)
    for mod in (tvis, jvis):
        with pytest.raises(SystemExit, match="umap"):
            mod.project(x, "umap")
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    with pytest.raises(SystemExit, match="scikit-learn"):
        tvis.project(x, "tsne")
    with pytest.raises(SystemExit, match="scikit-learn"):
        tvis.cone_projection([("a", x)], "tsne")
