"""The PyTorch port's text tower and tokenizer against the JAX package on
the CPU. Parameters are drawn by the JAX init and cross through
utils/jax_bridge; token ids and prompt embeddings are made with numpy."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gava_clip_tpu.models import text as jtext
from gava_clip_tpu.text import tokenizer as jtok
from gava_clip_tpu_torch.models import text as ttext
from gava_clip_tpu_torch.text import tokenizer as ttok
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_torch_bounds import module_deadline  # noqa: F401

JCFG = jtext.TextConfig(embed_dim=24, context_length=20, vocab_size=120,
                        width=32, heads=2, layers=3)
CFG = ttext.TextConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def params():
    jp = jax.tree_util.tree_map(
        np.asarray, jtext.init_text_params(jax.random.PRNGKey(3), JCFG))
    # the init leaves LayerNorms at identity: perturb them so that a
    # swapped scale / bias would show
    rs = np.random.RandomState(0)
    for blk in (jp["blocks"]["ln_1"], jp["blocks"]["ln_2"], jp["ln_final"]):
        blk["scale"] = (blk["scale"] + 0.1 * rs.randn(*blk["scale"].shape)
                        ).astype(np.float32)
        blk["bias"] = (0.1 * rs.randn(*blk["bias"].shape)).astype(np.float32)
    expected = ttext.init_text_params(None, CFG, device="meta")
    return jp, jax_bridge._convert(jp, expected, "", None)


def _tokens(seed, n):
    rs = np.random.RandomState(seed)
    tok = np.zeros((n, JCFG.context_length), np.int32)
    for i in range(n):
        k = rs.randint(3, JCFG.context_length - 1)
        tok[i, :k] = rs.randint(1, JCFG.vocab_size - 1, k)
        tok[i, k] = JCFG.vocab_size - 1          # the EOT id
    return tok


def test_init_text_params_shapes(params):
    """The port's own init has the JAX tree's paths, shapes and dtypes
    (blocks as a per-layer list)."""
    jp, _ = params
    mine = ttext.init_text_params(torch.Generator().manual_seed(0), CFG)
    back = jax_bridge.params_to_jax(mine)
    flat_j = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {jax.tree_util.keystr(k): v.shape for k, v in
              jax.tree_util.tree_flatten_with_path(back)[0]}
    assert flat_t == flat_j
    assert len(mine["blocks"]) == CFG.layers
    assert float(mine["token_embedding"].std()) == pytest.approx(0.02, rel=0.2)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_encode_text_tokens_matches_jax(params, attn_impl):
    """fp32, both attention paths (flash: the JAX streaming kernel in
    interpret mode against the port's plain streaming version). Tolerance:
    fp32 sums in another order through 3 blocks."""
    jp, tp = params
    tok = _tokens(1, 5)
    want = jtext.encode_text_tokens(jp, jnp.asarray(tok), JCFG,
                                    attn_impl=attn_impl)
    got = ttext.encode_text_tokens(tp, torch.from_numpy(tok), CFG,
                                   attn_impl=attn_impl)
    assert got.shape == (5, CFG.embed_dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_encode_text_embeds_bf16(params):
    """bf16 compute: the two frameworks round at the same points (the casts
    in `linear` and `layer_norm`); what is left is an ulp here and there,
    carried through 3 blocks."""
    jp, tp = params
    rs = np.random.RandomState(2)
    emb = (0.02 * rs.randn(4, JCFG.context_length, JCFG.width)
           ).astype(np.float32)
    eot = rs.randint(1, JCFG.context_length, 4).astype(np.int32)
    want = jtext.encode_text_embeds(jp, jnp.asarray(emb), jnp.asarray(eot),
                                    JCFG, compute_dtype=jnp.bfloat16)
    got = ttext.encode_text_embeds(tp, torch.from_numpy(emb),
                                   torch.from_numpy(eot), CFG,
                                   compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -6 * np.abs(want).max())


def test_text_transformer_maple_prompts(params):
    jp, tp = params
    rs = np.random.RandomState(3)
    x = rs.randn(3, JCFG.context_length, JCFG.width).astype(np.float32)
    mp = rs.randn(JCFG.layers - 1, 4, JCFG.width).astype(np.float32)
    want = jtext.text_transformer(jp, jnp.asarray(x), JCFG,
                                  maple_prompts=jnp.asarray(mp))
    got = ttext.text_transformer(tp, torch.from_numpy(x), CFG,
                                 maple_prompts=torch.from_numpy(mp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    plain = ttext.text_transformer(tp, torch.from_numpy(x), CFG)
    assert (got - plain).abs().max() > 1e-3      # the prompts did something


def test_text_tower_gradient_reaches_prompts_only_through_input(params):
    """The tower is frozen in training: its leaves take no gradient, the
    embedded prompts under it do (through the causal attention)."""
    _, tp = params
    emb = torch.zeros(2, CFG.context_length, CFG.width, requires_grad=True)
    out = ttext.encode_text_embeds(tp, emb, torch.tensor([5, 9]), CFG,
                                   attn_impl="flash")
    out.square().sum().backward()
    assert emb.grad is not None and emb.grad.abs().sum() > 0
    # causal: tokens after the pooled position get no gradient
    assert emb.grad[0, 6:].abs().sum() == 0 and emb.grad[1, 10:].abs().sum() == 0
    assert all(t.grad is None for blk in tp["blocks"]
               for t in blk["attn"]["q"].values())


def test_causal_mask():
    np.testing.assert_array_equal(ttext.causal_mask(5).numpy(),
                                  np.asarray(jtext.causal_mask(5)))


PROMPTS = [
    "a person walking with gait pattern v1 of severity level 0 showing step "
    "irregularities normal",
    "a person walking with gait pattern v5 of severity level 2 showing step "
    "irregularities moderate difficulty",
    "X X X X X X X X slight difficulty.",
    "it's a photo of 3 dogs, isn't it?", "",
]


def test_tokenizer_matches_jax_package():
    np.testing.assert_array_equal(ttok.tokenize(PROMPTS), jtok.tokenize(PROMPTS))
    np.testing.assert_array_equal(ttok.tokenize(PROMPTS[0], context_length=40),
                                  jtok.tokenize(PROMPTS[0], context_length=40))
    with pytest.raises(RuntimeError, match="too long"):
        ttok.tokenize(" ".join(["word"] * 100))
    t = ttok.tokenize(" ".join(["word"] * 100), truncate=True)
    assert t[0, -1] == ttok.EOT_TOKEN
    tok = ttok.ClipBpeTokenizer()
    assert tok.decode(tok.encode("step irregularities")) == \
        "step irregularities "
    assert (ttok.SOT_TOKEN, ttok.EOT_TOKEN, ttok.VOCAB_SIZE) == \
        (jtok.SOT_TOKEN, jtok.EOT_TOKEN, jtok.VOCAB_SIZE)


def test_tokenizer_fallbacks_give_the_same_ids(monkeypatch):
    """Without `regex` (the ASCII split pattern) and without `ftfy` (NFC
    cleaning) the ids of the prompts this slice builds are the same."""
    import sys
    want = ttok.tokenize(PROMPTS)
    monkeypatch.setattr(ttok, "_re", None)
    monkeypatch.setitem(sys.modules, "ftfy", None)
    fallback = ttok.ClipBpeTokenizer()
    assert "A-Za-z" in fallback._pattern.pattern
    for i, text in enumerate(PROMPTS):
        ids = [ttok.SOT_TOKEN] + fallback.encode(text) + [ttok.EOT_TOKEN]
        np.testing.assert_array_equal(want[i, :len(ids)], ids)
        assert not want[i, len(ids):].any()
