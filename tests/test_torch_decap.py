"""The port's DeCap captioner and its two programs against the JAX package on
the CPU, at the JAX tests' tiny DecapConfig (tests/test_decap.py: 64 wide,
2 layers, 2 heads): forward, loss, gradients, the three decoders, caption
rendering, three AdamW steps, checkpoints both ways, the decode studies,
then the port's programs at the full config. The JAX parameters cross
through utils/jax_bridge; inputs are made with numpy from seeds."""

import dataclasses
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gava_clip_tpu.cli import decode as jdecode
from gava_clip_tpu.cli import decoder_train as jdt
from gava_clip_tpu.models import decap as jdecap
from gava_clip_tpu.text import ClipBpeTokenizer as JTokenizer
from gava_clip_tpu_torch.cli import decode as tdecode
from gava_clip_tpu_torch.cli import decoder_train as tdt
from gava_clip_tpu_torch.models import decap as tdecap
from gava_clip_tpu_torch.text import ClipBpeTokenizer
from gava_clip_tpu_torch.train.state import tree_leaves
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_torch_bounds import module_deadline  # noqa: F401

JCFG = jdecap.DecapConfig(vocab_size=49408 + 500, n_layer=2, n_head=2,
                          n_embd=64, n_positions=32, prefix_size=16)
CFG = tdecap.DecapConfig(**dataclasses.asdict(JCFG))
# fp32 on both sides, sums in another order through 2 blocks and the
# 49,908-wide tied head
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The decoders run one token at a time: hundreds of small ops whose
    cost, with torch's intra-op pool, is thread start-up and, beside the
    other test workers, contention. One thread keeps them at their own
    cost; the number is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree_util.tree_map(
        np.asarray, jdecap.init_decap_params(jax.random.PRNGKey(0), JCFG))
    # the init leaves LayerNorms at identity: perturb them so that a
    # swapped scale / bias would show
    rs = np.random.RandomState(0)
    for ln in (jp["blocks"]["ln_1"], jp["blocks"]["ln_2"], jp["ln_f"]):
        ln["scale"] = (ln["scale"] + 0.1 * rs.randn(*ln["scale"].shape)
                       ).astype(np.float32)
        ln["bias"] = (0.1 * rs.randn(*ln["bias"].shape)).astype(np.float32)
    return jp, jax_bridge.decap_params_from_jax(jp, CFG, device="cpu")


def _tokens(seed, B=3, L=12):
    """SOT, words, a number token, EOT, zero padding; one row all words."""
    rs = np.random.RandomState(seed)
    tok = np.zeros((B, L), np.int32)
    for b in range(B):
        n = rs.randint(4, L - 1)
        tok[b, 0] = 49406
        tok[b, 1:n] = rs.randint(1, 49406, n - 1)
        if b:
            tok[b, rs.randint(1, n)] = 49408 + rs.randint(0, 500)
        tok[b, n] = 49407
    return tok


def _feats(seed, n=3):
    return np.random.RandomState(seed).randn(n, 16).astype(np.float32)


def test_init_and_bridge(params):
    """The port's init has the JAX tree's paths, shapes and dtypes; the
    bridge goes both ways bit for bit and refuses a wrong tree."""
    jp, tp = params
    mine = jax_bridge.params_to_jax(
        tdecap.init_decap_params(torch.Generator().manual_seed(0), CFG,
                                 device="cpu"))
    flat = lambda t: {jax.tree_util.keystr(k): (v.shape, v.dtype) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(mine) == flat(jp)
    back = jax_bridge.params_to_jax(tp)
    for (k, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(jp)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    with pytest.raises(KeyError, match="missing"):
        jax_bridge.decap_params_from_jax(
            {k: v for k, v in jp.items() if k != "wpe"}, CFG)
    with pytest.raises(ValueError, match="wte"):
        jax_bridge.decap_params_from_jax(dict(jp, wte=jp["wte"][:-1]), CFG)


def test_forward_matches_jax(params):
    jp, tp = params
    tok = _tokens(1)
    want = jdecap.decap_forward(jp, jnp.asarray(_feats(2)), jnp.asarray(tok),
                                JCFG)
    got = tdecap.decap_forward(tp, torch.from_numpy(_feats(2)),
                               torch.from_numpy(tok), CFG)
    assert got.shape == (3, 13, CFG.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_loss_and_terms_match_jax(params):
    jp, tp = params
    tok = _tokens(3)
    loss_j, m_j = jdecap.decap_loss(jp, jnp.asarray(_feats(4)),
                                    jnp.asarray(tok), JCFG)
    loss_t, m_t = tdecap.decap_loss(tp, torch.from_numpy(_feats(4)),
                                    torch.from_numpy(tok), CFG)
    assert float(m_j["loss_number"]) > 0
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=ATOL)
    assert sorted(m_t) == sorted(m_j)
    for k in m_j:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), atol=ATOL,
                                   err_msg=k)


def test_gradients_match_jax(params):
    """Every leaf's gradient within 1e-4 relative L2 of jax.grad's."""
    jp, tp = params
    tok, feats = _tokens(5), _feats(6)
    want = jax.jit(jax.grad(lambda p: jdecap.decap_loss(
        p, jnp.asarray(feats), jnp.asarray(tok), JCFG)[0]))(
            jax.tree_util.tree_map(jnp.asarray, jp))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    try:
        tdecap.decap_loss(tp, torch.from_numpy(feats), torch.from_numpy(tok),
                          CFG)[0].backward()
        got = jax_bridge.params_to_jax(jax_bridge._map(lambda t: t.grad, tp))
    finally:
        for t in leaves:
            t.requires_grad_(False)
            t.grad = None
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        w = np.asarray(w)
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        # the key bias shifts every score of a row alike: its true
        # gradient is zero and both sides give rounding noise
        if "'k'" in jax.tree_util.keystr(path) and \
                jax.tree_util.keystr(path).endswith("['bias']"):
            assert np.abs(g).max() < 1e-6 and np.abs(w).max() < 1e-6
            continue
        assert err < 1e-4, (jax.tree_util.keystr(path), err)


def _crafted(jp, feats, lanes):
    """Tied-embedding rows set so that lane i's first prediction is
    lanes[i] (a token id), as the JAX decoder tests craft them."""
    prefix = jdecap.project_prefix(jp, jnp.asarray(feats))
    h0 = np.asarray(jdecap.decap_transformer(jp, prefix[:, None, :], JCFG))[:, 0]
    wte = np.array(jp["wte"])
    for i, tok in lanes.items():
        wte[tok] = 10.0 * h0[i] / np.linalg.norm(h0[i])
    return dict(jp, wte=wte)


@pytest.mark.parametrize("case", ["random", "eot_and_number"])
def test_decoders_match_jax_and_each_other(params, case):
    """The port's host loop, K/V-cached and batched decoders give JAX's
    host-loop tokens and numbers, feature by feature: full-length decodes
    with random weights; with crafted weights lane 0 ends at step 0 (EOT),
    lane 2 opens with a number token, lane 1 runs to max_len, and batch 2
    leaves a padded lane in the second chunk."""
    jp, _ = params
    feats = _feats(11)
    max_len = 31
    if case == "eot_and_number":
        jp = _crafted(jp, feats, {0: 49407, 2: 49408 + 7})
        max_len = 12
    tp = jax_bridge.decap_params_from_jax(jp, CFG, device="cpu")
    want = [jdecap.greedy_decode(jp, f, JCFG, max_len=max_len) for f in feats]
    host = [tdecap.greedy_decode(tp, f, CFG, max_len=max_len) for f in feats]
    cached = tdecap.make_greedy_decoder(tp, CFG, max_len=max_len)
    batched = tdecap.make_batched_decoder(tp, CFG, max_len=max_len, batch=2)
    assert host == want
    assert [cached(f) for f in feats] == want
    assert batched(feats) == want
    if case == "eot_and_number":
        assert want[0][0] == [49407]
        assert want[2][0][0] == 286 and want[2][1][0] == 7
        assert len({len(t) for t, _ in want}) >= 2
    else:
        assert all(len(t) == max_len for t, _ in want)


def test_descale_and_render_caption_match_jax():
    entry = {"mean": 1.2, "std": 0.3, "shift": 0.0, "weight": 2.0}
    extra = {"graduated": 5.0 / 200, "l2_norm": "n/a", "global_shift": 100}
    for n in (0, 37, 100, 163, 499):
        assert tdecap.descale_number(n, entry, extra) == \
            jdecap.descale_number(n, entry, extra)
    pe_extra = {"graduated": 0.02, "l2_norm": 1.3}
    assert tdecap.descale_number(42, entry, pe_extra) == \
        jdecap.descale_number(42, entry, pe_extra)
    scale = {"walking speed value": entry,
             "step time value": {"mean": 0.5, "std": 0.1, "shift": 0.3,
                                 "weight": 1.5},
             "extra_info": extra}
    tok_t, tok_j = ClipBpeTokenizer(), JTokenizer()
    words = tok_t.encode("walking speed is ? , step time is ? .")
    tokens = [49406] + words[:4] + [49406] + words[4:] + [49407]
    for sd in (scale, None):
        got = tdecode.render_caption(list(tokens), [130, 77], sd, tok_t)
        want = jdecode.render_caption(list(tokens), [130, 77], sd, tok_j)
        assert got == want and "?" not in got


def test_decoder_train_steps_match_optax(params):
    """Three AdamW steps (optax.adamw's defaults, the warm-up schedule whose
    first rate is 0) from the same bridged init and batches: every leaf
    within ATOL of optax's (the steps move them by up to 1.5 lr), the
    losses and accuracies alike. The key biases' true gradient is zero
    (see test_gradients_match_jax) and AdamW's g / (sqrt(v) + eps) turns
    its rounding noise into up to lr an update: those are held to 2 lr."""
    jp, _ = params
    tp = jax_bridge.decap_params_from_jax(jp, CFG, device="cpu")
    lr, warmup, total = 1e-3, 2, 6
    opt = optax.adamw(jdt.linear_warmup_schedule(lr, warmup, total))
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate = opt.init(jparams)
    topt, sched = tdt.make_optimizer(tp, lr, warmup, total)
    step = tdt.make_train_step(tp, CFG, topt, sched)

    @jax.jit
    def jax_step(p, st, f, t):
        (loss, m), g = jax.value_and_grad(
            lambda p: jdecap.decap_loss(p, f, t, JCFG), has_aux=True)(p)
        updates, st = opt.update(g, st, p)
        return optax.apply_updates(p, updates), st, loss, m

    rates = []
    for i in range(3):
        tok, feats = _tokens(20 + i), _feats(30 + i)
        jparams, jstate, loss_j, m_j = jax_step(
            jparams, jstate, jnp.asarray(feats), jnp.asarray(tok))
        rates.append(topt.param_groups[0]["lr"])
        loss_t, m_t = step(torch.from_numpy(feats), torch.from_numpy(tok))
        np.testing.assert_allclose(float(loss_t), float(loss_j), atol=ATOL)
        np.testing.assert_allclose(float(m_t["acc"]), float(m_j["acc"]),
                                   atol=ATOL)
    assert rates == pytest.approx([0.0, lr / 2, lr], abs=1e-12)
    got = jax_bridge.params_to_jax(tp)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree_util.tree_leaves(got)):
        name = jax.tree_util.keystr(path)
        key_bias = name == "['blocks']['attn']['k']['bias']"
        np.testing.assert_allclose(g, np.asarray(w),
                                   atol=2 * lr if key_bias else ATOL,
                                   err_msg=name)
    sched_t = tdt.linear_warmup_schedule(lr, warmup, total)
    sched_j = jdt.linear_warmup_schedule(lr, warmup, total)
    for c in range(9):
        # optax evaluates its schedule in float32
        assert sched_t(c) == pytest.approx(float(sched_j(c)), rel=1e-6,
                                           abs=1e-12)


def test_checkpoints_load_in_either_package(params, tmp_path):
    """A checkpoint in the JAX program's format loads in the port, and one
    written by the port loads in the JAX package: the same logits."""
    jp, tp = params
    jpath = tmp_path / "jax.ckpt"
    with open(jpath, "wb") as f:
        pickle.dump({"params": jp, "config": JCFG.__dict__}, f)
    tpath = tdt.save_decap(str(tmp_path / "port.ckpt"), tp, CFG)
    tok = _tokens(7)
    want = np.asarray(jdecap.decap_forward(jp, jnp.asarray(_feats(8)),
                                           jnp.asarray(tok), JCFG))
    p1, c1 = tdecode.load_decap(str(jpath), device="cpu")
    p2, c2 = jdecode.load_decap(tpath)
    assert c1 == CFG and c2 == JCFG
    np.testing.assert_allclose(
        tdecap.decap_forward(p1, torch.from_numpy(_feats(8)),
                             torch.from_numpy(tok), c1).numpy(), want,
        atol=ATOL)
    np.testing.assert_array_equal(
        np.asarray(jdecap.decap_forward(p2, jnp.asarray(_feats(8)),
                                        jnp.asarray(tok), c2)), want)


E = 16
N_CLS = 3


def _fake_vlm(rs):
    params = {
        "memory_project": {
            "w1": rs.randn(N_CLS, E, E // 4).astype(np.float32),
            "b1": rs.randn(N_CLS, E // 4).astype(np.float32),
            "w2": rs.randn(N_CLS, E // 4, E // 8).astype(np.float32),
            "b2": rs.randn(N_CLS, E // 8).astype(np.float32),
        },
        "tf_project": {
            "fc1": {"kernel": rs.randn(E, E // 4).astype(np.float32),
                    "bias": np.zeros(E // 4, np.float32)},
            "fc2": {"kernel": rs.randn(E // 4, E // 8).astype(np.float32),
                    "bias": np.zeros(E // 8, np.float32)},
        },
    }
    return params, rs.randn(N_CLS, E).astype(np.float32)


def _fake_bank(rs, d=E, n=10):
    return {"embeds": rs.randn(n, 3, d).astype(np.float32),
            "updrs": np.array([0, 1, 2, 0, 1, 2, -1, 0, 1, 2][:n]),
            "diag": np.zeros(n, np.int64)}


def test_decode_studies_match_jax(params):
    """group_support_memory and replay_memory_projection equal to JAX's;
    the centroid and per-class studies decode the same captions."""
    jp, tp = params
    rs = np.random.RandomState(1)
    vlm, tf = _fake_vlm(rs)
    bank = _fake_bank(rs)
    groups_j = jdecode.group_support_memory(bank, "updrs")
    groups_t = tdecode.group_support_memory(bank, "updrs")
    assert groups_t.keys() == groups_j.keys() == {"updrs 0", "updrs 1",
                                                  "updrs 2"}
    for k in groups_j:
        np.testing.assert_array_equal(groups_t[k], groups_j[k])
    sim_j, raw_j = jdecode.replay_memory_projection(vlm, groups_j)
    sim_t, raw_t = tdecode.replay_memory_projection(vlm, groups_t)
    for k in sim_j:
        np.testing.assert_array_equal(sim_t[k], sim_j[k])
        np.testing.assert_array_equal(raw_t[k], raw_j[k])
    tok_t, tok_j = ClipBpeTokenizer(), JTokenizer()
    assert tdecode.centroid_study(tp, CFG, sim_t, raw_t, None, tok_t) == \
        jdecode.centroid_study(jp, JCFG, sim_j, raw_j, None, tok_j)
    assert tdecode.class_feature_study(tp, CFG, vlm, tf, sim_t, raw_t, None,
                                       tok_t, "updrs") == \
        jdecode.class_feature_study(jp, JCFG, vlm, tf, sim_j, raw_j, None,
                                    tok_j, "updrs")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's decoder_train program at the full DecapConfig (768 x 4,
    vocabulary 49,908): two steps at --bs 2 on a 4-row bank."""
    root = tmp_path_factory.mktemp("decap")
    rs = np.random.RandomState(0)
    tokens = np.zeros((4, 77), np.float32)
    tokens[:, 0] = 49406
    tokens[:, 1:4] = rs.randint(1, 49406, (4, 3))
    tokens[:, 4] = 49408 + rs.randint(0, 500, 4)
    tokens[:, 5] = 49407
    bank = dict(_fake_bank(rs, d=512, n=4), tokens=tokens)
    with open(root / "bank.pkl", "wb") as f:
        pickle.dump(bank, f)
    vlm, tf = _fake_vlm(np.random.RandomState(2))
    vlm["memory_project"] = {
        k: rs.randn(N_CLS, *v.shape[1:]).astype(np.float32) * 0.05
        for k, v in {"w1": np.zeros((1, 512, 128)), "b1": np.zeros((1, 128)),
                     "w2": np.zeros((1, 128, 64)),
                     "b2": np.zeros((1, 64))}.items()}
    with open(root / "vlm.ckpt", "wb") as f:
        pickle.dump({"params": vlm, "text_features": None}, f)
    argv = ["--train_data", str(root / "bank.pkl"), "--bs", "2",
            "--epochs", "1", "--print_freq", "1",
            "--output_dir", str(root / "ckpt")]
    path = tdt.main(argv + ["--device", "cpu"])
    return root, argv, path


def test_decoder_train_program(trained):
    root, argv, path = trained
    assert osp.isfile(path)
    assert tdt.last_run["steps"] == 2
    assert [s for s, _, _ in tdt.last_run["prints"]] == [1, 2]
    assert all(np.isfinite(l) for _, l, _ in tdt.last_run["prints"])
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    assert ckpt["config"] == dataclasses.asdict(tdecap.DecapConfig())
    assert ckpt["params"]["blocks"]["attn"]["q"]["kernel"].shape == \
        (4, 768, 768)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdt.main(argv)


def test_decode_program(trained, monkeypatch):
    """cli.decode on the program's checkpoint: the bulk path on the bank
    and the centroid study through a VLM checkpoint's memory heads."""
    root, _, path = trained
    monkeypatch.chdir(root)
    lines = tdecode.main(["--decap_ckpt", path, "--features",
                          str(root / "bank.pkl"), "--limit", "3",
                          "--device", "cpu"])
    assert len(lines) == 3 and all(isinstance(s, str) for s in lines)
    assert (root / "decoded.txt").read_text() == "\n".join(lines)
    study = tdecode.main(["--decap_ckpt", path, "--vlm_ckpt",
                          str(root / "vlm.ckpt"), "--memory_bank",
                          str(root / "bank.pkl"), "--use_centroid",
                          "--output", "centroid.txt", "--device", "cpu"])
    assert set(study) == {"updrs 0", "updrs 1", "updrs 2"}
    assert (root / "centroid.txt").read_text().startswith("CENTROID")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdecode.main(["--decap_ckpt", path, "--features",
                          str(root / "bank.pkl")])
