"""The port's offline gait-knowledge programs against the JAX package on the
CPU: gait parameters, the support-memory bank and NTE matrices, the slerp
metadata, the knowledge embeddings and the video preparation. The tiny text
tower of tests/test_offline.py (width 32, 2 layers) crosses through
utils/jax_bridge; inputs are made with numpy from seeds."""

import csv
import os
import os.path as osp
import pickle
import sys

import numpy as np
import pytest
import torch

import jax

from gava_clip_tpu.data import datasets as jdatasets
from gava_clip_tpu.data import loader as jloader
from gava_clip_tpu.models import text as jtext
from gava_clip_tpu.offline import embeddings as jemb
from gava_clip_tpu.offline import gait_params as jgait
from gava_clip_tpu.offline import metadata as jmeta
from gava_clip_tpu.offline import preprocess as jpre
from gava_clip_tpu.offline import video_prep as jvp
from gava_clip_tpu_torch.data import datasets as tdatasets
from gava_clip_tpu_torch.data import loader as tloader
from gava_clip_tpu_torch.models.text import TextConfig
from gava_clip_tpu_torch.offline import embeddings as temb
from gava_clip_tpu_torch.offline import gait_params as tgait
from gava_clip_tpu_torch.offline import metadata as tmeta
from gava_clip_tpu_torch.offline import preprocess as tpre
from gava_clip_tpu_torch.offline import video_prep as tvp
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_offline import synthetic_walk
from tests.test_torch_train_step import models  # noqa: F401  (fixture)

JCFG = jtext.TextConfig(embed_dim=32, width=32, heads=2, layers=2)
CFG = TextConfig(embed_dim=32, width=32, heads=2, layers=2)
# fp32 text towers on the same weights, sums in another order through 2
# blocks: the JAX tests' own 1e-5 on unit-norm rows
ATOL = 1e-5


@pytest.fixture(scope="module")
def tiny_text():
    jp = jax.tree_util.tree_map(
        np.asarray, jtext.init_text_params(jax.random.PRNGKey(0), JCFG))
    return jp, jax_bridge.text_params_from_jax(jp, CFG, device="cpu")


# --- gait parameters ---------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=1, speed=0.9),
                                dict(seed=2, step_freq=1.5, n_frames=300)])
def test_gait_parameters_match_jax(kw):
    """The same numpy / SciPy code on both sides: equal to 1e-12."""
    joints = synthetic_walk(**kw)
    want = jgait.compute_gait_parameters(joints)
    got = tgait.compute_gait_parameters(joints)
    assert got.leglength == pytest.approx(want.leglength, abs=1e-12)
    assert list(got.params) == list(want.params)
    for k in tgait.GAIT_PARAM_NAMES:
        assert got.params[k] == pytest.approx(want.params[k], abs=1e-12,
                                              nan_ok=True)


def _skeletons(n=4):
    return {f"SUB0{i}_walk.mp4": {"joints3D": synthetic_walk(seed=i),
                                  "gait_score": i % 3, "diag": i % 2}
            for i in range(n)}


def test_process_skeletons_and_save_round_trip(tmp_path):
    """Both tables equal; each package's metadata file reads back through
    the other's load_metadata unchanged."""
    sk = _skeletons()
    want = jgait.process_skeletons(sk)
    got = tgait.process_skeletons(sk)
    assert got.keys() == want.keys()
    assert got["vidname"] == want["vidname"] == [f"SUB0{i}_walk"
                                                  for i in range(4)]
    for k in list(want)[1:]:
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(want[k], float), atol=1e-12)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj = jgait.save_metadata(want, str(tmp_path / "j" / "tulip_gparams.xlsx"))
    pt = tgait.save_metadata(got, str(tmp_path / "t" / "tulip_gparams.xlsx"))
    assert osp.basename(pj) == osp.basename(pt)
    for reader in (jpre.load_metadata, tpre.load_metadata):
        for path in (pj, pt):
            part1, unit = reader(path)
            assert list(part1) == list(want)
            np.testing.assert_allclose(np.asarray(part1["speed"]),
                                       want["speed"], atol=1e-12)
            assert unit == tgait.default_units()


# --- the bank and the NTE files ---------------------------------------------

def _metadata_file(tmp_path, n_vid=5):
    rs = np.random.RandomState(0)
    part1 = {"vidname": [f"vid{i}" for i in range(n_vid)],
             "updrs": [0, 1, 2, 1, 0], "diag": [0, 1, 1, 0, 1],
             "leglength": list(0.9 + 0.1 * rs.rand(n_vid))}
    names = ["walking speed", "mean step time", "step width", "cadence",
             "step time asymmetry", "step width variability",
             "margin of stability", "step time variability"]
    for n in names:
        part1[n] = list(rs.rand(n_vid) + 0.5)
    meta = tmp_path / "tulip_basic_gparams.pkl"
    with open(meta, "wb") as f:
        pickle.dump({"part1": part1, "unit": {n: "unit" for n in names}}, f)
    return str(meta), part1["vidname"]


def _assert_scale_dicts_equal(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].keys() == w.keys()
        for kk, v in w.items():
            if isinstance(v, str):
                assert got[k][kk] == v
            else:
                assert got[k][kk] == pytest.approx(v, abs=1e-6, rel=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(no_pe=False),
                                dict(no_pe=False, new_pe=True)],
                         ids=["no_pe", "pe_minimize", "new_pe"])
def test_data_preprocess_matches_jax(tmp_path, tiny_text, kw):
    """Bank embeds and every NTE file within ATOL of JAX's; tokens, text,
    updrs, diag and dtypes equal; the scale dicts equal (floats to 1e-6);
    each package's MemoryDataset reads the other's bank.

    The PE path with `minimize`: the JAX function cannot run it here (it
    divides the probe in place, and np.asarray of a jax.Array is
    read-only), so the JAX side runs the same path with the port's
    optimized l2_norm given, and that value is held to scipy's minimum of
    the JAX objective on a copy of the JAX probe."""
    jp, tp = tiny_text
    meta, vids = _metadata_file(tmp_path)
    got = tpre.data_preprocess(
        meta, tp, CFG, save_dir=str(tmp_path / "gt"),
        video_dir=str(tmp_path / "vt"),
        cfg=tpre.PreprocessConfig(d_model=32, **kw), device="cpu")
    with open(got["scale"], "rb") as f:
        scale_t = pickle.load(f)
    jkw = dict(kw)
    if kw == dict(no_pe=False):
        with pytest.raises(ValueError, match="read-only"):
            jpre.data_preprocess(meta, jp, JCFG, save_dir=str(tmp_path / "x"),
                                 video_dir=str(tmp_path / "x"),
                                 cfg=jpre.PreprocessConfig(d_model=32, **kw))
        l2 = scale_t["extra_info"]["l2_norm"]
        from scipy.optimize import minimize
        import jax.numpy as jnp
        names = [n for n in jpre.load_metadata(meta)[0]
                 if n not in ("vidname", "updrs", "diag", "leglength")]
        base = np.array(jtext.encode_text_tokens(
            jp, jnp.asarray(jpre.tokenize(names)), JCFG))
        base /= np.linalg.norm(base, axis=-1, keepdims=True)
        probe = np.array(jtext.encode_text_tokens(
            jp, jnp.asarray(jpre.tokenize("the walking speed is")), JCFG))[0]
        probe /= np.linalg.norm(probe)
        pe = jpre.sinusoidal_pe(1000, 32)

        def objective(l):
            a, b = probe + pe[0] * l, probe + pe[250] * l
            return (a @ b / np.linalg.norm(a) / np.linalg.norm(b)
                    - (base @ base.T).mean()) ** 2
        want_l2 = float(minimize(objective, x0=1.0, tol=1e-9).x[0])
        assert l2 == pytest.approx(want_l2, rel=1e-4)
        jkw["l2_norm"] = l2
    want = jpre.data_preprocess(meta, jp, JCFG, save_dir=str(tmp_path / "gj"),
                                video_dir=str(tmp_path / "vj"),
                                cfg=jpre.PreprocessConfig(d_model=32, **jkw))
    assert osp.basename(got["data"]) == osp.basename(want["data"])
    with open(want["data"], "rb") as f:
        bank_j = pickle.load(f)
    with open(got["data"], "rb") as f:
        bank_t = pickle.load(f)
    assert bank_t.keys() == bank_j.keys()
    assert bank_t["embeds"].shape == (70 * 5, 4, 32)
    for k in ("embeds", "updrs", "diag", "tokens"):
        assert bank_t[k].dtype == bank_j[k].dtype, k
        assert bank_t[k].shape == bank_j[k].shape, k
    np.testing.assert_allclose(bank_t["embeds"], bank_j["embeds"], atol=ATOL)
    for k in ("tokens", "updrs", "diag"):
        np.testing.assert_array_equal(bank_t[k], bank_j[k])
    assert bank_t["text"] == bank_j["text"]
    with open(want["scale"], "rb") as f:
        _assert_scale_dicts_equal(scale_t, pickle.load(f))
    for vn in vids:
        nt = np.load(osp.join(got["nte_dir"], f"{vn}.npy"))
        nj = np.load(osp.join(want["nte_dir"], f"{vn}.npy"))
        assert nt.shape == nj.shape == (70, 32) and nt.dtype == nj.dtype
        np.testing.assert_allclose(nt, nj, atol=ATOL)
    # each package's memory dataset reads the other's bank
    for mod, path in ((jdatasets, got["data"]), (tdatasets, want["data"])):
        ds = mod.MemoryDataset(path, cls_type="updrs", for_zero_shot=False)
        emb, label = ds[0]
        assert emb.shape == (4, 32) and 0 <= label <= 2


def _nte_fold(root, n_comb, missing):
    """Two training clips as decoded-view cache files; clip 0's NTE file
    holds n_comb rows, clip 1's is missing when `missing`."""
    cache = osp.join(root, "cache")
    os.makedirs(osp.join(root, "nte"), exist_ok=True)
    rows = [("walk000*0.mp4", 0), ("walk001*0.mp4", 1)]
    lst = osp.join(root, "train_updrs.csv")
    with open(lst, "w") as f:
        f.write("".join(f"{p},{c}\n" for p, c in rows))
    rs = np.random.RandomState(0)
    for i in range(1 if missing else 2):
        np.save(osp.join(root, "nte", f"walk00{i}.npy"),
                rs.randn(n_comb, 8).astype(np.float32))
    return lst, cache, [p for p, _ in rows]


@pytest.mark.parametrize("missing", [False, True])
def test_fold_with_a_missing_nte_file(tmp_path, missing):
    """ROADMAP C: a clip without an NTE file gets the zero default of
    NUM_COMB = 70 rows, while offline/preprocess writes C(10, 4) = 210
    rows for the ten gait parameters. In both packages the batch of such a
    fold cannot be stacked (np.stack raises ValueError); with every file
    present it stacks to (2, 210, E)."""
    lst, cache, paths = _nte_fold(str(tmp_path), 210, missing)
    frames = np.zeros((1, 2, 8, 8, 3), np.uint8)
    for mod, loader in ((jdatasets, jloader), (tdatasets, tloader)):
        ds = mod.VideoDataset(mod.VideoDatasetConfig(
            list_path=lst, data_root=str(tmp_path), num_frames=2,
            spatial_size=8, is_train=True, add_nte=True, nte_dim=8,
            cache_dir=cache))
        for p in paths:
            ds._cache_store(p, frames)
        assert ds[1][2].shape == ((70, 8) if missing else (210, 8))
        if missing:
            with pytest.raises(ValueError):
                loader._collate_video(ds, [0, 1])
        else:
            assert loader._collate_video(ds, [0, 1])["nte"].shape == \
                (2, 210, 8)


# --- the slerp metadata and the knowledge embeddings ------------------------

def _full_metadata():
    rs = np.random.RandomState(4)
    return {
        "updrs": [0, 1, 2, -1],
        "diag": [1, 0, 1, 2],
        "left leg length": [0.9, 1.0, 1.1, 0.95],
        "right leg length": [0.92, 1.01, 1.08, 0.97],
        "left step distance is short": rs.rand(4).tolist(),
        "walking pace is slow": rs.rand(4).tolist(),
        "stance percentage is minor": rs.rand(4).tolist(),
    }


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_trees_close(got, want, atol=ATOL):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_trees_close(got[k], want[k], atol)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, atol=atol)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("keep_length", [False, True])
def test_build_metadata_dicts_matches_jax(tmp_path, tiny_text, keep_length):
    jp, tp = tiny_text
    want = jmeta.build_metadata_dicts(_full_metadata(), jp, JCFG,
                                      save_dir=str(tmp_path / "j"),
                                      keep_length=keep_length)
    got = tmeta.build_metadata_dicts(_full_metadata(), tp, CFG,
                                     save_dir=str(tmp_path / "t"),
                                     keep_length=keep_length, device="cpu")
    assert {k: osp.basename(v) for k, v in got.items()} == \
        {k: osp.basename(v) for k, v in want.items()}
    for k in want:
        _assert_trees_close(_load(got[k]), _load(want[k]))


def test_build_slerp_metadata_matches_jax(tmp_path, tiny_text):
    jp, tp = tiny_text
    part1 = {"vidname": ["a", "b", "c"], "updrs": [0, 1, 2],
             "diag": [1, 0, 1], "leglength": [0.9, 1.0, 1.1],
             "walking speed": [1.0, 1.2, 0.8],
             "step time": [0.5, 0.6, 0.55]}
    want = jmeta.build_slerp_metadata(part1, jp, JCFG,
                                      save_dir=str(tmp_path / "j"))
    got = tmeta.build_slerp_metadata(part1, tp, CFG,
                                     save_dir=str(tmp_path / "t"),
                                     device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        _assert_trees_close(_load(got[k]), _load(want[k]))
    np.testing.assert_allclose(tmeta.default_pe(), jmeta.PE, atol=0)
    np.testing.assert_allclose(tmeta.slerp([1.0, 0.2], [0.1, 1.0], [0.3, 0.7]),
                               jmeta.slerp([1.0, 0.2], [0.1, 1.0], [0.3, 0.7]),
                               atol=0)


def _reference_backbone(tmp_path, jp):
    """A reference-format clip_pretrained.pth (`textual.*` only) holding
    the JAX tiny tower, the inverse of utils/torch_convert."""
    sd = {"textual.token_embedding.weight": jp["token_embedding"],
          "textual.positional_embedding": jp["positional_embedding"],
          "textual.text_projection": jp["text_projection"],
          "textual.ln_final.weight": jp["ln_final"]["scale"],
          "textual.ln_final.bias": jp["ln_final"]["bias"]}
    b = jp["blocks"]
    for i in range(JCFG.layers):
        pfx = f"textual.transformer.resblocks.{i}"
        a = b["attn"]
        sd[f"{pfx}.attn.in_proj_weight"] = np.concatenate(
            [a[n]["kernel"][i].T for n in ("q", "k", "v")])
        sd[f"{pfx}.attn.in_proj_bias"] = np.concatenate(
            [a[n]["bias"][i] for n in ("q", "k", "v")])
        sd[f"{pfx}.attn.out_proj.weight"] = a["out"]["kernel"][i].T
        sd[f"{pfx}.attn.out_proj.bias"] = a["out"]["bias"][i]
        for ln in ("ln_1", "ln_2"):
            sd[f"{pfx}.{ln}.weight"] = b[ln]["scale"][i]
            sd[f"{pfx}.{ln}.bias"] = b[ln]["bias"][i]
        for mine, theirs in (("fc1", "c_fc"), ("fc2", "c_proj")):
            sd[f"{pfx}.mlp.{theirs}.weight"] = b["mlp"][mine]["kernel"][i].T
            sd[f"{pfx}.mlp.{theirs}.bias"] = b["mlp"][mine]["bias"][i]
    path = str(tmp_path / "clip_pretrained.pth")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in sd.items()}, path)
    return path


def test_metadata_main_matches_jax(tmp_path, tiny_text):
    """Both programs on one reference-format backbone and one .pkl table;
    the port's without --device raises here (no card)."""
    jp, _ = tiny_text
    backbone = _reference_backbone(tmp_path, jp)
    with open(tmp_path / "meta.pkl", "wb") as f:
        pickle.dump(_full_metadata(), f)
    common = ["--metadata_file", str(tmp_path / "meta.pkl"),
              "--backbone_path", backbone, "--embed_dim", "32",
              "--text_width", "32", "--text_heads", "2", "--text_layers", "2"]
    want = jmeta.main(common + ["--save_dir", str(tmp_path / "j")])
    got = tmeta.main(common + ["--save_dir", str(tmp_path / "t"),
                               "--device", "cpu"])
    for k in want:
        _assert_trees_close(_load(got[k]), _load(want[k]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmeta.main(common + ["--save_dir", str(tmp_path / "x")])


def test_encode_text_file_matches_jax(tmp_path, tiny_text):
    jp, tp = tiny_text
    txt = tmp_path / "desc.txt"
    txt.write_text("normal gait\nslow walking\nshuffling steps\n")
    js = tmp_path / "desc.json"
    js.write_text('{"a": "a walk", "b": "a run"}')
    for path, n in ((txt, 3), (js, 2)):
        want = np.load(jemb.encode_text_file(
            str(path), jp, JCFG, out_path=str(path) + ".j.npy"))
        got = np.load(temb.encode_text_file(
            str(path), tp, CFG, out_path=str(path) + ".t.npy", device="cpu"))
        assert got.shape == want.shape == (n, 32)
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert temb.number_words(45) == jemb.number_words(45)
    got = temb.pe_distance_study(tp, CFG, n=12, device="cpu")
    want = jemb.pe_distance_study(jp, JCFG, n=12)
    _assert_trees_close(got, want)


def test_extract_class_text_features_matches_jax(models):
    jmodel, model = models
    want = jemb.extract_class_text_features(jmodel, jmodel.params)
    got = temb.extract_class_text_features(model, model.params)
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encode_videos_to_class_dict_matches_jax(models):
    """The tiny vision tower (32^2, 2 frames) on 5 uint8 clips in batches of
    2; the last batch padded."""
    jmodel, model = models
    rs = np.random.RandomState(3)
    video = rs.randint(0, 255, (5, 2, 32, 32, 3)).astype(np.uint8)
    labels = np.array([0, 2, 1, 0, 2])
    loader = [{"video": video[i:i + 2], "labels": labels[i:i + 2]}
              for i in range(0, 5, 2)]
    mean, std = (0.45,) * 3, (0.225,) * 3
    want = jemb.encode_videos_to_class_dict(jmodel, jmodel.params, loader,
                                            mean, std, 2)
    got = temb.encode_videos_to_class_dict(model, model.params, loader,
                                           mean, std, 2)
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL)


# --- video preparation ---------------------------------------------------------

def _write_video(path, n, h=32, w=40, seed=0):
    import cv2
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (w, h))
    rs = np.random.RandomState(seed)
    for _ in range(n):
        writer.write(rs.randint(0, 255, (h, w, 3), dtype=np.uint8))
    writer.release()


def _read_csvs(d):
    return {fn: list(csv.reader(open(osp.join(d, fn))))
            for fn in sorted(os.listdir(d)) if fn.endswith(".csv")}


def _decoded(d):
    from gava_clip_tpu_torch.data.video import decode_frames
    return {fn: decode_frames(osp.join(d, fn))
            for fn in sorted(os.listdir(d)) if fn.endswith(".mp4")}


def _assert_same_outputs(dj, dt):
    assert _read_csvs(dt) == _read_csvs(dj)
    fj, ft = _decoded(dj), _decoded(dt)
    assert ft.keys() == fj.keys()
    for k in fj:
        np.testing.assert_array_equal(ft[k], fj[k])


@pytest.mark.parametrize("n", [70, 71, 89, 90, 150, 200, 333])
def test_chunk_start_indices_match_jax(n):
    for is_train in (True, False):
        np.testing.assert_array_equal(
            tvp.chunk_start_indices(n, 70, is_train),
            jvp.chunk_start_indices(n, 70, is_train))


def test_split_and_loso_folds_write_the_same_files(tmp_path):
    pytest.importorskip("cv2")
    vids = tmp_path / "vids"
    vids.mkdir()
    labels = {}
    for s, n in ((1, 150), (2, 80), (3, 66)):
        _write_video(vids / f"Subject_{s}_walk.mp4", n, seed=s)
        labels[f"Subject_{s}_walk"] = (s % 2, s % 3)
    want = jvp.split_videos_into_chunks(str(vids), labels,
                                        str(tmp_path / "j"), seqlen=70,
                                        val_subs=["Subject_1"])
    got = tvp.split_videos_into_chunks(str(vids), labels,
                                       str(tmp_path / "t"), seqlen=70,
                                       val_subs=["Subject_1"])
    assert got == want
    _assert_same_outputs(str(tmp_path / "j"), str(tmp_path / "t"))
    want = jvp.build_loso_folds(str(vids), labels, str(tmp_path / "lj"),
                                nfold=3)
    got = tvp.build_loso_folds(str(vids), labels, str(tmp_path / "lt"),
                               nfold=3)
    assert got == want
    for n in range(3):
        _assert_same_outputs(str(tmp_path / "lj" / f"chunks_{n}"),
                             str(tmp_path / "lt" / f"chunks_{n}"))
    assert tvp.class_distribution(str(tmp_path / "lt")) == \
        jvp.class_distribution(str(tmp_path / "lj"))


def test_convert_3cls_csv_matches_jax(tmp_path):
    for side in ("j", "t"):
        d = tmp_path / side
        d.mkdir()
        with open(d / "d.csv", "w", newline="") as f:
            csv.writer(f).writerows([["a", 0], ["b", 1], ["c", 3], ["d", 4]])
        with open(d / "s.csv", "w", newline="") as f:
            csv.writer(f).writerows([["a", 0], ["b", 2], ["c", 3]])
        (jvp if side == "j" else tvp).convert_3cls_csv(str(d / "d.csv"),
                                                       str(d / "s.csv"))
    assert _read_csvs(str(tmp_path / "t")) == _read_csvs(str(tmp_path / "j"))


def test_crop_and_turning_points_match_jax(tmp_path):
    """The bbox crop golden cases, the turning points, the straight
    segments, the resize cache and the bbox crops of a video."""
    pytest.importorskip("cv2")
    rs = np.random.RandomState(0)
    frame = rs.randint(0, 255, (100, 120, 3), dtype=np.uint8)
    for c_x, c_y, bs in [(60.0, 50.0, 0.3), (5.0, 5.0, 0.4),
                         (115.0, 95.0, 0.5)]:
        np.testing.assert_array_equal(
            tvp.crop_frame_with_bbox(frame, c_x, c_y, bs),
            jvp.crop_frame_with_bbox(frame, c_x, c_y, bs))
    x = np.concatenate([np.linspace(0, 10, 150), np.linspace(10, 0, 150)])
    x = x + 0.05 * rs.randn(300)
    assert tvp.find_turning_points(x, fps=30) == \
        jvp.find_turning_points(x, fps=30)
    vid = tmp_path / "Subject_3_Camera1.mp4"
    _write_video(vid, 300)
    for side, mod in (("j", jvp), ("t", tvp)):
        outs = mod.cut_straight_segments(str(vid), x, str(tmp_path / side))
        assert [osp.basename(o) for o in outs] == \
            ["Subject_3_Camera1_CC0.mp4", "Subject_3_Camera1_CC1.mp4"]
        src = tmp_path / f"src_{side}"
        src.mkdir()
        _write_video(src / "big.mp4", 5, h=64, w=128, seed=1)
        mod.resize_videos(str(src), str(tmp_path / side / "resized"),
                          short_side=32)
        bbox = {"Subject_3_Camera1_CC0": {
            "bbox": np.array([[20.0, 15.0, 0.2]] * 4),
            "frame_ids": np.array([0, 2, 4, 6])}}
        with open(tmp_path / "bbox.pkl", "wb") as f:
            pickle.dump(bbox, f)
        mod.crop_videos_with_bbox(str(tmp_path), str(tmp_path / "bbox.pkl"),
                                  str(tmp_path / side / "crops"), out_size=64)
    for sub in ("", "resized", "crops"):
        _assert_same_outputs(str(tmp_path / "j" / sub),
                             str(tmp_path / "t" / sub))


def test_label_tables_match_jax(tmp_path):
    vids = tmp_path / "vids"
    vids.mkdir()
    for name in ("Subject_2_Camera1.mp4", "Subject_1_Camera1.mp4",
                 "Subject_1_Camera2.mp4"):
        (vids / name).touch()
    with open(tmp_path / "gait_label.csv", "w", newline="") as f:
        csv.writer(f).writerows([["Subject", "gold_standard", "diag"],
                                 [1, 2, "HT"], [2, 1, "PD"]])
    outs = [mod.gold_standard_to_label(str(tmp_path / "gait_label.csv"),
                                       str(vids),
                                       str(tmp_path / f"labels_{s}.xlsx"))
            for s, mod in (("j", jvp), ("t", tvp))]
    tables = [mod.load_label_table(p) for mod in (jvp, tvp) for p in outs]
    assert all(t == tables[0] for t in tables)
    assert tables[0]["Subject_2_Camera1"] == (1, 1)
    for c in ("walking", "running"):
        (tmp_path / "k" / c).mkdir(parents=True)
        (tmp_path / "k" / c / "v0.mp4").touch()
    assert tvp.annotations_to_csv(str(tmp_path / "k"), str(tmp_path / "t.csv")) \
        == jvp.annotations_to_csv(str(tmp_path / "k"), str(tmp_path / "j.csv"))


def test_video_prep_without_a_decoder(tmp_path, monkeypatch):
    """Without cv2 the decode and encode functions raise naming it; the csv,
    fold and label functions run."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        tvp.crop_frame_with_bbox(np.zeros((8, 8, 3), np.uint8), 4, 4, 0.02)
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a.mp4").touch()
    with pytest.raises(RuntimeError, match="cv2"):
        tvp.resize_videos(str(tmp_path / "src"), str(tmp_path / "dst"))
    np.testing.assert_array_equal(tvp.chunk_start_indices(200, 70, False),
                                  [0, 70])
    assert tvp.find_turning_points(np.r_[np.linspace(0, 10, 150),
                                         np.linspace(10, 0, 150)])


def test_offline_programs_need_a_card_by_default(tmp_path, monkeypatch,
                                                 tiny_text):
    """device=None means the card: without one every program raises before
    it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = tiny_text
    meta, _ = _metadata_file(tmp_path)
    calls = (
        lambda: tpre.data_preprocess(meta, tp, CFG,
                                     save_dir=str(tmp_path / "g")),
        lambda: tmeta.build_metadata_dicts(_full_metadata(), tp, CFG,
                                           save_dir=str(tmp_path / "m")),
        lambda: tmeta.build_slerp_metadata({"updrs": [0], "diag": [0]}, tp,
                                           CFG, save_dir=str(tmp_path / "s")),
        lambda: temb.encode_texts(["a walk"], tp, CFG))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not any((tmp_path / d).exists() for d in "gms")
