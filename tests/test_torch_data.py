"""The host-side data path of the PyTorch port against the JAX package's:
samplers, datasets (decoded-view cache, NTE side channel, memory-label
surgery), loaders, metrics, the config round trip, the mirror-only
augmentation and the device prefetcher. Both sides are numpy code over the
same files and seeds, so everything is held EXACTLY (array_equal), except
where a tolerance is stated.
"""

import argparse
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gava_clip_tpu.data import datasets as jds
from gava_clip_tpu.data import device_preprocess as jpre
from gava_clip_tpu.data import loader as jld
from gava_clip_tpu.data import native as jnative
from gava_clip_tpu.data import sampler as jsampler
from gava_clip_tpu.data import video as jvideo
from gava_clip_tpu.train import metrics as jmetrics
from gava_clip_tpu.utils import config as jconfig
from gava_clip_tpu_torch.data import datasets as tds
from gava_clip_tpu_torch.data import device_prefetch as tprefetch
from gava_clip_tpu_torch.data import device_preprocess as tpre
from gava_clip_tpu_torch.data import loader as tld
from gava_clip_tpu_torch.data import native as tnative
from gava_clip_tpu_torch.data import sampler as tsampler
from gava_clip_tpu_torch.data import video as tvideo
from gava_clip_tpu_torch.train import metrics as tmetrics
from gava_clip_tpu_torch.utils import config as tconfig
from tests.test_torch_bounds import bounded_list, module_deadline  # noqa: F401


def _write_video(path, n=12, seed=0, size=(48, 40)):
    import cv2
    rs = np.random.RandomState(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, size)
    for _ in range(n):
        w.write(rs.randint(0, 255, (size[1], size[0], 3), dtype=np.uint8))
    w.release()


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    root = tmp_path_factory.mktemp("fold")
    names = ["fvid_a.mp4", "vid_b.mp4", "SUB1_x_001.mp4", "vid_d.mp4"]
    for i, n in enumerate(names):
        _write_video(root / n, seed=i)
    with open(root / "train.csv", "w") as f:
        f.write("".join(f"{n},{i % 3}\n" for i, n in enumerate(names)) + "\n")
    os.makedirs(root / "nte")
    rs = np.random.RandomState(9)
    np.save(root / "nte" / "vid_a.npy", rs.randn(70, 16).astype(np.float32))
    np.save(root / "nte" / "SUB1_x.npy", rs.randn(70, 16).astype(np.float32))
    return root, names


@pytest.mark.parametrize("n,steps,batch,world,rank,resume", [
    (10, 7, 4, 1, 0, 0), (10, 7, 4, 2, 1, 3), (5, 9, 6, 3, 2, 0),
    (64, 12, 16, 1, 0, 6), (3, 4, 2, 2, 0, 4)])
def test_step_sampler_grid_equals_jax(n, steps, batch, world, rank, resume):
    want = jsampler.step_sampler(n, steps, batch, rank=rank,
                                 world_size=world, resume_step=resume)
    got = tsampler.step_sampler(n, steps, batch, rank=rank, world_size=world,
                                resume_step=resume)
    assert got.shape == (steps - resume, batch // world)
    np.testing.assert_array_equal(got, want)
    # a resumed grid is the tail of the uninterrupted one
    np.testing.assert_array_equal(
        got, tsampler.step_sampler(n, steps, batch, rank=rank,
                                   world_size=world)[resume:])


def test_eval_sampler_equals_jax():
    for n, rank, world in ((10, 0, 1), (10, 1, 3), (7, 2, 4)):
        np.testing.assert_array_equal(tsampler.eval_sampler(n, rank, world),
                                      jsampler.eval_sampler(n, rank, world))


def test_frame_index_functions_equal_jax():
    for n, T, rate in ((30, 8, 1), (30, 8, 4), (5, 8, 2), (100, 4, -1)):
        a = jvideo.sample_frame_indices(n, T, rate, True,
                                        np.random.RandomState(3))
        b = tvideo.sample_frame_indices(n, T, rate, True,
                                        np.random.RandomState(3))
        assert a == b
    with pytest.raises(ValueError):
        tvideo.sample_frame_indices(10, 4, 1, False)
    for n, T, rate, views in ((30, 8, 2, 3), (5, 8, 1, 1), (12, 4, 3, 10)):
        assert tvideo.temporal_crop_indices(n, T, rate, views) == \
            jvideo.temporal_crop_indices(n, T, rate, views)
    for hw in ((40, 48), (48, 40), (33, 32)):
        box = tvideo.random_resized_crop_params(
            *hw, rng=np.random.RandomState(1))
        assert box == jvideo.random_resized_crop_params(
            *hw, rng=np.random.RandomState(1))


def test_crops_and_resizes_equal_jax():
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 255, (4, 40, 48, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tvideo.keep_aspect_resize(frames, 32),
                                  jvideo.keep_aspect_resize(frames, 32))
    sq = tvideo.keep_aspect_resize(frames, 32)
    for views in (1, 3):
        for a, b in zip(tvideo.spatial_crops(sq, 32, views),
                        jvideo.spatial_crops(sq, 32, views)):
            np.testing.assert_array_equal(a, b)
    for fn in ("random_resized_crop", "random_resized_crop_with_shift"):
        np.testing.assert_array_equal(
            getattr(tvideo, fn)(frames, 16, rng=np.random.RandomState(2)),
            getattr(jvideo, fn)(frames, 16, rng=np.random.RandomState(2)))
    np.testing.assert_array_equal(
        tvideo.random_short_side_scale_jitter(
            frames, 20, 36, rng=np.random.RandomState(4)),
        jvideo.random_short_side_scale_jitter(
            frames, 20, 36, rng=np.random.RandomState(4)))
    np.testing.assert_array_equal(
        tvideo.horizontal_flip(1.0, frames), frames[:, :, ::-1])


def test_native_frame_pipeline_equals_jax_copy():
    """The port builds its own copy of the C++ frame pipeline into its own
    build directory; where a compiler is at hand both libraries agree."""
    if not tnative.available():
        assert not jnative.available()      # no g++: both take the cv2 path
        return
    assert "gava_clip_tpu_torch" in tnative._LIB_PATH and \
        os.path.isfile(tnative._LIB_PATH)
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 255, (3, 40, 48, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tnative.resize_bilinear(frames, 32, 38),
                                  jnative.resize_bilinear(frames, 32, 38))
    np.testing.assert_array_equal(
        tnative.crop_resize(frames, 2, 3, 20, 30, 16, 16),
        jnative.crop_resize(frames, 2, 3, 20, 30, 16, 16))
    np.testing.assert_array_equal(tnative.center_crop(frames, 32),
                                  jnative.center_crop(frames, 32))
    np.testing.assert_array_equal(
        tvideo.keep_aspect_resize(frames, 32, use_native=True),
        jvideo.keep_aspect_resize(frames, 32, use_native=True))


@pytest.mark.parametrize("is_train,all_views", [(True, False), (False, False),
                                                (False, True)])
def test_video_dataset_outputs_and_cache_equal_jax(fold, tmp_path, is_train,
                                                   all_views):
    root, names = fold
    kw = dict(list_path=str(root / "train.csv"), data_root=str(root),
              num_spatial_views=3 if all_views else 1,
              num_temporal_views=2 if all_views else 1, num_frames=4,
              sampling_rate=2, spatial_size=32, is_train=is_train,
              add_nte=True, nte_dim=16, return_all_views=all_views)
    jd = jds.VideoDataset(jds.VideoDatasetConfig(
        cache_dir=str(tmp_path / "jc"), **kw))
    td = tds.VideoDataset(tds.VideoDatasetConfig(
        cache_dir=str(tmp_path / "tc"), **kw))
    assert len(td) == len(jd) == 4
    for i in range(4):
        a, b = td[i], jd[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == np.uint8 and a[1] == b[1]
        if is_train:
            np.testing.assert_array_equal(a[2], b[2])   # the NTE side channel
        else:
            assert a[2] == b[2]                         # the clip's name
    # the cache key and the cached bytes are the JAX package's
    assert sorted(os.listdir(tmp_path / "tc")) == \
        sorted(os.listdir(tmp_path / "jc"))
    assert td._cache_path(names[0]).split(os.sep)[-1] == \
        jd._cache_path(names[0]).split(os.sep)[-1]
    # a second read comes from the cache, bit-equal, and either package
    # reads the other's cache
    swapped = tds.VideoDataset(tds.VideoDatasetConfig(
        cache_dir=str(tmp_path / "jc"), **kw))
    np.testing.assert_array_equal(swapped[2][0], td[2][0])
    if is_train:
        # NTE: 'fvid' -> 'vid', SUB names drop their last field, a missing
        # file gives zeros
        assert np.abs(td[0][2]).sum() > 0 and np.abs(td[2][2]).sum() > 0
        assert td[1][2].shape == (70, 16) and not td[1][2].any()


def test_random_sample_dataset_equals_jax(fold):
    root, _ = fold
    kw = dict(list_path=str(root / "train.csv"), data_root=str(root),
              random_sample=True, num_frames=4, sampling_rate=2,
              spatial_size=24, mirror=True, is_train=True)
    jd = jds.VideoDataset(jds.VideoDatasetConfig(**kw), seed=5)
    td = tds.VideoDataset(tds.VideoDatasetConfig(**kw), seed=5)
    for i in (0, 3, 1):
        np.testing.assert_array_equal(td[i][0], jd[i][0])


@pytest.mark.parametrize("cls_type,zero_shot,key", [
    ("updrs", False, "updrs"), ("updrs_3cls", False, "updrs"),
    ("diag", True, "diag"), ("diag_3cls", True, "diag"),
    ("diag", False, "diag"), ("DIAG_3CLS", False, "diag")])
def test_memory_dataset_label_surgery_equals_jax(tmp_path, cls_type,
                                                 zero_shot, key):
    rs = np.random.RandomState(0)
    data = {"embeds": rs.randn(40, 3, 8).astype(np.float32),
            key: np.array([0, 1, 2, 3, 4, -1, 2, 3] * 5)}
    p = tmp_path / "mem.pkl"
    with open(p, "wb") as f:
        pickle.dump(data, f)
    jd = jds.MemoryDataset(str(p), cls_type, for_zero_shot=zero_shot)
    td = tds.MemoryDataset(str(p), cls_type, for_zero_shot=zero_shot)
    assert len(td) == len(jd) and td.labels.dtype == np.int64
    np.testing.assert_array_equal(td.labels, jd.labels)
    np.testing.assert_array_equal(td.data, jd.data)
    e, l = td[3]
    assert e.shape == (3, 8) and l == jd[3][1]


def test_dummy_datasets_equal_jax():
    for views in (1, 3):
        a = tds.DummyDataset("", 4, views, 16, nte_dim=8)[0]
        b = jds.DummyDataset("", 4, views, 16, nte_dim=8)[0]
        assert len(tds.DummyDataset("", 4, views, 16)) == 64
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    a, b = tds.DummyMemoDataset(3, 4, 8), jds.DummyMemoDataset(3, 4, 8)
    assert len(a) == len(b)
    np.testing.assert_array_equal(a[0][0], b[0][0])


def _loader_cfg(mod, root, **kw):
    return mod.LoaderConfig(
        train_list_path=str(root / "train.csv"),
        val_list_path=str(root / "train.csv"),
        eval_list_path=str(root / "train.csv"), eval_data_root=str(root),
        data_root=str(root), batch_size=3, num_frames=4, spatial_size=32,
        num_steps=3, num_workers=2, num_temporal_views=1, mem_batch_size=4,
        add_nte=True, embed_dim=16, **kw)


@pytest.mark.parametrize("which", ["train", "val", "eval", "memory",
                                   "train_resumed", "dummy"])
def test_loader_batches_equal_jax(fold, tmp_path, which):
    root, _ = fold
    rs = np.random.RandomState(2)
    mem = tmp_path / "mem.pkl"
    with open(mem, "wb") as f:
        pickle.dump({"embeds": rs.randn(12, 2, 16).astype(np.float32),
                     "updrs": np.arange(12) % 3}, f)
    extra = dict(use_support_memory=True, memory_data_path=str(mem),
                 type="updrs", dummy_dataset=which == "dummy")
    make = {"train": lambda m, c: m.create_train_loader(c),
            "dummy": lambda m, c: m.create_train_loader(c),
            "train_resumed": lambda m, c: m.create_train_loader(
                c, resume_step=2),
            "val": lambda m, c: m.create_val_loader(c),
            "eval": lambda m, c: m.create_eval_loader(c),
            "memory": lambda m, c: m.create_memory_loader(c)}[which]
    jb = list(make(jld, _loader_cfg(jld, root, **extra)))
    # the port's loader ends within its bound and leaves no thread behind
    before = threading.active_count()
    tb = bounded_list(lambda: make(tld, _loader_cfg(tld, root, **extra)))
    assert _wait_for(lambda: threading.active_count() <= before)
    assert len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        assert set(a) == set(b)
        for k in a:
            if k == "names":
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
    first = tb[0]
    if which in ("train", "dummy"):
        assert first["video"].shape == (3, 4, 32, 32, 3)
        assert first["nte"].shape == (3, 70, 16)
        assert first["labels"].dtype == np.int32
    if which == "memory":
        assert first["memory"].shape == (4, 2, 16)


def test_metrics_equal_jax():
    rs = np.random.RandomState(0)
    for conf in (rs.randint(0, 9, (3, 3)), np.diag([4, 0, 2]),
                 np.zeros((4, 4), np.int64)):
        np.testing.assert_array_equal(tmetrics.f1_from_confusion(conf),
                                      jmetrics.f1_from_confusion(conf))
        a, b = (m.summary_from_confusion(conf) for m in (tmetrics, jmetrics))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    ta, ja = tmetrics.StepAnomalyDetector(), jmetrics.StepAnomalyDetector()
    for t in [0.1] * 30 + [5.0, 0.1]:
        assert ta.check_step_time(t) == ja.check_step_time(t)
    for v in (1.0, float("nan"), float("inf"), 0.0):
        assert ta.check_loss(v) == ja.check_loss(v)


ARGV = ["--type", "updrs", "--num_steps", "7", "--mean", "0.4", "--std",
        "0.2", "0.3", "0.25", "--knowledge_version", "v1",
        "--knowledge_version", "v3", "--use_bf16", "--no_mirror",
        "--tsn_sampling", "--remat_policy", "dots", "--quantize_eval", "w8",
        "--lr", "3e-4", "--data_root", "x/tulip/y"]


def test_config_parser_and_round_trip_equal_jax(tmp_path):
    """The same flags parse to the same namespace (the port adds `device`),
    the config file is the same text, and either package reloads the
    other's."""
    ja = jconfig.build_train_parser().parse_args(ARGV)
    ta = tconfig.build_train_parser().parse_args(ARGV)
    tv = dict(vars(ta))
    assert tv.pop("device") is None
    assert tv == vars(ja)
    assert tconfig.build_train_parser().parse_args(
        ["--device", "cpu"]).device == "cpu"
    tconfig.save_config(argparse.Namespace(**tv), tmp_path / "t.yaml")
    jconfig.save_config(ja, tmp_path / "j.yaml")
    assert (tmp_path / "t.yaml").read_text() == \
        (tmp_path / "j.yaml").read_text()
    fresh = tconfig.build_train_parser().parse_args(["--data_root", "keep"])
    tconfig.load_config_into(fresh, tmp_path / "j.yaml", skip=["data_root"])
    assert fresh.data_root == "keep" and fresh.lr == 3e-4 and \
        fresh.knowledge_version == ["v1", "v3"] and fresh.std == [0.2, 0.3,
                                                                  0.25]
    fresh_j = jconfig.build_train_parser().parse_args([])
    jconfig.load_config_into(fresh_j, tmp_path / "t.yaml")
    assert vars(fresh_j) == vars(ja)
    for fold_i in (0, 3):
        a, b = argparse.Namespace(**vars(ja)), argparse.Namespace(**tv)
        jconfig.remap_fold_data_root(a, fold_i)
        tconfig.remap_fold_data_root(b, fold_i)
        assert vars(a) == vars(b)


def test_mirror_only_augment_equals_jax():
    """The flips come from another generator in each package, so the JAX
    side's decisions (recomputed from its key) are handed to the port: the
    same clips flip and the normalized values agree to fp32 rounding (1e-6;
    XLA fuses the divide). Without an override the port's draw depends on
    (seed, step) alone."""
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 255, (6, 2, 8, 10, 3), dtype=np.uint8)
    mean, std = (0.4, 0.45, 0.5), (0.2, 0.25, 0.3)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 7)
    want = np.asarray(jpre.make_train_augment(None, True, mean, std)(
        key, jnp.asarray(frames)))
    _, k_flip = jax.random.split(key)
    flip = np.asarray(jax.random.bernoulli(k_flip, 0.5, (6,)))
    assert 0 < flip.sum() < 6
    aug = tpre.make_train_augment(None, True, mean, std)
    got = aug(None, torch.from_numpy(frames), flip=torch.from_numpy(flip))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # no mirror: the plain normalize on both sides
    np.testing.assert_allclose(
        tpre.make_train_augment(None, False, mean, std)(
            None, torch.from_numpy(frames)).numpy(),
        np.asarray(jpre.normalize_frames(jnp.asarray(frames), mean, std)),
        atol=1e-6)
    a = aug(tpre.step_generator(0, 5), torch.from_numpy(frames))
    b = aug(tpre.step_generator(0, 5), torch.from_numpy(frames))
    c = [aug(tpre.step_generator(0, s), torch.from_numpy(frames))
         for s in range(6, 12)]
    assert torch.equal(a, b) and any(not torch.equal(a, x) for x in c)
    # with RandAugment or erasing on (tests/test_torch_augment.py holds them
    # to JAX) and draws handed in, an Invert on every clip and no box
    # erased, the batch is JAX's invert, the same flips and the normalize
    for kw in (dict(auto_augment="rand-m9-n1"), dict(erase_prob=0.25)):
        full = tpre.make_train_augment(kw.get("auto_augment"), True, mean,
                                       std, erase_prob=kw.get("erase_prob",
                                                              0.0))
        draws = {"flip": torch.from_numpy(flip),
                 "rand_augment": {"op": torch.full((6, 1), 2),
                                  "level": torch.full((6, 1), 0.9),
                                  "sign": torch.ones(6, 1, dtype=bool)},
                 "erase": {"apply": torch.zeros(6, dtype=bool),
                           "count": torch.ones(6, dtype=torch.int64),
                           "boxes": torch.ones(6, 1, 4, dtype=torch.int64),
                           "noise": None}}
        got = full(None, torch.from_numpy(frames), draws=draws)
        x = jnp.asarray(frames, jnp.float32) / 255.0
        if "auto_augment" in kw:
            x = 1.0 - x
        x = jnp.where(jnp.asarray(flip)[:, None, None, None, None],
                      x[:, :, :, ::-1], x)
        np.testing.assert_allclose(
            got.numpy(), np.asarray((x - jnp.asarray(mean)) /
                                    jnp.asarray(std)), atol=1e-6)


def test_prefetch_order_read_ahead_errors_and_close():
    """The JAX package's tests of its prefetcher, on the port's (the CPU
    pass-through form)."""
    pf = tprefetch.prefetch_to_device
    assert list(pf(iter(range(20)), lambda x: x * 2, size=3)) == \
        [x * 2 for x in range(20)]
    assert list(pf(iter(range(5)), lambda x: x, size=1, device="cpu")) == \
        list(range(5))
    produced = []
    it = pf(iter(range(10)), lambda x: produced.append(x) or x, size=2)
    assert next(it) == 0
    deadline = time.time() + 5.0
    while len(produced) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 3 and list(it) == list(range(1, 10))

    def bad(x):
        if x == 3:
            raise RuntimeError("copy failed")
        return x

    got = []
    with pytest.raises(RuntimeError, match="copy failed"):
        for v in pf(iter(range(10)), bad, size=2):
            got.append(v)
    assert got == [0, 1, 2]

    def gen():
        yield 1
        raise ValueError("decode failed")

    it = pf(gen(), lambda x: x, size=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="decode failed"):
        next(it)
    before = threading.active_count()
    it = pf(iter(range(1000)), lambda x: x, size=2)
    assert next(it) == 0
    it.close()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
    with pytest.raises(ValueError):
        next(pf(iter([1]), lambda x: x, size=0))


def test_pinned_batch_copier_on_the_host():
    """On the CPU the copier is `torch.from_numpy`; other values pass."""
    copier = tprefetch.PinnedBatchCopier("cpu")
    batch = {"video": np.arange(24, dtype=np.uint8).reshape(2, 3, 4)[:, ::2],
             "labels": np.array([1, 2], np.int64), "names": ["a", "b"]}
    out = copier(batch)
    assert out["names"] == ["a", "b"]
    assert out["video"].dtype == torch.uint8 and out["labels"].dtype == \
        torch.int64
    np.testing.assert_array_equal(out["video"].numpy(), batch["video"])


# --- ROADMAP C.3: a fetch error reaches the consumer, no thread is left ------

def _wait_for(cond, seconds=5.0):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.mark.parametrize("k", [0, 3, 9])
def test_loader_fetch_error_raises_within_a_bounded_time(k):
    """A `fetch_fn` that raises on its k-th batch makes iteration raise
    that exception after the k batches before it, within well under 10 s
    (the JAX package's prefetcher waits forever there), and no producer
    thread stays behind."""
    def fetch(idxs):
        if int(idxs[0]) == k:
            raise OSError(f"clip {k} cannot be read")
        time.sleep(0.01)
        return int(idxs[0])

    before = threading.active_count()
    pf = tld._Prefetcher(fetch, [np.array([i]) for i in range(10)],
                         num_workers=3, prefetch=2)
    got = []
    t0 = time.time()
    with pytest.raises(OSError, match=f"clip {k} cannot be read"):
        for item in pf:
            got.append(item)
    assert time.time() - t0 < 5.0
    assert got == list(range(k))
    assert _wait_for(lambda: threading.active_count() <= before)


def test_loader_consumer_that_stops_early_releases_the_producer():
    """A consumer that breaks (or closes the iterator) after one batch,
    with the queue full and fetches in flight, leaves no producer thread
    alive, and the fetches not yet started never run."""
    calls = []

    def fetch(idxs):
        calls.append(int(idxs[0]))
        time.sleep(0.02)
        return int(idxs[0])

    batches = [np.array([i]) for i in range(200)]
    for stop in ("break", "close"):
        calls.clear()
        before = threading.active_count()
        pf = tld._Prefetcher(fetch, batches, num_workers=2, prefetch=2)
        if stop == "break":
            for item in pf:
                break
        else:
            it = iter(pf)
            assert next(it) == 0
            time.sleep(0.2)           # the queue fills, the producer blocks
            it.close()
        # the producer and its pool's workers are gone
        assert _wait_for(lambda: threading.active_count() <= before), stop
        assert len(calls) < 20, (stop, len(calls))


def test_device_prefetch_raises_with_a_full_queue_and_a_slow_consumer():
    """The worker's error reaches a consumer whose step takes longer than
    a second while the queue is full: its put waits as long as an item's
    would (it gave up after 1 s and the consumer hung)."""
    def gen():
        yield from range(3)
        raise ValueError("decode failed")

    it = tprefetch.prefetch_to_device(gen(), lambda x: x, size=2)
    got = [next(it)]
    time.sleep(1.5)                  # the worker holds the error, q is full
    with pytest.raises(ValueError, match="decode failed"):
        for v in it:
            got.append(v)
            time.sleep(0.6)
    assert got == [0, 1, 2]
