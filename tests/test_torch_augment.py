"""The port's device-side augmentation against the JAX package's on the
CPU: the 15 RandAugment ops, the policy's parser and magnitude -> argument
map, rand_augment_batch, random erasing, the colour-jitter family, the
float validation path (keep-aspect resize, center crop) and the whole
make_train_augment chain.

The two packages draw from different random streams, so every decision
JAX draws (op choices, levels and signs, flips, boxes, the erasing noise,
jitter orders and strengths) is recomputed here from its key and handed to
the port through `draws=`.

Tolerances. The pixel ops repeat JAX's float32 arithmetic step for step:
their outputs agree within 2e-6 (a sum of three products or a mean taken
in another order moves the last bit). The geometric ops sample at a
floor()ed source coordinate: a cos / sin or a product one float32 ulp off
can move that coordinate across an integer, and the pixel then takes its
neighbour's bilinear weights. Bilinear sampling is continuous across the
integer, so such a pixel moves by about the ulp times the image's
gradient, but where the fill (outside the frame) or a later quantizing op
(posterize, equalize, solarize's threshold) sits on that boundary one pixel
jumps by up to a level. So the geometric ops and the composed policies are
held by the share of values that differ by more than 1e-5 (a few pixels),
never by a ceiling on the largest difference. Measured on these inputs:
the pixel ops within 3e-7, the geometric ops and the policies bit for bit,
the whole chain within 7.7e-6 (after the normalize's 1 / 0.225)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gava_clip_tpu.data import color_jitter as jcj
from gava_clip_tpu.data import device_preprocess as jpre
from gava_clip_tpu.data import rand_augment as jra
from gava_clip_tpu.data import random_erasing as jre
from gava_clip_tpu_torch.data import color_jitter as tcj
from gava_clip_tpu_torch.data import device_preprocess as tpre
from gava_clip_tpu_torch.data import rand_augment as tra
from gava_clip_tpu_torch.data import random_erasing as tre
from tests.test_torch_bounds import module_deadline  # noqa: F401

PIXEL_ATOL = 2e-6
NEAR = 1e-5
# share of values beyond NEAR: an op alone, a composed policy / chain
GEOM_SHARE = 0.01
CHAIN_SHARE = 0.02
# the JAX table's op index of each op whose argument carries a sign, and
# the key (of the 16 split from the layer's magnitude key) it draws from
_SIGN_KEY = {"Rotate": 0, "ShearX": 1, "ShearY": 2, "TranslateX": 3,
             "TranslateY": 4, "Color": 14, "Contrast": 14, "Brightness": 14,
             "Sharpness": 14}
_NAMES = [name for name, _, _ in tra.OPS]
_GEOMETRIC = {"Rotate", "ShearX", "ShearY", "TranslateX", "TranslateY"}


def _clips(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _share_far(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float((np.abs(a - b) > NEAR).mean())


def _jax_level_sign(cfg, k_mag, name):
    """The level L (float32) and the sign (True: positive) that JAX's
    _op_table draws from the layer's magnitude key for op `name`."""
    keys = jax.random.split(k_mag, 16)
    m = cfg.magnitude
    if cfg.mag_std > 0:
        m = m + cfg.mag_std * jax.random.normal(keys[15])
    L = torch.tensor([float(jnp.clip(m, 0.0, 10.0) / 10.0)],
                     dtype=torch.float32)
    sign = bool(jax.random.bernoulli(keys[_SIGN_KEY[name]])) \
        if name in _SIGN_KEY else True
    return L, torch.tensor([sign])


def _jax_policy_draws(key, batch, cfg):
    """JAX rand_augment_batch's op indices, levels and signs, recomputed
    from its key (the port's draws)."""
    ops, levels, signs = [], [], []
    for k in jax.random.split(key, batch):
        row_o, row_l, row_s = [], [], []
        for _ in range(cfg.num_layers):
            k, k_sel, k_mag = jax.random.split(k, 3)
            idx = int(jax.random.randint(k_sel, (), 0, len(tra.OPS)))
            L, s = _jax_level_sign(cfg, k_mag, _NAMES[idx])
            row_o.append(idx)
            row_l.append(L)
            row_s.append(s)
        ops.append(row_o)
        levels.append(torch.cat(row_l))
        signs.append(torch.cat(row_s))
    return {"op": torch.tensor(ops), "level": torch.stack(levels),
            "sign": torch.stack(signs)}


# (magnitude, mag_std, increasing, seed of the magnitude key): levels with
# noise around 3, and 9 without noise with the inc1 maps
_MAGNITUDES = [(3.0, 0.5, False, 1), (9.0, 0.0, True, 2)]


@pytest.mark.parametrize("mag", _MAGNITUDES, ids=["m3-mstd", "m9-inc"])
@pytest.mark.parametrize("name", _NAMES)
def test_rand_augment_op_matches_jax(name, mag):
    """Each op on a (2, 16, 16, 3) clip at the argument JAX's table gives
    it, the port's argument from JAX's level and sign."""
    m, mstd, inc, seed = mag
    cfg = jra.RandAugmentConfig(magnitude=m, num_layers=1, mag_std=mstd,
                                increasing=inc)
    i = _NAMES.index(name)
    k_mag = jax.random.PRNGKey(seed)
    _, fn_j, arg_j = jra._op_table(cfg, k_mag)[i]
    L, sign = _jax_level_sign(cfg, k_mag, name)
    clip = _clips(seed, (2, 16, 16, 3))
    clip[0, :4, :4] = 1.0          # a saturated corner and a dark one
    clip[1, -4:, -4:] = 0.0
    want = np.asarray(fn_j(jnp.asarray(clip), arg_j))
    got = tra.OPS[i][1](torch.from_numpy(clip)[None],
                        tra.op_argument(i, L, sign, inc))[0].numpy()
    if name in _GEOMETRIC:
        assert _share_far(got, want) <= GEOM_SHARE
    else:
        np.testing.assert_allclose(got, want, atol=PIXEL_ATOL, rtol=0)


@pytest.mark.parametrize("s,want", [
    ("rand-m7-n4-mstd0.5-inc1", (7.0, 4, 0.5, True)),
    ("rand-m9-n2", (9.0, 2, 0.0, False)),
    ("rand-m5.5-mstd1-inc0-n3", (5.5, 3, 1.0, False)),
    ("rand", (10.0, 2, 0.0, False)),
])
def test_parse_rand_augment_config_matches_jax(s, want):
    t, j = tra.parse_rand_augment_config(s), jra.parse_rand_augment_config(s)
    assert (t.magnitude, t.num_layers, t.mag_std, t.increasing) == want
    assert (j.magnitude, j.num_layers, j.mag_std, j.increasing) == want


@pytest.mark.parametrize("config", ["rand-m7-n4-mstd0.5-inc1", "rand-m9-n2",
                                    "rand-m3-n2-mstd2"])
def test_op_arguments_from_jax_level_and_sign_bit_equal(config):
    """The magnitude -> argument map fed JAX's L and signs, recomputed from
    its keys, gives JAX's table arguments bit for bit, for every op at 12
    keys (the Posterize and Solarize maps as JAX has them, ROADMAP C.5)."""
    cfg = jra.parse_rand_augment_config(config)
    for seed in range(12):
        k_mag = jax.random.PRNGKey(100 + seed)
        table = jra._op_table(cfg, k_mag)
        for i, name in enumerate(_NAMES):
            L, sign = _jax_level_sign(cfg, k_mag, name)
            got = tra.op_argument(i, L, sign, cfg.increasing)
            want = np.float32(table[i][2])
            np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                          [want], err_msg=name)


@pytest.mark.parametrize("config", ["rand-m7-n2-mstd0.5-inc1", "rand-m9-n2"])
def test_rand_augment_batch_matches_jax_with_its_draws(config):
    """Six (2, 16, 16, 3) clips through JAX's rand_augment_batch and the
    port's with JAX's choices handed over: every clip through the same ops
    in the same order, held by the share of values beyond 1e-5. Two layers
    (JAX's eager vmap takes ~4 s a layer here); the recipe's four run in
    test_make_train_augment_chain_matches_jax."""
    key = jax.random.PRNGKey(7)
    clips = _clips(3, (6, 2, 16, 16, 3))
    want = np.asarray(jra.rand_augment_batch(key, jnp.asarray(clips),
                                             config))
    draws = _jax_policy_draws(key, 6, jra.parse_rand_augment_config(config))
    got = tra.rand_augment_batch(None, torch.from_numpy(clips), config,
                                 draws=draws)
    assert len(set(draws["op"].reshape(-1).tolist())) > 3
    assert _share_far(got.numpy(), want) <= CHAIN_SHARE


def test_rand_augment_batch_groups_clips_by_op_and_draws_per_step():
    """Clips that drew one op go through it in one batched call: the
    result equals each clip run alone. The draws of a generator depend on
    its seed alone."""
    clips = torch.from_numpy(_clips(4, (5, 2, 16, 16, 3)))
    cfg = tra.parse_rand_augment_config("rand-m7-n3-mstd0.5")
    draws = tra.draw_rand_augment(torch.Generator().manual_seed(3), 5, cfg)
    again = tra.draw_rand_augment(torch.Generator().manual_seed(3), 5, cfg)
    assert all(torch.equal(draws[k], again[k]) for k in draws)
    batch = tra.rand_augment_batch(None, clips, "rand-m7-n3-mstd0.5",
                                   draws=draws)
    for b in range(5):
        one = tra.rand_augment_batch(
            None, clips[b:b + 1], "rand-m7-n3-mstd0.5",
            draws={k: v[b:b + 1] for k, v in draws.items()})
        torch.testing.assert_close(batch[b:b + 1], one, rtol=0, atol=0)


def _jax_erase_draws(key, clip_shape, cfg):
    """JAX erase_clip's decisions recomputed from its key, as the port's
    draws of a batch of one."""
    T, H, W, C = clip_shape
    k_apply, k_count, k_boxes, k_noise = jax.random.split(key, 4)
    apply = bool(jax.random.uniform(k_apply) < cfg.probability)
    count = int(jax.random.randint(k_count, (), cfg.min_count,
                                   cfg.max_count + 1))
    boxes, noise = [], []
    for bk, nk in zip(jax.random.split(k_boxes, cfg.max_count),
                      jax.random.split(k_noise, cfg.max_count)):
        boxes.append([int(v) for v in jre._sample_box(bk, H, W, cfg)])
        shape = (1, H, W, C) if cfg.cube else (T, H, W, C)
        noise.append(np.asarray(jax.random.normal(nk, shape)))
    return {"apply": torch.tensor([apply]), "count": torch.tensor([count]),
            "boxes": torch.tensor([boxes]),
            "noise": (torch.from_numpy(np.stack(noise))[None]
                      if cfg.mode == "rand" else None)}


@pytest.mark.parametrize("cfg", [
    jre.RandomErasingConfig(probability=1.0),
    jre.RandomErasingConfig(probability=1.0, max_count=3, cube=False),
    jre.RandomErasingConfig(probability=1.0, mode="const", max_count=2),
    jre.RandomErasingConfig(probability=0.0),
], ids=["cube", "three-boxes-per-frame", "const", "never"])
def test_erase_clip_matches_jax_with_its_draws(cfg):
    """erase_clip on a (2, 24, 20, 3) clip at 8 keys, JAX's boxes and
    gaussian noise recomputed from each key: the same values (a select)."""
    tcfg = tre.RandomErasingConfig(**cfg.__dict__)
    clip = _clips(5, (2, 24, 20, 3))
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jre.erase_clip(key, jnp.asarray(clip), cfg))
        got = tre.erase_clip(None, torch.from_numpy(clip), tcfg,
                             draws=_jax_erase_draws(key, clip.shape, cfg))
        np.testing.assert_array_equal(got.numpy(), want)


def test_erasing_box_sizes_match_jax():
    """The box's height and width from JAX's own area and aspect uniforms
    (the uniforms of its keys), at 200 keys and two frame sizes."""
    cfg = jre.RandomErasingConfig()
    tcfg = tre.RandomErasingConfig()
    for H, W in ((24, 20), (224, 224)):
        for seed in range(200):
            k1, k2, _, _ = jax.random.split(jax.random.PRNGKey(seed), 4)
            _, _, h, w = jre._sample_box(jax.random.PRNGKey(seed), H, W, cfg)
            th, tw = tre.box_size(
                torch.tensor(float(jax.random.uniform(k1))),
                torch.tensor(float(jax.random.uniform(k2))), H, W, tcfg)
            assert (int(th), int(tw)) == (int(h), int(w)), (seed, H, W)


def test_random_erasing_batch_draws_noise_on_the_device_generator():
    """The batch form erases only where a box lies, with the same draws
    from the same generator state, and its fill is (B, count, 1, H, W, C)
    noise on the clips' device."""
    clips = torch.from_numpy(_clips(6, (4, 2, 24, 20, 3)))
    cfg = tre.RandomErasingConfig(probability=0.75, max_count=2)
    d = tre.draw_random_erasing(torch.Generator().manual_seed(1),
                                clips.shape, clips.device, cfg)
    assert d["noise"].shape == (4, 2, 1, 24, 20, 3)
    a = tre.random_erasing_batch(torch.Generator().manual_seed(1), clips,
                                 cfg)
    b = tre.random_erasing_batch(None, clips, cfg, draws=d)
    assert torch.equal(a, b)
    changed = (a != clips).any(dim=(1, 4))
    for i in range(4):
        if not d["apply"][i]:
            assert not changed[i].any()
    assert changed.any()


def test_color_jitter_functions_match_jax():
    """grayscale, the three jitters at two strengths, hue rotation at three
    angles, the lighting jitter with JAX's alphas and color_jitter with
    JAX's order and strengths (recomputed from its key)."""
    clip = _clips(8, (2, 12, 14, 3))
    cj, ct = jnp.asarray(clip), torch.from_numpy(clip)

    def close(got, want, atol=PIXEL_ATOL):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                                   rtol=0)
    close(tcj.grayscale(ct), jcj.grayscale(cj))
    for u in (0.1, 0.85):
        for name in ("brightness_jitter", "contrast_jitter",
                     "saturation_jitter"):
            close(getattr(tcj, name)(0.4, torch.tensor(u), ct),
                  getattr(jcj, name)(0.4, jnp.float32(u), cj))
    for deg in (0.0, 37.0, -120.0):
        close(tcj.hue_rotate(deg, ct), jcj.hue_rotate(jnp.float32(deg), cj),
              atol=1e-5)
    key = jax.random.PRNGKey(3)
    alphas = 0.1 * np.asarray(jax.random.normal(key, (3,)))
    close(tcj.lighting_jitter(None, ct, alphas=torch.from_numpy(alphas)),
          jcj.lighting_jitter(key, cj))
    for var in ((0.4, 0.4, 0.4), (0.0, 0.3, 0.5)):
        key = jax.random.PRNGKey(11)
        n = sum(v != 0 for v in var)
        k, k_perm = jax.random.split(key)
        order = np.asarray(jax.random.permutation(k_perm, n))
        u = [float(jax.random.uniform(jax.random.fold_in(k, i)))
             for i in range(n)]
        close(tcj.color_jitter(None, ct, *var, draws={
            "order": torch.tensor(order.tolist()), "u": torch.tensor(u)}),
              jcj.color_jitter(key, cj, *var))
    g = torch.Generator().manual_seed(0)
    assert tcj.color_jitter(g, ct, 0.4, 0.4, 0.4).shape == ct.shape


# (frames, spatial size): a downscale of a portrait frame (antialiased in
# JAX), a downscale of a landscape one, an upscale
_RESIZES = [((2, 40, 32, 3), 24), ((1, 30, 48, 3), 16), ((2, 12, 16, 3), 24)]


@pytest.mark.parametrize("shape,size", _RESIZES,
                         ids=["down-portrait", "down-landscape", "up"])
def test_resize_crop_and_val_preprocess_match_jax(shape, size):
    """keep_aspect_resize (F.interpolate with antialias=True: the triangle
    filter widened by the scale, as jax.image.resize's bilinear), center
    crop and val_preprocess_float: measured within 1.8e-7 and 2.4e-7 (the
    resize without antialias is 0.44 off on the downscales)."""
    frames = _clips(9, shape)
    fj, ft = jnp.asarray(frames), torch.from_numpy(frames)
    resized = np.asarray(jpre.keep_aspect_resize_jax(fj, size))
    np.testing.assert_allclose(tpre.keep_aspect_resize(ft, size).numpy(),
                               resized, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        tpre.center_crop(torch.from_numpy(resized.copy()), size).numpy(),
        np.asarray(jpre.center_crop_jax(jnp.asarray(resized), size)))
    got = tpre.val_preprocess_float(ft, size, (0.4, 0.45, 0.5),
                                    (0.2, 0.25, 0.3))
    assert got.shape == shape[:-3] + (size, size, 3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jpre.val_preprocess_float(
            fj, size, (0.4, 0.45, 0.5), (0.2, 0.25, 0.3))), atol=PIXEL_ATOL
        * 2.5, rtol=0)


def _jax_chain_draws(key, batch, shape, auto_augment, erase_prob):
    """The decisions of JAX's make_train_augment(...)(key, frames), in its
    order (RandAugment, mirror, erasing), as the port's draws."""
    d = {}
    key, k_aug = jax.random.split(key)
    d["rand_augment"] = _jax_policy_draws(
        k_aug, batch, jra.parse_rand_augment_config(auto_augment))
    key, k_flip = jax.random.split(key)
    d["flip"] = torch.tensor(np.asarray(
        jax.random.bernoulli(k_flip, 0.5, (batch,))).tolist())
    key, k_erase = jax.random.split(key)
    cfg = jre.RandomErasingConfig(probability=erase_prob)
    per = [_jax_erase_draws(k, shape, cfg)
           for k in jax.random.split(k_erase, batch)]
    d["erase"] = {k: torch.cat([p[k] for p in per]) for k in per[0]}
    return d


def test_make_train_augment_chain_matches_jax():
    """The recipe's policy, the mirror and erasing at 0.5 over six uint8
    clips of (2, 16, 16, 3): JAX's jitted augment (as its cli.train runs
    it) against the port's with JAX's draws; the share of values beyond
    1e-5 (the normalize scales by 1 / 0.225) within CHAIN_SHARE."""
    config = "rand-m7-n4-mstd0.5-inc1"
    frames = np.random.RandomState(10).randint(0, 256, (6, 2, 16, 16, 3),
                                               dtype=np.uint8)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    want = np.asarray(jax.jit(jpre.make_train_augment(
        config, True, erase_prob=0.5))(key, jnp.asarray(frames)))
    draws = _jax_chain_draws(key, 6, frames.shape[1:], config, 0.5)
    assert 0 < int(draws["flip"].sum()) < 6
    assert 0 < int(draws["erase"]["apply"].sum()) < 6
    aug = tpre.make_train_augment(config, True, erase_prob=0.5)
    got = aug(None, torch.from_numpy(frames), draws=draws)
    assert _share_far(got.numpy(), want) <= CHAIN_SHARE


def test_augment_draws_depend_on_seed_and_step_alone():
    """With RandAugment and erasing on, step_generator(seed, step) fixes the
    batch: the same step twice gives the same bits, other steps others, and
    `augment.draw` on the same generator state gives the draws augment
    takes itself."""
    frames = torch.from_numpy(np.random.RandomState(11).randint(
        0, 256, (4, 2, 16, 16, 3), dtype=np.uint8))
    aug = tpre.make_train_augment("rand-m7-n4-mstd0.5-inc1", True,
                                  erase_prob=0.25)
    a = aug(tpre.step_generator(0, 5), frames)
    b = aug(tpre.step_generator(0, 5), frames)
    assert torch.equal(a, b)
    assert all(not torch.equal(a, aug(tpre.step_generator(0, s), frames))
               for s in (6, 7))
    assert not torch.equal(a, aug(tpre.step_generator(1, 5), frames))
    d = aug.draw(tpre.step_generator(0, 5), frames.shape, frames.device)
    assert set(d) == {"rand_augment", "flip", "erase"}
    assert torch.equal(aug(None, frames, draws=d), a)
