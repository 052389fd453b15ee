"""The port's training augmentation against the JAX package's, op by op
and for both recipes, under replayed draws.

torch cannot replay jax.random, so each test takes the raw samples a JAX
key makes -- by walking the JAX function's own jax.random.split tree --
and feeds them to the port's apply as its draws.  The two draws the port
takes as uniforms where JAX samples an index from the data (the ellipse
centres, the crop's instance) are converted: the JAX index's rank r of
count becomes u = (r + 0.5) / count.

Tolerances: labels, masks, crop indices and dropped pixels exactly equal;
depth and XYZ within 1e-6 plus 1e-6 of the value (an ulp or two: XLA
compiles the backprojection's division and the upsample's sums in another
order); images
in 0..255 within 2e-3 (the HLS round trip and the blur's convolution sum
in another order), normalized images within 1e-5.

The port's own draws are checked for the properties the JAX package's
tests check (tests/test_train_pipeline.py): exact per-cluster counts,
small clusters kept whole, dropout only on valid depth, GP noise masked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.ops import augment as taug
from unseenobjectclustering_torch.ops import resize as tresize
from unseenobjectclustering_torch.ops import train_pipeline as ttp
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.ops import augment as jaug
from unseenobjectclustering_tpu.ops import resize as jresize
from unseenobjectclustering_tpu.ops import train_pipeline as jtp

torch.set_num_threads(1)

H, W = 32, 48
INTR = (40.0, 40.0, W / 2.0, H / 2.0)
IMG_ATOL = 2e-3
E = jtp.MAX_ELLIPSES


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def scene(seed=0, b=2, h=H, w=W, k=4):
    rng = np.random.RandomState(seed)
    bgr = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    depth = rng.randint(400, 2000, (b, h, w)).astype(np.uint16)
    depth[:, :3] = 0                          # invalid rows
    depth[:, :, -5:] = 0                      # and columns
    label = np.zeros((b, h, w), np.uint8)
    for i in range(b):
        for obj in range(1, k + 1):
            y, x = rng.randint(0, h - 8), rng.randint(0, w - 8)
            label[i, y:y + rng.randint(3, 9), x:x + rng.randint(3, 9)] = obj
        depth[i, label[i] > 0] -= 200         # objects nearer than the table
    return bgr, depth, label


# ---------------------------------------------------------------------------
# replaying a JAX key's samples as the port's draws
# ---------------------------------------------------------------------------

def u(key, shape=()):
    return np.asarray(jax.random.uniform(key, shape))


def chromatic_draws(key):
    k1, k2, k3 = jax.random.split(key, 3)
    return np.array([u(k1), u(k2), u(k3)], np.float32)


def noise_draws(key, h, w):
    k_sel, k_lvl, k_sig, k_noise, k_size, k_dir = jax.random.split(key, 6)
    return {"select": u(k_sel), "level": u(k_lvl), "sigma": u(k_sig),
            "normal": np.asarray(jax.random.normal(k_noise, (h, w, 1))),
            "size": np.asarray(jax.random.randint(k_size, (), 0, 6)),
            "horizontal": u(k_dir)}


def rank_uniform(index, valid):
    """u with floor(u * count) = rank of `index` among the valid pixels."""
    cum = np.cumsum(valid)
    count = max(int(cum[-1]), 1)
    return ((cum[index] - 1 + 0.5) / count).astype(np.float32)


def ellipse_draws(key, depth_m):
    k_num, k_ctr, k_rad, k_ang = jax.random.split(key, 4)
    h, w = depth_m.shape
    valid = (np.asarray(depth_m) > 0).reshape(-1).astype(np.float32)
    probs = valid / max(valid.sum(), 1.0)
    centers = np.asarray(jax.random.choice(k_ctr, h * w, shape=(E,),
                                           p=jnp.asarray(probs)))
    return {"num": np.asarray(jax.random.poisson(
                k_num, jtp.ELLIPSE_DROPOUT_MEAN)).astype(np.float32),
            "center": rank_uniform(centers, valid),
            "radii": np.asarray(jax.random.gamma(
                k_rad, jtp.ELLIPSE_GAMMA_SHAPE, shape=(E, 2))),
            "theta": u(k_ang, (E,))}


def artifact_draws(key, h, w):
    ks = jax.random.split(key, 10)
    return {"shadow_w": np.asarray(jax.random.randint(
                ks[0], (), 2, jtp.MAX_SHADOW_W + 1)),
            "shadow_side": u(ks[1]), "shadow_on": u(ks[2]),
            "blob_field": u(ks[3], (h // 40 + 2, w // 40 + 2, 1))[..., 0],
            "blob_thr": u(ks[4]), "blob_on": u(ks[5]),
            "band_base": np.asarray(jax.random.randint(ks[6], (), 8, 48)),
            "band_jag": u(ks[7], (h // 16 + 2, 1, 1))[:, 0, 0],
            "band_side": u(ks[8]), "band_on": u(ks[9])}


def stack(draws):
    """Per-image draw dicts -> one batched dict of tensors."""
    if isinstance(draws[0], dict):
        return {k: stack([d[k] for d in draws]) for k in draws[0]}
    return t(np.stack([np.asarray(d) for d in draws]))


def recipe_draws(key, cfg, bgr, depth_mm, label, crop=False):
    """The port's draws for a batch, from the JAX recipe's key: only the
    draws the JAX recipe takes for cfg.INPUT (the depth pipeline's for
    DEPTH and RGBD, and always in the crop recipe; the image's for COLOR
    and RGBD), each from the key JAX takes it with."""
    b, h, w = depth_mm.shape
    size = int(cfg.TRAIN.SYN_CROP_SIZE) if crop else None
    oh, ow = (size, size) if crop else (h, w)
    depth = crop or cfg.INPUT in ("DEPTH", "RGBD")
    color = cfg.INPUT in ("COLOR", "RGBD")
    per = []
    for i, k in enumerate(jax.random.split(key, b)):
        ks = jax.random.split(k, 11 if crop else 9)
        d = {}
        if depth:
            d["gamma"] = np.asarray(jax.random.gamma(ks[0], jtp.GAMMA_SHAPE))
            d["ellipses"] = ellipse_draws(ks[1],
                                          depth_mm[i].astype(np.float32))
            if cfg.TRAIN.DEPTH_ARTIFACTS:
                d["artifacts"] = artifact_draws(ks[10 if crop else 8], h, w)
            d["gp"] = np.asarray(jax.random.normal(ks[2],
                                                   (h // 4, w // 4, 3)))
        c0 = 5 if crop else 3
        if color and cfg.TRAIN.CHROMATIC:
            d["chromatic_on"] = u(ks[c0])
            d["chromatic"] = chromatic_draws(ks[c0 + 1])
        if color and cfg.TRAIN.ADD_NOISE:
            d["noise_on"] = u(ks[c0 + 2])
            d["noise"] = noise_draws(ks[c0 + 3], oh, ow)
        if cfg.TRAIN.EMBEDDING_SAMPLING:
            d["sample"] = u(ks[9 if crop else 7], (oh * ow,))
        if crop:
            kk = max(int(label[i].max()), 1)
            pick = int(jax.random.randint(ks[3], (), 0, kk))
            d["pick"] = np.float32((pick + 0.5) / kk)
            d["pad"] = u(ks[4])
        per.append(d)
    return stack(per)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_chromatic_transform_matches_jax():
    bgr = scene(1)[0].astype(np.float32)
    keys = [jax.random.PRNGKey(s) for s in (3, 4)]
    want = np.stack([np.asarray(jaug.chromatic_transform_device(
        jnp.asarray(bgr[i]), k)) for i, k in enumerate(keys)])
    draws = t(np.stack([chromatic_draws(k) for k in keys]))
    got = taug.chromatic_transform_device(t(bgr), draws).numpy()
    np.testing.assert_allclose(got, want, atol=IMG_ATOL)


def test_hls_round_trip_matches_jax():
    bgr = np.random.RandomState(2).rand(7, 9, 3).astype(np.float32) * 255
    bgr[0, :3] = [10.0, 10.0, 10.0]           # grey: no hue
    jh = jaug._bgr_to_hls(jnp.asarray(bgr))
    th = taug._bgr_to_hls(t(bgr))
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
    np.testing.assert_allclose(taug._hls_to_bgr(*th).numpy(),
                               np.asarray(jaug._hls_to_bgr(*jh)), atol=1e-3)


def _key_where(pred, start):
    """The first PRNGKey(s), s >= start, whose noise coin satisfies pred."""
    for s in range(start, start + 500):
        k = jax.random.PRNGKey(s)
        if pred(u(jax.random.split(k, 6)[0])):
            return k
    raise AssertionError("no key found")


@pytest.mark.parametrize("branch", ["gaussian", "motion_blur"])
def test_add_noise_matches_jax(branch):
    bgr = scene(3)[0].astype(np.float32)
    pred = (lambda s: s < 0.9) if branch == "gaussian" else (
        lambda s: s >= 0.9)
    keys = [_key_where(pred, 0), _key_where(pred, 600)]
    want = np.stack([np.asarray(jaug.add_noise_device(
        jnp.asarray(bgr[i]), k)) for i, k in enumerate(keys)])
    draws = stack([noise_draws(k, H, W) for k in keys])
    got = taug.add_noise_device(t(bgr), draws).numpy()
    np.testing.assert_allclose(got, want, atol=IMG_ATOL)


def test_ellipse_dropout_matches_jax():
    _, depth_mm, _ = scene(4)
    depth = depth_mm.astype(np.float32) / 1000.0
    keys = [jax.random.PRNGKey(s) for s in (5, 6)]
    want = np.stack([np.asarray(jtp.dropout_random_ellipses_device(
        jnp.asarray(depth[i]), k)) for i, k in enumerate(keys)])
    draws = stack([ellipse_draws(k, depth[i]) for i, k in enumerate(keys)])
    got = ttp.dropout_random_ellipses_device(t(depth), draws).numpy()
    assert (want == 0).sum() > (depth == 0).sum()   # something dropped
    np.testing.assert_array_equal(got, want)


def test_depth_artifacts_match_jax():
    _, depth_mm, _ = scene(5)
    depth = depth_mm.astype(np.float32) / 1000.0
    keys = [jax.random.PRNGKey(s) for s in (7, 8, 9)]
    depth = np.concatenate([depth, depth[:1]])
    want = np.stack([np.asarray(jtp.add_depth_artifacts_device(
        jnp.asarray(depth[i]), k)) for i, k in enumerate(keys)])
    draws = stack([artifact_draws(k, H, W) for k in keys])
    got = ttp.add_depth_artifacts_device(t(depth), draws).numpy()
    np.testing.assert_array_equal(got, want)


def test_gp_noise_matches_jax():
    _, depth_mm, _ = scene(6)
    depth = depth_mm.astype(np.float32) / 1000.0
    xyz = np.random.RandomState(6).rand(2, H, W, 3).astype(np.float32)
    keys = [jax.random.PRNGKey(s) for s in (10, 11)]
    want = np.stack([np.asarray(jtp.add_gp_noise_to_xyz_device(
        jnp.asarray(xyz[i]), jnp.asarray(depth[i]), k))
        for i, k in enumerate(keys)])
    normal = t(np.stack([np.asarray(jax.random.normal(k, (H // 4, W // 4, 3)))
                         for k in keys]))
    got = ttp.add_gp_noise_to_xyz_device(t(xyz), t(depth), normal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sample_pixels_matches_jax():
    label = np.random.RandomState(7).randint(0, 4, (2, H, W)).astype(np.int32)
    keys = [jax.random.PRNGKey(s) for s in (12, 13)]
    sample = jax.jit(jtp.sample_pixels_device, static_argnums=2)
    want = np.stack([np.asarray(sample(jnp.asarray(label[i]), k, 50))
                     for i, k in enumerate(keys)])
    r = t(np.stack([u(k, (H * W,)) for k in keys]))
    got = ttp.sample_pixels_device(t(label), r, 50).numpy()
    np.testing.assert_array_equal(got, want)


def random_boxes(rng, b, h, w):
    x0 = rng.randint(0, w - 4, b)
    y0 = rng.randint(0, h - 4, b)
    x1 = np.minimum(x0 + rng.randint(3, w, b), w - 1)
    y1 = np.minimum(y0 + rng.randint(3, h, b), h - 1)
    return np.stack([x0, y0, x1, y1], 1).astype(np.int32)


@pytest.mark.parametrize("size", [17, 24])
def test_cv2_crops_match_jax(size):
    rng = np.random.RandomState(size)
    img = rng.rand(6, H, W, 3).astype(np.float32) * 255
    lab = rng.randint(0, 9, (6, H, W)).astype(np.int32)
    boxes = random_boxes(rng, 6, H, W)
    boxes[0] = [0, 0, W - 1, H - 1]
    want_b = np.stack([np.asarray(jtp._crop_bilinear_cv2(
        jnp.asarray(img[i]), jnp.asarray(boxes[i]), size)) for i in range(6)])
    want_n = np.stack([np.asarray(jtp._crop_nearest_cv2(
        jnp.asarray(lab[i]), jnp.asarray(boxes[i]), size)) for i in range(6)])
    got_b = ttp._crop_bilinear_cv2(t(img), t(boxes), size).numpy()
    got_n = ttp._crop_nearest_cv2(t(lab), t(boxes), size).numpy()
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got_b, want_b, atol=IMG_ATOL)


def test_resize_nearest_legacy_matches_jax():
    x = np.random.RandomState(8).randint(0, 9, (2, 13, 17)).astype(np.int32)
    for out_hw in [(26, 34), (7, 9), (13, 40)]:
        np.testing.assert_array_equal(
            tresize.resize_nearest_legacy(t(x), out_hw).numpy(),
            np.asarray(jresize.resize_nearest_legacy(jnp.asarray(x), out_hw)))


# ---------------------------------------------------------------------------
# both recipes
# ---------------------------------------------------------------------------

def configs(input_type="RGBD", **train):
    d = {"INPUT": input_type, "MODE": "TRAIN",
         "TRAIN": dict({"CHROMATIC": True, "ADD_NOISE": True,
                        "EMBEDDING_SAMPLING": True,
                        "EMBEDDING_SAMPLING_NUM": 30}, **train)}
    return jcfg.Config.from_dict(d), tcfg.Config.from_dict(d)


def check_recipe(jout, tout):
    """Labels, XYZ and image of both recipes; an output one recipe leaves
    out (None) the other leaves out too."""
    (ji, jx, jlab), (ti, tx, tlab) = jout, tout
    np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
    assert (tx is None) == (jx is None) and (ti is None) == (ji is None)
    if jx is not None:
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                                   atol=1e-6)
    if ji is not None:
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji),
                                   atol=IMG_ATOL / 255)


def draw_shapes(draws):
    """The tree of a draws dict's names and shapes."""
    if isinstance(draws, dict):
        return {k: draw_shapes(v) for k, v in draws.items()}
    return tuple(draws.shape)


def check_replay(draw, draws, bgr):
    """The replayed draws are exactly the ones the port's own draw takes:
    the same names and shapes, nothing more and nothing less."""
    own = draw(torch.Generator().manual_seed(0), t(bgr))
    assert draw_shapes(draws) == draw_shapes(own)


@pytest.mark.parametrize("input_type, artifacts", [
    pytest.param("RGBD", False, id="False"),
    pytest.param("RGBD", True, id="True"),
    pytest.param("COLOR", False, id="COLOR"),
    pytest.param("DEPTH", True, id="DEPTH")])
def test_full_image_recipe_matches_jax(input_type, artifacts):
    """The recipe under every input: RGB-D with and without depth
    artifacts, COLOR, and DEPTH with artifacts as its recipe trains."""
    jc, tc = configs(input_type, DEPTH_ARTIFACTS=artifacts)
    bgr, depth, label = scene(9, b=3)
    key = jax.random.PRNGKey(21)
    jout = jax.jit(jtp.make_device_augment(
        jc, fx=INTR[0], fy=INTR[1], px=INTR[2], py=INTR[3]))(
        jnp.asarray(bgr), jnp.asarray(depth), jnp.asarray(label), key)
    draw, apply = ttp.make_device_augment(tc, fx=INTR[0], fy=INTR[1],
                                          px=INTR[2], py=INTR[3])
    draws = recipe_draws(key, tc, bgr, depth, label)
    check_replay(draw, draws, bgr)
    tout = apply(t(bgr), t(depth.astype(np.int32)), t(label), draws)
    assert (tout[0] is None) == (input_type == "DEPTH")
    assert (tout[1] is None) == (input_type == "COLOR")
    check_recipe(jout, tout)


def test_crop_recipe_matches_jax():
    jc, tc = configs(SYN_CROP=True, SYN_CROP_SIZE=24)
    bgr, depth, label = scene(10, b=3)
    label[2] = 0                               # no instance: whole image
    key = jax.random.PRNGKey(22)
    jout = jax.jit(jtp.make_device_augment_crop(
        jc, fx=INTR[0], fy=INTR[1], px=INTR[2], py=INTR[3]))(
        jnp.asarray(bgr), jnp.asarray(depth), jnp.asarray(label), key)
    draw, apply = ttp.make_device_augment_crop(tc, fx=INTR[0], fy=INTR[1],
                                               px=INTR[2], py=INTR[3])
    draws = recipe_draws(key, tc, bgr, depth, label, crop=True)
    check_replay(draw, draws, bgr)
    tout = apply(t(bgr), t(depth.astype(np.int32)), t(label), draws)
    assert tout[0].shape == (3, 24, 24, 3)
    check_recipe(jout, tout)


@pytest.mark.parametrize("input_type", ["COLOR", "DEPTH"])
def test_recipe_modalities(input_type):
    cfg = tcfg.Config.from_dict({"INPUT": input_type, "MODE": "TRAIN"})
    draw, apply = ttp.make_device_augment(cfg, fx=INTR[0], fy=INTR[1],
                                          px=INTR[2], py=INTR[3])
    bgr, depth, label = (t(a) for a in scene(11))
    gen = torch.Generator().manual_seed(0)
    image, xyz, lab = apply(bgr, depth.to(torch.int32), label,
                            draw(gen, bgr))
    assert (image is None) == (input_type == "DEPTH")
    assert (xyz is None) == (input_type == "COLOR")
    assert lab.dtype == torch.int32 and lab.shape == (2, H, W)


# ---------------------------------------------------------------------------
# properties of the port's own draws
# ---------------------------------------------------------------------------

def test_sample_pixels_exact_counts():
    label = np.random.RandomState(0).randint(0, 4, (2, 64, 96))
    gen = torch.Generator().manual_seed(1)
    r = ttp.draw_sample_pixels(gen, 2, 64 * 96, "cpu")
    out = ttp.sample_pixels_device(t(label), r, 100).numpy()
    for i in range(2):
        for k in range(4):
            assert int((out[i] == k).sum()) == min(
                int((label[i] == k).sum()), 100)
    sel = out >= 0
    np.testing.assert_array_equal(out[sel], label[sel])


def test_sample_pixels_keeps_small_clusters_whole():
    label = np.zeros((1, 32, 32), np.int64)
    label[0, :3, :3] = 1                       # 9 pixels < num
    r = ttp.draw_sample_pixels(torch.Generator().manual_seed(0), 1, 1024,
                               "cpu")
    out = ttp.sample_pixels_device(t(label), r, 50).numpy()
    assert int((out == 1).sum()) == 9


def test_ellipse_dropout_only_on_valid_depth():
    depth = np.full((2, 96, 128), 1.0, np.float32)
    depth[:, :8] = 0.0
    draws = ttp.draw_ellipses(torch.Generator().manual_seed(3), 2, "cpu")
    out = ttp.dropout_random_ellipses_device(t(depth), draws).numpy()
    assert ((out == 0) | (out == depth)).all()
    assert (out[:, 8:] == 0).any()
    assert (out[:, :8] == 0).all()
    # every live ellipse's centre lies on valid depth
    assert (draws["num"] > 0).all()


def test_gp_noise_is_masked():
    depth = np.zeros((1, 32, 64), np.float32)
    depth[:, 16:] = 1.0
    xyz = np.ones((1, 32, 64, 3), np.float32)
    normal = ttp.draw_gp_noise(torch.Generator().manual_seed(0), 1, 32, 64,
                               3, "cpu")
    out = ttp.add_gp_noise_to_xyz_device(t(xyz), t(depth), normal).numpy()
    np.testing.assert_array_equal(out[:, :16], xyz[:, :16])
    assert not np.array_equal(out[:, 16:], xyz[:, 16:])
    assert np.abs(out - xyz).max() < 0.05
