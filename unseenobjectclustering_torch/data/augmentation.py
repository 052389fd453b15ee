"""Host data augmentation: RGB chromatic/noise + DexNet-style depth
corruption and the region-refinement mask perturbations.

A copy of ``unseenobjectclustering_tpu/data/augmentation.py`` for the
port: the same draws from the same explicit RandomState in the same order,
so a sample is bit-equal to the JAX package's.  The JAX package calls
OpenCV; here each call is a numpy replica in ``utils/imgproc.py`` that
gives cv2's bits (tests/test_torch_imgproc_cv2.py), so the module runs
where OpenCV is missing:

  cv2.cvtColor BGR2HLS / HLS2BGR       -> imgproc.bgr_to_hls / hls_to_bgr
  cv2.filter2D (motion blur)           -> imgproc.filter2d_u8
  cv2.resize INTER_CUBIC (GP noise)    -> imgproc.resize_cubic_f64
  cv2.resize INTER_LINEAR (artifacts)  -> imgproc.resize_linear_f64
  cv2.ellipse (filled)                 -> imgproc.fill_ellipse
  cv2.warpAffine INTER_NEAREST with
  cv2.getRotationMatrix2D              -> imgproc.warp_affine_nearest with
                                          imgproc.rotation_matrix_2d
  cv2.getStructuringElement ELLIPSE,
  cv2.morphologyEx                     -> imgproc.ellipse_kernel,
                                          imgproc.morphology

The port's on-device training augmentation is ops/train_pipeline.py.

The reference's stack (which mutates global numpy/random state from
dataloader workers):

  * chromatic_transform  — HLS jitter (lib/utils/blob.py:74-99)
  * add_noise            — Gaussian or motion blur (lib/utils/blob.py:102-129)
  * add_noise_to_depth   — multiplicative gamma
                           (lib/utils/augmentation.py:58-71)
  * add_noise_to_xyz     — GP additive noise, bicubic-rescaled
                           (lib/utils/augmentation.py:73-90)
  * dropout_random_ellipses — random ellipse dropouts
                           (lib/utils/augmentation.py:92-126)
  * perturb_mask         — the region-refinement mask perturbation suite:
                           erode/dilate, ellipse add/drop, translate, rotate,
                           cut, add (lib/utils/augmentation.py:195-509)

All functions are host-side numpy; they run in the loader's prefetch
threads.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from unseenobjectclustering_torch.utils import imgproc

# lib/datasets/tabletop_object.py:23-55
DEFAULT_NOISE_PARAMS: dict = {
    "gamma_shape": 1000.0,
    "gamma_scale": 0.001,
    "gaussian_scale": 0.005,
    "gp_rescale_factor": 4,
    "ellipse_dropout_mean": 10,
    "ellipse_gamma_shape": 5.0,
    "ellipse_gamma_scale": 1.0,
}


def _rng(rng: Optional[np.random.RandomState]) -> np.random.RandomState:
    return rng if rng is not None else np.random.random.__self__


# ---------------------------------------------------------------------------
# RGB
# ---------------------------------------------------------------------------

# per-channel jitter half-ranges in HLS space: hue +-5% of 180 deg,
# luminosity/saturation +-10% of full scale (distribution parity with
# blob.py:74-99, which draws the same uniform widths)
_HLS_JITTER = np.array([0.1 * 180, 0.2 * 256, 0.2 * 256], np.float32)


def chromatic_transform(im: np.ndarray, label: Optional[np.ndarray] = None,
                        rng: Optional[np.random.RandomState] = None,
                        d_h=None, d_s=None, d_l=None) -> np.ndarray:
    """Random hue/luminosity/saturation jitter on a BGR uint8 image.

    Distribution parity with blob.py:74-99; implemented as one vectorized
    HLS-space add (hue wraps mod 180, L/S clip) rather than per-plane
    split/merge.
    """
    r = _rng(rng)
    delta = (r.rand(3).astype(np.float32) - 0.5) * _HLS_JITTER
    for i, override in enumerate((d_h, d_l, d_s)):
        if override is not None:
            delta[i] = np.asarray(override, np.float32).reshape(())
    hls = imgproc.bgr_to_hls(im).astype(np.float32) + delta
    hls[..., 0] %= 180.0
    np.clip(hls[..., 1:], 0.0, 255.0, out=hls[..., 1:])
    new_im = imgproc.hls_to_bgr(hls.astype(np.uint8))
    if label is not None:
        keep = label > 0
        new_im[keep] = im[keep]
    return new_im


_BLUR_SIZES = (3, 5, 7, 9, 11, 15)


def add_noise(image: np.ndarray, level: float = 0.1,
              rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """90% additive Gaussian noise / 10% axis-aligned motion blur on a BGR
    uint8 image (distribution parity with blob.py:102-129)."""
    r = _rng(rng)
    if r.rand() < 0.9:
        sigma = r.rand() * r.uniform(0, level) * 256
        gauss = r.randn(*image.shape[:2]).astype(np.float32) * sigma
        return np.clip(image + gauss[..., None], 0, 255).astype(np.uint8)
    # motion blur: a 1-D box filter along a random axis
    size = _BLUR_SIZES[r.randint(len(_BLUR_SIZES))]
    line = np.full((1, size), 1.0 / size, np.float32)
    kernel = line if r.rand() < 0.5 else line.T
    return imgproc.filter2d_u8(image, kernel)


# ---------------------------------------------------------------------------
# depth (DexNet-style)
# ---------------------------------------------------------------------------

def add_noise_to_depth(depth_img: np.ndarray, noise_params: Mapping,
                       rng: Optional[np.random.RandomState] = None
                       ) -> np.ndarray:
    """Multiplicative gamma noise (augmentation.py:58-71)."""
    r = _rng(rng)
    mult = r.gamma(noise_params["gamma_shape"], noise_params["gamma_scale"])
    return depth_img * mult


def add_noise_to_xyz(xyz_img: np.ndarray, depth_img: np.ndarray,
                     noise_params: Mapping,
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    """Approximate-GP additive noise: a coarse Gaussian field bicubically
    upscaled to full resolution, applied only where depth is valid
    (distribution parity with augmentation.py:73-90)."""
    r = _rng(rng)
    h, w, c = xyz_img.shape
    gp = int(noise_params["gp_rescale_factor"])
    field = r.normal(0.0, noise_params["gaussian_scale"],
                     size=(h // gp, w // gp, c))
    field = imgproc.resize_cubic_f64(field, (h, w)).astype(xyz_img.dtype)
    return np.where((depth_img > 0)[..., None], xyz_img + field, xyz_img)


def dropout_random_ellipses(depth_img: np.ndarray, noise_params: Mapping,
                            rng: Optional[np.random.RandomState] = None
                            ) -> np.ndarray:
    """Zero out Poisson-many random ellipses (sensor-dropout robustness;
    distribution parity with augmentation.py:92-126).

    All ellipses are rasterized into ONE canvas and applied with a single
    masked store — the reference allocates a fresh full-size mask and
    rescans the image per ellipse.
    """
    r = _rng(rng)
    num = r.poisson(noise_params["ellipse_dropout_mean"])
    ys, xs = np.nonzero(depth_img > 0)
    if ys.size == 0 or num == 0:
        return depth_img.copy()
    pick = r.choice(ys.size, size=num)
    radii = np.rint(r.gamma(noise_params["ellipse_gamma_shape"],
                            noise_params["ellipse_gamma_scale"],
                            size=(num, 2))).astype(int)
    angles = r.randint(0, 360, size=num)
    canvas = np.zeros(depth_img.shape[:2], np.uint8)
    for i in range(num):
        imgproc.fill_ellipse(canvas, (int(xs[pick[i]]), int(ys[pick[i]])),
                             tuple(radii[i]), int(angles[i]), 1)
    return np.where(canvas.astype(bool), 0, depth_img)


def add_realsense_artifacts(depth_img: np.ndarray,
                            rng: Optional[np.random.RandomState] = None
                            ) -> np.ndarray:
    """RealSense-style structured depth dropout (cfg.TRAIN.DEPTH_ARTIFACTS).

    The reference trains on clean TOD depth plus ellipse dropout
    (lib/utils/augmentation.py:92-126) but evaluates and deploys on raw
    RealSense frames (tools/test_images.py:96-102 feeds them unfiltered).
    Measured on the 9 shipped demo captures: 4.6-7.9% of pixels are 0, and
    30-68% of the holes lie within 3 px of a depth edge.  Three modes,
    modeled on those captures:

      1. one-sided stereo-occlusion shadows: a band of missing depth on a
         single horizontal side of every depth discontinuity (the stereo
         camera's IR projector baseline is horizontal),
      2. large low-frequency blobs (glossy/dark surfaces: the demo table
         tops drop out in irregular patches),
      3. a ragged missing band at the left or right image border.

    The device-resident twin is ops/train_pipeline.add_depth_artifacts_device
    (same modes and distributions; keep them in sync)."""
    r = _rng(rng)
    h, w = depth_img.shape[:2]
    depth = depth_img.copy()
    drop = np.zeros((h, w), bool)

    # 1. stereo occlusion shadows at horizontal depth discontinuities
    if r.rand() < 0.8:
        dx = np.abs(np.diff(depth, axis=1, prepend=depth[:, :1]))
        edge = (dx > 0.04) & (depth > 0)
        width = r.randint(2, 13)
        sign = 1 if r.rand() < 0.5 else -1
        shadow = np.zeros((h, w), bool)
        for k in range(1, width + 1):
            shadow |= np.roll(edge, sign * k, axis=1)
        # roll wraps; clip the wrapped columns
        if sign > 0:
            shadow[:, :width] = False
        else:
            shadow[:, -width:] = False
        drop |= shadow
    # 2. low-frequency glossy blobs
    if r.rand() < 0.7:
        field = imgproc.resize_linear_f64(r.rand(h // 40 + 2, w // 40 + 2),
                                          (h, w))
        drop |= field > r.uniform(0.80, 0.95)
    # 3. ragged border band
    if r.rand() < 0.5:
        base = r.randint(8, 48)
        jag = imgproc.resize_linear_f64(r.rand(h // 16 + 2, 1), (h, 1))[:, 0]
        widths = (base * (0.5 + jag)).astype(int)
        cols = np.arange(w)[None, :]
        band = (cols < widths[:, None] if r.rand() < 0.5
                else cols >= w - widths[:, None])
        drop |= band
    return np.where(drop, 0.0, depth)


# ---------------------------------------------------------------------------
# mask perturbation (region-refinement training mode)
# ---------------------------------------------------------------------------

def _translate(img, tx, ty):
    """cv2.warpAffine by (tx, ty), INTER_NEAREST, 0 outside."""
    h, w = img.shape[:2]
    m = np.array([[1, 0, tx], [0, 1, ty]], dtype=np.float32)
    return imgproc.warp_affine_nearest(img, m, (w, h))


def _rotate(img, angle):
    """cv2.warpAffine by getRotationMatrix2D((w // 2, h // 2), angle, 1),
    INTER_NEAREST, 0 outside."""
    h, w = img.shape[:2]
    m = imgproc.rotation_matrix_2d((w // 2, h // 2), angle, 1)
    return imgproc.warp_affine_nearest(img, m, (w, h))


def _mask_ok(mask: np.ndarray) -> bool:
    return bool(mask.sum() >= 2)


def morph_open_close(mask: np.ndarray, cfg_train,
                     rng: np.random.RandomState) -> np.ndarray:
    """Random erosion/dilation/opening/closing with beta-sampled kernel size
    (augmentation.py:195-240 semantics)."""
    mask = mask.copy()
    h, w = mask.shape
    sidelength = np.mean([h, w])
    for _ in range(int(cfg_train.morphology_max_iters)):
        ksize = int(round(sidelength * rng.beta(
            cfg_train.label_dilation_alpha, cfg_train.label_dilation_beta)))
        ksize = max(ksize, 1)
        kernel = imgproc.ellipse_kernel(ksize)
        op = rng.randint(4)
        new = imgproc.morphology(mask.astype(np.uint8),
                                 ("erode", "dilate", "open", "close")[op],
                                 kernel)
        if _mask_ok(new):
            mask = new
    return mask.astype(mask.dtype)


def random_translation(mask: np.ndarray, cfg_train,
                       rng: np.random.RandomState) -> np.ndarray:
    """Translate by a beta-sampled fraction of the mask extent
    (augmentation.py:309-345 semantics)."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return mask
    extent = max(xs.max() - xs.min(), ys.max() - ys.min(), 1)
    pct = max(rng.beta(cfg_train.translation_alpha,
                       cfg_train.translation_beta),
              cfg_train.translation_percentage_min)
    d = int(round(pct * extent))
    tx = rng.randint(-d, d + 1)
    ty = rng.randint(-d, d + 1)
    new = _translate(mask.astype(np.uint8), tx, ty)
    return new if _mask_ok(new) else mask


def random_rotation(mask: np.ndarray, cfg_train,
                    rng: np.random.RandomState) -> np.ndarray:
    """Rotate by a uniform angle within +-rotation_angle_max
    (augmentation.py:348-378 semantics)."""
    angle = rng.uniform(-cfg_train.rotation_angle_max,
                        cfg_train.rotation_angle_max)
    new = _rotate(mask.astype(np.uint8), angle)
    return new if _mask_ok(new) else mask


def random_ellipses(mask: np.ndarray, cfg_train, rng: np.random.RandomState,
                    add: bool) -> np.ndarray:
    """Add or remove Poisson-many gamma-sized ellipses
    (augmentation.py:242-307 semantics)."""
    mask = mask.copy().astype(np.uint8)
    num = rng.poisson(cfg_train.num_ellipses_mean)
    ys, xs = np.nonzero(mask)
    if ys.size == 0 or num == 0:
        return mask
    extent = max(xs.max() - xs.min(), ys.max() - ys.min(), 1)
    for _ in range(num):
        i = rng.randint(ys.size)
        cy, cx = int(ys[i]), int(xs[i])
        rx = max(int(round(rng.gamma(cfg_train.ellipse_gamma_base_shape,
                                     cfg_train.ellipse_gamma_base_scale)
                           * cfg_train.ellipse_size_percentage * extent)), 1)
        ry = max(int(round(rng.gamma(cfg_train.ellipse_gamma_base_shape,
                                     cfg_train.ellipse_gamma_base_scale)
                           * cfg_train.ellipse_size_percentage * extent)), 1)
        angle = rng.randint(0, 360)
        ell = imgproc.fill_ellipse(np.zeros_like(mask), (cx, cy), (rx, ry),
                                   angle, 1)
        new = mask | ell if add else mask & ~ell
        if _mask_ok(new):
            mask = new
    return mask


def random_cut(mask: np.ndarray, cfg_train,
               rng: np.random.RandomState) -> np.ndarray:
    """Cut a random side strip off the mask (augmentation.py:381-429
    semantics)."""
    mask = mask.copy().astype(np.uint8)
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return mask
    x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
    pct = rng.uniform(cfg_train.cut_percentage_min,
                      cfg_train.cut_percentage_max)
    side = rng.randint(4)
    new = mask.copy()
    if side == 0:
        new[:, x0:x0 + int(round(pct * (x1 - x0 + 1)))] = 0
    elif side == 1:
        cut = int(round(pct * (x1 - x0 + 1)))
        new[:, x1 - cut + 1:x1 + 1] = 0
    elif side == 2:
        new[y0:y0 + int(round(pct * (y1 - y0 + 1))), :] = 0
    else:
        cut = int(round(pct * (y1 - y0 + 1)))
        new[y1 - cut + 1:y1 + 1, :] = 0
    return new if _mask_ok(new) else mask


def random_add(mask: np.ndarray, cfg_train,
               rng: np.random.RandomState) -> np.ndarray:
    """Add a translated+rotated copy of the mask next to itself
    (augmentation.py:432-509 semantics)."""
    mask = mask.copy().astype(np.uint8)
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return mask
    extent_x = max(int(xs.max()) - int(xs.min()), 1)
    extent_y = max(int(ys.max()) - int(ys.min()), 1)
    pct = rng.uniform(cfg_train.add_percentage_min,
                      cfg_train.add_percentage_max)
    tx = int(round(pct * extent_x)) * rng.choice([-1, 1])
    ty = int(round(pct * extent_y)) * rng.choice([-1, 1])
    piece = _translate(mask, tx, ty)
    piece = _rotate(piece, rng.uniform(-10, 10))
    new = mask | piece
    return new if _mask_ok(new) else mask


def perturb_mask(mask: np.ndarray, cfg_train,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Full perturbed-mask generator for region-refinement training:
    applies each sub-perturbation with its configured rate
    (augmentation.py:129-192 orchestration semantics, driven by the
    cfg.TRAIN.rate_of_* distribution parameters, lib/fcn/config.py:267-307).
    """
    r = rng if rng is not None else np.random.RandomState()
    out = (mask > 0).astype(np.uint8)
    for _ in range(int(cfg_train.max_augmentation_tries)):
        cand = out.copy()
        if r.rand() < cfg_train.rate_of_morphological_transform:
            cand = morph_open_close(cand, cfg_train, r)
        if r.rand() < cfg_train.rate_of_translation:
            cand = random_translation(cand, cfg_train, r)
        if r.rand() < cfg_train.rate_of_rotation:
            cand = random_rotation(cand, cfg_train, r)
        if r.rand() < cfg_train.rate_of_ellipses:
            cand = random_ellipses(cand, cfg_train, r,
                                   add=bool(r.rand() < 0.5))
        if r.rand() < cfg_train.rate_of_label_cutting:
            cand = random_cut(cand, cfg_train, r)
        if r.rand() < cfg_train.rate_of_label_adding:
            cand = random_add(cand, cfg_train, r)
        if _mask_ok(cand):
            return cand
    return out
