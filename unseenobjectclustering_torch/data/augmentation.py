"""Host data augmentation: RGB chromatic/noise + DexNet-style depth
corruption and the region-refinement mask perturbations.

A copy of ``unseenobjectclustering_tpu/data/augmentation.py`` for the
port: the same draws from the same explicit RandomState in the same order,
so a sample is bit-equal to the JAX package's.  OpenCV is imported inside
each function that calls it (cvtColor, filter2D, resize, ellipse,
warpAffine, morphology): on a machine without it those functions raise
ImportError and nothing stands in for them.  The port's on-device training
augmentation is ops/train_pipeline.py.

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

All functions are host-side numpy/cv2; they run in the loader's prefetch
threads.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

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
    import cv2

    r = _rng(rng)
    delta = (r.rand(3).astype(np.float32) - 0.5) * _HLS_JITTER
    for i, override in enumerate((d_h, d_l, d_s)):
        if override is not None:
            delta[i] = np.asarray(override, np.float32).reshape(())
    hls = cv2.cvtColor(im, cv2.COLOR_BGR2HLS).astype(np.float32) + delta
    hls[..., 0] %= 180.0
    np.clip(hls[..., 1:], 0.0, 255.0, out=hls[..., 1:])
    new_im = cv2.cvtColor(hls.astype(np.uint8), cv2.COLOR_HLS2BGR)
    if label is not None:
        keep = label > 0
        new_im[keep] = im[keep]
    return new_im


_BLUR_SIZES = (3, 5, 7, 9, 11, 15)


def add_noise(image: np.ndarray, level: float = 0.1,
              rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """90% additive Gaussian noise / 10% axis-aligned motion blur on a BGR
    uint8 image (distribution parity with blob.py:102-129)."""
    import cv2

    r = _rng(rng)
    if r.rand() < 0.9:
        sigma = r.rand() * r.uniform(0, level) * 256
        gauss = r.randn(*image.shape[:2]).astype(np.float32) * sigma
        return np.clip(image + gauss[..., None], 0, 255).astype(np.uint8)
    # motion blur: 1-D box filter along a random axis — cv2.filter2D with a
    # line kernel is separable, so run the 1-D kernel directly
    size = _BLUR_SIZES[r.randint(len(_BLUR_SIZES))]
    line = np.full((1, size), 1.0 / size, np.float32)
    kernel = line if r.rand() < 0.5 else line.T
    return cv2.filter2D(image, -1, kernel).astype(np.uint8)


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
    import cv2

    r = _rng(rng)
    h, w, c = xyz_img.shape
    gp = int(noise_params["gp_rescale_factor"])
    field = r.normal(0.0, noise_params["gaussian_scale"],
                     size=(h // gp, w // gp, c))
    field = cv2.resize(field, (w, h),
                       interpolation=cv2.INTER_CUBIC).astype(xyz_img.dtype)
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
    import cv2

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
        cv2.ellipse(canvas, (int(xs[pick[i]]), int(ys[pick[i]])),
                    tuple(radii[i]), angle=int(angles[i]), startAngle=0,
                    endAngle=360, color=1, thickness=-1)
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
    import cv2

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
        field = cv2.resize(r.rand(h // 40 + 2, w // 40 + 2), (w, h),
                           interpolation=cv2.INTER_LINEAR)
        drop |= field > r.uniform(0.80, 0.95)
    # 3. ragged border band
    if r.rand() < 0.5:
        base = r.randint(8, 48)
        jag = cv2.resize(r.rand(h // 16 + 2, 1), (1, h),
                         interpolation=cv2.INTER_LINEAR)[:, 0]
        widths = (base * (0.5 + jag)).astype(int)
        cols = np.arange(w)[None, :]
        band = (cols < widths[:, None] if r.rand() < 0.5
                else cols >= w - widths[:, None])
        drop |= band
    return np.where(drop, 0.0, depth)


# ---------------------------------------------------------------------------
# mask perturbation (region-refinement training mode)
# ---------------------------------------------------------------------------

def _translate(img, tx, ty, interpolation=None):
    import cv2

    if interpolation is None:
        interpolation = cv2.INTER_LINEAR
    h, w = img.shape[:2]
    m = np.array([[1, 0, tx], [0, 1, ty]], dtype=np.float32)
    return cv2.warpAffine(img, m, (w, h), flags=interpolation)


def _rotate(img, angle, interpolation=None):
    import cv2

    if interpolation is None:
        interpolation = cv2.INTER_LINEAR
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w // 2, h // 2), angle, 1)
    return cv2.warpAffine(img, m, (w, h), flags=interpolation)


def _mask_ok(mask: np.ndarray) -> bool:
    return bool(mask.sum() >= 2)


def morph_open_close(mask: np.ndarray, cfg_train,
                     rng: np.random.RandomState) -> np.ndarray:
    """Random erosion/dilation/opening/closing with beta-sampled kernel size
    (augmentation.py:195-240 semantics)."""
    import cv2

    mask = mask.copy()
    h, w = mask.shape
    sidelength = np.mean([h, w])
    for _ in range(int(cfg_train.morphology_max_iters)):
        ksize = int(round(sidelength * rng.beta(
            cfg_train.label_dilation_alpha, cfg_train.label_dilation_beta)))
        ksize = max(ksize, 1)
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize))
        op = rng.randint(4)
        new = cv2.morphologyEx(
            mask.astype(np.uint8),
            [cv2.MORPH_ERODE, cv2.MORPH_DILATE, cv2.MORPH_OPEN,
             cv2.MORPH_CLOSE][op], kernel)
        if _mask_ok(new):
            mask = new
    return mask.astype(mask.dtype)


def random_translation(mask: np.ndarray, cfg_train,
                       rng: np.random.RandomState) -> np.ndarray:
    """Translate by a beta-sampled fraction of the mask extent
    (augmentation.py:309-345 semantics)."""
    import cv2

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
    new = _translate(mask.astype(np.uint8), tx, ty, cv2.INTER_NEAREST)
    return new if _mask_ok(new) else mask


def random_rotation(mask: np.ndarray, cfg_train,
                    rng: np.random.RandomState) -> np.ndarray:
    """Rotate by a uniform angle within +-rotation_angle_max
    (augmentation.py:348-378 semantics)."""
    import cv2

    angle = rng.uniform(-cfg_train.rotation_angle_max,
                        cfg_train.rotation_angle_max)
    new = _rotate(mask.astype(np.uint8), angle, cv2.INTER_NEAREST)
    return new if _mask_ok(new) else mask


def random_ellipses(mask: np.ndarray, cfg_train, rng: np.random.RandomState,
                    add: bool) -> np.ndarray:
    """Add or remove Poisson-many gamma-sized ellipses
    (augmentation.py:242-307 semantics)."""
    import cv2

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
        ell = np.zeros_like(mask)
        ell = cv2.ellipse(ell, (cx, cy), (rx, ry), angle=angle, startAngle=0,
                          endAngle=360, color=1, thickness=-1)
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
    import cv2

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
    piece = _translate(mask, tx, ty, cv2.INTER_NEAREST)
    piece = _rotate(piece, rng.uniform(-10, 10), cv2.INTER_NEAREST)
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
