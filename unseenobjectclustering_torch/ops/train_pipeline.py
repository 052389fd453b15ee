"""The training input pipeline on the device: depth noise, ellipse dropout,
RealSense-style depth artifacts, backprojection, GP noise on XYZ, the RGB
jitter and noise, per-cluster pixel sampling, and the object-centric crop
of the zoom-in network's recipe.

Port of ``unseenobjectclustering_tpu/ops/train_pipeline.py`` (reference
lib/datasets/tabletop_object.py:135-306, data/augmentation.py).  The loader
hands over raw scenes (uint8 BGR, uint16 depth in mm, uint8 labels) and
everything else runs on the training device, batched over the images.

Every op is a *draw* from an explicit ``torch.Generator`` and an *apply*
that is deterministic given the draws (see ops/augment.py).  The draws hold
the JAX package's raw samples, so the tests feed the port the draws a JAX
key makes and hold the outputs equal.  Two draws are uniforms where the
JAX package samples an index from the data: the ellipse centres (the
floor(u * count)-th pixel of valid depth, where JAX draws `choice` with
p ∝ valid) and the crop's instance (1 + floor(u * K), where JAX draws
`randint(0, K)`); their distributions are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from unseenobjectclustering_torch.ops.augment import (
    add_noise_device, chromatic_transform_device, draw_chromatic, draw_noise)
from unseenobjectclustering_torch.ops.preprocess import (_div, compute_xyz,
                                                         normalize_bgr)
from unseenobjectclustering_torch.ops.resize import upsample_bilinear
from unseenobjectclustering_torch.ops.roi import _dense_relabel, _reciprocal

# DEFAULT_NOISE_PARAMS (data/augmentation.py / tabletop_object.py:23-55)
GAMMA_SHAPE = 1000.0
GAMMA_SCALE = 0.001
GAUSSIAN_SCALE = 0.005
GP_RESCALE = 4
ELLIPSE_DROPOUT_MEAN = 10.0
ELLIPSE_GAMMA_SHAPE = 5.0
ELLIPSE_GAMMA_SCALE = 1.0
MAX_ELLIPSES = 24          # the Poisson(10) count is clamped here
MAX_SHADOW_W = 12
TWO_PI = float(np.float32(2 * np.pi))


def _uniform_range(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jax.random.uniform(minval=lo, maxval=hi) from its standard uniform
    (the bounds rounded to float32 first, as JAX rounds them)."""
    lo32, span = float(np.float32(lo)), float(np.float32(hi) - np.float32(lo))
    return torch.clamp(u * span + lo32, min=lo32)


def _rand(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def _gamma(gen, shape, alpha: float, device):
    return torch._standard_gamma(
        torch.full(shape, alpha, dtype=torch.float32, device=device), gen)


# ---------------------------------------------------------------------------
# depth
# ---------------------------------------------------------------------------

def draw_ellipses(gen: torch.Generator, batch: int, device
                  ) -> dict[str, torch.Tensor]:
    """Poisson(10) count, MAX_ELLIPSES centre uniforms, gamma(5) radii
    [B, E, 2] and rotation uniforms per image."""
    e = MAX_ELLIPSES
    return {"num": torch.poisson(
                torch.full((batch,), ELLIPSE_DROPOUT_MEAN, device=device),
                gen),
            "center": _rand(gen, (batch, e), device),
            "radii": _gamma(gen, (batch, e, 2), ELLIPSE_GAMMA_SHAPE, device),
            "theta": _rand(gen, (batch, e), device)}


def dropout_random_ellipses_device(depth_m: torch.Tensor,
                                   draws: dict[str, torch.Tensor]
                                   ) -> torch.Tensor:
    """Zero Poisson-many random ellipses centred on valid-depth pixels
    (augmentation.py:92-126): gamma(5, 1) pixel radii, uniform rotation,
    the analytic per-pixel ellipse test.  depth_m [B, H, W]."""
    b, h, w = depth_m.shape
    dev = depth_m.device
    num = torch.clamp(draws["num"], max=MAX_ELLIPSES).to(torch.int64)
    valid = (depth_m > 0).reshape(b, h * w)
    cum = torch.cumsum(valid.to(torch.int64), dim=1)            # [B, HW]
    count = cum[:, -1:]
    target = torch.floor(draws["center"] * count.to(torch.float32)).to(
        torch.int64) + 1
    target = torch.minimum(target, count.clamp(min=1))
    centers = torch.searchsorted(cum, target).clamp(max=h * w - 1)
    cy = torch.div(centers, w, rounding_mode="floor").to(torch.float32)
    cx = torch.remainder(centers, w).to(torch.float32)
    radii = torch.round(draws["radii"] * ELLIPSE_GAMMA_SCALE)
    rx = torch.clamp(radii[..., 0], min=0.5)
    ry = torch.clamp(radii[..., 1], min=0.5)
    theta = draws["theta"] * TWO_PI
    ct, st = torch.cos(theta), torch.sin(theta)

    v = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    inside = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    for e in range(MAX_ELLIPSES):
        col = lambda t: t[:, e, None, None]
        du = u - col(cx)
        dv = v - col(cy)
        a = (du * col(ct) + dv * col(st)) / col(rx)
        bb = (-du * col(st) + dv * col(ct)) / col(ry)
        inside |= (a * a + bb * bb <= 1.0) & (num > e)[:, None, None]
    return torch.where(inside, torch.zeros_like(depth_m), depth_m)


def draw_depth_artifacts(gen: torch.Generator, batch: int, height: int,
                         width: int, device) -> dict[str, torch.Tensor]:
    """The ten draws of add_depth_artifacts_device per image (coins as
    standard uniforms)."""
    return {"shadow_w": torch.randint(2, MAX_SHADOW_W + 1, (batch,),
                                      generator=gen, device=device),
            "shadow_side": _rand(gen, (batch,), device),
            "shadow_on": _rand(gen, (batch,), device),
            "blob_field": _rand(gen, (batch, height // 40 + 2,
                                      width // 40 + 2), device),
            "blob_thr": _rand(gen, (batch,), device),
            "blob_on": _rand(gen, (batch,), device),
            "band_base": torch.randint(8, 48, (batch,), generator=gen,
                                       device=device),
            "band_jag": _rand(gen, (batch, height // 16 + 2), device),
            "band_side": _rand(gen, (batch,), device),
            "band_on": _rand(gen, (batch,), device)}


def add_depth_artifacts_device(depth_m: torch.Tensor,
                               draws: dict[str, torch.Tensor]
                               ) -> torch.Tensor:
    """RealSense-style structured dropout (cfg.TRAIN.DEPTH_ARTIFACTS):
    one-sided stereo-occlusion shadows at horizontal depth edges (coin
    0.8), low-frequency glossy blobs (0.7) and a ragged border band (0.5).
    depth_m [B, H, W]."""
    b, h, w = depth_m.shape
    dev = depth_m.device
    cols = torch.arange(w, device=dev)[None, None, :]
    col_b = lambda t: t[:, None, None]

    # 1. stereo occlusion shadows
    dx = torch.diff(depth_m, dim=2, prepend=depth_m[:, :, :1]).abs()
    edge = (dx > 0.04) & (depth_m > 0)
    left = col_b(draws["shadow_side"] < 0.5)
    shadow = torch.zeros_like(edge)
    for k in range(1, MAX_SHADOW_W + 1):
        live = col_b(draws["shadow_w"] >= k)
        pos = torch.roll(edge, k, dims=2) & (cols >= k)
        neg = torch.roll(edge, -k, dims=2) & (cols < w - k)
        shadow |= torch.where(left, pos, neg) & live
    drop = shadow & col_b(draws["shadow_on"] < 0.8)

    # 2. low-frequency glossy blobs
    field = upsample_bilinear(draws["blob_field"][..., None], (h, w))[..., 0]
    thr = _uniform_range(draws["blob_thr"], 0.80, 0.95)
    drop = drop | ((field > col_b(thr)) & col_b(draws["blob_on"] < 0.7))

    # 3. ragged border band (left or right)
    base = draws["band_base"].to(torch.float32)
    jag = upsample_bilinear(draws["band_jag"][:, :, None, None],
                            (h, 1))[:, :, 0, 0]
    widths = (base[:, None] * (0.5 + jag))[:, :, None]          # [B, H, 1]
    colf = cols.to(torch.float32)
    band = torch.where(col_b(draws["band_side"] < 0.5), colf < widths,
                       colf >= float(w) - widths)
    drop = drop | (band & col_b(draws["band_on"] < 0.5))
    return torch.where(drop, torch.zeros_like(depth_m), depth_m)


def draw_gp_noise(gen: torch.Generator, batch: int, height: int, width: int,
                  channels: int, device) -> torch.Tensor:
    """[B, H/4, W/4, C] standard normals of the coarse GP field."""
    return torch.randn((batch, height // GP_RESCALE, width // GP_RESCALE,
                        channels), generator=gen, device=device)


def add_gp_noise_to_xyz_device(xyz: torch.Tensor, depth_m: torch.Tensor,
                               normal: torch.Tensor) -> torch.Tensor:
    """Coarse Gaussian field (scale 0.005), upsampled bilinearly, added
    where depth is valid (augmentation.py:73-90).  xyz [B, H, W, 3]."""
    h, w = xyz.shape[1:3]
    field = upsample_bilinear(GAUSSIAN_SCALE * normal, (h, w))
    return torch.where((depth_m > 0)[..., None], xyz + field, xyz)


# ---------------------------------------------------------------------------
# labels
# ---------------------------------------------------------------------------

def draw_sample_pixels(gen: torch.Generator, batch: int, n: int, device
                       ) -> torch.Tensor:
    """[B, n] standard uniforms, one per pixel."""
    return _rand(gen, (batch, n), device)


def sample_pixels_device(label: torch.Tensor, r: torch.Tensor,
                         num: int) -> torch.Tensor:
    """Keep at most num random pixels per cluster, the rest -> -1
    (tabletop_object.py:241-254): a stable sort of label + r groups the
    pixels by cluster in a random order, and the rank within the group
    keeps exactly min(count, num).  label [B, H, W] -> int32."""
    b, h, w = label.shape
    n = h * w
    flat = label.reshape(b, n)
    order = torch.argsort(flat.to(torch.float32) + r, dim=1, stable=True)
    sorted_lab = torch.gather(flat, 1, order)
    iota = torch.arange(n, device=label.device).expand(b, n)
    is_new = torch.ones_like(sorted_lab, dtype=torch.bool)
    is_new[:, 1:] = sorted_lab[:, 1:] != sorted_lab[:, :-1]
    group_start = torch.cummax(torch.where(is_new, iota, 0), dim=1).values
    keep_sorted = (iota - group_start) < num
    keep = torch.empty_like(keep_sorted).scatter_(1, order, keep_sorted)
    out = torch.where(keep, flat, torch.full_like(flat, -1))
    return out.reshape(b, h, w).to(torch.int32)


# ---------------------------------------------------------------------------
# the object-centric crop (cv2 conventions)
# ---------------------------------------------------------------------------

def _crop_coords(box: torch.Tensor, size: int):
    """(x0, y0, x1, y1) as [B, 1] int64, the crop's float32 heights and
    widths, and d = arange(size) as float32."""
    x0, y0, x1, y1 = (c[:, None].to(torch.int64) for c in box.unbind(1))
    d = torch.arange(size, dtype=torch.float32, device=box.device)[None]
    ch = (y1 - y0 + 1).to(torch.float32)
    cw = (x1 - x0 + 1).to(torch.float32)
    return x0, y0, x1, y1, ch, cw, d


def _gather2(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
             ) -> torch.Tensor:
    """img[b, ys[b, i], xs[b, j]] -> [B, S, S, ...]."""
    bi = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[bi, ys[:, :, None], xs[:, None, :]]


def _crop_bilinear_cv2(img: torch.Tensor, box: torch.Tensor, size: int
                       ) -> torch.Tensor:
    """img[b, y0:y1+1, x0:x1+1] bilinear-resized to [B, size, size, C] with
    cv2.resize's half-pixel centres (src = (dst + 0.5) * scale - 0.5),
    border replicated.  box [B, 4] int (x0, y0, x1, y1)."""
    h, w = img.shape[1:3]
    x0, y0, x1, y1, ch, cw, d = _crop_coords(box, size)
    d = d + 0.5
    inv = _reciprocal(size).to(img.device)
    ys = y0.to(torch.float32) + d * ch * inv - 0.5
    xs = x0.to(torch.float32) + d * cw * inv - 0.5
    ys = torch.minimum(torch.maximum(ys, y0.to(torch.float32)),
                       y1.to(torch.float32))
    xs = torch.minimum(torch.maximum(xs, x0.to(torch.float32)),
                       x1.to(torch.float32))
    y_lo = torch.floor(ys).to(torch.int64).clamp(0, h - 1)
    y_hi = (y_lo + 1).clamp(0, h - 1)
    x_lo = torch.floor(xs).to(torch.int64).clamp(0, w - 1)
    x_hi = (x_lo + 1).clamp(0, w - 1)
    wy = (ys - y_lo.to(torch.float32))[:, :, None, None]
    wx = (xs - x_lo.to(torch.float32))[:, None, :, None]
    return ((1 - wy) * (1 - wx) * _gather2(img, y_lo, x_lo)
            + (1 - wy) * wx * _gather2(img, y_lo, x_hi)
            + wy * (1 - wx) * _gather2(img, y_hi, x_lo)
            + wy * wx * _gather2(img, y_hi, x_hi))


def _crop_nearest_cv2(img: torch.Tensor, box: torch.Tensor, size: int
                      ) -> torch.Tensor:
    """Crop + nearest resize with cv2's INTER_NEAREST index
    (src = floor(dst * scale)): [B, size, size, ...]."""
    h, w = img.shape[1:3]
    x0, y0, x1, y1, ch, cw, d = _crop_coords(box, size)
    inv = _reciprocal(size).to(img.device)
    ys = (y0 + torch.floor(d * ch * inv).to(torch.int64)).clamp(0, h - 1)
    xs = (x0 + torch.floor(d * cw * inv).to(torch.int64)).clamp(0, w - 1)
    return _gather2(img, ys, xs)


def _crop_boxes(label: torch.Tensor, u_pick: torch.Tensor,
                u_pct: torch.Tensor, pct_min: float, pct_max: float
                ) -> torch.Tensor:
    """The crop box of each image (tabletop_object.py:169-188): a random
    instance's tight box (the whole foreground when there is none),
    squared about its centre, padded by round(side * pct) (25 px when that
    is 0) and clipped.  Returns [B, 4] int64 (x0, y0, x1, y1)."""
    b, h, w = label.shape
    dev = label.device
    k = label.reshape(b, -1).max(dim=1).values                   # [B]
    kk = torch.clamp(k, min=1)
    pick = 1 + torch.minimum(
        torch.floor(u_pick * kk.to(torch.float32)).to(torch.int64), kk - 1)
    fg = torch.where((k > 0)[:, None, None], label == pick[:, None, None],
                     label >= 0)
    ygrid = torch.arange(h, device=dev)[None, :, None].expand(b, h, w)
    xgrid = torch.arange(w, device=dev)[None, None, :].expand(b, h, w)
    big = 1 << 30

    def extreme(grid, fill, fn):
        return fn(torch.where(fg, grid, fill).reshape(b, -1), dim=1).values

    x0 = extreme(xgrid, big, torch.min).to(torch.float32)
    y0 = extreme(ygrid, big, torch.min).to(torch.float32)
    x1 = extreme(xgrid, -big, torch.max).to(torch.float32)
    y1 = extreme(ygrid, -big, torch.max).to(torch.float32)

    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    xd, yd = x1 - x0, y1 - y0
    side = torch.maximum(xd, yd)
    wide = xd > yd
    y0s = torch.where(wide, cy - xd / 2, y0)
    y1s = torch.where(wide, cy + xd / 2, y1)
    x0s = torch.where(wide, x0, cx - yd / 2)
    x1s = torch.where(wide, x1, cx + yd / 2)
    pct = _uniform_range(u_pct, pct_min, pct_max)
    pad = torch.round(side * pct)
    pad = torch.where(pad == 0, torch.full_like(pad, 25.0), pad)
    return torch.stack([
        torch.clamp(torch.floor(x0s - pad), min=0),
        torch.clamp(torch.floor(y0s - pad), min=0),
        torch.clamp(torch.floor(x1s + pad), max=w - 1),
        torch.clamp(torch.floor(y1s + pad), max=h - 1)], dim=1).to(
            torch.int64)


# ---------------------------------------------------------------------------
# the two recipes
# ---------------------------------------------------------------------------

class _Recipe:
    """The config switches both recipes read."""

    def __init__(self, cfg):
        self.input_type = str(cfg.INPUT)
        self.use_chromatic = bool(cfg.TRAIN.CHROMATIC)
        self.use_noise = bool(cfg.TRAIN.ADD_NOISE)
        self.use_artifacts = bool(cfg.TRAIN.DEPTH_ARTIFACTS)
        self.sampling_num = (int(cfg.TRAIN.EMBEDDING_SAMPLING_NUM)
                             if bool(cfg.TRAIN.EMBEDDING_SAMPLING) else 0)
        self.pixel_means = np.asarray(cfg.pixel_means, np.float32)
        self.depth = self.input_type in ("DEPTH", "RGBD")
        self.color = self.input_type in ("COLOR", "RGBD")

    def draw_common(self, gen, b, h, w, oh, ow, dev, full_depth: bool
                    ) -> dict:
        """The draws both recipes share; (h, w) is the scene's size,
        (oh, ow) the output's."""
        out: dict = {}
        if full_depth:
            out["gamma"] = _gamma(gen, (b,), GAMMA_SHAPE, dev)
            out["ellipses"] = draw_ellipses(gen, b, dev)
            if self.use_artifacts:
                out["artifacts"] = draw_depth_artifacts(gen, b, h, w, dev)
            out["gp"] = draw_gp_noise(gen, b, h, w, 3, dev)
        if self.color:
            if self.use_chromatic:
                out["chromatic_on"] = _rand(gen, (b,), dev)
                out["chromatic"] = draw_chromatic(gen, b, dev)
            if self.use_noise:
                out["noise_on"] = _rand(gen, (b,), dev)
                out["noise"] = draw_noise(gen, b, oh, ow, dev)
        if self.sampling_num:
            out["sample"] = draw_sample_pixels(gen, b, oh * ow, dev)
        return out

    def depth_xyz(self, depth_mm, draws, intrinsics):
        """Gamma noise, ellipses, artifacts, backprojection and GP noise:
        XYZ [B, H, W, 3]."""
        depth = _div(depth_mm.to(torch.float32), 1000.0)
        mult = draws["gamma"] * GAMMA_SCALE
        depth = dropout_random_ellipses_device(
            depth * mult[:, None, None], draws["ellipses"])
        if self.use_artifacts:
            depth = add_depth_artifacts_device(depth, draws["artifacts"])
        xyz = compute_xyz(depth, *intrinsics)
        return add_gp_noise_to_xyz_device(xyz, depth, draws["gp"])

    def color_image(self, img, draws):
        """RGB jitter and noise, each with probability 0.9, then
        normalization: [B, H, W, 3] float32."""
        if self.use_chromatic:
            on = (draws["chromatic_on"] > 0.1)[:, None, None, None]
            img = torch.where(on, chromatic_transform_device(
                img, draws["chromatic"]), img)
        if self.use_noise:
            on = (draws["noise_on"] > 0.1)[:, None, None, None]
            img = torch.where(on, add_noise_device(img, draws["noise"]), img)
        return normalize_bgr(img, self.pixel_means)

    def sample(self, label, draws):
        if self.sampling_num:
            return sample_pixels_device(label, draws["sample"],
                                        self.sampling_num)
        return label.to(torch.int32)


def make_device_augment(cfg, *, fx: float, fy: float, px: float, py: float):
    """The full-image recipe (tabletop_object.py:135-155, :241-254,
    :299-306).  Returns (draw, apply):

      draw(gen, bgr_u8) -> draws  (the random numbers for this batch)
      apply(bgr_u8 [B,H,W,3], depth_mm_u16 [B,H,W], label_u8 [B,H,W],
            draws) -> (image, xyz, label)

    image and xyz follow cfg.INPUT (None for DEPTH and COLOR
    respectively); label is int32 with -1 where pixel sampling dropped a
    pixel.
    """
    rec = _Recipe(cfg)
    intrinsics = (fx, fy, px, py)

    def draw(gen: torch.Generator, bgr: torch.Tensor) -> dict:
        b, h, w = bgr.shape[:3]
        return rec.draw_common(gen, b, h, w, h, w, bgr.device, rec.depth)

    def apply(bgr, depth_mm, label_u8, draws):
        xyz = rec.depth_xyz(depth_mm, draws, intrinsics) if rec.depth \
            else None
        image = (rec.color_image(bgr.to(torch.float32), draws) if rec.color
                 else None)
        return image, xyz, rec.sample(label_u8.to(torch.int64), draws)

    return draw, apply


def make_device_augment_crop(cfg, *, fx: float, fy: float, px: float,
                             py: float):
    """The zoom-in network's object-centric crop recipe (cfg.TRAIN.SYN_CROP;
    tabletop_object.py:175-237 pad_crop_resize, then process_label,
    sample_pixels and the RGB recipe).  Per image: the full-image depth
    pipeline and backprojection, a random instance's squared and padded
    box, a crop resized to SYN_CROP_SIZE^2 (bilinear for BGR, nearest for
    labels and XYZ, cv2 conventions), a dense relabel, pixel sampling, RGB
    jitter and normalization.  Like the JAX package it skips the
    reference's retry of a degenerate box (the >= 25 px pad leaves none on
    an image at least 50 px wide).  Returns (draw, apply) as
    make_device_augment does; outputs are [B, S, S, ...].
    """
    rec = _Recipe(cfg)
    intrinsics = (fx, fy, px, py)
    size = int(cfg.TRAIN.SYN_CROP_SIZE)
    pct_min = float(cfg.TRAIN.min_padding_percentage)
    pct_max = float(cfg.TRAIN.max_padding_percentage)

    def draw(gen: torch.Generator, bgr: torch.Tensor) -> dict:
        b, h, w = bgr.shape[:3]
        dev = bgr.device
        out = rec.draw_common(gen, b, h, w, size, size, dev, True)
        out["pick"] = _rand(gen, (b,), dev)
        out["pad"] = _rand(gen, (b,), dev)
        return out

    def apply(bgr, depth_mm, label_u8, draws):
        label = label_u8.to(torch.int64)
        xyz = rec.depth_xyz(depth_mm, draws, intrinsics)
        box = _crop_boxes(label, draws["pick"], draws["pad"], pct_min,
                          pct_max)
        lab_c = _crop_nearest_cv2(label, box, size)
        lab_c = torch.stack([_dense_relabel(l) for l in lab_c]).to(
            torch.int64)
        xyz_c = _crop_nearest_cv2(xyz, box, size) if rec.depth else None
        image = None
        if rec.color:
            img = _crop_bilinear_cv2(bgr.to(torch.float32), box, size)
            image = rec.color_image(img, draws)
        return image, xyz_c, rec.sample(lab_c, draws)

    return draw, apply

