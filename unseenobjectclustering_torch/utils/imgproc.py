"""The OpenCV calls of the port's data path, in numpy, with OpenCV 5.0's
bits (the GPU machine has no OpenCV).

Each function is held bit-equal to ``cv2`` (5.0.0, its IPP HAL and SIMD
dispatch on x86-64) by ``tests/test_torch_imgproc_cv2.py``; where cv2's
result depends on the rounding of a particular code path, the docstring
names the path that was replicated.

  resize_u8, resize_linear_u8  cv2.resize INTER_LINEAR of uint8 (11-bit
                         fixed point; INTER_AREA at exactly half size)
  resize_nearest         cv2.resize INTER_NEAREST of any dtype
  resize_linear_f64      cv2.resize INTER_LINEAR of a 2-D float64 array
  resize_cubic_f64       cv2.resize INTER_CUBIC of float64
  bgr_to_hls, hls_to_bgr cv2.cvtColor COLOR_BGR2HLS / COLOR_HLS2BGR (uint8)
  filter2d_u8            cv2.filter2D(img, -1, k) with a 1 x k or k x 1
                         float32 kernel, BORDER_REFLECT_101
  fill_ellipse           cv2.ellipse(..., thickness=-1), full arc
  fill_poly              cv2.fillPoly(img, [pts], color) of one contour
  rotation_matrix_2d     cv2.getRotationMatrix2D
  warp_affine_nearest    cv2.warpAffine(..., flags=INTER_NEAREST),
                         BORDER_CONSTANT 0
  ellipse_kernel         cv2.getStructuringElement(MORPH_ELLIPSE, (k, k))
  morphology             cv2.morphologyEx erode/dilate/open/close with the
                         default anchor and border
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32
_ONE = 2048  # INTER_RESIZE_COEF_SCALE (11 bits)


def _fma(a, b, c):
    """a * b + c rounded once, in float64 numpy: Dekker's exact product and
    Knuth's exact sum, then one final rounding (the error terms are far
    below half an ulp, so this agrees with a hardware fused multiply-add
    except at an exact tie of probability ~2^-52)."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    sa = a * 134217729.0
    ah = sa - (sa - a)
    al = a - ah
    sb = b * 134217729.0
    bh = sb - (sb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _fma32(a, b, c):
    """A float32 fused multiply-add: the product of two float32s is exact in
    float64, and the sum is rounded to float64 and then to float32 (the
    tests hold every caller to cv2 over all the inputs it takes)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _check_hw(out_hw) -> tuple[int, int]:
    h, w = (int(v) for v in out_hw)
    if h < 1 or w < 1:
        raise ValueError(f"an output size must be positive, got {out_hw}")
    return h, w


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def _coords(n_in: int, n_out: int, inv: float, clamp: bool):
    """OpenCV's generic resize coordinates along one axis: x = (d + 0.5) *
    inv - 0.5 in double, cast to float32; (floor(x), the float32 fraction),
    with the taps past a border moved onto it (fraction 0) if `clamp`."""
    f = ((np.arange(n_out) + 0.5) * inv - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(_F32)
    if clamp:
        f[(s < 0) | (s >= n_in - 1)] = 0.0
    return s, f


def _taps(n_in: int, n_out: int, inv: float, clamp: bool):
    """The two source indices and 11-bit weights of the uint8 path."""
    s, f = _coords(n_in, n_out, inv, clamp)
    w1 = np.rint(f * _F32(_ONE)).astype(np.int64)
    w0 = np.rint((_F32(1.0) - f) * _F32(_ONE)).astype(np.int64)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def _area_half(src: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    s = src.astype(np.int64)[:2 * out_h, :2 * out_w]
    pad = ((0, 2 * out_h - s.shape[0]), (0, 2 * out_w - s.shape[1]))
    cells = np.pad(s, pad + ((0, 0),) * (s.ndim - 2))
    held = np.pad(np.ones(s.shape[:2], np.int64), pad)

    def block_sum(a):
        return a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2]

    total, n = block_sum(cells), block_sum(held)
    n = n.reshape(n.shape + (1,) * (s.ndim - 2))
    partial = np.rint(total.astype(_F32) / n.astype(_F32))
    return np.where(n == 4, (total + 2) >> 2, partial).astype(np.uint8)


def _check_u8(img: np.ndarray, name: str) -> None:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"{name} takes a uint8 [H, W(, C)] image, not "
                         f"{img.dtype} {img.shape}")


def _linear_u8(img: np.ndarray, out_h: int, out_w: int, inv_x: float,
               inv_y: float) -> np.ndarray:
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _taps(w, out_w, inv_x, clamp=True)
    y0, y1, b0, b1 = _taps(h, out_h, inv_y, clamp=False)
    s = img.astype(np.int64).reshape(h, w, -1)
    rows = s[:, x0] * a0[:, None] + s[:, x1] * a1[:, None]
    r0, r1 = rows[y0] >> 4, rows[y1] >> 4
    v = (((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16)
         + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape(
        (out_h, out_w) + img.shape[2:])


def resize_linear_u8(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(img, (w, h)) (INTER_LINEAR) of a uint8 [H, W] or
    [H, W, C] image, bit for bit, as OpenCV 5.0 computes it:

      * an output of the source's size is a copy;
      * at exactly half the size in both axes OpenCV switches to its fast
        INTER_AREA: the mean of each 2x2 block, (sum + 2) >> 2;
      * otherwise fixed-point linear interpolation with 11-bit weights:
        x = (d + 0.5) * (1 / (out / in)) - 0.5 in double, cast to float32;
        weights round((1 - f) * 2048) and round(f * 2048); columns past a
        border are clamped to it with weight (2048, 0), rows are clipped
        by index only (their weights stay fractional).  A row is the int32
        sum of its two taps; the vertical pass is the SIMD one,
        (((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2) >> 2,
        saturated to uint8.
    """
    _check_u8(img, "resize_linear_u8")
    out_h, out_w = _check_hw(out_hw)
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.copy()
    if (h, w) == (2 * out_h, 2 * out_w):
        return _area_half(img, out_h, out_w)
    return _linear_u8(img, out_h, out_w, 1.0 / (out_w / w),
                      1.0 / (out_h / h))


def resize_u8(img: np.ndarray, scale: float) -> np.ndarray:
    """cv2.resize(img, None, fx=scale, fy=scale) of a uint8 [H, W] or
    [H, W, C] image, bit for bit: dsize is (round(w * s), round(h * s)),
    rounded half to even, while the source coordinates step by 1 / s (see
    ``resize_linear_u8`` for the rest)."""
    _check_u8(img, "resize_u8")
    if not scale > 0:
        raise ValueError(f"scale must be positive, got {scale}")
    h, w = img.shape[:2]
    out_h, out_w = int(np.rint(h * scale)), int(np.rint(w * scale))
    if out_h < 1 or out_w < 1:
        raise ValueError(f"a {h}x{w} image at scale {scale} is empty")
    if (out_h, out_w) == (h, w):
        return img.copy()
    if scale == 0.5:
        return _area_half(img, out_h, out_w)
    return _linear_u8(img, out_h, out_w, 1.0 / scale, 1.0 / scale)


def resize_nearest(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST) of an [H, W] or
    [H, W, C] array of any dtype: source index min(floor(d * (1 / (out /
    in))), in - 1) in double."""
    out_h, out_w = _check_hw(out_hw)
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(out_h) * (1.0 / (out_h / h))), h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (1.0 / (out_w / w))), w - 1)
    return img[ys.astype(np.int64)][:, xs.astype(np.int64)]


def _linear_taps(n_in: int, n_out: int):
    """cv2.resize's INTER_LINEAR taps along one axis for float64 images:
    fx = fma(d + 0.5, in/out, -0.5), sx = floor(fx), weight fx - sx,
    clamped at both borders with the weight moved to the border pixel."""
    fx = _fma(np.arange(n_out) + 0.5, n_in / n_out, -0.5)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    low = sx < 0
    fx[low], sx[low] = 0.0, 0
    high = sx >= n_in - 1
    fx[high], sx[high] = 0.0, n_in - 1
    return sx, np.minimum(sx + 1, n_in - 1), fx


def resize_linear_f64(src: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(src, (w, h), interpolation=INTER_LINEAR) of a 2-D float64
    array, with cv2's bits.  OpenCV 5.0 takes one of two paths:

      * a source at least 2 x 2 goes to its IPP resize, which computes the
        taps in double with fused multiply-adds, rows first, then columns,
        each output fma(f, s1 - s0, s0);
      * a source of one row or one column (add_realsense_artifacts' [n, 1]
        band profile) takes OpenCV's generic resize: float32 coordinates
        and weights (1 - f, f), columns clamped at the border with the
        weight moved to it, rows clipped by index only, each output
        s0 * w0 + s1 * w1 in double, rows first.
    """
    h, w = _check_hw(out_hw)
    src = np.asarray(src, np.float64)
    if min(src.shape) < 2:
        x0, x1, a0, a1 = _taps_f32(src.shape[1], w, clamp=True)
        y0, y1, b0, b1 = _taps_f32(src.shape[0], h, clamp=False)
        rows = src[:, x0] * a0 + src[:, x1] * a1
        return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]
    x0, x1, fx = _linear_taps(src.shape[1], w)
    y0, y1, fy = _linear_taps(src.shape[0], h)
    rows = _fma(fx, src[:, x1] - src[:, x0], src[:, x0])
    return _fma(fy[:, None], rows[y1] - rows[y0], rows[y0])


def _taps_f32(n_in: int, n_out: int, clamp: bool):
    """The generic resize's linear taps: float32 weights (1 - f, f) as
    float64."""
    s, f = _coords(n_in, n_out, 1.0 / (n_out / n_in), clamp)
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            (_F32(1) - f).astype(np.float64), f.astype(np.float64))


def _cubic_taps(n_in: int, n_out: int):
    """INTER_CUBIC's four source indices (clamped to the border) and
    float32 weights (A = -0.75) per output index; the coordinate is
    (d + 0.5) * (1 / (out / in)) - 0.5 in double, cast to float32."""
    a = _F32(-0.75)
    s, x = _coords(n_in, n_out, 1.0 / (n_out / n_in), clamp=False)
    one = _F32(1)
    x1 = x + one
    c0 = ((a * x1 - _F32(5) * a) * x1 + _F32(8) * a) * x1 - _F32(4) * a
    c1 = ((a + _F32(2)) * x - (a + _F32(3))) * x * x + one
    y = one - x
    c2 = ((a + _F32(2)) * y - (a + _F32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None], 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], 1).astype(np.float64)


def resize_cubic_f64(src: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(src, (w, h), interpolation=INTER_CUBIC) of a float64
    [H, W] or [H, W, C] array, with cv2's bits: OpenCV's generic cubic
    resize (float32 coefficients, float64 sums, not fused), rows first,
    each output ((s0 * c0 + s1 * c1) + s2 * c2) + s3 * c3, the border
    replicated."""
    h, w = _check_hw(out_hw)
    src = np.asarray(src, np.float64)
    xi, xc = _cubic_taps(src.shape[1], w)
    yi, yc = _cubic_taps(src.shape[0], h)
    tail = (None,) * (src.ndim - 2)
    rows = src[:, xi[:, 0]] * xc[(slice(None), 0) + tail]
    for j in range(1, 4):
        rows = rows + src[:, xi[:, j]] * xc[(slice(None), j) + tail]
    out = rows[yi[:, 0]] * yc[(slice(None), 0, None) + tail]
    for j in range(1, 4):
        out = out + rows[yi[:, j]] * yc[(slice(None), j, None) + tail]
    return out


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

def _sat_u8(v: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def bgr_to_hls(im: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(im, COLOR_BGR2HLS) of a uint8 [..., 3] image (H in
    [0, 180)), bit for bit: OpenCV's SIMD float path.  Channels are scaled
    by float32(1/255); S = diff / (L < 0.5 ? max + min : 2 - (max + min));
    H = fma(x - y, 60 / diff, shift), where (x, y, shift) is (g, b, 0 or
    360 when g < b) if R is the largest, (b, r, 120) if G is, else (r, g,
    240); each channel is rounded half to even and saturated
    (H * 0.5, L * 255, S * 255).  All 2^24 colours are tested."""
    if im.dtype != np.uint8 or im.shape[-1] != 3:
        raise ValueError(f"bgr_to_hls takes uint8 [..., 3], not {im.dtype} "
                         f"{im.shape}")
    x = im.astype(_F32) * _F32(1.0 / 255.0)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    vmax = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = vmax - vmin
    msum = vmax + vmin
    lum = msum * _F32(0.5)
    chroma = diff > np.finfo(_F32).eps
    safe = np.where(chroma, diff, _F32(1))
    sat = np.where(lum < _F32(0.5), diff / np.where(chroma, msum, _F32(1)),
                   diff / np.where(chroma, _F32(2) - msum, _F32(1)))
    r_max, g_max = vmax == r, vmax == g
    num = np.where(r_max, g - b, np.where(g_max, b - r, r - g))
    shift = np.where(r_max, np.where(g < b, _F32(360), _F32(0)),
                     np.where(g_max, _F32(120), _F32(240)))
    hue = _fma32(num, _F32(60) / safe, shift)
    hue = np.where(hue < 0, hue + _F32(360), hue)
    hue = np.where(chroma, hue, _F32(0))
    sat = np.where(chroma, sat, _F32(0))
    return np.stack([_sat_u8(hue * _F32(0.5)), _sat_u8(lum * _F32(255)),
                     _sat_u8(sat * _F32(255))], -1)


_HLS_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])


def hls_to_bgr(im: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(im, COLOR_HLS2BGR) of a uint8 [..., 3] image, bit for
    bit: OpenCV's float formula (H * 6/180 in float32, L and S scaled by
    float32(1/255), p2 = L <= 0.5 ? L * (1 + S) : L + S - L * S, the sector
    table), each channel * 255 rounded half to even.  Every H in [0, 180)
    with every L and S is tested."""
    if im.dtype != np.uint8 or im.shape[-1] != 3:
        raise ValueError(f"hls_to_bgr takes uint8 [..., 3], not {im.dtype} "
                         f"{im.shape}")
    h = im[..., 0].astype(_F32)
    lum = im[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    s = im[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    p2 = np.where(lum <= _F32(0.5), lum * (_F32(1) + s), lum + s - lum * s)
    p1 = _F32(2) * lum - p2
    h = h * _F32(6.0 / 180.0)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(_F32)
    sector %= 6
    tab = np.stack([p2, p1, p1 + (p2 - p1) * (_F32(1) - h),
                    p1 + (p2 - p1) * h], -1)
    out = np.take_along_axis(tab, _HLS_SECTORS[sector], -1)
    out = np.where((s == 0)[..., None], lum[..., None], out)
    return _sat_u8(out * _F32(255))


# ---------------------------------------------------------------------------
# linear filter
# ---------------------------------------------------------------------------

def filter2d_u8(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """cv2.filter2D(img, -1, kernel) of a uint8 [H, W(, C)] image with a
    1 x k or k x 1 float32 kernel (anchor at its centre, BORDER_REFLECT_101),
    bit for bit: OpenCV's SIMD path for 8-bit sources, which accumulates
    the taps in float32 in kernel order with fused multiply-adds, then
    rounds half to even and saturates."""
    _check_u8(img, "filter2d_u8")
    kernel = np.asarray(kernel, _F32)
    if kernel.ndim != 2 or 1 not in kernel.shape:
        raise ValueError(f"filter2d_u8 takes a 1 x k or k x 1 kernel, not "
                         f"{kernel.shape}")
    axis = 1 if kernel.shape[0] == 1 else 0
    taps = kernel.ravel()
    k = taps.size
    anchor = k // 2
    n = img.shape[axis]
    # BORDER_REFLECT_101 indices, folded as often as the kernel needs
    idx = np.arange(-anchor, n + k - 1 - anchor)
    period = 2 * (n - 1)
    if period:
        idx = np.abs(idx) % period
        idx = np.where(idx >= n, period - idx, idx)
    else:
        idx = np.zeros_like(idx)
    src = np.take(img, idx, axis=axis).astype(_F32)
    acc = np.zeros(img.shape, _F32)
    for j in np.flatnonzero(taps):
        tap = np.take(src, np.arange(j, j + n), axis=axis)
        acc = _fma32(tap, taps[j], acc)
    return _sat_u8(acc)


# ---------------------------------------------------------------------------
# drawing: the filled ellipse (ellipse2Poly + FillConvexPoly)
# ---------------------------------------------------------------------------

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
# OpenCV's SinTable: sin(k degrees) to 7 decimals as float32, k = 0..450
_SIN = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(
    _F32).astype(np.float64)


def _c_div(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _ellipse_poly(cx: float, cy: float, ax: float, ay: float, angle: int,
                  delta: int) -> list[tuple[float, float]]:
    """ellipse2Poly (double version) over the full arc."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    alpha, beta = _SIN[450 - angle], _SIN[angle]
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x, y = ax * _SIN[450 - a], ay * _SIN[a]
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    return pts


def _clip_line(w: int, h: int, p1, p2):
    """clipLine on a (w, h) canvas in XY_SHIFT fixed point: (visible, p1,
    p2)."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _put(img, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _line(img, p1, p2, color) -> None:
    """Line2: the 8-connected fixed-point line of an edge."""
    h, w = img.shape[:2]
    visible, (x1, y1), (x2, y2) = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT,
                                             p1, p2)
    if not visible:
        return
    dx, dy = x2 - x1, y2 - y1
    steep = abs(dx) <= abs(dy)
    if not steep:
        if dx < 0:
            dy = -dy
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        x_step, y_step = _XY_ONE, _c_div(dy << _XY_SHIFT, abs(dx) | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        x_step, y_step = _c_div(dx << _XY_SHIFT, abs(dy) | 1), _XY_ONE
        count = (y2 - y1) >> _XY_SHIFT
    half = _XY_ONE >> 1
    x1, y1 = x1 + half, y1 + half
    _put(img, (x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT, color)
    if not steep:
        x1 >>= _XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1, y1 >> _XY_SHIFT, color)
            x1, y1 = x1 + 1, y1 + y_step
    else:
        y1 >>= _XY_SHIFT
        for _ in range(count + 1):
            _put(img, x1 >> _XY_SHIFT, y1, color)
            x1, y1 = x1 + x_step, y1 + 1


def _fill_convex(img, v: list[tuple[int, int]], color) -> None:
    """FillConvexPoly with LINE_8 at XY_SHIFT: every edge drawn by Line2,
    then the scanline fill between the two fixed-point edge walkers."""
    h, w = img.shape[:2]
    delta = _XY_ONE >> 1
    n = len(v)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = v[-1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> _XY_SHIFT, (xmax + delta) >> _XY_SHIFT
    ymin, ymax = (ymin + delta) >> _XY_SHIFT, (ymax + delta) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    # per walker: [idx, di, x, dx, ye]
    walk = [[imin, 1, -_XY_ONE, 0, ymin], [imin, n - 1, -_XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in walk:
            if y < e[4]:
                continue
            idx0, idx = e[0], e[0] + e[1]
            if idx >= n:
                idx -= n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + delta) >> _XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[0], e[2], e[4] = idx, xs, ty
                    e[3] = _c_div((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                    break
                idx0, idx = idx, idx + e[1]
                if idx >= n:
                    idx -= n
        if edges < 0:
            break
        if y >= 0:
            left, right = (walk[1], walk[0]) if walk[0][2] > walk[1][2] \
                else (walk[0], walk[1])
            xx1 = (left[2] + delta) >> _XY_SHIFT
            xx2 = (right[2] + delta) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        walk[0][2] += walk[0][3]
        walk[1][2] += walk[1][3]
        y += 1
        if y > ymax:
            break


def fill_ellipse(img: np.ndarray, center, axes, angle, color) -> np.ndarray:
    """cv2.ellipse(img, center, axes, angle, 0, 360, color, thickness=-1)
    in place (and returned), bit for bit: integer center and axes shifted
    to XY_SHIFT = 16 fixed point, the angle rounded to a degree,
    ellipse2Poly over OpenCV's 7-decimal sine table with a step of 90, 30,
    18 or 5 degrees by the larger axis, the points rounded to fixed point
    (duplicates dropped), then FillConvexPoly (edges by Line2, clipped,
    and the scanline fill).  Radii of 0 and centres off the canvas work as
    in cv2."""
    cx, cy = int(center[0]) << _XY_SHIFT, int(center[1]) << _XY_SHIFT
    ax, ay = abs(int(axes[0])) << _XY_SHIFT, abs(int(axes[1])) << _XY_SHIFT
    big = (max(ax, ay) + (_XY_ONE >> 1)) >> _XY_SHIFT
    delta = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    pts = _ellipse_poly(float(cx), float(cy), float(ax), float(ay),
                        int(np.rint(angle)), delta)
    v: list[tuple[int, int]] = []
    for x, y in pts:
        px = int(np.rint(x / _XY_ONE)) << _XY_SHIFT
        py = int(np.rint(y / _XY_ONE)) << _XY_SHIFT
        p = (px + int(np.rint(x - px)), py + int(np.rint(y - py)))
        if not v or p != v[-1]:
            v.append(p)
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    _fill_convex(img, v, color)
    return img


def _line8(img, p1, p2, color) -> None:
    """Line with LINE_8 between two points on the image: LineIterator's
    8-connected Bresenham walk, left to right."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        step = err < 0
        err += -(dy + dy) + (dx + dx if step else 0)
        if vert:
            y += sy
            x += sx if step else 0
        else:
            x += sx
            y += sy if step else 0


class _PolyEdge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0=0, y1=0, x=0, dx=0):
        self.y0, self.y1, self.x, self.dx = y0, y1, x, dx
        self.next = None


def _fill_edges(img, edges: list, color) -> None:
    """FillEdgeCollection with LINE_8 for edges on the image: the active
    edge list walked row by row, spans filled between its pairs (their
    fixed-point ends rounded inwards), then bubble-sorted by x."""
    total = len(edges)
    if total < 2:
        return
    y_max = max(e.y1 for e in edges)
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx))
    edges.append(_PolyEdge(y0=2 ** 31 - 1))
    head = _PolyEdge()
    i = 0
    e = edges[0]
    for y in range(e.y0, y_max):
        draw = False
        prelast, last = head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:
                prelast.next = last = last.next
                continue
            keep_prelast = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:
                prelast.next = e
                e.next = last
                prelast = e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                a, b = sorted((keep_prelast.x, prelast.x))
                # the span's ends rounded inwards
                img[y, (a + _XY_ONE - 1) >> _XY_SHIFT:(b >> _XY_SHIFT) + 1] \
                    = color
                keep_prelast.x += keep_prelast.dx
                prelast.x += prelast.dx
            draw = not draw
        # bubble sort of the active list by x (stable)
        keep = None
        while True:
            prelast, last = head, head.next
            exchanged = None
            while last is not keep and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next = te
                    last.next = te.next
                    te.next = last
                    prelast = te
                    exchanged = prelast
                else:
                    prelast, last = last, te
            if exchanged is None:
                break
            keep = exchanged
            if keep is head.next or keep is head:
                break


def fill_poly(img: np.ndarray, pts, color) -> np.ndarray:
    """cv2.fillPoly(img, [pts], color) in place (and returned), bit for
    bit, for one contour of integer [x, y] vertices that all lie on the
    canvas, of any shape (non-convex, self-intersecting, degenerate):
    LINE_8, shift 0; each edge drawn by Line (LineIterator's 8-connected
    walk) and collected as a fixed-point PolyEdge, then
    FillEdgeCollection's scanline fill.  A vertex off the canvas raises
    ValueError (cv2 clips such polygons in a way not replicated here)."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    off = [p for p in v if not (0 <= p[0] < w and 0 <= p[1] < h)]
    if off:
        raise ValueError(f"fill_poly takes vertices on the {w}x{h} canvas, "
                         f"not {off[:3]}")
    edges = []
    x0, y0 = v[-1]
    for x1, y1 in v:
        _line8(img, (x0, y0), (x1, y1), color)
        if y0 != y1:
            dx = _c_div((x1 - x0) << _XY_SHIFT, y1 - y0)
            if y0 < y1:
                edges.append(_PolyEdge(y0, y1, x0 << _XY_SHIFT, dx))
            else:
                edges.append(_PolyEdge(y1, y0, x1 << _XY_SHIFT, dx))
        x0, y0 = x1, y1
    _fill_edges(img, edges, color)
    return img


# ---------------------------------------------------------------------------
# affine warp (nearest)
# ---------------------------------------------------------------------------

def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale): [2, 3] float64 (the
    centre as float32, the angle times (pi / 180))."""
    cx, cy = float(_F32(center[0])), float(_F32(center[1]))
    rad = angle * (math.pi / 180)
    # the C library's cos and sin, as OpenCV's std::cos and std::sin
    alpha, beta = math.cos(rad) * scale, math.sin(rad) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine_nearest(src: np.ndarray, m, dsize) -> np.ndarray:
    """cv2.warpAffine(src, m, dsize, flags=INTER_NEAREST) with
    BORDER_CONSTANT 0, bit for bit: OpenCV 5.0's warp kernel, which
    inverts m in double (invertAffineTransform), casts the inverse to
    float32 and maps each output pixel (x, y) to
    rint(fma(M0, x, M1 * y + M2)), rint(fma(M3, x, M4 * y + M5)) in
    float32 (the row terms not fused), rounded half to even; a source
    outside the image reads 0.  (Not the AB_BITS fixed point of OpenCV
    4: it maps a coordinate within 1e-3 of .5 the other way.)"""
    w, h = (int(v) for v in dsize)
    m = np.asarray(m, np.float64).ravel()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = m[4] * det, m[0] * det, -m[1] * det, -m[3] * det
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    i = np.array([a11, a12, b1, a21, a22, b2]).astype(_F32)
    x = np.arange(w, dtype=_F32)[None, :]
    y = np.arange(h, dtype=_F32)[:, None]
    sx = np.rint(_fma32(i[0], x, i[1] * y + i[2]))
    sy = np.rint(_fma32(i[3], x, i[4] * y + i[5]))
    sh, sw = src.shape[:2]
    inside = (sx >= 0) & (sx < sw) & (sy >= 0) & (sy < sh)
    xs = np.clip(sx, 0, sw - 1).astype(np.int64)
    ys = np.clip(sy, 0, sh - 1).astype(np.int64)
    out = src[ys, xs]
    out[~inside] = 0
    return out


# ---------------------------------------------------------------------------
# morphology
# ---------------------------------------------------------------------------

def ellipse_kernel(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (ksize, ksize)): row i
    spans c -+ round(c * sqrt((r^2 - dy^2) / r^2)) with r = c = ksize // 2
    (1 x 1 is a rectangle)."""
    k = int(ksize)
    if k < 1:
        raise ValueError(f"ksize must be positive, got {ksize}")
    out = np.zeros((k, k), np.uint8)
    if k == 1:
        out[:] = 1
        return out
    r = c = k // 2
    inv_r2 = 1.0 / (r * r)
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            out[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    return out


def _erode_or_dilate(img: np.ndarray, kernel: np.ndarray, dilate: bool
                     ) -> np.ndarray:
    """min (erode) or max (dilate) of img[y + i - ay, x + j - ax] over the
    kernel's cells, anchor at the centre; cells outside the image are left
    out (cv2's default border value)."""
    fn = np.maximum if dilate else np.minimum
    fill = np.iinfo(img.dtype).min if dilate else np.iinfo(img.dtype).max
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = img.shape
    out = np.full((h, w), fill, img.dtype)
    spans = {}
    for i in range(kh):
        cols = np.flatnonzero(kernel[i])
        if cols.size == 0:
            continue
        j1, j2 = int(cols[0]), int(cols[-1]) + 1
        if cols.size != j2 - j1:
            raise ValueError("morphology takes kernels whose rows are runs")
        key = (j1, j2)
        if key not in spans:
            spans[key] = _shifted_window(img, j1 - ax, j2 - j1, fn, fill)
        band = spans[key]
        dy = i - ay  # out[y] takes band[y + dy]
        if abs(dy) >= h:
            continue
        ys, yd = slice(max(0, dy), min(h, h + dy)), \
            slice(max(0, -dy), min(h, h - dy))
        out[yd] = fn(out[yd], band[ys])
    return out


def _shifted_window(img: np.ndarray, start: int, length: int, fn, fill
                    ) -> np.ndarray:
    """out[:, x] = fn over img[:, x + start : x + start + length], cells
    past the border reading `fill` (van Herk / Gil-Werman: two cumulative
    passes per block of `length`)."""
    h, w = img.shape
    n_blocks = -(-(w + length) // length)
    total = n_blocks * length
    pad = np.full((h, total + length), fill, img.dtype)
    # pad[:, p] = img[:, p + start] where that exists
    p0 = max(0, -start)
    s0 = max(0, start)
    n = max(0, min(w - s0, total + length - p0))
    pad[:, p0:p0 + n] = img[:, s0:s0 + n]
    blocks = pad[:, :total].reshape(h, n_blocks, length)
    prefix = fn.accumulate(blocks, axis=2).reshape(h, total)
    suffix = fn.accumulate(blocks[:, :, ::-1], axis=2)[:, :, ::-1].reshape(
        h, total)
    x = np.arange(w)
    return fn(suffix[:, x], prefix[:, x + length - 1])


_MORPH_OPS = ("erode", "dilate", "open", "close")


def morphology(src: np.ndarray, op: str, kernel: np.ndarray) -> np.ndarray:
    """cv2.morphologyEx(src, MORPH_<op>, kernel) of a 2-D uint8 array with
    the default anchor (the kernel's centre), one iteration and the default
    border (which leaves outside cells out of the min / max); op is
    "erode", "dilate", "open" or "close"."""
    if op not in _MORPH_OPS:
        raise ValueError(f"op must be one of {_MORPH_OPS}, got {op!r}")
    if src.dtype != np.uint8 or src.ndim != 2:
        raise ValueError(f"morphology takes a 2-D uint8 array, not "
                         f"{src.dtype} {src.shape}")
    kernel = np.asarray(kernel) != 0
    first = op in ("dilate", "close")
    out = _erode_or_dilate(src, kernel, dilate=first)
    if op in ("open", "close"):
        out = _erode_or_dilate(out, kernel, dilate=not first)
    return out
