"""Procedural synthetic tabletop RGB-D scenes (the trainer's own data).

A copy of ``unseenobjectclustering_tpu/data/synthetic.py`` (renderer v4)
for the port, without OpenCV: the one cv2 call of the renderer, the
bilinear resize of the blotch noise, is ``utils/imgproc.resize_linear_f64``,
a numpy replica of ``cv2.resize(INTER_LINEAR)`` on float64 that gives
cv2's bits.
Scenes are a pure function of their index and equal the JAX package's
bit for bit.

A pinhole camera (random tilt and roll) looks down at a textured table
plane over a textured floor, carrying K composite objects (spheres,
oriented boxes, capped cylinders, bowls; stacks, mugs, bottles, lidded
containers, lying cans, plates, pens) with procedural textures, contact
shadows and coloured lighting, ray cast per pixel with a z-buffer.

The device trainer reads raw scenes (``raw=True``: uint8 BGR, uint16
depth in mm, uint8 labels), augmented on the device
(ops/train_pipeline.py); otherwise ``__getitem__`` builds the JAX
package's host-augmented sample (data/augmentation.py, numpy replicas of
its cv2 calls).  Registered as ``synthetic_tabletop_{train,test}``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.data import augmentation
from unseenobjectclustering_torch.data.datasets import (TableTopObject,
                                                        _compute_xyz_np,
                                                        _DatasetBase,
                                                        process_label)
from unseenobjectclustering_torch.utils.imgproc import resize_linear_f64


def _normalize(v):
    return v / max(np.linalg.norm(v), 1e-12)


# Bump to invalidate on-disk scene caches when the renderer changes.
# v3: multi-region object textures (one object, several texture zones —
# teaches the embedding that texture boundaries are not object boundaries),
# flat decal distractors on the table (background-labeled texture
# discontinuities), and specular highlights.
# v4 (modeled on the reference's 9 real RealSense captures, data/demo —
# the docs/REAL_DEMO_EVAL.md sim-to-real gap): concave open bowls, wide-low
# lidded containers, lying cylinders/cans, thin plates and pens (shape
# classes the demo frames contain and v3 never produced), horizontal
# label-band texture splits (real products split at lid/label height, not
# along random planes), table legs (background geometry the low-table demo
# frames show prominently), and low-contrast texture pairs.  RealSense
# depth artifacts (stereo-occlusion edge shadows, glossy blobs, border
# bands) are TRAIN-TIME augmentation (data/augmentation.py,
# ops/train_pipeline.py), not baked into the cache.
RENDER_VERSION = 4


# -- primitive ray intersections (camera at the origin, rays d [H,W,3]) ------
#
# Each helper returns (tt [H,W] float32 ray parameter, inf = miss;
# nrm [H,W,3] unit surface normal, valid where tt is finite).


def _isect_sphere(d, c, r):
    a = (d * d).sum(-1)
    bq = -2.0 * (d @ c)
    cq = np.float32(c @ c - r * r)
    disc = bq * bq - 4.0 * a * cq
    with np.errstate(invalid="ignore"):
        tt = np.where(disc > 0,
                      (-bq - np.sqrt(np.maximum(disc, 0))) / (2 * a),
                      np.inf).astype(np.float32)
        tt = np.where(tt > 0.05, tt, np.inf)
        pt = d * tt[..., None]
        nrm = pt - c[None, None]
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                               1e-9)
    return tt, np.nan_to_num(nrm)


def _isect_box(d, c, axes, half):
    """Oriented box: `axes` [3,3] rows = unit axes, `half` [3] half-extents."""
    ro = -np.stack([c @ axes[0], c @ axes[1], c @ axes[2]])
    rd = np.stack([d @ axes[0], d @ axes[1], d @ axes[2]], axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / rd
    lo = (-half - ro) * inv
    hi = (half - ro) * inv
    tmin = np.minimum(lo, hi).max(axis=-1)
    tmax = np.maximum(lo, hi).min(axis=-1)
    tt = np.where((tmax > tmin) & (tmin > 0.05), tmin,
                  np.inf).astype(np.float32)
    with np.errstate(invalid="ignore"):
        pt_o = ro[None, None] + rd * tt[..., None]
        scale = np.abs(pt_o) / half
    face = np.argmax(np.nan_to_num(scale), axis=-1)
    sgn = np.take_along_axis(np.sign(np.nan_to_num(pt_o)), face[..., None],
                             axis=-1)[..., 0]
    nrm = axes[face] * sgn[..., None]
    return tt, nrm


def _isect_cylinder(d, c, axes, r, hz):
    """Finite cylinder along axes[2] with radius r, half-height hz, capped."""
    ro = -np.stack([c @ axes[0], c @ axes[1], c @ axes[2]])
    rd = np.stack([d @ axes[0], d @ axes[1], d @ axes[2]], axis=-1)
    a = rd[..., 0] ** 2 + rd[..., 1] ** 2
    bq = 2 * (ro[0] * rd[..., 0] + ro[1] * rd[..., 1])
    cq = ro[0] ** 2 + ro[1] ** 2 - r * r
    disc = bq * bq - 4 * a * cq
    with np.errstate(divide="ignore", invalid="ignore"):
        t_side = np.where((disc > 0) & (a > 1e-12),
                          (-bq - np.sqrt(np.maximum(disc, 0))) / (2 * a),
                          np.inf)
        zs = ro[2] + rd[..., 2] * t_side
        t_side = np.where(np.abs(zs) <= hz, t_side, np.inf)
        # both caps; the one facing the camera wins via the min below
        t_caps = np.full(t_side.shape, np.inf, np.float32)
        cap_sign = np.zeros(t_side.shape, np.float32)
        for s in (1.0, -1.0):
            t_cap = (s * hz - ro[2]) / rd[..., 2]
            pu = ro[0] + rd[..., 0] * t_cap
            pv = ro[1] + rd[..., 1] * t_cap
            ok = (pu * pu + pv * pv <= r * r) & (t_cap > 0)
            t_cap = np.where(ok, t_cap, np.inf)
            cap_sign = np.where(t_cap < t_caps, s, cap_sign)
            t_caps = np.minimum(t_caps, t_cap)
    tt = np.minimum(t_side, t_caps).astype(np.float32)
    tt = np.where(tt > 0.05, tt, np.inf)
    side = t_side < t_caps
    with np.errstate(invalid="ignore"):
        pt_o = ro[None, None] + rd * tt[..., None]
        nrm_side = (pt_o[..., 0, None] * axes[0][None, None]
                    + pt_o[..., 1, None] * axes[1][None, None])
        nn = np.linalg.norm(nrm_side, axis=-1, keepdims=True)
        nrm_side = nrm_side / np.maximum(nn, 1e-9)
    nrm_side = np.nan_to_num(nrm_side)
    nrm_cap = axes[2][None, None] * cap_sign[..., None]
    nrm = np.where(side[..., None], nrm_side, nrm_cap)
    return tt, nrm


def _isect_bowl(d, c, axis, r_out, r_in):
    """Open hemispherical bowl (concave!): `c` is the RIM-plane center,
    opening along +axis.  Outer shell = lower hemisphere of radius r_out
    (near sphere hit), inner shell = lower hemisphere of radius r_in seen
    from inside (FAR sphere hit — rays enter through the opening), plus
    the flat rim annulus between the radii at the rim plane.  The demo
    frames carry two or three bowls each (e.g. 000000); v3 had no concave
    geometry at all."""
    tt = np.full(d.shape[:2], np.inf, np.float32)
    nrm = np.zeros(d.shape, np.float32)
    a = (d * d).sum(-1)
    bq = -2.0 * (d @ c)
    for r, pick_far in ((float(r_out), False), (float(r_in), True)):
        cq = np.float32(c @ c - r * r)
        disc = bq * bq - 4.0 * a * cq
        with np.errstate(invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0))
            t = np.where(disc > 0,
                         (-bq + (sq if pick_far else -sq)) / (2 * a),
                         np.inf)
            t = np.where(t > 0.05, t, np.inf).astype(np.float32)
            pt = d * t[..., None]
            below = ((pt - c) @ axis) < 0.0     # lower hemisphere only
            t = np.where(below, t, np.inf)
            ptc = pt - c
            n_s = (-ptc if pick_far else ptc) / max(r, 1e-9)
        closer = t < tt
        tt = np.where(closer, t, tt)
        nrm = np.where(closer[..., None], np.nan_to_num(n_s), nrm)
    dn = d @ axis
    with np.errstate(divide="ignore", invalid="ignore"):
        t_rim = (c @ axis) / np.where(np.abs(dn) < 1e-9, 1e-9, dn)
        pt = d * t_rim[..., None]
        rel = pt - c
        rad = np.linalg.norm(rel - (rel @ axis)[..., None] * axis, axis=-1)
        ok = (t_rim > 0.05) & (rad >= r_in) & (rad <= r_out)
    t_rim = np.where(ok, t_rim, np.inf).astype(np.float32)
    closer = t_rim < tt
    tt = np.where(closer, t_rim, tt)
    nrm = np.where(closer[..., None], axis[None, None].astype(np.float32),
                   nrm)
    return tt, nrm


def _isect_prims(d, prims):
    """Union of primitives: nearest hit wins.  Returns (tt, nrm)."""
    tt = np.full(d.shape[:2], np.inf, np.float32)
    nrm = np.zeros(d.shape, np.float32)
    for p in prims:
        if p["type"] == "sphere":
            t_p, n_p = _isect_sphere(d, p["c"], p["r"])
        elif p["type"] == "box":
            t_p, n_p = _isect_box(d, p["c"], p["axes"], p["half"])
        elif p["type"] == "bowl":
            t_p, n_p = _isect_bowl(d, p["c"], p["axis"], p["r_out"],
                                   p["r_in"])
        else:
            t_p, n_p = _isect_cylinder(d, p["c"], p["axes"], p["r"], p["hz"])
        closer = t_p < tt
        tt = np.where(closer, t_p, tt)
        nrm = np.where(closer[..., None], n_p, nrm)
    return tt, nrm


def _surface_pattern(pt, spec):
    """Procedural scalar texture in [0, 1] from world-space hit points.

    spec: dict with 'kind' in {plain, stripes, checker, marble}, random
    direction vectors u1/u2, frequency f, phase.  Evaluated on masked
    points only (pt is [M, 3]).
    """
    kind = spec["kind"]
    if kind == "plain":
        return np.full(pt.shape[0], 0.0, np.float32)
    a = pt @ spec["u1"] * spec["f"] + spec["phase"]
    if kind == "stripes":
        return (0.5 + 0.5 * np.sin(2 * np.pi * a)).astype(np.float32)
    b = pt @ spec["u2"] * spec["f"]
    if kind == "checker":
        return ((np.floor(a) + np.floor(b)) % 2).astype(np.float32)
    # marble: sinusoid warped by a second sinusoid
    return (0.5 + 0.5 * np.sin(2 * np.pi * a + 3.0 * np.sin(2 * np.pi * b))
            ).astype(np.float32)


def _random_pattern(rng, plain_prob=0.3):
    kinds = ["stripes", "checker", "marble"]
    kind = ("plain" if rng.rand() < plain_prob
            else kinds[rng.randint(len(kinds))])
    u1 = _normalize(rng.randn(3)).astype(np.float32)
    u2 = _normalize(rng.randn(3)).astype(np.float32)
    return {"kind": kind, "u1": u1, "u2": u2,
            "f": np.float32(rng.uniform(15.0, 70.0)),
            "phase": np.float32(rng.uniform(0, 2 * np.pi))}


class SyntheticTabletopDataset(_DatasetBase):
    """Infinite procedural tabletop scenes (deterministic per index)."""

    def __init__(self, image_set: str, cfg: Config,
                 path: Optional[str] = None, base_seed: int = 3,
                 height: Optional[int] = None, width: Optional[int] = None,
                 size: Optional[int] = None, min_objects: Optional[int] = None,
                 max_objects: Optional[int] = None,
                 cache_dir: Optional[str] = None, raw: bool = False):
        super().__init__(cfg, base_seed + (0 if image_set == "train"
                                           else 777_000_001))
        self._name = "synthetic_tabletop_" + image_set
        # `path`, when given, doubles as an on-disk render cache (scenes are
        # a pure function of the index, like TOD's pre-rendered directories)
        self.cache_dir = cache_dir or path
        # raw mode: emit the cached uint8/uint16 scene untouched so the
        # whole augmentation + normalization stack runs on device
        # (ops/train_pipeline.py) — the host is 1 core in this container
        self.raw = raw
        # resolution / count come from the reference's synthetic-data config
        # keys (cfg.TRAIN.SYN_WIDTH/SYN_HEIGHT/SYNNUM/SYN_MIN_OBJECT/...)
        # explicit None checks: 0 is a meaningful value (e.g. min_objects=0
        # allows empty negative scenes) and must not fall through to the
        # cfg default the way a falsy `or` would
        self.h = height if height is not None else int(cfg.TRAIN.SYN_HEIGHT)
        self.w = width if width is not None else int(cfg.TRAIN.SYN_WIDTH)
        size = size if size is not None else int(cfg.TRAIN.SYNNUM)
        self._size = size if image_set == "train" else min(size, 200)
        self.min_objects = (min_objects if min_objects is not None
                            else int(cfg.TRAIN.SYN_MIN_OBJECT))
        self.max_objects = (max_objects if max_objects is not None
                            else int(cfg.TRAIN.SYN_MAX_OBJECT))
        # scenes are a fixed function of the index (a true dataset, like
        # TOD's pre-rendered scenes); only augmentation draws advance with
        # set_epoch.  Renders are memoized up to a BYTE budget (a scene is
        # ~0.12 MB at 240x320 but ~1.84 MB at 480x640 — a fixed count cap
        # would quietly allow tens of GB of host RSS at full resolution),
        # so training is compute-bound instead of renderer-bound from
        # epoch 2 on.
        self._render_cache: dict[int, tuple] = {}
        self._cache_bytes = 0
        self._cache_cap_bytes = 2 << 30   # 2 GiB of memoized scenes
        self._manifest_checked = False
        self.f = 0.5 * self.w  # ~53 deg horizontal FoV
        self.cx, self.cy = self.w / 2.0, self.h / 2.0

    # -- geometry -------------------------------------------------------------

    def _rays(self, roll: float = 0.0):
        if not hasattr(self, "_ray_cache"):
            v, u = np.mgrid[:self.h, :self.w].astype(np.float32)
            d = np.stack([(u - self.cx) / self.f, (v - self.cy) / self.f,
                          np.ones_like(u)], axis=-1).astype(np.float32)
            self._ray_cache = d
        d = self._ray_cache  # unnormalized: t = z-depth along the axis
        if roll:
            cr, sr = np.cos(roll), np.sin(roll)
            d = np.stack([cr * d[..., 0] - sr * d[..., 1],
                          sr * d[..., 0] + cr * d[..., 1],
                          d[..., 2]], axis=-1).astype(np.float32)
        return d

    def _scene_frame(self, rng):
        """Table plane: camera tilted ~25-55 deg looking at the table."""
        tilt = np.radians(rng.uniform(25, 55))
        n = np.array([0.0, -np.cos(tilt), -np.sin(tilt)], np.float32)
        p0 = np.array([0.0, 0.25, rng.uniform(0.6, 0.95)], np.float32)
        t1 = _normalize(np.cross(n, [0.0, 0.0, 1.0]))
        t2 = np.cross(n, t1)
        return n, p0, t1.astype(np.float32), t2.astype(np.float32)

    def _build_object(self, rng, axes):
        """Composite object resting at the local origin: 1-3 primitives.

        Returns (prims with centers relative to the base point, footprint
        radius, height, stackable, band_z).  Kinds mimic common tabletop
        objects (TOD renders ShapeNet mugs/bottles/boxes; README.md:60-66);
        v4 adds the shape classes the real demo frames contain that v3
        never produced: open bowls, wide-low lidded containers, lying
        cylinders (cans on their side), thin plates, and pens.  band_z,
        when not None, is the preferred height of a horizontal texture
        split (lids/label bands — real products split horizontally)."""
        a1, a2, a3 = axes

        def rel(offset):
            return (offset[0] * a1 + offset[1] * a2
                    + offset[2] * a3).astype(np.float32)

        kind = rng.choice(11, p=[0.08, 0.12, 0.10, 0.08, 0.09, 0.07,
                                 0.10, 0.12, 0.08, 0.08, 0.08])
        prims = []
        if kind == 0:      # sphere
            r = np.float32(rng.uniform(0.035, 0.085))
            prims.append({"type": "sphere", "c": rel((0, 0, r)), "r": r})
            return prims, float(r), float(2 * r), False, None
        if kind == 1:      # box
            hx = np.float32(rng.uniform(0.03, 0.085))
            hy = np.float32(rng.uniform(0.03, 0.085))
            hz = np.float32(rng.uniform(0.035, 0.14))
            prims.append({"type": "box", "c": rel((0, 0, hz)), "axes": axes,
                          "half": np.array([hx, hy, hz], np.float32)})
            return prims, float(np.hypot(hx, hy)), float(2 * hz), True, None
        if kind == 2:      # cylinder
            r = np.float32(rng.uniform(0.025, 0.075))
            hz = np.float32(rng.uniform(0.05, 0.14))
            prims.append({"type": "cyl", "c": rel((0, 0, hz)), "axes": axes,
                          "r": r, "hz": hz})
            return prims, float(r), float(2 * hz), True, None
        if kind == 6:      # open bowl (concave)
            r = np.float32(rng.uniform(0.05, 0.11))
            depth_f = rng.uniform(0.55, 1.0)       # squashed hemispheres
            rim_h = np.float32(r * depth_f)
            prims.append({"type": "bowl", "c": rel((0, 0, rim_h)),
                          "axis": a3.astype(np.float32), "r_out": r,
                          "r_in": np.float32(r * rng.uniform(0.82, 0.92))})
            return prims, float(r), float(rim_h), False, None
        if kind == 7:      # wide-low lidded container (storage box)
            hx = np.float32(rng.uniform(0.05, 0.115))
            hy = np.float32(rng.uniform(0.04, 0.09))
            hz = np.float32(rng.uniform(0.022, 0.055))
            prims.append({"type": "box", "c": rel((0, 0, hz)), "axes": axes,
                          "half": np.array([hx, hy, hz], np.float32)})
            lid_h = np.float32(rng.uniform(0.007, 0.016))
            grow = np.float32(rng.uniform(1.03, 1.10))  # lid overhang
            prims.append({"type": "box", "c": rel((0, 0, 2 * hz + lid_h)),
                          "axes": axes,
                          "half": np.array([hx * grow, hy * grow, lid_h],
                                           np.float32)})
            height = float(2 * hz + 2 * lid_h)
            return (prims, float(np.hypot(hx, hy) * grow), height, True,
                    float(2 * hz))                 # split color AT the lid
        if kind == 8:      # lying cylinder (can/bottle on its side)
            r = np.float32(rng.uniform(0.028, 0.06))
            hl = np.float32(rng.uniform(0.05, 0.12))
            axes_l = np.stack([a2, a3, a1]).astype(np.float32)
            prims.append({"type": "cyl", "c": rel((0, 0, r)),
                          "axes": axes_l, "r": r, "hz": hl})
            return prims, float(np.hypot(r, hl)), float(2 * r), False, None
        if kind == 9:      # thin plate / book / flat box
            hx = np.float32(rng.uniform(0.05, 0.12))
            hy = np.float32(rng.uniform(0.04, 0.1))
            hz = np.float32(rng.uniform(0.004, 0.014))
            prims.append({"type": "box", "c": rel((0, 0, hz)), "axes": axes,
                          "half": np.array([hx, hy, hz], np.float32)})
            return prims, float(np.hypot(hx, hy)), float(2 * hz), True, None
        if kind == 10:     # pen / marker: thin long lying cylinder
            r = np.float32(rng.uniform(0.004, 0.009))
            hl = np.float32(rng.uniform(0.05, 0.09))
            axes_l = np.stack([a2, a3, a1]).astype(np.float32)
            prims.append({"type": "cyl", "c": rel((0, 0, r)),
                          "axes": axes_l, "r": r, "hz": hl})
            # cap: small sphere on one end (two-tone pens)
            prims.append({"type": "sphere",
                          "c": rel((float(hl), 0, r)),
                          "r": np.float32(r * 1.15)})
            return prims, float(hl + 2 * r), float(2 * r), False, None
        if kind == 3:      # stack: box base + smaller prim on top
            hx = np.float32(rng.uniform(0.04, 0.085))
            hy = np.float32(rng.uniform(0.04, 0.085))
            hz = np.float32(rng.uniform(0.035, 0.08))
            prims.append({"type": "box", "c": rel((0, 0, hz)), "axes": axes,
                          "half": np.array([hx, hy, hz], np.float32)})
            ju, jv = rng.uniform(-0.01, 0.01, 2)
            top = rng.randint(3)
            if top == 0:
                r2 = np.float32(rng.uniform(0.015, min(hx, hy)))
                prims.append({"type": "sphere",
                              "c": rel((ju, jv, 2 * hz + r2)), "r": r2})
                height = 2 * hz + 2 * r2
            elif top == 1:
                h2 = np.float32(rng.uniform(0.015, 0.05))
                half2 = np.array([rng.uniform(0.015, hx),
                                  rng.uniform(0.015, hy), h2], np.float32)
                prims.append({"type": "box", "c": rel((ju, jv, 2 * hz + h2)),
                              "axes": axes, "half": half2})
                height = 2 * hz + 2 * h2
            else:
                r2 = np.float32(rng.uniform(0.015, min(hx, hy)))
                h2 = np.float32(rng.uniform(0.02, 0.05))
                prims.append({"type": "cyl", "c": rel((ju, jv, 2 * hz + h2)),
                              "axes": axes, "r": r2, "hz": h2})
                height = 2 * hz + 2 * h2
            return prims, float(np.hypot(hx, hy)), float(height), False, None
        if kind == 4:      # mug: cylinder + side handle
            r = np.float32(rng.uniform(0.035, 0.06))
            hz = np.float32(rng.uniform(0.05, 0.095))
            prims.append({"type": "cyl", "c": rel((0, 0, hz)), "axes": axes,
                          "r": r, "hz": hz})
            hw = np.float32(rng.uniform(0.008, 0.014))
            prims.append({"type": "box",
                          "c": rel((r + hw, 0, hz)), "axes": axes,
                          "half": np.array([hw, 0.8 * hw, 0.6 * hz],
                                           np.float32)})
            return prims, float(r + 2 * hw), float(2 * hz), True, None
        # kind == 5: bottle: body + neck + cap sphere
        r = np.float32(rng.uniform(0.03, 0.055))
        hz = np.float32(rng.uniform(0.06, 0.11))
        prims.append({"type": "cyl", "c": rel((0, 0, hz)), "axes": axes,
                      "r": r, "hz": hz})
        rn = np.float32(r * rng.uniform(0.35, 0.55))
        hn = np.float32(rng.uniform(0.015, 0.035))
        prims.append({"type": "cyl", "c": rel((0, 0, 2 * hz + hn)),
                      "axes": axes, "r": rn, "hz": hn})
        prims.append({"type": "sphere", "c": rel((0, 0, 2 * hz + 2 * hn)),
                      "r": np.float32(rn * 1.2)})
        # label band: real bottles split color at label height, not along
        # random planes
        return (prims, float(r), float(2 * hz + 2 * hn + rn), False,
                float(hz * rng.uniform(0.7, 1.6)))

    def render(self, rng) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (bgr uint8 [H,W,3], depth_m float32 [H,W], labels int32)."""
        h, w = self.h, self.w
        d = self._rays(roll=np.radians(rng.uniform(-12, 12)))   # [H,W,3]
        n, p0, t1, t2 = self._scene_frame(rng)

        zbuf = np.full((h, w), np.inf, np.float32)
        labels = np.zeros((h, w), np.int32)
        normal_buf = np.zeros((h, w, 3), np.float32)
        plane_id = np.zeros((h, w), np.int32)  # 0 none, 1 table, 2 floor

        # table plane + infinite floor below it: t = (p . n) / (d . n)
        dn = d @ n
        dn_safe = np.where(np.abs(dn) < 1e-6, -1e-6, dn)
        table_extent = 0.9
        p_floor = (p0 - np.float32(rng.uniform(0.35, 0.8)) * n)
        for pid, pp in ((1, p0), (2, p_floor)):
            t_plane = np.where(dn < -1e-6, (pp @ n) / dn_safe,
                               np.inf).astype(np.float32)
            if pid == 1:
                with np.errstate(invalid="ignore"):
                    rel = d * np.nan_to_num(t_plane, posinf=0.0)[..., None] - pp
                    inside = ((np.abs(rel @ t1) < table_extent)
                              & (np.abs(rel @ t2) < table_extent))
            else:
                inside = True
            hit = (t_plane > 0.05) & (t_plane < zbuf) & inside
            zbuf = np.where(hit, t_plane, zbuf)
            normal_buf[hit] = n
            plane_id = np.where(hit, pid, plane_id)

        # table legs (v4): vertical boxes from the table underside to the
        # floor at the four corners, LABEL 0 — the low-table demo frames
        # (000005-000008) show legs and table-edge geometry prominently and
        # round-4 overlays put spurious instances exactly there
        if rng.rand() < 0.7:
            leg_drop = float((p0 - p_floor) @ n)   # table->floor distance
            leg_half = np.float32(rng.uniform(0.025, 0.05))
            leg_axes = np.stack([t1, t2, n]).astype(np.float32)
            off = table_extent - leg_half - 0.02
            for su in (-1.0, 1.0):
                for sv in (-1.0, 1.0):
                    c_leg = (p0 + su * off * t1 + sv * off * t2
                             - 0.5 * leg_drop * n).astype(np.float32)
                    t_leg, n_leg = _isect_box(
                        d, c_leg, leg_axes,
                        np.array([leg_half, leg_half, leg_drop / 2],
                                 np.float32))
                    hit = t_leg < zbuf
                    zbuf = np.where(hit, t_leg, zbuf)
                    normal_buf[hit] = n_leg[hit]
                    plane_id = np.where(hit, 3, plane_id)

        # -- objects: composite primitives with adjacency / stacking placement
        k = rng.randint(self.min_objects, self.max_objects + 1)
        placed = []   # dicts: cu, cv, foot_r, top_h, stackable
        specs = []    # per-object texture/color specs (index obj-1)
        for obj in range(1, k + 1):
            yaw = rng.uniform(0, np.pi)
            a1 = (np.cos(yaw) * t1 + np.sin(yaw) * t2).astype(np.float32)
            a2 = (-np.sin(yaw) * t1 + np.cos(yaw) * t2).astype(np.float32)
            axes = np.stack([a1, a2, n])
            prims, foot_r, height, stackable, band_z = self._build_object(
                rng, axes)

            mode = rng.rand()
            base_h = 0.0
            supports = [p for p in placed
                        if p["stackable"] and p["foot_r"] >= 0.9 * foot_r]
            if mode < 0.18 and supports:          # stack on a flat-top object
                s = supports[rng.randint(len(supports))]
                jr = 0.3 * max(s["foot_r"] - foot_r, 0.0)
                cu = s["cu"] + rng.uniform(-jr, jr)
                cv_ = s["cv"] + rng.uniform(-jr, jr)
                base_h = s["top_h"]
                s["stackable"] = False
            elif mode < 0.55 and placed:          # touching a placed object
                s = placed[rng.randint(len(placed))]
                th = rng.uniform(0, 2 * np.pi)
                dist = s["foot_r"] + foot_r + rng.uniform(-0.008, 0.02)
                cu = np.clip(s["cu"] + dist * np.cos(th), -0.5, 0.5)
                cv_ = np.clip(s["cv"] + dist * np.sin(th), -0.4, 0.5)
            else:                                 # free placement
                cu = rng.uniform(-0.45, 0.45)
                cv_ = rng.uniform(-0.35, 0.45)

            base = (p0 + cu * t1 + cv_ * t2 + base_h * n).astype(np.float32)
            for p in prims:
                p["c"] = (p["c"] + base).astype(np.float32)
            tt, nrm = _isect_prims(d, prims)
            hit = tt < zbuf
            zbuf = np.where(hit, tt, zbuf)
            labels = np.where(hit, obj, labels)
            normal_buf[hit] = nrm[hit]
            placed.append({"cu": cu, "cv": cv_, "foot_r": foot_r,
                           "top_h": base_h + height, "stackable": stackable})
            c1 = rng.uniform(0.15, 1.0, size=3)
            if rng.rand() < 0.3:   # low-contrast pair: near-plain objects
                c2 = np.clip(c1 * rng.uniform(0.7, 1.3, size=3), 0.05, 1.0)
            else:
                c2 = rng.uniform(0.15, 1.0, size=3)
            spec = {"pattern": _random_pattern(rng),
                    "c1": c1.astype(np.float32),
                    "c2": c2.astype(np.float32), "base": base.copy()}
            # ~60%: a second texture zone on the SAME object — real objects
            # carry labels, lids, multi-material panels; the embedding must
            # not cut them.  v4: the split is HORIZONTAL (lid/label height,
            # the dominant real-product pattern — demo containers split at
            # the lid, bottles at the label) when the object provides a
            # band hint or by a 0.6 coin; random plane otherwise (v3).
            if band_z is not None or rng.rand() < 0.6:
                spec["pattern_b"] = _random_pattern(rng)
                spec["c1b"] = rng.uniform(0.15, 1.0, 3).astype(np.float32)
                spec["c2b"] = rng.uniform(0.15, 1.0, 3).astype(np.float32)
                if band_z is not None or rng.rand() < 0.6:
                    zc = (band_z if band_z is not None
                          else rng.uniform(0.25, 0.75) * height)
                    spec["split_u"] = n.astype(np.float32)
                    spec["split_c"] = np.float32(zc)
                else:
                    spec["split_u"] = _normalize(
                        rng.randn(3)).astype(np.float32)
                    spec["split_c"] = np.float32(rng.uniform(-0.02, 0.02))
            specs.append(spec)

        valid = np.isfinite(zbuf)
        pts = d * np.where(valid, zbuf, 0.0)[..., None]  # world hit points

        # -- surface color: per-object procedural texture ---------------------
        base_col = np.zeros((h, w, 3), np.float32)
        for obj in range(1, k + 1):
            m = labels == obj
            if not m.any():
                continue
            s = specs[obj - 1]
            t = _surface_pattern(pts[m], s["pattern"])[:, None]
            col = s["c1"] * (1.0 - t) + s["c2"] * t
            if "pattern_b" in s:   # second texture zone, same instance label
                tb = _surface_pattern(pts[m], s["pattern_b"])[:, None]
                col_b = s["c1b"] * (1.0 - tb) + s["c2b"] * tb
                side = ((pts[m] - s["base"]) @ s["split_u"]
                        > s["split_c"])[:, None]
                col = np.where(side, col_b, col)
            base_col[m] = col
        # table: base color x multi-octave noise x optional grain pattern
        table_spec = {"pattern": _random_pattern(rng, plain_prob=0.45),
                      "c1": rng.uniform(0.3, 0.95, 3).astype(np.float32),
                      "c2": rng.uniform(0.3, 0.95, 3).astype(np.float32)}
        floor_col1 = rng.uniform(0.1, 0.8, 3).astype(np.float32)
        floor_col2 = rng.uniform(0.1, 0.8, 3).astype(np.float32)
        # legs reuse the table colors slightly darkened (same material)
        leg_spec = {"pattern": table_spec["pattern"],
                    "c1": 0.85 * table_spec["c1"],
                    "c2": 0.85 * table_spec["c2"]}
        for pid, spec in ((1, table_spec), (2, None), (3, leg_spec)):
            m = (plane_id == pid) & (labels == 0)
            if not m.any():
                continue
            if spec is not None:
                t = _surface_pattern(pts[m], spec["pattern"])[:, None]
                col = spec["c1"] * (1.0 - t) + spec["c2"] * t
            else:
                t = _surface_pattern(pts[m], {"kind": "marble",
                                              "u1": _normalize(rng.randn(3)),
                                              "u2": _normalize(rng.randn(3)),
                                              "f": np.float32(4.0),
                                              "phase": 0.0})[:, None]
                col = floor_col1 * (1.0 - t) + floor_col2 * t
            # smooth blotch noise (bilinear-upsampled low-res field)
            tex = resize_linear_f64(rng.rand(h // 32 + 2, w // 32 + 2),
                                     (h, w))
            col = col * (0.8 + 0.4 * tex[m])[:, None]
            base_col[m] = col

        # flat decal distractors on the table: colored elliptical patches
        # (placemats, stains, printed paper) that stay LABEL 0 — texture
        # discontinuities the clustering must not promote to objects
        table_bg = (plane_id == 1) & (labels == 0)
        n_decal = rng.randint(0, 5)
        if n_decal and table_bg.any():
            rel = pts[table_bg] - p0
            uu, vv = rel @ t1, rel @ t2
            col_tb = base_col[table_bg]
            for _ in range(n_decal):
                du, dv = rng.uniform(-0.7, 0.7), rng.uniform(-0.6, 0.7)
                ru = rng.uniform(0.05, 0.3)
                rv = ru * rng.uniform(0.4, 1.6)
                th = rng.uniform(0, np.pi)
                ct, st = np.cos(th), np.sin(th)
                a = ((uu - du) * ct + (vv - dv) * st) / ru
                b = (-(uu - du) * st + (vv - dv) * ct) / rv
                inside = (a * a + b * b) < 1.0
                if not inside.any():
                    continue
                dcol = rng.uniform(0.05, 1.0, 3).astype(np.float32)
                mix = rng.uniform(0.6, 1.0)
                col_tb[inside] = ((1 - mix) * col_tb[inside]
                                  + mix * dcol[None, :])
            base_col[table_bg] = col_tb

        # -- lighting: randomized direction + color, lambertian + shadows -----
        light = _normalize(np.array([rng.uniform(-0.6, 0.6),
                                     rng.uniform(-1.0, -0.3),
                                     rng.uniform(-0.9, -0.2)]))
        light_col = (1.0 + rng.uniform(-0.12, 0.12, 3)).astype(np.float32)
        ambient = rng.uniform(0.35, 0.55)
        lambert = np.clip(-(normal_buf @ light), 0.0, 1.0)
        shade = ambient + (1.0 - ambient) * lambert

        # contact shadows on the support planes (cheap: radial falloff
        # around each object footprint in table coordinates)
        on_plane = (plane_id > 0) & (labels == 0)
        if placed and on_plane.any():
            rel = pts[on_plane] - p0
            uu, vv = rel @ t1, rel @ t2
            sh = np.ones(uu.shape, np.float32)
            for p in placed:
                du = uu - p["cu"]
                dv = vv - p["cv"]
                r_sh = 1.6 * p["foot_r"]
                fall = np.clip(1.0 - np.sqrt(du * du + dv * dv) / r_sh,
                               0.0, 1.0)
                sh = sh * (1.0 - 0.45 * fall * fall)
            shade_pl = shade[on_plane] * sh
            shade[on_plane] = shade_pl

        # specular highlights (Blinn-Phong): glossy real objects carry
        # bright spots that break color constancy within one instance
        dn_hat = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True),
                                1e-9)
        half = -(light[None, None] + dn_hat)
        half /= np.maximum(np.linalg.norm(half, axis=-1, keepdims=True), 1e-9)
        ks = rng.uniform(0.0, 0.55)
        p_exp = rng.uniform(8.0, 40.0)
        spec_hl = ks * np.clip((normal_buf * half).sum(-1), 0.0, 1.0) ** p_exp
        spec_hl = np.where(labels > 0, spec_hl, 0.25 * spec_hl)

        exposure = rng.uniform(1.0, 1.35)
        rgb = ((base_col * shade[..., None] + spec_hl[..., None])
               * light_col * exposure)
        # sky / out-of-scene rays: dark gradient + noise, invalid depth
        if (~valid).any():
            g = (0.02 + 0.08 * (1.0 - np.mgrid[:h, :w][0] / h)
                 + 0.02 * rng.rand(h, w))
            rgb[~valid] = g[~valid][:, None]
        bgr = (np.clip(rgb[..., ::-1], 0, 1) * 255).astype(np.uint8)

        # sensor far clip: real RGB-D cameras return 0 beyond a few meters;
        # this also keeps the uint16 millimeter cache in range
        far = rng.uniform(3.5, 6.0)
        valid = valid & (zbuf < far)
        depth = np.where(valid, zbuf, 0.0).astype(np.float32)
        labels = np.where(valid, labels, 0)
        return bgr, depth, labels

    # -- scene cache (memory -> disk -> render) --------------------------------

    def _scene_path(self, idx: int) -> str:
        import os
        return os.path.join(self.cache_dir,
                            f"{self._name}_{self.h}x{self.w}_v{RENDER_VERSION}",
                            f"{idx:06d}.npz")

    def _check_cache_manifest(self, subdir: str) -> None:
        """Refuse to mix caches rendered under different scene parameters.

        The cache path only encodes name/size/version; base_seed and the
        object-count range also determine scene content, so a params.json
        manifest in the cache subdir pins them.  Mismatch -> error instead
        of silently training on the wrong distribution.  Pre-manifest
        caches (rendered before this check) adopt the current parameters.
        """
        import json
        import os
        if self._manifest_checked:
            return
        params = {"base_seed": int(self.base_seed),
                  "min_objects": int(self.min_objects),
                  "max_objects": int(self.max_objects)}
        mpath = os.path.join(subdir, "params.json")
        if os.path.exists(mpath):
            with open(mpath) as fh:
                on_disk = json.load(fh)
            if on_disk != params:
                raise ValueError(
                    f"render cache {subdir} was created with {on_disk} but "
                    f"this dataset is configured with {params}; point "
                    "cache_dir elsewhere or re-render")
        else:
            os.makedirs(subdir, exist_ok=True)
            import threading
            # pid + thread id: prefetch threads share the pid (see the
            # scene-write note in get_scene)
            tmp = mpath + f".tmp{os.getpid()}_{threading.get_ident()}"
            with open(tmp, "w") as fh:
                json.dump(params, fh)
            os.replace(tmp, mpath)
        # only mark verified on success: a caught mismatch must re-raise on
        # the next call, not silently serve the mismatched cache
        self._manifest_checked = True

    def check_cache_manifest(self) -> None:
        """Public manifest guard for callers that read the cache directly
        (e.g. data.resident.load_resident_scenes) instead of via
        get_scene."""
        import os
        if not self.cache_dir:
            return
        self._check_cache_manifest(os.path.dirname(self._scene_path(0)))

    def get_scene(self, idx: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Deterministic scene for `idx`: (bgr uint8, depth_mm uint16,
        label uint8), already process_label'd.  Rendering is the expensive
        step (~0.8 s at 480x640 on this 1-core host), so scenes are memoized
        in RAM and, when `cache_dir` is set, persisted to disk — the same
        regime as the reference's pre-rendered TOD directories."""
        import os
        cached = self._render_cache.get(idx)
        if cached is not None:
            return cached
        scene = None
        if self.cache_dir:
            p = self._scene_path(idx)
            self._check_cache_manifest(os.path.dirname(p))
            if os.path.exists(p):
                with np.load(p) as z:
                    scene = (z["bgr"], z["depth_mm"], z["label"])
        if scene is None:
            scene_rng = np.random.RandomState(
                (self.base_seed * 7_368_787 + idx) % (2 ** 31 - 1))
            bgr, depth, labels = self.render(scene_rng)
            labels = process_label(labels)
            scene = (bgr, (depth * 1000).astype(np.uint16),
                     labels.astype(np.uint8))
            if self.cache_dir:
                import threading
                p = self._scene_path(idx)
                os.makedirs(os.path.dirname(p), exist_ok=True)
                # pid AND thread id: DataLoader prefetch threads share the
                # pid, and two threads racing on one tmp path would make
                # the second os.replace raise FileNotFoundError
                tmp = p + f".tmp{os.getpid()}_{threading.get_ident()}"
                with open(tmp, "wb") as fh:  # file handle: no .npz suffixing
                    np.savez(fh, bgr=scene[0], depth_mm=scene[1],
                             label=scene[2])
                os.replace(tmp, p)  # atomic: safe under a prerender process
        nbytes = sum(a.nbytes for a in scene)
        if self._cache_bytes + nbytes <= self._cache_cap_bytes:
            self._render_cache[idx] = scene
            self._cache_bytes += nbytes
        return scene

    # -- sample contract --------------------------------------------------------

    def __getitem__(self, idx: int) -> dict:
        """The raw scene of `idx` (raw mode), or the sample the JAX
        package's host pipeline builds from it: depth noise, ellipse
        dropout and GP noise in TRAIN mode, the object-centric crop with
        SYN_CROP, pixel sampling, the chromatic and noise jitter, the
        normalization, all in numpy (no OpenCV)."""
        cfg = self.cfg
        rng = self._rng(idx)  # augmentation stream: (epoch, index)
        bgr, depth_mm, labels8 = self.get_scene(idx)
        if self.raw:
            return {"bgr": bgr, "depth_mm": depth_mm, "label_raw": labels8,
                    "filename": f"synthetic/{idx:08d}"}
        bgr = bgr.copy()
        depth = depth_mm.astype(np.float32) / 1000.0
        labels = labels8.astype(np.int32)

        xyz = None
        if cfg.INPUT in ("DEPTH", "RGBD"):
            if cfg.MODE == "TRAIN":
                depth = augmentation.add_noise_to_depth(
                    depth, augmentation.DEFAULT_NOISE_PARAMS, rng)
                depth = augmentation.dropout_random_ellipses(
                    depth, augmentation.DEFAULT_NOISE_PARAMS, rng)
                if cfg.TRAIN.DEPTH_ARTIFACTS:
                    depth = augmentation.add_realsense_artifacts(depth, rng)
            xyz = _compute_xyz_np(depth, self.f, self.f, self.cx, self.cy)
            if cfg.MODE == "TRAIN":
                xyz = augmentation.add_noise_to_xyz(
                    xyz, depth, augmentation.DEFAULT_NOISE_PARAMS, rng)

        if cfg.TRAIN.SYN_CROP:
            # the object-centric square crop of the TOD loader
            # (tabletop_object.py:175-237)
            bgr, labels, xyz = TableTopObject.pad_crop_resize(
                self, bgr, labels, xyz, rng)
            labels = process_label(labels)

        if cfg.TRAIN.EMBEDDING_SAMPLING and cfg.MODE == "TRAIN":
            labels = TableTopObject.sample_pixels(
                self, labels, int(cfg.TRAIN.EMBEDDING_SAMPLING_NUM), rng)

        bgr = self._maybe_augment_rgb(bgr, rng)
        sample = {
            "label": labels.astype(np.int32),
            "image_color": self._normalize_bgr(bgr),
            "filename": f"synthetic/{idx:08d}",
        }
        if xyz is not None:
            sample["depth"] = xyz.astype(np.float32)
        return sample
