"""Dataset classes: TableTopObject (synthetic train), OCIDObject, OSDObject.

Port of ``unseenobjectclustering_tpu/data/datasets.py`` (reference
lib/datasets/{tabletop_object,ocid_object,osd_object}.py): samples are
numpy NHWC float32 dicts {'image_color' [H,W,3] normalized BGR, 'depth'
[H,W,3] XYZ, 'label' [H,W] int32, 'filename'}, per-sample randomness comes
from a RandomState of (base_seed, index, epoch), and a sample is bit-equal
to the JAX package's.

What each reader needs on the machine it runs on: OCID and OSD read their
PNGs through ``utils/png.py`` and their PCDs through ``data/pcd.py``
(numpy, zlib and the native LZF library), so they run where PIL and
OpenCV are missing.  TableTopObject reads its ``rgb_*.jpeg`` with
``cv2.imread`` (there is no JPEG decoder here) and its PNGs with
``utils/png.py``; its training crops resize with cv2.  The TRAIN-mode
augmentations (``data/augmentation.py``) need OpenCV too.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Optional

import numpy as np

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.data import augmentation
from unseenobjectclustering_torch.data.pcd import load_pcd_xyz
from unseenobjectclustering_torch.utils import png
from unseenobjectclustering_torch.utils.masks import (imread_indexed,
                                                      mask_to_tight_box)

# lib/datasets/tabletop_object.py:23-55
TOD_PARAMS = {
    "img_width": 640,
    "img_height": 480,
    "near": 0.01,
    "far": 100,
    "fov": 45,
    "use_data_augmentation": True,
    **augmentation.DEFAULT_NOISE_PARAMS,
}


def process_label(foreground_labels: np.ndarray) -> np.ndarray:
    """Remap arbitrary ids to {0..K-1} preserving order
    (tabletop_object.py:158-172)."""
    unique = np.unique(foreground_labels)
    mapped = np.searchsorted(unique, foreground_labels)
    return mapped.astype(foreground_labels.dtype)


def _compute_xyz_np(depth_m: np.ndarray, fx: float, fy: float, px: float,
                    py: float) -> np.ndarray:
    # ops.preprocess imports torch: imported here so that the renderer's
    # numpy-only worker processes, which import this module, start without
    from unseenobjectclustering_torch.ops.preprocess import compute_xyz_np

    return compute_xyz_np(depth_m, fx, fy, px, py)


class _DatasetBase:
    """Common surface: len(), indexing, name/classes metadata (imdb.py)."""

    _name = "dataset"
    _classes = ("__background__", "foreground")

    def __init__(self, cfg: Config, base_seed: int = 3):
        self.cfg = cfg
        self.base_seed = base_seed
        self.pixel_mean = cfg.pixel_means.astype(np.float32) / 255.0
        self._epoch = 0

    @property
    def name(self) -> str:
        return self._name

    @property
    def num_classes(self) -> int:
        return len(self._classes)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-epoch augmentation stream: the draws are a
        deterministic function of (epoch, index)."""
        self._epoch = int(epoch)

    def _rng(self, idx: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.base_seed * 1_000_003 + idx
             + self._epoch * 977_482_177) % (2 ** 31 - 1))

    def _normalize_bgr(self, im_bgr_u8: np.ndarray) -> np.ndarray:
        return im_bgr_u8.astype(np.float32) / 255.0 - self.pixel_mean

    def _maybe_augment_rgb(self, im: np.ndarray,
                           rng: np.random.RandomState) -> np.ndarray:
        """Chromatic + noise augmentation at 90% probability each
        (tabletop_object.py:299-302)."""
        cfg = self.cfg
        if cfg.TRAIN.CHROMATIC and cfg.MODE == "TRAIN" and rng.rand(1) > 0.1:
            im = augmentation.chromatic_transform(im, rng=rng)
        if cfg.TRAIN.ADD_NOISE and cfg.MODE == "TRAIN" and rng.rand(1) > 0.1:
            im = augmentation.add_noise(im, rng=rng)
        return im

    def __len__(self) -> int:
        return self._size

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class TableTopObject(_DatasetBase):
    """Synthetic Tabletop Object Dataset (280k train samples)
    (lib/datasets/tabletop_object.py:96-323)."""

    def __init__(self, image_set: str, cfg: Config,
                 path: Optional[str] = None, base_seed: int = 3):
        super().__init__(cfg, base_seed)
        from unseenobjectclustering_torch.ops.preprocess import (
            focal_from_fov)

        self._name = "tabletop_object_" + image_set
        self._image_set = image_set
        self.path = path or os.path.join("data", "tabletop")
        self.params = dict(TOD_PARAMS)

        # crop mode uses 5 center views, offset +2 (tabletop_object.py:109-112)
        self.views_per_scene = 5 if cfg.TRAIN.SYN_CROP else 7

        sets = {"train": ["training_set"], "test": ["test_set"],
                "all": ["training_set", "test_set"]}[image_set]
        self.scene_dirs = []
        for s in sets:
            self.scene_dirs += sorted(
                glob.glob(os.path.join(self.path, s, "*")))
        self._size = len(self.scene_dirs) * self.views_per_scene

        f = focal_from_fov(self.params["img_width"],
                           self.params["img_height"], self.params["fov"],
                           self.params["near"])
        self.intrinsics = (f, f, self.params["img_width"] / 2.0,
                           self.params["img_height"] / 2.0)

    # -- per-sample stages ---------------------------------------------------

    def process_depth(self, depth_img_mm: np.ndarray,
                      rng: np.random.RandomState) -> np.ndarray:
        """mm -> m, noise, backproject, GP noise
        (tabletop_object.py:135-155)."""
        depth = (depth_img_mm / 1000.0).astype(np.float32)
        if self.params["use_data_augmentation"]:
            depth = augmentation.add_noise_to_depth(depth, self.params, rng)
            depth = augmentation.dropout_random_ellipses(depth, self.params,
                                                         rng)
        xyz = _compute_xyz_np(depth, *self.intrinsics)
        if self.params["use_data_augmentation"]:
            xyz = augmentation.add_noise_to_xyz(xyz, depth, self.params, rng)
        return xyz

    def pad_crop_resize(self, img, label, depth, rng):
        """Object-centric square crop with random padding, resized to
        SYN_CROP_SIZE^2 with cv2 (tabletop_object.py:175-237)."""
        import cv2

        cfg = self.cfg
        h, w = label.shape
        k = int(np.max(label))
        while True:
            idx = rng.randint(1, k + 1) if k > 0 else 0
            fg = (label == idx).astype(np.float32)
            if fg.sum() == 0:
                fg = (label >= 0).astype(np.float32)
            x_min, y_min, x_max, y_max = mask_to_tight_box(fg)
            cx, cy = (x_min + x_max) / 2, (y_min + y_max) / 2
            xd, yd = x_max - x_min, y_max - y_min
            if xd > yd:
                y_min, y_max = cy - xd / 2, cy + xd / 2
            else:
                x_min, x_max = cx - yd / 2, cx + yd / 2
            side = x_max - x_min
            pct = rng.uniform(cfg.TRAIN.min_padding_percentage,
                              cfg.TRAIN.max_padding_percentage)
            pad = int(round(side * pct)) or 25
            x_min = max(int(x_min - pad), 0)
            x_max = min(int(x_max + pad), w - 1)
            y_min = max(int(y_min - pad), 0)
            y_max = min(int(y_max + pad), h - 1)
            if y_min == y_max or x_min == x_max:
                continue
            break
        s = int(cfg.TRAIN.SYN_CROP_SIZE)
        img_c = cv2.resize(img[y_min:y_max + 1, x_min:x_max + 1], (s, s))
        lab_c = cv2.resize(label[y_min:y_max + 1, x_min:x_max + 1], (s, s),
                           interpolation=cv2.INTER_NEAREST)
        dep_c = None
        if depth is not None:
            dep_c = cv2.resize(depth[y_min:y_max + 1, x_min:x_max + 1],
                               (s, s), interpolation=cv2.INTER_NEAREST)
        return img_c, lab_c, dep_c

    def sample_pixels(self, labels: np.ndarray, num: int,
                      rng: np.random.RandomState) -> np.ndarray:
        """Keep <= num pixels per cluster; the rest become -1 (ignored by the
        loss) (tabletop_object.py:241-254)."""
        out = -1 * np.ones_like(labels)
        for i in range(int(np.max(labels)) + 1):
            ys, xs = np.where(labels == i)
            n = ys.size
            if n <= num:
                out[ys, xs] = i
            else:
                sel = rng.permutation(n)[:num]
                out[ys[sel], xs[sel]] = i
        return out

    def __getitem__(self, idx: int) -> dict:
        import cv2

        cfg = self.cfg
        rng = self._rng(idx)
        scene_dir = self.scene_dirs[idx // self.views_per_scene]
        view = idx % self.views_per_scene
        if cfg.TRAIN.SYN_CROP:
            view += 2

        labels = imread_indexed(
            os.path.join(scene_dir, "segmentation_%05d.png" % view))
        labels = labels.astype(np.int32)
        labels[labels == 1] = 0  # table -> background
        labels = process_label(labels)

        im = cv2.imread(os.path.join(scene_dir, "rgb_%05d.jpeg" % view))

        xyz = None
        if cfg.INPUT in ("DEPTH", "RGBD"):
            depth_mm = png.read_anydepth(
                os.path.join(scene_dir, "depth_%05d.png" % view))
            xyz = self.process_depth(depth_mm, rng)

        if cfg.TRAIN.SYN_CROP:
            im, labels, xyz = self.pad_crop_resize(im, labels, xyz, rng)
            labels = process_label(labels)
        if cfg.TRAIN.EMBEDDING_SAMPLING:
            labels = self.sample_pixels(
                labels, int(cfg.TRAIN.EMBEDDING_SAMPLING_NUM), rng)

        im = self._maybe_augment_rgb(im, rng)
        sample = {
            "label": labels.astype(np.int32),
            "image_color": self._normalize_bgr(im),
            "filename": os.path.join(scene_dir, "rgb_%05d.jpeg" % view),
        }
        if xyz is not None:
            sample["depth"] = xyz.astype(np.float32)
        return sample


def _read_cloud(pcd_filename: str, height: int, width: int) -> np.ndarray:
    """An organized cloud as [H, W, 3] float32 with its NaNs set to 0
    (ocid_object.py:104-112)."""
    cloud = load_pcd_xyz(pcd_filename)
    cloud[np.isnan(cloud)] = 0
    return cloud.reshape((height, width, 3)).astype(np.float32)


class OCIDObject(_DatasetBase):
    """OCID real-image evaluation set (lib/datasets/ocid_object.py:23-125).

    As in the reference, the label and PCD paths are the image path with
    every "rgb" replaced by "label" (or "pcd", and "png" by "pcd"), id 2
    is background wherever the label path holds "table", and the filename
    is cut at the first "OCID"."""

    _width, _height = 640, 480

    def __init__(self, image_set: str, cfg: Config,
                 path: Optional[str] = None, base_seed: int = 3):
        super().__init__(cfg, base_seed)
        self._name = "ocid_object_" + image_set
        self.path = path or os.path.join("data", "OCID")
        seqs = list(Path(self.path).glob("**/*seq*"))
        self.image_paths = []
        for seq in sorted(seqs):
            self.image_paths += sorted((seq / "rgb").glob("*.png"))
        self._size = len(self.image_paths)

    def __getitem__(self, idx: int) -> dict:
        cfg = self.cfg
        rng = self._rng(idx)
        filename = str(self.image_paths[idx])
        im = png.read_bgr(filename)
        im = self._maybe_augment_rgb(im, rng)

        labels_filename = filename.replace("rgb", "label")
        labels = imread_indexed(labels_filename).astype(np.int32)
        labels[labels == 1] = 0  # table
        if "table" in labels_filename:
            labels[labels == 2] = 0  # (ocid_object.py:89-95)
        labels = process_label(labels)

        i = filename.find("OCID")
        sample = {
            "image_color": self._normalize_bgr(im),
            "image_color_bgr": im.astype(np.float32) / 255.0,
            "label": labels,
            "filename": filename[i + 5:] if i >= 0 else filename,
        }
        if cfg.INPUT in ("DEPTH", "RGBD"):
            sample["depth"] = _read_cloud(
                filename.replace("rgb", "pcd").replace("png", "pcd"),
                self._height, self._width)
        return sample


class OSDObject(_DatasetBase):
    """OSD real-image evaluation set (111 images)
    (lib/datasets/osd_object.py:23-113).  Paths derive from the image path
    by replacing "image_color", and the filename is cut at the first
    "OSD", as in the reference."""

    _width, _height = 640, 480

    def __init__(self, image_set: str, cfg: Config,
                 path: Optional[str] = None, base_seed: int = 3):
        super().__init__(cfg, base_seed)
        self._name = "osd_object_" + image_set
        self.path = path or os.path.join("data", "OSD")
        self.image_files = sorted(
            glob.glob(os.path.join(self.path, "image_color", "*.png")))
        self._size = len(self.image_files)

    def __getitem__(self, idx: int) -> dict:
        cfg = self.cfg
        rng = self._rng(idx)
        filename = self.image_files[idx]
        im = png.read_bgr(filename)
        im = self._maybe_augment_rgb(im, rng)

        labels = imread_indexed(
            filename.replace("image_color", "annotation")).astype(np.int32)
        labels = process_label(labels)

        i = filename.find("OSD")
        sample = {
            "image_color": self._normalize_bgr(im),
            "image_color_bgr": im.astype(np.float32) / 255.0,
            "label": labels,
            "filename": filename[i + 4:] if i >= 0 else filename,
        }
        if cfg.INPUT in ("DEPTH", "RGBD"):
            sample["depth"] = _read_cloud(
                filename.replace("image_color", "pcd").replace("png", "pcd"),
                self._height, self._width)
        return sample
