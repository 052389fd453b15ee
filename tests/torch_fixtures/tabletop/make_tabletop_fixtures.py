"""Write the TableTop fixture tree, the small JPEG corpus and digests.json.

Run from the repository root, where cv2 and the JAX package import:

    python tests/torch_fixtures/tabletop/make_tabletop_fixtures.py

It writes, beside this file:

  * ``training_set/scene_00000`` and ``test_set/scene_00000``: 7 views each
    at 480x640 in the Tabletop Object Dataset's layout, rendered by the
    port's scene renderer from a fixed seed: ``rgb_%05d.jpeg`` (cv2.imwrite,
    its default quality 95, 4:2:0), ``depth_%05d.png`` (16-bit, mm) and
    ``segmentation_%05d.png`` (indexed: 0 background, 1 table, 2.. objects).
    The renderer does not label its table plane, so the background inside
    the objects' bounding box grown by 24 pixels is written as the table
    (1) and the rest as 0; the readers map both to background.
  * ``jpeg/``: small JPEGs from cv2.imwrite covering every sampling factor,
    grey, a restart interval, optimised Huffman tables, odd sizes down to
    1x1, qualities 50 / 75 / 95 / 100, and one progressive file.
  * ``digests.json``: the SHA-256 of cv2.imread of every JPEG (null for
    the progressive one, which the port's decoder refuses) and of every
    array of the JAX package's TableTopObject samples of the tree for each
    case of ``CASES`` at epochs 0 and 1.

With ``--time-decode`` it writes nothing and prints the ms of
cv2.imdecode and of the port's decoder (``utils/jpeg.py``) on the tree's
480x640 frame ``training_set/scene_00000/rgb_00000.jpeg``, median of 20
each, on this host's CPU.

``CASES``, ``array_digest`` and ``sample_digests`` are shared with the
tests and chip_smoke.py, which compute the same digests with the port's
readers (no cv2 there) and compare.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
H, W = 480, 640
VIEWS = 7
SEED = 14
TRAIN_YML = os.path.join(
    "experiments", "cfgs",
    "seg_resnet34_8s_embedding_cosine_rgbd_add_tabletop.yml")
CROP_YML = os.path.join(
    "experiments", "cfgs",
    "seg_resnet34_8s_embedding_cosine_rgbd_add_crop_tabletop.yml")
# name -> (registry name, yml relative to the repository root, MODE)
CASES = {
    "test": ("tabletop_object_test", TRAIN_YML, "TEST"),
    "train_rgbd_add": ("tabletop_object_train", TRAIN_YML, "TRAIN"),
    "train_crop224": ("tabletop_object_train", CROP_YML, "TRAIN"),
}
EPOCHS = (0, 1)


def array_digest(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def sample_digests(get_dataset, config_cls, root: str) -> dict:
    """{case: {epoch: [{key: digest} per sample]}} of every array of every
    sample of the tree at `root`, for a package's get_dataset and Config."""
    out = {}
    for name, (dataset, yml, mode) in CASES.items():
        cfg = config_cls.from_yaml(os.path.join(REPO, yml)).replace(
            MODE=mode)
        ds = get_dataset(dataset, cfg, path=root)
        out[name] = {}
        for epoch in EPOCHS:
            ds.set_epoch(epoch)
            out[name][str(epoch)] = [
                {k: array_digest(v) for k, v in sorted(ds[i].items())
                 if isinstance(v, np.ndarray)} for i in range(len(ds))]
    return out


def jpeg_files() -> list[str]:
    """Every committed JPEG, relative to this directory, sorted."""
    out = []
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith((".jpeg", ".jpg")):
                out.append(os.path.relpath(os.path.join(dirpath, f), HERE))
    return sorted(out)


def _tod_segmentation(labels: np.ndarray) -> np.ndarray:
    seg = np.zeros(labels.shape, np.uint8)
    ys, xs = np.nonzero(labels > 0)
    if ys.size:
        y0, y1 = max(ys.min() - 24, 0), ys.max() + 25
        x0, x1 = max(xs.min() - 24, 0), xs.max() + 25
        seg[y0:y1, x0:x1] = 1
    seg[labels > 0] = labels[labels > 0] + 1
    return seg


def _small_jpegs(cv2) -> None:
    rng = np.random.RandomState(SEED)
    d = os.path.join(HERE, "jpeg")
    os.makedirs(d, exist_ok=True)

    def image(h, w):
        y, x = np.mgrid[0:h, 0:w]
        base = np.stack([128 + 100 * np.sin(x / 5.0 + c) * np.cos(y / 9.0 - c)
                         for c in range(3)], -1)
        return np.clip(base + rng.randn(h, w, 3) * 12, 0, 255).astype(
            np.uint8)

    sampling = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
    for name, flag in sampling.items():
        for h, w in ((37, 53), (1, 1), (2, 3), (9, 18)):
            cv2.imwrite(os.path.join(d, f"s{name}_{h}x{w}.jpg"), image(h, w),
                        [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
    for q in (50, 75, 95, 100):
        cv2.imwrite(os.path.join(d, f"q{q}_31x47.jpg"), image(31, 47),
                    [cv2.IMWRITE_JPEG_QUALITY, q])
    cv2.imwrite(os.path.join(d, "grey_29x41.jpg"),
                image(29, 41)[..., 1])
    cv2.imwrite(os.path.join(d, "restart_45x67.jpg"), image(45, 67),
                [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    cv2.imwrite(os.path.join(d, "optimize_45x67.jpg"), image(45, 67),
                [cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    cv2.imwrite(os.path.join(d, "progressive_40x40.jpg"), image(40, 40),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])


def _median_ms(fn, runs: int = 20) -> float:
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def time_decode() -> None:
    """Print cv2.imdecode's and the port's decode ms on the 480x640 frame."""
    import cv2

    sys.path.insert(0, REPO)
    from unseenobjectclustering_torch.utils import jpeg

    path = os.path.join(HERE, "training_set", "scene_00000", "rgb_00000.jpeg")
    with open(path, "rb") as f:
        data = f.read()
    buf = np.frombuffer(data, np.uint8)
    jpeg.library()
    if not np.array_equal(jpeg.decode(data), cv2.imdecode(buf, 1)):
        raise AssertionError(f"{path}: the decoders differ")
    cv2_ms = _median_ms(lambda: cv2.imdecode(buf, cv2.IMREAD_COLOR))
    port_ms = _median_ms(lambda: jpeg.decode(data))
    print(f"{path} ({len(data)} bytes): cv2.imdecode {cv2_ms:.3f} ms, "
          f"utils/jpeg.decode {port_ms:.3f} ms (median of 20 each; "
          f"OpenCV {cv2.__version__})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time-decode", action="store_true",
                    help="print the decode ms of cv2 and the port's "
                    "decoder on the tree's 480x640 frame; write nothing")
    if ap.parse_args().time_decode:
        time_decode()
        return
    import cv2

    sys.path.insert(0, REPO)
    from unseenobjectclustering_torch.config import Config as TConfig
    from unseenobjectclustering_torch.data.synthetic import (
        SyntheticTabletopDataset)
    from unseenobjectclustering_torch.utils.masks import imwrite_indexed
    from unseenobjectclustering_tpu.config import Config as JConfig
    from unseenobjectclustering_tpu.data.factory import get_dataset

    renderer = SyntheticTabletopDataset(
        "test", TConfig.default(), height=H, width=W, size=2 * VIEWS,
        base_seed=SEED)
    for s, split in enumerate(("training_set", "test_set")):
        d = os.path.join(HERE, split, "scene_00000")
        os.makedirs(d, exist_ok=True)
        for v in range(VIEWS):
            bgr, depth_mm, labels = renderer.get_scene(s * VIEWS + v)
            cv2.imwrite(os.path.join(d, "rgb_%05d.jpeg" % v), bgr)
            cv2.imwrite(os.path.join(d, "depth_%05d.png" % v), depth_mm)
            imwrite_indexed(os.path.join(d, "segmentation_%05d.png" % v),
                            _tod_segmentation(labels))
    _small_jpegs(cv2)

    jpegs = {}
    for rel in jpeg_files():
        im = cv2.imread(os.path.join(HERE, rel))
        jpegs[rel] = None if "progressive" in rel else array_digest(im)
    digests = {"jpeg": jpegs,
               "samples": sample_digests(get_dataset, JConfig, HERE)}
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(dp, f))
                for dp, _, fs in os.walk(HERE) for f in fs)
    print(f"wrote {len(jpegs)} JPEGs and the tree: {total / 2 ** 20:.2f} MiB")


if __name__ == "__main__":
    main()
