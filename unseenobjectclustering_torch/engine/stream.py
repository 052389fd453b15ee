"""Real-time serving: camera-stream segmentation loop.

Port of ``unseenobjectclustering_tpu/engine/stream.py``, the reference ROS
node's processing core (ros/test_images_segmentation.py:47-194) with the
transport decoupled: `StreamSegmentor` owns the latest-frame buffer
(lock-guarded, newest wins — :106-131), the preprocessing on the
Segmentor's device and the two-stage Segmentor; the ROS adapter
(``unseenobjectclustering_torch/tools/ros_node.py``) is a thin topic
adapter around it, so any transport can serve the same engine.

Preprocessing: the uint8 BGR image and the float32 depth go to the device
once, and ``ops.preprocess.normalize_bgr``/``compute_xyz`` build the
normalized image and the XYZ image there, with the float32 operations, in
the order, of the JAX package's host path (compute_xyz_np and
x/255 - mean/255): the same bits.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.ops.preprocess import (compute_xyz,
                                                         normalize_bgr)


class Frame(NamedTuple):
    bgr: np.ndarray                 # [H, W, 3] uint8
    depth_m: Optional[np.ndarray]   # [H, W] float32 meters (or None)
    intrinsics: tuple               # (fx, fy, px, py)
    stamp: Any                      # opaque (e.g. ROS header)


class StreamResult(NamedTuple):
    labels: np.ndarray
    labels_refined: Optional[np.ndarray]
    stamp: Any
    latency_s: float
    # the frame the labels belong to, for overlay rendering downstream
    # (the reference node publishes label AND overlay topics)
    bgr: Optional[np.ndarray] = None


class StreamSegmentor:
    """Latest-frame poll-loop segmentation engine.

    Usage (transport-agnostic):
        ss = StreamSegmentor(cfg, segmentor)
        ss.submit(bgr, depth_m, (fx, fy, px, py), stamp)   # from any thread
        result = ss.process_latest()                        # worker loop
    """

    def __init__(self, cfg: Config, segmentor: Segmentor):
        self.cfg = cfg
        self.segmentor = segmentor
        self._lock = threading.Lock()
        self._frame: Optional[Frame] = None

    @property
    def pending(self) -> bool:
        """True while a submitted frame waits to be processed."""
        with self._lock:
            return self._frame is not None

    def submit(self, bgr: np.ndarray, depth_m: Optional[np.ndarray],
               intrinsics: tuple, stamp: Any = None) -> None:
        """Store the newest frame (older unprocessed frames are dropped,
        matching the reference's latest-wins buffer)."""
        with self._lock:
            self._frame = Frame(bgr, depth_m, intrinsics, stamp)

    def process_latest(self, refine: bool = True
                       ) -> Optional[StreamResult]:
        """Segment the most recent frame; returns None when no frame is
        pending (ros/test_images_segmentation.py:134-161 semantics).
        latency_s ends after the labels are on the host (segment fetches
        them, which waits for the device)."""
        with self._lock:
            frame, self._frame = self._frame, None
        if frame is None:
            return None
        t0 = time.perf_counter()
        device = self.segmentor.device
        image = None
        if self.cfg.INPUT != "DEPTH":
            bgr = torch.from_numpy(np.ascontiguousarray(frame.bgr)).to(device)
            image = normalize_bgr(bgr, self.cfg.pixel_means)[None]
        xyz = None
        if frame.depth_m is not None and self.cfg.INPUT in ("DEPTH", "RGBD"):
            depth = torch.from_numpy(np.ascontiguousarray(
                frame.depth_m, dtype=np.float32)).to(device)
            xyz = compute_xyz(depth, *frame.intrinsics)[None]
        res = self.segmentor.segment(image, xyz, refine=refine)
        return StreamResult(
            labels=res.labels[0],
            labels_refined=(res.labels_refined[0]
                            if res.labels_refined is not None else None),
            stamp=frame.stamp,
            latency_s=time.perf_counter() - t0,
            bgr=frame.bgr)

    def run_forever(self, callback: Callable[[StreamResult], Any],
                    refine: bool = True, poll_interval_s: float = 0.001,
                    should_stop: Callable[[], bool] = lambda: False
                    ) -> None:
        """Poll loop: segment frames as they arrive, invoke callback(result)
        (the reference's main loop, ros/test_images_segmentation.py:283-285).
        """
        while not should_stop():
            result = self.process_latest(refine=refine)
            if result is None:
                time.sleep(poll_interval_s)
                continue
            callback(result)
