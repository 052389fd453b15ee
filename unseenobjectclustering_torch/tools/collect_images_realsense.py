"""ROS capture helper: save synchronized RGB / depth pairs from a
RealSense camera as <n>-color.png / <n>-depth.png (depth in millimetres,
uint16), the pairs tools.test_images reads (the port of the JAX repo's
ros/collect_images_realsense.py, parity with the reference
ros/collect_images_realsense.py:22-97).

The synchronizer's callback is PairWriter, which takes its bridge and
clock as arguments; rospy, message_filters, cv_bridge and sensor_msgs are
imported in main().  PNGs are written by utils/png.imwrite, with
cv2.imwrite's bytes.

Run (ROS environment required):
  python -m unseenobjectclustering_torch.tools.collect_images_realsense \\
      --outdir data/captured --interval 1.0
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

import numpy as np

from unseenobjectclustering_torch.utils import png


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Collect RGB-D pairs")
    parser.add_argument("--outdir", type=str, default="data/captured")
    parser.add_argument("--rgb", type=str,
                        default="/camera/color/image_raw")
    parser.add_argument("--depth", type=str,
                        default="/camera/aligned_depth_to_color/image_raw")
    parser.add_argument("--interval", type=float, default=1.0,
                        help="seconds between saved pairs")
    return parser.parse_args(argv)


def depth_to_mm(depth: np.ndarray, encoding: str) -> np.ndarray:
    """The depth image as uint16 millimetres.  A 32FC1 image is in metres:
    NaN and infinite pixels become 0 (invalid, as the downstream z > 0
    filter expects) before the cast, and the rest are clipped to
    [0, 65535]."""
    if encoding == "32FC1":
        depth = np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)
        return np.clip(depth * 1000, 0, 65535).astype(np.uint16)
    return depth.astype(np.uint16)


class PairWriter:
    """The synchronizer's callback: at most one pair per `interval`
    seconds of `clock`, written as outdir/%06d-color.png and
    %06d-depth.png."""

    def __init__(self, outdir: str, interval: float, bridge,
                 clock: Callable[[], float],
                 log: Callable[[str], None] = print):
        self.outdir = outdir
        self.interval = interval
        self.bridge = bridge
        self.clock = clock
        self.log = log
        self.count = 0
        self.last = 0.0

    def __call__(self, rgb_msg, depth_msg) -> Optional[int]:
        """Write one pair unless the last was under `interval` ago;
        returns its number (None when skipped)."""
        now = self.clock()
        if now - self.last < self.interval:
            return None
        self.last = now
        im = self.bridge.imgmsg_to_cv2(rgb_msg, "bgr8")
        depth = depth_to_mm(self.bridge.imgmsg_to_cv2(depth_msg),
                            depth_msg.encoding)
        i = self.count
        png.imwrite(os.path.join(self.outdir, "%06d-color.png" % i), im)
        png.imwrite(os.path.join(self.outdir, "%06d-depth.png" % i), depth)
        self.count += 1
        self.log(f"saved pair {i}")
        return i


def main(argv: Optional[Sequence[str]] = None) -> PairWriter:
    args = parse_args(argv)
    import message_filters
    import rospy
    from cv_bridge import CvBridge
    from sensor_msgs.msg import Image

    os.makedirs(args.outdir, exist_ok=True)
    writer = PairWriter(args.outdir, args.interval, CvBridge(),
                        rospy.get_time, rospy.loginfo)
    rospy.init_node("collect_images")
    rgb_sub = message_filters.Subscriber(args.rgb, Image, queue_size=2)
    depth_sub = message_filters.Subscriber(args.depth, Image, queue_size=2)
    sync = message_filters.ApproximateTimeSynchronizer(
        [rgb_sub, depth_sub], queue_size=10, slop=0.1)
    sync.registerCallback(writer)
    rospy.spin()
    return writer


if __name__ == "__main__":
    main()
