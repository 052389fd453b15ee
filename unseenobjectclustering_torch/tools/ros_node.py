"""ROS node: live RGB-D unseen-object segmentation on the GPU.

Port of the JAX package's ros/test_images_segmentation.py (the reference
node, ros/test_images_segmentation.py:47-285): subscribes to synchronized
RGB + aligned-depth topics (RealSense D415, Azure Kinect or Fetch
layouts), reads intrinsics from CameraInfo, and publishes `seg_label` /
`seg_label_refined` (mono8) plus color-overlay images.  The compute core is
engine.stream.StreamSegmentor; this module is only the rospy transport
adapter, so rospy, message_filters, cv_bridge and sensor_msgs are imported
where they are used.

Run (ROS environment required):
  python -m unseenobjectclustering_torch.tools.ros_node \\
      --network seg_resnet34_8s_embedding --pretrained ckpt.pth \\
      --pretrained_crop ckpt_crop.pth --camera D415 [--fast] [--gpu 0]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Optional, Sequence

import numpy as np

from unseenobjectclustering_torch.tools.common import (add_model_args,
                                                       make_cfg,
                                                       make_segmentor)

CAMERA_TOPICS = {
    # camera name -> (rgb topic, depth topic, camera_info topic)
    # (ros/test_images_segmentation.py:68-98)
    "D415": ("/camera/color/image_raw",
             "/camera/aligned_depth_to_color/image_raw",
             "/camera/color/camera_info"),
    "Azure": ("/k4a/rgb/image_raw",
              "/k4a/depth_to_rgb/image_raw",
              "/k4a/rgb/camera_info"),
    "Fetch": ("/head_camera/rgb/image_raw",
              "/head_camera/depth_registered/image_raw",
              "/head_camera/rgb/camera_info"),
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="ROS segmentation node "
                                                 "(PyTorch)")
    add_model_args(parser)
    parser.add_argument("--camera", type=str, default="D415",
                        choices=sorted(CAMERA_TOPICS))
    return parser.parse_args(argv)


class ImageListener:
    """Subscribes RGB+depth, keeps the newest frame, publishes results."""

    def __init__(self, args: argparse.Namespace, stream: Any):
        import message_filters
        import rospy
        from cv_bridge import CvBridge
        from sensor_msgs.msg import CameraInfo, Image

        self.rospy = rospy
        self.bridge = CvBridge()
        self.stream = stream
        self.refine = args.pretrained_crop is not None

        rgb_topic, depth_topic, info_topic = CAMERA_TOPICS[args.camera]
        info = rospy.wait_for_message(info_topic, CameraInfo)
        k = np.array(info.K).reshape(3, 3)
        self.intrinsics = (k[0, 0], k[1, 1], k[0, 2], k[1, 2])

        self.label_pub = rospy.Publisher("seg_label", Image, queue_size=10)
        self.label_refined_pub = rospy.Publisher("seg_label_refined", Image,
                                                 queue_size=10)
        self.image_pub = rospy.Publisher("seg_image", Image, queue_size=10)
        self.image_refined_pub = rospy.Publisher("seg_image_refined", Image,
                                                 queue_size=10)

        rgb_sub = message_filters.Subscriber(rgb_topic, Image, queue_size=10)
        depth_sub = message_filters.Subscriber(depth_topic, Image,
                                               queue_size=10)
        sync = message_filters.ApproximateTimeSynchronizer(
            [rgb_sub, depth_sub], queue_size=10, slop=0.1)
        sync.registerCallback(self.callback_rgbd)

    def callback_rgbd(self, rgb_msg: Any, depth_msg: Any) -> None:
        im = self.bridge.imgmsg_to_cv2(rgb_msg, "bgr8")
        if depth_msg.encoding == "32FC1":
            depth = self.bridge.imgmsg_to_cv2(depth_msg)
        elif depth_msg.encoding == "16UC1":
            depth = self.bridge.imgmsg_to_cv2(depth_msg).astype(
                np.float32) / 1000.0
        else:
            self.rospy.logerr_throttle(
                1, f"unsupported depth encoding {depth_msg.encoding}")
            return
        self.stream.submit(im, depth, self.intrinsics, rgb_msg.header)

    def _publish(self, labels: np.ndarray, bgr: np.ndarray, header: Any,
                 label_pub: Any, image_pub: Any) -> None:
        from unseenobjectclustering_torch.utils.masks import (
            visualize_segmentation)

        msg = self.bridge.cv2_to_imgmsg(labels.astype(np.uint8), "mono8")
        msg.header = header
        label_pub.publish(msg)
        # the overlay keeps the input (BGR) color space
        msg = self.bridge.cv2_to_imgmsg(visualize_segmentation(bgr, labels),
                                        "bgr8")
        msg.header = header
        image_pub.publish(msg)

    def run_network(self) -> bool:
        """Process the newest frame, publish labels AND color overlays (the
        reference publishes both, ros/test_images_segmentation.py:163-194).
        Returns True when a frame was processed (False = idle)."""
        result = self.stream.process_latest(refine=self.refine)
        if result is None:
            return False
        self._publish(result.labels, result.bgr, result.stamp,
                      self.label_pub, self.image_pub)
        if result.labels_refined is not None:
            self._publish(result.labels_refined, result.bgr, result.stamp,
                          self.label_refined_pub, self.image_refined_pub)
        self.rospy.loginfo_throttle(
            5, f"segmentation latency {result.latency_s:.3f}s")
        return True


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    import rospy

    from unseenobjectclustering_torch.engine.stream import StreamSegmentor

    cfg = make_cfg(args)
    stream = StreamSegmentor(cfg, make_segmentor(cfg, args))
    rospy.init_node("seg_rgb")
    listener = ImageListener(args, stream)
    while not rospy.is_shutdown():
        # sleep on idle ticks: a tight no-frame spin would hold the GIL and
        # starve the rospy subscriber threads feeding the frame buffer
        if not listener.run_network():
            time.sleep(0.001)


if __name__ == "__main__":
    main()
