"""The port's tools/annotate_demo_gt.py and tools/collect_images_realsense.py
against the JAX repo's tools/annotate_demo_gt.py and
ros/collect_images_realsense.py on the CPU.

annotate_demo_gt: a 120x160 RGB-D frame (a tilted table plane and four
raised boxes, camera_params.json) is written into a temporary demo
directory, to which the JAX tool's fixed DEMO path is monkeypatched.
`propose` must give the JAX tool's proposal labels and overlay bytes, and
`apply` its label and verification PNGs byte for byte, for a spec of
erase, split, merge, keep, polygon and ellipse edits with the GrabCut
refinement on.  Without OpenCV the port's propose writes its labels and
then raises at the overlay's numbers, naming the step.  The connected
components are also held to cv2.connectedComponents alone, and the
polygon fill (utils/imgproc.fill_poly) to cv2.fillPoly.

collect_images_realsense: rospy, message_filters, cv_bridge and
sensor_msgs are fakes; each tool's synchronizer callback is driven with
the same messages and clock (16UC1 depth, 32FC1 depth with NaN and
infinities, a pair inside the interval that must be skipped), and the
written pair files must be the JAX callback's bytes.
"""

import importlib.util
import json
import os
import sys
import types

import cv2
import numpy as np
import pytest

from unseenobjectclustering_torch.tools import annotate_demo_gt
from unseenobjectclustering_torch.tools import collect_images_realsense
from unseenobjectclustering_torch.utils import imgproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 120, 160
CAM = {"fx": 150.0, "fy": 150.0, "x_offset": W / 2.0, "y_offset": H / 2.0}
BOXES = [(20, 20, 25, 30, 0.06), (30, 90, 30, 25, 0.08),
         (75, 40, 20, 40, 0.05), (80, 110, 25, 20, 0.07)]  # y, x, h, w, m


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def demo(tmp_path):
    """A demo directory with frame 0, and the JAX tool reading from it."""
    rng = np.random.RandomState(0)
    d = tmp_path / "demo"
    d.mkdir()
    # a plane through (0, 0, 1 m) tilted about the camera's x axis
    vs = np.arange(H, dtype=np.float64)[:, None]
    depth = np.repeat(1.0 / (1.0 + 0.3 * (vs - CAM["y_offset"]) / CAM["fy"]),
                      W, axis=1)
    color = np.full((H, W, 3), 120, np.float64)
    for k, (y, x, h, w, lift) in enumerate(BOXES):
        depth[y:y + h, x:x + w] -= lift
        color[y:y + h, x:x + w] = (40 + 50 * k, 200 - 40 * k, 90 + 30 * k)
    color += rng.randn(H, W, 3) * 4.0
    depth_mm = np.round(depth * 1000).astype(np.uint16)
    depth_mm[rng.rand(H, W) < 0.01] = 0
    cv2.imwrite(str(d / "000000-color.png"),
                np.clip(color, 0, 255).astype(np.uint8))
    cv2.imwrite(str(d / "000000-depth.png"), depth_mm)
    (d / "camera_params.json").write_text(json.dumps(CAM))
    return d


@pytest.fixture
def jax_annotate(monkeypatch, demo):
    module = load(os.path.join(REPO, "tools", "annotate_demo_gt.py"),
                  "jax_annotate_demo_gt")
    monkeypatch.setattr(module, "DEMO", str(demo))
    return module


def test_propose_equals_the_jax_tool(demo, jax_annotate, tmp_path):
    jax_annotate.propose(0, 10.0, 40, str(tmp_path / "jax"))
    labels = annotate_demo_gt.main(["propose", "--frame", "0",
                                    "--demo-dir", str(demo), "--min-px",
                                    "40", "--work-dir",
                                    str(tmp_path / "port")])
    want = np.load(tmp_path / "jax" / "000000-proposal.npy")
    got = np.load(tmp_path / "port" / "000000-proposal.npy")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(labels, want)
    assert want.max() == len(BOXES)
    assert ((tmp_path / "port" / "000000-proposal.png").read_bytes()
            == (tmp_path / "jax" / "000000-proposal.png").read_bytes())


def test_apply_equals_the_jax_tool(demo, jax_annotate, tmp_path):
    jax_annotate.propose(0, 10.0, 40, str(tmp_path / "work"))
    spec = {"erase": [[0, 0, 8, 8]],
            "split": [{"src": 2, "polygon": [[90, 30], [104, 30],
                                             [104, 60], [90, 60]]}],
            "merge": [[3, 4]],
            "keep": [1, 2, 3, 5],
            "polygon": {"new": [[130, 5], [150, 8], [155, 25], [140, 30],
                                [128, 18]],
                        "1": [[18, 18], [50, 18], [50, 22], [18, 24]]},
            "ellipse": {"new": [60, 100, 10, 6, 30]},
            "erase_final": [[0, 110, 10, 120]]}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    work = str(tmp_path / "work")
    jax_annotate.apply_spec(0, str(path), str(tmp_path / "jax"), work)
    got = annotate_demo_gt.main(["apply", "--frame", "0", "--demo-dir",
                                 str(demo), "--spec", str(path),
                                 "--work-dir", work, "--out-dir",
                                 str(tmp_path / "port")])
    for name in ("000000-label.png", "000000-verify.png"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    want = cv2.imread(str(tmp_path / "jax" / "000000-label.png"), -1)
    np.testing.assert_array_equal(got, want)
    assert got.max() >= 4


def test_propose_without_opencv_raises_at_the_overlay(demo, tmp_path,
                                                      monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="putText"):
        annotate_demo_gt.propose(0, 10.0, 40, str(tmp_path),
                                 demo_dir=str(demo))
    assert np.load(tmp_path / "000000-proposal.npy").max() == len(BOXES)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_are_cv2s(connectivity):
    """Labels and their numbering equal cv2.connectedComponents' on
    random masks of 1 to 80 pixels a side and at 480x640."""
    rng = np.random.RandomState(connectivity)
    for t in range(400):
        h, w = rng.randint(1, 80, 2) if t % 50 else (480, 640)
        mask = (rng.rand(h, w) < rng.uniform(0.05, 0.7)).astype(np.uint8)
        want_n, want = cv2.connectedComponents(mask,
                                               connectivity=connectivity)
        got_n, got = annotate_demo_gt.connected_components(mask,
                                                           connectivity)
        assert got_n == want_n
        np.testing.assert_array_equal(got, want)


def test_fill_poly_is_cv2s():
    """On-canvas polygons of 1 to 11 vertices (non-convex,
    self-intersecting, degenerate) on canvases of 1 to 640 pixels a
    side; an off-canvas vertex raises."""
    rng = np.random.RandomState(7)
    for t in range(600):
        h, w = (rng.randint(1, 60, 2) if t % 10 else
                rng.randint(200, 640, 2))
        k = rng.randint(1, 12)
        pts = np.stack([rng.randint(0, w, k), rng.randint(0, h, k)], 1)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts.astype(np.int32).reshape(-1, 1, 2)], 1)
        got = imgproc.fill_poly(np.zeros((h, w), np.uint8), pts, 1)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))
    with pytest.raises(ValueError, match="canvas"):
        imgproc.fill_poly(np.zeros((8, 8), np.uint8), [[0, 0], [8, 3],
                                                       [2, 5]], 1)


# -- collect_images_realsense -------------------------------------------------

class FakeMsg:
    def __init__(self, data, encoding):
        self.data = data
        self.encoding = encoding


class FakeBridge:
    def imgmsg_to_cv2(self, msg, fmt=None):
        return msg.data


def install_fake_ros(monkeypatch, clock):
    """Fake ROS modules; returns the dict the synchronizer's callback is
    recorded in."""
    rec = {}
    rospy = types.ModuleType("rospy")
    rospy.get_time = lambda: clock[0]
    rospy.loginfo = lambda *a, **k: None
    rospy.init_node = lambda name: None
    rospy.spin = lambda: None
    mf = types.ModuleType("message_filters")

    class Sub:
        def __init__(self, topic, *a, **k):
            rec.setdefault("topics", []).append(topic)

    class Sync:
        def __init__(self, subs, queue_size, slop):
            pass

        def registerCallback(self, cb):
            rec["callback"] = cb

    mf.Subscriber = Sub
    mf.ApproximateTimeSynchronizer = Sync
    cvb = types.ModuleType("cv_bridge")
    cvb.CvBridge = FakeBridge
    smsg = types.ModuleType("sensor_msgs")
    smsg_msg = types.ModuleType("sensor_msgs.msg")
    smsg_msg.Image = object
    smsg.msg = smsg_msg
    for name, mod in [("rospy", rospy), ("message_filters", mf),
                      ("cv_bridge", cvb), ("sensor_msgs", smsg),
                      ("sensor_msgs.msg", smsg_msg)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return rec


def capture_messages():
    """(time, rgb message, depth message): a 16UC1 pair, one 0.4 s later
    (skipped at --interval 1), a 32FC1 pair with NaN, infinities, a
    negative depth and one past 65.535 m."""
    rng = np.random.RandomState(3)
    rgb = [rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
           for _ in range(3)]
    d16 = rng.randint(0, 4000, (48, 64)).astype(np.uint16)
    d32 = rng.uniform(0.3, 2.5, (48, 64)).astype(np.float32)
    d32[0, :4] = [np.nan, np.inf, -np.inf, -0.5]
    d32[1, 0] = 70.0
    return [(10.0, FakeMsg(rgb[0], "rgb8"), FakeMsg(d16, "16UC1")),
            (10.4, FakeMsg(rgb[1], "rgb8"), FakeMsg(d16, "16UC1")),
            (11.5, FakeMsg(rgb[2], "rgb8"), FakeMsg(d32, "32FC1"))]


def test_capture_writes_the_jax_callbacks_bytes(monkeypatch, tmp_path):
    clock = [0.0]
    rec = install_fake_ros(monkeypatch, clock)
    jtool = load(os.path.join(REPO, "ros", "collect_images_realsense.py"),
                 "jax_collect_images_realsense")
    out = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    argv = ["--interval", "1.0", "--rgb", "/c/rgb", "--depth", "/c/depth"]
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", ["collect"] + argv + ["--outdir",
                                                    str(out["jax"])])
        jtool.main()
    callbacks = {"jax": rec.pop("callback")}
    collect_images_realsense.main(argv + ["--outdir", str(out["port"])])
    callbacks["port"] = rec.pop("callback")
    assert rec["topics"] == ["/c/rgb", "/c/depth"] * 2
    for name, cb in callbacks.items():
        for t, rgb, depth in capture_messages():
            clock[0] = t
            cb(rgb, depth)
    names = sorted(os.listdir(out["jax"]))
    assert names == ["000000-color.png", "000000-depth.png",
                     "000001-color.png", "000001-depth.png"]
    assert sorted(os.listdir(out["port"])) == names
    for name in names:
        assert ((out["port"] / name).read_bytes()
                == (out["jax"] / name).read_bytes()), name
    depth = cv2.imread(str(out["port"] / "000001-depth.png"), -1)
    assert list(depth[0, :4]) == [0, 0, 0, 0] and depth[1, 0] == 65535
