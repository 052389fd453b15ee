"""Entry points of the port, each run as
``python -m unseenobjectclustering_torch.tools.<name>``:

  test_npy       — segment .npy RGB-D dumps (numpy only: runs where OpenCV
                   is missing)
  test_images    — segment *-color.png / *-depth.png pairs (OpenCV)
  eval_demo_gt   — per-frame and mean F-measures against hand-annotated GT
  demo_artifact  — one overlay grid of the demo frames
  ros_node       — the rospy adapter around engine.stream.StreamSegmentor

Each runs on cuda:<--gpu> unless given --device cpu; --fast selects the
FAST_CLUSTER preset and bfloat16 convolutions.
"""
