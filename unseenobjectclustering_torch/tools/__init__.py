"""Entry points of the port, each run as
``python -m unseenobjectclustering_torch.tools.<name>``:

  test_net       — evaluate on OCID / OSD / TableTop / the synthetic test
                   split (OCID, OSD and synthetic: no OpenCV, no PIL)
  test_npy       — segment .npy RGB-D dumps (numpy only: runs where OpenCV
                   is missing)
  test_images    — segment *-color.png / *-depth.png pairs (OpenCV)
  eval_demo_gt   — per-frame and mean F-measures against hand-annotated GT
  demo_artifact  — one overlay grid of the demo frames
  ros_node       — the rospy adapter around engine.stream.StreamSegmentor
  train_net      — train a network on host-augmented samples (OpenCV) or
                   on synthetic scenes augmented on the device, with
                   full-state snapshots and exact resume
  render_dataset — pre-render the procedural scenes to a cache (numpy)
  make_real_fixtures — write rendered scenes as OCID/OSD trees (numpy)
  fast_parity_report, probe_seed_precision, dataset_statistics — the JAX
                   repo's report, seeding audit and dataset counts
  plot_bar_charts, plot_epochs — the published comparison charts and
                   per-epoch curves (matplotlib)
  view_tabletop_data — one image / depth / labels grid per TableTop sample
  annotate_demo_gt — propose and apply ground-truth masks for the demo
                   frames (GrabCut, flood fill and overlay text: OpenCV)
  collect_images_realsense — save synchronized RGB-D pairs from ROS topics

Each runs on cuda:<--gpu> unless given --device cpu (render_dataset,
make_real_fixtures, dataset_statistics and the five tools after it run on
the host); --fast selects the FAST_CLUSTER
preset and bfloat16 convolutions, train_net's --bf16 mixed precision.
"""
