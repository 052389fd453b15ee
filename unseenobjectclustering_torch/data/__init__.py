"""Data: the dataset readers (data.datasets: TableTop, OCID, OSD), the
procedural synthetic renderer (data.synthetic), the dataset registry
(data.factory), PCD IO (data.pcd) over the native IO library built from
native/ucio.cpp (data.native), the host augmentation (data.augmentation),
the threaded batch loader (data.loader) and the device-resident scene
cache (data.resident).

Host-side numpy, as in the JAX package; the device trainer's augmentation
runs on the card (ops/train_pipeline.py).  Only data.resident imports
torch, so the renderer's worker processes start without it; OpenCV is
imported only inside the functions that call it."""
