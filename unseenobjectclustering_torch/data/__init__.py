"""Data: the procedural synthetic renderer (data.synthetic), the dataset
registry (data.factory), the threaded batch loader (data.loader) and the
device-resident scene cache (data.resident).

Host-side numpy, as in the JAX package; the training augmentation runs on
the device (ops/train_pipeline.py).  Only data.resident imports torch, so
the renderer's worker processes start without it."""
