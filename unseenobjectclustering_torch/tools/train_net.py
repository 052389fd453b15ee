"""Train an unseen-object embedding network (CLI parity with the reference
tools/train_net.py:30-160 and the JAX package's tools/train_net.py).

By default the loader serves host-augmented samples
(data/augmentation.py, as the JAX package's tool does, with numpy replicas
of its cv2 calls: no OpenCV needed).  --device-augment streams raw
synthetic scenes and augments them on the device, --device-resident reads
the whole render cache onto the device first.

One process trains on cuda:<--gpu> (or --device, e.g. cpu).  Data
parallelism runs one process per card under torchrun: each process trains
on cuda:<LOCAL_RANK> with its rows of every global batch (--batch_size is
the global batch, rounded up to a multiple of the process count), the
state replicated from rank 0, BatchNorm statistics and the loss taken over
the global batch and the gradients summed over the processes; rank 0
alone prints and writes snapshots.  parallel.initialize also reads the
JAX package's COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID.

Example:
  python -m unseenobjectclustering_torch.tools.render_dataset \\
      --cache-dir output/render_cache --num 64
  python -m unseenobjectclustering_torch.tools.train_net \\
      --network seg_resnet34_8s_embedding --dataset synthetic_tabletop_train \\
      --cfg experiments/cfgs/seg_resnet34_8s_embedding_cosine_rgbd_add_tabletop.yml \\
      --solver adam --epochs 16 --device-resident \\
      --render-cache output/render_cache --resident-limit 64
  torchrun --standalone --nproc_per_node 8 \
      -m unseenobjectclustering_torch.tools.train_net <the same arguments>
"""

from __future__ import annotations

import argparse
import os
import pprint
import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from unseenobjectclustering_torch.config import Config, get_output_dir
from unseenobjectclustering_torch.data.factory import get_dataset
from unseenobjectclustering_torch.data.loader import DataLoader
from unseenobjectclustering_torch.data.resident import load_resident_scenes
from unseenobjectclustering_torch.engine.builder import load_network_state
from unseenobjectclustering_torch.engine.train import (TrainState,
                                                       create_train_state,
                                                       train_epochs,
                                                       train_epochs_resident)
from unseenobjectclustering_torch.parallel import (initialize, make_mesh,
                                                   replicate)
from unseenobjectclustering_torch.parallel.distributed import process_count
from unseenobjectclustering_torch.utils.checkpoint import restore_checkpoint


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train an unseen-object clustering network (PyTorch)")
    parser.add_argument("--epochs", type=int, default=16)
    parser.add_argument("--startepoch", type=int, default=0)
    parser.add_argument("--pretrained", type=str, default=None,
                        help="initial weights: a reference .pth, a "
                             "torchvision ImageNet resnet .pth, or a "
                             "snapshot directory")
    parser.add_argument("--resume", type=str, default=None,
                        help="snapshot directory: restore the full train "
                             "state (params, BatchNorm statistics, "
                             "optimizer, step) for an exact resume")
    parser.add_argument("--cfg", dest="cfg_file", type=str, default=None)
    parser.add_argument("--solver", type=str, default="sgd",
                        choices=("adam", "sgd"))
    parser.add_argument("--dataset", dest="dataset_name", type=str,
                        default="synthetic_tabletop_train")
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--rand", dest="randomize", action="store_true")
    parser.add_argument("--network", dest="network_name", type=str,
                        default="seg_resnet34_8s_embedding")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="override cfg.TRAIN.IMS_PER_BATCH")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--max_k", type=int, default=32,
                        help="static bound on GT instances per image")
    parser.add_argument("--bf16", action="store_true",
                        help="mixed precision: bfloat16 convolutions, "
                             "float32 params/optimizer/BatchNorm/loss")
    parser.add_argument("--device-augment", action="store_true",
                        help="stream raw cached scenes and augment them on "
                             "the device")
    parser.add_argument("--device-resident", action="store_true",
                        help="read the whole render cache onto the device "
                             "once (implies --device-augment)")
    parser.add_argument("--resident-limit", type=int, default=None,
                        help="cap on resident scenes")
    parser.add_argument("--render-cache", type=str, default=None,
                        help="scene cache directory of the procedural "
                             "renderer (tools.render_dataset)")
    parser.add_argument("--keep", type=int, default=4,
                        help="snapshots to retain")
    parser.add_argument("--output-dir", type=str, default=None,
                        help="snapshot directory (default: "
                             "output/<EXP_DIR>/<dataset>)")
    parser.add_argument("--gpu", dest="gpu_id", type=int, default=0,
                        help="train on cuda:<gpu> (one process; under "
                             "torchrun each process takes "
                             "cuda:<LOCAL_RANK>)")
    parser.add_argument("--device", type=str, default=None,
                        help="another device than cuda:<gpu> (cpu for the "
                             "tests)")
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        parser.print_help()
        sys.exit(1)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         callback: Optional[Callable] = None) -> TrainState:
    """Run the CLI; returns the final train state.  callback(epoch, i,
    metrics) follows every step."""
    args = parse_args(argv)
    initialize()
    mesh = make_mesh(args.device or (f"cuda:{args.gpu_id}"
                                     if process_count() == 1 else None))
    device = mesh.device
    log = print if mesh.rank == 0 else (lambda *a, **k: None)
    log("Called with args:")
    log(args)

    cfg = (Config.from_yaml(args.cfg_file) if args.cfg_file
           else Config.default())
    cfg = cfg.replace(MODE="TRAIN")
    log("Using config:")
    log(pprint.pformat(cfg.to_dict()))
    if not args.randomize:
        np.random.seed(cfg.RNG_SEED)

    dataset = get_dataset(args.dataset_name, cfg, path=args.dataset_root)
    if args.render_cache is not None:
        dataset.cache_dir = args.render_cache
    if args.device_resident:
        args.device_augment = True
    if args.device_augment:
        if not hasattr(dataset, "raw"):
            raise SystemExit(f"{args.dataset_name} has no raw scenes: "
                             "--device-augment takes the synthetic datasets")
        dataset.raw = True
    output_dir = args.output_dir or get_output_dir(cfg, dataset.name)
    log(f"Output will be saved to `{output_dir}`")

    batch = args.batch_size or int(cfg.TRAIN.IMS_PER_BATCH)
    if batch % mesh.world:
        batch = -(-batch // mesh.world) * mesh.world
        log(f"rounded batch to {batch} for {mesh.world} processes")
    loader = DataLoader(dataset, batch_size=batch, shuffle=True,
                        num_workers=args.workers, seed=int(cfg.RNG_SEED),
                        mesh=mesh)
    state_dict = load_network_state(cfg, args.network_name, args.pretrained)
    if args.device_resident:
        n_res = args.resident_limit or len(dataset)
        steps_per_epoch = max(n_res // batch, 1)
    else:
        steps_per_epoch = len(loader)
    # --startepoch alone restarts from bare weights with a fresh optimizer
    # count: milestones relative to it (the reference's convention);
    # --resume restores the absolute optimizer step: milestones absolute
    schedule_start = 0 if args.resume else args.startepoch
    state = create_train_state(
        cfg, network_name=args.network_name, solver=args.solver,
        steps_per_epoch=steps_per_epoch, start_epoch=schedule_start,
        state_dict=state_dict,
        model_dtype=torch.bfloat16 if args.bf16 else None, device=device)
    if args.resume:
        payload, ck_step = restore_checkpoint(args.resume)
        state.load_state_dict(payload)
        args.startepoch = max(args.startepoch, ck_step)
        log(f"=> resumed full train state at epoch {ck_step}")
    replicate(state, mesh)

    intrinsics = ((dataset.f, dataset.f, dataset.cx, dataset.cy)
                  if args.device_augment else None)
    common = dict(epochs=args.epochs, start_epoch=args.startepoch,
                  output_dir=output_dir, max_k=args.max_k,
                  intrinsics=intrinsics,
                  seed=int(cfg.RNG_SEED), keep=args.keep, callback=callback,
                  mesh=mesh)
    log(f"=> training on {device} (process 0 of {mesh.world})")
    if args.device_resident:
        if not getattr(dataset, "cache_dir", None):
            raise SystemExit("--device-resident needs an on-disk scene "
                             "cache: pass --render-cache DIR")
        dataset.check_cache_manifest()
        scenes = load_resident_scenes(
            os.path.dirname(dataset._scene_path(0)),
            limit=args.resident_limit or len(dataset), mesh=mesh)
        gib = sum(x.numel() * x.element_size() for x in scenes) / 2 ** 30
        log(f"=> device-resident: {int(scenes[0].shape[0])} scenes "
            f"({gib:.2f} GiB) on {device}")
        return train_epochs_resident(cfg, state, scenes, batch_size=batch,
                                     **common)
    return train_epochs(cfg, state, loader, **common)


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
