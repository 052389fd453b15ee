"""Training engine: optimizer, train state, the train step with on-device
augmentation, the epoch loops and snapshots.

Port of ``unseenobjectclustering_tpu/engine/train.py`` (reference recipe
tools/train_net.py:130-160, lib/fcn/train.py:37-76):

  * Adam(lr, betas=(MOMENTUM, BETA)) or SGD(momentum) with L2 weight decay
    added to the gradient (torch.optim's own semantics, which the JAX
    package's optax chains reproduce).  The lr of each step is the
    schedule at the optimizer's step count, set before the update, as
    optax evaluates it.
  * MultiStepLR for SGD: lr * GAMMA^(#milestones passed), per epoch.
  * the loss is models.losses.embedding_loss on the embeddings.
  * one device, or one process per card (mesh=parallel.make_mesh()):
    each rank steps on its rows of the global batch; BatchNorm
    normalizes with the global batch's statistics and the loss takes the
    global batch's scalars (models.resnet, models.losses), and the
    gradients of the ranks' loss shares are summed, so every rank applies
    the gradient of the global loss, the one-device step's.  BatchNorm's
    running statistics follow flax's update (models.resnet.BatchNorm2d).
  * float32 steps run with TF32 off (the Segmentor's _full_fp32 rule);
    mixed precision (model_dtype=bfloat16) runs the convolutions in
    bfloat16 over float32 parameters, optimizer state, BatchNorm, loss and
    final normalize.

The raw and device-resident steps run the whole augmentation
(ops/train_pipeline.py) on the training device from a ``torch.Generator``
seeded per step with (seed * 1_000_003 + epoch * 97_003 + i) mod
(2^31 - 1), the JAX package's per-step key; scenes are shuffled with
RandomState(seed + epoch) in both the streaming and the resident loop, so
a run resumes on either without a change of data order.  Under a mesh
every rank draws the global batch's numbers and applies its own rows of
them, so the augmented global batch is the one-device batch.  Only rank 0
prints and writes snapshots.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.engine.pipeline import (_full_fp32,
                                                          resolve_device)
from unseenobjectclustering_torch.models import compute_convs_in, get_network
from unseenobjectclustering_torch.models.losses import embedding_loss
from unseenobjectclustering_torch.ops.train_pipeline import (
    make_device_augment, make_device_augment_crop)
from unseenobjectclustering_torch.parallel import (Mesh, data_parallel,
                                                   shard_batch)
from unseenobjectclustering_torch.parallel.distributed import (process_count,
                                                               process_index)
from unseenobjectclustering_torch.utils.checkpoint import save_checkpoint

Schedule = Callable[[int], float]
LOG_LINE = ("[%d/%d][%d/%d], loss %.4f, loss intra: %.4f, loss_inter %.4f, "
            "lr %.6f, time %.2f")


class TrainState:
    """The model (train mode), its optimizer, the optimizer's step count
    and the lr schedule baked into it (logged as applied)."""

    def __init__(self, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer, schedule: Schedule,
                 step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = int(step)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict[str, Any]:
        """What a snapshot holds: the step, the model's parameters and
        BatchNorm buffers, the optimizer's moments and step counts."""
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, payload: Mapping[str, Any]) -> None:
        """Exact resume from state_dict()'s payload (e.g. a snapshot)."""
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])


def step_seed(seed: int, epoch: int, i: int) -> int:
    """The per-step seed of the augmentation draws (the JAX package's
    PRNGKey argument)."""
    return (seed * 1_000_003 + epoch * 97_003 + i) % (2 ** 31 - 1)


def multistep_schedule(base_lr: float, milestones: Sequence[int],
                       gamma: float, steps_per_epoch: int,
                       start_epoch: int = 0) -> Schedule:
    """MultiStepLR: lr * gamma^(#epoch milestones passed), by optimizer
    step.  Milestones are epochs relative to start_epoch (the reference's
    ``milestones=[m - startepoch ...]``, tools/train_net.py:142); one
    boundary per distinct step, as optax's piecewise-constant schedule."""
    boundaries = {}
    for m in milestones:
        rel = (m - start_epoch) * steps_per_epoch
        if rel > 0:
            boundaries[rel] = gamma

    def schedule(count: int) -> float:
        lr = float(base_lr)
        for b, g in boundaries.items():
            if count >= b:
                lr *= g
        return lr

    return schedule


def make_optimizer(cfg: Config, params, solver: str = "adam",
                   steps_per_epoch: int = 1, start_epoch: int = 0
                   ) -> tuple[torch.optim.Optimizer, Schedule]:
    """The reference's optimizer (tools/train_net.py:135-142) over
    `params`, and its lr schedule."""
    if solver not in ("adam", "sgd"):
        raise ValueError(f"solver must be adam|sgd, got {solver!r}")
    lr = float(cfg.TRAIN.LEARNING_RATE)
    wd = float(cfg.TRAIN.WEIGHT_DECAY)
    if solver == "adam":
        def schedule(count: int) -> float:
            return lr
        opt = torch.optim.Adam(params, lr=lr,
                               betas=(float(cfg.TRAIN.MOMENTUM),
                                      float(cfg.TRAIN.BETA)),
                               weight_decay=wd)
    else:
        schedule = multistep_schedule(lr, cfg.TRAIN.MILESTONES,
                                      float(cfg.TRAIN.GAMMA),
                                      steps_per_epoch, start_epoch)
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=float(cfg.TRAIN.MOMENTUM),
                              weight_decay=wd)
    return opt, schedule


def create_train_state(cfg: Config, *, network_name: str,
                       solver: str = "adam", steps_per_epoch: int = 1,
                       start_epoch: int = 0, seed: int = 3,
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       model_dtype: Optional[torch.dtype] = None,
                       device: Any = None) -> TrainState:
    """The network (from `state_dict`, or torch's init seeded with `seed`)
    on `device` (default: the CUDA device; raises without one) in train
    mode, and its optimizer.  A dropout layer's generator is seeded with
    `seed` on the device.  model_dtype=bfloat16 computes the
    convolutions in bfloat16 (mixed precision)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = get_network(network_name, cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    device = resolve_device(device)
    model.to(device)
    for mod in model.modules():  # VGG's dropout draws from its own
        if hasattr(mod, "dropout_generator"):
            mod.dropout_generator = torch.Generator(
                device=device).manual_seed(seed)
    compute_convs_in(model, model_dtype)
    model.train()
    opt, schedule = make_optimizer(cfg, model.parameters(), solver,
                                   steps_per_epoch, start_epoch)
    return TrainState(model, opt, schedule)


def _loss_kw(cfg: Config, max_k: int) -> dict:
    return dict(alpha=float(cfg.TRAIN.EMBEDDING_ALPHA),
                delta=float(cfg.TRAIN.EMBEDDING_DELTA),
                lambda_intra=float(cfg.TRAIN.EMBEDDING_LAMBDA_INTRA),
                lambda_inter=float(cfg.TRAIN.EMBEDDING_LAMBDA_INTER),
                max_k=max_k, metric=str(cfg.TRAIN.EMBEDDING_METRIC))


def _data_parallel(mesh: Optional[Mesh]) -> bool:
    """Whether a step runs on a rank's share of a global batch.  The mesh
    must be the process group's (its ranks reduce over the group): a
    process group of more than one rank without a mesh, or a mesh whose
    rank or world is not the group's, is refused (its ranks would apply
    different gradients)."""
    if mesh is None and process_count() > 1:
        raise ValueError("a train step under a process group of more than "
                         "one rank needs mesh=parallel.make_mesh()")
    if mesh is not None and mesh[:2] != (process_index(), process_count()):
        raise ValueError(f"mesh rank {mesh.rank} of {mesh.world} is not "
                         f"the process group's rank {process_index()} of "
                         f"{process_count()}")
    return mesh is not None and mesh.world > 1


def _sum_gradients(model: torch.nn.Module) -> None:
    """Each parameter's gradient summed over the ranks, in one all-reduce
    of the flattened gradients."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def train_step(state: TrainState, img: Optional[torch.Tensor],
               xyz: Optional[torch.Tensor], label: torch.Tensor, *,
               alpha: float, delta: float, lambda_intra: float,
               lambda_inter: float, max_k: int = 32, metric: str = "cosine",
               mark: Optional[Callable[[str], None]] = None,
               mesh: Optional[Mesh] = None
               ) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimization step on a batch already on the state's device:
    forward in train mode, embedding loss, backward, the schedule's lr,
    the update.  Returns (state, {"loss", "intra", "inter"}) with the
    metrics as 0-d tensors on the device (no host sync).  `mark`, when
    given, is called with "forward_backward" after the backward pass and
    "optimizer" after the update.

    With a mesh of more than one rank the batch is this rank's rows of the
    global batch: the loss is the rank's share, the gradients are summed
    over the ranks before the update and the metrics are the global
    batch's, as one device's step on the whole batch gives them."""
    parallel = _data_parallel(mesh)
    # BatchNorm, the loss and dropout read the data-parallel mesh from here
    with _full_fp32(), data_parallel(mesh if parallel else None):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        features = state.model(img, xyz)
        out = embedding_loss(features, label, alpha=alpha, delta=delta,
                             lambda_intra=lambda_intra,
                             lambda_inter=lambda_inter, max_k=max_k,
                             metric=metric)
        out.loss.backward()
        if mark is not None:
            mark("forward_backward")
        metrics = torch.stack([out.loss, out.intra, out.inter]).detach()
        if parallel:
            _sum_gradients(state.model)
            dist.all_reduce(metrics)
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        if mark is not None:
            mark("optimizer")
    return state, dict(zip(("loss", "intra", "inter"), metrics.unbind()))


def make_train_step(cfg: Config, max_k: int = 32):
    """step(state, img, xyz, label) with the config's loss settings."""
    kw = _loss_kw(cfg, max_k)

    def step(state, img, xyz, label, mark=None, mesh=None):
        return train_step(state, img, xyz, label, mark=mark, mesh=mesh,
                          **kw)

    return step


def _rank_draws(draw, gen, bgr, draws, mesh):
    """This rank's rows of the global batch's draws: `draws` when given,
    else drawn from `gen` for the global batch (bgr holds this rank's rows
    of it; a draw reads only the batch's shape and device)."""
    parallel = _data_parallel(mesh)
    if draws is None:
        b = bgr.shape[0] * (mesh.world if parallel else 1)
        draws = draw(gen, bgr[:1].expand(b, *bgr.shape[1:]))
    return shard_batch(draws, mesh) if parallel else draws


def make_train_step_raw(cfg: Config, *, fx: float, fy: float, px: float,
                        py: float, max_k: int = 32,
                        crop: Optional[bool] = None):
    """Augmentation + optimization step for raw scene batches on the
    state's device:

      step(state, bgr_u8 [B,H,W,3], depth_mm [B,H,W], label_u8 [B,H,W],
           gen=None, draws=None, mark=None, mesh=None) -> (state, metrics)

    The augmentation's random numbers are drawn from `gen` (a
    torch.Generator on the batch's device), or given as `draws` (the
    pinned draws of another run).  crop selects the zoom-in recipe
    (default: cfg.TRAIN.SYN_CROP).  `mark("augment")` follows the
    augmentation.  With a mesh of more than one rank the scenes are this
    rank's rows of the global batch, and `draws` (given or drawn from
    `gen`) are the global batch's: the step applies the rank's rows of
    them.
    """
    crop = bool(cfg.TRAIN.SYN_CROP) if crop is None else crop
    build = make_device_augment_crop if crop else make_device_augment
    draw, apply = build(cfg, fx=fx, fy=fy, px=px, py=py)
    kw = _loss_kw(cfg, max_k)

    def step(state, bgr, depth_mm, label_u8, gen=None, draws=None,
             mark=None, mesh=None):
        with _full_fp32():
            draws = _rank_draws(draw, gen, bgr, draws, mesh)
            img, xyz, label = apply(bgr, depth_mm, label_u8, draws)
        if mark is not None:
            mark("augment")
        return train_step(state, img, xyz, label, mark=mark, mesh=mesh,
                          **kw)

    step.draw = draw
    return step


def make_train_step_resident(cfg: Config, *, fx: float, fy: float,
                             px: float, py: float, max_k: int = 32,
                             crop: Optional[bool] = None):
    """The raw step behind an index gather, for scenes resident on the
    device (data.resident.load_resident_scenes):

      step(state, bgr_all [N,H,W,3], depth_all [N,H,W], label_all [N,H,W],
           idx [B] int64 on the device, gen, draws=None, mark=None,
           mesh=None)

    With a mesh, idx is this rank's rows of the global batch's indices.
    """
    inner = make_train_step_raw(cfg, fx=fx, fy=fy, px=px, py=py,
                                max_k=max_k, crop=crop)

    def step(state, bgr_all, depth_all, label_all, idx, gen=None,
             draws=None, mark=None, mesh=None):
        bgr = bgr_all.index_select(0, idx)
        depth_mm = depth_all.index_select(0, idx)
        label_u8 = label_all.index_select(0, idx)
        return inner(state, bgr, depth_mm, label_u8, gen=gen, draws=draws,
                     mark=mark, mesh=mesh)

    return step


def _generator(seed: int, epoch: int, i: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        step_seed(seed, epoch, i))


def _log(epoch, epochs, i, steps, metrics, lr, dt, mesh=None):
    if mesh is None or mesh.rank == 0:
        print(LOG_LINE % (epoch, epochs, i, steps, float(metrics["loss"]),
                          float(metrics["intra"]), float(metrics["inter"]),
                          lr, dt), flush=True)


def _maybe_snapshot(state, output_dir, epoch, epochs, snapshot_epochs, keep,
                    mesh=None):
    """A snapshot every snapshot_epochs and after the last epoch, written
    by rank 0 alone (its directory, commit marker and the `keep` rotation
    have one writer); the other ranks wait for it at a barrier."""
    if output_dir and ((epoch + 1) % snapshot_epochs == 0
                       or epoch == epochs - 1):
        if mesh is None or mesh.rank == 0:
            path = save_checkpoint(output_dir, epoch + 1, state.state_dict(),
                                   keep=keep)
            print(f"snapshot: {path}", flush=True)
        if mesh is not None and mesh.world > 1:
            dist.barrier()


def train_epochs(cfg: Config, state: TrainState, dataloader, *,
                 epochs: int, start_epoch: int = 0,
                 output_dir: Optional[str] = None, max_k: int = 32,
                 log_every: int = 20, snapshot_epochs: Optional[int] = None,
                 intrinsics: Optional[tuple] = None, seed: int = 3,
                 keep: int = 4, callback: Optional[Callable] = None,
                 mesh: Optional[Mesh] = None) -> TrainState:
    """Epoch loop over a loader (tools/train_net.py:146-160 +
    lib/fcn/train.py:37-76): the per-iteration log line, a snapshot every
    SNAPSHOT_EPOCHS and after the last epoch.  Batches are raw scene dicts
    ('bgr'/'depth_mm'/'label_raw', augmented on the device; needs
    `intrinsics` (fx, fy, px, py)) or augmented sample dicts
    ('image_color'/'depth'/'label').  callback(epoch, i, metrics) follows
    every step.  With a mesh of more than one rank the loader yields this
    rank's rows of each global batch (data.loader.DataLoader(mesh=mesh))
    and the state is the same on every rank (parallel.replicate)."""
    if (_data_parallel(mesh)
            and getattr(dataloader, "mesh", None) != mesh):
        raise ValueError("under a mesh the loader must yield this rank's "
                         "rows: DataLoader(..., mesh=mesh)")
    device = state.device
    step_fn = make_train_step(cfg, max_k=max_k)
    step_fn_raw = None
    snapshot_epochs = snapshot_epochs or int(cfg.TRAIN.SNAPSHOT_EPOCHS)

    def put(x):
        return None if x is None else torch.as_tensor(x).to(device)

    for epoch in range(start_epoch, epochs):
        if hasattr(dataloader, "set_epoch"):
            dataloader.set_epoch(epoch)
        epoch_size = len(dataloader)
        t_last = time.time()
        for i, batch in enumerate(dataloader):
            if "bgr" in batch:
                if step_fn_raw is None:
                    if intrinsics is None:
                        raise ValueError("raw batches need intrinsics=(fx, "
                                         "fy, px, py)")
                    fx, fy, px, py = intrinsics
                    step_fn_raw = make_train_step_raw(
                        cfg, fx=fx, fy=fy, px=px, py=py, max_k=max_k)
                depth = np.asarray(batch["depth_mm"]).astype(np.int32)
                state, metrics = step_fn_raw(
                    state, put(batch["bgr"]), put(depth),
                    put(batch["label_raw"]),
                    gen=_generator(seed, epoch, i, device), mesh=mesh)
            else:
                state, metrics = step_fn(
                    state, put(batch.get("image_color")),
                    put(batch.get("depth")), put(batch["label"]), mesh=mesh)
            if callback is not None:
                callback(epoch, i, metrics)
            if i % log_every == 0:
                dt, t_last = time.time() - t_last, time.time()
                _log(epoch, epochs, i, epoch_size, metrics,
                     state.schedule(state.step), dt, mesh)
        _maybe_snapshot(state, output_dir, epoch, epochs, snapshot_epochs,
                        keep, mesh)
    return state


def train_epochs_resident(cfg: Config, state: TrainState, scenes, *,
                          epochs: int, batch_size: int, start_epoch: int = 0,
                          output_dir: Optional[str] = None, max_k: int = 32,
                          log_every: int = 20,
                          snapshot_epochs: Optional[int] = None,
                          intrinsics: Optional[tuple] = None, seed: int = 3,
                          crop: Optional[bool] = None, keep: int = 4,
                          callback: Optional[Callable] = None,
                          mesh: Optional[Mesh] = None) -> TrainState:
    """Epoch loop over device-resident scenes (bgr_all, depth_all,
    label_all): each step sends only its index vector.  Scene order and
    augmentation seeds are train_epochs's with a DataLoader, so a
    streaming run can resume resident and the other way round.  With a
    mesh every rank holds all the scenes (load_resident_scenes(mesh=...))
    and gathers its rows of each step's shuffled indices; batch_size is
    the global batch."""
    bgr_all, depth_all, label_all = scenes
    n = int(bgr_all.shape[0])
    steps = n // batch_size
    if steps == 0:
        raise ValueError(
            f"{n} resident scenes < batch size {batch_size}: every epoch "
            "would run zero steps; lower --batch_size or raise "
            "--resident-limit")
    if intrinsics is None:
        raise ValueError("train_epochs_resident needs intrinsics=(fx, fy, "
                         "px, py) for the backprojection")
    fx, fy, px, py = intrinsics
    device = bgr_all.device
    step_fn = make_train_step_resident(cfg, fx=fx, fy=fy, px=px, py=py,
                                       max_k=max_k, crop=crop)
    snapshot_epochs = snapshot_epochs or int(cfg.TRAIN.SNAPSHOT_EPOCHS)
    for epoch in range(start_epoch, epochs):
        order = np.arange(n)
        np.random.RandomState(seed + epoch).shuffle(order)
        t_last = time.time()
        for i in range(steps):
            idx = order[i * batch_size:(i + 1) * batch_size]
            if mesh is not None:
                idx = idx[mesh.batch_slice(batch_size)]
            state, metrics = step_fn(state, bgr_all, depth_all, label_all,
                                     torch.from_numpy(idx).to(device),
                                     gen=_generator(seed, epoch, i, device),
                                     mesh=mesh)
            if callback is not None:
                callback(epoch, i, metrics)
            if i % log_every == 0:
                dt, t_last = time.time() - t_last, time.time()
                _log(epoch, epochs, i, steps, metrics,
                     state.schedule(state.step), dt, mesh)
        _maybe_snapshot(state, output_dir, epoch, epochs, snapshot_epochs,
                        keep, mesh)
    return state
