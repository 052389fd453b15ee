"""Two-stage unseen-object instance segmentation pipeline (PyTorch/CUDA).

Port of ``unseenobjectclustering_tpu/engine/pipeline.py``; the reference's
de-facto public API is ``test_sample`` (lib/fcn/test_dataset.py:232-267):

  stage 1: backbone forward -> unit-norm pixel embeddings -> vMF mean-shift
    clustering (the hand-written CUDA kernels on the card) with the depth
    validity filter fused into the assignment sweep.

  stage 2 (zoom-in refinement, with a crop network): per frame, dense
    relabel of the stage-1 ids -> RoI crops padded to a bucket of 8, 16 or
    MAX_INSTANCES slots, resized to 224^2 (ops/roi.py) -> the crop network
    on all slots at once -> mean-shift on each valid crop through the same
    four kernels -> veto + paste order on the device.

  paste-back (host, numpy): order-dependent overwrite by depth
    (ops/roi.paste_back; test_dataset.py:116-179).

  data-parallel stage 1 (segment_sharded): each process of a
    parallel.Mesh segments its frames of a batch on its card, and the
    labels are all-gathered.

  spatial stage 1 (make_spatial_stage1): one frame's columns split over
    the processes of a parallel.Mesh, with per-layer halo exchanges
    (parallel.spatial); the embeddings are all-gathered and every process
    clusters the whole frame with the four kernels.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.models import cast_convs, get_network
from unseenobjectclustering_torch.ops.mean_shift import mean_shift_smart_init
from unseenobjectclustering_torch.ops.roi import (_dense_relabel, crop_rois,
                                                  paste_back, veto_and_order)
from unseenobjectclustering_torch.parallel import spatial


class SegmentationResult(NamedTuple):
    """Outputs of one segmentation call (numpy, host-side)."""
    labels: np.ndarray                     # [B, H, W] int32 stage-1 labels
    labels_refined: Optional[np.ndarray]   # [B, H, W] int32 or None
    features: Optional[np.ndarray]         # [B, H, W, C] embeddings or None
    timing: dict


def resolve_device(device: Any = None) -> torch.device:
    """The explicit device, or the CUDA device when none is given.  Without
    a CUDA device this raises, unless the caller names another device:
    nothing moves to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


@contextlib.contextmanager
def _full_fp32():
    """float32 convolutions and matmuls at full float32 (no TF32) inside;
    the caller's two TF32 switches are restored on the way out."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _split(generator: torch.Generator) -> torch.Generator:
    """A fresh generator seeded from `generator`'s next draw (the port's
    counterpart of splitting a JAX PRNG key)."""
    sub = int(torch.randint(2 ** 62, (1,), generator=generator))
    return torch.Generator().manual_seed(sub)


def _cluster_batch(features: torch.Tensor,
                   generators: list[torch.Generator],
                   z_valid: Optional[torch.Tensor] = None,
                   filter_threshold: float = 0.0, **ms_kw) -> torch.Tensor:
    """Mean-shift cluster each image's pixel embeddings, one frame at a time.

    features: [B, H, W, C]; generators: one per frame.  z_valid [B, H, W]
    with filter_threshold fuses the depth-validity filter.  Returns
    [B, H, W] int32.
    """
    b, h, w, c = features.shape
    out = []
    for i in range(b):
        res = mean_shift_smart_init(
            features[i].reshape(h * w, c), generators[i],
            z_valid=None if z_valid is None else z_valid[i].reshape(h * w),
            filter_threshold=filter_threshold, **ms_kw)
        out.append(res.labels.reshape(h, w))
    return torch.stack(out)


def _cluster_crops(features: torch.Tensor, valid: list[bool],
                   generator: torch.Generator, **ms_kw) -> torch.Tensor:
    """Mean-shift cluster each RoI crop's embeddings, skipping the invalid
    padded slots.

    features: [M, S, S, C] on the device; valid: [M] on the host.  Each
    valid crop draws its own generator from `generator`, in slot order.
    Returns [M, S, S] int32, zeros in invalid slots.
    """
    m, s, _, c = features.shape
    out = torch.zeros((m, s, s), dtype=torch.int32, device=features.device)
    for i in range(m):
        if valid[i]:
            res = mean_shift_smart_init(features[i].reshape(s * s, c),
                                        _split(generator), **ms_kw)
            out[i] = res.labels.reshape(s, s)
    return out


class Segmentor:
    """Two-stage segmentation engine.

        seg = Segmentor(cfg, state_dict, state_dict_crop)
        result = seg.segment(image, xyz)   # normalized BGR + XYZ, NHWC

    ``state_dict`` / ``state_dict_crop`` are the main and zoom-in networks'
    weights in the reference key layout (``utils.checkpoint.
    state_dict_from_flax`` carries JAX weights over); they load with
    strict=True.  Without ``state_dict_crop`` there is no stage 2.  The
    convolutions run in float32, or in bfloat16 with
    model_dtype=torch.bfloat16 (BatchNorm and the embedding head's output
    stay float32).  float32 never runs as TF32: both TF32 switches are off
    for the length of each stage's call and restored after it, so the
    process's other torch code keeps its own settings.
    """

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 state_dict_crop: Optional[Mapping[str, torch.Tensor]] = None,
                 network_name: str = "seg_resnet34_8s_embedding",
                 crop_network_name: Optional[str] = None,
                 depth_threshold: Optional[float] = 0.8, seed: int = 3,
                 model_dtype: Optional[torch.dtype] = None,
                 device: Any = None):
        self.cfg = cfg
        self.device = resolve_device(device)

        def build(name, weights):
            model = get_network(name, cfg)
            model.load_state_dict(weights, strict=True)
            model.to(self.device)
            return cast_convs(model, model_dtype or torch.float32).eval()

        self.model = build(network_name, state_dict)
        self.model_crop = (build(crop_network_name or network_name,
                                 state_dict_crop)
                           if state_dict_crop is not None else None)
        # depth filter threshold: 0.5 OCID / 0.8 OSD & demo
        # (test_dataset.py:299-305,250-252); None disables.
        self.depth_threshold = depth_threshold
        self._generator = torch.Generator().manual_seed(seed)
        self._ms_kw = dict(kappa=float(cfg.CLUSTER.KAPPA),
                           num_seeds=int(cfg.CLUSTER.NUM_SEEDS),
                           max_iters=int(cfg.CLUSTER.MAX_ITERS),
                           epsilon=float(cfg.cluster_epsilon),
                           metric=str(cfg.TRAIN.EMBEDDING_METRIC),
                           use_pallas=bool(cfg.CLUSTER.USE_PALLAS),
                           seed_subsample=int(cfg.CLUSTER.SEED_SUBSAMPLE),
                           compute_dtype=str(cfg.CLUSTER.DTYPE))
        self.max_instances = int(cfg.CLUSTER.MAX_INSTANCES)
        self.crop_size = int(cfg.TRAIN.SYN_CROP_SIZE)
        # keep all-vetoed stage-1 instances instead of deleting them
        # (cfg.CLUSTER.REFINE_FALLBACK; ops/roi.paste_back)
        self.refine_fallback = bool(cfg.CLUSTER.REFINE_FALLBACK)
        # the crop batch is the smallest bucket that holds a frame's
        # instances: a frame with 5 runs the crop network on 8 slots, not
        # MAX_INSTANCES (the network's time scales with the slots), and
        # cuDNN sees at most three batch shapes
        self._buckets = sorted({b for b in (8, 16, self.max_instances)
                                if b <= self.max_instances})

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _lap(self, timing: Optional[dict], key: str, t0: float) -> float:
        """Add the seconds since t0 to timing[key] after a device sync (when
        timing is given); returns the time it read."""
        if timing is None:
            return t0
        self._sync()
        now = time.perf_counter()
        timing[key] = timing.get(key, 0.0) + now - t0
        return now

    @torch.inference_mode()
    @_full_fp32()
    def _stage1_impl(self, img: Optional[torch.Tensor],
                     xyz: Optional[torch.Tensor],
                     generators: list[torch.Generator], *, threshold: float,
                     ms_kw: Optional[dict] = None,
                     timing: Optional[dict] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """img/xyz: [B, H, W, 3] on the device -> (features [B,H,W,C],
        labels [B,H,W] int32).  timing, if given, gets 'network' and
        'cluster' seconds (with a device sync between the two)."""
        t0 = time.perf_counter()
        features = self.model(img, xyz)
        t0 = self._lap(timing, "network", t0)
        ms_kw = ms_kw or self._ms_kw
        if xyz is not None and threshold > 0:
            labels = _cluster_batch(features, generators,
                                    z_valid=xyz[..., 2] > 0,
                                    filter_threshold=float(threshold),
                                    **ms_kw)
        else:
            labels = _cluster_batch(features, generators, **ms_kw)
        self._lap(timing, "cluster", t0)
        return features, labels

    @torch.inference_mode()
    @_full_fp32()
    def _stage2_impl(self, img: torch.Tensor, labels: torch.Tensor,
                     xyz: torch.Tensor, generator: torch.Generator, *,
                     has_depth: bool, max_instances: Optional[int] = None,
                     timing: Optional[dict] = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
        """One frame: RoI crops -> crop network -> per-crop clustering ->
        veto + paste order, on the device.

        img/xyz: [H, W, 3] (zeros for a missing modality); labels: [H, W]
        stage-1 labels.  Returns the small tensors the host paste needs:
        (labels_veto [M, S, S] int8, order_key [M] float32, rois [M, 4]
        int32, valid [M] bool).  timing, if given, gets 'stage2_crops',
        'stage2_network', 'stage2_cluster' and 'stage2_veto' seconds added
        (with a device sync between them).
        """
        max_instances = max_instances or self.max_instances
        num_seeds = int(self._ms_kw["num_seeds"])
        t0 = time.perf_counter()
        # after the depth filter the stage-1 ids can be sparse (e.g.
        # {0, 2, 11}) while crop_rois takes ids 1..max_instances: the dense
        # relabel makes every instance reachable (the reference crops
        # every unique id, test_dataset.py:68-70)
        labels = _dense_relabel(labels, max_id=num_seeds)
        crops = crop_rois(img, labels, xyz, max_instances=max_instances,
                          crop_size=self.crop_size)
        # the host picks the slots to cluster: the stage's one fetch before
        # its results, of M booleans
        valid = crops.valid.tolist()
        t0 = self._lap(timing, "stage2_crops", t0)
        input_type = self.cfg.INPUT
        feats = self.model_crop(
            crops.rgb_crops if input_type != "DEPTH" else None,
            crops.depth_crops if input_type != "COLOR" else None)
        t0 = self._lap(timing, "stage2_network", t0)
        labels_crop = _cluster_crops(feats, valid, generator, **self._ms_kw)
        t0 = self._lap(timing, "stage2_cluster", t0)
        labels_veto, order_key = veto_and_order(
            labels_crop, crops.mask_crops,
            crops.depth_crops[..., 2] if has_depth else None, crops.valid,
            max_labels=max(num_seeds + 1, 2))
        if not has_depth:
            # RoI-area ordering (test_dataset.py:138-145)
            x0, y0, x1, y1 = crops.rois.unbind(1)
            area = ((y1 - y0 + 1) * (x1 - x0 + 1)).float()
            order_key = torch.where(crops.valid, area, -torch.inf)
        self._lap(timing, "stage2_veto", t0)
        return labels_veto, order_key, crops.rois, crops.valid

    def _refine(self, img: torch.Tensor, labels: torch.Tensor,
                xyz: torch.Tensor, labels_np: np.ndarray,
                generator: torch.Generator, *, has_depth: bool,
                timing: Optional[dict] = None) -> np.ndarray:
        """Stage 2 of one frame and its paste-back.  labels_np is the host
        copy of the stage-1 labels (int32); returns the refined [H, W] in
        its dtype.
        timing, if given, also gets 'stage2_fetch' and 'stage2_paste'."""
        # the instance count picks the smallest bucket; the sparse -> dense
        # id remap itself runs on the device
        k = int((np.unique(labels_np) > 0).sum())
        bucket = next((b for b in self._buckets if b >= k),
                      self.max_instances)
        out = self._stage2_impl(img, labels, xyz, generator,
                                has_depth=has_depth, max_instances=bucket,
                                timing=timing)
        t0 = time.perf_counter()
        labels_veto, order_key, rois, valid = (t.cpu().numpy() for t in out)
        t0 = self._lap(timing, "stage2_fetch", t0)
        fallback = None
        if self.refine_fallback:
            # crop slot s holds dense id s+1, and the dense relabel maps
            # each present id to its presence rank: a searchsorted against
            # the sparse labels' uniques recovers the dense map on the host
            uniq = np.unique(labels_np)
            fallback = np.searchsorted(uniq, labels_np).astype(
                labels_np.dtype)
        refined = paste_back(labels_np, labels_veto, order_key, rois, valid,
                             fallback_labels=fallback)
        self._lap(timing, "stage2_paste", t0)
        return refined

    def _threshold(self) -> float:
        return (-1.0 if self.depth_threshold is None
                else float(self.depth_threshold))

    def _upload(self, image, xyz):
        """image/xyz [B, H, W, 3] (numpy or tensors, either may be None) on
        the device as float32, zero-padded bottom/right to multiples of 16;
        returns (img, xyz, (H, W))."""
        def to_device(a):
            if a is None:
                return None
            return torch.as_tensor(a, dtype=torch.float32).to(self.device)

        img_d, xyz_d = to_device(image), to_device(xyz)
        ref = img_d if img_d is not None else xyz_d
        orig_hw = (int(ref.shape[1]), int(ref.shape[2]))
        ph, pw = (-orig_hw[0]) % 16, (-orig_hw[1]) % 16
        if ph or pw:
            pad = (0, 0, 0, pw, 0, ph)  # C, W, H from the last dim back
            img_d = (torch.nn.functional.pad(img_d, pad)
                     if img_d is not None else None)
            xyz_d = (torch.nn.functional.pad(xyz_d, pad)
                     if xyz_d is not None else None)
        return img_d, xyz_d, orig_hw

    # -- public API -----------------------------------------------------------

    def next_key(self) -> torch.Generator:
        """A fresh generator for one frame's first seeds, split off the
        Segmentor's own (seeded) generator."""
        return _split(self._generator)

    def segment_sample(self, sample: dict, *, refine: bool = True,
                       return_features: bool = False) -> SegmentationResult:
        """A sample dict in, labels out (test_sample,
        lib/fcn/test_dataset.py:232-267).

        Accepts {'image_color': [H,W,3] or [B,H,W,3], 'depth': optional
        [.,H,W,3] XYZ} (normalized, NHWC; numpy arrays or tensors).
        """
        image = sample.get("image_color")
        depth = sample.get("depth")
        if image is not None and image.ndim == 3:
            image = image[None]
        if depth is not None and depth.ndim == 3:
            depth = depth[None]
        return self.segment(image, depth, refine=refine,
                            return_features=return_features)

    def segment(self, image, xyz=None, *, refine: bool = True,
                return_features: bool = False) -> SegmentationResult:
        """Segment a batch of preprocessed RGB-D frames.

        Args:
          image: [B, H, W, 3] normalized BGR (ops.preprocess.normalize_bgr)
            or None when cfg.INPUT == 'DEPTH'.
          xyz: [B, H, W, 3] XYZ point-cloud image or None for COLOR.
          refine: run stage 2 (when the Segmentor has a crop network).

        Inputs whose H/W are not multiples of 16 are zero-padded
        bottom/right and the outputs cropped back (lib/utils/blob.py:48-71):
        both stages run on the padded frame, whose padded depth is z=0, so
        pad-region clusters fail the depth filter as in the reference.
        """
        timing: dict[str, float] = {}
        t0 = time.perf_counter()
        img_d, xyz_d, orig_hw = self._upload(image, xyz)
        b = (img_d if img_d is not None else xyz_d).shape[0]
        features, labels = self._stage1_impl(
            img_d, xyz_d, [self.next_key() for _ in range(b)],
            threshold=self._threshold(), timing=timing)
        labels_np = labels.cpu().numpy().astype(np.int32)
        timing["stage1"] = time.perf_counter() - t0

        labels_refined = None
        if refine and self.model_crop is not None:
            t1 = time.perf_counter()
            refined = []
            for i in range(b):
                img_i = (img_d[i] if img_d is not None
                         else torch.zeros_like(xyz_d[i]))
                xyz_i = (xyz_d[i] if xyz_d is not None
                         else torch.zeros_like(img_d[i]))
                refined.append(self._refine(
                    img_i, labels[i], xyz_i, labels_np[i], self.next_key(),
                    has_depth=xyz_d is not None, timing=timing))
            labels_refined = np.stack(refined)
            timing["stage2"] = time.perf_counter() - t1
        timing["total"] = time.perf_counter() - t0

        h, w = orig_hw  # crop back to the caller's (H, W)
        labels_np = labels_np[:, :h, :w]
        if labels_refined is not None:
            labels_refined = labels_refined[:, :h, :w]
        feats_np = None
        if return_features:
            feats_np = features[:, :h, :w].float().cpu().numpy()
        return SegmentationResult(labels=labels_np,
                                  labels_refined=labels_refined,
                                  features=feats_np, timing=timing)

    def make_sharded_stage1(self, mesh):
        """Data-parallel stage 1 over a parallel.Mesh: each rank runs the
        per-frame program on its frames of the batch (eval BatchNorm is
        per frame, so the ranks exchange nothing but the labels) and the
        labels are all-gathered.

        Returns fn(image, xyz, generators) -> labels [B, H, W] int32 on
        the Segmentor's device, the same on every rank: image/xyz are the
        global batch [B, H, W, 3] (numpy or tensors, on any device; a rank
        uploads only its frames), generators one per frame.  Rank r takes
        frames [r * ceil(B/W), (r + 1) * ceil(B/W)) of B, so B need not
        divide over the W ranks.  Each frame's labels are those stage 1
        gives it with its generator in Segmentor.segment on the rank's
        frames.  The network's kernels may differ with the batch size
        (cuDNN and oneDNN choose by shape), so a frame's embeddings in
        another batch can differ in the last bits (float32) or by ~1e-2
        (bfloat16), and labels at near-tie pixels with them.
        """
        def fn(image, xyz, generators):
            ref = image if image is not None else xyz
            b, h, w = (int(n) for n in ref.shape[:3])
            per = -(-b // mesh.world)
            lo, hi = min(b, mesh.rank * per), min(b, (mesh.rank + 1) * per)
            labels = torch.zeros((per, h, w), dtype=torch.int32,
                                 device=self.device)
            if hi > lo:
                img_d, xyz_d, _ = self._upload(
                    None if image is None else image[lo:hi],
                    None if xyz is None else xyz[lo:hi])
                _, local = self._stage1_impl(img_d, xyz_d,
                                             generators[lo:hi],
                                             threshold=self._threshold())
                labels[:hi - lo] = local[:, :h, :w]
            if mesh.world > 1:
                parts = [torch.empty_like(labels) for _ in range(mesh.world)]
                dist.all_gather(parts, labels)
                labels = torch.cat(parts)
            return labels[:b]

        return fn

    def make_spatial_stage1(self, mesh):
        """Single-frame latency route: stage 1 with each frame's width split
        over the ranks of a parallel.Mesh (the JAX package's
        make_spatial_stage1, which leaves the split to XLA's SPMD
        partitioner).

        Returns fn(image, xyz, generators) -> (features [B, H, W, C],
        labels [B, H, W] int32), both whole and equal on every rank, on
        the Segmentor's device.  Every rank passes the same preprocessed
        frames (numpy or tensors, on any device; image or xyz None as in
        _stage1_impl) and the same generators, one per frame.  Rank r
        uploads its band of W / world columns and the first layer's halo,
        runs the network on it with each layer exchanging its own halo
        with the neighbours (parallel.spatial), all-gathers the embedding
        columns, and clusters the whole frame as _stage1_impl does (the
        Segmentor's _ms_kw, the depth filter on the whole frame's z > 0):
        on the card, through the four kernels.  The JAX function clusters
        with its plain XLA path only because Pallas kernels do not
        partition; here each rank holds the whole frame's embeddings.

        The width rule (a difference kept on purpose; JAX needs W
        divisible by the mesh only): W splits into bands whose width is a
        multiple of the network's total stride (8 ResNet-8s, 16 U-Net, 32
        VGG) and, at the lowest resolution, at least its widest halo (4
        columns for ResNet-8s); otherwise fn raises.  The features agree
        with _stage1_impl's to rounding (the convolutions sum the same
        terms in the layout cuDNN or oneDNN picks for the band's shape),
        and the labels wherever those bits do not decide a near-tie.  At
        world size 1 the same sharded layers run with the frame's edge
        padding only."""
        plan = spatial.plan_network(self.model)
        threshold = self._threshold()

        @torch.inference_mode()
        @_full_fp32()
        def fn(image, xyz, generators):
            ref = image if image is not None else xyz
            shard = spatial.SpatialShard(mesh, int(ref.shape[2]), plan)
            with shard.active():
                band = self.model(shard.upload(image, self.device),
                                  shard.upload(xyz, self.device))
            features = shard.gather_columns(band)
            if xyz is not None and threshold > 0:
                z = torch.as_tensor(xyz[..., 2]).to(self.device)
                labels = _cluster_batch(features, generators, z_valid=z > 0,
                                        filter_threshold=threshold,
                                        **self._ms_kw)
            else:
                labels = _cluster_batch(features, generators, **self._ms_kw)
            return features, labels

        return fn

    def segment_sharded(self, mesh, image, xyz=None) -> np.ndarray:
        """Stage-1 labels of a batch segmented across the ranks of a
        parallel.Mesh (throughput-oriented dataset evaluation; no stage 2).
        Every rank passes the same global batch and draws its B generators
        in segment's order, so each frame's labels equal those of
        segment(refine=False) from a Segmentor with the same seed on the
        same frames (at world size 1, the whole batch; see
        make_sharded_stage1 on other batch sizes).  Returns [B, H, W]
        int32 on every rank."""
        b = (image if image is not None else xyz).shape[0]
        generators = [self.next_key() for _ in range(b)]
        labels = self.make_sharded_stage1(mesh)(image, xyz, generators)
        return labels.cpu().numpy()
