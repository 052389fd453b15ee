"""Configuration for the PyTorch/CUDA port.

The port's own copy of the JAX package's frozen ``Config`` (same key
inventory, strict YAML merge and ``CLUSTER`` section), so the port imports
nothing of the JAX package.  The reference (NVlabs/UnseenObjectClustering)
uses an ambient module-global ``easydict`` cfg mutated by YAML files
(``lib/fcn/config.py:24-441``); here an explicit frozen ``Config`` object is
threaded through every API.

Key semantics preserved from the reference:
  * strict merge: unknown keys or type mismatches raise
    (``lib/fcn/config.py:407-433``)
  * the full default key inventory, so any shipped YAML loads unchanged
  * ``PIXEL_MEANS`` BGR ordering (``lib/fcn/config.py:376``)

``CLUSTER.USE_PALLAS`` keeps its name so recipes load unchanged; in the port
it means "run the clustering through the hand-written CUDA kernels"
(``ops/cuda_seeding.py``, ``ops/cuda_mean_shift.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import yaml

# ---------------------------------------------------------------------------
# Default key inventory.
#
# This mirrors the semantic content of the reference defaults
# (lib/fcn/config.py:24-392).  Values are plain Python (tuples for sequences);
# PIXEL_MEANS is stored as a tuple and exposed as ndarray on Config.
# ---------------------------------------------------------------------------

_TRAIN_DEFAULTS: dict[str, Any] = {
    "WEIGHT_DECAY": 0.0001,
    "SEGMENTATION": True,
    "ITERNUM": 4,
    "HEATUP": 4,
    "GPUNUM": 1,
    "CLASSES": (0, 1, 2, 3),
    "SYMMETRY": (0, 0, 0, 0),
    "SLIM": False,
    "SINGLE_FRAME": False,
    "TRAINABLE": True,
    "VERTEX_REG": True,
    "VERTEX_REG_DELTA": False,
    "POSE_REG": True,
    "LABEL_W": 1.0,
    "VERTEX_W": 1.0,
    "VERTEX_W_INSIDE": 10.0,
    "POSE_W": 1.0,
    "BOX_W": 1.0,
    "HARD_LABEL_THRESHOLD": 1.0,
    "HARD_LABEL_SAMPLING": 1.0,
    "HARD_ANGLE": 15.0,
    "VISUALIZE": False,
    "GAN": False,
    "MATCHING": False,
    "NOISE_LEVEL": 0.05,
    "FREEZE_LAYERS": True,
    "MAX_ITERS_PER_EPOCH": 1000000,
    "UNIFORM_POSE_INTERVAL": 15,
    "AFFINE": False,
    "CHANGE_BACKGROUND": False,
    "FUSION_TYPE": "add",
    "HOUGH_LABEL_THRESHOLD": 100,
    "HOUGH_VOTING_THRESHOLD": -1,
    "HOUGH_SKIP_PIXELS": -1,
    "HOUGH_INLIER_THRESHOLD": 0.9,
    "SYNTHESIZE": False,
    "SYN_ONLINE": False,
    "SYN_WIDTH": 640,
    "SYN_HEIGHT": 480,
    "SYNROOT": "",
    "SYNITER": 0,
    "SYNNUM": 80000,
    "SYN_RATIO": 1,
    "SYN_CLASS_INDEX": 1,
    "SYN_TNEAR": 0.5,
    "SYN_TFAR": 2.0,
    "SYN_BACKGROUND_SPECIFIC": False,
    "SYN_BACKGROUND_SUBTRACT_MEAN": False,
    "SYN_BACKGROUND_CONSTANT_PROB": 0.1,
    "SYN_BACKGROUND_AFFINE": False,
    "SYN_SAMPLE_OBJECT": True,
    "SYN_SAMPLE_POSE": True,
    "SYN_STD_ROTATION": 15,
    "SYN_STD_TRANSLATION": 0.05,
    "SYN_MIN_OBJECT": 5,
    "SYN_MAX_OBJECT": 8,
    "SYN_BOUND": 0.4,
    "SYN_SAMPLE_DISTRACTOR": True,
    "SYN_CROP": False,
    "SYN_CROP_SIZE": 224,
    "SYN_TABLE_PROB": 0.8,
    "BOOSTRAP_PIXELS": 20,
    "ADAPT": False,
    "ADAPT_ROOT": "",
    "ADAPT_NUM": 400,
    "ADAPT_RATIO": 1,
    "ADAPT_WEIGHT": 0.1,
    "OPTIMIZER": "MOMENTUM",
    "LEARNING_RATE": 0.0001,
    "MILESTONES": (100, 150, 200),
    "MOMENTUM": 0.9,
    "BETA": 0.999,
    "GAMMA": 0.1,
    "SYMSIZE": 0,
    "GRID_SIZE": 256,
    "SCALES_BASE": (0.25, 0.5, 1.0, 2.0, 3.0),
    "CHROMATIC": True,
    "ADD_NOISE": False,
    # RealSense-style structured depth dropout during training (ours, not
    # in the reference — it trains on clean TOD depth but deploys on raw
    # RealSense frames): stereo-occlusion edge shadows + glossy blobs +
    # border bands (data/augmentation.add_realsense_artifacts and the
    # device twin ops/train_pipeline.add_depth_artifacts_device)
    "DEPTH_ARTIFACTS": False,
    "IMS_PER_BATCH": 2,
    "NUM_STEPS": 5,
    "NUM_UNITS": 64,
    "USE_FLIPPED": True,
    "SNAPSHOT_EPOCHS": 1,
    "SNAPSHOT_PREFIX": "caffenet_fast_rcnn",
    "SNAPSHOT_INFIX": "",
    "DISPLAY": 20,
    "ITERS": 0,
    "USE_GT": False,
    "BATCH_SIZE": 128,
    "FG_FRACTION": 0.25,
    "FG_THRESH": 0.5,
    "FG_THRESH_POSE": 0.2,
    "BG_THRESH_HI": 0.5,
    "BG_THRESH_LO": 0.1,
    "HAS_RPN": True,
    "RPN_POSITIVE_OVERLAP": 0.7,
    "RPN_NEGATIVE_OVERLAP": 0.3,
    "RPN_CLOBBER_POSITIVES": False,
    "RPN_FG_FRACTION": 0.5,
    "RPN_BATCHSIZE": 256,
    "RPN_NMS_THRESH": 0.7,
    "RPN_PRE_NMS_TOP_N": 12000,
    "RPN_POST_NMS_TOP_N": 2000,
    "RPN_BBOX_INSIDE_WEIGHTS": (1.0, 1.0, 1.0, 1.0),
    "RPN_POSITIVE_WEIGHT": -1.0,
    "BBOX_NORMALIZE_TARGETS": True,
    "BBOX_INSIDE_WEIGHTS": (1.0, 1.0, 1.0, 1.0),
    "BBOX_NORMALIZE_TARGETS_PRECOMPUTED": True,
    "BBOX_NORMALIZE_MEANS": (0.0, 0.0, 0.0, 0.0),
    "BBOX_NORMALIZE_STDS": (0.1, 0.1, 0.2, 0.2),
    # embedding learning (lib/fcn/config.py:250-265)
    "EMBEDDING_PRETRAIN": True,
    "EMBEDDING_SAMPLING": False,
    "EMBEDDING_SAMPLING_NUM": 1000,
    "EMBEDDING_ALPHA": 0.02,
    "EMBEDDING_DELTA": 0.5,
    "EMBEDDING_LAMBDA_INTRA": 1.0,
    "EMBEDDING_LAMBDA_INTER": 1.0,
    "EMBEDDING_CONTRASTIVE": False,
    "EMBEDDING_PIXELWISE": False,
    "EMBEDDING_PROTOTYPE": False,
    "EMBEDDING_METRIC": "euclidean",
    "EMBEDDING_NORMALIZATION": True,
    "EMBEDDING_LOSS_WEIGHT_MATCH": 1.0,
    "EMBEDDING_LOSS_WEIGHT_NONMATCH": 1.0,
    "EMBEDDING_LOSS_WEIGHT_BACKGROUND": 1.0,
    # VGG/U-Net DSL batch_norm flag (SEG.py:28 constructor arg; the
    # reference never sets it from a recipe, so the default matches)
    "VGG_BATCH_NORM": False,
    # region-refinement mask-augmentation distributions (lib/fcn/config.py:267-307)
    "max_augmentation_tries": 10,
    "padding_alpha": 1.0,
    "padding_beta": 4.0,
    "min_padding_percentage": 0.05,
    "max_padding_percentage": 0.5,
    "rate_of_morphological_transform": 0.9,
    "label_dilation_alpha": 1.0,
    "label_dilation_beta": 19.0,
    "morphology_max_iters": 3,
    "rate_of_translation": 0.7,
    "translation_alpha": 1.0,
    "translation_beta": 19.0,
    "translation_percentage_min": 0.05,
    "rate_of_rotation": 0.7,
    "rotation_angle_max": 10,
    "rate_of_label_adding": 0.5,
    "add_percentage_min": 0.1,
    "add_percentage_max": 0.4,
    "rate_of_label_cutting": 0.3,
    "cut_percentage_min": 0.25,
    "cut_percentage_max": 0.5,
    "rate_of_ellipses": 0.8,
    "num_ellipses_mean": 3,
    "ellipse_gamma_base_shape": 1.0,
    "ellipse_gamma_base_scale": 1.0,
    "ellipse_size_percentage": 0.1,
}

_TEST_DEFAULTS: dict[str, Any] = {
    "GLOBAL_SEARCH": False,
    "SEGMENTATION": True,
    "SINGLE_FRAME": False,
    "VERTEX_REG_2D": False,
    "VERTEX_REG_3D": False,
    "VISUALIZE": False,
    "RANSAC": False,
    "GAN": False,
    "POSE_REG": False,
    "POSE_REFINE": False,
    "POSE_SDF": True,
    "POSE_CODEBOOK": False,
    "SYNTHESIZE": False,
    "ROS_CAMERA": "camera",
    "DET_THRESHOLD": 0.5,
    "BUILD_CODEBOOK": False,
    "IMS_PER_BATCH": 1,
    "MEAN_SHIFT": False,
    "CHECK_SIZE": False,
    "NUM_SDF_ITERATIONS_INIT": 100,
    "NUM_SDF_ITERATIONS_TRACKING": 50,
    "SDF_TRANSLATION_REG": 10.0,
    "SDF_ROTATION_REG": 0.1,
    "NUM_LOST": 3,
    "ALIGN_Z_AXIS": False,
    "GEN_DATA": False,
    "HOUGH_LABEL_THRESHOLD": 100,
    "HOUGH_VOTING_THRESHOLD": -1,
    "HOUGH_SKIP_PIXELS": -1,
    "HOUGH_INLIER_THRESHOLD": 0.9,
    "CLASSES": (0, 1, 2, 3),
    "SYMMETRY": (0, 0, 0, 0),
    "ITERNUM": 4,
    "SCALES_BASE": (0.25, 0.5, 1.0, 2.0, 3.0),
    "GRID_SIZE": 256,
    "RPN_NMS_THRESH": 0.7,
    "RPN_PRE_NMS_TOP_N": 6000,
    "RPN_POST_NMS_TOP_N": 300,
    "BBOX_REG": True,
    "NMS": 0.3,
}

# Clustering section (not in the reference).  Values chosen to match the
# reference's hardcoded constants (lib/fcn/test_dataset.py:51,
# lib/utils/mean_shift.py:123,192).
_CLUSTER_DEFAULTS: dict[str, Any] = {
    "KAPPA": 20.0,
    "NUM_SEEDS": 100,
    "MAX_ITERS": 10,
    # epsilon for seed connected-components = 2 * EMBEDDING_ALPHA is derived
    # at build time; override here with a positive value.
    "EPSILON": -1.0,
    # static bound on instances surviving stage-1 (zoom-in refinement batch)
    "MAX_INSTANCES": 32,
    # pixel-axis subsampling stride for farthest-point seeding (1 = parity)
    "SEED_SUBSAMPLE": 1,
    # run the cosine clustering phases through the hand-written CUDA kernels
    "USE_PALLAS": True,
    # compute dtype for the similarity matmuls: 'float32' or 'bfloat16'
    "DTYPE": "float32",
    # keep the stage-1 instance when ALL its zoom-in clusters fail the 50%
    # overlap veto instead of deleting it (match_label_crop,
    # lib/fcn/test_dataset.py:116-127 deletes — reference semantics stays
    # the default).  Under domain shift the two synthetic-trained networks
    # disagree on weak masks and the veto erases whole instances (real
    # demo frame 000005 refines to F=0.000 without this);
    # the fallback makes refinement >= stage-1 (docs/REAL_DEMO_EVAL.md).
    "REFINE_FALLBACK": False,
}

# The "fast" inference preset: bfloat16 similarity matmuls + stride-8
# farthest-point seeding (its quality against the fp32 stride-1 parity path
# is in docs/FAST_PARITY_S8.md).  Apply as
# cfg.replace(CLUSTER=dict(FAST_CLUSTER)).
FAST_CLUSTER: dict[str, Any] = {"DTYPE": "bfloat16", "SEED_SUBSAMPLE": 8}

_TOP_DEFAULTS: dict[str, Any] = {
    "FLIP_X": False,
    "INPUT": "RGBD",
    "NETWORK": "VGG16",
    "RIG": "",
    "CAD": "",
    "POSE": "",
    "BACKGROUND": "",
    "USE_GPU_NMS": True,
    "MODE": "TRAIN",
    "INTRINSICS": (),
    "DATA_PATH": "",
    "FLOW_HEIGHT": 512,
    "FLOW_WIDTH": 640,
    "ANCHOR_SCALES": (8, 16, 32),
    "ANCHOR_RATIOS": (0.5, 1, 2),
    "FEATURE_STRIDE": 16,
    "gpu_id": 0,
    "instance_id": 0,
    "PIXEL_MEANS": (102.9801, 115.9465, 122.7717),  # BGR
    "RNG_SEED": 3,
    "EPS": 1e-14,
    "EXP_DIR": "default",
    "GPU_ID": 0,
}


def default_dict() -> dict[str, Any]:
    """Full default config tree as nested plain dicts."""
    d = dict(_TOP_DEFAULTS)
    d["TRAIN"] = dict(_TRAIN_DEFAULTS)
    d["TEST"] = dict(_TEST_DEFAULTS)
    d["CLUSTER"] = dict(_CLUSTER_DEFAULTS)
    return d


def _merge(src: Mapping[str, Any], dst: dict[str, Any], path: str = "") -> None:
    """Strict recursive merge; parity with lib/fcn/config.py:407-433."""
    for k, v in src.items():
        here = f"{path}.{k}" if path else str(k)
        if k not in dst:
            raise KeyError(f"{here} is not a valid config key")
        cur = dst[k]
        if isinstance(cur, dict):
            if not isinstance(v, Mapping):
                raise ValueError(f"Type mismatch for config key {here}: "
                                 f"expected section, got {type(v).__name__}")
            _merge(v, cur, here)
            continue
        # normalize sequences: YAML lists/tuples are both accepted for tuple
        # defaults; the reference relies on !!python/tuple tags.  Elements
        # are coerced to the default's element type (a list of strings for
        # MILESTONES would otherwise silently break the LR schedule), and
        # PIXEL_MEANS must stay length 3 (it feeds a fixed [3]-broadcast in
        # the jit'd preprocess).  Other tuple keys (CLASSES, MILESTONES,
        # INTRINSICS, ...) are legitimately variable-length.
        if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            if k == "PIXEL_MEANS" and len(v) != 3:
                raise ValueError(
                    f"{here} must have exactly 3 (BGR) entries, got {len(v)}")
            if cur and isinstance(cur[0], (int, float)):
                elem_t = float if isinstance(cur[0], float) else int
                try:
                    v = [elem_t(e) for e in v]
                except (TypeError, ValueError):
                    raise ValueError(
                        f"Elements of {here} must be {elem_t.__name__}, "
                        f"got {v!r}") from None
            dst[k] = tuple(v)
            continue
        # int is acceptable where float expected (YAML 1 vs 1.0)
        if isinstance(cur, float) and isinstance(v, int) and not isinstance(v, bool):
            dst[k] = float(v)
            continue
        if type(cur) is not type(v):
            raise ValueError(
                f"Type mismatch ({type(cur).__name__} vs. {type(v).__name__}) "
                f"for config key: {here}")
        dst[k] = v


class _TupleSafeLoader(yaml.SafeLoader):
    """SafeLoader that understands the !!python/tuple tags used by the
    reference's shipped YAML files (experiments/cfgs/*.yml)."""


_TupleSafeLoader.add_constructor(
    "tag:yaml.org,2002:python/tuple",
    lambda loader, node: tuple(loader.construct_sequence(node)))


def _canon_numbers(v: Any) -> Any:
    """Map every numeric leaf (bool/int/float) to float so values that
    compare equal under dict __eq__ (1 == 1.0 == True) serialize — and
    therefore hash — identically."""
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, dict):
        return {k: _canon_numbers(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_canon_numbers(x) for x in v]
    return v


class Section:
    """Read-only attribute view over one config section."""

    __slots__ = ("_d",)

    def __init__(self, d: Mapping[str, Any]):
        object.__setattr__(self, "_d", dict(d))

    def __getattr__(self, name: str) -> Any:
        try:
            return self._d[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> Any:
        return self._d[name]

    def __contains__(self, name: str) -> bool:
        return name in self._d

    def __setattr__(self, name: str, value: Any):
        raise AttributeError("Config sections are immutable; use replace()")

    def to_dict(self) -> dict[str, Any]:
        return dict(self._d)

    def __eq__(self, other) -> bool:
        if isinstance(other, Section):
            return self._d == other._d
        if isinstance(other, Mapping):
            return self._d == dict(other)
        return NotImplemented

    def __hash__(self):
        # same canonical form Config hashes (and __eq__ compares): numeric
        # leaves normalized to float, JSON text otherwise
        import json

        return hash(json.dumps(_canon_numbers(self._d), sort_keys=True,
                               default=list))

    def __repr__(self) -> str:
        return f"Section({self._d!r})"


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen view of the merged config tree.

    Attribute surface mirrors the ambient cfg of the reference
    (``cfg.INPUT``, ``cfg.TRAIN.EMBEDDING_ALPHA``, ...) so call sites read the
    same, but the object is explicit and immutable.
    """

    _tree: dict[str, Any] = dataclasses.field(default_factory=default_dict)

    def __post_init__(self):
        # own the tree: a raw Config(tree) must not alias the caller's
        # mutable dict (mutating it would change a "frozen" config), and a
        # structurally empty tree should fail here, not at first attribute
        import copy

        tree = object.__getattribute__(self, "_tree")
        for section in ("TRAIN", "TEST", "CLUSTER"):
            if section not in tree:
                raise KeyError(
                    f"Config tree is missing the {section} section — "
                    "construct via Config.default()/from_dict()/from_yaml()")
        object.__setattr__(self, "_tree", copy.deepcopy(dict(tree)))

    def __hash__(self) -> int:
        # the frozen dataclass's auto-hash raises on the dict field; a
        # canonical-JSON hash lets Config ride as a jit static argument.
        # Numbers are canonicalized first: dict __eq__ treats 1 == 1.0 ==
        # True, so trees differing only in numeric type must hash equal or
        # Config silently misses jit caches when used as a static arg.
        import json

        return hash(json.dumps(_canon_numbers(self._tree), sort_keys=True,
                               default=list))

    def __eq__(self, other) -> bool:
        return isinstance(other, Config) and self._tree == other._tree

    # -- constructors -------------------------------------------------------
    @staticmethod
    def default() -> "Config":
        return Config(default_dict())

    @staticmethod
    def from_dict(overrides: Mapping[str, Any]) -> "Config":
        tree = default_dict()
        _merge(overrides, tree)
        return Config(tree)

    @staticmethod
    def from_yaml(path: str | os.PathLike) -> "Config":
        with open(path, "r") as f:
            overrides = yaml.load(f, Loader=_TupleSafeLoader)
        return Config.from_dict(overrides or {})

    @staticmethod
    def inference_default(**overrides: Any) -> "Config":
        """No-cfg default for the inference entry points.

        The reference's config.py default metric is 'euclidean', which
        matches no released checkpoint (all shipped recipes are cosine,
        experiments/cfgs/*.yml) and silently over-segments cosine-trained
        embeddings — so the tools default to the demo recipe instead.
        Extra overrides merge on top (e.g. INPUT='RGBD')."""
        cfg = Config.from_dict({"MODE": "TEST",
                                "TRAIN": {"EMBEDDING_METRIC": "cosine"}})
        return cfg.replace(**overrides) if overrides else cfg

    def replace(self, **overrides: Any) -> "Config":
        """Return a new Config with dotted or nested overrides applied.

        replace(INPUT='COLOR'), replace(TRAIN={'SYN_CROP': True}), or the
        dotted form replace(**{'TRAIN.SYN_CROP': True}).
        """
        import copy

        expanded: dict[str, Any] = {}
        for k, v in overrides.items():
            if "." in k:
                head, _, rest = k.partition(".")
                node = expanded.setdefault(head, {})
                for part in rest.split(".")[:-1]:
                    node = node.setdefault(part, {})
                node[rest.split(".")[-1]] = v
            else:
                # nested dicts merge with any dotted keys for the same
                # section instead of overwriting them; Mappings are copied
                # on insert so a later dotted key for the same section
                # mutates OUR staging dict, never the caller's override
                # object (replace(TRAIN={...}, **{'TRAIN.B': 2}) must not
                # write B into the caller's dict)
                if (isinstance(v, Mapping)
                        and isinstance(expanded.get(k), dict)):
                    expanded[k].update(copy.deepcopy(dict(v)))
                else:
                    expanded[k] = (copy.deepcopy(dict(v))
                                   if isinstance(v, Mapping) else v)
        tree = copy.deepcopy(self._tree)
        _merge(expanded, tree)
        return Config(tree)

    # -- accessors ----------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        # single mechanism for ALL keys, section or scalar (TRAIN/TEST/
        # CLUSTER previously had redundant properties); Section views are
        # cached so hot loops don't pay an O(section) dict copy per access
        tree = object.__getattribute__(self, "_tree")
        if name in tree:
            v = tree[name]
            if isinstance(v, dict):
                try:
                    cache = object.__getattribute__(self, "_sections")
                except AttributeError:
                    cache = {}
                    object.__setattr__(self, "_sections", cache)
                if name not in cache:
                    cache[name] = Section(v)
                return cache[name]
            return v
        raise AttributeError(name)

    @property
    def pixel_means(self) -> np.ndarray:
        """BGR pixel means as an ndarray of shape [3] (values 0..255)."""
        return np.asarray(self._tree["PIXEL_MEANS"], dtype=np.float32)

    @property
    def cluster_epsilon(self) -> float:
        """Seed-merging epsilon: 2*alpha unless overridden
        (lib/utils/mean_shift.py:123)."""
        eps = self._tree["CLUSTER"]["EPSILON"]
        if eps > 0:
            return float(eps)
        return 2.0 * float(self._tree["TRAIN"]["EMBEDDING_ALPHA"])

    def to_dict(self) -> dict[str, Any]:
        import copy

        return copy.deepcopy(self._tree)

    def __repr__(self) -> str:
        return f"Config(INPUT={self._tree['INPUT']!r}, EXP_DIR={self._tree['EXP_DIR']!r})"


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def get_output_dir(cfg: Config, dataset_name: str, root: str | None = None) -> str:
    """<repo>/output/<EXP_DIR>/<dataset>/ — parity with
    lib/fcn/config.py:395-405, which anchors at the fixed ROOT_DIR rather
    than the cwd (runs from different directories must find each other's
    snapshots)."""
    root = root or _REPO_ROOT
    return os.path.join(root, "output", cfg.EXP_DIR, dataset_name)
