"""Typed configuration for the rig and the two models of the serving path.

Port of ``mpe3d_tpu/config.py`` (the joint vocabularies :15-34,
``RigConfig`` :45, the presets ``PANOPTIC`` :154 and ``ARPLAB`` :180 with
``get_rig`` :210, ``MatcherConfig`` :225, ``LifterConfig`` :260,
``MatcherTrainConfig`` :277, ``LifterTrainConfig`` :305).  A rig
preset holds every field of the reference's (``dataclasses.asdict`` of
both are equal); the model configs are cut to the fields the PyTorch
port reads (the reference's TPU serving switches are left out).  Kept as a copy so the port never imports the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple

# COCO-18 joint vocabulary (reference: skeleton_matching/graph_generator.py:63-67)
COCO_JOINT_NAMES: Tuple[str, ...] = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle", "neck",
)

# BODY_25 joint vocabulary (reference: skeleton_matching/graph_generator.py:68-74)
BODY25_JOINT_NAMES: Tuple[str, ...] = (
    "nose", "neck", "right_shoulder", "right_elbow", "right_hand",
    "left_shoulder", "left_elbow", "left_hand", "hip",
    "right_hip", "right_knee", "right_ankle", "left_hip",
    "left_knee", "left_ankle", "right_eye", "left_eye", "right_ear",
    "left_ear", "left_foot_ball", "left_toes", "left_heel",
    "right_foot_ball", "right_toes", "right_heel",
)

JOINT_NAMES_BY_FORMAT = {"COCO": COCO_JOINT_NAMES, "BODY_25": BODY25_JOINT_NAMES}


@dataclass(frozen=True)
class RigConfig:
    """A calibrated multi-camera rig.  Per-camera sequences are
    index-aligned with ``camera_names``."""

    name: str
    image_width: int
    image_height: int
    camera_names: Tuple[str, ...]
    fx: Tuple[float, ...]
    fy: Tuple[float, ...]
    cx: Tuple[float, ...]
    cy: Tuple[float, ...]
    kd0: Tuple[float, ...]
    kd1: Tuple[float, ...]
    kd2: Tuple[float, ...]
    p1: Tuple[float, ...]
    p2: Tuple[float, ...]
    used_cameras: Tuple[str, ...]
    used_cameras_skeleton_matching: Tuple[str, ...]
    used_joints: Tuple[int, ...]
    min_number_of_views: int = 2
    joint_format: str = "COCO"      # "COCO" (18 joints) or "BODY_25"
    numbers_per_joint: int = 14
    numbers_per_joint_for_loss: int = 4
    # default calibration file (pytransform3d pickle or JSON), relative to
    # the working directory; the CLI's --tm overrides it
    transformations_path: str = ""
    graph_alternative: str = "3"    # matcher graph: "1", "2" or "3"
    # drawing axis map: label -> (coordinate index, direction); the
    # synthetic generator reads world-up from its "Z" entry
    axes_3d: Tuple[Tuple[str, Tuple[int, float]], ...] = (
        ("X", (0, 1.0)), ("Y", (2, 1.0)), ("Z", (1, -1.0)),
    )

    @property
    def joint_names(self) -> Tuple[str, ...]:
        return JOINT_NAMES_BY_FORMAT[self.joint_format]

    @property
    def n_joints(self) -> int:
        return len(self.joint_names)

    @property
    def n_cameras(self) -> int:
        return len(self.camera_names)

    @property
    def n_used_cameras(self) -> int:
        return len(self.used_cameras)

    @property
    def n_matching_cameras(self) -> int:
        return len(self.used_cameras_skeleton_matching)

    @property
    def lifter_input_dim(self) -> int:
        """14 numbers per (used camera, joint)."""
        return self.n_used_cameras * self.n_joints * self.numbers_per_joint

    @property
    def matcher_feature_dim(self) -> int:
        """Alt-3 head-node feature width: 2 one-hot + 10 per (matching
        camera, joint)."""
        return 2 + self.n_matching_cameras * self.n_joints * 10

    def matcher_feature_dim_alt(self, alt: str = "3") -> int:
        """Feature width per graph alternative: alt-1 node-type, joint and
        camera one-hots + 4 joint numbers + the joint count; alt-2 4 and
        alt-3 10 numbers per (matching camera, joint)."""
        if alt == "1":
            return 2 + self.n_joints + self.n_matching_cameras + 4 + 1
        per = {"2": 4, "3": 10}[alt]
        return 2 + self.n_matching_cameras * self.n_joints * per

    def used_camera_indices(self) -> Tuple[int, ...]:
        return tuple(self.camera_names.index(c) for c in self.used_cameras)

    def matching_camera_indices(self) -> Tuple[int, ...]:
        return tuple(self.camera_names.index(c)
                     for c in self.used_cameras_skeleton_matching)


# CMU Panoptic, HD cameras 3/6/12/13/23 (reference: parameters.py:52-78)
PANOPTIC = RigConfig(
    name="PANOPTIC",
    image_width=1920,
    image_height=1080,
    camera_names=("trackera", "trackerb", "trackerc", "trackerd", "trackere"),
    fx=(1395.59, 1395.94, 1395.31, 1591.32, 1572.31),
    fy=(1392.03, 1392.22, 1391.77, 1587.2, 1567.51),
    cx=(950.046, 950.459, 966.65, 940.617, 942.938),
    cy=(564.906, 547.877, 562.988, 560.913, 559.888),
    kd0=(-0.28619, -0.279874, -0.284888, -0.232872, -0.237061),
    kd1=(0.179547, 0.166215, 0.179936, 0.194125, 0.18403),
    kd2=(-0.0451919, -0.035049, -0.0468637, 0.0125375, 0.0149481),
    p1=(-0.00010526, -0.000189415, -0.000119731, 4.22e-05, -0.000448556),
    p2=(6.45495e-05, 0.00107791, 0.000701704, 0.000877748, 0.00062731),
    used_cameras=("trackera", "trackerb", "trackerc", "trackerd", "trackere"),
    used_cameras_skeleton_matching=(
        "trackera", "trackerb", "trackerc", "trackerd", "trackere"),
    used_joints=(0, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17),
    transformations_path="tm_panoptic.pickle",
    axes_3d=(("X", (0, 1.0)), ("Y", (2, 1.0)), ("Z", (1, -1.0))),
)

_ARP_F = 848.0 / 1280.0
_ARP_ZF = 720.0 / 1080.0

# ARP Lab: 4 wall cameras + 2 robot-mounted (reference: parameters.py:79-123)
ARPLAB = RigConfig(
    name="ARPLAB",
    image_width=1280,
    image_height=720,
    camera_names=("trackera", "trackerb", "trackerc", "trackerd",
                  "orinbot_l", "orinbot_r"),
    fx=(634.0370 * _ARP_F, 633.6757 * _ARP_F, 636.5411 * _ARP_F,
        635.4050 * _ARP_F, 1097.2998046875 * _ARP_ZF, 1097.2998046875 * _ARP_ZF),
    fy=(633.5662 * _ARP_F, 633.0649 * _ARP_F, 636.1349 * _ARP_F,
        634.5941 * _ARP_F, 1097.2998046875 * _ARP_ZF, 1097.2998046875 * _ARP_ZF),
    cx=(631.7626 * _ARP_F, 635.7685 * _ARP_F, 638.4467 * _ARP_F,
        638.3454 * _ARP_F, 953.3253173828125 * _ARP_ZF, 953.3253173828125 * _ARP_ZF),
    cy=(355.3067 * _ARP_F, 358.7285 * _ARP_F, 370.3130 * _ARP_F,
        362.9503 * _ARP_F, 553.707763671875 * _ARP_ZF, 553.707763671875 * _ARP_ZF),
    kd0=(0.0,) * 6,
    kd1=(0.0,) * 6,
    kd2=(0.0,) * 6,
    p1=(0.0,) * 6,
    p2=(0.0,) * 6,
    used_cameras=("trackera", "trackerb", "trackerc", "trackerd",
                  "orinbot_l", "orinbot_r"),
    used_cameras_skeleton_matching=("trackera", "trackerb", "trackerc",
                                    "trackerd", "orinbot_l", "orinbot_r"),
    used_joints=(0, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17),
    transformations_path="tm_arp.pickle",
    axes_3d=(("X", (0, 1.0)), ("Y", (1, 1.0)), ("Z", (2, -1.0))),
)

_RIGS: Dict[str, RigConfig] = {"PANOPTIC": PANOPTIC, "ARPLAB": ARPLAB}


def get_rig(name: str) -> RigConfig:
    """Look up a rig preset by name (case-insensitive)."""
    try:
        return _RIGS[name.upper()]
    except KeyError:
        raise KeyError(f"Unknown rig '{name}'. Available: {sorted(_RIGS)}") from None


@dataclass(frozen=True)
class MatcherConfig:
    """GAT hyper-parameters (reference: train_skeleton_matching.py:40-57)."""

    in_dim: int = 902
    hidden: Tuple[int, ...] = (40, 40, 40, 30)
    heads: Tuple[int, ...] = (10, 10, 8, 5)
    n_classes: int = 1
    alpha: float = 0.15             # attention LeakyReLU slope
    # training-time dropout (models/gat.py::TrainableMatcher); serving
    # ignores both, checkpoint metas and the .prms import carry them
    feat_drop: float = 0.0
    attn_drop: float = 0.0
    residual: bool = False
    bias: bool = True
    hidden_slope: float = 0.01      # inter-layer LeakyReLU

    @property
    def n_layers(self) -> int:
        return len(self.hidden) + 1

    def layer_dims(self):
        """(in_dim, out_dim, n_heads) per layer (reference gat2.py:100-135)."""
        dims, d_in = [], self.in_dim
        for d_out, nh in zip(self.hidden, self.heads):
            dims.append((d_in, d_out, nh))
            d_in = d_out * nh
        dims.append((d_in, self.n_classes, 1))
        return dims


@dataclass(frozen=True)
class LifterConfig:
    """MLP lifter hyper-parameters (reference: utils/mlp.py:3-31)."""

    in_dim: int = 1260
    out_dim: int = 54
    widths: Tuple[int, ...] = (3072, 3072, 2048, 2048, 1024, 1024, 1024, 1024)
    negative_slope: float = 0.1
    # predict a correction to the triangulated prior packed into the input
    # (fields 11:14, lifting/pack.py) instead of absolute coordinates
    residual_prior: bool = False

    def layer_dims(self):
        dims = (self.in_dim, *self.widths, self.out_dim)
        return list(zip(dims[:-1], dims[1:]))


@dataclass(frozen=True)
class MatcherTrainConfig:
    """Matcher training (reference: train_skeleton_matching.py:31-58), the
    fields of the JAX package's, so checkpoint metas carry the same keys.
    ``scan_epoch``: an epoch takes ``n // batch_size`` full batches of a
    permutation drawn from a seeded ``torch.Generator`` and drops the tail;
    off, batches of ``np.random.default_rng(seed)``'s permutation, the tail
    kept.  ``prune_dist`` (metres, 0 = off): pairs whose mean ray distance
    exceeds it leave the loss and the head softmax.  ``checkpoint_backend``:
    "npz" ("orbax" is refused)."""

    epochs: int = 100
    lr: float = 1e-4
    batch_size: int = 15
    weight_decay: float = 1e-20
    patience: int = 5
    eval_every: int = 5
    limit: int = 120000
    use_bce: bool = False
    seed: int = 0
    scan_epoch: bool = True
    checkpoint_backend: str = "npz"
    prune_dist: float = 0.0


@dataclass(frozen=True)
class LifterTrainConfig:
    """Lifter training (reference: pose_estimator/train_pose_estimator.py:
    4-10), the fields of the JAX package's, so checkpoint metas carry the
    same keys.  An epoch takes ``n // batch_size`` full batches and drops
    the tail (``scan_epoch``, the only mode the port has); ``shuffle=False``
    takes them in dataset order.  ``loss``: a ``lifting/loss.py`` kind.
    ``save_rel_improve``: save only when the dev loss improved by this
    fraction since the last save (the best is saved at the end anyway).
    ``compute_dtype="bf16"``: matmul operands rounded to bf16, fp32 sums
    and fp32 master weights.  ``ema_decay`` > 0: evaluate, stop and save
    on the Polyak average of the weights.  ``checkpoint_backend``: "npz"
    ("orbax" is refused)."""

    epochs: int = 10000
    lr: float = 1e-4
    batch_size: int = 2096
    patience: int = 20
    eval_every: int = 5
    grad_clip_norm: float = 10.0
    optimise_matrices: bool = False
    max_combinations_number: int = 5
    seed: int = 58008
    scan_epoch: bool = True
    shuffle: bool = True
    loss: str = "reference"
    huber_delta: float = 10.0
    save_rel_improve: float = 0.02
    checkpoint_backend: str = "npz"
    compute_dtype: Optional[str] = None
    ema_decay: float = 0.0


def config_from_meta(cls, meta_section: Dict[str, Any], default):
    """Overlay a checkpoint meta's config dict on ``default``: fields the
    meta stores override, serving-only keys the port does not model are
    ignored, list values become tuples."""
    known = {f.name for f in fields(cls)}
    merged = {f.name: getattr(default, f.name) for f in fields(cls)}
    for k, v in (meta_section or {}).items():
        if k in known:
            merged[k] = tuple(v) if isinstance(v, list) else v
    return cls(**merged)
