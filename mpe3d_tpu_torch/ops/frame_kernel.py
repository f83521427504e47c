"""Decode + gather + pack of one frame: a hand-written CUDA kernel and its
plain version.

Replaces the decode ... pack part of the TPU whole-frame kernel
``mpe3d_tpu/ops/frame_kernel.py::_frame_kernel_call`` (:358, ``pallas_call``
at :829; decode :527-609, persons :611-640, gather :642-671, prior and gate
:673-741; configuration gate ``frame_kernel_supported`` :845).  The TPU kernel
also runs the GAT stack and the lifter MLP in the same launch; here they stay
the port's two other kernels (``ops/gat_kernel.py``, ``ops/fused_mlp.py``),
launched back to back with this one on one stream, so a frame goes from its
uploaded buffers to its poses with no host synchronisation
(``PoseEstimationPipeline._run_frame``).

The function, for scores [E] of one slot bucket (C matching cameras, S
slots, H = C*S heads) and the used cameras' per-slot buffers:

* the greedy camera-consistent decode over at most ``k_cap`` eligible pairs
  (score above ``threshold``, pair present), best first, ties to the lower
  pair index, the reference merge quirk (``matching/decode_device.py``);
* components with at least ``min_views`` heads -> persons [P, C] (slot per
  matching camera, -1 = none) and person_mask [P];
* each person's observations in the used cameras, gathered (zeros where the
  person has no slot);
* the lifter input [P, Cu*J*14] in the port's plain layout: fields 0-9 from
  ``pack_slot_fields09`` rows, fields 10-13 the triangulated prior (mean,
  median or IRLS) of the gathered observations, with the optional gate.

It is the same function as ``decode_person_proposals_device`` followed by
``pack_lifter_input`` on the gathered observations, which
``tests/test_torch_frame_kernel.py`` holds to the JAX package.  The split path
with pair pruning calls it on the compacted pairs: E_k = cap rows of the
pair table gathered by the kept indices, ``k_cap = min(k_cap, E_k)``
(``frame_kernel.py:1067-1073``); the bucket's limits are in
``frame_kernel_fits``.

``frame_decode_pack`` takes the plain version for CPU tensors and launches
the kernel (``csrc/frame_decode_pack.cu``) for CUDA tensors, checking the
arguments at the first call of their signature (sizes, shapes, dtypes) and
allocating the six outputs as views of one workspace;
``frame_decode_pack.launches`` counts the kernel launches.  Bound and design:
see the kernel source.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpe3d_tpu_torch.geometry.camera import CameraRig
from mpe3d_tpu_torch.lifting.pack import (pack_slot_fields09, prior_fields,
                                          triangulated_prior)
from mpe3d_tpu_torch.matching.decode_device import greedy_decode
from mpe3d_tpu_torch.ops import _build

PRIORS = ("mean", "median", "irls")
MAX_ROWS = 16        # person rows: the lifter kernel's activation rows
# kernel limits: pairs (shared memory), heads (10-bit ids), matching cameras
# (32-bit camera masks), used cameras (per-thread arrays)
MAX_PAIRS, MAX_HEADS, MAX_CAMERAS, MAX_USED_CAMERAS = 4096, 1024, 32, 8


class FrameOutputs(NamedTuple):
    persons: torch.Tensor       # [P, C] int32 slot per matching camera
    person_mask: torch.Tensor   # [P] bool
    net: torch.Tensor           # [P, Cu*J*14] fp32 lifter input
    kp: torch.Tensor            # [P, Cu, J, 2] gathered pixels
    valid: torch.Tensor         # [P, Cu, J] gathered valid flags (fp32)
    observed: torch.Tensor      # [P, Cu, J] gathered observed (bool)


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy().astype(np.float32)
    return np.asarray(a, np.float32)


def cam_consts(rig: CameraRig) -> torch.Tensor:
    """[Cu, 21] fp32 per camera: fx, fy, cx, cy, k1, k2, p1, p2, k3 and the
    world -> camera P = T_wc[:3, :4] row-major (``_cam_consts`` :157)."""
    K, dist, T = _np(rig.K), _np(rig.dist), _np(rig.T_wc)
    out = np.concatenate([K[:, 0, 0:1], K[:, 1, 1:2], K[:, 0, 2:3],
                          K[:, 1, 2:3], dist[:, :5],
                          T[:, :3, :].reshape(-1, 12)], 1)
    return torch.from_numpy(np.ascontiguousarray(out, np.float32))


def cam_to_world(rig: CameraRig) -> torch.Tensor:
    """[Cu, 12] fp32: T_cw[:3, :4] row-major (rotation to world and the
    camera centre), for fields 4-9."""
    T = _np(rig.T_cw)
    return torch.from_numpy(np.ascontiguousarray(T[:, :3, :].reshape(-1, 12)))


def rig_from_consts(cams: torch.Tensor,
                    cam_world: torch.Tensor) -> CameraRig:
    """The camera rig the two constant tables describe (K_inv unused)."""
    n = cams.shape[0]
    K = torch.zeros((n, 3, 3), dtype=cams.dtype, device=cams.device)
    K[:, 0, 0], K[:, 1, 1] = cams[:, 0], cams[:, 1]
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = cams[:, 2], cams[:, 3], 1.0
    last = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=cams.dtype,
                        device=cams.device).expand(n, 1, 4)
    T_wc = torch.cat([cams[:, 9:].reshape(n, 3, 4), last], 1)
    T_cw = torch.cat([cam_world.reshape(n, 3, 4), last], 1)
    return CameraRig(K, None, T_wc, T_cw, cams[:, 4:9], None)


def frame_decode_pack_plain(
        scores: torch.Tensor, pair_mask: torch.Tensor, pairs: torch.Tensor,
        used_pos: torch.Tensor, kp: torch.Tensor, valid: torch.Tensor,
        prob: torch.Tensor, observed: torch.Tensor, cams: torch.Tensor,
        cam_world: torch.Tensor, *, n_cameras: int, threshold: float,
        min_views: int, k_cap: int, P: int, prior: str,
        gate_px: Optional[float], image_size: Tuple[float, float],
        ) -> FrameOutputs:
    """Plain PyTorch version.  scores/pair_mask [E] fp32; pairs [E, 4] int32
    (``decode_pairs``); used_pos [Cu] int32 (matching row of each used
    camera, -1 = none); kp [Cu, S, J, 2], valid/prob [Cu, S, J] fp32,
    observed [Cu, S, J] bool; cams [Cu, 21] (``cam_consts``), cam_world
    [Cu, 12] (``cam_to_world``)."""
    Cu, S = kp.shape[0], kp.shape[1]
    rig = rig_from_consts(cams, cam_world)
    persons, person_mask = greedy_decode(scores, pair_mask, pairs, n_cameras,
                                         S, min_views, threshold, P, k_cap)
    up = used_pos.long()
    slot_u = torch.where(up[None, :] >= 0, persons[:, torch.clamp(up, min=0)],
                         torch.full_like(persons[:, :1], -1))   # [P, Cu]
    take = torch.clamp(slot_u, min=0)
    has = slot_u >= 0
    cu = torch.arange(Cu, device=kp.device)[None, :]
    gkp = kp[cu, take] * has[..., None, None]
    gval = valid[cu, take] * has[..., None]
    gobs = observed[cu, take] & has[..., None]
    f09 = pack_slot_fields09(kp, valid, prob, observed, rig, image_size)
    net09 = f09[cu, take] * has[..., None, None]              # [P, Cu, J, 14]
    xyz, ok = triangulated_prior(gkp, gobs, gobs, rig, prior=prior,
                                 prior_gate_px=gate_px)
    net = torch.cat([net09[..., :10], prior_fields(xyz, ok, Cu)], -1)
    return FrameOutputs(persons.to(torch.int32), person_mask,
                        net.reshape(P, -1), gkp, gval, gobs)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"frame_decode_pack: {name} must be a contiguous "
                         f"{dtype} tensor on {device}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"frame_decode_pack: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")


def _check_args(args, dev, E, C, S, J, Cu, P, k_cap, prior):
    """The checks of ``frame_decode_pack``'s arguments (sizes, dtypes,
    shapes, devices, contiguity)."""
    if prior not in PRIORS:
        raise ValueError(f"prior must be one of {PRIORS}, got {prior!r}")
    if not (1 <= E <= MAX_PAIRS and 1 <= C * S <= MAX_HEADS
            and C <= MAX_CAMERAS and 1 <= Cu <= MAX_USED_CAMERAS
            and 1 <= P <= MAX_ROWS and 1 <= k_cap <= E):
        raise ValueError(
            f"frame_decode_pack serves E <= {MAX_PAIRS}, C*S <= "
            f"{MAX_HEADS}, C <= {MAX_CAMERAS}, Cu <= {MAX_USED_CAMERAS}, "
            f"P <= {MAX_ROWS}, 1 <= k_cap <= E; got E={E}, C={C}, S={S}, "
            f"Cu={Cu}, P={P}, k_cap={k_cap}")
    f32, names = torch.float32, ("scores", "pair_mask", "pairs", "used_pos",
                                 "kp", "valid", "prob", "observed", "cams",
                                 "cam_world")
    want = ((f32, (E,)), (f32, (E,)), (torch.int32, (E, 4)),
            (torch.int32, (Cu,)), (f32, (Cu, S, J, 2)), (f32, (Cu, S, J)),
            (f32, (Cu, S, J)), (torch.bool, (Cu, S, J)), (f32, (Cu, 21)),
            (f32, (Cu, 12)))
    for t, name, (dtype, shape) in zip(args, names, want):
        _check(t, name, dtype, shape, dev)


class _Outputs(NamedTuple):
    """Where the six outputs lie in a call's one workspace: its bytes, and
    per output (dtype, shape, strides, offset in elements of its dtype)."""
    size: int
    views: Tuple[Tuple[torch.dtype, Tuple[int, ...], Tuple[int, ...], int],
                 ...]


def _output_layout(C, J, Cu, P) -> _Outputs:
    """net, kp, valid (fp32), persons (int32), person_mask and observed
    (bool), contiguous, each at a 16-byte aligned offset, in
    ``FrameOutputs`` order."""
    specs = {"net": (torch.float32, (P, Cu * J * 14)),
             "kp": (torch.float32, (P, Cu, J, 2)),
             "valid": (torch.float32, (P, Cu, J)),
             "persons": (torch.int32, (P, C)),
             "person_mask": (torch.bool, (P,)),
             "observed": (torch.bool, (P, Cu, J))}
    place, off = {}, 0
    for name, (dtype, shape) in specs.items():
        size = 1 if dtype == torch.bool else 4
        strides = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        place[name] = (dtype, shape, strides, off // size)
        off += -(-int(np.prod(shape)) * size // 16) * 16
    return _Outputs(off, tuple(place[name] for name in FrameOutputs._fields))


# checked argument signatures (device, sizes, scalars, and the inputs'
# shapes and dtypes) -> their output layout; a call whose signature was
# checked before is not checked again
_CHECKED = {}
_MAX_CHECKED = 64


def frame_decode_pack(
        scores: torch.Tensor, pair_mask: torch.Tensor, pairs: torch.Tensor,
        used_pos: torch.Tensor, kp: torch.Tensor, valid: torch.Tensor,
        prob: torch.Tensor, observed: torch.Tensor, cams: torch.Tensor,
        cam_world: torch.Tensor, *, n_cameras: int, threshold: float,
        min_views: int, k_cap: int, P: int, prior: str,
        gate_px: Optional[float], image_size: Tuple[float, float],
        ) -> FrameOutputs:
    """Decode + gather + pack of one frame (arguments as the plain version):
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors.
    On CUDA the arguments are checked at the first call of their
    signature, and the six outputs are views of one allocation."""
    args = (scores, pair_mask, pairs, used_pos, kp, valid, prob, observed,
            cams, cam_world)
    if scores.device.type == "cpu":
        return frame_decode_pack_plain(
            *args, n_cameras=n_cameras, threshold=threshold,
            min_views=min_views, k_cap=k_cap, P=P, prior=prior,
            gate_px=gate_px, image_size=image_size)
    if scores.device.type != "cuda":
        raise ValueError(f"frame_decode_pack: unsupported device "
                         f"{scores.device}")
    dev = scores.device
    E, C = scores.shape[0], n_cameras
    Cu, S, J = kp.shape[0], kp.shape[1], kp.shape[2]
    key = ((dev, C, P, k_cap, prior) + tuple([t.shape for t in args])
           + tuple([t.dtype for t in args]))
    out_layout = _CHECKED.get(key)
    if out_layout is None:
        _check_args(args, dev, E, C, S, J, Cu, P, k_cap, prior)
        if len(_CHECKED) >= _MAX_CHECKED:
            _CHECKED.clear()
        out_layout = _CHECKED[key] = _output_layout(C, J, Cu, P)
    ws = torch.empty(out_layout.size, dtype=torch.uint8, device=dev)
    bases = {torch.float32: ws.view(torch.float32),
             torch.int32: ws.view(torch.int32), torch.bool: ws.view(torch.bool)}
    out = FrameOutputs(*(torch.as_strided(bases[dtype], shape, strides, off)
                         for dtype, shape, strides, off in out_layout.views))
    code = _build.library().cdll.frame_decode_pack(
        *(t.data_ptr() for t in args), E, C, S, J, Cu, P, threshold,
        min_views, k_cap, PRIORS.index(prior), int(gate_px is not None),
        0.0 if gate_px is None else float(gate_px), float(image_size[0]),
        float(image_size[1]), *(t.data_ptr() for t in out),
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(code, "frame_decode_pack")
    frame_decode_pack.launches += 1
    return out


frame_decode_pack.launches = 0


def frame_kernel_fits(E: int, C: int, S: int) -> bool:
    """Whether one slot bucket fits the kernel: its decode pairs (E, the
    compacted count under pair pruning), heads C*S and matching cameras C.
    The limits of ``frame_decode_pack`` that depend on the bucket; the rest
    are per configuration (``frame_kernel_supported``)."""
    return 1 <= E <= MAX_PAIRS and 1 <= C * S <= MAX_HEADS and C <= MAX_CAMERAS


def frame_kernel_supported(pipe) -> bool:
    """Configurations the frame path serves (``frame_kernel.py:845-855`` for
    the ones the port has: it serves only the MLP backend, without geometric
    rerank): alt-3 graph, no GAT residual, a mean / median / IRLS prior,
    person buckets of at most 16 rows, camera counts within the kernel's
    limits, and a bf16 or int8 lifter (an fp32 lifter, the reference's
    ``serve_dtype=None`` off the TPU, takes the eager path).  Each bucket
    must also fit (``frame_kernel_fits``)."""
    return (pipe.rig_config.graph_alternative == "3"
            and pipe.lifter.serve_dtype != "fp32"
            and not pipe.matcher.cfg.residual
            and pipe.lifter_prior in PRIORS
            and pipe.person_buckets[-1] <= MAX_ROWS
            and len(pipe.match_idx) <= MAX_CAMERAS
            and len(pipe.used_idx) <= MAX_USED_CAMERAS)
