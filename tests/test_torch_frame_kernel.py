"""The port's frame path (``ops/frame_kernel.py``, ``_run_frame``) against the
JAX package, on the CPU.

* Module: ``frame_decode_pack_plain`` against JAX
  ``decode_person_proposals_device`` followed by a vmapped
  ``pack_lifter_input`` on the gathered observations, over numpy-seeded
  score fields and synthetic frames.
* Whole path: ``infer_fused(use_frame_kernel=True)`` against the TPU
  whole-frame kernel in interpret mode (``build_frame_program``), on the
  small pipeline of ``tests/test_frame_kernel.py``.
* Both paths of the port on the trained ``pan_irls_bf16`` pair.
* The CUDA kernel's selection of its decode trips (its sort keys and their
  ordering, emulated) against ``torch.sort(stable=True)``, and the CUDA
  wrapper's output layout and argument checks.

Tolerances: persons, person masks and gathered observations are equal; net
fields 0-9 within 1e-5 (fp32 pixel normalisation and one undistortion, the
same formulas); prior fields 11-13 within 1e-4 decameters (iterated fp32
geometry: 10 undistortion steps, refinement, 5 IRLS rounds, sums in another
order); the ``ok`` flags (field 10) equal except for joints whose gate
residual lies within 1e-3 px of the gate, which are counted and reported;
poses within 1e-2 m and quality within 0.5 px, as in
``tests/test_torch_pipeline.py`` (bf16 lifter operands turn last-bit
differences into rounding flips that cascade); scores within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.lifting.pack import pack_lifter_input as j_pack
from mpe3d_tpu.lifting.pack import pack_slot_fields09 as j_fields09
from mpe3d_tpu.matching import features as jfeat
from mpe3d_tpu.matching.decode_device import \
    decode_person_proposals_device as j_decode
from mpe3d_tpu.models.gat import init_matcher
from mpe3d_tpu.models.mlp import init_lifter
from mpe3d_tpu.ops.frame_kernel import _cam_consts, build_frame_program
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.geometry.camera import project_points, undistort_points
from mpe3d_tpu_torch.geometry.triangulate import triangulate_pair
from mpe3d_tpu_torch.lifting.pack import gate_residual_px, pack_slot_fields09
from mpe3d_tpu_torch.matching.decode_device import decode_pairs
from mpe3d_tpu_torch.matching.features import build_topology
from mpe3d_tpu_torch.ops import frame_kernel as fk
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

import torch_testing  # noqa: F401

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo",
                    "pan_irls_bf16")
SIZE = (1920.0, 1080.0)
C, S, J, P = 5, 4, 18, 8
FIELD_TOL, PRIOR_TOL, GATE_NEAR_PX = 1e-5, 1e-4, 1e-3
SCORE_TOL, POSE_TOL_M, QUALITY_TOL_PX = 1e-5, 1e-2, 0.5
NOISE = SceneNoise(pixel_sigma=1.0, joint_dropout=0.03, spurious_rate=0.1,
                   camera_dropout=0.05)


def _frames(n, seed, poison=False, people=(1, 3)):
    """(port FrameArrays, JAX FrameArrays) of the same wire frames, S=4
    slots; ``poison`` shifts camera 1's joint 5 by 200 px so the prior gate
    fires (as tests/test_frame_kernel.py:132-136 does)."""
    rig = synthetic_ring_rig(PANOPTIC)
    out = []
    for f in generate_frames(PANOPTIC, rig, n, n_people=people, seed=seed,
                             noise=NOISE, with_gt=False):
        pair = (parse_frame(f, PANOPTIC, max_skeletons=S),
                j_parse(f, J_PANOPTIC, max_skeletons=S))
        if poison:
            for fa in pair:
                fa.kp[1, :, 5] += 200.0
        out.append(pair)
    return out


# ---------------------------------------------------------------------------
# module: frame_decode_pack_plain against JAX decode + pack_lifter_input
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def module_setup():
    rig = synthetic_ring_rig(PANOPTIC).to("cpu")
    jrig = j_ring(J_PANOPTIC)
    jtopo = jfeat.build_topology(C, S)
    topo = build_topology(C, S)
    decoders = {}

    def jax_decode(top_k):
        if top_k not in decoders:
            decoders[top_k] = jax.jit(lambda s, m: j_decode(
                s, m, jtopo, 2, 0.5, P, top_k=top_k))
        return decoders[top_k]

    packs = {}

    def jax_pack(prior, gate):
        if (prior, gate) not in packs:
            packs[prior, gate] = jax.jit(jax.vmap(
                lambda k, v, p, o: j_pack(k, v, p, o, jrig, SIZE, prior=prior,
                                          prior_gate_px=gate)[0]))
        return packs[prior, gate]
    return rig, topo, jax_decode, jax_pack


def _geometric_scores(fa, rig, topo, seed):
    """A realistic score field [E]: two skeletons that triangulate
    consistently (small reprojection error over their shared joints) score
    high.  Times a numpy-seeded jitter in [0.9, 1]."""
    kp = torch.from_numpy(fa.kp[:, :S].copy())
    obs = torch.from_numpy(fa.in_view[:, :S].copy())
    xn = undistort_points(kp, rig.K[:, None, None], rig.dist[:, None, None])
    c1 = torch.from_numpy(topo.cam1.astype(np.int64))
    c2 = torch.from_numpy(topo.cam2.astype(np.int64))
    s1 = torch.from_numpy(topo.e1.astype(np.int64)) % S
    s2 = torch.from_numpy(topo.e2.astype(np.int64)) % S
    Pm = rig.T_wc[:, :3, :]
    X = triangulate_pair(xn[c1, s1], xn[c2, s2], Pm[c1][:, None],
                         Pm[c2][:, None])                       # [E, J, 3]
    err = 0.0
    for c, s in ((c1, s1), (c2, s2)):
        pix = project_points(X, rig.T_wc[c][:, None], rig.K[c][:, None],
                             rig.dist[c][:, None], min_depth=1e-4)
        err = err + torch.linalg.norm(pix - kp[c, s], dim=-1)
    both = (obs[c1, s1] & obs[c2, s2]).float()
    mean_err = (err * both).sum(1) / both.sum(1).clamp(min=1.0)
    score = torch.exp(-mean_err / 60.0) * (both.sum(1) >= 3)
    jitter = np.random.default_rng(seed).uniform(0.9, 1.0, topo.n_pairs)
    return (score.numpy() * jitter).astype(np.float32)


def _inputs(fa, scores):
    """numpy arrays of one frame for both sides: scores, pair mask, kp,
    valid, prob, observed (all cameras are matching and used cameras)."""
    topo = build_topology(C, S)
    present = fa.present[:, :S].reshape(-1)
    pm = (present[topo.e1] & present[topo.e2]).astype(np.float32)
    return (scores.astype(np.float32), pm,
            *(np.ascontiguousarray(a[:, :S]) for a in
              (fa.kp, fa.valid, fa.prob, fa.in_view)))


def _run_both(setup, arrays, prior, gate, top_k):
    rig, topo, jax_decode, jax_pack = setup
    scores, pm, kp, valid, prob, obs = arrays
    E = topo.n_pairs
    jp, jm = jax_decode(top_k)(jnp.asarray(scores), jnp.asarray(pm))
    jp, jm = np.asarray(jp), np.asarray(jm)
    # the reference gather (pipeline.py:867-876), all cameras used
    cams = np.arange(C)[None, :]
    take, has = np.maximum(jp, 0), jp >= 0
    g = (kp[cams, take] * has[..., None, None],
         valid[cams, take] * has[..., None],
         prob[cams, take] * has[..., None], obs[cams, take] & has[..., None])
    ref_net = np.asarray(jax_pack(prior, gate)(*map(jnp.asarray, g)))
    ungated = np.asarray(jax_pack(prior, None)(*map(jnp.asarray, g)))
    t = torch.from_numpy
    out = fk.frame_decode_pack(
        t(scores), t(pm), t(decode_pairs(topo)),
        torch.arange(C, dtype=torch.int32), t(kp), t(valid), t(prob), t(obs),
        fk.cam_consts(rig), fk.cam_to_world(rig), n_cameras=C,
        threshold=0.5, min_views=2, k_cap=min(top_k, E) if top_k else E,
        P=P, prior=prior, gate_px=gate, image_size=SIZE)
    return (jp, jm, g, ref_net, ungated), out


def _near_gate(out, ungated, rig, gate):
    """[P, J] joints whose gate residual (from the ungated prior) lies within
    GATE_NEAR_PX of the gate."""
    if gate is None:
        return np.zeros((P, J), bool)
    blk = ungated.reshape(P, C, J, 14)[:, 0]
    xyz = torch.from_numpy(blk[..., 11:14] * 10.0)
    resid = gate_residual_px(out.kp, out.observed, xyz, rig).numpy()
    return np.abs(resid - gate) < GATE_NEAR_PX


def _assert_frame(ref, out, rig, gate):
    jp, jm, g, ref_net, ungated = ref
    np.testing.assert_array_equal(out.persons.numpy(), jp)
    np.testing.assert_array_equal(out.person_mask.numpy(), jm)
    for got, want in zip((out.kp, out.valid, out.observed), g[:2] + g[3:]):
        np.testing.assert_array_equal(got.numpy(), want)
    got = out.net.numpy().reshape(P, C, J, 14)
    want = ref_net.reshape(P, C, J, 14)
    np.testing.assert_allclose(got[..., :10], want[..., :10], atol=FIELD_TOL)
    near = _near_gate(out, ungated, rig, gate)
    flips = (got[..., 10] != want[..., 10]).any(1)            # [P, J]
    note = (f"{int(near.sum())} joints within {GATE_NEAR_PX} px of the "
            f"gate, {int(flips.sum())} ok flags differ")
    assert not (flips & ~near).any(), note
    keep = ~flips[:, None, :, None]
    np.testing.assert_allclose(np.where(keep, got[..., 11:], 0.0),
                               np.where(keep, want[..., 11:], 0.0),
                               atol=PRIOR_TOL, err_msg=note)
    return int(jm.sum())


@pytest.mark.parametrize("prior", fk.PRIORS)
@pytest.mark.parametrize("gate", [None, 8.0])
def test_frame_decode_pack_priors(module_setup, prior, gate):
    """Synthetic frames with geometric score fields; with the gate, camera
    1's joint 5 is 200 px off, so the gate drops mean and IRLS priors."""
    rig, topo = module_setup[:2]
    n_persons, gated = 0, 0
    for i, (_, fa) in enumerate(_frames(3, 31, poison=gate is not None)):
        scores = _geometric_scores(fa, rig, topo, i)
        ref, out = _run_both(module_setup, _inputs(fa, scores), prior, gate,
                             64)
        n_persons += _assert_frame(ref, out, rig, gate)
        flag = lambda n: n.reshape(P, C, J, 14)[:, 0, :, 10]  # noqa: E731
        gated += int(flag(ref[4]).sum() - flag(ref[3]).sum())
    assert n_persons >= 3
    if gate is None:
        assert gated == 0
    elif prior != "median":
        # the median filter already drops the shifted camera's pairs, so its
        # prior reprojects well and the gate keeps it
        assert gated > 0


@pytest.mark.parametrize("kind,seed", [("dense", 0), ("dense", 1),
                                       ("ties", 0), ("ties", 1)])
def test_frame_decode_pack_cap_and_ties(module_setup, kind, seed):
    """More than 64 eligible pairs with top_k=64, so the trip cap binds
    ("dense"); scores on a coarse grid, so exact ties must go to the lower
    pair index ("ties", top_k=0: every eligible pair)."""
    rig, topo = module_setup[:2]
    _, fa = _frames(1, 40 + seed, people=(4, 5))[0]
    rng = np.random.default_rng(seed)
    E = topo.n_pairs
    if kind == "dense":
        scores, top_k = rng.uniform(0.55, 0.95, E), 64
    else:
        scores, top_k = np.round(rng.uniform(0.3, 1.0, E) * 8) / 8, 0
    arrays = _inputs(fa, scores)
    eligible = int(((arrays[0] > 0.5) & (arrays[1] > 0.5)).sum())
    if kind == "dense":
        assert eligible > 64
    else:
        assert len(np.unique(arrays[0][arrays[1] > 0.5])) < eligible
    ref, out = _run_both(module_setup, arrays, "irls", 8.0, top_k)
    assert _assert_frame(ref, out, rig, 8.0) >= 1


def test_frame_decode_pack_empty_frame(module_setup):
    rig = module_setup[0]
    E = build_topology(C, S).n_pairs
    z = np.zeros
    arrays = (z(E, np.float32), z(E, np.float32), z((C, S, J, 2), np.float32),
              z((C, S, J), np.float32), z((C, S, J), np.float32),
              z((C, S, J), bool))
    ref, out = _run_both(module_setup, arrays, "mean", 8.0, 64)
    assert _assert_frame(ref, out, rig, 8.0) == 0
    assert (out.persons.numpy() == -1).all()
    assert not out.net.numpy().any()


def test_cam_consts_match_reference():
    jrig = j_ring(J_PANOPTIC)
    ref = np.asarray(_cam_consts(jrig), np.float32)
    got = fk.cam_consts(synthetic_ring_rig(PANOPTIC)).numpy()
    np.testing.assert_array_equal(got, ref)
    T_cw = np.asarray(jrig.T_cw, np.float32)[:, :3, :].reshape(-1, 12)
    np.testing.assert_array_equal(
        fk.cam_to_world(synthetic_ring_rig(PANOPTIC)).numpy(), T_cw)


def test_pack_slot_fields09_matches_reference():
    jrig = j_ring(J_PANOPTIC)
    rig = synthetic_ring_rig(PANOPTIC).to("cpu")
    _, fa = _frames(1, 5)[0]
    a = [np.ascontiguousarray(x[:, :S])
         for x in (fa.kp, fa.valid, fa.prob, fa.in_view)]
    ref = np.asarray(j_fields09(*map(jnp.asarray, a), jrig, SIZE))
    got = pack_slot_fields09(*map(torch.from_numpy, a), rig, SIZE).numpy()
    assert got.shape == (C, S, J, 14)
    np.testing.assert_allclose(got, ref, atol=FIELD_TOL)
    assert not got[..., 10:].any()


def test_frame_decode_pack_rejects_other_devices(module_setup):
    """Only CPU tensors (plain version) and CUDA tensors (kernel) are
    served."""
    E = build_topology(C, S).n_pairs
    m = torch.zeros(E, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fk.frame_decode_pack(m, m, m, m, m, m, m, m, m, m, n_cameras=C,
                             threshold=0.5, min_views=2, k_cap=64, P=P,
                             prior="mean", gate_px=None, image_size=SIZE)


@pytest.mark.parametrize("C,J,Cu,P", [(5, 18, 5, 8), (5, 18, 5, 16),
                                       (32, 3, 8, 1)])
def test_output_layout_one_workspace(C, J, Cu, P):
    """The CUDA wrapper's six outputs as views of one workspace (built here
    on a CPU buffer): the dtypes and shapes of ``FrameOutputs``,
    contiguous, 16-byte aligned, inside the workspace and disjoint."""
    layout = fk._output_layout(C, J, Cu, P)
    ws = torch.zeros(layout.size, dtype=torch.uint8)
    bases = {d: ws.view(d) for d in (torch.float32, torch.int32, torch.bool)}
    out = fk.FrameOutputs(*(torch.as_strided(bases[d], shape, strides, off)
                            for d, shape, strides, off in layout.views))
    want = {"persons": (torch.int32, (P, C)), "person_mask": (torch.bool, (P,)),
            "net": (torch.float32, (P, Cu * J * 14)),
            "kp": (torch.float32, (P, Cu, J, 2)),
            "valid": (torch.float32, (P, Cu, J)),
            "observed": (torch.bool, (P, Cu, J))}
    spans = []
    for name, t in zip(fk.FrameOutputs._fields, out):
        assert (t.dtype, tuple(t.shape)) == want[name] and t.is_contiguous()
        start = t.data_ptr() - ws.data_ptr()
        spans.append((start, start + t.numel() * t.element_size()))
        assert start % 16 == 0
    spans.sort()
    assert spans[0][0] >= 0 and spans[-1][1] <= layout.size
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_argument_checks(module_setup):
    """The checks the CUDA wrapper runs once per argument signature: the
    serving sizes pass; a wrong dtype, a wrong shape, k_cap past E or an
    unknown prior raise."""
    E = build_topology(C, S).n_pairs
    Cu, J = 5, 18
    f = lambda *s: torch.zeros(s)                       # noqa: E731
    i = lambda *s: torch.zeros(s, dtype=torch.int32)    # noqa: E731
    args = [f(E), f(E), i(E, 4), i(Cu), f(Cu, S, J, 2), f(Cu, S, J),
            f(Cu, S, J), torch.zeros((Cu, S, J), dtype=torch.bool),
            f(Cu, 21), f(Cu, 12)]
    dev = torch.device("cpu")
    fk._check_args(args, dev, E, C, S, J, Cu, P, 64, "irls")
    bad = list(args)
    bad[2] = f(E, 4)
    with pytest.raises(ValueError, match="pairs must be"):
        fk._check_args(bad, dev, E, C, S, J, Cu, P, 64, "irls")
    bad = list(args)
    bad[4] = f(Cu, S, J, 3)
    with pytest.raises(ValueError, match="kp has shape"):
        fk._check_args(bad, dev, E, C, S, J, Cu, P, 64, "irls")
    with pytest.raises(ValueError, match="k_cap <= E"):
        fk._check_args(args, dev, E, C, S, J, Cu, P, E + 1, "irls")
    with pytest.raises(ValueError, match="prior must be"):
        fk._check_args(args, dev, E, C, S, J, Cu, P, 64, "huber")


# ---------------------------------------------------------------------------
# whole path: infer_fused(use_frame_kernel=True) against the TPU kernel
# ---------------------------------------------------------------------------

def _small_pipes(prior, gate, residual_prior):
    """The JAX pipeline of tests/test_frame_kernel.py:27-36 (hidden (8, 8),
    heads (2, 2), lifter widths (64, 64), threshold 0.05, bf16 serving) and
    the port's pipeline with the same weights."""
    jm = JMatcherConfig(in_dim=J_PANOPTIC.matcher_feature_dim,
                        hidden=(8, 8), heads=(2, 2))
    jl = JLifterConfig(widths=(64, 64), residual_prior=residual_prior)
    kw = dict(slot_buckets=(S,), person_buckets=(P,), threshold=0.05,
              decode_top_k=0, lifter_prior=prior, prior_gate_px=gate)
    jpipe = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC),
                      init_matcher(jax.random.PRNGKey(0), jm), jm,
                      init_lifter(jax.random.PRNGKey(1), jl), jl,
                      serve_dtype=jnp.bfloat16, **kw)
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=(8, 8),
                         heads=(2, 2))
    lcfg = LifterConfig(widths=(64, 64), residual_prior=residual_prior)
    port = PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(jpipe.matcher_params, mcfg, "cpu"),
        weights.lifter_from_tree(jpipe.lifter_params, lcfg, "cpu"),
        use_frame_kernel=True, device="cpu", **kw)
    return jpipe, port


@pytest.mark.parametrize("prior,gate,residual_prior,seed", [
    ("irls", 8.0, True, 31), ("mean", None, False, 7),
    ("median", 8.0, False, 13)])
def test_infer_fused_frame_path_matches_tpu_kernel(prior, gate,
                                                   residual_prior, seed):
    jpipe, port = _small_pipes(prior, gate, residual_prior)
    assert port.frame_path_on()
    from mpe3d_tpu.ops.frame_kernel import (frame_kernel_supported,
                                            pack_frame_serving)
    assert frame_kernel_supported(jpipe)
    lflat = pack_frame_serving(jpipe.lifter_params, len(jpipe.used_idx), J)
    prog = build_frame_program(jpipe, S, P, interpret=True)
    n_persons = 0
    for pf, jf in _frames(3, seed, poison=gate is not None):
        poses, persons, pmask, scores, quality = jax.device_get(prog(
            jpipe.matcher_params, lflat,
            *(jnp.asarray(a[:, :S]) for a in (jf.kp, jf.valid, jf.prob,
                                              jf.in_view, jf.present))))
        got = port.infer_fused(pf)
        n = int(pmask.sum())
        np.testing.assert_array_equal(got.persons, persons[:n])
        assert got.persons.dtype == persons.dtype == np.int32
        np.testing.assert_allclose(got.scores, scores, atol=SCORE_TOL)
        np.testing.assert_allclose(got.poses, poses[:n], atol=POSE_TOL_M)
        np.testing.assert_allclose(got.quality, quality[:n],
                                   atol=QUALITY_TOL_PX)
        n_persons += n
    assert n_persons >= 3


# ---------------------------------------------------------------------------
# the port's two paths on the trained pair
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_pipes():
    rig = synthetic_ring_rig(PANOPTIC)
    kw = dict(slot_buckets=(4,), person_buckets=(8,), device="cpu")
    frame = PoseEstimationPipeline.from_checkpoint(
        DEMO, rig, use_frame_kernel=True, **kw)
    eager = PoseEstimationPipeline.from_checkpoint(
        DEMO, rig, use_frame_kernel=False, **kw)
    frames = [parse_frame(f, PANOPTIC) for f in generate_frames(
        PANOPTIC, rig, 6, n_people=(2, 3), seed=1)]
    return frame, eager, frames


@pytest.mark.parametrize("matcher", ["trained", "random"])
def test_frame_path_matches_eager_path(trained_pipes, matcher):
    """Trained pan_irls_bf16 lifter; the trained matcher (near-zero scores
    on the ring rig) and a numpy-seeded random one (live persons)."""
    frame, eager, frames = trained_pipes
    if matcher == "random":
        tree = weights.random_matcher_tree(frame.matcher.cfg, 0)
        for p in (frame, eager):
            p.matcher = weights.matcher_from_tree(tree, p.matcher.cfg, "cpu")
    assert frame.frame_path_on() and not eager.frame_path_on()
    n = 0
    for f in frames:
        a, b = eager.infer_fused(f), frame.infer_fused(f)
        np.testing.assert_array_equal(b.persons, a.persons)
        assert b.persons.dtype == a.persons.dtype == np.int32
        np.testing.assert_allclose(b.scores, a.scores, atol=SCORE_TOL)
        np.testing.assert_allclose(b.poses, a.poses, atol=POSE_TOL_M)
        np.testing.assert_allclose(b.quality, a.quality, atol=QUALITY_TOL_PX)
        n += len(b.persons)
    if matcher == "random":
        assert n >= 2 * len(frames)


def test_use_frame_kernel_resolution():
    """None takes the frame path only on a CUDA device (so the eager path on
    the CPU), True forces it and raises on an unsupported configuration,
    False keeps the eager path."""
    rig = synthetic_ring_rig(PANOPTIC)
    mcfg = MatcherConfig(in_dim=PANOPTIC.matcher_feature_dim, hidden=(8,),
                         heads=(2,))
    lcfg = LifterConfig(widths=(16,))

    def pipe(**kw):
        return PoseEstimationPipeline(
            PANOPTIC, rig,
            weights.matcher_from_tree(weights.random_matcher_tree(mcfg, 0),
                                      mcfg, "cpu"),
            weights.lifter_from_tree(weights.random_lifter_tree(lcfg, 0),
                                     lcfg, "cpu"), device="cpu", **kw)
    assert fk.frame_kernel_supported(pipe())
    assert not pipe().frame_path_on()
    assert pipe(use_frame_kernel=True).frame_path_on()
    assert not pipe(use_frame_kernel=False).frame_path_on()
    wide = pipe(use_frame_kernel=True, person_buckets=(8, 32))
    assert not fk.frame_kernel_supported(wide)
    with pytest.raises(ValueError, match="does not serve"):
        wide.frame_path_on()


# ---- the decode kernel's selection order --------------------------------

RANK_SORT = 1024    # the kernel orders up to this many keys by counting


def kernel_decode_order(scores, pmask, threshold, k_cap, rng):
    """The CUDA kernel's selection of its decode trips, emulated: a 64-bit
    key per eligible pair (the score's order-preserving bits inverted, -0 as
    +0, then the pair index), compacted in an arbitrary order (the kernel's
    shared counter: ``rng`` shuffles); up to RANK_SORT keys each key's place
    is the count of smaller keys, past that the keys are padded with
    all-ones keys to a power of two and bitonic-sorted by the kernel's
    network.  The first n_live = min(#eligible, k_cap) keys' indices are the
    trips.  Returns (trips, n_live, the ordering used)."""
    s = scores.numpy().astype(np.float32)
    idx = np.flatnonzero((pmask.numpy() > 0.5) & (s > threshold))
    rng.shuffle(idx)
    u = np.where(s[idx] == 0, np.float32(0), s[idx]).view(np.uint32)
    asc = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    keys = (~asc).astype(np.uint64) << np.uint64(32) | idx.astype(np.uint64)
    n_live = min(len(idx), k_cap)
    if len(keys) <= RANK_SORT:
        rank = (keys[None, :] < keys[:, None]).sum(1)
        order = np.empty(n_live, np.uint64)
        take = rank < n_live
        order[rank[take]] = keys[take]
        return ((order & np.uint64(0xFFFFFFFF)).astype(np.int64), n_live,
                "count")
    n = 1
    while n < len(keys):
        n *= 2
    keys = np.concatenate([keys, np.full(n - len(keys), ~np.uint64(0))])
    i = np.arange(n)
    k = 2
    while k <= n:
        j = k // 2
        while j > 0:
            lo = i[(i ^ j) > i]
            hi = lo ^ j
            a, b = keys[lo], keys[hi]
            swap = (a > b) == ((lo & k) == 0)
            keys[lo[swap]], keys[hi[swap]] = b[swap], a[swap]
            j //= 2
        k *= 2
    return ((keys[:n_live] & np.uint64(0xFFFFFFFF)).astype(np.int64), n_live,
            "bitonic")


@pytest.mark.parametrize("E", [160, 2560])
@pytest.mark.parametrize("kind", ["random", "eighths", "signed"])
@pytest.mark.parametrize("k_cap", [8, 64, 2560])
def test_decode_order_matches_stable_sort(E, kind, k_cap):
    """The kernel's keys and their ordering (counting ranks, or the bitonic
    sort past 1024 eligible pairs) give exactly the trips of the plain
    version (``greedy_decode``: ``torch.sort(stable=True)`` of the masked
    scores, descending, and n_live = min(#eligible, k_cap)): random scores,
    scores on a grid of eighths (ties, to the lower index), signed scores
    with zeros of both signs under a negative threshold; a third of the
    pairs absent; k_cap below and above #eligible."""
    rng = np.random.default_rng(E + k_cap)
    if kind == "random":
        scores, threshold = rng.random(E), 0.5
    elif kind == "eighths":
        scores, threshold = np.round(rng.random(E) * 8) / 8, 0.5
    else:
        scores = np.round(rng.normal(size=E) * 4) / 8
        scores[rng.random(E) < 0.1] = -0.0
        threshold = -0.3
    scores = torch.tensor(scores, dtype=torch.float32)
    pmask = torch.tensor(rng.random(E) > 1 / 3, dtype=torch.float32)
    K = min(k_cap, E)
    order, n_live, how = kernel_decode_order(scores, pmask, threshold, K,
                                             rng)
    eligible = (pmask > 0.5) & (scores > threshold)
    masked = torch.where(eligible, scores,
                         torch.full_like(scores, float("-inf")))
    ref = torch.sort(masked, descending=True, stable=True).indices[:K]
    assert n_live == min(int(eligible.sum()), K)
    assert n_live > 0
    if k_cap == 8:                      # below #eligible
        assert n_live < int(eligible.sum())
    if k_cap == 2560:                   # at or above #eligible
        assert n_live == int(eligible.sum())
    np.testing.assert_array_equal(order, ref[:n_live].numpy())
    # both orderings of the kernel are exercised: counting up to RANK_SORT
    # eligible pairs, the bitonic sort past it
    assert how == ("bitonic" if (E, kind) == (2560, "signed") else "count")
