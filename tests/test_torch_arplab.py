"""The ARPLAB rig (6 cameras, two of them robot-mounted) and its three
shipped pairs, on the CPU, against the JAX pipeline on the same exports:

* ``models_demo/arp_irls``: int8-stored lifter, IRLS prior;
* ``models_demo/arp_irls_bf16``: bf16-stored lifter, IRLS prior (the JAX
  side serves bf16, ``serve_dtype=bfloat16``, as the port does);
* ``models_demo/arplab``: int8-stored lifter, median prior.

Each with its trained matcher (which decodes few persons on the synthetic
ring rig) and a numpy-seeded random one (seed 2: on these frames every
present pair scores above the threshold), on the frame path's plain
versions (``use_frame_kernel=True``), the eager path and ``infer_batch``,
at S=4 (the stack GAT form, E=240 pairs) and S=10 (the tiled form,
E=1500).  Persons equal (int32), scores within 1e-5 (stack) / 4e-5 (tiled:
the head sums run over the incidence list in another order,
``tests/test_torch_staged.py::TILED_SCORE_TOL``), poses within 1e-2 m (the
bf16 lifter's rounding cascade).  The S=10 frame is packed with the "mean"
prior on both sides: there the decode may group skeletons of different
people, and the IRLS prior of such groups is ill-conditioned
(``tests/test_torch_crowded.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpe3d_tpu.cli import load_models
from mpe3d_tpu.config import ARPLAB as J_ARPLAB
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                        load_matcher_checkpoint)
from mpe3d_tpu_torch.config import ARPLAB, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import generate_frames, synthetic_ring_rig
from mpe3d_tpu_torch.ops.fused_mlp import Bf16Layer, Int8Layer
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

import torch_testing  # noqa: F401

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo")
# model -> (lifter dtype served, packing prior, JAX serve_dtype)
PAIRS = {"arp_irls": ("int8", "irls", None),
         "arp_irls_bf16": ("bf16", "irls", jnp.bfloat16),
         "arplab": ("int8", "median", None)}
RANDOM_SEED = 2
SCORE_TOL = {"stack": 1e-5, "tiled": 4e-5}
POSE_TOL_M = 1e-2
# bucket -> (slot bucket, person bucket, prior: None for the pair's own)
BUCKETS = {4: ((4,), (8,), None), 10: ((10,), (16,), "mean")}


@pytest.fixture(scope="module")
def frames():
    rig = synthetic_ring_rig(ARPLAB)
    return {4: generate_frames(ARPLAB, rig, 2, n_people=(2, 3), seed=1),
            10: generate_frames(ARPLAB, rig, 1, n_people=(6, 8), seed=3)}


@pytest.fixture(scope="module", params=sorted(PAIRS))
def pair(request):
    name = request.param
    d = os.path.join(DEMO, name)
    mtree, mcfg = load_matcher_checkpoint(
        os.path.join(d, "skeleton_matching"),
        MatcherConfig(in_dim=ARPLAB.matcher_feature_dim))
    ltree, lcfg, prior = load_lifter_checkpoint(
        os.path.join(d, "pose_estimator"),
        LifterConfig(in_dim=ARPLAB.lifter_input_dim,
                     out_dim=ARPLAB.n_joints * 3))
    return name, load_models(d, J_ARPLAB), (mtree, mcfg, ltree, lcfg, prior)


def _compare(port, ref, wires, form):
    n_persons = 0
    for f in wires:
        a = ref.infer_fused(j_parse(f, J_ARPLAB))
        outs = [port.infer_fused(parse_frame(f, ARPLAB))]
        outs += port.infer_batch([parse_frame(f, ARPLAB)] * 2)
        for b in outs:
            np.testing.assert_array_equal(b.persons, a.persons)
            assert b.persons.dtype == a.persons.dtype == np.int32
            np.testing.assert_allclose(b.scores, a.scores,
                                       atol=SCORE_TOL[form])
            np.testing.assert_allclose(b.poses, a.poses, atol=POSE_TOL_M)
        n_persons += len(a.persons)
    return n_persons


@pytest.mark.parametrize("matcher", ["trained", "random"])
def test_arplab_pair_against_reference(frames, pair, matcher):
    name, (jm, jmcfg, jl, jlcfg, j_prior), (mtree, mcfg, ltree, lcfg,
                                            prior) = pair
    dtype, want_prior, j_dtype = PAIRS[name]
    assert prior == j_prior == want_prior
    assert mcfg.in_dim == jmcfg.in_dim == 1082
    assert lcfg.in_dim == jlcfg.in_dim == 1512
    if matcher == "random":
        mtree = weights.random_matcher_tree(mcfg, RANDOM_SEED)
        jm = jax.tree_util.tree_map(jnp.asarray, mtree)
    rig = synthetic_ring_rig(ARPLAB)
    lifter = weights.lifter_from_tree(ltree, lcfg, "cpu")
    assert lifter.serve_dtype == dtype
    kind = Int8Layer if dtype == "int8" else Bf16Layer
    assert [type(layer) for layer in lifter.packed_layers()] == (
        [kind] * 8 + [Bf16Layer])
    n_persons = 0
    for S, (slots, persons, bucket_prior) in BUCKETS.items():
        p = bucket_prior or prior
        kw = {} if j_dtype is None else {"serve_dtype": j_dtype}
        ref = JPipeline(J_ARPLAB, j_ring(J_ARPLAB), jm, jmcfg, jl, jlcfg,
                        slot_buckets=slots, person_buckets=persons,
                        use_frame_kernel=False, lifter_prior=p, **kw)
        for frame_path in (True, False):
            port = PoseEstimationPipeline(
                ARPLAB, rig, weights.matcher_from_tree(mtree, mcfg, "cpu"),
                lifter, slot_buckets=slots, person_buckets=persons,
                lifter_prior=p, use_frame_kernel=frame_path, device="cpu")
            form = "tiled" if S == 10 else "stack"
            assert port.serving_path(S) == (form, frame_path)
            if frame_path:
                plan = port.batch_plan(S, 2)
                assert plan.union and plan.chunks == (2,)
            n_persons += _compare(port, ref, frames[S], form)
    if matcher == "random":
        assert n_persons >= 2 * 2 * 4


def test_arplab_union_chunk():
    """ARPLAB S=4 on the frame path: union chunks of 21 frames (512 heads
    for the tiled form's incidence build, 24 a frame)."""
    mcfg = MatcherConfig(in_dim=ARPLAB.matcher_feature_dim, hidden=(8,),
                         heads=(2,))
    lcfg = LifterConfig(in_dim=ARPLAB.lifter_input_dim,
                        out_dim=ARPLAB.n_joints * 3, widths=(32,))
    port = PoseEstimationPipeline(
        ARPLAB, synthetic_ring_rig(ARPLAB),
        weights.matcher_from_tree(weights.random_matcher_tree(mcfg, 0),
                                  mcfg, "cpu"),
        weights.lifter_from_tree(weights.random_lifter_tree(lcfg, 1), lcfg,
                                 "cpu"),
        slot_buckets=(4,), person_buckets=(8,), use_frame_kernel=True,
        device="cpu")
    assert port.batch_plan(4, 50).chunks == (21, 21, 8)
