"""``infer_fused`` of the port on the CPU against the JAX pipeline.

The JAX side serves without the whole-frame kernel (``use_frame_kernel=
False``), bf16 lifter weights and operands (``serve_dtype=bfloat16``) and the
packing prior of the checkpoint meta, so it runs the same math as the port.
Both get the same synthetic frames and the same weights (through
``weights.py``).  Persons must be equal; scores are held to 1e-5 (fp32 GAT);
poses to 1e-2 m: the lifter's bf16 operands turn last-bit fp32 differences
into rounding flips that cascade through its 9 layers (millimetres here);
the quality column, computed from the poses, to 0.5 px.  Scores within 1e-5
of the threshold, where a decode could legitimately differ, are counted and
reported in the assertion message.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpe3d_tpu.cli import load_models
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import generate_frames, synthetic_ring_rig
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo",
                    "pan_irls_bf16")
N_FRAMES = 6


@pytest.fixture(scope="module")
def setup():
    mparams, mcfg, lparams, lcfg, prior = load_models(DEMO, J_PANOPTIC)
    rig = synthetic_ring_rig(PANOPTIC)
    port = PoseEstimationPipeline.from_checkpoint(
        DEMO, rig, device="cpu", slot_buckets=(4,), person_buckets=(8,))
    assert port.lifter_prior == prior == "irls"
    assert port.lifter.cfg.residual_prior == lcfg.residual_prior

    def jax_pipe(matcher_params):
        return JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), matcher_params, mcfg,
                         lparams, lcfg, slot_buckets=(4,),
                         person_buckets=(8,), use_frame_kernel=False,
                         serve_dtype=jnp.bfloat16, lifter_prior=prior)
    frames = generate_frames(PANOPTIC, rig, N_FRAMES, n_people=(2, 3), seed=1)
    return port, jax_pipe, mparams, frames


def _compare(port, ref_pipe, frames):
    near, n_persons = 0, 0
    for f in frames:
        a = ref_pipe.infer_fused(j_parse(f, J_PANOPTIC))
        b = port.infer_fused(parse_frame(f, PANOPTIC))
        near += int((np.abs(a.scores - 0.5) < 1e-5).sum())
        note = f"{near} scores within 1e-5 of the threshold"
        np.testing.assert_array_equal(b.persons, a.persons, err_msg=note)
        assert b.persons.dtype == a.persons.dtype == np.int32
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5, err_msg=note)
        np.testing.assert_allclose(b.poses, a.poses, atol=1e-2)
        np.testing.assert_allclose(b.quality, a.quality, atol=0.5)
        assert b.n_heads == a.n_heads
        n_persons += len(b.persons)
    return n_persons


def test_infer_fused_trained_weights(setup):
    port, jax_pipe, mparams, frames = setup
    _compare(port, jax_pipe(mparams), frames)


def test_infer_fused_random_matcher(setup):
    """numpy seed 0: its scores sit above the threshold, so every present
    pair is a candidate and the decode, pack and lifter run on persons."""
    port, jax_pipe, _, frames = setup
    tree = weights.random_matcher_tree(port.matcher.cfg, 0)
    port.matcher = weights.matcher_from_tree(tree, port.matcher.cfg, "cpu")
    n = _compare(port, jax_pipe(jax.tree_util.tree_map(jnp.asarray, tree)),
                 frames)
    assert n >= 2 * N_FRAMES
