"""The two shipped Panoptic pairs no other port test loads, through
``from_checkpoint`` on the CPU, against the JAX pipeline on the same
export:

* ``models_demo/pan_res``, the shipping end-to-end pair
  (``models_demo/README.md``): widefield matcher, int8-stored residual-prior
  lifter, the median prior; both sides serve its lifter int8;
* ``models_demo/pan_lowview_bf16``: the same matcher, a bf16-stored
  residual-prior lifter with the IRLS prior; the JAX side serves bf16
  (``serve_dtype=bfloat16``), as the port does.

Each on the eager path's and the frame path's plain versions, with the
pair's trained matcher (which decodes few persons on the ring rig) and the
numpy-seeded random matcher (seed 0: every present pair a candidate).
Tolerances as ``tests/test_torch_quant.py``: persons equal (int32), scores
1e-5 (fp32 GAT), poses 1e-2 m (bf16 rounding cascades through the
lifter).
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
from mpe3d_tpu_torch.ops.fused_mlp import Bf16Layer, Int8Layer
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo")
N_FRAMES = 6
# model -> (lifter dtype served, packing prior, JAX serve_dtype)
PAIRS = {"pan_res": ("int8", "median", None),
         "pan_lowview_bf16": ("bf16", "irls", jnp.bfloat16)}


@pytest.fixture(scope="module")
def frames():
    return generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), N_FRAMES,
                           n_people=(2, 3), seed=1)


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
        n_persons += len(b.persons)
    return n_persons


@pytest.mark.parametrize("frame_path", [False, True])
@pytest.mark.parametrize("model", sorted(PAIRS))
def test_demo_pair_against_reference(frames, model, frame_path):
    dtype, prior, j_dtype = PAIRS[model]
    d = os.path.join(DEMO, model)
    mparams, mcfg, lparams, lcfg, j_prior = load_models(d, J_PANOPTIC)
    port = PoseEstimationPipeline.from_checkpoint(
        d, synthetic_ring_rig(PANOPTIC), device="cpu", slot_buckets=(4,),
        person_buckets=(8,), use_frame_kernel=frame_path)
    assert port.serve_dtype == dtype
    assert port.lifter_prior == j_prior == prior
    assert port.lifter.cfg.residual_prior and lcfg.residual_prior
    kind = Int8Layer if dtype == "int8" else Bf16Layer
    assert [type(layer) for layer in port.lifter.packed_layers()] == (
        [kind] * 8 + [Bf16Layer])

    def ref(matcher):
        kw = {} if j_dtype is None else {"serve_dtype": j_dtype}
        return JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), matcher, mcfg,
                         lparams, lcfg, slot_buckets=(4,),
                         person_buckets=(8,), use_frame_kernel=False,
                         lifter_prior=prior, **kw)

    _compare(port, ref(mparams), frames)
    tree = weights.random_matcher_tree(port.matcher.cfg, 0)
    port.matcher = weights.matcher_from_tree(tree, port.matcher.cfg, "cpu")
    assert _compare(port, ref(jax.tree_util.tree_map(jnp.asarray, tree)),
                    frames) >= 2 * N_FRAMES
