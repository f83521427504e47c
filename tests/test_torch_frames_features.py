"""Synthetic frames, the wire parser and the matcher features of the port
against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import SceneNoise as JNoise
from mpe3d_tpu.data.synthetic import generate_frames as j_generate
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.matching import features as jfeat
from mpe3d_tpu_torch.config import PANOPTIC
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import (SceneNoise, generate_frames,
                                            synthetic_ring_rig)
from mpe3d_tpu_torch.matching import features as tfeat

import torch_testing  # noqa: F401


@pytest.fixture(scope="module")
def rigs():
    return j_ring(J_PANOPTIC), synthetic_ring_rig(PANOPTIC)


@pytest.mark.parametrize("seed,people,outliers", [(1, (2, 3), 0.0),
                                                  (7, (1, 6), 0.05)])
def test_generate_frames_identical(rigs, seed, people, outliers):
    jr, tr = rigs
    a = j_generate(J_PANOPTIC, jr, 4, n_people=people, seed=seed,
                   noise=JNoise(outlier_rate=outliers))
    b = generate_frames(PANOPTIC, tr, 4, n_people=people, seed=seed,
                        noise=SceneNoise(outlier_rate=outliers))
    assert a == b


@pytest.mark.parametrize("max_skeletons", [4, 10])
def test_parse_frame_identical(rigs, max_skeletons):
    jr, _ = rigs
    for f in j_generate(J_PANOPTIC, jr, 4, n_people=(2, 6), seed=11):
        a = j_parse(f, J_PANOPTIC, max_skeletons)
        b = parse_frame(f, PANOPTIC, max_skeletons)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("C,S", [(5, 4), (5, 2), (3, 10)])
def test_build_topology_exact(C, S):
    a = jfeat.build_topology(C, S)
    b = tfeat.build_topology(C, S)
    assert (b.n_heads, b.n_pairs) == (a.n_heads, a.n_pairs)
    for k in ("e1", "e2", "cam1", "cam2"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    inc = tfeat.incident_edges(b)
    assert inc.shape == (C * S, (C - 1) * S)
    # the incidence lists are exactly the reference's one-hot incidence
    one_hot = np.zeros((C * S, a.n_pairs))
    np.put_along_axis(one_hot, inc.astype(np.int64), 1.0, axis=1)
    np.testing.assert_array_equal(one_hot, (a.inc1 + a.inc2).T)


def test_head_edge_features_and_pair_mask(rigs):
    """alt-3 features within 1e-6 (same fp32 formulas)."""
    jr, tr = rigs
    trt = tr.to("cpu")
    topo = tfeat.build_topology(5, 4)
    jtopo = jfeat.build_topology(5, 4)
    size = (1920.0, 1080.0)
    for f in j_generate(J_PANOPTIC, jr, 3, n_people=(2, 4), seed=2):
        fa = j_parse(f, J_PANOPTIC, 4)
        ja, jm = jfeat.head_features(fa.kp, fa.valid, fa.prob, fa.in_view,
                                     fa.present, jr, size)
        ta, tm = tfeat.head_features(
            *(torch.from_numpy(x) for x in (fa.kp, fa.valid, fa.prob,
                                             fa.in_view, fa.present)),
            trt, size)
        assert ta.shape == (20, PANOPTIC.matcher_feature_dim)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        pm = tfeat.pair_mask_from_present(torch.from_numpy(fa.present),
                                          torch.from_numpy(topo.e1),
                                          torch.from_numpy(topo.e2))
        np.testing.assert_array_equal(
            pm.numpy(), np.asarray(jfeat.pair_mask_from_present(
                jnp.asarray(fa.present), jtopo)))
    np.testing.assert_array_equal(
        tfeat.edge_node_features(160, 902).numpy(),
        jfeat.edge_node_features(160, 902))
