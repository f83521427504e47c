"""Camera and triangulation functions of the port against the JAX package.

Same numpy-seeded inputs through both; fp32 throughout.  3D results are
held to 1e-5 m, pixels to 1e-3 px (fp32 at ~1e3 px magnitude), normalized
coordinates and rays to 1e-6: the arithmetic is the same, only the order of
a few fp32 operations may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.geometry import camera as jcam
from mpe3d_tpu.geometry import triangulate as jtri
from mpe3d_tpu_torch.config import PANOPTIC
from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
from mpe3d_tpu_torch.geometry import camera as tcam
from mpe3d_tpu_torch.geometry import triangulate as ttri

import torch_testing  # noqa: F401

ATOL_M = 1e-5


@pytest.fixture(scope="module")
def rigs():
    jr = j_ring(J_PANOPTIC)
    tr = synthetic_ring_rig(PANOPTIC)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(np.asarray(a), b)
    return jr, tr.to("cpu")


@pytest.fixture(scope="module")
def observations(rigs):
    """[C, J, 2] pixels of 18 random joints near the scene centre, pixel
    noise and a few invalid/outlier observations; validity [C, J]."""
    jr, _ = rigs
    rng = np.random.default_rng(3)
    pts = (rng.normal(0, 0.5, (18, 3)) + [0.0, -0.9, 0.0]).astype(np.float32)
    pix = np.asarray(jcam.project_points(
        jnp.asarray(pts)[None], jr.T_wc[:, None], jr.K[:, None],
        jr.dist[:, None], tangential=True))
    pix = pix + rng.normal(0, 1.0, pix.shape)
    pix[1, 3] += 60.0                                   # a confident outlier
    valid = (rng.random(pix.shape[:2]) > 0.2).astype(np.float32)
    return pts, pix.astype(np.float32), valid


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_intrinsics_and_rig(rigs):
    K, dist = jcam.intrinsics_from_rig_config(J_PANOPTIC)
    K2, dist2 = tcam.intrinsics_from_rig_config(PANOPTIC)
    np.testing.assert_array_equal(K, K2)
    np.testing.assert_array_equal(dist, dist2)
    jr, tr = rigs
    sub = synthetic_ring_rig(PANOPTIC).select((0, 2, 4))
    jsub = jr.select(np.array([0, 2, 4]))
    for a, b in zip(jsub, sub):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(jcam.cam_centers_world(jr.T_cw)),
                                  tcam.cam_centers_world(tr.T_cw).numpy())


def test_undistort_points(rigs, observations):
    jr, tr = rigs
    _, pix, _ = observations
    a = jcam.undistort_points(jnp.asarray(pix), jr.K[:, None],
                              jr.dist[:, None])
    b = tcam.undistort_points(_t(pix), tr.K[:, None], tr.dist[:, None])
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_project_points(rigs, observations):
    jr, tr = rigs
    pts, _, _ = observations
    for md in (0.0, 1e-4):
        a = jcam.project_points(jnp.asarray(pts)[None], jr.T_wc[:, None],
                                jr.K[:, None], jr.dist[:, None], min_depth=md)
        b = tcam.project_points(_t(pts)[None], tr.T_wc[:, None],
                                tr.K[:, None], tr.dist[:, None], min_depth=md)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)


def test_pixel_rays_world(rigs, observations):
    jr, tr = rigs
    _, pix, _ = observations
    a = jcam.pixel_rays_world(jnp.asarray(pix), jr.K_inv[:, None],
                              jr.T_cw[:, None])
    b = tcam.pixel_rays_world(_t(pix), tr.K_inv[:, None], tr.T_cw[:, None])
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_solve3x3():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(64, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    a = jtri._solve3x3(jnp.asarray(M), jnp.asarray(b))
    t = ttri._solve3x3(_t(M), _t(b))
    np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_triangulate_pair(rigs, observations):
    jr, tr = rigs
    _, pix, _ = observations
    jxn = jcam.undistort_points(jnp.asarray(pix), jr.K[:, None],
                                jr.dist[:, None])
    txn = tcam.undistort_points(_t(pix), tr.K[:, None], tr.dist[:, None])
    a = jtri.triangulate_pair(jxn[0], jxn[2], jr.T_wc[0, :3, :],
                              jr.T_wc[2, :3, :])
    b = ttri.triangulate_pair(txn[0], txn[2], tr.T_wc[0, :3, :],
                              tr.T_wc[2, :3, :])
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL_M)


@pytest.mark.parametrize("name", ["triangulate_mean",
                                  "triangulate_median_filtered",
                                  "triangulate_irls"])
def test_triangulate(rigs, observations, name):
    jr, tr = rigs
    pts, pix, valid = observations
    jx, jok = getattr(jtri, name)(jnp.asarray(pix), jnp.asarray(valid), jr)
    tx, tok = getattr(ttri, name)(_t(pix), _t(valid), tr)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL_M)
    # a batch of persons gives the per-person results
    tb, okb = getattr(ttri, name)(torch.stack([_t(pix), _t(pix) + 0.5]),
                                  torch.stack([_t(valid)] * 2), tr)
    np.testing.assert_allclose(tb[0].numpy(), tx.numpy(), atol=1e-6)
    jx2, _ = getattr(jtri, name)(jnp.asarray(pix) + 0.5, jnp.asarray(valid), jr)
    np.testing.assert_allclose(tb[1].numpy(), np.asarray(jx2), atol=ATOL_M)
    assert bool(tok[np.asarray(valid).sum(0) >= 2].all())
