"""The port's tiled GAT stack and pair pruning (plain versions) against the
JAX package, on the CPU.

* ``gat_stack_tiled_plain`` (through ``apply_matcher_tiled``) against the
  JAX ``apply_matcher_tiled`` with its Pallas kernels in interpret mode, as
  ``tests/test_ops.py::test_matcher_tiled_matches_xla`` runs them: scores
  within 2e-5 (the reference's own gate between its tiled and XLA forms;
  both sides fp32, head sums in another order).
* The tiled form against the port's stack form where both serve: 1e-5.
* ``pair_ray_distances`` within 1e-5 m; ``prune_pair_candidates`` with equal
  indices and weights on frames whose ranks have no near-ties (checked).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import SceneNoise as JSceneNoise
from mpe3d_tpu.data.synthetic import generate_frames as j_generate
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.matching import features as jfeat
from mpe3d_tpu.ops.gat_tiled import apply_matcher_tiled as j_tiled
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.checkpoint import load_matcher_checkpoint
from mpe3d_tpu_torch.config import PANOPTIC, MatcherConfig
from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
from mpe3d_tpu_torch.matching import features as tfeat
from mpe3d_tpu_torch.models import gat as tgat
from mpe3d_tpu_torch.ops import gat_tiled

TILED_TOL = 2e-5
STACK_TOL = 1e-5
DIST_TOL_M = 1e-5
DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo",
                    "pan_irls_bf16")


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _both(tree, cfg, hf, ef, pm, C, S, edge_const):
    """(JAX tiled scores in interpret mode, port tiled scores)."""
    jcfg = JMatcherConfig(in_dim=cfg.in_dim, hidden=cfg.hidden,
                          heads=cfg.heads, alpha=cfg.alpha,
                          hidden_slope=cfg.hidden_slope)
    ref = j_tiled(_jax_tree(tree), jnp.asarray(hf), ef,
                  jfeat.build_topology(C, S), jnp.asarray(pm), jcfg,
                  interpret=True, edge_const=edge_const)
    m = weights.matcher_from_tree(tree, cfg, "cpu")
    gtopo = tgat.gat_topology(tfeat.build_topology(C, S), "cpu", "tiled")
    got = tgat.apply_matcher_tiled(m, torch.tensor(hf), torch.tensor(ef),
                                   gtopo, torch.tensor(pm), edge_const)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("C,S", [(5, 10), (6, 16)])
@pytest.mark.parametrize("edge_const", [False, True])
def test_small_tiled_stack_against_pallas_interpret(C, S, edge_const):
    """Narrow layers on the Panoptic S=10 topology (E=1000) and on the
    ARPLAB-shaped 6 x 16 one (E=3840, head degree 80), some pairs dead."""
    d_in = 20
    cfg = MatcherConfig(in_dim=d_in, hidden=(6, 6), heads=(2, 2))
    tree = weights.random_matcher_tree(cfg, 3)
    E = C * (C - 1) // 2 * S * S
    rng = np.random.default_rng(9 + S)
    hf = rng.normal(size=(C * S, d_in)).astype(np.float32)
    ef = (tfeat.edge_node_features(E, d_in).numpy() if edge_const
          else rng.normal(size=(E, d_in)).astype(np.float32))
    pm = (rng.random(E) < 0.8).astype(np.float32)
    ref, got = _both(tree, cfg, hf, ef, pm, C, S, edge_const)
    np.testing.assert_allclose(got, ref, atol=TILED_TOL)


@pytest.fixture(scope="module")
def crowded_s8():
    """Alt-3 inputs of a synthetic Panoptic frame of 5-7 people at S=8
    (H=40, E=640), one slot emptied; both packages' rigs and frames."""
    jr = j_ring(J_PANOPTIC)
    f = j_generate(J_PANOPTIC, jr, 1, n_people=(5, 7), seed=21)[0]
    fa = j_parse(f, J_PANOPTIC, 8)
    fa = fa._replace(present=fa.present.copy())
    fa.present[1, 2] = False
    jtopo = jfeat.build_topology(5, 8)
    hf, _ = jfeat.head_features(fa.kp, fa.valid, fa.prob, fa.in_view,
                                fa.present, jr, (1920.0, 1080.0))
    pm = np.asarray(jfeat.pair_mask_from_present(jnp.asarray(fa.present),
                                                 jtopo))
    ef = tfeat.edge_node_features(jtopo.n_pairs, 902).numpy()
    return np.asarray(hf), ef, pm


@pytest.mark.parametrize("edge_const", [False, True])
def test_trained_tiled_stack_full_width(crowded_s8, edge_const):
    """The trained pan_irls_bf16 matcher at full width (902 -> 40x10, 40x10,
    40x8, 30x5 -> 1) on S=8: against the JAX tiled stack in interpret mode,
    and against the port's stack form, which serves S=8 too."""
    hf, ef, pm = crowded_s8
    tree, cfg = load_matcher_checkpoint(
        os.path.join(DEMO, "skeleton_matching"), MatcherConfig())
    ref, got = _both(tree, cfg, hf, ef, pm, 5, 8, edge_const)
    np.testing.assert_allclose(got, ref, atol=TILED_TOL)
    m = weights.matcher_from_tree(tree, cfg, "cpu")
    stack = tgat.apply_matcher(
        m, torch.tensor(hf), torch.tensor(ef),
        tgat.gat_topology(tfeat.build_topology(5, 8), "cpu"),
        torch.tensor(pm)).numpy()
    np.testing.assert_allclose(got, stack, atol=STACK_TOL)


@pytest.mark.parametrize("C,S,seed", [(3, 2, 0), (5, 4, 1), (5, 10, 2),
                                      (6, 16, 3)])
def test_tiled_matches_stack_plain(C, S, seed):
    """Random narrow weights: the two forms of the port on one input (the
    stack form at any degree here: its plain version has no cap)."""
    d_in = 24
    cfg = MatcherConfig(in_dim=d_in, hidden=(8, 6), heads=(3, 2))
    m = weights.matcher_from_tree(weights.random_matcher_tree(cfg, seed),
                                  cfg, "cpu")
    topo = tfeat.build_topology(C, S)
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(topo.n_heads + topo.n_pairs, d_in))
                     .astype(np.float32))
    pw = torch.tensor((rng.random(topo.n_pairs) > 0.3).astype(np.float32))
    a = m(x, pw, tgat.gat_topology(topo, "cpu"))
    b = m(x, pw, tgat.gat_topology(topo, "cpu", "tiled"), "tiled")
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=STACK_TOL)


def test_tiled_rejects_other_devices():
    topo = tgat.gat_topology(tfeat.build_topology(3, 2), "cpu", "tiled")
    x = torch.zeros((18, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gat_tiled.gat_stack_tiled(x, x[:12, 0], topo, x[0], [(4, 1, 1)],
                                  0.15, 0.01)


# ---------------------------------------------------------------------------
# pair pruning
# ---------------------------------------------------------------------------

S_PRUNE = 8


def _prune_frames(seed, n=3):
    """Dense S=8 frames with detector noise, parsed by both packages."""
    jr = j_ring(J_PANOPTIC)
    noise = JSceneNoise(pixel_sigma=1.5, joint_dropout=0.05,
                        spurious_rate=0.08, camera_dropout=0.05)
    fs = j_generate(J_PANOPTIC, jr, n, n_people=(5, 7), seed=seed,
                    noise=noise, with_gt=False)
    return [j_parse(f, J_PANOPTIC, max_skeletons=S_PRUNE) for f in fs]


def _prune_inputs(fa):
    kp = fa.kp[:, :S_PRUNE].astype(np.float32)
    shared = (fa.valid[:, :S_PRUNE]
              * fa.in_view[:, :S_PRUNE]).astype(np.float32)
    return kp, shared, fa.present[:, :S_PRUNE]


def _port_rig():
    rig = synthetic_ring_rig(PANOPTIC)
    return rig.select(PANOPTIC.matching_camera_indices()).to("cpu")


@pytest.mark.parametrize("seed", [5, 33])
def test_pair_ray_distances_match_reference(seed):
    jr = j_ring(J_PANOPTIC)
    jtopo = jfeat.build_topology(5, S_PRUNE)
    ttopo = tfeat.build_topology(5, S_PRUNE)
    for fa in _prune_frames(seed):
        kp, shared, _ = _prune_inputs(fa)
        ref = np.asarray(jfeat.pair_ray_distances(
            jnp.asarray(kp), jnp.asarray(shared), jr, jtopo))
        got = tfeat.pair_ray_distances(torch.tensor(kp), torch.tensor(shared),
                                       _port_rig(), ttopo).numpy()
        assert (ref < 999.0).sum() > 100           # rays were compared
        np.testing.assert_allclose(got, ref, atol=DIST_TOL_M)


def _near_tie(rank: np.ndarray, d_of_pruned: np.ndarray) -> bool:
    """Whether two ranks are within 1e-6 of each other without being equal,
    or a pruned rank (1e6 + d in fp32) could round another way under a 1e-6
    change of d: then the 1e-7 differences of the two packages' distances
    may reorder the pairs."""
    r = np.sort(rank.astype(np.float64))
    gaps = np.diff(r)
    if ((gaps > 0) & (gaps < 1e-6)).any():
        return True
    d = d_of_pruned.astype(np.float32)
    lo = np.float32(1e6) + (d - np.float32(1e-6))
    hi = np.float32(1e6) + (d + np.float32(1e-6))
    return bool((lo != hi).any())


@pytest.mark.parametrize("dist,cap", [(0.15, 320), (0.3, 200), (0.05, 640)])
def test_prune_pair_candidates_match_reference(dist, cap):
    jr = j_ring(J_PANOPTIC)
    jtopo = jfeat.build_topology(5, S_PRUNE)
    ttopo = tfeat.build_topology(5, S_PRUNE)
    n_kept, n_exact = 0, 0
    for fa in _prune_frames(33) + _prune_frames(5):
        kp, shared, present = _prune_inputs(fa)
        pm = np.asarray(jfeat.pair_mask_from_present(jnp.asarray(present),
                                                     jtopo))
        d = np.asarray(jfeat.pair_ray_distances(
            jnp.asarray(kp), jnp.asarray(shared), jr, jtopo))
        d_rank = np.where(d >= 999.0, np.float32(dist), d)
        keep = (pm > 0) & (d_rank <= dist)
        rank = np.where(keep, d_rank, np.float32(1e6) + d_rank)
        idx, w = jax.device_get(jfeat.prune_pair_candidates(
            jnp.asarray(kp), jnp.asarray(shared), jr, jtopo, jnp.asarray(pm),
            dist, cap))
        tidx, tw = tfeat.prune_pair_candidates(
            torch.tensor(kp), torch.tensor(shared), _port_rig(), ttopo,
            torch.tensor(pm), dist, cap)
        np.testing.assert_array_equal(tw.numpy(), w[:, 0])
        if _near_tie(rank, d_rank[~keep]):
            # only near-tied pairs may trade places
            tidx = tidx.numpy()
            gap = np.abs(rank[tidx].astype(np.float64) - rank[idx])
            assert np.all((tidx == idx) | (gap < 1e-6))
        else:
            np.testing.assert_array_equal(tidx.numpy(), idx)
            n_exact += 1
        n_kept += int(tw.sum())
    assert n_kept > 0 and n_exact >= 4
