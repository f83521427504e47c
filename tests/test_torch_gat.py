"""The port's GAT stack (plain version) against the JAX package.

Scores are held to 1e-5: both sides compute in fp32, the port gathers and
sums by index where the reference multiplies by 0/1 incidence matrices, so
only the order of fp32 sums differs.
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
from mpe3d_tpu.data.synthetic import generate_frames as j_generate
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.matching import features as jfeat
from mpe3d_tpu.models.gat import TopologyArrays, apply_matcher
from mpe3d_tpu.ops.gat_kernel import apply_matcher_pallas
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.checkpoint import load_matcher_checkpoint
from mpe3d_tpu_torch.config import MatcherConfig
from mpe3d_tpu_torch.matching.features import (build_topology,
                                               edge_node_features)
from mpe3d_tpu_torch.models import gat as tgat

ATOL = 1e-5
DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo")


def _port_scores(tree, cfg, hf, ef, pm, C, S):
    m = weights.matcher_from_tree(tree, cfg, "cpu")
    gtopo = tgat.gat_topology(build_topology(C, S), "cpu")
    return tgat.apply_matcher(m, torch.tensor(hf), torch.tensor(ef), gtopo,
                              torch.tensor(pm)).numpy()


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_small_stack_against_pallas_interpret(seed):
    """Two narrow layers on a 3-camera x 2-slot graph, some pairs dead."""
    C, S, d_in = 3, 2, 24
    cfg = MatcherConfig(in_dim=d_in, hidden=(8,), heads=(3,))
    jcfg = JMatcherConfig(in_dim=d_in, hidden=(8,), heads=(3,))
    tree = weights.random_matcher_tree(cfg, seed)
    jtopo = jfeat.build_topology(C, S)
    rng = np.random.default_rng(seed)
    hf = rng.normal(size=(C * S, d_in)).astype(np.float32)
    ef = edge_node_features(jtopo.n_pairs, d_in).numpy()
    pm = (rng.random(jtopo.n_pairs) > 0.3).astype(np.float32)
    ref = apply_matcher_pallas(_jax_tree(tree), jnp.asarray(hf),
                               jnp.asarray(ef), jtopo, jnp.asarray(pm), jcfg,
                               interpret=True)
    got = _port_scores(tree, cfg, hf, ef, pm, C, S)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)


@pytest.fixture(scope="module")
def frame_inputs():
    """Alt-3 features of a synthetic Panoptic frame at S=4 (H=20, E=160)."""
    jr = j_ring(J_PANOPTIC)
    f = j_generate(J_PANOPTIC, jr, 1, n_people=(3, 3), seed=4)[0]
    fa = j_parse(f, J_PANOPTIC, 4)
    fa = fa._replace(present=fa.present.copy())
    fa.present[2, 3] = False                       # one absent slot
    jtopo = jfeat.build_topology(5, 4)
    hf, _ = jfeat.head_features(fa.kp, fa.valid, fa.prob, fa.in_view,
                                fa.present, jr, (1920.0, 1080.0))
    pm = np.asarray(jfeat.pair_mask_from_present(jnp.asarray(fa.present),
                                                 jtopo))
    ef = jfeat.edge_node_features(jtopo.n_pairs, 902)
    return np.asarray(hf), ef, pm, jtopo


@pytest.mark.parametrize("weights_from", ["widefield", "random"])
def test_full_stack_against_xla(frame_inputs, weights_from):
    """Full width (902 -> 40x10, 40x10, 40x8, 30x5 -> 1) on H=20/E=160."""
    hf, ef, pm, jtopo = frame_inputs
    if weights_from == "widefield":
        tree, cfg = load_matcher_checkpoint(
            os.path.join(DEMO, "widefield", "skeleton_matching"),
            MatcherConfig())
    else:
        cfg = MatcherConfig()
        tree = weights.random_matcher_tree(cfg, 0)
    jcfg = JMatcherConfig(hidden=cfg.hidden, heads=cfg.heads, alpha=cfg.alpha)
    ref = apply_matcher(_jax_tree(tree), jnp.asarray(hf), jnp.asarray(ef),
                        TopologyArrays.from_topology(jtopo), jnp.asarray(pm),
                        jcfg)
    got = _port_scores(tree, cfg, hf, ef, pm, 5, 4)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
