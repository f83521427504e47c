"""The port's numpy checkpoint reader against the JAX package's loader."""

import os

import jax
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.models.gat import init_matcher
from mpe3d_tpu.models.mlp import init_lifter
from mpe3d_tpu.train.checkpoint import (load_checkpoint,
                                        load_lifter_checkpoint,
                                        matcher_config_from_meta, read_meta)
from mpe3d_tpu_torch import checkpoint as tck
from mpe3d_tpu_torch.config import LifterConfig, MatcherConfig

import torch_testing  # noqa: F401

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo")


@pytest.mark.parametrize("model", ["pan_irls_bf16", "widefield"])
def test_matcher_leaves_equal(model):
    stem = os.path.join(DEMO, model, "skeleton_matching")
    jcfg = matcher_config_from_meta(read_meta(stem), JMatcherConfig())
    jparams, _, _ = load_checkpoint(stem,
                                    init_matcher(jax.random.PRNGKey(0), jcfg))
    tree, cfg = tck.load_matcher_checkpoint(stem, MatcherConfig())
    assert (cfg.hidden, cfg.heads, cfg.alpha) == (jcfg.hidden, jcfg.heads,
                                                  jcfg.alpha)
    assert len(tree["layers"]) == len(jparams["layers"])
    for lt, lj in zip(tree["layers"], jparams["layers"]):
        assert sorted(lt) == sorted(lj)
        for k in lj:
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))


def test_lifter_raw_leaves_equal():
    """Leaf for leaf, in flatten order, as stored (bf16 bits as uint16)."""
    stem = os.path.join(DEMO, "pan_irls_bf16", "pose_estimator")
    leaves, meta = tck.read_checkpoint(stem)
    assert meta["stored"] == "bf16" and meta["prior"] == "irls"
    jparams, _, jmeta = load_checkpoint(
        stem, init_lifter(jax.random.PRNGKey(1), JLifterConfig()))
    jleaves = jax.tree_util.tree_leaves(jparams)
    assert len(leaves) == len(jleaves) == 18
    for a, b in zip(leaves, jleaves):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert meta == read_meta(stem)


def test_lifter_bf16_view_matches_reference():
    """bf16 weights are the stored bit patterns, viewed, not cast."""
    stem = os.path.join(DEMO, "pan_irls_bf16", "pose_estimator")
    tree, cfg, prior = tck.load_lifter_checkpoint(stem, LifterConfig())
    jparams, jcfg, jprior = load_lifter_checkpoint(stem, JLifterConfig())
    assert prior == jprior == "irls"
    assert cfg.residual_prior and jcfg.residual_prior
    assert cfg.widths == jcfg.widths
    for lt, lj in zip(tree["layers"], jparams["layers"]):
        assert lt["w"].dtype == torch.bfloat16
        bits = lt["w"].view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(bits, np.asarray(lj["w"]).view(np.uint16))
        np.testing.assert_array_equal(
            lt["w"].float().numpy(), np.asarray(lj["w"], np.float32))
        np.testing.assert_array_equal(lt["b"], np.asarray(lj["b"]))
