"""Lifter packing and the lifter MLP of the port against the JAX package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import SceneNoise
from mpe3d_tpu.data.synthetic import generate_frames as j_generate
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.lifting.pack import pack_lifter_input as j_pack
from mpe3d_tpu.models.mlp import apply_lifter
from mpe3d_tpu.ops.fused_mlp import fused_mlp_forward, pack_fused_layers
from mpe3d_tpu.train.checkpoint import load_lifter_checkpoint as j_load
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig
from mpe3d_tpu_torch.data.synthetic import synthetic_ring_rig
from mpe3d_tpu_torch.lifting.pack import pack_lifter_input
from mpe3d_tpu_torch.ops.fused_mlp import mlp_layer_plain

import torch_testing  # noqa: F401

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo")
SIZE = (1920.0, 1080.0)


@pytest.fixture(scope="module")
def persons():
    """Per-person observations [P, C, J, ...]: slot s of every camera of
    synthetic frames, with detector outliers so the prior gate fires."""
    jr = j_ring(J_PANOPTIC)
    out = []
    for f in j_generate(J_PANOPTIC, jr, 3, n_people=(3, 4), seed=5,
                        noise=SceneNoise(outlier_rate=0.1, outlier_px=80.0)):
        fa = j_parse(f, J_PANOPTIC, 4)
        for s in range(4):
            out.append((fa.kp[:, s], fa.valid[:, s], fa.prob[:, s],
                        fa.in_view[:, s]))
    stacked = [np.stack(x) for x in zip(*out)]
    return jr, stacked


def _jax_nets(jr, obs, prior, gate):
    fn = jax.vmap(lambda k, v, p, o: j_pack(
        k, v, p, o, jr, SIZE, prior=prior, prior_gate_px=gate)[0])
    return np.asarray(fn(*(jnp.asarray(x) for x in obs)))


@pytest.mark.parametrize("prior", ["mean", "median", "irls"])
@pytest.mark.parametrize("gate", [None, 8.0])
def test_pack_lifter_input(persons, prior, gate):
    """1260 floats per person within 1e-4 (fp32 geometry; fields hold
    decameters and normalized pixels of magnitude <= ~1)."""
    jr, obs = persons
    ref = _jax_nets(jr, obs, prior, gate)
    rig = synthetic_ring_rig(PANOPTIC).to("cpu")
    got, include = pack_lifter_input(*(torch.from_numpy(x) for x in obs),
                                     rig, SIZE, prior=prior,
                                     prior_gate_px=gate)
    assert got.shape == ref.shape == (len(obs[0]), 1260)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    np.testing.assert_array_equal(include.numpy(), obs[3])
    if gate is not None:   # the gate drops some joints' priors here
        ungated = _jax_nets(jr, obs, prior, None)
        flag = lambda n: n.reshape(-1, 5, 18, 14)[:, 0, :, 10]  # noqa: E731
        assert flag(ref).sum() < flag(ungated).sum()


def test_mlp_against_fused_kernel_interpret():
    """Narrow bf16 MLP against the TPU kernel in interpret mode.  Same
    bf16-rounded operands and fp32 sums; at these widths the sums are short
    and 1e-5 holds."""
    cfg = LifterConfig(in_dim=40, out_dim=6, widths=(48, 32))
    tree = weights.random_lifter_tree(cfg, 2)
    jlayers = [{"w": jnp.asarray(l["w"]).astype(jnp.bfloat16),
                "b": jnp.asarray(l["b"])} for l in tree["layers"]]
    flat, kinds, dims = pack_fused_layers(jlayers)
    x = np.random.default_rng(3).normal(size=(8, 40)).astype(np.float32)
    ref = fused_mlp_forward(jnp.asarray(x), flat, kinds, dims, 0.1, 6,
                            interpret=True)
    got = weights.lifter_from_tree(tree, cfg, "cpu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def full_lifter(persons):
    stem = os.path.join(DEMO, "pan_irls_bf16", "pose_estimator")
    jparams, jcfg, prior = j_load(stem, JLifterConfig())
    jr, obs = persons
    nets = _jax_nets(jr, obs, prior, None)[:8]
    cfg = LifterConfig(residual_prior=jcfg.residual_prior)
    return jparams, jcfg, weights.lifter_from_tree(jparams, cfg, "cpu"), nets


def test_full_lifter_layers_same_inputs(full_lifter):
    """Each full-width layer on the reference's own input: only the order of
    fp32 sums of exact bf16 products differs, 1e-5 of the layer's scale."""
    jparams, _, lifter, nets = full_lifter
    h = nets
    for i, (jl, (w, b)) in enumerate(zip(jparams["layers"],
                                         lifter.packed_layers())):
        ref = np.asarray(jnp.dot(jnp.asarray(h).astype(jnp.bfloat16), jl["w"],
                                 preferred_element_type=jnp.float32) + jl["b"])
        got = mlp_layer_plain(torch.tensor(h), w, b, 0.1, False).numpy()
        np.testing.assert_allclose(got[:, :ref.shape[1]], ref,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
        h = np.asarray(jax.nn.leaky_relu(ref, 0.1)) if i < 8 else ref


def test_full_lifter_against_apply_lifter(full_lifter):
    """The whole 29.1 M-param lifter on packed inputs, bf16 operands: a
    last-bit fp32 difference can flip a later operand's bf16 rounding (2^-8
    relative) and the flips cascade through 9 layers.  Observed on these
    inputs: 7.9e-5 decameters; held to 1e-3 (1 cm)."""
    jparams, jcfg, lifter, nets = full_lifter
    ref = np.asarray(apply_lifter(jparams, jnp.asarray(nets), jcfg,
                                  compute_dtype=jnp.bfloat16))
    got = lifter(torch.from_numpy(nets)).numpy()
    assert got.shape == (8, 54)
    np.testing.assert_allclose(got, ref, atol=1e-3)
