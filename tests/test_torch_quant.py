"""int8 lifter serving of the port on the CPU against the JAX package:
the int8 layer (plain version), the mixed int8 / bf16 MLP, quantisation,
the int8 checkpoint reader, and ``infer_fused`` with int8 and fp32 lifters.

Tolerances:
* one int8 layer: the same bf16 operands and exact products, fp32 sums in
  another order; 1e-5 x max(1, max |out|);
* the mixed MLP: a last-bit difference can flip a later layer's bf16
  operand rounding (2^-8 relative), so the whole narrow net is held to
  1e-4 x max(1, max |out|) (observed 3e-8);
* quantisation, dequantisation and checkpoint leaves: bit for bit;
* pipelines: persons equal (int32), scores 1e-5 (fp32 GAT), poses 1e-2 m
  (bf16 rounding cascades through the lifter; millimetres here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.cli import load_models
from mpe3d_tpu.config import LifterConfig as JLifterConfig
from mpe3d_tpu.config import MatcherConfig as JMatcherConfig
from mpe3d_tpu.config import PANOPTIC as J_PANOPTIC
from mpe3d_tpu.data.frames import parse_frame as j_parse
from mpe3d_tpu.data.synthetic import synthetic_ring_rig as j_ring
from mpe3d_tpu.models import mlp as jmlp
from mpe3d_tpu.ops.fused_mlp import fused_mlp_forward, pack_fused_layers
from mpe3d_tpu.ops.quant_matmul import int8_weight_matmul, xla_int8_matmul
from mpe3d_tpu.pipeline import PoseEstimationPipeline as JPipeline
from mpe3d_tpu.train.checkpoint import load_lifter_checkpoint as j_load
from mpe3d_tpu_torch import checkpoint as tck
from mpe3d_tpu_torch import weights
from mpe3d_tpu_torch.config import PANOPTIC, LifterConfig, MatcherConfig
from mpe3d_tpu_torch.data.frames import parse_frame
from mpe3d_tpu_torch.data.synthetic import generate_frames, synthetic_ring_rig
from mpe3d_tpu_torch.models import mlp as tmlp
from mpe3d_tpu_torch.ops import quant_matmul as tq
from mpe3d_tpu_torch.ops.fused_mlp import Bf16Layer, Int8Layer
from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline

DEMO = os.path.join(os.path.dirname(__file__), "..", "models_demo")
N_FRAMES = 6


def _layer_inputs(M, K, N, seed, with_rscale):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-2, N).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32)
    rscale = (rng.uniform(0.1, 3.0, K).astype(np.float32) if with_rscale
              else None)
    return x, wq, scale, b, rscale


@pytest.mark.parametrize("with_rscale", [False, True])
@pytest.mark.parametrize("M", [3, 16, 40])
@pytest.mark.parametrize("K", [100, 260])
def test_int8_layer_against_reference(K, M, with_rscale):
    """Unaligned K, rows within and beyond one 16-row tile, with and
    without row scales: the plain version against the TPU kernel in
    interpret mode and against its XLA oracle; the CPU entry gives the same
    numbers, a K-padded weight (zero rows, row scales at the true K) the
    same sums up to their order."""
    x, wq, scale, b, rscale = _layer_inputs(M, K, 48, K + M, with_rscale)
    j = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    jargs = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
             jnp.asarray(b))
    refs = [np.asarray(xla_int8_matmul(*jargs, 0.1, j(rscale))),
            np.asarray(int8_weight_matmul(*jargs, alpha=0.1,
                                          rscale=j(rscale), interpret=True))]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    targs = (t(x), t(wq), t(scale), t(b))
    got = tq.int8_matmul_plain(*targs, 0.1, t(rscale)).numpy()
    tol = 1e-5 * max(1.0, np.abs(refs[0]).max())
    for ref in refs:
        np.testing.assert_allclose(got, ref, atol=tol)
    np.testing.assert_array_equal(
        tq.int8_weight_matmul(*targs, 0.1, t(rscale)).numpy(), got)
    kp = -(-K // 128) * 128
    wq_pad = torch.zeros((kp, 48), dtype=torch.int8)
    wq_pad[:K] = targs[1]
    np.testing.assert_allclose(
        tq.int8_matmul_plain(targs[0], wq_pad, *targs[2:], 0.1,
                             t(rscale)).numpy(), got, atol=tol)


def test_int8_entry_rejects_other_devices():
    x, wq, scale, b, _ = _layer_inputs(2, 8, 32, 0, False)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.int8_weight_matmul(torch.from_numpy(x).to("meta"),
                              torch.from_numpy(wq), torch.from_numpy(scale))


def _narrow_cfg():
    return LifterConfig(in_dim=100, out_dim=6, widths=(128, 64))


def test_mixed_mlp_against_fused_kernel_interpret():
    """A narrow fp32 lifter served int8 by both packages: the port's packed
    mixed net (2 int8 layers, a bf16 head) against the TPU whole-network
    kernel in interpret mode and against ``apply_lifter`` on the quantised
    tree (per-layer int8 path, bf16 head)."""
    cfg = _narrow_cfg()
    tree = weights.random_lifter_tree(cfg, 4)
    jq = jmlp.quantize_lifter_weights(
        jax.tree_util.tree_map(jnp.asarray, tree))
    flat, kinds, dims = pack_fused_layers(jq["layers"])
    assert kinds == ("q", "q", "w")
    x = np.random.default_rng(5).normal(size=(8, 100)).astype(np.float32)
    jcfg = JLifterConfig(in_dim=100, out_dim=6, widths=(128, 64))
    refs = [np.asarray(fused_mlp_forward(jnp.asarray(x), flat, kinds, dims,
                                         0.1, 6, interpret=True)),
            np.asarray(jmlp.apply_lifter(jq, jnp.asarray(x), jcfg,
                                         compute_dtype=jnp.bfloat16))]
    lifter = weights.lifter_from_tree(tree, cfg, "cpu", serve_dtype="int8")
    assert lifter.serve_dtype == "int8"
    assert [type(layer) for layer in lifter.packed_layers()] == [
        Int8Layer, Int8Layer, Bf16Layer]
    got = lifter(torch.from_numpy(x)).numpy()
    for ref in refs:
        np.testing.assert_allclose(got, ref,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()))


def _bf16_tree():
    tree, _, _ = tck.load_lifter_checkpoint(
        os.path.join(DEMO, "pan_irls_bf16", "pose_estimator"),
        LifterConfig())
    return {"layers": [{"w": layer["w"], "b": torch.from_numpy(layer["b"])}
                       for layer in tree["layers"]]}


def _fp32_tree():
    cfg = LifterConfig(widths=(512, 256))
    return {"layers": [{k: torch.from_numpy(v) for k, v in layer.items()}
                       for layer in weights.random_lifter_tree(
                           cfg, 7)["layers"]]}


def _np(t):
    return np.asarray(t.float() if t.dtype == torch.bfloat16 else t)


@pytest.mark.parametrize("source", ["fp32", "bf16"])
def test_quantize_bit_for_bit(source):
    """``quantize_lifter_weights`` and ``dequantize_lifter_weights`` equal
    the JAX package's bit for bit, from a random fp32 tree and from the
    trained bf16 export (the reference upcasts bf16 to fp32 first)."""
    tree = _fp32_tree() if source == "fp32" else _bf16_tree()
    jtree = {"layers": [{"w": jnp.asarray(_np(layer["w"])).astype(
        jnp.bfloat16 if layer["w"].dtype == torch.bfloat16 else jnp.float32),
        "b": jnp.asarray(_np(layer["b"]))} for layer in tree["layers"]]}
    got, ref = tmlp.quantize_lifter_weights(tree), \
        jmlp.quantize_lifter_weights(jtree)
    assert tmlp.lifter_is_quantized(got) and not tmlp.lifter_is_quantized(
        tree)
    for g, r in zip(got["layers"], ref["layers"]):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(_np(g[k]),
                                          np.asarray(r[k], np.float32))
        if "wq" in g:
            assert g["wq"].dtype == torch.int8
    deq, jdeq = (tmlp.dequantize_lifter_weights(got),
                 jmlp.dequantize_lifter_weights(ref))
    for g, r in zip(deq["layers"], jdeq["layers"]):
        np.testing.assert_array_equal(_np(g["w"]),
                                      np.asarray(r["w"], np.float32))
    cast = tmlp.cast_lifter_weights(tree, torch.bfloat16)["layers"][0]["w"]
    np.testing.assert_array_equal(
        _np(cast), np.asarray(jmlp.cast_lifter_weights(
            jtree, jnp.bfloat16)["layers"][0]["w"], np.float32))


@pytest.mark.parametrize("model,n_leaves", [("pan_irls", 34),
                                            ("pan_compact", 34)])
def test_int8_checkpoint_leaves(model, n_leaves):
    """The int8 exports: every leaf equal to the reference loader's, int8
    ``wq`` unpadded, the kept-fp head fp32."""
    stem = os.path.join(DEMO, model, "pose_estimator")
    leaves, meta = tck.read_checkpoint(stem)
    assert meta["stored"] == "int8" and len(leaves) == n_leaves
    tree, cfg, prior = tck.load_lifter_checkpoint(stem, LifterConfig())
    jparams, jcfg, jprior = j_load(stem, JLifterConfig())
    assert prior == jprior and cfg.widths == jcfg.widths
    assert cfg.residual_prior == jcfg.residual_prior
    assert len(tree["layers"]) == len(jparams["layers"])
    for lt, lj in zip(tree["layers"], jparams["layers"]):
        assert sorted(lt) == sorted(lj)
        for k in lj:
            assert lt[k].dtype == np.asarray(lj[k]).dtype
            np.testing.assert_array_equal(lt[k], np.asarray(lj[k]))
    assert tree["layers"][0]["wq"].shape == (1260, cfg.widths[0])
    assert tree["layers"][-1]["w"].dtype == np.float32


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


@pytest.fixture(scope="module")
def frames():
    return generate_frames(PANOPTIC, synthetic_ring_rig(PANOPTIC), N_FRAMES,
                           n_people=(2, 3), seed=1)


@pytest.fixture(scope="module")
def random_matcher():
    """The default matcher architecture with numpy-seeded weights (seed 0:
    its scores sit above the threshold, so persons decode)."""
    return weights.random_matcher_tree(MatcherConfig(), 0), JMatcherConfig()


@pytest.mark.parametrize("serve_dtype", ["int8", "fp32"])
def test_pipeline_narrow_lifter(frames, random_matcher, serve_dtype):
    """A narrow fp32 lifter (1260 -> 256 -> 128 -> 54) served int8 (the
    port and the reference quantise it at construction) and fp32 (the
    reference's CPU default, ``serve_dtype=None``; the eager path)."""
    mtree, mcfg = random_matcher
    cfg = LifterConfig(widths=(256, 128))
    ltree = weights.random_lifter_tree(cfg, 3)
    ref = JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC),
                    jax.tree_util.tree_map(jnp.asarray, mtree), mcfg,
                    jax.tree_util.tree_map(jnp.asarray, ltree),
                    JLifterConfig(widths=(256, 128)), slot_buckets=(4,),
                    person_buckets=(8,), use_frame_kernel=False,
                    serve_dtype=None if serve_dtype == "fp32" else "int8",
                    lifter_prior="mean")
    lifter = weights.lifter_from_tree(ltree, cfg, "cpu", serve_dtype)
    port = PoseEstimationPipeline(
        PANOPTIC, synthetic_ring_rig(PANOPTIC),
        weights.matcher_from_tree(mtree, MatcherConfig(), "cpu"),
        lifter, slot_buckets=(4,), person_buckets=(8,), device="cpu")
    assert port.serve_dtype == lifter.serve_dtype == serve_dtype
    assert _compare(port, ref, frames) >= 2 * N_FRAMES
    if serve_dtype == "fp32":
        port.use_frame_kernel = True
        with pytest.raises(ValueError, match="does not serve"):
            port.frame_path_on()


@pytest.mark.parametrize("model,frame_path", [("pan_compact", False),
                                              ("pan_compact", True),
                                              ("pan_irls", False)])
def test_pipeline_int8_export(frames, random_matcher, model, frame_path):
    """An int8-stored demo pair at full width through ``from_checkpoint``
    (serve_dtype asked as fp32: int8 exports always serve int8), on the
    eager path's or the frame path's plain versions, against the reference
    pipeline on the same export, with its trained matcher and with the
    random one."""
    d = os.path.join(DEMO, model)
    mparams, mcfg, lparams, lcfg, prior = load_models(d, J_PANOPTIC)
    port = PoseEstimationPipeline.from_checkpoint(
        d, synthetic_ring_rig(PANOPTIC), device="cpu", serve_dtype="fp32",
        slot_buckets=(4,), person_buckets=(8,), use_frame_kernel=frame_path)
    assert port.serve_dtype == "int8" and port.lifter_prior == prior
    kinds = [type(layer) for layer in port.lifter.packed_layers()]
    assert kinds == [Int8Layer] * 8 + [Bf16Layer]

    def ref(matcher):
        return JPipeline(J_PANOPTIC, j_ring(J_PANOPTIC), matcher, mcfg,
                         lparams, lcfg, slot_buckets=(4,),
                         person_buckets=(8,), use_frame_kernel=False,
                         lifter_prior=prior)

    assert ref(mparams).serve_dtype == jnp.int8
    _compare(port, ref(mparams), frames)
    mtree, _ = random_matcher
    port.matcher = weights.matcher_from_tree(mtree, port.matcher.cfg, "cpu")
    assert _compare(port, ref(jax.tree_util.tree_map(jnp.asarray, mtree)),
                    frames) >= 2 * N_FRAMES
