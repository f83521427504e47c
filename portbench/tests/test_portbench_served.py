"""A stored lifter: the references' reader against the program's, the
checkpoint entry of ``program.py`` against the program's own
``from_checkpoint``, and the check of a configuration's lifter against
the meta."""

import json

import numpy as np
import pytest
import torch

from portbench import checkpoints, frames as F, program, weights
from portbench.cell import load
from portbench.loops import batch

IRLS, IRLS_BF16 = ("models_demo/pan_irls/pose_estimator",
                   "models_demo/pan_irls_bf16/pose_estimator")


def _bits(t) -> np.ndarray:
    """The bits of an fp32 / bf16 / int8 array or tensor."""
    if torch.is_tensor(t):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        t = t.numpy()
    return t.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[t.itemsize])


@pytest.mark.parametrize("stem", [IRLS, IRLS_BF16])
def test_reader_reads_what_the_program_reads(stem):
    from mpe3d_tpu_torch.checkpoint import (load_lifter_checkpoint,
                                            read_checkpoint)
    from mpe3d_tpu_torch.config import LifterConfig
    layers, meta = checkpoints.lifter(stem)
    tree, lcfg, prior = load_lifter_checkpoint(checkpoints.path(stem),
                                               LifterConfig())
    assert meta == {"in_dim": lcfg.in_dim, "out_dim": lcfg.out_dim,
                    "widths": list(lcfg.widths),
                    "negative_slope": lcfg.negative_slope,
                    "residual_prior": lcfg.residual_prior, "prior": prior,
                    "stored": read_checkpoint(checkpoints.path(stem))[1][
                        "stored"]}
    assert len(layers) == len(tree["layers"]) == 9
    for got, want in zip(layers, tree["layers"]):
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "w" and not torch.is_tensor(v):     # an int8 head: fp32
                v = torch.from_numpy(v).to(torch.bfloat16)
            assert got[k].dtype == (torch.bfloat16 if k == "w" else
                                    torch.int8 if k == "wq" else
                                    torch.float32)
            assert np.array_equal(_bits(got[k]), _bits(v)), k
    if meta["stored"] == "int8":
        assert [sorted(x) for x in layers] == (
            [["b", "rscale", "scale", "wq"]] * 8 + [["b", "w"]])


def _served(stem):
    cell = load("panoptic.batch_s4")
    cfg = json.loads(json.dumps(cell.config))
    tr = dict(cell.traffic)
    batch.tiny(cfg, tr)
    cfg["lifter"].update(checkpoints.meta(stem), checkpoint=stem)
    return cfg, tr


def _run(pipe, fl, n=2):
    out = []
    for i in range(0, len(fl), n):
        out += pipe.collect_batch(pipe.submit_batch(fl[i:i + n], slots=4))
    return out


def test_served_pipeline_is_from_checkpoint():
    """With the stem's own matcher, the entry is ``from_checkpoint`` at
    the configuration's serving settings: the same scores, persons and
    poses."""
    from mpe3d_tpu_torch.config import get_rig
    from mpe3d_tpu_torch.pipeline import PoseEstimationPipeline
    cfg, tr = _served(IRLS_BF16)
    rig = F.ring_rig(cfg)
    fl = program.frame_list(F.generate(cfg, rig, 6, tuple(tr["people"]), 4,
                                       11, tr["spread_m"]))
    got = _run(program.served_pipeline(cfg, tr, rig, "cpu"), fl)
    want = _run(PoseEstimationPipeline.from_checkpoint(
        checkpoints.path("models_demo/pan_irls_bf16"),
        program._camera_rig(rig), get_rig("PANOPTIC"), device="cpu",
        slot_buckets=(4,), person_buckets=tuple(tr["person_buckets"]),
        threshold=0.5, decode_top_k=64, use_frame_kernel=True), fl)
    assert sum(len(o.persons) for o in want) > 0
    for g, w in zip(got, want):
        for k in ("scores", "persons", "poses"):
            assert np.array_equal(getattr(g, k), getattr(w, k)), k


def test_served_pipeline_on_a_seeded_matcher():
    """The int8, residual, IRLS-prior lifter behind the seeded matcher:
    served as its meta says, every frame decoded and lifted to finite
    poses."""
    cfg, tr = _served(IRLS)
    rig = F.ring_rig(cfg)
    fl = program.frame_list(F.generate(cfg, rig, 4, tuple(tr["people"]), 4,
                                       12, tr["spread_m"]))
    pipe = program.served_pipeline(
        cfg, tr, rig, "cpu", weights.matcher_layers(cfg["matcher"], 5, "cpu"))
    assert (pipe.serve_dtype, pipe.lifter_prior) == ("int8", "irls")
    assert pipe.lifter.cfg.residual_prior
    out = _run(pipe, fl)
    assert all(len(o.persons) > 0 and np.isfinite(o.poses).all()
               for o in out)


@pytest.mark.parametrize("key,value", [
    ("widths", [3072] * 8), ("prior", "mean"), ("residual_prior", False),
    ("stored", "bf16"), ("stored", None), ("negative_slope", 0.2),
    ("out_dim", 57), ("in_dim", 1512)])
def test_a_lifter_unlike_its_meta_is_refused(key, value):
    """A stated size that differs from the meta, or none stated (None)."""
    cfg, _ = _served(IRLS)
    program.check_lifter(cfg)
    cfg["lifter"][key] = value
    with pytest.raises(SystemExit, match=key):
        program.check_lifter(cfg)

