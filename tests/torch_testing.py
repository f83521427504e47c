"""What the port's tests share: one torch thread count for every test
process, and the JAX references that several tests build with the same
arguments, built once a process.

Every ``tests/test_torch_*.py`` imports this module, so whichever of them a
pytest-xdist worker imports first sets the count.  Its import calls
``torch.set_num_threads(THREADS)``: a constant, not the machine's core
count, so the port's CPU numbers are the same on every machine, and six
workers do not each start one torch thread a core.  A subprocess that a
test starts gets the same count through ``subprocess_env()``.

The JAX references still run live, in the test's own process: a cache
holds what one test built for the next one that asks for the same thing,
and hands out nothing a test could change under another (fresh trees
around immutable arrays, read-only outputs, pipelines that hold no state
between calls).  JAX is imported when one of the functions below is
first called: the ranks of ``tests/test_torch_parallel.py`` import this
module and no JAX.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

MODELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                      "models_demo")

# torch's own intra-op thread count (one a core unless OMP_NUM_THREADS sets
# it), under which ``default_threads`` runs a test
DEFAULT_THREADS = torch.get_num_threads()
THREADS = 2
torch.set_num_threads(THREADS)


def subprocess_env(**extra):
    """This process's environment with ``OMP_NUM_THREADS=THREADS`` (and
    ``extra``), for a subprocess that imports torch."""
    return dict(os.environ, OMP_NUM_THREADS=str(THREADS), **extra)


@pytest.fixture
def default_threads():
    """Run a test under torch's own thread count, then set THREADS back.

    For the tests whose plain fp32 GAT scores sit within one element's
    rounding of their limit: the sums' split over threads moves the scores
    by 1-2e-5 (ROADMAP.md section 3)."""
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(THREADS)


@functools.lru_cache(maxsize=None)
def _load_models(model):
    from mpe3d_tpu.cli import load_models
    from mpe3d_tpu.config import PANOPTIC
    return load_models(os.path.join(MODELS, model), PANOPTIC)


def jax_models(model):
    """``mpe3d_tpu.cli.load_models`` of the Panoptic pair
    ``models_demo/<model>``: ``(matcher params, matcher config, lifter
    params, lifter config, prior)``, read once a process."""
    import jax

    mparams, mcfg, lparams, lcfg, prior = _load_models(model)
    fresh = functools.partial(jax.tree_util.tree_map, lambda a: a)
    return fresh(mparams), mcfg, fresh(lparams), lcfg, prior


@functools.lru_cache(maxsize=None)
def jax_pipeline(model, random_matcher=None, **options):
    """The JAX ``PoseEstimationPipeline`` on the Panoptic pair
    ``models_demo/<model>`` and the synthetic ring rig, one a process for
    the same arguments.

    ``random_matcher``: ``None`` for the pair's trained matcher, else
    ``(cfg, seed)``: the weights of the port's
    ``weights.random_matcher_tree(cfg, seed)`` in the trained matcher's
    place.  ``options`` go to the pipeline.  A test that mutates the
    pipeline builds its own."""
    import jax
    import jax.numpy as jnp

    from mpe3d_tpu.config import PANOPTIC
    from mpe3d_tpu.data.synthetic import synthetic_ring_rig
    from mpe3d_tpu.pipeline import PoseEstimationPipeline
    from mpe3d_tpu_torch import weights

    mparams, mcfg, lparams, lcfg, _ = jax_models(model)
    if random_matcher is not None:
        mparams = jax.tree_util.tree_map(
            jnp.asarray, weights.random_matcher_tree(*random_matcher))
    return PoseEstimationPipeline(PANOPTIC, synthetic_ring_rig(PANOPTIC),
                                  mparams, mcfg, lparams, lcfg, **options)


# (pipeline, the frames' JSON) -> the pipeline's outputs on the frames
_OUTPUTS = {}


def jax_infer_fused(pipe, frames):
    """``pipe.infer_fused`` of each wire frame, once a process for a
    pipeline from ``jax_pipeline`` and the same frames; the outputs'
    arrays are read-only."""
    from mpe3d_tpu.data.frames import parse_frame

    key = (pipe, json.dumps(frames))
    if key not in _OUTPUTS:
        outs = tuple(pipe.infer_fused(parse_frame(f, pipe.rig_config))
                     for f in frames)
        for a in (a for out in outs for a in out):
            if isinstance(a, np.ndarray):
                a.flags.writeable = False
        _OUTPUTS[key] = outs
    return _OUTPUTS[key]

