"""The port's host decode (``mpe3d_tpu_torch/matching/decode.py``) and the
device decode's ``order_scores`` against the JAX package.

Persons must be equal (values and dtype), over random score fields with
exact score ties, absent slots, both merge modes, and with and without an
order key (random, and one with its own exact ties); the one-camera bypass
must give the reference's persons for random presence.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.matching import decode as jdec
from mpe3d_tpu.matching import features as jfeat
from mpe3d_tpu.matching.decode_device import \
    decode_person_proposals_device as j_device
from mpe3d_tpu_torch.matching import decode as tdec
from mpe3d_tpu_torch.matching import features as tfeat
from mpe3d_tpu_torch.matching.decode_device import \
    decode_person_proposals_device as t_device

import torch_testing  # noqa: F401

C, S = 5, 4


def _field(kind: str, seed: int, cams: int = C, slots: int = S):
    """(scores [E], pair_mask [E]) float32 of a random frame."""
    rng = np.random.default_rng(seed)
    topo = tfeat.build_topology(cams, slots)
    E = topo.n_pairs
    present = rng.random((cams, slots)) > 0.15
    pm = present.reshape(-1)[topo.e1] & present.reshape(-1)[topo.e2]
    if kind == "sparse":
        s = rng.beta(0.5, 3.0, E)
    elif kind == "ties":        # a coarse grid: many exact ties
        s = np.round(rng.uniform(0.3, 1.0, E) * 8) / 8
    elif kind == "dense":
        s = rng.uniform(0.55, 0.95, E)
    else:                       # every live score equal
        s = np.full(E, 0.75)
    return s.astype(np.float32), pm.astype(np.float32)


def _order(mode: str, scores: np.ndarray, seed: int):
    """An order key [E] or None: random, or random on a coarse grid."""
    if mode == "none":
        return None
    rng = np.random.default_rng(seed + 100)
    key = scores - 0.3 * rng.random(scores.shape)
    if mode == "tied":
        key = np.round(key * 4) / 4
    return key.astype(np.float32)


CASES = list(itertools.product(("sparse", "ties", "dense", "flat"), (0, 1),
                               ("none", "random", "tied"), (True, False)))


@pytest.mark.parametrize("kind, seed, order, quirk", CASES)
def test_host_decode_matches_jax(kind, seed, order, quirk):
    scores, pm = _field(kind, seed)
    key = _order(order, scores, seed)
    want = jdec.decode_person_proposals(
        scores, pm, jfeat.build_topology(C, S), 2, 0.5, order_scores=key,
        reference_merge_quirk=quirk)
    got = tdec.decode_person_proposals(
        scores, pm, tfeat.build_topology(C, S), 2, 0.5, order_scores=key,
        reference_merge_quirk=quirk)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cams, slots, seed", [(3, 3, 0), (5, 10, 1),
                                               (6, 16, 2)])
def test_host_decode_matches_jax_other_buckets(cams, slots, seed):
    """Other rigs and buckets, heads past 8 (the set order's hash wraps)."""
    for kind in ("ties", "dense"):
        scores, pm = _field(kind, seed, cams, slots)
        want = jdec.decode_person_proposals(
            scores, pm, jfeat.build_topology(cams, slots), 2, 0.5)
        got = tdec.decode_person_proposals(
            scores, pm, tfeat.build_topology(cams, slots), 2, 0.5)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind, seed, order", [
    (k, s, o) for k in ("sparse", "ties", "dense") for s in (0, 1)
    for o in ("random", "tied")])
@pytest.mark.parametrize("top_k", [64, 0])
def test_device_decode_order_scores_match_jax(kind, seed, order, top_k):
    """Eligibility from the scores, walk order from the key, ties to the
    lower pair index (``lax.top_k``): persons and masks equal."""
    scores, pm = _field(kind, seed)
    key = _order(order, scores, seed)
    want = jax.jit(lambda s, m, o: j_device(
        s, m, jfeat.build_topology(C, S), 2, 0.5, 8, top_k=top_k,
        order_scores=o))(jnp.asarray(scores), jnp.asarray(pm),
                         jnp.asarray(key))
    got = t_device(torch.from_numpy(scores), torch.from_numpy(pm),
                   tfeat.build_topology(C, S), 2, 0.5, 8, top_k=top_k,
                   order_scores=torch.from_numpy(key))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_order_scores_change_the_decode():
    """The order key decides conflicts: reversing it gives another person
    set on a field where the scores alone give one (the check that the key
    is used at all), in both decoders alike."""
    changed = 0
    for seed in range(6):
        scores, pm = _field("dense", seed)
        key = (1.0 - scores).astype(np.float32)
        topo = tfeat.build_topology(C, S)
        a = tdec.decode_person_proposals(scores, pm, topo)
        b = tdec.decode_person_proposals(scores, pm, topo, order_scores=key)
        changed += int(not np.array_equal(a, b))
        np.testing.assert_array_equal(b, jdec.decode_person_proposals(
            scores, pm, jfeat.build_topology(C, S), order_scores=key))
    assert changed > 0


@pytest.mark.parametrize("seed", range(4))
def test_single_camera_bypass_matches_jax(seed):
    present = np.random.default_rng(seed).random((1, 10)) > 0.4
    want = jdec.single_camera_bypass(present)
    got = tdec.single_camera_bypass(present)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_set_order_matches_cpython_sets():
    """``_cpython_set2_order`` is the iteration order of real 2-sets."""
    for x in range(40):
        for y in range(40):
            if x != y:
                s = set()
                s.add(x)
                s.add(y)
                assert tdec._cpython_set2_order(x, y) == tuple(s)


def test_pair_order_memoised_and_equal_to_jax():
    topo = tfeat.build_topology(5, 10)
    a = tdec.reference_pair_order(topo.e1, topo.e2)
    b = tdec.reference_pair_order(topo.e1.copy(), topo.e2.copy())
    assert a[0] is b[0] and a[1] is b[1]
    ja, jb = jdec.reference_pair_order(topo.e1, topo.e2)
    np.testing.assert_array_equal(a[0], ja)
    np.testing.assert_array_equal(a[1], jb)
