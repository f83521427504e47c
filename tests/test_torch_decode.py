"""The port's device decode against ``decode_person_proposals_device``.

Persons and person masks must be equal, over random score fields that
include exact score ties, more than K above-threshold pairs, absent slots
and both merge modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpe3d_tpu.matching import features as jfeat
from mpe3d_tpu.matching.decode_device import \
    decode_person_proposals_device as j_decode
from mpe3d_tpu_torch.matching import features as tfeat
from mpe3d_tpu_torch.matching.decode_device import \
    decode_person_proposals_device as t_decode

import torch_testing  # noqa: F401

C, S = 5, 4


def _field(kind: str, seed: int):
    """(scores [E], pair_mask [E]) float32."""
    rng = np.random.default_rng(seed)
    E = C * (C - 1) // 2 * S * S
    present = rng.random((C, S)) > 0.15
    topo = tfeat.build_topology(C, S)
    pm = (present.reshape(-1)[topo.e1] & present.reshape(-1)[topo.e2])
    if kind == "sparse":        # few pairs above the threshold
        s = rng.beta(0.5, 3.0, E)
    elif kind == "ties":        # scores on a coarse grid: many exact ties
        s = np.round(rng.uniform(0.3, 1.0, E) * 8) / 8
    elif kind == "dense":       # every pair above the threshold (> K)
        s = rng.uniform(0.55, 0.95, E)
    else:                       # all live scores equal
        s = np.full(E, 0.75)
    return s.astype(np.float32), pm.astype(np.float32)


@pytest.fixture(scope="module")
def jax_decode():
    topo = jfeat.build_topology(C, S)
    fns = {}

    def get(top_k, quirk):
        key = (top_k, quirk)
        if key not in fns:
            fns[key] = jax.jit(lambda s, m: j_decode(
                s, m, topo, 2, 0.5, 8, top_k=top_k,
                reference_merge_quirk=quirk))
        return fns[key]
    return get


CASES = [(k, seed, top_k, quirk)
         for k in ("sparse", "ties", "dense", "flat")
         for seed in (0, 1)
         for top_k, quirk in ((64, True), (0, True), (64, False))]


@pytest.mark.parametrize("kind,seed,top_k,quirk", CASES)
def test_decode_matches_reference(jax_decode, kind, seed, top_k, quirk):
    s, pm = _field(kind, seed)
    jp, jm = jax_decode(top_k, quirk)(jnp.asarray(s), jnp.asarray(pm))
    tp, tm = t_decode(torch.from_numpy(s), torch.from_numpy(pm),
                      tfeat.build_topology(C, S), 2, 0.5, 8, top_k=top_k,
                      reference_merge_quirk=quirk)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    if kind in ("dense", "flat"):
        assert int(((s > 0.5) & (pm > 0.5)).sum()) > 64
