"""Pair-sharded descriptor matching over a device mesh.

The data-parallel axis of the SfM frontend: the candidate pair list is
sharded across devices with shard_map; descriptors are replicated (they are
small next to the O(F^2) distance work). Each device runs the same batched
2-NN + ratio matcher on its pair shard — no cross-device communication
needed until results are gathered.

This is the equivalent of the reference's OMP-parallel pair loop
(ref: src/photogrammetrie/sfm/UnorderedFeatureMatchingStrategy.cpp:40).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sfm_mvs_pipeline.ops.matching import match_pairs_batch
from sfm_mvs_pipeline.parallel.mesh import DATA_AXIS, pad_to_multiple


@functools.lru_cache(maxsize=32)
def _sharded_matcher(mesh, ratio, distinct, chunk, method, with_distance,
                     exact):
    """Build (once per parameter set) the jitted sharded matcher, so that
    repeat calls pay only dispatch, not a retrace."""
    out_specs = tuple([P(DATA_AXIS)] * (3 if with_distance else 2))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(DATA_AXIS)),
        out_specs=out_specs,
    )
    def go(descs, val, prs):
        return match_pairs_batch(
            descs, val, prs, ratio=ratio, distinct=distinct, chunk=chunk,
            method=method, with_distance=with_distance, exact=exact,
        )

    return jax.jit(go)


def match_pairs_sharded(
    mesh,
    descriptors: np.ndarray,  # (S, F, D)
    valid: np.ndarray,  # (S, F)
    pairs: np.ndarray,  # (P, 2)
    ratio: float = 0.7,
    distinct: bool = False,
    chunk: int = 8,
    method: str = "bf",
    with_distance: bool = False,
    exact: bool = False,
) -> tuple[np.ndarray, ...]:
    """Match pairs across the mesh. Returns (best_idx (P, F), mask (P, F))
    (+ best distance (P, F) when with_distance)."""
    n_dev = mesh.devices.size
    P_orig = len(pairs)
    pairs_p = pad_to_multiple(np.asarray(pairs, np.int32), n_dev)

    go = _sharded_matcher(
        mesh, ratio, distinct, chunk, method, with_distance, exact
    )
    out = go(
        jnp.asarray(descriptors), jnp.asarray(valid), jnp.asarray(pairs_p)
    )
    return tuple(np.asarray(o)[:P_orig] for o in out)
