"""Semi-global matching: 4-path cost-volume aggregation.

The --sgm path of the reference delegates to openMVS's SGM implementation
(ref: src/photogrammetrie/mvs/MVS.cpp:113-116, DenseReconstruction(-1)
disparity + (-2) fusion). Here SGM aggregates the SAME plane-sweep cost
volume (mvs/plane_sweep.py), so "SGM" and "plane-sweep" are two
regularizations of one pipeline — matching how the reference switches
densification mode by flag.

Formulation: per path direction r,
  L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                             L_r(p-r, d+-1) + P1,
                             min_d' L_r(p-r, d') + P2 ) - min_d' L_r(p-r, d')
aggregated over 4 directions (left/right/up/down). Each direction is a
lax.scan along its axis with a fully vectorized (lanes x depth) inner
update: the sequential dependence is only along the scan axis, every step
is one data-parallel update of a whole image row or column.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _scan_dir(cost: jax.Array, p1: float, p2: float) -> jax.Array:
    """Aggregate along axis 0 of cost (S, L, D): S = scan steps, L = lanes."""

    def step(prev, c):
        # prev, c: (L, D)
        m = jnp.min(prev, axis=-1, keepdims=True)  # (L, 1)
        up = jnp.concatenate([prev[:, :1] + p1, prev[:, :-1] + p1], axis=1)
        dn = jnp.concatenate([prev[:, 1:] + p1, prev[:, -1:] + p1], axis=1)
        best = jnp.minimum(jnp.minimum(prev, up), jnp.minimum(dn, m + p2))
        # best-m first: it is bounded by p2, avoiding cancellation
        # against c
        out = c + (best - m)
        return out, out

    init = cost[0]
    _, rest = jax.lax.scan(step, init, cost[1:])
    return jnp.concatenate([init[None], rest], axis=0)


@functools.partial(jax.jit, static_argnames=())
def sgm_aggregate(
    cost_volume: jax.Array,  # (D, H, W)
    p1: float | jax.Array = 0.03,
    p2: float | jax.Array = 0.3,
) -> jax.Array:
    """4-path SGM aggregation. Returns the aggregated volume (D, H, W),
    normalized by the number of paths so downstream thresholds keep scale."""
    v = jnp.moveaxis(cost_volume, 0, -1)  # (H, W, D)
    lr = _scan_dir(jnp.swapaxes(v, 0, 1), p1, p2)  # scan over W: (W, H, D)
    lr = jnp.swapaxes(lr, 0, 1)
    rl = _scan_dir(jnp.swapaxes(v, 0, 1)[::-1], p1, p2)[::-1]
    rl = jnp.swapaxes(rl, 0, 1)
    tb = _scan_dir(v, p1, p2)  # scan over H
    bt = _scan_dir(v[::-1], p1, p2)[::-1]

    agg = (lr + rl + tb + bt) / 4.0
    return jnp.moveaxis(agg, -1, 0)
