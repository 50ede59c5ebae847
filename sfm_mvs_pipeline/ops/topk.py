"""Top-k for feature selection.

`k` may exceed the axis size (an "unlimited" feature budget on a small
image or octave); the result is then every candidate, padded to k.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def select_top_k(scores: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """(values, indices) of the top-k scores along the last axis,
    descending, exact (`lax.top_k`).

    When k exceeds the axis size the result is every candidate, padded to
    k with -inf values / index 0 so downstream `vals > 0` validity masks
    drop the padding."""
    n = scores.shape[-1]
    if k >= n:
        vals, idx = jax.lax.top_k(scores, n)
        pad = [(0, 0)] * (scores.ndim - 1) + [(0, k - n)]
        return (
            jnp.pad(vals, pad, constant_values=-jnp.inf),
            jnp.pad(idx, pad, constant_values=0),
        )
    return jax.lax.top_k(scores, k)
