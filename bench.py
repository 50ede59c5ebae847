"""Matcher throughput on one GPU.

Times `match_pairs_batch`, the production matcher (every candidate pair in
one call: 2-NN plus the Lowe ratio test), at two feature capacities for
SIFT (L2, D=128, integer descriptors) and ORB (Hamming as a product of +-1
vectors, D=256). Each number is the median of 5 warm runs, each ended by
block_until_ready; compilation is reported separately as set-up. Prints
one JSON line that names the device it ran on. Refuses to run anywhere but
on a GPU.

    python3 bench.py
"""

from __future__ import annotations

import json
import statistics
import sys
import time

N_SHOTS, N_PAIRS, REPS = 8, 16, 5
SIZES = (2048, 10000)


def _descriptors(kind: str, f: int, seed: int):
    import jax
    import jax.numpy as jnp

    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    if kind == "sift":
        base = jax.random.randint(k1, (f, 128), 0, 256)
        noise = jax.random.randint(k2, (N_SHOTS, f, 128), -8, 9)
        d = jnp.clip(base[None] + noise, 0, 255).astype(jnp.float32)
    else:
        base = jax.random.bernoulli(k1, 0.5, (f, 256))
        flip = jax.random.bernoulli(k2, 0.1, (N_SHOTS, f, 256))
        d = jnp.where(base[None] ^ flip, 1.0, -1.0).astype(jnp.bfloat16)
    return d, jax.random.uniform(k3, (N_SHOTS, f)) > 0.05


def main() -> int:
    import jax
    import jax.numpy as jnp

    from sfm_mvs_pipeline.ops.matching import match_pairs_batch
    from sfm_mvs_pipeline.ops.pairs import unordered_pairs
    from sfm_mvs_pipeline.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (first device: {dev.platform})",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    pairs = jnp.asarray(unordered_pairs(N_SHOTS)[:N_PAIRS], jnp.int32)
    cells = {}
    for f in SIZES:
        for kind in ("sift", "orb"):
            descs, valid = _descriptors(kind, f, seed=f)
            t0 = time.perf_counter()
            jax.block_until_ready(match_pairs_batch(descs, valid, pairs))
            setup = time.perf_counter() - t0
            times = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                jax.block_until_ready(match_pairs_batch(descs, valid, pairs))
                times.append(time.perf_counter() - t0)
            med = statistics.median(times)
            cells[f"{kind}_F{f}"] = {
                "pairs_per_s": N_PAIRS / med,
                "median_s": med,
                "spread_s": max(times) - min(times),
                "compile_and_first_run_s": setup,
            }
    print(json.dumps({
        "metric": "matched_pairs_per_s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "pairs_per_call": N_PAIRS,
        "cells": cells,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
