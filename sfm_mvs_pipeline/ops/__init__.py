"""Jittable compute ops: geometry, features, matching, robust estimation.

All functions here are pure, shape-static, and safe to `jax.jit` / `vmap` /
`shard_map`. XLA compiles every one of them for the device; no stage needs
a hand-written kernel (PERF.md, "Kernel decisions").
"""
