"""sfm_mvs_pipeline — a Structure-from-Motion + Multi-View-Stereo pipeline in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
C++ photogrammetry pipeline (brunothg/sfm-mvs-pipeline): sparse SfM (feature
detection -> matching -> incremental pose recovery -> triangulation -> bundle
adjustment) followed by dense MVS (plane-sweep/SGM depth maps, fusion,
meshing, texturing), plus the CLI, statistics and PLY-export tooling around it.

Design stance (not a port):
  * flat fixed-capacity SoA arrays + validity masks instead of the reference's
    mutable pointer-graph `Scene` (ref: src/photogrammetrie/common/Scene.h:35-510)
  * every stage a jit-able batched op that XLA compiles for the device
  * scaling via jax.sharding NamedSharding/shard_map over a device Mesh
    instead of OpenMP `parallel for` (ref: src/cli/App.cpp:42-45)
"""

import jax as _jax

# Geometry code (DLT systems, normal equations, homography warps) needs full
# f32 matmuls: on a GPU the default f32 matmul precision is TF32, whose
# ~10-bit mantissa destroys RANSAC/DLT conditioning. Code that *wants*
# reduced precision opts in explicitly (the descriptor matcher's fast mode
# casts its operands to bf16).
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

APP_NAME = "sfm-mvs-pipeline"
APP_VERSION = __version__
