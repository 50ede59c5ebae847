"""Scene checkpoint / resume.

The reference's only durable intermediate is the openMVS handoff file
(omvs/mvs.bin + undistorted images; ref: src/photogrammetrie/util/
OpenMvsUtils.cpp:31-153) which lets the dense stage re-run independently —
and SURVEY.md §5 calls for this build to add REAL checkpointing of the
scene state. This module serializes the full SoA scene (poses, intrinsics,
points, observations, track index, feature arrays) to one .npz + JSON
sidecar, enabling:
  * re-running dense MVS without re-running SfM (reference mvs.bin parity)
  * resuming/inspecting any stage
"""

from __future__ import annotations

import json
import os

import numpy as np

from sfm_mvs_pipeline.models.scene import Scene

_ARRAY_FIELDS = [
    "keypoints", "descriptors", "feat_valid", "intrinsics", "cam_of_shot",
    "poses", "recovered", "points", "point_valid", "colors",
    "obs_point", "obs_shot", "obs_feat", "obs_uv", "obs_w", "point_of_feat",
]


def save_scene(scene: Scene, path: str) -> None:
    """Write scene state to `path` (.npz) + `<path>.json` metadata."""
    np.savez_compressed(
        path, **{f: getattr(scene, f) for f in _ARRAY_FIELDS}
    )
    meta = {
        "image_paths": list(scene.image_paths),
        "image_size": list(scene.image_size),
        "camera_model": scene.camera_model,
        "version": 1,
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_scene(path: str) -> Scene:
    data = np.load(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    kwargs = {f: data[f] for f in _ARRAY_FIELDS}
    return Scene(
        image_paths=meta["image_paths"],
        image_size=tuple(meta["image_size"]),
        camera_model=meta["camera_model"],
        **kwargs,
    )
