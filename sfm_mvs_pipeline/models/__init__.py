"""Data models: camera intrinsics models and the SoA scene state."""

from sfm_mvs_pipeline.models.cameras import (  # noqa: F401
    CAMERA_MODELS,
    CameraModel,
    distort_normalized,
    make_intrinsics,
    intrinsics_to_K,
    project_points,
    undistort_points,
)
