"""Test configuration: run everything on a simulated 8-device CPU mesh.

Must set the XLA flags BEFORE jax is imported anywhere. The platform is the
CPU unless JAX_PLATFORMS names another: `JAX_PLATFORMS=cuda python -m pytest
-m gpu tests/` runs the tests marked `gpu` on the card.
"""

import os

# jax.config.update is the reliable override even where jax was imported
# before this file; XLA_FLAGS is read lazily at backend init, so setting it
# here works.
PLATFORM = os.environ.get("JAX_PLATFORMS") or "cpu"
os.environ["JAX_PLATFORMS"] = PLATFORM
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", PLATFORM)
# CPU tests may use f64 oracles; device code paths stay f32.
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of which other tests ran before it
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def synthetic_scene():
    """A synthetic multi-view scene with known ground truth.

    Cameras on an arc looking at a 3D point cloud; substitutes for the
    reference's missing unit tests (SURVEY.md §4) and feeds the ATE checks.
    """
    rng = np.random.default_rng(7)
    n_cams, n_pts = 6, 400
    width, height = 640, 480
    f = 520.0
    intr = np.array([f, width / 2, height / 2, 0, 0, 0, 0], dtype=np.float64)

    pts = rng.uniform(-2, 2, size=(n_pts, 3))
    pts[:, 2] += 8.0  # in front of the rig

    poses = []
    for i in range(n_cams):
        ang = (i - n_cams / 2) * 0.12
        R = np.array(
            [
                [np.cos(ang), 0, np.sin(ang)],
                [0, 1, 0],
                [-np.sin(ang), 0, np.cos(ang)],
            ]
        )
        C = np.array([2.5 * np.sin(ang), 0.1 * i, 8.0 - 8.0 * np.cos(ang)])
        t = -R @ C
        poses.append((R, t))

    obs = []  # per camera: (N, 2) pixel observations
    for R, t in poses:
        pc = pts @ R.T + t
        uv = pc[:, :2] / pc[:, 2:3] * f + np.array([width / 2, height / 2])
        obs.append(uv)

    return {
        "intr": intr,
        "points": pts,
        "poses": poses,
        "obs": obs,
        "size": (width, height),
    }
