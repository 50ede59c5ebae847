"""Camera intrinsics models — one array layout for the reference's 3 models.

The reference implements three virtual-dispatch camera classes with separate
Ceres functors and parameter blocks:
  * SimpleCamera        params [f]                 (ref: src/photogrammetrie/common/SimpleCamera.cpp:63-104)
  * SimpleRadialCamera  params [f, k1, k2]         (ref: src/photogrammetrie/common/SimpleRadialCamera.cpp:69-116) — default
  * DistortionCamera    params [f, cx, cy, k1, k2, p1, p2] (ref: src/photogrammetrie/common/DistortionCamera.cpp:62-112)

Design: a single flat intrinsics vector of fixed size 7,
    [f, cx, cy, k1, k2, p1, p2]
with fx == fy == f (the reference never splits them). All three models share
one jittable projection function; the *model* only determines which entries
bundle adjustment is allowed to update (an optimization mask). This removes
virtual dispatch from the hot path and makes intrinsics a plain shardable
array `intrinsics[C, 7]`.

Projection (matches the reference functors exactly):
    x_cam = R X + t                          (world -> camera)
    x, y  = x_cam.xy / x_cam.z               (perspective)
    r^2   = x^2 + y^2
    radial = 1 + k1 r^2 + k2 r^4
    x_d = x * radial + 2 p1 x y + p2 (r^2 + 2 x^2)
    y_d = y * radial + p1 (r^2 + 2 y^2) + 2 p2 x y
    u = f * x_d + cx ;  v = f * y_d + cy
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from sfm_mvs_pipeline.ops.pose import aa_to_rotmat

# Intrinsics vector layout
F, CX, CY, K1, K2, P1, P2 = range(7)
N_INTR = 7


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """A named intrinsics model = an optimization mask over the 7-vector."""

    name: str
    opt_mask: tuple[int, ...]  # indices of intrinsics entries BA may update

    @property
    def mask_array(self) -> jax.Array:
        m = jnp.zeros((N_INTR,), dtype=jnp.float32)
        return m.at[jnp.array(self.opt_mask)].set(1.0)


# (ref model selection: src/cli/PhotogrammetrieCli.cpp:288-299; default = simple-radial)
CAMERA_MODELS: dict[str, CameraModel] = {
    "fixed": CameraModel("fixed", ()),  # calibrated: BA never touches intrinsics
    "simple": CameraModel("simple", (F,)),
    "simple-radial": CameraModel("simple-radial", (F, K1, K2)),
    "distortion": CameraModel("distortion", (F, CX, CY, K1, K2, P1, P2)),
}
DEFAULT_CAMERA_MODEL = "simple-radial"


def make_intrinsics(
    width: int, height: int, focal_factor: float = 1.2, dtype=jnp.float32
) -> jax.Array:
    """Initial intrinsics like the reference CLI: f = focal_factor * maxDim,
    center = resolution / 2, zero distortion.
    (ref: src/cli/PhotogrammetrieCli.cpp:312-314)
    """
    f = focal_factor * max(width, height)
    return jnp.array([f, width / 2.0, height / 2.0, 0, 0, 0, 0], dtype=dtype)


def intrinsics_to_K(intr: jax.Array) -> jax.Array:
    """Intrinsics 7-vector -> 3x3 K matrix. Batched over leading axes."""
    f, cx, cy = intr[..., F], intr[..., CX], intr[..., CY]
    zero = jnp.zeros_like(f)
    one = jnp.ones_like(f)
    K = jnp.stack(
        [
            jnp.stack([f, zero, cx], axis=-1),
            jnp.stack([zero, f, cy], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return K


def distort_normalized(intr: jax.Array, xy: jax.Array) -> jax.Array:
    """Apply radial+tangential distortion to normalized coords.

    intr: (..., 7), xy: (..., N, 2) or (..., 2). Returns distorted normalized
    coords (same shape as xy).
    """
    x, y = xy[..., 0], xy[..., 1]
    if xy.ndim > intr.ndim:  # per-point broadcast of intrinsics
        intr = intr[..., None, :]
    k1, k2 = intr[..., K1], intr[..., K2]
    p1, p2 = intr[..., P1], intr[..., P2]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + k2 * r2)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def normalized_to_pixels(intr: jax.Array, xy: jax.Array) -> jax.Array:
    """Distorted normalized coords -> pixel coords."""
    if xy.ndim > intr.ndim:
        intr = intr[..., None, :]
    f = intr[..., F]
    c = jnp.stack([intr[..., CX], intr[..., CY]], axis=-1)
    return xy * f[..., None] + c


def pixels_to_normalized(intr: jax.Array, uv: jax.Array) -> jax.Array:
    """Pixel coords -> distorted normalized coords (no undistortion)."""
    if uv.ndim > intr.ndim:
        intr = intr[..., None, :]
    f = intr[..., F]
    c = jnp.stack([intr[..., CX], intr[..., CY]], axis=-1)
    return (uv - c) / f[..., None]


def undistort_points(intr: jax.Array, uv: jax.Array, num_iters: int = 8) -> jax.Array:
    """Pixel coords -> UNDISTORTED normalized coords.

    Fixed-point inversion of the distortion model (the same scheme
    cv::undistortPoints uses; ref call site: src/photogrammetrie/sfm/SfM.cpp:410-412).
    num_iters is static so the loop unrolls under jit.
    """
    xy_dist = pixels_to_normalized(intr, uv)
    intr_b = intr[..., None, :] if uv.ndim > intr.ndim else intr

    def body(_, xy):
        # xy is current undistorted estimate; invert:
        # xd = x*radial + tang  =>  x = (xd - tang(x)) / radial(x)
        x, y = xy[..., 0], xy[..., 1]
        k1, k2 = intr_b[..., K1], intr_b[..., K2]
        p1, p2 = intr_b[..., P1], intr_b[..., P2]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + k2 * r2)
        tx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        ty = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = (xy_dist[..., 0] - tx) / radial
        yn = (xy_dist[..., 1] - ty) / radial
        return jnp.stack([xn, yn], axis=-1)

    return jax.lax.fori_loop(0, num_iters, body, xy_dist)


def project_points(
    pose: jax.Array, intr: jax.Array, pts3d: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Project world points into a camera.

    pose: (..., 6) angle-axis+t, intr: (..., 7), pts3d: (..., N, 3).
    Returns (uv (..., N, 2), depth (..., N)). Mirrors the reference's
    cv::projectPoints usage for the reprojection filter
    (ref: src/photogrammetrie/sfm/SfM.cpp:423-427) and the Ceres functors.
    """
    R = aa_to_rotmat(pose[..., :3])
    t = pose[..., 3:]
    x_cam = jnp.einsum("...ij,...nj->...ni", R, pts3d) + t[..., None, :]
    z = x_cam[..., 2]
    z_safe = jnp.where(z == 0, 1e-12, z)
    xy = x_cam[..., :2] / z_safe[..., None]
    xy_d = distort_normalized(intr, xy)
    uv = normalized_to_pixels(intr, xy_d)
    return uv, z


def reprojection_residuals(
    pose: jax.Array, intr: jax.Array, pts3d: jax.Array, uv_obs: jax.Array
) -> jax.Array:
    """Per-observation 2D residuals (projected - observed), the BA residual.

    Matches the reference's Ceres cost functors (residual = predicted
    centered/pixel position minus observation; e.g.
    src/photogrammetrie/common/SimpleRadialCamera.cpp:69-116).
    """
    uv, _ = project_points(pose, intr, pts3d)
    return uv - uv_obs
