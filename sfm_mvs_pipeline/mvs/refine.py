"""Photometric mesh refinement (--refine-mesh).

Replaces openMVS RefineMesh (ref: src/photogrammetrie/mvs/MVS.cpp:157-172,
gated by the --refine-mesh flag, src/cli/PhotogrammetrieCli.cpp:227; the
usage text warns it "kann ebenso zu schlechterem Mesh fuehren" —
PhotogrammetrieCli.cpp:453).

Batched formulation instead of openMVS's per-vertex gradient descent:
every vertex searches a fixed ladder of displacements along its normal and
keeps the one maximizing ZNCC photo-consistency between its two best
views — a batched (N_vertices x K_offsets x P_patch) evaluation per view
pair, all dense array ops. Vertices whose best score does not beat their
undisplaced score stay put, so refinement can only improve the photometric
objective it optimizes.
"""

from __future__ import annotations

import numpy as np


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # magnitude = 2*area (weights)
    n = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(n, faces[:, i], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def _vertex_view_scores(vertices, normals, poses, intr, image_hw):
    """(V, N) view-quality score per vertex (cos / z^2; -1 = not visible)."""
    import jax.numpy as jnp

    from sfm_mvs_pipeline.models.cameras import project_points
    from sfm_mvs_pipeline.ops.pose import camera_center

    h, w = image_hw
    pts = jnp.asarray(vertices, jnp.float32)
    poses_d = jnp.asarray(poses, jnp.float32)
    uv, z = project_points(
        poses_d, jnp.asarray(intr, jnp.float32),
        jnp.broadcast_to(pts[None], (len(poses), *pts.shape)),
    )
    uv = np.asarray(uv)
    z = np.asarray(z)
    import jax

    centers = np.asarray(jax.vmap(camera_center)(poses_d))
    to_cam = centers[:, None, :] - vertices[None]
    to_cam /= np.maximum(np.linalg.norm(to_cam, axis=-1, keepdims=True), 1e-12)
    cosang = np.einsum("vnk,nk->vn", to_cam, normals)
    m = 2.0  # patch margin in px
    inside = (
        (uv[..., 0] >= m) & (uv[..., 0] <= w - 1 - m)
        & (uv[..., 1] >= m) & (uv[..., 1] <= h - 1 - m)
        & (z > 1e-6)
    )
    return np.where(inside & (cosang > 0.05), cosang / np.maximum(z, 1e-6) ** 2, -1.0)


def refine_mesh_photometric(
    vertices: np.ndarray,
    faces: np.ndarray,
    poses: np.ndarray,  # (V, 6)
    intr: np.ndarray,  # (7,)
    grays: np.ndarray,  # (V, H, W) float in [0, 1]
    n_offsets: int = 9,
    rel_range: float = 0.5,
    patch_radius: int = 1,
    log=lambda *a: None,
) -> np.ndarray:
    """Returns refined vertex positions (same shape as `vertices`)."""
    import jax.numpy as jnp

    from sfm_mvs_pipeline.models.cameras import project_points
    from sfm_mvs_pipeline.mvs.plane_sweep import _bilinear_hw

    if len(vertices) == 0 or len(faces) == 0 or len(poses) < 2:
        return vertices

    normals = vertex_normals(vertices, faces)
    scores = _vertex_view_scores(vertices, normals, poses, intr, grays.shape[1:])
    order = np.argsort(-scores, axis=0)
    b1, b2 = order[0], order[1]  # two best views per vertex
    ok = (np.take_along_axis(scores, order[1:2], 0)[0] > 0)

    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    elen = np.linalg.norm(vertices[edges[:, 0]] - vertices[edges[:, 1]], axis=1)
    delta = float(np.median(elen)) * rel_range
    offsets = np.linspace(-delta, delta, n_offsets)
    zero_k = int(np.argmin(np.abs(offsets)))
    offsets[zero_k] = 0.0  # ensure the identity candidate is present

    r = patch_radius
    dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1), indexing="ij")
    dxy = np.stack([dx.ravel(), dy.ravel()], -1).astype(np.float32)  # (P, 2)

    import functools

    import jax

    @functools.partial(jax.jit, static_argnames=("n_off", "zero"))
    def _best_offsets(p, n, pose_a, pose_b, gray_a, gray_b, intr_d, offs,
                      dxy_d, n_off, zero):
        cand = p[:, None, :] + n[:, None, :] * offs[None, :, None]  # (N, K, 3)

        def patches(pose, gray):
            uv, z = project_points(pose, intr_d, cand.reshape(1, -1, 3))
            uv = uv[0]  # (N*K, 2)
            pix = uv[:, None, :] + dxy_d[None]  # (N*K, P, 2)
            vals, inside = _bilinear_hw(gray, pix[..., 0], pix[..., 1])
            return vals, inside.all(-1) & (z[0] > 1e-6)

        pa, ia = patches(pose_a, gray_a)
        pb, ib = patches(pose_b, gray_b)
        ma = pa - pa.mean(-1, keepdims=True)
        mb = pb - pb.mean(-1, keepdims=True)
        denom = jnp.sqrt((ma * ma).sum(-1) * (mb * mb).sum(-1)) + 1e-9
        zncc = jnp.where(ia & ib, (ma * mb).sum(-1) / denom, -2.0)
        zncc = zncc.reshape(-1, n_off)
        kbest = jnp.argmax(zncc, axis=1)
        improve = (
            jnp.take_along_axis(zncc, kbest[:, None], 1)[:, 0]
            > zncc[:, zero] + 1e-4
        )
        return jnp.where(improve, kbest, zero)

    intr_d = jnp.asarray(intr, jnp.float32)
    offs_d = jnp.asarray(offsets, jnp.float32)
    dxy_d = jnp.asarray(dxy)
    grays_d = jnp.asarray(grays, jnp.float32)

    out = vertices.copy()
    pair_key = b1.astype(np.int64) * len(poses) + b2
    moved = 0
    for key in np.unique(pair_key[ok]):
        va, vb = int(key // len(poses)), int(key % len(poses))
        sel = np.nonzero(ok & (pair_key == key))[0]
        # pad the vertex batch to a power of two: one compile per bucket,
        # not per group size
        m = max(64, 1 << int(np.ceil(np.log2(len(sel)))))
        p = np.zeros((m, 3), np.float32)
        n = np.zeros((m, 3), np.float32)
        p[: len(sel)] = vertices[sel]
        n[: len(sel)] = normals[sel]
        k_np = np.asarray(
            _best_offsets(
                jnp.asarray(p), jnp.asarray(n),
                jnp.asarray(poses[va], jnp.float32),
                jnp.asarray(poses[vb], jnp.float32),
                grays_d[va], grays_d[vb], intr_d, offs_d, dxy_d,
                n_offsets, zero_k,
            )
        )[: len(sel)]
        out[sel] = vertices[sel] + normals[sel] * offsets[k_np][:, None]
        moved += int((k_np != zero_k).sum())
    log(f"refine-mesh: moved {moved}/{len(vertices)} vertices "
        f"(search +-{delta:.4g})")
    return out
