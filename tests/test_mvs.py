"""Dense MVS tests on a synthetic two-plane scene with analytic ground truth."""

import numpy as np
import jax.numpy as jnp
import pytest

from sfm_mvs_pipeline.mvs.plane_sweep import (
    make_depth_planes,
    sweep_cost_volume,
    wta_depth,
)
from sfm_mvs_pipeline.mvs.sgm import sgm_aggregate
from sfm_mvs_pipeline.mvs.fusion import fuse_depth_maps
from sfm_mvs_pipeline.mvs.mesh import mesh_from_depth_maps


H, W, F = 120, 160, 140.0
Z_BG, Z_FG = 12.0, 8.0


def _texture(rng, n=512):
    import cv2

    t = rng.random((n, n)).astype(np.float32)
    return cv2.GaussianBlur(t, (0, 0), 1.5)


def _render(rng, centers):
    """Ray-cast 2 world planes (z = const) with a procedural texture.
    Cameras look down +z with identity rotation. Returns (grays, gt_depths)."""
    tex = _texture(rng)
    n = tex.shape[0]
    grays, depths = [], []
    cx, cy = W / 2, H / 2
    for C in centers:
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        rx = (xs - cx) / F
        ry = (ys - cy) / F
        # intersect background plane z = Z_BG (world); camera at C, R = I
        tz_bg = Z_BG - C[2]
        Xb = C[0] + rx * tz_bg
        Yb = C[1] + ry * tz_bg
        # foreground square [-1.5, 1.5]^2 at z = Z_FG
        tz_fg = Z_FG - C[2]
        Xf = C[0] + rx * tz_fg
        Yf = C[1] + ry * tz_fg
        fg = (np.abs(Xf) < 1.5) & (np.abs(Yf) < 1.5)
        X = np.where(fg, Xf, Xb)
        Y = np.where(fg, Yf, Yb)
        z = np.where(fg, tz_fg, tz_bg)
        # texture lookup by world xy (scaled)
        ui = ((X * 0.1 + 0.5) % 1.0 * (n - 1)).astype(int)
        vi = ((Y * 0.1 + 0.5) % 1.0 * (n - 1)).astype(int)
        grays.append(tex[vi, ui])
        depths.append(z)
    return np.stack(grays).astype(np.float32), np.stack(depths).astype(np.float32)


@pytest.fixture(scope="module")
def plane_scene():
    rng = np.random.default_rng(5)
    centers = np.array(
        [[-0.6, 0, 0], [-0.3, 0, 0], [0, 0, 0], [0.3, 0, 0], [0.6, 0, 0]]
    )
    grays, gt = _render(rng, centers)
    poses = np.zeros((5, 6), np.float32)
    poses[:, 3:] = -centers  # R = I -> t = -C
    intr = np.array([F, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    return grays, gt, poses, intr


def test_plane_sweep_depth(plane_scene):
    grays, gt, poses, intr = plane_scene
    planes = make_depth_planes(6.0, 16.0, 64).astype(np.float32)
    r = 2  # middle view
    nbrs = [0, 1, 3, 4]
    cv = sweep_cost_volume(
        jnp.asarray(grays[r]), jnp.asarray(grays[nbrs]),
        jnp.asarray(poses[r]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), jnp.asarray(planes),
    )
    assert cv.shape == (64, H, W)
    depth, cost, valid = wta_depth(cv, jnp.asarray(planes), max_cost=0.35)
    depth = np.asarray(depth)
    valid = np.asarray(valid)
    assert valid.mean() > 0.7, f"valid fraction {valid.mean()}"
    rel = np.abs(depth - gt[r]) / gt[r]
    med = np.median(rel[valid])
    assert med < 0.01, f"median relative depth error {med}"


def test_sgm_improves_or_holds(plane_scene):
    grays, gt, poses, intr = plane_scene
    planes = make_depth_planes(6.0, 16.0, 64).astype(np.float32)
    r, nbrs = 2, [1, 3]
    cv = sweep_cost_volume(
        jnp.asarray(grays[r]), jnp.asarray(grays[nbrs]),
        jnp.asarray(poses[r]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), jnp.asarray(planes),
    )
    d0, _, v0 = wta_depth(cv, jnp.asarray(planes), max_cost=0.5)
    agg = sgm_aggregate(cv)
    d1, _, v1 = wta_depth(agg, jnp.asarray(planes), max_cost=0.5)
    err0 = np.median(np.abs(np.asarray(d0) - gt[r])[np.asarray(v0)])
    err1 = np.median(np.abs(np.asarray(d1) - gt[r])[np.asarray(v1)])
    assert err1 <= err0 * 1.5  # SGM must not break a clean scene
    # SGM fills in: at least as many confident pixels
    assert np.asarray(v1).sum() >= np.asarray(v0).sum() * 0.9


def test_fusion_and_mesh(plane_scene):
    grays, gt, poses, intr = plane_scene
    planes = make_depth_planes(6.0, 16.0, 64).astype(np.float32)
    V = len(grays)
    dms = np.zeros((V, H, W), np.float32)
    vds = np.zeros((V, H, W), bool)
    for r in range(V):
        nbrs = [i for i in range(V) if i != r][:4]
        cv = sweep_cost_volume(
            jnp.asarray(grays[r]), jnp.asarray(grays[nbrs]),
            jnp.asarray(poses[r]), jnp.asarray(poses[nbrs]),
            jnp.asarray(intr), jnp.asarray(planes),
        )
        d, c, v = wta_depth(cv, jnp.asarray(planes), max_cost=0.35)
        dms[r] = np.asarray(d)
        vds[r] = np.asarray(v)

    rgbs = np.repeat((grays[..., None] * 255).astype(np.uint8), 3, axis=-1)
    fused = fuse_depth_maps(dms, vds, poses, intr, rgbs, min_views=3)
    pts = fused["points"]
    assert len(pts) > 5000
    # points lie on one of the two planes
    d_bg = np.abs(pts[:, 2] - Z_BG)
    d_fg = np.abs(pts[:, 2] - Z_FG)
    on_plane = np.minimum(d_bg, d_fg) < 0.15
    assert on_plane.mean() > 0.95, f"on-plane fraction {on_plane.mean()}"

    mesh = mesh_from_depth_maps(dms, vds, poses, intr, rgbs)
    assert len(mesh["vertices"]) > 500
    assert len(mesh["faces"]) > 1000
    mv = mesh["vertices"]
    on_plane_v = (
        np.minimum(np.abs(mv[:, 2] - Z_BG), np.abs(mv[:, 2] - Z_FG)) < 0.3
    )
    assert on_plane_v.mean() > 0.9


def _np_sgm(cost, p1, p2):
    """Straight numpy replica of 4-path SGM over a (D, H, W) volume: for each
    direction r, L_r(p, d) = C(p, d) + min(L_r(p-r, d), L_r(p-r, d+-1) + P1,
    min_d' L_r(p-r, d') + P2) - min_d' L_r(p-r, d'); the result is the mean
    of the four paths."""
    c = np.moveaxis(cost.astype(np.float64), 0, -1)  # (H, W, D)

    def one_dir(v):  # scan along axis 0 of (S, L, D)
        out = np.empty_like(v)
        out[0] = v[0]
        for i in range(1, len(v)):
            prev = out[i - 1]
            m = prev.min(-1, keepdims=True)
            pad = np.pad(prev, ((0, 0), (1, 1)), constant_values=np.inf)
            best = np.minimum.reduce(
                [prev, pad[:, :-2] + p1, pad[:, 2:] + p1,
                 np.broadcast_to(m + p2, prev.shape)]
            )
            out[i] = v[i] + best - m
        return out

    tb = one_dir(c)
    bt = one_dir(c[::-1])[::-1]
    cw = np.swapaxes(c, 0, 1)
    lr = np.swapaxes(one_dir(cw), 0, 1)
    rl = np.swapaxes(one_dir(cw[::-1])[::-1], 0, 1)
    return np.moveaxis((tb + bt + lr + rl) / 4.0, -1, 0)


@pytest.mark.parametrize("shape", [(5, 7, 9), (12, 16, 3)])
@pytest.mark.parametrize("p1,p2", [(0.03, 0.3), (0.1, 1.0)])
def test_sgm_aggregate_matches_numpy(rng, shape, p1, p2):
    """sgm_aggregate (four lax.scan recurrences) against the numpy replica,
    on a wide and a tall volume."""
    cost = rng.random(shape).astype(np.float32)
    got = np.asarray(sgm_aggregate(jnp.asarray(cost), p1, p2))
    np.testing.assert_allclose(got, _np_sgm(cost, p1, p2), atol=1e-5)


def test_texture_and_refine(plane_scene, tmp_path):
    """Texture atlas + textured PLY + photometric refinement on the synthetic
    scene: every face with a visible view gets one, texels come from real
    image content, refinement never degrades vertices with no photo signal."""
    from sfm_mvs_pipeline.mvs.refine import refine_mesh_photometric
    from sfm_mvs_pipeline.mvs.texture import (
        build_texture_atlas,
        select_face_views,
        write_ply_mesh_textured,
    )

    grays, gt, poses, intr = plane_scene
    valids = np.ones_like(gt, bool)
    rgbs = np.repeat((grays * 255).astype(np.uint8)[..., None], 3, axis=-1)
    mesh = mesh_from_depth_maps(gt, valids, poses, intr, rgbs, decimate=True)
    V, F_, = mesh["vertices"], mesh["faces"]
    assert len(F_) > 100

    best = select_face_views(V, F_, poses, intr, grays.shape[1:])
    assert (best >= 0).mean() > 0.8  # nearly all faces are seen

    tex = build_texture_atlas(V, F_, poses, intr, rgbs)
    atlas, uv = tex["atlas"], tex["uv"]
    assert uv.shape == (len(F_), 3, 2)
    assert (uv >= 0).all() and (uv <= 1).all()
    assert atlas.std() > 10  # real texture content, not a constant fill

    out = str(tmp_path / "mesh.ply")
    write_ply_mesh_textured(out, V, F_, uv, atlas, colors=mesh.get("colors"))
    head = open(out, "rb").read(400).decode("latin1")
    assert "TextureFile" in head and "texcoord" in head
    assert (tmp_path / "mesh.png").exists()

    # our own reader must round-trip the textured mesh: the face element
    # carries BOTH a vertex_indices list and a texcoord list per face
    # (regression: the reader used to misparse texcoord bytes as faces)
    from sfm_mvs_pipeline.utils.ply import read_ply

    back = read_ply(out)
    assert len(back["points"]) == len(V)
    np.testing.assert_array_equal(np.stack(back["faces"]), F_)

    refined = refine_mesh_photometric(V, F_, poses, intr, grays)
    assert refined.shape == V.shape
    # refinement is bounded by the search ladder
    d = np.linalg.norm(refined - V, axis=1)
    assert np.isfinite(refined).all() and d.max() < 1.0


def test_close_holes():
    """A grid mesh with one interior quad hole gets filled; the outer
    border (too large) stays open. Ref parity: mesh.Clean close-holes 30
    (src/photogrammetrie/mvs/MVS.cpp:160-166)."""
    from sfm_mvs_pipeline.mvs.mesh import close_holes

    n = 12
    yy, xx = np.mgrid[0:n, 0:n]
    V = np.stack([xx.ravel(), yy.ravel(), np.zeros(n * n).ravel()], 1).astype(
        np.float64
    )
    vid = lambda r, c: r * n + c
    F = []
    hole = (5, 5)  # skip both triangles of this quad
    for r in range(n - 1):
        for c in range(n - 1):
            if (r, c) == hole:
                continue
            a, b = vid(r, c), vid(r, c + 1)
            cc, d = vid(r + 1, c), vid(r + 1, c + 1)
            F.append((a, b, cc))
            F.append((b, d, cc))
    F = np.asarray(F, np.int64)
    cols = np.full((len(V), 3), 128, np.uint8)

    V2, F2, C2 = close_holes(V, F, cols, max_edges=30)
    # hole (4 boundary edges) filled with a centroid fan: +1 vertex, +4 faces
    assert len(V2) == len(V) + 1
    assert len(F2) == len(F) + 4
    assert C2.shape[0] == len(V2)
    np.testing.assert_allclose(V2[-1][:2], [5.5, 5.5])
    # the outer border (44 edges > 30) must remain open
    e = np.concatenate([F2[:, [0, 1]], F2[:, [1, 2]], F2[:, [2, 0]]])
    fwd = set(map(tuple, e.tolist()))
    n_boundary = sum(1 for (a, b) in fwd if (b, a) not in fwd)
    assert n_boundary == 4 * (n - 1)

    # closing with a small limit is a no-op for the quad hole
    V3, F3, _ = close_holes(V, F, cols, max_edges=3)
    assert len(V3) == len(V) and len(F3) == len(F)


def test_patchmatch_depth(plane_scene):
    """PatchMatch must resolve the two-plane scene to sub-percent median
    relative error — the continuous-depth analogue of the plane sweep
    (ref default dense path: MVS.cpp:118 DenseReconstruction(0))."""
    import jax

    from sfm_mvs_pipeline.mvs.patchmatch import patchmatch_depth

    grays, gt, poses, intr = plane_scene
    r, nbrs = 2, [0, 1, 3, 4]
    depth, cost, valid = patchmatch_depth(
        jnp.asarray(grays[r]), jnp.asarray(grays[nbrs]),
        jnp.asarray(poses[r]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), 6.0, 16.0, jax.random.PRNGKey(0),
        iterations=6, max_cost=0.35,
    )
    depth = np.asarray(depth)
    valid = np.asarray(valid)
    assert valid.mean() > 0.7, f"valid fraction {valid.mean()}"
    rel = np.abs(depth - gt[r]) / gt[r]
    med = np.median(rel[valid])
    assert med < 0.01, f"median relative depth error {med}"
    # continuous depths: not quantized to a plane ladder (a 64-plane sweep
    # yields <=64 distinct raw values; random search resolves far more —
    # piecewise-constant GT legitimately lets propagation clone values, so
    # only require well beyond any plane count)
    assert len(np.unique(depth[valid])) > 500


def test_patchmatch_seeded_matches_unseeded(plane_scene):
    """Seeding from a coarse depth (the ladder path) must not hurt."""
    import jax

    from sfm_mvs_pipeline.mvs.patchmatch import patchmatch_depth

    grays, gt, poses, intr = plane_scene
    r, nbrs = 2, [0, 1, 3, 4]
    args = (
        jnp.asarray(grays[r]), jnp.asarray(grays[nbrs]),
        jnp.asarray(poses[r]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), 6.0, 16.0,
    )
    seed = jnp.asarray(gt[r] * (1.0 + 0.03))  # a biased-but-close seed
    d1, _, v1 = patchmatch_depth(
        *args, jax.random.PRNGKey(1), init_depth=seed, iterations=5,
        max_cost=0.35,
    )
    err = np.abs(np.asarray(d1) - gt[r]) / gt[r]
    assert np.asarray(v1).mean() > 0.6
    assert np.median(err[np.asarray(v1)]) < 0.01


def test_rectified_depth(plane_scene):
    """The gather-free rectified disparity engine must resolve the
    two-plane scene like the plane sweep (same ZNCC scoring; per-pair WTA
    + cross-neighbor consensus instead of joint aggregation)."""
    from sfm_mvs_pipeline.mvs.rectified import rectified_depth

    grays, gt, poses, intr = plane_scene
    r, nbrs = 2, [0, 1, 3, 4]
    depth, cost, valid = rectified_depth(
        jnp.asarray(grays[r]), jnp.asarray(grays[nbrs]),
        jnp.asarray(poses[r]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), 6.0, 16.0, n_levels=64, max_cost=0.35,
    )
    depth = np.asarray(depth)
    valid = np.asarray(valid)
    assert valid.mean() > 0.6, f"valid fraction {valid.mean()}"
    rel = np.abs(depth - gt[r]) / gt[r]
    med = np.median(rel[valid])
    assert med < 0.01, f"median relative depth error {med}"


def test_rectified_degenerate_baseline_masked(plane_scene):
    """A pure forward-motion pair (baseline along the optical axis) cannot
    be rectified: the engine must mask it out instead of producing junk."""
    from sfm_mvs_pipeline.mvs.rectified import rectified_pair_depth

    grays, gt, poses, intr = plane_scene
    pose_fwd = np.zeros(6, np.float32)
    pose_fwd[5] = -0.3  # camera moved along +z
    d, c, v = rectified_pair_depth(
        jnp.asarray(grays[2]), jnp.asarray(grays[2]),
        jnp.asarray(poses[2]), jnp.asarray(pose_fwd),
        jnp.asarray(intr), 6.0, 16.0, n_levels=16,
    )
    assert not np.asarray(v).any()


def test_rect_forward_motion_falls_back_to_sweep(tmp_path):
    """ADVICE r3: for a pure forward-motion sequence EVERY neighbor fails
    the rectification geometry gate, and the r3 pipeline silently produced
    empty depth maps under the default method. run_mvs must now detect the
    degenerate geometry up front and route those views through the
    warp-based plane sweep."""
    import cv2

    from sfm_mvs_pipeline.models.scene import Scene
    from sfm_mvs_pipeline.mvs.pipeline import MVSConfig, run_mvs
    from sfm_mvs_pipeline.mvs.rectified import rect_geometry_ok

    rng = np.random.default_rng(11)
    centers = np.array([[0, 0, 0], [0, 0, 0.5], [0, 0, 1.0]])  # forward motion
    grays, gt = _render(rng, centers)
    poses = np.zeros((3, 6), np.float32)
    poses[:, 3:] = -centers

    # the gate itself: all-False for forward motion, True for lateral
    assert not rect_geometry_ok(poses[0], poses[1:]).any()
    lateral = np.zeros((1, 6), np.float32)
    lateral[0, 3] = 0.5
    assert rect_geometry_ok(poses[0], lateral).all()

    paths = []
    for i, g in enumerate(grays):
        p = str(tmp_path / f"{i}.png")
        cv2.imwrite(p, (g * 255).astype(np.uint8))
        paths.append(p)

    intr = np.array([F, W / 2, H / 2, 0, 0, 0, 0], np.float64)
    scene = Scene.create(
        paths, (W, H),
        np.zeros((3, 8, 2), np.float32), np.zeros((3, 8, 4), np.float32),
        np.ones((3, 8), bool), intr,
    )
    scene.poses[:] = poses
    scene.recovered[:] = True
    # sparse points on the background plane observed by every view (feeds
    # select_neighbors' shared-point scoring and depth_range)
    n_pts = 40
    X = np.stack(
        [
            rng.uniform(-3, 3, n_pts),
            rng.uniform(-2, 2, n_pts),
            rng.uniform(Z_FG - 1.0, Z_BG + 1.0, n_pts),  # spread in depth
        ],
        axis=1,
    )
    scene.points = X
    scene.point_valid = np.ones(n_pts, bool)
    scene.colors = np.zeros((n_pts, 4), np.uint8)
    op, os_, of_, uv = [], [], [], []
    for s in range(3):
        Xc = X - centers[s]  # R = I
        u = F * Xc[:, 0] / Xc[:, 2] + W / 2
        v = F * Xc[:, 1] / Xc[:, 2] + H / 2
        op.extend(range(n_pts))
        os_.extend([s] * n_pts)
        of_.extend([0] * n_pts)
        uv.extend(np.stack([u, v], axis=1))
    scene.obs_point = np.asarray(op, np.int32)
    scene.obs_shot = np.asarray(os_, np.int32)
    scene.obs_feat = np.asarray(of_, np.int32)
    scene.obs_uv = np.asarray(uv, np.float32)
    scene.obs_w = np.ones(len(op), np.float32)

    logs = []
    out = run_mvs(
        scene, str(tmp_path),
        MVSConfig(method="rect", n_planes=48, min_fusion_views=2),
        log=lambda *a: logs.append(" ".join(str(x) for x in a)),
    )
    assert any("falling back to plane sweep" in m for m in logs)
    valids = out["valids"]
    assert valids.any(), "fallback must produce non-empty depth maps"
    # and the depth is actually right where valid
    dm = out["depth_maps"]
    gt_cam = gt  # R = I: camera depth == rendered z
    errs = []
    for i in range(3):
        if valids[i].any():
            rel = np.abs(dm[i] - gt_cam[i]) / gt_cam[i]
            errs.append(np.median(rel[valids[i]]))
    assert errs and min(errs) < 0.05, f"median relative errors {errs}"


def test_derive_max_disp():
    """The static disparity bound must scale with focal x baseline / z_min
    (the r3 hard-coded 256 truncated the near range at the 3200-px ladder)."""
    from sfm_mvs_pipeline.mvs.rectified import derive_max_disp

    pose_r = np.zeros(6, np.float32)
    pose_n = np.zeros((1, 6), np.float32)
    pose_n[0, 3] = -1.0  # baseline 1 along x (t = -C)
    # small need -> floor 256
    assert derive_max_disp(pose_r, pose_n, 140.0, 5.0, 640) == 256
    # 3200-px-class: f=3840, b=1, z_min=5 -> need ~806 -> 1024
    assert derive_max_disp(pose_r, pose_n, 3840.0, 5.0, 3200) == 1024
    # absurd need is capped at the image width (rounded to lanes)
    assert derive_max_disp(pose_r, pose_n, 3840.0, 0.01, 3200) == 3200


def test_rect_ladder_resize_1080p(tmp_path):
    """VERDICT r3 item 4: exercise the resolution-ladder resize path at
    >=1080p end to end — 1440x810 inputs densified at the 1080 ladder cap
    through the rect engine, with the geometry-derived disparity bound."""
    import cv2

    from sfm_mvs_pipeline.models.scene import Scene
    from sfm_mvs_pipeline.mvs.pipeline import MVSConfig, run_mvs

    h2, w2, f2 = 810, 1440, 1700.0
    rng = np.random.default_rng(7)
    tex = cv2.GaussianBlur(rng.random((2048, 2048)).astype(np.float32), (0, 0), 2.0)
    centers = np.array([[-0.35, 0, 0], [0, 0, 0], [0.35, 0, 0]])
    grays, gts = [], []
    for C in centers:
        ys, xs = np.mgrid[0:h2, 0:w2].astype(np.float64)
        rx = (xs - w2 / 2) / f2
        ry = (ys - h2 / 2) / f2
        tz = Z_BG - C[2]
        X = C[0] + rx * tz
        Y = C[1] + ry * tz
        ui = ((X * 0.08 + 0.5) % 1.0 * 2047).astype(int)
        vi = ((Y * 0.08 + 0.5) % 1.0 * 2047).astype(int)
        grays.append(tex[vi, ui])
        gts.append(np.full((h2, w2), tz, np.float32))
    poses = np.zeros((3, 6), np.float32)
    poses[:, 3:] = -centers

    paths = []
    for i, g in enumerate(grays):
        p = str(tmp_path / f"hr{i}.png")
        cv2.imwrite(p, (g * 255).astype(np.uint8))
        paths.append(p)

    intr = np.array([f2, w2 / 2, h2 / 2, 0, 0, 0, 0], np.float64)
    scene = Scene.create(
        paths, (w2, h2),
        np.zeros((3, 8, 2), np.float32), np.zeros((3, 8, 4), np.float32),
        np.ones((3, 8), bool), intr,
    )
    scene.poses[:] = poses
    scene.recovered[:] = True
    n_pts = 30
    X = np.stack(
        [
            rng.uniform(-2, 2, n_pts),
            rng.uniform(-1.5, 1.5, n_pts),
            rng.uniform(Z_BG - 1.5, Z_BG + 1.5, n_pts),
        ],
        axis=1,
    )
    scene.points = X
    scene.point_valid = np.ones(n_pts, bool)
    scene.colors = np.zeros((n_pts, 4), np.uint8)
    op, os_, of_, uv = [], [], [], []
    for s in range(3):
        Xc = X - centers[s]
        u = f2 * Xc[:, 0] / Xc[:, 2] + w2 / 2
        v = f2 * Xc[:, 1] / Xc[:, 2] + h2 / 2
        op.extend(range(n_pts))
        os_.extend([s] * n_pts)
        of_.extend([0] * n_pts)
        uv.extend(np.stack([u, v], axis=1))
    scene.obs_point = np.asarray(op, np.int32)
    scene.obs_shot = np.asarray(os_, np.int32)
    scene.obs_feat = np.asarray(of_, np.int32)
    scene.obs_uv = np.asarray(uv, np.float32)
    scene.obs_w = np.ones(len(op), np.float32)

    logs = []
    out = run_mvs(
        scene, str(tmp_path),
        MVSConfig(
            method="rect", max_resolution=1080, n_planes=32, n_neighbors=2,
            min_fusion_views=2,
        ),
        log=lambda *a: logs.append(" ".join(str(x) for x in a)),
    )
    # the ladder actually downscaled 1440 -> 1080
    assert any("at 1080x607" in m or "at 1080x608" in m for m in logs), logs[:3]
    valids = out["valids"]
    assert valids.reshape(3, -1).any(axis=1).all(), "every view needs depth"
    dm = out["depth_maps"]
    errs = []
    for i in range(3):
        gt_i = cv2.resize(gts[i], (dm.shape[2], dm.shape[1]))
        rel = np.abs(dm[i] - gt_i) / gt_i
        errs.append(float(np.median(rel[valids[i]])))
    assert max(errs) < 0.03, f"median relative depth errors {errs}"


def test_rectified_sgm(plane_scene):
    """--sgm through the rectified engine: 4-path aggregation on the
    per-pair disparity volume must hold (or improve) the two-plane scene."""
    from sfm_mvs_pipeline.mvs.rectified import rectified_depth

    grays, gt, poses, intr = plane_scene
    r, nbrs = 2, [0, 1, 3, 4]
    depth, cost, valid = rectified_depth(
        jnp.asarray(grays[r]), jnp.asarray(grays[nbrs]),
        jnp.asarray(poses[r]), jnp.asarray(poses[nbrs]),
        jnp.asarray(intr), 6.0, 16.0, n_levels=64, max_cost=0.35,
        use_sgm=True,
    )
    depth = np.asarray(depth)
    valid = np.asarray(valid)
    assert valid.mean() > 0.6, f"valid fraction {valid.mean()}"
    rel = np.abs(depth - gt[r]) / gt[r]
    med = np.median(rel[valid])
    assert med < 0.01, f"median relative depth error {med}"
