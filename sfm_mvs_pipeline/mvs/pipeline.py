"""Dense MVS orchestration: undistort -> ladder -> depth maps -> fuse -> mesh.

Mirrors MVS::densifyScene / MVS::meshScene orchestration
(ref: src/photogrammetrie/mvs/MVS.cpp:100-181) and the exporter's
undistorted-image handoff (ref: src/photogrammetrie/util/OpenMvsUtils.cpp:136-152):
  * resolution ladder bounds: max 3200 / min 640 (ref: MVS.h:60-61)
  * 5 neighbor views (ref: MVS.h:58)
  * 3-view fusion inliers (ref: MVS.h:62)
  * plane-sweep default, SGM with --sgm (ref: MVS.cpp:112-120)
  * meshing + cleanup + optional refine/texture (ref: MVS.cpp:130-181)
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class MVSConfig:
    max_resolution: int = 3200
    min_resolution: int = 640
    n_neighbors: int = 5
    n_planes: int = 96
    window_radius: int = 3
    max_cost: float = 0.35
    min_fusion_views: int = 3
    fusion_tolerance: float = 0.01
    use_sgm: bool = False
    sgm_p1: float = 0.03
    sgm_p2: float = 0.3
    # depth-map method:
    #   "rect"       rectified pairwise disparity sweep (mvs/rectified.py),
    #                the default: shifts instead of per-plane gathers
    #   "sweep"      joint plane-sweep cost volume (mvs/plane_sweep.py)
    #   "patchmatch" checkerboard PatchMatch (mvs/patchmatch.py), the
    #                reference's openMVS default in batched form
    method: str = "rect"
    pm_iterations: int = 8
    # seed PatchMatch from the rectified engine's depth (one rectified
    # sweep) and run pm_iterations//4 refinement iterations instead of the full
    # random-init schedule — same continuous-depth output, ~4x faster; set
    # False for the classic random-init PatchMatch
    pm_seed_rect: bool = True
    mesh: bool = False
    decimate: bool = True
    refine_mesh: bool = False
    texture: bool = False
    keep_artifacts: bool = False


def _undistort_image(img: np.ndarray, intr: np.ndarray) -> np.ndarray:
    """Resample an image so straight lines are straight under pinhole K.

    For each undistorted target pixel: normalized -> distort -> source pixel
    (the same mapping cv2.initUndistortRectifyMap builds; the reference
    exports undistorted PNGs the same way, OpenMvsUtils.cpp:136-150)."""
    from sfm_mvs_pipeline.models.cameras import (
        distort_normalized,
        normalized_to_pixels,
        pixels_to_normalized,
    )
    from sfm_mvs_pipeline.mvs.plane_sweep import _bilinear_hw

    h, w = img.shape[:2]
    intr_d = jnp.asarray(intr, jnp.float32)
    ys, xs = jnp.meshgrid(
        jnp.arange(h, dtype=jnp.float32), jnp.arange(w, dtype=jnp.float32),
        indexing="ij",
    )
    uv = jnp.stack([xs, ys], axis=-1).reshape(-1, 2)
    xy = pixels_to_normalized(intr_d, uv)  # undistorted normalized (target)
    src = normalized_to_pixels(intr_d, distort_normalized(intr_d, xy)).reshape(
        h, w, 2
    )
    if img.ndim == 2:
        out, _ = _bilinear_hw(jnp.asarray(img, jnp.float32), src[..., 0], src[..., 1])
        return np.asarray(out)
    chans = [
        np.asarray(
            _bilinear_hw(
                jnp.asarray(img[..., c], jnp.float32), src[..., 0], src[..., 1]
            )[0]
        )
        for c in range(img.shape[2])
    ]
    return np.stack(chans, axis=-1)


def run_mvs(scene, out_dir: str, cfg: MVSConfig | None = None, log=lambda *a: None) -> dict:
    """Densify (and optionally mesh) a reconstructed scene. Writes
    pointcloud_dense.ply (+ mesh_dense.ply) into out_dir. Returns results."""
    from sfm_mvs_pipeline.mvs.fusion import fuse_depth_maps
    from sfm_mvs_pipeline.mvs.neighbors import depth_range, select_neighbors
    from sfm_mvs_pipeline.mvs.plane_sweep import (
        make_depth_planes,
        sweep_cost_volume,
        wta_depth,
    )
    from sfm_mvs_pipeline.utils.images import load_rgb, resize_area, rgb_to_gray
    from sfm_mvs_pipeline.utils.ply import write_ply_points

    cfg = cfg or MVSConfig()
    rec = [int(s) for s in np.nonzero(scene.recovered)[0]]
    if len(rec) < 2:
        log("not enough recovered views for densification")
        return {}
    w0, h0 = scene.image_size
    intr0 = scene.intrinsics[0]

    # resolution ladder (ref: resetImageResoloution semantics)
    scale = 1.0
    if max(w0, h0) > cfg.max_resolution:
        scale = cfg.max_resolution / max(w0, h0)
    elif max(w0, h0) < cfg.min_resolution:
        scale = 1.0  # never upsample beyond native
    w = int(round(w0 * scale))
    h = int(round(h0 * scale))
    intr = intr0.copy()
    intr[:3] *= scale
    intr_pinhole = intr.copy()
    intr_pinhole[3:] = 0.0  # images get undistorted below

    method = "SGM" if cfg.use_sgm else {
        "patchmatch": "PatchMatch", "sweep": "plane-sweep",
    }.get(cfg.method, "rectified-sweep")
    log(f"densifying {len(rec)} views at {w}x{h} "
        f"({method}, {cfg.n_planes} planes)")

    grays, rgbs = [], []
    for s in rec:
        rgb = load_rgb(scene.image_paths[s], (w0, h0))
        if scale != 1.0:
            rgb = resize_area(rgb, (w, h))
        rgb_u = _undistort_image(rgb, intr)
        gray = rgb_to_gray(rgb_u.astype(np.uint8))
        grays.append(gray.astype(np.float32) / 255.0)
        rgbs.append(rgb_u.astype(np.uint8))
    grays = np.stack(grays)
    rgbs = np.stack(rgbs)

    neighbors = select_neighbors(scene, cfg.n_neighbors)
    idx_of = {s: i for i, s in enumerate(rec)}

    depth_maps = np.zeros((len(rec), h, w), np.float32)
    valids = np.zeros((len(rec), h, w), bool)
    poses = scene.poses[rec].astype(np.float32)

    # Rect-engine degeneracy precheck (ADVICE r3): views whose EVERY
    # neighbor fails the rectification-geometry gate (near-forward motion)
    # would produce empty depth maps; route those views through the
    # warp-based plane sweep instead, and log partially-masked views.
    rect_fallback: set[int] = set()
    if cfg.method == "rect":
        from sfm_mvs_pipeline.mvs.rectified import rect_geometry_ok

        for i, s in enumerate(rec):
            nbrs_i = [idx_of[n] for n in neighbors.get(s, []) if n in idx_of]
            if not nbrs_i:
                continue
            geom_ok = rect_geometry_ok(poses[i], poses[nbrs_i])
            n_bad = int((~geom_ok).sum())
            if not geom_ok.any():
                rect_fallback.add(i)
                log(
                    f"view {s}: all {len(nbrs_i)} neighbors fail the "
                    "rectification geometry gate (near-forward baseline) — "
                    "falling back to plane sweep for this view"
                )
            elif n_bad:
                log(
                    f"view {s}: {n_bad}/{len(nbrs_i)} neighbors masked by "
                    "the rectification geometry gate"
                )

    import jax

    if len(jax.devices()) > 1:
        # per-view data parallelism over the device mesh (SURVEY.md §2.7 (4))
        from sfm_mvs_pipeline.parallel.mesh import make_mesh
        from sfm_mvs_pipeline.parallel.mvs import (
            compute_depth_maps_sharded,
            fixed_neighbor_table,
        )

        nbr_idx, nbr_valid = fixed_neighbor_table(
            neighbors, rec, cfg.n_neighbors
        )
        # rect_fallback views are recomputed on host below — zero their
        # neighbor rows so the device pass skips the wasted full depth map
        # (ADVICE r4)
        for i in rect_fallback:
            nbr_valid[i] = False
        planes_all = np.zeros((len(rec), cfg.n_planes), np.float32)
        for i, s in enumerate(rec):
            z_lo, z_hi = depth_range(scene, s)
            planes_all[i] = np.asarray(
                make_depth_planes(z_lo, z_hi, cfg.n_planes), np.float32
            )
        # static disparity bound sized to the actual geometry/resolution
        # (a hard-coded 256 truncates the near range at the 3200-px ladder)
        from sfm_mvs_pipeline.mvs.rectified import derive_max_disp

        md = 256
        for i in range(len(rec)):
            nb_i = nbr_idx[i][nbr_valid[i]]
            if len(nb_i):
                md = max(
                    md,
                    derive_max_disp(
                        poses[i], poses[nb_i], float(intr_pinhole[0]),
                        float(planes_all[i].min()), w,
                    ),
                )
        log(f"view-sharded depth estimation over {len(jax.devices())} devices"
            f" (max_disp {md})")
        depth_maps, valids = compute_depth_maps_sharded(
            make_mesh(), grays, poses, intr_pinhole.astype(np.float32),
            nbr_idx, nbr_valid, planes_all,
            window_radius=cfg.window_radius, use_sgm=cfg.use_sgm,
            sgm_p1=cfg.sgm_p1, sgm_p2=cfg.sgm_p2, max_cost=cfg.max_cost,
            method=cfg.method, pm_iterations=cfg.pm_iterations,
            pm_seed_rect=cfg.pm_seed_rect, max_disp=md,
        )
        for i, s in enumerate(rec):
            log(f"view {s}: {int(valids[i].sum())}/{h*w} valid px")
            if cfg.keep_artifacts:
                np.save(
                    os.path.join(out_dir, f"depth_{s:04d}.npy"), depth_maps[i]
                )
        # geometry-degenerate views are re-done with the sweep on host
        rec_loop = [(i, rec[i]) for i in sorted(rect_fallback)]
        if rec_loop:
            # sharded results arrive as read-only device views; the host
            # fallback loop below writes per-view rows
            depth_maps = np.array(depth_maps)
            valids = np.array(valids)
    else:
        rec_loop = list(enumerate(rec))

    for i, s in rec_loop:
        t_view = time.perf_counter()
        nbrs = [idx_of[n] for n in neighbors.get(s, []) if n in idx_of]
        if not nbrs:
            log(f"view {s}: no neighbors, skipped")
            continue
        z_lo, z_hi = depth_range(scene, s)
        if cfg.method == "patchmatch" and not cfg.use_sgm:
            from sfm_mvs_pipeline.mvs.patchmatch import patchmatch_depth

            # fixed neighbor capacity so every view shares one compiled fn
            cap = cfg.n_neighbors
            nb = (nbrs + [nbrs[0]] * cap)[:cap]
            nb_ok = np.zeros(cap, bool)
            nb_ok[: min(len(nbrs), cap)] = True

            seed_d = seed_v = None
            pm_iters = cfg.pm_iterations
            if cfg.pm_seed_rect:
                from sfm_mvs_pipeline.mvs.rectified import (
                    derive_max_disp,
                    rectified_depth,
                )

                seed_d, _sc, seed_v = rectified_depth(
                    jnp.asarray(grays[i]), jnp.asarray(grays[nb]),
                    jnp.asarray(poses[i]), jnp.asarray(poses[nb]),
                    jnp.asarray(intr_pinhole, jnp.float32),
                    jnp.float32(z_lo), jnp.float32(z_hi),
                    n_levels=cfg.n_planes, window_radius=cfg.window_radius,
                    max_cost=cfg.max_cost,
                    max_disp=derive_max_disp(
                        poses[i], poses[nb], float(intr_pinhole[0]),
                        float(z_lo), w,
                    ),
                    nbr_valid=jnp.asarray(nb_ok),
                )
                pm_iters = max(2, cfg.pm_iterations // 4)
            depth, cost, valid = patchmatch_depth(
                jnp.asarray(grays[i]), jnp.asarray(grays[nb]),
                jnp.asarray(poses[i]), jnp.asarray(poses[nb]),
                jnp.asarray(intr_pinhole, jnp.float32),
                jnp.float32(z_lo), jnp.float32(z_hi),
                # keyed by the view's index in `rec`, exactly like the
                # sharded path (parallel/mvs.py) — dense results are
                # reproducible across device counts
                jax.random.fold_in(jax.random.PRNGKey(0), i),
                init_depth=seed_d,
                init_valid=seed_v,
                iterations=pm_iters,
                window_radius=cfg.window_radius,
                max_cost=cfg.max_cost,
                nbr_valid=jnp.asarray(nb_ok),
            )
            depth_maps[i] = np.asarray(depth)
            valids[i] = np.asarray(valid)
            log(
                f"view {s}: depth range [{z_lo:.2f}, {z_hi:.2f}], "
                f"{int(valids[i].sum())}/{h*w} valid px, "
                f"{time.perf_counter() - t_view:.3f} s"
            )
            if cfg.keep_artifacts:
                np.save(
                    os.path.join(out_dir, f"depth_{s:04d}.npy"), depth_maps[i]
                )
            continue
        if cfg.method == "rect" and i not in rect_fallback:
            # --sgm composes with the rectified engine: 4-path aggregation
            # on the per-pair rectified disparity volume (its native
            # geometry), not on the gather-based sweep volume
            from sfm_mvs_pipeline.mvs.rectified import (
                derive_max_disp,
                rectified_depth,
            )

            cap = cfg.n_neighbors
            nb = (nbrs + [nbrs[0]] * cap)[:cap]
            nb_ok = np.zeros(cap, bool)
            nb_ok[: min(len(nbrs), cap)] = True
            md = derive_max_disp(
                poses[i], poses[nb], float(intr_pinhole[0]), float(z_lo), w
            )
            depth, cost, valid = rectified_depth(
                jnp.asarray(grays[i]), jnp.asarray(grays[nb]),
                jnp.asarray(poses[i]), jnp.asarray(poses[nb]),
                jnp.asarray(intr_pinhole, jnp.float32),
                jnp.float32(z_lo), jnp.float32(z_hi),
                n_levels=cfg.n_planes, window_radius=cfg.window_radius,
                max_cost=cfg.max_cost, max_disp=md,
                nbr_valid=jnp.asarray(nb_ok),
                use_sgm=cfg.use_sgm, sgm_p1=cfg.sgm_p1, sgm_p2=cfg.sgm_p2,
            )
            depth_maps[i] = np.asarray(depth)
            valids[i] = np.asarray(valid)
            log(
                f"view {s}: depth range [{z_lo:.2f}, {z_hi:.2f}], "
                f"{int(valids[i].sum())}/{h*w} valid px, "
                f"{time.perf_counter() - t_view:.3f} s"
            )
            if cfg.keep_artifacts:
                np.save(
                    os.path.join(out_dir, f"depth_{s:04d}.npy"), depth_maps[i]
                )
            continue
        planes = make_depth_planes(z_lo, z_hi, cfg.n_planes).astype(np.float32)
        cv = sweep_cost_volume(
            jnp.asarray(grays[i]),
            jnp.asarray(grays[nbrs]),
            jnp.asarray(poses[i]),
            jnp.asarray(poses[nbrs]),
            jnp.asarray(intr_pinhole, jnp.float32),
            jnp.asarray(planes),
            window_radius=cfg.window_radius,
        )
        if cfg.use_sgm:
            from sfm_mvs_pipeline.mvs.sgm import sgm_aggregate

            cv = sgm_aggregate(cv, cfg.sgm_p1, cfg.sgm_p2)
        depth, cost, valid = wta_depth(cv, jnp.asarray(planes), cfg.max_cost)
        depth_maps[i] = np.asarray(depth)
        valids[i] = np.asarray(valid)
        log(
            f"view {s}: depth range [{z_lo:.2f}, {z_hi:.2f}], "
            f"{int(valids[i].sum())}/{h*w} valid px, "
            f"{time.perf_counter() - t_view:.3f} s"
        )
        if cfg.keep_artifacts:
            np.save(os.path.join(out_dir, f"depth_{s:04d}.npy"), depth_maps[i])

    fused = fuse_depth_maps(
        depth_maps, valids, poses, intr_pinhole.astype(np.float32), rgbs,
        # can't demand more consistent views than exist (tiny scenes)
        min_views=min(cfg.min_fusion_views, len(rec)),
        rel_tolerance=cfg.fusion_tolerance,
        log=log,
    )
    log(f"fused dense cloud: {len(fused['points'])} points")
    write_ply_points(
        os.path.join(out_dir, "pointcloud_dense.ply"),
        fused["points"],
        fused["colors"],
        fused["normals"],
    )

    results = {"dense": fused, "depth_maps": depth_maps, "valids": valids}
    if cfg.mesh:
        from sfm_mvs_pipeline.mvs.mesh import mesh_from_depth_maps

        mesh = mesh_from_depth_maps(
            depth_maps, valids, poses, intr_pinhole.astype(np.float32), rgbs,
            decimate=cfg.decimate, log=log,
        )
        if cfg.refine_mesh and len(mesh["faces"]):
            # photometric refinement (openMVS RefineMesh stand-in,
            # ref: MVS.cpp:157-172)
            from sfm_mvs_pipeline.mvs.refine import refine_mesh_photometric

            mesh["vertices"] = refine_mesh_photometric(
                mesh["vertices"], mesh["faces"], poses,
                intr_pinhole.astype(np.float32), grays, log=log,
            )
        from sfm_mvs_pipeline.utils.ply import write_ply_mesh

        if cfg.texture and len(mesh["faces"]):
            # texture atlas + textured PLY (openMVS TextureMesh, gated by
            # --colored like the reference — PhotogrammetrieCli.cpp:228)
            from sfm_mvs_pipeline.mvs.texture import (
                build_texture_atlas,
                write_ply_mesh_textured,
            )

            tex = build_texture_atlas(
                mesh["vertices"], mesh["faces"], poses,
                intr_pinhole.astype(np.float32), rgbs,
            )
            write_ply_mesh_textured(
                os.path.join(out_dir, "mesh_dense.ply"),
                mesh["vertices"], mesh["faces"], tex["uv"], tex["atlas"],
                colors=mesh.get("colors"),
            )
            log(f"textured mesh: atlas {tex['atlas'].shape[0]}x"
                f"{tex['atlas'].shape[1]}")
            results["texture"] = tex
        else:
            write_ply_mesh(
                os.path.join(out_dir, "mesh_dense.ply"),
                mesh["vertices"],
                mesh["faces"],
                colors=mesh.get("colors"),
            )
        log(
            f"mesh: {len(mesh['vertices'])} vertices, {len(mesh['faces'])} faces"
        )
        results["mesh"] = mesh
    return results
