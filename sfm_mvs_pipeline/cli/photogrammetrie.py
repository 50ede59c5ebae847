"""The end-to-end photogrammetry driver CLI.

Parity with PhotogrammetrieCli (ref: src/cli/PhotogrammetrieCli.cpp:45-247):
workdir prep -> stats sampler -> scene build -> SfM -> artifacts/PLYs/stats
-> MVS (dense/mesh). Full reference flag set (PhotogrammetrieCli.cpp:422-460).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from sfm_mvs_pipeline.utils.args import AppArgs
from sfm_mvs_pipeline.utils import logger as logging

log = logging.AppLogger("PhotogrammetrieCli")


def print_usage() -> None:
    print(
        """photogrammetrie — sparse SfM + dense MVS reconstruction

  -Pimage=<dir|file>                 image directory (or repeated files)
  -Pout=<dir>                        working/output directory (default ./out)
  -Pcamera-model=simple|simple-radial|distortion   (default simple-radial)
  -Pfeature-detector=sift|orb        (default sift)
  -Pfeature-limit=N                  max features per image (default 10000,
                                     max 262144; 0 = unlimited, like the
                                     reference's cv::SIFT::create(0, ...))
  -Pfeature-matcher=bf|flann         (default bf; flann = approximate path)
  -Pmatch-precision=fast|exact       (default fast: bf16 operands with f32
                                     accumulation, exact on the integer
                                     SIFT and +-1 ORB descriptors the
                                     extractors emit; exact: f32 operands
                                     at full precision)
  -Pfeature-sequence=N               video window / grid neighborhood size
  -Pfeature-gridlength=N             grid row length (enables grid pairing)
  -Pmatch-threshold=N                min matches per pair (default 20)
  -Pbaseline-homography-threshold=N  min matches for baseline pair (default 100)
  -Phomography-inlier-ratio-threshold=X  (default 0.4)
  -Ppose-inlier-ratio-threshold=X    (default 0.4)
  -Pransac-matching-threshold=X      <0: -abs px, >0: fraction of max dim (default -3)
  -Pransac-baseline-threshold=X      (default -1)
  -Pransac-pose-threshold=X          (default -8)
  -Preprojection-error-threshold=X   (default 10)
  -Ppointcloud-point-merge-distance=X    (default 0.01)
  -Ppointcloud-feature-merge-distance=X  (default 20)
  -Pomp-feature-threads=N            (accepted for compat; batching replaces it)
  -Presume=<scene.npz>               skip SfM, resume from a scene checkpoint
  -Pprofile=<dir>                    capture a jax.profiler trace of the run
  --distinct-matches                 drop ambiguous (shared-target) matches
  --colored                          colorize the sparse cloud (+ texture the
                                     mesh, like the reference's TextureMesh)
  --dense                            run dense MVS
  --sgm                              use SGM instead of plane-sweep for depth
  -Pdense-method=rect|sweep|patchmatch   depth-map algorithm (default rect
                                     = rectified disparity sweep, shifts
                                     instead of per-plane gathers;
                                     sweep = joint plane-sweep volume;
                                     patchmatch = checkerboard PatchMatch,
                                     the reference's openMVS default)
  --mesh                             mesh the dense cloud
  --no-decimate                      skip mesh decimation
  --refine-mesh                      photometric mesh refinement (may also
                                     degrade the mesh, as the reference warns)
  --stats                            write statistics CSVs + resource samples
  --artifacts                        keep debug artifacts (matches, depth maps)
  --help"""
    )


def prepare_working_dir(path: str) -> None:
    """Wipe + recreate like the reference (PhotogrammetrieCli.cpp:399-402)."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


def main(args: AppArgs) -> int:
    if args.is_flag("help"):
        print_usage()
        return 0

    out_dir = args.get("out", "out")
    image_args = args.get_all("image")
    if not image_args and not args.get("resume"):
        log.error("no -Pimage given")
        print_usage()
        return 2

    # a resume checkpoint living INSIDE the output dir (the common case:
    # resume from the previous run's own scene.npz) must survive the
    # reference-semantics workdir wipe below — stash it first
    resume = args.get("resume")
    stash = None
    if resume and os.path.exists(resume):
        r_real = os.path.realpath(resume)
        out_real = os.path.realpath(out_dir)
        if r_real == out_real or r_real.startswith(out_real + os.sep):
            stash = tempfile.mkdtemp(prefix="sfm_resume_")
            for p in (resume, resume + ".json"):
                if os.path.exists(p):
                    shutil.copy2(p, stash)
            new_resume = os.path.join(stash, os.path.basename(resume))
            args.params["resume"] = [new_resume]

    prepare_working_dir(out_dir)

    sampler = None
    if args.is_flag("stats"):
        from sfm_mvs_pipeline.utils.stats import ResourceSampler

        sampler = ResourceSampler(os.path.join(out_dir, "app.stat.csv"))
        sampler.start()

    try:
        return _run(args, out_dir, image_args)
    finally:
        if sampler:
            sampler.stop()


def _run(args: AppArgs, out_dir: str, image_args: list) -> int:
    resume = args.get("resume")
    if resume:
        return _run_resumed(args, out_dir, resume)
    profile_dir = args.get("profile")
    if profile_dir:
        import jax

        jax.profiler.start_trace(profile_dir)
    try:
        return _run_inner(args, out_dir, image_args)
    finally:
        if profile_dir:
            import jax

            jax.profiler.stop_trace()
            log.info(f"profiler trace written to {profile_dir}")


def _run_inner(args: AppArgs, out_dir: str, image_args: list) -> int:
    import jax.numpy as jnp

    from sfm_mvs_pipeline.models.cameras import make_intrinsics
    from sfm_mvs_pipeline.models.scene import Scene
    from sfm_mvs_pipeline.ops.pairs import make_pairs
    from sfm_mvs_pipeline.sfm.ba import BAConfig
    from sfm_mvs_pipeline.sfm.incremental import SfMConfig, reconstruct
    from sfm_mvs_pipeline.utils.images import (
        colorize_points,
        list_images,
        load_gray_batch,
    )
    from sfm_mvs_pipeline.utils.ply import (
        write_camera_frustums_ply,
        write_ply_points,
    )
    from sfm_mvs_pipeline.utils.stats import write_reprojection_stats

    clock = [time.perf_counter()]

    def stage(name: str) -> None:
        # wall of the stage that just ended; device work inside it has been
        # fetched to the host by then, so the wall includes it
        now = time.perf_counter()
        log.info(f"stage wall {name}: {now - clock[0]:.3f} s")
        clock[0] = now

    # ---- enumerate images (dir or repeated files, sorted)
    paths = []
    for ia in image_args:
        if os.path.isdir(ia):
            paths.extend(list_images(ia))
        else:
            paths.append(ia)
    log.info(f"{len(paths)} input images")
    if len(paths) < 2:
        log.error("need at least two images")
        return 2

    imgs, (w, h) = load_gray_batch(paths)
    stage("load")

    # ---- feature extraction (reference-style aliases accepted:
    # SIFT/ORB, BF/FLANN, Simple/SimpleRadial/Distortion)
    detector = args.get("feature-detector", "sift").lower()
    # limit 0 means "unlimited" like cv::SIFT::create(0, ...) retaining all
    # features (ref: PhotogrammetrieCli.cpp:345, max 2^18 per :430)
    requested_limit = args.get_int("feature-limit", 10000)
    feature_limit = requested_limit
    if feature_limit <= 0:
        feature_limit = 1 << 18
    feature_limit = min(feature_limit, 1 << 18)
    # warn only when an EXPLICIT finite user limit is reduced (the flag was
    # actually passed); the default 10000 and 0 = unlimited reduce silently —
    # the area-driven capacity IS the meaning of "all features" there
    # (ADVICE r4: get_int alone cannot distinguish the default from a
    # user-passed 10000)
    explicit = args.get("feature-limit") is not None
    warn_req = requested_limit if (explicit and requested_limit > 0) else None
    log.info(f"extracting {detector} features (limit {feature_limit})")
    if detector == "sift":
        feats = extract_sift(imgs, _feature_cap(feature_limit, w, h, warn_req))
        descs = np.asarray(feats["descriptors"])
    elif detector == "orb":
        from sfm_mvs_pipeline.ops.orb import orb_features
        from sfm_mvs_pipeline.ops.matching import expand_binary_descriptors

        feats = orb_features(
            jnp.asarray(imgs), max_features=_feature_cap(feature_limit, w, h, warn_req)
        )
        descs = np.asarray(expand_binary_descriptors(feats["descriptors"]))
    else:
        log.error(f"unknown feature detector: {detector}")
        return 2
    kps = np.asarray(feats["keypoints"])
    valid = np.asarray(feats["valid"])
    log.info(f"features per image: {[int(v.sum()) for v in valid]}")
    stage("features")

    # ---- scene + camera model
    camera_model = _normalize_camera_model(
        args.get("camera-model", "simple-radial")
    )
    intr = np.asarray(make_intrinsics(w, h), np.float64)
    scene = Scene.create(
        paths, (w, h), kps, descs, valid, intr, camera_model=camera_model
    )

    # ---- pair policy (ref strategy selection PhotogrammetrieCli.cpp:320-340)
    grid_len = args.get_int("feature-gridlength", 0)
    seq = args.get_int("feature-sequence", 0)
    if grid_len > 0:
        pairs = make_pairs("grid", scene.n_shots, max(seq, 2), grid_len)
        log.info(f"grid pairing: {len(pairs)} pairs")
    elif seq > 0:
        pairs = make_pairs("video", scene.n_shots, seq)
        log.info(f"sequence pairing: {len(pairs)} pairs")
    else:
        pairs = make_pairs("unordered", scene.n_shots)
        log.info(f"unordered pairing: {len(pairs)} pairs")

    # ---- SfM
    cfg = SfMConfig(
        min_match_count=args.get_int("match-threshold", 20),
        baseline_min_matches=args.get_int("baseline-homography-threshold", 100),
        min_homography_inlier_ratio=args.get_float(
            "homography-inlier-ratio-threshold", 0.4
        ),
        min_pose_inlier_ratio=args.get_float("pose-inlier-ratio-threshold", 0.4),
        ransac_matching_threshold=args.get_float("ransac-matching-threshold", -3.0),
        ransac_baseline_threshold=args.get_float("ransac-baseline-threshold", -1.0),
        ransac_pose_threshold=args.get_float("ransac-pose-threshold", -8.0),
        max_reprojection_error=args.get_float("reprojection-error-threshold", 10.0),
        point_merge_distance=args.get_float("pointcloud-point-merge-distance", 0.01),
        feature_merge_distance=args.get_float(
            "pointcloud-feature-merge-distance", 20.0
        ),
        distinct_matches=args.is_flag("distinct-matches"),
        matcher_method=(
            "flann" if args.get("feature-matcher", "bf").lower() == "flann" else "bf"
        ),
        exact_match=_match_precision(args) == "exact",
        binary_descriptors=(detector == "orb"),
        ba=BAConfig(),
    )
    sfm_log = logging.AppLogger("SfM")
    stats = reconstruct(scene, pairs, cfg, log=sfm_log.info)
    log.info(f"SfM done: {stats}")
    stage("sfm")
    if stats.get("baseline") is None:
        log.error("reconstruction failed: no baseline pair")
        return 1

    # ---- outputs (ref: runSfM artifact block PhotogrammetrieCli.cpp:113-137)
    if args.is_flag("colored"):
        colorize_points(scene)
    live = scene.point_valid
    write_ply_points(
        os.path.join(out_dir, "pointcloud_sparse.ply"),
        scene.points[live],
        scene.colors[live] if args.is_flag("colored") else None,
    )
    rec = scene.recovered
    write_camera_frustums_ply(
        os.path.join(out_dir, "cameras_recovered.ply"),
        scene.poses[rec],
        scene.intrinsics[0],
        (w, h),
    )
    if args.is_flag("stats"):
        st = write_reprojection_stats(scene, out_dir)
        log.info(f"reprojection error: mean {st['mean']:.3f} median {st['median']:.3f}")
    if args.is_flag("artifacts"):
        _write_artifacts(scene, out_dir)
    # durable scene checkpoint (the reference's re-runnable mvs.bin handoff,
    # kept unconditionally since it is cheap and enables -Presume=)
    from sfm_mvs_pipeline.utils.checkpoint import save_scene

    save_scene(scene, os.path.join(out_dir, "scene.npz"))
    stage("outputs")

    # ---- dense MVS
    if args.is_flag("dense"):
        from sfm_mvs_pipeline.mvs.pipeline import MVSConfig, run_mvs

        mvs_cfg = MVSConfig(
            use_sgm=args.is_flag("sgm"),
            method=_dense_method(args),
            mesh=args.is_flag("mesh"),
            decimate=not args.is_flag("no-decimate"),
            refine_mesh=args.is_flag("refine-mesh"),
            texture=args.is_flag("colored"),
            keep_artifacts=args.is_flag("artifacts"),
        )
        run_mvs(scene, out_dir, mvs_cfg, log=logging.AppLogger("MVS").info)
        stage("dense")

    log.info("done")
    return 0


def extract_sift(imgs: np.ndarray, cap_env: int) -> dict:
    """SIFT features of a (B, H, W) batch at adaptive capacity: start at
    2048 slots and escalate x4 only on saturation, up to `cap_env` —
    top-k/padded-slot work scales with CAPACITY, not detections."""
    import jax.numpy as jnp

    from sfm_mvs_pipeline.ops.sift import sift_features

    cap = min(cap_env, 2048)
    imgs_d = jnp.asarray(imgs)  # upload once, not per escalation
    while True:
        feats = sift_features(
            imgs_d,
            max_features=cap,
            contrast_threshold=0.09,  # ref: cv::SIFT::create(..., 0.09)
        )
        detected = int(np.asarray(feats["valid"]).sum(axis=1).max())
        if detected < cap or cap >= cap_env:
            return feats
        cap = min(cap * 4, cap_env)
        log.info(
            f"feature capacity saturated ({detected}); escalating to {cap}"
        )


def _feature_cap(
    limit: int, w: int, h: int, warn_requested: int | None = None
) -> int:
    """Static feature capacity: next power of two covering the limit,
    bounded by the image area and the reference's 2^18 flag maximum
    (PhotogrammetrieCli.cpp:430) — AREA-driven, not fault-driven.

    Area bound: real images detect well under W*H/32 surviving DoG extrema
    even on dense texture (cv2.SIFT on insel at the reference's contrast
    0.09: ~330 of 291k px = 0.1%; a pure-noise 3200x1800 synthetic — the
    adversarial max — saturates 32768 = 0.6%), so an "unlimited" limit
    does not inflate the padded compute. (No lower hardware cap applies:
    the shift-add Gaussian blur in ops/sift.py avoids the conv layout that
    padded intermediates up to 128x.)

    Logs a warning whenever the user's requested limit is reduced."""
    bound = min(limit, 1 << 18, max(w * h // 32, 256))
    cap = 256
    while cap < bound:
        cap *= 2
    if warn_requested is not None and cap < warn_requested:
        logging.AppLogger("Photogrammetrie").warn(
            f"feature-limit {warn_requested} reduced to capacity {cap} "
            f"(image area {w}x{h} bounds detectable extrema)"
        )
    return cap


def _match_precision(args: AppArgs) -> str:
    """Validated -Pmatch-precision= (fast = bf16 operands with f32
    accumulation, the default; exact = f32 operands at full precision)."""
    mode = args.get("match-precision", "fast").lower()
    if mode not in ("fast", "exact"):
        raise ValueError(
            f"unknown -Pmatch-precision={mode} (expected fast|exact)"
        )
    return mode


def _dense_method(args: AppArgs) -> str:
    """Validated -Pdense-method= (reject typos instead of silently falling
    back to a default)."""
    method = args.get("dense-method", "rect").lower()
    if method not in ("rect", "sweep", "patchmatch"):
        raise ValueError(
            f"unknown -Pdense-method={method} (expected rect|sweep|patchmatch)"
        )
    return method


def _write_artifacts(scene, out_dir: str) -> None:
    """Debug artifacts mirroring the reference (PhotogrammetrieCli.cpp:139-219):
    keypoint overlay PNGs per shot, match-line PNGs per recovered pair
    (derived from the observation table), undistorted images, scene.txt."""
    from sfm_mvs_pipeline.utils.images import (
        draw_circles,
        draw_lines,
        load_rgb,
        write_png,
    )

    art = os.path.join(out_dir, "artifacts")
    os.makedirs(art, exist_ok=True)
    rgbs = {}
    for s in range(scene.n_shots):
        rgb = load_rgb(scene.image_paths[s], scene.image_size)
        rgbs[s] = rgb
        img = rgb.copy()
        draw_circles(img, scene.keypoints[s][scene.feat_valid[s]], (0, 255, 0))
        write_png(os.path.join(art, f"keypoints_{s:04d}.png"), img)

    # match images for shot pairs sharing tracked points
    live = scene.obs_w > 0
    by_point = {}
    for o in np.nonzero(live)[0]:
        by_point.setdefault(int(scene.obs_point[o]), []).append(o)
    pair_lines = {}
    for obs_list in by_point.values():
        for i in range(len(obs_list)):
            for j in range(i + 1, len(obs_list)):
                a, b = int(scene.obs_shot[obs_list[i]]), int(scene.obs_shot[obs_list[j]])
                if a == b:
                    continue
                if a > b:
                    a, b = b, a
                    oi, oj = obs_list[j], obs_list[i]
                else:
                    oi, oj = obs_list[i], obs_list[j]
                pair_lines.setdefault((a, b), []).append(
                    (scene.obs_uv[oi], scene.obs_uv[oj])
                )
    w, h = scene.image_size
    for (a, b), lines in pair_lines.items():
        if len(lines) < 10:
            continue
        canvas = np.concatenate([rgbs[a], rgbs[b]], axis=1)
        seg = np.asarray(lines[:500], np.float64)  # (N, 2 ends, 2)
        draw_lines(canvas, seg[:, 0], seg[:, 1] + [w, 0], (255, 200, 0))
        write_png(os.path.join(art, f"matches_{a:04d}_{b:04d}.png"), canvas)

    # undistorted images (ref: OpenMvsUtils.cpp:136-150 writes these too)
    from sfm_mvs_pipeline.mvs.pipeline import _undistort_image

    for s in range(scene.n_shots):
        und = _undistort_image(rgbs[s], scene.intrinsics[scene.cam_of_shot[s]])
        write_png(
            os.path.join(art, f"undistorted_{s:04d}.png"),
            np.clip(und, 0, 255).astype(np.uint8),
        )

    with open(os.path.join(out_dir, "scene.txt"), "w") as f:
        f.write(f"shots: {scene.n_shots}\n")
        f.write(f"points: {scene.n_points}\n")
        f.write(f"observations: {scene.n_obs}\n")
        f.write(f"intrinsics: {scene.intrinsics.tolist()}\n")
        for s in range(scene.n_shots):
            f.write(
                f"shot {s}: {scene.image_paths[s]} recovered={bool(scene.recovered[s])} "
                f"pose={scene.poses[s].round(6).tolist()}\n"
            )


def _run_resumed(args: AppArgs, out_dir: str, resume_path: str) -> int:
    """Resume from a scene checkpoint: re-run exports and/or dense MVS
    without repeating SfM (reference mvs.bin parity)."""
    from sfm_mvs_pipeline.utils.checkpoint import load_scene
    from sfm_mvs_pipeline.utils.images import colorize_points
    from sfm_mvs_pipeline.utils.ply import (
        write_camera_frustums_ply,
        write_ply_points,
    )

    scene = load_scene(resume_path)
    log.info(
        f"resumed scene: {scene.n_shots} shots, {scene.n_points} points, "
        f"{scene.n_obs} observations"
    )
    if args.is_flag("colored"):
        colorize_points(scene)
    # re-save the checkpoint into the (wiped) workdir so resumed runs keep
    # the same artifact contract as full runs and can themselves be resumed
    from sfm_mvs_pipeline.utils.checkpoint import save_scene

    save_scene(scene, os.path.join(out_dir, "scene.npz"))
    live = scene.point_valid
    write_ply_points(
        os.path.join(out_dir, "pointcloud_sparse.ply"),
        scene.points[live],
        scene.colors[live] if args.is_flag("colored") else None,
    )
    write_camera_frustums_ply(
        os.path.join(out_dir, "cameras_recovered.ply"),
        scene.poses[scene.recovered],
        scene.intrinsics[0],
        scene.image_size,
    )
    if args.is_flag("dense"):
        from sfm_mvs_pipeline.mvs.pipeline import MVSConfig, run_mvs

        mvs_cfg = MVSConfig(
            use_sgm=args.is_flag("sgm"),
            method=_dense_method(args),
            mesh=args.is_flag("mesh"),
            decimate=not args.is_flag("no-decimate"),
            refine_mesh=args.is_flag("refine-mesh"),
            texture=args.is_flag("colored"),
            keep_artifacts=args.is_flag("artifacts"),
        )
        run_mvs(scene, out_dir, mvs_cfg, log=logging.AppLogger("MVS").info)
    log.info("done")
    return 0


_CAMERA_ALIASES = {
    "simple": "simple", "simpleradial": "simple-radial",
    "simple-radial": "simple-radial", "distortion": "distortion",
    "fixed": "fixed",
}


def _normalize_camera_model(name: str) -> str:
    """Accept the reference run-script spellings (SimpleRadial, Simple,
    Distortion; ref: run-scripts/run-grid-flann.sh)."""
    key = name.replace("_", "").replace("-", "").lower()
    key2 = name.lower()
    if key2 in _CAMERA_ALIASES:
        return _CAMERA_ALIASES[key2]
    if key in _CAMERA_ALIASES:
        return _CAMERA_ALIASES[key]
    if key == "simpleradial":
        return "simple-radial"
    raise ValueError(f"unknown camera model: {name}")
