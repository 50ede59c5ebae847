"""Bundle adjustment: Levenberg-Marquardt with Schur complement on the device.

Replaces the reference's Ceres setup (one AutoDiff residual block per
(3D point, observation) with parameter blocks point[3] / pose[6] /
camera-intrinsics[1|3|7], solved by LM + DENSE_SCHUR, 5000 iters, eta 0.01;
ref: src/photogrammetrie/common/BundleAdjustment.cpp:50-93,
src/photogrammetrie/util/CeresUtils.cpp:43-50).

Design
------
Residuals: r_i = project(pose[shot_i], intr[cam_i], X[point_i]) - uv_i,
batched over all O observations; per-observation Jacobians via one vmapped
jax.jacfwd over the packed 16-vector (point 3 | pose 6 | intr 7) — the exact
analogue of Ceres autodiff, but computed for every observation in parallel.

Normal equations with points eliminated (Schur):
  Hpp  (P, 3, 3)  block diagonal     — segment_sum of Jp^T Jp
  Hcc  dense (D, D), D = 6*S + 7*C   — pose blocks + shared-intrinsics blocks
  Schur correction  sum_p U_p^T Bp U_p, with U_p (3, D) the point-p row of
  Hpc assembled DENSELY per point from a padded track table, chunk-scanned
  over points so the work is pure einsum/matmul (no scatters) and
  memory stays bounded. Bp = (Hpp_p + lambda diag)^-1 via closed-form 3x3.

The reduced camera system (D x D, D small: S<=hundreds) is solved on the
HOST in float64 — device f32 everywhere else; this mirrors how the
reference funnels everything into a small dense camera solve.

Intrinsics sharing: shots reference a camera via cam_of_shot (the reference
shares ONE camera across all shots; PhotogrammetrieCli.cpp:288-299), and the
per-model optimization mask (models/cameras.py) zeroes the columns BA may
not touch, including a full freeze for never-observed parameters.

Gauge freedom (global similarity) is left to LM damping, exactly like the
reference's Ceres configuration (no fixed blocks there either).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sfm_mvs_pipeline.models.cameras import reprojection_residuals

CHUNK = 4096  # points per Schur-assembly chunk (table-based paths)
# shot-axis buckets (static jit dim): ~1.4x steps keep the padded camera
# system small while amortizing compiles across many incremental BA calls
_SHOT_BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _shot_bucket(n: int) -> int:
    for b in _SHOT_BUCKETS:
        if n <= b:
            return b
    b = _SHOT_BUCKETS[-1]
    while b < n:
        b *= 2
    return b
# dense (P, S) grid eligibility: ~16M slots keeps the (P, S, 2, 16) Jacobian
# tensor near 4 GB peak in f32
DENSE_GRID_MAX_SLOTS = 16 * 1024 * 1024


@dataclasses.dataclass
class BAConfig:
    max_iterations: int = 50
    # relative cost-decrease stop, the moral analogue of Ceres eta/func-tol
    function_tolerance: float = 1e-6
    init_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    # "device": the whole LM loop runs as ONE lax.while_loop program with an
    #   equilibrated on-device Cholesky of the reduced camera system — zero
    #   host round trips per iteration.
    # "host": one build per iteration with the reduced solve on the host in
    #   float64 (the conservative fallback; also the oracle the device path
    #   is tested against).
    solver: str = "device"


def build_track_table(
    obs_point: np.ndarray, obs_weight: np.ndarray, n_points: int, cap: int = 64
) -> np.ndarray:
    """Host-side: (P, L) table of observation indices per point (pad = -1).

    L = max live track length (rounded up to a multiple of 4, capped).
    Replaces the reference's per-point Origin lists (Scene.h:242-270) with a
    fixed-capacity index table the device can gather from.
    """
    counts = np.zeros(n_points, dtype=np.int64)
    live = obs_weight > 0
    np.add.at(counts, obs_point[live], 1)
    # bucket L to powers of two so recompiles are amortized across BA calls
    need = int(counts.max()) if len(counts) else 0
    L = 4
    while L < min(need, cap):
        L *= 2
    L = int(min(L, cap))
    table = np.full((n_points, L), -1, dtype=np.int32)
    live_idx = np.nonzero(live)[0]
    pts = obs_point[live_idx]
    order = np.argsort(pts, kind="stable")
    pts_sorted = pts[order]
    idx_sorted = live_idx[order]
    # within-group rank via group-start offsets (vectorized cumcount)
    group_start = np.searchsorted(pts_sorted, pts_sorted, side="left")
    rank = np.arange(len(pts_sorted)) - group_start
    keep = rank < L
    table[pts_sorted[keep], rank[keep]] = idx_sorted[keep]
    return table


def build_shot_table(
    obs_point: np.ndarray,
    obs_shot: np.ndarray,
    obs_weight: np.ndarray,
    n_points: int,
    n_shots: int,
) -> np.ndarray | None:
    """Host-side: (P, S) table of the observation index of point p in shot s
    (pad = -1), or None if some (point, shot) has more than one live
    observation (possible after track merges — then the caller falls back to
    the (P, L) track table).

    This is the key to the fast Schur assembly: with at most one observation
    per (point, shot), the per-point camera row U_p is a pure GATHER
    Wc[tab[p]] laid out along the shot axis — no one-hot contraction over
    track slots, and the Schur correction collapses to one large matmul.
    """
    live = np.nonzero(obs_weight > 0)[0]
    key = obs_point[live].astype(np.int64) * n_shots + obs_shot[live]
    uniq, first = np.unique(key, return_index=True)
    if len(uniq) != len(key):
        return None
    table = np.full((n_points, n_shots), -1, dtype=np.int32)
    table[uniq // n_shots, uniq % n_shots] = live[first]
    return table


def pack_dense_obs(
    obs_point: np.ndarray,
    obs_shot: np.ndarray,
    obs_uv: np.ndarray,
    obs_w: np.ndarray,
    n_points: int,
    n_shots: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Host-side: repack the observation list as a dense (P, S) visibility
    grid — uv_ps (P, S, 2) and weights w_ps (P, S) (0 = not observed).

    Returns None when some (point, shot) has more than one live observation
    (possible after track merges; the caller falls back to the track table).

    This layout is what makes the BA build gather-free: every tensor
    indexes points/shots BY POSITION, so the whole Schur assembly lowers to
    dense broadcast math + one big matmul, with zero dynamic-gather ops.
    """
    live = np.nonzero(obs_w > 0)[0]
    key = obs_point[live].astype(np.int64) * n_shots + obs_shot[live]
    uniq, first = np.unique(key, return_index=True)
    if len(uniq) != len(key):
        return None
    uv_ps = np.zeros((n_points, n_shots, 2), obs_uv.dtype)
    w_ps = np.zeros((n_points, n_shots), obs_w.dtype)
    rows = uniq // n_shots
    cols = uniq % n_shots
    uv_ps[rows, cols] = obs_uv[live[first]]
    w_ps[rows, cols] = obs_w[live[first]]
    return uv_ps, w_ps


def _pack_params(points, poses, intr):
    return points, poses, intr


@partial(jax.jit, static_argnames=())
def compute_residuals(
    points, poses, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w
):
    """Weighted residual vector (O, 2) and total cost (0.5 * sum r^2)."""
    X = points[obs_point]
    pose = poses[obs_shot]
    K = intr[cam_of_shot[obs_shot]]
    r = jax.vmap(lambda p, k, x, uv: reprojection_residuals(p, k, x[None], uv[None])[0])(
        pose, K, X, obs_uv
    )
    r = r * obs_w[:, None]
    cost = 0.5 * jnp.sum(r * r)
    return r, cost


def _obs_jacobians(points, poses, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w):
    """Per-obs Jacobians: Jp (O,2,3), Jc (O,2,6), Ji (O,2,7), r (O,2)."""

    def res_one(x, pose, k, uv, w):
        return reprojection_residuals(pose, k, x[None], uv[None])[0] * w

    def packed(z, uv, w):
        return res_one(z[:3], z[3:9], z[9:16], uv, w)

    X = points[obs_point]
    pose = poses[obs_shot]
    K = intr[cam_of_shot[obs_shot]]
    z = jnp.concatenate([X, pose, K], axis=1)  # (O, 16)
    r = jax.vmap(packed)(z, obs_uv, obs_w)
    # jacfwd, not jacrev: reverse mode would need only 2 VJPs for this
    # 16 -> 2 map, but its transposed graph is a scatter/gather graph
    J = jax.vmap(jax.jacfwd(packed))(z, obs_uv, obs_w)  # (O, 2, 16)
    return J[:, :, :3], J[:, :, 3:9], J[:, :, 9:16], r


def _inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate/det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], axis=-1),
            jnp.stack([D, E, F], axis=-1),
            jnp.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def ba_build_core(
    points,
    poses,
    intr,
    cam_of_shot,
    obs_point,
    obs_shot,
    obs_uv,
    obs_w,
    track_tab,  # (P, L) int32 track table OR (P, S) shot table, -1 pad, LOCAL obs indices
    lam,
    intr_mask,  # (C, 7) f32 — per-camera optimizable-intrinsics mask
    pose_free,  # (S,) f32 — 1 where the shot pose is optimized
    n_shots: int,
    n_cams: int,
    axis_name: str | None = None,
    table_kind: str = "track",
):
    """Assemble the Schur-reduced camera system (single-shard body).

    Returns (S_red (D, D), rhs_red (D,), Bp (P,3,3), gp (P,3), cost) where
    D = 6*n_shots + 7*n_cams and the reduced system is
       S_red @ dcam = rhs_red      (note: rhs already includes the -g sign)

    When `axis_name` is given the function runs inside shard_map with
    observations AND points sharded (observations grouped by point so the
    track table is shard-local); the camera system, rhs and cost are
    psum-reduced over the axis while Bp/gp stay shard-local. This is the
    distributed DENSE_SCHUR of SURVEY.md §2.7: points model-parallel, the
    reduced camera Hessian all-reduced over ICI.
    """
    P = points.shape[0]
    D = 6 * n_shots + 7 * n_cams

    Jp, Jc, Ji, r = _obs_jacobians(
        points, poses, intr, cam_of_shot, obs_point, obs_shot, obs_uv, obs_w
    )
    # apply masks: frozen intrinsics columns & frozen poses
    obs_cam = cam_of_shot[obs_shot]
    Ji = Ji * intr_mask[obs_cam][:, None, :]
    Jc = Jc * pose_free[obs_shot][:, None, None]

    cost = 0.5 * jnp.sum(r * r)

    # ---- camera diagonal blocks (exact, all observations)
    # segment-sum-by-shot/cam as ONE-HOT MATMULS: the reduction over O
    # observations is a matrix product instead of scatter-adds.
    dt = points.dtype
    O = obs_shot.shape[0]
    oh_s = (obs_shot[:, None] == jnp.arange(n_shots)[None, :]).astype(dt)  # (O, S)
    oh_c = (obs_cam[:, None] == jnp.arange(n_cams)[None, :]).astype(dt)  # (O, C)
    flat_s = jnp.concatenate(
        [
            jnp.einsum("oai,oaj->oij", Jc, Jc).reshape(O, 36),
            jnp.einsum("oai,oaj->oij", Jc, Ji).reshape(O, 42),
            jnp.einsum("oai,oa->oi", Jc, r),
        ],
        axis=1,
    )  # (O, 84)
    red_s = jnp.einsum("os,ok->sk", oh_s, flat_s)  # (S, 84)
    Hcc_pose = red_s[:, :36].reshape(n_shots, 6, 6)
    Hcc_cross = red_s[:, 36:78].reshape(n_shots, 6, 7)
    gc = red_s[:, 78:84]
    flat_c = jnp.concatenate(
        [
            jnp.einsum("oai,oaj->oij", Ji, Ji).reshape(O, 49),
            jnp.einsum("oai,oa->oi", Ji, r),
        ],
        axis=1,
    )  # (O, 56)
    red_c = jnp.einsum("oc,ok->ck", oh_c, flat_c)
    Hcc_intr = red_c[:, :49].reshape(n_cams, 7, 7)
    gi = red_c[:, 49:56]

    # dense Hcc assembled from block tables with single scatters + reshapes
    s_idx = jnp.arange(n_shots)
    pp = (
        jnp.zeros((n_shots, 6, n_shots, 6), dtype=points.dtype)
        .at[s_idx, :, s_idx, :]
        .set(Hcc_pose)
        .reshape(6 * n_shots, 6 * n_shots)
    )
    c_idx = jnp.arange(n_cams)
    ii = (
        jnp.zeros((n_cams, 7, n_cams, 7), dtype=points.dtype)
        .at[c_idx, :, c_idx, :]
        .set(Hcc_intr)
        .reshape(7 * n_cams, 7 * n_cams)
    )
    pi = (
        jnp.zeros((n_shots, 6, n_cams, 7), dtype=points.dtype)
        .at[s_idx, :, cam_of_shot, :]
        .set(Hcc_cross)
        .reshape(6 * n_shots, 7 * n_cams)
    )
    Hcc = jnp.block([[pp, pi], [pi.T, ii]])

    g_full = jnp.concatenate([gc.reshape(-1), gi.reshape(-1)])

    # ---- point blocks + Schur correction, chunk-scanned over points
    # All point-side reductions (Hpp, gp) use TABLE GATHERS rather than
    # segment_sum scatters.
    #
    # Two table layouts:
    #  * "shot" (P, S): at most one observation per (point, shot) — the per-
    #    point camera row U_p is a pure gather laid out along the shot axis
    #    and the Schur correction is one big (3P, D)^T (3P, D) matmul.
    #    ~4x faster than the track path (no one-hot contraction over slots).
    #  * "track" (P, L): the general fallback (duplicate (point, shot)
    #    observations possible after merges); U_p is assembled with one-hot
    #    matmuls over the L slots. Exactness requires L to cover every live
    #    observation of a point (build_track_table caps at 64).
    Wc = jnp.einsum("oai,oaj->oij", Jp, Jc)  # (O, 3, 6)
    Wi = jnp.einsum("oai,oaj->oij", Jp, Ji)  # (O, 3, 7)

    Pp = track_tab.shape[0]
    slots = track_tab.shape[1]
    # memory-adaptive chunk: bound the gathered (CH, slots, 3, 7) and dense
    # (CH, 3, D) intermediates to ~32M f32 elements
    budget = 32 * 1024 * 1024
    per_point = max(slots * 27, 6 * D)
    ch = 1024
    while ch * 2 <= Pp and (ch * 2) * per_point <= budget:
        ch *= 2
    n_chunks = (Pp + ch - 1) // ch
    pad = n_chunks * ch - Pp
    tab = jnp.concatenate(
        [track_tab, jnp.full((pad, slots), -1, jnp.int32)], axis=0
    ).reshape(n_chunks, ch, slots)

    if table_kind == "shot":
        oh_cam = jax.nn.one_hot(cam_of_shot, n_cams, dtype=dt)  # (S, C)

    def chunk_body(carry, tab_c):
        S_acc, rhs_acc = carry
        validL = tab_c >= 0
        safe = jnp.where(validL, tab_c, 0)
        wL = validL.astype(dt)
        Jp_t = Jp[safe] * wL[..., None, None]  # (CH, slots, 2, 3)
        r_t = r[safe] * wL[..., None]  # (CH, slots, 2)
        Hpp_c = jnp.einsum("plai,plaj->pij", Jp_t, Jp_t)  # (CH, 3, 3)
        gp_c = jnp.einsum("plai,pla->pi", Jp_t, r_t)  # (CH, 3)
        damped = Hpp_c + lam * _diag_embed(
            jnp.maximum(
                jnp.stack([Hpp_c[:, 0, 0], Hpp_c[:, 1, 1], Hpp_c[:, 2, 2]], axis=-1),
                1e-8,
            )
        )
        Bp_c = _inv3x3(damped)

        Wc_t = Wc[safe] * wL[..., None, None]  # (CH, slots, 3, 6)
        Wi_t = Wi[safe] * wL[..., None, None]  # (CH, slots, 3, 7)

        if table_kind == "shot":
            # slots == n_shots: U_pose is just a transpose of the gather
            U_pose = jnp.transpose(Wc_t, (0, 2, 1, 3)).reshape(
                -1, 3, n_shots * 6
            )
            U_intr = jnp.einsum("psij,sc->picj", Wi_t, oh_cam).reshape(
                -1, 3, n_cams * 7
            )
        else:
            s_t = obs_shot[safe]
            c_t = obs_cam[safe]
            # dense per-point camera row U (CH, 3, D) via one-hot placement
            oh_s2 = jax.nn.one_hot(s_t, n_shots, dtype=dt)  # (CH, L, S)
            oh_c2 = jax.nn.one_hot(c_t, n_cams, dtype=dt)
            U_pose = jnp.einsum("plij,pls->pisj", Wc_t, oh_s2).reshape(
                -1, 3, n_shots * 6
            )
            U_intr = jnp.einsum("plij,plc->picj", Wi_t, oh_c2).reshape(
                -1, 3, n_cams * 7
            )
        U = jnp.concatenate([U_pose, U_intr], axis=-1)  # (CH, 3, D)

        BU = jnp.einsum("pab,pbd->pad", Bp_c, U)  # (CH, 3, D)
        # one tall-skinny matmul: (D, 3CH) @ (3CH, D)
        S_corr = jnp.einsum("pad,pae->de", U, BU)  # (D, D)
        rhs_corr = jnp.einsum(
            "pad,pa->d", U, jnp.einsum("pab,pb->pa", Bp_c, gp_c)
        )
        return (S_acc + S_corr, rhs_acc + rhs_corr), (Bp_c, gp_c)

    init = (jnp.zeros((D, D), dt), jnp.zeros((D,), dt))
    if axis_name is not None:
        # under shard_map the carry becomes device-varying; mark the init so
        init = jax.lax.pcast(init, axis_name, to="varying")
    (S_corr, rhs_corr), (Bp_all, gp_all) = jax.lax.scan(chunk_body, init, tab)
    Bp = Bp_all.reshape(-1, 3, 3)[:P]
    gp = gp_all.reshape(-1, 3)[:P]

    if axis_name is not None:
        # distributed reduction of the camera system over the mesh axis
        Hcc = jax.lax.psum(Hcc, axis_name)
        g_full = jax.lax.psum(g_full, axis_name)
        S_corr = jax.lax.psum(S_corr, axis_name)
        rhs_corr = jax.lax.psum(rhs_corr, axis_name)
        cost = jax.lax.psum(cost, axis_name)

    # LM damping on the (globally reduced) camera diagonal
    diagH = jnp.diagonal(Hcc)
    Hcc = Hcc + jnp.diag(lam * jnp.maximum(diagH, 1e-8))

    S_red = Hcc - S_corr
    rhs_red = -g_full + rhs_corr
    return S_red, rhs_red, Bp, gp, cost, Wc, Wi


ba_build_reduced = partial(
    jax.jit, static_argnames=("n_shots", "n_cams", "axis_name", "table_kind")
)(ba_build_core)


def _diag_embed(d):
    """(..., 3) -> (..., 3, 3) diagonal."""
    return jnp.einsum("...i,ij->...ij", d, jnp.eye(d.shape[-1], dtype=d.dtype))


@partial(jax.jit, static_argnames=("n_shots", "n_cams", "table_kind"))
def ba_backsub_points(
    dcam, Bp, gp, Wc, Wi, track_tab, obs_shot, obs_cam,
    n_shots: int, n_cams: int, table_kind: str = "track",
):
    """Back-substitute the point update: dX_p = -Bp (gp + Hpc_p dcam)."""
    dpose = dcam[: 6 * n_shots].reshape(n_shots, 6)
    dintr = dcam[6 * n_shots:].reshape(n_cams, 7)
    validL = track_tab >= 0
    safe = jnp.where(validL, track_tab, 0)
    w = validL.astype(Bp.dtype)
    if table_kind == "shot":
        # slot axis IS the shot axis: no per-observation index gathers.
        # In this mode the obs_cam argument must be cam_of_shot (S,).
        contrib = (
            jnp.einsum("psij,sj->psi", Wc[safe], dpose)
            + jnp.einsum("psij,sj->psi", Wi[safe], dintr[obs_cam])
        ) * w[..., None]
    else:
        # sum_i Wc_i dpose_{s_i} + Wi_i dintr_{c_i}  per point
        contrib = (
            jnp.einsum("plij,plj->pli", Wc[safe], dpose[obs_shot[safe]])
            + jnp.einsum("plij,plj->pli", Wi[safe], dintr[obs_cam[safe]])
        ) * w[..., None]
    hpc_dc = jnp.sum(contrib, axis=1)  # (P, 3)
    dX = -jnp.einsum("pab,pb->pa", Bp, gp + hpc_dc)
    return dX, dpose, dintr


def _pvary_tree(tree, axis_name):
    """Mark every still-invariant leaf as device-varying over axis_name
    (leaves that are already varying — e.g. sharded points — pass through)."""

    def f(x):
        aval = jax.typeof(x)
        if axis_name in getattr(aval, "vma", ()):
            return x
        return jax.lax.pcast(x, axis_name, to="varying")

    return jax.tree.map(f, tree)


def equilibrated_cholesky_solve(S, rhs):
    """Solve S x = rhs on device in working precision.

    Jacobi equilibration (scale by 1/sqrt(diag)) brings the reduced camera
    system's condition number down to where an f32 Cholesky is accurate; one
    iterative-refinement step recovers most of the remaining residual. Rows
    whose diagonal is ~0 (fully frozen parameters, e.g. masked intrinsics)
    are identity-pinned exactly like the host-f64 path. A non-PD system (LM
    lambda too small near gauge directions) yields NaNs, which the LM loop
    treats as a rejected step — the same self-healing Ceres relies on.
    """
    dt = S.dtype
    diag = jnp.diagonal(S)
    dead = diag <= 1e-12
    d = jnp.where(dead, 1.0, jax.lax.rsqrt(jnp.maximum(diag, 1e-20)))
    Ss = S * d[:, None] * d[None, :]
    live2 = (~dead)[:, None] & (~dead)[None, :]
    Ss = jnp.where(live2, Ss, 0.0) + jnp.diag(dead.astype(dt))
    b = jnp.where(dead, 0.0, rhs * d)
    L = jnp.linalg.cholesky(Ss)
    solve_lo = partial(jax.scipy.linalg.solve_triangular, lower=True)
    solve_up = partial(jax.scipy.linalg.solve_triangular, lower=False)
    x = solve_up(L.T, solve_lo(L, b))
    r = b - Ss @ x  # one refinement step in the equilibrated frame
    x = x + solve_up(L.T, solve_lo(L, r))
    return x * d


def ba_lm_core(
    pts, pos, K, cams, op, os_, ouv, ow, tab, imask, pfree,
    ftol, lam0, lam_up, lam_down, min_lam, max_lam,
    n_shots: int, n_cams: int, max_iterations: int,
    axis_name: str | None = None, table_kind: str = "track",
):
    """The full LM optimization as ONE device program (lax.while_loop).

    Single-chip when axis_name is None; inside shard_map (points/observations
    sharded, reduced system psum'd by ba_build_core) when axis_name is given —
    then the tiny equilibrated solve runs replicated on every chip, which is
    cheaper than any host detour.

    Returns (pts, pos, K, cost, iters, converged).
    """
    obs_cam = cams if table_kind == "shot" else cams[os_]
    _, cost0 = compute_residuals(pts, pos, K, cams, op, os_, ouv, ow)
    if axis_name is not None:
        cost0 = jax.lax.psum(cost0, axis_name)
    dt = pts.dtype
    i32 = jnp.int32

    def cond(st):
        return (st["it"] < max_iterations) & (~st["done"])

    def body(st):
        S_red, rhs, Bp, gp, _, Wc, Wi = ba_build_core(
            st["pts"], st["pos"], st["K"], cams, op, os_, ouv, ow, tab,
            st["lam"], imask, pfree,
            n_shots=n_shots, n_cams=n_cams, axis_name=axis_name,
            table_kind=table_kind,
        )
        dcam = equilibrated_cholesky_solve(S_red, rhs)
        dX, dpose, dintr = ba_backsub_points(
            dcam, Bp, gp, Wc, Wi, tab, os_, obs_cam,
            n_shots=n_shots, n_cams=n_cams, table_kind=table_kind,
        )
        new_pts = st["pts"] + dX
        new_pos = st["pos"] + dpose * pfree[:, None]
        new_K = st["K"] + dintr * imask
        _, new_cost = compute_residuals(
            new_pts, new_pos, new_K, cams, op, os_, ouv, ow
        )
        if axis_name is not None:
            new_cost = jax.lax.psum(new_cost, axis_name)
        accept = jnp.isfinite(new_cost) & (new_cost < st["cost"])
        rel = (st["cost"] - new_cost) / jnp.maximum(st["cost"], 1e-30)
        conv = accept & (rel < ftol)
        new_lam = jnp.where(
            accept,
            jnp.maximum(st["lam"] * lam_down, min_lam),
            st["lam"] * lam_up,
        )
        out = {
            "pts": jnp.where(accept, new_pts, st["pts"]),
            "pos": jnp.where(accept, new_pos, st["pos"]),
            "K": jnp.where(accept, new_K, st["K"]),
            "cost": jnp.where(accept, new_cost, st["cost"]),
            "lam": new_lam,
            "it": st["it"] + 1,
            "done": conv | ((~accept) & (new_lam > max_lam)),
            "conv": st["conv"] | conv,
        }
        return _pvary_tree(out, axis_name) if axis_name is not None else out

    init = {
        "pts": pts, "pos": pos, "K": K, "cost": cost0,
        "lam": jnp.asarray(lam0, dt), "it": jnp.asarray(0, i32),
        "done": jnp.asarray(False), "conv": jnp.asarray(False),
    }
    if axis_name is not None:
        # shard-varying + replicated leaves coexist in the carry; make the
        # replicated ones explicitly varying so the while_loop carry is
        # VMA-consistent under shard_map
        init = _pvary_tree(init, axis_name)
    st = jax.lax.while_loop(cond, body, init)
    return st["pts"], st["pos"], st["K"], st["cost"], st["it"], st["conv"]


ba_lm_device = partial(
    jax.jit,
    static_argnames=(
        "n_shots", "n_cams", "max_iterations", "axis_name", "table_kind"
    ),
)(ba_lm_core)


# ---------------------------------------------------------------------------
# Dense (P, S) visibility-grid formulation — zero dynamic gathers.
# ---------------------------------------------------------------------------

def compute_residuals_dense(points, poses, intr, cam_of_shot, uv_ps, w_ps):
    """Residuals on the dense grid: r (P, S, 2) weighted, and total cost."""
    K_s = intr[cam_of_shot]  # (S, 7)
    uv, _ = jax.vmap(
        lambda pose, k: project_points_flat(pose, k, points), in_axes=(0, 0)
    )(poses, K_s)  # (S, P, 2)
    r = (jnp.transpose(uv, (1, 0, 2)) - uv_ps) * w_ps[..., None]
    return r, 0.5 * jnp.sum(r * r)


def project_points_flat(pose, k, pts):
    from sfm_mvs_pipeline.models.cameras import project_points

    return project_points(pose, k, pts)


def _dense_jacobians(points, poses, intr, cam_of_shot, uv_ps, w_ps):
    """Per-slot Jacobians on the (P, S) grid, in P-MINOR layout.

    Returns Jp (2,3,S,P), Jc (2,6,S,P), Ji (2,7,S,P), r (2,S,P).

    Two design choices:

    * SHORT-CHAIN autodiff: a vmapped jacfwd over a packed 16-vector
      (point|pose|intr) per slot would re-derive the Rodrigues rotation
      once per slot with 16-wide tangents.
      The rotation is per-shot: Xc = R_s X + t_s and dXc/daa = (dR/daa) X
      are exact per-shot quantities (S jacfwds of aa_to_rotmat, trivial),
      and the per-slot jacfwd differentiates only the camera-frame
      projection over 10 inputs (Xc 3 | intr 7). Chain rule recovers
        dres/dX = dres/dXc R_s,  dres/dt = dres/dXc,
        dres/daa = dres/dXc dXc/daa.
      (jacfwd, not jacrev: the VJP transpose graph is a scatter graph.)

    * P-MINOR layout: slot-major tensors like (P,S,2,6) put tiny dims
      minormost. With P minormost and the 2/3/6/7 dims leading, every
      materialized Jacobian is contiguous along the long axis and every
      contraction runs over it. The vmap maps over the LAST axis
      (in_axes/out_axes=-1) so all AD intermediates inherit the layout.
    """
    P, S = w_ps.shape
    from sfm_mvs_pipeline.models.cameras import (
        distort_normalized,
        normalized_to_pixels,
    )
    from sfm_mvs_pipeline.ops.pose import aa_to_rotmat

    K_s = intr[cam_of_shot]  # (S, 7)
    R_s = jax.vmap(aa_to_rotmat)(poses[:, :3])  # (S, 3, 3)
    dR = jax.vmap(jax.jacfwd(aa_to_rotmat))(poses[:, :3])  # (S, 3, 3, 3)
    X_T = points.T  # (3, P)
    # Tiny-contraction einsums (contracting a 2- or 3-long axis with P
    # minormost) can lower to convolution fusions with layout-copy glue.
    # Unrolling them into explicit broadcast-multiply-sums keeps every op an
    # elementwise fusion in the shared P-minor layout.
    Xc = sum(
        R_s[:, :, b].T[:, :, None] * X_T[b][None, None] for b in range(3)
    ) + poses[:, 3:].T[:, :, None]  # (3, S, P)
    dXc_daa = sum(
        jnp.transpose(dR[:, :, b, :], (1, 2, 0))[:, :, :, None]
        * X_T[b][None, None, None]
        for b in range(3)
    )  # (3 cam-coord, 3 aa, S, P)

    def res_cam(v, uv, w):
        xc, k = v[:3], v[3:]
        z = jnp.where(xc[2] == 0, 1e-12, xc[2])
        xy = xc[:2] / z
        xy_d = distort_normalized(k, xy)
        return (normalized_to_pixels(k, xy_d) - uv) * w

    v = jnp.concatenate(
        [Xc, jnp.broadcast_to(K_s.T[:, :, None], (7, S, P))], axis=0
    ).reshape(10, S * P)
    uv_f = jnp.transpose(uv_ps, (2, 1, 0)).reshape(2, S * P)
    w_f = w_ps.T.reshape(S * P)
    # Dead slots (w == 0) include PADDED zero-points whose projection has
    # z ~ 0: the Jacobian there overflows f32 to inf, and inf * 0-weight is
    # NaN. Evaluate dead slots at a benign constant input instead — their
    # (weighted) residual and Jacobian are exactly zero either way.
    benign = jnp.zeros((10, 1), v.dtype).at[2, 0].set(1.0).at[3, 0].set(1.0)
    v = jnp.where((w_f > 0)[None, :], v, benign)
    r = jax.vmap(res_cam, in_axes=(-1, -1, -1), out_axes=-1)(v, uv_f, w_f)
    Jv = jax.vmap(jax.jacfwd(res_cam), in_axes=(-1, -1, -1), out_axes=-1)(
        v, uv_f, w_f
    )  # (2, 10, S*P)
    J_xc = Jv[:, :3].reshape(2, 3, S, P)
    Ji = Jv[:, 3:].reshape(2, 7, S, P)
    # b=3 contractions unrolled (see the Xc comment): elementwise fusions
    # instead of degenerate convolutions
    Jp = sum(
        J_xc[:, b, None] * R_s[:, b, :].T[None, :, :, None] for b in range(3)
    )  # (2, 3, S, P)
    Jc_rot = sum(
        J_xc[:, b, None] * dXc_daa[b][None] for b in range(3)
    )  # (2, 3, S, P)
    Jc = jnp.concatenate([Jc_rot, J_xc], axis=1)  # (2, 6, S, P)
    return Jp, Jc, Ji, r.reshape(2, S, P)


def ba_build_dense(
    points, poses, intr, cam_of_shot, uv_ps, w_ps, lam, intr_mask, pose_free,
    n_shots: int, n_cams: int, axis_name: str | None = None,
):
    """Gather-free Schur-reduced camera system on the dense (P, S) grid,
    entirely in P-MINOR layout (see _dense_jacobians): every materialized
    tensor keeps the big P axis minormost and every reduction contracts
    over it.

    Returns (S_red, rhs, Bp (3,3,P), gp (3,P), cost, U (3,D,P)) — U is the
    per-point camera row; back-substitution only needs U^T dcam, so no W
    intermediates are built.
    Under shard_map the POINT axis is sharded; the camera system psum-reduces
    over `axis_name` exactly like the table-based core.
    """
    dt = points.dtype
    P = points.shape[0]
    D = 6 * n_shots + 7 * n_cams

    Jp, Jc, Ji, r = _dense_jacobians(
        points, poses, intr, cam_of_shot, uv_ps, w_ps
    )
    # frozen-parameter masks
    Ji = Ji * intr_mask[cam_of_shot].T[None, :, :, None]
    Jc = Jc * pose_free[None, None, :, None]

    cost = 0.5 * jnp.sum(r * r)

    # ---- camera blocks: contractions over (l, p) with p in lanes
    Hcc_pose = jnp.einsum("lisp,ljsp->sij", Jc, Jc)  # (S, 6, 6)
    Hcc_cross = jnp.einsum("lisp,ljsp->sij", Jc, Ji)  # (S, 6, 7)
    gc = jnp.einsum("lisp,lsp->si", Jc, r)  # (S, 6)
    oh_cam = jax.nn.one_hot(cam_of_shot, n_cams, dtype=dt)  # (S, C)
    Hcc_intr = jnp.einsum("lisp,ljsp,sc->cij", Ji, Ji, oh_cam)  # (C, 7, 7)
    gi = jnp.einsum("lisp,lsp,sc->ci", Ji, r, oh_cam)  # (C, 7)

    s_idx = jnp.arange(n_shots)
    pp = (
        jnp.zeros((n_shots, 6, n_shots, 6), dt)
        .at[s_idx, :, s_idx, :]
        .set(Hcc_pose)
        .reshape(6 * n_shots, 6 * n_shots)
    )
    c_idx = jnp.arange(n_cams)
    ii = (
        jnp.zeros((n_cams, 7, n_cams, 7), dt)
        .at[c_idx, :, c_idx, :]
        .set(Hcc_intr)
        .reshape(7 * n_cams, 7 * n_cams)
    )
    pi = (
        jnp.zeros((n_shots, 6, n_cams, 7), dt)
        .at[s_idx, :, cam_of_shot, :]
        .set(Hcc_cross)
        .reshape(6 * n_shots, 7 * n_cams)
    )
    Hcc = jnp.block([[pp, pi], [pi.T, ii]])
    g_full = jnp.concatenate([gc.reshape(-1), gi.reshape(-1)])

    # ---- point blocks (3, 3, P) / (3, P): elementwise over lanes.
    # Unrolled over the symmetric 3x3 output (see the _dense_jacobians
    # comment): each entry is one multiply+reduce fusion at HBM speed
    # instead of a degenerate-convolution lowering.
    hpp_rows = [[None] * 3 for _ in range(3)]
    for a in range(3):
        for b in range(a, 3):
            hpp_rows[a][b] = jnp.sum(Jp[:, a] * Jp[:, b], axis=(0, 1))
            hpp_rows[b][a] = hpp_rows[a][b]
    Hpp = jnp.stack([jnp.stack(row) for row in hpp_rows])  # (3, 3, P)
    gp = jnp.stack(
        [jnp.sum(Jp[:, a] * r, axis=(0, 1)) for a in range(3)]
    )  # (3, P)
    diag3 = jnp.maximum(
        jnp.stack([Hpp[0, 0], Hpp[1, 1], Hpp[2, 2]]), 1e-8
    )  # (3, P)
    damped = Hpp + lam * jnp.einsum(
        "ab,bp->abp", jnp.eye(3, dtype=dt), diag3
    )
    Bp = _inv3x3_pm(damped)  # (3, 3, P)

    # ---- Schur correction: U (3, D, P). The l=2 contractions are unrolled
    # broadcast multiplies (elementwise fusions); the one materialized
    # transpose to the (a, s, i, p) D-ordering runs at full copy bandwidth,
    # unlike the 4.5 ms degenerate-convolution einsum it replaces.
    UP = sum(Jp[l][:, None] * Jc[l][None] for l in range(2))  # (3, 6, S, P)
    U_pose = jnp.transpose(UP, (0, 2, 1, 3)).reshape(3, n_shots * 6, P)
    UI = sum(Jp[l][:, None] * Ji[l][None] for l in range(2))  # (3, 7, S, P)
    if n_cams == 1:
        # single shared camera (the reference's default scene setup):
        # the one-hot contraction is a plain sum over shots
        U_intr = jnp.sum(UI, axis=2).reshape(3, 7, P)
    else:
        U_intr = jnp.einsum("ajsp,sc->acjp", UI, oh_cam).reshape(
            3, n_cams * 7, P
        )
    U = jnp.concatenate([U_pose, U_intr], axis=1)  # (3, D, P)
    BU = jnp.einsum("abp,bdp->adp", Bp, U)
    S_corr = jnp.einsum("adp,aep->de", U, BU)  # (D, 3P) @ (3P, D)
    rhs_corr = jnp.einsum("adp,ap->d", U, jnp.einsum("abp,bp->ap", Bp, gp))

    if axis_name is not None:
        Hcc = jax.lax.psum(Hcc, axis_name)
        g_full = jax.lax.psum(g_full, axis_name)
        S_corr = jax.lax.psum(S_corr, axis_name)
        rhs_corr = jax.lax.psum(rhs_corr, axis_name)
        cost = jax.lax.psum(cost, axis_name)

    diagH = jnp.diagonal(Hcc)
    Hcc = Hcc + jnp.diag(lam * jnp.maximum(diagH, 1e-8))
    return Hcc - S_corr, -g_full + rhs_corr, Bp, gp, cost, U


def _inv3x3_pm(M):
    """Closed-form 3x3 inverse for P-minor (3, 3, P) stacks."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [jnp.stack([A, B, C]), jnp.stack([D, E, F]), jnp.stack([G, H, I])]
    )  # (3, 3, P)
    return adj / det[None, None, :]


def ba_backsub_dense(dcam, Bp, gp, U, n_shots: int, n_cams: int):
    """Dense-grid back-substitution: dX_p = -Bp (gp + U_p dcam).
    P-minor operands; returns dX as (P, 3) for the parameter update."""
    dpose = dcam[: 6 * n_shots].reshape(n_shots, 6)
    dintr = dcam[6 * n_shots:].reshape(n_cams, 7)
    hpc_dc = jnp.einsum("adp,d->ap", U, dcam)
    dX = -jnp.einsum("abp,bp->ap", Bp, gp + hpc_dc)
    return dX.T, dpose, dintr


def ba_lm_dense_core(
    pts, pos, K, cams, uv_ps, w_ps, imask, pfree,
    ftol, lam0, lam_up, lam_down, min_lam, max_lam,
    n_shots: int, n_cams: int, max_iterations: int,
    axis_name: str | None = None,
):
    """Fused LM on the dense (P, S) grid (see ba_lm_core for the loop
    contract). Returns (pts, pos, K, cost, iters, converged)."""
    _, cost0 = compute_residuals_dense(pts, pos, K, cams, uv_ps, w_ps)
    if axis_name is not None:
        cost0 = jax.lax.psum(cost0, axis_name)
    dt = pts.dtype

    def cond(st):
        return (st["it"] < max_iterations) & (~st["done"])

    def body(st):
        S_red, rhs, Bp, gp, _, U = ba_build_dense(
            st["pts"], st["pos"], st["K"], cams, uv_ps, w_ps,
            st["lam"], imask, pfree,
            n_shots=n_shots, n_cams=n_cams, axis_name=axis_name,
        )
        dcam = equilibrated_cholesky_solve(S_red, rhs)
        dX, dpose, dintr = ba_backsub_dense(
            dcam, Bp, gp, U, n_shots=n_shots, n_cams=n_cams
        )
        new_pts = st["pts"] + dX
        new_pos = st["pos"] + dpose * pfree[:, None]
        new_K = st["K"] + dintr * imask
        _, new_cost = compute_residuals_dense(
            new_pts, new_pos, new_K, cams, uv_ps, w_ps
        )
        if axis_name is not None:
            new_cost = jax.lax.psum(new_cost, axis_name)
        accept = jnp.isfinite(new_cost) & (new_cost < st["cost"])
        rel = (st["cost"] - new_cost) / jnp.maximum(st["cost"], 1e-30)
        conv = accept & (rel < ftol)
        new_lam = jnp.where(
            accept,
            jnp.maximum(st["lam"] * lam_down, min_lam),
            st["lam"] * lam_up,
        )
        out = {
            "pts": jnp.where(accept, new_pts, st["pts"]),
            "pos": jnp.where(accept, new_pos, st["pos"]),
            "K": jnp.where(accept, new_K, st["K"]),
            "cost": jnp.where(accept, new_cost, st["cost"]),
            "lam": new_lam,
            "it": st["it"] + 1,
            "done": conv | ((~accept) & (new_lam > max_lam)),
            "conv": st["conv"] | conv,
        }
        return _pvary_tree(out, axis_name) if axis_name is not None else out

    init = {
        "pts": pts, "pos": pos, "K": K, "cost": cost0,
        "lam": jnp.asarray(lam0, dt), "it": jnp.asarray(0, jnp.int32),
        "done": jnp.asarray(False), "conv": jnp.asarray(False),
    }
    if axis_name is not None:
        init = _pvary_tree(init, axis_name)
    st = jax.lax.while_loop(cond, body, init)
    return st["pts"], st["pos"], st["K"], st["cost"], st["it"], st["conv"]


ba_lm_dense = partial(
    jax.jit,
    static_argnames=("n_shots", "n_cams", "max_iterations", "axis_name"),
)(ba_lm_dense_core)


def run_bundle_adjustment(
    points: np.ndarray,
    poses: np.ndarray,
    intr: np.ndarray,
    cam_of_shot: np.ndarray,
    obs_point: np.ndarray,
    obs_shot: np.ndarray,
    obs_uv: np.ndarray,
    obs_w: np.ndarray,
    intr_mask: np.ndarray,
    pose_free: np.ndarray | None = None,
    config: BAConfig | None = None,
    dtype=None,
    verbose: bool = False,
) -> dict:
    """Host LM driver. Arrays are numpy (any float dtype); device work runs in
    `dtype` (default: input dtype). Returns dict with updated arrays + stats.

    Semantics parity: optimizes every point, every recovered pose and the
    shared camera intrinsics exactly like BundleAdjustment::doBundleAdjustment;
    success mirrors Ceres CONVERGENCE (we report 'converged' when the
    relative cost decrease drops below function_tolerance before hitting
    max_iterations).
    """
    cfg = config or BAConfig()
    S_real = poses.shape[0]
    n_cams = intr.shape[0]
    P = points.shape[0]
    dt = jax.dtypes.canonicalize_dtype(dtype or points.dtype)

    # Bucket the SHOT axis too: n_shots is a static jit argument, so without
    # bucketing the incremental loop would recompile the fused LM program for
    # EVERY added view.
    # Padded shots are fully frozen (pose_free = 0, no observations): their
    # camera-system rows are identity-pinned by the solver and their updates
    # are exactly zero.
    n_shots = _shot_bucket(S_real)
    if n_shots > S_real:
        poses = np.concatenate(
            [poses, np.zeros((n_shots - S_real, 6), poses.dtype)]
        )
        cam_of_shot = np.concatenate(
            [cam_of_shot, np.zeros(n_shots - S_real, cam_of_shot.dtype)]
        )
        pf = (
            pose_free
            if pose_free is not None
            else np.ones(S_real, dtype=np.float64)
        )
        pose_free = np.concatenate([pf, np.zeros(n_shots - S_real, np.float64)])

    # Bucket the observation and point axes to powers of two: the incremental
    # SfM loop grows both every round, and without bucketing every BA call
    # would recompile (jit keys on shapes). Padding uses zero weights /
    # out-of-range-safe indices so results are unaffected.
    O = len(obs_point)
    O_pad = 1024
    while O_pad < O:
        O_pad *= 2
    P_pad = 1024
    while P_pad < P:
        P_pad *= 2
    if O_pad > O:
        obs_point = np.concatenate([obs_point, np.zeros(O_pad - O, obs_point.dtype)])
        obs_shot = np.concatenate([obs_shot, np.zeros(O_pad - O, obs_shot.dtype)])
        obs_uv = np.concatenate([obs_uv, np.zeros((O_pad - O, 2), obs_uv.dtype)])
        obs_w = np.concatenate([obs_w, np.zeros(O_pad - O, obs_w.dtype)])
    if P_pad > P:
        points = np.concatenate([points, np.zeros((P_pad - P, 3), points.dtype)])

    import time as _time

    _tt0 = _time.perf_counter()
    # layout choice, fastest first:
    #  * dense (P, S) visibility grid — gather-free build; needs <=1 obs per
    #    (point, shot) and a bounded grid size
    #  * (P, S) shot table — gathers, but no one-hot contraction
    #  * (P, L) track table — the general fallback
    dense = None
    if P_pad * n_shots <= DENSE_GRID_MAX_SLOTS:
        dense = pack_dense_obs(obs_point, obs_shot, obs_uv, obs_w, P_pad, n_shots)
    if dense is not None:
        track_tab, table_kind = None, "dense"
        uv_ps, w_ps = dense
    else:
        shot_tab = build_shot_table(obs_point, obs_shot, obs_w, P_pad, n_shots)
        if shot_tab is not None:
            track_tab, table_kind = shot_tab, "shot"
        else:
            track_tab, table_kind = build_track_table(obs_point, obs_w, P_pad), "track"
    _tt1 = _time.perf_counter()

    dev = lambda x, d=dt: jnp.asarray(x, dtype=d)
    pts = dev(points)
    pos = dev(poses)
    K = dev(intr)
    cams = jnp.asarray(cam_of_shot, dtype=jnp.int32)
    op = jnp.asarray(obs_point, dtype=jnp.int32)
    os_ = jnp.asarray(obs_shot, dtype=jnp.int32)
    ouv = dev(obs_uv)
    ow = dev(obs_w)
    imask = dev(intr_mask)
    pfree = dev(
        pose_free if pose_free is not None else np.ones(n_shots, dtype=np.float64)
    )
    if table_kind == "dense":
        uv_ps_d = dev(uv_ps)
        w_ps_d = dev(w_ps)
        tab = None
        jax.block_until_ready((pts, pos, K, cams, imask, pfree, uv_ps_d, w_ps_d))
    else:
        tab = jnp.asarray(track_tab)
        jax.block_until_ready(
            (pts, pos, K, cams, op, os_, ouv, ow, imask, pfree, tab)
        )
    _tt2 = _time.perf_counter()

    if cfg.solver == "device":
        # one fused program: every LM iteration (build + equilibrated
        # Cholesky + backsub + accept/reject) stays on device; the only
        # fetch is the final state
        if table_kind == "dense":
            out_pts, out_pos, out_K, cost_d, iters_d, conv_d = ba_lm_dense(
                pts, pos, K, cams, uv_ps_d, w_ps_d, imask, pfree,
                cfg.function_tolerance, cfg.init_lambda, cfg.lambda_up,
                cfg.lambda_down, cfg.min_lambda, cfg.max_lambda,
                n_shots=n_shots, n_cams=n_cams,
                max_iterations=cfg.max_iterations,
            )
        else:
            out_pts, out_pos, out_K, cost_d, iters_d, conv_d = ba_lm_device(
                pts, pos, K, cams, op, os_, ouv, ow, tab, imask, pfree,
                cfg.function_tolerance, cfg.init_lambda, cfg.lambda_up,
                cfg.lambda_down, cfg.min_lambda, cfg.max_lambda,
                n_shots=n_shots, n_cams=n_cams,
                max_iterations=cfg.max_iterations, table_kind=table_kind,
            )
        if verbose:
            print(
                f"  BA[device,{table_kind}]: setup {_tt1-_tt0:.2f}s transfers "
                f"{_tt2-_tt1:.2f}s", flush=True,
            )
        # ONE device->host fetch: packing the outputs into a single flat
        # vector collapses 6 transfers into 1
        n_pts_f = out_pts.size
        n_pos_f = out_pos.size
        n_K_f = out_K.size
        # scalars packed in the WORKING dtype (not hard-coded f32: under
        # x64 the cost would lose digits that downstream parity checks
        # compare)
        pdt = out_pts.dtype
        packed = jnp.concatenate(
            [
                out_pts.ravel(), out_pos.ravel(), out_K.ravel(),
                jnp.stack(
                    [
                        cost_d.astype(pdt),
                        iters_d.astype(pdt),
                        conv_d.astype(pdt),
                    ]
                ),
            ]
        )
        host = np.asarray(packed)
        o = 0
        pts_h = host[o : o + n_pts_f].reshape(out_pts.shape); o += n_pts_f
        pos_h = host[o : o + n_pos_f].reshape(out_pos.shape); o += n_pos_f
        K_h = host[o : o + n_K_f].reshape(out_K.shape); o += n_K_f
        cost_h, iters_h, conv_h = host[o], host[o + 1], host[o + 2]
        return {
            "points": pts_h.astype(points.dtype)[:P],
            "poses": pos_h.astype(poses.dtype)[:S_real],
            "intrinsics": K_h.astype(intr.dtype),
            "cost": float(cost_h),
            "iterations": int(iters_h),
            "converged": bool(conv_h > 0.5),
            "lambda": None,
        }

    if table_kind == "dense":
        # host-solver iterations use the table paths; rebuild the shot/track
        # table (the dense grid is a device-solver specialization)
        shot_tab = build_shot_table(obs_point, obs_shot, obs_w, P_pad, n_shots)
        if shot_tab is not None:
            track_tab, table_kind = shot_tab, "shot"
        else:
            track_tab, table_kind = build_track_table(obs_point, obs_w, P_pad), "track"
        tab = jnp.asarray(track_tab)

    _, cost = compute_residuals(pts, pos, K, cams, op, os_, ouv, ow)
    cost = float(cost)
    if verbose:
        print(
            f"  BA setup: track table {_tt1-_tt0:.2f}s transfers {_tt2-_tt1:.2f}s "
            f"first residuals {_time.perf_counter()-_tt2:.2f}s",
            flush=True,
        )
    lam = cfg.init_lambda
    iters = 0
    converged = False

    for it in range(cfg.max_iterations):
        _t0 = _time.perf_counter()
        iters = it + 1
        S_red, rhs_red, Bp, gp, _, Wc, Wi = ba_build_reduced(
            pts, pos, K, cams, op, os_, ouv, ow, tab,
            jnp.asarray(lam, dtype=dt), imask, pfree,
            n_shots=n_shots, n_cams=n_cams, table_kind=table_kind,
        )
        # host f64 solve of the small reduced system
        jax.block_until_ready(S_red)
        _t1 = _time.perf_counter()
        S_np = np.array(S_red, dtype=np.float64)
        rhs_np = np.array(rhs_red, dtype=np.float64)
        # guard fully-frozen rows (masked intrinsics): identity them
        diag0 = np.abs(np.diag(S_np)) < 1e-12
        S_np[diag0, :] = 0.0
        S_np[:, diag0] = 0.0
        S_np[diag0, diag0] = 1.0
        rhs_np[diag0] = 0.0
        try:
            dcam = np.linalg.solve(S_np, rhs_np)
        except np.linalg.LinAlgError:
            dcam = np.linalg.lstsq(S_np, rhs_np, rcond=None)[0]

        dcam_dev = dev(dcam)
        dX, dpose, dintr = ba_backsub_points(
            dcam_dev, Bp, gp, Wc, Wi, tab, os_,
            cams if table_kind == "shot" else cams[os_],
            n_shots=n_shots, n_cams=n_cams, table_kind=table_kind,
        )
        new_pts = pts + dX
        new_pos = pos + dpose * pfree[:, None]
        new_K = K + dintr * imask
        _, new_cost = compute_residuals(new_pts, new_pos, new_K, cams, op, os_, ouv, ow)
        new_cost = float(new_cost)
        if verbose:
            _t2 = _time.perf_counter()
            print(
                f"  BA iter {it}: build {_t1-_t0:.2f}s solve+apply {_t2-_t1:.2f}s "
                f"cost {cost:.4g} -> {new_cost:.4g} lam {lam:.2e}",
                flush=True,
            )

        if np.isfinite(new_cost) and new_cost < cost:
            rel = (cost - new_cost) / max(cost, 1e-30)
            pts, pos, K = new_pts, new_pos, new_K
            cost = new_cost
            lam = max(lam * cfg.lambda_down, cfg.min_lambda)
            if rel < cfg.function_tolerance:
                converged = True
                break
        else:
            lam = lam * cfg.lambda_up
            if lam > cfg.max_lambda:
                break

    _tt3 = _time.perf_counter()
    result_pts = np.array(pts, dtype=points.dtype)[:P]
    if verbose:
        print(f"  BA teardown: result transfer {_time.perf_counter()-_tt3:.2f}s", flush=True)
    return {
        "points": result_pts,
        "poses": np.array(pos, dtype=poses.dtype)[:S_real],
        "intrinsics": np.array(K, dtype=intr.dtype),
        "cost": cost,
        "iterations": iters,
        "converged": converged,
        "lambda": lam,
    }
