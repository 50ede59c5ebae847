#!/usr/bin/env python3
"""End-to-end smoke run of the SfM+MVS pipeline on one NVIDIA GPU.

    python3 chip_smoke.py                one card: phases A-D
    python3 chip_smoke.py --four-cards   four cards: the sharded path only

Phase B  the bundled insel set (3 x 360x202) through the CLI with
         --colored --dense --mesh --stats.
Phase C  12 rendered views at 1600x1200 through the CLI (SIFT, BF, the
         default feature limit, --dense --mesh), checked against the
         renderer's ground truth; a cold and a warm run.
Phase A  the descriptor matcher as XLA compiles it (no hand-written kernel
         remains), on the SIFT and ORB descriptors the program extracts
         from phase C's views, in both precision modes, checked against
         each other and a float64 reference. It runs after C, on C's views.
Phase D  the other engines on insel: --sgm, PatchMatch, ORB with FLANN.

--four-cards runs phase C's set twice, each in a child process, one after
the other: on card 0 alone, then on all four cards, where matching, BA and
depth maps are sharded. It checks that both runs register every view and
that their camera centres agree.

The CLI runs in-process through `sfm_mvs_pipeline.cli.app.main`; outputs
go to ./chip_smoke_out. Every result line names the card and its power
limit. The last line of standard output is one JSON object. The script
exits non-zero, with no result, when JAX finds no GPU or the package is
not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chip_smoke_out")
INSEL = os.path.join(ROOT, "sample_data", "insel")

# insel sparse cloud on the CPU backend with phase B's flags (3 views
# registered). The card sums in another order, which can flip the choice
# between near-equal baseline pairs ((0, 1) on an H100, (0, 2) on the CPU)
# and move the cloud by tens of points, so the card must reach this count
# less a 25 % margin
INSEL_CPU_SPARSE_POINTS = 137
SPARSE_MARGIN = 0.25
# phase C's set and its ground-truth bounds (the bounds of
# tests/test_synthetic_gt.py: ATE below 2 % of the trajectory's extent,
# relative rotations within 1 degree)
# (detail=3: a texel is 0.85 px, so SIFT finds ~6500 features per view,
# the density of a real capture under the default limit of 10000)
BIG_VIEWS, BIG_W, BIG_H, BIG_F, BIG_SEED = 12, 1600, 1200, 1400.0, 11
BIG_DETAIL = 3
ATE_REL_BOUND = 0.02
ROT_DEG_BOUND = 1.0
# --four-cards: camera centres of the one-card and four-card runs, after
# sim(3) alignment, within 0.5 % of the extent (psum reorders BA's sums)
CENTRE_AGREEMENT = 0.005

CARD = "card unknown"


def card_line() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "card unknown (nvidia-smi failed)"
    return out[0] if out else "card unknown"


def check(ok: bool, msg: str) -> None:
    """A smoke check; unlike `assert` it holds under `python -O` too."""
    if not ok:
        raise AssertionError(msg)


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv: list[str]) -> tuple[int, str, float]:
    """Run the CLI in-process; return (rc, log text, wall seconds)."""
    from sfm_mvs_pipeline.cli.app import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def log_values(log: str, marker: str) -> list[str]:
    """The text after `marker` on every log line that holds it."""
    return [ln.split(marker, 1)[1].strip() for ln in log.splitlines()
            if marker in ln]


def ply_count(path: str, element: str = "vertex") -> int:
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        head = f.read(4096).split(b"end_header")[0].decode("ascii", "replace")
    for ln in head.splitlines():
        if ln.startswith(f"element {element} "):
            return int(ln.split()[2])
    return 0


def scene_of(out_dir: str):
    from sfm_mvs_pipeline.utils.checkpoint import load_scene

    return load_scene(os.path.join(out_dir, "scene.npz"))


def centres_and_rotations(scene):
    import numpy as np

    from sfm_mvs_pipeline.ops.pose import aa_to_rotmat_np

    rec = np.nonzero(scene.recovered)[0]
    R = aa_to_rotmat_np(scene.poses[rec, :3].astype(np.float64))
    C = -np.einsum("nji,nj->ni", R, scene.poses[rec, 3:].astype(np.float64))
    return rec, C, R


# ------------------------------------------------------------------ phase A
def _f64_check(descs, valid, pairs, out, n_check: int, n_rows: int = 256):
    """Our best distance equals a float64 numpy reference on the first
    n_rows queries of n_check pairs, and our best index points at a true
    nearest neighbour (tie-safe: ORB distances tie often)."""
    import numpy as np

    d = np.asarray(descs, np.float64)
    v = np.asarray(valid)
    for k in range(n_check):
        a, b = (int(x) for x in pairs[k])
        q, t = d[a][:n_rows], d[b]
        # exact in float64: integer inputs, sums far below 2^53
        sq = (q * q).sum(1)[:, None] + (t * t).sum(1)[None] - 2.0 * q @ t.T
        sq[:, ~v[b]] = np.inf
        rows = np.nonzero(v[a][:n_rows])[0]
        best = np.asarray(out[2][k], np.float64)[rows] ** 2
        np.testing.assert_allclose(best, sq.min(1)[rows], rtol=1e-6)
        picked = sq[rows, np.asarray(out[0][k])[rows]]
        check(np.array_equal(picked, sq.min(1)[rows]),
              f"pair {k}: a best index is not a nearest neighbour")


def phase_a(n_orb_views=4) -> dict:
    """The matcher as XLA compiles it for the card (no hand-written kernel
    remains; PERF.md, "Kernel decisions"), on the program's own descriptors
    of phase C's views at the capacity the CLI picks: SIFT on every view
    and pair, ORB (+-1 expansion, D = 256) on the first n_orb_views.

    fast (bf16 operands, f32 accumulation) must equal exact (f32 operands
    at HIGHEST) bit for bit, since both extractors emit integers of at most
    256 and every sum stays below 2^24; exact is checked against float64
    numpy on a subset. bench.py times the matcher; this phase only checks."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sfm_mvs_pipeline.cli.photogrammetrie import _feature_cap, extract_sift
    from sfm_mvs_pipeline.ops.matching import (
        expand_binary_descriptors,
        match_pairs_batch,
    )
    from sfm_mvs_pipeline.ops.orb import orb_features
    from sfm_mvs_pipeline.ops.pairs import unordered_pairs
    from sfm_mvs_pipeline.utils.images import list_images, load_gray_batch

    views = os.path.join(OUT, "big_views")
    check(os.path.isdir(views), "phase A needs phase C's rendered views")
    imgs, (w, h) = load_gray_batch(list_images(views))
    cap_env = _feature_cap(10000, w, h)
    sift = extract_sift(imgs, cap_env)
    orb = orb_features(jnp.asarray(imgs[:n_orb_views]), max_features=cap_env)
    inputs = {
        "sift": (sift["descriptors"], sift["valid"], len(imgs)),
        "orb": (expand_binary_descriptors(orb["descriptors"]), orb["valid"],
                n_orb_views),
    }
    results = {}
    for kind, (descs, valid, n) in inputs.items():
        pairs = jnp.asarray(unordered_pairs(n), jnp.int32)
        outs = {}
        for mode in ("fast", "exact"):
            compiled = match_pairs_batch.lower(
                descs, valid, pairs, with_distance=True,
                exact=mode == "exact").compile()
            say(f"A {kind} F={descs.shape[1]} D={descs.shape[2]} "
                f"P={len(pairs)} {mode}: memory {compiled.memory_analysis()}")
            outs[mode] = jax.block_until_ready(compiled(descs, valid, pairs))
        for x, y, name in zip(outs["fast"], outs["exact"],
                              ("best_idx", "mask", "distance")):
            check(np.array_equal(np.asarray(x), np.asarray(y)),
                  f"{kind}: fast and exact {name} differ")
        _f64_check(descs, valid, np.asarray(pairs), outs["exact"], 2)
        row = {"capacity": int(descs.shape[1]), "pairs": len(pairs),
               "features_per_view": np.asarray(valid).sum(1).tolist(),
               "matches": int(np.asarray(outs["fast"][1]).sum())}
        say(f"A {kind}: " + json.dumps(row))
        check(row["matches"] > 0, f"{kind}: no matches")
        results[kind] = row
    return results


# ------------------------------------------------------------------ phase B
def phase_b() -> dict:
    out = os.path.join(OUT, "insel")
    rc, log, wall = run_cli([
        "-Prun=photogrammetrie", f"-Pimage={INSEL}", f"-Pout={out}",
        "--colored", "--dense", "--mesh", "--stats",
    ])
    check(rc == 0, f"insel run returned {rc}")
    scene = scene_of(out)
    n_reg = int(scene.recovered.sum())
    sparse = ply_count(os.path.join(out, "pointcloud_sparse.ply"))
    dense = ply_count(os.path.join(out, "pointcloud_dense.ply"))
    mesh = ply_count(os.path.join(out, "mesh_dense.ply"), "face")
    res = {"wall_s": wall, "registered": n_reg, "sparse_points": sparse,
           "dense_points": dense, "mesh_faces": mesh,
           "stage_walls": log_values(log, "stage wall ")}
    say(f"B insel: {json.dumps(res)}")
    check(n_reg == 3, f"{n_reg}/3 views registered")
    floor = int(INSEL_CPU_SPARSE_POINTS * (1 - SPARSE_MARGIN))
    check(sparse >= floor, f"sparse cloud {sparse} < {floor}")
    check(dense > 0 and mesh > 0, "empty dense cloud or mesh")
    return res


# ------------------------------------------------------------------ phase C
def render_big_set(dest: str, n_views=BIG_VIEWS, w=BIG_W, h=BIG_H, f=BIG_F,
                   detail=BIG_DETAIL):
    from sfm_mvs_pipeline.utils.synth import render_views

    if os.path.isdir(dest):
        shutil.rmtree(dest)
    _, gt_R, gt_C = render_views(dest, n_views=n_views, h=h, w=w, f=f,
                                 seed=BIG_SEED, detail=detail)
    return gt_R, gt_C


def big_argv(views: str, out: str, extra=()) -> list[str]:
    return ["-Prun=photogrammetrie", f"-Pimage={views}", f"-Pout={out}",
            "-Pfeature-limit=10000", "-Pfeature-detector=SIFT",
            "-Pfeature-matcher=BF", "--dense", "--mesh", *extra]


def trajectory_error(scene, gt_R, gt_C) -> dict:
    from sfm_mvs_pipeline.utils.metrics import trajectory_compare

    rec, C, R = centres_and_rotations(scene)
    cmp = trajectory_compare(C, R, gt_C[rec], gt_R[rec])
    extent = float(((gt_C[rec][-1] - gt_C[rec][0]) ** 2).sum() ** 0.5)
    return {"ate_rel": cmp["ate_rmse"] / extent,
            "max_rel_rot_deg": cmp["max_rel_rot_deg"]}


def phase_c(n_views=BIG_VIEWS, w=BIG_W, h=BIG_H, f=BIG_F,
            detail=BIG_DETAIL) -> dict:
    views = os.path.join(OUT, "big_views")
    t0 = time.perf_counter()
    gt_R, gt_C = render_big_set(views, n_views, w, h, f, detail)
    say(f"C rendered {n_views} views at {w}x{h} in "
        f"{time.perf_counter() - t0:.3f} s (set-up)")
    out = os.path.join(OUT, "big")
    walls = []
    for run in ("cold", "warm"):
        rc, log, wall = run_cli(big_argv(views, out))
        check(rc == 0, f"{run} run returned {rc}")
        walls.append(wall)
        say(f"C {run} wall {wall:.3f} s; stage walls "
            f"{log_values(log, 'stage wall ')}; matching "
            f"{log_values(log, '(matching wall ')}")
    scene = scene_of(out)
    n_reg = int(scene.recovered.sum())
    err = trajectory_error(scene, gt_R, gt_C)
    res = {"cold_wall_s": walls[0], "warm_wall_s": walls[1],
           "registered": n_reg, **err,
           "dense_points": ply_count(os.path.join(out, "pointcloud_dense.ply")),
           "mesh_faces": ply_count(os.path.join(out, "mesh_dense.ply"),
                                   "face")}
    say(f"C {n_views}x{w}x{h}: {json.dumps(res)}")
    check(n_reg == n_views, f"{n_reg}/{n_views} views registered")
    check(err["ate_rel"] < ATE_REL_BOUND, f"ATE {err['ate_rel']:.4%}")
    check(err["max_rel_rot_deg"] < ROT_DEG_BOUND,
          f"relative rotation {err['max_rel_rot_deg']:.4f} deg")
    check(res["dense_points"] > 0 and res["mesh_faces"] > 0,
          "empty dense cloud or mesh")
    return res


# ------------------------------------------------------------------ phase D
def phase_d() -> dict:
    runs = {
        "sgm": ["--sgm"],
        "patchmatch": ["-Pdense-method=patchmatch"],
        "orb_flann": ["-Pfeature-detector=ORB", "-Pfeature-matcher=FLANN"],
    }
    results = {}
    for name, extra in runs.items():
        out = os.path.join(OUT, f"insel_{name}")
        rc, log, wall = run_cli([
            "-Prun=photogrammetrie", f"-Pimage={INSEL}", f"-Pout={out}",
            "--dense", *extra,
        ])
        dense = ply_count(os.path.join(out, "pointcloud_dense.ply"))
        per_view = [v.rsplit(",", 1)[-1].strip()
                    for v in log_values(log, "valid px")]
        res = {"rc": rc, "wall_s": wall, "dense_points": dense,
               "per_view_depth": per_view}
        say(f"D {name}: {json.dumps(res)}")
        check(rc == 0, f"{name} returned {rc}")
        check(dense > 0, f"{name}: empty dense cloud")
        results[name] = res
    return results


# ------------------------------------------------------------ --four-cards
def four_card_child(n_cards: int, report: str, **size) -> None:
    """One run of phase C's set; writes centres, sharding log lines and
    per-device memory to `report`."""
    import csv

    import jax

    devs = jax.devices()
    check(len(devs) == n_cards, f"expected {n_cards} cards, see {len(devs)}")
    views = os.path.join(OUT, f"big_views_{n_cards}")
    gt_R, gt_C = render_big_set(views, **size)
    out = os.path.join(OUT, f"big_{n_cards}cards")
    rc, log, wall = run_cli(big_argv(views, out, ["--stats"]))
    check(rc == 0, f"run on {n_cards} cards returned {rc}")
    scene = scene_of(out)
    rec, C, R = centres_and_rotations(scene)
    sampled = [0] * n_cards
    with open(os.path.join(out, "app.stat.csv")) as f:
        for row in csv.DictReader(f, delimiter=";"):
            per = [int(x) for x in row["device_mem_used_per_device"].split("|")
                   if x]
            sampled = [max(a, b) for a, b in zip(sampled, per)]
    stats = [d.memory_stats() or {} for d in devs]
    json.dump({
        "n_cards": n_cards, "kind": devs[0].device_kind,
        "platform": devs[0].platform, "wall_s": wall, "registered": rec.tolist(),
        "centres": C.tolist(), "rotations": R.tolist(),
        "gt_C": gt_C.tolist(), "gt_R": gt_R.tolist(),
        "sharded_lines": [ln for ln in log.splitlines()
                          if "sharded" in ln and "devices" in ln],
        "bytes_in_use_sampled_max": sampled,
        "bytes_in_use_after": [int(s.get("bytes_in_use", 0)) for s in stats],
        "peak_bytes_in_use": [int(s.get("peak_bytes_in_use", 0))
                              for s in stats],
    }, open(report, "w"))


def four_cards() -> dict:
    """Parent of the two children; stays off JAX itself."""
    os.makedirs(OUT, exist_ok=True)
    reports = {}
    for n, visible in ((1, "0"), (4, "0,1,2,3")):
        report = os.path.join(OUT, f"four_cards_child{n}.json")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible)
        t0 = time.perf_counter()
        rc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(n),
             report], env=env,
        ).returncode
        say(f"four-cards child on {n} card(s): rc {rc}, "
            f"{time.perf_counter() - t0:.3f} s")
        check(rc == 0, f"child on {n} card(s) failed")
        reports[n] = json.load(open(report))
    return compare_four_card_reports(reports[1], reports[4])


def compare_four_card_reports(one: dict, four: dict) -> dict:
    import numpy as np

    from sfm_mvs_pipeline.utils.metrics import trajectory_compare

    for r in (one, four):
        say(f"four-cards {r['n_cards']} card(s): wall {r['wall_s']:.3f} s, "
            f"registered {len(r['registered'])}/{len(r['gt_C'])}, "
            f"bytes_in_use sampled max {r['bytes_in_use_sampled_max']}, "
            f"after {r['bytes_in_use_after']}, "
            f"peak {r['peak_bytes_in_use']}")
    for ln in four["sharded_lines"]:
        say(f"four-cards log: {ln.strip()}")
    for key in ("pair-sharded matching", "point-sharded bundle adjustment",
                "view-sharded depth estimation"):
        check(any(key in ln for ln in four["sharded_lines"]),
              f"four-card run did not log {key!r}")
    n_views = len(one["gt_C"])
    check(len(one["registered"]) == n_views, "one-card run lost views")
    check(len(four["registered"]) == n_views, "four-card run lost views")
    check(all(b > 0 for b in four["bytes_in_use_sampled_max"]),
          "a device never held memory during the four-card run")
    check(all(b > 0 for b in four["peak_bytes_in_use"]),
          "a device has no peak memory use in the four-card run")
    cmp = trajectory_compare(
        np.asarray(four["centres"]), np.asarray(four["rotations"]),
        np.asarray(one["centres"]), np.asarray(one["rotations"]))
    c1 = np.asarray(one["centres"])
    extent = float(np.linalg.norm(c1[-1] - c1[0]))
    agree = cmp["ate_rmse"] / extent
    say(f"four-cards: centres agree within {agree:.6%} of the extent "
        f"(bound {CENTRE_AGREEMENT:.2%}), max relative rotation "
        f"{cmp['max_rel_rot_deg']:.6f} deg")
    check(agree < CENTRE_AGREEMENT, "camera centres disagree")
    return four


# -------------------------------------------------------------------- main
def require_gpu():
    try:
        sys.path.insert(0, ROOT)
        import sfm_mvs_pipeline  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the sfm_mvs_pipeline package is not beside this "
              f"script ({e})", file=sys.stderr)
        sys.exit(2)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (first device: {dev.platform}); "
              "this smoke runs on the card only", file=sys.stderr)
        sys.exit(3)
    return jax


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the sharded path on four cards, nothing else")
    ap.add_argument("--child", nargs=2, metavar=("N", "REPORT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    CARD = card_line()

    if args.four_cards:
        # the parent must not touch the cards: only check the package
        sys.path.insert(0, ROOT)
        try:
            import sfm_mvs_pipeline  # noqa: F401
        except ImportError as e:
            print(f"chip_smoke: package missing ({e})", file=sys.stderr)
            return 2
        if shutil.which("nvidia-smi") is None:
            print("chip_smoke: no nvidia-smi, so no GPU", file=sys.stderr)
            return 3
        say("four-cards: one card, then four, on phase C's set")
        four = four_cards()
        print(CARD)
        print(json.dumps({"ok": True, "device": {
            "platform": four["platform"], "kind": four["kind"],
            "count": four["n_cards"]}}))
        return 0

    jax = require_gpu()
    from sfm_mvs_pipeline.utils.compile_cache import enable_compile_cache

    if args.child:
        enable_compile_cache()
        four_card_child(int(args.child[0]), args.child[1])
        return 0

    import jaxlib

    dev = jax.devices()[0]
    say(f"device_kind {dev.device_kind}, {len(jax.devices())} device(s), "
        f"bytes_limit {(dev.memory_stats() or {}).get('bytes_limit')}, "
        f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"compile cache {enable_compile_cache()}")
    if os.path.isdir(OUT):
        shutil.rmtree(OUT)
    os.makedirs(OUT)

    failed = []
    # A runs after C on C's views, so that C's first run stays cold
    for name, phase in (("B", phase_b), ("C", phase_c), ("A", phase_a),
                        ("D", phase_d)):
        t0 = time.perf_counter()
        try:
            phase()
            say(f"phase {name} passed in {time.perf_counter() - t0:.3f} s")
        except Exception:
            traceback.print_exc(file=sys.stdout)
            say(f"phase {name} FAILED after {time.perf_counter() - t0:.3f} s")
            failed.append(name)
    print(CARD)
    print(json.dumps({
        "ok": not failed, "failed_phases": failed,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
