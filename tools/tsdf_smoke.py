"""256³ TSDF streaming-recognition smoke with timings (real-KinFu scale).

Fuses synthetic depth frames of a tabletop scene (one bumpy-mesh object on
a plane) into a 256³ voxel volume with the sensor-model update (free-space
carving), raycasts a tracking view (trilinear), extracts the surface with
capacity-from-occupancy, and recognizes the object on the fused geometry.

The model description is built through the SAME sensing pipeline (the
model fused into its own TSDF volume at the same voxel size, surface
extracted) so both sides share sampling density and normal convention —
the requirement every TSDF recognition test documents
(tests/test_tsdf.py:53-85): matching raw mesh vertices against a fused
surface mismatches both density and normal smoothing and loses the pose.

Prints one JSON line with per-stage timings (cold = first call incl. XLA
compile, warm = steady-state) and the recognition result. The scene
functions are module-level so chip_smoke.py's TSDF phase fuses the same
tabletop.
Usage: python tools/tsdf_smoke.py [--dims 256] [--frames 8] [--img 240]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def tabletop_world(rng):
    """The bumpy-mesh object on a plane: (model points, model normals,
    world points). The object sits at (0, 0, 1) — its ground-truth pose is
    a pure translation.

    Dense area-uniform surface samples: the raw 2.5k vertices leave the
    rendered depth images ~15% filled (pinholes) at 240² — a real sensor
    returns a dense grid, so sample the mesh like one."""
    from objective_slam_tpu.utils import pointcloud as pc, synthetic

    verts, faces = synthetic.bumpy_mesh(subdiv=4, bumps=0.35)
    mp, mn = pc.sample_mesh_surface(verts, faces, 40_000, rng)
    obj = mp + np.float32([0, 0, 1.0])
    u = rng.uniform(-2.2, 2.2, size=(40_000, 2)).astype(np.float32)
    plane = np.concatenate([u, np.full((len(u), 1), -1.05, np.float32)],
                           axis=1)
    world = np.concatenate([obj, plane]).astype(np.float32)
    return mp, mn, world


def tracking_clutter():
    """Three distinct boxy objects around the target: yaw-constraining
    geometry for frame-to-model tracking (the bare blob+plane scene
    constrains no yaw — a 7.5°-step orbit on it lost 34/47 frames, measured
    round 5), exactly the clutter a realistic tabletop has."""
    from objective_slam_tpu.utils import pointcloud as pc, synthetic

    rngc = np.random.default_rng(7)
    clutter = []
    for i in range(3):
        bv, bf = synthetic.superellipsoid_mesh(subdiv=3, p=4.0,
                                               bumps=0.05 * (i + 1))
        cp_i, _ = pc.sample_mesh_surface(bv, bf, 8_000, rngc)
        cp_i = cp_i * np.float32([0.45, 0.3 + 0.12 * i, 0.55])
        q = synthetic.random_rotation_quat(rngc)
        cp_i = cp_i @ synthetic.quat_to_matrix(q).T
        ang_i = 2 * math.pi * i / 3 + 0.5
        cp_i += np.float32([1.7 * math.cos(ang_i),
                            1.7 * math.sin(ang_i), -0.55])
        clutter.append(cp_i)
    return clutter


def orbit_pose(ang):
    """World→camera pose of the orbit camera at angle `ang` (radians)."""
    from objective_slam_tpu.utils import synthetic

    eye = np.float32([3.2 * math.cos(ang), 3.2 * math.sin(ang), 1.6])
    return synthetic.look_at(eye, (0, 0, 0.5))


def fused_model_description(mp, mn, voxel_size, cfg):
    """Model description through the sensing pipeline: fuse the model into
    its own volume at the SAME voxel size, extract, d_dist-filter (the
    CLI's model path, cli.py:266-268 — describing the raw voxel-resolution
    surface is ~25k points = 0.6G pairwise PPFs), describe."""
    import objective_slam_tpu as ost
    from objective_slam_tpu.models import drost, tsdf
    from objective_slam_tpu.utils import pointcloud as pc

    lo, hi = mp.min(axis=0) - 0.2, mp.max(axis=0) + 0.2
    md = int(np.ceil(float((hi - lo).max()) / voxel_size / 8.0)) * 8
    mvol = tsdf.make_volume(origin=lo, dims=(md, md, md),
                            voxel_size=voxel_size)
    mvol = tsdf.integrate(mvol, mp, mn)
    msurf = tsdf.extract_surface(
        mvol, drost._next_cap(max(int(tsdf.surface_occupancy(mvol)), 1024)))
    mok = np.asarray(msurf.valid)
    fp = np.asarray(msurf.points)[mok]
    fn = np.asarray(msurf.normals)[mok]
    d_dist = cfg.tau_d * float(pc.bbox_diameter(fp))
    fp, fn = pc.voxel_downsample_np(fp, fn, d_dist)
    return ost.build_model_description(fp, fn, cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--img", type=int, default=240)
    args = ap.parse_args(argv)

    import jax
    from objective_slam_tpu.config import PPFConfig
    from objective_slam_tpu.models import tsdf
    from objective_slam_tpu.ops import transforms as tr
    from objective_slam_tpu.utils import synthetic

    rng = np.random.default_rng(0)
    mp, mn, world = tabletop_world(rng)

    D = args.dims
    vs = 5.0 / D                                    # 5 m cube -> 2 cm @256
    vol = tsdf.make_volume(origin=(-2.5, -2.5, -1.5), dims=(D, D, D),
                           voxel_size=vs)
    cfg = PPFConfig(max_poses=512, ref_point_df=2, refine_icp=True,
                    icp_iterations=8)
    rec = tsdf.StreamingRecognizer(vol, cfg)
    desc = fused_model_description(mp, mn, vs, cfg)
    rec.register_model("blob", desc)

    h = w = args.img
    intr = (0.9 * w, 0.9 * w, w / 2 - 0.5, h / 2 - 0.5)
    t_int = []
    for f in range(args.frames):
        T_cw = orbit_pose(2 * math.pi * f / args.frames)
        depth = synthetic.render_depth(world, T_cw, intr, (h, w))
        t0 = time.perf_counter()
        rec.integrate_depth_frame(depth, intr, T_cw)
        jax.block_until_ready(rec.volume.tsdf)
        t_int.append(time.perf_counter() - t0)

    # ---- Band-limited integration (same trajectory, fresh volume) ----
    # Probe candidate-block occupancy over the trajectory, size the static
    # cap (+15%, the repo's capacity rule), fuse banded, and time it; the
    # equality-within-band contract is enforced by tests/test_tsdf.py.
    vol_b = tsdf.make_volume(origin=(-2.5, -2.5, -1.5), dims=(D, D, D),
                             voxel_size=vs)
    frames_cached = []
    for f in range(args.frames):
        T_cw = orbit_pose(2 * math.pi * f / args.frames)
        frames_cached.append((synthetic.render_depth(world, T_cw, intr,
                                                     (h, w)), T_cw))
    occ_blocks = max(int(tsdf.band_block_occupancy(vol_b, d, intr, T))
                     for d, T in frames_cached)
    block_cap = ((int(occ_blocks * 1.15) + 127) // 128) * 128
    t_band = []
    for d, T in frames_cached:
        t0 = time.perf_counter()
        vol_b, ovf_b = tsdf.integrate_depth_banded(vol_b, d, intr, T,
                                                   block_cap=block_cap)
        jax.block_until_ready(vol_b.tsdf)
        t_band.append(time.perf_counter() - t0)
        assert not bool(ovf_b), "banded block_cap overflowed"

    def timed(fn):
        t0 = time.perf_counter()
        cold = fn()
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = fn()
        return warm, 1e3 * t_cold, 1e3 * (time.perf_counter() - t0)

    occ = int(tsdf.surface_occupancy(rec.volume))

    def do_surface():
        s = rec.surface()
        jax.block_until_ready(s.points)
        return s

    surf, t_surf_cold, t_surf = timed(do_surface)
    assert not bool(surf.overflowed), "capacity-from-occupancy overflowed"

    T_wc = np.linalg.inv(orbit_pose(0.0))

    def do_ray():
        view = tsdf.raycast_depth(rec.volume, intr, T_wc, (h, w))
        jax.block_until_ready(view)
        return view

    _, t_ray_cold, t_ray = timed(do_ray)

    def do_match():
        out = rec.recognize()["blob"]
        jax.block_until_ready(out.pose)
        return out

    out, t_match_cold, t_match = timed(do_match)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0, 0, 1.0]
    td, rd = (float(x) for x in tr.ht_dist(np.asarray(out.pose), T_true))

    # ---- KinFu tracking loop (BASELINE config 5 in substance): a SECOND
    # pass over the trajectory consuming RAW depth — only the first frame
    # is posed; every later pose comes from frame-to-model projective ICP,
    # each initialized from the PREVIOUS frame's tracked pose (so initial
    # error = inter-frame motion + accumulated drift, reported below) —
    # then recognition re-runs on the tracked-and-fused volume.
    vol2 = tsdf.make_volume(origin=(-2.5, -2.5, -1.5), dims=(D, D, D),
                            voxel_size=vs)
    rec2 = tsdf.StreamingRecognizer(vol2, cfg)
    rec2.register_model("blob", desc)
    # Inter-frame motion must sit inside projective ICP's convergence
    # basin (Newcombe §3.5 small-motion assumption): 7.5°/frame over the
    # full orbit. The original 45°-step pass converged every frame onto
    # the blob's rotationally-symmetric attractor at the frame-0 pose and
    # fused garbage — the failure that motivated the tracking_lost gate.
    #
    # The tracked world also needs yaw-constraining geometry (see
    # tracking_clutter); recognition still targets the blob among these
    # distractors.
    world_t = np.concatenate([world] + tracking_clutter()) \
        .astype(np.float32)
    n_track = max(6 * args.frames, 48)
    drift = []
    t_trk = []
    lost_frames = 0
    for f in range(n_track):
        T_gt = orbit_pose(2 * math.pi * f / n_track)
        depth = synthetic.render_depth(world_t, T_gt, intr, (h, w))
        t0 = time.perf_counter()
        res_t = rec2.track_depth_frame(depth, intr,
                                       T_cw_hint=T_gt if f == 0 else None)
        jax.block_until_ready(rec2.volume.tsdf)
        t_trk.append(time.perf_counter() - t0)
        if f > 0:
            lost_frames += int(rec2.tracking_lost)
            tdt, rdt = (float(x) for x in tr.ht_dist(rec2.T_cw, T_gt))
            drift.append({"frame": f, "trans": tdt,
                          "rot_deg": math.degrees(rdt),
                          "inliers": int(res_t.inliers),
                          "overlap": int(res_t.overlap),
                          "rms": float(res_t.rms)})
    out2 = rec2.recognize()["blob"]
    td2, rd2 = (float(x) for x in tr.ht_dist(np.asarray(out2.pose), T_true))

    print(json.dumps({
        "dims": D, "voxel_size": vs, "frames": args.frames,
        "integrate_ms_per_frame": 1e3 * float(np.mean(t_int[1:])),
        "integrate_banded_ms_per_frame": 1e3 * float(np.mean(t_band[1:])),
        "band_blocks_max": occ_blocks,
        "band_block_cap": block_cap,
        "band_blocks_total": (D // 8) ** 3,
        "surface_occupancy": occ,
        "surface_capacity_used": int(surf.points.shape[0]),
        "extract_ms": t_surf, "extract_ms_cold": t_surf_cold,
        "raycast_ms": t_ray, "raycast_ms_cold": t_ray_cold,
        "recognize_ms": t_match, "recognize_ms_cold": t_match_cold,
        "trans_err": td, "rot_err_deg": math.degrees(rd),
        "match": bool(td < 0.1 * desc.diameter and rd < math.radians(12)),
        "tracking": {
            "frames_tracked": n_track - 1,
            "deg_per_frame": 360.0 / n_track,
            "lost_frames": lost_frames,
            "track_ms_per_frame": 1e3 * float(np.mean(t_trk[1:])),
            "max_drift_trans": max(d["trans"] for d in drift),
            "max_drift_rot_deg": max(d["rot_deg"] for d in drift),
            "per_frame": drift,
            "recognize_trans_err": td2,
            "recognize_rot_err_deg": math.degrees(rd2),
            "recognize_match": bool(td2 < 0.1 * desc.diameter
                                    and rd2 < math.radians(12)),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
