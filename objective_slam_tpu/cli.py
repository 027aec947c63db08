"""Command-line registration app — the `alignment` binary equivalent.

Mirrors the reference CLI's flag surface (configure_options,
pcl/alignment/src/alignment.cpp:119-172) and flow (main, :191-398):
load PLYs -> estimate model diameters -> voxel-grid downsample ->
ppf_registration -> optional ground-truth validation printing a bare 0/1
match bit per (scene, model) pair on stdout -> optional visualization
(exported as a colored PLY / PNG instead of a PCLVisualizer window).

Usage:
  python -m objective_slam_tpu.cli --scene_files s.ply --model_files m.ply \
      --tau_d 0.1 [--validation_files t.txt] [--logfile run.log] ...
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from objective_slam_tpu.config import PPFConfig
from objective_slam_tpu.pipeline import ppf_registration
from objective_slam_tpu.utils import ply, pointcloud as pc, validation

log = logging.getLogger("objective_slam_tpu")


def csv_list(value: str) -> list[str]:
    """Comma-separated list (the reference's CommaSeparatedVector,
    alignment.cpp:92-117)."""
    return [v for v in value.split(",") if v]


def configure_options(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="objective_slam_tpu",
        description="PPF 6-DoF registration")
    # runstate parameters (alignment.cpp:123-127)
    p.add_argument("--dev", type=int, default=0,
                   help="JAX device index to use")
    p.add_argument("--logfile", type=str, default=None, help="log file")
    p.add_argument("--loglevel", type=str, default="info",
                   choices=["trace", "debug", "info", "warning", "error",
                            "fatal"])
    # algorithm parameters (alignment.cpp:129-144)
    p.add_argument("--tau_d", type=csv_list, required=True,
                   help="per-model voxel grid factors (CSV)")
    p.add_argument("--scene_leaf_size", type=float, default=10.0)
    p.add_argument("--ref_point_df", type=int, default=1,
                   help="scene reference point downsample factor")
    p.add_argument("--vote_count_threshold", type=float, default=0.4)
    p.add_argument("--cpu_clustering", type=lambda s: s.lower() == "true",
                   default=False)
    p.add_argument("--use_l1_norm", type=lambda s: s.lower() == "true",
                   default=False)
    p.add_argument("--use_averaged_clusters",
                   type=lambda s: s.lower() == "true", default=False)
    p.add_argument("--validation_translation_threshold", type=float,
                   default=0.1)
    p.add_argument("--validation_rotation_threshold", type=float,
                   default=12.0)
    # input files (alignment.cpp:146-152)
    p.add_argument("--scene_files", type=csv_list, required=True)
    p.add_argument("--model_files", type=csv_list, required=True)
    p.add_argument("--validation_files", type=csv_list, default=None)
    # output parameters (alignment.cpp:154-157)
    p.add_argument("--show_normals", type=lambda s: s.lower() == "true",
                   default=True)
    p.add_argument("--visualize", type=lambda s: s.lower() == "true",
                   default=False)
    p.add_argument("--visualize_out", type=str, default="alignment_vis",
                   help="basename for exported visualization files")
    p.add_argument("--visualize_html", type=lambda s: s.lower() == "true",
                   default=True,
                   help="with --visualize, also write an INTERACTIVE "
                        "self-contained WebGL viewer (<out>.html): orbit/"
                        "pan/zoom, per-cloud toggles, normals overlay — "
                        "the display-server-free equivalent of the "
                        "PCLVisualizer window (alignment.cpp:337-396)")
    # rebuild extensions
    p.add_argument("--estimate_normals_k", type=int, default=0,
                   help="if >0, (re-)estimate normals with k-NN PCA when "
                        "a PLY lacks them")
    p.add_argument("--smooth_normals", type=int, default=0,
                   help="if >0, smooth SCENE normals with this many "
                        "grid passes at --scene_leaf_size before "
                        "downsampling (sensor-noise denoising; "
                        "smooth_normals_grid). Pair with --icp_iterations: "
                        "smoothing adds a small coherent orientation bias "
                        "that unrefined Hough poses pay for, ICP pulls "
                        "back (EVAL.md 'Normal smoothing at sigma=0.5')")
    p.add_argument("--smooth_normals_order", type=int, default=1,
                   choices=[0, 1],
                   help="0 = box mean over the grid window; 1 (default) = "
                        "linear MLS fit evaluated at the query point, "
                        "cancelling the window's first-order curvature "
                        "bias at the cost of a 22-channel moment grid")
    p.add_argument("--max_poses", type=int, default=1024)
    p.add_argument("--engine", type=str, default="fast",
                   choices=["fast", "reference", "correlation"],
                   help="voting engine (see PPFConfig.engine)")
    p.add_argument("--runs_cap", type=int, default=0,
                   help="correlation engine only: starting unique-cell "
                        "compaction capacity (0 = auto heuristic + "
                        "overflow retry). Set above the known cell count "
                        "when batching same-shaped scenes to avoid one "
                        "retry recompile per match")
    p.add_argument("--use_fnv_keys", type=lambda s: s.lower() == "true",
                   default=False,
                   help="match through bit-exact FNV-1a feature hashes "
                        "including the reference's collision behavior "
                        "(parity mode; see PPFConfig.use_fnv_keys)")
    p.add_argument("--rescore_poses", type=lambda s: s.lower() == "true",
                   default=False,
                   help="re-rank threshold survivors by geometric inlier "
                        "score (extension; see PPFConfig.rescore_poses)")
    p.add_argument("--cluster_center_cell",
                   type=lambda s: s.lower() == "true", default=False,
                   help="include a pose's own translation cell in its "
                        "cluster neighborhood (True = corrected mode; False "
                        "= reference quirk, kernel.cu:684-689)")
    p.add_argument("--icp_iterations", type=int, default=0,
                   help="if >0, refine each pose with this many ICP "
                        "iterations (extension; not in the reference)")
    p.add_argument("--icp_max_dist_factor", type=float, default=2.0,
                   help="ICP correspondence rejection radius as a multiple "
                        "of d_dist; tighten (e.g. 1.0) for partial views "
                        "so occluded model points don't latch onto clutter")
    p.add_argument("--icp_point_to_plane",
                   type=lambda s: s.lower() == "true", default=False,
                   help="point-to-plane ICP error metric (needs scene "
                        "normals). Point-to-point slides on near-planar "
                        "geometry (thin blades, slabs); point-to-plane "
                        "locks it (e.g. scapula: 10.6 -> 2.4 mm)")
    p.add_argument("--normal_aware_downsample",
                   type=lambda s: s.lower() == "true", default=False,
                   help="voxel-downsample with normal-octant-extended cell "
                        "keys (scene AND model). pcl::VoxelGrid centroid "
                        "semantics (default) collapse geometry thinner "
                        "than the leaf — both sides of a blade/shell land "
                        "in one cell and the averaged normal cancels; "
                        "octant keys keep one point per side. Required "
                        "for thin real scans (bones); no-op for solid "
                        "chunky models")
    p.add_argument("--scene_capacity", type=int, default=0,
                   help="if >0, voxel-downsample scenes ON DEVICE to this "
                        "static padded capacity (pad rows are unmatchable "
                        "sentinels). Keeps shapes identical across scenes "
                        "so batch runs over a dataset compile ONCE per "
                        "model instead of once per scene")
    return p.parse_args(argv)


_LEVELS = {"trace": logging.DEBUG, "debug": logging.DEBUG,
           "info": logging.INFO, "warning": logging.WARNING,
           "error": logging.ERROR, "fatal": logging.CRITICAL}


def init_logging(args) -> None:
    """File sink with timestamps + severity filter (init_logging,
    alignment.cpp:174-189)."""
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if args.logfile:
        handlers.append(logging.FileHandler(args.logfile))
    logging.basicConfig(
        level=_LEVELS[args.loglevel],
        format="[%(asctime)s]: %(message)s",
        handlers=handlers, force=True)


def _load_cloud(path, args):
    cloud = ply.read_ply(path)
    pts = cloud.points
    nrm = cloud.normals
    if nrm is None:
        if cloud.faces is not None:
            nrm = pc.mesh_vertex_normals(pts, cloud.faces)
        elif args.estimate_normals_k > 0:
            nrm = np.asarray(pc.estimate_normals_knn(
                pts, k=args.estimate_normals_k, orient="outward"))
        else:
            raise SystemExit(
                f"{path}: no normals; pass --estimate_normals_k or provide "
                "a mesh")
    return pts, nrm


def main(argv=None) -> int:
    args = configure_options(argv)
    init_logging(args)
    log.info(" ".join(sys.argv if argv is None else ["cli"] + list(argv)))

    # --dev parity (ppf.cu:37-49): pin computation to the chosen device,
    # clamped like the reference's min(numDevices-1, devUse).
    import jax
    devices = jax.devices()
    dev = min(len(devices) - 1, max(args.dev, 0))
    log.info("Found %d devices; using device %d (%s)", len(devices), dev,
             devices[dev])
    with jax.default_device(devices[dev]):
        return _run(args)


def _run(args) -> int:
    scene_clouds = []
    for f in args.scene_files:
        log.info("Loading scene point cloud: %s", f)
        sp, sn = _load_cloud(f, args)
        if args.smooth_normals > 0:
            # Smooth the full-resolution scan's normal FIELD before any
            # downsampling so the voxelized matcher input AND the ICP
            # refinement cloud (which is this pre-downsample scan) share
            # the denoised orientation — the eval harness protocol.
            sn = np.asarray(pc.smooth_normals_grid(
                sp, sn, args.scene_leaf_size,
                iterations=args.smooth_normals,
                order=args.smooth_normals_order))
            log.info("Smoothed scene normals: %d passes, order %d, "
                     "radius %g", args.smooth_normals,
                     args.smooth_normals_order, args.scene_leaf_size)
        scene_clouds.append((sp, sn))

    if len(args.tau_d) != len(args.model_files):
        log.error("Each model must have an associated tau_d.")
        return 1
    tau_d = [float(t) for t in args.tau_d]

    model_clouds = []
    model_d_dists = []
    for i, f in enumerate(args.model_files):
        log.info("Loading model point cloud: %s", f)
        mp, mn = _load_cloud(f, args)
        diam = pc.bbox_diameter(mp)   # bbox-edge approx, alignment.cpp:246-253
        model_d_dists.append(tau_d[i] * diam)
        log.debug("model_diam, d_dist: %f, %f", diam, model_d_dists[-1])
        model_clouds.append((mp, mn))

    # Downsample (alignment.cpp:259-288).
    log.info("Downsampling...")
    ds_scenes = []
    viz_scenes = []     # pad-free twins: --scene_capacity pads ds_scenes
                        # with far-sentinel rows (lo − 1e7) that must never
                        # reach the PLY/PNG/HTML export — they blow the
                        # viewer's bounding box out by 1e7.
    for sp, sn in scene_clouds:
        log.info("Scene size before filtering: %d", len(sp))
        if args.scene_capacity > 0:
            vox = pc.voxel_downsample(sp, sn, args.scene_leaf_size,
                                      capacity=args.scene_capacity,
                                      normal_aware=args.
                                      normal_aware_downsample)
            if bool(vox.dropped):
                log.error("scene exceeds --scene_capacity %d; raise it",
                          args.scene_capacity)
                return 1
            sp2 = np.asarray(vox.points)
            sn2 = np.asarray(vox.normals)
            log.info("Scene size after filtering: %d (padded to %d)",
                     int(vox.num_voxels), args.scene_capacity)
            nv = int(vox.num_voxels)
            viz_scenes.append((sp2[:nv], sn2[:nv]))
        else:
            sp2, sn2 = pc.voxel_downsample_np(
                sp, sn, args.scene_leaf_size,
                normal_aware=args.normal_aware_downsample)
            log.info("Scene size after filtering: %d", len(sp2))
            viz_scenes.append((sp2, sn2))
        ds_scenes.append((sp2, sn2))
    ds_models = []
    for (mp, mn), dd in zip(model_clouds, model_d_dists):
        log.info("Model size before filtering: %d", len(mp))
        mp2, mn2 = pc.voxel_downsample_np(
            mp, mn, dd, normal_aware=args.normal_aware_downsample)
        log.info("Model size after filtering: %d", len(mp2))
        ds_models.append((mp2, mn2))

    cfg = PPFConfig(
        ref_point_df=args.ref_point_df,
        vote_count_threshold=args.vote_count_threshold,
        use_l1_norm=args.use_l1_norm,
        use_averaged_clusters=args.use_averaged_clusters,
        validation_translation_threshold=args.validation_translation_threshold,
        validation_rotation_threshold_deg=args.validation_rotation_threshold,
        scene_leaf_size=args.scene_leaf_size,
        max_poses=args.max_poses,
        engine=args.engine,
        use_fnv_keys=args.use_fnv_keys,
        rescore_poses=args.rescore_poses,
        cluster_center_cell=args.cluster_center_cell,
        refine_icp=args.icp_iterations > 0,
        icp_iterations=max(args.icp_iterations, 1),
        icp_max_dist_factor=args.icp_max_dist_factor,
        icp_point_to_plane=args.icp_point_to_plane)

    # ICP (if enabled) refines against the PRE-downsample scans — the
    # voxelized cloud's spacing would floor the achievable accuracy.
    out = ppf_registration(ds_scenes, ds_models, model_d_dists, cfg,
                           cpu_clustering=args.cpu_clustering,
                           icp_clouds=scene_clouds,
                           runs_cap=args.runs_cap or None)

    if args.validation_files:
        for i in range(len(ds_scenes)):
            for j in range(len(ds_models)):
                truth = validation.read_truth_file(
                    args.validation_files[i * len(ds_models) + j])
                log.info("Transformations for %s in %s:",
                         args.model_files[j], args.scene_files[i])
                log.info("Estimated transformation:\n%s", out.poses[i][j])
                log.info("Ground truth:\n%s", truth)
                model_diam = model_d_dists[j] / tau_d[j]
                v = validation.validate_pose(out.poses[i][j], truth,
                                             model_diam, cfg)
                log.info("Distance (trans, rot): %f, %f", v.trans_err,
                         v.rot_err)
                log.info("Threshold (validation_translation_threshold"
                         "*model_diam , 12 deg): %f, %f",
                         v.trans_thresh, v.rot_thresh)
                log.info("Match (trans, rot): %d, %d", v.trans_match,
                         v.rot_match)
                # The machine-readable match bit (alignment.cpp:332).
                print(int(v.match))

    if args.visualize:
        _export_visualization(args, viz_scenes, ds_models, out.poses)
    return 0


def _export_visualization(args, scenes, models, poses) -> None:
    """No-window visualization: write a combined colored PLY (and a PNG if
    matplotlib is available) — replaces the PCLVisualizer loop
    (alignment.cpp:337-396). --show_normals (the viewer's normals overlay,
    alignment.cpp:354-360) writes nx/ny/nz vertex properties into the PLY
    and draws a quiver subsample in the PNG."""
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255),
              (0, 255, 255), (255, 0, 255), (255, 255, 0)]
    all_pts, all_nrm, all_cols = [], [], []
    for sp, sn in scenes:
        all_pts.append(sp)
        all_nrm.append(sn)
        all_cols.append(np.full((len(sp), 3), 255, np.uint8))
    for i in range(len(scenes)):
        for j, (mp, mn) in enumerate(models):
            T = poses[i][j]
            moved = mp @ T[:3, :3].T + T[:3, 3]
            all_pts.append(moved.astype(np.float32))
            all_nrm.append((mn @ T[:3, :3].T).astype(np.float32))
            c = colors[(i * len(models) + j) % len(colors)]
            all_cols.append(np.tile(np.asarray(c, np.uint8), (len(mp), 1)))
    pts = np.concatenate(all_pts)
    nrm = np.concatenate(all_nrm)
    cols = np.concatenate(all_cols)
    out_ply = args.visualize_out + ".ply"
    nrm_props = ("property float nx\nproperty float ny\nproperty float nz\n"
                 if args.show_normals else "")
    with open(out_ply, "wb") as f:
        header = ("ply\nformat binary_little_endian 1.0\n"
                  f"element vertex {len(pts)}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  + nrm_props +
                  "property uchar red\nproperty uchar green\n"
                  "property uchar blue\nend_header\n")
        f.write(header.encode())
        if args.show_normals:
            rec = np.empty(len(pts), dtype=[("p", "<f4", (3,)),
                                            ("n", "<f4", (3,)),
                                            ("c", "u1", (3,))])
            rec["n"] = nrm
        else:
            rec = np.empty(len(pts), dtype=[("p", "<f4", (3,)),
                                            ("c", "u1", (3,))])
        rec["p"] = pts
        rec["c"] = cols
        f.write(rec.tobytes())
    log.info("visualization written: %s", out_ply)
    if getattr(args, "visualize_html", False):
        from objective_slam_tpu.utils import html_viewer
        clouds = [{"points": sp, "normals": sn, "name": f"scene{i}"}
                  for i, (sp, sn) in enumerate(scenes)]
        ci = 0
        for i in range(len(scenes)):
            for j, (mp, mn) in enumerate(models):
                T = poses[i][j]
                clouds.append({
                    "points": (mp @ T[:3, :3].T + T[:3, 3]).astype(
                        np.float32),
                    "normals": (mn @ T[:3, :3].T).astype(np.float32),
                    "color": html_viewer.default_color(ci),
                    "name": f"model{j}@scene{i}"})
                ci += 1
        html_viewer.write_html_viewer(args.visualize_out + ".html", clouds,
                                      title="alignment result")
        log.info("visualization written: %s.html", args.visualize_out)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
        step = max(1, len(pts) // 20000)
        ax.scatter(pts[::step, 0], pts[::step, 1], pts[::step, 2],
                   c=cols[::step] / 255.0, s=1)
        if args.show_normals:
            # Quiver a sparse subsample, scaled to ~2% of the scene extent
            # (the PCLVisualizer overlay draws every 10th normal at level
            # 0.02, alignment.cpp:354-360).
            qstep = max(1, len(pts) // 2000)
            extent = float(np.ptp(pts, axis=0).max())
            ax.quiver(pts[::qstep, 0], pts[::qstep, 1], pts[::qstep, 2],
                      nrm[::qstep, 0], nrm[::qstep, 1], nrm[::qstep, 2],
                      length=0.02 * extent, normalize=True,
                      color="gray", linewidth=0.3)
        fig.savefig(args.visualize_out + ".png", dpi=120)
        log.info("visualization written: %s.png", args.visualize_out)
    except Exception as e:  # matplotlib optional
        log.debug("png export skipped: %s", e)


if __name__ == "__main__":
    sys.exit(main())
