"""Multi-instance (bin-picking) recall/precision study.

The reference returns only the single argmax winner (model.cu:293-295)
even though its candidate list contains every instance's Hough peak; the
rebuild's `drost.extract_instances` recovers all of them by greedy
translation-NMS over the clustered candidates. This harness quantifies
that claim: scenes with k planted instances among planar clutter, recall
(planted instances recovered) and precision (extracted poses that are real
instances) per k, over multiple seeds.

Usage:
  python tools/eval_instances.py [--seeds 8] [--ks 2,4,6] [--out PATH]
  python tools/eval_instances.py --quick      # CI smoke
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


def build_scene(rng, mp_raw, mn_raw, k, n_total, n_inst_pts):
    """k instances among surface-like planar clutter (bench.py scene
    recipe, parameterized by instance count)."""
    from objective_slam_tpu.utils import synthetic

    n_clutter = n_total - k * n_inst_pts
    per = n_clutter // 8
    cps, cns = [], []
    for b in range(8):
        cnt = per if b < 7 else n_clutter - 7 * per
        u = rng.uniform(-1.5, 1.5, size=(cnt, 2))
        z = rng.normal(scale=0.01, size=(cnt, 1))
        pts = np.concatenate([u, z], axis=1)
        q = synthetic.random_rotation_quat(rng)
        R = synthetic.quat_to_matrix(q)
        offset = rng.uniform(-3.0, 5.0, size=3)
        cps.append(pts @ R.T + offset)
        nrm = np.tile(R[:, 2], (cnt, 1)) + rng.normal(scale=0.02,
                                                      size=(cnt, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        cns.append(nrm)
    sp = np.concatenate(cps).astype(np.float32)
    sn = np.concatenate(cns).astype(np.float32)

    diam = float(np.linalg.norm(mp_raw.max(0) - mp_raw.min(0)))
    truths, centers = [], []
    for _ in range(k):
        sel = rng.choice(len(mp_raw), size=n_inst_pts, replace=False)
        # Bounded rejection sampling with separation relaxation: at k = 6
        # the full-diameter pairwise constraint in this box is a
        # near-measure-zero event for uniform draws (the unbounded loop
        # spun for CPU-hours), so after each failed batch the separation
        # relaxes 10%. It never drops below 0.75·diam — still above
        # extract_instances' 0.7·diam NMS radius, so distinct instances
        # remain distinguishable by construction.
        sep = diam
        t, best, best_d = None, None, -1.0
        for _batch in range(50):
            cand = rng.uniform(-2.8, 2.8, size=(2000, 3)).astype(np.float32)
            dmin = np.full(len(cand), np.inf)
            for c in centers:
                dmin = np.minimum(dmin, np.linalg.norm(cand - c, axis=1))
            i = int(np.argmax(dmin))
            if dmin[i] > sep:
                t = cand[i]
                break
            if dmin[i] > best_d:
                best_d, best = float(dmin[i]), cand[i]
            sep = max(0.9 * sep, 0.75 * diam)
        if t is None:
            t = best          # farthest-candidate fallback: terminates
        centers.append(t)
        sp, sn, T = synthetic.plant_model(rng, mp_raw[sel], mn_raw[sel],
                                          sp, sn, translation=t)
        truths.append(T)
    return sp, sn, truths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--ks", type=str, default="2,4,6")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", type=str, default="/tmp/eval_instances.json")
    ap.add_argument("--accelerator", action="store_true",
                    help="run on JAX's default device; recognition rates "
                         "are platform-independent, so the default is the "
                         "CPU (set post-import through jax.config)")
    args = ap.parse_args(argv)
    if not args.accelerator:
        import jax
        jax.config.update("jax_platforms", "cpu")
    ks = [int(x) for x in args.ks.split(",")]
    n_model_raw, n_total, n_inst_pts = 20_000, 80_000, 10_000
    if args.quick:
        args.seeds, ks = 2, [2]
        n_model_raw, n_total, n_inst_pts = 2_000, 8_000, 1_000

    import objective_slam_tpu as ost
    from objective_slam_tpu.config import PPFConfig
    from objective_slam_tpu.models import drost
    from objective_slam_tpu.utils import (pointcloud as pc, synthetic,
                                          validation)

    t0 = time.time()
    rng0 = np.random.default_rng(99)
    mp_raw, mn_raw = synthetic.blob_cloud(rng0, n_model_raw)
    # Multi-instance prescription (extract_instances docstring): parity
    # center-cell mode + a top-K budget that can hold every instance's
    # candidate cells.
    cfg = PPFConfig(max_poses=1024, ref_point_df=5,
                    cluster_center_cell=True)
    d_dist = cfg.tau_d * pc.bbox_diameter(mp_raw)
    mp, mn = pc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    desc = ost.build_model_description(mp, mn, cfg, d_dist=d_dist)
    scene_leaf = 0.5 * d_dist

    # Static voxel capacity across every (k, seed): probe BOTH k extremes
    # (low k = more planar clutter, high k = more instance surface — either
    # can dominate the voxel count), pad 15%, round to lanes — the whole
    # sweep then compiles ONCE per vote-capacity bucket instead of once per
    # scene (pad rows sit at the far sentinel with zero normals —
    # unmatchable).
    probe = [pc.voxel_downsample_np(
        *build_scene(np.random.default_rng(10_000 * k + s),
                     mp_raw, mn_raw, k, n_total, n_inst_pts)[:2],
        scene_leaf)[0].shape[0]
        for k in {min(ks), max(ks)} for s in range(2)]
    capacity = ((int(max(probe) * 1.15) + 127) // 128) * 128
    print(f"[inst] probed occupancies {probe}, capacity {capacity}",
          file=sys.stderr, flush=True)

    rows = []
    for k in ks:
        for s in range(args.seeds):
            rng = np.random.default_rng(10_000 * k + s)
            sp, sn, truths = build_scene(rng, mp_raw, mn_raw, k,
                                         n_total, n_inst_pts)
            vox = pc.voxel_downsample(sp, sn, scene_leaf,
                                      capacity=capacity)
            assert not bool(vox.dropped)
            res = ost.match(desc, vox.points, vox.normals, cfg)
            poses, counts = drost.extract_instances(
                res, desc.diameter, max_instances=2 * k)
            matched_truth = [any(
                validation.validate_pose(p, T, desc.diameter, cfg).match
                for p in poses) for T in truths]
            pose_real = [any(
                validation.validate_pose(p, T, desc.diameter, cfg).match
                for T in truths) for p in poses]
            rows.append({
                "k": k, "seed": s,
                "recall": float(np.mean(matched_truth)),
                "precision": float(np.mean(pose_real)) if poses else 1.0,
                "n_extracted": len(poses),
                "overflowed": bool(res.overflowed),
                "topk_saturated": bool(res.topk_saturated),
            })
            print(f"[inst] k={k} seed={s}: recall "
                  f"{rows[-1]['recall']:.2f} precision "
                  f"{rows[-1]['precision']:.2f} extracted {len(poses)} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)

    summary = {"seeds": args.seeds, "per_k": {}}
    for k in ks:
        sel = [r for r in rows if r["k"] == k]
        summary["per_k"][str(k)] = {
            "recall": float(np.mean([r["recall"] for r in sel])),
            "precision": float(np.mean([r["precision"] for r in sel])),
            "perfect_scenes": int(sum(r["recall"] == 1.0 for r in sel)),
            "n_scenes": len(sel),
        }
    summary["rows"] = rows
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({key: v for key, v in summary.items()
                      if key != "rows"}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
