"""Quantify raycast_depth's documented semantic gaps vs a dense march.

`models/tsdf.raycast_depth` (coarse-to-fine: 1-gather nearest reads of a
3³-min-pooled field bracket the crossing, then a trilinear fine window)
documents two classes of pixels that read 0 where a dense all-trilinear
march finds a surface (tsdf.py:400-404):
  (a) rays beyond the grazing-incidence bound (~79° at the defaults) — a
      sub-pixel silhouette ring;
  (b) rays that graze within one voxel of a CLOSER surface, then hit a
      farther one more than 9·dt later.

This study turns that assertion into a measurement (VERDICT r4 weak-6): it
fuses the tsdf_smoke tabletop scene into a 256³ volume, renders the same
tracking view with BOTH raycasts, and reports

  - %% of pixels where the dense march hits and coarse-to-fine reads 0
    (the documented gap), and the converse,
  - what fraction of those gap pixels are within 1 px of the dense hit
    mask's silhouette edge (the "ring" claim),
  - depth agreement on pixels both rays hit.

The dense reference marches the SAME trilinear sampler at fine resolution
(n_dense steps over [t_near, t_far]) with no coarse bracket — the
semantics raycast_depth approximates, at ~n_dense·16 gathers/pixel.

CPU-feasible (the comparison is platform-independent); ~2 min at the
defaults. Writes one JSON line; use --out to also store it.

Usage: python tools/raycast_gap_study.py [--dims 256] [--img 240] [--cpu]
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


def dense_trilinear_depth(volume, intrinsics, T_wc, shape, t_near, t_far,
                          n_dense):
    """All-trilinear first-crossing march — the reference semantics
    raycast_depth's coarse-to-fine approximates. Mirrors tsdf.raycast_depth's
    trilinear `sample` exactly (weight-masked, unobserved reads +τ) so the
    only difference under study is the coarse bracketing."""
    import jax
    import jax.numpy as jnp

    h, w = shape
    fx, fy, cx, cy = (jnp.float32(v) for v in intrinsics)
    T = jnp.asarray(T_wc, jnp.float32)
    D, H, W = volume.dims

    uu = jnp.arange(w, dtype=jnp.float32)
    vv = jnp.arange(h, dtype=jnp.float32)
    gu, gv = jnp.meshgrid(uu, vv, indexing="xy")
    dirs_c = jnp.stack([(gu - cx) / fx, (gv - cy) / fy,
                        jnp.ones_like(gu)], axis=-1)
    dirs_w = jnp.einsum("ij,hwj->hwi", T[:3, :3], dirs_c,
                        precision=jax.lax.Precision.HIGHEST)
    org_w = T[:3, 3]

    def sample(t):
        pos = (org_w + dirs_w * t[..., None] - volume.origin) \
            / volume.voxel_size - 0.5
        base = jnp.floor(pos).astype(jnp.int32)
        frac = pos - base.astype(jnp.float32)
        val = jnp.zeros(pos.shape[:2], jnp.float32)
        wsum = jnp.zeros(pos.shape[:2], jnp.float32)
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    ii = base[..., 0] + di
                    jj = base[..., 1] + dj
                    kk = base[..., 2] + dk
                    inside = ((ii >= 0) & (ii < D) & (jj >= 0) & (jj < H)
                              & (kk >= 0) & (kk < W))
                    ci = jnp.clip(ii, 0, D - 1)
                    cj = jnp.clip(jj, 0, H - 1)
                    ck = jnp.clip(kk, 0, W - 1)
                    tv = volume.tsdf[ci, cj, ck]
                    wv = volume.weight[ci, cj, ck]
                    wt = (jnp.where(di, frac[..., 0], 1 - frac[..., 0])
                          * jnp.where(dj, frac[..., 1], 1 - frac[..., 1])
                          * jnp.where(dk, frac[..., 2], 1 - frac[..., 2]))
                    ok = inside & (wv > 0)
                    val = val + jnp.where(ok, wt * tv, 0.0)
                    wsum = wsum + jnp.where(ok, wt, 0.0)
        return jnp.where(wsum > 0.5, val / jnp.maximum(wsum, 1e-9),
                         jnp.float32(volume.truncation))

    ts = jnp.linspace(t_near, t_far, n_dense).astype(jnp.float32)

    def step(carry, t_scalar):
        prev_t, prev_v, hit = carry
        t_now = jnp.broadcast_to(t_scalar, (h, w))
        v_now = sample(t_now)
        crossed = (prev_v > 0) & (v_now <= 0) & (hit == 0.0)
        frac = prev_v / jnp.maximum(prev_v - v_now, 1e-9)
        d_hit = prev_t + frac * (t_now - prev_t)
        hit = jnp.where(crossed, d_hit, hit)
        return (t_now, v_now, hit), None

    t0v = jnp.broadcast_to(ts[0], (h, w))
    init = (t0v, sample(t0v), jnp.zeros((h, w), jnp.float32))
    (_, _, hit), _ = jax.lax.scan(step, init, ts[1:])
    return hit


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, default=256)
    ap.add_argument("--img", type=int, default=240)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--n_dense", type=int, default=768)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (keeps the card free)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--dump", type=str, default=None,
                    help="also save the two depth maps (npz) for offline "
                         "inspection of where the gap pixels sit")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from objective_slam_tpu.models import tsdf
    from objective_slam_tpu.utils import pointcloud as pc, synthetic

    t0 = time.time()
    # The tsdf_smoke tabletop scene, verbatim (object on a plane, 8-view
    # orbit), so the number lands on the same volume the smoke times.
    rng = np.random.default_rng(0)
    verts, faces = synthetic.bumpy_mesh(subdiv=4, bumps=0.35)
    mp, _mn = pc.sample_mesh_surface(verts, faces, 40_000, rng)
    obj = mp + np.float32([0, 0, 1.0])
    u = rng.uniform(-2.2, 2.2, size=(40_000, 2)).astype(np.float32)
    plane = np.concatenate([u, np.full((len(u), 1), -1.05, np.float32)],
                           axis=1)
    world = np.concatenate([obj, plane]).astype(np.float32)

    D = args.dims
    vs = 5.0 / D
    vol = tsdf.make_volume(origin=(-2.5, -2.5, -1.5), dims=(D, D, D),
                           voxel_size=vs)
    h = w = args.img
    intr = (0.9 * w, 0.9 * w, w / 2 - 0.5, h / 2 - 0.5)
    for f in range(args.frames):
        ang = 2 * math.pi * f / args.frames
        eye = np.float32([3.2 * math.cos(ang), 3.2 * math.sin(ang), 1.6])
        T_cw = synthetic.look_at(eye, (0, 0, 0.5))
        depth = synthetic.render_depth(world, T_cw, intr, (h, w))
        vol = tsdf.integrate_depth(vol, depth, intr, T_cw)
    jax.block_until_ready(vol.tsdf)
    print(f"[gap] fused {args.frames} frames ({time.time()-t0:.0f}s)",
          file=sys.stderr, flush=True)

    T_wc = np.linalg.inv(synthetic.look_at(
        np.float32([3.2, 0, 1.6]), (0, 0, 0.5)))
    t_near, t_far = 0.1, 6.0

    cf = np.asarray(tsdf.raycast_depth(vol, intr, T_wc, (h, w),
                                       t_near=t_near, t_far=t_far))
    dense = np.asarray(dense_trilinear_depth(
        vol, intr, T_wc, (h, w), t_near, t_far, args.n_dense))
    print(f"[gap] both raycasts done ({time.time()-t0:.0f}s)",
          file=sys.stderr, flush=True)

    hit_cf = cf > 0
    hit_dn = dense > 0
    miss_cf = hit_dn & ~hit_cf          # the documented gap classes
    extra_cf = hit_cf & ~hit_dn         # should be ~none (conservative)
    both = hit_cf & hit_dn

    # Silhouette edge of the dense hit mask: a hit pixel with a 4-neighbor
    # miss (or image border). Gap pixels within 1 px of it are the "ring".
    pad = np.pad(hit_dn, 1, constant_values=False)
    nb_miss = (~pad[:-2, 1:-1] | ~pad[2:, 1:-1]
               | ~pad[1:-1, :-2] | ~pad[1:-1, 2:])
    edge = hit_dn & nb_miss
    epad = np.pad(edge, 1, constant_values=False)
    near_edge = np.zeros_like(edge)
    for di in (0, 1, 2):
        for dj in (0, 1, 2):
            near_edge |= epad[di:di + h, dj:dj + w]

    n_miss = int(miss_cf.sum())
    n_ring = int((miss_cf & near_edge).sum())
    dd = np.abs(cf - dense)[both]
    res = {
        "dims": D, "img": args.img, "n_dense": args.n_dense,
        "voxel_size": vs,
        "pixels": int(h * w),
        "dense_hits": int(hit_dn.sum()),
        "cf_hits": int(hit_cf.sum()),
        "missed_by_cf": n_miss,
        "missed_by_cf_pct_of_hits": 100.0 * n_miss / max(hit_dn.sum(), 1),
        "missed_within_1px_of_silhouette": n_ring,
        "missed_interior": n_miss - n_ring,
        "extra_cf_hits": int(extra_cf.sum()),
        "both_hit_abs_depth_diff_median": float(np.median(dd)) if dd.size
        else 0.0,
        "both_hit_abs_depth_diff_p99": float(np.percentile(dd, 99))
        if dd.size else 0.0,
        "both_hit_diff_over_1_voxel": int((dd > vs).sum()),
        "wall_s": time.time() - t0,
    }
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    if args.dump:
        np.savez(args.dump, cf=cf, dense=dense)
    return 0


if __name__ == "__main__":
    sys.exit(main())
