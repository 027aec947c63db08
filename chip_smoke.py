"""Chip smoke: drive the recognizer's main path once on one GPU.

Runs, in one process, through the entry points a user calls:

  device  — platform, device kind, count, JAX version, and the card's name
            and power limit (nvidia-smi, a child process off JAX). Any
            platform but a GPU exits non-zero before the first phase.
  ppf     — the bench workload at seed 0 (20k-point model voxelized to
            ~280 points; 100k-point scene with 4 planted instances among
            planar clutter, ~2.7k voxels; ~49M Hough votes):
            ost.build_model_description, ost.match (count pass + host
            sync) and ost.match_with_state twice — the second call must
            dispatch without a count pass — for engine="fast" (the exact
            block engine) and engine="correlation", ICP against the raw
            scan. Each winner must localise a planted instance
            (translation < 0.1·diameter, rotation < 12°), no overflow.
  kernel  — the device tally gate at bench widths
            (bench.tally_bitequal_check): block engine ≡ legacy fast engine
            bit for bit, α-bin flip rate vs the fp32 readable engine
            < 1e-4 per vote; the readable engine vs the NumPy
            transliteration of the MATLAB semantics (tests/reference_impl)
            on 64 scene points (cell mismatches < 1e-4 per vote: fp32 on
            the card vs fp64 at bin edges); dictionary lookups vs NumPy,
            exactly.
  cli     — the reference's `alignment` surface (objective_slam_tpu.cli)
            on PLY/text files of the seed-0 scene; it must print 1.
  tsdf    — the streaming path at 256³ / 2 cm: fuse 4 depth frames with
            integrate_depth_banded, extract the surface, recognise through
            StreamingRecognizer, track 2 raw frames.

With --four-cards only the device phase and the sharded phase run: the
bench scene through parallel/sharded_match over a 1-D 4-device mesh,
compared with single-device drost._match_core.

Every phase prints its wall times on their own lines — `first` (first
call: compile + run) apart from `warm` (steady state) — beside
peak_bytes_in_use and the card. A failing phase raises; the script then
exits non-zero without the final line. The last stdout line is exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

import bench  # noqa: E402

# nvidia-smi's `name, power.limit` line(s), set by device_phase.
_CARD = "not queried"


def _say(phase: str, **fields) -> None:
    """One result line: `[phase] k=v ...`, then peak memory and the card."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not available")
    kv = " ".join(f"{k}={v}" for k, v in fields.items())
    card = " | ".join(_CARD.splitlines())
    print(f"[{phase}] {kv} peak_bytes_in_use={peak} card={card}",
          flush=True)


def _timed(fn):
    """(result, seconds) of fn() with every output on device finished."""
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def _first_and_warm(fn):
    """Run fn twice: (warm result, first-call seconds, warm seconds)."""
    _, first = _timed(fn)
    out, warm = _timed(fn)
    return out, first, warm


def device_phase() -> dict:
    """Platform, kind and count as JAX reports them, for the final line.
    Raises when the default device is not a GPU — there is no CPU
    fallback."""
    global _CARD
    import jax

    dev = jax.devices()[0]
    print(f"[device] platform={dev.platform} kind={dev.device_kind!r} "
          f"count={len(jax.devices())} jax={jax.__version__}", flush=True)
    info = bench.device_record()
    _CARD = info.pop("card")
    print(_CARD, flush=True)
    return info


def bench_problem(seed: int = 0, n_model_raw: int = 20_000,
                  n_total: int = 100_000, n_inst_pts: int = 15_000):
    """The bench's model and scene at `seed`, described and voxelized the
    bench's way: returns dict(cfg, desc, d_dist, mp_raw, mn_raw, sp, sn,
    truths, vox). The description is built for engine="correlation",
    which builds the fast (incl. block) AND correlation tables, so one
    description serves both engines."""
    import objective_slam_tpu as ost
    from objective_slam_tpu.config import PPFConfig
    from objective_slam_tpu.utils import pointcloud as pc

    rng = np.random.default_rng(seed)
    mp_raw, mn_raw = bench.build_model(rng, n_model_raw)
    sp, sn, truths = bench.build_scene(rng, mp_raw, mn_raw, n_total=n_total,
                                       n_inst_pts=n_inst_pts)
    cfg = PPFConfig(engine="correlation")
    d_dist = cfg.tau_d * pc.bbox_diameter(mp_raw)
    mp, mn = pc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    desc = ost.build_model_description(mp, mn, cfg, d_dist=d_dist)
    occ = int(pc.voxel_downsample(sp, sn, d_dist,
                                  capacity=len(sp)).num_voxels)
    cap = ((int(occ * 1.02) + 127) // 128) * 128
    vox = pc.voxel_downsample(sp, sn, d_dist, capacity=cap)
    if bool(vox.dropped):
        raise RuntimeError(f"scene voxel capacity {cap} overflowed")
    return dict(cfg=cfg, desc=desc, d_dist=d_dist, mp_raw=mp_raw,
                mn_raw=mn_raw, sp=sp, sn=sn, truths=truths, vox=vox)


def _localised(pose, truths, diameter, cfg):
    """The validation of the planted instance the pose is closest to."""
    from objective_slam_tpu.utils import validation

    vs = [validation.validate_pose(np.asarray(pose), T, diameter, cfg)
          for T in truths]
    return min(vs, key=lambda v: v.rot_err + (0.0 if v.match else 1e3))


def ppf_phase(prob: dict, max_poses: int = 8192, ref_point_df: int = 5,
              icp_iterations: int = 20, icp_stride: int = 8) -> dict:
    """ost.match + ost.match_with_state for both engines on the bench
    scene. max_poses defaults to drost.match's saturation ceiling: the
    multi-instance scene saturates any smaller top-K, and starting at the
    ceiling compiles one graph instead of the whole retry ladder."""
    import objective_slam_tpu as ost
    from objective_slam_tpu.models import drost

    desc, vox = prob["desc"], prob["vox"]
    icp_p = prob["sp"][::icp_stride]
    icp_n = prob["sn"][::icp_stride]
    out = {}
    for engine in ("fast", "correlation"):
        cfg = dataclasses.replace(
            prob["cfg"], engine=engine, max_poses=max_poses,
            ref_point_df=ref_point_df, refine_icp=True,
            icp_iterations=icp_iterations)

        def run_match():
            return ost.match(desc, vox.points, vox.normals, cfg,
                             icp_points=icp_p, icp_normals=icp_n)

        res, first, warm = _first_and_warm(run_match)
        res_s, state = ost.match_with_state(
            desc, vox.points, vox.normals, cfg, icp_points=icp_p,
            icp_normals=icp_n)
        # Count-pass probe: the reused state must dispatch straight away.
        counted = []
        real_count = drost._count_votes

        def counting(*a, **k):
            counted.append(1)
            return real_count(*a, **k)

        drost._count_votes = counting
        try:
            (res2, state2), t_state = _timed(lambda: ost.match_with_state(
                desc, vox.points, vox.normals, cfg, state=state,
                icp_points=icp_p, icp_normals=icp_n))
            (res3, _), t_state_warm = _timed(lambda: ost.match_with_state(
                desc, vox.points, vox.normals, cfg, state=state2,
                icp_points=icp_p, icp_normals=icp_n))
        finally:
            drost._count_votes = real_count
        if counted:
            raise RuntimeError(f"{engine}: match_with_state with a state "
                               "ran a count pass")
        for r in (res, res_s, res2, res3):
            if bool(r.overflowed):
                raise RuntimeError(f"{engine}: vote capacity overflowed")
        v = _localised(res.pose, prob["truths"], desc.diameter, cfg)
        v3 = _localised(res3.pose, prob["truths"], desc.diameter, cfg)
        if not (v.match and v3.match):
            raise RuntimeError(
                f"{engine}: winner localises no planted instance "
                f"(trans {v.trans_err:.4f}, rot "
                f"{math.degrees(v.rot_err):.2f} deg)")
        _say("ppf", engine=engine, num_votes=int(res.num_votes),
             match_first_s=f"{first:.3f}", match_warm_s=f"{warm:.4f}",
             state_first_s=f"{t_state:.4f}",
             state_warm_s=f"{t_state_warm:.4f}",
             trans_err=f"{v.trans_err:.5f}",
             rot_err_deg=f"{math.degrees(v.rot_err):.3f}",
             topk_saturated=bool(res.topk_saturated))
        out[engine] = res
    return out


def kernel_phase(prob: dict, ref_point_df: int = 5,
                 n_ref_points: int = 64) -> dict:
    """The tally gate and the reference comparisons at bench widths."""
    import jax
    import jax.numpy as jnp
    import reference_impl
    from objective_slam_tpu.models import drost
    from objective_slam_tpu.ops import ppf as ppf_ops
    from objective_slam_tpu.ops import voting_block, voting_corr, voting_fast

    desc, vox, cfg = prob["desc"], prob["vox"], prob["cfg"]
    capacity = vox.points.shape[0]
    total, rows, segs = drost._count_votes(desc, vox.points, vox.normals,
                                           ref_point_df, cfg.d_angle)
    n_ref = (capacity + ref_point_df - 1) // ref_point_df
    cap = drost._next_cap((rows + voting_block.CHUNK_ROWS * n_ref) * 128)
    seg_cap = drost._next_cap(max(segs, 1024))
    cap_fast = drost._next_cap(total + voting_fast.TALLY_CHUNK * n_ref)
    cap_ref = drost._next_cap(total)
    ref_idx = jnp.arange(0, capacity, ref_point_df, dtype=jnp.int32)

    def keys_of(p, n):
        return ppf_ops.pairwise_ppf_keys(p, n, desc.d_dist, cfg.d_angle,
                                         desc.max_dist_bin,
                                         ref_indices=ref_idx)

    @jax.jit
    def gate(p, n):
        keys, alpha = keys_of(p, n)
        return bench.tally_bitequal_check(keys, alpha, desc, cfg.d_angle,
                                          cap, seg_cap, cap_fast, cap_ref)

    (eq, eq_votes, flips, ovf), first, warm = _first_and_warm(
        lambda: gate(vox.points, vox.normals))
    flip_rate = int(flips) / max(total, 1)
    if bool(ovf):
        raise RuntimeError("tally gate: an engine overflowed its cap")
    if not (bool(eq) and bool(eq_votes)):
        raise RuntimeError("tally gate: block engine is not bit-equal to "
                           "the fast engine, or vote totals differ")
    if not flip_rate < 1e-4:
        raise RuntimeError(f"tally gate: flip rate {flip_rate:.3e}/vote")
    _say("kernel", check="block_vs_fast_vs_readable", votes=total,
         block_eq_fast=True, readable_flips=int(flips),
         flip_rate=f"{flip_rate:.3e}", first_s=f"{first:.3f}",
         warm_s=f"{warm:.4f}")

    # Dictionary lookups vs NumPy (exact): the block engine's
    # (count, row start) and the correlation engine's key -> rank.
    keys, _ = jax.jit(keys_of)(vox.points, vox.normals)
    flat = np.asarray(keys).reshape(-1)
    bt = desc.fast_tables.block
    cnt, brs = jax.jit(voting_block._dict_match)(jnp.asarray(flat), bt)
    occ_keys = np.asarray(bt.occ_keys)[:bt.k_occ]
    occ_vals = np.asarray(bt.occ_vals)[:bt.k_occ].astype(np.int64)
    pos = np.clip(np.searchsorted(occ_keys, flat), 0, bt.k_occ - 1)
    hit = occ_keys[pos] == flat
    np.testing.assert_array_equal(np.asarray(cnt),
                                  np.where(hit, occ_vals[pos, 0], 0))
    np.testing.assert_array_equal(np.asarray(brs),
                                  np.where(hit, occ_vals[pos, 1], 0))
    ct = desc.corr_tables
    rank = jax.jit(voting_corr.key_ranks)(jnp.asarray(flat), ct)
    c_keys = np.asarray(ct.occ_keys)[:ct.k_occ]
    cpos = np.clip(np.searchsorted(c_keys, flat), 0, ct.k_occ - 1)
    want = np.where(c_keys[cpos] == flat, cpos, ct.k_occ)
    np.testing.assert_array_equal(np.asarray(rank), want)
    _say("kernel", check="dict_lookup_vs_numpy", pairs=flat.size,
         hits=int(hit.sum()), exact=True)

    # Readable engine vs the NumPy transliteration of the MATLAB semantics
    # on n_ref_points scene points around the first planted instance (the
    # Python reference pays ~tens of µs per vote, so the full scene is out
    # of reach; a cluster of neighbours keeps the votes dense).
    pts = np.asarray(vox.points)[:int(np.asarray(vox.num_voxels))]
    nrm = np.asarray(vox.normals)[:len(pts)]
    c = prob["truths"][0][:3, 3]
    near = np.argsort(np.linalg.norm(pts - c, axis=1))[:n_ref_points]
    s_p, s_n = pts[near], nrm[near]
    m_p, m_n = np.asarray(desc.points), np.asarray(desc.normals)
    d_dist = float(desc.d_dist)
    acc_ref = reference_impl.voting(m_p, m_n, s_p, s_n, d_dist, cfg.d_angle)
    res = drost.match_accumulator_only(
        desc, s_p, s_n, dataclasses.replace(cfg, ref_point_df=1))
    # Tolerance: the engine works in fp32 on the device, the reference in
    # fp64 on the host, so a vote within an ulp of an α-bin (or feature-
    # bin) edge can land in the neighbouring cell — tests/test_voting.py's
    # tiny clouds are exact, the bench scene's 1.38M votes moved 0 and 1
    # in two card runs. Bound: cell mismatches below 1e-4 per vote.
    acc = np.asarray(res.accumulator)[:, :, :acc_ref.shape[2]]
    mismatch = int(np.abs(acc.astype(np.int64) - acc_ref).sum())
    n_votes = int(acc_ref.sum())
    if bool(res.overflowed) or not mismatch < 1e-4 * n_votes:
        raise RuntimeError(
            f"readable engine vs reference_impl: votes "
            f"{int(res.num_votes)} vs {n_votes}, {mismatch} cell counts "
            "differ")
    _say("kernel", check="readable_vs_reference_impl", points=len(s_p),
         votes=n_votes, engine_votes=int(res.num_votes),
         cell_mismatch=mismatch)
    return {"votes": total, "flips": int(flips)}


def cli_phase(prob: dict, ppf_winner, max_poses: int = 8192,
              ref_point_df: int = 5, icp_iterations: int = 20) -> None:
    """objective_slam_tpu.cli.main on PLY/text files of the bench scene.
    The CLI validates its single winner against ONE truth file, so the
    truth written is the planted instance the PPF phase's fast-engine
    winner localised (same model, leaf, tau_d, ref_point_df, max_poses)."""
    import contextlib
    import io

    from objective_slam_tpu import cli
    from objective_slam_tpu.utils import ply, validation

    cfg = prob["cfg"]
    truth = min(prob["truths"], key=lambda T: float(np.linalg.norm(
        T[:3, 3] - np.asarray(ppf_winner)[:3, 3])))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ply.write_ply(tmp / "model.ply", prob["mp_raw"], prob["mn_raw"])
        ply.write_ply(tmp / "scene.ply", prob["sp"], prob["sn"])
        validation.write_truth_file(tmp / "truth.txt", truth)
        argv = ["--scene_files", str(tmp / "scene.ply"),
                "--model_files", str(tmp / "model.ply"),
                "--tau_d", str(cfg.tau_d),
                "--scene_leaf_size", repr(float(prob["d_dist"])),
                "--ref_point_df", str(ref_point_df),
                "--max_poses", str(max_poses),
                "--icp_iterations", str(icp_iterations),
                "--validation_files", str(tmp / "truth.txt"),
                "--logfile", str(tmp / "cli.log"), "--loglevel", "warning"]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        first = time.perf_counter() - t0
    printed = buf.getvalue().strip()
    if rc != 0 or printed != "1":
        raise RuntimeError(f"cli: rc {rc}, printed {printed!r} (want '1')")
    _say("cli", printed=printed, first_s=f"{first:.3f}")


def tsdf_phase(dims: int = 256, img: int = 240, frames: int = 4,
               track_frames: int = 2) -> None:
    """Fuse `frames` depth frames banded, extract, recognise through
    StreamingRecognizer, then track `track_frames` raw frames
    (tsdf.track_frame) and fuse each at its tracked pose."""
    import tsdf_smoke
    from objective_slam_tpu.config import PPFConfig
    from objective_slam_tpu.models import tsdf
    from objective_slam_tpu.ops import transforms as tr
    from objective_slam_tpu.utils import synthetic

    rng = np.random.default_rng(0)
    mp, mn, world = tsdf_smoke.tabletop_world(rng)
    # Clutter keeps tracking well-posed (tsdf_smoke.tracking_clutter);
    # recognition targets the blob among it.
    world = np.concatenate([world] + tsdf_smoke.tracking_clutter()) \
        .astype(np.float32)
    vs = 5.0 / dims                                 # 5 m cube -> 2 cm @256
    cfg = PPFConfig(max_poses=512, ref_point_df=2, refine_icp=True,
                    icp_iterations=8)
    desc = tsdf_smoke.fused_model_description(mp, mn, vs, cfg)
    vol = tsdf.make_volume(origin=(-2.5, -2.5, -1.5),
                           dims=(dims, dims, dims), voxel_size=vs)
    intr = (0.9 * img, 0.9 * img, img / 2 - 0.5, img / 2 - 0.5)
    # Fused views orbit in 360/frames° steps; tracked frames continue the
    # orbit in 7.5° steps (inside projective ICP's convergence basin).
    ang_last = 2 * math.pi * (frames - 1) / frames
    poses = ([tsdf_smoke.orbit_pose(2 * math.pi * f / frames)
              for f in range(frames)]
             + [tsdf_smoke.orbit_pose(ang_last + math.radians(7.5) * k)
                for k in range(1, track_frames + 1)])
    depths = [synthetic.render_depth(world, T, intr, (img, img))
              for T in poses]
    occ = max(int(tsdf.band_block_occupancy(vol, d, intr, T))
              for d, T in zip(depths, poses))
    block_cap = ((int(occ * 1.15) + 127) // 128) * 128

    def fuse(vol, depth, T):
        vol, ovf = tsdf.integrate_depth_banded(vol, depth, intr, T,
                                               block_cap=block_cap)
        if bool(ovf):
            raise RuntimeError("tsdf: banded block_cap overflowed")
        return vol

    t_fuse = []
    for d, T in zip(depths[:frames], poses[:frames]):
        vol, dt = _timed(lambda: fuse(vol, d, T))
        t_fuse.append(dt)

    rec = tsdf.StreamingRecognizer(vol, cfg)
    rec.register_model("blob", desc)
    surf, t_surf, t_surf_w = _first_and_warm(rec.surface)
    if bool(surf.overflowed):
        raise RuntimeError("tsdf: surface capacity overflowed")
    out, t_rec, t_rec_w = _first_and_warm(lambda: rec.recognize()["blob"])
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, 3] = [0, 0, 1.0]
    td, rd = (float(x) for x in tr.ht_dist(np.asarray(out.pose), T_true))
    # tools/tsdf_smoke.py's recognition criterion.
    if not (td < 0.1 * desc.diameter and rd < math.radians(12)):
        raise RuntimeError(f"tsdf: recognised pose off by {td:.4f}, "
                           f"{math.degrees(rd):.2f} deg")

    T_prev = poses[frames - 1]
    t_trk, drift = [], []
    for d, T_gt in zip(depths[frames:], poses[frames:]):
        res, dt = _timed(lambda: tsdf.track_frame(vol, d, intr, T_prev))
        t_trk.append(dt)
        T_prev = np.asarray(res.T_cw)
        tdt, rdt = (float(x) for x in tr.ht_dist(T_prev, T_gt))
        drift.append((round(tdt, 5), round(math.degrees(rdt), 3)))
        # tests/test_tsdf.py's bounded-drift tolerance.
        if not (tdt < 2.5 * vs and math.degrees(rdt) < 2.0):
            raise RuntimeError(f"tsdf: tracked pose off by {tdt:.4f}, "
                               f"{math.degrees(rdt):.3f} deg")
        vol = fuse(vol, d, T_prev)
    _say("tsdf", dims=dims, voxel_m=f"{vs:.5f}",
         fuse_first_s=f"{t_fuse[0]:.3f}",
         fuse_warm_s=f"{np.mean(t_fuse[1:]):.4f}",
         extract_first_s=f"{t_surf:.3f}", extract_warm_s=f"{t_surf_w:.4f}",
         recognise_first_s=f"{t_rec:.3f}",
         recognise_warm_s=f"{t_rec_w:.4f}",
         track_first_s=f"{t_trk[0]:.3f}",
         track_warm_s=f"{np.mean(t_trk[1:]):.4f}",
         trans_err=f"{td:.5f}", rot_err_deg=f"{math.degrees(rd):.3f}",
         track_drift=drift)


def four_card_phase(prob: dict, n_devices: int = 4, max_poses: int = 512,
                    ref_point_df: int = 5, icp_iterations: int = 20,
                    icp_stride: int = 8) -> dict:
    """parallel/sharded_match over a 1-D ("ref",) mesh of n_devices vs
    single-device _match_core on the same scene, config and exact caps.

    Exact: num_votes, no overflow, and the K largest candidate vote counts
    (the global top-K values are the top-K of the shards' top-Ks, whatever
    the tie order). Tolerance: each winner localises a planted instance
    under the reference criteria (translation < 0.1·diameter, rotation <
    12°). The winners themselves may differ: this scene saturates the
    top-K, so the sharded path clusters n_devices·K candidates where the
    single device clusters K, and any of the 4 planted instances is a
    correct answer; their distance is printed."""
    import jax
    from jax.sharding import Mesh
    from objective_slam_tpu.models import drost
    from objective_slam_tpu.ops import transforms as tr
    from objective_slam_tpu.parallel import sharded_match as sm

    if len(jax.devices()) < n_devices:
        raise RuntimeError(f"{n_devices} devices needed, "
                           f"{len(jax.devices())} found")
    desc, vox = prob["desc"], prob["vox"]
    cfg = dataclasses.replace(prob["cfg"], engine="fast",
                              max_poses=max_poses, ref_point_df=ref_point_df,
                              refine_icp=True, icp_iterations=icp_iterations)
    icp_p = prob["sp"][::icp_stride]
    icp_n = prob["sn"][::icp_stride]
    n_scene = int(vox.points.shape[0])
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("ref",))
    vc, sc = sm.size_sharded_caps(desc, vox.points, vox.normals, cfg,
                                  n_devices)
    matcher = sm.make_sharded_matcher(mesh, desc, cfg, n_scene, vc,
                                      seg_cap_per_shard=sc)
    sres, s_first, s_warm = _first_and_warm(
        lambda: matcher(vox.points, vox.normals, icp_p, icp_n))

    _, caps = drost._match_sized_caps(desc, vox.points, vox.normals, cfg,
                                      icp_points=icp_p, icp_normals=icp_n)
    single = jax.jit(lambda p, n, ip, inn: drost._match_core(
        desc, p, n, ref_point_df=ref_point_df, vote_cap=caps.vote_cap,
        config=cfg, icp_points=ip, icp_normals=inn, seg_cap=caps.seg_cap))
    res, first, warm = _first_and_warm(
        lambda: single(vox.points, vox.normals, icp_p, icp_n))

    td, rd = (float(x) for x in tr.ht_dist(np.asarray(sres.pose),
                                           np.asarray(res.pose)))
    if bool(sres.overflowed) or bool(res.overflowed):
        raise RuntimeError("four-cards: a vote buffer overflowed")
    if int(sres.num_votes) != int(res.num_votes):
        raise RuntimeError(f"four-cards: num_votes {int(sres.num_votes)} "
                           f"sharded vs {int(res.num_votes)} single")
    top_s = np.sort(np.asarray(sres.pose_votes))[::-1][:max_poses]
    top_1 = np.sort(np.asarray(res.pose_votes))[::-1][:max_poses]
    if not np.array_equal(top_s, top_1):
        raise RuntimeError("four-cards: top-K vote counts differ")
    for name, r in (("sharded", sres), ("single", res)):
        v = _localised(r.pose, prob["truths"], desc.diameter, cfg)
        if not v.match:
            raise RuntimeError(
                f"four-cards: {name} winner localises no planted instance "
                f"({v.trans_err:.4f}, {math.degrees(v.rot_err):.2f} deg)")
    _say("four-cards", devices=n_devices, num_votes=int(res.num_votes),
         sharded_first_s=f"{s_first:.3f}", sharded_warm_s=f"{s_warm:.4f}",
         single_first_s=f"{first:.3f}", single_warm_s=f"{warm:.4f}",
         topk_equal=True, winners_diff_trans=f"{td:.5f}",
         winners_diff_rot_deg=f"{math.degrees(rd):.3f}")
    return {"sharded": sres, "single": res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device sharded-matcher phase")
    args = ap.parse_args(argv)

    try:
        device = device_phase()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    prob, t_prob = _timed(bench_problem)
    _say("setup", build_s=f"{t_prob:.3f}",
         model_points=prob["desc"].n_points,
         scene_voxels=int(prob["vox"].num_voxels))
    if args.four_cards:
        four_card_phase(prob)
    else:
        ppf = ppf_phase(prob)
        kernel_phase(prob)
        cli_phase(prob, ppf["fast"].pose)
        tsdf_phase()
    _say("total", wall_s=f"{time.perf_counter() - t0:.3f}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
