"""Multi-chip PPF matching: shard the scene reference-point axis.

The reference is single-GPU (ppf.cu:37-49 picks one device; SURVEY.md §2.4).
The Hough dimension — scene reference points — is embarrassingly parallel,
so the multi-device scale-out shards it across a 1-D `jax.sharding.Mesh`
axis ("ref") with `shard_map`:

  per-device:  its slice of reference rows -> pairwise keys/α -> local dense
               accumulator -> local top-K candidates + pose reconstruction
  collective:  all_gather of the K candidates per device (plus a
               psum'd saturation check against the GLOBAL threshold), then
               the global phase — relative threshold, dense clustering,
               optional geometric rescoring, winner, optional ICP — runs
               replicated in the enclosing jit.

The only cross-device traffic is D·K candidate poses (a few hundred KB),
not the O(R·n) pair arrays — one gather per match. The mesh follows the
algorithm alone: the devices of one host reach each other all to all at
the same rate (NVLink on an H100 host), so no axis layout matters. Exact
w.r.t. the single-chip path whenever each shard's survivors fit in K
(`topk_saturated` reports the truncation case at runtime, same contract as
voting.top_votes).

Feature parity with the single-chip `drost._match_core`: all four voting
engines (including the FNV keying mode, which rides `drost._scene_keys`),
exact count-pass capacity sizing (`size_sharded_caps`), geometric
rescoring, ICP refinement against an optional full-resolution cloud, and
the full candidate surface (poses/keep/clustered counts) so
`drost.extract_instances` works on the result unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from objective_slam_tpu.config import PPFConfig
from objective_slam_tpu.models import drost
from objective_slam_tpu.models.drost import ModelDescription
from objective_slam_tpu.ops import (clustering, icp, ppf as ppf_ops,
                                    transforms as tr, verify_pose)
from objective_slam_tpu.ops import (voting, voting_block, voting_corr,
                                    voting_fast)


class ShardedMatchResult(NamedTuple):
    pose: jax.Array             # (4, 4) winner (replicated)
    cluster_votes: jax.Array    # () winner's clustered count
    num_votes: jax.Array        # () total votes across all shards
    overflowed: jax.Array       # () any shard overflowed its vote buffer
    poses: jax.Array            # (D*K, 4, 4) gathered candidate poses
    pose_votes: jax.Array       # (D*K,) gathered raw vote counts
    pose_keep: jax.Array        # (D*K,) global-threshold survivors
    clustered_counts: jax.Array  # (D*K,) clustered weighted counts
    clustered_translations: jax.Array  # (D*K, 3) cluster-refined translations
    topk_saturated: jax.Array   # () any shard's survivors exceeded K


def psum_saturating(nv, axis_name: str):
    """Saturating cross-shard sum of per-shard SATURATING int32 totals.

    Each shard's num_votes honors `voting.saturating_total`'s contract
    (clamps at 2^31-1 instead of wrapping), but a plain `psum` of two
    sub-sentinel shards can wrap 2^31 and read as a plausible count. Sum as
    two 16-bit limbs with carry propagation (int32-safe for any mesh
    ≤ 2^15 devices) and re-saturate on either a shard-level sentinel or a
    carried-out total ≥ 2^31 — honoring the single-chip contract across
    the collective."""
    int_max = jnp.int32(2 ** 31 - 1)
    lo = jax.lax.psum(nv & 0xFFFF, axis_name)
    hi = jax.lax.psum(jax.lax.shift_right_logical(nv, 16), axis_name)
    any_sat = jax.lax.psum((nv == int_max).astype(jnp.int32),
                           axis_name) > 0
    # Carry lo's overflow into hi so (hi << 16) + lo cannot itself wrap:
    # after the carry, hi < 2^15 implies the exact total fits in int32.
    hi = hi + jax.lax.shift_right_logical(lo, 16)
    lo = lo & 0xFFFF
    return jnp.where(any_sat | (hi >= (1 << 15)), int_max,
                     (hi << 16) + lo)


def size_sharded_caps(model: ModelDescription, scene_points, scene_normals,
                      config: PPFConfig, n_shards: int
                      ) -> tuple[int, int | None]:
    """Exact per-shard capacity sizing from the count pass — the sharded
    analog of `drost.match`'s sizing (reference count/scan phase,
    model.cu:99-121). Returns (vote_cap_per_shard, seg_cap_per_shard) to
    pass to `make_sharded_matcher`; vote_cap excludes the per-row
    row-alignment budget (the matcher adds it, as its docstring states)."""
    if config.engine == "correlation":
        return 0, None
    votes_r, rows_r, segs_r = drost._count_votes_rows_jit(
        model, scene_points, scene_normals, config.ref_point_df,
        config.d_angle)
    votes_r = np.asarray(votes_r, np.int64)
    rows_r = np.asarray(rows_r, np.int64)
    segs_r = np.asarray(segs_r, np.int64)
    R = votes_r.shape[0]
    R_pad = ((R + n_shards - 1) // n_shards) * n_shards

    def shard_max(x):
        xp = np.zeros((R_pad,), np.int64)
        xp[:R] = x
        return int(xp.reshape(n_shards, -1).sum(axis=1).max())

    if config.engine == "fast" and model.fast_tables is not None \
            and model.fast_tables.block is not None:
        vote_cap = drost._next_cap(shard_max(rows_r) * 128)
        seg_cap = drost._next_cap(max(shard_max(segs_r), 1024))
        return vote_cap, seg_cap
    return drost._next_cap(shard_max(votes_r)), None


def make_sharded_matcher(mesh: Mesh, model: ModelDescription,
                         config: PPFConfig, n_scene: int,
                         vote_cap_per_shard: int,
                         seg_cap_per_shard: int | None = None,
                         runs_cap_per_shard: int | None = None):
    """Build a jitted multi-chip matcher over `mesh` (axis name "ref").

    n_scene and the caps are static; use `size_sharded_caps` to derive them
    exactly from a count pass. The number of reference rows
    R = ceil(n_scene / ref_point_df) is padded up to a multiple of the mesh
    size with out-of-range rows (they generate only INVALID_KEY pairs).

    runs_cap_per_shard (correlation engine): starting capacity for each
    shard's unique-cell compaction; None uses the engine heuristic. Either
    way `overflowed` reports truncation — use `sharded_match` for the
    auto-retry loop that guarantees untruncated tallies (the sharded analog
    of drost.match's correlation retry).

    Returns fn(scene_points, scene_normals, icp_points=None,
    icp_normals=None) -> ShardedMatchResult. When config.refine_icp is set,
    the winner is ICP-refined against icp_points (the full-resolution scan)
    or scene_points — replicated work after the gather, so it adds
    single-chip ICP latency, not communication.
    """
    n_dev = mesh.shape["ref"]
    df = config.ref_point_df
    R = (n_scene + df - 1) // df
    R_pad = ((R + n_dev - 1) // n_dev) * n_dev
    # The fast engines row-pad each local row to a tally chunk; budget it
    # on top of the caller's exact per-shard capacity.
    if config.engine == "fast":
        vote_cap_per_shard += (R_pad // n_dev) * voting_fast.TALLY_CHUNK
    # Padded rows index a sentinel far outside the cloud -> self-pair rule
    # can't trigger, distance overflows -> INVALID_KEY everywhere.
    ref_idx_host = np.full((R_pad,), n_scene - 1, np.int32)
    ref_idx_host[:R] = np.arange(0, R * df, df, dtype=np.int32)
    pad_row = np.zeros((R_pad,), bool)
    pad_row[R:] = True

    K = config.max_poses

    def _local_candidates(ref_idx, pad_mask, scene_points, scene_normals,
                          mdl: ModelDescription):
        """Per-shard: vote + local top-K + pose build. Runs under shard_map
        with ref_idx/pad_mask sharded, everything else replicated."""
        keys, alpha_s = drost._scene_keys(mdl, scene_points, scene_normals,
                                          ref_idx, config.d_angle)
        keys = jnp.where(pad_mask[:, None], ppf_ops.INVALID_KEY, keys)
        if config.engine == "correlation":
            if mdl.corr_tables is None:
                raise ValueError("engine='correlation' but corr_tables is "
                                 "None — rebuild tables for this engine")
            votes = voting_corr.cast_votes_corr(keys, alpha_s,
                                                mdl.corr_tables,
                                                mdl.n_points,
                                                runs_cap=runs_cap_per_shard)
        elif config.engine == "fast":
            if mdl.fast_tables is None:
                raise ValueError("engine='fast' but fast_tables is None — "
                                 "rebuild tables for this engine")
            if mdl.fast_tables.block is not None:
                votes = voting_block.cast_votes_block(
                    keys, alpha_s, mdl.fast_tables.block, mdl.n_points,
                    config.d_angle, vote_cap_per_shard,
                    seg_cap=seg_cap_per_shard)
            else:
                votes = voting_fast.cast_votes_fast(
                    keys, alpha_s, mdl.fast_tables, mdl.n_points,
                    config.d_angle, vote_cap_per_shard)
        else:
            votes = voting.cast_votes(keys, alpha_s, mdl.table,
                                      mdl.n_points, config.d_angle,
                                      vote_cap_per_shard)
        acc = votes.accumulator
        Rl, n_m, A = acc.shape
        counts, idx = jax.lax.top_k(acc.reshape(-1), K)
        a_idx = (idx % A).astype(jnp.int32)
        m_idx = ((idx // A) % n_m).astype(jnp.int32)
        r_loc = (idx // (A * n_m)).astype(jnp.int32)

        s_pts = scene_points[ref_idx]          # (Rl, 3)
        s_nrm = scene_normals[ref_idx]
        s_beta, s_gamma = tr.canonical_angles(s_pts, s_nrm)
        poses = tr.pose_from_vote(
            a_idx, mdl.points[m_idx], mdl.beta[m_idx], mdl.gamma[m_idx],
            s_pts[r_loc], s_beta[r_loc], s_gamma[r_loc], config.d_angle)
        weighted = counts.astype(jnp.float32) * mdl.vote_weights[m_idx]
        return (counts, poses, weighted, votes.num_votes, votes.overflowed,
                acc)

    def _body(ref_idx, pad_mask, scene_points, scene_normals, mdl):
        counts, poses, weighted, nv, ovf, acc = _local_candidates(
            ref_idx, pad_mask, scene_points, scene_normals, mdl)
        # Gather the candidate sets; the global phase then runs
        # replicated in the enclosing jit — no further communication.
        g_counts = jax.lax.all_gather(counts, "ref").reshape(-1)     # (D*K,)
        g_poses = jax.lax.all_gather(poses, "ref").reshape(-1, 4, 4)
        g_weighted = jax.lax.all_gather(weighted, "ref").reshape(-1)
        total_votes = psum_saturating(nv, "ref")
        any_ovf = jax.lax.psum(ovf.astype(jnp.int32), "ref") > 0
        # Exactness flag vs the GLOBAL relative threshold: a shard whose
        # above-threshold cells exceed its K budget may have dropped true
        # survivors before the gather (voting.top_votes contract).
        gmax = jnp.max(g_counts)
        thresh = jnp.float32(config.vote_count_threshold) * \
            gmax.astype(jnp.float32)
        above = jnp.sum((acc.astype(jnp.float32) > thresh) & (acc > 0),
                        dtype=jnp.int32)
        saturated = jax.lax.psum((above > K).astype(jnp.int32), "ref") > 0
        return (g_counts, g_poses, g_weighted, total_votes, any_ovf,
                saturated)

    mdl_specs = jax.tree.map(lambda _: P(), model)
    sharded = jax.shard_map(
        _body, mesh=mesh,
        in_specs=(P("ref"), P("ref"), P(), P(), mdl_specs),
        out_specs=(P(), P(), P(), P(), P(), P()),
        check_vma=False)

    ref_sharding = NamedSharding(mesh, P("ref"))
    ref_idx_dev = jax.device_put(jnp.asarray(ref_idx_host), ref_sharding)
    pad_dev = jax.device_put(jnp.asarray(pad_row), ref_sharding)

    @jax.jit
    def matcher(scene_points, scene_normals, icp_points=None,
                icp_normals=None):
        scene_points = jnp.asarray(scene_points, jnp.float32)
        scene_normals = jnp.asarray(scene_normals, jnp.float32)
        (g_counts, g_poses, g_weighted, total_votes, any_ovf, saturated) = \
            sharded(ref_idx_dev, pad_dev, scene_points, scene_normals,
                    model)

        # Global phase — identical staging to drost._match_core
        # (threshold model.cu:164-170, clustering kernel.cu:647-763,
        # winner model.cu:293-295, rescore/ICP rebuild extensions).
        max_count = jnp.max(g_counts)
        thresh = jnp.float32(config.vote_count_threshold) * \
            max_count.astype(jnp.float32)
        keep = (g_counts.astype(jnp.float32) > thresh) & (g_counts > 0)

        t = g_poses[:, :3, 3]
        q = tr.hrotmat2quat(g_poses)
        cl = clustering.cluster_poses_dense(
            t, q, g_weighted, keep, model.d_dist, config.rot_thresh,
            include_center_cell=config.cluster_center_cell,
            use_l1_norm=config.use_l1_norm,
            use_averaged_clusters=config.use_averaged_clusters)
        if config.rescore_poses:
            near = cl.vote_counts >= (
                jnp.float32(config.rescore_min_vote_frac)
                * jnp.max(cl.vote_counts))
            cand = g_poses.at[:, :3, 3].set(cl.translations)
            scores = verify_pose.inlier_scores(
                cand, keep & near, model.points, scene_points,
                model.d_dist,
                model_normals=model.normals, scene_normals=scene_normals)
            combined = jnp.where(keep & near,
                                 cl.vote_counts * (1.0 + scores), -1.0)
            win = jnp.argmax(combined)
            pose = cand[win]
        else:
            win = jnp.argmax(cl.vote_counts)
            pose = g_poses[win].at[:3, 3].set(cl.translations[win])

        if config.refine_icp:
            icp_target = scene_points if icp_points is None else \
                jnp.asarray(icp_points, jnp.float32)
            icp_nrm = (scene_normals if icp_points is None else icp_normals)
            pose = icp.refine_pose(
                model.points, icp_target, pose,
                iterations=config.icp_iterations,
                max_dist=config.icp_max_dist_factor * model.d_dist,
                scene_normals=None if icp_nrm is None
                else jnp.asarray(icp_nrm, jnp.float32),
                model_normals=model.normals,
                point_to_plane=config.icp_point_to_plane).pose

        return ShardedMatchResult(
            pose=pose, cluster_votes=cl.vote_counts[win],
            num_votes=total_votes, overflowed=any_ovf,
            poses=g_poses, pose_votes=g_counts, pose_keep=keep,
            clustered_counts=cl.vote_counts,
            clustered_translations=cl.translations,
            topk_saturated=saturated)

    return matcher


def sharded_match(mesh: Mesh, model: ModelDescription, scene_points,
                  scene_normals, config: PPFConfig = PPFConfig(),
                  icp_points=None, icp_normals=None,
                  vote_cap_per_shard: int | None = None,
                  seg_cap_per_shard: int | None = None,
                  runs_cap_per_shard: int | None = None
                  ) -> ShardedMatchResult:
    """Sized, never-silently-truncating sharded match — the multi-chip
    analog of `drost.match`.

    Exact engines: caps default to the exact count-pass sizing
    (`size_sharded_caps`), so the result cannot overflow. Correlation
    engine: starts at runs_cap_per_shard (None → engine heuristic) and
    AUTO-RETRIES at the next capacity bucket whenever any shard's runs
    compaction overflows — mirroring the single-chip retry in drost.match
    (drost.py match() correlation loop); the cap clamps to the per-shard
    pair count, so the loop terminates with untruncated tallies.

    One matcher is built per attempt (a retry recompiles, like the
    single-chip path). For repeated matching at fixed scene shape, size
    caps once and reuse `make_sharded_matcher`'s closure directly."""
    n_scene = int(np.asarray(scene_points).shape[0])
    n_dev = mesh.shape["ref"]
    df = config.ref_point_df
    R = (n_scene + df - 1) // df
    R_pad = ((R + n_dev - 1) // n_dev) * n_dev
    s_shard = (R_pad // n_dev) * n_scene   # per-shard pair count

    if config.engine != "correlation":
        if vote_cap_per_shard is None:
            vote_cap_per_shard, seg_auto = size_sharded_caps(
                model, scene_points, scene_normals, config, n_dev)
            if seg_cap_per_shard is None:
                seg_cap_per_shard = seg_auto
        matcher = make_sharded_matcher(
            mesh, model, config, n_scene, vote_cap_per_shard,
            seg_cap_per_shard=seg_cap_per_shard)
        return matcher(scene_points, scene_normals, icp_points=icp_points,
                       icp_normals=icp_normals)

    rc = runs_cap_per_shard
    while True:
        matcher = make_sharded_matcher(
            mesh, model, config, n_scene, 0, runs_cap_per_shard=rc)
        res = matcher(scene_points, scene_normals, icp_points=icp_points,
                      icp_normals=icp_normals)
        if rc is not None and rc >= s_shard:
            break
        if not bool(res.overflowed):
            break
        rc = drost._next_cap(2 * (rc if rc is not None
                                  else max(s_shard // 6, 65536)))
    return res
