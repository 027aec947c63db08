"""Drost-2010 PPF 6-DoF matcher — the flagship model.

End-to-end equivalent of the reference's Scene/Model classes and
Model::ppf_lookup (src/cuda/scene.cu:24-99, model.cu:43-306): build a
reusable model description offline, then match it against scenes with one
jitted, static-shape pipeline:

  scene points ──pairwise PPF keys + α_s──┐
                                          ├─ expansion voting ─ dense
  ModelDescription (key table + α_m) ─────┘   accumulator (R, n_m, 32)
                                              │
                top-K + relative threshold ───┤  (model.cu:148-170)
                batched pose reconstruction ──┤  (kernel.cu:605-645)
                weighted counts ──────────────┤  (kernel.cu:766-782)
                dense pose clustering ────────┤  (kernel.cu:647-763)
                argmax winner ────────────────┘  (model.cu:293-295)

Unlike the reference — which rebuilds the model description for every
(scene, model) pair despite it being scene-independent (acknowledged
inefficiency, ppf.cu:64-67) — the description here is an explicit,
serializable pytree built once per model.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from objective_slam_tpu.config import PPFConfig
from objective_slam_tpu.ops import (clustering, hashing, icp,
                                    ppf as ppf_ops,
                                    transforms as tr)
from objective_slam_tpu.ops import (verify_pose, voting, voting_block,
                                    voting_corr, voting_fast)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["points", "normals", "beta", "gamma", "vote_weights",
                 "table", "d_dist", "fast_tables", "corr_tables",
                 "fnv_remap"],
    meta_fields=["n_points", "num_keys", "max_dist_bin", "diameter"])
@dataclasses.dataclass(frozen=True)
class ModelDescription:
    """Serializable, scene-independent model description (pytree).

    Replaces Model's GPU-resident state (model.h:61-115): the
    ParallelHashArray becomes a direct-addressed table, the per-vote
    trans_model_scene math is strength-reduced into per-point canonical
    angles (beta/gamma) and per-pair α_m. Static metadata (sizes) rides in
    the pytree aux so jitted matchers see static shapes."""
    points: jax.Array        # (n_m, 3) float32
    normals: jax.Array       # (n_m, 3) float32
    beta: jax.Array          # (n_m,) canonical Roty angle per point
    gamma: jax.Array         # (n_m,) canonical Rotz angle per point
    vote_weights: jax.Array  # (n_m,) per-point vote weights (model.cu:67,91-93)
    table: voting.KeyTable
    d_dist: jax.Array        # () float32
    fast_tables: object      # voting_fast.FastModelTables | None
    corr_tables: object      # voting_corr.CorrTables | None
    fnv_remap: object        # hashing.FnvRemap | None (FNV keying mode:
                             # table/engines keyed by FNV-bucket rank)
    # --- static metadata (python ints; stable across traces) ---
    n_points: int
    num_keys: int
    max_dist_bin: int
    diameter: float


@functools.partial(jax.jit, static_argnames=("d_angle", "max_dist_bin",
                                             "num_keys"))
def _build_device(pts, nrm, d_dist, d_angle, max_dist_bin, num_keys):
    keys, alpha = ppf_ops.pairwise_ppf_keys(
        pts, nrm, d_dist, d_angle, max_dist_bin)
    table = voting.build_key_table(keys, alpha, num_keys)
    beta, gamma = tr.canonical_angles(pts, nrm)
    return table, beta, gamma


@functools.partial(jax.jit, static_argnames=("d_angle", "max_dist_bin"))
def _build_keys_device(pts, nrm, d_dist, d_angle, max_dist_bin):
    keys, alpha = ppf_ops.pairwise_ppf_keys(
        pts, nrm, d_dist, d_angle, max_dist_bin)
    beta, gamma = tr.canonical_angles(pts, nrm)
    return keys, alpha, beta, gamma


def build_model_description(points, normals, config: PPFConfig = PPFConfig(),
                            d_dist: float | None = None,
                            vote_weights=None) -> ModelDescription:
    """Build the model description (Model ctor, model.cu:43-82).

    d_dist defaults to tau_d · (max bbox edge) — the CLI convention
    (alignment.cpp:246-253). The key-space size is bounded by the bbox
    diagonal, keeping shapes static. The device part is one jitted call."""
    pts = np.asarray(points, np.float32)
    nrm = np.asarray(normals, np.float32)
    n = pts.shape[0]
    bbox = pts.max(axis=0) - pts.min(axis=0)
    diameter = float(bbox.max())
    if d_dist is None:
        d_dist = config.tau_d * diameter
    d_dist = float(d_dist)
    # Upper bound on any pairwise distance bin: the bbox diagonal.
    max_dist_bin = int(np.linalg.norm(bbox) / d_dist) + 1
    num_keys = ppf_ops.num_keys(max_dist_bin)

    fnv_remap = None
    if config.use_fnv_keys:
        # FNV keying mode: remap packed keys to FNV-bucket ranks (hash
        # collisions conflate buckets; hash 0 excluded) and key the table
        # — and every engine built from it — by rank.
        keys, alpha, beta, gamma = _build_keys_device(
            jnp.asarray(pts), jnp.asarray(nrm), jnp.float32(d_dist),
            config.d_angle, max_dist_bin)
        fnv_remap = hashing.build_fnv_remap(keys, d_dist, config.d_angle)
        num_keys = int(fnv_remap.occ_hashes.shape[0])
        rkeys = hashing.fnv_remap_keys(keys, fnv_remap, d_dist,
                                       config.d_angle)
        table = voting.build_key_table(rkeys, alpha, num_keys)
    else:
        table, beta, gamma = _build_device(
            jnp.asarray(pts), jnp.asarray(nrm), jnp.float32(d_dist),
            config.d_angle, max_dist_bin, num_keys)
    if vote_weights is None:
        vote_weights = jnp.ones((n,), jnp.float32)
    fast_tables = (voting_fast.build_fast_tables(table)
                   if config.engine in ("fast", "correlation") else None)
    corr_tables = (voting_corr.build_corr_tables(table, n, config.n_angle)
                   if config.engine == "correlation" else None)
    return ModelDescription(
        points=jnp.asarray(pts), normals=jnp.asarray(nrm),
        beta=beta, gamma=gamma,
        vote_weights=jnp.asarray(vote_weights, jnp.float32),
        table=table, d_dist=jnp.float32(d_dist),
        fast_tables=fast_tables, corr_tables=corr_tables,
        fnv_remap=fnv_remap,
        n_points=n, num_keys=num_keys, max_dist_bin=max_dist_bin,
        diameter=diameter)


class MatchResult(NamedTuple):
    """Result of matching one model against one scene."""
    pose: jax.Array           # (4, 4) winning transform (translation from
                              # clustering, rotation from the raw winner —
                              # ppf.cu:80-92 semantics)
    cluster_votes: jax.Array  # () float32 winner's clustered vote count
    num_votes: jax.Array      # () int32 total Hough votes cast
    overflowed: jax.Array     # () bool vote capacity exceeded
    poses: jax.Array          # (max_poses, 4, 4) candidate poses
    pose_votes: jax.Array     # (max_poses,) raw vote counts (desc)
    pose_keep: jax.Array      # (max_poses,) threshold survivors mask
    clustered_counts: jax.Array  # (max_poses,) clustered weighted counts
    clustered_translations: jax.Array  # (max_poses, 3) cluster-averaged (or
                              # grid-quantized) translations per candidate
    accumulator: jax.Array    # (R, n_m, 32) dense tallies (diagnostics)
    topk_saturated: jax.Array  # () bool: threshold survivors may exceed the
                               # static max_poses/block coverage — raise
                               # max_poses (voting.top_votes exactness flag)


def _scene_keys(model: ModelDescription, scene_points, scene_normals,
                ref_idx, d_angle):
    """Scene pair keys + α_s in the model's key space — packed keys, or
    FNV-bucket ranks when the description was built with use_fnv_keys."""
    keys, alpha_s = ppf_ops.pairwise_ppf_keys(
        scene_points, scene_normals, model.d_dist, d_angle,
        model.max_dist_bin, ref_indices=ref_idx)
    if model.fnv_remap is not None:
        keys = hashing.fnv_remap_keys(keys, model.fnv_remap, model.d_dist,
                                      d_angle)
    return keys, alpha_s


def _match_core(model: ModelDescription, scene_points, scene_normals,
                *, ref_point_df: int, vote_cap: int, config: PPFConfig,
                icp_points=None, icp_normals=None,
                seg_cap: int | None = None,
                runs_cap: int | None = None) -> MatchResult:
    """The jitted matching pipeline (Model::ppf_lookup, model.cu:269-306).

    icp_points/icp_normals: optional full-resolution scene cloud for the
    ICP stage. Voting must see the voxelized (uniform-density) cloud, but
    refinement against the raw scan is what gets ICP below the
    voxel-spacing accuracy floor (see ops/icp.refine_pose)."""
    scene_points = jnp.asarray(scene_points, jnp.float32)
    scene_normals = jnp.asarray(scene_normals, jnp.float32)
    n_s = scene_points.shape[0]
    ref_idx = jnp.arange(0, n_s, ref_point_df, dtype=jnp.int32)

    # Scene PPFs (Scene ctor: ppf_kernel + hashing, scene.cu:24-55).
    keys, alpha_s = _scene_keys(model, scene_points, scene_normals,
                                ref_idx, config.d_angle)

    s_ref_pts = scene_points[ref_idx]
    s_ref_nrm = scene_normals[ref_idx]
    s_beta, s_gamma = tr.canonical_angles(s_ref_pts, s_ref_nrm)

    # Voting (ComputeUniqueVotes, model.cu:95-171). Missing engine tables
    # raise at trace time instead of silently degrading (a correlation
    # config with corr_tables=None and vote_cap=0 would otherwise produce
    # an all-zero accumulator and a garbage pose).
    if config.engine == "correlation":
        if model.corr_tables is None:
            raise ValueError("engine='correlation' but model.corr_tables is "
                             "None — rebuild tables for this engine")
        votes = voting_corr.cast_votes_corr(keys, alpha_s,
                                            model.corr_tables,
                                            model.n_points,
                                            runs_cap=runs_cap)
    elif config.engine == "fast":
        if model.fast_tables is None:
            raise ValueError("engine='fast' but model.fast_tables is None — "
                             "rebuild tables for this engine")
        if model.fast_tables.block is not None:
            # Block-expansion exact engine (ops/voting_block.py): bit-equal
            # tallies with row-granular gathers instead of per-vote element
            # lookups. vote_cap is sized in row-padded slots by match()
            # when the block tables are present.
            votes = voting_block.cast_votes_block(
                keys, alpha_s, model.fast_tables.block, model.n_points,
                config.d_angle, vote_cap, seg_cap=seg_cap)
        else:
            votes = voting_fast.cast_votes_fast(
                keys, alpha_s, model.fast_tables, model.n_points,
                config.d_angle, vote_cap)
    else:
        votes = voting.cast_votes(keys, alpha_s, model.table,
                                  model.n_points, config.d_angle, vote_cap)
    top = voting.top_votes(votes.accumulator, config.vote_count_threshold,
                           config.max_poses)

    # Pose reconstruction (trans_calc_kernel2, kernel.cu:605-645), batched.
    poses = tr.pose_from_vote(
        top.alpha_idx,
        model.points[top.model_idx], model.beta[top.model_idx],
        model.gamma[top.model_idx],
        s_ref_pts[top.ref_idx], s_beta[top.ref_idx], s_gamma[top.ref_idx],
        config.d_angle)

    # Weighted vote counts (vote_weight_kernel, kernel.cu:766-782).
    weighted = top.counts.astype(jnp.float32) * \
        model.vote_weights[top.model_idx]

    # Clustering (ClusterTransformations, model.cu:202-244) + winner
    # (model.cu:293-295).
    t = poses[:, :3, 3]
    q = tr.hrotmat2quat(poses)
    cl = clustering.cluster_poses_dense(
        t, q, weighted, top.keep,
        model.d_dist, config.rot_thresh,
        include_center_cell=config.cluster_center_cell,
        use_l1_norm=config.use_l1_norm,
        use_averaged_clusters=config.use_averaged_clusters)
    if config.rescore_poses:
        # Geometric verification (ops/verify_pose.py) restricted to
        # NEAR-TIED Hough peaks: re-ranking all survivors by inlier
        # fraction lets a fully-visible distractor outscore an occluded
        # true instance (measured 82%→18% at 30% occlusion, EVAL.md §4);
        # the stage exists to break symmetric-model vote aliasing, where
        # the aliased peaks have near-equal clustered counts.
        near = cl.vote_counts >= (jnp.float32(config.rescore_min_vote_frac)
                                  * jnp.max(cl.vote_counts))
        cand = poses.at[:, :3, 3].set(cl.translations)
        scores = verify_pose.inlier_scores(
            cand, top.keep & near, model.points, scene_points,
            model.d_dist,
            model_normals=model.normals, scene_normals=scene_normals)
        # Combine Hough evidence with the geometric score instead of
        # replacing it: vote counts carry the occlusion-robust support
        # (an occluded instance's inlier FRACTION is intrinsically low),
        # the score breaks near-ties between aliased symmetric peaks.
        combined = jnp.where(top.keep & near,
                             cl.vote_counts * (1.0 + scores), -1.0)
        win = jnp.argmax(combined)
        pose = cand[win]
    else:
        win = jnp.argmax(cl.vote_counts)
        pose = poses[win].at[:3, 3].set(cl.translations[win])

    if config.refine_icp:
        # ICP refinement of the winner (rebuild extension; the reference
        # stops at the clustered winner). Voxel-pad sentinel points sit at
        # ~1e7 and can never fall within the rejection radius, so no
        # validity mask is needed.
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

    return MatchResult(
        pose=pose, cluster_votes=cl.vote_counts[win],
        num_votes=votes.num_votes, overflowed=votes.overflowed,
        poses=poses, pose_votes=top.counts, pose_keep=top.keep,
        clustered_counts=cl.vote_counts,
        clustered_translations=cl.translations,
        accumulator=votes.accumulator,
        topk_saturated=top.saturated)


@functools.partial(jax.jit,
                   static_argnames=("ref_point_df", "vote_cap", "config",
                                    "seg_cap", "runs_cap"))
def _match_jit(model, scene_points, scene_normals, ref_point_df, vote_cap,
               config, icp_points=None, icp_normals=None, seg_cap=None,
               runs_cap=None):
    return _match_core(model, scene_points, scene_normals,
                       ref_point_df=ref_point_df, vote_cap=vote_cap,
                       config=config, icp_points=icp_points,
                       icp_normals=icp_normals, seg_cap=seg_cap,
                       runs_cap=runs_cap)


@functools.partial(jax.jit, static_argnames=("ref_point_df", "d_angle"))
def _count_votes_rows_jit(model, scene_points, scene_normals, ref_point_df,
                          d_angle):
    """Per-reference-row exact vote counts (the reference's count/scan
    phase, model.cu:99-121) used to size the static expansion buffer.

    Returns (R,) int32 row sums; each row is bounded by n_s x max bucket
    count (< 2^31 for any realistic cloud), so the rows are exact even with
    x64 disabled — the total is summed on host in int64 (a >2^31 grand
    total is plausible at full-res 100k scenes with ref_df=1)."""
    scene_points = jnp.asarray(scene_points, jnp.float32)
    n_s = scene_points.shape[0]
    ref_idx = jnp.arange(0, n_s, ref_point_df, dtype=jnp.int32)
    keys, _ = _scene_keys(model, scene_points,
                          jnp.asarray(scene_normals, jnp.float32),
                          ref_idx, d_angle)
    valid = keys != ppf_ops.INVALID_KEY
    cnt = jnp.where(valid, model.table.counts[jnp.where(valid, keys, 0)], 0)
    return (jnp.sum(cnt, axis=1, dtype=jnp.int32),
            jnp.sum(voting_block.rows_for_counts(cnt), axis=1,
                    dtype=jnp.int32),
            jnp.sum((cnt > 0).astype(jnp.int32), axis=1, dtype=jnp.int32))


@functools.partial(jax.jit, static_argnames=("ref_point_df", "d_angle"))
def _count_votes_totals_jit(model, scene_points, scene_normals,
                            ref_point_df, d_angle):
    """Stacked (3,) int32 totals — ONE device->host transfer instead of
    three (each transfer is a device->host round trip in the sized-match
    path, drost.match). int32 is exact here: every downstream capacity is
    int32, so totals beyond 2^31 are out of scope by construction."""
    rows, brows, nsegs = _count_votes_rows_jit(
        model, scene_points, scene_normals, ref_point_df, d_angle)
    return jnp.stack([jnp.sum(rows, dtype=jnp.int32),
                      jnp.sum(brows, dtype=jnp.int32),
                      jnp.sum(nsegs, dtype=jnp.int32)])


def _count_votes(model, scene_points, scene_normals, ref_point_df,
                 d_angle) -> tuple[int, int, int]:
    """Host-side exact (total votes, total block-engine vote rows, total
    nonzero scene-pair segments)."""
    t = np.asarray(_count_votes_totals_jit(
        model, scene_points, scene_normals, ref_point_df, d_angle))
    return int(t[0]), int(t[1]), int(t[2])


def _next_cap(x: int) -> int:
    """Round a vote capacity up to the next {1, 1.25, 1.5, 1.75}x2^k bucket
    (max 25% slack). Every fill/lookup/tally stage scales with the cap, so
    plain pow2 rounding would cost up to 2x runtime; quarter-steps keep
    recompiles bounded while capping waste."""
    x = max(int(x), 1024)
    k = (x - 1).bit_length() - 1
    base = 1 << k
    for mult in (1.25, 1.5, 1.75, 2.0):
        cap = int(base * mult)
        if cap >= x:
            return cap
    return base * 2


class MatchCaps(NamedTuple):
    """Host-side capacity state of one sized match — everything needed to
    re-dispatch the same compiled buckets WITHOUT the count pass + host
    sync (see match_with_state). `vote_cap` is 0 for the correlation
    engine (capacity-free voting); `runs_cap` None means the engine's
    internal compaction default."""
    vote_cap: int
    seg_cap: int | None
    runs_cap: int | None
    max_poses: int


def match(model: ModelDescription, scene_points, scene_normals,
          config: PPFConfig = PPFConfig(),
          vote_cap: int | None = None, icp_points=None,
          icp_normals=None, runs_cap: int | None = None,
          max_poses_ceiling: int = 8192) -> MatchResult:
    """Match with the `topk_saturated` -> action loop closed: when the
    relative-threshold survivors exceed config.max_poses (the flag the
    reference's argmax-only path never needed — it throws the candidate
    list away, model.cu:293-295), retry with max_poses DOUBLED, the same
    pattern as the correlation engine's runs_cap retry. Bounded by
    max_poses_ceiling (dense clustering is O(max_poses^2)) and by the
    accumulator cell count; if still saturated at the bound the flag is
    returned set — never silently.

    Multi-instance extraction is the consumer this protects: a saturated
    top-K drops the weakest instance's peak first (EVAL.md multi-instance
    study — both k=6 misses were exactly this)."""
    return _match_loop(model, scene_points, scene_normals, config,
                       vote_cap, icp_points, icp_normals, runs_cap,
                       max_poses_ceiling)[0]


def match_with_state(model: ModelDescription, scene_points, scene_normals,
                     config: PPFConfig = PPFConfig(),
                     state: MatchCaps | None = None, icp_points=None,
                     icp_normals=None, max_poses_ceiling: int = 8192,
                     ) -> tuple[MatchResult, MatchCaps]:
    """Serving-loop match: `match()` semantics, plus capacity-state reuse.

    First call (state=None) behaves exactly like match(): exact count
    pass sizes the buffers (one device->host sync), saturation retries
    loop, and the caps that produced the returned result come back as
    `state`. Subsequent calls pass that state: the match dispatches
    IMMEDIATELY against the cached capacity buckets — zero host syncs
    before dispatch, no retrace — which removes the count-pass round
    trip from per-call latency (bench.py `e2e_with_sizing_ms` vs the
    warmed pipeline).

    Safety net (repo invariant: no silent truncation): if the reused caps
    overflow — bigger scene, denser votes — or the top-k saturates, the
    call falls back to the full exact-sizing path and returns refreshed
    caps. The result is therefore always exactly what match() would have
    produced; only the latency differs.

    Reference anchor: the reference re-runs its count/scan phase inside
    every timed lookup (model.cu:99-121) because its buffers live per
    call; a persistent serving loop has no reason to re-count unchanged
    capacity — this is the static-shape replacement, not a semantic drift:
    the overflow flags arrive with the result tensors and the fallback
    re-sizes exactly."""
    if state is not None:
        cfg = dataclasses.replace(config, max_poses=state.max_poses)
        res = _match_jit(model, scene_points, scene_normals,
                         cfg.ref_point_df, state.vote_cap, cfg,
                         icp_points=icp_points, icp_normals=icp_normals,
                         seg_cap=state.seg_cap, runs_cap=state.runs_cap)
        # ONE stacked flag readback — separate bool() casts would pay two
        # sequential device->host round trips on remote-device links (the
        # same latency class the whole function exists to remove).
        ovf, sat = (bool(x) for x in np.asarray(
            jnp.stack([res.overflowed, res.topk_saturated])))
        if not ovf:
            if not sat:
                return res, state
            n_s = int(np.asarray(scene_points).shape[0])
            R = (n_s + cfg.ref_point_df - 1) // cfg.ref_point_df
            cells = R * int(model.n_points) * voting.ALPHA_PAD
            if state.max_poses >= min(max_poses_ceiling, cells):
                # Saturation PERSISTS at the retry ceiling (dense-
                # candidate scenes, e.g. multi-instance at a relative
                # threshold — see EVAL.md): match() would re-derive the
                # identical flagged result; falling back every call would
                # silently forfeit the steady-state latency (a full
                # retry ladder per call). Terminal — return flagged, keep
                # the state.
                return res, state
    return _match_loop(model, scene_points, scene_normals, config,
                       None, icp_points, icp_normals, None,
                       max_poses_ceiling)


def _match_loop(model, scene_points, scene_normals, config, vote_cap,
                icp_points, icp_normals, runs_cap, max_poses_ceiling):
    """The topk_saturated -> double-max_poses retry loop shared by match()
    and match_with_state(); returns (result, caps-that-produced-it)."""
    cfg = config
    while True:
        res, caps = _match_sized_caps(model, scene_points, scene_normals,
                                      cfg, vote_cap, icp_points,
                                      icp_normals, runs_cap)
        if not bool(res.topk_saturated):
            return res, caps
        n_s = int(np.asarray(scene_points).shape[0])
        R = (n_s + cfg.ref_point_df - 1) // cfg.ref_point_df
        cells = R * int(model.n_points) * voting.ALPHA_PAD
        new_mp = min(2 * cfg.max_poses, max_poses_ceiling, cells)
        if new_mp <= cfg.max_poses:
            return res, caps
        cfg = dataclasses.replace(cfg, max_poses=new_mp)


def _match_sized(model: ModelDescription, scene_points, scene_normals,
                 config: PPFConfig = PPFConfig(),
                 vote_cap: int | None = None, icp_points=None,
                 icp_normals=None,
                 runs_cap: int | None = None) -> MatchResult:
    return _match_sized_caps(model, scene_points, scene_normals, config,
                             vote_cap, icp_points, icp_normals,
                             runs_cap)[0]


def _match_sized_caps(model: ModelDescription, scene_points, scene_normals,
                      config: PPFConfig = PPFConfig(),
                      vote_cap: int | None = None, icp_points=None,
                      icp_normals=None,
                      runs_cap: int | None = None
                      ) -> tuple[MatchResult, MatchCaps]:
    """Match a model description against a scene cloud.

    When vote_cap is None, an exact count pass sizes the vote buffer and
    rounds it up to a power of two — never overflows, with at most
    log2-many distinct compilations. Pass an explicit vote_cap for
    fully-static pipelines (and check `result.overflowed`).

    runs_cap (correlation engine only): STARTING capacity for the
    unique-cell compaction; None uses the engine's built-in heuristic.
    Either way the auto-retry loop below guarantees the returned result is
    never truncated, so this is purely a recompile/memory tuning knob.

    icp_points: optional full-resolution scene cloud; when config.refine_icp
    is set, ICP refines against this instead of the (typically voxelized)
    scene_points, beating the voxel-spacing accuracy floor."""
    if config.engine == "correlation":
        if model.corr_tables is None:
            raise ValueError(
                "engine='correlation' requires corr_tables; build the model "
                "description with a correlation config (or rebuild tables "
                "after serialization.load_model_description)")
        # Capacity-free engine except for the unique-cell compaction cap.
        # Start at the built-in heuristic and AUTO-RETRY at the next
        # capacity bucket whenever the runs compaction overflows — the cap
        # clamps to S (exact by construction), so the loop terminates and
        # tallies are never silently truncated (voting_corr.py runs_cap).
        n_s = int(np.asarray(scene_points).shape[0])
        R = (n_s + config.ref_point_df - 1) // config.ref_point_df
        S = R * n_s
        rc = runs_cap             # None → engine-internal default first
        while True:
            res = _match_jit(model, scene_points, scene_normals,
                             config.ref_point_df, 0, config,
                             icp_points=icp_points,
                             icp_normals=icp_normals, runs_cap=rc)
            if rc is not None and rc >= S:
                break
            if not bool(res.overflowed):
                break
            rc = _next_cap(2 * (rc if rc is not None
                                else max(S // 6, 65536)))
        return res, MatchCaps(0, None, rc, config.max_poses)
    if config.engine == "fast" and model.fast_tables is None:
        raise ValueError(
            "engine='fast' requires fast_tables; build the model "
            "description with a fast/correlation config")
    seg_cap = None
    if vote_cap is None:
        total, total_rows, n_segs = _count_votes(
            model, scene_points, scene_normals, config.ref_point_df,
            config.d_angle)
        if config.engine == "fast":
            n_s = int(np.asarray(scene_points).shape[0])
            n_ref = (n_s + config.ref_point_df - 1) // config.ref_point_df
            if model.fast_tables.block is not None:
                # Block engine: capacity is row-granular — each segment
                # rounds up to whole 128-lane rows, plus up to one chunk of
                # row-alignment padding per reference row.
                total = (total_rows
                         + voting_block.CHUNK_ROWS * n_ref) * 128
                # Exact nonzero-segment count: every indexed step of the
                # expansion runs at seg_cap scale, so size it tightly
                # (bucketed for compile stability).
                seg_cap = _next_cap(max(n_segs, 1024))
            else:
                # Row-aligned padding in the fast tally consumes up to one
                # chunk per reference row.
                total += voting_fast.TALLY_CHUNK * n_ref
        vote_cap = _next_cap(total)
    return (_match_jit(model, scene_points, scene_normals,
                       config.ref_point_df, int(vote_cap), config,
                       icp_points=icp_points, icp_normals=icp_normals,
                       seg_cap=seg_cap),
            MatchCaps(int(vote_cap), seg_cap, None, config.max_poses))


def match_accumulator_only(model: ModelDescription, scene_points,
                           scene_normals, config: PPFConfig = PPFConfig(),
                           vote_cap: int | None = None) -> voting.VoteResult:
    """Voting only — the MATLAB voting_scheme.m dense-accumulator semantics,
    for golden tests and benchmarking the hot path in isolation."""
    scene_points = jnp.asarray(scene_points, jnp.float32)
    scene_normals = jnp.asarray(scene_normals, jnp.float32)
    n_s = scene_points.shape[0]
    if vote_cap is None:
        vote_cap = _next_cap(_count_votes(
            model, scene_points, scene_normals, config.ref_point_df,
            config.d_angle)[0])
    ref_idx = jnp.arange(0, n_s, config.ref_point_df, dtype=jnp.int32)
    keys, alpha_s = _scene_keys(model, scene_points, scene_normals,
                                ref_idx, config.d_angle)
    return voting.cast_votes(keys, alpha_s, model.table, model.n_points,
                             config.d_angle, int(vote_cap))


def match_greedy_cpu(model: ModelDescription, scene_points, scene_normals,
                     config: PPFConfig = PPFConfig(),
                     vote_cap: int | None = None):
    """Match with the reference's CPU clustering mode
    (ClusterTransformationsCPU, model.cu:246-266): device voting + pose
    reconstruction, host greedy clustering; returns (pose, GreedyCluster)."""
    res = match(model, scene_points, scene_normals, config, vote_cap)
    keep = np.asarray(res.pose_keep)
    poses = np.asarray(res.poses)[keep]
    votes = np.asarray(res.pose_votes)[keep].astype(np.float32)
    gc = clustering.cluster_poses_greedy(
        poses, votes, float(model.d_dist), config.d_angle)
    return gc.poses[0], gc


def extract_instances(result: MatchResult, diameter: float,
                      max_instances: int = 8,
                      min_votes_frac: float = 0.25,
                      min_separation_factor: float = 0.7
                      ) -> tuple[list[np.ndarray], list[float]]:
    """Multi-instance output: greedy non-max suppression over the clustered
    candidate poses — the bin-picking extension (the reference returns only
    the single argmax winner, model.cu:293-295, even though the candidate
    list contains every instance's peak).

    Suppression is by TRANSLATION distance only: two physical instances
    cannot overlap, so candidates closer than min_separation_factor ·
    diameter are aliases of the same instance (α/symmetry aliases share
    the translation).

    Use `PPFConfig(cluster_center_cell=True, max_poses=<large>)` for
    multi-instance scenes: the reference's center-cell quirk (own
    translation cell excluded from the neighborhood, kernel.cu:684-689)
    makes clustered counts incomparable ACROSS instances — an instance
    whose candidate poses all share one grid cell aggregates nothing —
    and a small top-K can fill up with one instance's cells before the
    others appear.

    Args:
      result: a MatchResult from match().
      diameter: model diameter (ModelDescription.diameter).
      max_instances: static upper bound on returned instances.
      min_votes_frac: stop when a candidate's clustered count falls below
        this fraction of the strongest (weaker peaks are clutter echoes).

    Returns ([pose (4,4)...], [clustered vote count...]), strongest first.
    """
    keep = np.asarray(result.pose_keep)
    poses = np.asarray(result.poses)[keep]
    counts = np.asarray(result.clustered_counts)[keep]
    # Cluster-refined translations (averaged when use_averaged_clusters,
    # else grid-consistent) — the per-candidate analog of the winner's
    # translation patch (ppf.cu:80-92); raw Hough translations carry the
    # full d_dist quantization noise.
    trans = getattr(result, "clustered_translations", None)
    if trans is not None:
        poses = poses.copy()
        poses[:, :3, 3] = np.asarray(trans)[keep]
    if len(counts) == 0:
        return [], []
    order = np.argsort(-counts)
    vmax = float(counts[order[0]])
    thresh = min_separation_factor * diameter
    out_p: list[np.ndarray] = []
    out_c: list[float] = []
    for i in order:
        if float(counts[i]) < min_votes_frac * vmax \
                or len(out_p) >= max_instances:
            break
        t = poses[i][:3, 3]
        if all(np.linalg.norm(t - p[:3, 3]) > thresh for p in out_p):
            out_p.append(poses[i])
            out_c.append(float(counts[i]))
    return out_p, out_c
