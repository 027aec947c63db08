"""End-to-end pose recovery tests — the automated version of the
reference's synthetic-scene integration testing (scene_generation.hpp +
CLI validation, SURVEY.md §4.3-4.4)."""

import math

import numpy as np
import pytest

import objective_slam_tpu as ost
from objective_slam_tpu.config import PPFConfig
from objective_slam_tpu.models import drost
from objective_slam_tpu.ops import transforms as tr
from objective_slam_tpu.utils import pointcloud as pc, synthetic, validation


def _recover(rng, cfg, n_model=100, n_clutter=0, **match_kw):
    mp, mn = synthetic.blob_cloud(rng, n_model)
    if n_clutter:
        cp, cn = synthetic.clutter_cloud(rng, n_clutter)
    else:
        cp = cn = None
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn, cp, cn)
    desc = ost.build_model_description(mp, mn, cfg)
    res = ost.match(desc, sp, sn, cfg, **match_kw)
    return desc, res, T_true


def _check(desc, res, T_true, cfg=PPFConfig()):
    v = validation.validate_pose(np.asarray(res.pose), T_true,
                                 desc.diameter, cfg)
    assert not bool(res.overflowed)
    assert v.match, (v.trans_err, math.degrees(v.rot_err))
    return v


def test_recover_clean_scene(rng):
    cfg = PPFConfig(max_poses=512)
    desc, res, T_true = _recover(rng, cfg)
    _check(desc, res, T_true)


def test_recover_cluttered_scene(rng):
    cfg = PPFConfig(max_poses=512)
    desc, res, T_true = _recover(rng, cfg, n_clutter=80,
                                 vote_cap=4_000_000)
    _check(desc, res, T_true)


def test_recover_with_ref_point_df(rng):
    cfg = PPFConfig(max_poses=512, ref_point_df=2)
    desc, res, T_true = _recover(rng, cfg, n_model=140)
    _check(desc, res, T_true)


def test_recover_averaged_clusters(rng):
    cfg = PPFConfig(max_poses=512, use_averaged_clusters=True)
    desc, res, T_true = _recover(rng, cfg)
    _check(desc, res, T_true)


def test_recover_l1_norm(rng):
    cfg = PPFConfig(max_poses=512, use_l1_norm=True)
    desc, res, T_true = _recover(rng, cfg)
    _check(desc, res, T_true)


def test_recover_corrected_clustering(rng):
    cfg = PPFConfig(max_poses=512, cluster_center_cell=True)
    desc, res, T_true = _recover(rng, cfg)
    _check(desc, res, T_true)


def test_recover_greedy_cpu_clustering(rng):
    """The reference's --cpu_clustering mode (model.cu:246-266)."""
    cfg = PPFConfig(max_poses=512)
    mp, mn = synthetic.blob_cloud(rng, 100)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = ost.build_model_description(mp, mn, cfg)
    pose, clusters = drost.match_greedy_cpu(desc, sp, sn, cfg)
    v = validation.validate_pose(pose, T_true, desc.diameter, cfg)
    assert v.match, (v.trans_err, math.degrees(v.rot_err))
    assert clusters.votes[0] >= clusters.votes[-1]


def test_clutter_only_low_confidence(rng):
    """Model absent -> much lower winning vote count than model present."""
    cfg = PPFConfig(max_poses=512)
    mp, mn = synthetic.blob_cloud(rng, 100)
    desc = ost.build_model_description(mp, mn, cfg)
    sp, sn, _ = synthetic.plant_model(rng, mp, mn)
    present = ost.match(desc, sp, sn, cfg)
    cp, cn = synthetic.clutter_cloud(rng, 100)
    absent = ost.match(desc, cp, cn, cfg, vote_cap=4_000_000)
    assert int(absent.pose_votes[0]) < 0.2 * int(present.pose_votes[0])


def test_voxelized_scene_recovery(rng):
    """Full preprocessing chain: dense scene -> device voxel grid (with
    sentinel padding) -> match. Padding must not perturb the pose."""
    cfg = PPFConfig(max_poses=512)
    mp, mn = synthetic.blob_cloud(rng, 150)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    # Duplicate points with jitter to simulate a dense raw scan.
    dense_p = np.concatenate([sp + rng.normal(scale=1e-3, size=sp.shape)
                              for _ in range(4)]).astype(np.float32)
    dense_n = np.concatenate([sn] * 4).astype(np.float32)
    vox = pc.voxel_downsample(dense_p, dense_n, leaf=0.05)
    desc = ost.build_model_description(mp, mn, cfg)
    res = ost.match(desc, np.asarray(vox.points), np.asarray(vox.normals),
                    cfg, vote_cap=6_000_000)
    v = validation.validate_pose(np.asarray(res.pose), T_true,
                                 desc.diameter, cfg)
    assert v.match, (v.trans_err, math.degrees(v.rot_err))


def test_match_result_diagnostics(rng):
    cfg = PPFConfig(max_poses=256)
    desc, res, T_true = _recover(rng, cfg, n_model=60)
    assert res.poses.shape == (256, 4, 4)
    counts = np.asarray(res.pose_votes)
    assert (np.diff(counts) <= 0).all()   # descending
    assert int(res.num_votes) == int(np.asarray(res.accumulator).sum())


def test_recovery_with_estimated_normals(rng):
    """Full chain with kNN-estimated normals on BOTH sides (consistent
    'outward' orientation). Mixing conventions is known to fail — PPF
    requires one convention (documented in estimate_normals_knn)."""
    cfg = PPFConfig(max_poses=512)
    mp, _ = synthetic.blob_cloud(rng, 150)
    mn_est = np.asarray(pc.estimate_normals_knn(mp, k=12, orient="outward"))
    sp, _, T_true = synthetic.plant_model(rng, mp, mn_est)
    s_est = np.asarray(pc.estimate_normals_knn(sp, k=12, orient="outward"))
    desc = ost.build_model_description(mp, mn_est, cfg)
    res = ost.match(desc, sp, s_est, cfg)
    v = validation.validate_pose(np.asarray(res.pose), T_true,
                                 desc.diameter, cfg)
    assert v.match, (v.trans_err, math.degrees(v.rot_err))


def test_model_point_vote_weights(rng):
    """SetModelPointVoteWeights parity (model.cu:91-93, vote_weight_kernel
    kernel.cu:766-782): zeroing all weights kills clustered counts; raw
    counts (thresholding inputs) are unaffected."""
    # Corrected clustering mode: in parity mode the reference's center-cell
    # quirk (kernel.cu:684-689) prevents same-cell poses from aggregating,
    # so weights would be invisible on a clean scene.
    cfg = PPFConfig(max_poses=128, cluster_center_cell=True)
    mp, mn = synthetic.blob_cloud(rng, 60)
    sp, sn, _ = synthetic.plant_model(rng, mp, mn)
    d1 = ost.build_model_description(mp, mn, cfg)
    d0 = ost.build_model_description(mp, mn, cfg,
                                     vote_weights=np.zeros(60, np.float32))
    r1 = ost.match(d1, sp, sn, cfg)
    r0 = ost.match(d0, sp, sn, cfg)
    # Raw counts (thresholding inputs) are weight-independent.
    np.testing.assert_array_equal(np.asarray(r1.pose_votes),
                                  np.asarray(r0.pose_votes))
    # Zero weights zero every clustered count; real weights do not.
    cc = np.asarray(r0.clustered_counts)[np.asarray(r0.pose_keep)]
    assert (cc == 0.0).all()
    assert float(r1.cluster_votes) > 0.0


def test_rescoring_with_distractors(rng):
    """Recovery among curved distractor objects with geometric rescoring
    enabled (the bench-scale case lives in the benchmark; this guards
    the rescoring path end-to-end on CPU)."""
    base = dict(max_poses=512, engine="correlation")
    mp, mn = synthetic.blob_cloud(rng, 150, bumps=0.25)   # weak features
    dp1, dn1 = synthetic.blob_cloud(rng, 80, bumps=0.3)
    dp2, dn2 = synthetic.blob_cloud(rng, 80, bumps=0.3)
    clutter_p = np.concatenate([dp1 * 1.2 + np.array([3.0, 0, 0]),
                                dp2 * 0.9 + np.array([0, 3.0, 0])])
    clutter_n = np.concatenate([dn1, dn2]).astype(np.float32)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn,
                                           clutter_p.astype(np.float32),
                                           clutter_n)
    cfg = PPFConfig(rescore_poses=True, **base)
    desc = ost.build_model_description(mp, mn, cfg)
    res = ost.match(desc, sp, sn, cfg)
    v = validation.validate_pose(np.asarray(res.pose), T_true,
                                 desc.diameter, cfg)
    assert v.match, (v.trans_err, math.degrees(v.rot_err))


def test_rescoring_preserves_easy_recovery(rng):
    cfg = PPFConfig(max_poses=256, rescore_poses=True)
    desc, res, T_true = _recover(rng, cfg)
    _check(desc, res, T_true, cfg)


def test_fnv_keying_mode_recovers_pose(rng):
    """Operational FNV keying (use_fnv_keys): the pipeline matches through
    bit-exact FNV-1a feature hashes including the reference's collision
    conflation (kernel.cu:460-477) — and still recovers the pose."""
    cfg = PPFConfig(use_fnv_keys=True, max_poses=256)
    mp, mn = synthetic.blob_cloud(rng, 110)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = ost.build_model_description(mp, mn, cfg)
    assert desc.fnv_remap is not None and desc.fnv_remap.k_occ > 0
    res = ost.match(desc, sp, sn, cfg)
    v = validation.validate_pose(np.asarray(res.pose), T_true,
                                 desc.diameter, cfg)
    assert v.match, (v.trans_err, v.rot_err)


def test_fnv_mode_tallies_equal_packed_when_no_collisions(rng):
    """With no FNV collisions among the occupied keys (checked), the FNV
    remap is a bijection of the packed key space — accumulators must be
    IDENTICAL to the packed-key pipeline."""
    from objective_slam_tpu.ops import hashing, ppf as ppf_ops
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, _ = synthetic.plant_model(rng, mp, mn)
    cfg_p = PPFConfig(engine="reference", max_poses=128)
    cfg_f = PPFConfig(engine="reference", max_poses=128, use_fnv_keys=True)
    desc_p = ost.build_model_description(mp, mn, cfg_p)
    desc_f = ost.build_model_description(mp, mn, cfg_f)
    # Verify the premise: occupied packed keys hash collision-free.
    occ = np.nonzero(np.asarray(desc_p.table.counts))[0].astype(np.int32)
    h = np.asarray(hashing.packed_key_fnv(occ, float(desc_p.d_dist),
                                          cfg_p.d_angle))
    assert len(np.unique(h)) == len(h) and (h != 0).all(), \
        "collision in this cloud; pick another seed"
    rp = ost.match(desc_p, sp, sn, cfg_p)
    rf = ost.match(desc_f, sp, sn, cfg_f)
    np.testing.assert_array_equal(np.asarray(rp.accumulator),
                                  np.asarray(rf.accumulator))
    assert int(rp.num_votes) == int(rf.num_votes)


def test_fnv_mode_serialization_roundtrip(tmp_path, rng):
    from objective_slam_tpu.utils import serialization
    cfg = PPFConfig(use_fnv_keys=True, max_poses=128)
    mp, mn = synthetic.blob_cloud(rng, 80)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = ost.build_model_description(mp, mn, cfg)
    path = tmp_path / "fnv_model.npz"
    serialization.save_model_description(path, desc)
    loaded = serialization.load_model_description(path)
    assert loaded.fnv_remap is not None
    assert loaded.fnv_remap.k_occ == desc.fnv_remap.k_occ
    r0 = ost.match(desc, sp, sn, cfg)
    r1 = ost.match(loaded, sp, sn, cfg)
    np.testing.assert_array_equal(np.asarray(r0.accumulator),
                                  np.asarray(r1.accumulator))


def test_extract_instances_bin_picking(rng):
    """Multi-instance scene: extract_instances recovers EVERY planted
    instance from one match's candidate list (the reference only ever
    returns the argmax winner)."""
    mp, mn = synthetic.blob_cloud(rng, 2500, bumps=0.5)
    diam = pc.bbox_diameter(mp)
    # Plant 3 well-separated instances into planar clutter.
    u = rng.uniform(-1.5, 1.5, size=(2000, 2))
    cp = np.concatenate([u, rng.normal(scale=0.01, size=(2000, 1))],
                        axis=1).astype(np.float32)
    cp += np.float32([0, 0, -2.5])
    cn = np.tile(np.float32([0, 0, 1]), (2000, 1))
    sp, sn = cp, cn
    truths = []
    offsets = [np.float32([0, 0, 0]), np.float32([3.5, 0, 0]),
               np.float32([0, 3.5, 0])]
    for off in offsets:
        sel = rng.choice(len(mp), size=1800, replace=False)
        sp, sn, T = synthetic.plant_model(rng, mp[sel], mn[sel], sp, sn,
                                          translation=off)
        truths.append(T)

    # max_poses must cover ALL instances' candidate cells (each instance
    # here owns ~300-1000 cells), and the corrected clustering mode makes
    # cluster counts comparable across instances (see extract_instances).
    cfg = PPFConfig(ref_point_df=2, max_poses=2048,
                    cluster_center_cell=True)
    d_dist = cfg.tau_d * diam
    mpd, mnd = pc.voxel_downsample_np(mp, mn, d_dist)
    desc = ost.build_model_description(mpd, mnd, cfg, d_dist=d_dist)
    spd, snd = pc.voxel_downsample_np(sp, sn, d_dist)
    res = ost.match(desc, spd, snd, cfg)

    inst, votes = drost.extract_instances(res, desc.diameter,
                                          max_instances=5)
    assert len(inst) >= 3, len(inst)
    # Each truth matched by exactly one distinct extracted instance.
    used = set()
    for T_true in truths:
        errs = [tr.ht_dist(p, T_true) for p in inst]
        best = int(np.argmin([float(e[0]) for e in errs]))
        td, rd = (float(x) for x in errs[best])
        assert best not in used
        assert td < 0.1 * desc.diameter and rd < math.radians(12), (td, rd)
        used.add(best)


def test_topk_saturated_auto_retry(rng):
    """match() must close the topk_saturated -> action loop: a max_poses
    too small for the threshold survivors retries doubled (the corr
    runs_cap pattern) until the flag clears, instead of returning a
    silently truncated candidate list (VERDICT r3 weak-6)."""
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    cfg = PPFConfig(max_poses=2)
    desc = ost.build_model_description(mp, mn, cfg)

    # The raw sized path really does saturate at max_poses=2 (premise).
    raw = drost._match_sized(desc, sp, sn, cfg)
    assert bool(raw.topk_saturated)

    res = ost.match(desc, sp, sn, cfg)
    assert not bool(res.topk_saturated)
    td, rd = (float(x) for x in tr.ht_dist(np.asarray(res.pose), T_true))
    assert td < 0.1 * desc.diameter and rd < math.radians(12), (td, rd)

    # The ceiling bounds the loop: with ceiling == the starting max_poses
    # no retry is possible and the flag comes back set, never silently.
    res_capped = ost.match(desc, sp, sn, cfg, max_poses_ceiling=2)
    assert bool(res_capped.topk_saturated)


def test_match_with_state_steady_state_skips_count(rng, monkeypatch):
    """Serving-loop API: the second call with cached caps must dispatch
    with ZERO count passes (the per-call host sync drost.match pays) and
    produce the identical result; an undersized state must fall back to
    exact sizing instead of returning a truncated result."""
    cfg = PPFConfig(max_poses=256)
    mp, mn = synthetic.blob_cloud(rng, 100)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = ost.build_model_description(mp, mn, cfg)

    res1, caps = ost.match_with_state(desc, sp, sn, cfg)
    assert caps.vote_cap > 0 and caps.max_poses == 256
    v = validation.validate_pose(np.asarray(res1.pose), T_true,
                                 desc.diameter, cfg)
    assert v.match

    # Steady state: count pass must NOT run.
    def boom(*a, **k):
        raise AssertionError("count pass ran on the steady-state path")
    monkeypatch.setattr(drost, "_count_votes", boom)
    res2, caps2 = ost.match_with_state(desc, sp, sn, cfg, state=caps)
    assert caps2 == caps
    np.testing.assert_array_equal(np.asarray(res1.pose),
                                  np.asarray(res2.pose))
    np.testing.assert_array_equal(np.asarray(res1.accumulator),
                                  np.asarray(res2.accumulator))
    monkeypatch.undo()

    # Undersized caps (vote_cap 1024 floor is far below this scene's
    # votes): overflow must trigger the exact-sizing fallback, not a
    # silently truncated result.
    bad = drost.MatchCaps(1024, caps.seg_cap, None, 256)
    res3, caps3 = ost.match_with_state(desc, sp, sn, cfg, state=bad)
    assert caps3.vote_cap == caps.vote_cap
    assert not bool(res3.overflowed)
    np.testing.assert_array_equal(np.asarray(res1.pose),
                                  np.asarray(res3.pose))


def test_match_with_state_correlation_engine(rng):
    """Correlation engine: capacity-free voting — state reuse must hold
    the runs_cap bucket and produce the same pose."""
    cfg = PPFConfig(max_poses=256, engine="correlation")
    mp, mn = synthetic.blob_cloud(rng, 100)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = ost.build_model_description(mp, mn, cfg)
    res1, caps = ost.match_with_state(desc, sp, sn, cfg)
    assert caps.vote_cap == 0
    res2, caps2 = ost.match_with_state(desc, sp, sn, cfg, state=caps)
    assert caps2 == caps
    np.testing.assert_array_equal(np.asarray(res1.pose),
                                  np.asarray(res2.pose))
    v = validation.validate_pose(np.asarray(res1.pose), T_true,
                                 desc.diameter, cfg)
    assert v.match


def test_match_with_state_terminal_saturation(rng, monkeypatch):
    """Saturation that persists at the retry ceiling is TERMINAL: the
    steady-state path must return the flagged result without re-running
    the count pass every call (fallback-per-call measured 3.3 s vs 0.47 s
    on the bench scene), since match() would re-derive the identical
    flagged result."""
    cfg = PPFConfig(max_poses=4)          # absurdly small: saturates
    mp, mn = synthetic.blob_cloud(rng, 100)
    sp, sn, _ = synthetic.plant_model(rng, mp, mn)
    desc = ost.build_model_description(mp, mn, cfg)
    res1, caps = ost.match_with_state(desc, sp, sn, cfg,
                                      max_poses_ceiling=4)
    assert bool(res1.topk_saturated) and caps.max_poses == 4

    def boom(*a, **k):
        raise AssertionError("count pass ran on terminal-saturation path")
    monkeypatch.setattr(drost, "_count_votes", boom)
    res2, caps2 = ost.match_with_state(desc, sp, sn, cfg, state=caps,
                                       max_poses_ceiling=4)
    assert caps2 == caps and bool(res2.topk_saturated)
    np.testing.assert_array_equal(np.asarray(res1.pose),
                                  np.asarray(res2.pose))
