"""Golden tests: the voting engines vs the NumPy/MATLAB-semantics
reference on small clouds — the rebuild's equivalent of the reference's
MATLAB↔CUDA cross-validation (SURVEY.md §4.1)."""

import math

import numpy as np
import jax.numpy as jnp

from objective_slam_tpu.config import PPFConfig
from objective_slam_tpu.models import drost
from objective_slam_tpu.ops import ppf as ppf_ops, voting
import reference_impl as ref

D_ANGLE = 2 * math.pi / 30


def small_cloud(rng, n):
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm.astype(np.float32)


def test_key_table_contents(rng):
    """Table buckets must contain exactly the reference's model-description
    pair lists (model_description.m:30-68), keyed identically."""
    pts, nrm = small_cloud(rng, 14)
    d_dist = 0.4
    max_bin = 32
    keys, alpha = ppf_ops.pairwise_ppf_keys(pts, nrm, d_dist, D_ANGLE,
                                            max_bin)
    table = voting.build_key_table(keys, alpha, ppf_ops.num_keys(max_bin))
    ref_table = ref.model_description(pts, nrm, d_dist, D_ANGLE)

    counts = np.asarray(table.counts)
    offsets = np.asarray(table.offsets)
    pair_mr = np.asarray(table.pair_mr)
    total_ref = sum(len(v) for v in ref_table.values())
    assert counts.sum() == total_ref

    for key_tuple, pairs in ref_table.items():
        kd, k1, k2, k3 = key_tuple
        packed = ((kd * 16 + k1) * 16 + k2) * 16 + k3
        got_n = counts[packed]
        # fp boundary differences can move pairs between adjacent bins; the
        # clouds here are far from boundaries with overwhelming probability,
        # so require exact agreement (and fail loudly if not).
        assert got_n == len(pairs), key_tuple
        got_mr = sorted(pair_mr[offsets[packed]:offsets[packed] + got_n])
        assert got_mr == sorted(p[0] for p in pairs)


def test_accumulator_matches_reference(rng):
    """Dense accumulator == the MATLAB dense voting_scheme tallies."""
    m_pts, m_nrm = small_cloud(rng, 10)
    s_pts, s_nrm = small_cloud(rng, 12)
    d_dist = 0.5
    cfg = PPFConfig()
    desc = drost.build_model_description(m_pts, m_nrm, cfg, d_dist=d_dist)
    out = drost.match_accumulator_only(desc, s_pts, s_nrm, cfg)
    acc = np.asarray(out.accumulator)

    ref_acc = ref.voting(m_pts, m_nrm, s_pts, s_nrm, d_dist, D_ANGLE)
    assert not bool(out.overflowed)
    assert int(out.num_votes) == ref_acc.sum()
    np.testing.assert_array_equal(acc[:, :, :31], ref_acc)
    assert (acc[:, :, 31:] == 0).all()


def test_accumulator_with_ref_point_df(rng):
    """ref_point_df strides the reference rows (kernel.cu:432-435)."""
    m_pts, m_nrm = small_cloud(rng, 8)
    s_pts, s_nrm = small_cloud(rng, 15)
    d_dist = 0.5
    cfg = PPFConfig(ref_point_df=5)
    desc = drost.build_model_description(m_pts, m_nrm, cfg, d_dist=d_dist)
    out = drost.match_accumulator_only(desc, s_pts, s_nrm, cfg)
    acc = np.asarray(out.accumulator)
    ref_acc = ref.voting(m_pts, m_nrm, s_pts, s_nrm, d_dist, D_ANGLE, skip=5)
    assert acc.shape[0] == ref_acc.shape[0] == 3
    np.testing.assert_array_equal(acc[:, :, :31], ref_acc)


def test_vote_overflow_flag(rng):
    m_pts, m_nrm = small_cloud(rng, 10)
    # Scene = the model itself -> every model pair matches some scene pair,
    # guaranteeing plenty of votes.
    s_pts, s_nrm = m_pts, m_nrm
    cfg = PPFConfig()
    desc = drost.build_model_description(m_pts, m_nrm, cfg, d_dist=0.5)
    full = drost.match_accumulator_only(desc, s_pts, s_nrm, cfg)
    n_true = int(full.num_votes)
    assert n_true > 4
    capped = drost.match_accumulator_only(desc, s_pts, s_nrm, cfg,
                                          vote_cap=4)
    assert bool(capped.overflowed)
    assert int(np.asarray(capped.accumulator).sum()) == 4


def test_top_votes_threshold():
    acc = jnp.zeros((2, 3, 32), jnp.int32)
    acc = acc.at[1, 2, 5].set(100)
    acc = acc.at[0, 1, 7].set(50)
    acc = acc.at[0, 0, 0].set(39)   # below 0.4*100 -> dropped
    top = voting.top_votes(acc, 0.4, max_poses=8)
    counts = np.asarray(top.counts)
    keep = np.asarray(top.keep)
    assert counts[0] == 100 and keep[0]
    assert counts[1] == 50 and keep[1]
    # 39 < 40 -> not kept (strict >, model.cu:167)
    assert not keep[2]
    assert np.asarray(top.ref_idx)[0] == 1
    assert np.asarray(top.model_idx)[0] == 2
    assert np.asarray(top.alpha_idx)[0] == 5


def test_top_votes_saturated_flag():
    """saturated=True when above-threshold cells exceed max_poses (silent
    truncation is no longer silent — VERDICT r1 weak #6a)."""
    acc = jnp.zeros((2, 3, 32), jnp.int32)
    top = voting.top_votes(acc.at[0, 0, 0].set(10), 0.4, max_poses=8)
    assert not bool(top.saturated)
    # 12 cells at 100 > 0.4*100, but max_poses=8 -> saturated.
    acc2 = jnp.zeros((2, 3, 32), jnp.int32)
    for i in range(12):
        acc2 = acc2.at[i % 2, i % 3, i].set(100)
    top2 = voting.top_votes(acc2, 0.4, max_poses=8)
    assert bool(top2.saturated)
    # Exactly max_poses survivors -> not saturated.
    acc3 = jnp.zeros((2, 3, 32), jnp.int32)
    for i in range(8):
        acc3 = acc3.at[i % 2, i % 3, i].set(100)
    top3 = voting.top_votes(acc3, 0.4, max_poses=8)
    assert not bool(top3.saturated)


def test_top_votes_saturated_flag_hierarchical():
    """The hierarchical path flags survivors spanning more blocks than it
    gathers (scattered peaks across a large accumulator)."""
    import numpy as onp
    R, n_m, A = 64, 64, 32
    n = R * n_m * A                                # 131072 cells, block path
    max_poses = 4
    acc = onp.zeros((n,), onp.int32)
    # Spread 40 equal peaks far apart: block budget = max(64*4//1024, 64)=64
    # blocks, so 40 peaks in 40 distinct blocks still fit -> craft more
    # above-threshold cells than max_poses instead (first condition).
    idxs = onp.linspace(0, n - 1, 40).astype(onp.int64)
    acc[idxs] = 100
    top = voting.top_votes(jnp.asarray(acc).reshape(R, n_m, A), 0.4,
                           max_poses=max_poses)
    assert bool(top.saturated)
    # A single dominant peak is not saturated.
    acc2 = onp.zeros((n,), onp.int32)
    acc2[5] = 100
    top2 = voting.top_votes(jnp.asarray(acc2).reshape(R, n_m, A), 0.4,
                            max_poses=max_poses)
    assert not bool(top2.saturated)


def test_threshold_boundary_is_strict():
    """count == threshold·max must be dropped (x > min_votecount,
    model.cu:164-167)."""
    acc = jnp.zeros((1, 2, 32), jnp.int32)
    acc = acc.at[0, 0, 0].set(10)
    acc = acc.at[0, 1, 0].set(4)    # exactly 0.4*10
    top = voting.top_votes(acc, 0.4, max_poses=4)
    keep = np.asarray(top.keep)
    assert keep[0] and not keep[1]


def test_fast_engine_matches_reference_engine(rng):
    """ops/voting_fast must produce the exact same dense accumulator as the
    simple expansion engine, including ref_point_df striding and row
    padding edge cases."""
    import jax.numpy as jnp
    from objective_slam_tpu.ops import transforms as tr
    from objective_slam_tpu.ops import voting_fast

    for n_m, n_s, df in [(10, 12, 1), (9, 25, 3), (16, 16, 1)]:
        m_pts, m_nrm = small_cloud(rng, n_m)
        s_pts, s_nrm = small_cloud(rng, n_s)
        cfg = PPFConfig(ref_point_df=df)
        desc = drost.build_model_description(m_pts, m_nrm, cfg, d_dist=0.5)
        ref_out = drost.match_accumulator_only(desc, s_pts, s_nrm, cfg)

        ref_idx = jnp.arange(0, n_s, df, dtype=jnp.int32)
        keys, alpha_s = ppf_ops.pairwise_ppf_keys(
            s_pts, s_nrm, desc.d_dist, cfg.d_angle, desc.max_dist_bin,
            ref_indices=ref_idx)
        n_ref = len(np.asarray(ref_idx))
        for mxu in (True, False):
            fast = voting_fast.cast_votes_fast(
                keys, alpha_s, desc.fast_tables, desc.n_points, cfg.d_angle,
                vote_cap=int(ref_out.num_votes) +
                voting_fast.TALLY_CHUNK * n_ref,
                use_mxu_tally=mxu)
            assert int(fast.num_votes) == int(ref_out.num_votes), (n_m, mxu)
            assert not bool(fast.overflowed)
            got = np.asarray(fast.accumulator)
            want = np.asarray(ref_out.accumulator)
            # The fast engine recomputes α_s per vote; compiler fma/
            # reassociation can shift votes sitting exactly on an α-bin
            # boundary by one bin (same fp32-tolerance class as the
            # reference's own MATLAB-vs-CUDA comparisons). Totals match
            # exactly; allow a tiny fraction of ±1 adjacent-bin moves.
            assert got.sum() == want.sum()
            diff = got.astype(np.int64) - want
            assert np.abs(diff).max() <= 1, (n_m, mxu)
            frac = np.abs(diff).sum() / max(want.sum(), 1)
            assert frac < 0.005, (n_m, mxu, frac)
            # Moves must stay within a (ref, model) row (only the α bin
            # may shift).
            assert (diff.sum(axis=2) == 0).all(), (n_m, mxu)


def test_correlation_engine_blurs_within_one_alpha_bin(rng):
    """The correlation engine's accumulator must match the exact engine up
    to transport between ADJACENT α bins: per-(ref, model) row totals are
    identical and every vote lands within ±1 bin (circularly)."""
    from objective_slam_tpu.ops import voting_corr

    m_pts, m_nrm = small_cloud(rng, 12)
    s_pts, s_nrm = small_cloud(rng, 14)
    cfg_c = PPFConfig(engine="correlation")
    desc = drost.build_model_description(m_pts, m_nrm, cfg_c, d_dist=0.5)
    exact = drost.match_accumulator_only(desc, s_pts, s_nrm, PPFConfig())

    ref_idx = jnp.arange(0, 14, dtype=jnp.int32)
    keys, alpha_s = ppf_ops.pairwise_ppf_keys(
        s_pts, s_nrm, desc.d_dist, PPFConfig().d_angle, desc.max_dist_bin,
        ref_indices=ref_idx)
    corr = voting_corr.cast_votes_corr(keys, alpha_s, desc.corr_tables,
                                       desc.n_points)
    a_e = np.asarray(exact.accumulator)
    a_c = np.asarray(corr.accumulator)
    assert int(corr.num_votes) == int(exact.num_votes)
    # Row mass preserved.
    np.testing.assert_array_equal(a_c.sum(axis=2), a_e.sum(axis=2))
    # Bin 30 of the exact engine maps into the 30-bin circular space.
    e = a_e[:, :, :31].astype(np.int64).copy()
    e[:, :, 0] += e[:, :, 30]
    e = e[:, :, :30]
    c = a_c[:, :, :30].astype(np.int64)
    # ±1-bin circular transport feasibility: for every row, the cumulative
    # mismatch between the two circular histograms never exceeds what
    # adjacent-bin moves can explain. A simple sufficient check: blurring
    # both with a [1,1,1] circular kernel makes corr dominate exact.
    blur = (np.roll(c, 1, axis=2) + c + np.roll(c, -1, axis=2))
    assert (blur >= e).all()
    blur_e = (np.roll(e, 1, axis=2) + e + np.roll(e, -1, axis=2))
    assert (blur_e >= c).all()


def test_correlation_engine_recovers_pose(rng):
    """End-to-end recovery with engine='correlation'."""
    from objective_slam_tpu.utils import synthetic, validation
    import objective_slam_tpu as ost

    cfg = PPFConfig(engine="correlation", max_poses=256)
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = ost.build_model_description(mp, mn, cfg)
    res = ost.match(desc, sp, sn, cfg)
    v = validation.validate_pose(np.asarray(res.pose), T_true,
                                 desc.diameter, cfg)
    assert v.match, (v.trans_err, v.rot_err)


def test_correlation_runs_cap_overflow_and_retry(rng):
    """An undersized unique-cell compaction cap must (a) raise the
    `overflowed` flag at the engine level — never silently truncate — and
    (b) be healed transparently by drost.match's auto-retry loop
    (drost.py match() correlation branch), yielding tallies identical to
    an uncapped run."""
    from objective_slam_tpu.ops import voting_corr
    from objective_slam_tpu.utils import synthetic, validation
    import objective_slam_tpu as ost

    cfg = PPFConfig(engine="correlation", max_poses=256)
    mp, mn = synthetic.blob_cloud(rng, 90)
    sp, sn, T_true = synthetic.plant_model(rng, mp, mn)
    desc = drost.build_model_description(mp, mn, cfg)

    # (a) Engine level: runs_cap far below the unique-cell count.
    n_s = sp.shape[0]
    ref_idx = jnp.arange(0, n_s, dtype=jnp.int32)
    keys, alpha_s = ppf_ops.pairwise_ppf_keys(
        sp, sn, desc.d_dist, cfg.d_angle, desc.max_dist_bin,
        ref_indices=ref_idx)
    capped = voting_corr.cast_votes_corr(keys, alpha_s, desc.corr_tables,
                                         desc.n_points, runs_cap=128)
    assert bool(capped.overflowed)
    full = voting_corr.cast_votes_corr(keys, alpha_s, desc.corr_tables,
                                       desc.n_points)
    assert not bool(full.overflowed)

    # (b) match() level: a starting cap of 128 must retry up the capacity
    # buckets and converge to the same (non-overflowed) result.
    res = ost.match(desc, sp, sn, cfg, runs_cap=128)
    assert not bool(res.overflowed)
    ref_res = ost.match(desc, sp, sn, cfg)
    np.testing.assert_array_equal(np.asarray(res.accumulator),
                                  np.asarray(ref_res.accumulator))
    assert int(res.num_votes) == int(ref_res.num_votes)
    v = validation.validate_pose(np.asarray(res.pose), T_true,
                                 desc.diameter, cfg)
    assert v.match, (v.trans_err, v.rot_err)


def test_correlation_chunked_and_lut_paths_bit_equal(rng):
    """The row-chunked contraction (big-model path: dense histogram over
    budget) and the dense-LUT rank path (big-dictionary path) must both
    be bit-equal to the default single-chunk/dict-matmul graph — they are
    memory layouts, not approximations."""
    from objective_slam_tpu.ops import voting_corr

    m_pts, m_nrm = small_cloud(rng, 12)
    s_pts, s_nrm = small_cloud(rng, 40)
    cfg = PPFConfig(engine="correlation")
    desc = drost.build_model_description(m_pts, m_nrm, cfg, d_dist=0.5)
    ref_idx = jnp.arange(0, 40, dtype=jnp.int32)
    keys, alpha_s = ppf_ops.pairwise_ppf_keys(
        s_pts, s_nrm, desc.d_dist, cfg.d_angle, desc.max_dist_bin,
        ref_indices=ref_idx)
    base = voting_corr.cast_votes_corr(keys, alpha_s, desc.corr_tables,
                                       desc.n_points)
    assert not bool(base.overflowed)

    # Force multi-chunk: a budget far below the dense histogram size
    # (R=40 rows -> several chunks).
    K1 = desc.corr_tables.k_occ + 1
    budget = K1 * cfg.n_angle * 4 * 7          # ~7 rows per chunk
    chunked = voting_corr.cast_votes_corr(keys, alpha_s, desc.corr_tables,
                                          desc.n_points,
                                          chunk_budget_bytes=budget)
    assert not bool(chunked.overflowed)
    np.testing.assert_array_equal(np.asarray(chunked.accumulator),
                                  np.asarray(base.accumulator))
    assert int(chunked.num_votes) == int(base.num_votes)

    # Force the dense-LUT rank path (K_pad <= 2048 normally picks the
    # dictionary matmul) by lowering the threshold via monkeypatched
    # tables: re-run with the LUT by slicing the same tables through a
    # tiny wrapper — equality of occ ranks implies equality everywhere,
    # so compare a chunked+LUT run against base.
    import objective_slam_tpu.ops.voting_corr as vc
    import unittest.mock as mock
    with mock.patch.object(vc, "_DICT_MATMUL_MAX_K", 0):
        lut = voting_corr.cast_votes_corr(keys, alpha_s, desc.corr_tables,
                                          desc.n_points,
                                          chunk_budget_bytes=budget)
    np.testing.assert_array_equal(np.asarray(lut.accumulator),
                                  np.asarray(base.accumulator))
    assert int(lut.num_votes) == int(base.num_votes)

    # Force the two-key lexicographic sort branch (flat cell ids past
    # int32 at production scale — here triggered artificially) combined
    # with chunking: still bit-equal.
    with mock.patch.object(vc, "_FLAT_ID_MAX", 1):
        lex = voting_corr.cast_votes_corr(keys, alpha_s, desc.corr_tables,
                                          desc.n_points,
                                          chunk_budget_bytes=budget)
        lex1 = voting_corr.cast_votes_corr(keys, alpha_s, desc.corr_tables,
                                           desc.n_points)
    for r in (lex, lex1):
        np.testing.assert_array_equal(np.asarray(r.accumulator),
                                      np.asarray(base.accumulator))
        assert int(r.num_votes) == int(base.num_votes)


def test_fast_engine_unpacked_fallback(rng):
    """The two-lookup fallback tables (large models / big buckets) must
    produce the same accumulator as the packed single-lookup path."""
    from objective_slam_tpu.ops import voting_fast

    m_pts, m_nrm = small_cloud(rng, 11)
    s_pts, s_nrm = small_cloud(rng, 13)
    cfg = PPFConfig()
    desc = drost.build_model_description(m_pts, m_nrm, cfg, d_dist=0.5)
    unpacked = voting_fast.build_fast_tables(desc.table,
                                             force_unpacked=True)
    assert unpacked.pair_packed is None and unpacked.cnt_off is None

    ref_idx = jnp.arange(0, 13, dtype=jnp.int32)
    keys, alpha_s = ppf_ops.pairwise_ppf_keys(
        s_pts, s_nrm, desc.d_dist, cfg.d_angle, desc.max_dist_bin,
        ref_indices=ref_idx)
    cap = 1 << 18
    a = voting_fast.cast_votes_fast(keys, alpha_s, desc.fast_tables,
                                    desc.n_points, cfg.d_angle, cap)
    b = voting_fast.cast_votes_fast(keys, alpha_s, unpacked,
                                    desc.n_points, cfg.d_angle, cap)
    assert int(a.num_votes) == int(b.num_votes)
    np.testing.assert_array_equal(np.asarray(a.accumulator),
                                  np.asarray(b.accumulator))


def test_build_corr_tables_m3_matches_host_histogram(rng):
    """build_corr_tables scatters the multi-GB m3 histogram ON DEVICE
    (shipping only P-sized index arrays across the host<->device link);
    the result must equal the straightforward host-side numpy histogram
    bin for bin, including the α_m fixed-point binning and the all-zero
    unoccupied row."""
    import math as _math

    from objective_slam_tpu.ops import voting_corr

    n_m, num_keys, n_angle = 37, 512, 30
    keys = rng.integers(0, num_keys, size=(n_m, n_m)).astype(np.int32)
    keys[rng.random((n_m, n_m)) < 0.15] = np.int32(ppf_ops.INVALID_KEY)
    alpha = rng.uniform(-np.pi, np.pi, size=(n_m, n_m)).astype(np.float32)
    table = voting.build_key_table(jnp.asarray(keys), jnp.asarray(alpha),
                                   num_keys)
    tabs = voting_corr.build_corr_tables(table, n_m, n_angle)

    # Host golden: histogram over valid pairs only.
    counts = np.asarray(table.counts)
    pair_mr = np.asarray(table.pair_mr)
    pair_alpha = np.asarray(table.pair_alpha)
    occ = np.nonzero(counts)[0]
    k_occ = len(occ)
    rank = np.repeat(np.arange(k_occ), counts[occ])
    n_pairs = rank.shape[0]
    a_fix = np.clip(np.round((pair_alpha.astype(np.float64) + _math.pi)
                             * voting_corr._ALPHA_SCALE), 0,
                    (1 << voting_corr.ALPHA_BITS) - 1).astype(np.int64)
    b_m = ((a_fix * n_angle) >> voting_corr.ALPHA_BITS).astype(np.int64)
    m3 = np.zeros((k_occ + 1, n_angle, n_m), np.float32)
    np.add.at(m3, (rank, b_m[:n_pairs], pair_mr[:n_pairs]), 1.0)

    assert tabs.k_occ == k_occ
    np.testing.assert_array_equal(
        np.asarray(tabs.m3_dup), np.concatenate([m3, m3], axis=1))
    np.testing.assert_array_equal(np.asarray(tabs.occ_keys)[:k_occ], occ)


def test_dict_digits_matmul_generic_exact(rng):
    """voting_fast.dict_digits_matmul (the single-pass bf16 digit-split
    contraction both the block and correlation engines ride on) is
    bit-exact against a plain numpy dictionary lookup at the correlation
    engine's operating point: K_pad = 2048 rank payloads (2 digits) and a
    1-digit small table, with misses and INVALID_KEY inputs."""
    from objective_slam_tpu.ops import voting_fast as vf

    for k_pad, n_dig in ((2048, 2), (96, 1)):
        keys = rng.choice(1 << 20, size=k_pad, replace=False).astype(np.int32)
        # ranks offset by +1 so "miss" (all-zero row) is distinguishable.
        payload = np.arange(1, k_pad + 1, dtype=np.float32)[:, None]
        hits = rng.choice(keys, size=700).astype(np.int32)
        misses = rng.choice(1 << 20, size=300).astype(np.int32)
        invalid = np.full((24,), np.iinfo(np.int32).max, np.int32)
        flat = np.concatenate([hits, misses, invalid])

        out = np.asarray(vf.dict_digits_matmul(
            jnp.asarray(flat), jnp.asarray(keys), jnp.asarray(payload),
            n_digits=n_dig))[:, 0]

        lut = {int(k): float(v) for k, v in zip(keys, payload[:, 0])}
        want = np.float32([lut.get(int(k), 0.0) for k in flat])
        np.testing.assert_array_equal(out, want)


def test_saturating_total_many_rows_no_wrap():
    """saturating_total at reference-row counts past 32768 (a 100k-point
    scene at ref_point_df=1): the lo-limb int32 sum used to wrap and
    return garbage instead of either the exact total or the sentinel."""
    # 100k rows of 20k votes → exact total 2.0e9 < 2^31: must be EXACT.
    rows = jnp.full((100_000,), 20_000, jnp.int32)
    assert int(voting.saturating_total(rows)) == 2_000_000_000
    # 150k rows of 20k → 3.0e9 ≥ 2^31: must saturate to INT32_MAX.
    rows = jnp.full((150_000,), 20_000, jnp.int32)
    assert int(voting.saturating_total(rows)) == 2 ** 31 - 1
    # Small-case exactness unchanged.
    rows = jnp.asarray([0, 1, 65535, 65536, 123456], jnp.int32)
    assert int(voting.saturating_total(rows)) == 254528


def test_top_votes_max_poses_exceeds_accumulator():
    """max_poses larger than the whole accumulator (absurdly tiny clouds:
    scene·model·32 < max_poses) must clamp the top-k and pad with
    keep=False slots instead of crashing in lax.top_k — the public
    ost.match edge the verify playbook used to list as known-broken."""
    acc = jnp.zeros((4, 3, 32), jnp.int32).at[1, 2, 5].set(9)
    top = voting.top_votes(acc, 0.4, max_poses=1024)
    assert top.counts.shape == (1024,)
    assert int(top.counts[0]) == 9
    assert bool(top.keep[0])
    # Pad slots: zero counts, rejected.
    assert int(jnp.sum(top.keep)) == 1
    assert not bool(top.saturated)
