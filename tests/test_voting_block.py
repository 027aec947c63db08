"""Block-expansion exact engine (ops/voting_block.py): bit-equality with the
legacy fast engine and the readable reference engine, capacity semantics,
and end-to-end dispatch through drost.match."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from objective_slam_tpu.config import PPFConfig
from objective_slam_tpu.models import drost
from objective_slam_tpu.ops import (ppf as ppf_ops, voting, voting_block,
                                    voting_fast)
from objective_slam_tpu.utils import synthetic

D_ANGLE = 2 * math.pi / 30


def small_cloud(rng, n):
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm.astype(np.float32)


def _keys_and_tables(rng, n_m=24, n_s=40, d_dist=0.5, ref_point_df=1):
    m_pts, m_nrm = small_cloud(rng, n_m)
    s_pts, s_nrm = small_cloud(rng, n_s)
    max_bin = 32
    num_keys = ppf_ops.num_keys(max_bin)
    mk, ma = ppf_ops.pairwise_ppf_keys(m_pts, m_nrm, d_dist, D_ANGLE, max_bin)
    table = voting.build_key_table(mk, ma, num_keys)
    ref_idx = jnp.arange(0, n_s, ref_point_df, dtype=jnp.int32)
    sk, sa = ppf_ops.pairwise_ppf_keys(s_pts, s_nrm, d_dist, D_ANGLE,
                                       max_bin, ref_indices=ref_idx)
    return table, sk, sa, n_m


def test_block_tables_cover_all_pairs(rng):
    table, *_ = _keys_and_tables(rng)
    bt = voting_block.build_block_tables(table)
    assert bt is not None
    counts = np.asarray(table.counts)
    occ = np.nonzero(counts)[0]
    assert bt.k_occ == len(occ)
    # Every bucket's slots appear in pair2d at its dictionary row start.
    occ_keys = np.asarray(bt.occ_keys)
    occ_vals = np.asarray(bt.occ_vals)
    pair2d = np.asarray(bt.pair2d).reshape(-1)
    offsets = np.asarray(table.offsets)
    pair_mr = np.asarray(table.pair_mr)
    for i, k in enumerate(occ):
        assert occ_keys[i] == k
        c = int(occ_vals[i, 0])
        assert c == counts[k]
        s = int(occ_vals[i, 1]) * 128
        got_m = pair2d[s:s + c] >> voting_block.ALPHA_BITS
        np.testing.assert_array_equal(got_m,
                                      pair_mr[offsets[k]:offsets[k] + c])


def test_block_matches_fast_exactly(rng):
    """The block engine must reproduce the legacy fast engine's tallies
    bit-for-bit (same vote set, same fixed-point α binning)."""
    table, sk, sa, n_m = _keys_and_tables(rng)
    ft = voting_fast.build_fast_tables(table)
    assert ft.block is not None
    cap_fast = 1 << 18
    out_fast = voting_fast.cast_votes_fast(sk, sa, ft, n_m, D_ANGLE,
                                           cap_fast)
    out_block = voting_block.cast_votes_block(sk, sa, ft.block, n_m,
                                              D_ANGLE, cap_fast)
    assert not bool(out_fast.overflowed)
    assert not bool(out_block.overflowed)
    assert int(out_fast.num_votes) == int(out_block.num_votes)
    np.testing.assert_array_equal(np.asarray(out_fast.accumulator),
                                  np.asarray(out_block.accumulator))


def test_block_matches_fast_with_ref_df(rng):
    table, sk, sa, n_m = _keys_and_tables(rng, n_s=33, ref_point_df=4)
    ft = voting_fast.build_fast_tables(table)
    out_fast = voting_fast.cast_votes_fast(sk, sa, ft, n_m, D_ANGLE, 1 << 18)
    out_block = voting_block.cast_votes_block(sk, sa, ft.block, n_m,
                                              D_ANGLE, 1 << 18)
    np.testing.assert_array_equal(np.asarray(out_fast.accumulator),
                                  np.asarray(out_block.accumulator))


def test_block_overflow_flag(rng):
    table, sk, sa, n_m = _keys_and_tables(rng)
    bt = voting_block.build_block_tables(table)
    tiny = voting_block.cast_votes_block(sk, sa, bt, n_m, D_ANGLE,
                                         vote_cap=128)
    assert bool(tiny.overflowed)


def test_build_declines_oversize_models(rng):
    table, *_ = _keys_and_tables(rng)
    assert voting_block.build_block_tables(table, max_kocc=1) is None
    ft = voting_fast.build_fast_tables(table, force_unpacked=True)
    assert ft.block is None          # legacy fallback stays testable


def test_match_e2e_block_vs_legacy(rng):
    """drost.match dispatches to the block engine and recovers the same
    planted pose as the legacy fast path (identical accumulators)."""
    m_pts, m_nrm = synthetic.blob_cloud(rng, 220)
    c_pts, c_nrm = synthetic.blob_cloud(rng, 420)
    c_pts = c_pts * 1.8 + np.float32([2.5, 0.0, 0.0])
    scene, scene_n, T_true = synthetic.plant_model(rng, m_pts, m_nrm,
                                                   c_pts, c_nrm)
    cfg = PPFConfig(max_poses=256, ref_point_df=3)
    desc = drost.build_model_description(m_pts, m_nrm, cfg)
    assert desc.fast_tables.block is not None
    res = drost.match(desc, scene, scene_n, cfg)
    assert not bool(res.overflowed)

    # Legacy path: strip the block tables, same config.
    desc_legacy = drost.ModelDescription(
        points=desc.points, normals=desc.normals, beta=desc.beta,
        gamma=desc.gamma, vote_weights=desc.vote_weights, table=desc.table,
        d_dist=desc.d_dist,
        fast_tables=desc.fast_tables._replace(block=None),
        corr_tables=None, fnv_remap=None, n_points=desc.n_points,
        num_keys=desc.num_keys,
        max_dist_bin=desc.max_dist_bin, diameter=desc.diameter)
    res_legacy = drost.match(desc_legacy, scene, scene_n, cfg)
    np.testing.assert_array_equal(np.asarray(res.accumulator),
                                  np.asarray(res_legacy.accumulator))
    np.testing.assert_allclose(np.asarray(res.pose),
                               np.asarray(res_legacy.pose), atol=1e-5)


def test_dict_match_digits_exact(rng):
    """The dictionary contraction (_dict_match, digit-split over
    voting_fast.dict_lookup) returns exactly the (count, row_start) a NumPy
    dictionary lookup gives, for payload integers up to the engine's 2^24
    exactness bound — including values far past bf16's 8-bit and TF32's
    10-bit mantissas, misses, and INVALID_KEY pairs — and across several
    DICT_CHUNK chunks plus a ragged tail."""
    k_occ = 300
    K_pad = voting_block._ceil_to(k_occ, voting_block.LANES)
    keys = rng.choice(1 << 20, size=k_occ, replace=False).astype(np.int32)
    occ_keys = np.full((K_pad,), -2, np.int32)
    occ_keys[:k_occ] = keys
    occ_vals = np.zeros((K_pad, 2), np.float32)
    # Counts/row starts spanning 1..2^24-1 (the engine's exactness bound).
    occ_vals[:k_occ, 0] = rng.integers(1, (1 << 24) - 1, size=k_occ)
    occ_vals[:k_occ, 1] = rng.integers(0, (1 << 24) - 1, size=k_occ)
    bt = voting_block.BlockTables(
        occ_keys=jnp.asarray(occ_keys), occ_vals=jnp.asarray(occ_vals),
        pair2d=jnp.zeros((1, 128), jnp.uint32), k_occ=k_occ, n_rows=0)

    n = 2 * voting_fast.DICT_CHUNK + 777
    hits = rng.choice(keys, size=n - 400).astype(np.int32)
    misses = rng.choice(1 << 20, size=300).astype(np.int32)
    invalid = np.full((100,), np.iinfo(np.int32).max, np.int32)
    flat = np.concatenate([hits, misses, invalid])
    rng.shuffle(flat)

    cnt, brs = voting_block._dict_match(jnp.asarray(flat), bt)
    lut = {int(k): (int(c), int(r)) for k, (c, r)
           in zip(keys, occ_vals[:k_occ].astype(np.int64))}
    want = np.array([lut.get(int(k), (0, 0)) for k in flat], np.int64)
    np.testing.assert_array_equal(np.asarray(cnt), want[:, 0])
    np.testing.assert_array_equal(np.asarray(brs), want[:, 1])


def test_chunk_row_map_full_buffer_empty_trailing_row():
    """The exactly-full-buffer corner: an empty trailing reference row's
    start chunk equals n_chunks (one past the end). It must DROP from the
    chunk→row map — the pre-fix clip to n_chunks − 1 credited the last
    data chunk to the empty row, silently corrupting its tallies (tally
    routing; bit-equality invariant)."""
    chunk_rows, n_chunks = 4, 4
    # Row 0 owns all 16 vote rows (chunks 0-3); row 1 is empty and starts
    # at row 16 == row_cap.
    r_of_chunk_start = jnp.asarray([0, 16], jnp.int32)
    cmap, start_chunk = voting_block._chunk_row_map(
        r_of_chunk_start, R=2, chunk_rows=chunk_rows, n_chunks=n_chunks)
    np.testing.assert_array_equal(np.asarray(start_chunk), [0, 4])
    # Every chunk belongs to row 0; none to the empty row 1.
    np.testing.assert_array_equal(np.asarray(cmap), [0, 0, 0, 0])
    # Empty MIDDLE row: rows 0 and 1 share start chunk 0 (row 0 empty),
    # row 1 owns chunks 0-1, row 2 owns 2-3.
    cmap2, _ = voting_block._chunk_row_map(
        jnp.asarray([0, 0, 8], jnp.int32), R=3, chunk_rows=chunk_rows,
        n_chunks=n_chunks)
    np.testing.assert_array_equal(np.asarray(cmap2), [1, 1, 2, 2])


def test_block_exact_full_vote_cap_bit_equal(rng):
    """End-to-end guard for the same corner on the tally: size vote_cap
    EXACTLY to the expansion's total padded rows, with the last reference
    row contributing zero votes, and require bit-equal tallies vs the
    readable engine."""
    n_m, n_s, num_keys = 40, 36, 4096
    mkeys = rng.integers(0, num_keys, size=(n_m, n_m)).astype(np.int32)
    malpha = rng.uniform(-math.pi, math.pi, size=(n_m, n_m)) \
        .astype(np.float32)
    table = voting.build_key_table(jnp.asarray(mkeys), jnp.asarray(malpha),
                                   num_keys)
    tables = voting_block.build_block_tables(table)
    skeys = rng.integers(0, num_keys, size=(n_s, n_s)).astype(np.int32)
    skeys[-1, :] = ppf_ops.INVALID_KEY          # empty trailing ref row
    salpha = rng.uniform(-math.pi, math.pi, size=(n_s, n_s)) \
        .astype(np.float32)
    d_angle = 2.0 * math.pi / 30.0

    # Probe the exact padded row count with a generous cap, then re-run
    # with vote_cap sized exactly full.
    probe = voting_block._expand(jnp.asarray(skeys), jnp.asarray(salpha),
                                 tables, vote_cap=1 << 20,
                                 chunk_rows=voting_block.CHUNK_ROWS)
    total_rows_p = int(probe[6])
    assert total_rows_p % voting_block.CHUNK_ROWS == 0
    vote_cap = total_rows_p * voting_block.LANES

    res = voting_block.cast_votes_block(
        jnp.asarray(skeys), jnp.asarray(salpha), tables, n_m, d_angle,
        vote_cap=vote_cap)
    assert not bool(res.overflowed)
    ref = voting.cast_votes(jnp.asarray(skeys), jnp.asarray(salpha), table,
                            n_m, d_angle, vote_cap=1 << 20)
    assert int(res.num_votes) == int(ref.num_votes)
    np.testing.assert_array_equal(np.asarray(res.accumulator),
                                  np.asarray(ref.accumulator))
    # The empty trailing row's tallies must be all-zero.
    assert int(np.asarray(res.accumulator)[-1].sum()) == 0


def _numpy_tally(pp, alpha_row, owner, R, n_model, n_angle):
    """Plain per-slot reference for voting_block._tally: decode (m, α_m),
    bin α with the shared 22-bit fixed-point formula, count into the owning
    reference row; sentinel / out-of-model slots count nowhere."""
    bits = voting_block.ALPHA_BITS
    mask = (1 << bits) - 1
    pp = pp.astype(np.int64)
    m = pp >> bits
    a_m = pp & mask
    w = (alpha_row.astype(np.int64)[:, None] - a_m + (1 << (bits - 1))) & mask
    a_bin = np.minimum((w * n_angle) >> bits, voting.ALPHA_PAD - 1)
    acc = np.zeros((R, n_model, voting.ALPHA_PAD), np.int64)
    r = np.broadcast_to(np.asarray(owner)[:, None], m.shape)
    ok = m < n_model
    np.add.at(acc, (r[ok], m[ok], a_bin[ok]), 1)
    return acc


@pytest.mark.parametrize("n_model", [40, 1000])
def test_tally_row_map_sentinels_and_slack(rng, n_model):
    """_tally against the plain per-slot reference on the corners the
    expansion produces: an EMPTY middle reference row (shares its start
    chunk with the next row), an empty trailing row, capacity-slack chunks
    of all-sentinel rows, and sentinel slots inside data rows. n_model
    = 1000 pads the model axis to 1024 (8 blocks of 128), where the
    sentinel's m = 1023 is a real accumulator column index — it must still
    be dropped, not counted."""
    chunk_rows, n_chunks, R = 2, 5, 4
    row_cap = chunk_rows * n_chunks
    # Reference rows start (in vote rows): row 0 -> chunks 0-1, row 1
    # empty, row 2 -> chunk 2, row 3 empty; chunks 3-4 are slack.
    row_start = jnp.asarray([0, 4, 4, 6], jnp.int32)
    owner = [0, 0, 0, 0, 2, 2, 3, 3, 3, 3]
    sentinel = np.uint32(0xFFFFFFFF)
    m = rng.integers(0, n_model, size=(row_cap, 128)).astype(np.uint32)
    m[:, :3] = n_model - 1                       # the last model column
    a_m = rng.integers(0, 1 << voting_block.ALPHA_BITS,
                       size=(row_cap, 128)).astype(np.uint32)
    pp = (m << voting_block.ALPHA_BITS) | a_m
    pp[rng.random((row_cap, 128)) < 0.2] = sentinel
    pp[6:] = sentinel                            # slack rows: sentinel only
    alpha_row = rng.integers(0, 1 << voting_block.ALPHA_BITS,
                             size=(row_cap,)).astype(np.int32)

    got = voting_block._tally(jnp.asarray(pp), jnp.asarray(alpha_row),
                              row_start, R=R, n_model=n_model,
                              d_angle=D_ANGLE, chunk_rows=chunk_rows,
                              row_cap=row_cap)
    want = _numpy_tally(pp, alpha_row, owner, R, n_model, n_angle=30)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert want[1].sum() == 0 and want[3].sum() == 0
    assert int(np.asarray(got).sum()) == int((pp[:6] != sentinel).sum())


def test_block_votes_with_capacity_slack(rng):
    """A vote_cap far above the expansion's need (capacity slack: trailing
    chunks of all-sentinel rows) leaves tallies bit-equal to the legacy
    fast engine and to a tightly sized run."""
    table, sk, sa, n_m = _keys_and_tables(rng)
    ft = voting_fast.build_fast_tables(table)
    probe = voting_block._expand(sk, sa, ft.block, vote_cap=1 << 20,
                                 chunk_rows=voting_block.CHUNK_ROWS)
    tight = int(probe[6]) * voting_block.LANES
    out_tight = voting_block.cast_votes_block(sk, sa, ft.block, n_m,
                                              D_ANGLE, tight)
    out_slack = voting_block.cast_votes_block(sk, sa, ft.block, n_m,
                                              D_ANGLE, 8 * tight)
    out_fast = voting_fast.cast_votes_fast(sk, sa, ft, n_m, D_ANGLE,
                                           1 << 18)
    assert not bool(out_tight.overflowed) and not bool(out_slack.overflowed)
    np.testing.assert_array_equal(np.asarray(out_slack.accumulator),
                                  np.asarray(out_tight.accumulator))
    np.testing.assert_array_equal(np.asarray(out_slack.accumulator),
                                  np.asarray(out_fast.accumulator))
