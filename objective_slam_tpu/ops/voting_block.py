"""Block-expansion exact voting: row-granular expansion + scatter tally.

The legacy fast engine (ops/voting_fast.py) reads the pair table once per
VOTE. This engine moves every indexed step of the expansion from vote to
ROW granularity by exploiting two structural facts:

  1. votes of one scene pair read CONSECUTIVE pair-table slots (the bucket),
     so padding every bucket to whole 128-slot ROWS turns the per-vote
     gather into a per-row gather of 512-byte rows;
  2. the model occupies few distinct keys (K_occ), so the "hash lookup" of
     each scene pair becomes an equality compare against the occupied-key
     dictionary, contracted as one exact matmul
     (voting_fast.dict_lookup) that returns (count, bucket row start).

Pipeline (all static shapes):
  scene keys ──(S, K_occ) one-hot ⋅ (K_occ, 2) dictionary──> cnt, row_start
  per-segment row allocation (cumsum) + TWO per-ROW fills (cumsum-of-diffs
    at row granularity, 1-D scatters with tail corrections folded into the
    next head — pad rows/slots are handled by pair-table sentinels, not
    masks)
  pair rows ──ONE row gather──> (ROW_CAP, 128) packed (m << 22 | α_m_fix)
  tally: integer α-binning (the fixed-point formula voting_fast uses —
    tallies are bit-equal) and one int32 scatter-add per slot into the
    (R, n_m, 32) accumulator; a chunk→row map gives each vote row its
    reference row.

Replaces the role of ppf_vote_count_kernel + ppf_vote_kernel + vote
sort/histogram (reference src/cuda/kernel.cu:480-554, model.cu:95-151).

Built only for models that fit the packing budgets (n_m < 1024 model
points, K_occ <= BLOCK_MAX_KOCC occupied keys); larger models fall back to
the legacy fast paths automatically (see voting_fast.build_fast_tables).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from objective_slam_tpu.ops import ppf as ppf_ops
from objective_slam_tpu.ops import voting as voting_ref
from objective_slam_tpu.ops import voting_fast as vf

LANES = 128
CHUNK_ROWS = 64                 # vote rows per reference-row alignment
                                # unit: each reference row's rows are
                                # padded to a multiple, so capacity sizing
                                # adds CHUNK_ROWS rows per reference row
ALPHA_BITS = 22                 # fixed-point α (shared with voting_fast)
M_BITS = 32 - ALPHA_BITS        # model point index field (n_m <= 1024)
_ALPHA_SCALE = (1 << ALPHA_BITS) / (2.0 * math.pi)
# Dictionary-compare cost is S x K_pad; beyond this the legacy fast engine
# takes over (sparse buckets also make row padding expensive).
BLOCK_MAX_KOCC = 4096


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["occ_keys", "occ_vals", "pair2d"],
    meta_fields=["k_occ", "n_rows"])
@dataclasses.dataclass(frozen=True)
class BlockTables:
    """Bucket-padded model tables for block-expansion voting.

    occ_keys — (K_pad,) int32 occupied packed keys, pad = -2 (INVALID_KEY is
               INT_MAX and valid packed keys are in [0, num_keys); neither
               equals -2, so padded/invalid scene pairs match nothing by
               construction).
    occ_vals — (K_pad, 2) f32 [bucket vote count, bucket start ROW] — the
               dictionary payload of the one-hot contraction.
    pair2d   — (n_rows + 1, 128) uint32 (m << ALPHA_BITS | α_m fixed
               point). Each bucket is padded to whole rows with the
               SENTINEL slot 0xFFFFFFFF, whose m field decodes to
               (1 << M_BITS) − 1 — a model index the build gate reserves
               (n_m < 2^M_BITS strictly), so sentinel slots tally into a
               column the accumulator slice discards. Row n_rows is an
               all-sentinel row that padding vote rows point at. This
               removes the per-row valid-lane masking from the hot tally
               entirely.
    """
    occ_keys: jax.Array
    occ_vals: jax.Array
    pair2d: jax.Array
    k_occ: int
    n_rows: int


def build_block_tables(table: voting_ref.KeyTable,
                       max_kocc: int = BLOCK_MAX_KOCC
                       ) -> Optional[BlockTables]:
    """Host-side build from the key table; None if the model doesn't fit
    the packing budgets (caller falls back to the legacy fast tables)."""
    counts = np.asarray(table.counts)
    offsets = np.asarray(table.offsets)
    pair_mr = np.asarray(table.pair_mr)
    pair_alpha = np.asarray(table.pair_alpha)

    occ = np.nonzero(counts)[0]
    k_occ = len(occ)
    n_m = int(pair_mr.max(initial=0)) + 1
    # Strict bound reserves m = 2^M_BITS − 1 as the pad-slot sentinel.
    if k_occ == 0 or k_occ > max_kocc or n_m >= (1 << M_BITS):
        return None

    occ_cnt = counts[occ].astype(np.int64)
    occ_rows = (occ_cnt + LANES - 1) // LANES
    row_start = np.concatenate([[0], np.cumsum(occ_rows)[:-1]])
    n_rows = int(occ_rows.sum())

    a_fix = np.clip(np.round((pair_alpha.astype(np.float64) + math.pi)
                             * _ALPHA_SCALE), 0,
                    (1 << ALPHA_BITS) - 1).astype(np.uint32)
    packed = (pair_mr.astype(np.uint32) << ALPHA_BITS) | a_fix

    # Pad slots AND the trailing all-pad row are the sentinel 0xFFFFFFFF:
    # they tally into the reserved m column and are sliced away.
    pair2d = np.full((n_rows + 1, LANES), 0xFFFFFFFF, np.uint32)
    flat = pair2d.reshape(-1)
    for i, k in enumerate(occ):
        s = row_start[i] * LANES
        flat[s:s + occ_cnt[i]] = packed[offsets[k]:offsets[k] + occ_cnt[i]]

    K_pad = _ceil_to(max(k_occ, 1), LANES)
    occ_keys = np.full((K_pad,), -2, np.int32)
    occ_keys[:k_occ] = occ.astype(np.int32)
    occ_vals = np.zeros((K_pad, 2), np.float32)
    occ_vals[:k_occ, 0] = occ_cnt
    occ_vals[:k_occ, 1] = row_start

    return BlockTables(occ_keys=jnp.asarray(occ_keys),
                       occ_vals=jnp.asarray(occ_vals),
                       pair2d=jnp.asarray(pair2d),
                       k_occ=k_occ, n_rows=n_rows)


def _dict_match(flat_keys, tables: BlockTables):
    """(cnt, row_start) per scene pair via the one-hot dictionary matmul.

    Exact: each key matches at most one dictionary entry (occupied keys are
    distinct), payload integers are < 2^24, and misses (padding −2 never
    equals a scene key, INVALID_KEY matches nothing) return 0 counts."""
    out = vf.dict_lookup(flat_keys, tables.occ_keys, tables.occ_vals,
                         n_digits=4)
    return out[:, 0].astype(jnp.int32), out[:, 1].astype(jnp.int32)


def rows_for_counts(cnt):
    """Vote rows a segment of cnt votes occupies (ceil(cnt / 128))."""
    return (cnt + LANES - 1) // LANES


def cast_votes_block(scene_keys, scene_alpha, tables: BlockTables,
                     n_model: int, d_angle: float, vote_cap: int,
                     chunk_rows: int = CHUNK_ROWS,
                     seg_cap: int | None = None) -> voting_ref.VoteResult:
    """Generate and tally votes (block-expansion exact engine).

    Tallies are bit-identical to voting_fast.cast_votes_fast (same vote set,
    same 22-bit fixed-point α binning).

    Args:
      scene_keys: (R, n) int32 packed PPF keys (INVALID_KEY masked).
      scene_alpha: (R, n) float32 α_s per scene pair.
      vote_cap: static capacity in SLOTS; internally rows = vote_cap // 128.
        Must cover sum(ceil(cnt/128))*128 per scene pair plus up to one
        chunk (chunk_rows*128 slots) of row-alignment padding per reference
        row (see drost.match sizing).
      seg_cap: static bound on the number of NONZERO scene-pair segments
        (pairs with at least one matching model pair). Every indexed step
        of the expansion runs at this scale, so a tight bound (drost sizes
        it exactly from the count pass) is a large win; None falls back to
        row_cap (always sufficient: each nonzero segment occupies ≥ 1 vote
        row). Exceeding it sets `overflowed`.
    """
    R, n = scene_keys.shape
    (pp, alpha_row, row_start_p, total, overflow, row_cap,
     total_rows_p) = \
        _expand(scene_keys, scene_alpha, tables, vote_cap, chunk_rows,
                seg_cap)
    acc = _tally(pp, alpha_row,
                 r_of_chunk_start=row_start_p, R=R, n_model=n_model,
                 d_angle=d_angle, chunk_rows=chunk_rows, row_cap=row_cap)
    return voting_ref.VoteResult(accumulator=acc, num_votes=total,
                                 overflowed=overflow)


def _expand(scene_keys, scene_alpha, tables: BlockTables, vote_cap: int,
            chunk_rows: int, seg_cap: int | None = None):
    """Dictionary match + row allocation + per-row fills + THE row gather.

    Returns (pp, alpha_row, row_start_p, total, overflow, row_cap,
    total_rows_p) — everything the tally needs."""
    row_cap = max(vote_cap // LANES, chunk_rows)
    row_cap = _ceil_to(row_cap, chunk_rows)
    R, n = scene_keys.shape
    S = R * n
    if seg_cap is None:
        seg_cap = row_cap
    seg_cap = min(_ceil_to(max(seg_cap, LANES), LANES), S)
    flat_keys = scene_keys.reshape(-1)
    flat_alpha = scene_alpha.reshape(-1)

    cnt, brs = _dict_match(flat_keys, tables)               # (S,), (S,)
    crows = rows_for_counts(cnt)                            # (S,) rows/segment

    # Row-aligned padding so every tally chunk maps to one reference row.
    row_tot = jnp.sum(crows.reshape(R, n), axis=1)          # (R,) in rows
    pad_row = (-row_tot) % chunk_rows
    row_tot_p = row_tot + pad_row
    row_start_p = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(row_tot_p, dtype=jnp.int32)[:-1]])
    row_cum = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(row_tot, dtype=jnp.int32)[:-1]])

    roffs = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(crows, dtype=jnp.int32)[:-1]])           # (S,) excl scan
    # Padded head of each segment: per-REFERENCE-row pad offset broadcast
    # over the row's n scene pairs (no S-sized gather — repeat is dense).
    pad_before = jnp.broadcast_to(
        (row_start_p - row_cum)[:, None], (R, n)).reshape(-1)
    heads = roffs + pad_before
    total_rows_p = row_start_p[-1] + row_tot_p[-1]
    overflow = total_rows_p > row_cap

    # True vote total: per-row int32 sums (exact), saturating grand total
    # (cap sizing in drost handles the int64-safe total on host).
    total = voting_ref.saturating_total(
        jnp.sum(cnt.reshape(R, n), axis=1, dtype=jnp.int32))

    alpha_fix = jnp.round((flat_alpha + jnp.float32(math.pi))
                          * jnp.float32(_ALPHA_SCALE)).astype(jnp.int32)
    alpha_fix = jnp.clip(alpha_fix, 0, (1 << ALPHA_BITS) - 1)

    # Stream-compact the nonzero segments (typically a few % of S): an
    # S-sized sort followed by seg_cap-sized row gathers, so every later
    # indexed step runs at seg_cap scale. Sorting where(nz, iota, INT_MAX)
    # is a SINGLE-array sort whose sorted prefix IS the compacted index
    # list (iota is strictly increasing, so stability is free) — half the
    # payload of the argsort(key, iota) form.
    nz = crows > 0
    n_seg = jnp.sum(nz, dtype=jnp.int32)
    seg_overflow = n_seg > seg_cap
    starts = jnp.sort(jnp.where(
        nz, jnp.arange(S, dtype=jnp.int32),
        jnp.int32(np.iinfo(np.int32).max)))[:seg_cap]
    seg_ok = jnp.arange(seg_cap, dtype=jnp.int32) < n_seg
    gidx = jnp.where(seg_ok, starts, 0)
    payload = jnp.stack([cnt, brs, alpha_fix, heads], axis=1)     # (S, 4)
    compact = jnp.where(seg_ok[:, None], payload[gidx], 0)  # (seg_cap, 4)
    c_cnt = compact[:, 0]
    c_brs = compact[:, 1]
    c_alpha = compact[:, 2]
    c_heads = compact[:, 3]
    c_tail = c_heads + rows_for_counts(c_cnt)
    c_row = gidx // n                       # owning reference row

    # Two per-row transports (pair-table source row via u, α_s), each as
    # cumsum-of-diffs. Within one reference row consecutive segments are
    # back-to-back (heads = exclusive scan), so the tail correction of
    # segment j−1 FOLDS into the head diff of segment j. What remains is
    # ONE 1-D head scatter per channel plus an R-sized correction at each
    # reference row's padding boundary.
    #
    # u = brs − head + OFFSET with OFFSET > row_cap keeps u ≥ 1 inside
    # segments while the fill is exactly 0 on padding rows — the fill
    # itself marks validity, replacing the lanes_valid channel (pad rows
    # point at the all-sentinel pair2d row n_rows).
    offset = jnp.int32(row_cap + 1)
    u = c_brs - c_heads + offset
    prev_tail = jnp.concatenate([jnp.full((1,), -1, jnp.int32), c_tail[:-1]])
    prev_row = jnp.concatenate([jnp.full((1,), -1, jnp.int32), c_row[:-1]])
    prev_u = jnp.concatenate([jnp.zeros((1,), jnp.int32), u[:-1]])
    prev_a = jnp.concatenate([jnp.zeros((1,), jnp.int32), c_alpha[:-1]])
    contig = (prev_tail == c_heads) & (prev_row == c_row)
    head_idx = jnp.where(seg_ok, c_heads, row_cap)
    du = jnp.where(contig, u - prev_u, u)
    da = jnp.where(contig, c_alpha - prev_a, c_alpha)

    # Per-reference-row boundary corrections: the fill returns to 0 at the
    # start of the row's padding (R-sized — negligible scatter cost).
    segs_per_row = jnp.sum(nz.reshape(R, n), axis=1, dtype=jnp.int32)
    last_seg = jnp.clip(jnp.cumsum(segs_per_row, dtype=jnp.int32) - 1,
                        0, seg_cap - 1)
    has_seg = segs_per_row > 0
    u_last = jnp.where(has_seg, u[last_seg], 0)
    a_last = jnp.where(has_seg, c_alpha[last_seg], 0)
    row_end = jnp.where(has_seg, row_start_p + row_tot, row_cap)

    d_u = jnp.zeros((row_cap,), jnp.int32) \
        .at[head_idx].add(jnp.where(seg_ok, du, 0), mode="drop") \
        .at[row_end].add(-u_last, mode="drop")
    d_a = jnp.zeros((row_cap,), jnp.int32) \
        .at[head_idx].add(jnp.where(seg_ok, da, 0), mode="drop") \
        .at[row_end].add(-a_last, mode="drop")
    fill_u = jnp.cumsum(d_u, dtype=jnp.int32)
    alpha_row = jnp.cumsum(d_a, dtype=jnp.int32)

    t_iota = jnp.arange(row_cap, dtype=jnp.int32)
    # src_row[t] = brs[s] + (t − head[s]) inside segments; the all-sentinel
    # row n_rows on padding rows (fill 0). The clip only matters on
    # overflow (flagged) — in-range segments stay within their bucket.
    src_row = jnp.where(fill_u > 0,
                        jnp.clip(fill_u - offset + t_iota, 0,
                                 tables.n_rows),
                        tables.n_rows)

    overflow = overflow | seg_overflow

    # THE gather: one whole 128-slot row per vote row.
    pp = jnp.take(tables.pair2d, src_row, axis=0)           # (row_cap, 128)

    return (pp, alpha_row, row_start_p, total, overflow,
            row_cap, total_rows_p)


def _chunk_row_map(r_of_chunk_start, R, chunk_rows, n_chunks):
    """chunk → owning reference row (row starts are chunk-aligned by
    construction: scatter each row id at its first chunk + cummax).

    NO clipping of the scatter index: an empty TRAILING reference row
    whose start equals a full buffer's end (row_start_p == row_cap, i.e.
    start chunk == n_chunks) must DROP out of the map — clipping it to
    n_chunks − 1 used to claim the last data chunk for the empty row,
    silently mis-crediting that chunk's tallies whenever vote_cap was
    sized exactly full."""
    start_chunk = r_of_chunk_start // chunk_rows         # in [0, n_chunks]
    cmap = jnp.zeros((n_chunks,), jnp.int32).at[start_chunk].max(
        jnp.arange(R, dtype=jnp.int32), mode="drop")
    return jax.lax.cummax(cmap, axis=0), start_chunk


def _unpack_bin(pp_i32, a_s, n_angle):
    """In-register unpack + integer α binning (bit-equal to voting_fast:
    bin = ((α_s − α_m + 2²¹) mod 2²²) · n_angle >> 22)."""
    m = jax.lax.shift_right_logical(pp_i32, ALPHA_BITS)
    a_m = pp_i32 & jnp.int32((1 << ALPHA_BITS) - 1)
    half = jnp.int32(1 << (ALPHA_BITS - 1))
    mask = jnp.int32((1 << ALPHA_BITS) - 1)
    w = (a_s - a_m + half) & mask
    a_bin = jnp.clip((w * n_angle) >> ALPHA_BITS, 0, voting_ref.ALPHA_PAD - 1)
    return m, a_bin


def _tally(pp, alpha_row, r_of_chunk_start, R, n_model, d_angle,
           chunk_rows, row_cap):
    """Unpack + α-bin every gathered slot and scatter-add one count per
    slot into the (R, n_model, ALPHA_PAD) accumulator.

    A vote row's reference row comes from the chunk→row map (row starts are
    chunk-aligned by _expand). Sentinel slots decode to m = 2^M_BITS − 1,
    which the build gate keeps ≥ n_model, so they — and every padding or
    capacity-slack row, which points at the all-sentinel pair2d row — go to
    the dropped index n_cells. Integer adds are exact in any order."""
    A = voting_ref.ALPHA_PAD
    n_chunks = row_cap // chunk_rows
    n_angle = int(round(2.0 * math.pi / d_angle))
    pp_i32 = pp.view(jnp.int32) if pp.dtype == jnp.uint32 else pp

    cmap, _ = _chunk_row_map(r_of_chunk_start, R, chunk_rows, n_chunks)
    r_of_row = jnp.broadcast_to(cmap[:, None],
                                (n_chunks, chunk_rows)).reshape(-1, 1)
    m, a_bin = _unpack_bin(pp_i32, alpha_row[:, None], n_angle)
    n_cells = R * n_model * A
    target = jnp.where(m < n_model, (r_of_row * n_model + m) * A + a_bin,
                       n_cells)
    acc = jnp.zeros((n_cells,), jnp.int32).at[target.reshape(-1)].add(
        1, mode="drop")
    return acc.reshape(R, n_model, A)
