"""Correlation voting engine — matmul-only Hough voting (approximate α).

The exact engines pay at least one indexed lookup per vote. This engine
removes per-vote work entirely by factoring the accumulator through the
key space:

  acc[r, m, a] = Σ_k Σ_b  S3[r, k, b] · M3[k, (b − a + n/2) mod n, m]

where S3 histograms scene pairs per (reference row, occupied model key,
coarse α_s bin) — ONE scatter-add over scene pairs — and M3 histograms the
model description per (key, coarse α_m bin, model point) at build time.
The contraction is a batch of n_angle dense matmuls whose cost
scales with R·K_occ·n_angle·n_m, INDEPENDENT of the vote count — the right
asymptotics for vote-heavy scenes.

Approximation: the vote's α bin is computed from coarse-binned α_s and α_m
(bin(α_s)−bin(α_m) instead of bin(α_s−α_m)), which moves votes whose α
fraction straddles a bin edge by at most ±1 α bin (≈ uniformly-distributed
half the votes move to a neighbouring bin). Hough peaks blur slightly
across adjacent α bins; pose recovery is unaffected in practice because
clustering already merges poses within 2·Δα (ROT_THRESH, kernel.h:17).
NOT a parity engine — exact tallies come from engine="fast"/"reference".

Matmuls run in f32 at precision HIGHEST: bin counts exceed bf16's 8-bit
mantissa, and TF32 — the GPU's default for an f32 product — keeps 10 bits,
so a histogram cell above 2^11 would round. f32 is exact below 2^24.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import jax
import jax.numpy as jnp
import numpy as np

from objective_slam_tpu.ops import ppf as ppf_ops
from objective_slam_tpu.ops import voting as voting_ref
from objective_slam_tpu.ops import voting_fast as vf

ALPHA_BITS = vf.ALPHA_BITS
_ALPHA_SCALE = vf._ALPHA_SCALE

# Dictionary width past which the key->rank one-hot matmul (work scales
# with S·K_pad) gives way to a dense-LUT gather (work scales with S).
_DICT_MATMUL_MAX_K = 2048

# Largest flat (row·K1·n_angle + col) cell id representable in int32; past
# this the run compaction sorts (row, col) lexicographically instead.
# Module-level so tests can force the two-key branch at toy scale.
_FLAT_ID_MAX = 2**31


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["occ_keys", "m3_dup", "dense_rank"],
                   meta_fields=["k_occ", "n_angle"])
@dataclasses.dataclass(frozen=True)
class CorrTables:
    """Correlation-engine model tables.

    occ_keys — (K_pad,) int32 sorted occupied packed keys, pad −2. The
               key → occupied-rank map is evaluated as a one-hot
               contraction against this dictionary
               (voting_fast.dict_lookup).
    m3_dup   — (k_occ+1, 2·n_angle, n_m) f32: per-key α_m histogram over
               model points, duplicated along the α axis so every shift is
               a contiguous slice.
    dense_rank — (key_space,) int32 key → occupied rank (k_occ where
               unoccupied). The one-hot contraction writes S·K_pad one-hot
               bytes, so its cost scales with the DICTIONARY size: past
               ~2k occupied keys (big real-scan models) a plain gather
               through this dense table is used instead of the matmul
               (the key space is bounded: packed bins, or occupied-hash
               ranks in FNV mode — never the raw 2^32 hash space).
    """
    occ_keys: jax.Array
    m3_dup: jax.Array
    dense_rank: jax.Array
    k_occ: int
    n_angle: int


@functools.partial(jax.jit,
                   static_argnames=("k1", "n_angle", "n_model"))
def _scatter_m3_device(rank_idx, col_idx, *, k1, n_angle, n_model):
    """(k1, 2·n_angle, n_model) m3_dup from per-pair (rank, α·m) indices.

    A 2-D scatter keeps every index int32-safe even when
    k1·n_angle·n_model passes 2^31 (big real-scan models); invalid rows
    carry rank_idx == k1 and drop."""
    m3 = jnp.zeros((k1, n_angle * n_model), jnp.float32) \
        .at[rank_idx, col_idx].add(1.0, mode="drop") \
        .reshape(k1, n_angle, n_model)
    return jnp.concatenate([m3, m3], axis=1)


def build_corr_tables(table: voting_ref.KeyTable, n_model: int,
                      n_angle: int = 30) -> CorrTables:
    """Build from the key table (pairs sorted by key).

    The P-sized index math runs on host (the arrays are a few MB), but the
    m3 histogram itself is scattered ON DEVICE: it is (k_occ+1, 2n, n_m)
    f32 — multi-GB for real-scan models (skull: 2.6 GB) — and a host build
    would ship the whole thing host→device on every call."""
    counts = np.asarray(table.counts)
    pair_mr = np.asarray(table.pair_mr)
    pair_alpha = np.asarray(table.pair_alpha)

    occ_keys = np.nonzero(counts)[0]
    k_occ = len(occ_keys)
    k_pad = max(((k_occ + 127) // 128) * 128, 128)
    occ_dict = np.full((k_pad,), -2, np.int32)
    occ_dict[:k_occ] = occ_keys.astype(np.int32)
    dense_rank = np.full((len(counts),), k_occ, np.int32)
    dense_rank[occ_keys] = np.arange(k_occ, dtype=np.int32)

    # Coarse α_m bins via the same fixed-point quantization as the fast
    # engine (consistency of bin edges between the two sides) — f64 on
    # host so the bin edges stay bit-identical across backends.
    a_fix = np.clip(np.round((pair_alpha.astype(np.float64) + math.pi)
                             * _ALPHA_SCALE), 0,
                    (1 << ALPHA_BITS) - 1).astype(np.int64)
    b_m = ((a_fix * n_angle) >> ALPHA_BITS).astype(np.int64)

    # Which occupied key does each (key-sorted) pair belong to?
    pair_key_rank = np.repeat(np.arange(k_occ, dtype=np.int64),
                              counts[occ_keys])
    n_pairs = pair_key_rank.shape[0]
    P = pair_mr.shape[0]
    rank_idx = np.full((P,), k_occ + 1, np.int32)     # pad rows drop
    rank_idx[:n_pairs] = pair_key_rank
    col_idx = np.zeros((P,), np.int32)
    col_idx[:n_pairs] = (b_m[:n_pairs] * n_model
                         + pair_mr[:n_pairs].astype(np.int64))
    m3_dup = _scatter_m3_device(
        jnp.asarray(rank_idx), jnp.asarray(col_idx),
        k1=k_occ + 1, n_angle=n_angle, n_model=n_model)

    return CorrTables(
        occ_keys=jnp.asarray(occ_dict),
        m3_dup=m3_dup,
        dense_rank=jnp.asarray(dense_rank),
        k_occ=k_occ, n_angle=n_angle)


def key_ranks(flat_keys, tables: CorrTables):
    """(S,) int32 occupied-key rank of each scene key; k_occ for keys the
    model does not hold (and INVALID_KEY)."""
    K_pad = tables.occ_keys.shape[0]
    if K_pad <= _DICT_MATMUL_MAX_K:
        # One-hot dictionary matmul (pad entries are -2, so INVALID_KEY
        # matches nothing). The rank payload is offset by +1 so "no match"
        # (all-zero row) is distinguishable from rank 0.
        ranks1 = jnp.arange(1, K_pad + 1, dtype=jnp.float32)[:, None]
        n_dig = max(1, math.ceil(math.log(K_pad + 1) / math.log(128)))
        occ = vf.dict_lookup(flat_keys, tables.occ_keys, ranks1,
                             n_digits=n_dig)[:, 0].astype(jnp.int32) - 1
        return jnp.where(occ >= 0, occ, tables.k_occ)
    # Big dictionary: the one-hot would be S·K_pad elements (1.3 T for a
    # skull-sized model) — one dense-LUT gather per pair instead.
    key_space = tables.dense_rank.shape[0]
    safe = jnp.clip(flat_keys, 0, key_space - 1)
    return jnp.where(flat_keys != ppf_ops.INVALID_KEY,
                     tables.dense_rank[safe], jnp.int32(tables.k_occ))


def cast_votes_corr(scene_keys, scene_alpha, tables: CorrTables,
                    n_model: int, runs_cap: int | None = None,
                    chunk_budget_bytes: int | None = None
                    ) -> voting_ref.VoteResult:
    """Matmul voting: scene histogram + n_angle dense contractions.

    The scene histogram S3 is built by SORT + RUN-LENGTH COALESCING, not a
    direct per-pair scatter-add: after sorting the (row, key, α-bin) cell
    ids, equal cells form runs; only the ~runs_cap unique cells are
    scattered.

    runs_cap bounds the unique-cell count (static shape). None → S // 6,
    comfortably above any scene measured; if the actual run count exceeds
    it, `overflowed` is set (tallies would be incomplete — raise the cap).

    Large models (real-scan descriptions: 700+ points, 15k occupied keys)
    don't fit the dense (R, K1·n_angle) histogram in memory — with the
    minor-dim tile padding a skull-sized model wants 35 GB. When the dense
    histogram exceeds chunk_budget_bytes (None → 2 GiB), the contraction
    runs CHUNKED over reference rows via lax.scan: the cell-sorted run
    array means each row-chunk's runs are one contiguous slice (found by
    searchsorted), scattered into a (Rc, K1·n_angle) block that never
    leaves the budget. Bench-scale scenes keep the single-chunk graph
    bit-for-bit.

    Returns a VoteResult whose accumulator matches the exact engines up to
    ±1-α-bin transport (num_votes is exact)."""
    R, n = scene_keys.shape
    n_angle = tables.n_angle
    K1 = tables.k_occ + 1
    flat_keys = scene_keys.reshape(-1)
    flat_alpha = scene_alpha.reshape(-1)
    valid = flat_keys != ppf_ops.INVALID_KEY

    S = R * n
    occ = key_ranks(flat_keys, tables)

    a_fix = jnp.clip(jnp.round((flat_alpha + jnp.float32(math.pi))
                               * jnp.float32(_ALPHA_SCALE))
                     .astype(jnp.int32), 0, (1 << ALPHA_BITS) - 1)
    b_s = (a_fix * n_angle) >> ALPHA_BITS

    if runs_cap is None:
        # Small scenes: cap = S (exact by construction, compaction is
        # cheap there). Large scenes: S // 6 — votes concentrate on far
        # fewer unique cells in practice; `overflowed` guards the bound
        # and drost.match auto-retries at the next capacity bucket, so
        # the heuristic can never silently truncate tallies.
        runs_cap = max(S // 6, 65536)
    runs_cap = min(vf._ceil_to(runs_cap, vf.LANES), S)

    r_of_s = jnp.arange(S, dtype=jnp.int32) // n
    cells_per_row = K1 * n_angle
    n_cells_l = R * cells_per_row                     # python int (exact)
    if n_cells_l < _FLAT_ID_MAX:
        # Flat cell ids fit int32: one-key sort (the bench-scale graph).
        tgt = (r_of_s * K1 + occ) * n_angle + b_s
        tgt = jnp.where(valid, tgt, jnp.int32(n_cells_l))  # invalid last
        sv = jnp.sort(tgt)                            # (S,) sentinel at end
        new = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                               sv[1:] != sv[:-1]])
    else:
        # Big scenes × big models overflow the packed id — sort (row, col)
        # LEXICOGRAPHICALLY instead (two int32 keys; the flat 33-bit id
        # never exists). col < K1·n_angle and row ≤ R stay int32-safe.
        col0 = occ * n_angle + b_s
        rr = jnp.where(valid, r_of_s, jnp.int32(R))   # invalid rows last
        cc = jnp.where(valid, col0, 0)
        srow, scol = jax.lax.sort((rr, cc), num_keys=2)
        new = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                               (srow[1:] != srow[:-1])
                               | (scol[1:] != scol[:-1])])
    n_runs = jnp.sum(new, dtype=jnp.int32)
    # Compact run-start positions in order: sort where(new, iota, INT_MAX)
    # — iota is strictly increasing, so a single-array sort is the stable
    # compaction at half the payload of argsort(key, iota).
    starts = jnp.sort(jnp.where(
        new, jnp.arange(S, dtype=jnp.int32),
        jnp.int32(np.iinfo(np.int32).max)))[:runs_cap]
    run_ok = jnp.arange(runs_cap, dtype=jnp.int32) < n_runs
    # Rows past the real run count hold arbitrary non-start positions —
    # pin them to S so the next-start difference of the LAST real run (and
    # of every dead row) is well-defined.
    starts = jnp.where(run_ok, starts, S)
    si = jnp.minimum(starts, S - 1)
    # Per-run (row, col) pair — the id form every downstream consumer
    # uses (the flat id only exists in the int32-safe branch).
    if n_cells_l < _FLAT_ID_MAX:
        vals_u = sv[si]                               # (runs_cap,) cell ids
        cell_ok0 = vals_u < n_cells_l
        row_u = vals_u // cells_per_row
        col_u = vals_u % cells_per_row
    else:
        row_u = srow[si]
        col_u = scol[si]
        cell_ok0 = row_u < R
    next_start = jnp.concatenate([starts[1:], jnp.full((1,), S, jnp.int32)])
    cnts = jnp.where(run_ok, next_start - starts, 0)
    cell_ok = run_ok & cell_ok0                       # drop sentinel run
    runs_overflow = n_runs > runs_cap
    # Unoccupied keys (rank k_occ) hit the all-zero m3 row; drop them from
    # the vote count only (they contribute nothing to the contraction).
    m_tot = jnp.sum(tables.m3_dup[:, :n_angle, :], axis=(1, 2)) \
        .astype(jnp.int32)                                        # (K1,)
    half = n_angle // 2
    if chunk_budget_bytes is None:
        chunk_budget_bytes = 2 << 30
    Rc = max(8, min(R, chunk_budget_bytes // (cells_per_row * 4)))
    if n_cells_l >= _FLAT_ID_MAX:
        # Keep every per-chunk flat index int32-safe regardless of budget
        # (and stay off the single-chunk path, which assumes flat ids).
        Rc = max(1, min(Rc, (_FLAT_ID_MAX - 1) // cells_per_row))

    if Rc >= R and n_cells_l < _FLAT_ID_MAX:
        # Single chunk: the dense histogram fits — one scatter, n_angle
        # matmuls (the bench-scale graph). Only reachable from the
        # int32-id branch (budget caps n_cells at 2^29 floats).
        s3 = jnp.zeros((n_cells_l,), jnp.float32) \
            .at[jnp.where(cell_ok, vals_u, n_cells_l)] \
            .add(jnp.where(cell_ok, cnts, 0).astype(jnp.float32),
                 mode="drop") \
            .reshape(R, K1, n_angle)
        s3_flat = s3.reshape(R, K1 * n_angle)

        # num_votes (exact, integer — f32 cannot represent counts > 2^24):
        # Σ_k scene-hits[k] · bucket-size[k]. Per-cell products and
        # per-row sums are int32-exact (a single reference row with ≥ 2^31
        # votes is not a realistic cloud); the GRAND total is summed as
        # two int32 limbs and SATURATES to INT32_MAX instead of silently
        # wrapping when a vote-heavy scene passes 2^31 (this engine sizes
        # no capacity from it — the saturated sentinel is unmistakable
        # where a wrapped value would read as a plausible count).
        s_tot = jnp.sum(s3, axis=2).astype(jnp.int32)             # (R, K1)
        row_votes = jnp.sum(s_tot * m_tot[None, :], axis=1,
                            dtype=jnp.int32)                      # (R,)
        num_votes = voting_ref.saturating_total(row_votes)

        # acc[r, m, a] = S3_flat @ m3_dup[:, o_a : o_a+n, :]  with
        # o_a = (n/2 - a) mod n (coarse-bin identity: a ≈ b_s − b_m + n/2).
        cols = []
        for a in range(n_angle):
            o_a = (half - a) % n_angle
            rhs = jax.lax.dynamic_slice_in_dim(tables.m3_dup, o_a, n_angle,
                                               axis=1)
            rhs = rhs.reshape(K1 * n_angle, n_model)
            cols.append(jnp.dot(s3_flat, rhs,
                                preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST))
        acc = jnp.stack(cols, axis=-1)                            # (R,n_m,n)
    else:
        # Chunked over reference rows. Runs are cell-sorted, so each row
        # chunk's runs form one contiguous slice; per-chunk budget B keeps
        # the gather static (4x uniform-share skew headroom — exceeding it
        # sets `overflowed`, and the caller's capacity retry raises
        # runs_cap and with it B).
        chunks = -(-R // Rc)
        B = min(runs_cap,
                vf._ceil_to(max(65536, 4 * runs_cap // chunks), vf.LANES))
        # All rebasing is row-relative (flat cell ids may exceed int32).
        # Dead/sentinel runs get row chunks·Rc — past the END boundary, so
        # they land in no chunk's searchsorted slice (row R would fall
        # inside the last chunk and inflate its run count).
        rw = jnp.where(cell_ok, row_u, jnp.int32(chunks * Rc))
        cw = jnp.where(cell_ok, col_u, 0)
        cnt_ok = jnp.where(cell_ok, cnts, 0)
        lo_rows = jnp.arange(chunks + 1, dtype=jnp.int32) * Rc
        bounds = jnp.searchsorted(rw, lo_rows, side="left") \
            .astype(jnp.int32)                                # (chunks+1,)
        chunk_runs = bounds[1:] - bounds[:-1]
        runs_overflow = runs_overflow | jnp.any(chunk_runs > B)

        # num_votes from a (R·K1) scatter (the dense s3 never exists).
        rk = jnp.where(cell_ok, row_u * K1 + cw // n_angle, R * K1)
        s_tot = jnp.zeros((R * K1,), jnp.int32) \
            .at[rk].add(cnt_ok, mode="drop").reshape(R, K1)
        row_votes = jnp.sum(s_tot * m_tot[None, :], axis=1,
                            dtype=jnp.int32)
        num_votes = voting_ref.saturating_total(row_votes)

        m3d = tables.m3_dup
        chunk_cells = Rc * cells_per_row

        # Layout discipline (the whole reason this path exists): a tiled
        # layout can pad a MINOR dim of n_angle = 30 up to 128 (4.27x
        # memory), and a reshape that merges tiled dims
        # ((K1,30,m) -> (K1*30,m)) can MATERIALIZE a copy per α slice —
        # 30 x 697 MB live at once for a skull-sized model. So the chunk
        # histogram lives as (K1, 30, Rc) (row-minor), the model table is sliced but never reshaped, and
        # the contraction is a dot_general over the (key, α_m) dim PAIR.
        # The inner lax.map serializes the 30 slices: one alive at a time.
        def body(_, c):
            lo_row = c * Rc
            start = bounds[c]
            pos = jnp.arange(B, dtype=jnp.int32)
            idx = jnp.clip(start + pos, 0, runs_cap - 1)
            rr = rw[idx]
            ok = (pos < (bounds[c + 1] - start)) & (rr >= lo_row) \
                & (rr < lo_row + Rc)
            reb = cw[idx] * Rc + (rr - lo_row)
            s3c = jnp.zeros((chunk_cells,), jnp.float32) \
                .at[jnp.where(ok, reb, chunk_cells)] \
                .add(jnp.where(ok, cnt_ok[idx], 0).astype(jnp.float32),
                     mode="drop") \
                .reshape(K1, n_angle, Rc)

            def col(a):
                o_a = (half - a) % n_angle
                rhs = jax.lax.dynamic_slice_in_dim(m3d, o_a, n_angle,
                                                   axis=1)
                return jax.lax.dot_general(
                    s3c, rhs, (((0, 1), (0, 1)), ((), ())),
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)  # (Rc, n_m)

            cols = jax.lax.map(col, jnp.arange(n_angle, dtype=jnp.int32))
            return None, cols                             # (n, Rc, n_m)

        _, acc_chunks = jax.lax.scan(
            body, None, jnp.arange(chunks, dtype=jnp.int32))
        acc = jnp.transpose(acc_chunks, (0, 2, 3, 1)) \
            .reshape(chunks * Rc, n_model, n_angle)[:R]

    A = voting_ref.ALPHA_PAD
    acc = jnp.round(acc).astype(jnp.int32)
    acc = jnp.pad(acc, ((0, 0), (0, 0), (0, A - n_angle)))
    return voting_ref.VoteResult(accumulator=acc, num_votes=num_votes,
                                 overflowed=runs_overflow)
