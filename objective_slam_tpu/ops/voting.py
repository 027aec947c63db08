"""Hough voting: model key table construction + dense vote accumulation.

The reference implements voting as a Thrust pipeline: per-scene-pair binary
search into sorted model hash keys, two-phase count/scan/scatter into a u64
vote array, then sort + histogram + threshold (model.cu:95-171,
kernel.cu:480-554). Here everything is static-shape and dense:

  * the model "hash table" is a **direct-addressed table** over packed
    integer keys (counts + offsets + key-sorted pair arrays) — no binary
    search, one gather per lookup (replaces ParallelHashArray,
    include/impl/parallel_hash_array.hpp:17-47);
  * votes are generated by a **flat expansion**: exclusive-scan of per-pair
    match counts, a scatter/cummax decode from vote slot to scene pair, and
    pure-gather reconstruction of each vote's (ref point, model point,
    α bin) — work is proportional to the true vote count (padded to a static
    capacity), unlike bucket-capacity padding;
  * the α of each vote is wrap(α_s − α_m) with both angles precomputed per
    *pair* (see ops.transforms.alpha_angle) — replacing the reference's two
    dense 4×4 chains per vote (kernel.cu:302-349);
  * tallies land in a **dense accumulator** over (scene ref, model point,
    α bin) — the MATLAB voting_scheme.m:20 dense formulation, the
    static-shape answer (vote codes, sort and histogram disappear).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from objective_slam_tpu.ops import ppf as ppf_ops

# α-bin axis padded to 32 lanes (bins 0..30 possible; kernel.cu:341-342
# packs α in 6 bits for the same reason).
ALPHA_PAD = 32


class KeyTable(NamedTuple):
    """Direct-addressed model description table.

    counts[k]  — number of model pairs with packed key k       (K,) int32
    offsets[k] — first index of key k's pairs in the sorted     (K,) int32
                 pair arrays (exclusive scan of counts)
    pair_mr    — reference-point index of each pair, key-sorted (P,) int32
    pair_alpha — α_m of each pair, key-sorted                   (P,) float32
    max_count  — largest bucket size (traced scalar)
    """
    counts: jax.Array
    offsets: jax.Array
    pair_mr: jax.Array
    pair_alpha: jax.Array
    max_count: jax.Array


def build_key_table(keys, alpha, num_keys: int) -> KeyTable:
    """Build the model description from all-pairs packed keys.

    Equivalent of Model's ParallelHashArray construction (model.cu:69-81,
    parallel_hash_array.hpp:56-77): sort pair indices by key, histogram,
    exclusive-scan — but over a dense key space so lookups are direct.

    Args:
      keys:  (r, n) int32 packed keys (INVALID_KEY for self/degenerate).
      alpha: (r, n) float32 α_m per pair.
      num_keys: static size K of the key space.
    """
    r, n = keys.shape
    flat_keys = keys.reshape(-1)
    flat_alpha = alpha.reshape(-1)
    # Map INVALID_KEY to K so invalid pairs sort to the end and are excluded
    # from the table (the reference maps NaN features to hash 0 and skips
    # key 0 at lookup, kernel.cu:467-470, 491).
    capped = jnp.where(flat_keys == ppf_ops.INVALID_KEY, num_keys,
                       flat_keys).astype(jnp.int32)
    order = jnp.argsort(capped, stable=True)
    sorted_keys = capped[order]
    pair_mr = (order // n).astype(jnp.int32)
    pair_alpha = flat_alpha[order]
    counts = jnp.bincount(capped, length=num_keys + 1)[:num_keys].astype(
        jnp.int32)
    offsets = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(counts, dtype=jnp.int32)[:-1]])
    return KeyTable(counts=counts, offsets=offsets, pair_mr=pair_mr,
                    pair_alpha=pair_alpha,
                    max_count=jnp.max(counts),
                    )


def saturating_total(row_totals):
    """Grand total of per-row int32 vote counts, summed as two int32 limbs:
    exact whenever the true total < 2³¹ − 2¹⁹, SATURATING to INT32_MAX
    (instead of silently wrapping) beyond — a wrapped total reads as a
    plausible count, the sentinel cannot.

    The saturation test is an f32 sum of the rows THEMSELVES (not of the
    limbs): when it passes, the true total < 2³¹, so the lo-limb int32 sum
    (≤ the true total) cannot have wrapped and the limb total is exact.
    The 2¹⁹ margin dwarfs the f32 tree-reduction error for any row count
    this library can produce. (The previous form summed the limbs first
    and derived the test FROM them — at ≥ 32768 rows the lo sum itself
    wrapped before the test ever saw it.)"""
    row_totals = row_totals.astype(jnp.int32)
    lo = jnp.sum(row_totals & 0xFFFF, dtype=jnp.int32)
    hi = jnp.sum(row_totals >> 16, dtype=jnp.int32)
    tot_f = jnp.sum(row_totals.astype(jnp.float32))
    sat = tot_f >= jnp.float32(2 ** 31 - 2 ** 19)
    return jnp.where(sat, jnp.int32(2 ** 31 - 1), (hi << 16) + lo)


class VoteResult(NamedTuple):
    """Dense Hough accumulator + diagnostics.

    accumulator — (n_ref, n_model, ALPHA_PAD) int32 vote tallies
    num_votes   — true number of votes cast (scalar int32)
    overflowed  — True if num_votes exceeded the static capacity and votes
                  were dropped (scalar bool)
    """
    accumulator: jax.Array
    num_votes: jax.Array
    overflowed: jax.Array


def cast_votes(scene_keys, scene_alpha, table: KeyTable, n_model: int,
               d_angle: float, vote_cap: int) -> VoteResult:
    """Generate and tally all votes (the reference's ppf_vote_count_kernel +
    scan + ppf_vote_kernel + sort + histogram, model.cu:95-151, collapsed
    into one static-shape dense pass).

    Args:
      scene_keys:  (R, n) int32 packed keys of scene pairs.
      scene_alpha: (R, n) float32 α_s per scene pair.
      table: model KeyTable.
      n_model: number of model points (static).
      d_angle: α quantization step.
      vote_cap: static capacity for the expanded vote list. If the true vote
        count exceeds it, excess votes are dropped and `overflowed` is set.
    """
    R, n = scene_keys.shape
    S = R * n
    flat_keys = scene_keys.reshape(-1)
    flat_alpha = scene_alpha.reshape(-1)

    valid = flat_keys != ppf_ops.INVALID_KEY
    safe_keys = jnp.where(valid, flat_keys, 0)
    cnt = jnp.where(valid, table.counts[safe_keys], 0)          # (S,)
    voffs = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(cnt, dtype=jnp.int32)[:-1]])                 # exclusive
    total = voffs[-1] + cnt[-1]
    overflow = total > vote_cap

    # Decode vote slot -> owning scene pair: scatter each pair's index at its
    # first vote slot, then a running max (lax.cummax — the generic
    # associative_scan compiled very slowly at multi-million sizes).
    # Cheaper than per-vote binary search: 2 memory touches per vote
    # instead of ~log2(S) gathers.
    head = jnp.zeros((vote_cap,), jnp.int32)
    scatter_idx = jnp.where(cnt > 0, voffs, vote_cap)           # drop empties
    head = head.at[scatter_idx].max(jnp.arange(S, dtype=jnp.int32),
                                    mode="drop")
    sp = jax.lax.cummax(head, axis=0)                           # (CAP,)

    v = jnp.arange(vote_cap, dtype=jnp.int32)
    in_range = v < total
    j = v - voffs[sp]                                           # rank in bucket
    key_sp = safe_keys[sp]
    slot = table.offsets[key_sp] + j
    slot = jnp.clip(slot, 0, table.pair_mr.shape[0] - 1)
    m_r = table.pair_mr[slot]                                   # (CAP,)
    a_m = table.pair_alpha[slot]
    a_s = flat_alpha[sp]

    # α = wrap(α_s − α_m) quantized exactly as kernel.cu:341-342.
    two_pi = jnp.float32(2.0 * jnp.pi)
    alpha = a_s - a_m
    alpha = alpha - two_pi * jnp.floor((alpha + jnp.pi) / two_pi)
    shifted = alpha + jnp.float32(jnp.pi)
    quant = shifted - jnp.fmod(shifted, jnp.float32(d_angle))
    a_bin = jnp.round(quant / jnp.float32(d_angle)).astype(jnp.int32)
    a_bin = jnp.clip(a_bin, 0, ALPHA_PAD - 1)

    r_idx = sp // n
    target = (r_idx * n_model + m_r) * ALPHA_PAD + a_bin
    target = jnp.where(in_range, target, R * n_model * ALPHA_PAD)

    acc = jnp.zeros((R * n_model * ALPHA_PAD,), jnp.int32)
    acc = acc.at[target].add(1, mode="drop")
    return VoteResult(accumulator=acc.reshape(R, n_model, ALPHA_PAD),
                      num_votes=total, overflowed=overflow)


class TopVotes(NamedTuple):
    """Surviving votes after count thresholding (model.cu:148-170).

    counts   — (k,) int32 raw vote counts, descending
    ref_idx  — (k,) int32 scene reference row (into the ref axis)
    model_idx— (k,) int32 model point index
    alpha_idx— (k,) int32 α bin
    keep     — (k,) bool: count > vote_count_threshold · max (and count > 0)
    saturated— () bool: True if above-threshold cells may have been dropped
               (more survivors than max_poses, or — hierarchical path —
               survivors spanning more blocks than were gathered)
    """
    counts: jax.Array
    ref_idx: jax.Array
    model_idx: jax.Array
    alpha_idx: jax.Array
    keep: jax.Array
    saturated: jax.Array


def top_votes(accumulator, vote_count_threshold: float,
              max_poses: int) -> TopVotes:
    """Select the top-`max_poses` accumulator cells and mark those above the
    reference's relative threshold (model.cu:164-170: keep counts strictly
    greater than vote_count_threshold · max_count).

    Exact whenever the true number of surviving votes ≤ max_poses; the
    reference keeps a data-dependent count, impossible under static shapes
    (SURVEY.md §7 'Hard parts').

    For large accumulators a flat lax.top_k over every cell is slow, so
    selection is hierarchical: block maxima -> top blocks ->
    exact top_k inside the gathered blocks. `n_blocks = max(max_poses, 64)`
    blocks are gathered, which makes the selection EXACT whenever the true
    survivor count ≤ max_poses: every block holding a survivor has
    bmax > threshold, and any block outranking it in the top-k also holds a
    survivor, so ≤ max_poses survivor blocks all land in the gather. The
    `saturated` flag reports the remaining truncation case at runtime."""
    R, n_model, A = accumulator.shape
    flat = accumulator.reshape(-1)
    n = flat.shape[0]
    block = 256
    blocks_above = None
    n_blocks = None
    if n <= 64 * max_poses or n <= 2 * block:
        # Tiny accumulators (scene·model·32 < max_poses) clamp k and pad
        # back to the static max_poses shape: pad slots carry count 0, so
        # `keep` rejects them downstream.
        k = min(max_poses, n)
        counts, idx = jax.lax.top_k(flat, k)
        if k < max_poses:
            counts = jnp.pad(counts, (0, max_poses - k))
            idx = jnp.pad(idx, (0, max_poses - k))
    else:
        n_pad = ((n + block - 1) // block) * block
        padded = jnp.pad(flat, (0, n_pad - n),
                         constant_values=jnp.iinfo(jnp.int32).min)
        blocks = padded.reshape(-1, block)
        bmax = jnp.max(blocks, axis=1)
        n_blocks = min(max(max_poses, 64), bmax.shape[0])
        _, bidx = jax.lax.top_k(bmax, n_blocks)
        cand = blocks[bidx].reshape(-1)                     # (n_blocks*block,)
        counts, cidx = jax.lax.top_k(cand, max_poses)
        idx = bidx[cidx // block] * block + cidx % block
        idx = jnp.minimum(idx, n - 1)
        blocks_above = bmax
        n_blocks_static = n_blocks
    max_count = counts[0]
    thresh = jnp.float32(vote_count_threshold) * max_count.astype(jnp.float32)
    keep = (counts.astype(jnp.float32) > thresh) & (counts > 0)
    # Runtime exactness flag (one cheap reduction over the accumulator):
    # more above-threshold cells than max_poses, or — hierarchical path —
    # above-threshold blocks exceeding the gathered block budget, means
    # true survivors may have been silently dropped.
    above = (flat.astype(jnp.float32) > thresh) & (flat > 0)
    saturated = jnp.sum(above, dtype=jnp.int32) > max_poses
    if blocks_above is not None:
        b_above = (blocks_above.astype(jnp.float32) > thresh) & \
            (blocks_above > 0)
        saturated |= jnp.sum(b_above, dtype=jnp.int32) > n_blocks_static
    a_idx = idx % A
    m_idx = (idx // A) % n_model
    r_idx = idx // (A * n_model)
    return TopVotes(counts=counts, ref_idx=r_idx.astype(jnp.int32),
                    model_idx=m_idx.astype(jnp.int32),
                    alpha_idx=a_idx.astype(jnp.int32), keep=keep,
                    saturated=saturated)
