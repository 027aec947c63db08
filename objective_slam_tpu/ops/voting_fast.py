"""Legacy fast voting engine: lookup-minimal expansion + one-hot tally.

The exact engine for models the block engine (ops/voting_block.py) cannot
pack (n_m >= 1024 or K_occ > BLOCK_MAX_KOCC). The voting join is reduced
to ONE indexed lookup per vote, everything else dense:

  1. scene-pair stage: ONE rotation-packed take_along_axis per pair fetches
     the bucket (offset, count), packed into one uint32
     (offset<<CNT_BITS|count);
  2. per-vote segment values are transported by **cumsum-of-diffs fills**
     (scatter +x at segment head, −x past its end, then cumsum) — all
     integer and exact: α_s rides as 22-bit fixed point (quantization
     7.5e-7 rad, below fp32 ulp at π);
  3. the owning row r and segment start are filled with scatter-max +
     lax.cummax (both monotonic over the vote stream);
  4. the per-vote lookup reads the pair table ONCE: (model point index,
     α_m) packed into one uint32 (10 bits m, 22-bit fixed-point α_m); the
     α bin is then pure integer math:
     bin = (((α_s_fix − α_m_fix + 2²¹) mod 2²²) · n_angle) >> 22;
  5. the tally pads each reference row's votes to a chunk multiple so every
     chunk belongs to one row, then accumulates each chunk with a one-hot
     (C×n_m)ᵀ(C×32) bf16 matmul and combines chunks per row with a cumsum
     + row-boundary slice (or, with use_mxu_tally=False, one scatter-add).

vs the readable engine (ops/voting.py, ~7 indexed accesses per vote): same
tallies up to rare ±1 α-bin moves at bin boundaries (golden-tested < 0.5%).

Models with n_points > 1024 or bucket counts ≥ 2^CNT_BITS or pair arrays
≥ 2^OFF_BITS fall back to unpacked two-lookup tables automatically.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from objective_slam_tpu.ops import ppf as ppf_ops
from objective_slam_tpu.ops import voting as voting_ref

LANES = 128
# Tally chunk: votes per one-hot matmul; each reference row's votes
# are padded to a chunk multiple (cap sizing must add TALLY_CHUNK per row).
TALLY_CHUNK = 8192
# Scene keys per dictionary-lookup chunk (dict_lookup).
DICT_CHUNK = 32768
# Rotations materialized per packed table: 128/rot masked tga passes per
# lookup; rot=128 -> ONE pass, memory = 128 x base.
DEFAULT_ROT = 128

# uint32 packing layouts.
CNT_BITS = 12                      # bucket count field (counts < 4096)
OFF_BITS = 32 - CNT_BITS           # pair-array offset field
ALPHA_BITS = 22                    # fixed-point α_m field
M_BITS = 32 - ALPHA_BITS           # model point index field (n_m <= 1024)
_ALPHA_SCALE = (1 << ALPHA_BITS) / (2.0 * math.pi)


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dict_digits_matmul(flat_keys, occ_keys, payloads, n_digits: int):
    """Exact SINGLE-PASS bf16 dictionary matmul via 7-bit digit split.

    The natural one-hot dictionary contraction carries integer payloads
    past bf16's 8-bit mantissa (and past TF32's 10-bit one, the GPU's
    default for an f32 product). Splitting each payload into base-128
    digits makes EVERY operand exactly representable in bf16 — one-hot
    entries are 0/1 and digits are < 128 — and because the dictionary is
    injective (at most one occ_keys entry equals any scene key) each output
    element is a single matched entry's digit with no accumulation to lose
    precision in. One default-precision pass is exact by construction;
    recombination is an (S, n_digits) elementwise dot against the
    128-powers.

    Args:
      flat_keys: (S,) int32 scene keys.
      occ_keys: (K_pad,) int32 dictionary (pad entries must match nothing).
      payloads: (K_pad, P) f32 of NONNEGATIVE integers < 128**n_digits.
      n_digits: base-128 digits covering the payload range.

    Returns (S, P) f32, integer-valued; all-zero rows where no key matches
    (so offset payloads by +1 when 0 is a real value)."""
    K_pad, P = payloads.shape
    digs = [jnp.floor(payloads / jnp.float32(128.0 ** d)) % 128.0
            for d in range(n_digits)]
    dig_tbl = jnp.concatenate(digs, axis=1).astype(jnp.bfloat16)
    onehot = (flat_keys[:, None] == occ_keys[None, :]).astype(jnp.bfloat16)
    out = jnp.dot(onehot, dig_tbl,
                  preferred_element_type=jnp.float32)   # (S, n_digits*P)
    out = out.reshape(flat_keys.shape[0], n_digits, P)
    scale = (jnp.float32(128.0)
             ** jnp.arange(n_digits, dtype=jnp.float32))[None, :, None]
    return jnp.sum(out * scale, axis=1)


def dict_lookup(flat_keys, occ_keys, payloads, n_digits: int):
    """dict_digits_matmul over DICT_CHUNK-key chunks: the (chunk, K_pad)
    one-hot is the only S·K_pad-sized intermediate, so chunking bounds it
    wherever the compiler materializes it. Pad keys are −2, which no
    dictionary entry holds. Returns (S, P) f32 exact integers."""
    S = flat_keys.shape[0]
    chunk = min(DICT_CHUNK, _ceil_to(S, LANES))
    S_pad = _ceil_to(S, chunk)
    keys_p = jnp.concatenate(
        [flat_keys, jnp.full((S_pad - S,), -2, jnp.int32)])
    out = jax.lax.map(
        lambda kc: dict_digits_matmul(kc, occ_keys, payloads, n_digits),
        keys_p.reshape(-1, chunk))
    return out.reshape(S_pad, -1)[:S]


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["packed"], meta_fields=["height", "rot"])
@dataclasses.dataclass(frozen=True)
class PackedTable:
    """Rotation-packed lookup table for arbitrary-lane sublane gathers.

    packed[ρ·H + h, l] = flat[h·128 + (l+ρ) % 128] for ρ in [0, rot).
    With rot=128 a query k in lane l is served by one take_along_axis at
    row ((k−l) mod 128)·H + k//128; smaller rot uses 128/rot masked passes
    with lane-rolled copies. height/rot are static pytree metadata."""
    packed: jax.Array           # (rot*H, LANES)
    height: int                 # H = padded_len / 128
    rot: int                    # rotations materialized (divides 128)


def pack_table(flat, fill=0, rot: int = DEFAULT_ROT) -> PackedTable:
    """Host-side relayout (NumPy): an eager device build would issue dozens
    of tiny compiles."""
    flat = np.asarray(flat)
    n = flat.shape[0]
    H = _ceil_to(n, LANES) // LANES
    padded = np.concatenate([
        flat, np.full((H * LANES - n,), fill, flat.dtype)])
    grid = padded.reshape(H, LANES)
    packed = np.concatenate([np.roll(grid, -rho, axis=1)
                             for rho in range(rot)], axis=0)
    return PackedTable(packed=jnp.asarray(packed), height=H, rot=rot)


def packed_lookup(table: PackedTable, keys):
    """keys: (Q, LANES) int32 -> values (Q, LANES)."""
    lane = jax.lax.broadcasted_iota(jnp.int32, keys.shape, 1)
    hi = keys // LANES
    lo = keys % LANES
    rho = (lo - lane) % LANES
    if table.rot == LANES:
        return jnp.take_along_axis(table.packed, rho * table.height + hi,
                                   axis=0)
    out = jnp.zeros(keys.shape, table.packed.dtype)
    n_pass = LANES // table.rot
    for b in range(n_pass):
        tbl = table.packed if b == 0 else jnp.roll(table.packed,
                                                   -b * table.rot, axis=1)
        local = rho - b * table.rot
        in_block = (local >= 0) & (local < table.rot)
        row = jnp.where(in_block, local * table.height + hi, 0)
        got = jnp.take_along_axis(tbl, row, axis=0)
        out = jnp.where(in_block, got, out)
    return out


class FastModelTables(NamedTuple):
    """Model-side tables. Packed single-lookup variants when the model fits
    the bit budgets, else unpacked two-lookup fallbacks (fields are None
    when unused — structural, so jit sees static branches)."""
    cnt_off: Optional[PackedTable]     # uint32 (offset<<CNT_BITS | count)
    pair_packed: Optional[PackedTable]  # uint32 (m << ALPHA_BITS | α_fix)
    counts: Optional[PackedTable]      # fallback: int32 over key space
    offsets: Optional[PackedTable]     # fallback: int32 over key space
    pair_mr: Optional[PackedTable]     # fallback: int32 over pair slots
    pair_alpha: Optional[PackedTable]  # fallback: float32 over pair slots
    # Block-expansion tables (ops/voting_block.py): the preferred exact
    # engine — zero per-element indexed ops. None when the model exceeds
    # its packing budgets; drost dispatches on presence.
    block: Optional[object] = None


def build_fast_tables(table: voting_ref.KeyTable,
                      max_bytes_per_table: int = 512 * 1024 * 1024,
                      force_unpacked: bool = False) -> FastModelTables:
    """force_unpacked exercises the two-lookup fallback paths (used by
    models with n_points > 1024, bucket counts >= 2^CNT_BITS, or pair
    arrays >= 2^OFF_BITS) without needing a huge model; it also skips the
    block-expansion tables so the legacy per-vote path stays testable."""
    from objective_slam_tpu.ops import voting_block
    def rot_for(n_elems, itemsize):
        rot = DEFAULT_ROT
        while rot > 1 and _ceil_to(n_elems, LANES) * itemsize * rot > \
                max_bytes_per_table:
            rot //= 2
        return rot

    counts = np.asarray(table.counts)
    offsets = np.asarray(table.offsets)
    pair_mr = np.asarray(table.pair_mr)
    pair_alpha = np.asarray(table.pair_alpha)
    k = counts.shape[0]
    p = pair_mr.shape[0]
    rot_k = rot_for(k, 4)
    rot_p = rot_for(p, 4)

    can_pack_ko = (not force_unpacked and
                   counts.max(initial=0) < (1 << CNT_BITS) and
                   p < (1 << OFF_BITS))
    n_m = int(pair_mr.max(initial=0)) + 1
    can_pack_pair = (not force_unpacked) and n_m <= (1 << M_BITS)

    if can_pack_ko:
        cnt_off = ((offsets.astype(np.uint32) << CNT_BITS)
                   | counts.astype(np.uint32))
        t_cnt_off = pack_table(cnt_off, rot=rot_k)
        t_counts = t_offsets = None
    else:
        t_cnt_off = None
        t_counts = pack_table(counts, rot=rot_k)
        t_offsets = pack_table(offsets, rot=rot_k)

    if can_pack_pair:
        a_fix = np.clip(np.round(
            (pair_alpha.astype(np.float64) + math.pi) * _ALPHA_SCALE),
            0, (1 << ALPHA_BITS) - 1).astype(np.uint32)
        pair_packed = (pair_mr.astype(np.uint32) << ALPHA_BITS) | a_fix
        t_pair_packed = pack_table(pair_packed, rot=rot_p)
        t_pair_mr = t_pair_alpha = None
    else:
        t_pair_packed = None
        t_pair_mr = pack_table(pair_mr, rot=rot_p)
        t_pair_alpha = pack_table(pair_alpha, fill=0.0, rot=rot_p)

    block = (None if force_unpacked
             else voting_block.build_block_tables(table))
    return FastModelTables(
        cnt_off=t_cnt_off, pair_packed=t_pair_packed,
        counts=t_counts, offsets=t_offsets,
        pair_mr=t_pair_mr, pair_alpha=t_pair_alpha, block=block)


def _as_q(x, cap):
    return x.reshape(cap // LANES, LANES)


def cast_votes_fast(scene_keys, scene_alpha, tables: FastModelTables,
                    n_model: int, d_angle: float, vote_cap: int,
                    chunk: int = TALLY_CHUNK, use_mxu_tally: bool = True
                    ) -> voting_ref.VoteResult:
    """Generate and tally votes (fast engine).

    Args:
      scene_keys: (R, n) int32 packed PPF keys (INVALID_KEY masked).
      scene_alpha: (R, n) float32 α_s per scene pair.
      tables: rotation-packed model tables.
      n_model / d_angle: model size, α quantization step.
      vote_cap: static capacity (internally rounded up to lane/chunk
        alignment). Row padding consumes up to TALLY_CHUNK per reference
        row — size accordingly (see drost.match).
    """
    vote_cap = _ceil_to(vote_cap, max(LANES, chunk))
    R, n = scene_keys.shape
    S = R * n
    flat_keys = scene_keys.reshape(-1)
    flat_alpha = scene_alpha.reshape(-1)
    valid = flat_keys != ppf_ops.INVALID_KEY
    safe_keys = jnp.where(valid, flat_keys, 0)

    S_pad = _ceil_to(S, LANES)
    keys_q = _as_q(jnp.concatenate(
        [safe_keys, jnp.zeros((S_pad - S,), jnp.int32)]), S_pad)
    if tables.cnt_off is not None:
        co = packed_lookup(tables.cnt_off, keys_q).reshape(-1)[:S]
        cnt_q = (co & jnp.uint32((1 << CNT_BITS) - 1)).astype(jnp.int32)
        off_q = jax.lax.shift_right_logical(
            co, jnp.uint32(CNT_BITS)).astype(jnp.int32)
    else:
        cnt_q = packed_lookup(tables.counts, keys_q).reshape(-1)[:S]
        off_q = packed_lookup(tables.offsets, keys_q).reshape(-1)[:S]
    cnt = jnp.where(valid, cnt_q, 0)

    # Row-aligned padding so every tally chunk maps to one reference row.
    row_tot = jnp.sum(cnt.reshape(R, n), axis=1)                # (R,)
    pad_row = (-row_tot) % chunk
    row_tot_p = row_tot + pad_row
    row_start_p = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(row_tot_p, dtype=jnp.int32)[:-1]])
    row_cum = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(row_tot, dtype=jnp.int32)[:-1]])

    voffs = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(cnt, dtype=jnp.int32)[:-1]])                 # (S,)
    r_of_s = (jnp.arange(S, dtype=jnp.int32) // n)
    pad_before = row_start_p[r_of_s] - row_cum[r_of_s]
    heads = voffs + pad_before                                  # padded head
    total_p = row_start_p[-1] + row_tot_p[-1]
    total = row_cum[-1] + row_tot[-1]
    overflow = total_p > vote_cap

    nz = cnt > 0
    head_idx = jnp.where(nz, heads, vote_cap)                   # drop empties
    tail_idx = jnp.where(nz, heads + cnt, vote_cap)

    # Monotonic fill: segment start (owning row is implied by the
    # row-aligned chunks; only the scatter-fallback tally needs it).
    start = jax.lax.cummax(
        jnp.zeros((vote_cap,), jnp.int32)
        .at[head_idx].max(head_idx, mode="drop"),
        axis=0)

    # Integer segment fills are exact; int32 wraparound is harmless because
    # the ± diffs cancel exactly in modular arithmetic.
    def seg_fill(vals):
        d = jnp.zeros((vote_cap,), jnp.int32)
        d = d.at[head_idx].add(vals, mode="drop")
        d = d.at[tail_idx].add(-vals, mode="drop")
        return jnp.cumsum(d, dtype=jnp.int32)

    # α_s as 22-bit fixed point: integer fill is exact.
    alpha_fix = jnp.round((flat_alpha + jnp.float32(math.pi))
                          * jnp.float32(_ALPHA_SCALE)).astype(jnp.int32)
    alpha_fix = jnp.clip(alpha_fix, 0, (1 << ALPHA_BITS) - 1)

    # (offset << CNT_BITS | count) riding ONE fill: distinct segments never
    # overlap, so the packed value transports exactly.
    packed_oc = (off_q << CNT_BITS) | cnt
    oc_v = seg_fill(jnp.where(nz, packed_oc, 0))
    off_v = jax.lax.shift_right_logical(
        oc_v.view(jnp.uint32), jnp.uint32(CNT_BITS)).astype(jnp.int32)
    cnt_v = oc_v & jnp.int32((1 << CNT_BITS) - 1)
    alpha_v = seg_fill(jnp.where(nz, alpha_fix, 0))

    v_iota = jnp.arange(vote_cap, dtype=jnp.int32)
    j = v_iota - start
    vote_ok = (j >= 0) & (j < cnt_v) & (v_iota < total_p)

    # THE per-vote lookup.
    n_angle = int(round(2.0 * math.pi / d_angle))
    if tables.pair_packed is not None:
        P_max = tables.pair_packed.height * LANES - 1
        slot = jnp.clip(off_v + j, 0, P_max)
        pp = packed_lookup(tables.pair_packed, _as_q(slot, vote_cap)) \
            .reshape(-1)
        m_r = jax.lax.shift_right_logical(
            pp, jnp.uint32(ALPHA_BITS)).astype(jnp.int32)
        am_fix = (pp & jnp.uint32((1 << ALPHA_BITS) - 1)).astype(jnp.int32)
    else:
        P_max = tables.pair_mr.height * LANES - 1
        slot = jnp.clip(off_v + j, 0, P_max)
        slot_q = _as_q(slot, vote_cap)
        m_r = packed_lookup(tables.pair_mr, slot_q).reshape(-1)
        a_m = packed_lookup(tables.pair_alpha, slot_q).reshape(-1)
        am_fix = jnp.clip(jnp.round((a_m + jnp.float32(math.pi))
                                    * jnp.float32(_ALPHA_SCALE))
                          .astype(jnp.int32), 0, (1 << ALPHA_BITS) - 1)

    # Integer α binning: wrap(α_s − α_m) to [0, 2π) then bin by 2π/n_angle,
    # all in 22-bit fixed point — matches kernel.cu:341-342 up to the
    # 7.5e-7 rad fixed-point quantization (the reference's own fp32 noise
    # class). Zero per-vote transcendentals.
    half = jnp.int32(1 << (ALPHA_BITS - 1))
    mask = jnp.int32((1 << ALPHA_BITS) - 1)
    w = (alpha_v - am_fix + half) & mask
    a_bin = jnp.clip((w * n_angle) >> ALPHA_BITS, 0,
                     voting_ref.ALPHA_PAD - 1)

    A = voting_ref.ALPHA_PAD
    if use_mxu_tally:
        acc = _mxu_tally(m_r, a_bin, vote_ok, r_of_chunk_start=row_start_p,
                         R=R, n_model=n_model, chunk=chunk,
                         vote_cap=vote_cap)
    else:
        r_fill = jax.lax.cummax(
            jnp.zeros((vote_cap,), jnp.int32)
            .at[head_idx].max(r_of_s, mode="drop"),
            axis=0)
        target = jnp.where(vote_ok,
                           (r_fill * n_model + m_r) * A + a_bin,
                           R * n_model * A)
        acc = (jnp.zeros((R * n_model * A,), jnp.int32)
               .at[target].add(1, mode="drop").reshape(R, n_model, A))

    return voting_ref.VoteResult(accumulator=acc, num_votes=total,
                                 overflowed=overflow)


def _mxu_tally(m_r, a_bin, vote_ok, r_of_chunk_start, R, n_model, chunk,
               vote_cap):
    """Chunked one-hot matmul tally. Votes are row-padded so each chunk
    belongs to exactly one reference row; per-chunk partials combine into
    per-row tallies with a cumsum over chunks + row-boundary differences."""
    A = voting_ref.ALPHA_PAD
    n_chunks = vote_cap // chunk
    m_pad = _ceil_to(n_model, 128)

    m_c = m_r.reshape(n_chunks, chunk)
    a_c = a_bin.reshape(n_chunks, chunk)
    ok_c = vote_ok.reshape(n_chunks, chunk)

    iota_m = jax.lax.broadcasted_iota(jnp.int32, (chunk, m_pad), 1)
    iota_a = jax.lax.broadcasted_iota(jnp.int32, (chunk, A), 1)

    def chunk_partial(args):
        m, a, ok = args
        om = ((m[:, None] == iota_m) & ok[:, None]).astype(jnp.bfloat16)
        oa = (a[:, None] == iota_a).astype(jnp.bfloat16)
        return jax.lax.dot_general(
            om, oa, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)                 # (m_pad, A)

    partials = jax.lax.map(chunk_partial, (m_c, a_c, ok_c),
                           batch_size=8)                        # (n_chunks, m_pad, A)

    # Per-row combine: rows own contiguous chunk ranges
    # [row_start_p[r]/chunk, row_start_p[r+1]/chunk). Each f32 partial is an
    # exact integer <= chunk (8192), but the cumsum ACROSS chunks can pass
    # 2^24 per cell for vote-heavy symmetric models — combine in int32.
    cum = jnp.cumsum(jnp.round(partials).astype(jnp.int32), axis=0)
    cum = jnp.concatenate([jnp.zeros((1, m_pad, A), jnp.int32), cum],
                          axis=0)                               # (n_chunks+1,...)
    row_chunk_start = jnp.clip(r_of_chunk_start // chunk, 0, n_chunks)
    row_chunk_end = jnp.concatenate([
        row_chunk_start[1:],
        jnp.full((1,), n_chunks, jnp.int32)])
    row_chunk_end = jnp.clip(row_chunk_end, 0, n_chunks)
    acc = cum[row_chunk_end] - cum[row_chunk_start]             # (R, m_pad, A)
    return acc[:, :n_model, :]
