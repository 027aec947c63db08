"""Point-pair features, truncating quantization, and packed integer keys.

Reference semantics:
  * feature      — matlab/point_pair_feature.m:1-11, kernel.cu:109-122
  * quantization — matlab/my_discretize.m:1-9, kernel.cu:90-100 (quant_downf)
  * keying       — the reference FNV-1a-hashes the raw bytes of the quantized
                   float4 (kernel.cu:460-477). Here the primary key is a
                   *packed integer bin index* instead: with n_angle = 30 the
                   three angle bins fit in [0, 16) and the distance bin is
                   bounded by the model diameter, so the quantized feature
                   packs injectively into an int32 — zero hash collisions and
                   a direct-addressed lookup table (SURVEY.md §7). FNV-1a is
                   retained in ops/hashing.py for bit-parity validation.

All functions broadcast over leading batch dims and run on the VPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# All geometric contractions are tiny (k<=4); pin full fp32 precision so
# no backend lowers them to bf16 or TF32 passes (2e-3 error otherwise).
_HI = jax.lax.Precision.HIGHEST

# Sentinel for pairs that produce no feature: self-pairs (kernel.cu:438-441),
# non-reference rows under ref_point_df (kernel.cu:432-435), and degenerate
# zero-distance pairs. The reference marks them NaN and later maps NaN→key 0
# (kernel.cu:467-470); we use an explicit out-of-range key so that key 0
# remains a *valid* feature (the reference silently conflates a real hash of
# 0 with "empty" — documented deviation).
INVALID_KEY = jnp.int32(2147483647)

# Number of possible feature-angle bins: acos ∈ [0, π], step 2π/30 ⇒ bins
# 0..15. Padded to 16 (a power of two) for cheap packing.
ANGLE_BINS = 16


def quant_downf(x, step):
    """Truncating quantizer x − fmod(x, step) (kernel.cu:90-92,
    matlab/my_discretize.m). fmod semantics (truncate toward zero) match C
    fmodf for the non-negative inputs used here."""
    x = jnp.asarray(x, jnp.float32)
    step = jnp.float32(step)
    return x - jnp.fmod(x, step)


def compute_ppf(p1, n1, p2, n2):
    """F = (‖d‖, ∠(n1,d), ∠(n2,d), ∠(n1,n2)) with d = p2 − p1
    (kernel.cu:109-122). Angles via acos of normalized dots; dots are clamped
    to [-1, 1] (the reference lets fp error produce NaN there — the clamp
    only changes degenerate boundary cases, documented deviation).

    Inputs broadcast; returns (..., 4) float32."""
    p1 = jnp.asarray(p1, jnp.float32)
    p2 = jnp.asarray(p2, jnp.float32)
    n1 = jnp.asarray(n1, jnp.float32)
    n2 = jnp.asarray(n2, jnp.float32)
    d = p2 - p1
    dist = jnp.linalg.norm(d, axis=-1)
    inv = jnp.where(dist > 0, 1.0 / jnp.where(dist > 0, dist, 1.0), 0.0)
    n1n = jnp.linalg.norm(n1, axis=-1)
    n2n = jnp.linalg.norm(n2, axis=-1)

    def _angle(a, b, an, bn):
        c = jnp.sum(a * b, axis=-1) / jnp.where(an * bn > 0, an * bn, 1.0)
        return jnp.arccos(jnp.clip(c, -1.0, 1.0))

    f1 = dist
    f2 = jnp.arccos(jnp.clip(jnp.sum(n1 * d, axis=-1) * inv
                             / jnp.where(n1n > 0, n1n, 1.0), -1.0, 1.0))
    f3 = jnp.arccos(jnp.clip(jnp.sum(n2 * d, axis=-1) * inv
                             / jnp.where(n2n > 0, n2n, 1.0), -1.0, 1.0))
    f4 = _angle(n1, n2, n1n, n2n)
    return jnp.stack([f1, f2, f3, f4], axis=-1)


def disc_feature(f, d_dist, d_angle):
    """Quantize a PPF: distance by d_dist, angles by d_angle
    (kernel.cu:94-100). Returns the quantized float4 (parity with the
    reference's dumped arrays)."""
    return jnp.stack([
        quant_downf(f[..., 0], d_dist),
        quant_downf(f[..., 1], d_angle),
        quant_downf(f[..., 2], d_angle),
        quant_downf(f[..., 3], d_angle),
    ], axis=-1)


def feature_bins(f, d_dist, d_angle):
    """Integer bin indices of a PPF: bin = round(quant_downf(x, s)/s), which
    equals trunc(x/s) up to fp rounding — computed the reference way (via the
    quantized float) so bin boundaries match the reference bit pattern."""
    q = disc_feature(f, d_dist, d_angle)
    db = jnp.round(q[..., 0] / jnp.float32(d_dist)).astype(jnp.int32)
    ab = jnp.round(q[..., 1:] / jnp.float32(d_angle)).astype(jnp.int32)
    return db, ab


def pack_key(dist_bin, angle_bins, max_dist_bin):
    """Pack (dist_bin, a1, a2, a3) into one int32 key:
    key = ((dist·16 + a1)·16 + a2)·16 + a3.

    Injective for dist_bin ≤ max_dist_bin and angle bins < 16 — the exact
    replacement for the reference's FNV-1a of float bytes. Out-of-range
    distance bins (scene pairs farther apart than any model pair) map to
    INVALID_KEY so they match nothing."""
    a1 = angle_bins[..., 0]
    a2 = angle_bins[..., 1]
    a3 = angle_bins[..., 2]
    key = ((dist_bin * ANGLE_BINS + a1) * ANGLE_BINS + a2) * ANGLE_BINS + a3
    valid = (dist_bin >= 0) & (dist_bin <= max_dist_bin) & \
        (a1 < ANGLE_BINS) & (a2 < ANGLE_BINS) & (a3 < ANGLE_BINS)
    return jnp.where(valid, key, INVALID_KEY)


def num_keys(max_dist_bin: int) -> int:
    """Size of the direct-addressed key table."""
    return (int(max_dist_bin) + 1) * ANGLE_BINS * ANGLE_BINS * ANGLE_BINS


def pairwise_ppf_keys(points, normals, d_dist, d_angle, max_dist_bin,
                      ref_indices=None):
    """All-pairs PPF keys and α angles — the fused equivalent of the
    reference's ppf_kernel + ppf_hash_kernel (kernel.cu:404-477) plus the
    α_m/α_s precomputation (see ops.transforms.alpha_angle).

    Args:
      points, normals: (n, 3) float32.
      ref_indices: optional (r,) int32 of reference rows (implements
        ref_point_downsample_factor, kernel.cu:432-435 — instead of NaN-ing
        skipped rows we simply never materialize them).

    Returns:
      keys:  (r, n) int32 packed keys, INVALID_KEY on the diagonal (self
             pairs, kernel.cu:438-441) and for unmatchable distance bins.
      alpha: (r, n) float32 α angle of each pair in the canonical frame of
             its reference point.
    """
    from objective_slam_tpu.ops import transforms as tr

    points = jnp.asarray(points, jnp.float32)
    normals = jnp.asarray(normals, jnp.float32)
    n = points.shape[0]
    if ref_indices is None:
        ref_indices = jnp.arange(n, dtype=jnp.int32)
    ref_pts = points[ref_indices]          # (r, 3)
    ref_nrm = normals[ref_indices]         # (r, 3)

    d = points[None, :, :] - ref_pts[:, None, :]          # (r, n, 3)
    dist = jnp.linalg.norm(d, axis=-1)                    # (r, n)
    safe = jnp.where(dist > 0, dist, 1.0)
    d_hat = d / safe[..., None]

    ref_nn = jnp.linalg.norm(ref_nrm, axis=-1)            # (r,)
    all_nn = jnp.linalg.norm(normals, axis=-1)            # (n,)
    ref_unit = ref_nrm / jnp.where(ref_nn > 0, ref_nn, 1.0)[:, None]
    all_unit = normals / jnp.where(all_nn > 0, all_nn, 1.0)[:, None]

    c2 = jnp.einsum("rc,rnc->rn", ref_unit, d_hat, precision=_HI)
    c3 = jnp.einsum("nc,rnc->rn", all_unit, d_hat, precision=_HI)
    c4 = jnp.einsum("rc,nc->rn", ref_unit, all_unit, precision=_HI)
    f2 = jnp.arccos(jnp.clip(c2, -1.0, 1.0))
    f3 = jnp.arccos(jnp.clip(c3, -1.0, 1.0))
    f4 = jnp.arccos(jnp.clip(c4, -1.0, 1.0))

    d_dist = jnp.float32(d_dist)
    d_angle = jnp.float32(d_angle)
    dist_bin = jnp.round(quant_downf(dist, d_dist) / d_dist).astype(jnp.int32)
    a1 = jnp.round(quant_downf(f2, d_angle) / d_angle).astype(jnp.int32)
    a2 = jnp.round(quant_downf(f3, d_angle) / d_angle).astype(jnp.int32)
    a3 = jnp.round(quant_downf(f4, d_angle) / d_angle).astype(jnp.int32)

    key = ((dist_bin * ANGLE_BINS + a1) * ANGLE_BINS + a2) * ANGLE_BINS + a3
    # dist_bin >= 0 guards pad-sentinel points (e.g. voxel _PAD_OFFSET) whose
    # huge dist/d_dist quotient overflows the int cast: int32 saturation to
    # INT_MAX happens to stay invalid via <= max_dist_bin, but the sign of
    # float->int overflow is implementation-defined — make invalidity
    # structural on every backend.
    valid = (dist > 0) & (dist_bin >= 0) & (dist_bin <= max_dist_bin)
    # Self-pair exclusion by index (kernel.cu:438-441).
    self_pair = ref_indices[:, None] == jnp.arange(n, dtype=jnp.int32)[None, :]
    keys = jnp.where(valid & ~self_pair, key, INVALID_KEY)

    # α of each pair about the reference point's canonical frame. Written
    # as explicit row products (not einsum) so the fast voting engine's
    # per-vote recompute (ops/voting_fast.py) is bit-identical.
    beta, gamma = tr.canonical_angles(ref_pts, ref_nrm)
    cb, sb = jnp.cos(beta), jnp.sin(beta)
    cg, sg = jnp.cos(gamma), jnp.sin(gamma)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    u_y = (sg * cb)[:, None] * dx + cg[:, None] * dy + (sg * sb)[:, None] * dz
    u_z = (-sb)[:, None] * dx + cb[:, None] * dz
    alpha = jnp.arctan2(u_z, u_y)                         # (r, n)
    return keys, alpha
