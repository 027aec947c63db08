"""Pose clustering: dense static-shape formulation + greedy CPU-reference mode.

The reference clusters candidate poses two ways:

  * GPU path (kernel.cu:647-763, model.cu:202-244): discretize translations
    into a d_dist grid, FNV-hash each pose's cell and its 27-neighborhood,
    build a second ParallelHashArray, and for each pose sum the weighted vote
    counts of hash-bucket neighbors whose quaternion distance and translation
    distance pass thresholds. Quirk: the *center* cell's hash is zeroed
    ("THIS IS WRONG, BUT IT MAKES IT WORK", kernel.cu:684-689), so same-cell
    poses (including the pose itself) are never counted; each pose's tally
    starts at 1 instead.

  * CPU path (src/transformation_clustering.cpp:62-137): greedy agglomerative
    clustering by (translation, rotation-angle) thresholds, cluster votes
    summed, top-3 clusters averaged (Gramkow quaternion averaging).

Rebuild: candidate pose counts are bounded (top-K from voting), so the
hash join becomes a **dense P×P masked reduction** — quaternion dots via one
matmul, grid-cell adjacency via integer comparisons — with bit-equal
semantics minus FNV-collision artifacts (documented deviation). The greedy
CPU mode is kept as a NumPy implementation for small-input validation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Pin full fp32 matmul precision (the default may be bf16 passes or TF32).
_HI = jax.lax.Precision.HIGHEST
import numpy as np


class ClusterResult(NamedTuple):
    vote_counts: jax.Array   # (P,) float32 clustered (weighted) vote counts
    translations: jax.Array  # (P,) float32 (possibly cluster-averaged)


def cluster_poses_dense(translations, quats, weighted_counts, valid,
                        d_dist, rot_thresh, *, include_center_cell: bool,
                        use_l1_norm: bool, use_averaged_clusters: bool
                        ) -> ClusterResult:
    """Dense equivalent of rot_clustering_kernel (kernel.cu:702-763).

    Args:
      translations: (P, 3) float32 pose translations.
      quats: (P, 4) float32 pose quaternions (w, x, y, z).
      weighted_counts: (P,) float32 weighted vote counts
        (vote_weight_kernel, kernel.cu:766-782).
      valid: (P,) bool mask of real poses (False rows never match anything
        and report count 0).
      d_dist: translation grid step and L2 threshold (model.cu:240).
      rot_thresh: ROT_THRESH = 2·Δα; the quaternion test is
        |8(1 − q·q′)| < rot_thresh² (kernel.cu:717, 737-739).
      include_center_cell: False replicates the reference quirk of excluding
        a pose's own grid cell (and hence itself; its tally starts at 1,
        kernel.cu:684-689, 722). True is the corrected mode: all 27 cells
        count and the pose's own weighted count seeds the sum.
    """
    t = jnp.asarray(translations, jnp.float32)
    q = jnp.asarray(quats, jnp.float32)
    w = jnp.asarray(weighted_counts, jnp.float32)
    d_dist = jnp.float32(d_dist)

    # Grid cell = trunc(t / d_dist), computed the reference way via the
    # truncating quantizer then division (trans2idx_kernel, kernel.cu:675-678:
    # (int)(quant_downf(t, d)/d) truncates toward zero).
    quant = t - jnp.fmod(t, d_dist)
    cell = jnp.trunc(quant / d_dist).astype(jnp.int32)          # (P, 3)

    diff = cell[:, None, :] - cell[None, :, :]                  # (P, P, 3)
    adjacent = jnp.max(jnp.abs(diff), axis=-1) <= 1
    same_cell = jnp.all(diff == 0, axis=-1)
    if not include_center_cell:
        adjacent = adjacent & ~same_cell

    # Quaternion distance: one (P,4)x(4,P) matmul.
    qdot = jnp.dot(q, q.T, preferred_element_type=jnp.float32, precision=_HI)
    quat_ok = jnp.abs(8.0 * (1.0 - qdot)) < jnp.float32(rot_thresh) ** 2

    mask = adjacent & quat_ok
    if not use_l1_norm:
        tdiff = t[:, None, :] - t[None, :, :]
        dist_ok = jnp.linalg.norm(tdiff, axis=-1) < d_dist
        mask = mask & dist_ok
    mask = mask & valid[None, :] & valid[:, None]

    mf = mask.astype(jnp.float32)
    neighbor_sum = jnp.dot(mf, w, preferred_element_type=jnp.float32, precision=_HI)
    if include_center_cell:
        # Corrected mode: the center cell contributes (incl. self), seed 0.
        counts_out = neighbor_sum
    else:
        # Parity mode: vote_count_out starts at 1 (kernel.cu:722).
        counts_out = 1.0 + neighbor_sum

    if use_averaged_clusters:
        # Sequential weighted average in the reference (kernel.cu:747-752)
        # telescopes to (seed·t_i + Σ w_j t_j)/(seed + Σ w_j) with seed = 1
        # (parity) — order-independent, so computable as one reduction.
        seed = 0.0 if include_center_cell else 1.0
        t_sum = jnp.dot(mf, w[:, None] * t,
                        preferred_element_type=jnp.float32, precision=_HI) + seed * t
        denom = neighbor_sum + seed
        t_out = t_sum / jnp.where(denom > 0, denom, 1.0)[:, None]
    else:
        t_out = t

    counts_out = jnp.where(valid, counts_out, 0.0)
    return ClusterResult(vote_counts=counts_out, translations=t_out)


class GreedyCluster(NamedTuple):
    poses: np.ndarray   # (k, 4, 4) averaged cluster poses, votes descending
    votes: np.ndarray   # (k,) summed votes


def cluster_poses_greedy(poses, votes, trans_thresh, rot_thresh,
                         max_clusters: int = 3) -> GreedyCluster:
    """Host-side greedy agglomerative clustering — the reference CPU mode
    (clusterPoses, src/transformation_clustering.cpp:62-123): sort by votes
    descending, assign each pose to the first cluster whose *seed* is within
    (trans_thresh, rot_thresh), sum votes, then average the top-3 clusters'
    translations and quaternions (Gramkow)."""
    poses = np.asarray(poses, np.float32)
    votes = np.asarray(votes, np.float32)
    order = np.argsort(-votes, kind="stable")
    seeds: list[int] = []
    members: list[list[int]] = []
    cluster_votes: list[float] = []

    def _quat(R):
        # scipy-free rotation-matrix -> quaternion (w, x, y, z)
        tr = R[0, 0] + R[1, 1] + R[2, 2]
        w = 0.5 * np.sqrt(max(1.0 + tr, 0.0))
        x = np.copysign(0.5 * np.sqrt(max(1 + R[0, 0] - R[1, 1] - R[2, 2], 0)),
                        R[2, 1] - R[1, 2])
        y = np.copysign(0.5 * np.sqrt(max(1 - R[0, 0] + R[1, 1] - R[2, 2], 0)),
                        R[0, 2] - R[2, 0])
        z = np.copysign(0.5 * np.sqrt(max(1 - R[0, 0] - R[1, 1] + R[2, 2], 0)),
                        R[1, 0] - R[0, 1])
        q = np.array([w, x, y, z])
        n = np.linalg.norm(q)
        return q / n if n > 0 else q

    for i in order:
        placed = False
        for c, seed in enumerate(seeds):
            s = poses[seed]
            p = poses[i]
            tdist = np.linalg.norm(s[:3, 3] - p[:3, 3])
            Rrel = s[:3, :3].T @ p[:3, :3]
            ang = abs(np.arccos(np.clip((np.trace(Rrel) - 1) / 2, -1, 1)))
            if tdist < trans_thresh and ang < rot_thresh:
                members[c].append(i)
                cluster_votes[c] += float(votes[i])
                placed = True
                break
        if not placed:
            seeds.append(i)
            members.append([i])
            cluster_votes.append(float(votes[i]))

    order_c = np.argsort(-np.asarray(cluster_votes), kind="stable")
    k = min(max_clusters, len(order_c))
    out = np.zeros((k, 4, 4), np.float32)
    out_votes = np.zeros((k,), np.float32)
    for oi, c in enumerate(order_c[:k]):
        ts = poses[members[c], :3, 3].mean(axis=0)
        qs = np.stack([_quat(poses[m][:3, :3]) for m in members[c]])
        q_avg = qs.mean(axis=0)
        q_avg /= np.linalg.norm(q_avg)
        w, x, y, z = q_avg
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        out[oi, :3, :3] = R
        out[oi, :3, 3] = ts
        out[oi, 3, 3] = 1.0
        out_votes[oi] = cluster_votes[c]
    return GreedyCluster(poses=out, votes=out_votes)
