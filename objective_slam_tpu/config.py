"""Configuration for the PPF pipeline.

Mirrors the reference's compile-time constants (pcl/alignment/include/kernel.h:10-18)
and CLI algorithm flags (pcl/alignment/src/alignment.cpp:119-172), lifted into a
single dataclass so the whole pipeline is parameterized and jit-friendly
(values are Python scalars, closed over at trace time).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PPFConfig:
    """Algorithm parameters.

    Attributes:
      n_angle: number of rotation-angle bins over [0, 2π).
        Reference: N_ANGLE = 30 (kernel.h:15, matlab/model_description.m:14).
      tau_d: relative distance quantization step; d_dist = tau_d * model
        diameter (matlab/model_description.m:13; alignment.cpp `--tau_d`).
      ref_point_df: scene reference point downsample factor; only every
        ref_point_df-th scene point acts as a Hough reference point
        (kernel.cu:432-435; MATLAB voting_scheme.m `skip`).
      vote_count_threshold: fraction of the max vote count below which
        candidate votes are discarded (model.cu:164-170; default 0.4 from
        alignment.cpp:134-135).
      max_poses: static capacity for surviving (ref point, model point, α)
        vote cells turned into candidate poses. The reference keeps a
        data-dependent count (model.cu:169); under static shapes we keep the top
        `max_poses` by count and mask those below threshold. Exact whenever
        the true survivor count <= max_poses.
      cluster_center_cell: if False, replicate the reference quirk of
        excluding a pose's *own* translation grid cell from its cluster
        neighborhood ("THIS IS WRONG, BUT IT MAKES IT WORK",
        kernel.cu:684-689). If True, include it (corrected mode).
      use_l1_norm: skip the L2 translation-distance check in clustering
        (kernel.cu:740-746; the "L1" is the implicit grid-cell adjacency).
      use_averaged_clusters: weighted-average the cluster translation
        (kernel.cu:747-752).
      scene_leaf_size: voxel-grid leaf for scene downsampling
        (alignment.cpp:131, default 10.0).
      validation_translation_threshold: match iff translation error is below
        this fraction of the model diameter (alignment.cpp:141-142).
      validation_rotation_threshold_deg: match iff rotation error (rad) below
        this many degrees (alignment.cpp:143-144, default 12°).
      refine_icp: if True, refine the winning pose with ICP (ops/icp.py,
        matmul NN + solve) inside the jitted match — the Drost
        winner's rotation error is bounded by the 2π/30 α quantization
        (~±6°); ICP takes it to the noise floor. Extension: the reference
        stops at the clustered winner (model.cu:293-295).
      icp_iterations: fixed ICP iteration count (static shape).
      icp_max_dist_factor: ICP correspondence rejection radius as a
        multiple of d_dist.
      icp_point_to_plane: use the point-to-plane solver (hybrid Kabsch →
        clamped linearized 6×6) with scene normals. Point-to-plane doesn't
        penalize sliding along the surface, but it minimizes the
        off-surface bias of voxel-CENTROID model points — on highly curved
        surfaces that bias field can fix the pose a few degrees off
        (measured ~3° on the bumpy synthetic blob), while point-to-point
        against a full-resolution scan converges below 1° given enough
        iterations. Default False (point-to-point); enable for smooth
        real scans where the centroid bias is below the noise floor.
      rescore_poses: if True, re-rank candidate poses by geometric inlier
        score (fraction of model points within d_dist of a scene point) —
        a standard PPF verification stage absent from the reference; fixes
        Hough-peak aliasing for near-symmetric models (ops/verify_pose.py).
        Only candidates whose clustered vote count is within
        rescore_min_vote_frac of the winner compete: re-ranking ALL
        survivors lets a fully-visible distractor outscore an occluded
        true instance (EVAL.md §4).
      rescore_min_vote_frac: the near-tie threshold for the above.
      engine: voting engine. "fast" = the exact hot path —
        block-expansion voting (ops/voting_block.py: occupied-key
        dictionary matmul + bucket-row gather + scatter-add tally) when
        the model fits its packing budgets, else the legacy
        packed-lookup engine (ops/voting_fast.py); the two produce
        bit-identical tallies. "reference" = the simple expansion engine
        (ops/voting.py, readable twin used for golden-testing). Tallies are
        identical up to fixed-point α-bin boundary moves (< 0.5% of votes;
        bin 30 at exactly α=π wraps to 0 — PARITY.md §9). "correlation" =
        matmul-only Hough voting (ops/voting_corr.py) whose cost is
        independent of the vote count; approximate (±1 α-bin transport,
        PARITY.md §10; recognition-equivalent at dataset scale — EVAL.md).
      use_fnv_keys: operational FNV keying mode (ops/hashing.py): match
        through bit-exact FNV-1a feature hashes INCLUDING the reference's
        collision conflation and key-0 skip (kernel.cu:460-477, 467-470),
        so vote tallies are comparable bucket-for-bucket against a
        collision-afflicted reference run. Default False (injective packed
        keys — a strict superset: no collisions). Composes with every
        engine (the remap happens in key space).
    """

    engine: str = "fast"
    use_fnv_keys: bool = False
    rescore_poses: bool = False
    rescore_min_vote_frac: float = 0.7
    refine_icp: bool = False
    icp_iterations: int = 24
    icp_max_dist_factor: float = 2.0
    icp_point_to_plane: bool = False
    n_angle: int = 30
    tau_d: float = 0.1
    ref_point_df: int = 1
    vote_count_threshold: float = 0.4
    max_poses: int = 1024
    cluster_center_cell: bool = False
    use_l1_norm: bool = False
    use_averaged_clusters: bool = False
    scene_leaf_size: float = 10.0
    validation_translation_threshold: float = 0.1
    validation_rotation_threshold_deg: float = 12.0

    @property
    def d_angle(self) -> float:
        """Angle quantization step, D_ANGLE0 = 2π/n_angle (kernel.h:16)."""
        return 2.0 * math.pi / self.n_angle

    @property
    def rot_thresh(self) -> float:
        """Quaternion clustering threshold, ROT_THRESH = 2*d_angle (kernel.h:17)."""
        return 2.0 * self.d_angle

    @property
    def n_feat_angle_bins(self) -> int:
        """Feature angles live in [0, π]; with step 2π/n_angle that is
        n_angle/2 + 1 possible truncating-quantized bins (bin n_angle/2 only
        at exactly π)."""
        return self.n_angle // 2 + 1

    @property
    def n_alpha_bins(self) -> int:
        """α+π lives in [0, 2π]; truncating quantization yields bins
        0..n_angle (bin n_angle only at exactly 2π), cf. kernel.cu:341-342
        which packs α into 6 bits allowing bin 30."""
        return self.n_angle + 1
