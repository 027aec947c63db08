"""ICP pose refinement — point-to-point (Kabsch) and point-to-plane, matmul-based.

Not present in the reference (its pipeline ends at the clustered Hough
winner, model.cu:293-295); listed as a rebuild extension in BASELINE.json
("pose clustering plus ICP refinement run as batched Procrustes/SVD
solves"). Refines the Drost pose — whose rotation error is bounded by
the 2π/30 α quantization (~±6°) — down to the noise floor.

Design: fixed-iteration lax.fori loop (static shapes); nearest neighbours
via the ‖a−b‖² = ‖a‖²+‖b‖²−2a·b distance matrix, chunked over
scene points; correspondence rejection by distance threshold. Two solvers:
weighted Procrustes (Kabsch, 3×3 SVD) for point-to-point, and a linearized
6×6 normal-equation solve for point-to-plane. Point-to-plane is used when
scene normals are given: it doesn't penalize sliding along the surface, so
the discrete-sampling bias that floors point-to-point accuracy (both
clouds sample the same surface at DIFFERENT positions) vanishes, and
coarse model samplings still converge to the true pose.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


class ICPResult(NamedTuple):
    pose: jax.Array        # (4, 4) refined transform (model -> scene)
    rms: jax.Array         # () float32 final inlier RMS distance
    inliers: jax.Array     # () int32 final inlier count


# Scene-chunking budget for the NN distance tile (n_m × chunk f32): one
# chunk when the whole tile fits, else 16k-point chunks. A sequential
# lax.map over chunks costs per-chunk loop overhead, so for the
# common case (hundreds of model points × a 100k scan ≈ 28M floats) the
# single-tile path is markedly faster inside the 24-iteration loop.
_NN_TILE_BUDGET = 64 * 1024 * 1024
_NN_CHUNK = 16384


def refine_pose(model_points, scene_points, init_pose, *,
                iterations: int = 12, max_dist: float,
                scene_valid=None, scene_normals=None, model_normals=None,
                point_to_plane: bool | None = None,
                normal_cos_thresh: float = 0.5) -> ICPResult:
    """Refine `init_pose` so that model_points @ Rᵀ + t aligns with
    scene_points.

    ALL matmuls here run at HIGHEST precision: a reduced-precision default
    (bf16 passes, or TF32 on a GPU) re-rounds the 4×4 pose chain dT·T
    every iteration, which random-walks the rotation ~0.5-1° PER
    ITERATION — measured once as a monotonic 7°→21° divergence on a bf16
    default while fp32 converged on identical inputs. The tiny 3×3/4×4
    chains are free at f32.

    scene_points may be the FULL-RESOLUTION scan (not the voxelized cloud):
    the NN search is chunked over scene points so memory stays bounded, and
    refining against the dense scan is what lets ICP beat the voxel-spacing
    accuracy floor — with both clouds sampled at d_dist, point-to-point ICP
    stalls in a discrete-correspondence minimum ~d_dist/radius radians off.

    Args:
      model_points: (n_m, 3) float32.
      scene_points: (n_s, 3) float32 (padded rows allowed via scene_valid).
      init_pose: (4, 4) initial model->scene transform.
      iterations: fixed ICP iteration count (static).
      max_dist: correspondence rejection radius (typically ~2·d_dist).
      scene_valid: optional (n_s,) bool mask of real scene points.
      scene_normals: optional (n_s, 3) float32; enables normal-gated
        correspondences (with model_normals) and the point-to-plane solver.
      model_normals: optional (n_m, 3) float32; when given together with
        scene_normals, correspondences whose transformed model normal
        disagrees with the scene normal (cos < normal_cos_thresh) are
        rejected — regardless of solver. In cluttered scenes this is what
        stops model points latching onto nearby clutter surfaces and
        dragging the fit AWAY from the true pose.
      point_to_plane: solver choice; None (default) = point-to-plane iff
        scene_normals were given. Point-to-plane is a linearized 6×6 solve
        (insensitive to sampling-position mismatch but sensitive to the
        off-surface bias of voxel-centroid model points); point-to-point
        is weighted Kabsch.
      normal_cos_thresh: compatibility gate for the above.
    """
    if point_to_plane is None:
        point_to_plane = scene_normals is not None
    if point_to_plane and scene_normals is None:
        # Previously traced into a NameError deep inside the plane solver;
        # fail at the API boundary instead (hit when config.icp_point_to_
        # plane is set but the caller passes icp_points without
        # icp_normals).
        raise ValueError(
            "point-to-plane ICP requires scene_normals for the ICP cloud; "
            "pass them (icp_normals= at the match level) or use the "
            "point-to-point solver")
    m = jnp.asarray(model_points, jnp.float32)
    s = jnp.asarray(scene_points, jnp.float32)
    T0 = jnp.asarray(init_pose, jnp.float32)
    if scene_valid is None:
        scene_valid = jnp.ones((s.shape[0],), bool)
    s_sq = jnp.sum(s * s, axis=1)
    s_sq = jnp.where(scene_valid, s_sq, jnp.inf)
    max_sq = jnp.float32(max_dist) ** 2

    n_s = s.shape[0]
    n_m = m.shape[0]
    ch = n_s if n_m * n_s <= _NN_TILE_BUDGET else min(_NN_CHUNK, n_s)
    n_chunks = -(-n_s // ch)
    pad = n_chunks * ch - n_s
    s_p = jnp.concatenate([s, jnp.zeros((pad, 3), jnp.float32)])
    ssq_p = jnp.concatenate([s_sq, jnp.full((pad,), jnp.inf)])
    s_c = s_p.reshape(n_chunks, ch, 3)
    ssq_c = ssq_p.reshape(n_chunks, ch)

    def _nearest(mt):
        """Chunked NN: (n_m,) global argmin index + distance², one
        (n_m, ch) distance tile resident at a time."""
        mt_sq = jnp.sum(mt * mt, axis=1)[:, None]            # (n_m, 1)

        def one(args):
            sc, sqc = args
            d2 = (mt_sq + sqc[None, :]
                  - 2.0 * jnp.dot(mt, sc.T, precision=_HI))  # (n_m, ch)
            i = jnp.argmin(d2, axis=1)
            return (jnp.take_along_axis(d2, i[:, None], axis=1)[:, 0], i)

        d2c, ic = jax.lax.map(one, (s_c, ssq_c))             # (n_chunks, n_m)
        best = jnp.argmin(d2c, axis=0)                       # (n_m,)
        nn_d2 = jnp.take_along_axis(d2c, best[None, :], axis=0)[0]
        nn = (jnp.take_along_axis(ic, best[None, :], axis=0)[0]
              + best * ch)
        return jnp.clip(nn, 0, n_s - 1), nn_d2

    if scene_normals is not None:
        sn = jnp.asarray(scene_normals, jnp.float32)
        sn = sn / jnp.maximum(jnp.linalg.norm(sn, axis=1, keepdims=True),
                              1e-12)
    if model_normals is not None:
        mn = jnp.asarray(model_normals, jnp.float32)

    def _solve_point(mt, tgt, w, wsum):
        """Weighted Procrustes (Kabsch) increment."""
        cm = jnp.sum(w[:, None] * mt, axis=0) / wsum
        cs = jnp.sum(w[:, None] * tgt, axis=0) / wsum
        H = jnp.einsum("ni,nj->ij", w[:, None] * (mt - cm), tgt - cs,
                       precision=_HI)
        U, _, Vt = jnp.linalg.svd(H)
        det = jnp.linalg.det(jnp.matmul(Vt.T, U.T, precision=_HI))
        D = jnp.diag(jnp.array([1.0, 1.0, 1.0], jnp.float32)).at[2, 2].set(
            det)
        R = jnp.matmul(jnp.matmul(Vt.T, D, precision=_HI), U.T,
                       precision=_HI)
        t = cs - jnp.matmul(R, cm, precision=_HI)
        return R, t

    # Per-step rotation clamp for the linearized plane solve: Gauss-Newton
    # on point-to-plane OVERSHOOTS badly when correspondences are still
    # inconsistent (the quadratic model is only locally valid — an
    # unclamped first step here measures ~18° and diverges), so the update
    # is trust-regioned to ~1.1°/step and the early iterations use the
    # always-stable Kabsch solve (see step()).
    _OMEGA_MAX = 0.02

    def _solve_plane(mt, tgt, nrm, w, wsum):
        """Linearized point-to-plane increment: minimize
        Σ w ((mt + ω×mt + t − tgt)·n)² over δ = (ω, t) via the 6×6 normal
        equations, clamp the se(3) step, lift ω to a rotation (Rodrigues)."""
        r = jnp.sum((mt - tgt) * nrm, axis=1)                # (n_m,)
        J = jnp.concatenate([jnp.cross(mt, nrm), nrm], axis=1)  # (n_m, 6)
        Jw = J * w[:, None]
        A = jnp.dot(Jw.T, J, precision=_HI) \
            + 1e-6 * jnp.eye(6, dtype=jnp.float32)
        b = -jnp.dot(Jw.T, r, precision=_HI)
        delta = jnp.linalg.solve(A, b)
        omega, t = delta[:3], delta[3:]
        th = jnp.linalg.norm(omega) + 1e-12
        scale = jnp.minimum(1.0, _OMEGA_MAX / th)            # trust region
        omega, t, th = omega * scale, t * scale, th * scale
        k = omega / th
        K = jnp.array([[0.0, -k[2], k[1]],
                       [k[2], 0.0, -k[0]],
                       [-k[1], k[0], 0.0]], jnp.float32)
        R = (jnp.eye(3, dtype=jnp.float32) + jnp.sin(th) * K
             + (1.0 - jnp.cos(th)) * jnp.matmul(K, K, precision=_HI))
        return R, t

    # Hybrid schedule for the plane solver: Kabsch for the first
    # iterations (stable under the large inconsistent-correspondence error
    # of a raw Hough pose), then clamped point-to-plane to descend below
    # the sampling-mismatch floor that stalls point-to-point.
    n_point_iters = min(4, iterations) if point_to_plane else iterations

    def step(i, carry):
        T, _, _ = carry
        mt = jnp.matmul(m, T[:3, :3].T, precision=_HI) + T[:3, 3]  # (n_m, 3)
        nn, nn_d2 = _nearest(mt)
        w = (nn_d2 < max_sq).astype(jnp.float32)
        if scene_normals is not None and model_normals is not None:
            mnt = jnp.matmul(mn, T[:3, :3].T, precision=_HI)  # rotated nrm
            w = w * (jnp.sum(mnt * sn[nn], axis=1)
                     > normal_cos_thresh).astype(jnp.float32)
        tgt = s[nn]                                          # (n_m, 3)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        if not point_to_plane:
            R, t = _solve_point(mt, tgt, w, wsum)
        else:
            R, t = jax.lax.cond(
                i < n_point_iters,
                lambda: _solve_point(mt, tgt, w, wsum),
                lambda: _solve_plane(mt, tgt, sn[nn], w, wsum))
        dT = jnp.zeros((4, 4), jnp.float32)
        dT = dT.at[:3, :3].set(R).at[:3, 3].set(t).at[3, 3].set(1.0)
        T_new = jnp.matmul(dT, T, precision=_HI)
        rms = jnp.sqrt(jnp.sum(w * nn_d2) / wsum)
        return (T_new, rms, jnp.sum(w).astype(jnp.int32))

    init = (T0, jnp.float32(0.0), jnp.int32(0))
    T, rms, inl = jax.lax.fori_loop(0, iterations, step, init)
    return ICPResult(pose=T, rms=rms, inliers=inl)
