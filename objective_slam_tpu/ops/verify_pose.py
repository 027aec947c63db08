"""Geometric pose verification — inlier rescoring of candidate poses.

Not in the reference (its winner is the raw clustered Hough maximum,
model.cu:293-295), but a standard PPF-pipeline stage (cf. "Going Further
with Point Pair Features", Hinterstoisser et al. 2016): Hough peaks can be
aliased — especially for near-symmetric models or with the correlation
engine's α blur — while the true pose is trivially distinguished by how
much of the model it actually explains. Score each candidate by the
fraction of model points whose transformed position has a scene point
within `max_dist`; pick the best-scoring candidate among the threshold
survivors.

Candidate × model × scene distance tensors are matmuls (‖a−b‖²
expansion), chunked over candidates with lax.map to bound memory.
Enabled via PPFConfig.rescore_poses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("chunk",))
def inlier_scores(poses, valid, model_points, scene_points, max_dist,
                  model_normals=None, scene_normals=None,
                  cos_thresh: float = 0.7, chunk: int = 16):
    """Fraction of model points explained by the scene, per candidate pose.

    An inlier is a model point whose transformed position has a scene point
    within `max_dist` AND (when normals are given) whose rotated normal
    agrees with that scene point's normal (dot > cos_thresh). The normal
    term discriminates flipped poses of near-symmetric shapes, where
    positions alone cannot.

    Args:
      poses: (P, 4, 4) candidate transforms (model -> scene).
      valid: (P,) bool candidate mask.
      model_points: (n_m, 3); model_normals optional (n_m, 3).
      scene_points: (n_s, 3) — padding rows at far sentinels are harmless
        (they are never anyone's nearest neighbour within max_dist).
      max_dist: inlier radius (typically the model's d_dist).
      chunk: candidates per lax.map step (bounds the (chunk, n_m, n_s)
        distance tensor).
    """
    m = jnp.asarray(model_points, jnp.float32)
    s = jnp.asarray(scene_points, jnp.float32)
    use_normals = model_normals is not None and scene_normals is not None
    if use_normals:
        mn = jnp.asarray(model_normals, jnp.float32)
        mn = mn / jnp.maximum(jnp.linalg.norm(mn, axis=1, keepdims=True),
                              1e-9)
        sn = jnp.asarray(scene_normals, jnp.float32)
        sn = sn / jnp.maximum(jnp.linalg.norm(sn, axis=1, keepdims=True),
                              1e-9)
    P = poses.shape[0]
    pad = (-P) % chunk
    poses_p = jnp.concatenate(
        [poses, jnp.tile(jnp.eye(4, dtype=jnp.float32)[None], (pad, 1, 1))])
    s_sq = jnp.sum(s * s, axis=1)
    max_sq = jnp.float32(max_dist) ** 2

    def score_chunk(T):
        # T: (chunk, 4, 4)
        mt = jnp.einsum("cij,nj->cni", T[:, :3, :3], m,
                        precision=_HI) + T[:, None, :3, 3]   # (c, n_m, 3)
        d2 = (jnp.sum(mt * mt, axis=-1)[..., None] + s_sq[None, None, :]
              - 2.0 * jnp.einsum("cni,si->cns", mt, s, precision=_HI))
        nn_d2 = jnp.min(d2, axis=-1)                         # (c, n_m)
        ok = nn_d2 < max_sq
        if use_normals:
            nn_idx = jnp.argmin(d2, axis=-1)                 # (c, n_m)
            mnt = jnp.einsum("cij,nj->cni", T[:, :3, :3], mn,
                             precision=_HI)                  # (c, n_m, 3)
            snn = sn[nn_idx]                                 # (c, n_m, 3)
            ok = ok & (jnp.sum(mnt * snn, axis=-1) >
                       jnp.float32(cos_thresh))
        return jnp.mean(ok.astype(jnp.float32), axis=-1)

    scores = jax.lax.map(score_chunk,
                         poses_p.reshape(-1, chunk, 4, 4)).reshape(-1)[:P]
    return jnp.where(valid, scores, -1.0)
