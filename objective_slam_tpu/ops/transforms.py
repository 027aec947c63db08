"""Batched rigid-transform and quaternion math (pure jnp, fp32).

Equivalent of the reference device math library
(pcl/alignment/src/cuda/kernel.cu:32-401 and matlab/utils/pk-matlabfns/):
everything is written to broadcast over arbitrary leading batch dimensions so
it vectorizes with `vmap`/plain broadcasting instead of the
reference's per-thread 4x4 scalar loops.

Conventions:
  * homogeneous transforms are (..., 4, 4) float32 arrays
  * quaternions are (..., 4) arrays ordered (w, x, y, z) — matching the
    reference float4 layout where .x holds the scalar part
    (kernel.cu:128-144).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# All geometric contractions are tiny (k<=4); pin full fp32 precision so
# no backend lowers them to bf16 or TF32 passes (2e-3 error otherwise).
_HI = jax.lax.Precision.HIGHEST


def _embed_rot(c, s, i: int, j: int):
    """Homogeneous rotation by angle with cos c / sin s in plane (i, j).

    Rows/cols other than i, j are identity. c, s broadcast to (...)."""
    c = jnp.asarray(c, jnp.float32)
    s = jnp.asarray(s, jnp.float32)
    batch = jnp.broadcast_shapes(c.shape, s.shape)
    T = jnp.zeros(batch + (4, 4), jnp.float32)
    for k in range(4):
        if k not in (i, j):
            T = T.at[..., k, k].set(1.0)
    T = T.at[..., i, i].set(c)
    T = T.at[..., j, j].set(c)
    T = T.at[..., j, i].set(s)
    T = T.at[..., i, j].set(-s)
    return T


def rotx(theta):
    """Rotation about x (kernel.cu:181-189)."""
    theta = jnp.asarray(theta, jnp.float32)
    return _embed_rot(jnp.cos(theta), jnp.sin(theta), 1, 2)


def roty(theta):
    """Rotation about y (kernel.cu:191-199): standard right-handed R_y with
    T[0][2] = sin, T[2][0] = -sin."""
    theta = jnp.asarray(theta, jnp.float32)
    c, s = jnp.cos(theta), jnp.sin(theta)
    T = jnp.zeros(theta.shape + (4, 4), jnp.float32)
    T = T.at[..., 0, 0].set(c)
    T = T.at[..., 0, 2].set(s)
    T = T.at[..., 1, 1].set(1.0)
    T = T.at[..., 2, 0].set(-s)
    T = T.at[..., 2, 2].set(c)
    T = T.at[..., 3, 3].set(1.0)
    return T


def rotz(theta):
    """Rotation about z (kernel.cu:201-209)."""
    theta = jnp.asarray(theta, jnp.float32)
    return _embed_rot(jnp.cos(theta), jnp.sin(theta), 0, 1)


def trans_mat(v):
    """Homogeneous translation by v (..., 3) (kernel.cu:170-179)."""
    v = jnp.asarray(v, jnp.float32)
    T = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), v.shape[:-1] + (4, 4))
    return T.at[..., :3, 3].set(v)


def invht(T):
    """Closed-form inverse of a rigid homogeneous transform
    (kernel.cu:254-299): inv([R t; 0 1]) = [Rᵀ -Rᵀt; 0 1]."""
    T = jnp.asarray(T, jnp.float32)
    R_T = jnp.swapaxes(T[..., :3, :3], -1, -2)
    t = T[..., :3, 3]
    new_t = -jnp.einsum("...ij,...j->...i", R_T, t, precision=_HI)
    out = jnp.zeros_like(T)
    out = out.at[..., :3, :3].set(R_T)
    out = out.at[..., :3, 3].set(new_t)
    out = out.at[..., 3, 3].set(1.0)
    return out


def transform_points(T, p):
    """Apply homogeneous transform(s) to point(s): (..., 4, 4) x (..., 3) -> (..., 3).

    Replaces the reference homogenize/mat4f_vmul/dehomogenize chain
    (kernel.cu:234-252)."""
    T = jnp.asarray(T, jnp.float32)
    p = jnp.asarray(p, jnp.float32)
    return jnp.einsum("...ij,...j->...i", T[..., :3, :3], p, precision=_HI) + T[..., :3, 3]


def rotate_vectors(T, n):
    """Apply only the rotation part of T to vectors (for normals)."""
    T = jnp.asarray(T, jnp.float32)
    n = jnp.asarray(n, jnp.float32)
    return jnp.einsum("...ij,...j->...i", T[..., :3, :3], n, precision=_HI)


def hrotmat2quat(T):
    """Rotation matrix -> quaternion (w, x, y, z), reference formula
    kernel.cu:128-144 (copysign construction + normalization)."""
    T = jnp.asarray(T, jnp.float32)
    t = T[..., 0, 0] + T[..., 1, 1] + T[..., 2, 2]
    w = 0.5 * jnp.sqrt(jnp.maximum(1.0 + t, 0.0))
    x = jnp.copysign(
        0.5 * jnp.sqrt(jnp.maximum(1.0 + T[..., 0, 0] - T[..., 1, 1] - T[..., 2, 2], 0.0)),
        T[..., 2, 1] - T[..., 1, 2])
    y = jnp.copysign(
        0.5 * jnp.sqrt(jnp.maximum(1.0 - T[..., 0, 0] + T[..., 1, 1] - T[..., 2, 2], 0.0)),
        T[..., 0, 2] - T[..., 2, 0])
    z = jnp.copysign(
        0.5 * jnp.sqrt(jnp.maximum(1.0 - T[..., 0, 0] - T[..., 1, 1] + T[..., 2, 2], 0.0)),
        T[..., 1, 0] - T[..., 0, 1])
    q = jnp.stack([w, x, y, z], axis=-1)
    # Reference normalizes by sqrt(norm(q)) where norm already includes a
    # sqrt (kernel.cu:138) — i.e. by |q|^(1/2); that is a bug kept out of the
    # rebuild: we normalize to unit length. Clustering only uses dot
    # products of quaternions of equal construction, so this is a pure
    # improvement (documented deviation).
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat2hrotmat(q):
    """Quaternion (w, x, y, z) -> homogeneous rotation (kernel.cu:146-168)."""
    q = jnp.asarray(q, jnp.float32)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = jnp.where(n == 0, 0.0, 2.0 / jnp.where(n == 0, 1.0, n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    T = jnp.zeros(q.shape[:-1] + (4, 4), jnp.float32)
    T = T.at[..., 0, 0].set(1 - (yy + zz))
    T = T.at[..., 0, 1].set(xy - wz)
    T = T.at[..., 0, 2].set(xz + wy)
    T = T.at[..., 1, 0].set(xy + wz)
    T = T.at[..., 1, 1].set(1 - (xx + zz))
    T = T.at[..., 1, 2].set(yz - wx)
    T = T.at[..., 2, 0].set(xz - wy)
    T = T.at[..., 2, 1].set(yz + wx)
    T = T.at[..., 2, 2].set(1 - (xx + yy))
    T = T.at[..., 3, 3].set(1.0)
    return T


def canonical_angles(p, n):
    """Per-point canonical-frame rotation angles (β about y, γ about z).

    The intermediate-frame construction of matlab/trans_model_scene.m:12-16
    / kernel.cu:302-327 moves reference point p to the origin and rotates its
    normal n onto +x:  T_g = Rotz(γ) · Roty(β) · Trans(−p)  with
        β = atan2(n.z, n.x)
        γ = −atan2((Roty(β)·n).y, (Roty(β)·n).x)

    With the reference's roty convention, Roty(β)·n has
      x' = cos β · n.x + sin β · n.z,   y' = n.y
    so γ = −atan2(n.y, cos β·n.x + sin β·n.z). Computed closed-form here
    (strength reduction the reference hints at in compute_rot_angles,
    kernel.cu:352-369, but still re-evaluated per vote there; we compute it
    once per point)."""
    p = jnp.asarray(p, jnp.float32)
    n = jnp.asarray(n, jnp.float32)
    beta = jnp.arctan2(n[..., 2], n[..., 0])
    xp = jnp.cos(beta) * n[..., 0] + jnp.sin(beta) * n[..., 2]
    gamma = -jnp.arctan2(n[..., 1], xp)
    return beta, gamma


def canonical_rotation(beta, gamma):
    """3x3 rotation R = Rz(γ)[:3,:3] @ Ry(β)[:3,:3] for canonical frames."""
    cb, sb = jnp.cos(beta), jnp.sin(beta)
    cg, sg = jnp.cos(gamma), jnp.sin(gamma)
    zero = jnp.zeros_like(cb)
    # Rz(γ) @ Ry(β) with the reference's roty convention (see roty()).
    row0 = jnp.stack([cg * cb, -sg, cg * sb], axis=-1)
    row1 = jnp.stack([sg * cb, cg, sg * sb], axis=-1)
    row2 = jnp.stack([-sb, zero, cb], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def canonical_transform(p, n):
    """Full 4x4 T_g = Rotz(γ)·Roty(β)·Trans(−p) (kernel.cu:310-318)."""
    beta, gamma = canonical_angles(p, n)
    R = canonical_rotation(beta, gamma)
    p = jnp.asarray(p, jnp.float32)
    t = -jnp.einsum("...ij,...j->...i", R, p, precision=_HI)
    T = jnp.zeros(beta.shape + (4, 4), jnp.float32)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def alpha_about_x(u, v):
    """Signed angle from u to v about the +x axis after projecting both onto
    the yz plane: atan2(x̂·(û×v̂), û·v̂) (matlab/trans_model_scene.m:34-39,
    kernel.cu:330-340).

    Note the reference's cross() has a typo in its z component
    (kernel.cu:86) but only the x component is consumed here, which is
    correct: (u×v).x = u.y·v.z − u.z·v.y."""
    u = jnp.asarray(u, jnp.float32)
    v = jnp.asarray(v, jnp.float32)
    cross_x = u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1]
    dot_yz = u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]
    return jnp.arctan2(cross_x, dot_yz)


def alpha_angle(p_ref, n_ref, p_other):
    """α-contribution of a point pair: the angle about x of the second point
    once the pair is moved to the canonical frame of (p_ref, n_ref).

    Key identity used throughout the rebuild: the reference's per-vote
    α = atan2((u×v).x, u·v) with u = T_m_g·m_i, v = T_s_g·s_i
    (kernel.cu:330-340) decomposes as α = wrap(α_s − α_m) where
    α_m = atan2(u.z, u.y) and α_s = atan2(v.z, v.y). We therefore compute a
    single angle per *pair* at description/preprocess time instead of two
    dense 4×4 chains per *vote* (SURVEY.md §7 'strength-reduced')."""
    beta, gamma = canonical_angles(p_ref, n_ref)
    R = canonical_rotation(beta, gamma)
    d = jnp.asarray(p_other, jnp.float32) - jnp.asarray(p_ref, jnp.float32)
    u = jnp.einsum("...ij,...j->...i", R, d, precision=_HI)
    return jnp.arctan2(u[..., 2], u[..., 1])


def wrap_angle(a):
    """Wrap to [-π, π)."""
    two_pi = jnp.float32(2.0 * jnp.pi)
    return a - two_pi * jnp.floor((a + jnp.pi) / two_pi)


def trans_model_scene(m_r, n_r_m, m_i, s_r, n_r_s, s_i):
    """Golden-path transliteration of matlab/trans_model_scene.m:1-41 /
    kernel.cu:302-349: returns (T_m_g, T_s_g, α). Used by tests to validate
    the strength-reduced α decomposition; the hot path never calls this."""
    T_m_g = canonical_transform(m_r, n_r_m)
    T_s_g = canonical_transform(s_r, n_r_s)
    u = transform_points(T_m_g, m_i)
    v = transform_points(T_s_g, s_i)
    alpha = alpha_about_x(u, v)
    return T_m_g, T_s_g, alpha


def pose_from_vote(alpha_idx, m_point, m_beta, m_gamma, s_point, s_beta,
                   s_gamma, d_angle):
    """Rebuild the 4x4 pose of a surviving vote:
    T = invht(T_s_g) · Rotx(α_idx·Δα − π) · T_m_g (kernel.cu:372-401,
    trans_calc_kernel2 kernel.cu:605-645). Fully batched."""
    alpha = alpha_idx.astype(jnp.float32) * jnp.float32(d_angle) - jnp.float32(jnp.pi)
    Rm = canonical_rotation(m_beta, m_gamma)
    Rs = canonical_rotation(s_beta, s_gamma)
    tm = -jnp.einsum("...ij,...j->...i", Rm, jnp.asarray(m_point, jnp.float32), precision=_HI)
    ts = -jnp.einsum("...ij,...j->...i", Rs, jnp.asarray(s_point, jnp.float32), precision=_HI)
    # T = [Rsᵀ s_r; 0 1] · Rotx(α) · [Rm tm; 0 1]
    ca, sa = jnp.cos(alpha), jnp.sin(alpha)
    zero = jnp.zeros_like(ca)
    one = jnp.ones_like(ca)
    Rx = jnp.stack([
        jnp.stack([one, zero, zero], axis=-1),
        jnp.stack([zero, ca, -sa], axis=-1),
        jnp.stack([zero, sa, ca], axis=-1),
    ], axis=-2)
    Rs_T = jnp.swapaxes(Rs, -1, -2)
    R = jnp.einsum("...ij,...jk,...kl->...il", Rs_T, Rx, Rm, precision=_HI)
    t = jnp.einsum("...ij,...jk,...k->...i", Rs_T, Rx, tm, precision=_HI) + jnp.asarray(
        s_point, jnp.float32)
    T = jnp.zeros(R.shape[:-2] + (4, 4), jnp.float32)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def ht_dist(a, b):
    """Homogeneous-transform distance: (‖t_a − t_b‖, |angle(R_a⁻¹ R_b)|)
    (src/cuda/linalg.cu:9-20). Batched."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    t_diff = jnp.linalg.norm(a[..., :3, 3] - b[..., :3, 3], axis=-1)
    R = jnp.einsum("...ji,...jk->...ik", a[..., :3, :3], b[..., :3, :3], precision=_HI)
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    ang = jnp.arccos(jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0))
    return t_diff, jnp.abs(ang)
