"""Point-cloud preprocessing: voxel-grid downsampling, normal estimation,
diameter, downsamplers, scene centering.

Replaces the reference's CPU/PCL preprocessing layer:
  * voxelGridDownsample (alignment.cpp:79-87) and the standalone voxel_grid
    CLI (pcl/voxel_grid/voxel_grid.cpp:6-31)
  * randomDownsample / sequentialDownsample (alignment.cpp:57-76)
  * model diameter from bbox (alignment.cpp:246-257) and the MATLAB
    max-dist-from-bbox-center convention (model_description.m:5-13)
  * mesh vertex normals (matlab/compute_normals.m:1-24) and k-NN PCA
    normals (driver requirement; PCL NormalEstimation equivalent)
  * CenterScene (include/impl/scene_generation.hpp:88-103)

Unlike the reference, the voxel grid and normal estimation run **on
device** (sort + segment reductions; distance matrices as matmuls) so a raw
100k-point scene never round-trips to the host between load and match.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_HI = jax.lax.Precision.HIGHEST


class VoxelizedCloud(NamedTuple):
    """Padded, static-shape voxel-grid output.

    points/normals — (capacity, 3); rows ≥ num_voxels are padding placed at
    a far sentinel (no PPF key can match them) with zero normals.
    num_voxels   — () int32 number of real rows
    dropped      — () bool: more occupied voxels than capacity (excess
                   merged into the last row; raise capacity if set)
    """
    points: jax.Array
    normals: jax.Array
    num_voxels: jax.Array
    dropped: jax.Array


# Sentinel displacement for padding rows: far enough that any pair distance
# bin overflows max_dist_bin and maps to INVALID_KEY.
_PAD_OFFSET = 1.0e7


def voxel_downsample(points, normals, leaf, capacity: int | None = None,
                     normal_aware: bool = False) -> VoxelizedCloud:
    """Voxel-grid downsample with per-voxel centroids of points and normals
    (pcl::VoxelGrid semantics, alignment.cpp:79-87), as a static-shape JAX
    op: cell keys -> sort -> segment means.

    capacity bounds the number of output voxels (default: len(points),
    always exact).

    normal_aware=True extends the cell key with the normal OCTANT (the
    three sign bits), so geometry THINNER than the leaf — blades, shells,
    tube walls — keeps one point per SIDE instead of collapsing both sides
    into a centroid whose averaged normal cancels to noise. Plain centroid
    mode reproduces the reference exactly but silently destroys any
    structure thinner than the leaf (real scanned bones lose every match
    without this; procedural solids never notice). Costs up to ~2x output
    voxels where normals straddle an octant boundary."""
    p = jnp.asarray(points, jnp.float32)
    nr = jnp.asarray(normals, jnp.float32)
    n = p.shape[0]
    if capacity is None:
        capacity = n
    leaf = jnp.float32(leaf)

    lo = jnp.min(p, axis=0)
    cell = jnp.floor((p - lo) / leaf).astype(jnp.int32)          # (n, 3)
    dims = jnp.max(cell, axis=0) + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    if normal_aware:
        octant = ((nr[:, 0] > 0).astype(jnp.int32)
                  + 2 * (nr[:, 1] > 0).astype(jnp.int32)
                  + 4 * (nr[:, 2] > 0).astype(jnp.int32))
        key = key * 8 + octant

    order = jnp.argsort(key, stable=True)
    skey = key[order]
    sp = p[order]
    sn = nr[order]
    new_seg = jnp.concatenate([
        jnp.ones((1,), jnp.int32),
        (skey[1:] != skey[:-1]).astype(jnp.int32)])
    seg = jnp.cumsum(new_seg) - 1                                 # (n,)
    num_voxels = seg[-1] + 1
    dropped = num_voxels > capacity
    seg = jnp.minimum(seg, capacity - 1)

    ones = jnp.ones((n,), jnp.float32)
    cnt = jax.ops.segment_sum(ones, seg, num_segments=capacity)
    psum = jax.ops.segment_sum(sp, seg, num_segments=capacity)
    nsum = jax.ops.segment_sum(sn, seg, num_segments=capacity)
    denom = jnp.where(cnt > 0, cnt, 1.0)[:, None]
    cent = psum / denom
    nmean = nsum / denom

    valid = (jnp.arange(capacity) < num_voxels)
    pad = lo - _PAD_OFFSET
    out_p = jnp.where(valid[:, None], cent, pad)
    out_n = jnp.where(valid[:, None], nmean, 0.0)
    return VoxelizedCloud(points=out_p, normals=out_n,
                          num_voxels=num_voxels, dropped=dropped)


def voxel_downsample_np(points, normals, leaf, normal_aware: bool = False):
    """Host-side exact voxel grid (dynamic output size) for CLI paths.
    normal_aware: see `voxel_downsample` — octant-extended keys preserve
    sub-leaf thin structure (both sides of blades/shells)."""
    p = np.asarray(points, np.float64)
    nr = np.asarray(normals, np.float64) if normals is not None else None
    lo = p.min(axis=0)
    cell = np.floor((p - lo) / leaf).astype(np.int64)
    dims = cell.max(axis=0) + 1
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    if normal_aware:
        if nr is None:
            raise ValueError("normal_aware downsampling requires normals")
        octant = ((nr[:, 0] > 0).astype(np.int64)
                  + 2 * (nr[:, 1] > 0).astype(np.int64)
                  + 4 * (nr[:, 2] > 0).astype(np.int64))
        key = key * 8 + octant
    order = np.argsort(key, kind="stable")
    skey = key[order]
    uniq, start, cnt = np.unique(skey, return_index=True, return_counts=True)
    out_p = np.add.reduceat(p[order], start, axis=0) / cnt[:, None]
    out_n = None
    if nr is not None:
        out_n = np.add.reduceat(nr[order], start, axis=0) / cnt[:, None]
        out_n = out_n.astype(np.float32)
    return out_p.astype(np.float32), out_n


def random_downsample(points, normals, fraction, seed=0):
    """Keep ⌊fraction·n⌋ random points (alignment.cpp:57-64)."""
    n = np.asarray(points).shape[0]
    k = int(fraction * n)
    idx = np.random.default_rng(seed).permutation(n)[:k]
    nrm = None if normals is None else np.asarray(normals)[idx]
    return np.asarray(points)[idx], nrm


def sequential_downsample(points, normals, step: int):
    """Keep every step-th point (alignment.cpp:67-76; MATLAB drost.m
    stride)."""
    nrm = None if normals is None else np.asarray(normals)[::step]
    return np.asarray(points)[::step], nrm


def bbox_diameter(points) -> float:
    """Max bbox edge — the CLI's cheap model-diameter estimate
    (alignment.cpp:246-253: 'approximate it with the max difference between
    coords')."""
    p = np.asarray(points)
    return float((p.max(axis=0) - p.min(axis=0)).max())


def bbox_center_radius(points) -> float:
    """Max distance from the bbox center — the MATLAB diameter convention
    (model_description.m:5-13); d_dist = 0.1 · this."""
    p = np.asarray(points, np.float64)
    center = (p.min(axis=0) + p.max(axis=0)) / 2
    return float(np.linalg.norm(p - center, axis=1).max())


def center_scene(points, offset=1.0):
    """Translate so the centroid sits at (offset, offset, offset) — the
    reference moves scenes into the positive octant because 'Having the
    scene be in a different octant breaks things'
    (scene_generation.hpp:88-103). Returns (points, T_applied)."""
    p = np.asarray(points, np.float32)
    c = p.mean(axis=0)
    shift = -c + offset
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = shift
    return p + shift, T


def _smallest_eigvec_sym3(cov):
    """Unit eigenvector of the SMALLEST eigenvalue of each symmetric 3×3 —
    closed form (trigonometric eigenvalues + cross-product eigenvector,
    Eberly's robust recipe), fully vectorized.

    Replaces jnp.linalg.eigh's batched QR iteration with a fixed,
    branch-free formula over the batch. Accuracy is ample for
    surface normals: the relevant eigengap (surface-tangent vs normal
    variance) is large wherever a normal is meaningful; near-isotropic
    neighborhoods fall back to +z.

    cov: (n, 3, 3) float32 symmetric. Returns (n, 3) unit vectors."""
    eye = jnp.eye(3, dtype=jnp.float32)
    q = jnp.trace(cov, axis1=-2, axis2=-1) / 3.0
    B = cov - q[:, None, None] * eye
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    Bn = B / p[:, None, None]
    half_det = jnp.linalg.det(Bn) / 2.0
    phi = jnp.arccos(jnp.clip(half_det, -1.0, 1.0)) / 3.0
    lam_min = q + 2.0 * p * jnp.cos(phi + jnp.float32(2.0 * np.pi / 3.0))

    M = cov - lam_min[:, None, None] * eye
    c0 = jnp.cross(M[:, 0], M[:, 1])
    c1 = jnp.cross(M[:, 0], M[:, 2])
    c2 = jnp.cross(M[:, 1], M[:, 2])
    n0 = jnp.sum(c0 * c0, axis=-1)
    n1 = jnp.sum(c1 * c1, axis=-1)
    n2 = jnp.sum(c2 * c2, axis=-1)
    best = jnp.where((n1 >= n0)[:, None] & (n1 >= n2)[:, None], c1,
                     jnp.where((n2 >= n0)[:, None], c2, c0))
    nbest = jnp.maximum(n0, jnp.maximum(n1, n2))
    nrm = jnp.linalg.norm(best, axis=-1, keepdims=True)
    unit = best / jnp.maximum(nrm, 1e-30)
    # Degenerate (isotropic / zero) neighborhoods: fall back to +z.
    fallback = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                                unit.shape)
    ok = (nbest > 1e-20) & (p2 > 1e-24)
    return jnp.where(ok[:, None], unit, fallback)


def estimate_normals_knn(points, k: int = 16, viewpoint=(0.0, 0.0, 0.0),
                         orient: str = "viewpoint"):
    """k-NN PCA surface normals.

    The n×n distance matrix is one matmul (‖a−b‖² =
    ‖a‖²+‖b‖²−2a·b), top_k picks neighborhoods, covariances are batched
    3×3 eigenproblems. For each point the normal is the eigenvector of the
    neighborhood covariance with the smallest eigenvalue (the PCL
    NormalEstimation algorithm the reference relies on upstream of its PLY
    inputs; normals feed compute_ppf, kernel.cu:109-122).

    orient:
      'viewpoint' — flip toward `viewpoint` (sensor position; PCL default).
        Correct for range scans where every surface faces the sensor.
      'outward'   — flip away from the cloud centroid. Correct for closed,
        roughly star-convex objects (matches mesh outward normals; PPF
        matching needs the *same* orientation convention on model and
        scene or back-facing votes cancel).
    """
    p = jnp.asarray(points, jnp.float32)
    n = p.shape[0]
    k = min(k, n)
    sq = jnp.sum(p * p, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * jnp.dot(
        p, p.T, preferred_element_type=jnp.float32, precision=_HI)
    # top_k of negative distance = k nearest (self included).
    _, idx = jax.lax.top_k(-d2, k)                                # (n, k)
    nbrs = p[idx]                                                 # (n, k, 3)
    mean = jnp.mean(nbrs, axis=1, keepdims=True)
    centered = nbrs - mean
    cov = jnp.einsum("nki,nkj->nij", centered, centered,
                     precision=_HI) / k
    # Smallest-eigenvalue eigenvector of each symmetric 3x3 (closed form,
    # see _smallest_eigvec_sym3).
    normal = _smallest_eigvec_sym3(cov)                           # (n, 3)
    if orient == "outward":
        ref_dir = p - jnp.mean(p, axis=0)
    else:
        ref_dir = jnp.asarray(viewpoint, jnp.float32) - p
    flip = jnp.sum(normal * ref_dir, axis=-1) < 0
    return jnp.where(flip[:, None], -normal, normal)


def _box3(x):
    """27-cell box sum over the leading three (grid) axes of x via three
    separable width-3 passes — pure dense adds, no gathers."""
    for ax in range(3):
        lo = jnp.roll(x, 1, axis=ax).at[(slice(None),) * ax + (0,)].set(0.0)
        hi = jnp.roll(x, -1, axis=ax).at[(slice(None),) * ax + (-1,)].set(0.0)
        x = x + lo + hi
    return x


def estimate_normals_grid(points, radius, viewpoint=(0.0, 0.0, 0.0),
                          orient: str = "viewpoint", dims=None,
                          box_filter: bool = True):
    """Scalable surface-normal estimation for large raw scans.

    `estimate_normals_knn` materializes the n×n distance matrix — 4×10¹⁰
    bytes at the benchmark's 100 k raw points. This variant is O(n + grid):
    bucket points into a voxel grid at leaf = radius, accumulate per-cell
    first/second moments with one segment_sum, box-filter the moment grid
    over the 27-cell neighborhood with three separable width-3 passes
    (dense adds — no gathers), then read each point's neighborhood
    statistics back with ONE row gather and solve the batched 3×3
    eigenproblem. The neighborhood is the cube [−r, 2r]³ around the point's
    cell instead of the exact k-NN ball; for normal estimation (smallest
    principal axis of a locally planar patch) the two are equivalent in
    practice — cross-validated against estimate_normals_knn in
    tests/test_utils.py.

    Same role as PCL NormalEstimation (the reference's upstream dependency
    for its PLY inputs, SURVEY.md §7 step 2); orient semantics match
    estimate_normals_knn.

    Args:
      points: (n, 3). radius: neighborhood scale (voxel leaf).
      dims: optional static (dx, dy, dz) grid shape; computed from the
        cloud's bbox on the host when omitted (requires concrete points).
      box_filter: True = 27-cell neighborhood (window ~3·radius; right for
        noisy scans of smooth surfaces). False = the point's OWN cell only
        (window ~radius) — use for CURVED surfaces whose feature wavelength
        is within a few radii: the wide box window biases PCA normals by
        10-20° there (measured on the bench blobs), which scrambles the
        12° PPF angle bins.
    """
    p_np = None
    if dims is None:
        p_np = np.asarray(points, np.float32)
        lo_h = p_np.min(axis=0)
        hi_h = p_np.max(axis=0)
        dims = tuple(int(d) + 1 for d in
                     np.floor((hi_h - lo_h) / float(radius)).astype(np.int64))
    dx, dy, dz = dims
    n_cells = dx * dy * dz

    p = jnp.asarray(points, jnp.float32)
    n = p.shape[0]
    lo = jnp.min(p, axis=0)
    cell = jnp.clip(jnp.floor((p - lo) / jnp.float32(radius)).astype(
        jnp.int32), 0, jnp.asarray([dx - 1, dy - 1, dz - 1]))
    key = (cell[:, 0] * dy + cell[:, 1]) * dz + cell[:, 2]

    # Per-cell moments: [1, x, y, z, xx, yy, zz, xy, xz, yz] (10 channels).
    mom = jnp.concatenate([
        jnp.ones((n, 1), jnp.float32), p,
        p * p, p[:, [0, 0, 1]] * p[:, [1, 2, 2]]], axis=1)    # (n, 10)
    grid = jax.ops.segment_sum(mom, key, num_segments=n_cells)
    if box_filter:
        grid = _box3(grid.reshape(dx, dy, dz, 10)).reshape(n_cells, 10)

    s = jnp.take(grid, key, axis=0)                            # (n, 10) ONE row gather
    cnt = jnp.maximum(s[:, 0], 1.0)[:, None]
    mu = s[:, 1:4] / cnt
    exx = s[:, 4:7] / cnt
    exy = s[:, 7:10] / cnt
    # cov = E[ppᵀ] − μμᵀ (neighborhood covariance about the box mean).
    cov = jnp.zeros((n, 3, 3), jnp.float32)
    cov = cov.at[:, 0, 0].set(exx[:, 0] - mu[:, 0] * mu[:, 0])
    cov = cov.at[:, 1, 1].set(exx[:, 1] - mu[:, 1] * mu[:, 1])
    cov = cov.at[:, 2, 2].set(exx[:, 2] - mu[:, 2] * mu[:, 2])
    cov = cov.at[:, 0, 1].set(exy[:, 0] - mu[:, 0] * mu[:, 1])
    cov = cov.at[:, 0, 2].set(exy[:, 1] - mu[:, 0] * mu[:, 2])
    cov = cov.at[:, 1, 2].set(exy[:, 2] - mu[:, 1] * mu[:, 2])
    cov = cov.at[:, 1, 0].set(cov[:, 0, 1])
    cov = cov.at[:, 2, 0].set(cov[:, 0, 2])
    cov = cov.at[:, 2, 1].set(cov[:, 1, 2])

    normal = _smallest_eigvec_sym3(cov)
    if orient == "outward":
        ref_dir = p - jnp.mean(p, axis=0)
    else:
        ref_dir = jnp.asarray(viewpoint, jnp.float32) - p
    flip = jnp.sum(normal * ref_dir, axis=-1) < 0
    return jnp.where(flip[:, None], -normal, normal)


def smooth_normals_grid(points, normals, radius, dims=None,
                        iterations: int = 1, order: int = 0,
                        ridge: float = 0.05):
    """Smooth a noisy normal FIELD over the 27-cell grid neighborhood
    (leaf = radius) — same O(n + grid) machinery as estimate_normals_grid,
    but smoothing GIVEN normals instead of re-deriving them from point
    positions, so the input's orientation convention is preserved (each
    output normal is sign-aligned with its input).

    order=0 — plain box average. Shrinks iid angular noise by ~1/√k, but
    on curved surfaces the window mean is BIASED toward the window's mean
    orientation (~5° at radius ≈ leaf on bench-blob curvature — measured
    in EVAL.md). Hough voting averages zero-mean noise but not coherent
    bias, so at σ = 0.5·leaf this variant measurably HURTS unrefined
    recognition (EVAL.md "Normal smoothing at σ = 0.5").

    order=1 — first-order (moving-least-squares) fit: regress the normal
    field linearly on position over the window, n(x) ≈ a + Bᵀ(x − c), and
    EVALUATE AT THE QUERY POINT. The linear term absorbs the first-order
    curvature variation, cancelling the window bias that order=0 pays
    while keeping the same variance reduction. Costs one 22-channel
    moment grid (vs 3) and a ridge-regularized 3×3 solve per point.

    Args:
      points: (n, 3). normals: (n, 3) noisy unit normals.
      radius: grid leaf (smoothing scale).
      dims: optional static grid shape (see estimate_normals_grid).
      iterations: smoothing passes (each widens the kernel by ~one cell).
      order: 0 = box mean, 1 = linear MLS fit (bias-corrected).
      ridge: order=1 regularizer as a fraction of mean(trace(Cxx)) — a
        planar window's position covariance is rank-2, so the solve needs
        damping along the normal direction; the correction there is noise
        anyway (the normal field has no real gradient through the
        surface).
    """
    p_np = None
    if dims is None:
        p_np = np.asarray(points, np.float32)
        lo_h = p_np.min(axis=0)
        hi_h = p_np.max(axis=0)
        dims = tuple(int(d) + 1 for d in
                     np.floor((hi_h - lo_h) / float(radius)).astype(np.int64))
    dx, dy, dz = dims
    n_cells = dx * dy * dz

    p = jnp.asarray(points, jnp.float32)
    nr = jnp.asarray(normals, jnp.float32)
    lo = jnp.min(p, axis=0)
    cell = jnp.clip(jnp.floor((p - lo) / jnp.float32(radius)).astype(
        jnp.int32), 0, jnp.asarray([dx - 1, dy - 1, dz - 1]))
    key = (cell[:, 0] * dy + cell[:, 1]) * dz + cell[:, 2]
    # Window-relative coordinates (subtract the cloud mean) keep the f32
    # second moments small regardless of where the scan sits in space.
    pc_rel = p - jnp.mean(p, axis=0)

    out = nr
    for _ in range(iterations):
        if order == 0:
            grid = jax.ops.segment_sum(out, key, num_segments=n_cells)
            grid = _box3(grid.reshape(dx, dy, dz, 3)).reshape(n_cells, 3)
            s = jnp.take(grid, key, axis=0)               # (n, 3) row gather
        else:
            # Moments: [1, x(3), n(3), xxᵀ(6 sym), x⊗n(9)] = 22 channels.
            x = pc_rel
            mom = jnp.concatenate([
                jnp.ones((x.shape[0], 1), jnp.float32), x, out,
                x * x, x[:, [0, 0, 1]] * x[:, [1, 2, 2]],
                (x[:, :, None] * out[:, None, :]).reshape(-1, 9)
            ], axis=1)                                    # (n, 22)
            grid = jax.ops.segment_sum(mom, key, num_segments=n_cells)
            grid = _box3(grid.reshape(dx, dy, dz, 22)).reshape(n_cells, 22)
            s22 = jnp.take(grid, key, axis=0)             # (n, 22) row gather
            cnt = jnp.maximum(s22[:, 0], 1.0)[:, None]
            c = s22[:, 1:4] / cnt                         # window centroid
            nbar = s22[:, 4:7] / cnt                      # window mean normal
            exx = s22[:, 7:10] / cnt
            exy = s22[:, 10:13] / cnt                     # xy, xz, yz
            exn = s22[:, 13:22].reshape(-1, 3, 3) / cnt[:, :, None]
            cxx = jnp.zeros((x.shape[0], 3, 3), jnp.float32)
            cxx = cxx.at[:, 0, 0].set(exx[:, 0] - c[:, 0] * c[:, 0])
            cxx = cxx.at[:, 1, 1].set(exx[:, 1] - c[:, 1] * c[:, 1])
            cxx = cxx.at[:, 2, 2].set(exx[:, 2] - c[:, 2] * c[:, 2])
            cxx = cxx.at[:, 0, 1].set(exy[:, 0] - c[:, 0] * c[:, 1])
            cxx = cxx.at[:, 0, 2].set(exy[:, 1] - c[:, 0] * c[:, 2])
            cxx = cxx.at[:, 1, 2].set(exy[:, 2] - c[:, 1] * c[:, 2])
            cxx = cxx.at[:, 1, 0].set(cxx[:, 0, 1])
            cxx = cxx.at[:, 2, 0].set(cxx[:, 0, 2])
            cxx = cxx.at[:, 2, 1].set(cxx[:, 1, 2])
            cxn = exn - c[:, :, None] * nbar[:, None, :]  # Cov(x, n) (3,3)
            tr = (cxx[:, 0, 0] + cxx[:, 1, 1] + cxx[:, 2, 2]) / 3.0
            lam = (jnp.float32(ridge) * tr + 1e-12)[:, None, None]
            A = cxx + lam * jnp.eye(3, dtype=jnp.float32)
            # B = A⁻¹ Cxn; n(p) = n̄ + Bᵀ (p − c). Batched 3×3 solve.
            B = jnp.linalg.solve(A, cxn)                  # (n, 3, 3)
            d = (pc_rel - c)[:, :, None]                  # (n, 3, 1)
            s = nbar + jnp.sum(B * d, axis=1)             # (n, 3)
            # Single-point / degenerate windows: fall back to the mean.
            s = jnp.where((cnt > 3.0) & (tr[:, None] > 1e-20), s, nbar)
        norm = jnp.linalg.norm(s, axis=1, keepdims=True)
        sm = s / jnp.where(norm > 1e-12, norm, 1.0)
        # Keep each point's hemisphere; a degenerate (cancelled) average
        # falls back to the input normal.
        flip = jnp.sum(sm * out, axis=-1, keepdims=True) < 0
        sm = jnp.where(flip, -sm, sm)
        out = jnp.where(norm > 1e-6, sm, out)
    return out


def mesh_vertex_normals(points, faces):
    """Area-weighted vertex normals from a triangle mesh — the MATLAB
    offline path (compute_normals.m: triangulation vertexNormal)."""
    p = np.asarray(points, np.float64)
    f = np.asarray(faces, np.int64)
    v0, v1, v2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)        # area-weighted face normals
    out = np.zeros_like(p)
    for c in range(3):
        np.add.at(out, f[:, c], fn)
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    out = out / np.where(norms > 0, norms, 1.0)
    return out.astype(np.float32)


def sample_mesh_surface(points, faces, n, rng):
    """Uniform area-weighted point sampling of a triangle mesh surface.

    Raw mesh VERTICES are a bad stand-in for a scan: decimated assets
    concentrate vertices at high-curvature features, so flat regions are
    underrepresented and a d_dist voxel filter can leave a handful of
    description points (a 848-vertex humerus filtered to 48). Sampling
    ∝ triangle area reproduces the uniform surface coverage of a real
    range scan — the form the reference's PLY inputs actually have
    (scanner output, alignment.cpp:212).

    Normals are barycentrically interpolated vertex normals
    (`mesh_vertex_normals`), renormalized.

    Returns (points (n, 3) float32, normals (n, 3) float32).
    """
    p = np.asarray(points, np.float64)
    f = np.asarray(faces, np.int64)
    vn = mesh_vertex_normals(p, f).astype(np.float64)
    v0, v1, v2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    w = area / area.sum()
    tri = rng.choice(len(f), size=n, p=w)
    # Uniform barycentric coordinates via the square-root trick.
    r1 = np.sqrt(rng.uniform(size=n))
    r2 = rng.uniform(size=n)
    b0, b1, b2 = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
    fi = f[tri]
    pts = (b0[:, None] * p[fi[:, 0]] + b1[:, None] * p[fi[:, 1]]
           + b2[:, None] * p[fi[:, 2]])
    nrm = (b0[:, None] * vn[fi[:, 0]] + b1[:, None] * vn[fi[:, 1]]
           + b2[:, None] * vn[fi[:, 2]])
    norms = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.where(norms > 1e-12, norms, 1.0)
    return pts.astype(np.float32), nrm.astype(np.float32)


def write_trans_adj(path, T) -> None:
    """Write the translation-adjustment sidecar the MATLAB preprocessing
    emits next to each PLY (compute_trans_adj.m:1-16,
    compute_normals.m:17-22): the 4x4 transform that was applied to move
    the cloud into its stored frame."""
    import numpy as _np
    T = _np.asarray(T, _np.float32)
    with open(path, "w") as f:
        for row in T:
            f.write(" ".join(f"{v:.9g}" for v in row) + "\n")


def read_trans_adj(path):
    import numpy as _np
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(x) for x in line.split())
    return _np.asarray(vals[:16], _np.float32).reshape(4, 4)
