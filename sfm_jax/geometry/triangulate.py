"""Batched linear (DLT) triangulation.

Replacement for the reference's per-point 4x4 DLT systems +
``cusolverDnSgesvdjBatched`` + dehomogenize kernel
(reference SfM/sfm.cu:309-344, SfM/kernels.h:387-450): one vmapped Gram
null-vector solve over all N points, no host loop, no solver handles.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sfm_jax.ops import linalg
from sfm_jax.utils.precision import f32_matmul


def make_projection(R, t):
    """[..., 3, 4] projection P = [R | t] in normalized camera coords."""
    return jnp.concatenate([R, t[..., :, None]], axis=-1)


def dlt_system(x1, x2, P1, P2):
    """Per-point 4x4 DLT matrix (reference SfM/kernels.h:387-431).

    Args:
      x1, x2: [..., N, 3] normalized homogeneous observations.
      P1, P2: [..., 3, 4] camera projections (broadcast over N).

    Rows: x*P[2]-P[0], y*P[2]-P[1] for each view.
    """
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    r0 = x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :]
    r1 = x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :]
    r2 = x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :]
    r3 = x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]
    return jnp.stack([r0, r1, r2, r3], axis=-2)  # [..., N, 4, 4]


@functools.partial(jax.jit, static_argnames=("sweeps", "w_clamp", "solver"))
@f32_matmul
def triangulate(x1, x2, P1, P2, *, sweeps: int = 10, w_clamp: float = 5.0,
                solver: str = "jacobi"):
    """Triangulate all correspondences; returns (X [..., N, 3], w [..., N]).

    ``w`` is the homogeneous scale; points with |w| below 1/w_clamp of the
    spatial norm are near-infinite.  The reference clamps |w| > 5 outliers
    to the origin (SfM/kernels.h:433-450); we return the dehomogenized
    points plus a finite-point validity mask instead of destroying data.

    solver: "jacobi" (fixed-`sweeps` Gram Jacobi — the default) or
    "adj" (closed-form adjugate null vector).  The interleaved
    on-device A/B (tools/exp_solver_ab.py, r2) measured the geometry
    stage faster with the jacobi solvers; see ops.linalg.svd3x3.
    """
    if solver not in ("adj", "jacobi"):
        raise ValueError(f"triangulate: unknown solver {solver!r}")
    A = dlt_system(x1, x2, P1, P2)
    if solver == "adj":
        X_h = linalg.gram_nullvec4_adj(A)        # [..., N, 4] unit norm
    else:
        X_h = linalg.gram_nullvec(A, sweeps=sweeps)  # [..., N, 4] unit norm
    w = X_h[..., 3]
    denom = jnp.where(jnp.abs(w) < 1e-12, jnp.where(w < 0, -1e-12, 1e-12), w)
    X = X_h[..., :3] / denom[..., None]
    # The reference zeroes points with w == 0 or |w| > 5
    # (SfM/kernels.h:439-441); with a unit-norm homogeneous vector only
    # the w ~ 0 (point at infinity) case can occur.  `w_clamp` bounds
    # the admissible depth ratio ||xyz|| / |w| in baseline units.
    finite = jnp.abs(w) * w_clamp > jnp.linalg.norm(X_h[..., :3], axis=-1) * 1e-6
    return X, w, finite


def depths(X, R, t):
    """Depth of world points in a camera (R, t): z of R X + t."""
    return jnp.einsum("...ij,...nj->...ni", R, X)[..., 2] + t[..., None, 2]


@f32_matmul
def midpoint_depths(x1, x2, R, t):
    """Closed-form two-ray depths (z1, z2) for cheirality tests.

    Rays z1*x1 (camera 1) and C2 + z2*(R^T x2) (camera 2, center
    C2 = -R^T t) generally don't intersect; the least-squares depths
    along each ray solve the 2x2 system of the connecting segment.
    ~10 elementwise ops per point — the cheap stand-in for the full
    per-candidate DLT when only the SIGNS are needed (refine-round
    cheirality weights, two_view_geometry).  Degenerate (parallel)
    rays return ~0 depths, which fail the z>0 test — safe.

    Args: x1, x2 [N, 3] normalized homogeneous; (R, t) camera 2.
    Returns (z1 [N], z2 [N]).
    """
    b = jnp.einsum("ji,nj->ni", R, x2)        # R^T x2: ray dirs in cam 1
    C2 = -jnp.einsum("ji,j->i", R, t)
    aa = jnp.sum(x1 * x1, -1)
    bb = jnp.sum(b * b, -1)
    ab = jnp.sum(x1 * b, -1)
    ac = jnp.sum(x1 * C2, -1)
    bc = jnp.sum(b * C2, -1)
    det = aa * bb - ab * ab
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    z1 = (bb * ac - ab * bc) / det
    z2 = (ab * ac - aa * bc) / det
    return z1, z2


def reprojection_errors(X, x1, x2, R, t):
    """Squared reprojection error in both normalized image planes.

    x1 observes X from the identity camera, x2 from (R, t).
    Returns [..., N].
    """
    z1 = jnp.maximum(jnp.abs(X[..., 2]), 1e-12) * jnp.sign(
        jnp.where(X[..., 2] == 0, 1.0, X[..., 2])
    )
    p1 = X[..., :2] / z1[..., None]
    Xc = jnp.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z2 = jnp.where(jnp.abs(Xc[..., 2]) < 1e-12, 1e-12, Xc[..., 2])
    p2 = Xc[..., :2] / z2[..., None]
    e1 = jnp.sum((p1 - x1[..., :2] / x1[..., 2:3]) ** 2, axis=-1)
    e2 = jnp.sum((p2 - x2[..., :2] / x2[..., 2:3]) ** 2, axis=-1)
    return e1 + e2


@f32_matmul
def triangulate_tracks(R, t, cam_idx, pt_idx, uv_n, mask, n_points: int,
                       *, w_clamp: float = 5.0):
    """Multiview linear triangulation over a flat observation list.

    Extends the reference's strictly two-view DLT (SfM/sfm.cu:309-344)
    to arbitrary-length tracks: each observation contributes the two
    cross-product rows x_h x (R X + t) = 0 and the per-point 3x3 normal
    systems accumulate by segment-sum — one batched solve for ALL
    points, no per-track loop (scatter-add + vmapped
    solve).

    Args:
      R, t: [M, 3, 3] / [M, 3] world->camera poses.
      cam_idx, pt_idx: [O] observation incidence.
      uv_n: [O, 2] NORMALIZED image coordinates.
      mask: [O] validity.
      n_points: static point capacity P.

    Returns (X [P, 3], ok [P]) where ok requires >= 2 masked
    observations and a finite solve.
    """
    O = uv_n.shape[0]
    Rj = R[cam_idx]
    tj = t[cam_idx]
    x = jnp.concatenate([uv_n, jnp.ones((O, 1), uv_n.dtype)], axis=1)

    def rows(xh, Rc, tc):
        return (
            jnp.stack([xh[0] * Rc[2] - Rc[0], xh[1] * Rc[2] - Rc[1]]),
            jnp.stack([xh[0] * tc[2] - tc[0], xh[1] * tc[2] - tc[1]]),
        )

    Ar, br = jax.vmap(rows)(x, Rj, tj)            # [O,2,3], [O,2]
    Ar = Ar * mask.astype(uv_n.dtype)[:, None, None]
    br = br * mask.astype(uv_n.dtype)[:, None]
    AtA = jnp.zeros((n_points, 3, 3), uv_n.dtype).at[pt_idx].add(
        jnp.einsum("oki,okj->oij", Ar, Ar)
    )
    Atb = jnp.zeros((n_points, 3), uv_n.dtype).at[pt_idx].add(
        jnp.einsum("oki,ok->oi", Ar, -br)
    )
    nobs = jnp.zeros((n_points,), uv_n.dtype).at[pt_idx].add(
        mask.astype(uv_n.dtype)
    )
    X = jnp.linalg.solve(
        AtA + 1e-6 * jnp.eye(3, dtype=uv_n.dtype)[None], Atb[:, :, None]
    )[:, :, 0]
    ok = (nobs >= 2) & jnp.isfinite(X).all(axis=1)
    return jnp.where(ok[:, None], X, 0.0), ok
