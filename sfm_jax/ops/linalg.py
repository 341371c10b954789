"""Batched small-matrix linear algebra for an accelerator.

Replacement for the reference's cuSOLVER batched Jacobi SVD
(``cusolverDnSgesvdjBatched``, reference SfM/kernels.h:175-234) and the
handwritten branch-free 3x3 device SVD (reference SfM/svd.h:311-335).

Design: instead of per-matrix iterative solvers with data-dependent
convergence, we run a *fixed-sweep cyclic Jacobi eigendecomposition*,
fully vectorized over the batch dimension.  Every rotation step is a
handful of fused element-wise ops over ``[B, n]`` slices — pure VPU work,
no host round trips, no dynamic shapes, trivially vmappable/shardable.
For the tiny n here (3/4/9) a fixed sweep count converges to f32
round-off.

The null-space extraction the SfM pipeline actually needs (smallest
right-singular vector of A) is computed as the smallest eigenvector of
the Gram matrix A^T A — an [n, n] symmetric eigenproblem, which avoids
ever forming U for the 8x9 systems.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from sfm_jax.utils.precision import f32_matmul

__all__ = [
    "jacobi_eigh",
    "smallest_eigvec",
    "gram_nullvec",
    "svd3x3",
    "project_to_essential",
    "so3_project",
    "cross_matrix",
]


def _jacobi_rotation(app, aqq, apq):
    """Batched symmetric Jacobi rotation angle: returns (c, s).

    Branch-free: where |apq| is negligible we emit the identity rotation.
    """
    small = jnp.abs(apq) <= 1e-36
    apq_safe = jnp.where(small, 1.0, apq)
    tau = (aqq - app) / (2.0 * apq_safe)
    # t = sign(tau) / (|tau| + sqrt(1 + tau^2))  (the smaller root)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    # sign(0) == 0 would zero the rotation; pick +1 there.
    t = jnp.where(tau == 0.0, 1.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c = jnp.where(small, 1.0, c)
    s = jnp.where(small, 0.0, s)
    return c, s


@functools.partial(jax.jit, static_argnames=("sweeps", "sort"))
@f32_matmul
def jacobi_eigh(A, *, sweeps: int = 10, sort: bool = True):
    """Eigendecomposition of batched symmetric matrices via cyclic Jacobi.

    Args:
      A: ``[..., n, n]`` symmetric (only used symmetrically).
      sweeps: fixed number of full cyclic sweeps (unrolled at trace time).
      sort: sort eigenvalues ascending (with matching eigenvectors).

    Returns:
      (w, V): eigenvalues ``[..., n]`` and eigenvectors ``[..., n, n]``
      (columns), such that ``A @ V[..., :, k] ≈ w[..., k] * V[..., :, k]``.
    """
    n = A.shape[-1]
    dt = A.dtype
    A = 0.5 * (A + jnp.swapaxes(A, -1, -2))
    V = jnp.broadcast_to(jnp.eye(n, dtype=dt), A.shape)

    def one_sweep(_, carry):
        A, V = carry
        # Pair order is static, so all indexing is static slices — XLA
        # fuses each rotation into a few VPU ops.  Only the sweep loop is
        # rolled (lax.fori_loop) to keep compile time bounded.
        for p in range(n - 1):
            for q in range(p + 1, n):
                c, s = _jacobi_rotation(
                    A[..., p, p], A[..., q, q], A[..., p, q]
                )
                c_ = c[..., None]
                s_ = s[..., None]
                # Column update: A <- A J  (J rotates columns p,q)
                col_p = A[..., :, p]
                col_q = A[..., :, q]
                A = A.at[..., :, p].set(c_ * col_p - s_ * col_q)
                A = A.at[..., :, q].set(s_ * col_p + c_ * col_q)
                # Row update: A <- J^T A
                row_p = A[..., p, :]
                row_q = A[..., q, :]
                A = A.at[..., p, :].set(c_ * row_p - s_ * row_q)
                A = A.at[..., q, :].set(s_ * row_p + c_ * row_q)
                # Accumulate eigenvectors: V <- V J
                v_p = V[..., :, p]
                v_q = V[..., :, q]
                V = V.at[..., :, p].set(c_ * v_p - s_ * v_q)
                V = V.at[..., :, q].set(s_ * v_p + c_ * v_q)
        return A, V

    A, V = jax.lax.fori_loop(0, sweeps, one_sweep, (A, V))

    w = jnp.diagonal(A, axis1=-2, axis2=-1)
    if sort:
        order = jnp.argsort(w, axis=-1)
        w = jnp.take_along_axis(w, order, axis=-1)
        V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w, V


def smallest_eigvec(A, *, sweeps: int = 10):
    """Unit eigenvector of the smallest eigenvalue of symmetric ``A``.

    Returns ``[..., n]``.
    """
    w, V = jacobi_eigh(A, sweeps=sweeps, sort=False)
    idx = jnp.argmin(w, axis=-1)
    v = jnp.take_along_axis(V, idx[..., None, None], axis=-1)[..., 0]
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def gram_nullvec(A, *, sweeps: int = 10):
    """Approximate null vector of ``A`` ([..., m, n], m >= n-1).

    Smallest right-singular vector, computed as the smallest eigenvector
    of the Gram matrix A^T A.  Replaces the reference's batched 8x9 SVD
    (reference SfM/kernels.h:211-234) where only the last row of V^T is
    consumed (reference SfM/kernels.h:452-458).
    """
    G = jnp.einsum("...mi,...mj->...ij", A, A)
    return smallest_eigvec(G, sweeps=sweeps)


def _minor3(G, rs, cs):
    return _det3(
        jnp.stack(
            [jnp.stack([G[..., r, c] for c in cs], axis=-1) for r in rs],
            axis=-2,
        )
    )


def gram_nullvec4_adj(A):
    """Null vector of [..., m, 4] systems via the ADJUGATE of G = A^T A.

    adj(G) = det(G) G^{-1} = sum_i (prod_{j!=i} lam_j) v_i v_i^T is
    dominated by the smallest-eigenvalue term with relative mixing
    ~ (lam_4/lam_3) = (sigma_4/sigma_3)^2, so its strongest column IS
    the null direction — ~150 fully parallel flops (16 cofactor 3x3
    dets) instead of the 10-sweep Jacobi chain of `gram_nullvec`
    (~60 sequential rotations).  Intended for the DLT triangulation
    systems (reference SfM/sfm.cu:309-344) whose rows are O(1)-scaled;
    degenerate lam_3 ~ lam_4 inputs (points at infinity, zero baseline)
    return an arbitrary direction inside the near-null subspace exactly
    like an f32 SVD would, and are filtered by the callers' validity
    masks.  Zero/invalid systems fall back to e3 (w-axis), which
    dehomogenizes to the origin.
    """
    G = jnp.einsum("...mi,...mj->...ij", A, A)
    # Scale-invariance: cofactors are cubic in G's entries (~||A||^6),
    # which overflows f32 for row scales >= ~1e3 and underflows the
    # fallback threshold below ~1e-3.  Normalize by the largest diagonal
    # entry (= largest column norm^2, >= any |off-diagonal| by
    # Cauchy-Schwarz); the null vector is normalized at the end, so the
    # scaling cancels exactly.
    d0 = jnp.max(jnp.diagonal(G, axis1=-2, axis2=-1), axis=-1)
    s = jnp.where(d0 > 1e-30, d0, 1.0)[..., None, None]
    G = G / s
    idx = (0, 1, 2, 3)
    cols = []
    for j in range(4):
        rs = tuple(r for r in idx if r != j)
        col = []
        for i in range(4):
            cs = tuple(c for c in idx if c != i)
            col.append(((-1.0) ** (i + j)) * _minor3(G, rs, cs))
        cols.append(jnp.stack(col, axis=-1))  # adj(G)[:, j] (G symmetric)
    adj = jnp.stack(cols, axis=-1)                     # [..., 4, 4]
    d = jnp.diagonal(adj, axis1=-2, axis2=-1)          # c * v4_i^2
    j = jnp.argmax(d, axis=-1)
    v = jnp.take_along_axis(adj, j[..., None, None], axis=-1)[..., 0]
    n2 = jnp.sum(v * v, axis=-1)
    ok = (n2 > 1e-36)[..., None]
    den = jnp.sqrt(jnp.where(n2 > 1e-36, n2, 1.0))[..., None]
    fb = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0, 1.0], A.dtype), v.shape)
    return jnp.where(ok, v / den, fb)


@f32_matmul
def smallest_eigvec_power(G, *, iters: int = 5):
    """Smallest eigenvector of symmetric PSD ``[..., n, n]`` matrices via
    ridge inverse iteration.

    The fixed-sweep Jacobi unrolls to ~sweeps * n(n-1)/2 * ~20
    sequential tiny ops (latency-bound even when batched); this
    is `iters` batched n x n solves.  Convergence ratio
    (lam_min + eps)/(lam_2 + eps) is tiny for the near-null-space
    systems it serves (all-inlier least-squares polish, DLT hypothesis
    banks).
    """
    n = G.shape[-1]
    eps = (jnp.trace(G, axis1=-2, axis2=-1) / n * 1e-7 + 1e-20)[
        ..., None, None
    ]
    A = G + eps * jnp.eye(n, dtype=G.dtype)
    v0 = jnp.ones(G.shape[:-1], G.dtype) / jnp.sqrt(jnp.asarray(n, G.dtype))

    def body(v, _):
        w = jnp.linalg.solve(A, v[..., None])[..., 0]
        nw = jnp.linalg.norm(w, axis=-1, keepdims=True)
        return w / jnp.maximum(nw, 1e-30), None

    v, _ = jax.lax.scan(body, v0, None, length=iters)
    return v


def _det3(B):
    return (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )


def _unit(v, eps=1e-20):
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def _eigvec_for(A, lam):
    """Eigenvector of symmetric A for eigenvalue lam via the largest
    cross product of rows of (A - lam I) — accurate when lam is the
    best-separated eigenvalue (the caller anchors on it)."""
    M = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    c0 = jnp.cross(M[..., 0, :], M[..., 1, :])
    c1 = jnp.cross(M[..., 0, :], M[..., 2, :])
    c2 = jnp.cross(M[..., 1, :], M[..., 2, :])
    n0 = jnp.sum(c0 * c0, axis=-1)
    n1 = jnp.sum(c1 * c1, axis=-1)
    n2 = jnp.sum(c2 * c2, axis=-1)
    c01 = jnp.where((n0 >= n1)[..., None], c0, c1)
    n01 = jnp.maximum(n0, n1)
    c = jnp.where((n01 >= n2)[..., None], c01, c2)
    n = jnp.maximum(n01, n2)
    # Normalize EXACTLY by the selected norm (an eps-clamped norm would
    # return a non-unit vector when n underflows, poisoning the Rayleigh
    # quotients downstream); near-zero cross products (isotropic A) fall
    # back to a canonical axis — any unit vector is an eigenvector there.
    ok = (n > 1e-36)[..., None]
    den = jnp.sqrt(jnp.where(n > 1e-36, n, 1.0))[..., None]
    fb = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], A.dtype), c.shape)
    return jnp.where(ok, c / den, fb)


def eigh3x3(A):
    """Closed-form eigendecomposition of batched SYMMETRIC 3x3 matrices.

    Returns (w ascending [..., 3], V [..., 3, 3] orthonormal columns).

    Replaces the fixed-sweep Jacobi for the n == 3 case: the Jacobi
    chain (sweeps x 3 rotations x ~20 ops) is sequential and dominates
    the latency of single-matrix decompositions; this is ~50
    fully-parallel ops (Cardano eigenvalues + one anchored cross-product
    eigenvector + a closed-form 2x2 rotation in its orthogonal
    complement).  Anchoring on the best-separated extreme eigenvalue and
    building the remaining pair from the exact 2x2 complement problem
    keeps the reconstruction stable even for (near-)degenerate pairs —
    exactly the essential-matrix case s ~ (1, 1, 0).
    """
    A = 0.5 * (A + jnp.swapaxes(A, -1, -2))
    dt = A.dtype
    # Scale-invariance: the eigenvector cross products are quadratic in
    # A (norms quartic), overflowing f32 for ||A|| >= ~1e9 and
    # denormalizing below ~1e-18.  Normalize by the largest |entry| and
    # scale the eigenvalues back at the end (eigenvectors are
    # scale-free).
    amax = jnp.max(jnp.abs(A), axis=(-2, -1))
    ascale = jnp.where(amax > 1e-30, amax, 1.0)
    A = A / ascale[..., None, None]
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    d0 = A[..., 0, 0] - q
    d1 = A[..., 1, 1] - q
    d2 = A[..., 2, 2] - q
    off2 = (
        A[..., 0, 1] ** 2 + A[..., 0, 2] ** 2 + A[..., 1, 2] ** 2
    )
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * off2
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    scale = jnp.where(p > 1e-30, p, 1.0)
    B = (A - q[..., None, None] * jnp.eye(3, dtype=dt)) / scale[..., None, None]
    r = jnp.clip(_det3(B) / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    two_pi_3 = jnp.asarray(2.0 * jnp.pi / 3.0, dt)
    lmax = q + 2.0 * p * jnp.cos(phi)
    lmin = q + 2.0 * p * jnp.cos(phi + two_pi_3)
    lmid = 3.0 * q - lmax - lmin

    # Anchor the cross-product eigenvector on the better-separated
    # extreme; the other two come from the 2x2 complement problem.
    use_max = (lmax - lmid) >= (lmid - lmin)
    v_anchor = _eigvec_for(A, jnp.where(use_max, lmax, lmin))

    # Orthonormal basis {u, w} of the complement of v_anchor.
    ax = jnp.abs(v_anchor[..., 0])
    ref = jnp.where(
        (ax < 0.9)[..., None],
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], dt), v_anchor.shape),
        jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0], dt), v_anchor.shape),
    )
    u = _unit(jnp.cross(v_anchor, ref))
    w = jnp.cross(v_anchor, u)
    Au = jnp.einsum("...ij,...j->...i", A, u)
    Aw = jnp.einsum("...ij,...j->...i", A, w)
    s00 = jnp.sum(u * Au, axis=-1)
    s01 = jnp.sum(u * Aw, axis=-1)
    s11 = jnp.sum(w * Aw, axis=-1)
    theta = 0.5 * jnp.arctan2(2.0 * s01, s00 - s11)
    c = jnp.cos(theta)
    s = jnp.sin(theta)
    e0 = c[..., None] * u + s[..., None] * w
    e1 = -s[..., None] * u + c[..., None] * w
    mu0 = s00 * c * c + 2.0 * s01 * c * s + s11 * s * s
    mu1 = s00 * s * s - 2.0 * s01 * c * s + s11 * c * c
    swap = mu0 > mu1
    e_lo = jnp.where(swap[..., None], e1, e0)
    e_hi = jnp.where(swap[..., None], e0, e1)

    mu_lo = jnp.where(swap, mu1, mu0)
    mu_hi = jnp.where(swap, mu0, mu1)

    # Column order ascending: anchor==max -> (e_lo, e_hi, v_anchor);
    # anchor==min -> (v_anchor, e_lo, e_hi).
    um = use_max[..., None]
    v0 = jnp.where(um, e_lo, v_anchor)
    v1 = jnp.where(um, e_hi, e_lo)
    v2 = jnp.where(um, v_anchor, e_hi)
    V = jnp.stack([v0, v1, v2], axis=-1)
    # Returned eigenvalues are RAYLEIGH QUOTIENTS of the constructed
    # vectors (mu_* already are; the anchor's is one matvec) — accurate
    # to second order in the vector error, where the raw Cardano root
    # carries an absolute ~eps*||A|| error that the sqrt in svd3x3
    # amplifies for small singular values.
    Av = jnp.einsum("...ij,...j->...i", A, v_anchor)
    lam_a = jnp.sum(v_anchor * Av, axis=-1)
    w0 = jnp.where(use_max, mu_lo, lam_a)
    w1 = jnp.where(use_max, mu_hi, mu_lo)
    w2 = jnp.where(use_max, lam_a, mu_hi)
    x = jnp.stack([w0, w1, w2], axis=-1) * ascale[..., None]
    # Near-isotropic matrices: eigenvalues are all ~q and ANY orthonormal
    # V works; the construction above already degrades gracefully there
    # (fallback axes), so no special case is needed.
    return x, V


@f32_matmul
def qr_nullvec(A):
    """Exact null vector of [..., m, n] systems with m < n via QR.

    Complete QR of A^T: the trailing column of Q spans the orthogonal
    complement of the row space.  For the minimal 8x9 systems this is
    ~400x more accurate in f32 than the Gram eigensolve (linear instead
    of squared conditioning) and maps to XLA's batched Householder QR.
    Use `gram_nullvec` for overdetermined least-squares systems instead.
    """
    Q, _ = jnp.linalg.qr(jnp.swapaxes(A, -1, -2), mode="complete")
    return Q[..., :, -1]


def _orthonormal_u_from(E, V, s):
    """U columns for a 3x3 SVD given right vectors V and singvals s.

    u_i = E v_i / s_i for the two dominant directions; u_2 completes the
    right-handed frame via a cross product (robust when s_2 ~ 0, which is
    exactly the essential-matrix case).
    """
    def _safe_unit(v, fallback):
        n = jnp.linalg.norm(v, axis=-1, keepdims=True)
        ok = n > 1e-12
        unit = v / jnp.where(ok, n, 1.0)
        fb = jnp.broadcast_to(jnp.asarray(fallback, v.dtype), v.shape)
        return jnp.where(ok, unit, fb)

    u0 = (E @ V[..., :, 0:1])[..., 0] / jnp.maximum(s[..., 0:1], 1e-20)
    # Degenerate (e.g. zero) inputs fall back to canonical axes so the
    # result stays a finite orthonormal frame instead of NaN-poisoning
    # downstream consumers.
    u0 = _safe_unit(u0, [1.0, 0.0, 0.0])
    u1 = (E @ V[..., :, 1:2])[..., 0]
    # Re-orthogonalize against u0 before normalizing (f32 safety).
    u1 = u1 - jnp.sum(u1 * u0, axis=-1, keepdims=True) * u0
    n1 = jnp.linalg.norm(u1, axis=-1, keepdims=True)
    ok1 = n1 > 1e-12
    # Fallback: any unit vector perpendicular to u0 (two candidates so
    # at least one is nonzero for every u0).
    perp_a = jnp.stack(
        [-u0[..., 1], u0[..., 0], jnp.zeros_like(u0[..., 0])], axis=-1
    )
    perp_b = jnp.stack(
        [jnp.zeros_like(u0[..., 0]), -u0[..., 2], u0[..., 1]], axis=-1
    )
    na = jnp.linalg.norm(perp_a, axis=-1, keepdims=True)
    perp = jnp.where(na > 0.5, perp_a / jnp.maximum(na, 1e-12),
                     perp_b / jnp.maximum(
                         jnp.linalg.norm(perp_b, axis=-1, keepdims=True), 1e-12))
    u1 = jnp.where(ok1, u1 / jnp.where(ok1, n1, 1.0), perp)
    u2 = jnp.cross(u0, u1)
    return jnp.stack([u0, u1, u2], axis=-1), u2


def _align_v2(E, V, u2):
    """Flip V's third column so that E v2 aligns with u2 = u0 x u1.

    Keeps U orthonormal-by-construction while preserving E = U S V^T
    when s2 > 0 (for essential matrices s2 ~ 0 and the sign is moot).
    """
    Ev2 = (E @ V[..., :, 2:3])[..., 0]
    d = jnp.sum(Ev2 * u2, axis=-1)
    sign = jnp.where(d < 0, -1.0, 1.0)
    return V.at[..., :, 2].multiply(sign[..., None])


@functools.partial(jax.jit, static_argnames=("sweeps", "method"))
@f32_matmul
def svd3x3(E, *, sweeps: int = 8, method: str = "jacobi"):
    """Batched 3x3 SVD ``E = U diag(s) V^T`` with descending s.

    Analog of the reference's branch-free device svd3
    (reference SfM/svd.h:311-335): eigendecompose E^T E for V and s,
    reconstruct U column-wise.  U and V are proper orthonormal but
    *not* guaranteed det=+1; pose decomposition fixes signs (see
    geometry.pose).

    method: "jacobi" (fixed-`sweeps` cyclic Jacobi — the default) or
    "analytic" (closed-form eigh3x3).  The analytic form was written to
    cut dependency-chain latency, but an interleaved on-device A/B
    (tools/exp_solver_ab.py, r2) measured the geometry stage 0.4 ms
    FASTER with jacobi (2.64 vs 3.06 ms): the closed-form's cube roots,
    trig and guarded normalizations cost more VPU issue slots than the
    sweep chain's latency saves.
    """
    if method not in ("analytic", "jacobi"):
        raise ValueError(f"svd3x3: unknown method {method!r}")
    G = jnp.einsum("...ji,...jk->...ik", E, E)
    if method == "analytic":
        w, V = eigh3x3(G)  # ascending
    else:
        w, V = jacobi_eigh(G, sweeps=sweeps, sort=True)  # ascending
    # Descending singular values.
    w = w[..., ::-1]
    V = V[..., ::-1]
    s = jnp.sqrt(jnp.maximum(w, 0.0))
    U, u2 = _orthonormal_u_from(E, V, s)
    V = _align_v2(E, V, u2)
    return U, s, V


@f32_matmul
def project_to_essential(E, *, sweeps: int = 8):
    """Project 3x3 matrices onto the essential manifold: singvals (1,1,0).

    Replaces the reference's in-kernel ``normalizeE``
    (reference SfM/kernels.h:281-295).
    """
    U, _, V = svd3x3(E, sweeps=sweeps)
    d = jnp.asarray([1.0, 1.0, 0.0], dtype=E.dtype)
    return jnp.einsum("...ik,k,...jk->...ij", U, d, V)


def so3_project(M, *, sweeps: int = 8):
    """Nearest rotation matrix (polar decomposition, det=+1)."""
    U, _, V = svd3x3(M, sweeps=sweeps)
    # R = U diag(1,1,det(U V^T)) V^T ensures det(R)=+1.
    UVt = jnp.einsum("...ik,...jk->...ij", U, V)
    det = jnp.linalg.det(UVt)
    d = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    return jnp.einsum("...ik,...k,...jk->...ij", U, d, V)


def cross_matrix(t):
    """Skew-symmetric [t]_x for ``t`` of shape [..., 3]."""
    z = jnp.zeros_like(t[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -t[..., 2], t[..., 1]], axis=-1),
            jnp.stack([t[..., 2], z, -t[..., 0]], axis=-1),
            jnp.stack([-t[..., 1], t[..., 0], z], axis=-1),
        ],
        axis=-2,
    )
