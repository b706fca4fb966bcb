"""Small-matrix batched linear algebra for the estimation stack.

The reference leans on Armadillo/Cholmod for these (logDet Util.hpp:714-731,
g2o's dense/sparse solvers); here every op is a fixed-shape batched primitive
that XLA maps onto the device's vector and matrix units. Matrices are tiny (3..13 square), so the
batch dimension carries the parallelism.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def logdet_psd(M: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """log|M| for symmetric PSD (..., n, n) via Cholesky (ref Util.hpp logDet).

    Returns -inf-free values: non-PD inputs produce a large negative number via
    nan-scrubbing so greedy argmax selection never picks them.
    """
    if jitter:
        M = M + jitter * jnp.eye(M.shape[-1], dtype=M.dtype)
    L = jnp.linalg.cholesky(M)
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    ld = 2.0 * jnp.sum(jnp.log(jnp.maximum(diag, 1e-30)), axis=-1)
    return jnp.where(jnp.isnan(ld), -1e30, ld)


def slogdet_general(M: jnp.ndarray) -> jnp.ndarray:
    """Sign-agnostic log|det| fallback for symmetric-but-indefinite inputs."""
    sign, ld = jnp.linalg.slogdet(M)
    return jnp.where(sign > 0, ld, -1e30)


def solve_psd(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b for symmetric PD A (..., n, n), b (..., n) via Cholesky."""
    L = jnp.linalg.cholesky(A)
    y = jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )
    return x[..., 0]


def inv3(M: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Closed-form batched 3×3 inverse (Schur point-block inversion in BA).

    Adjugate/determinant form — one fused elementwise program, no LU.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det)
    inv = jnp.stack(
        [
            jnp.stack([A, B, C], axis=-1),
            jnp.stack([D, E, F], axis=-1),
            jnp.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


def normalize_points_2d(pts: jnp.ndarray, mask: jnp.ndarray):
    """Hartley normalization of masked 2D point sets (used by the two-view
    initializer's DLT, ref src/Initializer.cc Normalize).

    Returns (normalized points, 3×3 similarity T with x_norm = T @ x).
    """
    w = mask.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1.0)
    mean = jnp.sum(pts * w[..., None], axis=-2, keepdims=True) / n[..., None]
    centered = (pts - mean) * w[..., None]
    mean_dev = jnp.sum(jnp.abs(centered), axis=-2) / n[..., None][..., 0]
    s = 1.0 / jnp.maximum(mean_dev, 1e-8)  # (..., 2)
    normed = centered * s[..., None, :]
    sx, sy = s[..., 0], s[..., 1]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    zero = jnp.zeros_like(sx)
    one = jnp.ones_like(sx)
    T = jnp.stack(
        [
            jnp.stack([sx, zero, -mx * sx], axis=-1),
            jnp.stack([zero, sy, -my * sy], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    return normed, T


def smallest_eigvec_sym(M: jnp.ndarray) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of a small symmetric matrix.

    Used for DLT solves (A^T A nullspace) in homography/fundamental/triangulation
    estimation — jnp.linalg.eigh is batched and differentiable.
    """
    _, vecs = jnp.linalg.eigh(M)
    return vecs[..., :, 0]
