"""Closed-form 3D-3D alignment (Horn/Umeyama), batched.

Used by the Sim3 solver (ref src/Sim3Solver.cc ComputeSim3's Horn method,
cc:215-318) and the EPnP control-point alignment. SVD-based: works batched on
the device, handles the reflection case.
"""

from __future__ import annotations

import jax.numpy as jnp

from gf_orb_slam_tpu.geometry import quat, se3


def horn_align(
    src: jnp.ndarray, dst: jnp.ndarray, w: jnp.ndarray, with_scale: bool = False
):
    """Weighted alignment dst ≈ s·R·src + t.

    src, dst: (..., N, 3); w: (..., N) nonneg weights.
    Returns (q (...,4), t (...,3), s (...,)).
    """
    wn = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    mu_s = jnp.sum(src * wn[..., None], axis=-2, keepdims=True)
    mu_d = jnp.sum(dst * wn[..., None], axis=-2, keepdims=True)
    xs = src - mu_s
    xd = dst - mu_d
    cov = jnp.einsum("...ni,...n,...nj->...ij", xd, wn, xs)  # (...,3,3)
    U, D, Vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    S = jnp.ones_like(D).at[..., 2].set(jnp.sign(det))
    R = jnp.einsum("...ij,...j,...jk->...ik", U, S, Vt)
    if with_scale:
        var_s = jnp.sum(jnp.einsum("...ni,...ni->...n", xs, xs) * wn, axis=-1)
        s = jnp.sum(D * S, axis=-1) / jnp.maximum(var_s, 1e-12)
    else:
        s = jnp.ones(cov.shape[:-2], cov.dtype)
    t = mu_d[..., 0, :] - s[..., None] * jnp.einsum("...ij,...j->...i", R, mu_s[..., 0, :])
    return quat.r2q(R), t, s
